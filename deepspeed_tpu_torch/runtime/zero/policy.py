"""ZeRO stages on one device: the port of ``deepspeed_tpu/runtime/zero/
policy.py`` for a data-parallel world of 1.

The JAX policy shards master weights, optimizer moments, gradients and
(stage 3) parameters over the data axis. With one device that axis has
size 1 and nothing is sharded, so stages 0-3 compute the same numbers; the
port records the stage and validates it. A data-parallel world above 1
(ZeRO over NCCL) is not ported and raises.
"""

from __future__ import annotations

from .config import DeepSpeedZeroConfig, ZeroStageEnum

_WHAT = {0: "nothing partitioned", 1: "optimizer states",
         2: "optimizer states + gradients",
         3: "optimizer states + gradients + parameters"}


class ZeroShardingPolicy:
    def __init__(self, config: DeepSpeedZeroConfig, world_size: int = 1):
        if world_size != 1:
            raise NotImplementedError(
                f"ZeRO over a data-parallel world of {world_size} (NCCL "
                f"sharding) is not ported to the PyTorch/CUDA package yet; "
                f"it runs on one device")
        self.config = config
        self.stage = ZeroStageEnum(int(config.stage))
        self.world_size = world_size

    def describe(self) -> str:
        return (f"zero stage {int(self.stage)} ({_WHAT[int(self.stage)]}) "
                f"over a data-parallel world of {self.world_size}: nothing "
                f"sharded")
