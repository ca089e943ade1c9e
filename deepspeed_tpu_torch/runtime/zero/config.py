"""ZeRO configuration: the port's own copy of ``deepspeed_tpu/runtime/zero/
config.py``, with the JSON names of the reference so unmodified configs
parse. The stage, ``stage3_param_persistence_threshold`` and
``mics_shard_size`` steer the partition over a data-parallel world
(``zero/policy.py``, ``zero/partition.py``); the bucket, prefetch and
overlap knobs parse and steer nothing (one collective a tensor, no
prefetch).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

from ..config_utils import DeepSpeedConfigModel, pp_int
from .offload_config import (DeepSpeedZeroOffloadOptimizerConfig,
                             DeepSpeedZeroOffloadParamConfig,
                             OffloadDeviceEnum)

__all__ = ["ZeroStageEnum", "DeepSpeedZeroConfig", "OffloadDeviceEnum"]


class ZeroStageEnum(IntEnum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


def _ge0(default):
    return dataclasses.field(default=default, metadata={"ge": 0})


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: ZeroStageEnum = ZeroStageEnum.disabled
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = _ge0(int(5e8))
    allgather_partitions: bool = True
    allgather_bucket_size: int = _ge0(int(5e8))
    overlap_comm: Optional[bool] = None  # default True for stage 3
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None

    sub_group_size: int = _ge0(int(1e9))
    stage3_max_live_parameters: int = _ge0(int(1e9))
    stage3_max_reuse_distance: int = _ge0(int(1e9))
    stage3_prefetch_bucket_size: int = _ge0(int(5e7))
    stage3_param_persistence_threshold: int = _ge0(int(1e5))
    stage3_gather_16bit_weights_on_model_save: bool = False
    stage3_gather_fp16_weights_on_model_save: bool = dataclasses.field(
        default=False, metadata={
            "deprecated": True,
            "new_param": "stage3_gather_16bit_weights_on_model_save"})

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True

    def __post_init__(self):
        stage = int(self.stage)
        if not 0 <= stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.stage}")
        self.stage = ZeroStageEnum(stage)
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == ZeroStageEnum.weights

    def __repr__(self):
        return (f"DeepSpeedZeroConfig(stage={int(self.stage)}, "
                f"reduce_bucket_size={pp_int(self.reduce_bucket_size)}, "
                f"offload_param={self.offload_param}, "
                f"offload_optimizer={self.offload_optimizer})")
