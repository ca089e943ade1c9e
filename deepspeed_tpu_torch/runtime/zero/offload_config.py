"""Offload configuration: the port's own copy of ``deepspeed_tpu/runtime/
zero/offload_config.py``. The blocks parse; the engine raises
``NotImplementedError`` for any device other than ``none`` (ZeRO-Offload is
not ported yet)."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

from ..config_utils import DeepSpeedConfigModel


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_param`` block."""

    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = dataclasses.field(default=5, metadata={"ge": 0})
    buffer_size: int = dataclasses.field(default=int(1e8), metadata={"ge": 0})
    max_in_cpu: int = dataclasses.field(default=int(1e9), metadata={"ge": 0})
    pin_memory: bool = False

    def __post_init__(self):
        self.device = OffloadDeviceEnum(self.device)


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer`` block."""

    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = dataclasses.field(default=4, metadata={"ge": 0})
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    swap_master: bool = True

    def __post_init__(self):
        self.device = OffloadDeviceEnum(self.device)
