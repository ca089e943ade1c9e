"""Offload configuration: the port's own copy of ``deepspeed_tpu/runtime/
zero/offload_config.py``.

Devices: ``none`` (the card's memory), ``cpu`` (host memory) and ``nvme``
(files under ``nvme_path``, moved by the async I/O op ``ops/aio``).
``offload_optimizer`` keeps the fp32 master weights and Adam moments off the
card and steps them with the host Adam (``runtime/zero/offload.py``);
``offload_param`` streams the blocks' weights through the card a layer at a
time for training (``runtime/zero/param_offload.py``), which takes the
optimizer offload with it. ``swap_master: false`` (with ``device: nvme``)
keeps the master in host memory and swaps only the moments to disk.
"""

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
