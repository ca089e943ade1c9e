"""Accelerator abstraction (port of ``deepspeed_tpu/accelerator/
abstract_accelerator.py``): device naming, synchronisation, memory stats and
the Hopper capability probe behind one interface, for ``cuda`` and ``cpu``."""

from __future__ import annotations

import abc
from typing import List

import torch


class Accelerator(abc.ABC):
    _name: str = "abstract"

    def device_name(self, device_index=None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def is_available(self) -> bool:
        return self.device_count() > 0

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    def devices(self) -> List[torch.device]:
        return [torch.device(self.device_name(i))
                for i in range(self.device_count())]

    def synchronize(self) -> None:
        """Wait for all work queued on the device (no-op on the CPU)."""

    def memory_stats(self) -> dict:
        """``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit`` and
        ``bytes_free`` of the device (empty on the CPU)."""
        return {}

    def is_sm90(self) -> bool:
        """True when the device is Hopper (compute capability 9.x), the
        target the CUDA kernels are compiled for."""
        return False
