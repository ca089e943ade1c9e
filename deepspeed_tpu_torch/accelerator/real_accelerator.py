"""Accelerator selection and device resolution (port of ``deepspeed_tpu/
accelerator/real_accelerator.py``).

The port's entry points run on ``cuda`` unless the caller asks for the
CPU: :func:`resolve_device` returns ``cuda`` by default and raises when no
card is visible, instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

from .abstract_accelerator import Accelerator


class CudaAccelerator(Accelerator):
    _name = "cuda"

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def synchronize(self) -> None:
        torch.cuda.synchronize()

    def memory_stats(self) -> dict:
        free, total = torch.cuda.mem_get_info()
        return {"bytes_in_use": torch.cuda.memory_allocated(),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
                "bytes_limit": total, "bytes_free": free}

    def is_sm90(self) -> bool:
        return self.is_available() and \
            torch.cuda.get_device_capability(0)[0] == 9


class CpuAccelerator(Accelerator):
    _name = "cpu"

    def device_count(self) -> int:
        return 1

    def devices(self):
        return [torch.device("cpu")]


_ACCELERATORS = {"cuda": CudaAccelerator, "cpu": CpuAccelerator}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is None;
    ``cpu`` only when asked for. Raises when CUDA is asked for (or
    defaulted to) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; the port runs on cuda "
                         f"or cpu")
    return dev


def get_accelerator(device: Union[str, torch.device, None] = None
                    ) -> Accelerator:
    """The accelerator for ``device`` (resolved by :func:`resolve_device`)."""
    return _ACCELERATORS[resolve_device(device).type]()


def copy_from_host(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy host data (a numpy array or CPU tensor) into the device tensor
    ``dst`` in stream order, without making the host wait for the device:
    a copy from pageable memory waits for the stream's earlier work, so on
    a card the data goes through pinned memory (PyTorch's pinned-block
    cache keeps each block until its copy has run). Returns ``dst``."""
    src = torch.as_tensor(src)
    if dst.device.type == "cuda":
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)
