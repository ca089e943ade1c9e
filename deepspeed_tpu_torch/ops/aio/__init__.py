"""Async file I/O for the NVMe offload tier (the port of ``deepspeed_tpu/
ops/aio/__init__.py``): ``async_pread``/``async_pwrite`` return tickets,
``wait_ticket`` waits for one request, ``wait`` for all, over the port's host
op ``ops/csrc/aio.cpp`` (a thread pool of pread/pwrite calls, each request
split into ``block_size`` chunks), built at first use by
``op_builder.load_host``.

Buffers are contiguous CPU tensors; offsets are in bytes. A chunk goes
through ``O_DIRECT`` (with ``o_direct=True``) when its buffer address, file
offset and size are all 4096-aligned (:func:`aligned_array` gives such
buffers; pinned memory from the CUDA host allocator is page-aligned too),
else through the buffered descriptor of the same file. tmpfs and some
overlay filesystems refuse ``O_DIRECT``: :func:`o_direct_supported` probes a
directory. A failed chunk makes ``wait``/``wait_ticket`` raise ``IOError``.
``single_submit`` and ``overlap_events`` are accepted for config parity and
do nothing (submission always overlaps). The JAX package's tuning tool
``ops/aio/sweep.py`` is not ported.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from .. import op_builder

ALIGN = 4096


def aligned_array(nbytes: int, dtype: torch.dtype = torch.uint8,
                  align: int = ALIGN, pin_memory: bool = False
                  ) -> torch.Tensor:
    """A 1-D CPU tensor of ``nbytes`` (rounded up to whole elements) whose
    data pointer is ``align``-aligned: an over-allocated buffer sliced at
    the first aligned byte (pinned with ``pin_memory``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = -(-nbytes // itemsize) * itemsize
    raw = torch.empty(n + align, dtype=torch.uint8, pin_memory=pin_memory)
    off = (-raw.data_ptr()) % align
    return raw[off:off + n].view(dtype)


def _buffer(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("aio buffers must be contiguous CPU tensors")
    return t


class AioHandle:
    """Thread-pool async file I/O over CPU tensors (module docstring)."""

    def __init__(self, num_threads: int = 4, block_size: int = 1 << 20,
                 queue_depth: int = 0, o_direct: bool = False,
                 single_submit: bool = False, overlap_events: bool = True):
        del single_submit, overlap_events
        if block_size < ALIGN:
            raise ValueError(f"block_size must be >= {ALIGN} bytes, got "
                             f"{block_size}")
        self._lib = op_builder.load_host("aio")
        self._h = self._lib.ds_aio_create(num_threads, block_size,
                                          queue_depth, int(o_direct))
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.num_threads = num_threads
        self.o_direct = o_direct
        # every submitted buffer stays referenced until its ticket (or a
        # full wait) completes
        self._refs: Dict[int, torch.Tensor] = {}

    def async_pwrite(self, tensor: torch.Tensor, path: str,
                     offset: int = 0) -> int:
        """Submit a write of ``tensor``'s bytes at ``offset``; returns its
        ticket."""
        t = _buffer(tensor)
        ticket = self._lib.ds_aio_pwrite(
            self._h, os.fsencode(path), t.data_ptr(),
            t.numel() * t.element_size(), offset)
        self._refs[ticket] = t
        return ticket

    def async_pread(self, tensor: torch.Tensor, path: str,
                    offset: int = 0) -> int:
        """Submit a read into ``tensor`` from ``offset``; returns its
        ticket."""
        t = _buffer(tensor)
        ticket = self._lib.ds_aio_pread(
            self._h, os.fsencode(path), t.data_ptr(),
            t.numel() * t.element_size(), offset)
        self._refs[ticket] = t
        return ticket

    def sync_pwrite(self, tensor: torch.Tensor, path: str,
                    offset: int = 0) -> None:
        self.wait_ticket(self.async_pwrite(tensor, path, offset))

    def sync_pread(self, tensor: torch.Tensor, path: str,
                   offset: int = 0) -> None:
        self.wait_ticket(self.async_pread(tensor, path, offset))

    def wait(self) -> int:
        """Wait for every pending request; raises ``IOError`` if a chunk
        failed, else returns 0."""
        errors = self._lib.ds_aio_wait(self._h)
        self._refs.clear()
        if errors:
            raise IOError(f"aio: {errors} chunk(s) failed")
        return 0

    def wait_ticket(self, ticket: int) -> None:
        """Wait for one request and release its buffer; raises ``IOError``
        if one of its chunks failed."""
        errors = self._lib.ds_aio_wait_ticket(self._h, ticket)
        self._refs.pop(ticket, None)
        if errors:
            raise IOError(f"aio: {errors} chunk(s) failed (ticket {ticket})")

    def pending(self) -> int:
        return self._lib.ds_aio_pending(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.ds_aio_wait(self._h)
            self._lib.ds_aio_destroy(self._h)
            self._h = None
            self._refs.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def o_direct_supported(path: str) -> bool:
    """True when the filesystem holding ``path`` (a directory or a file)
    accepts ``O_DIRECT`` opens."""
    lib = op_builder.load_host("aio")
    return bool(lib.ds_aio_probe_o_direct(os.fsencode(path)))
