"""Byte packing for layer streaming (port of
``deepspeed_tpu/utils/streaming.py``).

One transformer layer's parameters travel host -> device as ONE contiguous
byte buffer, so a layer is one copy however many leaves it has. The
device side reads its leaves as views of that buffer, so nothing is copied
there (the JAX package re-slices on the device with a traced bitcast, an
HBM-local copy).

A layer is a flat dict ``{name: tensor or array}`` (the names of a
``TransformerBlock``'s ``state_dict``). Float leaves travel in the compute
dtype, converted while they are packed; leaves ``keep_dtype`` selects (the
int8 tier's per-channel ``scale`` rows) and non-float leaves keep their
storage dtype. Each leaf starts at a multiple of :data:`ALIGN` bytes, so
every view is aligned as the kernels' vector and TMA loads need, and any
view of the buffer can be reinterpreted as its leaf's dtype.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# byte alignment of each leaf inside the buffer
ALIGN = 256


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor over ``x`` (a tensor, an array or an ``np.memmap``)
    without a copy; a read-only memmap is only ever read from here."""
    if torch.is_tensor(x):
        return x
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # non-writable arrays
        return torch.from_numpy(np.asarray(x))


class LayerWireFormat:
    """Leaf metadata + pack/unpack for one layer's parameter dict.

    ``keep_dtype(name, leaf) -> bool``: float leaves that keep their
    storage dtype on the wire; every other float leaf converts to
    ``compute_dtype``; non-floats always keep theirs."""

    def __init__(self, layer: Dict[str, object], compute_dtype: torch.dtype,
                 keep_dtype: Optional[Callable] = None):
        self.compute_dtype = compute_dtype
        self.names: List[str] = list(layer)
        leaves = [host_tensor(layer[k]) for k in self.names]

        def wire_dtype(name, leaf):
            if not leaf.is_floating_point():
                return leaf.dtype
            if keep_dtype is not None and keep_dtype(name, leaf):
                return leaf.dtype
            return compute_dtype

        self.shapes: List[tuple] = [tuple(t.shape) for t in leaves]
        self.wire_dtypes = [wire_dtype(k, t)
                            for k, t in zip(self.names, leaves)]
        self.nbytes = [int(np.prod(s, dtype=np.int64)) * d.itemsize
                       for s, d in zip(self.shapes, self.wire_dtypes)]
        self.offsets, off = [], 0
        for nb in self.nbytes:
            self.offsets.append(off)
            off += -(-nb // ALIGN) * ALIGN
        self.total_nbytes = off

    @property
    def uniform_dtype(self) -> Optional[torch.dtype]:
        """The single wire dtype when every leaf shares one (a plain bf16
        layer), else None."""
        first = self.wire_dtypes[0] if self.wire_dtypes else None
        return first if all(d == first for d in self.wire_dtypes) else None

    def _views(self, flat: torch.Tensor, itemsize: int) -> Dict:
        return {name: flat[off // itemsize:(off + nb) // itemsize]
                for name, off, nb in zip(self.names, self.offsets,
                                         self.nbytes)}

    def unpack_typed(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A buffer viewed as :attr:`uniform_dtype` -> leaf views (slice +
        reshape, no reinterpretation)."""
        views = self._views(flat, self.uniform_dtype.itemsize)
        return {name: views[name].view(shape)
                for name, shape in zip(self.names, self.shapes)}

    def unpack(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A uint8 buffer (on any device) -> leaf views, each
        reinterpreted as its wire dtype."""
        views = self._views(flat, 1)
        return {name: views[name].view(dtype).view(shape)
                for name, dtype, shape in zip(self.names, self.wire_dtypes,
                                              self.shapes)}

    def pack_into(self, layer: Dict[str, object], buf: torch.Tensor) -> None:
        """Host: convert every leaf to its wire dtype into its place in the
        uint8 ``buf`` (``total_nbytes`` long)."""
        dst = self.unpack(buf)
        for name in self.names:
            dst[name].copy_(host_tensor(layer[name]))

    def unpack_host(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Host-side inverse of :meth:`pack_into`: owned copies."""
        return {name: t.clone() for name, t in self.unpack(buf).items()}
