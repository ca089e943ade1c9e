"""Fixed-shape slot pool of per-slot KV cache (port of
``deepspeed_tpu/serving/slot_pool.py``).

The pool owns ONE stacked cache, k/v ``(L, num_slots, KV, S, D)``, allocated
through the model's :class:`~deepspeed_tpu_torch.models.transformer_lm.
KVCacheSpec` with batch = slots. Continuous batching never changes a shape:
admitting, retiring and reusing slots move data inside the same tensors,
and dead slots ride the decode step as masked padding.

Admission writes IN PLACE: the engine's prefill writes the prompt's K/V
straight into the slot's row of :attr:`cache` (the JAX pool prefills into a
separate single-row cache and copies it over). Columns past the new
prompt's length keep the previous occupant's values; attention never reads
them, because each slot's length (:attr:`starts`) masks them and the next
decode write lands exactly at that length. :meth:`admit` then records the
length.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict

import numpy as np


class SlotPool:
    """``num_slots`` independently occupied rows of one shared KV cache."""

    def __init__(self, spec: Any, num_slots: int, device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.spec = spec
        self.num_slots = num_slots
        self.capacity = int(spec.max_seq_len)
        self.device = device
        self.cache: Dict[str, Any] = spec.stacked_cache(num_slots, device)
        # per-slot cache lengths, host side: decode reads them every step
        self.starts = np.zeros((num_slots,), np.int32)
        self._free = list(range(num_slots))
        heapq.heapify(self._free)  # smallest slot first: deterministic
        self._free_set = set(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("slot pool exhausted (scheduler bug: admit "
                               "called without a free slot)")
        slot = heapq.heappop(self._free)
        self._free_set.discard(slot)
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free pool. A double release would hand one
        row to two requests, so it raises."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if slot in self._free_set:
            raise RuntimeError(f"double release of slot {slot} (already "
                               f"free; scheduler/engine bug)")
        heapq.heappush(self._free, slot)
        self._free_set.add(slot)

    def reset(self) -> None:
        """Recovery after a mid-step exception: free every slot and zero
        the cache."""
        self.cache = self.spec.stacked_cache(self.num_slots, self.device)
        self.starts[:] = 0
        self._free = list(range(self.num_slots))
        heapq.heapify(self._free)
        self._free_set = set(self._free)

    def admit(self, slot: int, length: int) -> None:
        """Record that ``slot``'s row now holds a ``length``-token prefill
        (written in place by the engine, see the module docstring)."""
        if length > self.capacity:
            raise ValueError(f"sequence length {length} exceeds slot "
                             f"capacity {self.capacity}")
        self.starts[slot] = length

    def advance(self, lengths) -> None:
        """Advance the per-slot lengths after a decode step: by a scalar
        for every slot, or by a (num_slots,) array."""
        if np.ndim(lengths) == 0:
            self.starts += int(lengths)
            return
        lengths = np.asarray(lengths, np.int32)
        if lengths.shape != self.starts.shape:
            raise ValueError(f"advance lengths shape {lengths.shape} != "
                             f"({self.num_slots},)")
        self.starts += lengths

    def positions(self) -> np.ndarray:
        """(num_slots,) decode positions: each live slot's length, clamped
        into the allocation; 0 for a free slot, so a dead row costs the
        decode kernel one cache row instead of its stale length."""
        pos = np.minimum(self.starts, self.capacity - 1).astype(np.int32)
        pos[list(self._free_set)] = 0
        return pos

    def consistency_errors(self) -> list:
        """Bookkeeping audit for ``check_invariants()``: the free heap and
        its set mirror must agree and hold valid ids. Returns violation
        strings (empty = healthy)."""
        errors = []
        if len(self._free) != len(self._free_set):
            errors.append(f"free heap ({len(self._free)}) and free set "
                          f"({len(self._free_set)}) sizes differ")
        if set(self._free) != self._free_set:
            errors.append(f"free heap {sorted(self._free)} != free set "
                          f"{sorted(self._free_set)}")
        bad = [s for s in self._free_set if not 0 <= s < self.num_slots]
        if bad:
            errors.append(f"free slots out of range: {sorted(bad)}")
        return errors
