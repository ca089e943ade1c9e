"""Fixed-shape slot pool of per-slot KV cache (port of
``deepspeed_tpu/serving/slot_pool.py``).

The pool owns ONE stacked cache, k/v ``(L, num_slots, KV, S, D)`` (int8 with
fp32 ``k_scale``/``v_scale`` ``(L, num_slots, KV, S)`` for an int8 KV cache),
allocated through the model's ``KVCacheSpec`` with batch = slots.
Continuous batching never changes a shape: admitting, retiring and reusing
slots move data inside the same tensors, and dead slots ride the decode
step as masked padding.

Admission writes IN PLACE: :meth:`prefill_target` hands the engine this
pool's cache and the slots' rows, so the prefill writes the prompt's K/V
straight into them (the JAX pool prefills into a separate cache and copies
it over). Columns past the new prompt's length keep the previous
occupant's values; attention never reads them, because each slot's length
(:attr:`starts`) masks them and the next write lands exactly at that
length. :meth:`admit_rows` then records the lengths. The paged pool
(``paged_pool.PagedKVPool``) keeps the same contract over pages.

The cache tensors live as long as the pool: :meth:`reset` zeroes them in
place, and the decode positions go to the device through one static
buffer (:meth:`positions_dev`). A decode step captured in a CUDA graph
(``inference/decode_graph.py``) holds their addresses, so a new allocation
would leave it writing into freed memory.

Over a ``(data, model)`` mesh the slots are split over the data ranks
(``shard=(lo, hi)``, ``serving/model_group.py``): the cache holds rows
``[lo, hi)`` only, as row ``slot - lo``, while the slot numbers, lengths
and free list stay those of the whole pool on every rank.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict

import numpy as np
import torch

from ..accelerator import copy_from_host


class SlotPool:
    """``num_slots`` independently occupied rows of one shared KV cache."""

    def __init__(self, spec: Any, num_slots: int, device=None, shard=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.spec = spec
        self.num_slots = num_slots
        # the slots whose K/V rows this rank's cache holds
        self.shard = (0, num_slots) if shard is None else tuple(shard)
        self.capacity = int(spec.max_seq_len)
        self.device = device
        self.cache: Dict[str, Any] = self._fresh_cache()
        # per-slot cache lengths, host side: decode reads them every step
        self.starts = np.zeros((num_slots,), np.int32)
        # their device copy at each decode step (positions_dev)
        self._pos_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=device)
        self._free = list(range(num_slots))
        heapq.heapify(self._free)  # smallest slot first: deterministic
        self._free_set = set(self._free)

    def _fresh_cache(self) -> Dict[str, Any]:
        lo, hi = self.shard
        return self.spec.stacked_cache(hi - lo, self.device)

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
        the cache, in place."""
        for leaf in self.cache.values():
            leaf.zero_()
        self.starts[:] = 0
        self._free = list(range(self.num_slots))
        heapq.heapify(self._free)
        self._free_set = set(self._free)

    def reset_row(self, slot: int) -> None:
        """Scrub ``slot`` before a chunked admission: its length drops to 0
        (stale rows stay, masked, until the chunks overwrite them)."""
        self.starts[slot] = 0

    def prefill_target(self, slots, width: int):
        """``(cache, rows)`` a whole-prompt prefill of ``len(slots)``
        prompts at ``width`` writes into: this pool's cache, the slots'
        own rows (``width`` is not needed: rows span the capacity)."""
        return self.cache, list(slots)

    def admit_rows(self, cache, slots, lengths) -> None:
        """Record that ``slots`` now hold prefills of ``lengths`` tokens,
        written in place by the engine into :meth:`prefill_target`'s
        ``cache``."""
        lengths = np.asarray(lengths, np.int32)
        if np.any(lengths > self.capacity):
            raise ValueError(f"sequence length {int(lengths.max())} exceeds "
                             f"slot capacity {self.capacity}")
        self.starts[np.asarray(slots, np.int64)] = lengths

    def advance(self, lengths) -> None:
        """Advance the per-slot lengths after a decode step by a
        (num_slots,) array (0 for the rows that did not grow)."""
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

    def positions_dev(self) -> torch.Tensor:
        """:meth:`positions` in the pool's static (num_slots,) int32 device
        buffer, copied without a host sync (stream-ordered: a step that
        read the previous values has already been issued)."""
        return copy_from_host(self._pos_dev, self.positions())

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
