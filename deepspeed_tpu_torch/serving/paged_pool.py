"""Paged KV pool: fixed-size pages, per-slot page tables and refcounted
copy-on-write prefix sharing over the serving slot pool (port of
``deepspeed_tpu/serving/paged_pool.py``).

Terminology (vLLM PagedAttention, SGLang RadixAttention): a *page* is
``page_size`` positions of K/V across every layer; the
``(num_slots, pages_per_slot)`` int32 *page table* is the per-sequence
block table; the free-page heap is the block allocator; ``num_pages <
num_slots * pages_per_slot`` oversubscribes the pool, since slots reserve
nothing. The :class:`~deepspeed_tpu_torch.serving.prefix_cache.PrefixCache`
trie maps full-page token prefixes to pages; a page's refcount counts the
slots mapping it plus the trie nodes caching it. Admission maps a trie
hit's pages for free and prefills only the uncached suffix; the first
write into a shared page forks it (copy-on-write).

Storage is ``KVCacheSpec.paged_cache``: k/v ``(L, P, KV, page_size, D)``,
plus fp32 scale pages ``k_scale``/``v_scale`` ``(L, P, KV, page_size)``
for an int8 KV cache; every page operation (CoW copy, admission and chunk
scatter, dense view) carries every leaf.
Decode reads the pages in place: :meth:`run_decode` calls the model's
``decode_paged``, which writes the step's rows through the table and
attends through ``paged_decode_attention`` (the CUDA kernel for a pool on
the card, its plain version for a pool on the CPU). With ``kernel="off"``
it composes the dense path instead: gather the slots' dense view
(``KVCacheSpec.dense_from_pages``), run the contiguous decode, and write
the step's column back through the table. Chunked prefill always takes
that composition for the one slot it fills (a chunk is wider than the
kernel's query rows), as in the JAX package.

Sentinel convention: table entry ``num_pages`` means "unmapped". The pool
holds one page more than it hands out, page ``num_pages`` itself, a
scratch page: reads through a sentinel entry land there and are masked by
length, and the writes ``page_writes`` drops (sentinel entries, positions
past the table) are written there, so a free or padding row never touches
a real page and no step waits on the host to select its writes. The device
table is one tensor for the pool's life, refreshed in place after host
edits, so a decode step captured in a CUDA graph keeps reading it.

Speculative verify (:meth:`run_verify`) scores K+1 query rows a slot:
through ``decode_paged`` and the paged kernel for K+1 <= ``MAX_QUERY_ROWS``
on a kernel pool, else through the dense composition (the JAX package's
choice too), its K+1 columns written back through the table.

Not in this slice (each raises ``NotImplementedError``): the cross-pool
page transfer of disaggregated serving (``import_pages``, ``seat_pages``).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..accelerator import copy_from_host
from ..ops.attention.paged_attention import MAX_QUERY_ROWS, page_writes
from .prefix_cache import PrefixCache
from .slot_pool import SlotPool


class PagePoolExhausted(RuntimeError):
    """No free page and nothing evictable: the caller must preempt a
    victim (freeing its pages) and retry, or fail the allocation."""


#: mirror of ``ops.attention.paged_attention.MAX_QUERY_ROWS`` (the query
#: rows one kernel launch serves); the pool checks the two stay equal
_KERNEL_MAX_QUERY_ROWS = 8


class PagedKVPool(SlotPool):
    """Drop-in :class:`SlotPool` with paged storage and prefix caching.

    The host-side API is the SlotPool contract (``alloc``/``release``/
    ``advance``/``starts``/``reset``/``reset_row``/``prefill_target``/
    ``admit_rows``/``consistency_errors``); the model steps over pages are
    :meth:`run_decode` and :meth:`run_prefill_chunk`, which the serving
    engine dispatches to when paging is on.
    """

    def __init__(self, spec: Any, num_slots: int, num_pages: int = None,
                 page_size: int = 64, device=None, prefix_cache: bool = True,
                 kernel: str = "auto"):
        if kernel not in ("auto", "on", "off"):
            raise ValueError(f"kernel must be auto|on|off, got {kernel!r}")
        if MAX_QUERY_ROWS != _KERNEL_MAX_QUERY_ROWS:
            raise RuntimeError(
                f"_KERNEL_MAX_QUERY_ROWS={_KERNEL_MAX_QUERY_ROWS} drifted "
                f"from the kernel's MAX_QUERY_ROWS={MAX_QUERY_ROWS}")
        capacity = int(spec.max_seq_len)
        page_size = int(page_size)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if capacity % page_size != 0:
            raise ValueError(
                f"page_size ({page_size}) must divide the KV capacity "
                f"({capacity}) so page tables tile the positions axis "
                f"exactly")
        self.page_size = page_size
        self.pages_per_slot = capacity // page_size
        P = (num_slots * self.pages_per_slot if num_pages is None
             else int(num_pages))
        if P < 1:
            raise ValueError(f"num_pages must be >= 1, got {P}")
        self.num_pages = P
        # host page bookkeeping; the device copy of the table follows it
        self.page_refs = np.zeros((P,), np.int32)
        self._free_pages = list(range(P))
        heapq.heapify(self._free_pages)   # smallest page first: deterministic
        self._free_page_set = set(self._free_pages)
        self.table = np.full((num_slots, self.pages_per_slot), P, np.int32)
        # its device copy, refreshed on first use after host edits
        self._table_dev = torch.full((num_slots, self.pages_per_slot), P,
                                     dtype=torch.int32, device=device)
        self._table_stale = False
        self.cow_copies = 0
        self.page_evictions = 0
        self.prefix = PrefixCache(page_size) if prefix_cache else None
        # "auto"/"on": decode through decode_paged (the kernel on the card,
        # its plain version on the CPU); "off": the dense composition
        self.kernel = kernel
        super().__init__(spec, num_slots, device)

    # ------------------------------------------------------------------
    # state containers
    # ------------------------------------------------------------------
    def _fresh_cache(self) -> Dict[str, Any]:
        # page num_pages is the scratch page (module docstring)
        return self.spec.paged_cache(self.num_pages + 1, self.page_size,
                                     self.device)

    def _sync_table(self) -> None:
        """Mark the device table stale after a host-side table edit."""
        self._table_stale = True

    @property
    def table_dev(self) -> torch.Tensor:
        """The page table on the pool's device, (num_slots,
        pages_per_slot) int32: always the same tensor, brought up to date
        with the host table (without a host sync) when it is read."""
        if self._table_stale:
            copy_from_host(self._table_dev, self.table)
            self._table_stale = False
        return self._table_dev

    @property
    def kernel_active(self) -> bool:
        """Whether decode reads the pages in place (``decode_paged``)."""
        return self.kernel != "off"

    # ------------------------------------------------------------------
    # page refcounting / allocation
    # ------------------------------------------------------------------
    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    def evictable_page_count(self) -> int:
        """Pages reclaimable WITHOUT preempting anyone (trie-only refs)."""
        return self.prefix.evictable_pages(self) \
            if self.prefix is not None else 0

    def ref_page(self, pid: int) -> None:
        if not 0 <= pid < self.num_pages:
            raise ValueError(f"page {pid} out of range [0, {self.num_pages})")
        if self.page_refs[pid] <= 0:
            raise RuntimeError(f"ref_page({pid}) on a free page (allocator "
                               f"bug: free pages have no owner to share)")
        self.page_refs[pid] += 1

    def unref_page(self, pid: int) -> bool:
        """Drop one reference; returns True when the page became free."""
        if not 0 <= pid < self.num_pages:
            raise ValueError(f"page {pid} out of range [0, {self.num_pages})")
        if pid in self._free_page_set or self.page_refs[pid] <= 0:
            raise RuntimeError(f"double free of page {pid} (already free; "
                               f"pool/trie bug)")
        self.page_refs[pid] -= 1
        if self.page_refs[pid] == 0:
            heapq.heappush(self._free_pages, pid)
            self._free_page_set.add(pid)
            return True
        return False

    def alloc_page(self) -> int:
        """Pop a free page (refcount 1 for the caller's mapping). Under
        pressure, least-recently-matched trie-only pages are reclaimed
        first; raises :class:`PagePoolExhausted` when even the trie has
        nothing to give, the caller's cue to preempt."""
        if not self._free_pages and self.prefix is not None:
            self.page_evictions += self.prefix.evict(self, 1)
        if not self._free_pages:
            raise PagePoolExhausted(
                f"page pool exhausted: {self.num_pages} pages all "
                f"referenced and nothing evictable")
        pid = heapq.heappop(self._free_pages)
        self._free_page_set.discard(pid)
        self.page_refs[pid] = 1
        return pid

    # ------------------------------------------------------------------
    # slot mapping (the mutable side of the page table)
    # ------------------------------------------------------------------
    def _unmap_slot(self, slot: int) -> None:
        sent = self.num_pages
        for pid in self.table[slot]:
            if pid != sent:
                self.unref_page(int(pid))
        self.table[slot, :] = sent
        self._sync_table()

    def release(self, slot: int) -> None:
        """Free the slot AND unreference its pages: exclusively owned pages
        (generated suffix, CoW forks) return to the free pool at once;
        trie-cached prompt pages stay warm for the next request with the
        same prefix."""
        super().release(slot)         # range + double-free validation
        self._unmap_slot(slot)

    def reset(self) -> None:
        self.page_refs[:] = 0
        self._free_pages = list(range(self.num_pages))
        heapq.heapify(self._free_pages)
        self._free_page_set = set(self._free_pages)
        self.table[:] = self.num_pages
        self._sync_table()
        if self.prefix is not None:
            # the cached pages died with the pool; a fresh trie (not
            # clear()) avoids walking unref_page over freed state
            self.prefix = PrefixCache(self.page_size)
        super().reset()

    def reset_row(self, slot: int) -> None:
        self._unmap_slot(slot)
        super().reset_row(slot)

    def _copy_page(self, src: int, dst: int) -> None:
        """One page-to-page copy of every cache leaf across all layers (the
        CoW fork; an int8 cache's scale pages go with their rows)."""
        for leaf in self.cache.values():
            leaf[:, dst] = leaf[:, src]

    def ensure_writable(self, slot: int, start: int, end: int) -> int:
        """Make positions ``[start, end)`` of ``slot`` safely writable
        BEFORE a step writes them: unmapped pages are allocated; shared
        pages (refcount > 1) are forked copy-on-write (page copy, table
        entry swung to the fork, old page unref'd). Returns the number of
        forks. May raise :class:`PagePoolExhausted`; mappings made so far
        stay valid, so the caller preempts a victim and retries."""
        if end <= start:
            return 0
        end = min(end, self.capacity)
        sent = self.num_pages
        ncow = 0
        for p in range(start // self.page_size,
                       (end - 1) // self.page_size + 1):
            pid = int(self.table[slot, p])
            if pid == sent:
                self.table[slot, p] = self.alloc_page()
                self._sync_table()
            elif self.page_refs[pid] > 1:
                fork = self.alloc_page()
                try:
                    self._copy_page(pid, fork)
                except Exception:
                    # the copy died before the fork was mapped: hand it back
                    # (fresh refcount is 1) instead of stranding it until
                    # the next reset()
                    self.unref_page(fork)
                    raise
                self.table[slot, p] = fork
                self._sync_table()
                self.unref_page(pid)
                ncow += 1
        self.cow_copies += ncow
        return ncow

    def map_prefix(self, slot: int, page_ids: Sequence[int]) -> None:
        """Map a trie hit's pages into the slot's table (positions
        ``[0, len(page_ids) * page_size)``): one refcount bump per page,
        no prefill."""
        for i, pid in enumerate(page_ids):
            if self.table[slot, i] != self.num_pages:
                raise RuntimeError(f"map_prefix over occupied entry "
                                   f"({slot}, {i})")
            self.ref_page(int(pid))
            self.table[slot, i] = int(pid)
        self._sync_table()

    def seat_prefix(self, slot: int, page_ids: Sequence[int],
                    prefill_pos: int) -> None:
        """Seat a prefix-hit admission: map the shared pages, position the
        chunked prefill at ``prefill_pos``, and fork every mapped page at
        or beyond it up front. Decode steps interleave with chunked
        prefill and write (masked) garbage at the slot's length each step;
        those writes must never land in a page another request reads."""
        self.map_prefix(slot, page_ids)
        hit_len = len(page_ids) * self.page_size
        self.starts[slot] = prefill_pos
        self.ensure_writable(slot, prefill_pos,
                             max(hit_len, prefill_pos + 1))

    def cache_prefix(self, slot: int, tokens) -> int:
        """Publish the slot's freshly prefilled FULL prompt pages into the
        trie (once per request, when its prefill completes). The trailing
        partial page keeps taking this slot's decode writes, so it is not
        cached."""
        if self.prefix is None:
            return 0
        n_full = int(np.asarray(tokens).reshape(-1).shape[0]) \
            // self.page_size
        if n_full == 0:
            return 0
        pages = [int(p) for p in self.table[slot, :n_full]]
        if any(p == self.num_pages for p in pages):
            raise RuntimeError(f"cache_prefix: slot {slot} prompt pages "
                               f"not fully mapped: {pages}")
        return self.prefix.insert(tokens, pages, self)

    def import_pages(self, *args, **kwargs):
        raise NotImplementedError("cross-pool page transfer (disaggregated "
                                  "prefill/decode) is a later slice")

    seat_pages = import_pages

    # ------------------------------------------------------------------
    # model steps over pages
    # ------------------------------------------------------------------
    def _scatter_cols(self, dense: Dict[str, Any], tables, positions) -> None:
        """Write the dense view's rows at ``positions`` ((B, W) absolute,
        aligned with the dense batch) back into the pages through
        ``tables`` ((B, pages_per_slot)), every leaf (scales too);
        sentinel entries and positions past the table are dropped (to the
        scratch page)."""
        B, W = positions.shape
        _, page, offs = page_writes(positions, tables, self.num_pages,
                                    self.page_size, scratch=True)
        rows = torch.arange(B, device=positions.device)[:, None] \
            .expand(B, W).reshape(-1)
        # a dropped position may lie past the dense view: any row will do
        cols = positions.clamp(0, dense["k"].shape[3] - 1).reshape(-1)
        for key, leaf in self.cache.items():
            leaf[:, page, :, offs] = dense[key][:, rows, :, cols]

    def run_decode(self, engine: Any, tokens, pos) -> torch.Tensor:
        """One decode step for every slot over the pages (updated in
        place); returns the (num_slots, 1, V) logits."""
        pos = torch.as_tensor(pos, device=self.device).long()
        if self.kernel_active:
            return engine.decode_paged(self.cache, tokens, pos,
                                       self.table_dev, scratch_page=True)
        dense = self.spec.dense_from_pages(self.cache, self.table_dev)
        logits = engine.decode(dense, tokens, pos)
        self._scatter_cols(dense, self.table_dev, pos[:, None])
        return logits

    def run_prefill_chunk(self, engine: Any, ids, slot: int, start: int,
                          last_idx: int) -> torch.Tensor:
        """One prefill chunk (1, C) into ``slot``'s pages at ``start``
        (the pages covering the chunk's true tokens must be writable: the
        engine calls :meth:`ensure_writable` first). Gathers the slot's
        pages up to the chunk's end, runs the window-masked chunk against
        them and writes the chunk's C rows back through the table.
        Returns the (1, 1, V) logits of chunk position ``last_idx``."""
        C = int(np.shape(ids)[1])
        n = min(self.pages_per_slot, -(-(start + C) // self.page_size))
        row = self.table_dev[slot:slot + 1, :n]
        dense = self.spec.dense_from_pages(self.cache, row)
        logits = engine.prefill_chunk(dense, ids, 0, start, last_idx)
        cols = start + torch.arange(C, device=self.device)[None]
        self._scatter_cols(dense, row, cols)
        return logits

    def run_verify(self, engine: Any, tokens, pos, draft, draft_len,
                   generator, temperature: float, greedy: bool, top_k: int,
                   top_p: float):
        """Speculative verify over the pages (``InferenceEngine.verify_k``'s
        semantics; ``tokens`` (num_slots, K+1)), updated in place; returns
        ``(out, n_emit)``. On a kernel pool with K+1 <= ``MAX_QUERY_ROWS``
        the forward is ``decode_paged`` with T = K+1 (the paged kernel on
        the card, a captured step with ``enable_cuda_graph``), each row's
        writes through the table, those of unmapped positions to the
        scratch page. Otherwise (wider chunks, or ``kernel="off"``) it is
        the dense composition: gather the slots' dense view, run the
        contiguous (B, K+1) forward, write the K+1 columns back."""
        from ..inference.engine import _filter_logits
        from .spec_decode.verify import make_verify_fn

        if self.kernel_active and tokens.shape[1] <= MAX_QUERY_ROWS:
            def forward(cache, tokens, pos):
                return engine.decode_paged(cache, tokens, pos.long(),
                                           self.table_dev, scratch_page=True)
        else:
            if engine.decode_graphs is not None:
                raise ValueError(
                    "a captured verify step reads the pages in place through "
                    "the paged kernel (kernel on, K+1 <= "
                    f"{MAX_QUERY_ROWS}); the dense composition builds a new "
                    "view of the pages at every step, which cannot be "
                    "captured")

            def forward(cache, tokens, pos):
                dense = self.spec.dense_from_pages(cache, self.table_dev)
                logits = engine.decode(dense, tokens, pos)
                cols = pos.long()[:, None] + torch.arange(
                    tokens.shape[1], device=self.device)[None]
                self._scatter_cols(dense, self.table_dev, cols)
                return logits

        verify = make_verify_fn(forward, _filter_logits)
        return verify(self.cache, tokens,
                      torch.as_tensor(pos, device=self.device), draft,
                      draft_len, generator, temperature, greedy, top_k, top_p)

    # ------------------------------------------------------------------
    # admission (SlotPool API, paged storage)
    # ------------------------------------------------------------------
    def prefill_target(self, slots, width: int):
        """A fresh (L, len(slots), KV, width, D) cache for the prefill to
        write; :meth:`admit_rows` moves it into the slots' pages."""
        spec = dataclasses.replace(self.spec, max_seq_len=int(width))
        return spec.stacked_cache(len(slots), self.device), None

    def admit_rows(self, cache, slots, lengths) -> None:
        """Back the first ``lengths[i]`` positions of ``slots[i]`` with
        pages and copy row i of the prefill ``cache`` into them."""
        slots = np.asarray(slots, np.int64)
        lengths = np.asarray(lengths, np.int64)
        if np.any(lengths > self.capacity):
            raise ValueError(f"sequence length {int(lengths.max())} exceeds "
                             f"slot capacity {self.capacity}")
        for s, n in zip(slots, lengths):
            self.ensure_writable(int(s), 0, int(n))
        width = cache["k"].shape[3]
        pos = np.arange(width)[None].repeat(len(slots), 0)
        pos[pos >= lengths[:, None]] = self.capacity    # dropped
        self._scatter_cols(cache, self.table_dev[torch.as_tensor(slots)],
                           torch.as_tensor(pos, device=self.device))
        self.starts[slots] = lengths

    # ------------------------------------------------------------------
    # audit / stats
    # ------------------------------------------------------------------
    @property
    def page_nbytes(self) -> int:
        """Bytes one page occupies across every cache leaf and layer (an
        int8 cache's scale pages included)."""
        return sum(leaf[:, 0].numel() * leaf.element_size()
                   for leaf in self.cache.values())

    def page_stats(self) -> dict:
        free = len(self._free_pages)
        stats = {"pages_total": self.num_pages,
                 "pages_free": free,
                 "pages_in_use": self.num_pages - free,
                 "refcounted_pages": int(np.sum(self.page_refs > 1)),
                 "cow_copies": self.cow_copies,
                 "page_evictions": self.page_evictions,
                 "page_size": self.page_size,
                 "page_bytes": self.page_nbytes}
        if self.prefix is not None:
            stats.update(
                prefix_hits=self.prefix.hits,
                prefix_misses=self.prefix.misses,
                prefix_hit_tokens=self.prefix.hit_tokens,
                prefix_nodes=self.prefix.num_nodes,
                prefix_evictable_pages=self.evictable_page_count())
        return stats

    def consistency_errors(self) -> List[str]:
        """SlotPool's audit plus the page bookkeeping invariants: the
        free-page heap and set agree, every refcount equals the references
        actually held (table entries + trie nodes), zero-ref pages are
        exactly the free ones, free slots map nothing, and every live
        slot's ``[0, length)`` positions are page-backed."""
        errors = super().consistency_errors()
        P = sent = self.num_pages
        if len(self._free_pages) != len(self._free_page_set):
            errors.append(f"free page heap ({len(self._free_pages)}) and "
                          f"set ({len(self._free_page_set)}) sizes differ")
        if set(self._free_pages) != self._free_page_set:
            errors.append("free page heap and set mirrors disagree")
        bad = [p for p in self._free_page_set if not 0 <= p < P]
        if bad:
            errors.append(f"free pages out of range: {sorted(bad)}")
        held = np.zeros((P,), np.int64)
        for pid in self.table.reshape(-1):
            pid = int(pid)
            if pid == sent:
                continue
            if not 0 <= pid < P:
                errors.append(f"table references page {pid} out of range")
                continue
            held[pid] += 1
        if self.prefix is not None:
            for pid, c in self.prefix.page_counts().items():
                if not 0 <= pid < P:
                    errors.append(f"trie references page {pid} out of range")
                else:
                    held[pid] += c
        mism = np.nonzero(held != self.page_refs)[0]
        if len(mism):
            errors.append(
                f"page refcounts disagree with held references at pages "
                f"{mism[:8].tolist()}: "
                f"refs={self.page_refs[mism][:8].tolist()} "
                f"held={held[mism][:8].tolist()}")
        zero_ref = set(np.nonzero(self.page_refs == 0)[0].tolist())
        if zero_ref != self._free_page_set:
            errors.append(
                f"zero-ref pages != free pages: only-zero-ref="
                f"{sorted(zero_ref - self._free_page_set)[:8]} "
                f"only-free={sorted(self._free_page_set - zero_ref)[:8]}")
        for slot in range(self.num_slots):
            row = self.table[slot]
            if slot in self._free_set:
                if np.any(row != sent):
                    errors.append(f"free slot {slot} still maps pages "
                                  f"{row[row != sent].tolist()}")
                continue
            n_live = -(-int(self.starts[slot]) // self.page_size)
            if np.any(row[:n_live] == sent):
                errors.append(
                    f"slot {slot} live region [0, {int(self.starts[slot])})"
                    f" has unmapped pages: row={row[:n_live].tolist()}")
        return errors
