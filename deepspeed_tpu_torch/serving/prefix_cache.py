"""Radix-tree prefix cache over paged KV (the port's copy of
``deepspeed_tpu/serving/prefix_cache.py``; SGLang's RadixAttention idea).

The trie is host-only bookkeeping: it maps token-id prefixes to page ids
of the :class:`~deepspeed_tpu_torch.serving.paged_pool.PagedKVPool`. Each
edge is one FULL page of ``page_size`` token ids (a tuple key), each node
holds the page id whose K/V rows were computed for exactly that prefix,
and the trie itself owns ONE refcount on every cached page, independent of
any slot's mapping, so a request can retire while its prompt pages stay
warm for the next request with the same prefix.

Only full pages are ever cached: a partially filled page is still being
written by its owning slot (decode appends land there), so sharing it
would let one request's writes corrupt another's attention window. The
K/V content of a page is a function of (token ids, positions) for this
model family, so equal full-page prefixes give equal cache rows.

Eviction is leaf-LRU: when the pool runs out of free pages it asks the
trie to drop its least-recently-matched LEAF nodes (dropping leaves first
converges to dropping whole cold branches). Unref-ing a node's page frees
it only when no live slot still maps it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _Node:
    __slots__ = ("children", "page", "stamp", "parent", "key")

    def __init__(self, parent: Optional["_Node"], key, page: int, stamp: int):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.key = key          # the full-page token tuple edge from parent
        self.page = page        # pool page id holding this prefix's K/V
        self.stamp = stamp      # LRU clock of the last match touching it


class PrefixCache:
    """Token-id radix tree over refcounted KV pages (one page per edge)."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.root = _Node(None, None, -1, 0)
        self._clock = 0
        # lookup accounting (match() only; peek() is cost-estimation and
        # must not disturb LRU order or the hit counters)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_nodes = 0

    # ------------------------------------------------------------------
    def _keys(self, tokens) -> List[Tuple[int, ...]]:
        """Full-page token tuples of ``tokens`` (the trailing partial
        page, if any, is dropped — never cached, never matched)."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        n = len(toks) // ps
        return [tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                for i in range(n)]

    @property
    def num_nodes(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += len(node.children)
            stack.extend(node.children.values())
        return count

    def page_counts(self) -> Dict[int, int]:
        """page id -> number of trie references (for the pool's refcount
        audit; a page may legally back several nodes only if insert ever
        deduped — it doesn't today, so counts are 0/1)."""
        counts: Dict[int, int] = {}
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            counts[node.page] = counts.get(node.page, 0) + 1
            stack.extend(node.children.values())
        return counts

    # ------------------------------------------------------------------
    def match(self, tokens) -> List[int]:
        """Longest cached full-page prefix of ``tokens``: the page ids to
        map into the admitting slot, in order. Touches LRU stamps and
        the hit/miss counters (one lookup = one hit or one miss)."""
        self._clock += 1
        pages: List[int] = []
        node = self.root
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages

    def peek(self, tokens) -> int:
        """Number of full pages a :meth:`match` would return, WITHOUT
        touching LRU stamps or counters — admission cost estimation."""
        n = 0
        node = self.root
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            n += 1
            node = child
        return n

    def insert(self, tokens, page_ids: Sequence[int], pool) -> int:
        """Cache ``tokens``'s full pages, backed by ``page_ids`` (the
        admitting slot's pages, in order — one per full page). Existing
        nodes are kept (equal prefixes have bitwise-equal pages, so the
        older copy is as good and already shared); each NEW node takes
        one ``pool.ref_page`` on its page so the cache outlives the
        slot. Returns the number of new nodes created."""
        self._clock += 1
        keys = self._keys(tokens)
        if len(page_ids) < len(keys):
            keys = keys[:len(page_ids)]
        node = self.root
        created = 0
        for key, pid in zip(keys, page_ids):
            child = node.children.get(key)
            if child is None:
                pool.ref_page(int(pid))
                child = _Node(node, key, int(pid), self._clock)
                node.children[key] = child
                created += 1
                self.inserted_pages += 1
            else:
                child.stamp = self._clock
            node = child
        return created

    # ------------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, pool, need: int = 1) -> int:
        """Drop least-recently-matched LEAF nodes until ``need`` pages
        have actually been FREED (a node whose page a live slot still
        maps frees nothing now — the node is dropped anyway, releasing
        the trie's claim). Returns the number of pages freed."""
        freed = 0
        while freed < need:
            leaves = self._leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            victim.parent.children.pop(victim.key, None)
            self.evicted_nodes += 1
            if pool.unref_page(victim.page):
                freed += 1
        return freed

    def evictable_pages(self, pool) -> int:
        """Pages that would return to the free pool if the WHOLE trie
        were dropped right now: cached pages no live slot maps (their
        only reference is the trie's)."""
        return sum(1 for pid in self.page_counts()
                   if int(pool.page_refs[pid]) == 1)

    def clear(self, pool) -> None:
        """Drop every node, releasing the trie's page references."""
        stack = list(self.root.children.values())
        self.root.children.clear()
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            pool.unref_page(node.page)
