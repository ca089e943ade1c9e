"""Block-sparsity layout configs: a copy of the JAX package's
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (numpy only), kept
here so that the port imports nothing of that package. ``make_layout`` gives
the same layouts bit for bit, ``random.Random(0)`` draws included.

The reference's sparsity vocabulary
(``ops/sparse_attention/sparsity_config.py:95,239,411,546,674``: Dense,
Fixed, Variable, BigBird, BSLongformer, LocalSlidingWindow).

A layout is an int32 array (num_heads, num_blocks, num_blocks): entry
[h, i, j] = 1 ⇔ head h's query block i attends to key block j. Layouts are
built on the host in numpy once per sequence length.
``attention="unidirectional"`` masks j > i at the block level; the kernels
apply token-level causal masking inside diagonal blocks.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base (≅ reference sparsity_config.py:18): common fields + helpers."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @staticmethod
    def _check_attention(attention: str) -> str:
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                f"only \"uni/bi-directional\" attention is supported, got "
                f"{attention!r}")
        return attention

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), np.int32)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend to all blocks (debug/reference)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """≅ reference FixedSparsityConfig (sparsity_config.py:95): local windows
    of ``num_local_blocks`` + global attention to the last
    ``num_global_blocks`` of each preceding window ("fixed" pattern from the
    Sparse Transformers paper).

    ``num_different_global_patterns`` rotates which sub-block of the window
    is global across heads (requires different_layout_per_head).
    """

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 requires "
                "different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                "num_different_global_patterns exceeds available patterns "
                f"({num_local_blocks // num_global_blocks})")
        self._check_attention(attention)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(H if self.different_layout_per_head else 1):
            # local windows
            for start in range(0, n, L):
                end = min(start + L, n)
                layout[h, start:end, start:end] = 1
            # global columns: pattern index rotates per head
            pat = h % self.num_different_global_patterns
            # in each local window, the pat-th G-sized sub-block (from the
            # end, reference uses the last sub-blocks) is "global"
            for start in range(0, n, L):
                first_g = start + L - (pat + 1) * G
                if first_g < 0:
                    continue
                g0, g1 = first_g, min(first_g + G, n)
                # vertical: the whole column is global (the unidirectional
                # variant is clipped by the tril below; within-window entries
                # are already covered by the local block)
                layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """≅ reference VariableSparsityConfig (sparsity_config.py:239): random
    blocks + variable-size local windows + global blocks from custom indices."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices length mismatch")
        self._check_attention(attention)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        rng = random.Random(0)
        for h in range(H if self.different_layout_per_head else 1):
            # variable local windows: cycle through the given sizes
            start = 0
            i = 0
            while start < n:
                w = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
                start = end
                i += 1
            # random blocks
            for _ in range(self.num_random_blocks):
                r, c = rng.randrange(n), rng.randrange(n)
                layout[h, r, c] = 1
            # global blocks
            for gi, idx in enumerate(self.global_block_indices):
                if idx >= n:
                    continue
                end = idx + 1
                if self.global_block_end_indices is not None:
                    end = min(self.global_block_end_indices[gi], n)
                layout[h, :, idx:end] = 1  # vertical
                if self.horizontal_global_attention:
                    layout[h, idx:end, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """≅ reference BigBirdSparsityConfig (sparsity_config.py:411):
    random + sliding-window + global-block pattern."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = self._check_attention(attention)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        rng = random.Random(0)
        for h in range(H if self.different_layout_per_head else 1):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1  # window
                # random blocks per row (unidirectional: sample from the past,
                # reference samples full row then masks)
                hi = i + 1 if self.attention == "unidirectional" else n
                for _ in range(self.num_random_blocks):
                    layout[h, i, rng.randrange(max(1, hi))] = 1
            g = min(self.num_global_blocks, n)
            layout[h, :, :g] = 1  # global columns
            layout[h, :g, :] = 1  # global rows
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """≅ reference BSLongformerSparsityConfig (sparsity_config.py:546):
    block-sparse Longformer — sliding window + global attention at given
    block indices."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = self._check_attention(attention)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        for h in range(H if self.different_layout_per_head else 1):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1
            for gi, idx in enumerate(self.global_block_indices):
                if idx >= n:
                    continue
                end = idx + 1
                if self.global_block_end_indices is not None:
                    end = min(self.global_block_end_indices[gi], n)
                layout[h, :, idx:end] = 1  # global columns
                layout[h, idx:end, :] = 1  # global rows
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """≅ reference LocalSlidingWindowSparsityConfig (sparsity_config.py:674):
    pure sliding window."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = self._check_attention(attention)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, n, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            lo = max(0, i - w)
            hi = min(n, i + w + 1) if self.attention == "bidirectional" else i + 1
            layout[0, i, lo:hi] = 1
        layout[1:] = layout[0]
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout
