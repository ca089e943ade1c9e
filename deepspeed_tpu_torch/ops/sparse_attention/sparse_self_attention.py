"""Block-sparse self-attention over a sparsity-config layout: the port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.

:func:`block_sparse_attention` is the gather formulation: for each (head,
query block) the layout selects at most M key blocks, which are gathered
into a dense (…, M·block, head_dim) tile, and attention runs as ordinary
batched products with compute O(nq · M · block²) instead of O(T²). Padded
gather slots (rows with fewer than M live blocks) point at block 0 and are
killed by the mask. The JAX package writes it in plain XLA, with no Pallas
kernel, and routes granules under 128 and key-padding masks to it; here it
is plain PyTorch, differentiable through autograd, on any device. It is
exact at any granule, and it is the numerics reference of the fused kernels
(``block_sparse_kernel.py``).

:class:`SparseSelfAttention` chooses between the two by shape before
anything runs, as the JAX module does: the kernels when the granule passes
``supports_pallas`` and no key-padding mask is given, the gather
formulation otherwise. It never falls back after a failure.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .block_sparse_kernel import block_sparse_flash_attention, supports_pallas
from .sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)

NEG_INF = -1e30


def layout_to_gather_indices(layout: np.ndarray):
    """(H, nq, nk) 0/1 layout → (indices (H, nq, M), valid (H, nq, M)) where
    M = max live blocks over all (head, q-block) rows."""
    H, nq, nk = layout.shape
    counts = layout.sum(-1)
    M = max(1, int(counts.max()))
    idx = np.zeros((H, nq, M), np.int32)
    valid = np.zeros((H, nq, M), bool)
    for h in range(H):
        for i in range(nq):
            js = np.nonzero(layout[h, i])[0]
            idx[h, i, :len(js)] = js
            valid[h, i, :len(js)] = True
    return idx, valid


def block_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           key_padding_mask=None):
    """q/k/v: (B, T, H, D); ``layout``: host (H, T//block, T//block);
    ``key_padding_mask``: (B, T) bool, True = keep. Returns (B, T, H, D) in
    q's dtype; scores, softmax and products in fp32."""
    B, T, H, D = q.shape
    nq = T // block
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    idx_np, valid_np = layout_to_gather_indices(np.asarray(layout))
    M = idx_np.shape[-1]
    dev = q.device
    idx = torch.as_tensor(idx_np, device=dev).long()
    valid = torch.as_tensor(valid_np, device=dev)

    def blocks(x):   # (B, T, H, D) → (B, H, nq, block, D)
        return x.transpose(1, 2).reshape(B, H, nq, block, D)

    # gather key/value blocks per (h, q-block): (B, H, nq, M, block, D)
    heads = torch.arange(H, device=dev)[:, None, None]
    kg = blocks(k)[:, heads, idx]
    vg = blocks(v)[:, heads, idx]
    s = torch.einsum("bhqtd,bhqmsd->bhqtms", blocks(q).float(),
                     kg.float()) * scale            # (B, H, nq, block, M, block)

    # mask: invalid gather slots; token-level causal inside/over blocks
    mask = valid[None, :, :, None, :, None]
    if causal:
        ar = torch.arange(block, device=dev)
        q_pos = torch.arange(nq, device=dev)[:, None] * block + ar
        k_pos = idx[..., None] * block + ar                # (H, nq, M, block)
        causal_ok = q_pos[None, :, :, None, None] >= k_pos[:, :, None, :, :]
        mask = mask & causal_ok[None]
    if key_padding_mask is not None:
        kp = torch.as_tensor(key_padding_mask, device=dev).bool()
        kp = kp.reshape(B, nq, block)[:, idx]              # (B, H, nq, M, block)
        mask = mask & kp[:, :, :, None, :, :]

    s = s.masked_fill(~mask, NEG_INF)
    # a row with no live key: the softmax over -1e30 is uniform, and the
    # mask kills it afterwards
    p = torch.softmax(s.reshape(B, H, nq, block, M * block), dim=-1)
    p = p.reshape(s.shape).masked_fill(~mask, 0.0)
    o = torch.einsum("bhqtms,bhqmsd->bhqtd", p, vg.float())
    return o.reshape(B, H, T, D).transpose(1, 2).to(q.dtype)


class SparseSelfAttention:
    """≅ reference ``SparseSelfAttention`` (sparse_self_attention.py:12):
    callable taking (q, k, v) shaped (B, T, H, D) and applying the configured
    block-sparse pattern. Layouts are built once per sequence length and
    cached.

    ``kernel``: "auto" routes to the fused kernels
    (``block_sparse_kernel.py``) when the layout granule passes
    ``supports_pallas`` (block >= 128) and no key-padding mask is given,
    else the gather formulation; "pallas"/"gather" force a path (the JAX
    package's names).
    """

    def __init__(self, sparsity_config: SparsityConfig = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 kernel: str = "auto"):
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError(f"key_padding_mask_mode must be add|mul, got "
                             f"{key_padding_mask_mode!r}")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError(f"attn_mask_mode must be add|mul, got "
                             f"{attn_mask_mode!r}")
        if kernel not in ("auto", "pallas", "gather"):
            raise ValueError(f"kernel must be auto|pallas|gather, got "
                             f"{kernel!r}")
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.kernel = kernel
        self._layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None,
                 attn_mask=None):
        if attn_mask is not None:
            raise NotImplementedError(
                "dense attn_mask is not supported by the block-sparse kernel "
                "yet; express the pattern via the sparsity config layout")
        cfg = self.sparsity_config
        T = query.shape[1]
        layout = self.get_layout(T)
        causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
        keep = None
        if key_padding_mask is not None:
            # "add": additive float mask (0 keep, large-negative drop);
            # "mul": multiplicative 0/1 mask (reference mask-mode semantics)
            kpm = torch.as_tensor(key_padding_mask, device=query.device)
            keep = kpm > -1.0 if self.key_padding_mask_mode == "add" \
                else kpm > 0
        use_kernel = self.kernel == "pallas" or (
            self.kernel == "auto" and keep is None
            and supports_pallas(cfg.block, T))
        if use_kernel:
            if keep is not None:
                raise NotImplementedError(
                    "key_padding_mask is not supported by the Pallas "
                    "block-sparse kernel; use kernel=\"gather\"")
            return block_sparse_flash_attention(
                query, key, value, layout, cfg.block, causal=causal)
        return block_sparse_attention(
            query, key, value, layout, cfg.block, causal=causal,
            key_padding_mask=keep)


__all__ = [
    "SparseSelfAttention",
    "block_sparse_attention",
    "layout_to_gather_indices",
    "SparsityConfig",
    "DenseSparsityConfig",
    "FixedSparsityConfig",
    "VariableSparsityConfig",
    "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig",
    "LocalSlidingWindowSparsityConfig",
]
