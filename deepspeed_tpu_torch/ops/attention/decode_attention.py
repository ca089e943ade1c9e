"""Single-token cached attention: the CUDA kernel's wrapper and its plain
version.

Port of ``deepspeed_tpu/ops/attention/decode_attention.py``. The kernel is
``ops/csrc/decode_attention.cu``, which replaces the TPU kernel
``decode_attention`` (decode_attention.py:203 in the JAX package;
``pallas_call`` at :318, body ``_decode_kernel`` at :128). Its header says
what bounds it on the H100 (bytes) and how it keeps reads coalesced.

Cache layout: one layer's K/V slice is (B, KV, S, D), positions-major, in
the compute dtype. The JAX package stores positions-minor (B, KV, D, S) and
packs int8 into int32 words; both exist only for the TPU's lane tiling, so
the port does not keep them. Tests compare the logical K/V by transposing.

:func:`decode_attention` takes :func:`decode_attention_reference` only for
tensors on the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def alibi_slopes(n_head: int) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.) as (H,) fp32, the JAX package's
    ``transformer_lm.alibi_slopes``."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_head).is_integer():
        return torch.tensor(pow2_slopes(n_head), dtype=torch.float32)
    closest = 2 ** math.floor(math.log2(n_head))
    extra = pow2_slopes(2 * closest)[0::2][: n_head - closest]
    return torch.tensor(pow2_slopes(closest) + extra, dtype=torch.float32)


def decode_attention_reference(q, k_cache, v_cache, lengths, scale,
                               alibi_slopes=None):
    """Plain PyTorch twin of the kernel in fp32: the einsum decode math of
    the JAX ``CachedAttention`` (transformer_lm.py:551-593) at T=1, with
    positions ``>= lengths[b]`` masked and ALiBi ``slope·(pos − (len−1))``."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    k32, v32 = k_cache.float(), v_cache.float()
    if KV != H:
        k32 = k32.repeat_interleave(H // KV, dim=1)
        v32 = v32.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k32) * scale
    pos = torch.arange(S, device=q.device)
    lengths = lengths.to(q.device).long().reshape(B, 1)
    if alibi_slopes is not None:
        rel = (pos[None, :] - (lengths - 1)).float()            # (B, S)
        s = s + alibi_slopes.float().to(q.device)[None, :, None] \
            * rel[:, None, :]
    s = s.masked_fill((pos[None, :] >= lengths)[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a free slot (length 0) attends to nothing: output 0, as the kernel's
    # max(l, 1e-30) gives, instead of the uniform row softmax would make
    p = p * (lengths > 0).reshape(B, 1, 1)
    return torch.einsum("bhs,bhsd->bhd", p, v32).to(q.dtype)


def window_attention_reference(q, k_cache, v_cache, starts, scale,
                               alibi_slopes=None):
    """T query rows per sequence over its cache rows, in fp32: q (B, T, H,
    D), caches (B, KV, S, D); row t of sequence b sees positions ``<=
    starts[b] + t`` with ALiBi ``slope·(pos − (starts[b] + t))``. This is
    the window-masked einsum of the JAX ``CachedAttention``
    (transformer_lm.py:494-593), which has no kernel there either.
    Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    k32, v32 = k_cache.float(), v_cache.float()
    if KV != H:
        k32 = k32.repeat_interleave(H // KV, dim=1)
        v32 = v32.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bthd,bhsd->bhts", q.float(), k32) * scale
    pos = torch.arange(S, device=q.device)
    limit = starts.to(q.device).long().reshape(B, 1) \
        + torch.arange(T, device=q.device)[None]                  # (B, T)
    if alibi_slopes is not None:
        rel = (pos[None, None, :] - limit[:, :, None]).float()       # (B,T,S)
        s = s + alibi_slopes.float().to(q.device)[None, :, None, None] \
            * rel[:, None]
    s = s.masked_fill((pos[None, None, :] > limit[:, :, None])[:, None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bthd", p, v32).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None,
                     alibi_slopes: Optional[torch.Tensor] = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Attention of one query row per sequence over its cache.

    Args:
      q: (B, H, D).
      k_cache, v_cache: one layer's (B, KV, S, D), H % KV == 0 (query head
        h reads KV head h // (H // KV)).
      lengths: (B,) int32 (or an int), valid positions per sequence
        INCLUDING the token just written.
      alibi_slopes: optional (H,) fp32 ALiBi slopes.
      k_scale, v_scale: the int8 KV-cache variant, not ported yet.
    Returns (B, H, D) in q's dtype. On CUDA each launch adds one to
    ``decode_attention.launches``.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV cache (kv_cache_quant scales) is a later slice of the "
            "port")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention wants q (B,H,D) and caches "
                         f"(B,KV,S,D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    _, KV, S, Dc = k_cache.shape
    if k_cache.shape[0] != B or Dc != D or H % KV != 0:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not torch.is_tensor(lengths) or lengths.dim() == 0:
        lengths = torch.full((B,), int(lengths), dtype=torch.int32,
                             device=q.device)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    from ..op_builder import DTYPE_CODES, launch

    if q.dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode kernel supports dtypes {list(DTYPE_CODES)} "
                         f"and head dims {SUPPORTED_HEAD_DIMS}; got "
                         f"{q.dtype}, D={D}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"q/cache dtypes differ: {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != q.device:
        raise ValueError(f"lengths must be (B,) int32 on {q.device}; got "
                         f"{tuple(lengths.shape)} {lengths.dtype} "
                         f"{lengths.device}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache)]
    if alibi_slopes is not None:
        if alibi_slopes.shape != (H,) or alibi_slopes.dtype != torch.float32:
            raise ValueError("alibi_slopes must be (H,) float32")
        tensors.append(("alibi_slopes", alibi_slopes))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"decode kernel needs {name} contiguous, "
                             f"16-byte aligned, on {q.device}")
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    launch("decode_attention", q.device, DTYPE_CODES[q.dtype], q.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
           alibi_slopes.data_ptr() if alibi_slopes is not None else None,
           out.data_ptr(), B, H, KV, S, D, float(scale))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
