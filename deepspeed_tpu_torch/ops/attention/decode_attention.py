"""Single-token cached attention: the CUDA kernel's wrapper and its plain
version.

Port of ``deepspeed_tpu/ops/attention/decode_attention.py``. The kernel is
``ops/csrc/decode_attention.cu``, which replaces the TPU kernel
``decode_attention`` (decode_attention.py:203 in the JAX package;
``pallas_call`` at :318, body ``_decode_kernel`` at :128). Its header says
what bounds it on the H100 (bytes) and how it keeps reads coalesced.

Cache layout: one layer's K/V slice is (B, KV, S, D), positions-major, in
the compute dtype, or int8 with fp32 per-row scales (B, KV, S) for the int8
KV cache (:func:`quantize_kv_rows`). The JAX package stores positions-minor
(B, KV, D, S) and can pack int8 into int32 words (``kv_cache_packed``); both
exist only for the TPU's lane tiling and the packing is lossless, so the port
keeps plain int8 rows. Tests compare the logical K/V by transposing.

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


def quantize_kv_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization over the last axis (the JAX
    package's ``quantize_kv_rows``): returns (int8 values, fp32 scales) with
    ``x ≈ int8 * scale[..., None]``; one scale per (batch, kv-head,
    position). Rounding is half to even, values clip to ±127 and the scale
    is floored at 1e-8, so an all-zero row stays finite."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _expand_kv(k_cache, v_cache, H: int, k_scale=None, v_scale=None):
    """fp32 K/V (and scales) with KV heads repeated to the H query heads."""
    k32, v32 = k_cache.float(), v_cache.float()
    KV = k_cache.shape[1]
    scales = (k_scale, v_scale)
    if KV != H:
        k32 = k32.repeat_interleave(H // KV, dim=1)
        v32 = v32.repeat_interleave(H // KV, dim=1)
        if k_scale is not None:
            scales = tuple(s.repeat_interleave(H // KV, dim=1)
                           for s in scales)
    return k32, v32, scales


def decode_attention_reference(q, k_cache, v_cache, lengths, scale,
                               alibi_slopes=None, k_scale=None,
                               v_scale=None):
    """Plain PyTorch twin of the kernel in fp32: the einsum decode math of
    the JAX ``CachedAttention`` (transformer_lm.py:551-593) at T=1, with
    positions ``>= lengths[b]`` masked and ALiBi ``slope·(pos − (len−1))``.
    An int8 cache passes ``k_scale``/``v_scale`` (B, KV, S): the K scales
    multiply the scores and the V scales the probabilities, as in the JAX
    einsum path (transformer_lm.py:508-577), so the cache is never
    dequantized into a full copy."""
    B, H, D = q.shape
    S = k_cache.shape[2]
    k32, v32, (ks, vs) = _expand_kv(k_cache, v_cache, H, k_scale, v_scale)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k32) * scale
    if ks is not None:
        s = s * ks.float()
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
    if vs is not None:
        p = p * vs.float()
    return torch.einsum("bhs,bhsd->bhd", p, v32).to(q.dtype)


def window_attention_reference(q, k_cache, v_cache, starts, scale,
                               alibi_slopes=None, k_scale=None,
                               v_scale=None):
    """T query rows per sequence over its cache rows, in fp32: q (B, T, H,
    D), caches (B, KV, S, D); row t of sequence b sees positions ``<=
    starts[b] + t`` with ALiBi ``slope·(pos − (starts[b] + t))``. This is
    the window-masked einsum of the JAX ``CachedAttention``
    (transformer_lm.py:494-593), which has no kernel there either. An int8
    cache passes (B, KV, S) ``k_scale``/``v_scale``, folded into the scores
    and probabilities as in :func:`decode_attention_reference`.
    Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    S = k_cache.shape[2]
    k32, v32, (ks, vs) = _expand_kv(k_cache, v_cache, H, k_scale, v_scale)
    s = torch.einsum("bthd,bhsd->bhts", q.float(), k32) * scale
    if ks is not None:
        s = s * ks.float()[:, :, None]
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
    if vs is not None:
        p = p * vs.float()[:, :, None]
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
      k_scale, v_scale: (B, KV, S) fp32 per-row scales of an int8 cache
        (row value = int8 * scale); both or neither.
    Returns (B, H, D) in q's dtype. On CUDA each launch adds one to
    ``decode_attention.launches``, or to ``decode_attention.int8_launches``
    for an int8 cache.
    """
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("provide both k_scale and v_scale or neither")
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
    if quantized and (k_scale.shape != k_cache.shape[:3]
                      or v_scale.shape != k_scale.shape):
        raise ValueError(f"scales must be {tuple(k_cache.shape[:3])}; got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale, alibi_slopes, k_scale,
                                          v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    from ..op_builder import DTYPE_CODES, launch

    if q.dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode kernel supports dtypes {list(DTYPE_CODES)} "
                         f"and head dims {SUPPORTED_HEAD_DIMS}; got "
                         f"{q.dtype}, D={D}")
    cache_dtype = torch.int8 if quantized else q.dtype
    if not (cache_dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"cache dtypes must be {cache_dtype}: got "
                         f"{k_cache.dtype}, {v_cache.dtype} for q "
                         f"{q.dtype}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != q.device:
        raise ValueError(f"lengths must be (B,) int32 on {q.device}; got "
                         f"{tuple(lengths.shape)} {lengths.dtype} "
                         f"{lengths.device}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache)]
    if quantized:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError("k_scale/v_scale must be float32")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
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
    slopes = alibi_slopes.data_ptr() if alibi_slopes is not None else None
    out = torch.empty_like(q)
    if quantized:
        launch("decode_attention", q.device, DTYPE_CODES[q.dtype],
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
               slopes, out.data_ptr(), B, H, KV, S, D, float(scale),
               symbol="dstorch_decode_attention_int8")
        decode_attention.int8_launches += 1
        return out
    launch("decode_attention", q.device, DTYPE_CODES[q.dtype], q.data_ptr(),
           k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
           slopes, out.data_ptr(), B, H, KV, S, D, float(scale))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.int8_launches = 0
