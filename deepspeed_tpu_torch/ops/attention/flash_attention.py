"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``deepspeed_tpu/ops/attention/flash_attention.py`` (forward only; the
backward kernels belong to the training slice). The kernel is
``ops/csrc/flash_attention_fwd.cu``, which replaces the TPU kernel
``_flash_fwd`` (flash_attention.py:140 in the JAX package, both of its
``pallas_call``s). Its header says what bounds it on the H100.

Layout is the JAX package's: q (B, T, H, D); k/v (B, S, KV, D) with
H % KV == 0 (grouped-query heads are mapped inside the kernel, so callers do
not repeat K/V); out (B, T, H, D); lse (B, H, T) fp32.

:func:`flash_attention` takes :func:`mha_reference` only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises; it never falls
back. There is no sequence-length crossover: the TPU's tuned
``use_flash_by_default`` does not carry over, every call on CUDA launches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def mha_reference(q, k, v, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention in fp32: the kernel's twin. Returns
    ``(out in q's dtype, lse (B, H, T) fp32)``; the JAX ``mha_reference``
    returns ``out`` alone, the kernel's twin must cover both outputs."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k32, v32 = k.float(), v.float()
    if KV != H:
        k32 = k32.repeat_interleave(H // KV, dim=2)
        v32 = v32.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k32) * scale
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v32)
    return out.to(q.dtype), lse


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B,T,H,D) and k/v "
                         f"(B,S,KV,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if causal and k.shape[1] != T:
        raise ValueError(
            f"causal flash attention requires seq_q == seq_k (got {T} vs "
            f"{k.shape[1]}); use causal=False for cross-attention")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax(q kᵀ · scale) v`` → ``(out (B,T,H,D), lse (B,H,T) fp32)``.

    ``scale`` defaults to 1/sqrt(D). CPU tensors take
    :func:`mha_reference`; CUDA tensors launch the kernel (each launch adds
    one to ``flash_attention.launches``)."""
    _check(q, k, v, causal)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    from ..op_builder import DTYPE_CODES, launch

    if q.dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel supports dtypes {list(DTYPE_CODES)} "
                         f"and head dims {SUPPORTED_HEAD_DIMS}; got "
                         f"{q.dtype}, D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs contiguous 16-byte aligned "
                             f"{name}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch("flash_attention_fwd", q.device, DTYPE_CODES[q.dtype], q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T,
           S, H, KV, D, float(scale), int(bool(causal)))
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
