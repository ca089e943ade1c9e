"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Port of ``deepspeed_tpu/ops/attention/flash_attention.py``. The forward
kernel is ``ops/csrc/flash_attention_fwd.cu`` and replaces the TPU kernel
``_flash_fwd`` (flash_attention.py:140 in the JAX package, both of its
``pallas_call``s); the backward kernels are ``ops/csrc/
flash_attention_bwd.cu``, replacing ``_bwd_dq_kernel`` (:210, launched at
:315) and ``_bwd_dkv_kernel`` (:253, launched at :340). Each source's
header says what bounds it on the H100.

The forward, dq and dk/dv kernels have two designs each, and
:func:`flash_design` names the one a call runs: ``"wgmma"`` (the tensor
cores, fed by TMA) for bf16 and fp16 at D = 64 and 128, ``"fma"`` (the fp32
FMA units) for fp32, whose 1e-4 tolerance TF32 products miss, and for D =
32, whose 64-byte rows are below the 128-byte swizzle atom.

Layout is the JAX package's: q (B, T, H, D); k/v (B, S, KV, D) with
H % KV == 0 (grouped-query heads are mapped inside the kernels, so callers
do not repeat K/V); out (B, T, H, D); lse (B, H, T) fp32.

:func:`flash_attention` is differentiable. It runs as the custom operator
``dstorch::flash_attention`` (so that a selective activation-checkpoint
policy can name it and keep its outputs instead of re-running it), whose
backward saves ``(q, k, v, out, lse)`` as the JAX ``_flash_attention_fwd``
does, computes ``delta = rowsum(dO ∘ out)`` in fp32 with plain PyTorch (the
JAX package does this outside its kernels, :310), then runs the dq and dkv
kernels. lse is an output for the serving callers and takes no gradient.

Every wrapper takes its plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel or raises; it never falls back. There is
no sequence-length crossover: the TPU's tuned ``use_flash_by_default`` does
not carry over, every call on CUDA launches. Each launch adds one to its
wrapper's ``launches``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)


def flash_design(dtype: torch.dtype, D: int) -> str:
    """The design the forward, dq and dk/dv kernels run for ``dtype`` and
    head dim ``D`` (see the module docstring): ``"wgmma"`` or ``"fma"``."""
    if dtype in (torch.bfloat16, torch.float16) and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def block_rows(D: int, tiles_of_128: int, sm_count: int) -> int:
    """Rows a block of the wgmma design takes (query rows in the forward
    and dq, keys in dk/dv): 128, two consumer warpgroups, unless that grid
    (``tiles_of_128`` blocks) would leave some of the card's ``sm_count``
    SMs idle, or D = 128, whose 128-row blocks spill registers; then 64, one
    warpgroup."""
    return 64 if D == 128 or tiles_of_128 < sm_count else 128


def design_code(dtype: torch.dtype, D: int, heads: int, rows: int,
                sm_count: int) -> int:
    """The C entry points' design argument for a kernel over ``heads``
    (batch x heads) rows of ``rows`` positions on a card of ``sm_count``
    SMs: 0 the FMA design, 1 the wgmma design with 128-row blocks, 2 with
    64-row blocks."""
    if flash_design(dtype, D) == "fma":
        return 0
    return 1 if block_rows(D, heads * -(-rows // 128), sm_count) == 128 else 2


def _design_code(t, D: int, heads: int, rows: int) -> int:
    """:func:`design_code` on ``t``'s card."""
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return design_code(t.dtype, D, heads, rows, sms)


def _repeat_kv(x, H: int):
    KV = x.shape[2]
    return x if KV == H else x.repeat_interleave(H // KV, dim=2)


def _sum_groups(dx, KV: int):
    """(B, S, H, D) gradients of repeated K/V heads summed back to KV."""
    B, S, H, D = dx.shape
    return dx if KV == H else dx.view(B, S, KV, H // KV, D).sum(3)


def _scores(q, k32, causal: bool, scale: float):
    s = torch.einsum("bthd,bshd->bhts", q.float(), k32) * scale
    if causal:
        T, S = s.shape[-2:]
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def mha_reference(q, k, v, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention in fp32: the forward kernel's twin. Returns
    ``(out in q's dtype, lse (B, H, T) fp32)``; the JAX ``mha_reference``
    returns ``out`` alone, the kernel's twin must cover both outputs."""
    H, D = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = _scores(q, _repeat_kv(k.float(), H), causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, _repeat_kv(v.float(), H))
    return out.to(q.dtype), lse


def _probs(q, k32, lse, causal, scale):
    """p = exp(s - lse) recomputed from the saved lse, fp32 (B, H, T, S)."""
    return torch.exp(_scores(q, k32, causal, scale) - lse[..., None])


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """Plain dq, the dq kernel's twin: ``ds = p ∘ (dO vᵀ − delta)`` rounded
    to k's dtype (as the TPU kernel casts it before its MXU product), then
    ``dq = ds k · scale`` in fp32, returned in q's dtype."""
    H = q.shape[2]
    k32, v32 = _repeat_kv(k.float(), H), _repeat_kv(v.float(), H)
    p = _probs(q, k32, lse, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v32)
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    return (torch.einsum("bhts,bshd->bthd", ds, k32) * scale).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dk and dv, the dkv kernel's twin: ``dv = pᵀ dO`` with p rounded
    to dO's dtype, ``dk = dsᵀ q · scale`` with ds rounded to q's dtype, fp32
    sums over each KV head's query heads, returned in k's and v's dtypes."""
    H, KV = q.shape[2], k.shape[2]
    k32, v32 = _repeat_kv(k.float(), H), _repeat_kv(v.float(), H)
    p = _probs(q, k32, lse, causal, scale)
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v32)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    return (_sum_groups(dk, KV).to(k.dtype),
            _sum_groups(dv, KV).to(v.dtype))


def attention_delta(out, do) -> torch.Tensor:
    """``delta = rowsum(dO ∘ out)`` in fp32, (B, H, T) like lse."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def mha_backward_reference(q, k, v, out, lse, do, causal: bool = True,
                           scale: Optional[float] = None):
    """Plain (dq, dk, dv) from the forward's saved tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = attention_delta(out, do)
    dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return flash_dq_reference(q, k, v, do, lse, delta, causal, scale), dk, dv


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


def _check_cuda(D: int, dtype, **tensors):
    """What every flash kernel takes; imports the builder's dtype codes."""
    from ..op_builder import DTYPE_CODES

    if dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel supports dtypes {list(DTYPE_CODES)} "
                         f"and head dims {SUPPORTED_HEAD_DIMS}; got "
                         f"{dtype}, D={D}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs contiguous 16-byte aligned "
                             f"{name}")
    return DTYPE_CODES[dtype]


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    return q.device.type


def _flash_forward(q, k, v, causal: bool, scale: float):
    """(out, lse): the plain version for CPU tensors, else the kernel."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if _device_kind(q) == "cpu":
        return mha_reference(q, k, v, causal, scale)
    from ..op_builder import launch

    code = _check_cuda(D, q.dtype, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch("flash_attention_fwd", q.device, code,
           _design_code(q, D, B * H, T), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, S, H, KV, D,
           float(scale), int(bool(causal)))
    flash_attention.launches += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, delta) -> int:
    """What the backward kernels take beyond the forward's checks; returns
    the dtype code."""
    code = _check_cuda(q.shape[3], q.dtype, q=q, k=k, v=v, do=do, lse=lse,
                       delta=delta)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or \
                t.shape != (q.shape[0], q.shape[2], q.shape[1]):
            raise ValueError(f"{name} must be fp32 (B, H, T); got {t.dtype} "
                             f"{tuple(t.shape)}")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must match q's shape and dtype")
    return code


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dq from the forward's lse and ``delta`` (see
    :func:`flash_dq_reference`). CPU tensors take the plain version; CUDA
    tensors launch the dq kernel of :func:`flash_design`'s design
    (``flash_attention_dq.launches``)."""
    _check(q, k, v, causal)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _device_kind(q) == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    from ..op_builder import launch

    code = _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    launch("flash_attention_bwd", q.device, code,
           _design_code(q, D, B * H, T), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dq.data_ptr(), B, T, S, H, KV, D, float(scale), int(bool(causal)),
           symbol="dstorch_flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the forward's lse and ``delta`` (see
    :func:`flash_dkv_reference`); a KV head's gradient sums its query
    heads'. CPU tensors take the plain version; CUDA tensors launch the dkv
    kernel of :func:`flash_design`'s design
    (``flash_attention_dkv.launches``)."""
    _check(q, k, v, causal)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _device_kind(q) == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    from ..op_builder import launch

    code = _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("flash_attention_bwd", q.device, code,
           _design_code(q, D, B * KV, S), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), B, T, S, H, KV, D, float(scale),
           int(bool(causal)), symbol="dstorch_flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, do, causal: bool = True,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention`: delta in plain PyTorch, then
    the dq and dkv kernels (or their plain versions on the CPU). ``do`` is
    made contiguous here: autograd may hand over a strided gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.contiguous()
    delta = attention_delta(out, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


@torch.library.custom_op(
    "dstorch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
           "-> (Tensor, Tensor)")
def _flash_op(q, k, v, causal, scale):
    return _flash_forward(q, k, v, causal, scale)


@_flash_op.register_fake
def _(q, k, v, causal, scale):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, T), dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _flash_bwd(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                          ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_bwd, setup_context=_flash_setup)
# the operator a checkpoint policy names to keep (out, lse)
FLASH_OP = torch.ops.dstorch.flash_attention.default


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax(q kᵀ · scale) v`` → ``(out (B,T,H,D), lse (B,H,T) fp32)``,
    differentiable in q, k and v.

    ``scale`` defaults to 1/sqrt(D). CPU tensors take :func:`mha_reference`
    (and the plain backward); CUDA tensors launch the kernels (each forward
    launch adds one to ``flash_attention.launches``). The kernels want
    contiguous q, k and v: a caller holding strided views (a split of a
    fused projection) makes them contiguous first."""
    _check(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return FLASH_OP(q, k, v, bool(causal), float(scale))


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
