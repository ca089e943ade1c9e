"""Fused LayerNorm → Linear, forward and backward: the CUDA kernels'
wrappers and their plain versions.

Port of ``deepspeed_tpu/ops/transformer/ln_linear.py``. The kernels are
``ops/csrc/ln_linear.cu``, replacing the TPU kernels ``_fwd_kernel`` (:52,
launched at :121) and ``_bwd_dx_kernel`` (:75, launched at :159); the
source's header says what bounds them on the H100.

``ln_linear(x, gamma, beta, weight, bias, eps)`` computes
``(LN(x) · gamma + beta) Wᵀ + bias`` for x (..., C) and ``weight`` (N, C) in
``nn.Linear``'s layout (the JAX function takes W as (C, N)). Like the JAX
function it casts gamma, beta, W and bias to x's dtype, and:

* when the shape gate (:func:`supports_fused`) takes the shape, it runs the
  custom operator ``dstorch::ln_linear``: the forward kernel gives ``(y,
  mean, rstd)`` (fp32 row statistics); the backward-dx kernel gives dx and
  per-``BLOCK_M``-row partials of dgamma and dbeta, summed here; dW and db are
  plain products from the normalized rows recomputed with the saved
  statistics, as ``_ln_linear_vjp_bwd`` (:219-232) leaves them to XLA;
* otherwise, on a CPU tensor, it takes the plain composition of the JAX
  fallback (:265-277), differentiated by autograd; on a CUDA tensor it
  raises, so no call on the card leaves the kernels silently.

The gate is the CUDA kernels' own, not the TPU's 128-lane rule. bf16 and
fp16 run wgmma GEMMs fed by TMA: C a multiple of 64 and N a multiple of 8,
any M, which takes every shape the JAX gate takes (C ≤ 4096, multiples of
128) and more (GPT-2 XL's C = 1600). fp32 keeps the FMA units, in kernels
whose shared memory does not grow with C: C a multiple of 32, any M and N,
which also takes every shape the JAX gate takes.

The kernel wrappers :func:`ln_linear_fwd` and :func:`ln_linear_bwd_dx` take
their plain versions only for CPU tensors; a CUDA tensor launches the
kernels (one wrapper call adds one to its ``launches``: the forward is a
statistics pass and the GEMM, the backward the GEMM and a finishing pass)
or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

# checkpoint-policy names of the forward's outputs in the JAX package; the
# port's policy names the operator (LN_LINEAR_OP) that produces them
LN_SAVE_NAMES = ("ln_linear_out", "ln_linear_stats")
BLOCK_M = 128      # rows per dgamma / dbeta partial (the GEMMs' row tile)
BWD_BLOCK_C = 128  # backward: columns of C per tile (row partials)
K_SLICE = 64       # 16-bit: C must be a multiple of this
N_ALIGN = 8        # 16-bit: N must be a multiple of this (16-byte rows)
CHUNK = 32         # fp32: C must be a multiple of this
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)


def supports_fused(m: int, c: int, n: int,
                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernels for ``dtype`` take an (m, c) x against an (n, c)
    weight (see the module docstring)."""
    if dtype in _WGMMA_DTYPES:
        return (m >= 1 and n >= 1 and n % N_ALIGN == 0 and c >= K_SLICE
                and c % K_SLICE == 0)
    return m >= 1 and n >= 1 and c >= CHUNK and c % CHUNK == 0


def _gate_rule(dtype) -> str:
    if dtype in _WGMMA_DTYPES:
        return f"C a multiple of {K_SLICE}, N of {N_ALIGN}"
    return f"C a multiple of {CHUNK}"


def _stats(x2, eps: float):
    xf = x2.float()
    mu = xf.mean(1)
    xc = xf - mu[:, None]
    rstd = torch.rsqrt((xc * xc).mean(1) + eps)
    return xc, mu, rstd


def ln_linear_fwd_reference(x2, gamma, beta, weight, bias, eps: float):
    """The forward kernel's twin: fp32 statistics, the normalized rows
    rounded to x's dtype, an fp32 product plus bias rounded once."""
    xc, mu, rstd = _stats(x2, eps)
    n = (xc * rstd[:, None] * gamma.float() + beta.float()).to(x2.dtype)
    y = n.float() @ weight.float().t() + bias.float()
    return y.to(x2.dtype), mu, rstd


def ln_linear_bwd_dx_reference(dy, weight, x2, gamma, mean, rstd):
    """The backward-dx kernel's twin: ``dn = dy W`` in fp32, the LayerNorm
    backward, and per-``BLOCK_M``-row partials of ``Σ dn·xh`` and ``Σ dn``
    ((ceil(M / BLOCK_M), C) fp32 each)."""
    M, C = x2.shape
    dn = dy.float() @ weight.float()
    xh = (x2.float() - mean[:, None]) * rstd[:, None]
    dxh = dn * gamma.float()
    m1 = dxh.mean(1, keepdim=True)
    m2 = (dxh * xh).mean(1, keepdim=True)
    dx = (rstd[:, None] * (dxh - m1 - xh * m2)).to(x2.dtype)
    tiles = -(-M // BLOCK_M)
    pad = tiles * BLOCK_M - M

    def parts(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).view(
            tiles, BLOCK_M, C).sum(1)

    return dx, parts(dn * xh), parts(dn)


def _code(dtype, **tensors):
    from ..op_builder import DTYPE_CODES

    if dtype not in DTYPE_CODES:
        raise ValueError(f"ln_linear kernels support dtypes "
                         f"{list(DTYPE_CODES)}; got {dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_linear kernels need contiguous 16-byte "
                             f"aligned {name}")
    return DTYPE_CODES[dtype]


def _cuda(t) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_linear runs on cpu or cuda, not "
                         f"{t.device.type}")
    return t.device.type == "cuda"


def ln_linear_fwd(x2, gamma, beta, weight, bias, eps: float = 1e-5):
    """(y (M, N), mean (M,), rstd (M,)) for x2 (M, C); all of gamma, beta,
    weight and bias in x2's dtype."""
    M, C = x2.shape
    N = weight.shape[0]
    if not _cuda(x2):
        return ln_linear_fwd_reference(x2, gamma, beta, weight, bias, eps)
    if not supports_fused(M, C, N, x2.dtype):
        raise ValueError(f"ln_linear kernel does not tile M={M}, C={C}, "
                         f"N={N} ({_gate_rule(x2.dtype)})")
    from ..op_builder import launch

    code = _code(x2.dtype, x=x2, gamma=gamma, beta=beta, weight=weight,
                 bias=bias)
    y = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    mean = torch.empty(M, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    scratch = None  # 16-bit: gamma and beta in fp32, read a slice a stage
    if x2.dtype in _WGMMA_DTYPES:
        scratch = torch.empty(2 * C, dtype=torch.float32, device=x2.device)
    launch("ln_linear", x2.device, code, x2.data_ptr(), gamma.data_ptr(),
           beta.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
           mean.data_ptr(), rstd.data_ptr(),
           None if scratch is None else scratch.data_ptr(), M, C, N,
           float(eps), symbol="dstorch_ln_linear_fwd")
    ln_linear_fwd.launches += 1
    return y, mean, rstd


def ln_linear_bwd_dx(dy, weight, x2, gamma, mean, rstd):
    """(dx (M, C), dgamma partials, dbeta partials) — see
    :func:`ln_linear_bwd_dx_reference`."""
    M, C = x2.shape
    N = weight.shape[0]
    if not _cuda(x2):
        return ln_linear_bwd_dx_reference(dy, weight, x2, gamma, mean, rstd)
    if not supports_fused(M, C, N, x2.dtype):
        raise ValueError(f"ln_linear kernel does not tile M={M}, C={C}, "
                         f"N={N} ({_gate_rule(x2.dtype)})")
    from ..op_builder import launch

    code = _code(x2.dtype, dy=dy, weight=weight, x=x2, gamma=gamma,
                 mean=mean, rstd=rstd)
    tiles = -(-M // BLOCK_M)
    dx = torch.empty_like(x2)
    dg = torch.empty((tiles, C), dtype=torch.float32, device=x2.device)
    db = torch.empty_like(dg)
    # dxh (M, C) and the row partials, fp32, for every dtype
    scratch = torch.empty(M * C + 2 * M * -(-C // BWD_BLOCK_C),
                          dtype=torch.float32, device=x2.device)
    launch("ln_linear", x2.device, code, dy.data_ptr(), weight.data_ptr(),
           x2.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           dx.data_ptr(), dg.data_ptr(), db.data_ptr(), scratch.data_ptr(),
           M, C, N, symbol="dstorch_ln_linear_bwd_dx")
    ln_linear_bwd_dx.launches += 1
    return dx, dg, db


@torch.library.custom_op(
    "dstorch::ln_linear", mutates_args=(),
    schema="(Tensor x, Tensor gamma, Tensor beta, Tensor weight, "
           "Tensor bias, float eps) -> (Tensor, Tensor, Tensor)")
def _ln_linear_op(x, gamma, beta, weight, bias, eps):
    return ln_linear_fwd(x, gamma, beta, weight, bias, eps)


@_ln_linear_op.register_fake
def _(x, gamma, beta, weight, bias, eps):
    M = x.shape[0]
    stat = x.new_empty(M, dtype=torch.float32)
    return x.new_empty((M, weight.shape[0])), stat, stat.clone()


def _ln_setup(ctx, inputs, output):
    x, gamma, beta, weight, bias, _eps = inputs
    _y, mean, rstd = output
    ctx.save_for_backward(x, gamma, beta, weight, mean, rstd)
    ctx.bias_dtype = bias.dtype
    ctx.mark_non_differentiable(mean, rstd)


def _ln_bwd(ctx, dy, _dmean, _drstd):
    x, gamma, beta, weight, mean, rstd = ctx.saved_tensors
    dy = dy.contiguous()
    dx, dg_parts, db_parts = ln_linear_bwd_dx(dy, weight, x, gamma, mean,
                                              rstd)
    # dW and db as the JAX package leaves them to XLA: the normalized rows
    # recomputed from the saved statistics, one plain product. The rows are
    # formed as the forward kernel forms them (x * rstd - mean * rstd, then
    # * gamma + beta, in fp32, rounded to x's dtype) in two elementwise
    # passes, and db is summed in fp32 without an fp32 copy of dy.
    xh = torch.addcmul((-mean * rstd)[:, None], x, rstd[:, None])
    nmat = torch.addcmul(beta.float(), xh, gamma.float(),
                         out=torch.empty_like(x))
    dw = (dy.t() @ nmat).to(weight.dtype)
    db = dy.sum(0, dtype=torch.float32).to(ctx.bias_dtype)
    return (dx, dg_parts.sum(0).to(gamma.dtype),
            db_parts.sum(0).to(beta.dtype), dw, db, None)


_ln_linear_op.register_autograd(_ln_bwd, setup_context=_ln_setup)
# the operator a checkpoint policy names to keep (y, mean, rstd)
LN_LINEAR_OP = torch.ops.dstorch.ln_linear.default


def _plain(x2, gamma, beta, weight, bias, eps):
    """The JAX fallback's composition: the normalized rows rounded to x's
    dtype, then a product and a bias add in x's dtype."""
    xc, _, rstd = _stats(x2, eps)
    n = (xc * rstd[:, None] * gamma.float() + beta.float()).to(x2.dtype)
    return n @ weight.to(x2.dtype).t() + bias.to(x2.dtype)


def ln_linear(x, gamma, beta, weight, bias,
              eps: float = 1e-5) -> torch.Tensor:
    """``(LN(x; gamma, beta) Wᵀ + bias)``: x (..., C), ``weight`` (N, C) →
    (..., N), differentiable in every tensor (see the module docstring)."""
    *lead, c = x.shape
    n = weight.shape[0]
    x2 = x.reshape(-1, c)
    m = x2.shape[0]
    if not supports_fused(m, c, n, x.dtype):
        if _cuda(x):
            raise ValueError(f"ln_linear kernel does not tile M={m}, C={c}, "
                             f"N={n} ({_gate_rule(x.dtype)}); use "
                             f"fused_ln_linear=False")
        return _plain(x2, gamma, beta, weight, bias, eps).reshape(*lead, n)
    dt = x.dtype
    y, _, _ = LN_LINEAR_OP(x2.contiguous(), gamma.to(dt), beta.to(dt),
                           weight.to(dt), bias.to(dt), float(eps))
    return y.reshape(*lead, n)


ln_linear_fwd.launches = 0
ln_linear_bwd_dx.launches = 0
