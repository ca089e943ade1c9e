"""Block-sparse flash attention, forward and backward: the CUDA kernels'
wrappers, their plain versions and the differentiable operator.

Port of ``deepspeed_tpu/ops/sparse_attention/pallas_kernel.py``. The kernels
are ``ops/csrc/block_sparse_attention.cu``: ``block_sparse_fwd`` replaces
``_sparse_fwd_kernel`` (pallas_kernel.py:68, launched at :151),
``block_sparse_dq`` replaces ``_sparse_dq_kernel`` (:164, launched at :288)
and ``block_sparse_dkv`` replaces ``_sparse_dkv_kernel`` (:206, launched at
:328). The source's header says what bounds them on the H100.

The dq and dk/dv kernels have two designs, and :func:`sparse_design` names
the one a call runs: ``"wgmma"`` (the tensor cores, fed by TMA: the dense
flash kernels' structure with the tile walk driven by the schedule) for
bf16 and fp16 at D = 64 and 128, ``"fma"`` (the fp32 FMA units) for fp32
and D = 32, as for the flash kernels. :func:`sparse_block_rows` picks the
wgmma blocks' rows (128, or 64 where the granule is not a multiple of 128,
where 128-row blocks would leave SMs idle, and for dk/dv at D = 128), and
:func:`sparse_design_code` turns both into the entry points' design
argument. The forward runs its FMA kernel in every case. The wgmma dk/dv
kernel starts its blocks in :func:`launch_order`, longest walk first.

A layout is (H, T // block, T // block) 0/1 (``sparsity_config``). The
kernels walk its lists (:func:`layout_to_schedule`): the forward and dq
kernels ``idx[h, i, :cnt[h, i]]``, the key blocks of query block i; the dkv
kernel ``idx_t``/``cnt_t``, the same lists of the transposed layout.
:func:`schedule` builds the four once per (layout, device) on the host and
keeps them there as int32 device tensors, so a call copies nothing to the
device.

Layout of the tensors: q/k/v/out (B, T, H, D), the JAX function's public
layout (the kernels read it in place; the TPU kernels take (B·H, T, D));
lse and delta (B, H, T) fp32, as the flash kernels'. Every head has its own
K/V: the JAX kernels have no grouped-query heads, so neither do these.

With ``causal``, masking is token-level (key > query is dropped). A query
row with no live key gives out 0, lse ``-1e30 + log(1e-30)`` (= -1e30 in
fp32) and no gradient. That is the JAX kernel's result for an empty layout
row, and the JAX gather formulation's for a causal row whose live blocks all
lie in its future, where the JAX Pallas kernel returns the mean of v over
the masked block instead (``ROADMAP.md`` queue 3).

:func:`block_sparse_flash_attention` is differentiable. It runs as the
custom operator ``dstorch::block_sparse_attention`` (a selective
activation-checkpoint policy names it to keep its outputs, as the JAX
package tags them ``flash_out``/``flash_lse``), whose backward saves ``(q, k,
v, out, lse)``, computes ``delta = rowsum(dO ∘ out)`` in fp32 with plain
PyTorch (the JAX package does this outside its kernels, :262), then runs the
dq and dkv kernels.

Every wrapper takes its plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel or raises; it never falls back. Each
launch adds one to its wrapper's ``launches``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..attention.flash_attention import attention_delta, flash_design

NEG_INF = -1e30
LANES = 128
MIN_KERNEL_BLOCK = 128
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def sparse_design(dtype: torch.dtype, D: int) -> str:
    """The design the dq and dk/dv kernels run for ``dtype`` and head dim
    ``D``: ``"wgmma"`` or ``"fma"``, the flash kernels' rule
    (:func:`..attention.flash_attention.flash_design`)."""
    return flash_design(dtype, D)


def sparse_block_rows(kernel: str, D: int, block: int, tiles_of_128: int,
                      sm_count: int) -> int:
    """Rows a block of the wgmma design takes (query rows for ``"dq"``,
    keys for ``"dkv"``): 128, two consumer warpgroups, unless the granule
    ``block`` is not a multiple of 128 (a block lies in one layout row or
    column), the grid (``tiles_of_128`` blocks) would leave some of the
    card's ``sm_count`` SMs idle, or the kernel is dk/dv at D = 128, whose
    128-key blocks spill registers; then 64, one warpgroup."""
    if block % 128 or tiles_of_128 < sm_count or (kernel == "dkv"
                                                   and D == 128):
        return 64
    return 128


def sparse_design_code(dtype: torch.dtype, D: int, block: int, heads: int,
                       T: int, sm_count: int, kernel: str) -> int:
    """The dq (``kernel="dq"``) or dk/dv (``"dkv"``) entry point's design
    argument for ``heads`` (batch x heads) sequences of ``T`` positions on
    a card of ``sm_count`` SMs: 0 the FMA design, 1 the wgmma design with
    128-row blocks, 2 with 64-row blocks."""
    if sparse_design(dtype, D) == "fma":
        return 0
    rows = sparse_block_rows(kernel, D, block, heads * -(-T // 128), sm_count)
    return 1 if rows == 128 else 2


def layout_to_schedule(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, nq, nk) 0/1 layout → (idx (H, nq, M) int32, cnt (H, nq) int32).

    ``idx[h, i, :cnt[h, i]]`` lists the live key blocks of row (h, i) in
    ascending order; slots past cnt repeat the last live index (the JAX
    package's DMA-elision padding, kept so the two schedules are equal).
    Rows with no live blocks point at block 0 with cnt 0.
    """
    H, nq, nk = layout.shape
    counts = layout.sum(-1).astype(np.int32)
    M = max(1, int(counts.max()))
    idx = np.zeros((H, nq, M), np.int32)
    for h in range(H):
        for i in range(nq):
            js = np.nonzero(layout[h, i])[0]
            if len(js):
                idx[h, i, :len(js)] = js
                idx[h, i, len(js):] = js[-1]
    return idx, counts


def supports_pallas(layout_block: int, seq_len: int) -> bool:
    """The kernel's gate, the JAX package's (same name): a granule of at
    least 128, a multiple of 128, that tiles the sequence. The CUDA kernels
    need only a multiple of their 64-row tile; the gate is kept for parity,
    so both packages route the same shapes to the gather formulation."""
    return (layout_block >= MIN_KERNEL_BLOCK
            and layout_block % LANES == 0
            and seq_len % layout_block == 0)


@functools.lru_cache(maxsize=32)
def _cached_schedule(layout_bytes: bytes, shape: tuple, device: torch.device):
    layout = np.frombuffer(layout_bytes, np.int32).reshape(shape)
    idx, cnt = layout_to_schedule(layout)
    idx_t, cnt_t = layout_to_schedule(layout.transpose(0, 2, 1))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (idx, cnt, idx_t, cnt_t))


def schedule(layout, device) -> Tuple[torch.Tensor, ...]:
    """``(idx, cnt, idx_t, cnt_t)`` of ``layout`` as int32 tensors on
    ``device``, built once per (layout, device) and cached."""
    layout = np.ascontiguousarray(np.asarray(layout, dtype=np.int32))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cached_schedule(layout.tobytes(), layout.shape, device)


_ORDERS = WeakIdKeyDictionary()


def launch_order(cnt_t: torch.Tensor) -> torch.Tensor:
    """(H · nq,) int32 on ``cnt_t``'s device: the (head, layout column)
    pairs ``h * nq + j`` of the transposed schedule's counts ``cnt_t`` (H,
    nq), most live query blocks first, ties in order. The wgmma dk/dv
    kernel starts its blocks in this order, so the longest walks (BigBird's
    global column, a Fixed layout's global columns wherever they lie) do
    not trail. Built on the device once per ``cnt_t`` tensor and kept while
    it lives, so a call with a cached schedule copies nothing."""
    order = _ORDERS.get(cnt_t)
    if order is None:
        order = torch.sort(cnt_t.reshape(-1), descending=True,
                           stable=True).indices.to(torch.int32)
        _ORDERS[cnt_t] = order
    return order


# ---------------------------------------------------------------------------
# plain versions: each takes its kernel's inputs

def _token_mask(idx, cnt, block: int, T: int, causal: bool,
                transposed: bool = False) -> torch.Tensor:
    """(H, T, T) bool: query t may attend key s. Built from a schedule
    (``transposed``: the dkv kernel's lists of query blocks per key block)
    without a host sync, so the plain versions can be captured in a CUDA
    graph."""
    H, n, M = idx.shape
    valid = torch.arange(M, device=idx.device) < cnt[..., None]
    listed = F.one_hot(idx.long(), n).bool() & valid[..., None]
    layout = listed.any(2)                               # (H, n, n)
    if transposed:
        layout = layout.transpose(1, 2)
    mask = layout[:, :, None, :, None].expand(H, n, block, n, block) \
        .reshape(H, T, T)
    if causal:
        mask = mask & torch.ones(T, T, dtype=torch.bool,
                                 device=idx.device).tril()
    return mask


def _scores(q, k, mask, scale: float) -> torch.Tensor:
    """fp32 (B, H, T, T) scores, masked ones at -1e30."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    return s.masked_fill_(~mask, NEG_INF)


def _probs(q, k, lse, mask, scale: float) -> torch.Tensor:
    """p = exp(s - lse) recomputed from the saved lse, 0 where masked."""
    p = (_scores(q, k, mask, scale) - lse[..., None]).exp_()
    return p.masked_fill_(~mask, 0.0)


def block_sparse_fwd_reference(q, k, v, idx, cnt, block: int, causal: bool,
                               scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward, the forward kernel's twin, in fp32 over the whole
    (T, T) score matrix with the layout expanded to a token mask. Returns
    ``(out in q's dtype, lse (B, H, T) fp32)``; a row with no live key
    gives out 0 and lse ``-1e30 + log(1e-30)``, the kernel's value."""
    T = q.shape[1]
    mask = _token_mask(idx, cnt, block, T, causal)
    s = _scores(q, k, mask, scale)
    m = s.amax(-1, keepdim=True)
    p = (s - m).exp_().masked_fill_(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min_(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p.div_(l), v.float())
    return out.to(q.dtype), (m + l.log())[..., 0]


def block_sparse_dq_reference(q, k, v, do, lse, delta, idx, cnt, block: int,
                              causal: bool, scale: float) -> torch.Tensor:
    """Plain dq, the dq kernel's twin: ``ds = p ∘ (dO vᵀ − delta)`` rounded
    to k's dtype, then ``dq = ds k · scale`` in fp32, returned in q's
    dtype."""
    mask = _token_mask(idx, cnt, block, q.shape[1], causal)
    p = _probs(q, k, lse, mask, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    return (torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale
            ).to(q.dtype)


def block_sparse_dkv_reference(q, k, v, do, lse, delta, idx_t, cnt_t,
                               block: int, causal: bool, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dk and dv, the dkv kernel's twin (it takes the transposed
    schedule): ``dv = pᵀ dO`` with p rounded to dO's dtype, ``dk = dsᵀ q ·
    scale`` with ds rounded to q's dtype, fp32 sums, returned in k's and
    v's dtypes."""
    mask = _token_mask(idx_t, cnt_t, block, q.shape[1], causal,
                       transposed=True)
    p = _probs(q, k, lse, mask, scale)
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers

def _on_cpu(q) -> bool:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block-sparse attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    return q.device.type == "cpu"


def _check_cuda(q, idx, cnt, block: int, **tensors) -> int:
    """What every block-sparse kernel takes; returns the dtype code."""
    from ..op_builder import DTYPE_CODES

    B, T, H, D = q.shape
    if q.dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"block-sparse kernels support dtypes "
                         f"{list(DTYPE_CODES)} and head dims "
                         f"{SUPPORTED_HEAD_DIMS}; got {q.dtype}, D={D}")
    if block % 64 or T % block:
        raise ValueError(f"block {block} must be a multiple of 64 that "
                         f"divides T={T}")
    nq = T // block
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32 or \
            idx.dim() != 3 or idx.shape[:2] != (H, nq) or \
            cnt.shape != (H, nq):
        raise ValueError(f"schedule must be int32 idx (H, nq, M) and cnt "
                         f"(H, nq) with H={H}, nq={nq}; got "
                         f"{tuple(idx.shape)} {idx.dtype}, "
                         f"{tuple(cnt.shape)} {cnt.dtype}")
    for name, t in dict(q=q, idx=idx, cnt=cnt, **tensors).items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"block-sparse kernel needs contiguous 16-byte "
                             f"aligned {name}")
        if t.dim() == 4 and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match "
                             f"q {tuple(q.shape)} {q.dtype} (no grouped-query "
                             f"heads)")
    for name in ("lse", "delta"):
        t = tensors.get(name)
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (B, H, T)):
            raise ValueError(f"{name} must be fp32 (B, H, T); got {t.dtype} "
                             f"{tuple(t.shape)}")
    return DTYPE_CODES[q.dtype]


def _design_code(q, block: int, kernel: str) -> int:
    """:func:`sparse_design_code` for ``q`` (B, T, H, D) on its card."""
    B, T, H, D = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return sparse_design_code(q.dtype, D, block, B * H, T, sms, kernel)


def block_sparse_fwd(q, k, v, idx, cnt, block: int, causal: bool,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` over the live blocks that ``idx``/``cnt`` list. CPU
    tensors take :func:`block_sparse_fwd_reference`; CUDA tensors launch
    the forward kernel (``block_sparse_fwd.launches``)."""
    if _on_cpu(q):
        return block_sparse_fwd_reference(q, k, v, idx, cnt, block, causal,
                                          scale)
    from ..op_builder import launch

    code = _check_cuda(q, idx, cnt, block, k=k, v=v)
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch("block_sparse_attention", q.device, code, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
           idx.data_ptr(), cnt.data_ptr(), B, T, H, D, idx.shape[2], block,
           float(scale), int(bool(causal)), symbol="dstorch_block_sparse_fwd")
    block_sparse_fwd.launches += 1
    return out, lse


def block_sparse_dq(q, k, v, do, lse, delta, idx, cnt, block: int,
                    causal: bool, scale: float) -> torch.Tensor:
    """dq from the forward's lse and ``delta`` (see
    :func:`block_sparse_dq_reference`). CPU tensors take the plain version;
    CUDA tensors launch the dq kernel of :func:`sparse_design_code`'s design
    (``block_sparse_dq.launches``)."""
    if _on_cpu(q):
        return block_sparse_dq_reference(q, k, v, do, lse, delta, idx, cnt,
                                         block, causal, scale)
    from ..op_builder import launch

    code = _check_cuda(q, idx, cnt, block, k=k, v=v, do=do, lse=lse,
                       delta=delta)
    B, T, H, D = q.shape
    dq = torch.empty_like(q)
    launch("block_sparse_attention", q.device, code,
           _design_code(q, block, "dq"), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), idx.data_ptr(), cnt.data_ptr(), dq.data_ptr(),
           B, T, H, D, idx.shape[2], block, float(scale), int(bool(causal)),
           symbol="dstorch_block_sparse_dq")
    block_sparse_dq.launches += 1
    return dq


def block_sparse_dkv(q, k, v, do, lse, delta, idx_t, cnt_t, block: int,
                     causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the forward's lse and ``delta``, walking the
    transposed schedule (see :func:`block_sparse_dkv_reference`). CPU
    tensors take the plain version; CUDA tensors launch the dkv kernel of
    :func:`sparse_design_code`'s design (``block_sparse_dkv.launches``)."""
    if _on_cpu(q):
        return block_sparse_dkv_reference(q, k, v, do, lse, delta, idx_t,
                                          cnt_t, block, causal, scale)
    from ..op_builder import launch

    code = _check_cuda(q, idx_t, cnt_t, block, k=k, v=v, do=do, lse=lse,
                       delta=delta)
    B, T, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("block_sparse_attention", q.device, code,
           _design_code(q, block, "dkv"), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), idx_t.data_ptr(), cnt_t.data_ptr(),
           launch_order(cnt_t).data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
           T, H, D, idx_t.shape[2], block, float(scale), int(bool(causal)),
           symbol="dstorch_block_sparse_dkv")
    block_sparse_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the differentiable operator

@torch.library.custom_op(
    "dstorch::block_sparse_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor idx, Tensor cnt, "
           "Tensor idx_t, Tensor cnt_t, int block, bool causal, float scale) "
           "-> (Tensor, Tensor)")
def _sparse_op(q, k, v, idx, cnt, idx_t, cnt_t, block, causal, scale):
    return block_sparse_fwd(q, k, v, idx, cnt, block, causal, scale)


@_sparse_op.register_fake
def _(q, k, v, idx, cnt, idx_t, cnt_t, block, causal, scale):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, T), dtype=torch.float32)


def _sparse_setup(ctx, inputs, output):
    q, k, v, idx, cnt, idx_t, cnt_t, block, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, idx, cnt, idx_t, cnt_t)
    ctx.block, ctx.causal, ctx.scale = block, causal, scale
    ctx.mark_non_differentiable(lse)


def _sparse_bwd(ctx, dout, _dlse):
    q, k, v, out, lse, idx, cnt, idx_t, cnt_t = ctx.saved_tensors
    do = dout.contiguous()   # autograd may hand over a strided gradient
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta)
    dq = block_sparse_dq(*args, idx, cnt, ctx.block, ctx.causal, ctx.scale)
    dk, dv = block_sparse_dkv(*args, idx_t, cnt_t, ctx.block, ctx.causal,
                              ctx.scale)
    return dq, dk, dv, None, None, None, None, None, None, None


_sparse_op.register_autograd(_sparse_bwd, setup_context=_sparse_setup)
# the operator a checkpoint policy names to keep (out, lse)
SPARSE_OP = torch.ops.dstorch.block_sparse_attention.default


def block_sparse_flash_attention(q, k, v, layout: np.ndarray, block: int,
                                 causal: bool = False,
                                 scale: Optional[float] = None):
    """Fused block-sparse attention. q/k/v: (B, T, H, D); ``layout``: host
    (H, T // block, T // block) 0/1. Returns (B, T, H, D), differentiable in
    q, k and v.

    Requires ``supports_pallas(block, T)``; callers route finer layouts to
    the gather formulation. CPU tensors take the plain versions; CUDA
    tensors launch the kernels."""
    B, T, H, D = q.shape
    if not supports_pallas(block, T):
        raise ValueError(
            f"block {block} / seq {T} not supported by the Pallas kernel "
            f"(need block >= {MIN_KERNEL_BLOCK}, block % {LANES} == 0, "
            "T % block == 0)")
    if layout.shape != (H, T // block, T // block):
        raise ValueError(f"layout shape {layout.shape} != "
                         f"{(H, T // block, T // block)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match q {tuple(q.shape)}: the block-sparse kernels "
                         f"have no grouped-query heads")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    idx, cnt, idx_t, cnt_t = schedule(layout, q.device)
    out, _ = SPARSE_OP(q.contiguous(), k.contiguous(), v.contiguous(), idx,
                       cnt, idx_t, cnt_t, int(block), bool(causal),
                       float(scale))
    return out


block_sparse_fwd.launches = 0
block_sparse_dq.launches = 0
block_sparse_dkv.launches = 0

__all__ = [
    "block_sparse_flash_attention",
    "layout_to_schedule",
    "supports_pallas",
    "MIN_KERNEL_BLOCK",
]
