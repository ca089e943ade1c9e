"""Cached attention over a paged KV pool: the CUDA kernel's wrapper and its
plain version.

Port of ``deepspeed_tpu/ops/attention/paged_attention.py``. The kernel is
``ops/csrc/paged_decode_attention.cu``, which replaces the TPU kernel
``paged_decode_attention`` (paged_attention.py:125 in the JAX package;
``pallas_call`` at :247, body ``_paged_kernel`` at :58). It reads the
serving pool's pages in place through the per-slot page table, so no dense
per-slot view of the cache is built. It is the contiguous decode kernel
(``ops/csrc/decode_sm90.cuh``, shared with ``decode_attention.cu``) with
the page table as its row source and a limit of its own for each query row,
as the JAX kernel mirrors its dense decode kernel: one block per (slot, KV
head, tile of 16 (query row, query head) pairs, S-chunk), in
:func:`~.decode_attention.decode_design`'s design (``"mma"``:
``mma.sync`` on the tensor cores, ``"fma"``: the FMA units) over
:func:`paged_plan`'s chunks, chosen from the shapes alone.

Page layout: one layer's pool is (P, KV, page_size, D), positions-major, in
the compute dtype, matching the contiguous cache's (B, KV, S, D); for the
int8 KV cache the pages are int8 with fp32 scale pages (P, KV, page_size),
one scale per cached row. The JAX package stores (P, KV, D, page_size) for
the TPU's lane tiling; tests compare the logical K/V by transposing. Table
entry ``P`` means "unmapped" and is clipped to page ``P - 1``: it is only
reached past a slot's live length, where every read is masked.

:func:`paged_decode_attention` takes :func:`paged_decode_attention_reference`
only for tensors on the CPU. For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .decode_attention import (SUPPORTED_HEAD_DIMS, decode_design,
                               decode_plan, window_attention_reference)

__all__ = ["MAX_QUERY_ROWS", "page_writes", "paged_decode_attention",
           "paged_decode_attention_reference", "paged_plan"]

# query rows per slot one call serves: plain decode (1) and speculative
# verify (K + 1), the JAX kernel's sublane count. The kernel's A rows are
# the T x (H / KV) (query row, query head) pairs of a KV head, 16 to a tile
MAX_QUERY_ROWS = 8
# page-table entries one block stages in shared memory (64 KB): a chunk of
# the plan touches at most ceil(chunk / page_size) + 1 pages
MAX_TABLE_PAGES = 16384


def paged_plan(B: int, T: int, H: int, KV: int, S: int, D: int,
               sm_count: int) -> tuple:
    """``(splits, chunk)``: the kernel's split of a slot's ``S`` positions
    (``max_pages * page_size``) into ``splits`` chunks of ``chunk``
    positions, one block each. The contiguous kernel's rule
    (:func:`~.decode_attention.decode_plan`) with a block's A rows the
    ``T * H / KV`` (query row, query head) pairs of a KV head: as many
    chunks as keep the ``B * KV * ceil(T * (H / KV) / 16)`` tiles times
    ``splits`` within one block an SM of the card's ``sm_count``. From the
    shapes only, never from the starts (they live on the device: reading
    them would sync the host and could not be captured in a CUDA graph)."""
    return decode_plan(B, T * H, KV, S, D, sm_count)


def page_writes(positions, table, num_pages: int, page_size: int):
    """Where a step's cache rows land in the pool: position p of slot b goes
    to ``pages[table[b, p // page_size], :, p % page_size]``. Positions past
    the table and unmapped (sentinel ``num_pages``) entries are dropped, so
    a free or padding row never touches a real page. ``positions`` and
    ``table`` are (B, W) and (B, pages_per_slot) on one device. Returns
    ``(sel, page ids, rows in page)`` over the flattened (B*W) positions
    (one host sync)."""
    max_pages = table.shape[1]
    pidx = (positions // page_size).clamp(0, max_pages - 1)
    page = table.long().gather(1, pidx)
    ok = (positions >= 0) & (positions < max_pages * page_size) \
        & (page < num_pages)
    sel = ok.reshape(-1).nonzero()[:, 0]
    return (sel, page.reshape(-1)[sel],
            (positions % page_size).reshape(-1)[sel])


def paged_decode_attention_reference(q, k_pages, v_pages, table, starts,
                                     scale, alibi_slopes=None,
                                     k_scale_pages=None, v_scale_pages=None):
    """Plain PyTorch twin of the kernel in fp32: clip sentinel page ids to
    ``P - 1``, gather the live pages of each slot into a dense view, and
    let row t of slot b attend positions ``<= starts[b] + t`` with ALiBi
    ``slope·(pos − (starts[b] + t))``. Int8 pages pass their (P, KV,
    page_size) scale pages, gathered the same way and folded into the
    scores and probabilities. Returns (B, T, H, D) in q's dtype."""
    B, T = q.shape[:2]
    P, KV, ps, D = k_pages.shape
    starts = starts.to(q.device).long().reshape(B)
    n_pages = min(table.shape[1],
                  -(-(int(starts.max()) + T) // ps))       # live pages
    ids = table[:, :n_pages].to(q.device).long().clamp(0, P - 1).reshape(-1)

    def dense(pages):                               # (B, KV, S[, D])
        g = pages[ids].reshape(B, n_pages, KV, ps, *pages.shape[3:])
        return g.transpose(1, 2).reshape(B, KV, n_pages * ps,
                                         *pages.shape[3:])

    scales = {} if k_scale_pages is None else dict(
        k_scale=dense(k_scale_pages), v_scale=dense(v_scale_pages))
    return window_attention_reference(q, dense(k_pages), dense(v_pages),
                                      starts, scale, alibi_slopes, **scales)


def paged_decode_attention(q, k_pages, v_pages, table, starts, *,
                           scale: Optional[float] = None,
                           alibi_slopes: Optional[torch.Tensor] = None,
                           k_scale_pages=None,
                           v_scale_pages=None) -> torch.Tensor:
    """Attention of 1..``MAX_QUERY_ROWS`` query rows per slot over its
    pages.

    Args:
      q: (B, T, H, D); row t of slot b attends positions
        ``[0, starts[b] + t]`` (the caller has already written this step's
        T rows into the pages).
      k_pages, v_pages: one layer's pool (P, KV, page_size, D),
        H % KV == 0 (query head h reads KV head h // (H // KV)).
      table: (B, pages_per_slot) int32; ``P`` marks an unmapped entry.
      starts: (B,) int32 cache length before this step's rows.
      alibi_slopes: optional (H,) fp32 ALiBi slopes.
      k_scale_pages, v_scale_pages: (P, KV, page_size) fp32 per-row scales
        of int8 pages (row value = int8 * scale); both or neither.
    Returns (B, T, H, D) in q's dtype. On CUDA each call (the kernel in
    ``decode_design``'s design over :func:`paged_plan`'s chunks, then the
    combine kernel if there are several) adds one to
    ``paged_decode_attention.launches``, or to
    ``paged_decode_attention.int8_launches`` for int8 pages.
    """
    quantized = k_scale_pages is not None
    if quantized != (v_scale_pages is not None):
        raise ValueError("provide both k_scale_pages and v_scale_pages or "
                         "neither")
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention wants q (B,T,H,D) and pages "
                         f"(P,KV,ps,D); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, T, H, D = q.shape
    P, KV, ps, Dp = k_pages.shape
    if Dp != D or H % KV != 0 or table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"pages {tuple(k_pages.shape)} / table "
                         f"{tuple(table.shape)} do not fit q {tuple(q.shape)}")
    if not 1 <= T <= MAX_QUERY_ROWS:
        raise ValueError(f"paged kernel handles 1..{MAX_QUERY_ROWS} query "
                         f"rows, got {T}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not torch.is_tensor(starts) or starts.dim() == 0:
        starts = torch.full((B,), int(starts), dtype=torch.int32,
                            device=q.device)
    if quantized and (k_scale_pages.shape != k_pages.shape[:3]
                      or v_scale_pages.shape != k_scale_pages.shape):
        raise ValueError(f"scale pages must be {tuple(k_pages.shape[:3])}; "
                         f"got {tuple(k_scale_pages.shape)}, "
                         f"{tuple(v_scale_pages.shape)}")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, table, starts, scale, alibi_slopes,
            k_scale_pages, v_scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    from ..op_builder import DTYPE_CODES, launch

    if q.dtype not in DTYPE_CODES or D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged kernel supports dtypes {list(DTYPE_CODES)} "
                         f"and head dims {SUPPORTED_HEAD_DIMS}; got "
                         f"{q.dtype}, D={D}")
    page_dtype = torch.int8 if quantized else q.dtype
    if not (page_dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError(f"page dtypes must be {page_dtype}: got "
                         f"{k_pages.dtype}, {v_pages.dtype} for q {q.dtype}")
    for name, t, shape in (("table", table, (B, table.shape[1])),
                           ("starts", starts, (B,))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} int32 on "
                             f"{q.device}; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = paged_plan(B, T, H, KV, table.shape[1] * ps, D, sms)
    if -(-plan[1] // ps) + 1 > MAX_TABLE_PAGES:
        raise ValueError(f"paged kernel stages at most {MAX_TABLE_PAGES} "
                         f"table entries a block; a chunk of {plan[1]} "
                         f"positions over pages of {ps} touches more")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if quantized:
        if k_scale_pages.dtype != torch.float32 \
                or v_scale_pages.dtype != torch.float32:
            raise ValueError("k_scale_pages/v_scale_pages must be float32")
        tensors += [("k_scale_pages", k_scale_pages),
                    ("v_scale_pages", v_scale_pages)]
    if alibi_slopes is not None:
        if alibi_slopes.shape != (H,) or alibi_slopes.dtype != torch.float32:
            raise ValueError("alibi_slopes must be (H,) float32")
        tensors.append(("alibi_slopes", alibi_slopes))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"paged kernel needs {name} contiguous, 16-byte "
                             f"aligned, on {q.device}")
    slopes = alibi_slopes.data_ptr() if alibi_slopes is not None else None
    out = torch.empty_like(q)
    design = 1 if decode_design(q.dtype, D) == "mma" else 0
    # the chunks' (m, l, acc) states, merged by the second kernel
    scratch = (torch.empty(B * T * H * plan[0] * (2 + D), dtype=torch.float32,
                           device=q.device) if plan[0] > 1 else None)
    partials = scratch.data_ptr() if scratch is not None else None
    shapes = (B, T, H, KV, P, ps, table.shape[1], D, *plan, float(scale))
    if quantized:
        launch("paged_decode_attention", q.device, DTYPE_CODES[q.dtype],
               design, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               k_scale_pages.data_ptr(), v_scale_pages.data_ptr(),
               table.data_ptr(), starts.data_ptr(), slopes, out.data_ptr(),
               partials, *shapes,
               symbol="dstorch_paged_decode_attention_int8")
        paged_decode_attention.int8_launches += 1
        return out
    launch("paged_decode_attention", q.device, DTYPE_CODES[q.dtype], design,
           q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           table.data_ptr(), starts.data_ptr(), slopes, out.data_ptr(),
           partials, *shapes)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
