"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: fp32 inputs differ from the plain version only in summation
order (1e-4 absolute on unit-scale outputs); bf16/fp16 add the rounding of
p to the input dtype before the PV product and of the output (3e-2 on
outputs below 4 in magnitude). lse is fp32 in every case (1e-3). The paged
kernel is the decode kernel over a page table (one template,
``decode_sm90.cuh``) and takes its tolerances, and the int8-cache variants
the same again (their scaled probabilities are rounded to bf16 for bf16
queries only).

The decode kernel has two designs (``decode_design``): mma.sync for
bf16/fp16 at D = 64 and 128, FMA otherwise, so the grids reach both; its
lengths put ``decode_plan``'s chunks empty, partial and full. Its permuted
operand layouts fail silently, so one-hot queries over small-integer V
rows hold it exactly, in both designs and cache types. The paged grids add
page sizes off 16, forced chunk counts and up to 4 row tiles a KV head
(8 rows of 8 heads), and one-hot cases of their own.

The training kernels (flash dq and dkv, ln_linear forward and
backward-dx) compute in fp32 with their plain versions' roundings (ds and p
rounded to the input dtype in the attention backward, the normalized rows
in ln_linear), so they are held relative to each output's largest element
(at least 1e-2, for gradients that vanish in exact arithmetic): fp32 to
1e-4 (summation order), bf16/fp16 to 2e-2 (an output rounding, and
a rounded intermediate that lands on the other side of a rounding boundary
when the fp32 sums before it differ in their last bits).

The flash forward, dq and dk/dv kernels run the wgmma design for bf16/fp16
at D = 64 and 128 and the FMA design otherwise (``flash_design``), so the
grids below reach both; the tensor cores sum in another order than the plain
version, which the same limits cover. The wgmma designs pack the fp32
accumulator into 16-bit A fragments in registers: one test pins that
packing alone on a 64 x 64 tile, with small integers, so that the result is
exact.

The block-sparse kernels take the flash kernels' tolerances: the forward
those of the flash forward, dq and dkv those of the flash backward. Their dq
and dk/dv kernels have the flash kernels' two designs (``sparse_design``):
the grids below reach the FMA design (fp32, D = 32) and both wgmma block
sizes (forced through ``sparse_block_rows``, or by a granule that is not a
multiple of 128), and hold every gradient of a row or key that the layout
leaves without a partner at exactly 0.

int8_matmul: the kernel and the plain version both round x to bf16 and sum
exact bf16 x int8 products in fp32, so an fp32 output differs in summation
order only (1e-5, relative to each output and, for outputs that cancel,
to the largest one); a bf16/fp16 output adds one rounding of the output
(2^-9 / 2^-11 relative, allowed twice). Its tensor-core kernel builds the
mma fragments from permuted k and converts int8 to bf16 by bit operations,
both of which fail silently: small integers (every sum exact in fp32) and
one-hot rows (each output one weight) pin them exactly, at every tile shape
and split that ``int8_plan`` picks.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.attention.decode_attention import (
    alibi_slopes, decode_attention, decode_attention_reference)
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    flash_attention, mha_reference)
from deepspeed_tpu_torch.ops.attention.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    attention_delta, flash_attention_dkv, flash_attention_dq,
    flash_dkv_reference, flash_dq_reference)
from deepspeed_tpu_torch.ops.quantization.int8_matmul import (
    int8_matmul, int8_matmul_reference)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    block_sparse_dkv, block_sparse_dkv_reference, block_sparse_dq,
    block_sparse_dq_reference, block_sparse_flash_attention, block_sparse_fwd,
    block_sparse_fwd_reference, schedule)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.ops.transformer.ln_linear import (
    ln_linear, ln_linear_bwd_dx, ln_linear_bwd_dx_reference, ln_linear_fwd,
    ln_linear_fwd_reference)

from _torch_threads import one_thread  # noqa: F401


pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}
NEG_INF32 = torch.tensor(-1e30).item()   # the kernels' masked value in fp32
DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # C codes


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# (H, KV): MHA, GQA, GPT-2's 12 heads, TinyLlama's 32 over 4, MQA
DECODE_HEADS = [(4, 4), (8, 2), (12, 12), (32, 4), (8, 1)]


def _decode_lengths(B, H, KV, S, D):
    """0, 1, the first chunk's edge and one past it (``decode_plan``'s
    chunk on this card), S - 1 and S, then 77 for the slots left."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = decode_plan(B, H, KV, S, D, sms)[1]
    lengths = [0, 1, min(chunk, S), min(chunk + 1, S), S - 1, S]
    return torch.tensor((lengths + [77] * B)[:B], dtype=torch.int32,
                        device="cuda")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H,KV", DECODE_HEADS)
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_kernel_matches_plain(gen, dtype, D, H, KV, alibi):
    """Every (dtype, D) reaches its design (mma for bf16/fp16 at D 64 and
    128, FMA otherwise); lengths put chunks empty, partial and full."""
    B, S = 6, 300
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, KV, S, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, KV, S, D, generator=gen, device="cuda").to(dtype)
    lengths = _decode_lengths(B, H, KV, S, D)
    slopes = alibi_slopes(H).cuda() if alibi else None
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths, alibi_slopes=slopes)
    want = decode_attention_reference(q, k, v, lengths, 1 / math.sqrt(D),
                                      slopes)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,T,S", [(True, 1, 1), (True, 100, 100),
                                        (True, 129, 129), (False, 70, 200)])
def test_flash_kernel_matches_plain(gen, dtype, D, causal, T, S):
    B, H, KV = 2, 4, 2
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal)
    want, want_lse = mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


# (H, KV, ALiBi) of the paged grids: MHA, GQA, ALiBi, MQA (8 query heads a
# KV head: 8 rows make 4 row tiles) and TinyLlama's 32 over 4
PAGED_HEADS = [(4, 4, False), (8, 2, False), (4, 4, True), (8, 1, False),
               (32, 4, False)]
# (page size, chunks): the plan's own, a page size off 16 (a 16-position
# group crosses a page boundary), and 1, 2, 4 chunks forced
PAGED_SPLITS = [(16, None), (24, None), (8, 1), (24, 2), (16, 4)]


def _paged_case(gen, T, ps, splits, monkeypatch):
    """Shuffled page ids, sentinels past each slot's live pages, starts on
    and beside page boundaries, a slot at length 0 (one live position)
    and one whose rows run to the last position of its table; ``splits``
    forces that many chunks of whole rounds. Returns (table, starts, P)."""
    import deepspeed_tpu_torch.ops.attention.paged_attention as pa

    B, max_pages = 6, 16
    S = max_pages * ps
    if splits is not None:
        chunk = -(-S // (splits * 64)) * 64
        assert -(-S // chunk) == splits
        monkeypatch.setattr(pa, "paged_plan", lambda *_: (splits, chunk))
    P = B * max_pages + 3
    starts = torch.tensor([0, 15, 16, 17, 77, S - T], dtype=torch.int32,
                          device="cuda")
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * max_pages]
    table = perm.reshape(B, max_pages).to(torch.int32)
    live = (starts.long() + T + ps - 1) // ps
    dead = torch.arange(max_pages, device="cuda")[None] >= live[:, None]
    return table.masked_fill(dead, P).contiguous(), starts, P


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
@pytest.mark.parametrize("H,KV,alibi", PAGED_HEADS)
@pytest.mark.parametrize("ps,splits", PAGED_SPLITS)
def test_paged_kernel_matches_plain(gen, monkeypatch, dtype, D, T, H, KV,
                                    alibi, ps, splits):
    """Every (dtype, D) reaches its design (mma for bf16/fp16, FMA for
    fp32) over the layout of ``_paged_case``."""
    table, starts, P = _paged_case(gen, T, ps, splits, monkeypatch)
    B = starts.shape[0]
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(P, KV, ps, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(P, KV, ps, D, generator=gen, device="cuda").to(dtype)
    slopes = alibi_slopes(H).cuda() if alibi else None
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, k, v, table, starts, alibi_slopes=slopes)
    want = paged_decode_attention_reference(q, k, v, table, starts,
                                            1 / math.sqrt(D), slopes)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 8, 2, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    cache = torch.randn(1, 2, 8, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q[:, 0], cache, cache,
                         torch.tensor([4], device="cuda"))
    pages = torch.randn(3, 2, 4, 64, generator=gen, device="cuda")
    table = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="query rows"):
        paged_decode_attention(q[:, :1].expand(1, 9, 2, 64).contiguous(),
                               pages, pages, table, starts)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q[:, :1], pages, pages, table.long(), starts)
    # an int8 cache needs int8 rows and fp32 scales; a float cache no scales
    scales = torch.ones(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(q[:, 0], cache, cache, starts + 4, k_scale=scales,
                         v_scale=scales)
    with pytest.raises(ValueError, match="int8 weights"):
        int8_matmul(q[0, 0], torch.zeros(3, 64, device="cuda"),
                    torch.ones(3, device="cuda"))


def _int8_rows(gen, *shape):
    """Random int8 rows with fp32 per-row scales around 0.01 (values of
    order 1, as a quantized unit-variance cache holds)."""
    q8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.01 + 0.005
    return q8, sc


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H,KV", DECODE_HEADS)
@pytest.mark.parametrize("alibi", [False, True])
def test_int8_decode_kernel_matches_plain(gen, dtype, D, H, KV, alibi):
    B, S = 6, 300
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k8, ks = _int8_rows(gen, B, KV, S, D)
    v8, vs = _int8_rows(gen, B, KV, S, D)
    lengths = _decode_lengths(B, H, KV, S, D)
    slopes = alibi_slopes(H).cuda() if alibi else None
    before = decode_attention.int8_launches
    got = decode_attention(q, k8, v8, lengths, alibi_slopes=slopes,
                           k_scale=ks, v_scale=vs)
    want = decode_attention_reference(q, k8, v8, lengths, 1 / math.sqrt(D),
                                      slopes, ks, vs)
    torch.cuda.synchronize()
    assert decode_attention.int8_launches == before + 1
    assert torch.isfinite(got.float()).all() and (got[0] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype,design", [
    (torch.bfloat16, "mma"), (torch.float16, "mma"), (torch.bfloat16, "fma"),
    (torch.float32, "fma")])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KV", [(12, 12), (32, 4), (8, 1), (40, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_one_hot_is_exact(gen, monkeypatch, dtype, design, D,
                                        H, KV, int8):
    """Fragment layouts fail silently, so each head's query is one-hot on
    its own dim and its group's K holds a single 1 there, at a random
    position below the slot's length: every other score is 0, so p is 1
    there and exp(-100) elsewhere, which the kernels' exp2 flushes to 0,
    and out is that position's V row of small integers, exactly. A wrong head, dim, position or output column
    in the permuted operands, or a wrong chunk merge, moves whole
    entries. 40 heads over 2 KV heads give each KV head a block of 16 rows
    and one of 4."""
    import deepspeed_tpu_torch.ops.attention.decode_attention as da

    monkeypatch.setattr(da, "decode_design", lambda *_: design)
    B, S = 3, 1000
    g = H // KV
    lengths = torch.tensor([S, 417, 1], dtype=torch.int32, device="cuda")
    target = (torch.rand(B, H, generator=gen, device="cuda")
              * lengths[:, None]).long()                    # (B, H)
    dim = torch.arange(H, device="cuda") % D
    q = torch.zeros(B, H, D, device="cuda")
    q[:, torch.arange(H), dim] = 100.0
    k = torch.zeros(B, KV, S, D, device="cuda")
    kvh = torch.arange(H, device="cuda") // g
    for b in range(B):
        k[b, kvh, target[b], dim] = 1.0
    v = torch.randint(-8, 9, (B, KV, S, D), generator=gen,
                      device="cuda").float()
    want = v[torch.arange(B)[:, None], kvh[None], target]      # (B, H, D)
    q = q.to(dtype)
    if int8:
        ones = torch.ones(B, KV, S, device="cuda")
        got = decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                               lengths, scale=1.0, k_scale=ones,
                               v_scale=ones)
    else:
        got = decode_attention(q, k.to(dtype), v.to(dtype), lengths,
                               scale=1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernel_is_deterministic(gen, int8):
    """The chunks merge in rank order: the same inputs give the same bits
    (TinyLlama's heads, 8 chunks a group)."""
    B, H, KV, S, D = 4, 32, 4, 2048, 64
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor([1, 2048, 1100, 517], dtype=torch.int32,
                           device="cuda")
    if int8:
        k8, ks = _int8_rows(gen, B, KV, S, D)
        v8, vs = _int8_rows(gen, B, KV, S, D)
        runs = [decode_attention(q, k8, v8, lengths, k_scale=ks, v_scale=vs)
                for _ in range(3)]
    else:
        k, v = (torch.randn(B, KV, S, D, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        runs = [decode_attention(q, k, v, lengths) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_decode_entries_refuse_what_the_plan_does_not_give(gen):
    """The entry points take design 0 (FMA: every dtype, D 32, 64, 128) and
    1 (mma.sync: bf16 and fp16 at D 64 and 128), and a plan of 1..16 chunks
    of whole 64-position rounds that covers S with none past it, with fp32
    partials for more than one chunk; they refuse anything else."""
    from deepspeed_tpu_torch.ops.op_builder import (KernelLaunchError,
                                                    launch)

    B, H, KV, S = 2, 8, 2, 1024
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")

    def run(dtype, D, design, splits, chunk, scratch=True):
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(B, KV, S, D, generator=gen, device="cuda").to(dtype)
        out = torch.empty_like(q)
        part = torch.empty(B * H * splits * (2 + D), device="cuda")
        launch("decode_attention", q.device, DTYPE[dtype], design,
               q.data_ptr(), kv.data_ptr(), kv.data_ptr(), lengths.data_ptr(),
               None, out.data_ptr(), part.data_ptr() if scratch else None, B,
               H, KV, S, D, splits, chunk, 0.125)
        torch.cuda.synchronize()

    for args in ((torch.bfloat16, 64, 1, 4, 256), (torch.float16, 128, 1, 1, 1024),
                 (torch.bfloat16, 32, 0, 2, 512), (torch.float32, 64, 0, 16, 64),
                 (torch.bfloat16, 64, 1, 1, 1024, False)):
        run(*args)                                           # taken
    for args in ((torch.float32, 64, 1, 4, 256),             # fp32 on mma
                 (torch.bfloat16, 32, 1, 4, 256),            # D 32 on mma
                 (torch.bfloat16, 64, 2, 4, 256),            # no design 2
                 (torch.bfloat16, 64, 1, 3, 256),            # S not covered
                 (torch.bfloat16, 64, 1, 5, 256),            # a chunk past S
                 (torch.bfloat16, 64, 1, 8, 128 + 32),       # not whole rounds
                 (torch.bfloat16, 64, 1, 32, 32),            # over 16 chunks
                 (torch.bfloat16, 64, 1, 4, 256, False)):    # no partials
        with pytest.raises(KernelLaunchError):
            run(*args)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
@pytest.mark.parametrize("H,KV,alibi", PAGED_HEADS)
@pytest.mark.parametrize("ps,splits", PAGED_SPLITS)
def test_int8_paged_kernel_matches_plain(gen, monkeypatch, dtype, D, T, H,
                                         KV, alibi, ps, splits):
    """The paged test's layout over int8 pages with scale pages."""
    table, starts, P = _paged_case(gen, T, ps, splits, monkeypatch)
    B = starts.shape[0]
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    k8, ks = _int8_rows(gen, P, KV, ps, D)
    v8, vs = _int8_rows(gen, P, KV, ps, D)
    slopes = alibi_slopes(H).cuda() if alibi else None
    before = paged_decode_attention.int8_launches
    got = paged_decode_attention(q, k8, v8, table, starts,
                                 alibi_slopes=slopes, k_scale_pages=ks,
                                 v_scale_pages=vs)
    want = paged_decode_attention_reference(q, k8, v8, table, starts,
                                            1 / math.sqrt(D), slopes, ks, vs)
    torch.cuda.synchronize()
    assert paged_decode_attention.int8_launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype,design", [
    (torch.bfloat16, "mma"), (torch.float16, "mma"), (torch.bfloat16, "fma"),
    (torch.float32, "fma")])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KV", [(12, 12), (32, 4), (8, 1)])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_one_hot_is_exact(gen, monkeypatch, dtype, design, D,
                                       H, KV, T, int8):
    """The paged kernel's fragments, as the decode kernel's one-hot test
    holds them: each (query row t, head) pair of a KV head queries its own
    dim t * g + (h % g) with 100, and its KV head's K holds a single 1 there
    at a random position that every row of the slot sees, read through
    shuffled 24-position pages (a group crosses pages); every other score is
    0, so p is 1 there and exp(-100) elsewhere, which the kernels' exp2
    flushes to 0, and out is that position's V row of small integers,
    exactly. A wrong row, head, dim, position, page or output column, or a
    wrong chunk merge (the rule gives 3, 8 and 16 chunks here), moves whole
    entries."""
    import deepspeed_tpu_torch.ops.attention.paged_attention as pa

    monkeypatch.setattr(pa, "decode_design", lambda *_: design)
    B, ps, max_pages = 3, 24, 42
    S, g = ps * max_pages, H // KV
    P = B * max_pages + 2
    starts = torch.tensor([S - T, 417, 0], dtype=torch.int32, device="cuda")
    table = torch.randperm(P, generator=gen, device="cuda")[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    live = (starts.long() + T + ps - 1) // ps
    table = table.masked_fill(torch.arange(max_pages, device="cuda")[None]
                              >= live[:, None], P).contiguous()
    h = torch.arange(H, device="cuda")
    kvh = h // g
    dim = torch.arange(T, device="cuda")[:, None] * g + h[None] % g  # (T, H)
    target = (torch.rand(B, T, H, generator=gen, device="cuda")
              * (starts.float()[:, None, None] + 1)).long()          # <= start
    q = torch.zeros(B, T, H, D, device="cuda")
    q[:, torch.arange(T)[:, None], h[None], dim] = 100.0
    k = torch.zeros(P, KV, ps, D, device="cuda")
    page = table.long().gather(1, target.reshape(B, -1) // ps).reshape(B, T, H)
    k[page, kvh, target % ps, dim.expand(B, T, H)] = 1.0
    v = torch.randint(-8, 9, (P, KV, ps, D), generator=gen,
                      device="cuda").float()
    want = v[page, kvh, target % ps]                          # (B, T, H, D)
    q = q.to(dtype)
    if int8:
        ones = torch.ones(P, KV, ps, device="cuda")
        got = paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                                     table, starts, scale=1.0,
                                     k_scale_pages=ones, v_scale_pages=ones)
    else:
        got = paged_decode_attention(q, k.to(dtype), v.to(dtype), table,
                                     starts, scale=1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_is_deterministic(gen, int8):
    """The chunks merge in rank order: the same inputs give the same bits
    (TinyLlama's heads over 64-position pages, 4 chunks a tile; and T = 8,
    4 row tiles a KV head)."""
    B, H, KV, D, ps, max_pages = 8, 32, 4, 64, 64, 16
    P = B * max_pages
    table = torch.randperm(P, generator=gen, device="cuda").reshape(
        B, max_pages).to(torch.int32)
    starts = torch.tensor([0, 1017, 500, 64, 63, 700, 1, 900],
                          dtype=torch.int32, device="cuda")
    if int8:
        k8, ks = _int8_rows(gen, P, KV, ps, D)
        v8, vs = _int8_rows(gen, P, KV, ps, D)
        pages = dict(k_pages=k8, v_pages=v8, k_scale_pages=ks,
                     v_scale_pages=vs)
    else:
        pages = dict(k_pages=torch.randn(P, KV, ps, D, generator=gen,
                                         device="cuda").bfloat16(),
                     v_pages=torch.randn(P, KV, ps, D, generator=gen,
                                         device="cuda").bfloat16())
    for T in (1, 8):
        q = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        runs = [paged_decode_attention(q, table=table, starts=starts, **pages)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_paged_entries_refuse_what_the_plan_does_not_give(gen):
    """The entry points take design 0 (FMA: every dtype, D 32, 64, 128) and
    1 (mma.sync: bf16 and fp16 at D 64 and 128), 1..8 query rows, and a plan
    of 1..16 chunks of whole 64-position rounds that covers a slot's
    max_pages * page_size positions with none past it, with fp32 partials
    for more than one chunk and page ids a block can stage; they refuse
    anything else."""
    from deepspeed_tpu_torch.ops.op_builder import (KernelLaunchError,
                                                    launch)

    B, H, KV = 2, 8, 2

    def run(dtype, D, design, splits, chunk, scratch=True, T=1, ps=16,
            max_pages=64):
        P = B * max_pages
        q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(P, KV, ps, D, generator=gen, device="cuda").to(dtype)
        table = torch.arange(P, dtype=torch.int32, device="cuda").reshape(
            B, max_pages)
        starts = torch.full((B,), max_pages * ps - T, dtype=torch.int32,
                            device="cuda")
        out = torch.empty_like(q)
        part = torch.empty(B * T * H * splits * (2 + D), device="cuda")
        launch("paged_decode_attention", q.device, DTYPE[dtype], design,
               q.data_ptr(), kv.data_ptr(), kv.data_ptr(), table.data_ptr(),
               starts.data_ptr(), None, out.data_ptr(),
               part.data_ptr() if scratch else None, B, T, H, KV, P, ps,
               max_pages, D, splits, chunk, 0.125)
        torch.cuda.synchronize()

    for args in ((torch.bfloat16, 64, 1, 4, 256), (torch.float16, 128, 1, 1, 1024),
                 (torch.bfloat16, 32, 0, 2, 512), (torch.float32, 64, 0, 16, 64),
                 (torch.bfloat16, 64, 1, 1, 1024, False),
                 (torch.bfloat16, 64, 1, 2, 512, True, 8)):
        run(*args)                                           # taken
    for args in ((torch.float32, 64, 1, 4, 256),             # fp32 on mma
                 (torch.bfloat16, 32, 1, 4, 256),            # D 32 on mma
                 (torch.bfloat16, 64, 2, 4, 256),            # no design 2
                 (torch.bfloat16, 64, 1, 3, 256),            # S not covered
                 (torch.bfloat16, 64, 1, 5, 256),            # a chunk past S
                 (torch.bfloat16, 64, 1, 8, 128 + 32),       # not whole rounds
                 (torch.bfloat16, 64, 1, 32, 32),            # over 16 chunks
                 (torch.bfloat16, 64, 1, 4, 256, False),     # no partials
                 (torch.bfloat16, 64, 1, 4, 256, True, 9),   # 9 query rows
                 (torch.bfloat16, 64, 1, 4, 256, True, 0),   # no query row
                 # one chunk of 20032 positions over 1-position pages
                 # stages more ids than a block holds
                 (torch.bfloat16, 64, 1, 1, 20032, True, 1, 1, 20000)):
        with pytest.raises(KernelLaunchError):
            run(*args)


@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 64, 300, 512, 1000])
@pytest.mark.parametrize("K,N", [(2048, 256), (64, 1), (40, 200),
                                 (5632, 2048), (1000, 77), (5632, 256)])
@pytest.mark.parametrize("xdtype,odtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float16, torch.float32), (torch.bfloat16, torch.float16)])
def test_int8_matmul_matches_plain(gen, M, K, N, xdtype, odtype):
    """Decode (M <= 16) and prefill tiles of the tensor-core kernel, split K
    (N = 256), and the scalar kernel (K % 16 != 0), at odd and TinyLlama
    shapes."""
    x = torch.randn(M, K, generator=gen, device="cuda").to(xdtype)
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(N, generator=gen, device="cuda") * 1e-3 + 1e-4
    before = int8_matmul.launches
    got = int8_matmul(x, w, s, out_dtype=odtype)
    want = int8_matmul_reference(x, w, s, torch.float32)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1 and got.dtype == odtype
    # the output rounding, relative (bf16 2^-9, fp16 2^-11, with a factor
    # 2); summation order, absolute against the largest output
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8,
            torch.float16: 2 ** -10}[odtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * float(want.abs().max()))


# (M, K, N): every tile shape of int8_plan, split and unsplit, ragged M, N
# and K (a K that is not a multiple of the k slice), and the scalar kernel
INT8_EXACT_SHAPES = [(1, 2048, 256), (8, 2048, 256), (8, 2048, 5632),
                     (16, 5632, 2048), (5, 48, 200), (64, 2048, 5632),
                     (72, 2048, 256), (300, 160, 77), (512, 2048, 5632),
                     (33, 40, 200)]


@pytest.mark.parametrize("M,K,N", INT8_EXACT_SHAPES)
def test_int8_matmul_small_integers_are_exact(gen, M, K, N):
    """The A- and B-fragment paths: x in -2..2 and int8 weights, scale 1,
    fp32 out; every product and partial sum is an integer below 2^24, so
    the kernel must equal the plain version exactly whatever its order."""
    x = torch.randint(-2, 3, (M, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randint(-128, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.ones(N, device="cuda")
    got = int8_matmul(x, w, s, out_dtype=torch.float32)
    torch.testing.assert_close(got, int8_matmul_reference(x, w, s,
                                                          torch.float32),
                               atol=0, rtol=0)


@pytest.mark.parametrize("M", [8, 64])
def test_int8_matmul_converts_every_int8_value_exactly(gen, M):
    """All 256 int8 values through the kernel's int8 -> bf16 conversion:
    weight row n holds n - 128 shifted along k, x is one-hot (row m picks k
    = m), so every output is one weight, exactly."""
    K, N = 64, 256
    n = torch.arange(N, device="cuda")[:, None]
    k = torch.arange(K, device="cuda")[None]
    w = ((n + k) % 256 - 128).to(torch.int8)
    x = torch.eye(M, K, device="cuda", dtype=torch.bfloat16)
    got = int8_matmul(x, w, torch.ones(N, device="cuda"),
                      out_dtype=torch.float32)
    torch.testing.assert_close(got, w[:, :M].t().float(), atol=0, rtol=0)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 256), (64, 2048, 5632),
                                   (72, 5632, 2048)])
def test_int8_matmul_split_k_is_deterministic(gen, M, K, N):
    """Split-K tiles reduce their partials in a fixed order: two calls give
    the same bits."""
    from deepspeed_tpu_torch.ops.quantization.int8_matmul import int8_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert int8_plan(M, K, N, sms)[1] > 1
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(N, generator=gen, device="cuda") * 1e-3 + 1e-4
    a = int8_matmul(x, w, s, out_dtype=torch.float32)
    b = int8_matmul(x, w, s, out_dtype=torch.float32)
    assert torch.equal(a, b)


def test_int8_matmul_entry_refuses_what_its_kernels_do_not_take(gen):
    """The C entry point refuses a tensor-core tile for an unaligned x or
    a K that is not a multiple of 16, and a split outside 1..8 or beyond
    the k slices; int8_plan never asks for these."""
    from deepspeed_tpu_torch.ops.op_builder import (KernelLaunchError,
                                                    launch)

    xs = torch.randn(8 * 64 + 8, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.ones(64, 64, dtype=torch.int8, device="cuda")
    s = torch.ones(64, device="cuda")
    y = torch.empty(8, 64, device="cuda")

    def call(x_ptr, K, tile, splits):
        launch("int8_matmul", y.device, 1, x_ptr, w.data_ptr(), s.data_ptr(),
               0, y.data_ptr(), 8, K, 64, tile, splits)

    call(xs.data_ptr(), 64, 1, 1)                        # taken
    for x_ptr, K, tile, splits in ((xs.data_ptr() + 2, 64, 1, 1),
                                   (xs.data_ptr(), 40, 1, 1),
                                   (xs.data_ptr(), 64, 1, 9),
                                   (xs.data_ptr(), 64, 3, 2),
                                   (xs.data_ptr(), 64, 5, 1),
                                   (xs.data_ptr(), 64, 0, 2)):
        with pytest.raises(KernelLaunchError):
            call(x_ptr, K, tile, splits)


TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _close_to_max(got, want, tol, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    # floored at 1e-2: the inputs are unit-scale, so a gradient that is
    # zero in exact arithmetic (one key: dq = 0) is held to 1e-2 * tol
    err = (got - want).abs().max().item() / max(want.abs().max().item(),
                                                1e-2)
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,T,S,H,KV", [
    (True, 128, 128, 4, 4), (True, 100, 100, 4, 2), (False, 70, 200, 4, 4),
    (True, 1, 1, 2, 2), (False, 129, 65, 8, 2)])
def test_flash_backward_kernels_match_plain(gen, dtype, D, causal, T, S, H,
                                            KV):
    B = 2
    q, do = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=causal)
    delta = attention_delta(out, do)
    scale = 1 / math.sqrt(D)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want_dk, want_dv = flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                           scale)
    _close_to_max(dq, flash_dq_reference(q, k, v, do, lse, delta, causal,
                                         scale), TRAIN_TOL[dtype], "dq")
    _close_to_max(dk, want_dk, TRAIN_TOL[dtype], "dk")
    _close_to_max(dv, want_dv, TRAIN_TOL[dtype], "dv")


@pytest.mark.parametrize("rows", [64, 128])
def test_flash_backward_at_the_tinyllama_training_shape(gen, monkeypatch,
                                                        rows):
    """dq and dk/dv at TinyLlama's training shape (B=4, T=2048, 32 query
    heads over 4 KV heads, D=64, bf16, causal), in both block sizes: the
    dk/dv kernel sums each group of 8 query heads into its KV head."""
    import deepspeed_tpu_torch.ops.attention.flash_attention as fa

    monkeypatch.setattr(fa, "block_rows", lambda *_: rows)
    B, T, H, KV, D = 4, 2048, 32, 4, 64
    q, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, T, KV, D, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    out, lse = flash_attention(q, k, v)
    args = (q, k, v, do, lse, attention_delta(out, do), True,
            1 / math.sqrt(D))
    tol = TRAIN_TOL[torch.bfloat16]
    _close_to_max(flash_attention_dq(*args), flash_dq_reference(*args), tol,
                  "dq")
    for got, ref, name in zip(flash_attention_dkv(*args),
                              flash_dkv_reference(*args), ("dk", "dv")):
        _close_to_max(got, ref, tol, name)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,T,S,H,KV", [
    (True, 129, 129, 4, 2), (False, 70, 200, 4, 4), (True, 300, 300, 2, 2)])
def test_flash_wgmma_block_sizes(gen, monkeypatch, rows, dtype, D, causal, T,
                                 S, H, KV):
    """The wgmma design's forward, dq and dk/dv kernels with 64- and
    128-row blocks alike (the grid rule ``block_rows`` picks one by shape;
    forced here), against the plain versions."""
    import deepspeed_tpu_torch.ops.attention.flash_attention as fa

    monkeypatch.setattr(fa, "block_rows", lambda *_: rows)
    B = 2
    q, do = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=causal)
    want, want_lse = mha_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    args = (q, k, v, do, lse, attention_delta(out, do), causal,
            1 / math.sqrt(D))
    for got, ref, name in zip(flash_attention_dkv(*args),
                              flash_dkv_reference(*args), ("dk", "dv")):
        _close_to_max(got, ref, TRAIN_TOL[dtype], name)
    _close_to_max(flash_attention_dq(*args), flash_dq_reference(*args),
                  TRAIN_TOL[dtype], "dq")


def test_flash_backward_entries_refuse_unknown_designs(gen):
    """The dq and dkv entry points take design 0 (FMA), 1 and 2 (wgmma,
    bf16/fp16 at D 64 and 128) and refuse anything else."""
    from deepspeed_tpu_torch.ops.op_builder import (KernelLaunchError,
                                                    launch)

    def run(dtype, D, design, dkv):
        q, k, v, do = (torch.randn(1, 64, 2, D, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        stats = torch.zeros(1, 2, 64, device="cuda")
        outs = [torch.empty_like(q)] + ([torch.empty_like(q)] if dkv else [])
        launch("flash_attention_bwd", q.device, DTYPE[dtype], design,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               stats.data_ptr(), stats.data_ptr(),
               *(o.data_ptr() for o in outs), 1, 64, 64, 2, 2, D, 0.125, 1,
               symbol="dstorch_flash_attention_" + ("dkv" if dkv else "dq"))

    for dkv in (False, True):
        for dtype, D, design in ((torch.bfloat16, 64, 0),
                                 (torch.bfloat16, 64, 1),
                                 (torch.float16, 128, 2),
                                 (torch.float32, 64, 0)):
            run(dtype, D, design, dkv)                  # taken
        for dtype, D, design in ((torch.bfloat16, 64, 3),
                                 (torch.bfloat16, 64, -1),
                                 (torch.float32, 64, 1),
                                 (torch.bfloat16, 32, 2)):
            with pytest.raises(KernelLaunchError):
                run(dtype, D, design, dkv)


def test_flash_autograd_launches_both_backward_kernels(gen):
    q, k, v = (torch.randn(2, 96, 4, 64, generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    out, _ = flash_attention(q, k, v)
    # a strided cotangent: the backward makes it contiguous itself
    g = torch.randn(2, 4, 96, 64, generator=gen, device="cuda").transpose(1, 2)
    out.backward(g)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    ref, _ = flash_attention(qc, kc, vc)
    ref.backward(g.cpu())
    for got, want in ((q, qc), (k, kc), (v, vc)):
        _close_to_max(got.grad.cpu(), want.grad, 1e-4, "grad")


# fp32 keeps the FMA kernels' shapes (C a multiple of 32, no cap: 2048 and
# the JAX gate's top 4096 included);
# bf16 and fp16 take the wgmma kernels' gate (C a multiple of 64, N of 8):
# ragged M against the 128-row tile, C from one K slice to the top of the
# JAX gate and GPT-2 XL's 1600 (ragged against the 128-column backward
# tile), N from one 8-column group to ragged against the forward tile
LN_LINEAR_SHAPES = [
    (torch.float32, M, C, N) for M, C, N in
    [(128, 128, 128), (70, 96, 50), (33, 1536, 130), (1, 32, 1),
     (300, 1024, 640), (200, 2048, 136), (33, 2048, 8), (130, 4096, 300),
     (1, 4096, 64)]] + [
    (dtype, M, C, N) for dtype in (torch.bfloat16, torch.float16)
    for M in (1, 33, 1000) for C in (64, 1024, 1600, 4096)
    for N in (8, 136, 3072)]


@pytest.mark.parametrize("dtype,M,C,N", LN_LINEAR_SHAPES)
def test_ln_linear_kernels_match_plain(gen, dtype, M, C, N):
    x = (torch.randn(M, C, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    w = (torch.randn(N, C, generator=gen, device="cuda") / math.sqrt(C)
         ).to(dtype)
    bias = (0.1 * torch.randn(N, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(M, N, generator=gen, device="cuda").to(dtype)
    before = (ln_linear_fwd.launches, ln_linear_bwd_dx.launches)
    y, mean, rstd = ln_linear_fwd(x, g, b, w, bias)
    dx, dg, db = ln_linear_bwd_dx(dy, w, x, g, mean, rstd)
    torch.cuda.synchronize()
    assert (ln_linear_fwd.launches, ln_linear_bwd_dx.launches) == \
        (before[0] + 1, before[1] + 1)
    ry, rmean, rrstd = ln_linear_fwd_reference(x, g, b, w, bias, 1e-5)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)
    _close_to_max(y, ry, TRAIN_TOL[dtype], "y")
    rdx, rdg, rdb = ln_linear_bwd_dx_reference(dy, w, x, g, mean, rstd)
    assert dg.shape == rdg.shape
    _close_to_max(dx, rdx, TRAIN_TOL[dtype], "dx")
    _close_to_max(dg.sum(0), rdg.sum(0), 1e-4, "dgamma")
    _close_to_max(db.sum(0), rdb.sum(0), 1e-4, "dbeta")


def test_ln_linear_autograd_and_refusals(gen):
    x = torch.randn(4, 16, 256, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    ln = torch.nn.LayerNorm(256, device="cuda", dtype=torch.bfloat16)
    fc = torch.nn.Linear(256, 384, device="cuda", dtype=torch.bfloat16)
    before = (ln_linear_fwd.launches, ln_linear_bwd_dx.launches)
    y = ln_linear(x, ln.weight, ln.bias, fc.weight, fc.bias)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (ln_linear_fwd.launches, ln_linear_bwd_dx.launches) == \
        (before[0] + 1, before[1] + 1)
    assert all(p.grad is not None for p in (*ln.parameters(),
                                            *fc.parameters()))
    # a shape the gate refuses raises on the card: no silent plain path
    xr = torch.randn(8, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="does not tile"):
        ln_linear(xr, torch.ones(48, device="cuda"),
                  torch.zeros(48, device="cuda"),
                  torch.randn(8, 48, device="cuda"),
                  torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="does not tile"):
        ln_linear_fwd(xr, torch.ones(48, device="cuda"),
                      torch.zeros(48, device="cuda"),
                      torch.randn(8, 48, device="cuda"),
                      torch.zeros(8, device="cuda"))
    # bf16 refusals of the wgmma kernels: C not a multiple of 64, N not of 8
    bf = dict(device="cuda", dtype=torch.bfloat16)
    for c, n in ((96, 64), (128, 12)):
        xb = torch.randn(8, c, **bf)
        args = (torch.ones(c, **bf), torch.zeros(c, **bf),
                torch.randn(n, c, **bf), torch.zeros(n, **bf))
        with pytest.raises(ValueError, match="does not tile"):
            ln_linear(xb, *args)
        with pytest.raises(ValueError, match="does not tile"):
            ln_linear_fwd(xb, *args)
        with pytest.raises(ValueError, match="does not tile"):
            ln_linear_bwd_dx(torch.randn(8, n, **bf), args[2], xb, args[0],
                             torch.zeros(8, device="cuda"),
                             torch.ones(8, device="cuda"))


@pytest.mark.parametrize("n_embd", [1600, 2048, 4096])
def test_fused_ln_linear_model_at_wide_c(gen, n_embd):
    """``fused_ln_linear=True`` on a bf16 GPT-2 layer at GPT-2 XL's, the
    1.3B's and the JAX gate's top width runs the kernels (qkv and fc, once
    each way), and its loss and gradients match the unfused model's; a
    width the gate refuses raises."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=n_embd,
                     n_layer=1, n_head=n_embd // 64, dtype=torch.bfloat16,
                     use_flash_attention=False, fused_ln_linear=True)
    model = GPT2LMHeadModel(cfg, device="cuda").to(torch.bfloat16)
    model.init_weights(gen)
    batch = {"input_ids": torch.randint(0, 256, (2, 64), generator=gen,
                                        device="cuda")}
    out = []
    for fused in (True, False):
        model.replace_config(fused_ln_linear=fused)
        model.zero_grad(set_to_none=True)
        before = (ln_linear_fwd.launches, ln_linear_bwd_dx.launches)
        loss = model(batch)
        loss.backward()
        torch.cuda.synchronize()
        got = (ln_linear_fwd.launches - before[0],
               ln_linear_bwd_dx.launches - before[1])
        assert got == ((2, 2) if fused else (0, 0))
        out.append((loss.item(), {k: p.grad.float()
                                  for k, p in model.named_parameters()}))
    (loss_f, grads_f), (loss_u, grads_u) = out
    assert abs(loss_f - loss_u) <= 1e-2 * abs(loss_u)
    for k, g in grads_u.items():
        _close_to_max(grads_f[k], g, 5e-2, k)
    refused = GPT2Config(vocab_size=256, n_positions=64, n_embd=1000,
                         n_layer=1, n_head=8, dtype=torch.bfloat16,
                         use_flash_attention=False, fused_ln_linear=True)
    model = GPT2LMHeadModel(refused, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="does not tile"):
        model(batch)


def test_fused_ln_linear_fp32_model_at_wide_c(gen):
    """``fused_ln_linear=True`` on an fp32 GPT-2 layer at C = 2048, which
    the fp32 gate used to refuse, runs the kernels (qkv and fc, once each
    way), and its loss and gradients match the unfused model's (summation
    order only: fp32 throughout)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=2048, n_layer=1,
                     n_head=32, dtype=torch.float32,
                     use_flash_attention=False, fused_ln_linear=True)
    model = GPT2LMHeadModel(cfg, device="cuda")
    model.init_weights(gen)
    batch = {"input_ids": torch.randint(0, 256, (2, 64), generator=gen,
                                        device="cuda")}
    out = []
    for fused in (True, False):
        model.replace_config(fused_ln_linear=fused)
        model.zero_grad(set_to_none=True)
        before = (ln_linear_fwd.launches, ln_linear_bwd_dx.launches)
        loss = model(batch)
        loss.backward()
        torch.cuda.synchronize()
        got = (ln_linear_fwd.launches - before[0],
               ln_linear_bwd_dx.launches - before[1])
        assert got == ((2, 2) if fused else (0, 0))
        out.append((loss.item(), {k: p.grad.float().clone()
                                  for k, p in model.named_parameters()}))
    (loss_f, grads_f), (loss_u, grads_u) = out
    assert abs(loss_f - loss_u) <= 1e-5 * abs(loss_u)
    for k, g in grads_u.items():
        _close_to_max(grads_f[k], g, TRAIN_TOL[torch.float32], k)


def test_flash_kernels_at_the_dense_arm_shape(gen):
    """The forward, dq and dk/dv kernels (wgmma design: bf16, D = 64) at
    B=1, H=12, T=8192, causal, the flash-dense training arm's shape: 64 key
    tiles of the forward's walk, 128 of dq's and 128 query tiles of the
    dk/dv walk."""
    B, T, H, D = 1, 8192, 12, 64
    dtype = torch.bfloat16
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    before = (flash_attention.launches, flash_attention_dkv.launches)
    out, lse = flash_attention(q, k, v, causal=True)
    want, want_lse = mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    del want, want_lse
    delta = attention_delta(out, do)
    scale = 1 / math.sqrt(D)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want_dk, want_dv = flash_dkv_reference(q, k, v, do, lse, delta, True,
                                           scale)
    _close_to_max(dk, want_dk, TRAIN_TOL[dtype], "dk")
    _close_to_max(dv, want_dv, TRAIN_TOL[dtype], "dv")
    del want_dk, want_dv
    _close_to_max(flash_attention_dq(q, k, v, do, lse, delta, True, scale),
                  flash_dq_reference(q, k, v, do, lse, delta, True, scale),
                  TRAIN_TOL[dtype], "dq")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_accumulator_packs_into_a_fragments(gen, dtype):
    """The packing the wgmma attention kernels use, alone: S = a bᵀ by an
    SS wgmma, its fp32 accumulator packed into A fragments in registers, o
    = S c by an RS wgmma reading c through the transpose-B bit. Small
    integers keep every value exact in 16 bits and fp32, so o equals the
    plain product exactly; a misplaced register pair moves whole entries."""
    from deepspeed_tpu_torch.ops.op_builder import DTYPE_CODES, launch

    a, b = (torch.randint(-1, 2, (64, 64), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    c = torch.randint(-2, 3, (64, 64), generator=gen, device="cuda").to(dtype)
    o = torch.empty(64, 64, device="cuda")
    launch("flash_attention_fwd", a.device, DTYPE_CODES[dtype], a.data_ptr(),
           b.data_ptr(), c.data_ptr(), o.data_ptr(),
           symbol="dstorch_wgmma_pack_probe")
    torch.cuda.synchronize()
    want = (a.float() @ b.float().t()) @ c.float()
    assert want.abs().max() > 0
    torch.testing.assert_close(o, want, atol=0, rtol=0)


def _sparse_layout(kind, H, n, block):
    """(H, n, n) layouts: BigBird unidirectional with one layout per head;
    Fixed bidirectional with horizontal globals; a hand-made one with empty
    rows, a block above the diagonal and a key block that no row lists."""
    if kind == "bigbird":
        return BigBirdSparsityConfig(
            num_heads=H, block=block, different_layout_per_head=True,
            num_random_blocks=1, num_sliding_window_blocks=3,
            num_global_blocks=1, attention="unidirectional").make_layout(
                n * block)
    if kind == "fixed":
        return FixedSparsityConfig(
            num_heads=H, block=block, num_local_blocks=2, num_global_blocks=1,
            horizontal_global_attention=True).make_layout(n * block)
    layout = np.tril(np.ones((H, n, n), np.int32))
    layout[0, 1] = 0                 # head 0: query block 1 attends nothing
    layout[1, 0, 2] = 1              # head 1: row 0 lists a future block
    layout[-1, 2:, 1] = 0
    layout[0, :, -1] = 0             # head 0: no row lists the last block
    return layout


# (dtype, wgmma block rows): fp32 takes the FMA design, bf16 each wgmma size
SPARSE_DESIGNS = [(torch.float32, None), (torch.bfloat16, 64),
                  (torch.bfloat16, 128)]


@pytest.mark.parametrize("dtype,rows", SPARSE_DESIGNS)
@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("kind,causal", [("bigbird", True), ("fixed", False),
                                         ("empty", True), ("empty", False)])
def test_block_sparse_kernels_match_plain(gen, monkeypatch, dtype, rows,
                                          block, kind, causal):
    B, H, D, n = 2, 3, 64, 4
    _force_sparse_rows(monkeypatch, rows)
    _check_block_sparse(gen, dtype, B, H, D, n, block,
                        _sparse_layout(kind, H, n, block), causal,
                        _design(dtype, D, rows))


@pytest.mark.parametrize("D,rows", [(32, None), (128, 64), (128, 128)])
def test_block_sparse_kernels_head_dims(gen, monkeypatch, D, rows):
    _force_sparse_rows(monkeypatch, rows)
    _check_block_sparse(gen, torch.bfloat16, 1, 2, D, 6, 128,
                        _sparse_layout("bigbird", 2, 6, 128), True,
                        _design(torch.bfloat16, D, rows))


@pytest.mark.parametrize("block", [64, 192])
@pytest.mark.parametrize("kind,causal", [("bigbird", True), ("empty", True),
                                         ("fixed", False)])
def test_block_sparse_granules_off_128_take_64_row_blocks(gen, block, kind,
                                                          causal):
    """A granule that is not a multiple of 128 cannot hold a 128-row block
    inside one layout row: the rule gives 64-row blocks (design 2), as it
    would on any grid."""
    _check_block_sparse(gen, torch.bfloat16, 2, 3, 64, 6, block,
                        _sparse_layout(kind, 3, 6, block), causal, 2)


@pytest.mark.parametrize("rows", [64, 128])
def test_block_sparse_dkv_long_columns_off_tile_0(gen, monkeypatch, rows):
    """Fixed with horizontal globals: the columns that every query block
    lists are the last block of each window, not key tile 0; the wgmma
    dk/dv kernel's launch order starts them first, wherever they lie."""
    import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel as bsk

    layout = FixedSparsityConfig(
        num_heads=2, block=128, num_local_blocks=4, num_global_blocks=1,
        horizontal_global_attention=True).make_layout(8 * 128)
    per_column = layout.sum(1)
    assert per_column[:, 0].max() < per_column.max()
    cnt_t = schedule(layout, "cuda")[3]
    assert bsk.launch_order(cnt_t)[:4].tolist() == [3, 7, 11, 15]
    _force_sparse_rows(monkeypatch, rows)
    _check_block_sparse(gen, torch.bfloat16, 1, 2, 64, 8, 128, layout, False,
                        1 if rows == 128 else 2)


def test_block_sparse_entries_refuse_unknown_designs(gen):
    """The forward, dq and dkv entry points take design 0 (FMA), 1 (wgmma,
    128-row blocks: bf16/fp16 at D 64 and 128, a granule that is a multiple
    of 128) and 2 (wgmma, 64-row blocks) and refuse anything else."""
    import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.op_builder import (KernelLaunchError,
                                                    launch)

    def run(dtype, D, design, kernel, block=128):
        H, T = 2, 2 * block
        layout = np.tril(np.ones((H, 2, 2), np.int32))
        idx, cnt, idx_t, cnt_t = schedule(layout, "cuda")
        q, k, v, do = (torch.randn(1, T, H, D, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        stats = torch.zeros(1, H, T, device="cuda")
        if kernel == "fwd":
            launch("block_sparse_attention", q.device, DTYPE[dtype], design,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   torch.empty_like(q).data_ptr(), stats.data_ptr(),
                   idx.data_ptr(), cnt.data_ptr(), 1, T, H, D, idx.shape[2],
                   block, 0.125, 1, symbol="dstorch_block_sparse_fwd")
            return
        dkv = kernel == "dkv"
        sched = (idx_t, cnt_t, bsk.launch_order(cnt_t)) if dkv else (idx, cnt)
        outs = [torch.empty_like(q)] + ([torch.empty_like(q)] if dkv else [])
        launch("block_sparse_attention", q.device, DTYPE[dtype], design,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               stats.data_ptr(), stats.data_ptr(),
               *(t.data_ptr() for t in sched), *(o.data_ptr() for o in outs),
               1, T, H, D, sched[0].shape[2], block, 0.125, 1,
               symbol="dstorch_block_sparse_" + kernel)

    for kernel in ("fwd", "dq", "dkv"):
        for dtype, D, design, block in ((torch.bfloat16, 64, 0, 128),
                                        (torch.bfloat16, 64, 1, 128),
                                        (torch.float16, 128, 2, 128),
                                        (torch.bfloat16, 64, 2, 192),
                                        (torch.float32, 64, 0, 128)):
            run(dtype, D, design, kernel, block)          # taken
        for dtype, D, design, block in ((torch.bfloat16, 64, 3, 128),
                                        (torch.bfloat16, 64, -1, 128),
                                        (torch.float32, 64, 1, 128),
                                        (torch.bfloat16, 32, 2, 128),
                                        (torch.bfloat16, 64, 1, 192)):
            with pytest.raises(KernelLaunchError):
                run(dtype, D, design, kernel, block)


def _force_sparse_rows(monkeypatch, rows):
    """Make the wgmma design take ``rows``-row blocks (None: the rule)."""
    import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel as bsk

    if rows is not None:
        monkeypatch.setattr(bsk, "sparse_block_rows", lambda *_: rows)


def _design(dtype, D, rows):
    """The design code a forced ``rows`` gives (0: the FMA design)."""
    if dtype == torch.float32 or D == 32:
        return 0
    return 1 if rows == 128 else 2


def _check_block_sparse(gen, dtype, B, H, D, n, block, layout, causal,
                        design):
    import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel as bsk

    T = n * block
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    idx, cnt, idx_t, cnt_t = schedule(layout, "cuda")
    scale = 1 / math.sqrt(D)
    assert (bsk._design_code(q, block, "fwd"), bsk._design_code(q, block, "dq"),
            bsk._design_code(q, block, "dkv")) == (design, design, design)
    before = (block_sparse_fwd.launches, block_sparse_dq.launches,
              block_sparse_dkv.launches)
    out, lse = block_sparse_fwd(q, k, v, idx, cnt, block, causal, scale)
    want, want_lse = block_sparse_fwd_reference(q, k, v, idx, cnt, block,
                                                causal, scale)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    # a query with no live key (an empty row, a causal row whose blocks all
    # lie in its future): out exactly 0, lse -1e30
    alone = ~bsk._token_mask(idx, cnt, block, T, causal).any(2)   # (H, T)
    if alone.any():
        assert out.permute(0, 2, 1, 3)[:, alone].abs().max().item() == 0
        assert (lse[:, alone] == NEG_INF32).all()
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta)
    dq = block_sparse_dq(*args, idx, cnt, block, causal, scale)
    dk, dv = block_sparse_dkv(*args, idx_t, cnt_t, block, causal, scale)
    torch.cuda.synchronize()
    assert (block_sparse_fwd.launches, block_sparse_dq.launches,
            block_sparse_dkv.launches) == tuple(x + 1 for x in before)
    _close_to_max(dq, block_sparse_dq_reference(*args, idx, cnt, block,
                                                causal, scale),
                  TRAIN_TOL[dtype], "dq")
    want_dk, want_dv = block_sparse_dkv_reference(*args, idx_t, cnt_t, block,
                                                  causal, scale)
    _close_to_max(dk, want_dk, TRAIN_TOL[dtype], "dk")
    _close_to_max(dv, want_dv, TRAIN_TOL[dtype], "dv")
    # a query with no live key, a key that no query attends: exactly 0
    mask = bsk._token_mask(idx, cnt, block, T, causal)     # (H, T, T)
    for name, grad, dead in (("dq", dq, ~mask.any(2)),
                             ("dk", dk, ~mask.any(1)),
                             ("dv", dv, ~mask.any(1))):
        if dead.any():
            got = grad.permute(0, 2, 1, 3)[:, dead].abs().max().item()
            assert got == 0, f"{name} of an unattended row: {got}"


def test_block_sparse_autograd_and_refusals(gen):
    layout = _sparse_layout("bigbird", 4, 4, 128)
    q, k, v = (torch.randn(2, 512, 4, 64, generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    before = (block_sparse_fwd.launches, block_sparse_dq.launches,
              block_sparse_dkv.launches)
    out = block_sparse_flash_attention(q, k, v, layout, 128, causal=True)
    g = torch.randn(2, 4, 512, 64, generator=gen, device="cuda")
    out.backward(g.transpose(1, 2))          # a strided cotangent
    torch.cuda.synchronize()
    assert (block_sparse_fwd.launches, block_sparse_dq.launches,
            block_sparse_dkv.launches) == tuple(x + 1 for x in before)
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    ref = block_sparse_flash_attention(qc, kc, vc, layout, 128, causal=True)
    ref.backward(g.cpu().transpose(1, 2))
    _close_to_max(out.detach().cpu(), ref.detach(), 1e-4, "out")
    for got, want in ((q, qc), (k, kc), (v, vc)):
        _close_to_max(got.grad.cpu(), want.grad, 1e-4, "grad")
    # what the kernels do not take raises on the card: no plain path
    idx, cnt, _, _ = schedule(layout, "cuda")
    x = torch.randn(1, 512, 4, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        block_sparse_fwd(x, x, x, idx, cnt, 128, True, 1.0)
    x = torch.randn(1, 512, 4, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        block_sparse_fwd(x, x, x, idx.long(), cnt, 128, True, 1.0)
    with pytest.raises(ValueError, match="grouped-query"):
        block_sparse_fwd(x, x[:, :, :2].contiguous(), x, idx, cnt, 128, True,
                         1.0)


# -- the captured decode step (inference/decode_graph.py) -------------------
# A 2-layer model on the card at serving widths: GPT-2's (12 heads, D 64,
# bf16) or a GQA 8/2 llama with int8 weights and the int8 KV cache. The
# captured step replays the same kernels on the same inputs as the eager
# one, so its logits are held to 1e-3 relative per row (bit-equal is
# expected) and its greedy tokens exactly.

def _graph_engines(gen, int8: bool):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import (TransformerLM,
                                                           transformer_config)

    if int8:
        cfg = transformer_config("llama", vocab_size=512, n_embd=512,
                                 n_layer=2, n_head=8, n_kv_head=2,
                                 max_seq_len=256, kv_cache_quant=True,
                                 dtype=torch.bfloat16)
    else:
        cfg = transformer_config("gpt2", vocab_size=512, n_embd=768,
                                 n_layer=2, n_head=12, max_seq_len=256,
                                 dtype=torch.bfloat16)
    model = TransformerLM(cfg, device="cuda")
    model.init_weights(gen)
    # int8: the first engine quantizes the model in place; the second
    # serves the same int8 model (its compute tier is already applied)
    eager = dst.init_inference(model, config={
        "dtype": "int8" if int8 else "bfloat16"})
    graph = dst.init_inference(model, config={"dtype": "bfloat16",
                                              "enable_cuda_graph": True})
    return eager, graph


def _launch_counts():
    from deepspeed_tpu_torch.inference.decode_graph import LAUNCH_COUNTERS
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _decode_steps(eng, route, cache, pool, toks, starts):
    out = []
    for step, tok in enumerate(toks):
        pos = starts + step
        if route == "paged":
            for s in range(len(starts)):
                pool.ensure_writable(s, int(pos[s]), int(pos[s]) + 1)
            out.append(eng.decode_paged(cache, tok, pos, pool.table_dev,
                                        scratch_page=True))
        else:
            out.append(eng.decode(cache, tok, pos))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("route", ["contiguous", "paged"])
def test_captured_decode_equals_eager_with_exact_launch_counts(gen, route,
                                                              int8):
    from deepspeed_tpu_torch.serving import PagedKVPool

    eager, graph = _graph_engines(gen, int8)
    B, T, L = 4, 40, 2
    ids = torch.randint(0, 512, (B, T), generator=gen, device="cuda")
    starts = torch.tensor([T, 33, 12, 1], dtype=torch.int32, device="cuda")
    toks = torch.randint(0, 512, (5, B, 1), generator=gen, device="cuda")
    _, dense = eager.prefill_at(ids)
    caches, pools = [], []
    for _ in range(2):
        if route == "paged":
            pool = PagedKVPool(eager.kv_cache_spec(), num_slots=B,
                               page_size=16, device="cuda",
                               prefix_cache=False)
            slots = [pool.alloc() for _ in range(B)]
            pool.admit_rows(dense, slots, np.full(B, T))
            caches.append(pool.cache)
            pools.append(pool)
        else:
            caches.append({k: v.clone() for k, v in dense.items()})
            pools.append(None)
    runs = []
    for eng, cache, pool in ((eager, caches[0], pools[0]),
                             (graph, caches[1], pools[1])):
        before = _launch_counts()
        runs.append(_decode_steps(eng, route, cache, pool, toks, starts))
        runs.append([a - b for a, b in zip(_launch_counts(), before)])
    (want, eager_counts), (got, graph_counts) = runs[:2], runs[2:]
    assert graph.decode_graphs.captures == 1
    assert graph_counts == eager_counts
    attn = ("paged_decode_attention" if route == "paged"
            else "decode_attention")
    from deepspeed_tpu_torch.inference.decode_graph import LAUNCH_COUNTERS
    counts = {(fn.__name__, attr): n for (fn, attr), n in
              zip(LAUNCH_COUNTERS, graph_counts)}
    assert counts[attn, "int8_launches" if int8 else "launches"] == L * 5
    assert counts["int8_matmul", "launches"] == (7 * L * 5 if int8 else 0)
    assert counts["int8_matmul", "prefill_launches"] == 0
    for step, (a, b) in enumerate(zip(got, want)):
        rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        assert rel <= 1e-3, f"step {step}: rel {rel}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"step {step}"
    for key in caches[0]:
        if route == "paged":    # the scratch page takes dropped rows
            assert torch.equal(caches[0][key][:, :-1], caches[1][key][:, :-1])
        else:
            assert torch.equal(caches[0][key], caches[1][key]), key


@pytest.mark.parametrize("paged", [False, True])
def test_captured_server_replays_across_churn_and_reset(gen, paged):
    """A captured server's one decode graph survives slot churn, a pool
    reset and a fresh generate(): nothing is captured again, and the greedy
    tokens are the eager server's."""
    import deepspeed_tpu_torch as dst

    eager, graph = _graph_engines(gen, int8=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(4, 90, 10)]
    tokens = {}
    for name, eng in (("eager", eager), ("graph", graph)):
        srv = dst.ServingEngine(eng, num_slots=4, prefill_chunk=32,
                                paged_kv={"page_size": 16} if paged
                                else False, strict_recompile=True)
        out = []
        for wave in range(2):
            reqs = [srv.submit(p, max_new_tokens=12) for p in prompts]
            srv.run_until_drained()
            srv.check_invariants()
            out.append([r.tokens() for r in reqs])
            if wave == 0:
                srv.end_warmup()
                srv.pool.reset()
        tokens[name] = out
        assert srv.watchdog.recompiles == 0
    assert graph.decode_graphs.captures == 1
    for wave in range(2):
        for a, b in zip(tokens["eager"][wave], tokens["graph"][wave]):
            np.testing.assert_array_equal(a, b)


def test_guard_fails_a_poisoned_row_of_a_captured_paged_step_alone(gen):
    """The numerics guard on a captured paged decode step: a FaultInjector
    writes NaN into one running row of a replayed step's logits (on the
    card, in place). That request alone ends FAILED numerical_error, the
    others' tokens are an unpoisoned server's, every step makes at most one
    device-to-host fetch (exactly one when it decodes: the guard's flags
    ride the tokens'), and nothing is captured again."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving import RequestState
    from deepspeed_tpu_torch.serving.resilience import FaultInjector

    _, graph = _graph_engines(gen, int8=False)
    rng = np.random.default_rng(5)
    # four requests on four slots: both servers admit them alike
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in (9, 30, 45, 60)]
    out = {}
    for name, schedule in (("clean", {}), ("poisoned", {"nan_logits": [3]})):
        srv = dst.ServingEngine(graph, num_slots=4, prefill_chunk=32,
                                paged_kv={"page_size": 16},
                                guard_numerics=True, strict_recompile=True,
                                fault_injector=FaultInjector(
                                    seed=0, schedule=schedule))
        reqs = [srv.submit(p, max_new_tokens=12) for p in prompts]
        while srv.pending or srv.live_count:
            fetches, decodes = srv.fetches, srv.metrics.decode_steps
            srv.step()
            decoded = srv.metrics.decode_steps - decodes
            assert srv.fetches - fetches == decoded or \
                (decoded == 0 and srv.fetches - fetches <= 1)
        srv.check_invariants()
        assert srv.pool.free_page_count + len(
            srv.pool.prefix.page_counts()) == srv.pool.num_pages
        captures = [e for e in srv.watchdog.events
                    if e["program"] == "DecodeGraphs.capture"]
        assert len(captures) == 1
        out[name] = reqs
    assert graph.decode_graphs.captures == 2      # one per server's pool
    bad = [r for r in out["poisoned"] if r.state is RequestState.FAILED]
    assert len(bad) == 1 and bad[0].finish_reason == "numerical_error"
    for a, b in zip(out["poisoned"], out["clean"]):
        assert b.state is RequestState.FINISHED
        if a is not bad[0]:
            assert a.state is RequestState.FINISHED
            np.testing.assert_array_equal(a.tokens(), b.tokens())
        else:
            # the tokens before the poisoned step are the clean ones
            assert a.output_tokens == b.output_tokens[:len(a.output_tokens)]


def test_a_decode_step_that_cannot_be_captured_raises(gen):
    """With the switch on, a step that syncs the host (here the paged
    write made to select its rows on the host) raises at its first call
    instead of running eagerly. A failed capture can leave the CUDA
    context unusable, so it runs in a process of its own."""
    import subprocess
    import sys
    code = (
        "import numpy as np, torch\n"
        "import deepspeed_tpu_torch as dst\n"
        "from deepspeed_tpu_torch.models import transformer_lm as tl\n"
        "orig = tl.page_writes\n"
        "tl.page_writes = lambda *a, scratch=False: orig(*a)\n"
        "cfg = tl.transformer_config('gpt2', vocab_size=512, n_embd=768,\n"
        "    n_layer=2, n_head=12, max_seq_len=256, dtype=torch.bfloat16)\n"
        "eng = dst.init_inference(tl.TransformerLM(cfg),\n"
        "    config={'dtype': 'bfloat16', 'enable_cuda_graph': True})\n"
        "srv = dst.ServingEngine(eng, num_slots=2, paged_kv=True)\n"
        "srv.submit(np.arange(9, dtype=np.int32), max_new_tokens=4)\n"
        "try:\n"
        "    srv.run_until_drained()\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert "RAISED" in done.stdout, done.stdout + done.stderr
    assert "captur" in done.stdout.lower(), done.stdout


# -- speculative verify (serving/spec_decode/) ------------------------------
# A verify step sends K+1 query rows a slot through the paged kernel: every
# T from 1 to 8 at the serving layout (64-position pages, the plan's own
# split) under GPT-2's heads and TinyLlama's GQA 32/4, where T = 5 leaves
# the last row tile of a KV head partly empty (40 of 48 rows).

@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("H,KV", [(12, 12), (32, 4)])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_kernel_every_verify_width(gen, monkeypatch, T, H, KV, int8):
    table, starts, P = _paged_case(gen, T, 64, None, monkeypatch)
    B, D = starts.shape[0], 64
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    if int8:
        k, ks = _int8_rows(gen, P, KV, 64, D)
        v, vs = _int8_rows(gen, P, KV, 64, D)
        scales = dict(k_scale_pages=ks, v_scale_pages=vs)
    else:
        k, v = (torch.randn(P, KV, 64, D, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        scales = {}
    counter = "int8_launches" if int8 else "launches"
    before = getattr(paged_decode_attention, counter)
    got = paged_decode_attention(q, k, v, table, starts, **scales)
    want = paged_decode_attention_reference(
        q, k, v, table, starts, 1 / math.sqrt(D), None,
        scales.get("k_scale_pages"), scales.get("v_scale_pages"))
    torch.cuda.synchronize()
    assert getattr(paged_decode_attention, counter) == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("route", ["contiguous", "paged"])
def test_captured_verify_equals_eager_with_exact_launch_counts(gen, route,
                                                              int8):
    """Three k=4 verify steps (random drafts, draft lengths 0-4, positions
    advanced by what each step emits) on an eager engine and on a captured
    one: the same emitted tokens and counts, the same cache, one capture,
    and the same launches, counted exactly: the paged kernel (route
    "paged") 2 layers a step, no decode kernel (the contiguous verify is
    the window-masked einsum), and with int8 weights int8_matmul 7 x 2 a
    step in its prefill tiles (M = 4 slots x 5 rows)."""
    from deepspeed_tpu_torch.inference.decode_graph import LAUNCH_COUNTERS
    from deepspeed_tpu_torch.serving import PagedKVPool

    eager, graph = _graph_engines(gen, int8)
    B, T, L, K, steps = 4, 40, 2, 4, 3
    ids = torch.randint(0, 512, (B, T), generator=gen, device="cuda")
    tokens = torch.randint(0, 512, (steps, B, K + 1), generator=gen,
                           device="cuda")
    lens = torch.randint(0, K + 1, (steps, B), generator=gen, device="cuda")
    _, dense = eager.prefill_at(ids)
    runs = []
    for eng in (eager, graph):
        if route == "paged":
            pool = PagedKVPool(eager.kv_cache_spec(), num_slots=B,
                               page_size=16, device="cuda",
                               prefix_cache=False)
            pool.admit_rows(dense, [pool.alloc() for _ in range(B)],
                            np.full(B, T))
            cache = pool.cache
        else:
            cache = {k: v.clone() for k, v in dense.items()}
        before = _launch_counts()
        pos = torch.tensor([T, 33, 12, 1], dtype=torch.int32, device="cuda")
        outs = []
        for step in range(steps):
            args = (tokens[step], pos, tokens[step, :, 1:], lens[step], None,
                    1.0, True, 0, 1.0)
            if route == "paged":
                for s in range(B):
                    pool.ensure_writable(s, int(pos[s]), int(pos[s]) + K + 1)
                out, n_emit = pool.run_verify(eng, *args)
            else:
                out, n_emit = eng.verify_k(cache, *args)
            outs.append((out.clone(), n_emit.clone()))
            pos = pos + n_emit.int()
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(_launch_counts(), before)]
        runs.append((outs, counts, cache))
    (want, eager_counts, eager_cache), (got, graph_counts, graph_cache) = runs
    assert graph.decode_graphs.captures == 1
    assert graph_counts == eager_counts
    counts = {(fn.__name__, attr): n for (fn, attr), n in
              zip(LAUNCH_COUNTERS, graph_counts)}
    paged = L * steps if route == "paged" else 0
    assert counts["paged_decode_attention",
                  "int8_launches" if int8 else "launches"] == paged
    assert counts["decode_attention", "launches"] == 0
    assert counts["decode_attention", "int8_launches"] == 0
    assert counts["int8_matmul", "launches"] == \
        counts["int8_matmul", "prefill_launches"] == \
        (7 * L * steps if int8 else 0)
    for step, ((a, na), (b, nb)) in enumerate(zip(got, want)):
        assert torch.equal(na, nb), f"step {step}"
        assert torch.equal(a, b), f"step {step}"
    for key in eager_cache:
        if route == "paged":    # the scratch page takes dropped rows
            assert torch.equal(eager_cache[key][:, :-1],
                               graph_cache[key][:, :-1]), key
        else:
            assert torch.equal(eager_cache[key], graph_cache[key]), key


# ---------------------------------------------------------------------------
# the inference engine's remaining tiers: int8 quantization on the card and
# on the host, the storage tier's captured step, ZeRO-Inference's stream

def test_quantize_columns_on_the_card_equals_the_host(gen):
    """The card's per-channel scales and values are the host's bit for
    bit (a Python-number divisor would be a reciprocal multiply on CUDA):
    ZeRO-Inference quantizes on the host what the compute tier quantizes
    on the card."""
    from deepspeed_tpu_torch.ops.quantization import quantize_columns

    w = (torch.randn(2048, 5632, generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    qd, sd = quantize_columns(w)
    qh, sh = quantize_columns(w.cpu())
    assert torch.equal(sd.cpu(), sh) and torch.equal(qd.cpu(), qh)


def test_storage_tier_captured_step_equals_eager(gen):
    """fp16 with int8 at rest: a captured paged decode step (the
    dequantization recorded in the graph) gives the eager step's logits
    and cache bit for bit, with the paged kernel's launches exact."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import (TransformerLM,
                                                           transformer_config)
    from deepspeed_tpu_torch.ops.attention.paged_attention import \
        paged_decode_attention
    from deepspeed_tpu_torch.serving import PagedKVPool

    cfg = transformer_config("gpt2", vocab_size=512, n_embd=768, n_layer=2,
                             n_head=12, max_seq_len=256,
                             dtype=torch.float16)
    model = TransformerLM(cfg, device="cuda")
    model.init_weights(gen)
    eager = dst.init_inference(model, config={
        "dtype": "float16", "quant": {"enabled": True, "group_size": 64}})
    assert eager.module.blocks[0].attn.q_proj.parametrizations.weight \
        .original.dtype == torch.int8
    graph = dst.init_inference(model, config={"dtype": "float16",
                                              "enable_cuda_graph": True})
    toks = torch.randint(0, 512, (4, 6, 1), generator=gen, device="cuda")
    starts = torch.tensor([3, 40, 70, 130], device="cuda")
    runs = []
    for eng in (eager, graph):
        pool = PagedKVPool(eng.kv_cache_spec(), 4, num_pages=32,
                           page_size=16, device="cuda")
        for s in range(4):
            pool.ensure_writable(s, 0, int(starts[s]))
        before = paged_decode_attention.launches
        out = _decode_steps(eng, "paged", pool.cache, pool,
                            toks.unbind(1), starts)
        runs.append((out, paged_decode_attention.launches - before,
                     pool.cache))
    (want, n_eager, eager_cache), (got, n_graph, graph_cache) = runs
    assert n_eager == n_graph == 2 * 6
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for key in eager_cache:
        assert torch.equal(eager_cache[key][:, :-1],
                           graph_cache[key][:, :-1]), key


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_zero_inference_streams_as_the_resident_model_computes(gen, int8):
    """Layers streamed from pinned memory through 2-4 rotating buffers,
    packed or a copy a leaf, give the resident model's logits and greedy
    tokens bit for bit (int8: the resident model's int8 compute tier),
    with the flash, decode and int8_matmul launches a pass exact."""
    import copy

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import ZeroInferenceEngine
    from deepspeed_tpu_torch.models.transformer_lm import (TransformerLM,
                                                           transformer_config)
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        flash_attention
    from deepspeed_tpu_torch.ops.quantization import (DENSE_KEYS,
                                                      int8_matmul,
                                                      quantize_lm_params)

    cfg = transformer_config("llama", vocab_size=512, n_embd=512, n_layer=3,
                             n_head=8, n_kv_head=2, max_seq_len=256,
                             dtype=torch.bfloat16)
    model = TransformerLM(cfg, device="cuda")
    model.init_weights(gen)
    host = {k: v.cpu() for k, v in model.state_dict().items()}
    resident = model
    if int8:
        resident = copy.deepcopy(model)
        quantize_lm_params(resident, DENSE_KEYS - {"lm_head"})
        resident.replace_config(int8_weights=True)
    ids = torch.randint(0, 512, (4, 96), generator=gen, device="cuda")
    with torch.no_grad():
        want = resident.logits(ids)
    expect = dst.init_inference(resident, config={"dtype": "bfloat16"}) \
        .generate(ids[:, :16], max_new_tokens=5)
    for prefetch, pack in ((0, True), (1, True), (2, True), (1, False)):
        zi = ZeroInferenceEngine(cfg, host, prefetch=prefetch, pack=pack,
                                 int8=int8)
        before = (flash_attention.launches, int8_matmul.launches)
        got = zi(ids)
        torch.cuda.synchronize()
        assert flash_attention.launches - before[0] == 3
        assert int8_matmul.launches - before[1] == (21 if int8 else 0)
        assert torch.equal(got, want), (prefetch, pack)
        before = decode_attention.launches
        toks = zi.generate(ids[:, :16], max_new_tokens=5)
        assert decode_attention.launches - before == 3 * 4
        np.testing.assert_array_equal(toks, expect)


# A rank's share of TinyLlama (32 query heads over 4 KV heads, D 64) served
# by a model group of two: 16 query heads over 2 KV heads, the shapes the
# tensor-parallel serving path hands the three attention kernels.
TP_RANK_H, TP_RANK_KV = 16, 2


@pytest.mark.parametrize("T,S", [(16, 16), (64, 64), (600, 600)])
def test_flash_kernel_at_the_tp_rank_shapes(gen, T, S):
    H, KV, D = TP_RANK_H, TP_RANK_KV, 64
    q = torch.randn(1, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn(1, S, KV, D, generator=gen, device="cuda").to(q.dtype)
    v = torch.randn(1, S, KV, D, generator=gen, device="cuda").to(q.dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=True)
    want, want_lse = mha_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_at_the_tp_rank_shapes(gen, int8):
    B, S, D = 8, 2048, 64
    H, KV = TP_RANK_H, TP_RANK_KV
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    if int8:
        (k, ks), (v, vs) = (_int8_rows(gen, B, KV, S, D) for _ in range(2))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.randn(B, KV, S, D, generator=gen, device="cuda").to(
            q.dtype) for _ in range(2))
        ks = vs = None
        scales = {}
    lengths = _decode_lengths(B, H, KV, S, D)
    counter = "int8_launches" if int8 else "launches"
    before = getattr(decode_attention, counter)
    got = decode_attention(q, k, v, lengths, **scales)
    want = decode_attention_reference(q, k, v, lengths, 1 / math.sqrt(D),
                                      None, ks, vs)
    torch.cuda.synchronize()
    assert getattr(decode_attention, counter) == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
@pytest.mark.parametrize("ps,splits", [(64, None), (16, None), (24, 2)])
def test_paged_kernel_at_the_tp_rank_shapes(gen, monkeypatch, int8, T, ps,
                                            splits):
    D, H, KV = 64, TP_RANK_H, TP_RANK_KV
    table, starts, P = _paged_case(gen, T, ps, splits, monkeypatch)
    B = starts.shape[0]
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    if int8:
        (k, ks), (v, vs) = (_int8_rows(gen, P, KV, ps, D) for _ in range(2))
        scales = dict(k_scale_pages=ks, v_scale_pages=vs)
    else:
        k, v = (torch.randn(P, KV, ps, D, generator=gen, device="cuda").to(
            q.dtype) for _ in range(2))
        ks = vs = None
        scales = {}
    counter = "int8_launches" if int8 else "launches"
    before = getattr(paged_decode_attention, counter)
    got = paged_decode_attention(q, k, v, table, starts, **scales)
    want = paged_decode_attention_reference(q, k, v, table, starts,
                                            1 / math.sqrt(D), None, ks, vs)
    torch.cuda.synchronize()
    assert getattr(paged_decode_attention, counter) == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
