"""The port's paged attention and paged model step against the JAX package.

``paged_decode_attention``: the JAX Pallas kernel (interpret mode on the
CPU, as ``tests/unit/ops/test_paged_attention.py`` runs it) against the
port's plain version, on the same fp32 pages. The JAX pool stores pages
positions-minor (P, KV, D, page_size); the test hands it the transpose of
the port's (P, KV, page_size, D). Page ids are shuffled, entries past each
slot's live pages hold the sentinel ``P``, and starts sit on and beside
page boundaries. Tolerance 1e-5 absolute (fp32, unit-scale outputs): the
kernel's per-page online softmax against one full softmax.

The CUDA kernel splits a slot's positions into ``paged_plan``'s chunks
(from the shapes only) and merges them in chunk order, each query row
masked at its own limit ``starts[b] + t``; that split and merge are
emulated in plain torch, step for step as in
``test_torch_decode_attention.py``, and held against the JAX kernel with
that file's tolerances: 2e-5 on fp32 pages, where nothing is rounded and
the merge's algebra is pinned (a position dropped or counted twice moves an
output by about 1/64), and 3e-2 on bf16 and int8 pages (bf16 queries),
where both sides round p (times the V scale) to bf16 relative to the
running maxima of different blocks and round outputs below 4 to bf16.

``dense_from_pages`` and ``decode_paged`` against their JAX counterparts
on the same weights (through ``checkpoint.flax_import``): the gathered
cache exactly, the step's logits and the written pages within 1e-4
(summation order over two layers, as ``test_torch_transformer_lm.py``).
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.models.transformer_lm import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.attention.paged_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.ops.attention.decode_attention import (
    MAX_SPLITS, PLAN_ROUND, alibi_slopes, quantize_kv_rows)
from deepspeed_tpu_torch.ops.attention.paged_attention import (
    MAX_QUERY_ROWS, paged_decode_attention, paged_plan)

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-5
MODEL_ATOL = 1e-4


def _pages(rng, B, KV, D, ps, max_pages, starts, T):
    """Random fp32 pages (P, KV, ps, D) with two spare pages, and a table of
    shuffled ids holding the sentinel P past each slot's live pages."""
    P_ = B * max_pages + 2
    k = rng.standard_normal((P_, KV, ps, D)).astype(np.float32)
    v = rng.standard_normal((P_, KV, ps, D)).astype(np.float32)
    table = rng.permutation(P_)[:B * max_pages].reshape(B, max_pages)
    live = (starts + T + ps - 1) // ps
    table = np.where(np.arange(max_pages)[None] < live[:, None], table, P_)
    return k, v, table.astype(np.int32)


@pytest.mark.parametrize("T", [1, 3, MAX_QUERY_ROWS])
@pytest.mark.parametrize("H,KV,alibi", [(4, 4, False), (4, 2, False),
                                        (4, 4, True)],
                         ids=["mha", "gqa", "alibi"])
def test_plain_version_matches_jax_kernel(T, H, KV, alibi):
    B, D, ps, max_pages = 3, 16, 8, 4
    rng = np.random.default_rng(T * 10 + KV + alibi)
    starts = np.array([0, ps, 2 * ps + 3], np.int32)
    k, v, table = _pages(rng, B, KV, D, ps, max_pages, starts, T)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    slopes = np.array(jax_slopes(H)) if alibi else None
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), jnp.asarray(table),
        jnp.asarray(starts),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes)))
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(starts),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert paged_decode_attention.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("B,T,H,KV,S,D,sms,want", [
    # serve_paged: GPT-2's 12 heads, 8 slots of 16 x 64 positions (96 tiles)
    (8, 1, 12, 12, 1024, 64, 132, (1, 1024)),
    # its verify width: 8 rows x 1 head still fit one tile a KV head
    (8, 8, 12, 12, 1024, 64, 132, (1, 1024)),
    # serve_int8: TinyLlama's 32 heads over 4 (32 tiles: 4 chunks)
    (8, 1, 32, 4, 1024, 64, 132, (4, 256)),
    # its verify width: 8 rows x 8 heads are 4 row tiles a KV head
    (8, 8, 32, 4, 1024, 64, 132, (1, 1024)),
    # one slot over one KV head: 16 chunks
    (1, 1, 8, 1, 4096, 64, 132, (16, 256)),
    # a slot's capacity below one round: one chunk of one round
    (2, 4, 8, 8, 40, 64, 132, (1, 64)),
])
def test_paged_plan(B, T, H, KV, S, D, sms, want):
    """The paged kernel's split of a slot's capacity: the decode kernel's
    rule over ``B * KV * ceil(T * (H / KV) / 16)`` tiles, from the shapes
    alone (no starts or table argument), 1 to 16 chunks of whole 64-position
    rounds covering S with none past it."""
    params = inspect.signature(paged_plan).parameters
    assert "starts" not in params and "table" not in params
    splits, chunk = paged_plan(B, T, H, KV, S, D, sms)
    assert (splits, chunk) == want
    assert 1 <= splits <= MAX_SPLITS and chunk % PLAN_ROUND == 0
    assert (splits - 1) * chunk < S <= splits * chunk
    assert paged_plan(B, T, H, KV, S, D, sms) == (splits, chunk)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def paged_split_merge_emulation(q, k_pages, v_pages, table, starts, scale,
                                slopes, ks_pages, vs_pages, plan, rounded):
    """The CUDA kernel's arithmetic in plain fp32 torch: q (B, T, H, D),
    pages (P, KV, ps, D) (int8 values with fp32 scale pages, or scale pages
    None) read through ``table`` with ids clipped to [0, P - 1]. Row t of
    slot b sees positions ``<= starts[b] + t`` (at most the table's last).
    Each of ``plan``'s chunks is walked as 16-position groups dealt to 4
    warps in turn; each warp keeps (m, l, acc) per row by online softmax
    over its groups, p (times the V scale) passed through ``rounded`` before
    the PV product; the warps merge, then the chunks, in order. Returns
    (B, T, H, D) passed through ``rounded``."""
    splits, chunk = plan
    B, T, H, D = q.shape
    P, KV, ps = k_pages.shape[:3]
    n = table.shape[1]
    S, rep = n * ps, H // KV
    ids = table.long().clamp(0, P - 1).reshape(-1)

    def dense(pages):                       # (B, H, S[, D]) in fp32
        g = pages[ids].reshape(B, n, KV, ps, *pages.shape[3:])
        g = g.transpose(1, 2).reshape(B, KV, S, *pages.shape[3:])
        return g.float().repeat_interleave(rep, 1)

    kf, vf = dense(k_pages), dense(v_pages)
    s_all = torch.einsum("bthd,bhsd->bths", q.float(), kf) * scale
    if ks_pages is not None:
        s_all = s_all * dense(ks_pages)[:, None]
    pos = torch.arange(S)
    lim = (starts.long().clamp_min(0)[:, None] + torch.arange(T)
           ).clamp_max(S - 1)[:, :, None, None]                # (B, T, 1, 1)
    if slopes is not None:
        s_all = s_all + slopes[None, None, :, None] * (pos - lim)
    live = pos <= lim                                          # (B, T, 1, S)
    vsc = (dense(vs_pages)[:, None] if vs_pages is not None
           else torch.ones(1, 1, 1, S))

    def merge(states):
        m = torch.stack([st[0] for st in states]).amax(0)
        l = sum(st[1] * torch.exp(st[0] - m) for st in states)
        acc = sum(st[2] * torch.exp(st[0] - m)[..., None] for st in states)
        return m, l, acc

    empty = (torch.full((B, T, H), -1e30), torch.zeros(B, T, H),
             torch.zeros(B, T, H, D))
    chunks = []
    for c in range(splits):
        warps = []
        for w in range(4):
            m, l, acc = empty
            for g0 in range(c * chunk + 16 * w, min((c + 1) * chunk, S), 64):
                sl = slice(g0, g0 + 16)
                x = s_all[..., sl].masked_fill(~live[..., sl], -1e30)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[..., None]) * live[..., sl]
                l = l * alpha + p.sum(-1)
                pv = rounded(p * vsc[..., sl])
                acc = acc * alpha[..., None] + torch.einsum(
                    "bths,bhsd->bthd", pv, vf[:, :, sl])
                m = m_new
            warps.append((m, l, acc))
        chunks.append(merge(warps))
    m, l, acc = merge(chunks)
    return rounded(acc / l.clamp_min(1e-30)[..., None])


@pytest.mark.parametrize("pages,alibi,T,ps", [
    ("fp32", False, 1, 16), ("bf16", False, 4, 8), ("bf16", True, 1, 16),
    ("int8", True, 4, 8), ("int8", False, 1, 16)])
def test_paged_split_merge_matches_jax_kernel(pages, alibi, T, ps):
    """The kernel's chunked split (4 chunks of 64 here), per-row limits and
    chunk-order merge against the JAX Pallas kernel in interpret mode, at GQA
    4/2 over shuffled pages with sentinels, starts 0, one before a chunk
    edge, on it, one past it and at the table's end."""
    B, H, KV, D, S = 5, 4, 2, 32, 256
    max_pages = S // ps
    plan = paged_plan(B, T, H, KV, S, D, 132)
    assert plan == (4, 64)
    chunk = plan[1]
    starts = np.array([0, chunk - 1, chunk, chunk + 1, S - T], np.int32)
    rng = np.random.default_rng(11 + T + ps + alibi)
    k, v, table = _pages(rng, B, KV, D, ps, max_pages, starts, T)
    q = torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32))
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    slopes = alibi_slopes(H) if alibi else None
    scale = 1.0 / np.sqrt(D)
    ks = vs = None
    rounded, atol, jdt, tdt = _bf16, 3e-2, jnp.bfloat16, torch.bfloat16
    if pages == "fp32":
        rounded, atol, jdt, tdt = (lambda x: x), 2e-5, jnp.float32, \
            torch.float32
    elif pages == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    else:
        k, v = _bf16(k), _bf16(v)
    q = rounded(q)
    kj, vj = (jnp.asarray(x.numpy().transpose(0, 1, 3, 2)) for x in (k, v))
    if pages != "int8":
        kj, vj = kj.astype(jdt), vj.astype(jdt)
    scales = {} if ks is None else dict(
        k_scale_pages=jnp.asarray(ks.numpy()),
        v_scale_pages=jnp.asarray(vs.numpy()))
    want = np.asarray(jax.jit(lambda *a: jax_paged(
        *a, alibi_slopes=None if slopes is None else jnp.asarray(
            slopes.numpy()), **scales))(
        jnp.asarray(q.numpy()).astype(jdt), kj, vj, jnp.asarray(table),
        jnp.asarray(starts)).astype(jnp.float32))
    tstarts, ttable = torch.from_numpy(starts), torch.from_numpy(table)
    got = paged_split_merge_emulation(q, k, v, ttable, tstarts, scale,
                                      slopes, ks, vs, plan, rounded)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    # the port's plain version (it rounds nothing but its output) as well
    cast = (lambda x: x) if pages == "int8" else (lambda x: x.to(tdt))
    plain = paged_decode_attention(
        q.to(tdt), cast(k), cast(v), ttable, tstarts, alibi_slopes=slopes,
        k_scale_pages=ks, v_scale_pages=vs)
    np.testing.assert_allclose(plain.float().numpy(), got.numpy(),
                               atol=atol, rtol=0)


# Both int8-page paths hold a float64 evaluation to this fraction of its
# largest output. The scores reach several hundred (int8 values times scales
# up to 1.5 times unit queries), so fp32 rounds the exponent's argument by
# ~3e-5 and both paths land up to 6.6e-6 of max|out| from the exact value
# (seeds 0-299, _int8_pages_failure_rates); a wrong scale moves the output
# by O(1) of max|out|.
INT8_PAGES_RTOL = 5e-5


def _int8_pages_case(seed):
    """int8 pages (2 pages of 4 rows, 2 heads, D=8) with per-row scales in
    [0.5, 1.5), a unit-normal query at position 5 over pages [1, 0]."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, 1, 2, 8, generator=g)
    p8 = torch.randint(-127, 128, (2, 2, 4, 8), dtype=torch.int8, generator=g)
    sc = torch.rand(2, 2, 4, generator=g) + 0.5
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    return q, p8, sc, table


def _int8_pages_float64(q, p8, sc, table, start):
    """Attention of the query at position ``start`` over the dequantized
    rows of its pages, in plain float64 einsum and softmax."""
    deq = p8.double() * sc.double()[..., None]
    ps = p8.shape[2]
    pos = torch.arange(start + 1)
    rows = deq[table[0].long()[pos // ps], :, pos % ps]    # (S, KV, D)
    s = torch.einsum("hd,shd->hs", q[0, 0].double(), rows) / math.sqrt(8)
    return torch.einsum("hs,shd->hd", torch.softmax(s, -1), rows)[None, None]


def _int8_pages_errors(seed):
    """Each path's max |error| against float64, over max|ref|: int8 pages
    with scale pages, and fp32 pages holding the dequantized rows."""
    q, p8, sc, table = _int8_pages_case(seed)
    ref = _int8_pages_float64(q, p8, sc, table, 5)
    deq = p8.float() * sc[..., None]
    paths = (paged_decode_attention(q, p8, p8, table, 5, k_scale_pages=sc,
                                    v_scale_pages=sc),
             paged_decode_attention(q, deq, deq, table, 5))
    top = ref.abs().max().item()
    return [(p.double() - ref).abs().max().item() / top for p in paths]


@pytest.mark.parametrize("seed", range(8))
def test_int8_pages_are_a_later_slice(seed):
    """Ported since: int8 pages with scale pages, and plain pages holding
    the dequantized rows, each match a float64 evaluation of the same
    attention within fp32 rounding; scale pages of the wrong shape are
    refused."""
    int8_err, deq_err = _int8_pages_errors(seed)
    assert int8_err <= INT8_PAGES_RTOL, int8_err
    assert deq_err <= INT8_PAGES_RTOL, deq_err
    q, p8, sc, table = _int8_pages_case(seed)
    with pytest.raises(ValueError, match="scale pages"):
        paged_decode_attention(q, p8, p8, table, 0, k_scale_pages=sc[:1],
                               v_scale_pages=sc[:1])


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            n_kv_head=2, dtype=jnp.float32)


@pytest.fixture(scope="module")
def model_pair():
    jcfg = J.transformer_config("llama", **TINY)
    jm = J.TransformerLM(jcfg)
    params = jm.init({"params": jax.random.PRNGKey(2)},
                     jnp.zeros((1, 8), jnp.int32), method=jm.logits)["params"]
    pcfg = P.transformer_config("llama", **{**TINY, "dtype": torch.float32})
    pm = P.TransformerLM(pcfg)
    pm.load_state_dict(state_dict_from_flax(
        pcfg, jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm


def _model_pages(pm, rng, B, ps, starts, T):
    spec = pm.kv_cache_spec()
    L, KV, D = spec.n_layer, spec.kv_heads, spec.head_dim
    max_pages = spec.max_seq_len // ps
    Pn = B * max_pages + 2
    k = rng.standard_normal((L, Pn, KV, ps, D)).astype(np.float32)
    v = rng.standard_normal((L, Pn, KV, ps, D)).astype(np.float32)
    table = rng.permutation(Pn)[:B * max_pages].reshape(B, max_pages)
    live = (starts + T + ps - 1) // ps
    table = np.where(np.arange(max_pages)[None] < live[:, None], table, Pn)
    return k, v, table.astype(np.int32)


def test_dense_from_pages_matches_jax(model_pair):
    jm, _, pm = model_pair
    rng = np.random.default_rng(3)
    starts = np.array([5, 40], np.int32)
    k, v, table = _model_pages(pm, rng, 2, 16, starts, 1)
    jspec = J.make_kv_cache_spec(jm.config)
    want = jspec.dense_from_pages(
        {"k": jnp.asarray(k.transpose(0, 1, 2, 4, 3)),
         "v": jnp.asarray(v.transpose(0, 1, 2, 4, 3))}, jnp.asarray(table))
    got = pm.kv_cache_spec().dense_from_pages(
        {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
        torch.from_numpy(table))
    for side in ("k", "v"):
        np.testing.assert_array_equal(
            got[side].numpy(), np.asarray(want[side]).transpose(0, 1, 2, 4, 3))


@pytest.mark.parametrize("T", [1, 3])
def test_decode_paged_matches_jax(model_pair, T):
    """One paged step (GQA, rotary) from the same pages: the logits and
    every page afterwards, so the rows written through the table land in
    the same places and sentinel writes touch nothing."""
    jm, params, pm = model_pair
    rng = np.random.default_rng(4 + T)
    ps = 16
    # slot 2's rows run past its live pages into sentinel entries
    starts = np.array([0, 17, 31], np.int32)
    k, v, table = _model_pages(pm, rng, 3, ps, starts, T)
    table[2, 2:] = k.shape[1]
    toks = rng.integers(0, 64, (3, T)).astype(np.int32)
    cache = {"cache_store": {
        "k": jnp.asarray(k.transpose(0, 1, 2, 4, 3)),
        "v": jnp.asarray(v.transpose(0, 1, 2, 4, 3)),
        "index": jnp.asarray(starts)}}
    jl, jvars = jm.apply({"params": params, "cache": cache},
                         jnp.asarray(toks), jnp.asarray(starts),
                         jnp.asarray(table), method=jm.decode_paged,
                         mutable=["cache"])
    pages = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got = pm.decode_paged(torch.from_numpy(toks).long(),
                          torch.from_numpy(starts), pages,
                          torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=MODEL_ATOL,
                               rtol=0)
    for side, orig in (("k", k), ("v", v)):
        want = np.asarray(jvars["cache"]["cache_store"][side])
        np.testing.assert_allclose(pages[side].numpy(),
                                   want.transpose(0, 1, 2, 4, 3),
                                   atol=MODEL_ATOL, rtol=0)
        assert not np.array_equal(pages[side].numpy(), orig)


def _int8_pages_failure_rates(seeds=range(300)):
    """Failures over ``seeds`` of the check this test made before (the two
    fp32 paths against each other, atol = rtol = 1e-5) and of the check it
    makes now; and the largest error against float64 that either path gave.
    ``PYTHONPATH=. python tests/test_torch_paged_attention.py`` prints
    them."""
    before = after = 0
    worst = 0.0
    for seed in seeds:
        q, p8, sc, table = _int8_pages_case(seed)
        got = paged_decode_attention(q, p8, p8, table, 5, k_scale_pages=sc,
                                     v_scale_pages=sc)
        deq = p8.float() * sc[..., None]
        want = paged_decode_attention(q, deq, deq, table, 5)
        before += not torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        errs = _int8_pages_errors(seed)
        after += max(errs) > INT8_PAGES_RTOL
        worst = max(worst, *errs)
    return before, after, worst


if __name__ == "__main__":
    n_before, n_after, worst_err = _int8_pages_failure_rates()
    print(f"over 300 seeds: {n_before} failed the earlier check, {n_after} "
          f"fail this one; worst error {worst_err:.3g} of max|ref|")
