"""The port's paged attention and paged model step against the JAX package.

``paged_decode_attention``: the JAX Pallas kernel (interpret mode on the
CPU, as ``tests/unit/ops/test_paged_attention.py`` runs it) against the
port's plain version, on the same fp32 pages. The JAX pool stores pages
positions-minor (P, KV, D, page_size); the test hands it the transpose of
the port's (P, KV, page_size, D). Page ids are shuffled, entries past each
slot's live pages hold the sentinel ``P``, and starts sit on and beside
page boundaries. Tolerance 1e-5 absolute (fp32, unit-scale outputs): the
kernel's per-page online softmax against one full softmax.

``dense_from_pages`` and ``decode_paged`` against their JAX counterparts
on the same weights (through ``checkpoint.flax_import``): the gathered
cache exactly, the step's logits and the written pages within 1e-4
(summation order over two layers, as ``test_torch_transformer_lm.py``).
"""

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
from deepspeed_tpu_torch.ops.attention.paged_attention import (
    MAX_QUERY_ROWS, paged_decode_attention)

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
