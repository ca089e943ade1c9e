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


def test_int8_pages_are_a_later_slice():
    """Ported since: int8 pages with scale pages equal plain pages holding
    the dequantized rows; scale pages of the wrong shape are refused."""
    q = torch.randn(1, 1, 2, 8)
    p8 = torch.randint(-127, 128, (2, 2, 4, 8), dtype=torch.int8)
    sc = torch.rand(2, 2, 4) + 0.5
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    got = paged_decode_attention(q, p8, p8, table, 5, k_scale_pages=sc,
                                 v_scale_pages=sc)
    deq = p8.float() * sc[..., None]
    want = paged_decode_attention(q, deq, deq, table, 5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
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
