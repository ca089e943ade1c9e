"""The port's int8 KV cache against the JAX package's, on the CPU.

``quantize_kv_rows`` and the plain int8 decode and paged attention (the CUDA
kernels' twins) take the same numpy inputs as their JAX counterparts; the
JAX side runs its Pallas kernels in interpret mode, which the JAX package's
own tests hold against attention over the dequantized cache. The paged pool
must carry the scale pages wherever the rows go.

Tolerances: quantized rows are identical except at exact .5 ties (the JAX
side may round ``x / scale`` a hair differently; the test counts them).
Attention is fp32 on both sides, with the scales folded into scores and
probabilities; only summation order differs: atol 1e-4 (the JAX package's
own tolerance for its int8 kernel against the dequantized oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer_lm import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.attention import decode_attention as jda
from deepspeed_tpu.ops.attention.paged_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu_torch.models.transformer_lm import (KVCacheSpec,
                                                       transformer_config)
from deepspeed_tpu_torch.ops.attention.decode_attention import (
    decode_attention, quantize_kv_rows)
from deepspeed_tpu_torch.ops.attention.paged_attention import \
    paged_decode_attention
from deepspeed_tpu_torch.serving import PagedKVPool

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-4


def test_quantize_kv_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 40, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # a zero row: scale 1e-8
    x[1, 1, 3, :4] = [1.27, 0.005, -0.015, 0.025]     # .5 ties at scale 0.01
    want_q, want_s = (np.asarray(a) for a in jda.quantize_kv_rows(
        jnp.asarray(x)))
    got_q, got_s = quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.shape == x.shape[:-1]
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-7, atol=0)
    assert got_s[0, 0, 0] == np.float32(1e-8) and (got_q[0, 0, 0] == 0).all()
    diff = got_q.numpy().astype(np.int32) - want_q.astype(np.int32)
    ratio = x / want_s[..., None]
    ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-4
    # only exact-half ties may round apart, and then by one step
    assert np.all(np.abs(diff) <= 1) and np.all(ties[diff != 0])
    assert np.count_nonzero(diff) <= np.count_nonzero(ties)


def _int8_cache(rng, *shape):
    q8 = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)
    return q8, sc


@pytest.mark.parametrize("H,KV,alibi", [(4, 4, False), (4, 2, False),
                                        (4, 2, True)],
                         ids=["mha", "gqa", "gqa_alibi"])
def test_int8_decode_matches_jax_kernel(H, KV, alibi):
    B, S, D = 3, 64, 32
    rng = np.random.default_rng(H + KV + alibi)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k8, ks = _int8_cache(rng, B, KV, S, D)
    v8, vs = _int8_cache(rng, B, KV, S, D)
    lengths = np.array([1, 37, S], np.int32)
    slopes = np.array(jax_slopes(H)) if alibi else None
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k8.transpose(0, 1, 3, 2)),
        jnp.asarray(v8.transpose(0, 1, 3, 2)), jnp.asarray(lengths),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_s=32))
    got = decode_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(lengths),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert decode_attention.int8_launches == 0


@pytest.mark.parametrize("T,H,KV", [(1, 4, 2), (3, 4, 4)])
def test_int8_paged_matches_jax_kernel(T, H, KV):
    """Shuffled pages, a sentinel past each slot's live pages, T query
    rows; JAX pages are (P, KV, D, page_size), the port's (P, KV,
    page_size, D)."""
    B, D, ps, per_slot = 2, 32, 16, 4
    P = B * per_slot + 1
    rng = np.random.default_rng(10 * T + KV)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k8, ks = _int8_cache(rng, P, KV, ps, D)
    v8, vs = _int8_cache(rng, P, KV, ps, D)
    table = rng.permutation(P)[:B * per_slot].reshape(B, per_slot)
    starts = np.array([ps * per_slot - T - 1, 5], np.int32)
    table[1, 1:] = P                                   # unmapped
    table = table.astype(np.int32)
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(k8.transpose(0, 1, 3, 2)),
        jnp.asarray(v8.transpose(0, 1, 3, 2)), jnp.asarray(table),
        jnp.asarray(starts), k_scale_pages=jnp.asarray(ks),
        v_scale_pages=jnp.asarray(vs)))
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(table), torch.from_numpy(starts),
        k_scale_pages=torch.from_numpy(ks), v_scale_pages=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert paged_decode_attention.int8_launches == 0


def test_cow_and_prefix_seating_copy_the_scale_pages():
    """A prefix page shared by two slots forks on the first write: the fork
    reads back the same dequantized rows, the original keeps its own, and
    page bytes count the scales."""
    cfg = transformer_config("llama", vocab_size=32, max_seq_len=64,
                             n_embd=32, n_layer=2, n_head=4, n_kv_head=2,
                             kv_cache_quant=True, dtype=torch.float32)
    spec = KVCacheSpec(cfg.n_layer, cfg.kv_heads, cfg.head_dim, cfg.dtype,
                       cfg.max_seq_len, quant=True)
    pool = PagedKVPool(spec, num_slots=2, num_pages=8, page_size=16,
                       device="cpu")
    assert set(pool.cache) == {"k", "v", "k_scale", "v_scale"}
    assert pool.cache["k"].dtype == torch.int8
    per_row = 2 * cfg.kv_heads * (cfg.head_dim + 4)     # int8 row + fp32
    assert pool.page_stats()["page_bytes"] == cfg.n_layer * 16 * per_row
    gen = torch.Generator().manual_seed(0)
    a = pool.alloc()
    pool.ensure_writable(a, 0, 32)
    for name, leaf in pool.cache.items():
        src = torch.randint(-127, 128, leaf.shape, generator=gen) \
            if leaf.dtype == torch.int8 else \
            torch.rand(leaf.shape, generator=gen) + 0.1
        leaf.copy_(src.to(leaf.dtype))
    pool.starts[a] = 32
    pages = [int(p) for p in pool.table[a, :2]]

    def rows(slot):
        view = spec.dense_from_pages(pool.cache, pool.table_dev[slot:slot + 1])
        return {side: view[side].float() * view[f"{side}_scale"][..., None]
                for side in ("k", "v")}

    before = rows(a)
    b = pool.alloc()
    pool.reset_row(b)
    pool.seat_prefix(b, pages, prefill_pos=20)     # forks page 1 up front
    assert pool.cow_copies == 1 and pool.table[b, 1] not in pages
    assert pool.table[b, 0] == pages[0]
    after_a, seated = rows(a), rows(b)
    for side in ("k", "v"):
        torch.testing.assert_close(after_a[side][:, :, :, :32],
                                   before[side][:, :, :, :32], rtol=0, atol=0)
        torch.testing.assert_close(seated[side][:, :, :, :32],
                                   before[side][:, :, :, :32], rtol=0, atol=0)
    assert not pool.consistency_errors()
