"""The port's decode attention against the JAX package's Pallas kernel.

The JAX kernel reads its positions-minor cache (B, KV, D, S), so the test
hands it the transpose of the port's (B, KV, S, D) cache, with a small
``block_s`` so that several blocks run, and lengths 1, mid and S. Both sides
compute in fp32: the tolerance (2e-5 absolute on unit-scale outputs) covers
the kernel's blockwise online softmax against one full softmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer_lm import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.attention.decode_attention import \
    decode_attention as jax_decode
from deepspeed_tpu_torch.ops.attention.decode_attention import (
    alibi_slopes, decode_attention)

ATOL = 2e-5
B, S, D = 3, 64, 32


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
def test_matches_jax_kernel(H, KV, alibi):
    rng = np.random.default_rng(H * 10 + KV + alibi)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    lengths = np.array([1, 37, S], np.int32)
    slopes = np.array(jax_slopes(H)) if alibi else None
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), jnp.asarray(lengths),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        block_s=16))
    got = decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert decode_attention.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("n_head", [4, 8, 12])
def test_alibi_slopes_match_jax(n_head):
    np.testing.assert_allclose(alibi_slopes(n_head).numpy(),
                               np.asarray(jax_slopes(n_head)), rtol=1e-7)


def test_free_slot_row_is_finite_and_int8_is_a_later_slice():
    q = torch.randn(2, 2, D)
    cache = torch.randn(2, 2, S, D)
    out = decode_attention(q, cache, cache, torch.tensor([0, 1],
                                                         dtype=torch.int32))
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    # the int8 cache is ported: unit scales over int8 rows equal the plain
    # attention over the same values, a free row stays 0, and one scale
    # tensor without the other is refused
    c8 = (cache * 20).round().clamp(-127, 127).to(torch.int8)
    ones = torch.ones(2, 2, S)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    got = decode_attention(q, c8, c8, lengths, k_scale=ones, v_scale=ones)
    want = decode_attention(q, c8.float(), c8.float(), lengths)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got[0] == 0).all()
    with pytest.raises(ValueError, match="both"):
        decode_attention(q, c8, c8, 1, k_scale=ones)
