"""The port's flash-attention backward against the JAX package's.

The JAX side is ``jax.vjp`` of its ``flash_attention`` with 64-row blocks,
so its Pallas dq and dkv kernels run in interpret mode on the CPU; the
port's ``flash_attention`` is differentiated through its custom operator,
whose backward takes the plain dq and dkv versions for CPU tensors. Inputs
and the output cotangent come from numpy with a seed. Everything is fp32:
the tolerance (2e-5 absolute on unit-scale gradients) covers summation
order only.

Grouped-query heads (the JAX function has none) are held against the port's
own result on K/V repeated to every query head, whose gradients summed
over each group are the grouped gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention.flash_attention import \
    flash_attention as jax_flash
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    attention_delta, flash_attention, flash_attention_backward,
    flash_attention_dkv, flash_attention_dq, mha_backward_reference)

from _torch_threads import one_thread  # noqa: F401


ATOL = 2e-5


def _inputs(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, T, H, D))]


def _port_grads(q, k, v, do, causal):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = flash_attention(q, k, v, causal=causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("causal,T,S", [(True, 128, 128), (False, 128, 192)])
def test_grads_match_jax_vjp(causal, T, S):
    q, k, v, do = _inputs(0, 1, T, S, 2, 2, 32)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                 block_q=64, block_k=64),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got_out, got = _port_grads(q, k, v, do, causal)
    np.testing.assert_allclose(got_out, np.asarray(out), atol=ATOL, rtol=0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_grouped_heads_sum_their_group():
    q, k, v, do = _inputs(1, 2, 70, 70, 4, 2, 32)
    _, got = _port_grads(q, k, v, do, True)
    rep = [np.repeat(x, 2, axis=2) for x in (k, v)]
    _, full = _port_grads(q, *rep, do, True)
    np.testing.assert_allclose(got[0], full[0], atol=ATOL, rtol=0)
    for g, f in zip(got[1:], full[1:]):
        np.testing.assert_allclose(g, f.reshape(2, 70, 2, 2, 32).sum(3),
                                   atol=ATOL, rtol=0)


def test_kernel_wrappers_take_their_plain_versions_on_the_cpu():
    """The dq and dkv wrappers and the whole backward agree with the plain
    reference from the forward's saved tensors; lse takes no gradient."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 1, 96, 96, 2, 1,
                                                        32))
    out, lse = flash_attention(q, k, v)
    scale = 32 ** -0.5
    delta = attention_delta(out, do)
    assert delta.shape == lse.shape == (1, 2, 96)
    dq = flash_attention_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, True, scale)
    for got, want in zip((dq, dk, dv), mha_backward_reference(
            q, k, v, out, lse, do, True, scale)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    for got, want in zip(flash_attention_backward(
            q, k, v, out, lse, do.transpose(1, 2).contiguous().transpose(
                1, 2), True, scale), (dq, dk, dv)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_attention_dq.launches == flash_attention_dkv.launches == 0
    qg = q.clone().requires_grad_()
    _, lse_g = flash_attention(qg, k, v)
    assert not lse_g.requires_grad


def test_bf16_rounds_as_the_tpu_kernels():
    """With bf16 inputs the plain dq rounds ds to k's dtype and the plain dv
    rounds p to dO's dtype, as the TPU kernels do: the result sits within
    bf16 rounding of the fp32 gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 1, 64, 64, 2, 2,
                                                        32))
    out, lse = flash_attention(q, k, v)
    want = mha_backward_reference(q, k, v, out, lse, do)
    lo = [x.bfloat16() for x in (q, k, v)]
    out_lo, lse_lo = flash_attention(*lo)
    got = mha_backward_reference(*lo, out_lo, lse_lo, do.bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w).abs().max() <= 0.05 * w.abs().max()
