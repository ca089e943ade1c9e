"""The port's fused LayerNorm→Linear against the JAX package's.

The JAX side is ``jax.vjp`` of its ``ln_linear`` at the smallest shape its
gate takes (m = c = n = 128), so its Pallas forward and backward-dx kernels
run in interpret mode on the CPU; a ragged shape (c = 100) takes its plain
fallback. The port takes its kernels' plain versions on the CPU at the
first shape, and its own fallback at the ragged one. The JAX function takes
W as (C, N) and the port as (N, C) (``nn.Linear``'s layout). Inputs come
from numpy with a seed; everything is fp32, so y and the gradients of x,
gamma, beta, W and b agree within 2e-5 of their largest element (summation
order only). One shape the JAX gate takes and the port's old fp32 gate (C
≤ 1536) refused, (128, 2048, 128), goes through the port's custom operator
and through ``ln_linear`` in fp32 (the kernels' plain versions on the CPU)
against the JAX Pallas kernels, whose result both tests share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.ln_linear import ln_linear as jax_ln
from deepspeed_tpu.ops.transformer.ln_linear import \
    supports_fused as jax_supports
from deepspeed_tpu_torch.ops.transformer import ln_linear as port_ln
from deepspeed_tpu_torch.ops.transformer.ln_linear import (
    BLOCK_M, LN_LINEAR_OP, LN_SAVE_NAMES, ln_linear, ln_linear_bwd_dx,
    ln_linear_bwd_dx_reference, ln_linear_fwd, supports_fused)

from _torch_threads import one_thread  # noqa: F401


RTOL = 2e-5


def _inputs(m, c, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, c)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((c, n)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    return x, gamma, beta, w, bias, dy


def _close(got, want, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, f"{what}: {err}"


@pytest.mark.parametrize("m,c,n", [(128, 128, 128), (96, 100, 72)])
def test_forward_and_grads_match_jax(m, c, n):
    x, gamma, beta, w, bias, dy = _inputs(m, c, n)
    assert jax_supports(m, c, n) == (c == 128)
    assert supports_fused(m, c, n) == (c == 128)
    y, vjp = jax.vjp(lambda *a: jax_ln(*a), *map(jnp.asarray,
                                                  (x, gamma, beta, w, bias)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    want[3] = want[3].T        # dW in the port's (N, C) layout
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, gamma, beta, np.ascontiguousarray(w.T), bias)]
    got_y = ln_linear(*args)
    got_y.backward(torch.from_numpy(dy))
    _close(got_y.detach().numpy(), np.asarray(y), "y")
    for name, a, ref in zip(("x", "gamma", "beta", "W", "b"), args, want):
        _close(a.grad.numpy(), ref, f"d{name}")


def test_leading_dims_and_refusals():
    x, gamma, beta, w, bias, _ = _inputs(2 * 40, 64, 48, seed=1)
    t = [torch.from_numpy(a) for a in (x, gamma, beta,
                                       np.ascontiguousarray(w.T), bias)]
    flat = ln_linear(*t)
    y3 = ln_linear(t[0].view(2, 40, 64), *t[1:])
    assert y3.shape == (2, 40, 48)
    torch.testing.assert_close(y3.reshape(80, 48), flat, atol=0, rtol=0)
    # the gate is the CUDA kernels' own. fp32 (FMA kernels): C a multiple
    # of 32, any M and N, no cap on C
    f32 = torch.float32
    assert supports_fused(7, 32, 3, f32) and supports_fused(10240, 1536, 4096,
                                                            f32)
    assert supports_fused(64, 1568, 64, f32)
    assert supports_fused(10240, 4096, 4096, f32)
    assert not supports_fused(64, 48, 64, f32)
    assert not supports_fused(64, 0, 64, f32)
    # bf16 / fp16 (wgmma kernels, bf16 by default): C a multiple of 64, N of
    # 8, any M; no cap on C
    for dt in (torch.bfloat16, torch.float16):
        assert supports_fused(1, 64, 8, dt) and supports_fused(10240, 4096,
                                                               3072, dt)
        assert supports_fused(2048, 1600, 4800, dt)
        assert not supports_fused(7, 32, 8, dt)      # C % 64
        assert not supports_fused(64, 96, 64, dt)    # C % 64
        assert not supports_fused(64, 64, 12, dt)    # N % 8
    assert supports_fused(10240, 1536, 4096) and not supports_fused(7, 32, 3)
    # a refused shape on the CPU takes the plain composition (a CUDA
    # tensor raises; tests/test_torch_cuda_kernels.py holds that)
    xr, wr = torch.randn(4, 48), torch.randn(8, 48)
    want = torch.nn.functional.linear(
        torch.nn.functional.layer_norm(xr, (48,), eps=1e-5), wr)
    torch.testing.assert_close(
        ln_linear(xr, torch.ones(48), torch.zeros(48), wr, torch.zeros(8)),
        want, atol=2e-5, rtol=2e-5)
    assert LN_SAVE_NAMES == ("ln_linear_out", "ln_linear_stats")


def test_kernel_wrappers_take_their_plain_versions_on_the_cpu():
    """Partials are one row per BLOCK_M rows, a ragged last tile included,
    and sum to dgamma and dbeta."""
    m, c, n = 70, 64, 40
    x, gamma, beta, w, bias, dy = (torch.from_numpy(a) for a in
                                   _inputs(m, c, n, seed=2))
    w = w.t().contiguous()
    y, mean, rstd = ln_linear_fwd(x, gamma, beta, w, bias)
    assert y.shape == (m, n) and mean.shape == rstd.shape == (m,)
    torch.testing.assert_close(mean, x.mean(1), atol=1e-6, rtol=0)
    dx, dg, db = ln_linear_bwd_dx(dy, w, x, gamma, mean, rstd)
    assert dg.shape == db.shape == (-(-m // BLOCK_M), c)
    xs = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    ref = torch.nn.functional.layer_norm(xs[0], (c,), xs[1], xs[2], 1e-5)
    (ref @ w.t()).backward(dy)
    torch.testing.assert_close(dx, xs[0].grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(dg.sum(0), xs[1].grad, atol=1e-4, rtol=0)
    torch.testing.assert_close(db.sum(0), xs[2].grad, atol=1e-4, rtol=0)
    assert ln_linear_fwd.launches == ln_linear_bwd_dx.launches == 0
    for got, want in zip((dx, dg, db), ln_linear_bwd_dx_reference(
            dy, w, x, gamma, mean, rstd)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_bf16_gate_takes_every_shape_the_jax_gate_takes():
    ms = (1, 8, 100, 128, 256, 512, 1000, 1024, 2048, 10240)
    cs = tuple(range(32, 4097 + 256, 32)) + (100, 1600)
    ns = (1, 8, 50, 128, 136, 384, 512, 640, 3000, 3072, 4096, 4800, 8192)
    taken = 0
    for m in ms:
        for c in cs:
            for n in ns:
                if jax_supports(m, c, n):
                    taken += 1
                    assert supports_fused(m, c, n), (m, c, n)
                    assert supports_fused(m, c, n, torch.float16), (m, c, n)
    assert taken > 500
    # the JAX gate's top (C = 4096) is inside, and so is GPT-2 XL's C = 1600,
    # which the JAX package runs through its XLA composition
    assert jax_supports(10240, 4096, 4096) and supports_fused(10240, 4096,
                                                              4096)
    assert not jax_supports(2048, 1600, 4800)
    assert supports_fused(2048, 1600, 4800)


WIDE = (128, 2048, 128)


@pytest.fixture(scope="module")
def wide_jax():
    """The inputs at WIDE and the JAX Pallas kernels' (y, [dx, dgamma,
    dbeta, dW (N, C), db]) on them, in interpret mode."""
    x, gamma, beta, w, bias, dy = _inputs(*WIDE, seed=3)
    y, vjp = jax.jit(lambda *a: jax.vjp(jax_ln, *a))(
        *map(jnp.asarray, (x, gamma, beta, w, bias)))
    want = [np.asarray(g) for g in jax.jit(vjp)(jnp.asarray(dy))]
    want[3] = want[3].T
    return (x, gamma, beta, w, bias, dy), np.asarray(y), want


def _counting_plain_versions(monkeypatch):
    calls = []
    for name in ("ln_linear_fwd_reference", "ln_linear_bwd_dx_reference"):
        real = getattr(port_ln, name)
        monkeypatch.setattr(port_ln, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    return calls


def test_wide_c_through_the_operator_matches_jax(monkeypatch, wide_jax):
    """(128, 2048, 128): the JAX gate takes it, the old port gates (16-bit
    and fp32 alike, C ≤ 1536) refused it. fp32 through
    ``dstorch::ln_linear`` (the kernels' plain versions on the CPU) against
    the JAX Pallas kernels in interpret mode; then bf16 through
    ``ln_linear``, which takes the operator."""
    m, c, n = WIDE
    assert jax_supports(m, c, n) and supports_fused(m, c, n)
    assert supports_fused(m, c, n, torch.float32)   # no fp32 cap on C
    (x, gamma, beta, w, bias, dy), y, want = wide_jax
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, gamma, beta, np.ascontiguousarray(w.T), bias)]
    got_y, _, _ = LN_LINEAR_OP(*args, 1e-5)
    got_y.backward(torch.from_numpy(dy))
    _close(got_y.detach().numpy(), y, "y")
    for name, a, ref in zip(("x", "gamma", "beta", "W", "b"), args, want):
        _close(a.grad.numpy(), ref, f"d{name}")

    calls = _counting_plain_versions(monkeypatch)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    p = [torch.from_numpy(a).to(torch.bfloat16) for a in
         (gamma, beta, np.ascontiguousarray(w.T), bias)]
    ln_linear(xb, *p).float().sum().backward()
    assert calls == ["ln_linear_fwd_reference", "ln_linear_bwd_dx_reference"]
    assert xb.grad is not None and torch.isfinite(xb.grad).all()


def test_fp32_wide_c_through_ln_linear_matches_jax(monkeypatch, wide_jax):
    """fp32 at C = 2048 through the public ``ln_linear``, which now takes
    the custom operator (its kernels' plain versions on the CPU) as the JAX
    function takes its Pallas kernels: forward and every gradient against
    the JAX package within RTOL."""
    (x, gamma, beta, w, bias, dy), y, want = wide_jax
    calls = _counting_plain_versions(monkeypatch)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, gamma, beta, np.ascontiguousarray(w.T), bias)]
    got_y = ln_linear(*args)
    got_y.backward(torch.from_numpy(dy))
    assert calls == ["ln_linear_fwd_reference", "ln_linear_bwd_dx_reference"]
    _close(got_y.detach().numpy(), y, "y")
    for name, a, ref in zip(("x", "gamma", "beta", "W", "b"), args, want):
        _close(a.grad.numpy(), ref, f"d{name}")


@pytest.mark.parametrize("c", [1024, 2048, 3072, 4096])
def test_fp32_gate_takes_every_shape_the_jax_gate_takes(c):
    """The fp32 gate (C a multiple of 32, no cap) takes every (m, c, n) that
    the JAX gate takes at the widths of GPT-2 medium, the 1.3B, GPT-2 XL's
    neighbour 3072 and the JAX gate's top."""
    ms = (1, 8, 100, 128, 256, 512, 1000, 1024, 2048, 10240)
    ns = (1, 8, 50, 128, 136, 384, 512, 640, 3000, 3072, 4096, 4800, 8192)
    taken = [(m, n) for m in ms for n in ns if jax_supports(m, c, n)]
    assert len(taken) > 20
    for m, n in taken:
        assert supports_fused(m, c, n, torch.float32), (m, c, n)


def test_partials_have_block_m_rows_with_a_ragged_last_tile():
    m, c, n = 2 * BLOCK_M + 5, 64, 16
    x, gamma, _, w, _, dy = (torch.from_numpy(a) for a in
                             _inputs(m, c, n, seed=4))
    w = w.t().contiguous()
    xf = x.double()
    mean = xf.mean(1)
    rstd = ((xf - mean[:, None]) ** 2).mean(1).add(1e-5).rsqrt()
    _, dg, db = ln_linear_bwd_dx(dy, w, x, gamma, mean.float(), rstd.float())
    assert dg.shape == db.shape == (3, c)
    dn = dy.double() @ w.double()
    xh = (xf - mean[:, None]) * rstd[:, None]
    for i, rows in enumerate((slice(0, 128), slice(128, 256),
                              slice(256, m))):
        torch.testing.assert_close(dg[i].double(), (dn * xh)[rows].sum(0),
                                   atol=1e-4, rtol=0)
        torch.testing.assert_close(db[i].double(), dn[rows].sum(0),
                                   atol=1e-4, rtol=0)
