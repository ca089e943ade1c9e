"""The port's host optimizer op (``ops/csrc/cpu_adam.cpp``, built at first
use with the C++ compiler into ``build/host/``) against the JAX package's.

The same numpy-seeded arrays go through the port's ``DeepSpeedCPUAdam`` /
``DeepSpeedCPUAdagrad`` (torch tensors) and the JAX package's (numpy
arrays): bit-equal when the JAX wrapper reports its native build, as here
(both compile the same source with the same flags), else within 1e-6
relative; and against the port's plain PyTorch versions within 1e-6
relative. ``to_bf16`` is bit-equal to ``tensor.to(torch.bfloat16)`` on
finite values, ties included; ``has_overflow`` sees NaN and both
infinities; a missing compiler raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdagrad as JaxAdagrad
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import (DeepSpeedCPUAdagrad,
                                          DeepSpeedCPUAdam,
                                          adagrad_step_reference,
                                          adam_step_reference)

from _torch_threads import one_thread  # noqa: F401

N = 4097            # off the vector width
STEPS = 4
RTOL = 1e-6


def _arrays(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    grads = [rng.standard_normal(N).astype(np.float32)
             for _ in range(STEPS)]
    return p, grads


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, f"{what}: {err}"


def _same(got, want, native, what):
    if native:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        _close(got, want, what)


@pytest.mark.parametrize("adamw", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_matches_the_jax_op_and_the_plain_version(adamw, wd,
                                                       bias_correction):
    p0, grads = _arrays(0)
    kw = dict(lr=2e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=wd,
              adamw_mode=adamw, bias_correction=bias_correction)
    jax_opt = JaxAdam(**kw)
    ours = DeepSpeedCPUAdam(**kw)
    jp, jm, jv = p0.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (jp, jm, jv))
    rp, rm, rv = tp.clone(), tm.clone(), tv.clone()
    for t, g in enumerate(grads, start=1):
        jax_opt.step(jp, g.copy(), jm, jv, t)
        ours.step(tp, torch.from_numpy(g.copy()), tm, tv, t)
        adam_step_reference(rp, torch.from_numpy(g.copy()), rm, rv, t,
                            kw["lr"], kw["betas"], kw["eps"], wd, adamw,
                            bias_correction)
    for name, got, want, plain in (("param", tp, jp, rp), ("m", tm, jm, rm),
                                   ("v", tv, jv, rv)):
        _same(got.numpy(), want, jax_opt.native, f"{name} vs JAX")
        _close(got.numpy(), plain.numpy(), f"{name} vs plain")


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adagrad_matches_the_jax_op_and_the_plain_version(wd):
    p0, grads = _arrays(1)
    jax_opt = JaxAdagrad(lr=1e-2, eps=1e-8, weight_decay=wd)
    ours = DeepSpeedCPUAdagrad(lr=1e-2, eps=1e-8, weight_decay=wd)
    jp, ja = p0.copy(), np.zeros(N, np.float32)
    tp, ta = torch.from_numpy(jp.copy()), torch.from_numpy(ja.copy())
    rp, ra = tp.clone(), ta.clone()
    for g in grads:
        jax_opt.step(jp, g.copy(), ja)
        ours.step(tp, torch.from_numpy(g.copy()), ta)
        adagrad_step_reference(rp, torch.from_numpy(g.copy()), ra, 1e-2,
                               1e-8, wd)
    native = jax_opt._lib is not None
    _same(tp.numpy(), jp, native, "param vs JAX")
    _same(ta.numpy(), ja, native, "accum vs JAX")
    _close(tp.numpy(), rp.numpy(), "param vs plain")
    _close(ta.numpy(), ra.numpy(), "accum vs plain")


def test_to_bf16_rounds_to_nearest_even_like_torch():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(N) * 100).astype(np.float32))
    # exact ties: the lower 16 bits 0x8000, with even and odd upper halves
    ties = torch.tensor([0x3F808000, 0x3F818000, 0xBF808000, 0x40498000,
                         0x3F80FFFF, 0x3F807FFF, 0x7F7F8000],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    x = torch.cat([x, ties, torch.tensor([0.0, -0.0, 1e-40, -3e-39])])
    opt = DeepSpeedCPUAdam()
    got = opt.to_bf16(x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    dst = torch.empty(x.shape, dtype=torch.bfloat16)
    assert opt.to_bf16(x, dst) is dst and torch.equal(dst.view(torch.int16),
                                                      got.view(torch.int16))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_has_overflow_sees_nonfinite(bad):
    opt = DeepSpeedCPUAdam()
    g = torch.zeros(N)
    assert not opt.has_overflow(g)
    g[N // 2] = bad
    assert opt.has_overflow(g)


def test_rejects_tensors_the_op_cannot_take():
    opt = DeepSpeedCPUAdam()
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="fp32 CPU"):
        opt.step(p, torch.zeros(8, dtype=torch.float64), p.clone(),
                 p.clone(), 1)
    with pytest.raises(ValueError, match="fp32 CPU"):
        opt.step(p, torch.zeros(4), torch.zeros(8), torch.zeros(8), 1)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/bin/c++")
    monkeypatch.setattr(op_builder, "_HOST_LIBS", {})
    with pytest.raises(op_builder.KernelBuildError, match="CXX="):
        op_builder.build_host("cpu_adam")
    with pytest.raises(op_builder.KernelBuildError):
        DeepSpeedCPUAdam()


def test_a_cxx_without_openmp_is_passed_over(monkeypatch, tmp_path):
    """A ``$CXX`` that cannot build OpenMP code (a compiler without its
    runtime) gives way to ``c++``/``g++`` on ``PATH``, which build the op
    with the same flags."""
    fake = tmp_path / "c++-no-openmp"
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    cxx = op_builder.find_cxx()
    assert cxx != str(fake)
    assert op_builder.build_host("cpu_adam").name.startswith("libcpu_adam-")


def test_host_build_lands_in_the_ignored_build_dir():
    path = op_builder.build_host("cpu_adam")
    assert path.parent == op_builder.BUILD_DIR.parent / "host"
    assert path.name.startswith("libcpu_adam-") and path.exists()
    assert op_builder.build_host("cpu_adam") == path
