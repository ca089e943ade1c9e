"""The port's int8 weight path against the JAX package's, on the CPU.

``quantize_columns``, the plain ``int8_matmul_reference`` (the CUDA kernel's
twin), ``QuantDense`` and ``quantize_lm_params`` take the same numpy inputs
as their JAX counterparts. The JAX side runs its plain reference (the
Pallas kernel is held against it by the JAX package's own tests).

Tolerances: quantized values are identical (same fp32 division, round half
to even); scales agree to 1e-7. The fp32 product differs from the JAX one
only in summation order (bf16 x int8 products are exact in fp32): rtol
1e-5. A bf16 output adds one bf16 rounding of values below 1 (spacing at
most 2^-8): atol 1e-2.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.ops.quantization import QuantDense as JaxQuantDense
from deepspeed_tpu.ops.quantization import convert as jconvert
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.ops.quantization import (DENSE_KEYS, QuantDense,
                                                  int8_matmul,
                                                  int8_matmul_reference,
                                                  quantize_columns,
                                                  quantize_lm_params)
from deepspeed_tpu_torch.ops.quantization.int8_matmul import (INT8_TILES,
                                                              MAX_SPLITS,
                                                              int8_plan)

from _torch_threads import one_thread  # noqa: F401


# the JAX package re-exports the function under the module's name
jq = importlib.import_module("deepspeed_tpu.ops.quantization.int8_matmul")
K, N = 64, 200          # N is not a multiple of 128


def _case(rng, M):
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)     # JAX (K, N)
    s = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    return x, w, s


def test_quantize_columns_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:, 7] = 0.0                                   # a zero column: scale 1
    w[3, 9] = 1e-3 * 127 * 2.5                      # exact .5 ties in col 9
    want_q, want_s = jq.quantize_columns(w)
    got_q, got_s = quantize_columns(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.shape == (1, N)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-7, atol=0)
    assert got_s[0, 7] == 1.0


@pytest.mark.parametrize("M", [1, 8, 37])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_jax_reference(M, out_dtype):
    x, w, s = _case(np.random.default_rng(M), M)
    want = np.asarray(jq.int8_matmul_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        out_dtype=getattr(jnp, out_dtype)), np.float32)
    tw = torch.from_numpy(np.ascontiguousarray(w.T))        # port (N, K)
    got = int8_matmul(torch.from_numpy(x), tw, torch.from_numpy(s[0]),
                      out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (M, N)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2)
    # leading dims pass through; CPU tensors launch nothing
    got3 = int8_matmul_reference(torch.from_numpy(x)[None], tw,
                                 torch.from_numpy(s))
    assert got3.shape == (1, M, N) and int8_matmul.launches == 0


def test_quant_dense_matches_jax_with_padding_dropped():
    """JAX pads N=200 to 256 columns (zero weights, scale 1); the port
    holds the 200 real ones as (N, K)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    layer = JaxQuantDense(N, use_bias=True, dtype=jnp.float32,
                          kernel_mode="off")
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert params["kernel"].shape == (K, 256)
    _, w, s = _case(rng, 1)
    kernel = np.zeros((K, 256), np.int8)
    kernel[:, :N] = w
    scale = np.ones((1, 256), np.float32)
    scale[:, :N] = s
    bias = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(layer.apply({"params": {
        "kernel": kernel, "scale": scale, "bias": bias}}, jnp.asarray(x)))
    for mode in ("auto", "off"):
        port = QuantDense(K, N, bias=True, dtype=torch.float32,
                          kernel_mode=mode)
        port.load_state_dict({"weight": torch.from_numpy(kernel[:, :N].T),
                              "scale": torch.from_numpy(scale[0, :N]),
                              "bias": torch.from_numpy(bias)})
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def float_pair():
    jcfg = J.transformer_config("llama", vocab_size=64, max_seq_len=32,
                                n_embd=32, n_layer=2, n_head=4, n_kv_head=2,
                                dtype=jnp.float32)
    jm = J.TransformerLM(jcfg)
    # jitted: one compile instead of eager dispatch (seconds on the CPU)
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = P.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    return pcfg, params


@pytest.mark.parametrize("head", [False, True], ids=["head_fp", "int8_head"])
def test_quantize_lm_params_matches_jax(float_pair, head):
    """The port quantizes its module tree on the model's device; the result
    equals the JAX tree quantized on the host and carried over by the
    weight bridge (int8 kernels identical, scales within 1e-7)."""
    pcfg, params = float_pair
    keys = DENSE_KEYS if head else DENSE_KEYS - {"lm_head"}
    qparams, n_jax = jconvert.quantize_lm_params(params, dense_keys=keys)
    model = P.TransformerLM(pcfg)
    model.load_state_dict(state_dict_from_flax(pcfg, params))
    _, n = quantize_lm_params(model, keys)
    assert n == 7 * pcfg.n_layer + head and n_jax == 7 + head
    qcfg = dataclasses.replace(pcfg, int8_weights=True, int8_head=head)
    want = state_dict_from_flax(qcfg, qparams)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        if val.dtype == torch.int8:
            np.testing.assert_array_equal(got[key].numpy(), val.numpy(),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       rtol=1e-7, atol=0, err_msg=key)
    assert isinstance(model.lm_head, QuantDense) is head


# TinyLlama's projections (K, N) at decode (M = 8) and prefill (M = 64, 72,
# 512) on a 132-SM card: (tile, splits)
@pytest.mark.parametrize("M,K,N,plan", [
    (8, 2048, 2048, (1, 8)), (8, 2048, 256, (1, 8)), (8, 2048, 5632, (1, 1)),
    (8, 5632, 2048, (1, 8)), (1, 2048, 2048, (1, 8)), (16, 2048, 2048, (2, 8)),
    (64, 2048, 5632, (3, 6)), (72, 2048, 5632, (4, 6)),
    (512, 2048, 5632, (4, 1)), (8, 256, 64, (1, 2))])
def test_int8_plan_by_rows_and_grid(M, K, N, plan):
    """The tensor-core kernel's tile by M (8 or 16 tokens a block for
    decode, 64 or 128 for prefill) and the split of each tile's K range: up
    to 8 blocks while the tiles fill under a quarter of the card's slots
    (two blocks an SM), never more than the tile's k slices, and none once
    the tiles fill a quarter (the decode gate, the 512-row prompt)."""
    assert int8_plan(M, K, N, 132) == plan
    tile, splits = plan
    assert M <= INT8_TILES[tile][1] or tile == max(INT8_TILES)
    assert 1 <= splits <= min(MAX_SPLITS, -(-K // INT8_TILES[tile][2]))


def test_int8_plan_takes_the_scalar_kernel_off_the_fast_path():
    """K % 16 != 0 or an unaligned x or w: the scalar kernel (tile 0), one
    split, whatever M."""
    for M in (1, 8, 64, 1000):
        assert int8_plan(M, 40, 200, 132) == (0, 1)
        assert int8_plan(M, 2048, 256, 132, aligned=False) == (0, 1)


def test_cpu_tensors_never_reach_the_kernel_builder(monkeypatch):
    """On the CPU int8_matmul is its plain version: the builder is never
    asked for a kernel and no launch is counted."""
    from deepspeed_tpu_torch.ops import op_builder

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel builder")

    monkeypatch.setattr(op_builder, "load", refuse)
    monkeypatch.setattr(op_builder, "launch", refuse)
    rng = np.random.default_rng(5)
    x, w, s = _case(rng, 72)
    wt = torch.from_numpy(w.T.copy())
    before = (int8_matmul.launches, int8_matmul.prefill_launches)
    got = int8_matmul(torch.from_numpy(x), wt, torch.from_numpy(s[0]),
                      torch.float32)
    torch.testing.assert_close(got, int8_matmul_reference(
        torch.from_numpy(x), wt, torch.from_numpy(s[0]), torch.float32))
    assert (int8_matmul.launches, int8_matmul.prefill_launches) == before
