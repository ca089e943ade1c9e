"""The port's int8 storage tier and ``WeightQuantization`` against the JAX
package's, on the CPU.

``WeightQuantization`` is numpy in both packages: its values and scales
are held bitwise. The storage tier (``quant.enabled`` in fp32 or fp16,
``bits`` 4 or 8, a module that is not a ``TransformerLM``) stores int8 and
per-group fp32 scales and dequantizes at each use: the port's dequantized
weights, read through the module, are held bitwise against the JAX
engine's ``_dequant`` output carried over by the weight bridge
(``state_dict_from_flax``). With bitwise-equal weights the fp32 logits
differ only by summation order, within 1e-5; greedy tokens are identical.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.runtime.weight_quantizer import \
    WeightQuantization as JaxWeightQuantization
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.inference.engine import GroupDequant
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-5
TINY = dict(vocab_size=64, max_seq_len=32, n_embd=32, n_layer=2, n_head=4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float16": (jnp.float16, torch.float16)}


def _port_config(jcfg, **overrides):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return P.TransformerConfig(**{**fields, **overrides})


@functools.lru_cache(maxsize=None)
def _jax_params(family, n_layer=2):
    """fp32 parameters of a tiny JAX model (flax keeps them fp32 whatever
    the config's compute dtype), from shapes and numpy: no init program
    compiles."""
    jm = J.TransformerLM(J.transformer_config(family, **{
        **TINY, "n_layer": n_layer}))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        method=jm.logits))["params"]
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, a.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("bits,extra", [(8, False), (8, True), (4, True)])
def test_weight_quantization_matches_jax(bits, extra):
    rng = np.random.default_rng(bits + extra)
    sd = {"attn.qkv.weight": rng.normal(size=(16, 48)).astype(np.float32),
          "mlp.fc.weight": rng.normal(size=(16, 64)).astype(np.float32),
          "mlp.proj.bias": rng.normal(size=(16,)).astype(np.float32),
          "odd.weight": rng.normal(size=(3, 5)).astype(np.float32),
          "zero.weight": np.zeros((4, 8), np.float32),
          "ids": np.arange(12, dtype=np.int32).reshape(3, 4)}
    kw = dict(mlp_extra_grouping=extra, quantize_groups=2, num_bits=bits)
    got, got_s = WeightQuantization(**kw).quantize_state_dict(sd)
    want, want_s = JaxWeightQuantization(**kw).quantize_state_dict(sd)
    assert got.keys() == want.keys() and got_s.keys() == want_s.keys()
    assert "odd.weight" not in got_s          # 15 elements, 2 groups
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in got_s:
        np.testing.assert_array_equal(got_s[key], want_s[key], err_msg=key)
    assert got_s["mlp.fc.weight"].shape == ((4, 1) if extra else (2, 1))
    back = WeightQuantization.dequantize_state_dict(got, got_s, np.float16)
    want_back = JaxWeightQuantization.dequantize_state_dict(want, want_s,
                                                            np.float16)
    for key in back:
        np.testing.assert_array_equal(back[key], want_back[key], err_msg=key)
    q, s = WeightQuantization(num_bits=bits).quantize_value(
        sd["attn.qkv.weight"], 8)
    jq, js = JaxWeightQuantization(num_bits=bits).quantize_value(
        sd["attn.qkv.weight"], 8)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(WeightQuantization.dequantize_value(q, s),
                                  JaxWeightQuantization.dequantize_value(jq,
                                                                         js))


def _engines(family, dtype, group_size, bits=8, n_layer=2):
    jdt, tdt = DTYPES[dtype]
    jcfg = J.transformer_config(family, dtype=jdt,
                                **{**TINY, "n_layer": n_layer})
    jm = J.TransformerLM(jcfg)
    params = _jax_params(family, n_layer)
    quant = {"enabled": True, "bits": bits, "group_size": group_size}
    jeng = ds.init_inference(jm, model_parameters=params, dtype=dtype,
                             quant=quant)
    jeng._ensure_params(np.zeros((1, 8), np.int32))
    pcfg = _port_config(jcfg, dtype=tdt)
    pm = P.TransformerLM(pcfg)
    pm.load_state_dict(state_dict_from_flax(pcfg, params))
    peng = dst.init_inference(pm, config={"dtype": dtype, "quant": quant},
                              device="cpu")
    return jeng, peng, pcfg


@pytest.mark.parametrize("family,dtype,group_size,bits,n_layer", [
    ("gpt2", "float32", 64, 4, 2), ("llama", "float32", 0, 8, 2),
    ("llama", "float16", 64, 8, 2),
    # 48-value groups over 3 layers: groups straddle the layers' ends
    ("gpt2", "float32", 48, 8, 3)])
def test_dequantized_weights_equal_jax_bitwise(family, dtype, group_size,
                                               bits, n_layer):
    jeng, peng, pcfg = _engines(family, dtype, group_size, bits, n_layer)
    want = state_dict_from_flax(pcfg, jax.tree_util.tree_map(
        np.asarray, jeng._dequant(jeng.params)))
    mod = peng.module
    leaves, straddled = set(), False
    for key, ref in want.items():
        owner, _, name = key.rpartition(".")
        sub = mod.get_submodule(owner)
        got = getattr(sub, name)
        # the JAX blocks are one scanned leaf with a layer axis: every
        # block parameter is a leaf of rank >= 2 there
        layers = pcfg.n_layer if key.startswith("blocks.") else 1
        if ref.dim() + (layers > 1) >= 2:
            leaves.add(".".join(p if not p.isdigit() else "*"
                                for p in key.split(".")))
            stored = sub.parametrizations[name]
            assert stored.original.dtype == torch.int8, key
            assert isinstance(stored[0], GroupDequant), key
            # the groups of its leaf this layer's values fall in
            size, n = ref.numel() * layers, ref.numel()
            groups = size // group_size if group_size and \
                size % group_size == 0 else 1
            li = int(key.split(".")[1]) if layers > 1 else 0
            g0, g1 = li * n * groups // size, ((li + 1) * n - 1) * groups \
                // size
            rows = stored[0].scale.shape[0]
            assert rows == g1 - g0 + 1, key
            straddled |= rows > 1 and bool(stored[0].offset
                                           or n % stored[0].group_len)
        else:
            assert not hasattr(sub, "parametrizations"), key
        assert got.dtype == ref.dtype == DTYPES[dtype][1], key
        assert torch.equal(got, ref), key
    assert len(leaves) == len(jeng._quant_scales)
    assert straddled == (group_size == 48)
    # int8 at rest: about a quarter (fp32) or half (fp16) of the bytes
    rest = sum(t.numel() * t.element_size()
               for t in mod.state_dict().values())
    full = sum(t.numel() * t.element_size() for t in want.values())
    assert rest < (0.3 if dtype == "float32" else 0.6) * full


def test_storage_tier_logits_and_tokens_match_jax():
    """fp32 storage tier (llama: the untied head is a quantized leaf too): full-context logits within 1e-5 of the JAX
    engine's, greedy generate() identical, and throughput() with the JAX
    keys."""
    jeng, peng, _ = _engines("llama", "float32", 64)
    ids = np.random.default_rng(1).integers(0, 64, (2, 9)).astype(np.int32)
    want = np.asarray(jeng.forward(ids))
    got = peng.forward(ids).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jt = jeng.generate(ids, max_new_tokens=6)
    pt = peng.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(pt, np.asarray(jt))
    jr, pr = jeng.throughput(ids, 6), peng.throughput(ids, 6)
    assert set(pr) == set(jr) == {"tokens_per_sec", "elapsed_s"}
    assert pr["tokens_per_sec"] > 0 and pr["elapsed_s"] > 0


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(48, name="fc")(x))
        return fnn.Dense(12, name="proj")(h)


def test_module_without_logits_runs_the_generic_forward():
    """A module with no ``logits`` method runs through ``forward`` as a
    plain call (the JAX ``_generic_forward``), on stored int8 weights."""
    x = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    jm = _JaxMLP()
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0)}, x)["params"])
    quant = {"enabled": True, "group_size": 16}
    jeng = ds.init_inference(jm, model_parameters=params, dtype="float32",
                             quant=quant)
    want = np.asarray(jeng.forward(x))
    pm = nn.Sequential(nn.Linear(16, 48), nn.ReLU(), nn.Linear(48, 12))
    with torch.no_grad():
        for i, name in ((0, "fc"), (2, "proj")):
            pm[i].weight.copy_(torch.tensor(params[name]["kernel"].T))
            pm[i].bias.copy_(torch.tensor(params[name]["bias"]))
    peng = dst.init_inference(pm, config={"dtype": "float32",
                                          "quant": quant}, device="cpu")
    assert peng.kv_cache_spec() is None
    assert pm[0].parametrizations.weight.original.dtype == torch.int8
    got = peng(x).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_storage_tier_serves_and_compute_tier_is_unchanged():
    """An fp16 storage-tier engine serves through ``init_serving`` (its
    tokens equal its own ``generate()``); ``dtype="int8"`` on a bf16
    TransformerLM still takes the compute tier (QuantDense)."""
    from deepspeed_tpu_torch.ops.quantization import QuantDense

    pcfg = P.transformer_config("llama", dtype=torch.float16, **TINY)
    pm = P.TransformerLM(pcfg)
    pm.init_weights(torch.Generator().manual_seed(0))
    srv = dst.init_serving(pm, config={"dtype": "float16",
                                       "quant": {"enabled": True}},
                           num_slots=2, prefill_chunk=8, paged_kv=True,
                           device="cpu")
    ids = np.random.default_rng(4).integers(0, 64, (2, 11))
    reqs = [srv.submit(row, max_new_tokens=5) for row in ids]
    srv.run_until_drained()
    want = srv.engine.generate(ids, max_new_tokens=5)
    for req, row in zip(reqs, want):
        np.testing.assert_array_equal(req.tokens(), row)
    bm = P.TransformerLM(dataclasses.replace(pcfg, dtype=torch.bfloat16))
    eng = dst.init_inference(bm, config={"dtype": "int8"}, device="cpu")
    assert isinstance(eng.module.blocks[0].attn.q_proj, QuantDense)
    assert not parametrized(eng.module)


def parametrized(module) -> bool:
    return any(hasattr(m, "parametrizations") for m in module.modules())
