"""The port's int8 model and ``dtype="int8"`` engine against the JAX
package's, on the CPU.

A 2-layer GQA llama (n_embd 32, 4 heads over 2 KV heads) with int8 weights
and the int8 KV cache: the JAX tree is quantized by the JAX package's
``quantize_lm_params`` and carried over by the weight bridge, so both
packages hold the same int8 weights and scales. The JAX side decodes
through its plain einsum path (``decode_kernel="off"``); the Pallas kernels
are held against it by the JAX package's own tests.

Tolerances. The fp32 model: both sides round only each projection's input
to bf16 (the int8 tier's compute contract) and quantize the same K/V rows;
fp32 summation order can move a value across a bf16 or int8 rounding
boundary, which shifts a logit by one rounding step of one input (~1e-3 on
logits of magnitude ~1), so logits agree within 2e-3. The ``dtype="int8"``
engines compute in bf16 (activations rounded at every layer in different
places by the two frameworks): logits within 3e-2 relative L2 per
position, and argmax agreeing on at least 90% of positions.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.ops.quantization.convert import \
    quantize_lm_params as jax_quantize_lm_params
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.ops.quantization import DENSE_KEYS, QuantDense

from _torch_threads import one_thread  # noqa: F401


ATOL = 2e-3
TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            n_kv_head=2, dtype=jnp.float32, decode_kernel="off")


def _port_config(jcfg, **overrides):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return P.TransformerConfig(**{**fields, **overrides})


@pytest.fixture(scope="module")
def stack():
    jcfg = J.transformer_config("llama", **TINY)
    jm = J.TransformerLM(jcfg)
    # jitted: one compile instead of eager dispatch (seconds on the CPU)
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    qparams, _ = jax_quantize_lm_params(params, DENSE_KEYS - {"lm_head"})
    jcfg_q = dataclasses.replace(jcfg, int8_weights=True, kv_cache_quant=True)
    jm_q = J.TransformerLM(jcfg_q)
    pcfg_q = _port_config(jcfg_q)
    pm_q = P.TransformerLM(pcfg_q)
    pm_q.load_state_dict(state_dict_from_flax(pcfg_q, qparams))
    return dict(jcfg=jcfg, params=params, jm_q=jm_q, qparams=qparams,
                pm_q=pm_q)


def test_int8_model_matches_jax(stack):
    """Logits; prefill (logits and the int8 cache); decode steps at
    per-slot (B,) starts with T=1 and a 3-token window step."""
    jm, qp, pm = stack["jm_q"], stack["qparams"], stack["pm_q"]
    ids = np.random.default_rng(0).integers(0, 64, (2, 10)).astype(np.int32)
    assert isinstance(pm.blocks[0].mlp.gate_proj, QuantDense)
    want = np.asarray(jax.jit(lambda p, i: jm.apply(
        {"params": p}, i, method=jm.logits))(qp, jnp.asarray(ids)))
    got = pm.logits(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    prefill = jax.jit(lambda p, i: jm.apply({"params": p}, i,
                                            method=jm.prefill,
                                            mutable=["cache"]))
    decode = jax.jit(lambda v, t, s: jm.apply(v, t, s, method=jm.decode,
                                              mutable=["cache"]))
    jl, jvars = prefill(qp, jnp.asarray(ids))
    pl, cache = pm.prefill(torch.from_numpy(ids).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    store = jvars["cache"]["cache_store"]
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    np.testing.assert_allclose(cache["k_scale"].numpy(),
                               np.asarray(store["k_scale"]), rtol=1e-4,
                               atol=0)
    starts = np.array([10, 7], np.int32)
    jcache = {"cache_store": {**store, "index": jnp.asarray(starts)}}
    toks = np.random.default_rng(5).integers(0, 64, (2, 3))
    for step, tok in enumerate((toks[:, :1], toks)):
        tok = tok.astype(np.int32)
        jl, jvars = decode({"params": qp, "cache": jcache}, jnp.asarray(tok),
                           jnp.asarray(starts))
        jcache = jvars["cache"]
        got = pm.decode(torch.from_numpy(tok).long(), starts, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
        starts = starts + tok.shape[1]


def test_one_token_prefill_into_a_subset_of_rows(stack):
    """A one-token prompt attends its own quantized row (as the JAX module
    does through its cache), also when it is written into some rows of a
    larger cache: rows 3 and 1 of 4 get the rows and logits of a prefill
    into a fresh 2-row cache, and rows 0 and 2 stay empty."""
    jm, qp, pm = stack["jm_q"], stack["qparams"], stack["pm_q"]
    ids = np.array([[5], [9]], np.int32)
    want, _ = jax.jit(lambda p, i: jm.apply({"params": p}, i,
                                            method=jm.prefill,
                                            mutable=["cache"]))(
        qp, jnp.asarray(ids))
    fresh_logits, fresh = pm.prefill(torch.from_numpy(ids).long())
    np.testing.assert_allclose(fresh_logits.numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    cache = pm.kv_cache_spec().stacked_cache(4)
    logits, cache = pm.prefill(torch.from_numpy(ids).long(), cache,
                               rows=torch.tensor([3, 1]))
    torch.testing.assert_close(logits, fresh_logits)
    for key, leaf in fresh.items():
        torch.testing.assert_close(cache[key][:, [3, 1]], leaf)
        assert not cache[key][:, [0, 2]].any(), key


def test_replace_config_owns_the_int8_kernel_switch(stack):
    """``replace_config`` gives every submodule the new config and every
    QuantDense the config's ``int8_kernel``."""
    pm = copy.deepcopy(stack["pm_q"])
    dense = [m for m in pm.modules() if isinstance(m, QuantDense)]
    assert dense and {m.kernel_mode for m in dense} == {"auto"}
    cfg = pm.replace_config(int8_kernel="off", decode_kernel="auto")
    assert pm.config is cfg and cfg.int8_kernel == "off"
    assert {m.kernel_mode for m in dense} == {"off"}
    assert all(m.config is cfg for m in pm.modules()
               if hasattr(m, "config"))


def test_engine_int8_tier_matches_jax(stack):
    """``dtype="int8"`` on a bf16 TransformerLM in both packages: the port
    swaps every projection but the head for QuantDense on the device (the
    tree under 0.75x the bf16 one), and its logits track the JAX tier's."""
    jcfg = dataclasses.replace(stack["jcfg"], dtype=jnp.bfloat16,
                               decode_kernel="auto")
    params = stack["params"]
    ids = np.random.default_rng(4).integers(0, 64, (2, 12)).astype(np.int32)
    jeng = ds.init_inference(J.TransformerLM(jcfg), model_parameters=params,
                             dtype="int8")
    want = np.asarray(jeng.forward(jnp.asarray(ids)), np.float32)

    pcfg = _port_config(jcfg)
    state = state_dict_from_flax(pcfg, params)
    fp = dst.init_inference(P.TransformerLM(pcfg), model_parameters=state,
                            config={"dtype": "bfloat16"}, device="cpu")
    q = dst.init_inference(P.TransformerLM(pcfg), model_parameters=state,
                           config={"dtype": "int8"}, device="cpu")
    assert q.module.config.int8_weights and q.module.kv_cache_spec().dtype \
        == torch.bfloat16
    dense = [m for m in q.module.modules() if isinstance(m, QuantDense)]
    assert len(dense) == 7 * pcfg.n_layer and not isinstance(
        q.module.lm_head, QuantDense)
    assert all(m.weight.dtype == torch.int8 and m.dtype == torch.bfloat16
               for m in dense)

    def tree_bytes(module):
        return sum(t.numel() * t.element_size()
                   for t in module.state_dict().values())

    assert tree_bytes(q.module) < 0.75 * tree_bytes(fp.module)
    got = q.forward(ids).float().numpy()
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() < 3e-2, rel.max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    toks = q.generate(ids, max_new_tokens=4)
    assert toks.shape == (2, 16)
