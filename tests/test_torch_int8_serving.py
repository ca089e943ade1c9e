"""The port's int8 servers and generate() against the JAX package's, on the
CPU: greedy tokens must be identical.

A 2-layer GQA llama (n_embd 32, 4 heads over 2 KV heads) with int8 weights
and the int8 KV cache: the JAX tree is quantized by the JAX package's
``quantize_lm_params`` and carried over by the weight bridge, so both
packages hold the same int8 weights and scales. The JAX side decodes
through its plain einsum path (``decode_kernel="off"``); the Pallas kernels
are held against it by the JAX package's own tests.

The model is fp32 apart from each projection's bf16 input (the int8 tier's
compute contract), and its weights come from the JAX module's init, so
logits are far from ties and greedy tokens carry over exactly.
"""

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
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.ops.quantization import DENSE_KEYS

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            n_kv_head=2, dtype=jnp.float32, decode_kernel="off")
PS = CHUNK = 16


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


@pytest.fixture(scope="module")
def traffic():
    """2 requests sharing a 2-page prefix (streamed in chunks) and a
    one-token prompt (bucketed whole-prompt admission)."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 64, 2 * PS)
    prompts = [np.concatenate([base, rng.integers(0, 64, n)])
               for n in (5, 12)]
    prompts.append(rng.integers(0, 64, 1))
    budgets = [9, 6, 11]
    return [p.astype(np.int32) for p in prompts], budgets


@pytest.fixture(scope="module")
def generated(stack, traffic):
    """The port's generate() tokens (held against the JAX engine's below)."""
    eng = dst.init_inference(stack["pm_q"], config={"dtype": "float32"},
                             device="cpu")
    return [eng.generate(p[None], max_new_tokens=b)[0]
            for p, b in zip(*traffic)]


def _serve(srv, prompts, budgets):
    reqs = [srv.submit(prompts[0], max_new_tokens=budgets[0])]
    for _ in range(50):
        if reqs[0].state.value == "running":
            break
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=b)
             for p, b in zip(prompts[1:], budgets[1:])]
    srv.run_until_drained(max_steps=400)
    srv.check_invariants()
    assert all(r.state.value == "finished" for r in reqs)
    return reqs


@pytest.fixture(scope="module")
def chunked(stack, traffic):
    """The JAX paged server's greedy tokens (stall-free chunks of 16)."""
    jeng = ds.init_inference(model=stack["jm_q"],
                             model_parameters=stack["qparams"],
                             config={"dtype": "float32"})
    srv = JaxServingEngine(jeng, num_slots=2, prefill_chunk=CHUNK,
                           paged_kv={"page_size": PS, "kernel": "off"})
    return [np.asarray(r.tokens()) for r in _serve(srv, *traffic)]


def test_int8_generate_matches_jax(stack, traffic, generated, chunked):
    """The port's generate() gives the JAX engine's tokens. A prompt that
    fits one chunk is admitted whole by the chunked servers too, so there
    the JAX server agrees with generate(); a longer prompt streamed in
    chunks attends its own quantized rows (whole-prompt prefill attends the
    fresh full-precision K/V), in both packages alike."""
    ids = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(np.int32)
    jeng = ds.init_inference(model=stack["jm_q"],
                             model_parameters=stack["qparams"],
                             config={"dtype": "float32"})
    eng = dst.init_inference(stack["pm_q"], config={"dtype": "float32"},
                             device="cpu")
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=12),
        np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=12)))
    for p, want, got in zip(traffic[0], generated, chunked):
        if len(p) <= CHUNK:
            np.testing.assert_array_equal(got, want)


ARMS = {
    "paged_prefix": dict(prefill_chunk=CHUNK,
                         paged_kv={"page_size": PS, "prefix_cache": True}),
    "contiguous_stall_free": dict(prefill_chunk=CHUNK),
    "contiguous_serial": dict(prefill_chunk=0),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_int8_servers_match_the_oracles(stack, traffic, generated, chunked,
                                        arm):
    """Greedy tokens: the port's paged + prefix-cache int8 server and its
    contiguous stall-free one give the JAX paged server's (chunked
    admission); its contiguous serial one gives generate()'s (whole-prompt
    admission). The pool's cache is int8 with its scales."""
    eng = dst.init_inference(stack["pm_q"], config={"dtype": "float32"},
                             device="cpu")
    srv = dst.ServingEngine(eng, num_slots=2, **ARMS[arm])
    assert srv.pool.cache["v"].dtype == torch.int8
    assert srv.pool.cache["v_scale"].dtype == torch.float32
    reqs = _serve(srv, *traffic)
    oracle = generated if arm == "contiguous_serial" else chunked
    for req, want in zip(reqs, oracle):
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")
    if arm == "paged_prefix":
        assert reqs[1].prefix_hit_tokens == 2 * PS
