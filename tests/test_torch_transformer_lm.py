"""The port's TransformerLM against the JAX package's, on the same weights.

Weights come from the JAX module's own init and cross through the weight
bridge (``checkpoint.flax_import.state_dict_from_flax``). The JAX side runs
its Pallas kernels (``decode_kernel="on"`` with a 16-position block so the
decode kernel walks several blocks, ``use_flash_attention=True``) in
interpret mode; the port runs its plain versions on the CPU. Everything is
fp32, so the tolerance (1e-4 absolute on logits of magnitude ~5) covers
summation order only, compounded over two layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-4
TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            dtype=jnp.float32, decode_kernel="on", decode_block=16,
            use_flash_attention=True)
PRESETS = {"gpt2": {}, "llama": dict(n_kv_head=2)}


def _pair(family, **overrides):
    jcfg = J.transformer_config(family, **{**TINY, **overrides})
    jm = J.TransformerLM(jcfg)
    ids = np.random.default_rng(0).integers(0, 64, (2, 10)).astype(np.int32)
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(ids),
                     method=jm.logits)["params"]
    pcfg = P.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    pm = P.TransformerLM(pcfg)
    pm.load_state_dict(state_dict_from_flax(
        pcfg, jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm, ids


@pytest.fixture(scope="module", params=sorted(PRESETS))
def pair(request):
    return _pair(request.param, **PRESETS[request.param])


def test_weight_bridge_covers_every_parameter(pair):
    _, params, pm, _ = pair
    sd = state_dict_from_flax(pm.config,
                              jax.tree_util.tree_map(np.asarray, params))
    assert sorted(sd) == sorted(pm.state_dict())
    assert sd["blocks.1.attn.q_proj.weight"].shape == \
        (pm.config.n_embd, pm.config.n_embd)
    np.testing.assert_array_equal(
        sd["blocks.1.attn.q_proj.weight"].numpy(),
        np.asarray(params["blocks"]["block"]["attn"]["q_proj"]["kernel"][1]).T)


def test_logits_match(pair):
    jm, params, pm, ids = pair
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               method=jm.logits))
    got = pm.logits(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_prefill_cache_and_decode_steps_match(pair):
    """Cache contents after ``prefill``, then 4 decode steps with per-slot
    (B,) starts (row 1 sits 3 positions behind row 0) give equal logits;
    the JAX cache (L, B, KV, D, S) is compared through its transpose."""
    jm, params, pm, ids = pair
    jl, jvars = jm.apply({"params": params}, jnp.asarray(ids),
                         method=jm.prefill, mutable=["cache"])
    pl, cache = pm.prefill(torch.from_numpy(ids).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jcache = jvars["cache"]
    for side in ("k", "v"):
        want = np.asarray(jcache["cache_store"][side]).transpose(0, 1, 2, 4, 3)
        np.testing.assert_allclose(cache[side].numpy(), want, atol=ATOL,
                                   rtol=0)
    T = ids.shape[1]
    starts = np.array([T, T - 3], np.int32)
    # the JAX cache offset is the stored per-slot index, as in its slot pool
    jcache = {"cache_store": {**jcache["cache_store"],
                              "index": jnp.asarray(starts)}}
    toks = np.random.default_rng(5).integers(0, 64, (4, 2, 1)).astype(np.int32)
    for step in range(4):
        jl, jvars = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(toks[step]), jnp.asarray(starts),
                             method=jm.decode, mutable=["cache"])
        jcache = jvars["cache"]
        got = pm.decode(torch.from_numpy(toks[step]).long(), starts, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
        starts = starts + 1


def test_alibi_preset_prefill_and_decode_match():
    """bloom: ALiBi on the plain fresh path and in the decode kernel (the
    flash kernel has no bias hook, so ALiBi prefill stays plain)."""
    jm, params, pm, ids = _pair("bloom", use_flash_attention=False)
    jl, jvars = jm.apply({"params": params}, jnp.asarray(ids),
                         method=jm.prefill, mutable=["cache"])
    pl, cache = pm.prefill(torch.from_numpy(ids).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.array([[3], [7]], np.int32)
    starts = np.array([10, 5], np.int32)
    jcache = {"cache_store": {**jvars["cache"]["cache_store"],
                              "index": jnp.asarray(starts)}}
    jd, _ = jm.apply({"params": params, "cache": jcache},
                     jnp.asarray(tok), jnp.asarray(starts), method=jm.decode,
                     mutable=["cache"])
    got = pm.decode(torch.from_numpy(tok).long(), starts, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=0)


def test_later_slices_raise():
    cfg = P.transformer_config("gpt2", vocab_size=64, max_seq_len=64,
                               n_embd=32, n_layer=1, n_head=4,
                               dtype=torch.float32)
    # int8 weights, the int8 KV cache and the JAX engine's int8 storage
    # tier (here: fp32 with quantization on; tests/test_torch_storage_tier.py
    # holds it against JAX) are ported
    for ported in (dict(int8_weights=True), dict(kv_cache_quant=True)):
        P.TransformerLM(dataclasses.replace(cfg, **ported))
    eng = dst.init_inference(P.TransformerLM(cfg), device="cpu",
                             config={"dtype": "float32",
                                     "quant": {"enabled": True}})
    stored = eng.module.embed_tokens.parametrizations.weight.original
    assert stored.dtype == torch.int8
    pm = P.TransformerLM(cfg)
    _, cache = pm.prefill(torch.zeros(1, 4, dtype=torch.long))
    # multi-token decode is ported: two tokens at once equal two steps
    two = pm.decode(torch.tensor([[3, 5]]), 4,
                    {k: v.clone() for k, v in cache.items()})
    one = [pm.decode(torch.tensor([[t]]), 4 + i, cache)
           for i, t in enumerate((3, 5))]
    torch.testing.assert_close(two, torch.cat(one, dim=1), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="query rows"):
        pages = pm.kv_cache_spec().paged_cache(4, 16)
        pm.decode_paged(torch.zeros(1, 9, dtype=torch.long), 0, pages,
                        torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="alibi"):
        P.TransformerLM(dataclasses.replace(
            cfg, pos_emb="alibi", use_flash_attention=True)).logits(
                torch.zeros(1, 4, dtype=torch.long))
