"""The port's streaming loss against the JAX package's.

``chunked_softmax_xent``: the same numpy inputs through the JAX function
and the port's give the same summed loss and the same gradients in ``x``
and ``w`` (fp32, 1e-5 relative to each array's largest element), also where
the chunk does not divide T (the padded positions are masked).

``loss_chunk`` in GPT-2: the port's model gives the dense loss and the
dense gradients from the streaming path, and both losses equal the JAX
model's streamed loss on the same weights through the bridge (fp32: only
the summation order differs, so 1e-5 relative). ``TransformerLM``'s
streamed and dense losses (tied and untied heads) are held against the
JAX model's, gradients included, in ``test_torch_llama_training.py``. The
int8 guard of the JAX ``TransformerLM`` (an int8-quantized untied head
cannot be streamed) fires for the untied head only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as JG
from deepspeed_tpu.ops.transformer.chunked_xent import \
    chunked_softmax_xent as jax_xent
from deepspeed_tpu_torch.checkpoint.flax_import import \
    gpt2_state_dict_from_flax
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as PT
from deepspeed_tpu_torch.ops.transformer.chunked_xent import \
    chunked_softmax_xent

from _torch_threads import one_thread  # noqa: F401

RTOL = 1e-5
V, C = 97, 16


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, f"{what}: {err}"


@pytest.mark.parametrize("T,chunk", [(16, 4), (13, 5), (12, 32)])
def test_streaming_loss_and_gradients_match_jax(T, chunk):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    w = rng.standard_normal((V, C)).astype(np.float32)
    tgt = rng.integers(0, V, (2, T)).astype(np.int32)
    mask = (rng.random((2, T)) > 0.2).astype(np.float32)
    jl, (jgx, jgw) = jax.jit(jax.value_and_grad(
        lambda a, b: jax_xent(a, b, tgt, mask, chunk), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    loss = chunked_softmax_xent(xt, wt, torch.from_numpy(tgt),
                                torch.from_numpy(mask), chunk)
    loss.backward()
    _close(loss.item(), float(jl), "loss")
    _close(xt.grad.numpy(), jgx, "d loss / d x")
    _close(wt.grad.numpy(), jgw, "d loss / d w")


def _batch(T=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (2, T)).astype(np.int32)
    labels = ids.copy()
    labels[0, -3:] = -100
    return {"input_ids": ids, "labels": labels}


def _loss_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = model(batch)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in
                         model.named_parameters()}


def _hold_chunked_against_dense(model, batch, jax_loss):
    dense_loss, dense = _loss_grads(model, batch)
    model.replace_config(loss_chunk=5)
    loss, grads = _loss_grads(model, batch)
    _close(loss, dense_loss, "chunked vs dense loss")
    _close(dense_loss, jax_loss, "port dense loss vs JAX")
    _close(loss, jax_loss, "port chunked loss vs JAX")
    for k, g in grads.items():
        _close(g.numpy(), dense[k].numpy(), f"chunked vs dense grad {k}")


def _random_params(model, ids, seed):
    """A flax params tree for ``model`` from numpy (N(0, 0.02), norm scales
    1): its shapes by ``jax.eval_shape``, so no init program is compiled."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, {"input_ids": ids}))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.02, s.shape).astype(s.dtype), shapes)


def _jax_loss(model, params, batch, chunk):
    model = type(model)(dataclasses.replace(model.config, loss_chunk=chunk))
    return float(jax.jit(lambda p: model.apply(
        {"params": p}, {k: jnp.asarray(v) for k, v in batch.items()}))(
            params))


def test_gpt2_chunked_equals_dense_and_jax():
    jcfg = JG.GPT2Config(vocab_size=V, n_positions=16, n_embd=32, n_layer=2,
                         n_head=2, dtype=jnp.float32,
                         use_flash_attention=False)
    jm = JG.GPT2LMHeadModel(jcfg)
    batch = _batch()
    params = _random_params(jm, jnp.asarray(batch["input_ids"]), 0)
    jax_loss = _jax_loss(jm, params, batch, 5)
    pcfg = PG.GPT2Config(vocab_size=V, n_positions=16, n_embd=32, n_layer=2,
                         n_head=2, dtype=torch.float32)
    pm = PG.GPT2LMHeadModel(pcfg)
    pm.load_state_dict(gpt2_state_dict_from_flax(
        pcfg, jax.tree_util.tree_map(np.asarray, params)))
    _hold_chunked_against_dense(pm, batch, jax_loss)


@pytest.mark.parametrize("tied", [True, False])
def test_int8_head_guard_fires_for_the_untied_head_only(tied):
    cfg = PT.transformer_config(
        "llama", vocab_size=V, max_seq_len=16, n_embd=32, n_layer=1,
        n_head=2, dtype=torch.float32, int8_weights=True, int8_head=True,
        tie_word_embeddings=tied, loss_chunk=4)
    model = PT.TransformerLM(cfg)
    with torch.no_grad():
        if tied:
            assert np.isfinite(model(_batch()).item())
        else:
            with pytest.raises(ValueError, match="loss_chunk does not "
                               "compose with an int8-quantized untied "
                               "lm_head"):
                model(_batch())
