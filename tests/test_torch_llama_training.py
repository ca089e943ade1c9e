"""The port's ``TransformerLM`` trains: its loss against the JAX model's.

A tiny llama (vocab 97, n_embd 32, 2 layers, 4 query heads over 2 KV heads,
RMSNorm, rotary, SwiGLU, untied head; fp32) gets random weights in the JAX
module's tree, which cross the weight bridge. The JAX side runs its einsum
attention (no Pallas); the port runs ``use_flash_attention="auto"`` with
``remat=True``, so its attention is the flash operator's plain versions on
the CPU (K/V at their 2 heads, the dk/dv plain version summing each group)
inside checkpointed blocks. fp32 throughout, so only summation order
differs:

* the loss, dense and streamed (``loss_chunk=5``), and every parameter's
  gradient agree within 1e-5 relative to the JAX array's largest element;
  the tied head (the same weights without ``lm_head``) too; the streamed
  loss equals the port's dense one;
* three ``train_batch`` calls of a port engine equal the JAX engine's (one
  device, the same config as ``test_torch_training.py``: Adam with weight
  decay, WarmupLR, clipping 1.0, gas 2, ZeRO 2): losses within 1e-5
  relative, every parameter after them within 2e-6 absolute (an Adam step
  moves an element by up to lr = 5e-4).

Port-only: with ``dropout > 0`` a rematerialized model draws the same masks
as one that keeps its activations (same loss and gradients, exactly), and
the flash rule keeps dropout on the einsum path in training, as the JAX
``_use_flash`` does.
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
from deepspeed_tpu.parallel import initialize_mesh
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P

RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
TINY = dict(vocab_size=97, max_seq_len=16, n_embd=32, n_layer=2, n_head=4,
            n_kv_head=2, dtype=jnp.float32, use_flash_attention=False)
CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 4,
        "warmup_type": "linear"}},
    "gradient_clipping": 1.0, "steps_per_print": 100,
}


def _batches(n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 97, (4, 16)).astype(np.int32)
        labels = ids.copy()
        labels[1, -4:] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny models: with PyTorch's default of
    a thread a core, the suite's six workers oversubscribe the cores and
    tiny CPU ops run tens of times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_side():
    """(JAX config, numpy params of the untied model)."""
    cfg = J.transformer_config("llama", **TINY)
    ids = jnp.asarray(_batches(1)[0]["input_ids"])
    return cfg, _random_params(J.TransformerLM(cfg), ids, 3)


def _port_config(jcfg, **overrides):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update({"use_flash_attention": "auto", "remat": True,
                   **overrides})
    return P.TransformerConfig(**fields)


def _port_model(jcfg, params, **overrides):
    cfg = _port_config(jcfg, **overrides)
    model = P.TransformerLM(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, params))
    return model


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, f"{what}: {err}"


@pytest.mark.parametrize("tied,chunk", [(False, 0), (False, 5), (True, 5)])
def test_loss_and_every_gradient_match_jax(jax_side, tied, chunk):
    jcfg, params = jax_side
    if tied:
        params = {k: v for k, v in params.items() if k != "lm_head"}
    jcfg = dataclasses.replace(jcfg, tie_word_embeddings=tied,
                               loss_chunk=chunk)
    jm = J.TransformerLM(jcfg)
    batch = _batches(1)[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, _jax_batch(batch))))(params)
    pm = _port_model(jcfg, params)
    loss = pm(batch)
    loss.backward()
    _close(loss.item(), float(jl), "loss")
    want = state_dict_from_flax(pm.config,
                                jax.tree_util.tree_map(np.asarray, jg))
    grads = dict(pm.named_parameters())
    assert sorted(grads) == sorted(want)
    for name, p in grads.items():
        _close(p.grad.numpy(), want[name].numpy(), f"grad {name}")
    if chunk:
        # the streamed loss equals the port's own dense loss
        pm.replace_config(loss_chunk=0)
        with torch.no_grad():
            _close(pm(batch).item(), loss.item(), "dense vs streamed loss")


def test_three_train_batch_steps_match_the_jax_engine(jax_side):
    jcfg, params = jax_side
    mesh = initialize_mesh(devices=jax.devices()[:1])
    jengine, *_ = ds.initialize(model=J.TransformerLM(jcfg),
                                model_parameters=params, config=CONFIG,
                                mesh=mesh)
    jlosses = [float(jengine.train_batch(batch=b)) for b in _batches()]
    cfg = _port_config(jcfg)
    engine, *_ = dst.initialize(
        model=P.TransformerLM(cfg), config=CONFIG, device="cpu",
        model_parameters=state_dict_from_flax(cfg, params))
    losses = [float(engine.train_batch(batch=b)) for b in _batches()]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = state_dict_from_flax(cfg, jax.tree_util.tree_map(
        np.asarray, jengine.state["params"]))
    got = engine.module.state_dict()
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        diff = (val - want[name]).abs().max().item()
        assert diff <= PARAM_ATOL, f"{name}: {diff}"
    assert engine.global_steps == 3 and engine.micro_steps == 6


def test_remat_recomputes_the_same_dropout_masks(jax_side):
    jcfg, params = jax_side
    runs = []
    for remat in (False, True):
        model = _port_model(jcfg, params, dropout=0.1, remat=remat)
        model.seed_dropout(7)
        loss = model(_batches(1)[0])
        loss.backward()
        runs.append((loss.item(), {k: p.grad for k, p in
                                   model.named_parameters()}))
    (plain_loss, plain), (remat_loss, remat) = runs
    assert remat_loss == plain_loss
    for name, g in plain.items():
        assert torch.equal(remat[name], g), name
    # deterministic (eval) forwards draw no masks
    model.seed_dropout(7)
    with torch.no_grad():
        a = model(_batches(1)[0], deterministic=True).item()
        b = model(_batches(1)[0], deterministic=True).item()
    assert a == b != plain_loss


def test_flash_rule_keeps_training_dropout_on_the_einsum_path(
        jax_side, monkeypatch):
    jcfg, params = jax_side
    calls = []
    real = P.flash_attention
    monkeypatch.setattr(P, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = _port_model(jcfg, params, dropout=0.1, remat=False)
    model(_batches(1)[0])                       # training: einsum path
    assert calls == []
    model(_batches(1)[0], deterministic=True)   # no dropout: the kernel
    assert len(calls) == jcfg.n_layer
    model.replace_config(use_flash_attention=True)
    with pytest.raises(ValueError, match="dropout in train mode"):
        model(_batches(1)[0])
