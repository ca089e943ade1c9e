"""ZeRO-Infinity parameter offload in the port (``runtime/zero/
param_offload.py``: the blocks' weights streamed through the device a layer
at a time, the host Adam over every parameter) against the JAX engine's
``offload_param`` path.

Three tiny models get random weights in the JAX module's tree, which cross
the weight bridge: a tied ``TransformerLM`` (the gpt2 preset), an untied
GQA llama (4 query heads over 2 KV heads) and ``GPT2LMHeadModel`` (n_embd
32, 2 layers, vocab 64, 16 positions). Both engines (the JAX one on a
one-device mesh) run ``train_batch`` over the same 3 batches: micro 2 x
gas 2, AdamW with weight decay, clipping at 0.5 (the host-side clip
scales every step here), ``offload_param: cpu``. fp32, so only summation
order differs: losses within 1e-5 relative, every parameter after the 3
steps within the JAX offload tests' rtol = atol = 2e-4.

On the llama the port's NVMe store (``offload_param: nvme`` with
``offload_optimizer: nvme``) and NVMe moments only (``swap_master:
false``) are bit-equal to the ``cpu`` tier. Port-only: with dropout, the
streamed step's loss and every gradient equal the resident model's run with
the same per-(micro-batch, layer) seeds, so the backward's recompute draws
the forward's masks; bf16 parameter offload tracks bf16 optimizer offload;
a checkpoint round trip resumes bit-equal; ``check_supported`` refuses
optimizers other than Adam, fp16, other modules and the eager API.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as JG
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.parallel import initialize_mesh
from deepspeed_tpu_torch.checkpoint.flax_import import (
    gpt2_state_dict_from_flax, state_dict_from_flax)
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.runtime.zero import offload as offload_mod
from deepspeed_tpu_torch.runtime.zero.param_offload import layer_seeds

from _torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
PARAM_TOL = 2e-4
V, T = 64, 16
LM = dict(vocab_size=V, max_seq_len=T, n_embd=32, n_layer=2, n_head=4)
GPT2 = dict(vocab_size=V, n_positions=T, n_embd=32, n_layer=2, n_head=2)
CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "zero_optimization": {"stage": 0, "offload_param": {"device": "cpu"}},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
    "gradient_clipping": 0.5, "steps_per_print": 100,
}
MODELS = {
    "tied": ("gpt2", dict(LM)),
    "llama": ("llama", dict(LM, n_kv_head=2)),
    "gpt2": (None, dict(GPT2)),
}


def _batches(n=3):
    rng = np.random.default_rng(1)
    return [{"input_ids": rng.integers(0, V, (4, T)).astype(np.int32)}
            for _ in range(n)]


def _random_params(model, ids, seed):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, {"input_ids": ids}))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.02, s.shape).astype(s.dtype), shapes)


def _jax_model(kind):
    family, fields = MODELS[kind]
    if family is None:
        return JG.GPT2LMHeadModel(JG.GPT2Config(**fields, dtype=jnp.float32))
    return J.TransformerLM(J.transformer_config(
        family, **fields, dtype=jnp.float32, use_flash_attention=False))


def _port_model(kind, params=None, seed=0, **overrides):
    family, fields = MODELS[kind]
    if family is None:
        cfg = PG.GPT2Config(**fields, dtype=torch.float32, **overrides)
        model = PG.GPT2LMHeadModel(cfg)
        bridge = gpt2_state_dict_from_flax
    else:
        cfg = P.transformer_config(family, **fields, dtype=torch.float32,
                                   **overrides)
        model = P.TransformerLM(cfg)
        bridge = state_dict_from_flax
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(bridge(cfg, params))
    return model, bridge


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: its JAX params, and the JAX parameter-offload engine's
    losses and parameters after 3 steps."""
    out = {}
    batches = _batches()
    for kind in MODELS:
        model = _jax_model(kind)
        params = _random_params(model, jnp.asarray(batches[0]["input_ids"]),
                                4)
        engine, *_ = ds.initialize(
            model=model, model_parameters=jax.tree_util.tree_map(np.array,
                                                                 params),
            config=CONFIG, mesh=initialize_mesh(devices=jax.devices()[:1]))
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        final = jax.tree_util.tree_map(
            np.asarray, engine._param_offload.full_params_tree())
        out[kind] = (params, losses, final)
    return out


def _engine(model, zero=None, **extra):
    config = dict(CONFIG, **extra)
    if zero is not None:
        config["zero_optimization"] = zero
    engine, *_ = dst.initialize(model=model, config=config, device="cpu")
    return engine


def _train(engine, batches):
    return [float(engine.train_batch(batch=b)) for b in batches]


def _assert_params(got, want, tol):
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        np.testing.assert_allclose(val.float().numpy(),
                                   want[name].float().numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("kind", list(MODELS))
def test_streamed_training_matches_the_jax_engine(jax_runs, kind):
    params, jlosses, jfinal = jax_runs[kind]
    model, bridge = _port_model(kind, params)
    engine = _engine(model)
    runner = engine._param_offload
    assert all(p.is_meta for n, p in model.named_parameters()
               if n.startswith("blocks."))
    losses = _train(engine, _batches())
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_params(runner.full_state_dict(), bridge(model.config, jfinal),
                   PARAM_TOL)
    t = runner.last_timings
    assert t["forward_stream_s"] > 0 and t["backward_stream_s"] > 0
    assert runner.store.streamed_bytes == \
        3 * 2 * 2 * 2 * runner.store.layer_nbytes


def test_nvme_tiers_are_bit_equal_to_the_cpu_tier(jax_runs, tmp_path):
    params = jax_runs["llama"][0]
    runs = {}
    for tier, zero in (
            ("cpu", None),
            ("nvme", {"stage": 0, "offload_param": {
                "device": "nvme", "nvme_path": str(tmp_path / "p")},
                "offload_optimizer": {"device": "nvme",
                                      "nvme_path": str(tmp_path / "o")}}),
            ("moments", {"stage": 0, "offload_param": {"device": "cpu"},
                         "offload_optimizer": {
                             "device": "nvme", "swap_master": False,
                             "nvme_path": str(tmp_path / "m")}})):
        engine = _engine(_port_model("llama", params)[0], zero)
        runs[tier] = (_train(engine, _batches()),
                      engine._param_offload.full_state_dict(), engine)
    for tier in ("nvme", "moments"):
        assert runs[tier][0] == runs["cpu"][0]
        for k, v in runs["cpu"][1].items():
            assert torch.equal(runs[tier][1][k], v), (tier, k)
    store = runs["nvme"][2]._param_offload.store
    assert store.layers is None and store.nvme
    assert sorted(p.name for p in (tmp_path / "p").glob("layer_*.bin")) == \
        ["layer_00000.bin", "layer_00001.bin"]
    opt = runs["moments"][2]._param_offload.opt
    assert opt.nvme and not opt.swap_master
    assert all(opt.master[k] is not None and opt.m[k] is None
               for k in opt.m)
    assert not list((tmp_path / "m").glob("*.master.bin"))


def test_dropout_recompute_draws_the_forward_masks(monkeypatch):
    """gas 1, no clip: the gradients the host step receives are one
    micro-batch's, held against the resident model with the runner's
    seeds."""
    seen = {}
    real = offload_mod.OffloadedOptimizer.step

    def spy(self, grads, *args, keys=None, **kwargs):
        seen.update({k: grads[k].clone() for k in keys})
        return real(self, grads, *args, keys=keys, **kwargs)

    monkeypatch.setattr(offload_mod.OffloadedOptimizer, "step", spy)
    batch = _batches(1)[0]
    batch = {"input_ids": batch["input_ids"][:2]}
    model = _port_model("llama", seed=3, dropout=0.2)[0]
    ref = _port_model("llama", seed=3, dropout=0.2)[0]
    engine = _engine(model, gradient_accumulation_steps=1,
                     gradient_clipping=0.0)
    loss = float(engine.train_batch(batch=batch))
    ids = torch.as_tensor(batch["input_ids"]).long()
    pos = ref._positions(*ids.shape)

    def ref_loss(seeds):
        x = ref._embed(ids, pos)
        for blk, s in zip(ref.blocks, seeds):
            x = blk(x, pos, seed=s)
        return ref.loss_from_hidden(ref.ln_f(x), batch, chunk=0)

    seeds = layer_seeds(engine._config.seed, 0, 1, 2)[0]
    want = ref_loss(seeds)
    want.backward()
    assert abs(loss - want.item()) <= 1e-6 * abs(want.item())
    for name, p in ref.named_parameters():
        g = p.grad
        err = (seen[name].reshape(g.shape) - g).abs().max().item()
        assert err <= 1e-5 * g.abs().max().item(), name
    with torch.no_grad():
        assert ref_loss([s + 1 for s in seeds]).item() != want.item()


def test_bf16_parameter_offload_tracks_bf16_optimizer_offload(jax_runs):
    params = jax_runs["llama"][0]
    bf16 = {"bf16": {"enabled": True}}
    streamed = _train(_engine(_port_model("llama", params)[0], **bf16),
                      _batches())
    resident = _train(_engine(_port_model("llama", params)[0],
                              {"stage": 2,
                               "offload_optimizer": {"device": "cpu"}},
                              **bf16), _batches())
    np.testing.assert_allclose(streamed, resident, rtol=2e-3)


def test_checkpoint_round_trip_resumes(jax_runs, tmp_path):
    params = jax_runs["tied"][0]
    batches = _batches(4)
    saver = _engine(_port_model("tied", params)[0])
    _train(saver, batches[:2])
    saver.save_checkpoint(str(tmp_path))
    loader = _engine(_port_model("tied", seed=8)[0])
    loader.load_checkpoint(str(tmp_path))
    evaluate = saver.eval_batch_fn()
    assert float(evaluate(batches[2])) == \
        float(loader.eval_batch_fn()(batches[2]))
    for kind in ("master", "m", "v"):
        a = saver._offload_opt.state_dict()[kind]
        b = loader._offload_opt.state_dict()[kind]
        assert all(torch.equal(a[k], b[k]) for k in a), kind
    assert _train(loader, batches[2:]) == _train(saver, batches[2:])


def test_check_supported_refusals():
    model = _port_model("tied", seed=0)[0]
    with pytest.raises(ValueError, match="Adam"):
        _engine(model, optimizer={"type": "SGD", "params": {"lr": 1e-3}})
    with pytest.raises(ValueError, match="bf16/fp32"):
        _engine(model, fp16={"enabled": True})

    class Other(torch.nn.Module):
        def forward(self, batch):
            return torch.zeros(())

    with pytest.raises(ValueError, match="TransformerLM and GPT2LMHeadModel"):
        _engine(Other())
    engine = _engine(model)
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.forward(_batches(1)[0])
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.step()
    cfg = dataclasses.replace(model.config)
    assert cfg.n_layer == 2
