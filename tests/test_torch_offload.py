"""ZeRO-Offload in the port: the optimizer state on the host or on disk
(``runtime/zero/offload.py``, the engine's ``offload_optimizer`` path)
against the JAX engine's, and its checkpoints.

A tiny llama (vocab 64, n_embd 32, 2 layers, 4 query heads over 2 KV heads,
untied head) gets random weights in the JAX module's tree, which cross the
weight bridge; both engines run ``train_batch`` over the same 3 batches
(micro 2 x gas 2, AdamW with weight decay, WarmupLR, clipping 1.0, ZeRO 2,
``offload_optimizer`` on; the JAX engine on a one-device mesh):

* fp32: losses within 1e-5 relative, every parameter after the 3 steps
  within the JAX offload tests' rtol = atol = 2e-4, for the port's ``cpu``
  and ``nvme`` tiers; the ``nvme`` tier (and its ``swap_master: false``
  variant) bit-equal to the ``cpu`` tier: the same host op on the same
  values, and the files hold fp32 exactly;
* bf16 with fp32 masters: losses and the host masters within 2e-3;
* the port with offload against the port without, within 2e-4 (the JAX
  ``test_offload_cpu_matches_fused``); fp16 overflow skips the host step;
  the eager ``forward``/``backward``/``step`` triple equals ``train_batch``.

Checkpoints: an offload engine's save and load restores the host master and
moments bit-equal and the resumed losses equal the unbroken run's;
``ds_to_universal`` keeps the moments (parameter-shaped) and loads into an
offload engine and an on-device one (the JAX
``test_universal_offload.py``); a JAX offload engine's checkpoint imports
through ``flax_import`` and resumes in the port.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.parallel import initialize_mesh
from deepspeed_tpu_torch.checkpoint import (ds_to_universal, load_universal,
                                            universal_dir)
from deepspeed_tpu_torch.checkpoint.flax_import import (
    engine_checkpoint_from_flax, state_dict_from_flax)
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine, checkpoint_meta_path, write_latest)

from _torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
PARAM_TOL = 2e-4            # the JAX offload tests' rtol = atol
BF16_TOL = 2e-3
V, T = 64, 16
LLAMA = dict(vocab_size=V, max_seq_len=T, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2)
CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                              "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 4,
        "warmup_type": "linear"}},
    "gradient_clipping": 1.0, "steps_per_print": 100,
}
BF16 = {"bf16": {"enabled": True}}


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, V, (4, T)).astype(np.int32)}
            for _ in range(n)]


def _random_params(model, ids, seed):
    """A flax params tree (N(0, 0.02), norm scales 1) from numpy; shapes by
    ``jax.eval_shape``, so no init program is compiled."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, {"input_ids": ids}))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.02, s.shape).astype(s.dtype), shapes)


def _zero(**offload):
    return {"stage": 2, "offload_optimizer": {"device": "cpu", **offload}}


def _jax_engine(cfg, params, config):
    # a copy: the JAX host optimizer adopts fp32 arrays as its master
    # (np.ascontiguousarray) and updates them in place
    params = jax.tree_util.tree_map(np.array, params)
    engine, *_ = ds.initialize(model=J.TransformerLM(cfg),
                               model_parameters=params, config=config,
                               mesh=initialize_mesh(devices=jax.devices()[:1]))
    return engine


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX offload engines: fp32 (a checkpoint after 2 steps, then the
    third) and bf16, 3 steps each: losses, parameters and host masters."""
    cfg = J.transformer_config("llama", **LLAMA, dtype=jnp.float32,
                               use_flash_attention=False)
    batches = _batches()
    params = _random_params(J.TransformerLM(cfg),
                            jnp.asarray(batches[0]["input_ids"]), 3)
    out = {"cfg": cfg, "params": params}
    ckpt = tmp_path_factory.mktemp("jax_offload_ckpt")
    for precision, extra in (("fp32", {}), ("bf16", BF16)):
        engine = _jax_engine(cfg, params, dict(CONFIG, **extra))
        losses = []
        for i, b in enumerate(batches):
            if i == 2 and precision == "fp32":
                engine.save_checkpoint(str(ckpt))
            losses.append(float(engine.train_batch(batch=b)))
        master = engine._offload_opt.state_dict()["master"]
        out[precision] = dict(
            losses=losses,
            params=jax.tree_util.tree_map(np.asarray,
                                          engine.state["params"]),
            master=jax.tree_util.tree_map(
                np.asarray, {k: master[k] for k in master}))
    out["ckpt"] = ckpt
    return out


def _port_config(jcfg, **overrides):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields.update({"use_flash_attention": "auto", **overrides})
    return P.TransformerConfig(**fields)


def _port_engine(jax_side, zero=None, precision="fp32", seed=None, **extra):
    cfg = _port_config(jax_side["cfg"])
    model = P.TransformerLM(cfg)
    if seed is None:
        model.load_state_dict(state_dict_from_flax(cfg, jax_side["params"]))
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    config = dict(CONFIG, zero_optimization=zero or _zero(),
                  **(BF16 if precision == "bf16" else {}), **extra)
    engine, *_ = dst.initialize(model=model, config=config, device="cpu")
    return engine


def _train(engine, batches):
    return [float(engine.train_batch(batch=b)) for b in batches]


def _bridged(cfg, tree):
    return state_dict_from_flax(dataclasses.replace(cfg, dtype=torch.float32),
                                tree)


def _unflatten_paths(flat):
    out = {}
    for path, leaf in flat.items():
        d = out
        *mods, name = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[name] = leaf
    return out


def _assert_params(got, want, tol):
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        np.testing.assert_allclose(val.float().numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def _host_state(engine):
    sd = engine._offload_opt.state_dict()
    return {kind: {k: v.clone() for k, v in tree.items()}
            for kind, tree in sd.items()}


def _assert_state_equal(a, b):
    for kind in ("master", "m", "v"):
        assert sorted(a[kind]) == sorted(b[kind])
        for k in a[kind]:
            assert torch.equal(a[kind][k], b[kind][k]), (kind, k)


def test_cpu_and_nvme_tiers_match_the_jax_engine(jax_side, tmp_path):
    want = jax_side["fp32"]
    cfg = _port_config(jax_side["cfg"])
    runs = {}
    for tier, zero in (("cpu", _zero()),
                       ("nvme", _zero(device="nvme",
                                      nvme_path=str(tmp_path / "a"))),
                       ("moments", _zero(device="nvme", swap_master=False,
                                         nvme_path=str(tmp_path / "b")))):
        engine = _port_engine(jax_side, zero)
        assert engine.master is None and engine.opt_state is None
        losses = _train(engine, _batches())
        np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
        _assert_params(engine.module.state_dict(),
                       _bridged(cfg, want["params"]), PARAM_TOL)
        runs[tier] = (losses, engine.module.state_dict(), _host_state(engine),
                      engine)
    for tier in ("nvme", "moments"):
        assert runs[tier][0] == runs["cpu"][0]
        for k, v in runs["cpu"][1].items():
            assert torch.equal(runs[tier][1][k], v), (tier, k)
        _assert_state_equal(runs[tier][2], runs["cpu"][2])
    files = os.listdir(tmp_path / "a")
    opt = runs["nvme"][3]._offload_opt
    assert len(files) == 3 * len(opt.master)
    name = next(iter(opt.master))
    assert os.path.getsize(opt.leaf_file(name, "m")) == 4 * opt.numel([name])
    assert all(opt.m[k] is None and opt.master[k] is None for k in opt.m)
    moments = runs["moments"][3]._offload_opt
    assert not any(f.endswith(".master.bin")
                   for f in os.listdir(tmp_path / "b"))
    assert all(moments.master[k] is not None and moments.m[k] is None
               for k in moments.m)
    assert opt.last_timings.keys() == {"swap_in_s", "compute_s", "drain_s"}


def test_bf16_with_fp32_masters_matches_the_jax_engine(jax_side):
    want = jax_side["bf16"]
    engine = _port_engine(jax_side, precision="bf16")
    losses = _train(engine, _batches())
    np.testing.assert_allclose(losses, want["losses"], rtol=BF16_TOL)
    cfg = _port_config(jax_side["cfg"])
    master = _bridged(cfg, _unflatten_paths(want["master"]))
    _assert_params(engine._offload_opt.state_dict()["master"], master,
                   BF16_TOL)
    for name, p in engine.module.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), engine._offload_opt.master[name].to(
            torch.bfloat16)), name


def test_offload_matches_the_device_optimizer(jax_side):
    off = _train(_port_engine(jax_side), _batches())
    on = _train(_port_engine(jax_side, {"stage": 2}), _batches())
    np.testing.assert_allclose(off, on, rtol=2e-4, atol=2e-4)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, batch):
        x = torch.as_tensor(batch["x"], device=self.w.device)
        return (x.to(self.w.dtype) * self.w).float().sum()


def test_fp16_overflow_skips_the_host_step():
    engine, *_ = dst.initialize(model=_Linear(), device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "fp16": {
            "enabled": True, "initial_scale_power": 4},
        "zero_optimization": _zero(),
        "optimizer": {"type": "Adam", "params": {"lr": 0.5}}})
    good = {"x": np.ones((2, 4), np.float32)}
    bad = {"x": np.full((2, 4), np.inf, np.float32)}
    opt = engine._offload_opt
    for batch, overflow in ((good, False), (bad, True), (good, False)):
        before = {k: t.clone() for k, t in _host_state(engine)["m"].items()}
        engine.train_batch(batch=batch)
        moved = not torch.equal(opt.m["w"], before["w"])
        assert moved is not overflow
    assert engine.skipped_steps == 1 and engine._opt_step == 2
    assert engine.global_steps == 3


def test_eager_triple_equals_train_batch(jax_side):
    batches = _batches()
    ref = _port_engine(jax_side)
    want = _train(ref, batches)
    engine = _port_engine(jax_side)
    for b in batches:
        for i in range(2):
            loss = engine.forward({"input_ids": b["input_ids"][2 * i:
                                                              2 * i + 2]})
            engine.backward(loss)
            engine.step()
    assert engine.global_steps == 3 and engine._opt_step == 3
    for k, v in ref.module.state_dict().items():
        assert torch.equal(engine.module.state_dict()[k], v), k
    _assert_state_equal(_host_state(engine), _host_state(ref))
    assert len(want) == 3


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_save_load_restores_host_state_and_resumes(jax_side, tmp_path, tier):
    def zero(sub):
        return _zero(device="nvme", nvme_path=str(tmp_path / sub)) \
            if tier == "nvme" else _zero()

    batches = _batches(4)
    saver = _port_engine(jax_side, zero("saver"))
    _train(saver, batches[:2])
    saver.save_checkpoint(str(tmp_path / "ck"))
    saved = _host_state(saver)
    loader = _port_engine(jax_side, zero("loader"), seed=9)
    loader.load_checkpoint(str(tmp_path / "ck"))
    _assert_state_equal(_host_state(loader), saved)
    assert loader._opt_step == 2 and loader.global_steps == 2
    assert _train(loader, batches[2:]) == _train(saver, batches[2:])
    # module only: the host master is re-seeded from the loaded module
    fresh = _port_engine(jax_side, zero("fresh"), seed=11)
    fresh.load_checkpoint(str(tmp_path / "ck"), load_module_only=True)
    for name, p in fresh.module.named_parameters():
        assert torch.equal(fresh._offload_opt.read_leaf("master", name), p)


def test_universal_checkpoint_keeps_the_moments(jax_side, tmp_path):
    batches = _batches(4)
    engine = _port_engine(jax_side, precision="bf16")
    _train(engine, batches[:2])
    engine.save_checkpoint(str(tmp_path))
    blob = load_universal(ds_to_universal(str(tmp_path)))
    assert sorted(blob["opt"]) == ["exp_avg", "exp_avg_sq"]
    for name, p in engine.module.named_parameters():
        m = blob["opt"]["exp_avg"][name]
        assert m.shape == tuple(p.shape) and np.abs(m).sum() > 0
        assert torch.equal(torch.as_tensor(m).reshape(-1),
                           engine._offload_opt.m[name])
    univ = {"checkpoint": {"load_universal": True}}
    offload = _port_engine(jax_side, precision="bf16", seed=4, **univ)
    offload.load_checkpoint(str(tmp_path))
    assert any(t.abs().sum() > 0 for t in offload._offload_opt.m.values())
    _assert_state_equal(_host_state(offload), _host_state(engine))
    device = _port_engine(jax_side, {"stage": 0}, precision="bf16", seed=4,
                          **univ)
    device.load_checkpoint(str(tmp_path))
    for name, p in device.module.named_parameters():
        assert p.dtype == torch.bfloat16
    want = _train(engine, batches[2:])
    assert _train(offload, batches[2:]) == want
    np.testing.assert_allclose(_train(device, batches[2:]), want, rtol=1e-2)
    assert universal_dir(str(tmp_path), "global_step2").endswith(
        "global_step2_universal")


def test_jax_offload_checkpoint_resumes_in_the_port(jax_side, tmp_path):
    cfg = _port_config(jax_side["cfg"])
    sd = ArrayCheckpointEngine().load(checkpoint_meta_path(
        str(jax_side["ckpt"]), "global_step2", "model"))
    port_sd = engine_checkpoint_from_flax(cfg, sd)
    assert port_sd["master"] is None and port_sd["optimizer"] is None
    host = port_sd["offload_optimizer"]
    model = P.TransformerLM(cfg)
    assert sorted(host["master"]) == sorted(n for n, _ in
                                            model.named_parameters())
    for name, p in model.named_parameters():
        assert host["master"][name].shape == p.shape
        assert host["m"][name].shape == (p.numel(),)
    ArrayCheckpointEngine().save(
        port_sd, checkpoint_meta_path(str(tmp_path), "global_step2", "model"))
    write_latest(str(tmp_path), "global_step2")
    engine = _port_engine(jax_side, seed=5)
    engine.load_checkpoint(str(tmp_path))
    assert (engine.global_steps, engine._opt_step) == (2, 2)
    losses = _train(engine, _batches()[2:])
    np.testing.assert_allclose(losses, jax_side["fp32"]["losses"][2:],
                               rtol=LOSS_RTOL)
    _assert_params(engine.module.state_dict(),
                   _bridged(cfg, jax_side["fp32"]["params"]), PARAM_TOL)


def test_offload_refuses_optimizers_other_than_adam(jax_side):
    with pytest.raises(ValueError, match="Adam"):
        _port_engine(jax_side, optimizer={"type": "SGD",
                                          "params": {"lr": 1e-3}})


def test_nvme_unwind_and_single_leaf_io(tmp_path):
    """A failed read mid-step drops the unread leaf, so a retry reads its
    files again; the drain then reports the failed chunk too (the JAX
    handle counts it twice), so the finished leaf's host copy stays
    authoritative. ``read_leaf`` and ``write_leaf`` move one leaf whatever
    the swap state."""
    from deepspeed_tpu_torch.runtime.zero.offload import OffloadedOptimizer
    from deepspeed_tpu_torch.runtime.zero.offload_config import \
        DeepSpeedZeroOffloadOptimizerConfig

    params = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(5)}
    opt = OffloadedOptimizer(params, {"lr": 0.1}, (
        DeepSpeedZeroOffloadOptimizerConfig(device="nvme",
                                            nvme_path=str(tmp_path))))
    grads = {"a": torch.ones(6), "b": torch.ones(5)}
    b_file = opt.leaf_file("b", "m")
    os.rename(b_file, b_file + ".away")
    with pytest.raises(IOError):
        opt.step(dict(grads), 0.1, 1, torch.float32)
    assert opt.m["b"] is None and opt.master["b"] is None
    assert opt.m["a"] is not None
    moved = opt.read_leaf("master", "a")
    assert moved.shape == (2, 3) and not torch.equal(moved, params["a"])
    assert torch.equal(opt.read_leaf("master", "b"), params["b"])
    os.rename(b_file + ".away", b_file)
    opt.step(dict(grads), 0.1, 1, torch.float32, keys={"b"})
    assert not torch.equal(opt.read_leaf("master", "b"), params["b"])
    assert opt.write_leaf("v", "a", torch.full((2, 3), 7.0))
    assert torch.equal(opt.read_leaf("v", "a"), torch.full((2, 3), 7.0))
    assert not opt.write_leaf("v", "missing", torch.zeros(1))
    assert opt.read_leaf("m", "missing") is None
    opt.close()
