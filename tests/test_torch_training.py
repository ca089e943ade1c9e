"""The port's training engine against the JAX package's.

One JAX engine and one port engine train the same tiny GPT-2 (vocab 128,
n_embd 128, 2 layers, 4 heads, T = 64), whose JAX-initialised weights cross
through the weight bridge, on the same batches from numpy. The JAX engine
runs on a one-device mesh, so both split the global batch into the same
micro-batches. Config: fp32, Adam with weight decay 0.1, WarmupLR, clipping
1.0, gas 2, ZeRO stage 2. The losses of 3 ``train_batch`` calls agree
within 1e-5 relative and every parameter after them within 2e-6 absolute
(values are O(0.1); each Adam step moves an element by up to lr = 5e-4,
so a step taken in the wrong direction shows as 1e-4 or more). One slice
is exempt: the key third of each ``qkv`` bias has an analytically zero
gradient (adding a constant to every score of a row leaves the softmax
unchanged), so both engines feed Adam rounding noise, which it normalizes
to a step of ±lr in either direction; those elements are held to the sum
of the three steps' lr (7.5e-4), which still catches a wrong weight decay.
Two port engines that should compute the same (stage 0 against stage 2,
``forward``/``backward``/``step`` against ``train_batch``) are held to
1e-7 under the same rule. One CPU op moved their bits from run to run: the
backward of the embedding lookup ``wte[ids]`` is ``index_put_`` with
``accumulate=True``, which PyTorch's CPU kernel sums over its threads with
atomic adds, so under load (six test workers on eight cores) the order of
a token's gradient rows changed between engines, a last-bit difference
that Adam turned into up to 1.2e-7 of an ``ln`` weight. That test runs
with ``torch.use_deterministic_algorithms(True)`` (the sorted, serial
accumulation), restored afterwards; under the same load the engines were
then bit-equal in every run.

The lr schedules are held against the JAX ones within 1e-6 relative (the
JAX package computes in float32), ``update_scale`` against the JAX function
exactly, on a scripted overflow sequence, and each optimizer's update over
four steps against the JAX ``OptimizerDef`` within 1e-6 absolute plus
1e-6 relative on unit-scale parameters (fp32 rounding of the same ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as J
from deepspeed_tpu.ops import optimizers as JO
from deepspeed_tpu.parallel import initialize_mesh
from deepspeed_tpu.runtime import lr_schedules as JL
from deepspeed_tpu.runtime.fp16 import loss_scaler as JS
from deepspeed_tpu_torch.checkpoint.flax_import import \
    gpt2_state_dict_from_flax
from deepspeed_tpu_torch.models import gpt2 as P
from deepspeed_tpu_torch.ops import optimizers as PO
from deepspeed_tpu_torch.runtime import lr_schedules as PL
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as PS

from _torch_threads import one_thread  # noqa: F401


LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
SAME_ATOL = 1e-7
KEY_BIAS_ATOL = 7.5e-4      # lr summed over the three steps
TINY = dict(vocab_size=128, n_positions=64, n_embd=128, n_layer=2, n_head=4)
CONFIG = {
    "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                             "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 4,
        "warmup_type": "linear"}},
    "gradient_clipping": 1.0, "steps_per_print": 100,
}
# bench.py's flagship config (bench.py:195-204), as the JAX bench passes it
BENCH_CONFIG = {
    "train_micro_batch_size_per_gpu": 10, "gradient_accumulation_steps": 16,
    "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
    "optimizer": {"type": "Adam", "params": {"lr": 3e-4,
                                             "weight_decay": 0.1}},
    "gradient_clipping": 1.0, "steps_per_print": 1000000,
}


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 128, (8, 64)).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    """(initial params, losses, final params) of the JAX engine, numpy."""
    model = J.GPT2LMHeadModel(J.GPT2Config(**TINY, dtype=jnp.float32,
                                           use_flash_attention=False))
    params = jax.tree_util.tree_map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(0)}, _batches(1)[0])["params"])
    mesh = initialize_mesh(devices=jax.devices()[:1])
    engine, *_ = ds.initialize(model=model, model_parameters=params,
                               config=CONFIG, mesh=mesh)
    losses = [float(engine.train_batch(batch=b)) for b in _batches()]
    final = jax.tree_util.tree_map(np.asarray, engine.state["params"])
    return params, losses, final


def _port_engine(params, config=CONFIG, **model_overrides):
    cfg = P.GPT2Config(**TINY, dtype=torch.float32, **model_overrides)
    model = P.GPT2LMHeadModel(cfg)
    engine, opt, loader, sched = dst.initialize(
        model=model, config=config, device="cpu",
        model_parameters=gpt2_state_dict_from_flax(cfg, params))
    return engine


def _state(engine):
    return {k: v.detach().clone() for k, v in engine.module.state_dict().items()}


def _assert_params_close(got, want, atol):
    assert sorted(got) == sorted(want)
    C = TINY["n_embd"]
    for key, val in got.items():
        diff = (val - want[key]).abs()
        if key.endswith("attn.qkv.bias"):
            key_slice = diff[C:2 * C].max().item()
            assert key_slice <= KEY_BIAS_ATOL, f"{key} keys: {key_slice}"
            diff = torch.cat([diff[:C], diff[2 * C:]])
        assert diff.max().item() <= atol, f"{key}: {diff.max().item()}"


def test_three_steps_match_the_jax_engine(jax_run):
    params, jlosses, jfinal = jax_run
    engine = _port_engine(params)
    losses = [float(engine.train_batch(batch=b)) for b in _batches()]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _assert_params_close(_state(engine), gpt2_state_dict_from_flax(
        engine.module.config, jfinal), PARAM_ATOL)
    assert (engine.global_steps, engine.micro_steps, engine.global_samples,
            engine.skipped_steps) == (3, 6, 24, 0)
    assert engine.get_lr() == [pytest.approx(7.5e-4)]


@pytest.fixture
def deterministic():
    """PyTorch's deterministic kernels for one test, restored after."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_stage0_equals_stage2_and_eager_equals_train_batch(jax_run,
                                                           deterministic):
    params = jax_run[0]
    ref = _port_engine(params)
    for b in _batches():
        ref.train_batch(batch=b)
    stage0 = _port_engine(params, config=dict(
        CONFIG, zero_optimization={"stage": 0}))
    eager = _port_engine(params)
    for b in _batches():
        stage0.train_batch(batch=b)
        for i in range(2):
            loss = eager.forward({"input_ids": b["input_ids"][4 * i:4 * i + 4]})
            eager.backward(loss)
            eager.step()
    assert eager.global_steps == 3 and eager.micro_steps == 6
    for other in (stage0, eager):
        _assert_params_close(_state(other), _state(ref), SAME_ATOL)


def test_bf16_keeps_fp32_master_weights(jax_run):
    params = jax_run[0]
    cfg = dict(CONFIG, bf16={"enabled": True})
    engine = _port_engine(params, config=cfg)
    assert all(p.dtype == torch.bfloat16 for p in engine.module.parameters())
    assert all(m.dtype == torch.float32 for m in engine.master)
    # the masters start from the parameters as given, not their bf16 copies
    wte = torch.tensor(params["wte"]["embedding"])
    torch.testing.assert_close(engine.master[0], wte, atol=0, rtol=0)
    losses = [float(engine.train_batch(batch=b)) for b in _batches()]
    assert all(np.isfinite(losses))
    for p, m in zip(engine.module.parameters(), engine.master):
        torch.testing.assert_close(p, m.bfloat16(), atol=0, rtol=0)


def test_dataloader_path_advances():
    rng = np.random.default_rng(1)
    data = [{"input_ids": rng.integers(0, 128, 64).astype(np.int32)}
            for _ in range(24)]
    model = P.GPT2LMHeadModel(P.GPT2Config(**TINY, dtype=torch.float32))
    model.init_weights(torch.Generator().manual_seed(0))
    config = dict(CONFIG, optimizer={"type": "Adam", "params": {"lr": 0.0}})
    config.pop("scheduler")
    engine, _, loader, sched = dst.initialize(
        model=model, config=config, training_data=data, device="cpu")
    assert sched is None and len(loader) == 6
    losses = [float(engine.train_batch()) for _ in range(3)]
    assert len(set(losses)) == 3      # lr 0: only the data moved


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=10)),
    ("WarmupDecayLR", dict(total_num_steps=40, warmup_min_lr=0.0,
                           warmup_max_lr=1e-3, warmup_num_steps=10,
                           warmup_type="linear")),
    ("WarmupCosineLR", dict(total_num_steps=40, warmup_num_steps=10,
                            warmup_max_lr=2e-3, cos_min_ratio=0.1)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=8, cycle_second_step_size=12,
                      decay_lr_rate=0.5, decay_step_size=5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=7,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_staircase=True)),
])
def test_lr_schedules_match_jax(name, params):
    jax_s = JL.get_lr_schedule(name, dict(params))
    port = PL.get_lr_schedule(name, dict(params))
    for step in (0, 1, 3, 9, 10, 11, 19, 20, 25, 39, 40, 60):
        want = float(jax_s.lr_at(step))
        assert port.lr_at(step) == pytest.approx(want, rel=1e-6, abs=1e-12), \
            (name, step)


@pytest.mark.parametrize("hysteresis,window,consecutive",
                         [(1, 3, False), (2, 2, False), (3, 2, True)])
def test_update_scale_matches_jax(hysteresis, window, consecutive):
    overflows = [False, True, False, False, True, True, False, False, False,
                 True, True, True, False, False, False, False]
    kw = dict(scale_window=window, min_scale=2.0, delayed_shift=hysteresis,
              consecutive_hysteresis=consecutive)
    js = JS.make_loss_scale_state(2.0 ** 10, hysteresis)
    ps = PS.make_loss_scale_state(2.0 ** 10, hysteresis)
    for flag in overflows:
        js = JS.update_scale(js, jnp.asarray(flag), **kw)
        ps = PS.update_scale(ps, flag, **kw)
        assert ps == (float(js.loss_scale), int(js.good_steps),
                      int(js.hysteresis))
    for tensors in ([torch.ones(3), torch.tensor([1.0, float("inf")])],
                    [torch.ones(2)], [torch.tensor([float("nan")])]):
        want = bool(JS.has_inf_or_nan([jnp.asarray(t.numpy())
                                       for t in tensors]))
        assert bool(PS.has_inf_or_nan(tensors)) == want


class _Linear(torch.nn.Module):
    """loss = mean(w · x): an inf in x overflows every gradient."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, batch):
        return (self.w * batch["x"].to(self.w.dtype)).mean()


def test_fp16_overflow_skips_the_update():
    config = {"train_batch_size": 2, "fp16": {
        "enabled": True, "initial_scale_power": 4, "hysteresis": 1,
        "loss_scale_window": 100},
        "optimizer": {"type": "SGD", "params": {"lr": 0.5}}}
    engine, *_ = dst.initialize(model=_Linear(), config=config, device="cpu")
    good = {"x": np.ones((2, 4), np.float32)}
    bad = {"x": np.full((2, 4), np.inf, np.float32)}
    state = PS.make_loss_scale_state(16.0, 1)
    for batch, overflow in ((good, False), (bad, True), (good, False)):
        before = engine.master[0].clone()
        engine.train_batch(batch=batch)
        state = PS.update_scale(state, overflow, scale_window=100,
                                delayed_shift=1)
        assert engine.loss_scale_state == state
        moved = not torch.equal(engine.master[0], before)
        assert moved is not overflow
    assert engine.skipped_steps == 1 and engine._opt_step == 2
    assert engine.global_steps == 3
    torch.testing.assert_close(engine.master[0], torch.ones(4) - 2 * 0.5 / 4)


@pytest.mark.parametrize("key,value", [
    ("zero_optimization", {"stage": 2, "offload_optimizer": {"device": "cpu"}}),
    ("zero_optimization", {"stage": 3, "offload_param": {"device": "nvme"}}),
    ("optimizer", {"type": "OneBitAdam", "params": {"lr": 1e-3}}),
    ("pipeline", {"stages": 2}),
    ("hybrid_engine", {"enabled": True}),
    ("curriculum_learning", {"enabled": True}),
    ("flops_profiler", {"enabled": True}),
    ("tensorboard", {"enabled": True, "output_path": "tb"}),
    ("mesh", {"model": 2}),
])
def test_unported_keys_raise(key, value, tmp_path):
    """Keys of features the port does not have raise. The two offload
    blocks were such keys until the offload tiers were ported
    (``tests/test_torch_offload.py``, ``test_torch_param_offload.py``):
    they now build an engine that takes a step. ``mesh.model`` 2 was one
    until tensor-parallel training was ported
    (``tests/test_torch_tp_training.py`` trains over two ranks): it now
    parses as ported, and one process, a world of one rank, cannot hold a
    model group of two."""
    model = P.GPT2LMHeadModel(P.GPT2Config(**TINY, dtype=torch.float32))
    if key == "mesh":
        cfg = dst.DeepSpeedConfig.load(dict(CONFIG, **{key: value}))
        assert cfg.not_ported() == [] and cfg.mesh.model == 2
        with pytest.raises(ValueError, match="not divisible by model"):
            dst.initialize(model=model, config=dict(CONFIG, **{key: value}),
                           device="cpu")
        return
    if key == "zero_optimization":
        value = {k: dict(v, nvme_path=str(tmp_path))
                 if isinstance(v, dict) else v for k, v in value.items()}
        engine, *_ = dst.initialize(model=model, device="cpu",
                                    config=dict(CONFIG, **{key: value}))
        assert engine._offload_opt is not None
        assert np.isfinite(float(engine.train_batch(batch=_batches(1)[0])))
        return
    with pytest.raises(NotImplementedError):
        dst.initialize(model=model, config=dict(CONFIG, **{key: value}),
                       device="cpu")


def test_flagship_config_parses_and_cpu_must_be_asked_for(monkeypatch,
                                                          tmp_path):
    cfg = dst.DeepSpeedConfig.load(BENCH_CONFIG)
    assert (cfg.train_batch_size, cfg.precision_dtype,
            int(cfg.zero_optimization.stage)) == (160, torch.bfloat16, 2)
    assert cfg.not_ported() == []
    model = P.GPT2LMHeadModel(P.GPT2Config(**TINY, dtype=torch.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.initialize(model=model, config=CONFIG)
    engine, *_ = dst.initialize(model=model, config=CONFIG, device="cpu")
    # the CPU engine's checkpoint round trip (tests/test_torch_checkpoint.py
    # holds it bit for bit at every precision)
    engine.train_batch(batch=_batches(1)[0])
    engine.save_checkpoint(str(tmp_path))
    saved = _state(engine)
    engine.train_batch(batch=_batches(2)[1])
    assert engine.load_checkpoint(str(tmp_path)) == (str(tmp_path), {})
    assert engine.global_steps == 1
    _assert_params_close(_state(engine), saved, 0.0)
    eval_loss = engine.eval_batch_fn()(_batches(1)[0])
    assert eval_loss.requires_grad is False and np.isfinite(float(eval_loss))


@pytest.mark.parametrize("name,params", [
    ("Adam", {"weight_decay": 0.1}),
    ("Adam", {"weight_decay": 0.1, "adam_w_mode": False,
              "bias_correction": False}),
    ("AdamW", {"betas": (0.8, 0.99), "eps": 1e-6, "weight_decay": 0.01}),
    ("Lamb", {"weight_decay": 0.05, "max_coeff": 2.0, "min_coeff": 0.1}),
    ("SGD", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("Adagrad", {"weight_decay": 0.02}),
])
def test_optimizers_match_jax(name, params):
    rng = np.random.default_rng(4)
    shapes = [(3, 5), (7,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    jopt, popt = JO.get_optimizer(name, params), PO.get_optimizer(name,
                                                                  params)
    jp = [jnp.asarray(x) for x in p0]
    jstate = jopt.init(jp)
    pp = [torch.tensor(x) for x in p0]
    pstate = popt.init(pp)
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        jp, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp,
                                 jnp.float32(lr), jnp.int32(step))
        popt.update([torch.tensor(x) for x in g], pstate, pp, lr, step)
    for got, want in zip(pp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    with pytest.raises(NotImplementedError):
        PO.get_optimizer("OneBitLamb", {})


def test_config_surface(tmp_path):
    """The port's dataclass config keeps the JAX package's parsing rules."""
    cfg = dst.DeepSpeedConfig.load({
        "train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
        "gradient_accumulation_steps": "auto", "some_future_key": 1,
        "zero_optimization": {"stage": 3, "reduce_bucket_size": "auto",
                              "stage3_gather_fp16_weights_on_model_save":
                                  True}})
    assert cfg.gradient_accumulation_steps == 8
    assert cfg.extra == {"some_future_key": 1}
    zc = cfg.zero_optimization
    assert zc.reduce_bucket_size == int(5e8) and zc.overlap_comm is True
    assert zc.stage3_gather_16bit_weights_on_model_save is True
    with pytest.raises(ValueError, match="train_batch_size is not equal"):
        dst.DeepSpeedConfig.load({"train_batch_size": 30,
                                  "train_micro_batch_size_per_gpu": 4,
                                  "gradient_accumulation_steps": 8})
    with pytest.raises(ValueError, match=">= 0"):
        dst.DeepSpeedConfig.load({"train_batch_size": 8, "zero_optimization":
                                  {"reduce_bucket_size": -1}})
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ValueError, match="Duplicate keys"):
        dst.DeepSpeedConfig.load(str(path))
    path.write_text('{"train_micro_batch_size_per_gpu": 2, '
                    '"fp16": {"enabled": true}, "bf16": {"enabled": true}}')
    with pytest.raises(ValueError, match="cannot be enabled"):
        dst.DeepSpeedConfig.load(str(path))
