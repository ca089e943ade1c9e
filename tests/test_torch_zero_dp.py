"""ZeRO over a data-parallel world: the port at 2 and 4 gloo ranks against
the JAX engine at data = 2 and 4 on the conftest's virtual CPU mesh.

Models: a tiny GPT-2 (vocab 128, n_embd 66, 3 layers, 6 heads, T = 16:
at world 4 the 66-wide tensors have no dimension 4 divides and stay whole
while the rest shard) and a tiny GQA llama ``TransformerLM`` (vocab 97,
n_embd 32, 4 query heads over 2 KV heads). Random weights from numpy (the
JAX tree's shapes by ``jax.eval_shape``) cross the weight bridge. Config:
micro 2, gas 2, AdamW lr 1e-3 wd 0.1 behind a linear 4-step warm-up from 0
(as ``test_torch_training.py``: Adam's first update moves every element by
about lr whatever its gradient, so without the warm-up a gradient at the
noise floor moves an element by ±lr), clipping 1.0 (active: the norms are
above 1), ``stage3_param_persistence_threshold`` 200 (the 66-element
norms and biases stay whole at stage 3), 3 steps. Each rank's k-th
micro-batch is its contiguous block of the JAX engine's k-th global
micro-batch (``_torch_dist.rank_rows``).

Tolerances. fp32: losses and each step's global gradient norm (pre-clip:
it reads the shards' sum and the world's average, which Adam and the clip
would hide) within 1e-5 relative, the final masters within 2e-6 absolute
(PR 15's probe: summation order alone gives about 2e-6 relative), one
slice exempt as in ``test_torch_training.py`` (the key third of each
GPT-2 ``qkv`` bias has a zero gradient that Adam turns into ±lr noise;
held to 3 × lr). bf16 (fp32 masters): XLA and PyTorch round their bf16
products differently, which one rank of the port shows as much as four
(measured: losses within 8e-5 relative, the masters' update,
final − initial over every tensor, within 1.8% of the JAX update's norm),
so the bounds are 2e-4 on the losses, 1e-2 on the norms and 5% on the
update; the port's stages and worlds are held to each other tightly
instead. The port's stages 1-3 against its own stage 0: losses and norms
within 1e-6 relative, masters within 1e-6 absolute (2 × lr on the exempt
slice): only the order of fp32 sums differs. A world of W ranks against
one rank with W × gas micro-batches (the same micro-batches): the same
bounds.

MiCS (shard 2 of 4, stage 3) against the JAX MiCS mesh; fp16 with an inf
in one rank's rows (only the other rank's gradient slice sees it) skips
the step on both ranks, with the JAX engine's skip count and loss scale,
under SGD without clipping (the update then shows the gradient's scale);
bytes at rest per stage against the partition the JAX specs predict,
exactly; stage 3 never holds more than two blocks' gathered weights in a
forward (with and without activation checkpointing); a checkpoint saved at
world 4, stage 3, loads at world 2 (its files, and their universal
conversion, which records the source world of 4) and at one rank without
a process group with the same next two losses (1e-6 and 1e-4 relative: the first is
a forward of the same weights, the second follows an update summed in
another order); ``zero_to_fp32`` and ``safe_get_full_fp32_param`` give the
gathered masters; a process group of one rank changes nothing, bit for
bit. Three spawns (worlds 4 and 2 here, 4 in ``test_torch_comm.py``), six
JAX engines.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import gpt2 as JG
from deepspeed_tpu.models import transformer_lm as JL
from deepspeed_tpu.parallel import initialize_mesh as j_initialize_mesh
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JLoader
from deepspeed_tpu.runtime.zero import policy as JP
from deepspeed_tpu.runtime.zero.mics import MiCS_Init as j_mics_init
from deepspeed_tpu_torch.checkpoint.flax_import import _fp32_state_dict
from deepspeed_tpu_torch.checkpoint.universal_checkpoint import (
    ds_to_universal, load_universal, universal_dir)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import \
    get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as PL
from deepspeed_tpu_torch.runtime.dataloader import \
    DeepSpeedDataLoader as PLoader

from _torch_dist import spawn, train_run
from _torch_threads import one_thread  # noqa: F401

LR = 1e-3
GPT2 = dict(vocab_size=128, n_positions=32, n_embd=66, n_layer=3, n_head=6)
LLAMA = dict(vocab_size=97, max_seq_len=16, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2, use_flash_attention=False)
SEQ = 16
STEPS = 3
THRESHOLD = 200
FP32 = dict(loss=1e-5, atol=2e-6, key=3 * LR)
SAME = dict(loss=1e-6, atol=1e-6, key=2 * LR)
BF16_LOSS, BF16_NORM, BF16_UPDATE = 2e-4, 1e-2, 0.05


def config(stage, dtype="fp32", gas=2, **zero):
    c = {"train_micro_batch_size_per_gpu": 2,
         "gradient_accumulation_steps": gas,
         "zero_optimization": {"stage": stage,
                               "stage3_param_persistence_threshold":
                                   THRESHOLD, **zero},
         "optimizer": {"type": "AdamW",
                       "params": {"lr": LR, "weight_decay": 0.1}},
         "scheduler": {"type": "WarmupLR", "params": {
             "warmup_min_lr": 0.0, "warmup_max_lr": LR,
             "warmup_num_steps": 4, "warmup_type": "linear"}},
         "gradient_clipping": 1.0, "steps_per_print": 100}
    if dtype == "bf16":
        c["bf16"] = {"enabled": True}
    return c


def _random_params(model, batch, seed):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.02, s.shape).astype(s.dtype), shapes)


def _ids(vocab, rows, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, SEQ)).astype(
        np.int32)} for _ in range(STEPS + 2)]


class Side:
    """One model family: its JAX module, numpy weights, port configs."""

    def __init__(self, kind):
        self.kind = kind
        if kind == "gpt2":
            self.jcfg = JG.GPT2Config(**GPT2, dtype=jnp.float32,
                                      use_flash_attention=False)
            jmodel = JG.GPT2LMHeadModel(self.jcfg)
            self.pcfg = PG.GPT2Config(**GPT2, dtype=torch.float32)
            vocab = GPT2["vocab_size"]
        else:
            self.jcfg = JL.transformer_config("llama", **LLAMA,
                                              dtype=jnp.float32)
            jmodel = JL.TransformerLM(self.jcfg)
            fields = {f.name: getattr(self.jcfg, f.name)
                      for f in dataclasses.fields(self.jcfg)}
            self.pcfg = PL.TransformerConfig(**{**fields,
                                                "dtype": torch.float32})
            vocab = LLAMA["vocab_size"]
        self.vocab = vocab
        probe = {"input_ids": jnp.zeros((2, SEQ), jnp.int32)}
        self.params = _random_params(jmodel, probe, 7)
        self.state = _fp32_state_dict(self.pcfg, self.params)

    def jmodel(self, dtype):
        jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        cfg = dataclasses.replace(self.jcfg, dtype=jd)
        return JG.GPT2LMHeadModel(cfg) if self.kind == "gpt2" else \
            JL.TransformerLM(cfg)

    def spec(self, dtype):
        return (self.pcfg, self.state,
                torch.bfloat16 if dtype == "bf16" else torch.float32)

    def fp32(self, tree):
        return _fp32_state_dict(self.pcfg, jax.tree_util.tree_map(
            np.asarray, tree))


SIDES = {}


def side(kind):
    if kind not in SIDES:
        SIDES[kind] = Side(kind)
    return SIDES[kind]


def batches(kind, world, gas=2):
    return _ids(side(kind).vocab, 2 * gas * world, {2: 1, 4: 2}.get(world, 0))


def fp16_batches():
    """Global fp16 batches for world 2: x (8, 8) and, at step 1, an inf in
    column 3 of rank 1's rows."""
    rng = np.random.default_rng(5)
    out = []
    for step in range(4):
        x = rng.normal(size=(8, 8)).astype(np.float32)
        if step == 1:
            for k in range(2):
                x[k * 4 + 2:k * 4 + 4, 3] = np.inf
        out.append({"x": x})
    return out


FP16_CONFIG = {"train_micro_batch_size_per_gpu": 2,
               "gradient_accumulation_steps": 2,
               "fp16": {"enabled": True, "initial_scale_power": 8},
               "zero_optimization": {"stage": 2},
               "optimizer": {"type": "SGD", "params": {"lr": 1e-2}},
               "steps_per_print": 100}


# ---------------------------------------------------------------------------
# the JAX engines (six)
# ---------------------------------------------------------------------------
JAX_RUNS = {}


def jax_run(kind, dtype, data, stage, mics=0):
    key = (kind, dtype, data, stage, mics)
    if key in JAX_RUNS:
        return JAX_RUNS[key]
    devices = jax.devices()[:data]
    if mics:
        mesh = j_mics_init(mics, data=data, devices=devices)
        cfg = config(stage, dtype, mics_shard_size=mics)
    else:
        mesh = j_initialize_mesh(data=data, devices=devices)
        cfg = config(stage, dtype)
    if kind == "squares":
        params = {"w": np.full((8,), 0.5, np.float32)}

        def loss_fn(p, batch, rng):
            x = batch["x"].astype(p["w"].dtype)
            return jnp.mean(jnp.sum((x * p["w"]) ** 2, -1).astype(
                jnp.float32))

        engine, *_ = ds.initialize(loss_fn=loss_fn, model_parameters=params,
                                   config=FP16_CONFIG, mesh=mesh)
        data_ = fp16_batches()
    else:
        s = side(kind)
        engine, *_ = ds.initialize(
            model=s.jmodel(dtype), config=cfg, mesh=mesh,
            model_parameters=jax.tree_util.tree_map(np.array, s.params))
        data_ = batches(kind, data)[:STEPS]
    losses, norms = [], []
    for b in data_:
        losses.append(float(engine.train_batch(batch=b)))
        norms.append(float(engine.get_global_grad_norm()))
    st = engine.state
    tree = st["master"] if st.get("master") is not None else st["params"]
    # the fused step counts a skip as a step without an optimizer step
    out = {"losses": losses, "norms": norms, "tree": tree,
           "skipped": int(st["step"]) - int(st["opt_step"]),
           "scale": st.get("scale")}
    JAX_RUNS[key] = out
    return out


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------
def port_run(kind, dtype, stage, world, gas=2, **extra):
    return dict(model=side(kind).spec(dtype), config=config(stage, dtype, gas),
                batches=batches(kind, world, gas)[:STEPS], **extra)


def w4_runs(ckpt):
    runs = {("gpt2", "bf16", s): port_run("gpt2", "bf16", s, 4)
            for s in range(4)}
    runs.update({("llama", "fp32", s): port_run("llama", "fp32", s, 4)
                 for s in (0, 3)})
    mics = port_run("gpt2", "fp32", 3, 4, mics=2)
    mics["config"]["zero_optimization"]["mics_shard_size"] = 2
    runs["mics"] = mics
    runs["ckpt"] = port_run("gpt2", "bf16", 3, 4, save=ckpt,
                            next=batches("gpt2", 4)[STEPS:])
    return runs


def w2_runs(ckpt):
    runs = {("gpt2", "fp32", s): port_run("gpt2", "fp32", s, 2,
                                          fragment=s == 3)
            for s in range(4)}
    runs.update({("llama", "bf16", s): port_run("llama", "bf16", s, 2)
                 for s in (0, 3)})
    remat = port_run("gpt2", "fp32", 3, 2)
    cfg = dataclasses.replace(side("gpt2").pcfg, remat=True,
                              remat_policy="dots")
    remat["model"] = (cfg,) + remat["model"][1:]
    runs["remat"] = remat
    runs["fp16"] = dict(model=("squares", 8), config=FP16_CONFIG,
                        batches=fp16_batches())
    # the world-4 checkpoint's next two global batches at gas 4, from its
    # files and from their universal conversion
    runs["load"] = dict(model=side("gpt2").spec("bf16"),
                        config=config(3, "bf16", gas=4), load=ckpt,
                        batches=batches("gpt2", 4)[STEPS:])
    universal = config(2, "bf16", gas=4)
    universal["checkpoint"] = {"load_universal": True}
    runs["universal"] = dict(runs["load"], config=universal)
    return runs


REFUSE = [({"offload_optimizer": {"device": "cpu"}}, "offload"),
          ({"offload_param": {"device": "cpu"}}, "offload"),
          (None, "LAMB")]


def refusal_configs():
    out = []
    for zero, _ in REFUSE:
        if zero is None:
            c = config(1)
            c["optimizer"] = {"type": "Lamb", "params": {"lr": LR}}
        else:
            c = config(3 if "offload_param" in zero else 2, **zero)
        out.append((side("gpt2").spec("fp32"), c))
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("zero_ckpt"))


@pytest.fixture(scope="module")
def w4(tmp_path_factory, ckpt_dir):
    return spawn("train", 4, tmp_path_factory.mktemp("w4"), timeout=240,
                 runs=w4_runs(ckpt_dir))


@pytest.fixture(scope="module")
def w2(tmp_path_factory, ckpt_dir, w4):
    ds_to_universal(ckpt_dir)
    return spawn("train", 2, tmp_path_factory.mktemp("w2"), timeout=240,
                 runs=w2_runs(ckpt_dir), refuse=refusal_configs())


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
def _same_across_ranks(results, key):
    first = results[0][key]
    for r in results[1:]:
        assert r[key]["losses"] == first["losses"], key
    return first


def _hold_params(got, want, tol, width=None):
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        diff = (torch.as_tensor(val).float() - want[name].float()).abs()
        if width and name.endswith("attn.qkv.bias"):
            key = diff[width:2 * width].max().item()
            assert key <= tol["key"], f"{name} keys: {key}"
            diff = torch.cat([diff[:width], diff[2 * width:]])
        assert diff.max().item() <= tol["atol"], \
            f"{name}: {diff.max().item()}"


def _hold(got, want, tol, kind):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"])
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=tol["loss"])
    _hold_params(got["targets"], want["targets"], tol,
                 GPT2["n_embd"] if kind == "gpt2" else None)


def _hold_bf16(got, jax_res, kind):
    np.testing.assert_allclose(got["losses"], jax_res["losses"],
                               rtol=BF16_LOSS)
    np.testing.assert_allclose(got["norms"], jax_res["norms"],
                               rtol=BF16_NORM)
    init = side(kind).state
    want = side(kind).fp32(jax_res["tree"])
    width = GPT2["n_embd"] if kind == "gpt2" else None
    num = den = 0.0
    for name, val in got["targets"].items():
        diff, upd = val - want[name], want[name] - init[name]
        if width and name.endswith("attn.qkv.bias"):
            diff = torch.cat([diff[:width], diff[2 * width:]])
            upd = torch.cat([upd[:width], upd[2 * width:]])
        num += diff.square().sum().item()
        den += upd.square().sum().item()
    err = math.sqrt(num / den)
    assert err <= BF16_UPDATE, f"update rel err {err:.4f}"


def _jax_as_port(kind, res):
    return {"losses": res["losses"], "norms": res["norms"],
            "targets": side(kind).fp32(res["tree"])}


@pytest.mark.parametrize("stage", [0, 3])
def test_gpt2_fp32_two_ranks_match_the_jax_engine(w2, stage):
    got = _same_across_ranks(w2, ("gpt2", "fp32", stage))
    want = _jax_as_port("gpt2", jax_run("gpt2", "fp32", 2, 3))
    _hold(got, want, FP32, "gpt2")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_gpt2_fp32_two_ranks_stages_equal_stage_0(w2, stage):
    _hold(_same_across_ranks(w2, ("gpt2", "fp32", stage)),
          w2[0][("gpt2", "fp32", 0)], SAME, "gpt2")


@pytest.mark.parametrize("stage", [0, 3])
def test_gpt2_bf16_four_ranks_match_the_jax_engine(w4, stage):
    _hold_bf16(_same_across_ranks(w4, ("gpt2", "bf16", stage)),
               jax_run("gpt2", "bf16", 4, 3), "gpt2")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_gpt2_bf16_four_ranks_stages_equal_stage_0(w4, stage):
    _hold(_same_across_ranks(w4, ("gpt2", "bf16", stage)),
          w4[0][("gpt2", "bf16", 0)], SAME, "gpt2")


@pytest.mark.parametrize("stage", [0, 3])
def test_llama_gqa_fp32_four_ranks_match_the_jax_engine(w4, stage):
    got = _same_across_ranks(w4, ("llama", "fp32", stage))
    _hold(got, _jax_as_port("llama", jax_run("llama", "fp32", 4, 3)), FP32,
          "llama")


@pytest.mark.parametrize("stage", [0, 3])
def test_llama_gqa_bf16_two_ranks_match_the_jax_engine(w2, stage):
    _hold_bf16(_same_across_ranks(w2, ("llama", "bf16", stage)),
               jax_run("llama", "bf16", 2, 3), "llama")


def test_llama_stage3_equals_stage0(w2, w4):
    _hold(w4[0][("llama", "fp32", 3)], w4[0][("llama", "fp32", 0)], SAME,
          "llama")
    _hold(w2[0][("llama", "bf16", 3)], w2[0][("llama", "bf16", 0)], SAME,
          "llama")


def test_mics_shard_2_of_4_matches_the_jax_mics_mesh(w4):
    got = _same_across_ranks(w4, "mics")
    want = _jax_as_port("gpt2", jax_run("gpt2", "fp32", 4, 3, mics=2))
    _hold(got, want, FP32, "gpt2")


def test_fp16_overflow_on_one_rank_skips_the_step_everywhere(w2):
    res = jax_run("squares", "fp16", 2, 2)
    for r in w2:
        got = r["fp16"]
        assert got["skipped"] == res["skipped"] == 1
        assert math.isinf(got["losses"][1]) and math.isinf(res["losses"][1])
        np.testing.assert_allclose(got["losses"], res["losses"], rtol=2e-3)
        js = res["scale"]
        assert got["scale"] == (float(js.loss_scale), int(js.good_steps),
                                int(js.hysteresis))
    # three SGD steps of lr 1e-2 on gradients of about 1 rounded to fp16
    np.testing.assert_allclose(w2[0]["fp16"]["targets"]["w"].numpy(),
                               np.asarray(res["tree"]["w"]), atol=5e-5)


def _predicted(names_shapes, stage, world, itemsize, keep_master):
    """Bytes at rest from the JAX policy's specs."""
    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig

    mesh = j_initialize_mesh(data=world, devices=jax.devices()[:world])
    policy = JP.ZeroShardingPolicy(DeepSpeedZeroConfig(
        stage=stage, stage3_param_persistence_threshold=THRESHOLD), mesh)

    def local(spec, shape):
        n = math.prod(shape)
        return n // world if any(e is not None for e in spec) else n

    out = dict(params=0, master=0, moments=0, accumulators=0)
    for name, shape in names_shapes:
        p, m = policy.param_spec(name, shape), policy.master_spec(name, shape)
        g = policy.grad_spec(name, shape)
        out["params"] += local(p, shape) * itemsize
        sharded = [any(e is not None for e in s) for s in (p, m)]
        if keep_master or sharded[1] != sharded[0]:
            out["master"] += local(m, shape) * 4
        out["moments"] += 2 * local(m, shape) * 4
        out["accumulators"] += local(g, shape) * 4
    return out


@pytest.mark.parametrize("world,dtype", [(2, "fp32"), (4, "bf16")])
def test_bytes_at_rest_match_the_partition(w2, w4, world, dtype):
    results = {2: w2, 4: w4}[world]
    shapes = [(k, tuple(v.shape)) for k, v in side("gpt2").state.items()]
    for stage in range(4):
        want = _predicted(shapes, stage, world, 2 if dtype == "bf16" else 4,
                          dtype == "bf16")
        for r in results:
            assert r[("gpt2", dtype, stage)]["bytes"] == want, stage
    # stage 3 at world 4 keeps the 66-wide tensors whole
    full = _predicted(shapes, 0, 4, 2, True)
    assert w4[0][("gpt2", "bf16", 3)]["bytes"]["params"] > full["params"] / 4


def test_stage3_holds_at_most_two_blocks_gathered(w2, w4):
    for results, key in ((w2, ("gpt2", "fp32", 3)), (w2, "remat"),
                         (w4, ("gpt2", "bf16", 3))):
        for r in results:
            assert 1 <= r[key]["max_live_blocks"] <= 2, key
    _hold(w2[0]["remat"], w2[0][("gpt2", "fp32", 3)], SAME, "gpt2")


def test_checkpoint_saved_at_four_ranks_resumes_at_two_and_one(w2, w4,
                                                              ckpt_dir):
    saved = w4[0]["ckpt"]
    want = saved["next_losses"]
    assert len({tuple(r["ckpt"]["next_losses"]) for r in w4}) == 1
    got2 = [r[key]["losses"] for r in w2 for key in ("load", "universal")]
    meta = load_universal(universal_dir(ckpt_dir, "global_step3"))["meta"]
    assert meta["source_dp_world_size"] == 4
    run = dict(model=side("gpt2").spec("bf16"),
               config=config(0, "bf16", gas=8), load=ckpt_dir,
               batches=batches("gpt2", 4)[STEPS:])
    got1 = train_run(run)["losses"]
    for got in got2 + [got1]:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    fp32 = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir)
    assert sorted(fp32) == sorted(saved["targets"])
    for name, val in saved["targets"].items():
        np.testing.assert_array_equal(fp32[name], val.numpy())
        np.testing.assert_array_equal(saved["fp32_param"][name], val.numpy())


def test_tensor_fragment_reads_and_writes_whole_tensors(w2):
    """Stage 3 at two ranks: a sharded and a whole (persistent) parameter
    read whole through ``safe_get_full_*`` (the moments beside the
    gathered masters' shapes) and written whole by
    ``safe_set_full_fp32_param`` (read back as written, the compute copy
    too)."""
    for r in w2:
        frag = r[("gpt2", "fp32", 3)]["fragment"]
        assert frag, r
        for name, got in frag.items():
            shape = tuple(side("gpt2").state[name].shape)
            assert got["shapes"] == [shape] * 3, name
            assert got["set_reads_back"] and got["module_follows"], name


def test_two_ranks_equal_one_rank_with_twice_the_micro_batches(w2):
    run = port_run("gpt2", "fp32", 0, 2)
    run["config"] = config(2, gas=4)
    _hold(train_run(run), w2[0][("gpt2", "fp32", 2)], SAME, "gpt2")


def test_a_process_group_of_one_rank_changes_nothing(tmp_path):
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    runs = [port_run("gpt2", "bf16", s, 1, gas=2) for s in (0, 3)]
    alone = [train_run(r) for r in runs]
    comm.init_distributed(dist_backend="gloo", rank=0, world_size=1,
                          init_method=f"file://{tmp_path}/store",
                          verbose=False)
    try:
        grouped = [train_run(r) for r in runs]
    finally:
        dist.destroy_process_group()
        comm_mod._initialized = False
        mesh_mod.reset_mesh()
    for a, g in zip(alone, grouped):
        assert a["losses"] == g["losses"]
        for name in a["targets"]:
            assert torch.equal(a["targets"][name], g["targets"][name])


def test_unported_keys_still_raise_at_two_ranks(w2):
    for (_, what), msg in zip(REFUSE, w2[0]["refusals"]):
        assert msg is not None and what in msg, msg


@pytest.mark.parametrize("world", [2, 4])
def test_rank_loaders_stride_like_the_jax_loader(world):
    rng = np.random.default_rng(3)
    data = [{"input_ids": rng.integers(0, 9, 4)} for _ in range(40)]
    for rank in range(world):
        mine = list(PLoader(data, batch_size=2, num_shards=world,
                            shard_index=rank))
        theirs = list(JLoader(data, batch_size=2, num_shards=world,
                              shard_index=rank))
        assert len(mine) == len(theirs) == 40 // (2 * world)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    # the ranks' first micro-batches together: the first 2 · world samples
    firsts = [next(iter(PLoader(data, 2, num_shards=world, shard_index=r)))
              for r in range(world)]
    got = sorted(map(tuple, np.concatenate([b["input_ids"] for b in firsts])))
    assert got == sorted(tuple(d["input_ids"]) for d in data[:2 * world])


@pytest.mark.parametrize("required", [None, False])
def test_dist_init_required_decides_whether_initialize_joins(monkeypatch,
                                                             required):
    """``WORLD_SIZE`` 2 with no rendezvous: the engine tries to join (and
    says what it lacks), unless ``dist_init_required=False``, which builds
    a one-rank engine without a group."""
    import torch.distributed as dist

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from _torch_dist import Squares

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    mesh_mod.reset_mesh()
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "SGD", "params": {"lr": 0.1}}}
    if required is None:
        with pytest.raises(RuntimeError, match="MASTER_ADDR"):
            dst.initialize(model=Squares(), config=config, device="cpu")
    else:
        engine, *_ = dst.initialize(model=Squares(), config=config,
                                    device="cpu", dist_init_required=required)
        assert engine.dp_world_size == 1
        loss = engine.train_batch(batch={"x": torch.ones(2, 8)})
        assert float(loss) == pytest.approx(2.0)
    assert not dist.is_initialized()
    mesh_mod.reset_mesh()
