"""Tensor-parallel training: the port over a model group of two gloo ranks
at ``(data, model)`` = (1, 2) and (2, 2) against the JAX engine on the same
meshes of the conftest's virtual CPU devices.

Models, fp32, random numpy weights (the JAX tree's shapes by
``jax.eval_shape``) through the weight bridge:

* a tiny GPT-2 with an odd vocabulary (67, n_embd 32, 2 layers, 4 heads,
  T = 16): its embedding and tied head stay whole on every rank (GSPMD
  would pad them; ``device_put`` refuses an uneven split, so the JAX
  engine takes ``gpt2_sharding_rules`` without the ``wte`` rule, the
  placement the port's plan keeps), its fused qkv splits per head;
* a tiny GQA llama ``TransformerLM`` with an even vocabulary (64, 4 query
  heads over 2 KV heads, untied): its embedding and head are
  vocab-parallel, and ``loss_chunk`` 8 streams the loss through the
  gathered chunks.

Runs: (1, 2) at stages 0 and 2 with gas 4, (2, 2) at stages 1 and 3 with
gas 2, micro 2: the same four global batches of 8 rows, 4 ``train_batch``
steps, AdamW lr 1e-3 wd 0.1 behind a 4-step linear warm-up, clip 1.0,
``stage3_param_persistence_threshold`` 200 (``test_torch_zero_dp.py``'s
config). JAX: one engine a model and mesh ((1, 2) stage 0 gas 4, (2, 2)
stage 3 gas 2); every micro-batch has the same number of rows, so the mean
of the micro means is the same function of the global batch at both gas.

Held against JAX within ``test_torch_zero_dp.py``'s fp32 tolerance: the
losses and each step's pre-clip global gradient norm (1e-5 relative; a
replicated tensor counted once a rank, or a slice counted once, moves the
norm), the final gathered fp32 weights (2e-6 absolute; the key third of
GPT-2's qkv bias, whose gradient is zero and which Adam moves by noise of
about lr, within 3 × lr), both ranks of a group alike.

Also: GPT-2 with an even vocabulary (vocab-parallel embedding and tied
head, the streamed loss, remat "dots") and a multi-query llama (its one KV
head held by both ranks) at (1, 2) against the port's one-rank engine;
each parallel layer's output, input and weight gradients at world 2
against the plain layer; the comm layer's all-gather along ``axis=-1``
over the model group; a checkpoint saved at ``model`` 2 holding the
whole tensors under the one-rank names and shapes (equal to the JAX
tree's, name by name) that loads at ``model`` 1 and resumes with the
same loss; a rank's bytes at rest against the policy's prediction over
the rank's tensor-parallel shapes; dropout 0.1 leaving every rank of the
group the same residual stream (GPT-2 and llama); ``fused_ln_linear=True``
at ``model`` 2 raising ``ValueError`` as the JAX model does.

Two spawns (worlds 2 and 4, started before the JAX side runs); JAX: four
engines.
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
from deepspeed_tpu.runtime.zero.policy import ShardingRules as JRules
from deepspeed_tpu_torch import module_inject as MI
from deepspeed_tpu_torch.checkpoint.flax_import import _fp32_state_dict
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as PL
from deepspeed_tpu_torch.parallel import mesh as PM
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine, checkpoint_meta_path, read_latest)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy

from _torch_dist import start, train_run
from _torch_threads import one_thread  # noqa: F401

LR = 1e-3
GPT2 = dict(vocab_size=67, n_positions=16, n_embd=32, n_layer=2, n_head=4)
LLAMA = dict(vocab_size=64, max_seq_len=16, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2, loss_chunk=8, use_flash_attention=False)
SEQ, STEPS, ROWS, THRESHOLD = 16, 4, 8, 200
FP32 = dict(loss=1e-5, atol=2e-6, key=3 * LR)
# (data, stage) -> gas of each port run; the JAX engines run the first of
# each mesh
MESHES = {(1, 0): 4, (1, 2): 4, (2, 1): 2, (2, 3): 2}
JAX_RUNS = {1: 0, 2: 3}


def config(stage, data, gas):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas,
            "mesh": {"data": data, "model": 2},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold":
                                      THRESHOLD},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": LR,
                "warmup_num_steps": 4, "warmup_type": "linear"}},
            "gradient_clipping": 1.0, "steps_per_print": 100}


class Side:
    """One model family: its JAX module and rules, numpy weights, the
    port's config and fp32 state dict, the global batches."""

    def __init__(self, kind):
        self.kind = kind
        if kind == "gpt2":
            self.jcfg = JG.GPT2Config(**GPT2, dtype=jnp.float32,
                                      use_flash_attention=False)
            self.jmodel = JG.GPT2LMHeadModel(self.jcfg)
            self.pcfg = PG.GPT2Config(**GPT2, dtype=torch.float32)
            # the odd vocabulary stays whole (module docstring)
            self.rules = [r for r in JG.gpt2_sharding_rules()
                          if "wte" not in r[0]]
        else:
            self.jcfg = JL.transformer_config("llama", **LLAMA,
                                              dtype=jnp.float32)
            self.jmodel = JL.TransformerLM(self.jcfg)
            fields = {f.name: getattr(self.jcfg, f.name)
                      for f in dataclasses.fields(self.jcfg)}
            self.pcfg = PL.TransformerConfig(**{**fields,
                                                "dtype": torch.float32})
            self.rules = JL.transformer_sharding_rules()
        probe = {"input_ids": jnp.zeros((2, SEQ), jnp.int32)}
        shapes = jax.eval_shape(lambda: self.jmodel.init(
            {"params": jax.random.PRNGKey(0)}, probe))["params"]
        rng = np.random.default_rng(7)
        self.params = jax.tree_util.tree_map_with_path(
            lambda path, s: np.ones(s.shape, s.dtype)
            if path[-1].key == "scale" else
            rng.normal(0.0, 0.02, s.shape).astype(s.dtype), shapes)
        self.state = _fp32_state_dict(self.pcfg, self.params)
        vocab = self.pcfg.vocab_size
        brng = np.random.default_rng(1)
        self.batches = [{"input_ids": brng.integers(0, vocab, (ROWS, SEQ))
                         .astype(np.int32)} for _ in range(STEPS + 1)]

    def spec(self, **changes):
        cfg = dataclasses.replace(self.pcfg, **changes)
        return (cfg, self.state, torch.float32)

    def fp32(self, tree):
        return _fp32_state_dict(self.pcfg, jax.tree_util.tree_map(
            np.asarray, tree))


SIDES = {}


def side(kind):
    if kind not in SIDES:
        SIDES[kind] = Side(kind)
    return SIDES[kind]


def port_runs(data, ckpt=None):
    runs = {}
    for kind in ("gpt2", "llama"):
        for (d, stage), gas in MESHES.items():
            if d == data:
                runs[(kind, stage)] = dict(
                    model=side(kind).spec(), config=config(stage, d, gas),
                    batches=side(kind).batches[:STEPS])
    if ckpt is not None:
        runs["ckpt"] = dict(runs[("gpt2", 2)], save=ckpt,
                            next=side("gpt2").batches[STEPS:])
        runs.update({key: one_rank_run(key) for key in ONE_RANK})
    return runs


# placements the JAX runs above do not take, held against the port's own
# one-rank engine: GPT-2 with an even vocabulary (its embedding and tied
# head vocab-parallel, the streamed loss gathered a chunk at a time, remat
# "dots") and a multi-query llama (one KV head, which both ranks hold:
# its gradient summed over them)
ONE_RANK = {"gpt2_vocab_parallel": dict(vocab_size=64, loss_chunk=8,
                                        remat=True, remat_policy="dots"),
            "llama_mqa": dict(n_kv_head=1, remat=True)}


def one_rank_run(key, model=2):
    kind = "gpt2" if key.startswith("gpt2") else "llama"
    s = side(kind)
    cfg = dataclasses.replace(s.pcfg, **ONE_RANK[key])
    torch_model = (PG.GPT2LMHeadModel if kind == "gpt2" else
                   PL.TransformerLM)(cfg)
    torch_model.init_weights(torch.Generator().manual_seed(4))
    rows = np.random.default_rng(2).integers(0, cfg.vocab_size, (STEPS, 4,
                                                                 SEQ))
    conf = dict(config(2, 1, 2), mesh={"data": 1, "model": model})
    return dict(model=(cfg, torch_model.state_dict(), torch.float32),
                config=conf, batches=[{"input_ids": r.astype(np.int32)}
                                      for r in rows])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.fixture(scope="module")
def started(tmp_path_factory, ckpt_dir):
    """The port's two worlds, started before the JAX side runs."""
    probe = dict(dropout_models=[side("gpt2").spec(dropout=0.1),
                                 side("llama").spec(dropout=0.1)],
                 fused=side("gpt2").spec(fused_ln_linear=True))
    return {1: start("train", 2, tmp_path_factory.mktemp("tp_w2"),
                     timeout=240, runs=port_runs(1, ckpt_dir), probe=probe),
            2: start("train", 4, tmp_path_factory.mktemp("tp_w4"),
                     timeout=240, runs=port_runs(2))}


@pytest.fixture(scope="module")
def jax_side(started):
    """The JAX engine for each model at (1, 2) and (2, 2)."""
    from deepspeed_tpu.parallel import mesh as jmesh

    out = {}
    for kind in ("gpt2", "llama"):
        s = side(kind)
        for data, stage in JAX_RUNS.items():
            jmesh.reset_mesh()
            mesh = j_initialize_mesh(data=data, model=2,
                                     devices=jax.devices()[:2 * data])
            engine, *_ = ds.initialize(
                model=s.jmodel, config=config(stage, data,
                                              MESHES[(data, stage)]),
                mesh=mesh, sharding_rules=JRules(s.rules),
                model_parameters=jax.tree_util.tree_map(np.array, s.params))
            losses, norms = [], []
            for b in s.batches[:STEPS]:
                losses.append(float(engine.train_batch(batch=b)))
                norms.append(float(engine.get_global_grad_norm()))
            st = engine.state
            tree = st["master"] if st.get("master") is not None \
                else st["params"]
            out[(kind, data)] = {"losses": losses, "norms": norms,
                                 "targets": s.fp32(tree)}
        jmesh.reset_mesh()
    return out


@pytest.fixture(scope="module")
def port(started):
    return {data: job.join() for data, job in started.items()}


def _hold(got, want, kind):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=FP32["loss"])
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=FP32["loss"])
    assert sorted(got["targets"]) == sorted(want["targets"])
    C = GPT2["n_embd"]
    for name, val in got["targets"].items():
        diff = (val.float() - want["targets"][name].float()).abs()
        if kind == "gpt2" and name.endswith("attn.qkv.bias"):
            key = diff[C:2 * C].max().item()
            assert key <= FP32["key"], f"{name} keys: {key}"
            diff = torch.cat([diff[:C], diff[2 * C:]])
        assert diff.max().item() <= FP32["atol"], \
            f"{name}: {diff.max().item()}"


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
@pytest.mark.parametrize("data,stage", sorted(MESHES))
def test_ranks_match_the_jax_engine_at_the_same_mesh(jax_side, port, kind,
                                                     data, stage):
    ranks = port[data]
    got = ranks[0][(kind, stage)]
    for r in ranks[1:]:
        assert r[(kind, stage)]["losses"] == got["losses"]
        assert r[(kind, stage)]["norms"] == got["norms"]
    _hold(got, jax_side[(kind, data)], kind)


@pytest.mark.parametrize("layer", ["column", "row", "embedding", "head",
                                   "tied_head", "shared_heads"])
def test_parallel_layers_match_the_plain_layers(port, layer):
    for r in port[1]:
        assert r["probe"]["layers"][layer] <= 1e-5, layer


@pytest.mark.parametrize("key", sorted(ONE_RANK))
def test_other_placements_match_one_rank(port, key):
    """Against the same model on one rank without a process group: the
    losses and norms within 1e-5 relative, the weights within 2e-6 on
    ``test_torch_zero_dp.py``'s own-stages bound (``SAME`` there: only
    the order of fp32 sums differs), both ranks alike."""
    got = port[1][0][key]
    assert port[1][1][key]["losses"] == got["losses"]
    want = train_run(one_rank_run(key, model=1))
    PM.reset_mesh()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert sorted(got["targets"]) == sorted(want["targets"])
    for name, val in got["targets"].items():
        assert (val - want["targets"][name]).abs().max().item() <= 1e-5, name


def test_rank_order_matches_the_jax_mesh():
    """A rank's (data, model) coordinate is the JAX mesh's for the same
    device index: data-major, the model axis innermost, so a model group
    is a block of consecutive ranks."""
    from deepspeed_tpu.parallel import mesh as jmesh

    jmesh.reset_mesh()
    jm = j_initialize_mesh(data=2, model=2, devices=jax.devices()[:4])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    names = list(jm.axis_names)
    for rank in range(4):
        mesh = PM.ProcessMesh(PM.MESH_AXES, (1, 2, 1, 1, 2), rank)
        idx = where[jax.devices()[rank].id]
        assert (mesh.axis_rank("data"), mesh.axis_rank("model")) == \
            (idx[names.index("data")], idx[names.index("model")])
    jmesh.reset_mesh()


def test_all_gather_along_the_last_axis(port):
    assert all(r["probe"]["gather_last"] for r in port[1])


def test_checkpoint_at_model_2_is_the_one_rank_tree(jax_side, port,
                                                    ckpt_dir):
    """The saved tree: whole tensors under the one-rank names and shapes,
    name by name the JAX tree's (bit for bit the gathered weights the
    ranks trained); loaded at ``model`` 1 without a process group it
    resumes with the loss the two ranks took next."""
    saved = port[1][0]["ckpt"]
    tag = read_latest(ckpt_dir)
    sd = ArrayCheckpointEngine().load(checkpoint_meta_path(ckpt_dir, tag,
                                                           "model"))
    want = jax_side[("gpt2", 1)]["targets"]
    assert sd["mp_world_size"] == 2
    for tree in (sd["module"], sd["master"] or sd["module"]):
        assert sorted(tree) == sorted(want)
        for name, val in tree.items():
            assert tuple(np.shape(val)) == tuple(want[name].shape), name
    for name, val in saved["targets"].items():
        np.testing.assert_array_equal(np.asarray(sd["module"][name],
                                                 np.float32), val.numpy())
    run = dict(model=side("gpt2").spec(), config=dict(
        config(2, 1, 4), mesh={"data": 1, "model": 1}), load=ckpt_dir,
        batches=side("gpt2").batches[STEPS:])
    one = train_run(run)
    np.testing.assert_allclose(one["losses"][0], saved["next_losses"][0],
                               rtol=1e-6)
    PM.reset_mesh()


@pytest.mark.parametrize("data,stage", [(1, 0), (2, 3)])
def test_bytes_at_rest_follow_the_rank_shapes(port, data, stage):
    """A rank's bytes at rest equal the policy's prediction over its
    tensor-parallel shapes (``local_shapes``), and at (1, 2) a rank holds
    less than the whole model but more than half (the norms, the odd
    vocabulary's embedding and the row projections' biases whole)."""
    s = side("gpt2")
    model = PG.GPT2LMHeadModel(s.pcfg)
    full = {k: tuple(v.shape) for k, v in s.state.items()}
    zero = DeepSpeedZeroConfig(stage=stage,
                               stage3_param_persistence_threshold=THRESHOLD)
    whole = sum(math.prod(v) for v in full.values()) * 4
    for rank, r in enumerate(port[data]):
        mesh = PM.ProcessMesh(PM.MESH_AXES, (1, data, 1, 1, 2), rank)
        plan = MI.tp_plans(model, MI.get_policy_rules(model), mesh)[
            mesh.axis_rank("model")]
        shapes = MI.local_shapes(plan, full, MI.head_dim_of(model))
        want = ZeroShardingPolicy(zero, mesh).bytes_at_rest(
            shapes, param_itemsize=4, keep_master=False, moments=2)
        assert r[("gpt2", stage)]["bytes"] == want, rank
        if data == 1:
            assert whole / 2 < want["params"] < whole


@pytest.mark.parametrize("which", [0, 1], ids=["gpt2", "llama"])
def test_dropout_leaves_the_group_one_residual_stream(port, which):
    ranks = [r["probe"]["hidden"][which] for r in port[1]]
    dropped, clean = ranks[0]
    assert not torch.equal(dropped, clean)
    for h, c in ranks[1:]:
        assert torch.equal(h, dropped) and torch.equal(c, clean)


def test_fused_ln_linear_raises_above_one_model_rank(port):
    from deepspeed_tpu.parallel import mesh as jmesh

    jmesh.reset_mesh()
    j_initialize_mesh(data=1, model=2, devices=jax.devices()[:2])
    jcfg = dataclasses.replace(side("gpt2").jcfg, fused_ln_linear=True)
    with pytest.raises(ValueError, match="model parallelism") as jax_exc:
        JG._use_fused_ln(jcfg)
    jmesh.reset_mesh()
    for r in port[1]:
        msg = r["probe"]["fused"]
        assert msg and "does not compose with model parallelism" in msg
        assert "does not compose with model parallelism" in \
            str(jax_exc.value)
