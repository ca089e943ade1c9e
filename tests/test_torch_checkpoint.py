"""The port's checkpoints: round trips, the JAX engine's files, universal
checkpoints, the fp32 export and the Megatron-DeepSpeed GPT-2 import.

Round trips (port only, ``torch.use_deterministic_algorithms(True)``, so
"equal" means bit-equal): an engine trains 2 steps, saves, and a fresh
engine built from other random weights loads; its module, master weights,
optimizer moments, counters, loss scale and dropout generator then equal
the saver's, and 2 more steps of each give the same losses and weights as
the saver's unbroken 4. Cases: tiny GPT-2 at ZeRO stages 0 and 2 in bf16,
fp16 (a dynamic loss scale that moves) and fp32, and a tiny llama with
dropout (the generator's state must carry over). Also ``latest``,
``client_state``, ``load_module_only`` (the master re-seeded from the
loaded module) and ``load_optimizer_states=False``.

Against the JAX package: a JAX engine (tiny llama, fp32, the config of
``test_torch_training.py``) trains 2 steps and saves; the port reads the
file, ``engine_checkpoint_from_flax`` converts it, a port engine loads it
and its next 2 losses equal the JAX engine's next 2 within 1e-5 relative
(fp32 summation order), its weights within 2e-6. A bf16 port checkpoint
loads with the JAX ``ArrayCheckpointEngine`` with the JAX file's top-level
keys and ``bfloat16`` leaves. ``zero_to_fp32`` returns the master weights
exactly, and on a converted JAX checkpoint what the JAX converter returns
under bridged names, exactly. The Megatron import (synthetic tp=1 and tp=2
torch shards, built as ``tests/unit/checkpoint/test_gpt2_import.py``
builds them) gives weights equal across tp exactly and port logits equal
to the JAX import's within 1e-5 (fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.checkpoint import megatron_gpt2_to_flax
from deepspeed_tpu.checkpoint.zero_to_fp32 import \
    get_fp32_state_dict_from_zero_checkpoint as jax_zero_to_fp32
from deepspeed_tpu.models import gpt2 as JG
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.parallel import initialize_mesh
from deepspeed_tpu.runtime.checkpoint_engine.checkpoint_engine import \
    ArrayCheckpointEngine as JaxArrayCheckpointEngine
from deepspeed_tpu_torch.checkpoint import (
    convert_zero_checkpoint_to_fp32_state_dict, ds_to_universal,
    get_fp32_state_dict_from_zero_checkpoint, megatron_gpt2_state_dict,
    universal_dir)
from deepspeed_tpu_torch.checkpoint.flax_import import (
    engine_checkpoint_from_flax, state_dict_from_flax)
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine, checkpoint_meta_path, read_latest, write_latest)

from _torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
V, T = 64, 16
GPT2 = dict(vocab_size=V, n_positions=T, n_embd=32, n_layer=2, n_head=2)
LLAMA = dict(vocab_size=V, max_seq_len=T, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2)
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
PRECISION = {"fp32": ({}, torch.float32),
             "bf16": ({"bf16": {"enabled": True}}, torch.bfloat16),
             "fp16": ({"fp16": {"enabled": True, "initial_scale_power": 12,
                                "loss_scale_window": 2}}, torch.float16)}


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, V, (4, T)).astype(np.int32)}
            for _ in range(n)]


def _engine(kind="gpt2", precision="fp32", stage=2, seed=0, **config):
    extra, dtype = PRECISION[precision]
    if kind == "gpt2":
        model = PG.GPT2LMHeadModel(PG.GPT2Config(**GPT2, dtype=dtype),
                                   param_dtype=torch.float32)
    else:
        model = P.TransformerLM(P.transformer_config(
            "llama", **LLAMA, dtype=torch.float32, dropout=0.1, remat=True))
        model.replace_config(dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    cfg = dict(CONFIG, zero_optimization={"stage": stage}, **extra, **config)
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    return engine


def _snapshot(engine):
    gen = getattr(engine.module, "dropout_generator", None)
    return dict(
        module={k: v.clone() for k, v in engine.module.state_dict().items()},
        master=[m.clone() for m in engine.master or []],
        opt=[t.clone() for field in engine.opt_state for t in field],
        counters=(engine.global_steps, engine.global_samples,
                  engine.micro_steps, engine.skipped_steps,
                  engine._opt_step, engine.loss_scale_state),
        rng=gen.get_state() if gen is not None else None)


def _assert_same(a, b):
    assert a["counters"] == b["counters"]
    assert sorted(a["module"]) == sorted(b["module"])
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    for group in ("master", "opt"):
        assert len(a[group]) == len(b[group])
        assert all(torch.equal(x, y) for x, y in zip(a[group], b[group]))
    assert (a["rng"] is None) == (b["rng"] is None)
    assert a["rng"] is None or torch.equal(a["rng"], b["rng"])


@pytest.mark.parametrize("kind,precision,stage", [
    ("gpt2", "bf16", 0), ("gpt2", "bf16", 2), ("gpt2", "fp16", 2),
    ("gpt2", "fp32", 0), ("llama", "bf16", 2)])
def test_save_load_resumes_bit_equal(tmp_path, deterministic, kind,
                                     precision, stage):
    batches = _batches()
    saver = _engine(kind, precision, stage)
    for b in batches[:2]:
        saver.train_batch(batch=b)
    saver.save_checkpoint(str(tmp_path))
    assert read_latest(str(tmp_path)) == "global_step2"
    resumed = _engine(kind, precision, stage, seed=1)
    assert resumed.load_checkpoint(str(tmp_path)) == (str(tmp_path), {})
    _assert_same(_snapshot(resumed), _snapshot(saver))
    unbroken = [float(saver.train_batch(batch=b)) for b in batches[2:]]
    again = [float(resumed.train_batch(batch=b)) for b in batches[2:]]
    assert again == unbroken
    _assert_same(_snapshot(resumed), _snapshot(saver))
    if precision == "fp16":
        assert saver.loss_scale_state.loss_scale != 2.0 ** 12


def test_latest_client_state_module_only_and_without_optimizer(tmp_path):
    batches = _batches(3)
    saver = _engine(precision="bf16")
    for b in batches[:2]:
        saver.train_batch(batch=b)
    at_a = _snapshot(saver)
    saver.save_checkpoint(str(tmp_path), tag="a",
                          client_state={"epoch": 3, "note": "warm"})
    saver.train_batch(batch=batches[2])
    saver.save_checkpoint(str(tmp_path), tag="b", save_latest=False)
    assert read_latest(str(tmp_path)) == "a"

    latest = _engine(precision="bf16", seed=1)
    _, client = latest.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3, "note": "warm"}
    _assert_same(_snapshot(latest), at_a)

    module_only = _engine(precision="bf16", seed=1)
    module_only.load_checkpoint(str(tmp_path), tag="b", load_module_only=True)
    got = _snapshot(module_only)
    for k, v in saver.module.state_dict().items():
        assert torch.equal(got["module"][k], v), k
    # the master follows the loaded module, the rest is a fresh engine's
    assert all(torch.equal(m, p.float()) for m, p in
               zip(module_only.master, module_only._params))
    assert got["counters"][:5] == (0, 0, 0, 0, 0)
    assert all(not t.any() for t in got["opt"])

    no_opt = _engine(precision="bf16", seed=1)
    no_opt.load_checkpoint(str(tmp_path), tag="a",
                           load_optimizer_states=False)
    got = _snapshot(no_opt)
    assert got["counters"] == at_a["counters"]
    assert all(torch.equal(x, y) for x, y in zip(got["master"],
                                                 at_a["master"]))
    assert all(not t.any() for t in got["opt"])


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


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX engine's checkpoint after 2 steps, its next 2 losses and its
    weights after them."""
    cfg = J.transformer_config("llama", **LLAMA, dtype=jnp.float32,
                               use_flash_attention=False)
    model = J.TransformerLM(cfg)
    batches = _batches()
    params = _random_params(model, jnp.asarray(batches[0]["input_ids"]), 2)
    engine, *_ = ds.initialize(model=model, model_parameters=params,
                               config=CONFIG,
                               mesh=initialize_mesh(devices=jax.devices()[:1]))
    for b in batches[:2]:
        engine.train_batch(batch=b)
    path = tmp_path_factory.mktemp("jax_ckpt")
    engine.save_checkpoint(str(path))
    losses = [float(engine.train_batch(batch=b)) for b in batches[2:]]
    final = jax.tree_util.tree_map(np.asarray, engine.state["params"])
    return cfg, path, losses, final


def _port_llama_config(jcfg):
    return P.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})


def _convert_jax_checkpoint(jax_run, out):
    jcfg, path, _, _ = jax_run
    cfg = _port_llama_config(jcfg)
    sd = ArrayCheckpointEngine().load(
        checkpoint_meta_path(str(path), "global_step2", "model"))
    port_sd = engine_checkpoint_from_flax(cfg, sd)
    ArrayCheckpointEngine().save(
        port_sd, checkpoint_meta_path(str(out), "global_step2", "model"))
    write_latest(str(out), "global_step2")
    return cfg, sd, port_sd


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    cfg, sd, port_sd = _convert_jax_checkpoint(jax_run, tmp_path)
    assert port_sd["master"] is None and port_sd["rng"] is None
    assert sorted(port_sd["optimizer"]) == ["exp_avg", "exp_avg_sq"]
    # a master tree goes through the same rules, in fp32
    with_master = engine_checkpoint_from_flax(cfg, dict(sd,
                                                        master=sd["module"]))
    for k, v in with_master["master"].items():
        assert v.dtype == torch.float32
        assert torch.equal(v, port_sd["module"][k].float()), k
    model = P.TransformerLM(cfg)
    model.init_weights(torch.Generator().manual_seed(5))
    engine, *_ = dst.initialize(model=model, config=CONFIG, device="cpu")
    engine.load_checkpoint(str(tmp_path))
    assert (engine.global_steps, engine.micro_steps) == (2, 4)
    losses = [float(engine.train_batch(batch=b)) for b in _batches()[2:]]
    np.testing.assert_allclose(losses, jax_run[2], rtol=LOSS_RTOL)
    want = state_dict_from_flax(cfg, jax_run[3])
    for name, val in engine.module.state_dict().items():
        diff = (val - want[name]).abs().max().item()
        assert diff <= PARAM_ATOL, f"{name}: {diff}"


def test_port_files_load_with_the_jax_engine(jax_run, tmp_path):
    engine = _engine(precision="bf16")
    engine.train_batch(batch=_batches(1)[0])
    engine.save_checkpoint(str(tmp_path), tag="t")
    path = checkpoint_meta_path(str(tmp_path), "t", "model")
    got = JaxArrayCheckpointEngine().load(path)
    jax_file = JaxArrayCheckpointEngine().load(checkpoint_meta_path(
        str(jax_run[1]), "global_step2", "model"))
    assert sorted(got) == sorted(jax_file)
    module = engine.module.state_dict()
    assert sorted(got["module"]) == sorted(module)
    for k, v in got["module"].items():
        assert v.dtype.name == "bfloat16", k
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      module[k].float().numpy())
    for k, m in zip(engine._param_names, engine.master):
        np.testing.assert_array_equal(got["master"][k], m.numpy())
    assert sorted(got["optimizer"]) == ["exp_avg", "exp_avg_sq"]
    assert int(got["step"]) == int(got["global_steps"]) == 1


def test_universal_checkpoint_from_stage2_loads_at_stage0(tmp_path,
                                                         deterministic):
    batches = _batches(3)
    saver = _engine(precision="bf16", stage=2)
    for b in batches[:2]:
        saver.train_batch(batch=b)
    saver.save_checkpoint(str(tmp_path))
    out = ds_to_universal(str(tmp_path))
    assert out == universal_dir(str(tmp_path), "global_step2")
    loader = _engine(precision="bf16", stage=0, seed=1,
                     checkpoint={"load_universal": True})
    loader.load_checkpoint(str(tmp_path))
    assert loader.global_steps == 2 and loader._opt_step == 2
    assert float(loader.train_batch(batch=batches[2])) == \
        float(saver.train_batch(batch=batches[2]))


def test_zero_to_fp32_is_the_master_and_the_jax_converters(jax_run,
                                                          tmp_path):
    engine = _engine(precision="bf16")
    engine.train_batch(batch=_batches(1)[0])
    engine.save_checkpoint(str(tmp_path / "port"))
    fp32 = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert sorted(fp32) == sorted(engine._param_names)
    for k, m in zip(engine._param_names, engine.master):
        assert fp32[k].dtype == np.float32
        np.testing.assert_array_equal(fp32[k], m.numpy())
    out = tmp_path / "fp32.npz"
    convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path / "port"),
                                               str(out))
    fresh = PG.GPT2LMHeadModel(PG.GPT2Config(**GPT2, dtype=torch.bfloat16))
    with np.load(out) as data:
        fresh.load_state_dict({k: torch.from_numpy(data[k]).bfloat16()
                               for k in data.files})
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, engine.module.state_dict()[k]), k

    cfg, _, _ = _convert_jax_checkpoint(jax_run, tmp_path / "jax")
    got = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "jax"))
    want = state_dict_from_flax(cfg, jax_zero_to_fp32(str(jax_run[1]),
                                                      flat_keys=False))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy())


def _megatron_shards(tp, hidden=16, layers=2, vocab=32, positions=16):
    """Full torch GPT-2 weights from a seed, split into ``tp`` Megatron
    (version 0) shards: qkv per rank [q_r|k_r|v_r], h_to_4h and the
    embedding by rows, the two output projections by columns."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    def rows(t, i):
        return torch.chunk(t, tp, dim=0)[i]

    def cols(t, i):
        return torch.chunk(t, tp, dim=1)[i]

    def qkv(t, i):
        return torch.cat([rows(p, i) for p in torch.chunk(t, 3, dim=0)])

    full = [{"input_layernorm.weight": torch.ones(hidden),
             "input_layernorm.bias": r(hidden),
             "self_attention.query_key_value.weight": r(3 * hidden, hidden),
             "self_attention.query_key_value.bias": r(3 * hidden),
             "self_attention.dense.weight": r(hidden, hidden),
             "self_attention.dense.bias": r(hidden),
             "post_attention_layernorm.weight": torch.ones(hidden),
             "post_attention_layernorm.bias": r(hidden),
             "mlp.dense_h_to_4h.weight": r(4 * hidden, hidden),
             "mlp.dense_h_to_4h.bias": r(4 * hidden),
             "mlp.dense_4h_to_h.weight": r(hidden, 4 * hidden),
             "mlp.dense_4h_to_h.bias": r(hidden)} for _ in range(layers)]
    emb = {"word_embeddings.weight": r(vocab, hidden),
           "position_embeddings.weight": r(positions, hidden)}
    norm = {"weight": torch.ones(hidden), "bias": r(hidden)}
    split = {"self_attention.query_key_value.weight": qkv,
             "self_attention.query_key_value.bias": qkv,
             "self_attention.dense.weight": cols,
             "mlp.dense_h_to_4h.weight": rows,
             "mlp.dense_h_to_4h.bias": rows,
             "mlp.dense_4h_to_h.weight": cols}
    return [([{k: split[k](v, i) if k in split else v
               for k, v in layer.items()} for layer in full],
             {"word_embeddings.weight": rows(emb["word_embeddings.weight"],
                                             i),
              "position_embeddings.weight": emb["position_embeddings.weight"]},
             norm) for i in range(tp)]


def _write_megatron(path, shards):
    path.mkdir(parents=True)
    last = len(shards[0][0]) + 1
    for i, (layers, emb, norm) in enumerate(shards):
        torch.save(emb, path / f"layer_00-model_{i:02d}-model_states.pt")
        for li, layer in enumerate(layers):
            torch.save(layer, path / f"layer_{li + 1:02d}-model_{i:02d}"
                       f"-model_states.pt")
        torch.save(norm, path / f"layer_{last:02d}-model_{i:02d}"
                   f"-model_states.pt")
        torch.save({"iteration": 7}, path / f"mp_rank_{i:02d}_model_states.pt")
    return str(path)


def test_megatron_import_matches_the_jax_import(tmp_path):
    dims = dict(vocab_size=32, n_positions=16, n_embd=16, n_layer=2,
                n_head=2)
    pcfg = PG.GPT2Config(**dims, dtype=torch.float32)
    jcfg = JG.GPT2Config(**dims, dtype=jnp.float32, use_flash_attention=False)
    jm = JG.GPT2LMHeadModel(jcfg)
    jax_logits = jax.jit(lambda p, i: jm.apply(
        {"params": p}, i, method=JG.GPT2LMHeadModel.logits))
    ids = np.arange(12, dtype=np.int32).reshape(1, 12) % 32
    sds = []
    for tp in (1, 2):
        path = _write_megatron(tmp_path / f"tp{tp}", _megatron_shards(tp))
        sd = megatron_gpt2_state_dict(path, pcfg)
        model = PG.GPT2LMHeadModel(pcfg)
        model.load_state_dict(sd)
        want = np.asarray(jax_logits(megatron_gpt2_to_flax(path, jcfg), ids))
        got = model.logits(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        sds.append(sd)
    assert sorted(sds[0]) == sorted(sds[1])
    for k, v in sds[0].items():
        assert torch.equal(sds[1][k], v), k
