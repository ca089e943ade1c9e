"""The serving keys above one rank of a model group, held against the JAX
server on its TP mesh: the port over two gloo ranks against the JAX engine
on a ``(data=1, model=2)`` mesh of the conftest's virtual CPU devices.

Model: ``test_torch_tp_serving.py``'s tiny GQA llama (vocab 64, n_embd
32, 2 layers, 4 query heads over 2 KV heads, fp32, random numpy weights
through the weight bridge), served on its paged server (4 slots, chunk 8,
8-position pages, prefix cache) over its workload.

* the int8 STORAGE tier (``quant`` on an fp32 engine, as above one rank
  both packages keep it): at ``group_size`` 8, whose groups never cross a
  shard boundary, and 64, whose groups do (a column-parallel shard holds
  half of every 64-value group of q, k, v, gate and up), every rank's
  served weight equals its shard of the JAX ``_dequant`` output bit for
  bit, logits within 1e-5 relative, ``generate()`` the JAX engine's
  tokens, and a rank's bytes at rest under 0.6 (group 64) and 0.75 (group
  8: a scale every 8 values) of the one-rank storage engine's; at group 8
  every weight dequantizes through a reshape against its scales
  (``GroupDequant``), at 64 the cut q, k, v, gate and up through the
  per-element group index (``ShardDequant``);
* an ``int8_weights`` model (the JAX ``quantize_lm_params`` tree through
  the bridge: ``QuantDense`` columns, ``RowParallelQuantDense`` rows, the
  per-rank ``int8_matmul`` products summed): logits within 2e-3 (both
  sides round each projection's input to bf16; the summation order moves
  a value across a rounding boundary, ``test_torch_int8_model.py``), and
  ``generate()`` and the paged server the JAX int8 engine's tokens;
  ``gather_tensor`` puts every rank's int8 weights and scales back whole;
* the small-model drafter (its engine over the same model group) gives
  the JAX TP server's greedy tokens;
* the cost model: a rank's flops over the traffic, times 2, within 1% of
  the one-rank server's;
* the clocked keys together (``deadline_default_ms``, a submission's
  ``deadline_ms``, ``step_wall_budget_ms``, ``degradation``,
  ``priority``, ``fault_injector``'s slow dispatches and the numerics
  guard), with no shared clock: rank 0 reads the JAX server's fake clock,
  rank 1 one 5e4 s off it that runs 700x faster. Every request's state,
  reasons, tokens and class, every step's load state and the overruns
  equal the JAX server's on both ranks, with no slot or page leaked.

One spawn (about 15 s, started before the JAX side runs); JAX: four TP
engines, three servers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer_lm as JL
from deepspeed_tpu.ops.quantization.convert import \
    quantize_lm_params as jax_quantize_lm_params
from deepspeed_tpu.parallel import initialize_mesh as j_initialize_mesh
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import resilience as jres
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as PL
from deepspeed_tpu_torch.module_inject import shard_tensor
from deepspeed_tpu_torch.ops.quantization import DENSE_KEYS

import deepspeed_tpu_torch as dst
from _torch_dist import FakeClock, clocked_injector, clocked_run, start
from _torch_threads import one_thread  # noqa: F401

LLAMA = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2)
NEW = 6
PAGED = dict(num_slots=4, prefill_chunk=8,
             paged_kv={"page_size": 8, "num_pages": 48,
                       "prefix_cache": True})
GROUPS = (8, 64)
REST = {8: 0.75, 64: 0.6}
INT8_ATOL = 2e-3
# the clocked keys (module docstring): every third request on a 25 ms
# deadline in the lowest class, slow dispatches (50 ms of fake clock) at
# the 2nd, 5th and 9th step, a 20 ms wall budget, a 30 ms step-gap p99
CLOCKED = dict(
    deadline_default_ms=2000.0, step_wall_budget_ms=20.0,
    degradation={"queue_pressured": 4, "queue_overloaded": 9,
                 "gap_p99_pressured_ms": 30.0,
                 "gap_p99_overloaded_ms": 200.0, "window": 8,
                 "cooldown_steps": 3},
    priority=True, guard_numerics=True)
SLOW, TICK, T0 = [2, 5, 9], 0.01, 100.0


def _plan(n):
    return [{"deadline_ms": 25.0, "priority": "batch"} if i % 3 == 2 else
            {"priority": ("interactive", "standard")[i % 2]}
            for i in range(n)]


def _workload():
    """``test_torch_tp_serving.py``'s workload."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 64, size=int(rng.integers(5, 13)))
               .astype(np.int32) for _ in range(8)]
    budgets = [int(rng.integers(4, 9)) for _ in range(8)]
    prefix = rng.integers(0, 64, 16)
    prompts += [np.concatenate([prefix, rng.integers(0, 64, 4)])
                .astype(np.int32) for _ in range(3)]
    return prompts, budgets + [5, 6, 7]


def _port_config(jcfg, **overrides):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return PL.TransformerConfig(**{**fields, "dtype": torch.float32,
                                   **overrides})


@pytest.fixture(scope="module")
def side():
    jcfg = JL.transformer_config("llama", **LLAMA, dtype=jnp.float32)
    jmodel = JL.TransformerLM(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        method=jmodel.logits))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: rng.normal(1.0, 0.1, s.shape).astype(s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.08, s.shape).astype(s.dtype), shapes)
    qparams, _ = jax_quantize_lm_params(params, DENSE_KEYS - {"lm_head"})
    qparams = jax.tree_util.tree_map(np.asarray, qparams)
    jcfg_q = dataclasses.replace(jcfg, int8_weights=True)
    pcfg, pcfg_q = _port_config(jcfg), _port_config(jcfg_q)
    ids = np.random.default_rng(5).integers(0, 64, (2, 7)).astype(np.int32)
    return dict(jmodel=jmodel, params=params, jmodel_q=JL.TransformerLM(
        jcfg_q), qparams=qparams, pcfg=pcfg, ids=ids,
        model=(pcfg, state_dict_from_flax(pcfg, params)),
        qmodel=(pcfg_q, state_dict_from_flax(pcfg_q, qparams)))


@pytest.fixture(scope="module")
def port(side, tmp_path_factory):
    """The two ranks, started before the JAX side runs; joined on first
    use."""
    prompts, budgets = _workload()
    job = start("tp_keys", 2, tmp_path_factory.mktemp("tp_keys"),
                timeout=200, model=side["model"], qmodel=side["qmodel"],
                ids=side["ids"], new=NEW, prompts=prompts, budgets=budgets,
                server=PAGED, clocked=dict(CLOCKED, plan=_plan(len(prompts)),
                                           slow=SLOW, tick=TICK, t0=T0))
    yield job
    job.join()


@pytest.fixture(scope="module")
def jax_side(side, port):
    from deepspeed_tpu.parallel import mesh as jmesh

    prompts, budgets = _workload()
    mesh = j_initialize_mesh(data=1, model=2, devices=jax.devices()[:2])
    out = {}

    def engine(module, params, **config):
        return ds.init_inference(module, model_parameters=params,
                                 config={"dtype": "float32", "mp_size": 2,
                                         **config}, mesh=mesh)

    def tokens(srv):
        reqs = [srv.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        srv.run_until_drained(max_steps=500)
        return [list(map(int, r.output_tokens)) for r in reqs]

    eng = engine(side["jmodel"], side["params"])
    out["paged"] = tokens(JServingEngine(eng, max_queue_depth=32, **PAGED))
    clock = FakeClock(T0, TICK)
    srv = JServingEngine(
        eng, max_queue_depth=32, clock=clock,
        fault_injector=clocked_injector(jres, clock, seed=0, slow_ms=50.0,
                                        schedule={"slow_dispatch": SLOW}),
        **PAGED, **CLOCKED)
    out["clocked"] = clocked_run(jres, srv, clock, prompts, budgets,
                                 _plan(len(prompts)))
    for gs in GROUPS:
        q = engine(side["jmodel"], side["params"],
                   quant={"enabled": True, "group_size": gs})
        q._ensure_params(np.zeros((1, 8), np.int32))
        out[f"storage{gs}"] = dict(
            weights=state_dict_from_flax(side["pcfg"], jax.tree_util.tree_map(
                np.asarray, q._dequant(q.params))),
            logits=np.asarray(q.forward(side["ids"]), np.float32),
            generate=np.asarray(q.generate(side["ids"], max_new_tokens=NEW)))
    q = engine(side["jmodel_q"], side["qparams"])
    out["int8_weights"] = dict(
        logits=np.asarray(q.forward(side["ids"]), np.float32),
        generate=np.asarray(q.generate(side["ids"], max_new_tokens=NEW)),
        server=tokens(JServingEngine(q, max_queue_depth=32, **PAGED)))
    jmesh.reset_mesh()
    return out


@pytest.fixture(scope="module")
def ranks(port):
    return port.join()


@pytest.fixture(scope="module")
def one_rank(side):
    """The port on one rank: the storage tier's bytes at rest at each
    group size and the cost model's flops over the workload."""
    prompts, budgets = _workload()

    def engine(**config):
        return dst.init_inference(
            PL.TransformerLM(side["pcfg"]), model_parameters=side["model"][1],
            config={"dtype": "float32", **config}, device="cpu")

    out = {}
    for gs in GROUPS:
        mod = engine(quant={"enabled": True, "group_size": gs}).module
        out[gs] = sum(t.numel() * t.element_size()
                      for t in mod.state_dict().values())
    srv = dst.ServingEngine(engine(), max_queue_depth=32, cost_model=True,
                            **PAGED)
    for p, b in zip(prompts, budgets):
        srv.submit(p, max_new_tokens=b)
    srv.run_until_drained(max_steps=500)
    out["flops"] = srv.costs.flops_total
    return out


def _rel(got, want) -> float:
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


@pytest.mark.parametrize("gs", GROUPS)
def test_storage_tier_shards_dequantize_to_jax(side, jax_side, ranks,
                                               one_rank, gs):
    want = jax_side[f"storage{gs}"]
    hd = LLAMA["n_embd"] // LLAMA["n_head"]
    cut = 0
    for r in ranks:
        got = r[f"storage{gs}"]
        plan = got["plan"]
        for key, whole in want["weights"].items():
            mine = shard_tensor(plan, key, whole, hd)
            cut += mine.shape != whole.shape
            assert torch.equal(got["weights"][key], mine), (gs, key)
        assert _rel(got["logits"], want["logits"]) <= 1e-5
        np.testing.assert_array_equal(np.asarray(got["generate"]),
                                      want["generate"])
        assert got["bytes"] < REST[gs] * one_rank[gs], (got["bytes"],
                                                        one_rank[gs])
        # a cut along whole groups dequantizes through a reshape; only a
        # cut that breaks groups indexes each element's group
        assert got["dequant"] == (["GroupDequant"] if gs == 8 else
                                  ["GroupDequant", "ShardDequant"]), \
            (gs, got["dequant"])
    assert cut > 0


def test_int8_weights_model_matches_jax(jax_side, ranks):
    want = jax_side["int8_weights"]
    for r in ranks:
        got = r["int8_weights"]
        assert got["kinds"] == ["QuantDense", "RowParallelQuantDense"]
        # gather_tensor puts the int8 weights and scales back whole
        assert len(got["gathered"]) == 2 * 7 * LLAMA["n_layer"]
        assert all(got["gathered"].values()), got["gathered"]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=INT8_ATOL, rtol=0)
        np.testing.assert_array_equal(np.asarray(got["generate"]),
                                      want["generate"])
        srv = got["server"]
        assert srv["finished"] and srv["no_leak"]
        assert srv["tokens"] == want["server"]


def test_small_model_drafter_matches_jax(jax_side, ranks):
    for r in ranks:
        got = r["spec_model"]
        assert got["finished"] and got["no_leak"]
        assert got["tokens"] == jax_side["paged"]


def test_cost_model_charges_a_rank_its_share(jax_side, ranks, one_rank):
    for r in ranks:
        assert r["cost"]["tokens"] == jax_side["paged"]
        got = 2 * r["cost"]["flops"]
        assert abs(got - one_rank["flops"]) <= 0.01 * one_rank["flops"], \
            (got, one_rank["flops"])


def test_clocked_keys_read_rank_zero_clock(jax_side, ranks):
    want_reqs, want_loads, want_overruns = jax_side["clocked"]
    # the clock decided something: expiries, overruns, load states
    assert sum(req[2] == "deadline" for req in want_reqs) > 0
    assert want_overruns > 0 and len(set(want_loads)) > 1
    for r in ranks:
        reqs, loads, overruns = r["clocked"]
        assert reqs == want_reqs
        assert loads == want_loads
        assert overruns == want_overruns
        assert r["clocked_leak"]
