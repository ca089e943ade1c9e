"""Tensor-parallel serving: the port over model groups of 2 and 4 gloo ranks
against the JAX engine on a ``(data=1, model=N)`` mesh of the conftest's
virtual CPU devices.

Model: a tiny GQA llama ``TransformerLM`` (vocab 64, n_embd 32, 2 layers,
4 query heads over 2 KV heads, 64 positions, fp32), random numpy weights
(the JAX tree's shapes by ``jax.eval_shape``) through the weight bridge.
At N=2 each rank holds 2 query heads and 1 KV head; at N=4 one query head
and the KV head it reads, each KV head kept whole on the two ranks that
share it (GSPMD splits KV heads in halves there; the placements differ,
the results may not).

* ``generate()`` at N=2 and N=4: greedy tokens equal the JAX engine's on
  its TP mesh and the forward's logits agree within 1e-5 relative per
  position (only the order of fp32 sums differs: the row-parallel
  projections sum per rank, then across ranks);
* ``init_serving`` at N=2, contiguous (4 slots) and paged (chunk 8,
  8-position pages, prefix cache), over ``tests/unit/serving/
  test_tp_serving.py``'s workload plus three prompts on a shared 16-token
  prefix: tokens equal the JAX TP servers' and are the same on every rank,
  the prefix cache is hit, no slot or page leaks; at N=4 the same on
  every rank;
* a ``(data=2, model=2)`` mesh over the world of 4: each data rank holds
  half the contiguous pool's slots (the paged pool whole), and both
  servers give the JAX TP servers' tokens on every rank;
* ``tp_size`` 1 on a one-rank mesh is bit-equal to no mesh;
* every serving key runs at N=2 on the paged server with no ``clock=``
  and gives the JAX TP server's tokens on every rank, with no slot or page
  leaked, and what the key computes holds: the clocked keys' stamps and
  overruns are rank 0's on every rank, a NaN row on rank 1 alone fails on
  every rank, speculative decoding drafts, the cost model charges a rank
  half the whole model's terms, a prefill/decode pair behind
  ``ReplicaRouter`` moves half a page a rank, the HTTP front end on rank 0
  streams the tokens while rank 1 follows, and the int8 storage tier
  ``generate()``s the JAX storage tier's tokens; ``enable_cuda_graph``,
  ``zero`` and ``ZeroInferenceEngine`` still raise ``NotImplementedError``;
* a rank that reports another digest makes every rank raise
  ``RankDivergenceError`` at the step's grant, with its slot back;
* GPT-2 above one rank (refused until tensor-parallel training brought
  the per-head qkv split): ``GPT2LMHeadModel`` through ``init_inference``
  at ``mp_size`` 2 gives the one-rank model's logits, and through
  ``initialize`` with ``mesh.model`` 2 the one-rank loss; a gpt2-family
  ``TransformerLM`` (vocab 64: vocab-parallel embedding and tied head)
  ``generate()``s the JAX engine's tokens at ``(1, 2)``.

Two spawns (worlds 2 and 4, about 15 and 12 s, started together before
the JAX side runs); JAX: four TP engines, two servers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer_lm as JL
from deepspeed_tpu.parallel import initialize_mesh as j_initialize_mesh
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as PL
from deepspeed_tpu_torch.parallel import mesh as PM

import deepspeed_tpu_torch as dst
from _torch_dist import start
from _torch_threads import one_thread  # noqa: F401

LLAMA = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
             n_kv_head=2)
LOGITS_RTOL = 1e-5
NEW = 6
PAGED = dict(num_slots=4, prefill_chunk=8,
             paged_kv={"page_size": 8, "num_pages": 48,
                       "prefix_cache": True})
SERVERS = {"contiguous": dict(num_slots=4), "paged": PAGED}
GPT2_FAMILY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2,
                   n_head=4)
# the serving keys each run above one rank (_torch_dist._keys) ...
RUNNING = ("deadline_default_ms", "step_wall_budget_ms", "degradation",
           "fault_injector", "priority", "overlap", "spec_decode", "role",
           "cost_model", "deadline_ms", "int8", "router", "http")
# ... and the three that still raise
REFUSED = ("enable_cuda_graph", "zero", "zero_inference")


def _workload():
    """``test_tp_serving.py``'s ``_workload(seed=17)``, then three prompts
    sharing a 16-token prefix (two pages: the prefix cache's hits)."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 64, size=int(rng.integers(5, 13)))
               .astype(np.int32) for _ in range(8)]
    budgets = [int(rng.integers(4, 9)) for _ in range(8)]
    prefix = rng.integers(0, 64, 16)
    prompts += [np.concatenate([prefix, rng.integers(0, 64, 4)])
                .astype(np.int32) for _ in range(3)]
    return prompts, budgets + [5, 6, 7]


@pytest.fixture(scope="module")
def side():
    jcfg = JL.transformer_config("llama", **LLAMA, dtype=jnp.float32)
    jmodel = JL.TransformerLM(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, ids,
        method=jmodel.logits))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: rng.normal(1.0, 0.1, s.shape).astype(s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.08, s.shape).astype(s.dtype), shapes)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    pcfg = PL.TransformerConfig(**{**fields, "dtype": torch.float32})
    ids = np.random.default_rng(5).integers(0, 64, (2, 7)).astype(np.int32)
    gcfg = JL.transformer_config("gpt2", **GPT2_FAMILY, dtype=jnp.float32)
    gmodel = JL.TransformerLM(gcfg)
    gshapes = jax.eval_shape(lambda: gmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        method=gmodel.logits))["params"]
    gparams = jax.tree_util.tree_map_with_path(
        lambda path, s: rng.normal(1.0, 0.1, s.shape).astype(s.dtype)
        if path[-1].key == "scale" else
        rng.normal(0.0, 0.08, s.shape).astype(s.dtype), gshapes)
    gfields = {f.name: getattr(gcfg, f.name)
               for f in dataclasses.fields(gcfg)}
    gpcfg = PL.TransformerConfig(**{**gfields, "dtype": torch.float32})
    return dict(jmodel=jmodel, params=params, pcfg=pcfg, ids=ids,
                state=state_dict_from_flax(pcfg, params), gmodel=gmodel,
                gparams=gparams, gpt2_family=(
                    gpcfg, state_dict_from_flax(gpcfg, gparams)))


def _jax_engine(side, n):
    mesh = j_initialize_mesh(data=1, model=n, devices=jax.devices()[:n])
    return ds.init_inference(side["jmodel"], model_parameters=side["params"],
                             config={"dtype": "float32", "mp_size": n},
                             mesh=mesh)


@pytest.fixture(scope="module")
def started(side, tmp_path_factory):
    """The port's two worlds, started before the JAX side runs."""
    prompts, budgets = _workload()
    kw = dict(model=(side["pcfg"], side["state"]), ids=side["ids"], new=NEW,
              prompts=prompts, budgets=budgets)
    return {2: start("tp", 2, tmp_path_factory.mktemp("tp2"), timeout=150,
                     servers=SERVERS, refuse=True,
                     gpt2_family=side["gpt2_family"], **kw),
            4: start("tp", 4, tmp_path_factory.mktemp("tp4"), timeout=150,
                     servers=SERVERS, **kw)}


@pytest.fixture(scope="module")
def jax_side(side, started):
    """Generate and logits at N=2 and 4, the two servers at N=2."""
    from deepspeed_tpu.parallel import mesh as jmesh

    out = {}
    prompts, budgets = _workload()
    for n in (2, 4):
        eng = _jax_engine(side, n)
        assert eng.mp_world_size == n
        out[n] = dict(generate=np.asarray(
            eng.generate(side["ids"], max_new_tokens=NEW)),
            logits=np.asarray(eng.forward(side["ids"]), np.float32))
        if n == 2:
            q = ds.init_inference(side["jmodel"],
                                  model_parameters=side["params"],
                                  config={"dtype": "float32", "mp_size": 2,
                                          "quant": {"enabled": True}},
                                  mesh=eng.mesh)
            out["int8"] = np.asarray(q.generate(prompts[0][None],
                                                max_new_tokens=6))
            out["servers"] = {}
            for label, kw in SERVERS.items():
                srv = JServingEngine(eng, max_queue_depth=32, **kw)
                reqs = [srv.submit(p, max_new_tokens=b)
                        for p, b in zip(prompts, budgets)]
                srv.run_until_drained(max_steps=500)
                out["servers"][label] = [list(map(int, r.output_tokens))
                                         for r in reqs]
        jmesh.reset_mesh()
    mesh = j_initialize_mesh(data=1, model=2, devices=jax.devices()[:2])
    eng = ds.init_inference(side["gmodel"], model_parameters=side["gparams"],
                            config={"dtype": "float32", "mp_size": 2},
                            mesh=mesh)
    out["gpt2_family"] = np.asarray(eng.generate(side["ids"],
                                                 max_new_tokens=NEW))
    jmesh.reset_mesh()
    return out


@pytest.fixture(scope="module")
def port(started):
    return {n: job.join() for n, job in started.items()}


def _rel(got, want) -> float:
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


@pytest.mark.parametrize("n", [2, 4])
def test_generate_matches_jax_tp_engine(side, jax_side, port, n):
    ranks = port[n]
    assert all(r["mp"] == n for r in ranks)
    want = jax_side[n]["generate"]
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["generate"]), want)
    assert _rel(ranks[0]["logits"], jax_side[n]["logits"]) <= LOGITS_RTOL


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_its_share(port, n):
    """Sharded leaves hold 1/N (the KV heads: 2/N, at least one); norms
    stay whole."""
    H, KV, C, V = 4, 2, 32, 64
    D, F = C // H, 4 * C
    for rank, r in enumerate(port[n]):
        shapes = r["params"]
        assert shapes["embed_tokens.weight"] == (V // n, C)
        assert shapes["lm_head.weight"] == (V // n, C)
        assert shapes["blocks.0.attn.q_proj.weight"] == (H // n * D, C)
        assert shapes["blocks.0.attn.k_proj.weight"] == \
            (max(KV // n, 1) * D, C)
        assert shapes["blocks.1.attn.o_proj.weight"] == (C, H // n * D)
        assert shapes["blocks.1.mlp.down_proj.weight"] == (C, F // n)
        assert shapes["blocks.0.ln_1.weight"] == (C,)
        assert r["kv_heads"] == max(KV // n, 1)
        plan = r["plan"]
        assert plan.q_heads == (rank * H // n, (rank + 1) * H // n)
        assert plan.kv_heads[0] == rank * H // n // (H // KV)


@pytest.mark.parametrize("label", sorted(SERVERS))
def test_servers_match_jax_tp_server(jax_side, port, label):
    want = jax_side["servers"][label]
    for r in port[2]:
        got = r["servers"][label]
        assert got["finished"] and got["no_leak"], got
        assert got["tokens"] == want
        assert got["kv_heads"] == 1
        if label == "paged":
            assert got["hit_tokens"] > 0
    paged4 = [r["servers"]["paged"] for r in port[4]]
    assert all(p["tokens"] == jax_side["servers"]["paged"] and p["no_leak"]
               for p in paged4)


@pytest.mark.parametrize("key", REFUSED)
def test_unported_keys_raise_above_one_rank(port, key):
    for r in port[2]:
        assert r["keys"][key], key


@pytest.mark.parametrize("key", RUNNING)
def test_keys_run_above_one_rank(jax_side, port, key):
    """Each serving key at N=2 on the paged server, with no ``clock=``:
    the JAX TP server's tokens, the same on every rank, no slot or page
    leaked, and what the key computes (module docstring)."""
    want = jax_side["servers"]["paged"]
    got = [r["keys"][key] for r in port[2]]
    mine = got[0]
    if key == "int8":
        for g in got:
            np.testing.assert_array_equal(np.asarray(g["generate"]),
                                          jax_side["int8"])
        return
    assert all(g["no_leak"] for g in got), key
    if key == "http":
        assert mine["tokens"] == want
        assert mine["group_size"] == 2 and mine["metrics_group"]
        return
    assert all(g["tokens"] == mine["tokens"] and g["states"] ==
               mine["states"] for g in got), key
    if key == "fault_injector":
        # rank 1 alone wrote the NaN row; every rank failed that request
        failed = [i for i, s in enumerate(mine["states"]) if s == "failed"]
        assert len(failed) == 1
        assert [t for i, t in enumerate(mine["tokens"]) if i not in failed] \
            == [t for i, t in enumerate(want) if i not in failed]
        return
    assert mine["finished"] and mine["tokens"] == want, key
    if key in ("deadline_default_ms", "deadline_ms"):
        # rank 0's readings stamped every rank's requests
        assert None not in mine["deadlines"]
        assert all(g["deadlines"] == mine["deadlines"] for g in got)
    elif key == "step_wall_budget_ms":
        assert mine["overruns"] > 0
        assert all(g["overruns"] == mine["overruns"] for g in got)
    elif key == "spec_decode":
        assert mine["drafted"] > 0
    elif key == "cost_model":
        for term in ("proj", "pair", "head", "vocab", "kv_token"):
            assert 2 * mine["mine"][term] == mine["whole"][term], term
        assert mine["flops"] > 0 and mine["mfu"] > 0
        assert all(g["flops"] == mine["flops"] for g in got)
    elif key == "role":
        L, KV, D, ps = 2, 2, 8, PAGED["paged_kv"]["page_size"]
        assert mine["imported"] > 0
        assert 2 * mine["page_nbytes"] == L * 2 * KV * ps * D * 4


@pytest.mark.parametrize("entry", ["gpt2", "training"])
def test_gpt2_runs_above_one_rank(jax_side, port, entry):
    """The two GPT-2 cases this file refused until the per-head qkv split
    (module docstring): each entry point now runs over the model group."""
    for r in port[2]:
        got = r["above_one_rank"]
        if entry == "gpt2":
            assert got["serve_mp"] == 2 and got["serve_rel"] <= LOGITS_RTOL
            np.testing.assert_array_equal(np.asarray(r["gpt2_family"]),
                                          jax_side["gpt2_family"])
        else:
            assert got["train_mp"] == 2
            np.testing.assert_allclose(got["train_losses"][0],
                                       got["one_rank_loss"], rtol=1e-6)
            assert got["train_losses"][1] < got["train_losses"][0]


def test_shared_clock_and_digest_mismatch(jax_side, port):
    """The world of 4 as ``(data=2, model=2)``: rank order data-major (the
    model axis innermost, as the JAX mesh), each data rank half the
    contiguous slots and its own model group, the JAX TP servers' tokens
    on every rank; and a digest mismatch at N=2."""
    for rank, r in enumerate(port[4]):
        got = r["data_and_model"]
        assert (got["mp"], got["dp"], got["dp_rank"]) == (2, 2, rank // 2)
        for label, srv in got["servers"].items():
            assert srv["finished"] and srv["no_leak"], label
            assert srv["tokens"] == jax_side["servers"][label], label
        assert got["servers"]["contiguous"]["rows"] == \
            SERVERS["contiguous"]["num_slots"] // 2
        assert got["servers"]["paged"]["rows"] == \
            PAGED["paged_kv"]["num_pages"] + 1
    for r in port[2]:
        assert "parted at step 1 (grant)" in r["diverge"]
        assert r["diverge_leak"]


def test_clock_reads_pair_by_place(port):
    """Every rank reads the group clock at the same places, as many times
    (each server over the traffic, at N=2 and 4); a read that rank 1 makes
    alone meets rank 0's read in ``submit`` and raises on both ranks."""
    for n in (2, 4):
        for label in SERVERS:
            reads = [(r["servers"][label]["clock_reads"],
                      r["servers"][label]["steps"]) for r in port[n]]
            assert reads[0][0] > reads[0][1] > 0, (n, label, reads)
            assert all(x == reads[0] for x in reads), (n, label, reads)
    msgs = [r["clock_diverge"] for r in port[2]]
    assert all(m and "read the server's clock at different places" in m
               for m in msgs), msgs
    assert "engine.py:submit:" in msgs[0], msgs
    assert "_torch_dist.py:_tp:" in msgs[1], msgs


def test_tp1_on_a_mesh_is_bit_equal(side):
    cfg, state, ids = side["pcfg"], side["state"], side["ids"]
    out = []
    for mesh in (None, "mesh"):
        PM.reset_mesh()
        kw = {} if mesh is None else dict(mesh=PM.build_mesh(model=1),
                                          mp_size=1)
        eng = dst.init_inference(PL.TransformerLM(cfg),
                                 model_parameters=state,
                                 config={"dtype": "float32"}, device="cpu",
                                 **kw)
        assert eng.mp_world_size == 1
        out.append((eng.forward(ids), eng.generate(ids, max_new_tokens=NEW)))
    PM.reset_mesh()
    assert torch.equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
