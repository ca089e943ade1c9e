"""The captured decode step (``enable_cuda_graph``) on the CPU, against the
eager step and the JAX package.

On a CPU engine the switch runs the same static-buffer step body that a
CUDA engine captures, eagerly (``inference/decode_graph.py``), so these
tests drive everything but the capture call itself: static inputs, one
step per signature and cache, the contiguous and paged routes, the
sync-free page writes that a captured paged step needs, and the pools
keeping their tensors in place. Capture and replay on the card are in
``tests/test_torch_cuda_kernels.py``.

Oracles. The static-buffer step must equal the eager step bit for bit (the
same operations on the same inputs). Against the JAX module's decode
(weights through ``checkpoint.flax_import``, its plain einsum decode):
fp32 logits within 1e-4 (summation order over two layers), the int8 cache
within 2e-3 (a rounding step of one quantized row, as in
``test_torch_int8_model.py``), bf16 within 3e-2 relative L2 per row (the
two frameworks round activations to bf16 in different places).
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
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.inference.decode_graph import DecodeGraphs
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.ops.attention.paged_attention import page_writes
from deepspeed_tpu_torch.serving import PagedKVPool, RequestState, SlotPool

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            decode_kernel="off")
# name -> (family, overrides, tolerance kind)
CONFIGS = {
    "gpt2_fp32": ("gpt2", dict(dtype=jnp.float32), "fp32"),
    "bloom_alibi_fp32": ("bloom", dict(dtype=jnp.float32), "fp32"),
    "llama_int8_cache": ("llama", dict(dtype=jnp.float32, n_kv_head=2,
                                       kv_cache_quant=True), "int8"),
    "gpt2_bf16": ("gpt2", dict(dtype=jnp.bfloat16), "bf16"),
}
PS = 8
B, T = 3, 10
STARTS = np.array([T, T - 3, T - 6], np.int32)


def _pair(family, overrides):
    jcfg = J.transformer_config(family, **{**TINY, **overrides})
    jm = J.TransformerLM(jcfg)
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    pcfg = P.TransformerConfig(**{**fields, "decode_kernel": "auto"})
    pm = P.TransformerLM(pcfg)
    pm.load_state_dict(state_dict_from_flax(pcfg, params))
    return jm, params, pm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    family, overrides, tol = CONFIGS[request.param]
    jm, params, pm = _pair(family, overrides)
    ids = np.random.default_rng(0).integers(0, 64, (B, T)).astype(np.int32)
    prefill = jax.jit(lambda p, i: jm.apply({"params": p}, i,
                                            method=jm.prefill,
                                            mutable=["cache"]))
    decode = jax.jit(lambda v, t, s: jm.apply(v, t, s, method=jm.decode,
                                              mutable=["cache"]))
    _, jvars = prefill(params, jnp.asarray(ids))
    _, cache = pm.prefill(torch.from_numpy(ids).long())
    toks = np.random.default_rng(1).integers(0, 64, (3, B, 1))
    # the JAX reference: three decode steps at per-slot starts
    jcache = {"cache_store": {**jvars["cache"]["cache_store"],
                              "index": jnp.asarray(STARTS)}}
    want = []
    for tok in toks:
        jl, jv = decode({"params": params, "cache": jcache},
                        jnp.asarray(tok.astype(np.int32)),
                        jnp.asarray(STARTS + len(want)))
        jcache = jv["cache"]
        want.append(np.asarray(jl, np.float32))
    return dict(pm=pm, cache=cache, toks=toks, want=want, tol=tol)


def _close(got, want, tol, what):
    got = got.float().numpy()
    if tol == "bf16":
        rel = (np.linalg.norm(got - want, axis=-1)
               / np.linalg.norm(want, axis=-1)).max()
        assert rel <= 3e-2, f"{what}: rel err {rel}"
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 if tol == "fp32" else 2e-3,
                                   err_msg=what)


def _pages(pm, cache):
    """The prefilled rows in a page pool (with its scratch page) and its
    table, through PagedKVPool.admit_rows."""
    pool = PagedKVPool(pm.kv_cache_spec(), num_slots=B, page_size=PS,
                       device="cpu", prefix_cache=False)
    slots = [pool.alloc() for _ in range(B)]
    pool.admit_rows(cache, slots, np.full(B, T))
    for s, n in zip(slots, STARTS):
        pool.ensure_writable(s, 0, int(n) + 3)
    return pool


@pytest.mark.parametrize("route", ["contiguous", "paged"])
def test_static_step_equals_eager_step_and_jax(case, route):
    pm, toks, want = case["pm"], case["toks"], case["want"]
    if route == "paged":
        pool = _pages(pm, case["cache"])
        eager_cache, table = pool.cache, pool.table_dev
        graph_cache = {k: v.clone() for k, v in eager_cache.items()}
    else:
        eager_cache = {k: v.clone() for k, v in case["cache"].items()}
        graph_cache = {k: v.clone() for k, v in case["cache"].items()}
        table = None
    graphs = DecodeGraphs(pm, "cpu")
    for step, tok in enumerate(toks):
        tok = torch.from_numpy(tok).long()
        pos = torch.from_numpy(STARTS + step)
        if route == "paged":
            eager = pm.decode_paged(tok, pos, eager_cache, table,
                                    scratch_page=True)
        else:
            eager = pm.decode(tok, pos, eager_cache)
        got = graphs.run(route, graph_cache, tok, pos, table)
        assert torch.equal(got, eager), f"step {step}"
        _close(got, want[step], case["tol"], f"{route} step {step}")
    assert graphs.captures == 1          # one signature, one cache
    for key in eager_cache:
        assert torch.equal(graph_cache[key], eager_cache[key]), key
    # another cache of the same signature gets a step of its own
    other = {k: v.clone() for k, v in graph_cache.items()}
    graphs.run(route, other, tok, pos, table)
    assert graphs.captures == 2


def test_engine_switch_routes_decode_through_the_graphs():
    _, _, pm = _pair("gpt2", dict(dtype=jnp.float32))
    eng = dst.init_inference(pm, config={"dtype": "float32",
                                         "enable_cuda_graph": True},
                             device="cpu")
    assert eng.decode_graphs is not None
    off = dst.init_inference(pm, config={"dtype": "float32"}, device="cpu")
    assert off.decode_graphs is None
    ids = np.random.default_rng(2).integers(0, 64, (B, T))
    _, c1 = off.prefill_at(ids)
    c2 = {k: v.clone() for k, v in c1.items()}
    for step in range(3):
        tok = [[step], [5], [9]]
        a = off.decode(c1, tok, T + step)
        b = eng.decode(c2, tok, T + step)
        assert torch.equal(a, b)
    assert eng.decode_graphs.captures == 1
    pool = PagedKVPool(pm.kv_cache_spec(), num_slots=B, page_size=PS,
                       device="cpu")
    with pytest.raises(ValueError, match="scratch page"):
        eng.decode_paged(pool.cache, [[1]] * B, 0, pool.table_dev)
    with pytest.raises(ValueError, match="cannot be captured"):
        dst.ServingEngine(eng, num_slots=2, paged_kv={"kernel": "off"})


@pytest.fixture(scope="module")
def gen_pair():
    jm, params, pm = _pair("gpt2", dict(dtype=jnp.float32))
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    eng = dst.init_inference(pm, config={"dtype": "float32",
                                         "enable_cuda_graph": True},
                             device="cpu")
    return jeng, eng, pm


def test_generate_with_the_switch_equals_jax(gen_pair):
    jeng, eng, pm = gen_pair
    ids = np.random.default_rng(4).integers(0, 64, (2, 7)).astype(np.int32)
    want = np.asarray(jeng.generate(ids, max_new_tokens=8))
    got = eng.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    got = eng.generate(ids, max_new_tokens=8)       # the same static cache
    np.testing.assert_array_equal(got, want)
    assert eng.decode_graphs.captures == 1
    eos = int(want[0, 7 + 2])                       # row 0's third token
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=8, eos_token_id=eos),
        np.asarray(jeng.generate(ids, max_new_tokens=8, eos_token_id=eos)))
    # sampled: the draw runs after the replay with the caller's generator,
    # so the tokens are the eager engine's for the same seed
    off = dst.init_inference(pm, config={"dtype": "float32"}, device="cpu")
    for seed in (0, 1):
        kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8,
                  top_k=20, seed=seed)
        np.testing.assert_array_equal(eng.generate(ids, **kw),
                                      off.generate(ids, **kw))


def test_sync_free_page_writes_equal_the_selected_ones():
    """Sentinel entries, positions past the table, negative positions and
    whole free rows: the scratch form writes exactly the selected form's
    rows into the real pages and everything it drops into the scratch
    page, so no page outside the live targets changes."""
    rng = np.random.default_rng(6)
    Pn, ps, max_pages, W = 24, 4, 5, 3
    Bn = 4
    table = rng.permutation(Pn)[:Bn * max_pages].reshape(Bn, max_pages)
    table[rng.random(table.shape) < 0.3] = Pn       # unmapped entries
    table[3] = Pn                                   # a free row
    # distinct positions within a row, distinct pages across rows: no two
    # live writes share a target
    positions = np.stack([rng.permutation(max_pages * ps)[:W]
                          for _ in range(Bn)])
    positions[0, 2] = max_pages * ps + 1            # past the table
    positions[1, 0] = -1
    table, positions = torch.from_numpy(table).int(), torch.from_numpy(
        positions)
    rows = torch.randn(Bn * W, 2, 6)
    base = torch.randn(Pn + 1, 2, ps, 6)

    sel, page, offs = page_writes(positions, table, Pn, ps)
    old = base[:Pn].clone()
    old[page, :, offs] = rows[sel]
    none, page2, offs2 = page_writes(positions, table, Pn, ps, scratch=True)
    assert none is None and page2.shape == (Bn * W,)
    new = base.clone()
    new[page2, :, offs2] = rows
    assert torch.equal(new[:Pn], old)
    live = set(page.tolist())
    for p in range(Pn):
        if p not in live:
            assert torch.equal(new[p], base[p]), p
    dropped = Bn * W - len(sel)
    assert dropped > 0 and (page2 == Pn).sum().item() == dropped


def test_model_scratch_write_equals_dropped_write(case):
    """decode_paged with the scratch page gives the logits and real pages
    of the selecting form on pages without one (slot 2 is a free row: its
    writes are dropped and its logits are padding)."""
    pm = case["pm"]
    pool = _pages(pm, case["cache"])
    Pn = pool.num_pages
    tok = torch.from_numpy(case["toks"][0]).long()
    table = pool.table_dev.clone()
    table[2] = Pn
    with_scratch = {k: v.clone() for k, v in pool.cache.items()}
    without = {k: v[:, :Pn].clone() for k, v in pool.cache.items()}
    a = pm.decode_paged(tok, torch.from_numpy(STARTS), with_scratch, table,
                        scratch_page=True)
    b = pm.decode_paged(tok, torch.from_numpy(STARTS), without, table)
    torch.testing.assert_close(a[:2], b[:2], rtol=0, atol=1e-5)
    for key in without:
        assert torch.equal(with_scratch[key][:, :Pn], without[key]), key


def test_pools_keep_their_tensors_in_place():
    spec = P.KVCacheSpec(n_layer=2, kv_heads=2, head_dim=8,
                         dtype=torch.float32, max_seq_len=32, quant=True)
    for pool in (SlotPool(spec, 3, "cpu"),
                 PagedKVPool(spec, 3, num_pages=10, page_size=8,
                             device="cpu")):
        ptrs = {k: v.data_ptr() for k, v in pool.cache.items()}
        pos_ptr = pool.positions_dev().data_ptr()
        paged = isinstance(pool, PagedKVPool)
        table_ptr = pool.table_dev.data_ptr() if paged else None
        for leaf in pool.cache.values():
            leaf.fill_(1)
        s = pool.alloc()
        pool.admit_rows(spec.stacked_cache(1, "cpu"), [s], [12])
        pool.starts[s] = 12
        if paged:
            pool.ensure_writable(s, 12, 20)
            assert pool.table_dev.data_ptr() == table_ptr
            np.testing.assert_array_equal(pool.table_dev.numpy(), pool.table)
        pool.release(s)
        pool.reset()
        assert {k: v.data_ptr() for k, v in pool.cache.items()} == ptrs
        assert all(not v.any() for v in pool.cache.values())
        assert pool.positions_dev().data_ptr() == pos_ptr
        if paged:
            assert pool.table_dev.data_ptr() == table_ptr
            assert (pool.table_dev == pool.num_pages).all()
            assert pool.cache["k"].shape[1] == pool.num_pages + 1
            assert pool.page_nbytes == 2 * 8 * 2 * 2 * (8 + 4)


def test_captured_server_matches_the_eager_server():
    """A server over an engine with the switch: one decode step per server
    whatever the churn, the same greedy tokens as the eager server, and
    the token vector kept in place."""
    _, _, pm = _pair("llama", dict(dtype=jnp.float32, n_kv_head=2,
                                   kv_cache_quant=True))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 64, n).astype(np.int32)
               for n in (5, 19, 9, 30, 3)]
    budgets = [6, 4, 9, 5, 7]
    out = {}
    for arm, switch in (("eager", False), ("graph", True)):
        eng = dst.init_inference(pm, config={"dtype": "float32",
                                             "enable_cuda_graph": switch},
                                 device="cpu")
        for paged in (False, {"page_size": PS}):
            srv = dst.ServingEngine(eng, num_slots=2, prefill_chunk=PS,
                                    paged_kv=paged)
            cur = srv._cur.data_ptr()
            reqs = [srv.submit(p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            srv.run_until_drained(max_steps=300)
            srv.check_invariants()
            assert all(r.state is RequestState.FINISHED for r in reqs)
            assert srv._cur.data_ptr() == cur
            out[arm, bool(paged)] = [r.tokens() for r in reqs]
        if switch:
            # one contiguous and one paged step, each captured once
            assert eng.decode_graphs.captures == 2
    for paged in (False, True):
        for a, b in zip(out["eager", paged], out["graph", paged]):
            np.testing.assert_array_equal(a, b)
