"""Disaggregated prefill/decode on the CPU: the port's fleet against the JAX
fleet on the same weights (``checkpoint.flax_import``) and requests.

A transferred page is the bits the prefill replica wrote, so a fleet's
greedy tokens are one engine's: held against ``generate()`` of both
packages and against the JAX fleet, with each request's hops (dispatch,
transfer, failover, finish, and the replica of each), the fleet topology
and the set of Prometheus series names and labels equal to the JAX
router's. Then the JAX ``test_disagg.py`` cases that need no TPU: the
adopt unwind, a destination dying mid-transfer, and the repair of the
captured decode's shared watchdog (a second server on one engine no longer
counts as a recompile in a warmed one; the JAX package counts none either).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.router import ReplicaRouter as JaxRouter
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (PagedKVPool, ReplicaRouter,
                                         RequestState, ServingEngine)
from deepspeed_tpu_torch.telemetry import RecompileAfterWarmupError

from _torch_fleet import (BUDGETS, PS, TINY, assert_generated,
                          assert_no_page_leaks, make_prompts, paged_server,
                          port_engine, warm)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def stack():
    jm = J.TransformerLM(J.transformer_config("gpt2", **TINY,
                                              dtype=jnp.float32))
    params = jm.init({"params": jax.random.PRNGKey(1)},
                     jnp.zeros((1, 8), jnp.int32), method=jm.logits)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    pcfg = P.transformer_config("gpt2", **TINY, dtype=torch.float32)
    peng = port_engine(state_dict_from_flax(pcfg, params))
    return jeng, peng


def jax_server(jeng, role="both", **kw):
    kw.setdefault("prefill_chunk", PS)
    return JaxServingEngine(jeng, num_slots=2, max_queue_depth=32,
                            paged_kv={"page_size": PS, "num_pages": None,
                                      "kernel": "off"},
                            role=role, **kw)


def _die_once(pool):
    """Arm ``pool.seat_pages`` to raise once, after ``import_pages`` has
    allocated the destination pages (a replica dying mid-transfer)."""
    real = pool.seat_pages
    armed = {"on": True}

    def seat(*a, **kw):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("replica died mid-transfer")
        return real(*a, **kw)

    pool.seat_pages = seat
    return real


def _run_fleet(router, prompts, budgets, die=None):
    """Warm, then serve the traffic; ``die``: replica index whose first
    seat after warmup raises. Returns the requests and the fleet's
    record: hops per request, topology, router counters and the
    exposition's series."""
    warm(router)
    real = _die_once(router.replicas[die].pool) if die is not None else None
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    router.run_until_drained(max_steps=800)
    if real is not None:
        router.replicas[die].pool.seat_pages = real
    router.check_invariants()
    hops = [[(h["kind"], h.get("replica"))
             for h in router.journey(r.journey_id)["hops"]] for r in reqs]
    st = router.stats()
    record = dict(
        hops=hops, topology=router.fleet_topology(),
        alive=list(router.alive_replicas),
        counters={k: st[k] for k in ("dispatched", "transfers",
                                     "transfer_bytes", "failovers",
                                     "transfer_pages_saved",
                                     "prefix_routed", "spills")},
        series=_series(router.fleet.to_prometheus()),
        recompiles=router.recompiles)
    return reqs, record


def _series(text):
    """Metric names with their label keys (values dropped), the shape of
    an exposition."""
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"([A-Za-z_:][A-Za-z0-9_:]*)(\{([^}]*)\})?", line)
        labels = tuple(sorted(kv.split("=")[0] for kv in
                              (m.group(3) or "").split(",") if kv))
        out.add((m.group(1), labels))
    return out


ARMS = {
    "disaggregated": (["prefill", "decode"], None),
    "two_both": (["both", "both"], None),
    "failover_mid_transfer": (["prefill", "decode", "decode"], 1),
}


@pytest.fixture(scope="module")
def jax_fleets(stack):
    """Each arm on the JAX fleet, once: its tokens and its record."""
    jeng, _ = stack
    prompts = make_prompts(7)
    out = {}
    for arm, (roles, die) in ARMS.items():
        router = JaxRouter([jax_server(jeng, r, strict_recompile=True)
                            for r in roles])
        reqs, record = _run_fleet(router, prompts, BUDGETS, die=die)
        out[arm] = ([r.tokens() for r in reqs], record)
    return prompts, out


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_fleet_tokens_hops_and_topology_equal_the_jax_fleet(stack,
                                                            jax_fleets,
                                                            arm):
    _, peng = stack
    prompts, jax_out = jax_fleets
    roles, die = ARMS[arm]
    router = ReplicaRouter([paged_server(peng, r, strict_recompile=True)
                            for r in roles])
    reqs, record = _run_fleet(router, prompts, BUDGETS, die=die)
    want_tokens, want = jax_out[arm]
    assert_generated(peng, reqs, prompts, BUDGETS)
    for req, toks in zip(reqs, want_tokens):
        np.testing.assert_array_equal(req.tokens(), toks)
    for key in ("hops", "topology", "alive", "counters", "recompiles"):
        assert record[key] == want[key], key
    assert record["recompiles"] == 0
    if roles[0] == "prefill":
        assert record["counters"]["transfers"] >= len(reqs)
        assert all(("transfer" in [k for k, _ in h]) for h in record["hops"])
    if die is not None:
        assert die not in record["alive"]
    for i in router.alive_replicas:
        assert_no_page_leaks(router.replicas[i])
    # the dead replica's imported pages were unwound too
    if die is not None:
        assert_no_page_leaks(router.replicas[die])


def test_prometheus_series_equal_the_jax_fleet(stack, jax_fleets):
    _, peng = stack
    prompts, jax_out = jax_fleets
    router = ReplicaRouter([paged_server(peng, r) for r in
                            ("prefill", "decode")])
    _, record = _run_fleet(router, prompts, BUDGETS)
    want = jax_out["disaggregated"][1]["series"]
    # a port engine has series the JAX engine has not, and the other way
    # round (cost and compile sources differ); the fleet's own shape must
    # agree: the router and fleet series, and every replica series'
    # labels
    fleet = {s for s in want if s[0].startswith(("router_", "fleet_"))}
    assert {s for s in record["series"]
            if s[0].startswith(("router_", "fleet_"))} == fleet
    labelled = {s for s in record["series"] if "replica" in s[1]}
    assert labelled and all(s[1][:2] in (("replica", "role"),
                                         ("le", "replica"))
                            for s in labelled)
    shared = {s[0] for s in labelled} & {s[0] for s in want}
    assert {s for s in labelled if s[0] in shared} == \
        {s for s in want if s[0] in shared}
    assert len(shared) > 20


def test_generate_of_both_packages_agree(stack, jax_fleets):
    jeng, peng = stack
    prompts, _ = jax_fleets
    for p, b in list(zip(prompts, BUDGETS))[1:3]:
        np.testing.assert_array_equal(
            peng.generate(p[None], max_new_tokens=b),
            np.asarray(jeng.generate(p[None], max_new_tokens=b)))


def _parked(pre, req):
    for _ in range(40):
        pre.step()
        if req in pre.pending_handoffs():
            return
    raise AssertionError("the request never parked")


def test_adopt_unwind_leaves_destination_pool_clean(stack):
    """A seat failure inside adopt() hands back the whole imported batch
    and the slot; the source still owns the request, and a later adopt
    succeeds."""
    _, peng = stack
    pre = paged_server(peng, role="prefill")
    dec = paged_server(peng, role="decode")
    req = pre.submit(make_prompts(13)[2], max_new_tokens=4)
    _parked(pre, req)
    free_slots = dec.pool.free_count
    free_pages = len(dec.pool._free_page_set)
    real = dec.pool.seat_pages
    dec.pool.seat_pages = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("boom"))
    with pytest.raises(RuntimeError):
        dec.adopt(req, pre)
    dec.pool.seat_pages = real
    assert dec.pool.free_count == free_slots
    assert len(dec.pool._free_page_set) == free_pages
    dec.check_invariants()
    src_slot = next(s for s, r in pre._slot_req.items() if r is req)
    stats = dec.adopt(req, pre)
    assert stats["pages"] >= 1
    assert stats["bytes"] == stats["pages"] * dec.pool.page_nbytes
    pre.finish_handoff(req, src_slot)
    assert pre.pending_handoffs() == []
    dec.run_until_drained(max_steps=200)
    assert req.state is RequestState.FINISHED
    assert_generated(peng, [req], [make_prompts(13)[2]], [4])
    assert_no_page_leaks(pre)
    assert_no_page_leaks(dec)


def test_import_pages_copies_every_leaf_and_unwinds(stack):
    """The transfer primitive: the destination pages equal the source's
    bit for bit, every leaf; a failure mid-copy unwinds its pages; a free
    source page and a geometry mismatch are refused."""
    _, peng = stack
    pre = paged_server(peng, role="prefill")
    dec = paged_server(peng, role="decode")
    req = pre.submit(make_prompts(5)[4], max_new_tokens=4)     # 17 tokens
    _parked(pre, req)
    src = [int(p) for p in pre.pool.table[req.slot, :3]]
    dst = dec.pool.import_pages(pre.pool, src)
    for name, leaf in pre.pool.cache.items():
        assert leaf[:, src].equal(dec.pool.cache[name][:, dst])
    assert all(dec.pool.page_refs[p] == 1 for p in dst)
    dec.pool.unref_pages(dst)
    free = len(dec.pool._free_page_set)

    def boom(*a, **kw):
        raise RuntimeError("copy failed")

    real = dec.pool._scatter_pages
    dec.pool._scatter_pages = boom
    with pytest.raises(RuntimeError, match="copy failed"):
        dec.pool.import_pages(pre.pool, src)
    dec.pool._scatter_pages = real
    assert len(dec.pool._free_page_set) == free
    unused = pre.pool.num_pages - 1
    assert unused in pre.pool._free_page_set
    with pytest.raises(ValueError, match="free"):
        dec.pool.import_pages(pre.pool, [unused])
    other = PagedKVPool(dec.pool.spec, 2, page_size=2 * PS, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        other.import_pages(pre.pool, src)
    dec.check_invariants()


def test_seat_pages_is_atomic(stack):
    _, peng = stack
    dec = paged_server(peng, role="decode")
    pool = dec.pool
    slot = pool.alloc()
    pages = [pool.alloc_page(), pool.alloc_page()]
    with pytest.raises(ValueError, match="cannot back"):
        pool.seat_pages(slot, pages, 3 * PS)
    pool.table[slot, 1] = pages[0]        # an occupied entry
    with pytest.raises(RuntimeError, match="occupied"):
        pool.seat_pages(slot, pages, 2 * PS)
    assert pool.table[slot, 0] == pool.num_pages   # nothing was taken
    pool.table[slot, 1] = pool.num_pages
    pool.seat_pages(slot, pages, 2 * PS - 3)
    assert list(pool.table[slot, :2]) == pages
    assert pool.starts[slot] == 2 * PS - 3
    assert pool.table_dev[slot, :2].tolist() == pages
    pool.release(slot)
    assert pool.free_page_count == pool.num_pages


def test_adopted_prompt_publishes_only_written_pages(stack):
    """A prompt one token short of a page boundary: the first sampled
    token's position lies in the prompt's last page, unwritten until the
    next decode step. The destination trie publishes only the pages whose
    positions are all written, so a follow-up turn that extends the
    conversation maps no page with an unwritten position."""
    _, peng = stack
    rng = np.random.default_rng(21)
    first = rng.integers(0, 64, 2 * PS - 1).astype(np.int32)
    router = ReplicaRouter([paged_server(peng, "prefill"),
                            paged_server(peng, "decode")])
    r1 = router.submit(first, max_new_tokens=6, session="chat")
    router.run_until_drained(max_steps=200)
    dec = router.replicas[1]
    assert len(dec.pool.prefix.page_counts()) == 1       # not 2
    follow = np.concatenate([r1.tokens(),
                             rng.integers(0, 64, 5).astype(np.int32)])
    r2 = router.submit(follow, max_new_tokens=6, session="chat")
    router.run_until_drained(max_steps=200)
    assert router.stats()["transfer_pages_saved"] >= 1
    assert_generated(peng, [r1, r2], [first, follow], [6, 6])
    for rep in router.replicas:
        assert_no_page_leaks(rep)


def test_roles_need_paged_kv_and_prefill_never_decodes(stack):
    _, peng = stack
    with pytest.raises(ValueError, match="paged_kv"):
        ServingEngine(peng, role="prefill")
    with pytest.raises(ValueError, match="role must be"):
        paged_server(peng, role="verify")
    pre = paged_server(peng, role="prefill")
    assert pre.stats()["role"] == "prefill"
    req = pre.submit(make_prompts(3)[1], max_new_tokens=5)
    _parked(pre, req)
    for _ in range(3):
        pre.step()
    assert len(req.output_tokens) == 1 and pre.stats()["decode_steps"] == 0
    assert pre.timelines.events_of(req.request_id)[-1] == "handoff_ready"
    assert req.request_id in pre.timelines.parked_ids()
    with pytest.raises(ValueError, match="decode-capable"):
        pre.adopt(req, pre)
    pre.cancel(req.request_id)
    assert pre.pending_handoffs() == []
    assert_no_page_leaks(pre)


# -- the captured decode's watchdog, shared by servers on one engine ------
def _warmed(server, prompts):
    for p in prompts:
        server.submit(p, max_new_tokens=3)
    server.run_until_drained(max_steps=200)
    server.end_warmup()


def test_second_server_is_no_recompile_in_a_warmed_one(stack):
    """Server B built on server A's captured engine captures a decode
    step for its own pool: that capture counts against B, never against
    the warmed A (before the repair it did, and A's next step raised
    RecompileAfterWarmupError under strict_recompile)."""
    _, peng = stack
    prompts = make_prompts(3)[:3]
    a = paged_server(peng, strict_recompile=True,
                     paged_kv={"page_size": PS, "kernel": "on"})
    _warmed(a, prompts)
    b = paged_server(a.engine, strict_recompile=True)
    b.submit(prompts[0], max_new_tokens=3)
    b.run_until_drained(max_steps=200)
    assert a.watchdog.recompiles == 0
    assert sum(e["program"] == "DecodeGraphs.capture"
               for e in a.watchdog.events) == 1
    assert sum(e["program"] == "DecodeGraphs.capture"
               for e in b.watchdog.events) == 1
    a.submit(prompts[1], max_new_tokens=3)
    a.run_until_drained(max_steps=200)       # no RecompileAfterWarmupError
    # each server still counts its own new captures after warmup
    b.end_warmup()
    peng.decode_graphs._graphs.clear()
    b.submit(prompts[0], max_new_tokens=3)      # B's warmed shapes
    with pytest.raises(RecompileAfterWarmupError, match="capture"):
        b.run_until_drained(max_steps=200)
    assert b.watchdog.recompiles == 1 and a.watchdog.recompiles == 0


def test_jax_second_server_counts_no_recompile(stack):
    """The reference: a second JAX server of the same shapes on one
    engine hits the shared jit cache, and the warmed one counts
    nothing."""
    jeng, _ = stack
    prompts = make_prompts(3)[:3]
    a = jax_server(jeng, strict_recompile=True)
    _warmed(a, prompts)
    b = jax_server(jeng, strict_recompile=True)
    b.submit(prompts[0], max_new_tokens=3)
    b.run_until_drained(max_steps=200)
    assert a.watchdog.recompiles == 0
    a.submit(prompts[1], max_new_tokens=3)
    a.run_until_drained(max_steps=200)
    assert a.watchdog.recompiles == 0
