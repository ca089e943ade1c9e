"""Paged KV serving with the prefix cache and stall-free chunked admission,
on the CPU, against the port's other paths and the JAX ServingEngine.

Paging and chunking are memory-layout and scheduling changes, never
numerics changes: each request's greedy tokens must be identical across
the port's paged server (prefix cache on, decode through ``decode_paged``
or, with ``kernel="off"``, the dense gather/scatter composition), its
contiguous stall-free and serial servers, its own ``generate()``, and the
JAX ``ServingEngine`` (paged, ``kernel="off"``, chunk 16) on the same
weights (``checkpoint.flax_import``). Everything is fp32; the weights come
from the JAX module's init, so logits are far from ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (InvariantViolation, PagedKVPool,
                                         PagePoolExhausted, RequestState)

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=128, n_embd=32, n_layer=2, n_head=4,
            dtype=jnp.float32)
PS = CHUNK = 16


@pytest.fixture(scope="module")
def stack():
    jm = J.TransformerLM(J.transformer_config("gpt2", **TINY))
    params = jm.init({"params": jax.random.PRNGKey(5)},
                     jnp.zeros((1, 8), jnp.int32), method=jm.logits)["params"]
    pcfg = P.transformer_config("gpt2", **{**TINY, "dtype": torch.float32})
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    eng = dst.init_inference(P.TransformerLM(pcfg),
                             config={"dtype": "float32"},
                             model_parameters=state, device="cpu")
    return jm, params, eng


@pytest.fixture(scope="module")
def traffic():
    """3 requests sharing a 2-page prefix (the first is served before the
    others arrive, so the trie holds it) and 4 unrelated prompts, short
    ones (bucketed admission) and long ones (chunked)."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 64, 2 * PS)
    prompts = [np.concatenate([base, rng.integers(0, 64, n)])
               for n in (5, 12, 21)]
    prompts += [rng.integers(0, 64, n) for n in (6, 13, 40, 57)]
    budgets = [9, 6, 11, 7, 10, 8, 12]
    return [p.astype(np.int32) for p in prompts], budgets


@pytest.fixture(scope="module")
def generated(stack, traffic):
    eng = stack[2]
    return [eng.generate(p[None], max_new_tokens=b)[0]
            for p, b in zip(*traffic)]


def _serve(srv, prompts, budgets):
    """Serve the traffic on either package's server (their request states
    are different enums, so compare by value)."""
    reqs = [srv.submit(prompts[0], max_new_tokens=budgets[0])]
    for _ in range(50):
        if reqs[0].state.value == "running":
            break
        srv.step()
    assert reqs[0].state.value == "running"
    reqs += [srv.submit(p, max_new_tokens=b)
             for p, b in zip(prompts[1:], budgets[1:])]
    srv.run_until_drained(max_steps=400)
    srv.check_invariants()
    assert all(r.state.value == "finished" for r in reqs)
    return reqs


PORT_ARMS = {
    "paged": dict(prefill_chunk=CHUNK, paged_kv={"page_size": PS}),
    "paged_kernel_off": dict(prefill_chunk=CHUNK,
                             paged_kv={"page_size": PS, "kernel": "off"}),
    "contiguous_stall_free": dict(prefill_chunk=CHUNK),
    "contiguous_serial": dict(prefill_chunk=0),
}


@pytest.mark.parametrize("arm", sorted(PORT_ARMS))
def test_port_paths_match_generate(stack, traffic, generated, arm):
    eng = stack[2]
    srv = dst.ServingEngine(eng, num_slots=3, **PORT_ARMS[arm])
    reqs = _serve(srv, *traffic)
    for req, want in zip(reqs, generated):
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")
    if arm.startswith("paged"):
        # the followers of the first shared-prefix request sat on its pages
        assert reqs[0].prefix_hit_tokens == 0
        assert all(r.prefix_hit_tokens == 2 * PS for r in reqs[1:3])
        st = srv.stats()
        assert st["prefix_hits"] == 2 and st["prefix_hit_tokens"] == 4 * PS
        assert st["paging"]["pages_total"] == srv.pool.num_pages
        assert any(r.chunks > 1 for r in reqs)   # long prompts streamed


def test_jax_paged_server_gives_the_same_tokens(stack, traffic, generated):
    jm, params, _ = stack
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    srv = JaxServingEngine(jeng, num_slots=3, prefill_chunk=CHUNK,
                           paged_kv={"page_size": PS, "kernel": "off"})
    reqs = _serve(srv, *traffic)
    for req, want in zip(reqs, generated):
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")
    assert all(r.prefix_hit_tokens == 2 * PS for r in reqs[1:3])


def test_oversubscribed_pool_drains_through_preemption(stack):
    """6 pages for 3 slots whose requests grow to 3 pages each, and no
    prefix cache to evict from: decode runs out of pages, the youngest
    other request is preempted back to the queue, and every request still
    finishes with generate()'s tokens and no page left held."""
    eng = stack[2]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 64, 20).astype(np.int32) for _ in range(4)]
    budgets = [24, 22, 20, 18]
    srv = dst.ServingEngine(eng, num_slots=3, prefill_chunk=CHUNK,
                            paged_kv={"page_size": PS, "num_pages": 6,
                                      "prefix_cache": False})
    reqs = [srv.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    srv.run_until_drained(max_steps=400)
    srv.check_invariants()
    assert srv.stats()["preempted"] > 0
    assert sum(r.preemptions for r in reqs) == srv.stats()["preempted"]
    assert srv.pool.free_page_count == srv.pool.num_pages
    for req, p, b in zip(reqs, prompts, budgets):
        assert req.state is RequestState.FINISHED
        np.testing.assert_array_equal(
            req.tokens(), eng.generate(p[None], max_new_tokens=b)[0])


@pytest.mark.parametrize("pressure,b_budget", [("decode_boundary", 6),
                                               ("decode_boundary", 1),
                                               ("inflight_chunk", 6)])
def test_preempting_a_request_admitted_in_the_same_step(stack, pressure,
                                                        b_budget):
    """A short admission takes the last free page in the step where another
    request needs one more: its running neighbour's decode crosses a page
    boundary, or a long prompt's in-flight chunk (whose pages the grant
    never charges) reaches a new page. The victim is the fresh admission,
    whose first token the host has not replayed yet; that token must join
    its seed for re-admission (or, when it was the last of its budget,
    finish the request from the queue), and nothing may fail."""
    eng = stack[2]
    rng = np.random.default_rng(31)
    if pressure == "decode_boundary":
        # A (10 tokens, 1 page) decodes; its write reaches position 16 in
        # step 7, the step B (1 page) is admitted into the last free page
        num_pages, first, submit_after = 2, (10, 12), 6
    else:
        # A (40 tokens) streams one chunk a step; B is admitted in step 3,
        # when A's last chunk needs its third page
        num_pages, first, submit_after = 3, (40, 8), 2
    a_prompt = rng.integers(0, 64, first[0]).astype(np.int32)
    b_prompt = rng.integers(0, 64, 10).astype(np.int32)
    srv = dst.ServingEngine(eng, num_slots=2, prefill_chunk=CHUNK,
                            paged_kv={"page_size": PS, "num_pages": num_pages,
                                      "prefix_cache": False})
    a = srv.submit(a_prompt, max_new_tokens=first[1])
    for _ in range(submit_after):
        srv.step()
    b = srv.submit(b_prompt, max_new_tokens=b_budget)
    srv.step()
    assert b.slot is None and b.preemptions == 1
    assert len(b.output_tokens) == 1
    assert b.state is (RequestState.FINISHED if b_budget == 1
                       else RequestState.QUEUED)
    assert (b in srv.scheduler.queue) is (b_budget > 1)
    srv.check_invariants()
    srv.run_until_drained(max_steps=100)
    srv.check_invariants()
    assert srv.metrics.failed == 0
    assert srv.pool.free_page_count == srv.pool.num_pages
    for req, p in ((a, a_prompt), (b, b_prompt)):
        assert req.state is RequestState.FINISHED
        np.testing.assert_array_equal(
            req.tokens(),
            eng.generate(p[None], max_new_tokens=req.max_new_tokens)[0])


def test_page_aligned_duplicate_forks_copy_on_write(stack):
    """A page-aligned duplicate prompt fully hits the trie; its last chunk
    is prefilled again into a shared page, which must be forked."""
    eng = stack[2]
    dup = np.arange(3 * PS, dtype=np.int32) % 64
    srv = dst.ServingEngine(eng, num_slots=2, prefill_chunk=CHUNK,
                            paged_kv={"page_size": PS})
    first = srv.submit(dup, max_new_tokens=5)
    srv.run_until_drained()
    second = srv.submit(dup, max_new_tokens=5)
    srv.run_until_drained()
    srv.check_invariants()
    assert srv.pool.cow_copies >= 1 and second.prefix_hit_tokens == 2 * PS
    want = eng.generate(dup[None], max_new_tokens=5)[0]
    np.testing.assert_array_equal(first.tokens(), want)
    np.testing.assert_array_equal(second.tokens(), want)


def test_cow_fork_page_returns_when_the_copy_fails(stack):
    """Regression: a fork page allocated for copy-on-write must go back to
    the free list when the page copy raises, not stay stranded."""
    pool = PagedKVPool(stack[2].kv_cache_spec(), num_slots=2, num_pages=6,
                       page_size=PS, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    pool.ensure_writable(a, 0, PS)
    pool.map_prefix(b, [int(pool.table[a, 0])])     # page shared by a and b
    free = pool.free_page_count

    def broken(src, dst):
        raise RuntimeError("copy failed")

    pool._copy_page = broken
    with pytest.raises(RuntimeError, match="copy failed"):
        pool.ensure_writable(b, 0, 1)
    assert pool.free_page_count == free and not pool.consistency_errors()
    del pool._copy_page
    assert pool.ensure_writable(b, 0, 1) == 1       # the fork now succeeds
    assert pool.table[a, 0] != pool.table[b, 0]
    assert not pool.consistency_errors()


def test_page_denominated_admission_and_pool_exhaustion(stack):
    eng = stack[2]
    srv = dst.ServingEngine(eng, num_slots=2, prefill_chunk=CHUNK,
                            paged_kv={"page_size": PS, "num_pages": 4})
    big = srv.submit(np.zeros(60, np.int32), max_new_tokens=8)   # 5 pages
    assert big.state is RequestState.REJECTED
    assert big.reject_reason == "prompt_too_long"
    pool = PagedKVPool(eng.kv_cache_spec(), num_slots=1, num_pages=1,
                       page_size=PS, device="cpu", prefix_cache=False)
    slot = pool.alloc()
    with pytest.raises(PagePoolExhausted):
        pool.ensure_writable(slot, 0, PS + 1)
    assert pool.free_page_count == 0 and not pool.consistency_errors()


def test_audit_and_abort_leave_no_page_behind(stack, traffic):
    """A phantom page reference fails the audit; a step that raises with
    requests PREFILLING and RUNNING requeues the former, fails the latter
    and resets the pool with nothing held."""
    eng = stack[2]
    prompts, budgets = traffic
    srv = dst.ServingEngine(eng, num_slots=3, prefill_chunk=CHUNK,
                            paged_kv={"page_size": PS})
    reqs = [srv.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    srv.step()
    srv.step()
    assert {r.state for r in reqs} >= {RequestState.PREFILLING}
    srv.check_invariants()
    held = int(srv.pool.table[srv.pool.table < srv.pool.num_pages][0])
    srv.pool.page_refs[held] += 1
    with pytest.raises(InvariantViolation, match="refcounts"):
        srv.check_invariants()
    srv.pool.page_refs[held] -= 1

    def broken(*args, **kwargs):
        raise RuntimeError("injected")

    decode_paged, eng.decode_paged = eng.decode_paged, broken
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.step()
    finally:
        eng.decode_paged = decode_paged
    srv.check_invariants()
    assert srv.pool.free_page_count == srv.pool.num_pages
    assert not srv._slot_req and srv.metrics.failed > 0
    srv.run_until_drained(max_steps=400)
    srv.check_invariants()
    assert all(r.state in (RequestState.FINISHED, RequestState.FAILED)
               for r in reqs)
