"""The pipelined step (``overlap=True``) of the port's ServingEngine: the
cases of the JAX package's ``tests/unit/serving/test_overlap.py`` that do
not need speculative decoding, plus the JAX ``overlap=True`` server itself.

Overlap reorders when the step's work is issued (the running slots'
decode before admission and the prefill chunk, one fetch at the end of
the step), never what is computed: every outcome (tokens, finish reasons)
is the serial step's, on the plain and paged pools, through preemption and
resume, with the captured decode step too (``enable_cuda_graph``, on the
CPU its static-buffer body), and the JAX ``overlap=True`` server gives the
same tokens on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import RequestState

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
PS = 8


@pytest.fixture(scope="module")
def stack():
    jm = J.TransformerLM(J.TransformerConfig(**TINY, dtype=jnp.float32))
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    pcfg = P.TransformerConfig(**TINY, dtype=torch.float32)
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    engines = {switch: dst.init_inference(
        P.TransformerLM(pcfg), device="cpu", model_parameters=state,
        config={"dtype": "float32", "enable_cuda_graph": switch})
        for switch in (False, True)}
    return jm, params, pcfg, state, engines


def make_srv(engine, overlap, num_slots=3, **kw):
    kw.setdefault("prefill_chunk", PS)
    return dst.ServingEngine(engine, num_slots=num_slots, max_queue_depth=32,
                             overlap=overlap, **kw)


def _workload(seed=11, n=8):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 22, size=n)
    prompts = [rng.integers(0, 64, size=int(T)).astype(np.int32)
               for T in lengths]
    budgets = [int(b) for b in rng.integers(3, 10, size=n)]
    return prompts, budgets


def run_traffic(srv, prompts, budgets, max_steps=600):
    reqs = [srv.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    steps = 0
    while (srv.pending or srv.live_count) and steps < max_steps:
        srv.step()
        steps += 1
        assert not srv._deferred, "deferred fetches leaked past the step"
    srv.check_invariants()
    return reqs


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("extra", [
    {},
    {"paged_kv": {"page_size": PS, "kernel": "on"}},
    # a pool small enough that page pressure preempts
    {"paged_kv": {"page_size": PS, "num_pages": 5}},
], ids=["plain", "paged-kernel", "paged-pressure"])
def test_overlap_outcome_parity(stack, extra, graph):
    """The same staggered workload through overlap and serial servers:
    every request finishes with identical tokens and finish reason."""
    engine = stack[4][graph]
    prompts, budgets = _workload()
    srv_s = make_srv(engine, overlap=False, **extra)
    srv_o = make_srv(engine, overlap=True, **extra)
    assert not srv_s._overlap and srv_o._overlap
    serial = run_traffic(srv_s, prompts, budgets)
    over = run_traffic(srv_o, prompts, budgets)
    for a, b in zip(serial, over):
        assert a.state is RequestState.FINISHED, a.finish_reason
        assert a.finish_reason == b.finish_reason
        np.testing.assert_array_equal(a.tokens(), b.tokens())
    if "num_pages" in extra.get("paged_kv", {}):
        assert srv_s.stats()["preempted"] > 0
        assert srv_o.stats()["preempted"] > 0


def test_overlap_matches_generate(stack):
    """The pipelined path against the whole-batch oracle directly."""
    engine = stack[4][False]
    prompts, budgets = _workload(seed=17, n=5)
    reqs = run_traffic(make_srv(engine, overlap=True), prompts, budgets)
    for req, p, b in zip(reqs, prompts, budgets):
        expected = engine.generate(np.asarray(p)[None], max_new_tokens=b)[0]
        np.testing.assert_array_equal(req.tokens(), expected)


def test_overlap_preempt_resume_parity(stack):
    """Preempting mid-decode while fetches are deferred: the resumed
    request's output equals the serial arm's (no token applied twice,
    none lost)."""
    engine = stack[4][False]
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, 64, size=14).astype(np.int32)

    def run(overlap):
        srv = make_srv(engine, overlap=overlap, num_slots=2)
        req = srv.submit(prompt, max_new_tokens=10)
        for _ in range(4):
            srv.step()
        assert not srv._deferred          # step boundaries stay clean
        srv._preempt_req(req)
        assert req.preemptions == 1 and req.state is RequestState.QUEUED
        srv.run_until_drained(max_steps=200)
        srv.check_invariants()
        return req

    a, b = run(True), run(False)
    assert a.state is RequestState.FINISHED
    assert a.finish_reason == b.finish_reason
    np.testing.assert_array_equal(a.tokens(), b.tokens())


def test_overlap_defers_decode_fetches(stack):
    """The pipeline is real: with live decode slots an overlap step queues
    its token fetch through _defer and drains it once, at the step's end,
    and the decode is issued before the step's admission."""
    engine = stack[4][False]
    srv = make_srv(engine, overlap=True, num_slots=2)
    queued, order = [], []
    drain, decode, admit = (srv._drain_deferred, srv._decode_step,
                            srv._admit_stall_free)

    def spy_drain():
        queued.append(len(srv._deferred))
        return drain()

    srv._drain_deferred = spy_drain
    srv._decode_step = lambda *a: (order.append("decode"), decode(*a))
    srv._admit_stall_free = lambda *a: (order.append("admit"), admit(*a))
    srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
    srv.step()             # nothing ran at entry: admission, then decode
    srv.submit(np.arange(7, dtype=np.int32), max_new_tokens=4)
    srv.step()             # the running slot's decode, then admission
    srv.run_until_drained(max_steps=100)
    srv.check_invariants()
    assert any(n > 0 for n in queued)
    assert order[:4] == ["admit", "decode", "decode", "admit"]
    assert not srv._deferred


def test_init_serving_forwards_overlap_and_kernel(stack):
    _, _, pcfg, state, _ = stack
    srv = dst.init_serving(P.TransformerLM(pcfg), model_parameters=state,
                           config={"dtype": "float32"}, device="cpu",
                           num_slots=2, prefill_chunk=PS, overlap=True,
                           strict_recompile=True, enable_cuda_graph=True,
                           paged_kv={"page_size": PS, "kernel": "on"})
    assert srv._overlap and srv.watchdog.strict
    assert srv.pool.kernel_active and srv.engine.decode_graphs is not None
    req = srv.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    srv.run_until_drained(max_steps=100)
    srv.check_invariants()
    assert req.state is RequestState.FINISHED
    assert srv.engine.decode_graphs.captures == 1


def test_same_tokens_as_the_jax_overlap_server(stack):
    jm, params, _, _, engines = stack
    prompts, budgets = _workload(seed=31, n=6)
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    jsrv = JaxServingEngine(jeng, num_slots=3, max_queue_depth=32,
                            prefill_chunk=PS, overlap=True)
    want = [r.tokens() for r in run_traffic(jsrv, prompts, budgets)]
    got = [r.tokens() for r in
           run_traffic(make_srv(engines[True], overlap=True), prompts,
                       budgets)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
