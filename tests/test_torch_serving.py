"""The port's ServingEngine and InferenceEngine on the CPU.

Serving is a scheduling layer: each request's greedy tokens must equal the
port's own ``generate()`` for that prompt, bitwise, whatever the slot
churn. The engine's teacher-forced logits (bucketed prefill, then one decode
per token) are held against the JAX ``InferenceEngine`` on the same bridged
weights, in fp32 (tolerance 1e-4 absolute: summation order over two
layers). Weights come from the JAX module's init, so logits are far from
ties.
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
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (InvariantViolation, RequestState,
                                         ServingEngine)

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-4
TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            dtype=jnp.float32)


@pytest.fixture(scope="module")
def stack():
    jm = J.TransformerLM(J.transformer_config("gpt2", **TINY))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jm.init({"params": jax.random.PRNGKey(1)}, ids,
                     method=jm.logits)["params"]
    pcfg = P.transformer_config("gpt2", **{**TINY, "dtype": torch.float32})
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    return jm, params, pcfg, state


def _engine(stack):
    _, _, pcfg, state = stack
    return dst.init_inference(P.TransformerLM(pcfg),
                              config={"dtype": "float32"},
                              model_parameters=state, device="cpu")


def _server(stack, **kw):
    return ServingEngine(_engine(stack), **{"num_slots": 2,
                                            "max_queue_depth": 8, **kw})


def test_tokens_bitwise_match_generate_with_staggered_arrivals(stack):
    srv = _server(stack)
    rng = np.random.default_rng(7)
    lengths = [5, 9, 12, 5, 9, 12]
    budgets = [6, 4, 8, 3, 7, 5]
    prompts = [rng.integers(0, 64, size=n).astype(np.int32) for n in lengths]
    reqs = [srv.submit(p, max_new_tokens=b)
            for p, b in zip(prompts[:3], budgets[:3])]
    srv.step()
    srv.step()
    reqs += [srv.submit(p, max_new_tokens=b)
             for p, b in zip(prompts[3:], budgets[3:])]
    srv.run_until_drained(max_steps=200)
    srv.check_invariants()
    assert srv.pool.free_count == 2 and not srv._slot_req
    for req, prompt, budget in zip(reqs, prompts, budgets):
        assert req.state is RequestState.FINISHED
        assert req.finish_reason == "length"
        want = srv.engine.generate(prompt[None], max_new_tokens=budget)[0]
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")


def test_eos_retires_like_generate(stack):
    srv = _server(stack)
    prompt = np.arange(3, 9, dtype=np.int32)
    greedy = srv.engine.generate(prompt[None], max_new_tokens=6)[0]
    eos = int(greedy[len(prompt) + 2])  # the third generated token
    req = srv.submit(prompt, max_new_tokens=6, eos_token_id=eos)
    srv.run_until_drained()
    want = srv.engine.generate(prompt[None], max_new_tokens=6,
                               eos_token_id=eos)[0]
    assert req.finish_reason == "eos"
    np.testing.assert_array_equal(req.tokens(), want[:len(req.tokens())])
    assert (want[len(req.tokens()):] == eos).all()


def test_teacher_forced_logits_match_jax_engine(stack):
    jm, params, _, _ = stack
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    eng = _engine(stack)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 64, (1, 11)).astype(np.int32)
    forced = rng.integers(0, 64, 4).astype(np.int32)
    jeng._ensure_params(jnp.asarray(prompt))
    jl, jcache = jeng._jit_prefill_gen(jeng.params, jnp.asarray(prompt))
    # the port's serving path: prompt right-padded to the 16 bucket
    padded = np.zeros((1, 16), np.int64)
    padded[0, :11] = prompt[0]
    pl, cache = eng.prefill_at(padded, 10)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for i, tok in enumerate(forced):
        jl, jcache = jeng._jit_decode(jeng.params, jcache,
                                      jnp.asarray([[tok]]),
                                      jnp.asarray(11 + i, jnp.int32))
        pl = eng.decode(cache, [[int(tok)]], 11 + i)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode {i}")


def test_sampling_is_seeded_and_top_k_one_is_greedy(stack):
    eng = _engine(stack)
    prompt = np.arange(1, 7, dtype=np.int32)[None]
    a = eng.generate(prompt, 8, do_sample=True, top_k=5, top_p=0.9, seed=3)
    b = eng.generate(prompt, 8, do_sample=True, top_k=5, top_p=0.9, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        eng.generate(prompt, 8, do_sample=True, top_k=1, seed=4),
        eng.generate(prompt, 8))


def test_gang_policy_admits_only_after_drain(stack):
    srv = _server(stack, policy="gang")
    reqs = [srv.submit(np.arange(4, dtype=np.int32) + i, max_new_tokens=b)
            for i, b in enumerate([3, 6, 2, 2])]
    srv.run_until_drained()
    srv.check_invariants()
    first_done = max(r.finish_time for r in reqs[:2])
    assert all(r.admit_time >= first_done for r in reqs[2:])
    assert all(r.state is RequestState.FINISHED for r in reqs)


def test_rejection_reasons(stack):
    srv = _server(stack, max_queue_depth=1)
    long = srv.submit(np.zeros(60, np.int32), max_new_tokens=10)
    assert long.state is RequestState.REJECTED
    assert long.reject_reason == "prompt_too_long"
    srv.submit(np.zeros(4, np.int32), max_new_tokens=2)
    full = srv.submit(np.zeros(4, np.int32), max_new_tokens=2)
    assert full.reject_reason == "queue_full"
    assert srv.stats()["rejected"] == {"prompt_too_long": 1, "queue_full": 1}


def test_monitor_gets_events_on_the_step_axis(stack):
    class Sink:
        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    sink = Sink()
    srv = _server(stack, monitor=sink)
    srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
    srv.run_until_drained()
    tags = {tag for tag, _, _ in sink.events}
    assert {"serving/ttft_ms", "serving/new_tokens"} <= tags
    assert all(step == srv.step_id for _, _, step in sink.events)
    assert srv.stats()["completed"] == 1


def test_no_slot_leaks_on_a_mid_step_error(stack):
    srv = _server(stack)
    for i in range(3):
        srv.submit(np.arange(5, dtype=np.int32) + i, max_new_tokens=4)
    srv.step()
    decode = srv.engine.decode

    def broken(*args, **kwargs):
        raise RuntimeError("injected")

    srv.engine.decode = broken
    with pytest.raises(RuntimeError, match="injected"):
        srv.step()
    srv.engine.decode = decode
    srv.check_invariants()
    assert srv.pool.free_count == 2 and srv.metrics.failed == 2
    srv.run_until_drained()
    srv.check_invariants()
    srv.pool._free_set.discard(0)  # a leaked slot is caught
    with pytest.raises(InvariantViolation, match="leaked|differ"):
        srv.check_invariants()


def test_unported_serving_keys_raise(stack):
    _, _, pcfg, state = stack
    model = P.TransformerLM(pcfg)
    # the resilience and telemetry keys are ported: each is accepted, with
    # the JAX defaults and validation messages
    for key, val in (("tracer", True), ("deadline_default_ms", 100),
                     ("priority", True), ("registry", None),
                     ("timeline_capacity", 16), ("step_wall_budget_ms", 5.0),
                     ("guard_numerics", True), ("degradation", True),
                     ("preempt_queue_threshold", 2),
                     ("preempt_min_run_steps", 1), ("fault_injector", None),
                     ("slo", True), ("flight_recorder", 8),
                     ("dump_dir", None), ("clock", lambda: 0.0),
                     ("cost_model", False), ("cost_model", True),
                     ("cost_model", {"kv_every": 4}), ("role", "both")):
        srv = dst.init_serving(model, config={"dtype": "float32"},
                               device="cpu", **{key: val})
        assert srv.pool.num_slots == 4
    with pytest.raises(ValueError, match="deadline_default_ms must be > 0"):
        dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                         deadline_default_ms=0)
    # the cost model is ported: True, a kwargs dict or an instance
    from deepspeed_tpu_torch.telemetry import ProgramCostModel
    cm = ProgramCostModel(kv_every=2)
    srv = dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                           cost_model=cm)
    assert srv.costs is cm and srv.watchdog.cost_model is cm
    assert dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                            cost_model={"kv_every": 4}).costs.kv_every == 4
    # only the disaggregated roles are still to come
    with pytest.raises(NotImplementedError, match="role"):
        dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                         role="prefill")
    with pytest.raises(ValueError, match="paged_kv keys"):
        dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                         paged_kv={"pages": 4})
    srv = dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                           paged_kv=False, prefill_chunk=0,
                           deadline_default_ms=None)
    assert srv.pool.num_slots == 4 and srv.prefill_chunk == 0
    # the JAX defaults: stall-free chunk 64 (capped at the capacity), and
    # the page pool sized from the chunk when paged_kv is on
    srv = dst.init_serving(model, config={"dtype": "float32"}, device="cpu",
                           paged_kv=True)
    assert srv.prefill_chunk == 64 and srv.prefill_token_budget == 128
    assert srv.pool.page_size == 64 and srv.pool.kernel == "auto"
    with pytest.raises(ValueError, match="dtype"):
        dst.init_inference(P.TransformerLM(dataclasses.replace(
            pcfg, dtype=torch.bfloat16)), config={"dtype": "float32"},
            device="cpu")
