"""Shared pieces of the port's fleet tests (``tests/test_torch_disagg.py``,
``test_torch_router.py``, ``test_torch_fleet.py``, ``test_torch_frontend.py``):
the tiny model, the paged replica every fleet test builds, the traffic and
the audits. Import what a file needs from here."""

import numpy as np
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.transformer_lm import (TransformerLM,
                                                       transformer_config)
from deepspeed_tpu_torch.serving import RequestState, ServingEngine

# the JAX fleet tests' TINY (tests/unit/serving/test_disagg.py), in the
# gpt2 family both packages' bridges share
TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
PS = 8        # page size == prefill chunk for every fleet server

LENGTHS = [5, 9, 12, 5, 17, 12]
BUDGETS = [6, 4, 8, 3, 7, 5]


def port_engine(state_dict=None, seed: int = 0, graphs: bool = True,
                **overrides):
    """A CPU ``InferenceEngine`` over the tiny fp32 model: the weights of
    ``state_dict`` (a JAX tree through ``checkpoint.flax_import``), else
    random from ``seed``. ``graphs``: ``enable_cuda_graph``, the card's
    serving configuration (on the CPU the static-buffer step runs
    eagerly, with one capture call per cache)."""
    cfg = transformer_config("gpt2", **{**TINY, **overrides},
                             dtype=torch.float32)
    model = TransformerLM(cfg)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    return dst.init_inference(model, config={"dtype": "float32",
                                             "enable_cuda_graph": graphs},
                              model_parameters=state_dict, device="cpu")


def paged_server(engine, role: str = "both", **kw):
    """The fleet tests' replica: 2 slots, chunk = page = ``PS``."""
    kw.setdefault("prefill_chunk", PS)
    kw.setdefault("max_queue_depth", 32)
    kw.setdefault("paged_kv", {"page_size": PS, "num_pages": None})
    return ServingEngine(engine, num_slots=2, role=role, **kw)


def make_prompts(seed: int, lengths=LENGTHS, vocab: int = 64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in lengths]


def warm(router, max_steps: int = 600) -> None:
    """Drive one population of shapes through the fleet, then arm the
    watchdogs (the JAX tests' ``_warm``)."""
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(make_prompts(3), BUDGETS)]
    router.run_until_drained(max_steps=max_steps)
    assert all(r.state.value == "finished" for r in reqs)
    router.end_warmup()


def spawn_factory(engine, **kw):
    """Elastic provisioner: a newcomer arrives warmed (the JAX tests'
    ``_spawn_factory``): a decode-capable one serves the warm population
    alone, a prefill one prefills it to the parked state and cancels."""
    wprompts = make_prompts(3)

    def spawn(role):
        rep = paged_server(engine, role=role, **kw)
        if role != "prefill":
            w = [rep.submit(p, max_new_tokens=b)
                 for p, b in zip(wprompts, BUDGETS)]
            rep.run_until_drained(max_steps=600)
            assert all(r.state is RequestState.FINISHED for r in w)
        else:
            for p, b in zip(wprompts, BUDGETS):
                r = rep.submit(p, max_new_tokens=b)
                for _ in range(40):
                    rep.step()
                    if r in rep.pending_handoffs():
                        break
                rep.cancel(r.request_id)
        return rep

    return spawn


def assert_generated(engine, reqs, prompts, budgets) -> None:
    """Every request FINISHED with the tokens of ``engine.generate()``."""
    for req, prompt, budget in zip(reqs, prompts, budgets):
        assert req.state is RequestState.FINISHED, (
            req.request_id, req.state, req.finish_reason)
        want = engine.generate(np.asarray(prompt)[None],
                               max_new_tokens=budget)[0]
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")


def assert_no_page_leaks(srv) -> None:
    """After a drain every non-free page is held by the prefix trie, no
    slot is seated and the audit is clean."""
    srv.check_invariants()
    assert srv.live_count == 0
    pool = srv.pool
    trie_pages = set(pool.prefix.page_counts())
    assert len(pool._free_page_set) + len(trie_pages) == pool.num_pages
    assert not (trie_pages & pool._free_page_set)
    assert pool.free_count == pool.num_slots
