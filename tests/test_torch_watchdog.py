"""The recompile watchdog (``strict_recompile``) on both packages, with the
same traffic: the JAX test ``test_watchdog_zero_after_warmup_and_strict_raise``
(``tests/unit/serving/test_telemetry_serving.py``) run on the JAX
``ServingEngine``, the port's, and the port's with ``enable_cuda_graph``
(on the CPU the captured step's static-buffer body, one capture per
server).

After warmup, slot churn through reused slots records no recompile; a
prompt in a new prefill bucket is a new program signature, which raises
``RecompileAfterWarmupError`` at the step boundary in both packages. The
raise fails no request and leaves the bookkeeping consistent, and serving
goes on afterwards.
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
from deepspeed_tpu.telemetry import \
    RecompileAfterWarmupError as JaxRecompileAfterWarmupError
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.telemetry import (RecompileAfterWarmupError,
                                           RecompileWatchdog, fast_key)

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def engines():
    jm = J.TransformerLM(J.TransformerConfig(**TINY, dtype=jnp.float32))
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    pcfg = P.TransformerConfig(**TINY, dtype=torch.float32)
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    out = {"jax": (jeng, JaxServingEngine, JaxRecompileAfterWarmupError)}
    for arm, switch in (("port", False), ("port_graph", True)):
        eng = dst.init_inference(P.TransformerLM(pcfg), device="cpu",
                                 model_parameters=state,
                                 config={"dtype": "float32",
                                         "enable_cuda_graph": switch})
        out[arm] = (eng, dst.ServingEngine, RecompileAfterWarmupError)
    return out


@pytest.mark.parametrize("arm", ["jax", "port", "port_graph"])
def test_watchdog_zero_after_warmup_and_strict_raise(engines, arm):
    engine, Server, Error = engines[arm]
    rng = np.random.default_rng(89)
    graphs = getattr(engine, "decode_graphs", None)
    captures = graphs.captures if graphs is not None else 0
    srv = Server(engine, num_slots=2, max_queue_depth=16,
                 strict_recompile=True)
    for _ in range(3):  # warm both admission buckets
        srv.submit(rng.integers(0, 64, size=6).astype(np.int32),
                   max_new_tokens=3)
    srv.run_until_drained(max_steps=50)
    srv.end_warmup()
    assert srv.watchdog.warmed

    churn = [srv.submit(rng.integers(0, 64, size=6).astype(np.int32),
                        max_new_tokens=4) for _ in range(5)]
    srv.run_until_drained(max_steps=100)
    assert srv.watchdog.recompiles == 0
    assert all(r.state.value == "finished" for r in churn)

    # a fresh program: strict mode raises at the step boundary
    late = srv.submit(rng.integers(0, 64, size=33).astype(np.int32),
                      max_new_tokens=2)  # new prefill bucket (width 64)
    with pytest.raises(Error):
        srv.run_until_drained(max_steps=20)
    assert srv.watchdog.recompiles > 0
    assert srv.watchdog.summary()["recompiles"] == srv.watchdog.recompiles
    # the raise came after the step: nothing failed, nothing leaked
    assert late.state.value in ("running", "finished")
    assert srv.metrics.failed == 0
    srv.check_invariants()
    srv.run_until_drained(max_steps=20)   # reported once, then serving goes on
    assert late.state.value == "finished"
    srv.check_invariants()
    if arm == "port_graph":
        assert graphs.captures == captures + 1
        assert "DecodeGraphs.capture" in srv.watchdog.summary()["programs"]
    if arm != "jax":
        man = srv.watchdog.signature_manifest()
        assert any("int64[2,16]" in s
                   for s in man["InferenceEngine.prefill_at"])


def test_a_capture_after_warmup_is_a_recompile(engines):
    """A decode step captured after warmup (here: the pool's cache moved
    to a new tensor, as a rebinding reset would do) counts and raises."""
    eng = engines["port_graph"][0]
    srv = dst.ServingEngine(eng, num_slots=2, prefill_chunk=0,
                            strict_recompile=True)
    srv.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    srv.run_until_drained(max_steps=20)
    srv.end_warmup()
    srv.pool.cache = {k: v.clone() for k, v in srv.pool.cache.items()}
    srv.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    with pytest.raises(RecompileAfterWarmupError, match="DecodeGraphs"):
        srv.run_until_drained(max_steps=20)
    assert srv.metrics.failed == 0


def test_fast_key_abstracts_values():
    wd = RecompileWatchdog()

    class Owner:
        def f(self, *args, **kwargs):
            return len(args)

    owner = Owner()
    proxy = wd.attach(owner, "f")
    assert wd.attach(owner, "f") is proxy           # idempotent
    owner.f(torch.zeros(2, 3), 5, [1, 2], flag=True)
    owner.f(torch.ones(2, 3), 7, [3, 4], flag=True)    # same key
    assert wd.warmup_recompiles == 1
    wd.end_warmup()
    owner.f(torch.zeros(2, 4), 5, [1, 2], flag=True)   # new shape
    owner.f(np.zeros((2, 3), np.float32), 5.0, [1, 2], flag=True)
    assert wd.recompiles == 2
    assert fast_key((torch.zeros(2, 3, dtype=torch.int64),), {}) == \
        fast_key((np.zeros((2, 3), np.int64),), {})
