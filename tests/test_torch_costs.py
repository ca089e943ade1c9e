"""The port's serving cost model (``telemetry/costs.py``) against the JAX
package's, on the CPU.

The JAX model harvests XLA's ``cost_analysis()``; the port counts each
program analytically. What is held against the JAX package:

* the keys of ``summary()``, ``efficiency_snapshot()``, ``kv_hbm_report``
  and ``device_memory_report`` for the same traffic, and the predicted KV
  bytes exactly (contiguous, paged, int8);
* flops per program within 10% of XLA's count at the same signature, for
  the programs whose XLA count is the work they do: the whole-prompt
  prefill (``prefill_at``) and the one-token decode step (``decode``, at
  a full cache: XLA counts the capacity, the port the live lengths) of a
  ONE-layer model. The JAX blocks are a scanned loop and XLA counts a
  loop's body once, so a deeper model's count is one layer's (measured:
  the 2-layer count equals the 1-layer one); the Pallas kernels are not
  reached on the CPU (the JAX model takes its einsum path off the TPU).
  Measured at these shapes the port's count is 0.92-0.98 of XLA's: XLA
  also counts the norms, activations and softmax, and a prefill's full
  T x T score matrix where the port counts the causal half;
* the port's bytes exactly (to 1e-9) against a count built here from the
  config and the parameters' bytes: every weight once (an embedding table
  a gathered row a token unless the tied head reads it whole), the KV rows
  read and written, the fp32 logits; XLA's "bytes accessed" sums the
  operands of every operation, intermediates included, so it is held only
  as a ratio to the port's count: measured at 3.35-8.38 here, held within
  that range widened by a tenth at each end (BYTES_RATIO);
* the attention and KV read charged from the live lengths: a decode step
  at positions p costs its step at 0 plus p positions' pairs and KV rows,
  read from a host argument or, for a device tensor, the serving loop's
  host copy;
* the peak overrides as in ``tests/unit/telemetry/test_efficiency.py``.

The port's own invariants: outputs are bit-identical with the model on and
off, each forward is charged once (a pool program that calls an engine
program is not charged again), a captured decode step (a CPU engine runs
its static-buffer body) is charged as its eager program, and an unknown
program is ``unavailable`` without raising.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.serving.paged_pool import PagedKVPool as JaxPagedKVPool
from deepspeed_tpu.serving.slot_pool import SlotPool as JaxSlotPool
from deepspeed_tpu.telemetry import costs as jcosts
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import PagedKVPool, SlotPool
from deepspeed_tpu_torch.telemetry import costs as pcosts

from _torch_threads import one_thread  # noqa: F401


FLOPS_TOL = 0.10
BYTES_RATIO = (3.0, 9.2)
BYTES_RTOL = 1e-9
V = 128


@functools.lru_cache(maxsize=None)
def _models(family, n_layer):
    """JAX engine and port engine on the same fp32 weights (JAX weights
    from shapes and numpy: no init program compiles)."""
    jcfg = J.transformer_config(family, vocab_size=V, n_layer=n_layer,
                                n_head=4, n_embd=64, max_seq_len=64,
                                dtype=jnp.float32)
    jm = J.TransformerLM(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        method=jm.logits))["params"]
    rng = np.random.default_rng(n_layer)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.1, a.shape).astype(np.float32), shapes)
    pcfg = P.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    state = state_dict_from_flax(pcfg, params)
    return jm, params, pcfg, state


def _port_engine(family="gpt2", n_layer=2, **config):
    _, _, pcfg, state = _models(family, n_layer)
    return dst.init_inference(P.TransformerLM(pcfg), model_parameters=state,
                              config={"dtype": "float32", **config},
                              device="cpu")


def _traffic(srv, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [srv.submit(rng.integers(0, V, n).astype(np.int32),
                       max_new_tokens=b) for n, b in ((5, 4), (11, 6))]
    srv.run_until_drained()
    return reqs


def _exact_bytes(module, B, T, read, head_rows):
    """Bytes of a (B, T) forward after ``read`` cache positions a row,
    projecting ``head_rows`` positions a row: from the parameters and the
    config, not the port's count."""
    cfg = module.config
    item = cfg.dtype.itemsize
    tables = [module.embed_tokens.weight]
    if hasattr(module, "embed_pos"):
        tables.append(module.embed_pos.weight)
    weights = sum(p.numel() * p.element_size()
                  for p in module.state_dict().values())
    weights -= sum(t.numel() * item for t in tables)
    weights += B * T * cfg.n_embd * item * len(tables)
    if cfg.tie_word_embeddings:
        weights += tables[0].numel() * item
    kv = cfg.n_layer * 2 * cfg.kv_heads * cfg.head_dim * item * B * (read + T)
    return weights + kv + B * head_rows * cfg.vocab_size * 4


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_flops_match_xla_count(family):
    """prefill_at at (2, 16) (and (4, 32) for gpt2), and decode at batch
    4 over the full 64-position cache, on a 1-layer model: flops against
    XLA's count, bytes exactly against a count from the parameters and as
    a ratio to XLA's (module docstring)."""
    jm, params, pcfg, state = _models(family, 1)
    jeng = ds.init_inference(jm, model_parameters=params, dtype="float32")
    jeng._ensure_params(np.zeros((1, 8), np.int32))
    peng = _port_engine(family, 1)

    def xla(fn, *args):
        ca = fn.lower(*args).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        return ca["flops"], ca["bytes accessed"]

    def hold(what, port, exact, flops, byts):
        f, b = port
        assert 1 - FLOPS_TOL <= f / flops <= 1.0, (what, f, flops)
        assert abs(b - exact) <= BYTES_RTOL * exact, (what, b, exact)
        assert BYTES_RATIO[0] <= byts / b <= BYTES_RATIO[1], (what, b, byts)

    for B, T in ((2, 16), (4, 32))[:2 if family == "gpt2" else 1]:
        ids = jnp.zeros((B, T), jnp.int32)
        hold(f"prefill_at {B}x{T}",
             pcosts.charge(pcosts._count("prefill_at", peng,
                                         (np.zeros((B, T)), None), {}), ()),
             _exact_bytes(peng.module, B, T, 0, 1),
             *xla(jeng._jit_prefill_at, jeng.params, ids,
                  jnp.full((B,), T - 1, jnp.int32)))
    _, cache = jeng._jit_prefill_at(jeng.params, jnp.zeros((4, 16), jnp.int32),
                                    jnp.full((4,), 15, jnp.int32))
    pcache = peng.kv_cache_spec().stacked_cache(4)
    S = pcache["k"].shape[-2]
    args = (pcache, np.zeros((4, 1)), S - 1)
    cost = pcosts._count("decode", peng, args, {})
    hold("decode", pcosts.charge(cost, args),
         _exact_bytes(peng.module, 4, 1, S - 1, 1),
         *xla(jeng._jit_decode, jeng.params, cache,
              jnp.zeros((4, 1), jnp.int32), jnp.full((4,), S - 1, jnp.int32)))


def test_attention_charged_from_live_lengths():
    """A decode step's charge grows with its rows' positions, one pair a
    layer and head and one KV row a position: from an int, a host array,
    a CPU tensor, or the model's host copy of a device tensor (a ``meta``
    tensor here); with none of them, the capacity."""
    peng = _port_engine("llama", 2)
    cfg = peng.module.config
    pcache = peng.kv_cache_spec().stacked_cache(4)
    S = pcache["k"].shape[-2]
    tokens = np.zeros((4, 1))
    cost = pcosts._count("decode", peng, (pcache, tokens, 0), {})
    f0, b0 = pcosts.charge(cost, (pcache, tokens, 0))
    pair = 4 * cfg.n_layer * cfg.n_head * cfg.head_dim
    row = cfg.n_layer * 2 * cfg.kv_heads * cfg.head_dim * 4
    pos = np.array([3, 0, 17, 40])
    meta = torch.empty(4, device="meta")
    for p, hint in ((pos, None), (torch.as_tensor(pos), None),
                    (meta, pos), (5, None)):
        n = (4 * p if isinstance(p, int) else int(pos.sum()))
        assert pcosts.charge(cost, (pcache, tokens, p), hint) == \
            (f0 + n * pair, b0 + n * row)
    assert pcosts.charge(cost, (pcache, tokens, meta)) == \
        (f0 + 4 * (S - 1) * pair, b0 + 4 * (S - 1) * row)
    cm = pcosts.ProgramCostModel()
    cm.positions = pos
    cm.account("InferenceEngine.decode", peng.decode, (pcache, tokens, meta),
               {})
    cm.step_update(1.0)
    assert (cm.flops_total, cm.bytes_total) == \
        (f0 + pos.sum() * pair, b0 + pos.sum() * row)


def test_keys_and_predicted_kv_match_jax():
    """The same traffic through a JAX and a port server with the cost
    model on: the same summary / snapshot / report keys, every program
    costed, sane gauges; the KV prediction equals JAX's for contiguous,
    paged and int8 pools."""
    jm, params, pcfg, state = _models("gpt2", 2)
    kw = dict(num_slots=2, prefill_chunk=0, cost_model=True)
    jsrv = ds.init_serving(jm, model_parameters=params,
                           config={"dtype": "float32"}, **kw)
    psrv = dst.ServingEngine(_port_engine(), **kw)
    for srv in (jsrv, psrv):
        _traffic(srv)
    js, ps = jsrv.costs.summary(), psrv.costs.summary()
    assert set(ps) == set(js)
    assert ps["unavailable"] == 0 and ps["harvests"] == ps["programs"] > 0
    assert ps["uncosted_calls"] == 0 and ps["calls_total"] > 0
    assert ps["tokens_total"] == js["tokens_total"] == 10
    jsnap, psnap = jsrv.efficiency_snapshot(), psrv.efficiency_snapshot()
    assert set(psnap) == set(jsnap)
    assert 0 < psnap["mfu"] and 0 < psnap["bandwidth_util"]
    assert psnap["hbm_drift"] == jsnap["hbm_drift"] == 0.0
    assert set(psnap["costs"]["hbm"]) == set(jsnap["costs"]["hbm"])
    assert set(pcosts.device_memory_report()) == \
        set(jcosts.device_memory_report())
    psrv.reset_efficiency_window()
    assert psrv.efficiency_snapshot()["costs"]["calls_total"] == 0

    for quant in (False, True):
        jspec = J.TransformerLM(dataclasses.replace(
            jm.config, kv_cache_quant=quant)).kv_cache_spec()
        pspec = dataclasses.replace(psrv.engine.kv_cache_spec(), quant=quant)
        pairs = [(JaxSlotPool(jspec, 3), SlotPool(pspec, 3)),
                 (JaxPagedKVPool(jspec, 3, num_pages=10, page_size=16),
                  PagedKVPool(pspec, 3, num_pages=10, page_size=16))]
        for jpool, ppool in pairs:
            jrep, prep = jcosts.kv_hbm_report(jpool), \
                pcosts.kv_hbm_report(ppool)
            assert set(prep) == set(jrep)
            for key in ("kv_bytes_predicted", "kv_bytes_per_token",
                        "kv_capacity_tokens"):
                assert prep[key] == jrep[key], (quant, key)
            assert prep["hbm_drift"] == 0.0, (quant, prep)


def test_outputs_identical_and_each_forward_charged_once():
    """Greedy and sampled tokens are bit-identical with the model on and
    off; on a paged server the pool programs carry no charge of their own
    (their engine programs do); a captured-decode server (the CPU runs
    the static-buffer step) is charged exactly as the eager one."""
    arms = {}
    for name, cost, graphs in (("off", False, False), ("on", True, False),
                               ("captured", True, True)):
        for sample in (False, True):
            srv = dst.ServingEngine(
                _port_engine(enable_cuda_graph=graphs), num_slots=2,
                prefill_chunk=8, paged_kv={"page_size": 8}, seed=3,
                do_sample=sample, temperature=0.8, cost_model=cost)
            arms[name, sample] = (srv, [r.tokens() for r in _traffic(srv)])
    for sample in (False, True):
        for name in ("on", "captured"):
            for a, b in zip(arms[name, sample][1], arms["off", sample][1]):
                np.testing.assert_array_equal(a, b)
    on, cap = arms["on", False][0].costs, arms["captured", False][0].costs
    names = {prog for prog, _ in on.programs}
    assert "InferenceEngine.decode_paged" in names
    assert "InferenceEngine.prefill_chunk" in names
    assert not {n for n in names if n.startswith("SlotPool.run_")}
    assert on.summary()["unavailable"] == 0
    for key in ("flops_total", "bytes_accessed_total", "calls_total"):
        assert cap.summary()[key] == on.summary()[key], key


def test_unknown_program_is_unavailable_and_never_raises():
    from deepspeed_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    cm = pcosts.ProgramCostModel(registry=reg)
    cm.account("Foo.bar", lambda x: x, (torch.zeros(3),), {})
    cm.account("Foo.bar", lambda x: x, (torch.zeros(3),), {})
    s = cm.summary()
    assert (s["unavailable"], s["uncosted_calls"], s["calls_total"]) == \
        (1, 2, 2)
    assert reg.gauge("telemetry/cost_model_unavailable").value == 1
    cm.step_update(0.5, tokens=4)
    assert cm.mfu == 0.0 and cm.tokens_per_gflop == 0.0


def test_peaks_and_overrides_as_in_jax(monkeypatch):
    """The nominal CPU peaks are JAX's; num_devices scales the resolved
    peaks, explicit peaks stay aggregate (tests/unit/telemetry/
    test_efficiency.py); an H100 SXM resolves to its data-sheet peaks."""
    assert pcosts.resolve_peaks("cpu") == jcosts.resolve_peaks() \
        == (1e12, 1e11)
    pf, pb = pcosts.resolve_peaks("cpu")
    for kw in ({"num_devices": 1}, {"num_devices": 4},
               {"peak_flops": 5e12, "peak_bytes_per_s": 2e11,
                "num_devices": 4}):
        got, want = pcosts.ProgramCostModel(**kw), \
            jcosts.ProgramCostModel(**kw)
        assert (got.peak_flops, got.peak_bytes_per_s, got.num_devices) == \
            (want.peak_flops, want.peak_bytes_per_s, want.num_devices)
        assert got.summary()["num_devices"] == kw["num_devices"]
    assert pcosts.ProgramCostModel(num_devices=4).peak_flops == 4 * pf
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert pcosts.resolve_peaks("cuda") == (989e12, 3.35e12)
