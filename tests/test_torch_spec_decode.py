"""Speculative decoding in the port (``serving/spec_decode/``,
``InferenceEngine.verify_k``, ``PagedKVPool.run_verify`` and the serving
step), on the CPU, against the JAX package and the port's own paths.

The parts are held against their JAX counterparts on the same seeded
inputs: the config's validation (same exceptions), the n-gram drafter and
``bucket_width`` (identical proposals), greedy acceptance through one stub
forward (identical ``out`` and ``n_emit``), ``verify_k`` on a contiguous
cache and ``run_verify`` over pages (kernel route, dense route, and K+1 = 9,
which takes the dense route: identical tokens, cache within 1e-4 as the
paged tests hold it), and the small-model drafter (identical proposals).
Sampled acceptance cannot reproduce JAX's RNG stream, so it is held to the
lossless property instead: the first emitted token's distribution over
20000 draws equals the filtered target distribution within 0.02 total
variation.

The servers are the JAX package's own spec scenarios
(``tests/unit/serving/test_spec_decode.py``, the spec cases of
``test_stallfree.py``, ``test_paging.py`` and ``test_overlap.py``): greedy
tokens equal the spec-off server's, ``generate()``'s and the JAX spec
server's, on the contiguous and paged pools, serial and stall-free,
``overlap=True`` and the captured engine (on the CPU its static-buffer
body); every run ends with a clean ``check_invariants()``. Everything is
fp32 with the JAX module's initial weights (``checkpoint.flax_import``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.inference.engine import \
    _filter_logits as jax_filter_logits
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving import SpecDecodeConfig as JaxSpecDecodeConfig
from deepspeed_tpu.serving.paged_pool import PagedKVPool as JaxPagedKVPool
from deepspeed_tpu.serving.spec_decode import drafter as jdrafter
from deepspeed_tpu.serving.spec_decode import make_drafter as jax_make_drafter
from deepspeed_tpu.serving.spec_decode.verify import \
    make_verify_fn as jax_make_verify_fn
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.inference.engine import _filter_logits
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (PagedKVPool, RequestState, SlotPool,
                                         SpecDecodeConfig)
from deepspeed_tpu_torch.serving.spec_decode import (NGramDrafter,
                                                     SmallModelDrafter,
                                                     make_drafter)
from deepspeed_tpu_torch.serving.spec_decode.drafter import bucket_width
from deepspeed_tpu_torch.serving.spec_decode.verify import make_verify_fn

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
PS = 8
# logits and cache rows of the two packages' fp32 forwards (summation order)
MODEL_ATOL = 1e-4
# the lossless property: total variation of 20000 draws against the target
TV_TOL = 0.02


def _pair(family, **overrides):
    jcfg = J.transformer_config(family, **TINY, dtype=jnp.float32,
                                **overrides)
    jm = J.TransformerLM(jcfg)
    params = jax.jit(lambda key, ids: jm.init(
        {"params": key}, ids, method=jm.logits))(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    pcfg = P.TransformerConfig(**{**fields, "dtype": torch.float32})
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    return jm, params, pcfg, state


def _engine(pcfg, state, graph=False):
    return dst.init_inference(P.TransformerLM(pcfg), device="cpu",
                              model_parameters=state,
                              config={"dtype": "float32",
                                      "enable_cuda_graph": graph})


@pytest.fixture(scope="module")
def stack():
    """GPT-2 family (learned positions): the JAX engine, and the port's
    eager and captured engines on the same weights."""
    jm, params, pcfg, state = _pair("gpt2")
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    return dict(jm=jm, params=params, jeng=jeng, pcfg=pcfg, state=state,
                eager=_engine(pcfg, state),
                graph=_engine(pcfg, state, graph=True))


@pytest.fixture(scope="module")
def llama():
    """Llama family (rotary, GQA 4/2) for the verify forwards: rotary
    positions take any offset, so a row may verify past the allocation."""
    jm, params, pcfg, state = _pair("llama", n_kv_head=2)
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    jeng._ensure_params(jnp.zeros((1, 2), jnp.int32))   # builds its jits
    return dict(jm=jm, jeng=jeng, pcfg=pcfg, eng=_engine(pcfg, state))


def _spec(k=4, **kw):
    return dict({"drafter": "ngram", "k": k, "max_ngram": 3}, **kw)


def _mixed_prompts(rng, n):
    """Half repetitive (the drafter's home turf), half random (acceptance
    near 0): parity must hold for both."""
    prompts = []
    for i in range(n):
        T = int(rng.integers(8, 28))
        if i % 2 == 0:
            motif = rng.integers(0, 64, size=int(rng.integers(3, 6)))
            prompts.append(np.tile(motif, T // len(motif) + 1)[:T]
                           .astype(np.int32))
        else:
            prompts.append(rng.integers(0, 64, size=T).astype(np.int32))
    return prompts


def _drain(srv, reqs, max_steps=400):
    srv.run_until_drained(max_steps=max_steps)
    srv.check_invariants()
    assert not srv._deferred, "deferred fetches leaked past the drain"
    for r in reqs:
        assert r.state.value == "finished", (r.request_id, r.finish_reason)
    return reqs


def _assert_generate(engine, reqs, budgets=None):
    for i, req in enumerate(reqs):
        n = req.max_new_tokens if budgets is None else budgets[i]
        want = engine.generate(np.asarray(req.prompt)[None],
                               max_new_tokens=n)[0]
        np.testing.assert_array_equal(req.tokens(), want,
                                      err_msg=f"req {req.request_id}")


# ---------------------------------------------------------------- config
CONFIG_CASES = [
    ("from_value", 7, TypeError),
    ("validate", dict(k=0), ValueError),
    ("validate", dict(k=63), ValueError),
    ("validate", dict(min_ngram=0), ValueError),
    ("validate", dict(min_ngram=3, max_ngram=2), ValueError),
    ("make_drafter", dict(drafter="model"), ValueError),
    ("make_drafter", dict(drafter="nope"), ValueError),
]


@pytest.mark.parametrize("how,arg,exc", CONFIG_CASES)
def test_spec_config_validation_matches_jax(how, arg, exc):
    """Each JAX validation case raises the same exception, with the same
    message, in both packages."""
    messages = []
    for cls, make in ((JaxSpecDecodeConfig, jax_make_drafter),
                      (SpecDecodeConfig, make_drafter)):
        with pytest.raises(exc) as info:
            if how == "from_value":
                cls.from_value(arg)
            elif how == "validate":
                cls(**arg).validate(64)
            else:
                make(cls(**arg))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_spec_config_values():
    assert SpecDecodeConfig.from_value(None) is None
    assert SpecDecodeConfig.from_value(False) is None
    cfg = SpecDecodeConfig.from_value(True)
    assert cfg.enabled and cfg.drafter == "ngram" and cfg.k == 4
    assert SpecDecodeConfig.from_value({"k": 2}).k == 2
    assert SpecDecodeConfig.from_value(cfg) is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxSpecDecodeConfig.from_value(True))
    d = NGramDrafter()
    assert make_drafter(SpecDecodeConfig(drafter=d)) is d
    assert isinstance(make_drafter(cfg), NGramDrafter)


# -------------------------------------------------------------- drafters
def test_ngram_drafter_unit():
    d = NGramDrafter(max_ngram=3, min_ngram=1)
    h = np.array([1, 2, 3, 1, 2, 3, 1, 2], np.int32)
    tokens, counts = d.propose([h, None, np.array([9], np.int32)], k=3)
    assert tokens.shape == (3, 3) and counts.shape == (3,)
    # suffix [3, 1, 2] recurs at position 2; its continuation is h[5:8]
    np.testing.assert_array_equal(tokens[0], [3, 1, 2])
    assert counts[0] == 3
    assert counts[1] == 0 and counts[2] == 0   # dead slot, short history
    # a continuation clipped by the history's end: a partial count
    tokens, counts = d.propose([np.array([5, 6, 5, 6, 5], np.int32)], k=4)
    assert 0 < counts[0] <= 4
    np.testing.assert_array_equal(
        tokens[0, :counts[0]], np.array([6, 5, 6, 5])[:counts[0]])
    # no repeated suffix anywhere: no proposal
    _, counts = d.propose([np.arange(10, dtype=np.int32)], k=3)
    assert counts[0] == 0
    with pytest.raises(ValueError, match="min_ngram"):
        NGramDrafter(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("max_ngram,min_ngram,k", [(3, 1, 4), (2, 2, 8),
                                                   (4, 1, 1)])
def test_ngram_drafter_matches_jax(max_ngram, min_ngram, k):
    """Seeded histories over a small vocabulary (so suffixes recur),
    None histories and ones too short to match: identical proposals."""
    rng = np.random.default_rng(7 + k)
    hist = [None, np.array([3], np.int32), np.array([4, 4], np.int32)]
    hist += [rng.integers(0, 6, size=int(n)).astype(np.int32)
             for n in rng.integers(2, 40, size=13)]
    mine = NGramDrafter(max_ngram, min_ngram).propose(hist, k)
    theirs = jdrafter.NGramDrafter(max_ngram, min_ngram).propose(hist, k)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert mine[1].sum() > 0                   # some rows really drafted


def test_bucket_width_matches_jax():
    for cap in (16, 64, 1024):
        for n in range(0, cap + 3):
            assert bucket_width(n, cap) == jdrafter.bucket_width(n, cap)


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies. The JAX drafter uploads its
    positions with ``jnp.asarray(pos)`` and then runs ``pos += 1`` on the
    numpy array; where the upload aliases the array's buffer (a CPU
    zero-copy, which depends on the buffer's alignment) the increment
    reaches the cache the next decode reads, so its last proposals change
    from one process to the next. A copying upload is the drafter's
    intended semantics."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, x, *args, **kwargs):
        return jnp.array(x, *args, copy=True, **kwargs)


def test_small_model_drafter_matches_jax(stack, monkeypatch):
    """The same histories (a long one truncated to the window that leaves
    room for k positions, None rows) through both packages' drafters over
    the same weights: identical proposals (the JAX drafter's uploads made
    to copy, see ``_CopyingJnp``); the kept draft cache is reused on the
    next call."""
    monkeypatch.setattr(jdrafter, "jnp", _CopyingJnp())
    rng = np.random.default_rng(13)
    hist = [rng.integers(0, 64, size=int(n)).astype(np.int32)
            for n in (5, 17, 62, 33)]
    hist.insert(2, None)
    drafter = SmallModelDrafter(stack["eager"])
    theirs = jdrafter.SmallModelDrafter(stack["jeng"]).propose(hist, 4)
    mine = drafter.propose(hist, 4)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (mine[1] == [4, 4, 0, 4, 4]).all()
    again = drafter.propose(hist[::-1], 4)
    np.testing.assert_array_equal(again[0], mine[0][::-1])
    assert len(drafter._caches) == 1


# ---------------------------------------------------------------- verify
def _stub_case(seed=3, B=7, K=4, V=64):
    """Fixed logits for a stub forward and drafts that agree with their
    argmax for a chosen prefix: draft_len 0..K, and a dead row."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    targets = logits.argmax(-1)
    draft = rng.integers(0, V, (B, K)).astype(np.int32)
    draft_len = np.array([0, 1, 2, 3, 4, 4, 0], np.int32)[:B]
    agree = np.array([0, 1, 1, 3, 4, 2, 0])[:B]     # accepted prefix wanted
    for b in range(B):
        draft[b, :agree[b]] = targets[b, :agree[b]]
        if agree[b] < K:
            draft[b, agree[b]] = (targets[b, agree[b]] + 1) % V
    return logits, draft, draft_len


def test_greedy_verify_matches_jax():
    """Greedy acceptance through one stub forward in both packages:
    identical out and n_emit for draft_len 0..K and a dead row."""
    logits, draft, draft_len = _stub_case()
    B, T, _ = logits.shape
    tokens = np.zeros((B, T), np.int32)
    jverify = jax.jit(jax_make_verify_fn(
        lambda params, cache, tok, pos: (jnp.asarray(logits), cache),
        jax_filter_logits), static_argnums=(9, 10))
    _, jout, jn = jverify({}, {}, jnp.asarray(tokens),
                          jnp.zeros((B,), jnp.int32), jnp.asarray(draft),
                          jnp.asarray(draft_len), jax.random.PRNGKey(0),
                          jnp.float32(1.0), jnp.asarray(True), 0, 1.0)
    verify = make_verify_fn(lambda cache, tok, pos: torch.from_numpy(logits),
                            _filter_logits)
    out, n_emit = verify({}, torch.from_numpy(tokens), torch.zeros(B),
                         torch.from_numpy(draft), torch.from_numpy(draft_len),
                         None, 1.0, True, 0, 1.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n_emit.numpy(), [1, 2, 2, 4, 5, 3, 1])


@pytest.mark.parametrize("top_k,top_p,temperature", [(0, 1.0, 1.0),
                                                     (5, 1.0, 0.7),
                                                     (0, 0.8, 1.3)])
def test_sampled_verify_is_lossless(top_k, top_p, temperature):
    """Rejection sampling with a point-mass draft keeps the target
    distribution: over 20000 draws at V = 8 the first emitted token's
    empirical distribution is the filtered target's (total variation
    <= 0.02), for a draft token the target likes and one it never samples;
    the second token follows only accepted drafts."""
    V, K, N = 8, 2, 20000
    gen = torch.Generator().manual_seed(11)
    base = torch.tensor([2.0, 1.2, 0.3, -0.5, 0.9, -1.0, 0.1, 1.6])
    logits = base.repeat(N, K + 1, 1)
    probs = torch.softmax(_filter_logits(base[None], temperature, top_k,
                                         top_p), dim=-1)[0]
    verify = make_verify_fn(lambda cache, tok, pos: logits, _filter_logits)
    for d0 in (int(probs.argmax()), int(probs.argmin())):
        draft = torch.full((N, K), d0)
        out, n_emit = verify({}, torch.zeros(N, K + 1, dtype=torch.long),
                             torch.zeros(N), draft,
                             torch.full((N,), K), gen, temperature, False,
                             top_k, top_p)
        freq = torch.bincount(out[:, 0], minlength=V).float() / N
        tv = 0.5 * (freq - probs).abs().sum().item()
        assert tv <= TV_TOL, (d0, tv, freq.tolist(), probs.tolist())
        assert ((out[:, 0] == d0) == (n_emit > 1)).all()
        assert (n_emit >= 1).all() and (n_emit <= K + 1).all()


def _greedy_drafts(step, tokens0, K, rows_agree):
    """Drafts from the model's own greedy continuation (``step(tok, i)``
    runs decode step i on a copy of the cache): row b keeps
    ``rows_agree[b]`` tokens of it, then one wrong token."""
    cont, cur = [], tokens0
    for i in range(K):
        cur = step(cur, i).argmax(-1)
        cont.append(cur)
    draft = torch.stack(cont, 1)
    for b, a in enumerate(rows_agree):
        if a < K:
            draft[b, a] = (draft[b, a] + 1) % TINY["vocab_size"]
    return draft


def test_verify_k_matches_jax(llama):
    """``verify_k`` on a contiguous cache against the JAX engine's: rows
    that accept all, part and none of their drafts, a draft_len 0 row, a
    dead row, and a row ending one position short of the allocation:
    identical out and n_emit, cache within 1e-4."""
    K, B, S = 4, 6, TINY["max_seq_len"]
    spec = llama["eng"].kv_cache_spec()
    L, KV, D = spec.n_layer, spec.kv_heads, spec.head_dim
    rng = np.random.default_rng(5)
    k = rng.standard_normal((L, B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, KV, S, D)).astype(np.float32)
    starts = np.array([12, 9, 30, 5, 0, S - K - 2])
    draft_len = np.array([4, 4, 2, 0, 0, 4])
    tokens0 = torch.from_numpy(rng.integers(0, 64, B))
    pm = llama["eng"].module
    probe = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    draft = _greedy_drafts(
        lambda tok, i: pm.decode(tok[:, None], torch.from_numpy(starts + i),
                                 probe)[:, 0], tokens0, K,
        [4, 1, 4, 0, 0, 4])
    tokens = torch.cat([tokens0[:, None], draft], 1)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    out, n_emit = llama["eng"].verify_k(
        cache, tokens, torch.from_numpy(starts), draft,
        torch.from_numpy(draft_len), None, 1.0, True, 0, 1.0)
    jcache = {"cache_store": {
        "k": jnp.asarray(k.transpose(0, 1, 2, 4, 3)),
        "v": jnp.asarray(v.transpose(0, 1, 2, 4, 3)),
        "index": jnp.asarray(starts, jnp.int32)}}
    jcache, jout, jn = llama["jeng"].verify_k(
        jcache, jnp.asarray(tokens.numpy(), jnp.int32),
        jnp.asarray(starts, jnp.int32), jnp.asarray(draft.numpy(), jnp.int32),
        jnp.asarray(draft_len, jnp.int32), jax.random.PRNGKey(0),
        jnp.float32(1.0), jnp.asarray(True), 0, 1.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n_emit.numpy(), [5, 2, 3, 1, 1, 5])
    for side in ("k", "v"):
        want = np.asarray(jcache["cache_store"][side]).transpose(0, 1, 2, 4, 3)
        np.testing.assert_allclose(cache[side].numpy(), want,
                                   atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8-cache"])
def test_verify_drops_writes_past_the_allocation(llama, quant):
    """A row whose K+1 positions run past the allocation (a dead or
    prefilling row in a server): its positions inside are written as in a
    wider cache, the ones past it are dropped, and the rows before its
    start keep their values exactly (the dropped writes put back what was
    there, with no host sync). Rotary positions, so every offset is
    valid."""
    K, S = 4, TINY["max_seq_len"]
    pcfg = dataclasses.replace(llama["pcfg"], kv_cache_quant=quant)
    wide_cfg = dataclasses.replace(pcfg, max_seq_len=S + 16)
    pm = P.TransformerLM(pcfg)
    pm.load_state_dict(llama["eng"].module.state_dict())
    wide = P.TransformerLM(wide_cfg)
    wide.load_state_dict(pm.state_dict())
    torch.manual_seed(0)
    ids = torch.randint(0, 64, (3, 20))
    _, cache = pm.prefill(ids)
    _, wcache = wide.prefill(ids)
    before = {name: leaf.clone() for name, leaf in cache.items()}
    starts = torch.tensor([S - 2, S, 7])
    tokens = torch.randint(0, 64, (3, K + 1))
    pm.decode(tokens, starts, cache)
    wide.decode(tokens, starts, wcache)
    for name, leaf in cache.items():
        kept = wcache[name][:, :, :, :S]
        # row 0: S-2, S-1 written, the rest dropped; row 1: nothing kept
        torch.testing.assert_close(leaf, kept, atol=MODEL_ATOL, rtol=0)
        assert torch.equal(leaf[:, 0, :, :S - 2],
                           before[name][:, 0, :, :S - 2])
        assert torch.equal(leaf[:, 1], before[name][:, 1])


def _jax_pool(llama, kernel, B, Pn, k, v, table, starts):
    jspec = J.make_kv_cache_spec(llama["jm"].config)
    jpool = JaxPagedKVPool(jspec, B, num_pages=Pn, page_size=PS,
                           prefix_cache=False, kernel=kernel)
    jpool.cache = {"cache_store": {
        "k": jnp.asarray(k.transpose(0, 1, 2, 4, 3)),
        "v": jnp.asarray(v.transpose(0, 1, 2, 4, 3)),
        "index": jnp.asarray(starts, jnp.int32),
        "table": jnp.asarray(table)}}
    return jpool


@pytest.mark.parametrize("kernel,K", [("on", 4), ("off", 4), ("on", 8)],
                         ids=["kernel", "dense", "k8-dense"])
def test_run_verify_matches_jax(llama, kernel, K):
    """``run_verify`` over pages against the JAX pool's: the kernel route
    (``decode_paged``, T = K+1), the dense composition (``kernel="off"``)
    and K+1 = 9, past the kernel's 8 query rows (the dense route on a
    kernel pool). Rows that accept all and part of their drafts, one whose
    window crosses a page boundary, one whose last positions fall on an
    unmapped page (dropped; the port writes them to its scratch page) and
    a dead row: identical out and n_emit on the mapped rows, every page
    within 1e-4."""
    B, S = 5, TINY["max_seq_len"]
    spec = llama["eng"].kv_cache_spec()
    L, KV, D = spec.n_layer, spec.kv_heads, spec.head_dim
    per_slot = S // PS
    Pn = B * per_slot
    rng = np.random.default_rng(17 + K)
    k = rng.standard_normal((L, Pn, KV, PS, D)).astype(np.float32)
    v = rng.standard_normal((L, Pn, KV, PS, D)).astype(np.float32)
    starts = np.array([5, 14, 21, 6, 0])
    table = rng.permutation(Pn).reshape(B, per_slot).astype(np.int32)
    live = (starts + K + 1 + PS - 1) // PS
    live[3] = 1                                  # row 3: the tail unmapped
    live[4] = 0                                  # row 4: dead
    table = np.where(np.arange(per_slot)[None] < live[:, None], table,
                     Pn).astype(np.int32)
    mapped = [0, 1, 2]
    draft_len = np.array([K, K, K - 1, K, 0])
    pool = PagedKVPool(spec, B, num_pages=Pn, page_size=PS, device="cpu",
                       prefix_cache=False, kernel=kernel)
    pool.cache["k"][:, :Pn] = torch.from_numpy(k)
    pool.cache["v"][:, :Pn] = torch.from_numpy(v)
    pool.table[:] = table
    pool._sync_table()
    eng = llama["eng"]
    probe = {name: leaf.clone() for name, leaf in pool.cache.items()}
    tokens0 = torch.from_numpy(rng.integers(0, 64, B))
    draft = _greedy_drafts(
        lambda tok, i: eng.module.decode_paged(
            tok[:, None], torch.from_numpy(starts + i), probe, pool.table_dev,
            scratch_page=True)[:, 0], tokens0, K, [K, 2, K, K, 0])
    tokens = torch.cat([tokens0[:, None], draft], 1)
    out, n_emit = pool.run_verify(eng, tokens, torch.from_numpy(starts),
                                  draft, torch.from_numpy(draft_len), None,
                                  1.0, True, 0, 1.0)
    jpool = _jax_pool(llama, kernel, B, Pn, k, v, table, starts)
    jout, jn = jpool.run_verify(
        llama["jeng"], jnp.asarray(tokens.numpy(), jnp.int32),
        jnp.asarray(starts, jnp.int32), jnp.asarray(draft.numpy(), jnp.int32),
        jnp.asarray(draft_len, jnp.int32), jax.random.PRNGKey(0),
        jnp.float32(1.0), jnp.asarray(True), 0, 1.0)
    np.testing.assert_array_equal(out.numpy()[mapped],
                                  np.asarray(jout)[mapped])
    np.testing.assert_array_equal(n_emit.numpy()[mapped],
                                  np.asarray(jn)[mapped])
    np.testing.assert_array_equal(n_emit.numpy()[mapped], [K + 1, 3, K])
    for side in ("k", "v"):
        want = np.asarray(jpool.cache["cache_store"][side])
        np.testing.assert_allclose(pool.cache[side][:, :Pn].numpy(),
                                   want.transpose(0, 1, 2, 4, 3),
                                   atol=MODEL_ATOL, rtol=0)


def test_captured_paged_verify_refuses_the_dense_route(stack):
    """A captured engine verifies through the paged kernel only: a server
    whose k+1 exceeds its 8 query rows is refused at construction, and
    the pool refuses the dense route for it."""
    with pytest.raises(ValueError, match="query rows"):
        dst.ServingEngine(stack["graph"], num_slots=2, prefill_chunk=PS,
                          paged_kv={"page_size": PS}, spec_decode=_spec(8))
    pool = PagedKVPool(stack["graph"].kv_cache_spec(), 2, page_size=PS,
                       device="cpu", kernel="on")
    with pytest.raises(ValueError, match="cannot be captured"):
        pool.run_verify(stack["graph"], torch.zeros(2, 9, dtype=torch.long),
                        torch.zeros(2), torch.zeros(2, 8, dtype=torch.long),
                        torch.zeros(2, dtype=torch.long), None, 1.0, True, 0,
                        1.0)


# --------------------------------------------------------------- servers
@pytest.fixture(scope="module")
def multiwave(stack):
    """The JAX acceptance scenario: 7 mixed prompts, staggered one per
    step, through 2 slots (slot reuse), and the JAX spec server's tokens
    for it."""
    rng = np.random.default_rng(23)
    prompts = _mixed_prompts(rng, 7)
    budgets = [int(b) for b in rng.integers(4, 24, size=7)]
    jsrv = JaxServingEngine(stack["jeng"], num_slots=2, max_queue_depth=16,
                            spec_decode=_spec(4))
    jreqs = []
    for p, b in zip(prompts, budgets):
        jreqs.append(jsrv.submit(p, max_new_tokens=b))
        jsrv.step()
    jsrv.run_until_drained(max_steps=300)
    jsrv.check_invariants()
    return prompts, budgets, [np.asarray(r.tokens()) for r in jreqs]


def _staggered(srv, prompts, budgets):
    reqs = []
    for p, b in zip(prompts, budgets):
        reqs.append(srv.submit(p, max_new_tokens=b))
        srv.step()
    return _drain(srv, reqs)


SERVER_ARMS = {
    "contiguous": dict(),
    "contiguous-serial": dict(prefill_chunk=0),
    "paged": dict(prefill_chunk=PS, paged_kv={"page_size": PS}),
    "paged-dense": dict(prefill_chunk=PS,
                        paged_kv={"page_size": PS, "kernel": "off"}),
    "overlap": dict(prefill_chunk=PS, overlap=True),
    "captured": dict(prefill_chunk=PS, strict_recompile=True),
    "captured-paged-overlap": dict(prefill_chunk=PS, overlap=True,
                                   paged_kv={"page_size": PS},
                                   strict_recompile=True),
}


@pytest.mark.parametrize("arm", list(SERVER_ARMS))
def test_greedy_parity_multiwave_staggered(stack, multiwave, arm):
    """The acceptance bar on every port path: the spec server's greedy
    tokens equal the spec-off server's, generate()'s and the JAX spec
    server's, with fewer decode steps than tokens."""
    prompts, budgets, jax_tokens = multiwave
    engine = stack["graph" if arm.startswith("captured") else "eager"]

    def run(spec):
        srv = dst.ServingEngine(engine, num_slots=2, max_queue_depth=16,
                                spec_decode=spec, **SERVER_ARMS[arm])
        return _staggered(srv, prompts, budgets), srv

    off, _ = run(None)
    on, srv = run(_spec(4))
    for a, b, want in zip(on, off, jax_tokens):
        np.testing.assert_array_equal(a.tokens(), b.tokens())
        np.testing.assert_array_equal(a.tokens(), want)
    _assert_generate(stack["eager"], on)
    s = srv.stats()
    assert s["spec_drafted"] > 0 and s["spec_accepted"] > 0
    assert s["tokens_per_decode_step"] > 1.0
    assert s["decode_steps"] < sum(budgets)
    if arm.startswith("captured"):
        # the verify forward is the server's only captured step
        assert [e["program"] for e in srv.watchdog.events].count(
            "DecodeGraphs.capture") == 1


def test_eos_mid_accepted_chunk(stack):
    """An eos emitted INSIDE an accepted draft chunk truncates the
    emission, retires the slot that step, and matches generate()'s
    prefix."""
    engine = stack["eager"]
    prompt = np.tile(np.array([7, 3, 11, 5], np.int32), 5)
    gen = engine.generate(prompt[None], max_new_tokens=12)[0][len(prompt):]
    eos = int(gen[3])
    first = int(np.argmax(gen == eos))
    for kw in (dict(), dict(paged_kv={"page_size": PS}, prefill_chunk=PS)):
        srv = dst.ServingEngine(engine, num_slots=2, max_queue_depth=4,
                                spec_decode=_spec(5), **kw)
        req = srv.submit(prompt, max_new_tokens=12, eos_token_id=eos)
        _drain(srv, [req], 50)
        assert req.finish_reason == "eos"
        np.testing.assert_array_equal(req.output_tokens, gen[:first + 1])


def test_do_sample_spec_smoke(stack):
    """The rejection-sampling path through the server: budgets met, tokens
    in the vocabulary, and the same seed gives the same tokens."""
    rng = np.random.default_rng(29)
    prompts = _mixed_prompts(rng, 4)

    def run():
        srv = dst.ServingEngine(stack["eager"], num_slots=2,
                                max_queue_depth=8, do_sample=True,
                                temperature=1.0, seed=5,
                                spec_decode=_spec(3))
        reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
        return _drain(srv, reqs, 100)

    a, b = run(), run()
    for r, s in zip(a, b):
        assert len(r.output_tokens) == 6
        assert all(0 <= t < 64 for t in r.output_tokens)
        assert r.output_tokens == s.output_tokens


def test_spec_churn_does_not_recompile(stack):
    """Slot retire/admit churn with speculation on a captured engine under
    strict_recompile: after a warm-up wave, another wave records no
    signature and no capture (draft_len masking absorbs every
    live/dead/non-speculating mix), and the verify step was captured
    once."""
    rng = np.random.default_rng(31)
    srv = dst.ServingEngine(stack["graph"], num_slots=2, max_queue_depth=16,
                            prefill_chunk=PS, strict_recompile=True,
                            paged_kv={"page_size": PS}, spec_decode=_spec(4))
    warm = [rng.integers(0, 64, size=n).astype(np.int32)
            for n in (5, 12, 40, 20)]
    _drain(srv, [srv.submit(p, max_new_tokens=5) for p in warm])
    srv.end_warmup()
    for _ in range(2):
        reqs = [srv.submit(p, max_new_tokens=5)
                for p in _mixed_prompts(rng, 6)]
        _drain(srv, reqs)
    assert srv.watchdog.recompiles == 0
    progs = [e["program"] for e in srv.watchdog.events]
    assert progs.count("DecodeGraphs.capture") == 1
    assert "SlotPool.run_verify" in progs
    assert "SlotPool.run_decode" not in progs     # every step verified


def test_capacity_margin_tightens_admission(stack):
    """With spec on, admission reserves k positions of verify headroom: a
    request that fits the raw capacity but not capacity - k is refused as
    prompt_too_long; with paged KV the k columns count in its pages."""
    engine = stack["eager"]
    prompt = np.zeros((40,), np.int32)   # 40 + 20 = 60 <= 64, > 64 - 6
    off = dst.ServingEngine(engine, num_slots=2, max_queue_depth=4)
    assert off.submit(prompt, max_new_tokens=20).state is RequestState.QUEUED
    on = dst.ServingEngine(engine, num_slots=2, max_queue_depth=4,
                           spec_decode=_spec(6))
    r = on.submit(prompt, max_new_tokens=20)
    assert r.state is RequestState.REJECTED
    assert r.reject_reason == "prompt_too_long"
    assert on.submit(prompt, max_new_tokens=18).state is RequestState.QUEUED
    paged = dst.ServingEngine(engine, num_slots=2, prefill_chunk=PS,
                              paged_kv={"page_size": PS, "num_pages": 6},
                              spec_decode=_spec(6))
    assert paged.scheduler.page_headroom == 6
    # 40 + 2 + 6 = 48 columns = 6 pages fit; one more token does not
    assert paged.submit(prompt, max_new_tokens=2).state \
        is RequestState.QUEUED
    assert paged.submit(prompt, max_new_tokens=3).state \
        is RequestState.REJECTED


def test_slot_pool_advance_per_slot(stack):
    """advance(array) is the rollback primitive: the lengths move per
    slot, and the device positions follow at the next step."""
    pool = SlotPool(stack["eager"].kv_cache_spec(), 3, "cpu")
    for slot in range(3):
        pool.alloc()
    pool.starts[:] = [5, 9, 2]
    pool.advance(np.array([3, 0, 1], np.int32))
    np.testing.assert_array_equal(pool.starts, [8, 9, 3])
    np.testing.assert_array_equal(pool.positions_dev().numpy(), [8, 9, 3])
    with pytest.raises(ValueError, match="shape"):
        pool.advance(np.zeros((2,), np.int32))


def test_spec_decode_skips_prefilling_slots(stack):
    """Speculation + chunked admission: verify steps must not advance or
    corrupt half-prefilled rows; both the running and the chunked request
    equal generate()."""
    rng = np.random.default_rng(41)
    for kw in (dict(), dict(paged_kv={"page_size": 16})):
        srv = dst.ServingEngine(stack["eager"], num_slots=2,
                                max_queue_depth=8, prefill_chunk=16,
                                spec_decode=_spec(4), **kw)
        short = srv.submit(rng.integers(1, 64, size=9).astype(np.int32),
                           max_new_tokens=12)
        long = srv.submit(rng.integers(1, 64, size=44).astype(np.int32),
                          max_new_tokens=6)
        _drain(srv, [short, long], 200)
        assert long.chunks > 1
        _assert_generate(stack["eager"], [short, long])


def test_spec_decode_paged_parity_across_page_boundary(stack):
    """Draft-verify over the paged pool: the K+1 window and its rollback
    straddle page boundaries (budgets span several pages); greedy output
    equals generate() and the JAX paged spec server's."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 8, size=n).astype(np.int32)
               for n in (6, 14, 10)]               # small vocab: n-gram hits
    budgets = [20, 18, 16]
    srv = dst.ServingEngine(stack["eager"], num_slots=2, max_queue_depth=32,
                            prefill_chunk=PS, paged_kv={"page_size": PS},
                            spec_decode=_spec(3))
    reqs = _drain(srv, [srv.submit(p, max_new_tokens=b)
                        for p, b in zip(prompts, budgets)])
    _assert_generate(stack["eager"], reqs)
    jsrv = JaxServingEngine(stack["jeng"], num_slots=2, max_queue_depth=32,
                            prefill_chunk=PS,
                            paged_kv={"page_size": PS, "kernel": "off"},
                            spec_decode=_spec(3))
    jreqs = [jsrv.submit(p, max_new_tokens=b)
             for p, b in zip(prompts, budgets)]
    jsrv.run_until_drained(max_steps=300)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.tokens(), np.asarray(b.tokens()))
    assert srv.stats()["spec_accepted"] > 0


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_overlap_spec_outcome_parity(stack, graph, paged):
    """The same staggered workload through overlap and serial spec
    servers: identical tokens and finish reasons."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, size=int(T)).astype(np.int32)
               for T in rng.integers(3, 22, size=8)]
    budgets = [int(b) for b in rng.integers(3, 10, size=8)]
    kw = dict(paged_kv={"page_size": PS}) if paged else {}

    def run(overlap):
        srv = dst.ServingEngine(stack["graph" if graph else "eager"],
                                num_slots=3, max_queue_depth=32,
                                prefill_chunk=PS, overlap=overlap,
                                spec_decode=_spec(3), **kw)
        return _drain(srv, [srv.submit(p, max_new_tokens=b)
                            for p, b in zip(prompts, budgets)], 600)

    for a, b in zip(run(False), run(True)):
        assert a.finish_reason == b.finish_reason
        np.testing.assert_array_equal(a.tokens(), b.tokens())


def test_prefix_hit_after_spec_decoded_request(stack):
    """A request seated on the pages a spec-decoded request published
    (their rejected draft rows rolled back, never in a cached page) gives
    generate()'s tokens; so does the full-hit duplicate."""
    rng = np.random.default_rng(53)
    motif = rng.integers(0, 64, size=5)
    first = np.tile(motif, 6)[:26].astype(np.int32)
    second = np.concatenate([first[:24], rng.integers(0, 64, 7)]) \
        .astype(np.int32)
    srv = dst.ServingEngine(stack["eager"], num_slots=2, max_queue_depth=8,
                            prefill_chunk=PS, paged_kv={"page_size": PS},
                            spec_decode=_spec(4))
    a = _drain(srv, [srv.submit(first, max_new_tokens=14)])
    assert a[0].spec_accepted > 0
    b = _drain(srv, [srv.submit(second, max_new_tokens=10),
                     srv.submit(first, max_new_tokens=9)])
    assert all(r.prefix_hit_tokens > 0 for r in b)
    _assert_generate(stack["eager"], a + b)


def test_small_model_drafter_self_speculation(stack):
    """Drafting with the target's own weights (the degenerate two-model
    setup) through a captured draft engine keeps exact parity and accepts
    nearly everything; each server's drafter replays one captured decode
    step on its kept draft cache."""
    draft_eng = _engine(stack["pcfg"], stack["state"], graph=True)
    rng = np.random.default_rng(37)
    prompts = _mixed_prompts(rng, 4)
    for n, kw in enumerate((dict(), dict(paged_kv={"page_size": PS},
                                         prefill_chunk=PS))):
        srv = dst.ServingEngine(stack["eager"], num_slots=2,
                                max_queue_depth=8,
                                spec_decode={"drafter": "model", "k": 4,
                                             "draft_engine": draft_eng},
                                **kw)
        reqs = _drain(srv, [srv.submit(p, max_new_tokens=10)
                            for p in prompts], 100)
        _assert_generate(stack["eager"], reqs)
        s = srv.stats()
        assert s["spec_acceptance_rate"] > 0.8
        assert s["tokens_per_decode_step"] > 2.0
        assert "Drafter.prefill_at" in {e["program"]
                                        for e in srv.watchdog.events}
        assert draft_eng.decode_graphs.captures == n + 1


class _Monitor:
    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def test_spec_stats_and_monitor_events(stack):
    """The summary keys of the JAX server, and the spec monitor events."""
    mon = _Monitor()
    srv = dst.init_serving(P.TransformerLM(stack["pcfg"]), device="cpu",
                           model_parameters=stack["state"],
                           config={"dtype": "float32"}, num_slots=2,
                           monitor=mon, spec_decode=_spec(4))
    prompt = np.tile(np.array([9, 2, 30], np.int32), 6)
    req = _drain(srv, [srv.submit(prompt, max_new_tokens=12)])[0]
    s = srv.stats()
    assert s["spec_k"] == 4
    assert s["spec_drafted"] == req.spec_drafted > 0
    assert s["spec_accepted"] == req.spec_accepted > 0
    assert s["spec_acceptance_rate"] == pytest.approx(
        req.spec_accepted / req.spec_drafted)
    assert 0.0 <= s["draft_overhead_pct"] <= 100.0
    tags = {t for t, _, _ in mon.events}
    assert {"serving/spec_acceptance",
            "serving/spec_tokens_per_slot_step"} <= tags
    off = dst.ServingEngine(srv.engine, num_slots=2).stats()
    assert off["spec_k"] == 0 and off["spec_acceptance_rate"] is None
