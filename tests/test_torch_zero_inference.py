"""The port's ZeRO-Inference engine (layer-streamed weights) against the
port's resident ``TransformerLM`` and the JAX package's
``ZeroInferenceEngine``, on the CPU (the port of
``tests/unit/inference/test_zero_inference.py``).

Streamed and resident run the same blocks on the same weights, so in fp32
they agree within summation noise (1e-5); so do the port and the JAX
engine (the weights cross through the weight bridge). Greedy tokens are
identical. The int8 tier rounds each projection's input to bf16 in both
packages, and fp32 summation order can move a value across a bf16
rounding boundary, which shifts a logit by about one rounding step (the
int8 model test's 2e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.inference.zero_inference import \
    ZeroInferenceEngine as JaxZeroInferenceEngine
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.inference import ZeroInferenceEngine
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.utils.streaming import LayerWireFormat

from _torch_threads import one_thread  # noqa: F401


ATOL = 1e-5
INT8_ATOL = 2e-3
V = 64


@functools.lru_cache(maxsize=None)
def _family(family, n_layer=3):
    """(JAX config, flax params, port config, port state dict, resident
    port model) for a tiny fp32 model; JAX weights from shapes and numpy,
    so no init program compiles."""
    jcfg = J.transformer_config(family, vocab_size=V, n_layer=n_layer,
                                n_head=2, n_embd=32, max_seq_len=32,
                                dtype=jnp.float32)
    jm = J.TransformerLM(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        method=jm.logits))["params"]
    rng = np.random.default_rng(len(family) + n_layer)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, a.shape).astype(np.float32), shapes)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    pcfg = P.TransformerConfig(**fields)
    sd = state_dict_from_flax(pcfg, params)
    resident = P.TransformerLM(pcfg)
    resident.load_state_dict(sd)
    return jcfg, params, pcfg, sd, resident.eval()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


@pytest.mark.parametrize("family", ["gpt2", "llama", "bloom"])
def test_streamed_matches_resident_and_jax(family):
    """bloom: the embedding layernorm and ALiBi; gpt2: learned positions
    and the tied head; llama: rotary, RMSNorm, SwiGLU."""
    jcfg, params, pcfg, sd, resident = _family(family)
    ids = _ids(2, (2, 12))
    zi = ZeroInferenceEngine(pcfg, sd, device="cpu")
    times = []
    got = zi.forward(ids, layer_times=times).numpy()
    assert len(times) == pcfg.n_layer and min(times) > 0
    with torch.no_grad():
        want = resident.logits(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jax_out = JaxZeroInferenceEngine(jcfg, params, dtype=jnp.float32)(ids)
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=ATOL, rtol=0)


def test_prefetch_variants_and_unpacked_layers_agree():
    """prefetch 0, 1 and 2 (rotations of 2-4 staging buffers) and
    pack=False: the same logits bit for bit, and as many bytes streamed as
    layers."""
    _, _, pcfg, sd, _ = _family("gpt2", n_layer=4)
    ids = _ids(3, (1, 8))
    outs = []
    for prefetch, pack in ((0, True), (1, True), (2, True), (1, False)):
        zi = ZeroInferenceEngine(pcfg, sd, prefetch=prefetch, pack=pack,
                                 device="cpu")
        outs.append(zi(ids))
        assert zi.streamed_bytes == pcfg.n_layer * zi.layer_nbytes
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_memmap_host_weights(tmp_path):
    """Weights can live in memory-mapped files (the NVMe tier)."""
    _, _, pcfg, sd, resident = _family("llama")
    mapped = {}
    for i, (key, val) in enumerate(sd.items()):
        path = tmp_path / f"w{i}.npy"
        np.save(path, val.numpy())
        mapped[key] = np.load(path, mmap_mode="r")
    ids = _ids(4, (2, 8))
    got = ZeroInferenceEngine(pcfg, mapped, device="cpu")(ids)
    with torch.no_grad():
        want = resident.logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_streamed_generate_matches_resident_and_jax():
    """Greedy generate() under streaming (per-layer device caches built by
    the prefill pass, updated by each decode pass) equals the resident
    engine's and the JAX streamed engine's; max_new_tokens=0 returns the
    prompt."""
    jcfg, params, pcfg, sd, resident = _family("llama")
    ids = _ids(5, (2, 6))
    expect = dst.init_inference(resident, config={"dtype": "float32"},
                                device="cpu").generate(ids, max_new_tokens=6)
    zi = ZeroInferenceEngine(pcfg, sd, device="cpu")
    got = zi.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got, expect)
    jax_got = JaxZeroInferenceEngine(jcfg, params, dtype=jnp.float32) \
        .generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got, np.asarray(jax_got))
    np.testing.assert_array_equal(zi.generate(ids, max_new_tokens=0), ids)
    with pytest.raises(ValueError, match="max_seq_len"):
        zi.generate(ids, max_new_tokens=40)


def test_score_matches_jax_and_ranks_likely_sequences():
    """score(): per-sequence mean log-likelihood, as the JAX engine scores
    (1e-5); a sequence the model itself generated greedily outscores
    random ones."""
    jcfg, params, pcfg, sd, resident = _family("gpt2")
    zi = ZeroInferenceEngine(pcfg, sd, device="cpu")
    rand = _ids(6, (3, 16))
    greedy = zi.generate(rand[:1, :4], max_new_tokens=12)
    ids = np.concatenate([rand, greedy])
    scores = zi.score(ids)
    assert scores.shape == (4,) and np.isfinite(scores).all()
    want = JaxZeroInferenceEngine(jcfg, params, dtype=jnp.float32).score(ids)
    np.testing.assert_allclose(scores, np.asarray(want), atol=ATOL, rtol=0)
    assert scores.argmax() == 3


def test_int8_streaming_tier_matches_jax():
    """int8=True: the projections stream as int8 + per-channel scales
    (about half the bytes), logits agree with the JAX int8 tier and track
    the fp32 stream, and generate() runs."""
    jcfg, params, pcfg, sd, _ = _family("llama")
    ids = _ids(7, (2, 10))
    ref = ZeroInferenceEngine(pcfg, sd, device="cpu")
    q = ZeroInferenceEngine(pcfg, sd, int8=True, device="cpu")
    assert q.config.int8_weights and not pcfg.int8_weights
    assert q.layer_nbytes < 0.7 * ref.layer_nbytes
    assert q._wire.uniform_dtype is None
    got = q(ids).numpy()
    want = JaxZeroInferenceEngine(jcfg, params, dtype=jnp.float32,
                                  int8=True)(ids)
    np.testing.assert_allclose(got, np.asarray(want), atol=INT8_ATOL, rtol=0)
    agree = (got.argmax(-1) == ref(ids).numpy().argmax(-1)).mean()
    assert agree > 0.9, agree
    assert q.generate(ids, max_new_tokens=4).shape == (2, 14)


def test_wire_format_round_trip():
    """pack_into / unpack / unpack_typed / unpack_host: every leaf comes
    back in its wire dtype at an aligned offset; int8 and "scale" leaves
    keep their dtype, other floats take the compute dtype."""
    layer = {"w": torch.randn(5, 7), "q": torch.randint(-8, 8, (3, 4),
                                                         dtype=torch.int8),
             "proj.scale": torch.rand(6), "b": torch.randn(3).double()}
    wire = LayerWireFormat(layer, torch.bfloat16,
                           keep_dtype=lambda n, _: n.endswith(".scale"))
    assert wire.uniform_dtype is None
    assert [str(d) for d in wire.wire_dtypes] == [
        "torch.bfloat16", "torch.int8", "torch.float32", "torch.bfloat16"]
    buf = torch.zeros(wire.total_nbytes, dtype=torch.uint8)
    wire.pack_into(layer, buf)
    for out in (wire.unpack(buf), wire.unpack_host(buf)):
        for name, leaf in layer.items():
            want = leaf if name in ("q", "proj.scale") else \
                leaf.to(torch.bfloat16)
            assert out[name].dtype == want.dtype
            assert torch.equal(out[name], want), name
    typed = LayerWireFormat({"a": torch.randn(4, 3), "b": torch.randn(5)},
                            torch.float32)
    assert typed.uniform_dtype == torch.float32
    buf = torch.zeros(typed.total_nbytes, dtype=torch.uint8)
    typed.pack_into({"a": torch.ones(4, 3), "b": torch.full((5,), 2.0)}, buf)
    out = typed.unpack_typed(buf.view(torch.float32))
    assert out["a"].shape == (4, 3) and (out["a"] == 1).all()
    assert (out["b"] == 2).all()
