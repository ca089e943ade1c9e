"""The port's decode attention against the JAX package's Pallas kernel.

The JAX kernel reads its positions-minor cache (B, KV, D, S), so the test
hands it the transpose of the port's (B, KV, S, D) cache, with a small
``block_s`` so that several blocks run, and lengths 1, mid and S. Both sides
compute in fp32: the tolerance (2e-5 absolute on unit-scale outputs) covers
the kernel's blockwise online softmax against one full softmax.

The CUDA kernel splits S into ``decode_plan``'s chunks and merges them;
its split and merge are emulated here in plain torch, step for step (each
chunk's 16-position groups dealt to 4 warps in turn, an online softmax per
warp with p rounded where the kernel rounds it, the warps merged, then the
chunks in order) and held against the JAX kernel. On an fp32 cache nothing
is rounded, so the merge's algebra is held to the fp32 tolerance above; a
chunk of one position dropped or counted twice moves an output by about
1/65. On a bf16 cache and an int8 cache (bf16 queries) both sides round p
(times the V scale) to bf16 before the PV product, relative to the running
maxima of different blocks, and round the output to bf16: outputs lie below
4 in magnitude, where bf16's spacing is at most 2^-6, so two output
roundings and the probabilities' (which average out in the weighted sum)
stay under 3e-2, the card tests' bound for the kernel itself.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer_lm import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.attention.decode_attention import \
    decode_attention as jax_decode
from deepspeed_tpu_torch.ops.attention.decode_attention import (
    MAX_SPLITS, PLAN_ROUND, alibi_slopes, decode_attention, decode_design,
    decode_plan, quantize_kv_rows)

ATOL = 2e-5
B, S, D = 3, 64, 32


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
def test_matches_jax_kernel(H, KV, alibi):
    rng = np.random.default_rng(H * 10 + KV + alibi)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    lengths = np.array([1, 37, S], np.int32)
    slopes = np.array(jax_slopes(H)) if alibi else None
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), jnp.asarray(lengths),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        block_s=16))
    got = decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert decode_attention.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("n_head", [4, 8, 12])
def test_alibi_slopes_match_jax(n_head):
    np.testing.assert_allclose(alibi_slopes(n_head).numpy(),
                               np.asarray(jax_slopes(n_head)), rtol=1e-7)


def test_free_slot_row_is_finite_and_int8_is_a_later_slice():
    q = torch.randn(2, 2, D)
    cache = torch.randn(2, 2, S, D)
    out = decode_attention(q, cache, cache, torch.tensor([0, 1],
                                                         dtype=torch.int32))
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    # the int8 cache is ported: unit scales over int8 rows equal the plain
    # attention over the same values, a free row stays 0, and one scale
    # tensor without the other is refused
    c8 = (cache * 20).round().clamp(-127, 127).to(torch.int8)
    ones = torch.ones(2, 2, S)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    got = decode_attention(q, c8, c8, lengths, k_scale=ones, v_scale=ones)
    want = decode_attention(q, c8.float(), c8.float(), lengths)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got[0] == 0).all()
    with pytest.raises(ValueError, match="both"):
        decode_attention(q, c8, c8, 1, k_scale=ones)


@pytest.mark.parametrize("B,H,KV,S,D,sms,want", [
    # serve_int8_contiguous: TinyLlama's 32 heads over 4, 4 slots of 2048
    (4, 32, 4, 2048, 64, 132, (8, 256)),
    # the serve row: GPT-2's 12 heads, 8 slots of 1024 (96 groups: no split)
    (8, 12, 12, 1024, 64, 132, (1, 1024)),
    # 3 slots: 36 groups, 3 chunks a group
    (3, 12, 12, 1000, 64, 132, (3, 384)),
    # enough groups to fill the card: no split
    (64, 32, 8, 2048, 128, 132, (1, 2048)),
    # S below one round: one chunk of one round
    (2, 8, 8, 40, 64, 132, (1, 64)),
    # a ragged S: the last chunk runs past it, none starts past it
    (5, 8, 2, 300, 64, 132, (5, 64)),
    # 40 heads over 2: two blocks of heads a KV head, 16 chunks a group
    (1, 40, 2, 4096, 64, 132, (16, 256)),
])
def test_decode_plan(B, H, KV, S, D, sms, want):
    """The kernel's split of S: from the shapes alone (no lengths argument),
    1 to 16 chunks of whole rounds of 4 warps x 16 positions (the mma tile's
    positions), covering S with none past it."""
    assert "lengths" not in inspect.signature(decode_plan).parameters
    splits, chunk = decode_plan(B, H, KV, S, D, sms)
    assert (splits, chunk) == want
    assert 1 <= splits <= MAX_SPLITS and chunk % PLAN_ROUND == 0
    assert PLAN_ROUND == 4 * 16
    assert (splits - 1) * chunk < S <= splits * chunk
    # the same shapes give the same plan on every call
    assert decode_plan(B, H, KV, S, D, sms) == (splits, chunk)


def test_decode_design():
    """mma.sync for 16-bit queries at D 64 and 128; FMA for fp32 and D 32."""
    assert decode_design(torch.bfloat16, 64) == "mma"
    assert decode_design(torch.float16, 128) == "mma"
    assert decode_design(torch.float32, 64) == "fma"
    assert decode_design(torch.bfloat16, 32) == "fma"


def _bf16(x):
    return x.to(torch.bfloat16).float()


def split_merge_emulation(q, k, v, lengths, scale, slopes, ks, vs, plan,
                          rounded=_bf16):
    """The CUDA kernel's arithmetic in plain fp32 torch: q (B, H, D), caches
    (B, KV, S, D) (int8 values with fp32 scales ks/vs, or ks = vs = None).
    Each of ``plan``'s chunks is walked as 16-position groups dealt to 4
    warps in turn; each warp keeps (m, l, acc) by online softmax over its
    groups, p (times the V scale) passed through ``rounded`` before the PV
    product; the warps merge, then the chunks, in order. Returns (B, H, D)
    passed through ``rounded``."""
    splits, chunk = plan
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    s_all = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * scale
    if ks is not None:
        s_all = s_all * ks.repeat_interleave(rep, 1)
    pos = torch.arange(S)
    length = lengths.long()[:, None, None]
    if slopes is not None:
        s_all = s_all + slopes[None, :, None] * (pos - (length - 1))
    live = pos[None, None, :] < length                        # (B, 1, S)
    vsc = (vs.repeat_interleave(rep, 1) if vs is not None
           else torch.ones(B, H, S))

    def merge(states):
        m = torch.stack([st[0] for st in states]).amax(0)
        l = sum(st[1] * torch.exp(st[0] - m) for st in states)
        acc = sum(st[2] * torch.exp(st[0] - m)[..., None] for st in states)
        return m, l, acc

    empty = (torch.full((B, H), -1e30), torch.zeros(B, H),
             torch.zeros(B, H, D))
    chunks = []
    for c in range(splits):
        warps = []
        for w in range(4):
            m, l, acc = empty
            for g0 in range(c * chunk + 16 * w, (c + 1) * chunk, 64):
                sl = slice(g0, min(g0 + 16, S))
                if g0 >= S:
                    break
                x = s_all[..., sl].masked_fill(~live[..., sl], -1e30)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[..., None]) * live[..., sl]
                l = l * alpha + p.sum(-1)
                pv = rounded(p * vsc[..., sl])
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhs,bhsd->bhd", pv, vf[:, :, sl])
                m = m_new
            warps.append((m, l, acc))
        chunks.append(merge(warps))
    m, l, acc = merge(chunks)
    return rounded(acc / l.clamp_min(1e-30)[..., None])


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
def test_split_merge_matches_jax_kernel(cache, alibi):
    """The kernel's split and merge over decode_plan's chunks (8 chunks of
    64 here) against the JAX kernel, at lengths 0, 1, a chunk edge, one past
    it, and S."""
    B, H, KV, S, D = 5, 4, 2, 512, 32
    plan = decode_plan(B, H, KV, S, D, 132)
    assert plan == (8, 64)
    chunk = plan[1]
    rng = np.random.default_rng(7 + alibi)
    q, *kv = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
              for shape in ((B, H, D), (B, KV, S, D), (B, KV, S, D)))
    lengths = torch.tensor([0, 1, chunk, chunk + 1, S], dtype=torch.int32)
    slopes = alibi_slopes(H) if alibi else None
    scale = 1.0 / np.sqrt(D)
    ks = vs = None
    rounded, atol, jdt, tdt = _bf16, 3e-2, jnp.bfloat16, torch.bfloat16
    if cache == "fp32":
        k, v = kv
        rounded, atol, jdt, tdt = (lambda x: x), ATOL, jnp.float32, \
            torch.float32
    elif cache == "int8":
        (k, ks), (v, vs) = (quantize_kv_rows(x) for x in kv)
    else:
        k, v = (_bf16(x) for x in kv)
    q = rounded(q)
    kj, vj = (jnp.asarray(x.numpy().transpose(0, 1, 3, 2)) for x in (k, v))
    if cache != "int8":
        kj, vj = kj.astype(jdt), vj.astype(jdt)
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                        v_scale=jnp.asarray(vs.numpy()))
    want = np.asarray(jax.jit(lambda *a: jax_decode(
        *a, alibi_slopes=None if slopes is None else jnp.asarray(
            slopes.numpy()), block_s=64, **scales))(
        jnp.asarray(q.numpy()).astype(jdt), kj, vj,
        jnp.asarray(lengths.numpy())).astype(jnp.float32))
    got = split_merge_emulation(q, k, v, lengths, scale, slopes, ks, vs,
                                plan, rounded)
    assert (got[0] == 0).all() and np.all(want[0] == 0)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    # the port's plain version (it rounds nothing but its output) as well
    cast = (lambda x: x) if cache == "int8" else (lambda x: x.to(tdt))
    plain = decode_attention(q.to(tdt), cast(k), cast(v), lengths,
                             alibi_slopes=slopes, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(plain.float().numpy(), got.numpy(),
                               atol=atol, rtol=0)
