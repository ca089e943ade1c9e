"""The port's flash-attention forward against the JAX package's.

The JAX side runs its Pallas kernel (interpret mode on the CPU); the port's
wrapper takes its plain version because the tensors lie on the CPU. Inputs
come from numpy with a seed. Both sides compute in fp32, so the tolerance
(2e-5 absolute on unit-scale outputs) covers only summation order: the
Pallas kernel's blockwise online softmax against one full softmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention.flash_attention import \
    flash_attention as jax_flash
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    block_rows, design_code, flash_attention, flash_design, mha_reference)

from _torch_threads import one_thread  # noqa: F401


ATOL = 2e-5


def _inputs(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


def _jax_lse(q, k, causal):
    """logsumexp over keys of the JAX-side scores, (B, H, T)."""
    s = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(q.shape[-1])
    if causal:
        T, S = q.shape[1], k.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((T, S), bool))[None, None], s, -1e30)
    return np.asarray(jnp.log(jnp.sum(jnp.exp(s - s.max(-1, keepdims=True)),
                                      -1)) + s.max(-1))


@pytest.mark.parametrize("causal,T,S", [(True, 96, 96), (True, 40, 40),
                                        (False, 48, 80)])
def test_out_and_lse_match_jax(causal, T, S):
    q, k, v = _inputs(0, 2, T, S, 2, 2, 32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal),
                               atol=ATOL, rtol=0)
    assert flash_attention.launches == 0  # CPU tensors launch nothing


def test_gqa_maps_heads_like_repeat():
    """KV heads shared by H/KV query heads each equal the JAX package's
    ``jnp.repeat`` of K/V along heads (transformer_lm.py:530-532)."""
    q, k, v = _inputs(1, 1, 24, 24, 4, 2, 32)
    want = np.asarray(jax_flash(jnp.asarray(q),
                                jnp.repeat(jnp.asarray(k), 2, axis=2),
                                jnp.repeat(jnp.asarray(v), 2, axis=2)))
    out, _ = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)


def test_reference_keeps_input_dtype_and_rejects_misaligned_causal():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(2, 1, 16, 16, 2, 2, 32))
    out, lse = mha_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.isfinite(lse).all()
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        flash_attention(q, k[:, :8], v[:, :8], causal=True)


def test_flash_design_by_dtype_and_head_dim():
    """The forward, dq and dk/dv kernels run on the tensor cores (wgmma) for
    bf16 and fp16 at D = 64 and 128, and on the FMA units for fp32 and for
    D = 32; every supported pair names one of the two."""
    for dtype in (torch.bfloat16, torch.float16):
        for D in (64, 128):
            assert flash_design(dtype, D) == "wgmma"
        assert flash_design(dtype, 32) == "fma"
    for D in (32, 64, 128):
        assert flash_design(torch.float32, D) == "fma"


def test_block_rows_by_grid_and_head_dim():
    """The wgmma design's block size on a 132-SM card: 64-row blocks where
    128-row ones would leave SMs idle (the serving prefill, B=1 H=12 T=1024:
    96 tiles) and at D = 128; 128-row blocks once the grid covers the card
    (the training shape, 10 x 16 x 8 tiles; the dense arm at T=8192)."""
    assert block_rows(64, 1 * 12 * 8, 132) == 64
    assert block_rows(64, 131, 132) == 64
    assert block_rows(64, 132, 132) == 128
    assert block_rows(64, 10 * 16 * 8, 132) == 128
    assert block_rows(64, 1 * 12 * 64, 132) == 128
    for tiles in (1, 96, 1280):
        assert block_rows(128, tiles, 132) == 64


@pytest.mark.parametrize("dtype,D,heads,rows,code", [
    # dq and the forward over B x H query rows: the training shape (10 x 16
    # heads, T=1024) takes 128-row blocks, the serving prefill (12 heads)
    # 64-row ones, D=128 64-row ones, fp32 and D=32 the FMA design
    (torch.bfloat16, 64, 160, 1024, 1), (torch.float16, 64, 12, 1024, 2),
    (torch.bfloat16, 128, 160, 1024, 2), (torch.float32, 64, 160, 1024, 0),
    (torch.bfloat16, 32, 160, 1024, 0),
    # dk/dv over B x KV key rows, the dense arm at T=8192 (12 heads)
    (torch.bfloat16, 64, 12, 8192, 1)])
def test_design_code_names_each_kernels_design(dtype, D, heads, rows, code):
    """The C entry points' design argument, which the forward, dq and dkv
    wrappers pass: 0 FMA, 1 wgmma with 128-row blocks, 2 with 64-row
    blocks, on a 132-SM card."""
    assert design_code(dtype, D, heads, rows, 132) == code
    assert (code == 0) == (flash_design(dtype, D) == "fma")
