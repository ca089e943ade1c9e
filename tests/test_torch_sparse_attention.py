"""The port's block-sparse attention against the JAX package's, on the CPU.

Layouts and schedules must be equal. The block-sparse operator
(``dstorch::block_sparse_attention``, its plain versions on the CPU) is
held, forward and through autograd, against the JAX
``block_sparse_flash_attention`` and ``jax.grad`` of it, with the JAX Pallas
kernels in interpret mode as ``tests/unit/ops/test_sparse_pallas.py`` runs
them: fp32, block 128, H = 2, atol 1e-4 on outputs and 5e-4 on gradients
(that file's tolerances: summation order only). lse is held to 1e-4 as
well. A causal row whose live blocks all lie in its future is held against
the JAX gather formulation, which gives 0 there (the JAX Pallas kernel
gives the mean of v over the masked block; ``ROADMAP.md`` queue 3). The
gather formulation and ``SparseSelfAttention``'s routing are held against
the JAX module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import pallas_kernel as JK
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as JS
from deepspeed_tpu.ops.sparse_attention import sparsity_config as JC
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as K
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_self_attention as S
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as C

from _torch_threads import one_thread  # noqa: F401


BLOCK = 128
OUT_ATOL = 1e-4
GRAD_ATOL = 5e-4

# (class name, kwargs): every config class, per-head layouts and the
# options that change a layout
CONFIGS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed_uni_patterns": ("FixedSparsityConfig", dict(
        different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, attention="unidirectional",
        num_different_global_patterns=2)),
    "fixed_bi_horizontal": ("FixedSparsityConfig", dict(
        num_local_blocks=2, num_global_blocks=1,
        horizontal_global_attention=True)),
    "variable": ("VariableSparsityConfig", dict(
        different_layout_per_head=True, num_random_blocks=3,
        local_window_blocks=[2, 4], global_block_indices=[0, 5],
        global_block_end_indices=[2, 7], horizontal_global_attention=True)),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(
        different_layout_per_head=True, num_random_blocks=2,
        attention="unidirectional")),
    "bigbird_bi": ("BigBirdSparsityConfig", dict(num_random_blocks=1)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(
        global_block_indices=[0, 3], attention="unidirectional")),
    "sliding": ("LocalSlidingWindowSparsityConfig", dict(
        num_sliding_window_blocks=3, attention="bidirectional")),
}


def _pair(name, num_heads=4, block=16):
    cls, kwargs = CONFIGS[name]
    return (getattr(JC, cls)(num_heads=num_heads, block=block, **kwargs),
            getattr(C, cls)(num_heads=num_heads, block=block, **kwargs))


@pytest.mark.parametrize("T", [128, 320])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_match_jax(name, T):
    jcfg, cfg = _pair(name)
    want, got = jcfg.make_layout(T), cfg.make_layout(T)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _train_layout():
    """The training path's layout: BigBird, block 512, w3 r1 g1,
    unidirectional, 12 heads, T = 8192."""
    return C.BigBirdSparsityConfig(
        num_heads=12, block=512, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1,
        attention="unidirectional").make_layout(8192)


def _empty_row_layout():
    layout = np.zeros((2, 3, 4), np.int32)
    layout[0, 0, [1, 3]] = 1
    layout[0, 1, 2] = 1          # row 2 of head 0 empty
    layout[1, :, 0] = 1
    layout[1, 2, 3] = 1
    return layout


@pytest.mark.parametrize("layout_fn", [_train_layout, _empty_row_layout])
def test_schedules_match_jax(layout_fn):
    layout = layout_fn()
    for lay in (layout, layout.transpose(0, 2, 1)):
        for got, want in zip(K.layout_to_schedule(lay),
                             JK.layout_to_schedule(lay)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_train_layout_shape_and_cached_schedule():
    layout = _train_layout()
    assert int(layout[0].sum()) == 54
    idx, cnt, idx_t, cnt_t = K.schedule(layout, "cpu")
    assert idx.shape == (12, 16, 4) and idx_t.shape == (12, 16, 16)
    assert all(t.dtype == torch.int32 for t in (idx, cnt, idx_t, cnt_t))
    # built once per (layout, device): the same tensors come back
    again = K.schedule(layout.copy(), torch.device("cpu"))
    assert all(a is b for a, b in zip(again, (idx, cnt, idx_t, cnt_t)))
    # live (query, key) pairs after causal masking, 12 heads
    blocks = np.argwhere(layout)
    pairs = sum(512 * 512 if j < i else 512 * 513 // 2
                for _, i, j in blocks if j <= i)
    assert pairs == 144_752_640


def _local_global(H, nq):
    layout = np.zeros((H, nq, nq), np.int32)
    for i in range(nq):
        layout[:, i, i] = 1
        layout[:, i, max(i - 1, 0)] = 1
        layout[:, i, 0] = 1
    return layout


def _case(name):
    """(layout, causal) of each kernel case, at T = 256 (two blocks)."""
    layout = np.array([[[1, 0], [1, 1]]] * 2, np.int32)
    if name == "bidirectional_empty_row":
        layout[0, 1] = 0                # head 0: query block 1 attends nothing
        layout[1, 0, 1] = 1
    elif name == "per_head_above_diagonal":
        layout[0, 0, 1] = 1   # head 0: row 0 lists block 1, its future, beside 0
        layout[1] = np.eye(2, dtype=np.int32)    # head 1: diagonal only
    return layout, name != "bidirectional_empty_row"


def _inputs(T, seed, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, T, H, D)).astype(np.float32)
            for _ in range(4)]                 # q, k, v, output weights


def _port_out_lse_grads(q, k, v, w, layout, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    idx, cnt, idx_t, cnt_t = K.schedule(layout, "cpu")
    out, lse = K.SPARSE_OP(qt, kt, vt, idx, cnt, idx_t, cnt_t, BLOCK, causal,
                           1.0 / np.sqrt(q.shape[-1]))
    (out * torch.tensor(w)).sum().backward()
    return (out.detach().numpy(), lse.numpy(),
            [t.grad.numpy() for t in (qt, kt, vt)])


@pytest.mark.parametrize("name", ["causal", "bidirectional_empty_row",
                                  "per_head_above_diagonal"])
def test_operator_matches_jax_pallas(name):
    layout, causal = _case(name)
    T = 256
    q, k, v, w = _inputs(T, seed=len(name))
    out, lse, grads = _port_out_lse_grads(q, k, v, w, layout, causal)

    def loss(q, k, v):
        o = JK.block_sparse_flash_attention(q, k, v, layout, BLOCK,
                                            causal=causal)
        return jnp.sum(o * w), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    np.testing.assert_allclose(out, np.asarray(jout), atol=OUT_ATOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL)

    if name == "per_head_above_diagonal":
        return
    # lse against the JAX forward kernel's (bh, 8, T) rows
    H, D = q.shape[2], q.shape[3]
    idx, cnt = JK.layout_to_schedule(layout)
    bh = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(H, T, D))
          for x in (q, k, v)]
    _, jlse = JK._sparse_fwd(*bh, idx, cnt, scale=1.0 / np.sqrt(D),
                             causal=causal, block=BLOCK, num_heads=H)
    np.testing.assert_allclose(lse[0], np.asarray(jlse)[:, 0], atol=OUT_ATOL,
                               rtol=0)
    if name == "bidirectional_empty_row":
        assert (out[:, BLOCK:, 0] == 0).all()
        assert (lse[0, 0, BLOCK:] == np.float32(-1e30)).all()


def test_future_only_causal_row_matches_the_gather_formulation():
    """Query block 0 lists only block 1, which lies wholly in its future:
    no valid key, so out 0 and no gradient, as the JAX gather formulation
    gives (the port's rule for every row without a valid key)."""
    layout = np.array([[[0, 1], [1, 1]]] * 2, np.int32)
    q, k, v, w = _inputs(256, seed=7)
    out, lse, grads = _port_out_lse_grads(q, k, v, w, layout, True)

    def loss(q, k, v):
        o = JS.block_sparse_attention(q, k, v, layout, BLOCK, causal=True)
        return jnp.sum(o * w), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    np.testing.assert_allclose(out, np.asarray(jout), atol=OUT_ATOL)
    assert (out[:, :BLOCK] == 0).all() and (grads[0][:, :BLOCK] == 0).all()
    assert (lse[0, :, :BLOCK] == np.float32(-1e30)).all()
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the block-sparse forward's plain version (the kernel's
    stand-in on the CPU)."""
    calls = []
    ref = K.block_sparse_fwd_reference

    def wrapper(*args, **kwargs):
        calls.append(args[5])                      # block
        return ref(*args, **kwargs)

    monkeypatch.setattr(K, "block_sparse_fwd_reference", wrapper)
    return calls


def _module_pair(block, **kwargs):
    cfg_kwargs = dict(num_local_blocks=2, num_global_blocks=1,
                      attention="unidirectional")
    return (JS.SparseSelfAttention(JC.FixedSparsityConfig(
                num_heads=2, block=block, **cfg_kwargs), **kwargs),
            S.SparseSelfAttention(C.FixedSparsityConfig(
                num_heads=2, block=block, **cfg_kwargs), **kwargs))


@pytest.mark.parametrize("block,routed", [(128, [128]), (16, [])])
def test_module_auto_routes_as_jax(counted, block, routed):
    """auto: the kernel at block 128 (JAX: its Pallas kernel), the gather
    formulation at block 16."""
    jmod, mod = _module_pair(block)
    q, k, v, _ = _inputs(256, seed=block)
    got = mod(*(torch.tensor(x) for x in (q, k, v)))
    want = jax.jit(jmod)(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    assert counted == routed


@pytest.mark.parametrize("mode", ["add", "mul"])
def test_key_padding_mask_takes_the_gather_path(counted, mode):
    jmod, mod = _module_pair(128, key_padding_mask_mode=mode)
    q, k, v, _ = _inputs(256, seed=3)
    keep = np.ones((1, 256), bool)
    keep[0, 100:140] = keep[0, 200:] = False
    kpm = (np.where(keep, 0.0, -1e4) if mode == "add"
           else keep.astype(np.float32))
    got = mod(*(torch.tensor(x) for x in (q, k, v)),
              key_padding_mask=torch.tensor(kpm))
    want = jax.jit(jmod)(q, k, v, key_padding_mask=jnp.asarray(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)
    assert counted == []
    with pytest.raises(NotImplementedError, match="key_padding_mask"):
        S.SparseSelfAttention(mod.sparsity_config, kernel="pallas")(
            *(torch.tensor(x) for x in (q, k, v)),
            key_padding_mask=torch.tensor(kpm))


def test_refusals_match_jax():
    jmod, mod = _module_pair(16, kernel="pallas")
    q = np.zeros((1, 128, 2, 32), np.float32)
    with pytest.raises(ValueError, match="not supported"):
        jmod(q, q, q)
    with pytest.raises(ValueError, match="not supported"):
        mod(*(torch.tensor(q),) * 3)
    assert not K.supports_pallas(16, 128) and not JK.supports_pallas(16, 128)
    for args in ((128, 512), (64, 512), (128, 500), (256, 512)):
        assert K.supports_pallas(*args) == JK.supports_pallas(*args)
    t = torch.zeros(1, 256, 2, 32)
    with pytest.raises(ValueError, match="layout shape"):
        K.block_sparse_flash_attention(t, t, t, np.ones((2, 1, 1)), 128)
    with pytest.raises(ValueError, match="grouped-query"):
        K.block_sparse_flash_attention(t, t[:, :, :1], t[:, :, :1],
                                       np.ones((2, 2, 2)), 128)
    with pytest.raises(NotImplementedError, match="attn_mask"):
        mod(t, t, t, attn_mask=t)
    for bad in (dict(kernel="triton"), dict(key_padding_mask_mode="x"),
                dict(attn_mask_mode="x")):
        with pytest.raises(ValueError):
            S.SparseSelfAttention(**bad)


def test_cpu_tensors_never_reach_the_kernel_builder(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("op builder called for CPU tensors")

    for name in ("build", "load", "launch", "find_nvcc"):
        monkeypatch.setattr(op_builder, name, refuse)
    before = (K.block_sparse_fwd.launches, K.block_sparse_dq.launches,
              K.block_sparse_dkv.launches)
    q = torch.randn(1, 256, 2, 32, requires_grad=True)
    K.block_sparse_flash_attention(q, q, q, _local_global(2, 2), 128,
                                   causal=True).sum().backward()
    assert q.grad is not None
    assert (K.block_sparse_fwd.launches, K.block_sparse_dq.launches,
            K.block_sparse_dkv.launches) == before


@pytest.mark.parametrize("dtype,D,block,heads,T,sms,kernel,want", [
    # the training shape (B=1, H=12, T=8192, BigBird block 512): 768 tiles
    (torch.bfloat16, 64, 512, 12, 8192, 132, "dq", 1),
    (torch.float16, 64, 512, 12, 8192, 132, "dkv", 1),
    # fp32 and D = 32 keep the FMA kernels
    (torch.float32, 64, 512, 12, 8192, 132, "dq", 0),
    (torch.bfloat16, 32, 512, 12, 8192, 132, "dkv", 0),
    # a granule that is not a multiple of 128 cannot hold a 128-row block
    (torch.bfloat16, 64, 192, 12, 192 * 42, 132, "dq", 2),
    (torch.bfloat16, 64, 64, 12, 8192, 132, "dkv", 2),
    # 16 tiles of 128 rows leave a 132-SM card idle, not a 16-SM one
    (torch.bfloat16, 64, 128, 1, 2048, 132, "dq", 2),
    (torch.bfloat16, 64, 128, 1, 2048, 16, "dq", 1),
    # D = 128: dk/dv's 128-key blocks spill registers, dq's do not
    (torch.bfloat16, 128, 512, 12, 8192, 132, "dkv", 2),
    (torch.bfloat16, 128, 512, 12, 8192, 132, "dq", 1),
    # the forward takes dq's rule: 128-row blocks at the training shape
    (torch.bfloat16, 64, 512, 12, 8192, 132, "fwd", 1),
    (torch.float16, 128, 512, 12, 8192, 132, "fwd", 1),
    # fp32 and D = 32 keep the FMA forward
    (torch.float32, 64, 512, 12, 8192, 132, "fwd", 0),
    (torch.bfloat16, 32, 512, 12, 8192, 132, "fwd", 0),
    # a granule off 128, or a grid that leaves SMs idle: 64-row blocks
    (torch.bfloat16, 64, 192, 12, 192 * 42, 132, "fwd", 2),
    (torch.bfloat16, 64, 128, 1, 2048, 132, "fwd", 2),
])
def test_sparse_design_code(dtype, D, block, heads, T, sms, kernel, want):
    """The forward, dq and dk/dv entry points' design: 0 the FMA kernels,
    1 wgmma with 128-row blocks, 2 with 64-row blocks."""
    assert K.sparse_design(dtype, D) == ("fma" if want == 0 else "wgmma")
    assert K.sparse_design_code(dtype, D, block, heads, T, sms,
                                kernel) == want


def test_launch_order_longest_first_and_cached():
    """The wgmma dk/dv kernel starts its (head, layout column) pairs most
    live query blocks first, ties in order; the order is built once per
    schedule tensor."""
    cnt_t = torch.tensor([[1, 3, 3], [2, 0, 3]], dtype=torch.int32)
    order = K.launch_order(cnt_t)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 2, 5, 3, 0, 4]
    assert K.launch_order(cnt_t) is order
    # Fixed with horizontal globals: the global columns 3 and 7 come first
    layout = C.FixedSparsityConfig(
        num_heads=2, block=128, num_local_blocks=4, num_global_blocks=1,
        horizontal_global_attention=True).make_layout(8 * 128)
    _, _, _, cnt_t = K.schedule(layout, "cpu")
    assert K.launch_order(cnt_t)[:4].tolist() == [3, 7, 11, 15]
