"""The port's GPT2LMHeadModel against the JAX package's, on the same weights.

Weights come from the JAX module's init and cross through the weight bridge
(``checkpoint.flax_import.gpt2_state_dict_from_flax``); so do the JAX
gradients, which puts both sides' gradients in the port's layout. The JAX
side is ``jax.value_and_grad`` of its model: the plain attention arm, and
with ``fused_ln_linear=True`` its Pallas ln_linear kernels in interpret
mode. The port runs on the CPU, every kernel wrapper through its plain
version, with each combination of the flash arm, the fused ln_linear arm
and the remat policies.

Everything is fp32 at vocab 128, n_embd 128, 2 layers, 4 heads, T = 64,
B = 2. The loss agrees within 1e-5 relative and each gradient within 1e-4
of its largest element: summation order only (blockwise softmax against one
softmax, the fused kernel's sums against XLA's), compounded over two
layers.

With ``sparse_attention`` (a BigBird unidirectional layout, block 128, one
layout per head, T = 512, so that every head skips blocks) the port takes
its block-sparse kernel operator (the plain versions on the CPU) and the
JAX model its gather formulation (its route off a TPU): width 64, 2 heads,
``n_positions`` 2048 (above GPT-2's 1024, through the same bridge), at the
same tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as J
from deepspeed_tpu.ops.sparse_attention import sparsity_config as J_SPARSE
from deepspeed_tpu_torch.checkpoint.flax_import import \
    gpt2_state_dict_from_flax
from deepspeed_tpu_torch.models import gpt2 as P
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparsity_config as P_SPARSE

from _torch_threads import one_thread  # noqa: F401


LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TINY = dict(vocab_size=128, n_positions=64, n_embd=128, n_layer=2, n_head=4)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 64)).astype(np.int32)
    labels = ids.copy()
    labels[0, 10:20] = -100     # ignored positions
    return {"input_ids": ids, "labels": labels}


@pytest.fixture(scope="module")
def jax_side():
    """(params as numpy, {fused: (loss, grads as numpy)})."""
    batch = _batch()
    cfg = J.GPT2Config(**TINY, dtype=jnp.float32, use_flash_attention=False)
    params = J.GPT2LMHeadModel(cfg).init(
        {"params": jax.random.PRNGKey(0)}, batch)["params"]
    out = {}
    for fused in (False, True):
        model = J.GPT2LMHeadModel(J.GPT2Config(
            **TINY, dtype=jnp.float32, use_flash_attention=False,
            fused_ln_linear=fused))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.apply({"params": p}, batch,
                                  deterministic=True)))(params)
        out[fused] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return jax.tree_util.tree_map(np.asarray, params), out


def _port(params, **overrides):
    cfg = P.GPT2Config(**TINY, dtype=torch.float32, **overrides)
    model = P.GPT2LMHeadModel(cfg)
    model.load_state_dict(gpt2_state_dict_from_flax(cfg, params))
    return model


def _loss_and_grads(model, batch):
    loss = model(batch)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


def test_bridge_covers_every_parameter(jax_side):
    params, _ = jax_side
    model = _port(params)
    sd = gpt2_state_dict_from_flax(model.config, params)
    assert sorted(sd) == sorted(model.state_dict())
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        params["blocks"]["block"]["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["ln_f.weight"].numpy(),
                                  params["ln_f"]["scale"])


@pytest.mark.parametrize("flash,fused,remat,policy", [
    (False, False, False, "full"),
    (True, False, False, "full"),
    (True, True, False, "full"),
    (False, True, False, "full"),
    (True, False, True, "full"),
    (True, False, True, "dots"),
    (True, True, True, "dots"),
    (False, True, True, "dots_plain"),
])
def test_loss_and_grads_match_jax(jax_side, flash, fused, remat, policy):
    params, want = jax_side
    model = _port(params, use_flash_attention=flash, fused_ln_linear=fused,
                  remat=remat, remat_policy=policy)
    loss, grads = _loss_and_grads(model, _batch())
    jloss, jgrads = want[fused]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    jgrads = gpt2_state_dict_from_flax(model.config, jgrads)
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        ref = jgrads[key]
        err = (g - ref).abs().max().item() / ref.abs().max().item()
        assert err <= GRAD_TOL, f"{key}: {err}"


def test_remat_recomputes_the_forward_kernels_only_under_full(jax_side,
                                                              monkeypatch):
    """Counting the plain versions' calls (the kernels' stand-ins on the
    CPU): "dots" keeps the flash and ln_linear outputs, so each forward runs
    once per layer; "full" runs each again in the backward."""
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import ln_linear as ll

    params, _ = jax_side
    calls = {"flash": 0, "ln": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(fa, "mha_reference", counted(fa.mha_reference,
                                                     "flash"))
    monkeypatch.setattr(ll, "ln_linear_fwd_reference",
                        counted(ll.ln_linear_fwd_reference, "ln"))
    L = TINY["n_layer"]
    for policy, per_layer in (("dots", 1), ("full", 2), ("dots_plain", 2)):
        calls.update(flash=0, ln=0)
        model = _port(params, use_flash_attention=True, fused_ln_linear=True,
                      remat=True, remat_policy=policy)
        _loss_and_grads(model, _batch())
        assert calls == {"flash": per_layer * L, "ln": 2 * per_layer * L}, \
            (policy, calls)


def test_ignored_labels_drop_out_of_the_mean(jax_side):
    params, _ = jax_side
    model = _port(params)
    batch = _batch()
    with torch.no_grad():
        logits = model.logits(torch.as_tensor(batch["input_ids"]))[:, :-1]
        logp = torch.log_softmax(logits, -1)
        targets = torch.as_tensor(batch["labels"][:, 1:]).long()
        keep = targets >= 0
        nll = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
        want = nll[keep].mean().item()
        assert model(batch).item() == pytest.approx(want, rel=1e-6)
        all_ignored = dict(batch, labels=np.full_like(batch["labels"], -100))
        assert model(all_ignored).item() == 0.0


def test_unported_switches_raise():
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        P.GPT2Config(**TINY, sequence_parallel="ring")
    # the streaming loss is ported (tests/test_torch_chunked_xent.py)
    assert P.GPT2Config(**TINY, loss_chunk=64).loss_chunk == 64
    # sparse_attention is ported; the JAX model's refusal around it stays
    assert P.GPT2Config(**TINY, sparse_attention=_sparsity(P_SPARSE))
    with pytest.raises(ValueError, match="sequence_parallel"):
        P.GPT2Config(**TINY, sparse_attention=_sparsity(P_SPARSE),
                     sequence_parallel="ring")
    with pytest.raises(ValueError, match="dropout"):
        P.GPT2Config(**TINY, dropout=0.1, use_flash_attention=True)
    assert P.GPT2Config(**TINY, scan_unroll=4).scan_unroll == 4
    assert not P.GPT2Config(**TINY).fused      # "auto" resolves off


SPARSE_TINY = dict(vocab_size=128, n_positions=2048, n_embd=64, n_layer=2,
                   n_head=2)
SPARSE_T = 512


def _sparsity(module, block=128):
    return module.BigBirdSparsityConfig(
        num_heads=2, block=block, different_layout_per_head=True,
        num_random_blocks=1, num_sliding_window_blocks=1,
        num_global_blocks=1, attention="unidirectional")


def _sparse_batch():
    rng = np.random.default_rng(1)
    return {"input_ids": rng.integers(0, 128, (1, SPARSE_T)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_sparse_side():
    """(params, loss, grads) of the JAX model with the BigBird layout, as
    numpy; its attention takes the gather formulation on the CPU."""
    batch = _sparse_batch()
    model = J.GPT2LMHeadModel(J.GPT2Config(
        **SPARSE_TINY, dtype=jnp.float32,
        sparse_attention=_sparsity(J_SPARSE)))
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(1)},
                                 batch)["params"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch, deterministic=True)))(
            params)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return as_np(params), float(loss), as_np(grads)


def _sparse_port(params, **overrides):
    cfg = P.GPT2Config(**SPARSE_TINY, dtype=torch.float32,
                       sparse_attention=_sparsity(P_SPARSE), **overrides)
    model = P.GPT2LMHeadModel(cfg)
    model.load_state_dict(gpt2_state_dict_from_flax(cfg, params))
    return model


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_sparse_loss_and_grads_match_jax(jax_sparse_side, remat, policy):
    params, jloss, jgrads = jax_sparse_side
    assert params["wpe"]["embedding"].shape == (2048, 64)
    layout = _sparsity(P_SPARSE).make_layout(SPARSE_T)
    assert (layout == 0).sum() > (layout.size - layout[0].size) // 2
    model = _sparse_port(params, remat=remat, remat_policy=policy)
    loss, grads = _loss_and_grads(model, _sparse_batch())
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    jgrads = gpt2_state_dict_from_flax(model.config, jgrads)
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        ref = jgrads[key]
        err = (g - ref).abs().max().item() / ref.abs().max().item()
        assert err <= GRAD_TOL, f"{key}: {err}"


def test_sparse_remat_recomputes_the_forward_kernel_only_under_full(
        jax_sparse_side, monkeypatch):
    """The block-sparse forward's plain version (the kernel's stand-in on
    the CPU) runs once per layer under "dots", which keeps the operator's
    outputs, and twice under "full" and "dots_plain"; no flash forward
    runs beside it."""
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bk

    calls = {"sparse": 0, "flash": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(bk, "block_sparse_fwd_reference",
                        counted(bk.block_sparse_fwd_reference, "sparse"))
    monkeypatch.setattr(fa, "mha_reference",
                        counted(fa.mha_reference, "flash"))
    params = jax_sparse_side[0]
    L = SPARSE_TINY["n_layer"]
    for policy, per_layer in (("dots", 1), ("full", 2), ("dots_plain", 2)):
        calls.update(sparse=0, flash=0)
        model = _sparse_port(params, remat=True, remat_policy=policy,
                             use_flash_attention=True)
        _loss_and_grads(model, _sparse_batch())
        assert calls == {"sparse": per_layer * L, "flash": 0}, \
            (policy, calls)


def test_sparse_fine_granule_takes_the_gather_route(jax_sparse_side,
                                                    monkeypatch):
    """A granule under 128 fails ``supports_pallas``: the gather
    formulation runs (no kernel operator), and its loss is the same
    function's; dropout in training is refused as in the JAX model."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bk

    def refuse(*args, **kwargs):
        raise AssertionError("kernel operator on a fine granule")

    monkeypatch.setattr(bk, "block_sparse_fwd_reference", refuse)
    params = jax_sparse_side[0]
    coarse = _sparse_port(params)
    cfg = coarse.replace_config(sparse_attention=_sparsity(P_SPARSE, 64))
    layout = cfg.sparse_attention.make_layout(SPARSE_T)
    assert layout.shape == (2, 8, 8)
    with torch.no_grad():
        loss = coarse(_sparse_batch()).item()
    assert np.isfinite(loss)
    coarse.replace_config(dropout=0.1)
    with pytest.raises(ValueError, match="dropout"):
        coarse(_sparse_batch(), deterministic=False)
