"""The port's activation checkpointing (``deepspeed_tpu_torch/runtime/
activation_checkpointing/checkpointing.py``) against the JAX module.

* ``checkpoint`` (non-reentrant, and the reference's own function, which
  ``cpu_checkpointing`` takes on one rank) and ``checkpoint_sequential``
  in two segments: value and gradients equal the JAX module's on the same
  function and inputs (fp32, 1e-5);
* ``partition_activations`` over a model group of two gloo ranks: the
  checkpoint keeps half its input's bytes, its backward issues one
  all-gather, and its gradients equal the uncheckpointed function's;
* the JSON block configures the same fields as the JAX ``configure``, and
  an engine built with ``partition_activations: true`` configures the
  module rather than ignoring it;
* the RNG tracker takes the JAX calls (``model_parallel_manual_seed``,
  ``get_rng_tracker().fork()``, ``get_cuda_rng_tracker``,
  ``fold_in_model_parallel_rank``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jckpt
from deepspeed_tpu_torch.parallel import mesh as PM
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt

from _torch_dist import Squares, start
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _reset_config():
    ckpt.reset()
    jckpt.reset()
    yield
    ckpt.reset()
    jckpt.reset()


@pytest.fixture(scope="module", autouse=True)
def two_ranks(tmp_path_factory):
    """Started with the module, before the JAX side runs."""
    return start("act_ckpt", 2, tmp_path_factory.mktemp("act"), timeout=120)


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 16)).astype(np.float32) / 4
    x = rng.normal(size=(8, 16)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("mode", ["plain", "partition", "cpu"])
def test_checkpoint_gradients_equal_the_jax_module(mode):
    """``partition`` at one rank keeps the input whole (the JAX
    ``partition`` is a no-op without a model axis); ``cpu`` runs the
    reference's function, its input kept in host memory."""
    kw = {"plain": {}, "partition": dict(partition_activations=True),
          "cpu": dict(checkpoint_in_cpu=True)}[mode]
    ckpt.configure(**kw)
    jckpt.configure(partition_activations=kw.get("partition_activations"))
    w, x = _inputs()
    jw = jnp.asarray(w)

    def jf(a):
        h = jnp.tanh(a @ jw)
        return jnp.sum(h * h)

    jval, jgrad = jax.value_and_grad(lambda a: jckpt.checkpoint(jf, a))(x)
    tw = torch.nn.Parameter(torch.from_numpy(w))

    def tf(a):
        h = torch.tanh(a @ tw)
        return (h * h).sum()

    tx = torch.from_numpy(x).requires_grad_()
    val = ckpt.checkpoint(tf, tx)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)
    # w's gradient, against JAX's derivative in w
    jwgrad = jax.grad(lambda v: jnp.sum(jnp.tanh(x @ v) ** 2))(jw)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jwgrad),
                               rtol=1e-5, atol=1e-6)


def test_checkpoint_sequential_segments_equal_the_jax_module():
    ckpt.configure(num_checkpoints=2)
    jckpt.configure(num_checkpoints=2)
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=(8, 8)).astype(np.float32) / 3 for _ in range(5)]
    x = rng.normal(size=(4, 8)).astype(np.float32)
    jlayers = [lambda h, w=jnp.asarray(w): jnp.tanh(h @ w) for w in ws]
    jval, jgrad = jax.value_and_grad(
        lambda h: jnp.sum(jckpt.checkpoint_sequential(jlayers, h)))(x)
    tws = [torch.nn.Parameter(torch.from_numpy(w)) for w in ws]
    layers = [lambda h, w=w: torch.tanh(h @ w) for w in tws]
    tx = torch.from_numpy(x).requires_grad_()
    val = ckpt.checkpoint_sequential(layers, tx).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-5)
    assert all(w.grad is not None for w in tws)


def test_partitioned_input_halves_at_two_model_ranks(two_ranks):
    for r in two_ranks.join():
        assert r["kept"] * 2 == r["whole"], r
        assert r["ops"] == {"all_gather_into_tensor": 1}, r["ops"]
        assert r["grad_err"] <= 1e-5, r


def test_json_block_configures_what_jax_configures():
    block = {"train_batch_size": 1, "activation_checkpointing": {
        "partition_activations": True, "cpu_checkpointing": False,
        "number_checkpoints": 2, "synchronize_checkpoint_boundary": True}}
    ckpt.configure(deepspeed_config=block)
    jckpt.configure(deepspeed_config=block)
    for field in ("partition_activations", "contiguous_memory_optimization",
                  "cpu_checkpointing", "num_checkpoints", "synchronize",
                  "profile", "configured"):
        assert getattr(ckpt._CONFIG, field) == \
            getattr(jckpt._CONFIG, field), field
    assert ckpt.partition(torch.ones(6, 4)).shape == (6, 4)


def test_engine_reads_the_activation_checkpointing_block():
    """An engine with ``partition_activations: true`` configures the
    module (the JAX engine's rule); a later engine with the default block
    leaves an explicit configuration as it is."""
    PM.reset_mesh()
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
              "activation_checkpointing": {"partition_activations": True,
                                           "number_checkpoints": 3}}
    assert not ckpt.is_configured()
    dst.initialize(model=Squares(), config=config, device="cpu")
    assert ckpt.is_configured() and ckpt._CONFIG.partition_activations
    assert ckpt._CONFIG.num_checkpoints == 3
    dst.initialize(model=Squares(), device="cpu",
                   config={k: v for k, v in config.items()
                           if k != "activation_checkpointing"})
    assert ckpt._CONFIG.partition_activations
    PM.reset_mesh()


def test_rng_tracker_takes_the_jax_calls():
    ckpt.model_parallel_manual_seed(1234, mp_rank=0)
    tracker = ckpt.get_rng_tracker()
    assert ckpt.get_cuda_rng_tracker() is tracker
    with tracker.fork() as g1:
        a = torch.rand(4, generator=g1)
    with tracker.fork() as g2:
        b = torch.rand(4, generator=g2)
    assert not torch.equal(a, b)
    ckpt.model_parallel_cuda_manual_seed(1234, mp_rank=1)
    with ckpt.get_rng_tracker().fork() as g3:
        c = torch.rand(4, generator=g3)
    assert not torch.equal(a, c)
    ckpt.model_parallel_manual_seed(1234, mp_rank=0)
    with ckpt.get_rng_tracker().fork() as g4:
        assert torch.equal(torch.rand(4, generator=g4), a)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("model-parallel-rng", 1)
    with pytest.raises(Exception, match="not added"):
        with tracker.fork("missing"):
            pass
    # no model group above one rank: the seed as it is (JAX: the key)
    assert ckpt.fold_in_model_parallel_rank(7) == 7
    assert ckpt.checkpoint_name(a, ckpt.OFFLOAD_NAME) is a
