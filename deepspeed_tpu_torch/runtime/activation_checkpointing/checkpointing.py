"""Activation checkpointing: the port of ``deepspeed_tpu/runtime/
activation_checkpointing/checkpointing.py`` (the reference's Megatron-derived
``checkpointing.py``: ``checkpoint()`` :708, ``configure()`` :789, activation
partitioning over the model-parallel ranks :366 and its gather in backward
:255, CPU checkpointing :461, ``num_checkpoints`` segments, the RNG tracker
:121, :198).

* :func:`checkpoint` runs ``function(*args)`` without keeping its
  intermediate activations and recomputes them in the backward. By default
  it is non-reentrant ``torch.utils.checkpoint``. With
  ``partition_activations`` over a model group above one rank, or with
  ``cpu_checkpointing``, it is the reference's own function: the saved
  inputs are kept as this rank's 1/M slice of their leading dimension
  (where M divides it; the JAX package constrains the same dimension's
  sharding over the ``model`` axis) and all-gathered over the model group
  in the backward, or kept in host memory and copied back; the body is
  recomputed under the forward's RNG state and differentiated, and the
  parameters inside it take their gradients as the body's backward runs.
  The gradients equal the uncheckpointed graph's.
* :func:`checkpoint_sequential` checkpoints contiguous segments of a layer
  list (``num_checkpoints`` of them: only the segment boundaries stay
  live).
* The RNG tracker (:func:`get_rng_tracker`,
  :func:`model_parallel_manual_seed`) keeps named ``torch.Generator``
  streams; ``fork`` yields a generator of its own each time, as the JAX
  tracker yields a split key, and :func:`fold_in_model_parallel_rank`
  gives each model rank a seed of its own (the attention's dropout under
  tensor parallelism draws from such a seed,
  ``module_inject.mappings.model_parallel_generator``).

The engine configures this module from the config's
``activation_checkpointing`` block as the JAX engine does, so
``partition_activations: true`` is read, not ignored.
``contiguous_memory_optimization`` and ``profile`` are recorded (the JAX
module records them too); ``synchronize_checkpoint_boundary`` synchronizes
the device before and after a checkpointed call on a card.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ... import comm
from ...module_inject.mappings import fold_in_rank, group_rank, group_size
from ...parallel.mesh import MODEL_AXIS
from ...utils.logging import log_dist

# the tag of activations eligible for host offload under
# ``cpu_checkpointing`` (the JAX name; :func:`checkpoint_name` is identity)
OFFLOAD_NAME = "ds_activation"

MODEL_PARALLEL_AXIS = MODEL_AXIS


class _CheckpointConfig:
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    num_checkpoints: Optional[int] = None
    synchronize: bool = False
    profile: bool = False
    configured: bool = False


_CONFIG = _CheckpointConfig()


def configure(mpu_=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """Configure from a config (a dict, a JSON path or a
    ``DeepSpeedConfig``) and/or keyword overrides (≅ reference
    checkpointing.py:789). ``mpu_`` is accepted for the signature; the
    model group comes from the global mesh."""
    acc = None
    if deepspeed_config is not None:
        from ..config import DeepSpeedConfig

        if isinstance(deepspeed_config, (str, dict)):
            deepspeed_config = DeepSpeedConfig.load(deepspeed_config,
                                                    world_size=1)
        acc = deepspeed_config.activation_checkpointing

    def pick(override, from_cfg, default):
        if override is not None:
            return override
        return from_cfg if acc is not None else default

    _CONFIG.partition_activations = pick(
        partition_activations, acc and acc.partition_activations, False)
    _CONFIG.contiguous_memory_optimization = pick(
        contiguous_checkpointing,
        acc and acc.contiguous_memory_optimization, False)
    _CONFIG.cpu_checkpointing = pick(
        checkpoint_in_cpu, acc and acc.cpu_checkpointing, False)
    _CONFIG.num_checkpoints = pick(
        num_checkpoints, acc.number_checkpoints if acc else None, None)
    _CONFIG.synchronize = pick(
        synchronize, acc and acc.synchronize_checkpoint_boundary, False)
    _CONFIG.profile = pick(profile, acc and acc.profile, False)
    _CONFIG.configured = True
    log_dist(f"Activation checkpointing configured: partition_activations="
             f"{_CONFIG.partition_activations} cpu_checkpointing="
             f"{_CONFIG.cpu_checkpointing} num_checkpoints="
             f"{_CONFIG.num_checkpoints}", ranks=[0])


def is_configured() -> bool:
    return _CONFIG.configured


def reset() -> None:
    _CONFIG.__dict__.clear()


# ---------------------------------------------------------------------------
# partitioned and host-kept inputs
# ---------------------------------------------------------------------------
def _partitions(x) -> int:
    """The model group's size when ``x``'s leading dimension splits over it
    (the JAX ``partition`` condition), else 1."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or \
            x.dim() == 0:
        return 1
    m = group_size(MODEL_AXIS)
    return m if m > 1 and x.shape[0] % m == 0 else 1


def partition(x: torch.Tensor) -> torch.Tensor:
    """This rank's 1/M slice of ``x``'s leading dimension (a copy), as a
    partitioned checkpoint keeps a saved input; ``x`` itself without a
    model group above one rank or where M does not divide that dimension
    (≅ reference checkpointing.py:366)."""
    m = _partitions(x)
    if m == 1:
        return x
    k = x.shape[0] // m
    return x.narrow(0, group_rank(MODEL_AXIS) * k, k).clone()


def gather_partitioned(part: torch.Tensor) -> torch.Tensor:
    """The whole tensor from every model rank's :func:`partition`
    (collective over the model group; ≅ reference checkpointing.py:255)."""
    return comm.all_gather_into_tensor(part.contiguous(), group=MODEL_AXIS,
                                       axis=0)


def _sync(args) -> None:
    if _CONFIG.synchronize:
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)
                    and a.is_cuda), None)
        if dev is not None:
            torch.cuda.synchronize(dev)


class _CheckpointFunction(torch.autograd.Function):
    """The reference's checkpoint function: the inputs saved partitioned
    or on the host, the body recomputed and differentiated in the
    backward."""

    @staticmethod
    def forward(ctx, function, *args):
        ctx.function = function
        ctx.cuda = [a.device for a in args
                    if isinstance(a, torch.Tensor) and a.is_cuda][:1]
        ctx.cpu_rng = torch.get_rng_state()
        ctx.cuda_rng = torch.cuda.get_rng_state(ctx.cuda[0]) \
            if ctx.cuda else None
        with torch.no_grad():
            out = function(*args)
        stored, ctx.layout = [], []
        for a in args:
            if not isinstance(a, torch.Tensor):
                ctx.layout.append(("value", a))
                continue
            m = _partitions(a) if _CONFIG.partition_activations else 1
            keep = partition(a) if m > 1 else a
            host = _CONFIG.cpu_checkpointing and keep.device.type != "cpu"
            if host:
                keep = keep.to("cpu")
            ctx.layout.append(("tensor", (m, a.device if host else None,
                                          a.requires_grad)))
            stored.append(keep)
        ctx.save_for_backward(*stored)
        return out

    @staticmethod
    def backward(ctx, *grads):
        stored = iter(ctx.saved_tensors)
        inputs = []
        for kind, info in ctx.layout:
            if kind == "value":
                inputs.append(info)
                continue
            m, device, req = info
            t = next(stored)
            if device is not None:
                t = t.to(device)
            if m > 1:
                t = gather_partitioned(t)
            inputs.append(t.detach().requires_grad_(req))
        devices = ctx.cuda
        with torch.random.fork_rng(devices=devices):
            torch.set_rng_state(ctx.cpu_rng)
            if devices:
                torch.cuda.set_rng_state(ctx.cuda_rng, devices[0])
            with torch.enable_grad():
                out = ctx.function(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None,) + tuple(
            t.grad if isinstance(t, torch.Tensor) else None for t in inputs)


def checkpoint(function: Callable, *args) -> Any:
    """Checkpoint ``function(*args)`` (≅ reference checkpointing.py:708;
    module docstring): nothing inside the body is kept, the inputs are
    (partitioned over the model group or on the host when configured),
    and the body is recomputed in the backward."""
    _sync(args)
    special = (_CONFIG.partition_activations and
               any(_partitions(a) > 1 for a in args)) or \
        _CONFIG.cpu_checkpointing
    if special and torch.is_grad_enabled():
        out = _CheckpointFunction.apply(function, *args)
    else:
        out = _torch_checkpoint(function, *args, use_reentrant=False)
    _sync(args)
    return out


def checkpoint_wrapper(function: Callable) -> Callable:
    """Decorator form: ``function`` checkpointed with the configured
    policy."""

    def wrapped(*args):
        return checkpoint(function, *args)

    return wrapped


def checkpoint_name(x, name: str):
    """The JAX tag of an activation for the offload policy: identity (the
    port keeps a checkpoint's inputs on the host under
    ``cpu_checkpointing``, not tagged activations)."""
    return x


def checkpoint_sequential(layers: Sequence[Callable], x: Any,
                          num_checkpoints: Optional[int] = None) -> Any:
    """Run ``layers`` in order, checkpointed in ``num_checkpoints``
    contiguous segments (default: the configured ``num_checkpoints``, else
    one a layer), sizes as equal as possible, the first segments one
    longer."""
    if not layers:
        return x
    n = len(layers)
    k = num_checkpoints if num_checkpoints is not None \
        else _CONFIG.num_checkpoints
    if not k or k <= 0 or k > n:
        k = n
    base, rem = divmod(n, k)
    out, idx = x, 0
    for seg in range(k):
        size = base + (1 if seg < rem else 0)

        def run_segment(h, _layers=tuple(layers[idx:idx + size])):
            for layer in _layers:
                h = layer(h)
            return h

        idx += size
        out = checkpoint(run_segment, out)
    return out


# ---------------------------------------------------------------------------
# RNG tracker (reference checkpointing.py:121 CudaRNGStatesTracker, :198)
# ---------------------------------------------------------------------------
_MODEL_PARALLEL_RNG = "model-parallel-rng"


def fold_in_model_parallel_rank(seed: int,
                                axis_name: str = MODEL_PARALLEL_AXIS) -> int:
    """A dropout seed of this model rank's own from ``seed`` (the JAX
    function folds the rank into a key inside a mapped body); ``seed``
    unchanged outside a model group above one rank."""
    if group_size(axis_name) == 1:
        return int(seed)
    return fold_in_rank(seed, group_rank(axis_name))


class RNGStatesTracker:
    """Named generator streams (≅ CudaRNGStatesTracker,
    checkpointing.py:121): ``add`` seeds a stream, ``fork`` yields a
    ``torch.Generator`` of its own seeded from the stream, which advances
    (the JAX tracker yields a split key)."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_.clear()

    def get_states(self):
        return dict(self.states_)

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise Exception(f"RNG state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed))

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG, device=None):
        if name not in self.states_:
            raise Exception(f"RNG state {name} is not added")
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.states_[name]))
        kw = {} if device is None else {"device": device}
        yield torch.Generator(**kw).manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


# the reference's name (get_cuda_rng_tracker)
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_manual_seed(seed: int, mp_rank: int = 0) -> None:
    """Seed the model-parallel stream (≅ model_parallel_cuda_manual_seed,
    checkpointing.py:198): offset by the model rank, so the ranks' shards
    draw different dropout."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG, seed + 2718 + mp_rank)


model_parallel_cuda_manual_seed = model_parallel_manual_seed
