"""ZeRO stages as sharding specs: the port of ``deepspeed_tpu/runtime/zero/
policy.py``.

The JAX package hands these specs to GSPMD; the port's engine reads them
to lay out each tensor over the ranks of the ZeRO group (the ``data``
axis of ``parallel.mesh``; under MiCS the shard group, replicated across
``data_outer``):

* stage 1 shards the fp32 master weights and the optimizer moments;
* stage 2 also the gradient accumulators;
* stage 3 also the compute parameters, except those at or below
  ``stage3_param_persistence_threshold`` elements, which stay whole
  (masters shard whatever their size).

A tensor shards along its largest dimension divisible by the ZeRO world
(``zero_shard_spec``, the JAX choice kept exactly); a tensor with no such
dimension stays whole on every rank. A spec is a tuple with one entry a
dimension, ``None`` or the axis name it shards over.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence, Tuple

from ...parallel.mesh import ZERO_AXES
from .config import DeepSpeedZeroConfig, ZeroStageEnum


class PartitionSpec(tuple):
    """Per-dimension mesh axes (the JAX ``PartitionSpec``'s entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _shape(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh.shape)


def _zero_world(mesh) -> int:
    dims = _shape(mesh)
    return int(math.prod(dims.get(a, 1) for a in ZERO_AXES))


def _used_axes(spec: Optional[Sequence]) -> set:
    used = set()
    if spec is None:
        return used
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def zero_shard_spec(shape: Sequence[int],
                    mesh,
                    stage_applies: bool,
                    tp_spec: Optional[Sequence] = None,
                    persistence_threshold: int = 0) -> PartitionSpec:
    """Compose a ZeRO-sharding spec for one tensor.

    Picks the largest dimension divisible by the ZeRO world size that TP has
    not claimed and shards it over ``("data", "expert", "seq")``. Tensors at
    or below ``persistence_threshold`` elements (or with no divisible dim)
    stay at their TP spec — the analog of ZeRO-3 persistent small params.
    """
    ndim = len(shape)
    base = list(tp_spec) if tp_spec is not None else []
    base += [None] * (ndim - len(base))

    if not stage_applies:
        return PartitionSpec(*base)

    size = math.prod(shape) if shape else 1
    if persistence_threshold and size <= persistence_threshold:
        return PartitionSpec(*base)

    zero_world = _zero_world(mesh)
    if zero_world == 1:
        return PartitionSpec(*base)

    taken = _used_axes(tp_spec)
    zero_axes = tuple(a for a in ZERO_AXES if a not in taken)
    if not zero_axes:
        return PartitionSpec(*base)
    dims = _shape(mesh)
    shard_world = int(math.prod(dims.get(a, 1) for a in zero_axes))
    if shard_world == 1:
        return PartitionSpec(*base)

    # largest free dim divisible by the shard world
    candidates = [i for i in range(ndim) if base[i] is None and shape[i] % shard_world == 0
                  and shape[i] > 0]
    if not candidates:
        return PartitionSpec(*base)
    best = max(candidates, key=lambda i: shape[i])
    base[best] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
    return PartitionSpec(*base)


def shard_dim(spec: Sequence) -> Optional[int]:
    """The dimension a spec shards over the ZeRO axes, or None."""
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        if any(a in ZERO_AXES for a in axes if a is not None):
            return i
    return None


class ShardingRules:
    """Regex path -> spec rules for tensor-parallel parameters (the JAX
    class; the training engine takes them as ``sharding_rules``): ``rules``
    is a list of ``(pattern, entries)``, ``entries`` one
    mesh axis or None a dimension of the parameter's JAX leaf; the first
    pattern that ``re.search``-es the path wins. Paths are the JAX
    parameter paths (``blocks/block/attn/q_proj/kernel``), which
    ``checkpoint.flax_import.flax_paths`` gives for a port module's
    parameters; ``module_inject`` turns the rules into module swaps."""

    def __init__(self, rules: Optional[Sequence[Tuple[str, Sequence]]]
                 = None):
        self.raw_rules = list(rules or [])
        self.rules = [(re.compile(pat), PartitionSpec(*spec))
                      for pat, spec in self.raw_rules]

    def spec_for(self, path: str) -> Optional[PartitionSpec]:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return None


_WHAT = {0: "nothing partitioned", 1: "optimizer states",
         2: "optimizer states + gradients",
         3: "optimizer states + gradients + parameters"}


class ZeroShardingPolicy:
    """Each parameter's specs for its compute copy (``param_spec``), its
    fp32 master and moments (``master_spec``) and its gradient accumulator
    (``grad_spec``), by the stage:

    stage 0: everything whole (gradients all-reduced)
    stage 1: master weights + optimizer moments sharded
    stage 2: + gradient accumulators sharded
    stage 3: + compute parameters sharded
    """

    def __init__(self, config: DeepSpeedZeroConfig, mesh=None,
                 sharding_rules: Optional[ShardingRules] = None):
        self.config = config
        self.mesh = mesh
        self.rules = sharding_rules or ShardingRules()
        self.stage = int(ZeroStageEnum(int(config.stage)))

    @property
    def zero_world(self) -> int:
        return _zero_world(self.mesh)

    def tp_spec(self, path: str):
        return self.rules.spec_for(path)

    def param_spec(self, path: str, shape) -> PartitionSpec:
        return zero_shard_spec(
            shape, self.mesh,
            stage_applies=self.stage >= ZeroStageEnum.weights,
            tp_spec=self.tp_spec(path),
            persistence_threshold=self.config.stage3_param_persistence_threshold,
        )

    def master_spec(self, path: str, shape) -> PartitionSpec:
        return zero_shard_spec(
            shape, self.mesh,
            stage_applies=self.stage >= ZeroStageEnum.optimizer_states,
            tp_spec=self.tp_spec(path),
            # masters shard regardless of size at stage >= 1 (the flat
            # partition's analog); the threshold applies to compute params
            persistence_threshold=0,
        )

    def grad_spec(self, path: str, shape) -> PartitionSpec:
        if self.stage >= ZeroStageEnum.gradients:
            return self.master_spec(path, shape)
        return zero_shard_spec(shape, self.mesh, stage_applies=False,
                               tp_spec=self.tp_spec(path))

    def bytes_at_rest(self, shapes: Dict[str, Tuple[int, ...]],
                      param_itemsize: int, keep_master: bool,
                      moments: int) -> Dict[str, int]:
        """The bytes one rank holds between steps, predicted from the
        specs alone: the compute parameters (``param_itemsize`` bytes an
        element), the fp32 masters (with ``keep_master``, or where a stage
        keeps an fp32 shard beside a whole fp32 parameter), ``moments``
        fp32 optimizer fields and the fp32 gradient accumulators. At a
        ``(data, model)`` mesh ``shapes`` are the rank's tensor-parallel
        parts (``module_inject.local_shapes``): ZeRO partitions each over
        the data group as the rank-local tensor it is."""
        world = self.zero_world

        def local(spec, shape) -> int:
            n = math.prod(shape)
            return n // world if shard_dim(spec) is not None else n

        out = dict(params=0, master=0, moments=0, accumulators=0)
        for name, shape in shapes.items():
            p = self.param_spec(name, shape)
            m = self.master_spec(name, shape)
            g = self.grad_spec(name, shape)
            out["params"] += local(p, shape) * param_itemsize
            own = keep_master or shard_dim(m) != shard_dim(p)
            out["master"] += local(m, shape) * 4 if own else 0
            out["moments"] += local(m, shape) * 4 * moments
            out["accumulators"] += local(g, shape) * 4
        return out

    def describe(self) -> str:
        return (f"zero stage {self.stage} ({_WHAT[self.stage]}) over a ZeRO "
                f"world of {self.zero_world}")
