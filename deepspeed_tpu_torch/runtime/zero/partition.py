"""Each parameter's place over the ZeRO group, and stage 3's gathered
parameters: the engine-side half of the port's ZeRO (the reference's
``partition_parameters.py`` and ``partitioned_param_coordinator.py``; in
the JAX package GSPMD does this from ``policy.py``'s specs).

:class:`ZeroPartition` turns the policy's specs into one
:class:`ParamLayout` a parameter: which dimension its fp32 master, moments
and (stage >= 2) gradient accumulator shard along, and whether its compute
copy is sharded at rest (stage 3). Rank r of the ZeRO group holds the r-th
of the group's equal slices along that dimension; a tensor with no
dimension the group divides stays whole on every rank. Gradients are
summed in fp32: reduce-scattered over the ZeRO group (the ``data`` axis;
under MiCS the shard group) and all-reduced over the MiCS replica groups
(``data_outer``), or all-reduced over the whole data-parallel world where
they stay whole. Under tensor parallelism the layouts are over each
rank's tensor-parallel parts, and every reduction and gather here stays
within the data axes: the ranks of a model group never meet here.

:class:`Zero3Params` shards the compute parameters of a stage-3 model at
rest: each sharded parameter is replaced in its module by a Parameter
holding the rank's slice, and the full tensor exists only while it is
used:

* forward: a pre-hook on each block (``module.blocks``) gathers the
  block's parameters through :class:`_Gather` (an autograd Function whose
  forward all-gathers and whose backward reduce-scatters the gradient into
  the fp32 accumulator shard) and puts the full tensors in the modules; a
  forward hook puts the shards back. The parameters outside the blocks
  (embeddings, final norm, head) are gathered by hooks on the model for
  its whole forward.
* autograd would keep every gathered weight alive until the backward
  through the tensors it saves (``F.linear`` saves its weight). The
  engine's forward runs under ``saved_tensors_hooks`` whose pack hook
  replaces a saved tensor that lives in a gathered weight's storage by a
  handle (parameter index, size, stride, offset); the unpack hook gathers
  the weight again in the backward (once a block: the gathered copy is
  cached until the parameter's :class:`_Gather` backward has run, after
  which nothing reads it).
* under activation checkpointing the checkpoint's own hooks take the
  block's saved tensors (the innermost hooks win), and its recomputation
  calls the block again, whose pre-hook gathers again.

After each backward ``after_backward()`` puts every shard back (a
checkpoint's recomputation may stop early, before its block's forward hook
runs) and drops the backward's gathered copies.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ... import comm
from ...parallel.mesh import DATA_OUTER_AXIS, ZERO_AXES
from .policy import ZeroShardingPolicy, shard_dim


@dataclasses.dataclass
class ParamLayout:
    """One parameter's partition. ``dim``: the dimension its master,
    moments (and with ``grad_sharded`` its accumulator) shard along, None
    when they stay whole; ``param_sharded``: its compute copy is sharded
    at rest (stage 3)."""

    name: str
    shape: Tuple[int, ...]
    dim: Optional[int]
    param_sharded: bool
    grad_sharded: bool
    world: int
    rank: int

    @property
    def state_sharded(self) -> bool:
        return self.dim is not None

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor (a view); the tensor itself
        when whole."""
        if self.dim is None:
            return full
        k = full.shape[self.dim] // self.world
        return full.narrow(self.dim, self.rank * k, k)

    def local_shape(self) -> Tuple[int, ...]:
        if self.dim is None:
            return self.shape
        shape = list(self.shape)
        shape[self.dim] //= self.world
        return tuple(shape)


class ZeroPartition:
    """The layouts of ``named_shapes`` under ``policy`` on ``mesh``, and
    the collectives that move tensors between their layouts."""

    def __init__(self, policy: ZeroShardingPolicy, mesh,
                 named_shapes: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.policy = policy
        self.world = policy.zero_world
        self.rank = mesh.axis_rank(ZERO_AXES) if mesh is not None else 0
        self.replicas = mesh.axis_size((DATA_OUTER_AXIS,)) \
            if mesh is not None else 1
        self.layouts: List[ParamLayout] = []
        for name, shape in named_shapes:
            shape = tuple(int(s) for s in shape)
            dim = shard_dim(policy.master_spec(name, shape))
            pdim = shard_dim(policy.param_spec(name, shape))
            gdim = shard_dim(policy.grad_spec(name, shape))
            self.layouts.append(ParamLayout(
                name, shape, dim, param_sharded=pdim is not None,
                grad_sharded=gdim is not None, world=self.world,
                rank=self.rank))

    @property
    def any_sharded(self) -> bool:
        return any(lay.state_sharded for lay in self.layouts)

    @property
    def stage3(self) -> bool:
        return any(lay.param_sharded for lay in self.layouts)

    def gather(self, lay: ParamLayout, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's slice."""
        if lay.dim is None:
            return shard
        return comm.all_gather_into_tensor(shard, group=ZERO_AXES,
                                           axis=lay.dim)

    def scatter(self, lay: ParamLayout, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the ZeRO group's sum of ``full``."""
        return comm.reduce_scatter_tensor(full, group=ZERO_AXES,
                                          scatter_dimension=lay.dim)

    def reduce_boundary(self, accs: List[torch.Tensor]) -> List[torch.Tensor]:
        """At the accumulation boundary, each rank's summed gradients
        (``accs``, aligned with the layouts) as the world's sums in each
        parameter's state layout: a whole accumulator is all-reduced over
        the data-parallel world (stage 0, or a tensor that stays whole) or
        reduce-scattered into the rank's slice (stage 1); a sharded one
        (stage >= 2, already reduce-scattered each micro-batch) is summed
        over the MiCS replica groups."""
        out = []
        for lay, acc in zip(self.layouts, accs):
            if lay.grad_sharded:
                g = acc
                if self.replicas > 1:
                    comm.all_reduce(g, group=DATA_OUTER_AXIS)
            elif lay.state_sharded:
                g = self.scatter(lay, acc)
                if self.replicas > 1:
                    comm.all_reduce(g, group=DATA_OUTER_AXIS)
            else:
                g = comm.all_reduce(acc)
            out.append(g)
        return out

    def sharded_mask(self) -> List[bool]:
        return [lay.state_sharded for lay in self.layouts]

    def take(self, lay: ParamLayout, full, like: torch.Tensor
             ) -> torch.Tensor:
        """``full`` (a whole saved tensor or array) in ``like``'s layout:
        the rank's slice when ``like`` is one."""
        full = torch.as_tensor(full)
        if tuple(full.shape) == tuple(like.shape):
            return full
        return lay.local(full)


class _Handle:
    """A saved tensor that lived in a gathered weight's storage."""

    __slots__ = ("index", "size", "stride", "offset")

    def __init__(self, index, size, stride, offset):
        self.index, self.size = index, size
        self.stride, self.offset = stride, offset


class _Gather(torch.autograd.Function):
    """shard -> full (all-gather); the backward reduce-scatters the full
    gradient in fp32 into the accumulator shard and gives the shard no
    gradient of its own."""

    @staticmethod
    def forward(ctx, shard, owner, index):
        ctx.owner, ctx.index = owner, index
        return owner.gather_index(index, shard)

    @staticmethod
    def backward(ctx, grad):
        ctx.owner.grad_ready(ctx.index, grad)
        return None, None, None


class Zero3Params:
    """Stage 3's sharded compute parameters of ``module`` (module
    docstring). ``params`` and ``accs`` are the engine's trainable
    parameters and fp32 accumulators, aligned with ``part.layouts``;
    the sharded entries of ``params`` are replaced by the shard
    Parameters."""

    def __init__(self, module: nn.Module, part: ZeroPartition,
                 params: List[torch.Tensor], accs: List[torch.Tensor]):
        self.part = part
        self.accs = accs
        holders: Dict[int, List[Tuple[nn.Module, str]]] = {}
        for mod in module.modules():
            for attr, p in mod._parameters.items():
                if p is not None:
                    holders.setdefault(id(p), []).append((mod, attr))
        blocks = getattr(module, "blocks", None)
        block_of: Dict[int, int] = {}
        if isinstance(blocks, nn.ModuleList):
            for b, blk in enumerate(blocks):
                for p in blk.parameters():
                    block_of[id(p)] = b
        self.index: List[int] = []           # entry -> engine param index
        self.shards: List[nn.Parameter] = []
        self.holders: List[List[Tuple[nn.Module, str]]] = []
        self.groups: Dict[object, List[int]] = {}
        with torch.no_grad():
            for i, (lay, p) in enumerate(zip(part.layouts, params)):
                if not lay.param_sharded:
                    continue
                shard = nn.Parameter(lay.local(p.detach()).clone(),
                                     requires_grad=p.requires_grad)
                e = len(self.shards)
                self.index.append(i)
                self.shards.append(shard)
                self.holders.append(holders[id(p)])
                self.groups.setdefault(block_of.get(id(p), "root"),
                                       []).append(e)
                for mod, attr in holders[id(p)]:
                    mod._parameters[attr] = shard
                params[i] = shard
        self._live: Dict[int, int] = {}      # storage pointer -> entry
        self._alive: Dict[int, weakref.ref] = {}
        self._bwd: Dict[int, torch.Tensor] = {}
        self.in_forward = False
        self.max_live_blocks = 0
        self._hooks = []
        if isinstance(blocks, nn.ModuleList):
            for b, blk in enumerate(blocks):
                if b in self.groups:
                    self._hook(blk, b)
        if "root" in self.groups:
            self._hook(module, "root")

    def _hook(self, mod: nn.Module, group) -> None:
        self._hooks.append(mod.register_forward_pre_hook(
            lambda m, args, g=group: self.enter(g)))
        self._hooks.append(mod.register_forward_hook(
            lambda m, args, out, g=group: self.exit(g)))

    # --- gathering ---------------------------------------------------------
    def gather_index(self, e: int, shard: torch.Tensor) -> torch.Tensor:
        lay = self.part.layouts[self.index[e]]
        with torch.no_grad():
            return self.part.gather(lay, shard)

    def enter(self, group) -> None:
        """Gather ``group``'s parameters into their modules."""
        grad = torch.is_grad_enabled()
        for e in self.groups[group]:
            shard = self.shards[e]
            if grad and shard.requires_grad:
                full = _Gather.apply(shard, self, e)
            else:
                full = self.gather_index(e, shard)
            for mod, attr in self.holders[e]:
                mod._parameters[attr] = full
            self._live[full.untyped_storage().data_ptr()] = e
            self._alive[e] = weakref.ref(full)
        if self.in_forward and group != "root":
            live = {b for b, es in self.groups.items() if b != "root" and any(
                self._alive.get(e) is not None and self._alive[e]() is not None
                for e in es)}
            self.max_live_blocks = max(self.max_live_blocks, len(live))

    def exit(self, group) -> None:
        """Put ``group``'s shards back."""
        for e in self.groups[group]:
            for mod, attr in self.holders[e]:
                full = mod._parameters[attr]
                if full is not self.shards[e]:
                    self._live.pop(full.untyped_storage().data_ptr(), None)
                mod._parameters[attr] = self.shards[e]

    # --- saved tensors -----------------------------------------------------
    def pack(self, t: torch.Tensor):
        if not self._live or t.layout != torch.strided:
            return t
        e = self._live.get(t.untyped_storage().data_ptr())
        if e is None:
            return t
        return _Handle(e, t.size(), t.stride(), t.storage_offset())

    def unpack(self, saved):
        if not isinstance(saved, _Handle):
            return saved
        full = self._bwd.get(saved.index)
        if full is None:
            full = self.gather_index(saved.index, self.shards[saved.index])
            self._bwd[saved.index] = full
        return full.as_strided(saved.size, saved.stride, saved.offset)

    def saving(self):
        """The context the engine's forward runs under."""
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)

    def grad_ready(self, e: int, grad: torch.Tensor) -> None:
        i = self.index[e]
        lay = self.part.layouts[i]
        self.accs[i].add_(self.part.scatter(lay, grad.float()))
        self._bwd.pop(e, None)

    def after_backward(self) -> None:
        for e, shard in enumerate(self.shards):
            for mod, attr in self.holders[e]:
                mod._parameters[attr] = shard
        self._live.clear()
        self._bwd.clear()

    def full_state(self) -> Dict[int, torch.Tensor]:
        """{engine param index: the gathered full tensor} (collective)."""
        return {self.index[e]: self.gather_index(e, shard)
                for e, shard in enumerate(self.shards)}
