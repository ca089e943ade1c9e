"""The autograd of tensor parallelism: Megatron's four operators over a
model group, as ``torch.autograd.Function``s on the port's ``comm``.

* :func:`copy_to_group`: identity forward, all-reduce backward. It sits on
  the input of every column-parallel projection (and of a vocab-parallel
  head): each rank's input gradient is a partial sum over its slice of the
  output features, and the all-reduce makes it whole;
* :func:`reduce_from_group`: all-reduce forward, identity backward. A
  row-parallel projection's partial products and a vocab-parallel
  embedding's rows are summed over the group;
* :func:`gather_from_group`: all-gather along the last axis forward, this
  rank's slice of the gradient backward (a vocab-parallel head's logits);
* :func:`sum_grad_over_group`: identity forward; backward, the gradient
  of a tensor several ranks hold copies of (a KV head that query heads on
  two ranks read) summed over those ranks, so every copy takes the same
  update.

GSPMD inserts the same collectives for the JAX package's sharded
placements. Over a group of one rank every operator returns its input and
calls nothing. A collective that fails raises (``comm`` returns its input
only where the group is one rank).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import comm
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import MODEL_AXIS


def group_size(group=MODEL_AXIS) -> int:
    return comm.get_world_size(group)


def group_rank(group=MODEL_AXIS) -> int:
    if group_size(group) == 1:
        return 0
    return mesh_mod.get_mesh().axis_rank(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    return comm.all_reduce(out, group=group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return comm.all_gather_into_tensor(x.contiguous(), group=group,
                                           axis=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, group_rank(ctx.group) * ctx.n,
                           ctx.n).contiguous(), None


class _SumGradOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, span, total, group):
        ctx.span, ctx.total, ctx.group = span, total, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.span
        buf = grad.new_zeros((ctx.total,) + tuple(grad.shape[1:]))
        buf[lo:hi] = grad
        comm.all_reduce(buf, group=ctx.group)
        return buf[lo:hi], None, None, None


def copy_to_group(x: torch.Tensor, group=MODEL_AXIS) -> torch.Tensor:
    if group is None or group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=MODEL_AXIS) -> torch.Tensor:
    if group is None or group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group=MODEL_AXIS) -> torch.Tensor:
    if group is None or group_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group)


def sum_grad_over_group(x: torch.Tensor, span: Tuple[int, int], total: int,
                        group=MODEL_AXIS) -> torch.Tensor:
    """``x`` holds rows ``span`` of a (``total``, ...) tensor; the ranks
    whose spans overlap hold the same rows, and their gradients are
    summed (the others add zeros)."""
    if group is None or group_size(group) == 1:
        return x
    return _SumGradOverGroup.apply(x, tuple(span), int(total), group)


def fold_in_rank(seed: int, rank: int) -> int:
    """A seed of its own for model rank ``rank``, derived from ``seed``."""
    return (int(seed) ^ ((rank + 1) * 0x9E3779B97F4A7C15)) % (2 ** 63)


def model_parallel_generator(gen, group=MODEL_AXIS):
    """For a model-parallel region's dropout (the attention probabilities
    of this rank's heads): a generator seeded from one draw of ``gen``
    folded with this rank, so the ranks' heads drop independently while
    ``gen`` advances alike on every rank (the replicated activations'
    masks stay equal across the group). ``gen`` itself over a group of
    one, or None."""
    if gen is None or group is None or group_size(group) == 1:
        return gen
    draw = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(
        fold_in_rank(draw, group_rank(group)))
