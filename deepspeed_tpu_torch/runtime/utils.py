"""Runtime math helpers: the port of ``deepspeed_tpu/runtime/utils.py``
(global gradient norm, clipping by it, parameter count), over lists of
tensors. Every result stays on the device: nothing here syncs.

Over ZeRO shards the norm is the world's: ``sharded`` marks the gradients
that are this rank's slices, whose squared norms (largest magnitudes for
``ord=inf``) are reduced over the ZeRO ``group``; a gradient that stays
whole is the same on every rank and counts once. Over a model group
(tensor parallelism) ``copies`` gives, for each gradient, how many ranks
of the ``model_group`` hold the same values (the group's size for a
replicated tensor, 1 for a slice): each rank's squares are divided by it
and summed over the model group, so a slice counts once and a replica
once, not once a rank."""

from __future__ import annotations

import itertools
from typing import Iterable, List, Optional, Tuple

import torch


def _local_norm(grads: List[torch.Tensor], ord) -> torch.Tensor:
    if ord == 2:
        return torch.stack(torch._foreach_norm(
            [g.float() for g in grads])).square().sum().sqrt()
    return torch.stack([g.float().abs().max() for g in grads]).max()


def global_grad_norm(grads: Iterable[torch.Tensor],
                     ord: int = 2, sharded: Optional[List[bool]] = None,
                     group=None, copies: Optional[List[int]] = None,
                     model_group=None) -> torch.Tensor:
    """The L2 norm over every element of every gradient (``ord=inf``: the
    largest magnitude), as an fp32 device scalar; with ``sharded`` (one
    flag a gradient), over the ZeRO group's shards; with ``model_group``,
    over the model group's tensor-parallel parts too, each gradient held
    by ``copies`` of its ranks (module docstring)."""
    from .. import comm

    kept = [(g, s, c) for g, s, c in zip(
        grads, sharded or itertools.repeat(False),
        copies or itertools.repeat(1)) if g is not None]
    if not kept:
        return torch.tensor(0.0)
    grads = [g for g, _, _ in kept]
    any_sharded = any(s for _, s, _ in kept)
    over_model = model_group is not None and \
        comm.get_world_size(model_group) > 1
    if ord != 2:
        part = _local_norm(grads, ord).reshape(1)
        if any_sharded:
            comm.all_reduce(part, op=comm.ReduceOp.MAX, group=group)
        if over_model:
            comm.all_reduce(part, op=comm.ReduceOp.MAX, group=model_group)
        return part[0]

    def squares(flag):
        gs = [(g, c) for g, s, c in kept if s == flag]
        if not gs:
            return torch.zeros(1, device=grads[0].device)
        norms = torch._foreach_norm([g.float() for g, _ in gs])
        w = torch.tensor([1.0 / c for _, c in gs], device=norms[0].device)
        return (torch.stack(norms).square() * w).sum().reshape(1)

    total = squares(False)
    if any_sharded:
        total = total + comm.all_reduce(squares(True), group=group)
    if over_model:
        comm.all_reduce(total, group=model_group)
    return total[0].sqrt()


def clip_grads_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                              norm: Optional[torch.Tensor] = None
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` IN PLACE so that their global norm is at most
    ``max_norm``: by ``min(1, max_norm / (norm + 1e-6))``, or by 1 when the
    norm is not finite (that step is skipped anyway). Returns ``(grads,
    pre-clip norm)``."""
    if norm is None:
        norm = global_grad_norm(grads)
    safe = torch.where(torch.isfinite(norm), norm, torch.zeros_like(norm))
    factor = torch.clamp(max_norm / (safe + 1e-6), max=1.0)
    torch._foreach_mul_(grads, factor)
    return grads, norm


def count_parameters(params: Iterable[torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params)
