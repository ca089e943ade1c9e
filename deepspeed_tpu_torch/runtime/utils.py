"""Runtime math helpers: the port of ``deepspeed_tpu/runtime/utils.py``
(global gradient norm, clipping by it, parameter count), over lists of
tensors. Every result stays on the device: nothing here syncs.

Over ZeRO shards the norm is the world's: ``sharded`` marks the gradients
that are this rank's slices, whose squared norms (largest magnitudes for
``ord=inf``) are reduced over the ZeRO ``group``; a gradient that stays
whole is the same on every rank and counts once."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch


def _local_norm(grads: List[torch.Tensor], ord) -> torch.Tensor:
    if ord == 2:
        return torch.stack(torch._foreach_norm(
            [g.float() for g in grads])).square().sum().sqrt()
    return torch.stack([g.float().abs().max() for g in grads]).max()


def global_grad_norm(grads: Iterable[torch.Tensor],
                     ord: int = 2, sharded: Optional[List[bool]] = None,
                     group=None) -> torch.Tensor:
    """The L2 norm over every element of every gradient (``ord=inf``: the
    largest magnitude), as an fp32 device scalar; with ``sharded`` (one
    flag a gradient), over the ZeRO group's shards (module docstring)."""
    grads = list(grads)
    if sharded is None or not any(sharded):
        grads = [g for g in grads if g is not None]
        if not grads:
            return torch.tensor(0.0)
        return _local_norm(grads, ord)
    from .. import comm

    mine = [g for g, s in zip(grads, sharded) if s and g is not None]
    whole = [g for g, s in zip(grads, sharded) if not s and g is not None]
    part = _local_norm(mine, ord)
    if ord == 2:
        part = part.square().reshape(1)
        comm.all_reduce(part, group=group)
        total = part[0] + (_local_norm(whole, 2).square() if whole else 0.0)
        return total.sqrt()
    part = part.reshape(1)
    comm.all_reduce(part, op=comm.ReduceOp.MAX, group=group)
    return torch.maximum(part[0], _local_norm(whole, ord)) if whole \
        else part[0]


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
