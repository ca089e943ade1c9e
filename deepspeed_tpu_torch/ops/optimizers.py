"""Optimizers over lists of fp32 tensors: the port of ``deepspeed_tpu/ops/
optimizers.py``.

Each optimizer is an :class:`OptimizerDef`: ``init(params)`` builds its
state (lists aligned with ``params``) and ``update(grads, state, params,
lr, step)`` applies one step IN PLACE to ``params`` (the engine's fp32
master copies, or the module's own fp32 parameters) and to ``state``; the
JAX package returns new pytrees instead. The arithmetic is the JAX
package's, step by step, on PyTorch's ``_foreach`` ops: one fused launch
per operation over all tensors, the multi-tensor apply that the JAX package
leaves to XLA's fusion. The JAX package has no Pallas kernel here.

``"type": "Adam"`` means decoupled weight decay (``adam_w_mode=True``,
AdamW), as in the JAX package: ``p ← p − lr·(m̂/(√v̂ + eps)) − lr·wd·p``
with ``m̂ = m / (1 − β1^t)`` and ``v̂ = v / (1 − β2^t)``, ``t = step + 1``.
PyTorch's ``torch.optim.Adam`` with ``weight_decay`` is the coupled (L2)
variant, a different optimizer (``adam_w_mode=False`` here).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tensors = List[torch.Tensor]


class OptimizerDef(NamedTuple):
    """A functional optimizer: ``init(params) -> state``; ``update(grads,
    state, params, lr, step)`` updates ``params`` and ``state`` in place."""

    init: Callable[[Tensors], Tuple]
    update: Callable[..., None]
    name: str


class AdamState(NamedTuple):
    exp_avg: Tensors
    exp_avg_sq: Tensors


def _zeros_like(params: Tensors) -> Tensors:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def fused_adam(betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True) -> OptimizerDef:
    """Adam (``adam_w_mode=False``: weight decay added to the gradient) or
    AdamW (``True``: decoupled decay, the JAX package's default)."""
    beta1, beta2 = betas

    def init(params):
        return AdamState(_zeros_like(params), _zeros_like(params))

    def update(grads, state: AdamState, params, lr: float, step: int):
        t = step + 1
        bc1 = 1.0 - beta1 ** t if bias_correction else 1.0
        bc2 = 1.0 - beta2 ** t if bias_correction else 1.0
        m, v = state
        if weight_decay != 0.0 and not adam_w_mode:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        if weight_decay != 0.0 and adam_w_mode:
            # the decay term reads the parameter before this step's update
            torch._foreach_mul_(params, 1.0 - lr * weight_decay)
        torch._foreach_addcdiv_(params, m, denom, value=-lr / bc1)

    return OptimizerDef(init=init, update=update, name="FusedAdam")


def fused_lamb(betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01,
               bias_correction: bool = True) -> OptimizerDef:
    """LAMB: the Adam direction (plus decoupled decay) scaled per tensor by
    the trust ratio ``‖p‖ / ‖u‖`` clamped to [min_coeff, max_coeff]."""
    beta1, beta2 = betas

    def init(params):
        return AdamState(_zeros_like(params), _zeros_like(params))

    def update(grads, state: AdamState, params, lr: float, step: int):
        t = step + 1
        bc1 = 1.0 - beta1 ** t if bias_correction else 1.0
        bc2 = 1.0 - beta2 ** t if bias_correction else 1.0
        m, v = state
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, denom)
        if weight_decay != 0.0:
            torch._foreach_add_(u, params, alpha=weight_decay)
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(u)
        for p, upd, pn, un in zip(params, u, p_norm, u_norm):
            trust = torch.where((pn > 0) & (un > 0),
                                (pn / un).clamp(min_coeff, max_coeff),
                                torch.ones_like(pn))
            p.add_(upd * trust, alpha=-lr)

    return OptimizerDef(init=init, update=update, name="FusedLamb")


class SGDState(NamedTuple):
    momentum_buf: Tensors


def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> OptimizerDef:
    def init(params):
        return SGDState(_zeros_like(params))

    def update(grads, state: SGDState, params, lr: float, step: int):
        del step
        if weight_decay != 0.0:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        buf = state.momentum_buf
        torch._foreach_mul_(buf, momentum)
        torch._foreach_add_(buf, grads)
        if nesterov:
            d = torch._foreach_add(grads, buf, alpha=momentum)
        else:
            d = buf
        torch._foreach_add_(params, d, alpha=-lr)

    return OptimizerDef(init=init, update=update, name="SGD")


class AdagradState(NamedTuple):
    accum: Tensors


def adagrad(eps: float = 1e-8, weight_decay: float = 0.0) -> OptimizerDef:
    def init(params):
        return AdagradState(_zeros_like(params))

    def update(grads, state: AdagradState, params, lr: float, step: int):
        del step
        if weight_decay != 0.0:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        torch._foreach_addcmul_(state.accum, grads, grads)
        denom = torch._foreach_sqrt(state.accum)
        torch._foreach_add_(denom, eps)
        torch._foreach_addcdiv_(params, grads, denom, value=-lr)

    return OptimizerDef(init=init, update=update, name="Adagrad")


ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"


def _adam_factory(params: Dict) -> OptimizerDef:
    return fused_adam(betas=tuple(params.get("betas", (0.9, 0.999))),
                      eps=params.get("eps", 1e-8),
                      weight_decay=params.get("weight_decay", 0.0),
                      adam_w_mode=params.get("adam_w_mode", True),
                      bias_correction=params.get("bias_correction", True))


def _adamw_factory(params: Dict) -> OptimizerDef:
    return _adam_factory(dict(params, adam_w_mode=True))


def _lamb_factory(params: Dict) -> OptimizerDef:
    return fused_lamb(betas=tuple(params.get("betas", (0.9, 0.999))),
                      eps=params.get("eps", 1e-8),
                      weight_decay=params.get("weight_decay", 0.0),
                      max_coeff=params.get("max_coeff", 10.0),
                      min_coeff=params.get("min_coeff", 0.01))


def _sgd_factory(params: Dict) -> OptimizerDef:
    return sgd(momentum=params.get("momentum", 0.0),
               weight_decay=params.get("weight_decay", 0.0),
               nesterov=params.get("nesterov", False))


def _adagrad_factory(params: Dict) -> OptimizerDef:
    return adagrad(eps=params.get("eps", 1e-8),
                   weight_decay=params.get("weight_decay", 0.0))


OPTIMIZER_REGISTRY: Dict[str, Callable[[Dict], OptimizerDef]] = {
    ADAM_OPTIMIZER: _adam_factory,
    ADAMW_OPTIMIZER: _adamw_factory,
    LAMB_OPTIMIZER: _lamb_factory,
    SGD_OPTIMIZER: _sgd_factory,
    ADAGRAD_OPTIMIZER: _adagrad_factory,
}
# the 1-bit optimizers of the JAX package (compressed communication over
# data-parallel replicas) are not ported
NOT_PORTED = (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
              ZERO_ONE_ADAM_OPTIMIZER)


def get_optimizer(type_name: Optional[str],
                  params: Optional[Dict] = None) -> OptimizerDef:
    """The optimizer for the config's ``optimizer.type`` (case-insensitive);
    ``lr`` flows through the schedule, not the definition."""
    name = (type_name or "adam").lower()
    params = dict(params or {})
    params.pop("lr", None)
    if name.replace("_", "") in NOT_PORTED:
        raise NotImplementedError(f"optimizer {type_name!r} is not ported to "
                                  f"the PyTorch/CUDA package yet")
    if name in OPTIMIZER_REGISTRY:
        return OPTIMIZER_REGISTRY[name](params)
    raise ValueError(f"Unknown optimizer type {type_name!r}; supported: "
                     f"{sorted(OPTIMIZER_REGISTRY)}")
