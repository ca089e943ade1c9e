"""DeepSpeedCPUAdam and DeepSpeedCPUAdagrad: host-side optimizer steps over
offloaded optimizer state (the port of ``deepspeed_tpu/ops/adam/
cpu_adam.py``).

They operate IN PLACE on contiguous fp32 CPU tensors (the master weights,
the moments, the gradient), passing their ``data_ptr()`` through ctypes to
the port's host op ``ops/csrc/cpu_adam.cpp``, built at first use by
``op_builder.load_host``. There is no fallback: a missing compiler or a
failed build raises when the optimizer is made. ``to_bf16`` rounds to
nearest even into a bf16 tensor (the op writes its 16-bit words), as
``tensor.to(torch.bfloat16)`` does for finite values.

:func:`adam_step_reference` and :func:`adagrad_step_reference` are the same
arithmetic in plain PyTorch, step by step in fp32; only the tests use them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import op_builder


def _check(*tensors: torch.Tensor) -> int:
    """Every tensor contiguous fp32 on the CPU, all of one size; returns
    it."""
    n = tensors[0].numel()
    for t in tensors:
        if t.device.type != "cpu" or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"host optimizer tensors must be contiguous "
                             f"fp32 CPU tensors of one size; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return n


def bias_corrections(betas: Tuple[float, float], step_num: int,
                     bias_correction: bool = True) -> Tuple[float, float]:
    """(1 - beta1^t, 1 - beta2^t) for the 1-indexed ``step_num``, or
    (1, 1) without bias correction."""
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 - betas[0] ** step_num, 1.0 - betas[1] ** step_num


class DeepSpeedCPUAdam:
    """Adam (``adamw_mode=False``: weight decay added to the gradient) or
    AdamW (``True``: decoupled decay) on the host."""

    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, bias_correction: bool = True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self._lib = op_builder.load_host("cpu_adam")

    def step(self, param: torch.Tensor, grad: torch.Tensor,
             exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor, step_num: int,
             lr: Optional[float] = None) -> None:
        """One step in place; ``step_num`` is 1-indexed. Every tensor is a
        contiguous fp32 CPU tensor of one size (any shape)."""
        n = _check(param, grad, exp_avg, exp_avg_sq)
        lr = self.lr if lr is None else lr
        bc1, bc2 = bias_corrections(self.betas, step_num,
                                    self.bias_correction)
        self._lib.ds_adam_step(param.data_ptr(), grad.data_ptr(),
                               exp_avg.data_ptr(), exp_avg_sq.data_ptr(), n,
                               lr, self.betas[0],
                               self.betas[1], self.eps, self.weight_decay,
                               int(self.adamw_mode), bc1, bc2)

    def has_overflow(self, grad: torch.Tensor) -> bool:
        """True when ``grad`` holds a NaN or an infinity."""
        n = _check(grad)
        return bool(self._lib.ds_has_nonfinite(grad.data_ptr(), n))

    def to_bf16(self, src: torch.Tensor,
                dst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``src`` (fp32, CPU, contiguous) rounded to nearest even into
        ``dst`` (a contiguous bf16 CPU tensor of its size, e.g. a pinned
        upload buffer; default: a new one of ``src``'s shape)."""
        n = _check(src)
        if dst is None:
            dst = torch.empty(src.shape, dtype=torch.bfloat16)
        if dst.dtype != torch.bfloat16 or dst.device.type != "cpu" or \
                not dst.is_contiguous() or dst.numel() != n:
            raise ValueError("to_bf16 needs a contiguous bf16 CPU "
                             "destination of the source's size")
        self._lib.ds_f32_to_bf16(dst.data_ptr(), src.data_ptr(), n)
        return dst


class DeepSpeedCPUAdagrad:
    """Adagrad on the host (weight decay added to the gradient)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = op_builder.load_host("cpu_adam")

    def step(self, param: torch.Tensor, grad: torch.Tensor,
             accum: torch.Tensor, lr: Optional[float] = None) -> None:
        n = _check(param, grad, accum)
        lr = self.lr if lr is None else lr
        self._lib.ds_adagrad_step(param.data_ptr(), grad.data_ptr(),
                                  accum.data_ptr(), n,
                                  lr, self.eps, self.weight_decay)


def _f32(x: float) -> torch.Tensor:
    """A Python float rounded to fp32, as ctypes passes it to the op."""
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adam_step_reference(param, grad, exp_avg, exp_avg_sq, step_num: int,
                        lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                        weight_decay: float = 0.0, adamw_mode: bool = True,
                        bias_correction: bool = True) -> None:
    """:meth:`DeepSpeedCPUAdam.step`'s arithmetic in plain fp32 PyTorch, in
    place."""
    b1, b2 = _f32(betas[0]), _f32(betas[1])
    bc1, bc2 = (_f32(x) for x in bias_corrections(betas, step_num,
                                                  bias_correction))
    wd = _f32(weight_decay)
    g = grad
    if weight_decay != 0.0 and not adamw_mode:
        g = g + wd * param
    exp_avg.copy_(b1 * exp_avg + (1 - b1) * g)
    exp_avg_sq.copy_(b2 * exp_avg_sq + (1 - b2) * g * g)
    denom = exp_avg_sq.sqrt() * (1 / bc2.sqrt()) + _f32(eps)
    update = exp_avg * (1 / bc1) / denom
    if weight_decay != 0.0 and adamw_mode:
        update = update + wd * param
    param.sub_(_f32(lr) * update)


@torch.no_grad()
def adagrad_step_reference(param, grad, accum, lr: float, eps: float = 1e-8,
                           weight_decay: float = 0.0) -> None:
    """:meth:`DeepSpeedCPUAdagrad.step`'s arithmetic in plain PyTorch."""
    g = grad
    if weight_decay != 0.0:
        g = g + _f32(weight_decay) * param
    accum.add_(g * g)
    param.sub_(_f32(lr) * g / (accum.sqrt() + _f32(eps)))
