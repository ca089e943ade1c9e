"""Int8-at-rest linear layer for serving (port of
``deepspeed_tpu/ops/quantization/linear.py``).

:class:`QuantDense` replaces ``nn.Linear`` in the int8 serving tier: an int8
``weight`` (N, K) and an fp32 per-output-channel ``scale`` (N,), held as
buffers, and a forward through :func:`~.int8_matmul.int8_matmul`, so the
weights stream from device memory as int8.

The JAX layer pads its feature count to a multiple of 128 lanes
(``pad_features``), a TPU tiling rule; the CUDA kernel takes any N, so the
port stores N unpadded (the weight bridge drops the JAX pad columns, which
are zero weights with scale 1).
"""

from __future__ import annotations

import torch
from torch import nn

from .int8_matmul import int8_matmul, int8_matmul_reference, quantize_columns

__all__ = ["QuantDense"]


class QuantDense(nn.Module):
    """``y = int8_matmul(x, weight, scale, dtype) + bias``.

    ``kernel_mode``: ``"auto"`` and ``"on"`` take :func:`int8_matmul` (the
    kernel for a CUDA tensor, its plain version for a CPU one); ``"off"``
    the plain version everywhere. Inside a ``TransformerLM`` the model's
    config owns the switch (``int8_kernel``); change it with
    ``TransformerLM.replace_config``, which sets this attribute on every
    QuantDense. The product runs with x rounded to bf16
    whatever ``dtype`` is (the JAX tier's compute contract); ``dtype`` is the
    output dtype, and the optional bias is added in it afterwards, as the
    JAX layer does.

    Move a model that holds one with ``.to(device)`` only: ``.to(dtype)``
    casts every floating buffer, the fp32 scales too."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.bfloat16,
                 kernel_mode: str = "auto", device=None):
        super().__init__()
        if kernel_mode not in ("auto", "on", "off"):
            raise ValueError(f"kernel_mode must be auto|on|off, got "
                             f"{kernel_mode!r}")
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.kernel_mode = kernel_mode
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=dtype, device=device) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear, dtype=None,
                    kernel_mode: str = "auto") -> "QuantDense":
        """Quantize ``linear`` per output channel on its own device."""
        w = linear.weight
        out = cls(linear.in_features, linear.out_features,
                  bias=linear.bias is not None, dtype=dtype or w.dtype,
                  kernel_mode=kernel_mode, device=w.device)
        q, s = quantize_columns(w.t())
        out.weight.copy_(q.t())
        out.scale.copy_(s.reshape(-1))
        if linear.bias is not None:
            out.bias.copy_(linear.bias)
        return out

    def product(self, x):
        """``int8_matmul(x, weight, scale, dtype)``, without the bias."""
        if self.kernel_mode == "off":
            return int8_matmul_reference(x, self.weight, self.scale,
                                         self.dtype)
        return int8_matmul(x.contiguous(), self.weight, self.scale,
                           self.dtype)

    def forward(self, x):
        y = self.product(x)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, dtype={self.dtype}, "
                f"kernel_mode={self.kernel_mode}")
