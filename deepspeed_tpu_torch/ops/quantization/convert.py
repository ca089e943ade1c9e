"""Module-tree conversion to the int8 serving layout (port of
``deepspeed_tpu/ops/quantization/convert.py``).

The JAX function walks a flax parameter tree on the host. Here the tree is
the port's ``nn.Module`` tree: every ``nn.Linear`` whose attribute name is in
:data:`DENSE_KEYS` is replaced in place by a :class:`~.linear.QuantDense`,
quantized per output channel on the device the model lives on (a 1.1B model
is not quantized in numpy on the host).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .linear import QuantDense

__all__ = ["DENSE_KEYS", "quantize_lm_params"]

DENSE_KEYS = frozenset({
    "q_proj", "k_proj", "v_proj", "o_proj",
    "up_proj", "gate_proj", "down_proj", "lm_head"})


def quantize_lm_params(model: nn.Module, dense_keys=DENSE_KEYS,
                       kernel_mode: str = "auto") -> Tuple[nn.Module, int]:
    """Swap every ``nn.Linear`` named in ``dense_keys`` for a QuantDense
    that outputs in the layer's own dtype. Returns (the same model, the
    number of layers converted). ``lm_head`` outputs fp32, as the JAX head
    does."""
    targets = [(parent, name, child)
               for parent in model.modules()
               for name, child in parent.named_children()
               if name in dense_keys and isinstance(child, nn.Linear)]
    for parent, name, child in targets:
        dtype = torch.float32 if name == "lm_head" else None
        setattr(parent, name, QuantDense.from_linear(
            child, dtype=dtype, kernel_mode=kernel_mode))
    return model, len(targets)
