"""Module-tree conversion to the int8 serving layout (port of
``deepspeed_tpu/ops/quantization/convert.py``).

The JAX function walks a flax parameter tree on the host. Here the tree is
the port's ``nn.Module`` tree: every ``nn.Linear`` whose attribute name is in
:data:`DENSE_KEYS` is replaced in place by a :class:`~.linear.QuantDense`,
quantized per output channel on the device the model lives on (a 1.1B model
is not quantized in numpy on the host). :func:`quantize_lm_state_dict` is
its host-side twin over a state dict, for weights that never sit in a
module on the device (ZeRO-Inference's host tier).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from .int8_matmul import quantize_columns
from .linear import QuantDense

__all__ = ["DENSE_KEYS", "quantize_lm_params", "quantize_lm_state_dict"]

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


@torch.no_grad()
def quantize_lm_state_dict(sd: Dict[str, torch.Tensor],
                           dense_keys=DENSE_KEYS
                           ) -> Tuple[Dict[str, torch.Tensor], int]:
    """:func:`quantize_lm_params` over a state dict on its own device:
    every float ``<...>.<dense>.weight`` (N, K) with ``<dense>`` in
    ``dense_keys`` becomes the QuantDense layout, an int8 ``weight`` (N, K)
    and an fp32 ``scale`` (N,) beside it, quantized as
    ``QuantDense.from_linear`` quantizes; every other entry is kept.
    Returns (the new dict, the number of weights converted)."""
    out: Dict[str, torch.Tensor] = {}
    n = 0
    for key, w in sd.items():
        parts = key.split(".")
        w = torch.as_tensor(w)
        if len(parts) >= 2 and parts[-1] == "weight" and \
                parts[-2] in dense_keys and w.dim() == 2 and \
                w.is_floating_point():
            q, s = quantize_columns(w.t())
            out[key] = q.t().contiguous()
            out[key[:-len("weight")] + "scale"] = s.reshape(-1)
            n += 1
        else:
            out[key] = w
    return out, n
