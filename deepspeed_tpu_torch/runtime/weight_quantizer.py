"""Inference weight quantization (port of
``deepspeed_tpu/runtime/weight_quantizer.py``, itself the counterpart of
the reference ``deepspeed/runtime/weight_quantizer.py``): an offline
utility that quantizes a state dict for int8 storage or transport with
per-group symmetric scales, and the matching dequantize. Host-side numpy,
as in the JAX package, so both give the same bits; the inference engine's
int8 storage tier (``inference/engine.py``) quantizes each weight with
:meth:`WeightQuantization.quantize_value`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


class WeightQuantization:
    def __init__(self, mlp_extra_grouping: bool = False,
                 quantize_groups: int = 1, num_bits: int = 8):
        self.mlp_extra_grouping = mlp_extra_grouping
        self.quantize_groups = quantize_groups
        self.num_bits = num_bits

    def _groups_for(self, key: str) -> int:
        if self.mlp_extra_grouping and ("mlp" in key or "fc" in key):
            return self.quantize_groups * 2
        return self.quantize_groups

    def quantize_value(self, value: np.ndarray,
                       groups: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (int8 values, fp32 per-group scales)."""
        v = np.asarray(value, np.float32)
        flat = v.reshape(groups, -1)
        q_range = 2 ** (self.num_bits - 1) - 1
        scales = np.abs(flat).max(axis=1, keepdims=True) / q_range
        scales = np.where(scales == 0, 1.0, scales)
        q = np.clip(np.round(flat / scales), -q_range - 1,
                    q_range).astype(np.int8)
        return q.reshape(v.shape), scales.astype(np.float32)

    @staticmethod
    def dequantize_value(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
        groups = scales.shape[0]
        flat = q.astype(np.float32).reshape(groups, -1) * scales
        return flat.reshape(q.shape)

    def quantize_state_dict(self, sd: Dict[str, Any]
                            ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Quantize every matrix-valued entry; returns (quantized sd,
        {key: scales}) — the reference's (sd, all_scales) shape."""
        out: Dict[str, Any] = {}
        all_scales: Dict[str, np.ndarray] = {}
        for key, value in sd.items():
            if np.ndim(value) >= 2 and np.issubdtype(
                    np.asarray(value).dtype, np.floating):
                groups = self._groups_for(key)
                if np.asarray(value).size % groups != 0:
                    out[key] = value
                    continue
                q, scales = self.quantize_value(value, groups)
                out[key] = q
                all_scales[key] = scales
            else:
                out[key] = value
        return out, all_scales

    @staticmethod
    def dequantize_state_dict(sd: Dict[str, Any],
                              all_scales: Dict[str, np.ndarray],
                              dtype=np.float32) -> Dict[str, Any]:
        out = {}
        for key, value in sd.items():
            if key in all_scales:
                out[key] = WeightQuantization.dequantize_value(
                    value, all_scales[key]).astype(dtype)
            else:
                out[key] = value
        return out
