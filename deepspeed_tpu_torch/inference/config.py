"""Inference config (port of ``deepspeed_tpu/inference/config.py``): the same
JSON surface as a plain dataclass.

Keys for features this port does not have yet raise instead of being
ignored: tensor parallelism above 1, ZeRO-Inference and the injection
policy. ``checkpoint`` (a path, a dict or None) parses and is recorded, as
in the JAX package, where no code reads it either.
Weight quantization (``dtype="int8"`` or ``quant.enabled``) is
accepted; the engine serves it through the int8 compute tier or raises for
the storage tier it has no kernel for.

``enable_cuda_graph`` (default False, as in both packages) is the switch
for the captured decode step: with it the engine replays every one-token
decode step (``decode``, ``decode_paged``, ``generate()``'s loop, and so
every serving decode step) from a CUDA graph captured per signature
(``decode_graph.py``), or raises if the step cannot be captured; on a CPU
engine the same static-buffer step runs eagerly. ``use_triton`` and
``triton_autotune`` parse as they do in the JAX package, where they are
no-ops; they mean nothing to a port whose kernels are hand-written CUDA
C++, and are recorded only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16,
           # int8 weights: activations in bf16 (the JAX jnp_dtype)
           "int8": torch.bfloat16}
_QUANT_DEFAULTS = {"enabled": False, "bits": 8, "group_size": 0}

# key -> the value that means "off" (anything else raises)
_NOT_PORTED = {"zero": {}, "injection_policy": None}


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"  # float32 | float16 | bfloat16 | int8
    tensor_parallel: Dict[str, Any] = dataclasses.field(default_factory=dict)
    quant: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_batch_size: Optional[int] = None
    replace_method: str = "auto"
    replace_with_kernel_inject: bool = False
    return_tuple: bool = True
    # recorded, no effect (module docstring)
    checkpoint: Union[str, Dict[str, Any], None] = None
    # capture and replay the decode step (module docstring)
    enable_cuda_graph: bool = False
    # accepted and recorded, no-ops (module docstring)
    use_triton: bool = False
    triton_autotune: bool = False
    # sampling defaults for generate() and serving
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    @classmethod
    def from_dict(cls, cfg: Optional[Dict[str, Any]]) -> \
            "DeepSpeedInferenceConfig":
        cfg = dict(cfg or {})
        for alias, key in (("tp", "tensor_parallel"),
                           ("max_tokens", "max_out_tokens"),
                           ("kernel_inject", "replace_with_kernel_inject")):
            if alias in cfg:
                cfg[key] = cfg.pop(alias)
        if "mp_size" in cfg:
            cfg.setdefault("tensor_parallel", {})["tp_size"] = \
                cfg.pop("mp_size")
        for key, off in _NOT_PORTED.items():
            if key in cfg and cfg.pop(key) != off:
                raise NotImplementedError(
                    f"inference config key {key!r} is not ported to the "
                    f"PyTorch/CUDA package yet")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(cfg) - names)
        if unknown:
            raise ValueError(f"unknown inference config keys {unknown}")
        out = cls(**cfg)
        if int(out.tensor_parallel.get("tp_size", 1)) != 1:
            raise NotImplementedError("tensor parallelism is not ported yet")
        unknown = sorted(set(out.quant) - set(_QUANT_DEFAULTS))
        if unknown:
            raise ValueError(f"unknown quant keys {unknown}; expected "
                             f"{sorted(_QUANT_DEFAULTS)}")
        out.quant = {**_QUANT_DEFAULTS, **out.quant}
        out.torch_dtype()
        return out

    @property
    def quant_enabled(self) -> bool:
        """Weight-only int8: ``quant.enabled`` or ``dtype="int8"`` (the JAX
        engine's ``_quant_enabled``)."""
        return bool(self.quant.get("enabled")) or "int8" in str(self.dtype)

    @property
    def mp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1))

    def torch_dtype(self) -> torch.dtype:
        key = str(self.dtype).replace("torch.", "")
        if key not in _DTYPES:
            raise ValueError(f"unsupported inference dtype {self.dtype!r}; "
                             f"supported: {sorted(_DTYPES)}")
        return _DTYPES[key]
