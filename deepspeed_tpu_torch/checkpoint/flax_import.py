"""Weight bridges: the JAX package's ``TransformerLM`` and
``GPT2LMHeadModel`` parameter trees to the port's ``state_dict``s.

The input is the flax ``params`` tree as nested dicts of numpy arrays (the
caller converts device arrays with ``np.asarray``); nothing here imports
JAX. The mapping:

* the scanned stack ``blocks/block/...`` carries a leading layer dim L,
  split into ``blocks.{l}....``;
* a Dense ``kernel`` (in, out) becomes ``Linear.weight`` (out, in);
  ``bias`` carries over;
* a LayerNorm/RMSNorm ``scale`` becomes ``weight``;
* ``embed_tokens/embedding`` and ``embed_pos/embedding`` carry over;
* ``lm_head/kernel`` (C, V) becomes ``lm_head.weight`` (V, C);
* a JAX ``QuantDense`` (the int8 tier's ``quantize_lm_params`` tree) has an
  int8 ``kernel`` (K, N_pad) and an fp32 ``scale`` (1, N_pad), its feature
  count padded to 128 lanes; they become the port's ``QuantDense.weight``
  (N, K) int8 and ``scale`` (N,) fp32 with the pad columns (zero weights,
  scale 1) dropped, for a model built with ``int8_weights=True``.

GPT-2 (:func:`gpt2_state_dict_from_flax`) has ``wte``/``wpe`` embeddings,
the scanned ``blocks/block/{ln_1, attn/qkv, attn/proj, ln_2, mlp/fc,
mlp/proj}`` and ``ln_f``, mapped by the same rules. The JAX model's tree is
the same with ``fused_ln_linear=True`` (its ``_LNParams``/``_DenseParams``
register the same names), so one bridge serves both arms.

:func:`engine_checkpoint_from_flax` turns a whole checkpoint the JAX
engine saved into the port engine's: its module, master weights and every
optimizer moment go leaf by leaf through these rules, the step counters,
loss scale and schedule carry over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.transformer_lm import TransformerConfig
from ..ops.quantization.convert import DENSE_KEYS
from ..runtime.checkpoint_engine.checkpoint_engine import as_numpy


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = as_numpy(val)
    return out


def _features(cfg: TransformerConfig, dense: str) -> int:
    """A projection's true output features (a QuantDense stores them padded
    to 128 in the JAX tree)."""
    hidden = int(cfg.mlp_ratio * cfg.n_embd)
    return {"q_proj": cfg.n_head * cfg.head_dim,
            "k_proj": cfg.kv_heads * cfg.head_dim,
            "v_proj": cfg.kv_heads * cfg.head_dim,
            "o_proj": cfg.n_embd, "gate_proj": hidden, "up_proj": hidden,
            "down_proj": cfg.n_embd, "lm_head": cfg.vocab_size}[dense]


def _leaf(cfg: TransformerConfig, path: str, arr: np.ndarray):
    """(torch-side suffix, tensor-ready array) for one flax leaf name."""
    *mods, name = path.split("/")
    mod = ".".join(mods)
    quant = mods and mods[-1] in DENSE_KEYS
    if name == "kernel" and arr.dtype == np.int8:
        n = _features(cfg, mods[-1])
        return f"{mod}.weight", np.ascontiguousarray(arr[:, :n].T)
    if name == "kernel":
        return f"{mod}.weight", np.ascontiguousarray(arr.T)
    if name == "scale" and quant:             # a QuantDense channel scale
        return f"{mod}.scale", arr.reshape(-1)[:_features(cfg, mods[-1])]
    if name in ("scale", "embedding"):
        return f"{mod}.weight", arr
    if name == "bias":
        return f"{mod}.bias", arr
    raise KeyError(f"unknown flax parameter leaf {path!r}")


def _tensor(cfg: TransformerConfig, key: str, arr: np.ndarray):
    """int8 weights stay int8 and channel scales fp32; every other leaf
    takes ``cfg.dtype``."""
    if arr.dtype == np.int8:
        return torch.from_numpy(np.array(arr))
    out = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out if key.endswith(".scale") else out.to(cfg.dtype)


def _lm_arrays(cfg: TransformerConfig,
               params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``TransformerLM`` names -> arrays, in the flax leaves' dtypes."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        if path.startswith("blocks/block/"):
            if arr.shape[0] != cfg.n_layer:
                raise ValueError(f"{path}: leading dim {arr.shape[0]} != "
                                 f"n_layer {cfg.n_layer}")
            for li in range(cfg.n_layer):
                key, val = _leaf(cfg, path[len("blocks/block/"):], arr[li])
                sd[f"blocks.{li}.{key}"] = val
        else:
            key, val = _leaf(cfg, path, arr)
            sd[key] = val
    return sd


def state_dict_from_flax(cfg: TransformerConfig,
                         params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM(cfg).state_dict()`` from a flax params
    tree, in ``cfg.dtype`` (int8 weights and their fp32 scales as they
    are). Raises on a leaf the bridge does not know or a layer count that
    disagrees with ``cfg.n_layer``."""
    return {k: _tensor(cfg, k, v) for k, v in _lm_arrays(cfg, params).items()}


def gpt2_state_dict_from_flax(cfg, params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The port's ``GPT2LMHeadModel(cfg).state_dict()`` (fp32) from a JAX
    GPT-2 params tree of numpy arrays; raises on an unknown leaf or a
    layer count that disagrees with ``cfg.n_layer``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        if path.startswith("blocks/block/"):
            if arr.shape[0] != cfg.n_layer:
                raise ValueError(f"{path}: leading dim {arr.shape[0]} != "
                                 f"n_layer {cfg.n_layer}")
            layers = [(f"blocks.{li}.", arr[li]) for li in range(cfg.n_layer)]
            path = path[len("blocks/block/"):]
        else:
            layers = [("", arr)]
        *mods, name = path.split("/")
        if name not in ("kernel", "bias", "scale", "embedding"):
            raise KeyError(f"unknown flax parameter leaf {path!r}")
        suffix = "bias" if name == "bias" else "weight"
        for prefix, val in layers:
            if name == "kernel":
                val = val.T
            sd[f"{prefix}{'.'.join(mods)}.{suffix}"] = torch.from_numpy(
                np.array(val, dtype=np.float32))
    return sd


def _fp32_state_dict(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if isinstance(cfg, TransformerConfig):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in _lm_arrays(cfg, tree).items()}
    return gpt2_state_dict_from_flax(cfg, tree)


_CARRIED = ("step", "opt_step", "scale", "global_steps", "global_samples",
            "micro_steps", "skipped_steps", "dp_world_size", "mp_world_size",
            "lr_scheduler", "client_state")


def engine_checkpoint_from_flax(cfg, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The port engine's checkpoint dict from one the JAX engine saved
    (``ArrayCheckpointEngine.load`` of its ``mp_rank_00_model_states``, in
    either package), for ``GPT2LMHeadModel(cfg)`` (a ``GPT2Config``) or
    ``TransformerLM(cfg)``: ``module`` through the model's bridge (GPT-2
    fp32, ``TransformerLM`` in ``cfg.dtype``); ``master`` and each
    optimizer field (``exp_avg``, ``exp_avg_sq``, ...) leaf by leaf through
    the same rules, in fp32; the counters, loss scale, schedule and client
    state as they are. Save it with the port's ``ArrayCheckpointEngine``
    and ``engine.load_checkpoint`` resumes the run.

    ``rng`` is left out: the JAX engine's is a PRNG key, which no torch
    generator state can stand for, so the loading engine keeps its own
    model's dropout generator. The offloaded-optimizer and one-bit states
    are not ported and raise."""
    for key in ("offload_optimizer", "onebit"):
        if sd.get(key) is not None:
            raise NotImplementedError(f"the checkpoint holds {key!r} state, "
                                      f"which the port has no engine for")
    module = sd["module"]
    if isinstance(cfg, TransformerConfig):
        module_sd = state_dict_from_flax(cfg, module)
    else:
        module_sd = gpt2_state_dict_from_flax(cfg, module)
    master = sd.get("master")
    optimizer = sd.get("optimizer")
    out = {"module": module_sd,
           "master": _fp32_state_dict(cfg, master) if master else None,
           "optimizer": {str(field): _fp32_state_dict(cfg, tree)
                         for field, tree in optimizer.items()}
           if optimizer else None,
           "offload_optimizer": None, "onebit": None, "rng": None}
    out.update({key: sd[key] for key in _CARRIED if key in sd})
    return out
