"""Weight bridge: the JAX package's ``TransformerLM`` parameter tree to the
port's ``state_dict``.

The input is the flax ``params`` tree as nested dicts of numpy arrays (the
caller converts device arrays with ``np.asarray``); nothing here imports
JAX. The mapping:

* the scanned stack ``blocks/block/...`` carries a leading layer dim L,
  split into ``blocks.{l}....``;
* a Dense ``kernel`` (in, out) becomes ``Linear.weight`` (out, in);
  ``bias`` carries over;
* a LayerNorm/RMSNorm ``scale`` becomes ``weight``;
* ``embed_tokens/embedding`` and ``embed_pos/embedding`` carry over;
* ``lm_head/kernel`` (C, V) becomes ``lm_head.weight`` (V, C).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.transformer_lm import TransformerConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _leaf(path: str, arr: np.ndarray):
    """(torch-side suffix, tensor-ready array) for one flax leaf name."""
    *mods, name = path.split("/")
    mod = ".".join(mods)
    if name == "kernel":
        return f"{mod}.weight", np.ascontiguousarray(arr.T)
    if name in ("scale", "embedding"):
        return f"{mod}.weight", arr
    if name == "bias":
        return f"{mod}.bias", arr
    raise KeyError(f"unknown flax parameter leaf {path!r}")


def state_dict_from_flax(cfg: TransformerConfig,
                         params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM(cfg).state_dict()`` from a flax params
    tree, in ``cfg.dtype``. Raises on a leaf the bridge does not know or a
    layer count that disagrees with ``cfg.n_layer``."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        if path.startswith("blocks/block/"):
            if arr.shape[0] != cfg.n_layer:
                raise ValueError(f"{path}: leading dim {arr.shape[0]} != "
                                 f"n_layer {cfg.n_layer}")
            for li in range(cfg.n_layer):
                key, val = _leaf(path[len("blocks/block/"):], arr[li])
                sd[f"blocks.{li}.{key}"] = val
        else:
            key, val = _leaf(path, arr)
            sd[key] = val
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(cfg.dtype)
            for k, v in sd.items()}
