"""Universal checkpoint: the port of ``deepspeed_tpu/checkpoint/
universal_checkpoint.py`` (numpy and the standard library).

The offline ``ds_to_universal`` conversion writes a checkpoint loadable at
any parallelism layout: one entry per parameter, fp32 master weights plus
each optimizer-moment tree, with a JSON meta for counters, the same files
as the JAX package's. The source is the single-host file of
``engine.save_checkpoint`` (the port saves whole tensors, as the JAX engine
saves whole logical arrays); ``engine.load_universal_checkpoint`` reads it
back into a fresh engine at any ZeRO stage. The JAX package's
multi-process orbax layout is not ported, and its converter raises; nor
is the JAX converter's branch for host-offloaded optimizer state, which the
port's engine has no counterpart for.

Layout::

    <dir>/<tag>_universal/
        meta.json           # step/opt_step/counters, param shapes+dtypes
        fp32.npz            # master weights (param path → fp32 array)
        opt_<name>.npz      # one per optimizer-moment tree (exp_avg, ...)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ..runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine,
    as_numpy,
    checkpoint_meta_path,
    read_latest,
)
from ..utils.logging import log_dist

UNIVERSAL_SUFFIX = "_universal"


def _flatten(tree: Any, prefix: str = "", sep: str = "/") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}{sep}", sep))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}{sep}", sep))
    else:
        flat[prefix[:-len(sep)] if prefix else prefix] = tree
    return flat


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return nested


def _save_tree_npz(path: str, tree: Any) -> Dict[str, str]:
    """Flatten an array tree into an npz; returns {index_key: param_path}."""
    flat = {k: as_numpy(v, np.float32)
            for k, v in _flatten(tree).items() if v is not None}
    index = {f"a{i}": k for i, k in enumerate(sorted(flat))}
    np.savez(path, **{f"a{i}": flat[k]
                      for i, k in enumerate(sorted(flat))})
    return index


def _load_tree_npz(path: str, index: Dict[str, str]) -> Dict[str, Any]:
    data = np.load(path, allow_pickle=False)
    return _unflatten({param_path: data[ak] for ak, param_path in index.items()})


def universal_dir(base_dir: str, tag: str) -> str:
    return os.path.join(base_dir, str(tag) + UNIVERSAL_SUFFIX)


def _orbax_to_state_dict(ckpt_dir: str, tag: str,
                         orbax_path: str) -> Dict[str, Any]:
    """The JAX package reads its multi-process orbax layout here; that
    layout is not ported."""
    raise NotImplementedError(
        f"{orbax_path}: orbax (multi-process) checkpoints are not ported to "
        "the PyTorch/CUDA package")


def ds_to_universal(ckpt_dir: str, tag: Optional[str] = None,
                    output_dir: Optional[str] = None) -> str:
    """Convert a saved checkpoint into the universal format — the analog of
    the reference's ``ds_to_universal.py`` offline tool. Returns the
    universal dir path."""
    if tag is None:
        tag = read_latest(ckpt_dir)
    pickle_path = checkpoint_meta_path(ckpt_dir, tag, "model",
                                       mp_rank=0, dp_rank=0)
    orbax_path = os.path.join(ckpt_dir, str(tag), "orbax_state")
    if os.path.exists(pickle_path + ".meta"):
        engine = ArrayCheckpointEngine()
        sd = engine.load(pickle_path)
    elif os.path.isdir(orbax_path):
        # multi-process saves (engine.save_checkpoint orbax branch) store a
        # sharded array tree + meta sidecar; map it onto the single-file
        # state-dict shape this converter consumes
        sd = _orbax_to_state_dict(ckpt_dir, tag, orbax_path)
    else:
        raise FileNotFoundError(
            f"no checkpoint at {ckpt_dir}/{tag}: neither "
            f"{pickle_path}.meta nor {orbax_path} exists")
    out = universal_dir(output_dir or ckpt_dir, tag)
    os.makedirs(out, exist_ok=True)

    # fp32 master weights; fall back to (upcast) module params when training
    # ran without a separate master copy (pure fp32 runs)
    master = sd.get("master")
    source = master if master else sd["module"]
    fp32_index = _save_tree_npz(os.path.join(out, "fp32.npz"), source)

    # each field of the optimizer state aligned with params (AdamState:
    # exp_avg / exp_avg_sq)
    opt_indices: Dict[str, Dict[str, str]] = {}
    for key, sub in (sd.get("optimizer") or {}).items():
        if sub is not None:
            opt_indices[str(key)] = _save_tree_npz(
                os.path.join(out, f"opt_{key}.npz"), sub)

    def as_int(v, default=0):
        return int(np.asarray(v)) if v is not None else default

    def jsonify(v):
        if isinstance(v, dict):
            return {k: jsonify(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [jsonify(x) for x in v]
        if isinstance(v, np.ndarray):
            return v.item() if v.ndim == 0 else v.tolist()
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        return v

    meta = {
        "tag": str(tag),
        "step": as_int(sd.get("step")),
        "opt_step": as_int(sd.get("opt_step", sd.get("step"))),
        "global_steps": as_int(sd.get("global_steps")),
        "global_samples": as_int(sd.get("global_samples")),
        "micro_steps": as_int(sd.get("micro_steps")),
        "skipped_steps": as_int(sd.get("skipped_steps")),
        "lr_scheduler": jsonify(sd.get("lr_scheduler")),
        "fp32_index": fp32_index,
        "opt_indices": opt_indices,
        "source_dp_world_size": as_int(sd.get("dp_world_size"), 1),
        "source_mp_world_size": as_int(sd.get("mp_world_size"), 1),
    }
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    log_dist(f"wrote universal checkpoint {out}", ranks=[0])
    return out


def load_universal(univ_dir: str) -> Dict[str, Any]:
    """Read a universal checkpoint dir → {meta, fp32, opt:{name: tree}}."""
    with open(os.path.join(univ_dir, "meta.json")) as f:
        meta = json.load(f)
    fp32 = _load_tree_npz(os.path.join(univ_dir, "fp32.npz"),
                          meta["fp32_index"])
    opt = {name: _load_tree_npz(os.path.join(univ_dir, f"opt_{name}.npz"), idx)
           for name, idx in meta.get("opt_indices", {}).items()}
    return {"meta": meta, "fp32": fp32, "opt": opt}
