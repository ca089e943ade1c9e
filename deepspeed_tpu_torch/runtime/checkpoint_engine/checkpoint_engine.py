"""Checkpoint engines: the port of ``deepspeed_tpu/runtime/checkpoint_engine/
checkpoint_engine.py``, writing the JAX engine's files.

:class:`ArrayCheckpointEngine` flattens a nested state dict into "/"-joined
keys and writes

* ``<path>.npz``: every array leaf, named ``a{i}`` in the sorted order of
  the keys;
* ``<path>.meta``: a pickle of ``{"index": {"a{i}": key}, "others": {key:
  non-array leaf}, "dtypes": {key: dtype name}}``.

Leaves may be torch tensors (copied to the host), numpy arrays or scalars.
A dtype numpy does not have (``bfloat16``, the ``float8`` types) is stored
as the unsigned integer view of its bytes with its name in ``dtypes``, as
the JAX engine stores its ``ml_dtypes`` arrays, so either package reads
the other's files. :meth:`ArrayCheckpointEngine.load` gives those leaves
back as torch tensors of that dtype (a byte view, no ``ml_dtypes``) and
every other array as a numpy array.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ...utils.logging import log_dist, logger

__all__ = ["CheckpointEngine", "ArrayCheckpointEngine", "write_latest",
           "read_latest", "checkpoint_meta_path", "as_numpy"]

_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint8", "uint16", "uint32", "uint64", "bool")
# stored views (the JAX engine's) and the torch views that make them
_VIEW_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_SIGNED = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16),
           4: (np.int32, torch.int32)}


class CheckpointEngine:
    def __init__(self, config_params=None):
        pass

    def create(self, tag: str) -> None:
        """Hook for per-tag setup (log/start async session)."""
        log_dist(f"[DSTPU] Saving checkpoint tag {tag}", ranks=[0])

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def save(self, state_dict: Any, path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Any:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Mark all saves for ``tag`` durable (the ``latest`` protocol relies
        on this ordering)."""
        return True


def _flatten_state_dict(sd: Any, prefix: str = "") -> dict:
    flat = {}
    if isinstance(sd, dict):
        for k, v in sd.items():
            flat.update(_flatten_state_dict(v, f"{prefix}{k}/"))
    elif isinstance(sd, (list, tuple)):
        for i, v in enumerate(sd):
            flat.update(_flatten_state_dict(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = sd
    return flat


def _stored(value):
    """(numpy array as stored, dtype name to record or None) for an array
    leaf; ValueError for a leaf that goes to the pickle instead."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name in _NATIVE:
            return t.numpy(), None
        size = t.element_size()
        return t.view(_SIGNED[size][1]).numpy().view(_VIEW_DTYPES[size]), name
    arr = np.asarray(value)
    if arr.dtype.kind in "OUSV":
        raise ValueError
    if arr.dtype.name not in _NATIVE:      # an ml_dtypes array
        return arr.view(_VIEW_DTYPES[arr.dtype.itemsize]), arr.dtype.name
    return arr, None


def as_numpy(value, dtype=None) -> np.ndarray:
    """A loaded leaf (numpy array, scalar or torch tensor of any dtype) as a
    numpy array, cast to ``dtype`` when given (a bf16 tensor through fp32)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if str(t.dtype).replace("torch.", "") not in _NATIVE:
            t = t.float()
        value = t.numpy()
    return np.asarray(value, dtype=dtype)


class ArrayCheckpointEngine(CheckpointEngine):
    """Default synchronous engine: one ``.npz`` of arrays + a pickle for
    non-array leaves (the torch.save analog, torch_checkpoint_engine.py:12)."""

    def save(self, state_dict: Any, path: str) -> None:
        arrays, dtypes, others = {}, {}, {}
        for k, v in _flatten_state_dict(state_dict).items():
            if v is None:
                others[k] = None
                continue
            try:
                arrays[k], name = _stored(v)
            except (ValueError, TypeError):
                others[k] = v
                continue
            if name is not None:
                dtypes[k] = name
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # npz keys can't contain some chars on all systems; index them
        keys = sorted(arrays)
        index = {f"a{i}": k for i, k in enumerate(keys)}
        np.savez(path + ".npz", **{f"a{i}": arrays[k]
                                   for i, k in enumerate(keys)})
        with open(path + ".meta", "wb") as fh:
            pickle.dump({"index": index, "others": others, "dtypes": dtypes},
                        fh)
        logger.debug(f"saved checkpoint shard {path}")

    def load(self, path: str, map_location=None) -> dict:
        with open(path + ".meta", "rb") as fh:
            meta = pickle.load(fh)
        data = np.load(path + ".npz", allow_pickle=False)
        dtypes = meta.get("dtypes", {})
        flat = {}
        for ak, key in meta["index"].items():
            arr = data[ak]
            if key in dtypes:
                np_view, torch_view = _SIGNED[arr.dtype.itemsize]
                arr = torch.from_numpy(arr.view(np_view)).view(
                    torch_view).view(getattr(torch, dtypes[key]))
            flat[key] = arr
        flat.update(meta["others"])
        # unflatten into nested dicts
        nested: dict = {}
        for key, value in flat.items():
            parts = key.split("/")
            d = nested
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = value
        return nested


def write_latest(save_dir: str, tag: str) -> None:
    """``latest`` tag file protocol (reference engine.py:3045)."""
    with open(os.path.join(save_dir, "latest"), "w") as fh:
        fh.write(tag)


def read_latest(load_dir: str) -> str:
    latest_path = os.path.join(load_dir, "latest")
    with open(latest_path, "r") as fh:
        return fh.read().strip()


def checkpoint_meta_path(save_dir: str, tag: str, kind: str, mp_rank: int = 0,
                         dp_rank: int = 0) -> str:
    """Reference checkpoint naming (engine.py:2485-2503):
    ``mp_rank_XX_model_states`` / ``zero_pp_rank_X_mp_rank_XX_optim_states``."""
    if kind == "model":
        name = f"mp_rank_{mp_rank:02d}_model_states"
    elif kind == "optim":
        name = f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states"
    else:
        raise ValueError(kind)
    return os.path.join(save_dir, str(tag), name)
