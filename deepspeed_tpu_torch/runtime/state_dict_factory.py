"""Model-parallel resharding of Megatron-style state dicts: the port of
``deepspeed_tpu/runtime/state_dict_factory.py``.

Load a checkpoint saved at one model-parallel degree and serve a shard for
another: merge saved shards when the target degree is lower, split one
when it is higher, each tensor along its ``get_layer_cat_dim`` dimension
(``checkpoint/deepspeed_checkpoint.py``: row-parallel weights on dim 1,
column-parallel weights and their biases on dim 0, norms and the other
known-replicated names whole). A fused ``query_key_value`` tensor of a
version-0 checkpoint holds [Q; K; V] per shard, so merging regroups the
thirds into [Q_all; K_all; V_all] and splitting cuts each third; versions
1.0 and 2.0 group by head, where a plain concatenation or cut is right.

Numpy in, numpy out: ``.npz`` files load with numpy, ``.pt`` files through
the checkpoint module's ``_torch_load`` (a ``weights_only`` load; full
unpickling only with ``DS_TRUST_CHECKPOINT=1``), bf16 tensors read as fp32.
The qkv test and the version-0 merge are that module's too.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

from ..checkpoint.deepspeed_checkpoint import (
    _is_qkv,
    _to_numpy,
    _torch_load,
    get_layer_cat_dim,
    merge_query_key_value,
)


class SDLoaderFactory:
    @staticmethod
    def get_sd_loader_json(json_file, checkpoint_engine=None):
        """A loader from a checkpoint description (a JSON file's path or
        its dict): ``type`` (default Megatron), ``checkpoints`` (the shard
        files, in model-parallel rank order), ``version``."""
        if isinstance(json_file, str):
            with open(json_file) as f:
                data = json.load(f)
        else:
            data = json_file
        sd_type = data.get("type", "Megatron")
        ckpt_list = data.get("checkpoints", [])
        version = data.get("version", 0.0)
        return SDLoaderFactory.get_sd_loader(ckpt_list, sd_type, version)

    @staticmethod
    def get_sd_loader(ckpt_list, sd_type: str = "Megatron", version=0.0):
        if sd_type.lower() == "megatron":
            return MegatronSDLoader(ckpt_list, version)
        raise ValueError(f"unknown sd_type {sd_type}")


def _load_file(path: str) -> Dict[str, Any]:
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        return {k: data[k] for k in data.files}
    sd = _torch_load(path)
    sd = sd.get("module", sd) if isinstance(sd, dict) else sd
    return {k: _to_numpy(v) if hasattr(v, "detach") else v
            for k, v in sd.items()}


class MegatronSDLoader:
    def __init__(self, ckpt_list: List[str], version=0.0):
        self.ckpt_list = list(ckpt_list)
        self.version = version

    @property
    def ckpt_mp_size(self) -> int:
        return len(self.ckpt_list)

    def load(self, mp_world_size: int, mp_rank: int,
             quantize: bool = False) -> Dict[str, Any]:
        """The state dict of ``mp_rank`` of ``mp_world_size``."""
        n = self.ckpt_mp_size
        if mp_world_size == n:
            return _load_file(self.ckpt_list[mp_rank])
        if mp_world_size < n:
            assert n % mp_world_size == 0, \
                f"cannot merge {n} shards into {mp_world_size}"
            per = n // mp_world_size
            shards = [_load_file(p) for p in
                      self.ckpt_list[mp_rank * per:(mp_rank + 1) * per]]
            return self.merge_state_dicts(shards)
        assert mp_world_size % n == 0, \
            f"cannot split {n} shards into {mp_world_size}"
        per = mp_world_size // n
        src = _load_file(self.ckpt_list[mp_rank // per])
        return self.split_state_dict(src, per, mp_rank % per)

    # -- merge / split ----------------------------------------------------
    def merge_state_dicts(self, shards: List[Dict[str, Any]]
                          ) -> Dict[str, Any]:
        merged: Dict[str, Any] = {}
        for key in shards[0]:
            values = [s[key] for s in shards]
            dim = get_layer_cat_dim(key)
            if dim is None or np.ndim(values[0]) == 0:
                merged[key] = values[0]
            elif _is_qkv(key):
                merged[key] = merge_query_key_value(values, self.version,
                                                    dim)
            else:
                merged[key] = np.concatenate(values, axis=dim)
        return merged

    def split_state_dict(self, sd: Dict[str, Any], num_splits: int,
                         split_idx: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in sd.items():
            dim = get_layer_cat_dim(key)
            if dim is None or np.ndim(value) == 0:
                out[key] = value
            elif _is_qkv(key):
                out[key] = self.split_query_key_value(value, num_splits,
                                                      split_idx, dim)
            else:
                assert value.shape[dim] % num_splits == 0, \
                    f"{key}: dim {dim} size {value.shape[dim]} not " \
                    f"divisible by {num_splits}"
                out[key] = np.split(value, num_splits, axis=dim)[split_idx]
        return out

    # -- the fused qkv by checkpoint version ------------------------------
    def split_query_key_value(self, value: np.ndarray, num_splits: int,
                              split_idx: int, dim: int = 0) -> np.ndarray:
        if float(self.version) >= 1.0:
            return np.split(value, num_splits, axis=dim)[split_idx]
        q, k, v = np.split(value, 3, axis=dim)
        return np.concatenate(
            [np.split(q, num_splits, axis=dim)[split_idx],
             np.split(k, num_splits, axis=dim)[split_idx],
             np.split(v, num_splits, axis=dim)[split_idx]], axis=dim)
