"""Reader / reshaper for reference-format (Megatron-DeepSpeed) checkpoints:
the port's copy of ``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``,
with the version-aware qkv merge of the JAX ``runtime/state_dict_factory.py``
``MegatronSDLoader`` (:129-150) kept here as two functions.

Capability parity with reference
``deepspeed/checkpoint/deepspeed_checkpoint.py:33 DeepSpeedCheckpoint`` — an
abstraction over a 3D (tp, pp, dp) checkpoint directory: degree discovery,
per-layer file maps, tp-merge of embedding/transformer/final-norm states.
Doubles as the **migration path** from the reference framework: it reads
torch ``.pt`` checkpoint dirs (torch is available CPU-only) and can emit
this framework's universal format via :func:`to_universal`.

TP merge heuristics (reference state_dict_factory.py:190 MegatronSDLoader):
column-parallel params (qkv, mlp up / h_to_4h) concatenate on dim 0;
row-parallel (attention output dense, mlp down / 4h_to_h) on dim 1;
everything else must be replicated and takes rank 0's copy.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.logging import logger
from .reshape_3d_utils import (
    LAYER_FILE_PREFIX,
    MODEL_FILE_PREFIX,
    get_model_3d_descriptor,
)
from .reshape_utils import (
    basic_folder_validation,
    get_files,
    get_files_with_prefix,
    merge_state_dicts,
    partition_data,
)

EMBEDDING_LAYER_INDEX = 0
FINAL_LAYER_NORM_INDEX = -1
ARGS_KEY = "args"
CHECKPOINT_INFO_KEY = "checkpoint_info"
ITERATION_KEY = "iteration"

SEQUENTIAL_LAYERS = [
    "input_layernorm.weight", "input_layernorm.bias",
    "self_attention.dense.bias", "attention.dense.bias",
    "post_attention_layernorm.weight", "post_attention_layernorm.bias",
    "mlp.dense_4h_to_h.bias", "position_embeddings.weight",
]
# param-name suffix → concat dim for TP merge
LAYER_CONCAT_DIM = {
    "self_attention.dense.weight": 1,
    "attention.dense.weight": 1,
    "mlp.dense_4h_to_h.weight": 1,
}
_DEFAULT_COL_PARALLEL_DIM = 0


def _to_numpy(value):
    if hasattr(value, "detach"):  # torch tensor
        t = value.detach().cpu()
        if t.dtype.is_floating_point and t.element_size() == 2 \
                and "bfloat16" in str(t.dtype):
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _torch_load(path: str) -> Dict[str, Any]:
    """Load a reference-format .pt checkpoint.

    Prefers ``weights_only=True`` (no arbitrary-code unpickling) with the
    Megatron ``args`` Namespace allowlisted; only on failure falls back to
    full unpickling, which EXECUTES code embedded in the file — reference
    checkpoints routinely carry custom classes, but only fall through for
    files you trust.
    """
    import argparse

    import torch

    try:
        if hasattr(torch.serialization, "add_safe_globals"):
            torch.serialization.add_safe_globals([argparse.Namespace])
        return torch.load(path, map_location="cpu", weights_only=True)
    except TypeError:
        # torch < 1.13: no weights_only kwarg — plain load, as before
        return torch.load(path, map_location="cpu")
    except (pickle.UnpicklingError, RuntimeError) as e:
        # torch raises UnpicklingError on some versions, RuntimeError on
        # others, for weights_only failures (OSError/FileNotFoundError pass
        # through unchanged); the unsafe fallback requires explicit opt-in.
        # Unrelated RuntimeErrors (e.g. a truncated zip) propagate as-is —
        # retrying them unsafely is futile and the opt-in hint misleading.
        msg = str(e)
        if isinstance(e, RuntimeError) and \
                "Weights only load failed" not in msg and \
                "Unsupported global" not in msg and \
                "weights_only" not in msg:
            raise
        if os.environ.get("DS_TRUST_CHECKPOINT") != "1":
            raise RuntimeError(
                f"{path} failed the weights_only safe load ({e}). Full "
                "unpickling EXECUTES code embedded in the checkpoint; if you "
                "trust this file, set DS_TRUST_CHECKPOINT=1 to allow it."
            ) from e
        logger.warning(
            "%s failed the weights_only safe load (%s); DS_TRUST_CHECKPOINT=1 "
            "set — falling back to full unpickling, which EXECUTES code "
            "embedded in the checkpoint.", path, e)
        return torch.load(path, map_location="cpu", weights_only=False)


def _is_qkv(key: str) -> bool:
    return "query_key_value" in key or "qkv" in key


def merge_query_key_value(values: List[np.ndarray], version: float,
                          dim: int = 0) -> np.ndarray:
    """Megatron qkv layouts by checkpoint version (reference
    state_dict_factory.py:220): version 0 stores [Q_shard; K_shard;
    V_shard] fused per shard → merging must split each shard into
    thirds and regroup so the result is [Q_all; K_all; V_all];
    versions 1.0/2.0 store per-head-grouped layouts where a plain
    concat over shards is already correct."""
    if float(version) >= 1.0:
        return np.concatenate(values, axis=dim)
    qs, ks, vs = [], [], []
    for v in values:
        q, k, u = np.split(v, 3, axis=dim)
        qs.append(q)
        ks.append(k)
        vs.append(u)
    return np.concatenate(
        [np.concatenate(qs, axis=dim), np.concatenate(ks, axis=dim),
         np.concatenate(vs, axis=dim)], axis=dim)


def get_layer_cat_dim(key: str) -> Optional[int]:
    """TP concat dim for a param name; None = replicated. Norm params and
    the known-replicated suffixes stay whole; row-parallel weights merge on
    dim 1; column-parallel weights AND their biases (qkv, h_to_4h,
    embeddings) merge on dim 0."""
    for suffix in SEQUENTIAL_LAYERS:
        if key.endswith(suffix):
            return None
    for suffix, dim in LAYER_CONCAT_DIM.items():
        if key.endswith(suffix):
            return dim
    if "layernorm" in key.lower() or ".norm." in key or \
            key.endswith("norm.weight") or key.endswith("norm.bias"):
        return None
    return _DEFAULT_COL_PARALLEL_DIM


class DeepSpeedCheckpoint:
    def __init__(self, dir: str, tp_degree: Optional[int] = None,
                 pp_degree: Optional[int] = None,
                 dp_degree: Optional[int] = None):
        self.dir = dir
        basic_folder_validation(dir)
        self.file_list = get_files(dir)
        self.layer_files = get_files_with_prefix(self.file_list,
                                                 LAYER_FILE_PREFIX)
        self.mp_rank_files = get_files_with_prefix(self.file_list,
                                                   MODEL_FILE_PREFIX)
        self.layer_keys = self._get_layer_keys()

        src = get_model_3d_descriptor(dir)
        self.zero_checkpoint_desc = src
        self.original_tp_degree = src.tp_degree
        self.original_pp_degree = max(src.pp_degree, 1)
        self.original_dp_degree = src.dp_degree
        self.tp_degree = tp_degree if tp_degree is not None \
            else self.original_tp_degree
        self.pp_degree = pp_degree if pp_degree is not None \
            else self.original_pp_degree
        self.dp_degree = dp_degree if dp_degree is not None \
            else self.original_dp_degree
        self.global_state: Dict[str, Any] = {}

        self.tp_to_embedding_map = self._build_tp_other_layer_map(
            EMBEDDING_LAYER_INDEX)
        self.tp_to_final_norm_map = self._build_tp_other_layer_map(
            FINAL_LAYER_NORM_INDEX)
        self.pp_to_transformer_map = self._build_pp_transformer_map()
        self.transformer_file_map = self._build_transformer_file_map()

    # -- degree queries ---------------------------------------------------
    def is_change_tp_degree(self) -> bool:
        return self.tp_degree != self.original_tp_degree

    def is_change_pp_degree(self) -> bool:
        return self.pp_degree != self.original_pp_degree

    def is_change_dp_degree(self) -> bool:
        return self.dp_degree != self.original_dp_degree

    # -- mapping construction ---------------------------------------------
    def _get_layer_keys(self) -> List[str]:
        key_set = set()
        for file_path in self.layer_files:
            m = re.search(rf"{LAYER_FILE_PREFIX}(\d+)",
                          os.path.basename(file_path))
            if m:
                key_set.add(m.group(1))
        return sorted(key_set, key=int)

    def _build_tp_other_layer_map(self, layer_index: int) -> Dict[int, List[str]]:
        if not self.layer_keys:
            return {}
        layer_key = self.layer_keys[layer_index]
        layer_files = get_files_with_prefix(
            self.layer_files, f"{LAYER_FILE_PREFIX}{layer_key}")
        partitions = partition_data(layer_files, self.tp_degree)
        return {i: partitions[i] for i in range(self.tp_degree)}

    def _build_pp_transformer_map(self) -> Dict[int, List[str]]:
        if not self.layer_keys:
            return {}
        transformer_keys = self.layer_keys[1:-1]
        # contiguous split covering every layer (early stages take the
        # remainder) — a floor split would silently drop trailing layers
        n = len(transformer_keys)
        base, rem = divmod(n, self.pp_degree)
        out: Dict[int, List[str]] = {}
        start = 0
        for i in range(self.pp_degree):
            count = base + (1 if i < rem else 0)
            out[i] = transformer_keys[start:start + count]
            start += count
        return out

    def _build_transformer_file_map(self) -> Dict[tuple, List[str]]:
        file_map: Dict[tuple, List[str]] = {}
        for pp_index, layer_keys in self.pp_to_transformer_map.items():
            for layer_key in layer_keys:
                layer_files = get_files_with_prefix(
                    self.layer_files, f"{LAYER_FILE_PREFIX}{layer_key}")
                partitions = partition_data(layer_files, self.tp_degree)
                for tp_index in range(self.tp_degree):
                    file_map.setdefault((tp_index, pp_index), [])
                    file_map[(tp_index, pp_index)] += partitions[tp_index]
        return file_map

    # -- state access -----------------------------------------------------
    def _merge_tp_files(self, files: List[str]) -> Dict[str, np.ndarray]:
        sds = [{k: _to_numpy(v) for k, v in _torch_load(f).items()
                if not k.startswith("_")} for f in files]
        if len(sds) == 1:
            return sds[0]
        return merge_state_dicts(sds, cat_dim_fn=get_layer_cat_dim)

    def get_embedding_state(self, tp_index: int) -> Dict[str, np.ndarray]:
        assert tp_index in self.tp_to_embedding_map
        return self._merge_tp_files(self.tp_to_embedding_map[tp_index]) \
            if len(self.tp_to_embedding_map[tp_index]) > 1 else \
            {k: _to_numpy(v)
             for k, v in _torch_load(self.tp_to_embedding_map[tp_index][0]).items()}

    def get_embedding_files(self, tp_index: int) -> List[str]:
        return self.tp_to_embedding_map[tp_index]

    def get_final_norm_state(self, tp_index: int) -> Dict[str, np.ndarray]:
        return {k: _to_numpy(v)
                for k, v in _torch_load(
                    self.tp_to_final_norm_map[tp_index][0]).items()}

    def get_final_norm_files(self, tp_index: int) -> List[str]:
        return self.tp_to_final_norm_map[tp_index]

    def get_transformer_state(self, tp_index: int,
                              pp_index: int) -> List[Dict[str, np.ndarray]]:
        t_list = []
        for fname in self.transformer_file_map[(tp_index, pp_index)]:
            sd = _torch_load(fname)
            t_list.append({k: _to_numpy(v) for k, v in sd.items()})
        return t_list

    def checkpoint_version(self) -> float:
        """Megatron checkpoint_version from the mp_rank state (0.0 when
        absent) — decides the qkv shard layout (state_dict_factory.py)."""
        sd = self._load_mp_rank_sd()
        v = sd.get("checkpoint_version", 0.0)
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    def merged_layer_state(self, layer_key: str,
                           ckpt_version: Optional[float] = None
                           ) -> Dict[str, np.ndarray]:
        """One layer's state with ALL original-tp shards merged whole
        (qkv/row/col concat rules) — the building block of to_universal and
        of model importers.

        ``query_key_value`` params get the version-aware regroup
        (:func:`merge_query_key_value`, reference
        state_dict_factory.py:220): version-0 shards store [q_r|k_r|v_r]
        fused per rank, so a naive dim-0 concat would interleave ranks'
        q/k/v — each shard is split into thirds and re-concatenated per
        component; versions >= 1.0 concat plainly. The version defaults to
        the checkpoint's own ``checkpoint_version``."""
        if ckpt_version is None:
            ckpt_version = self.checkpoint_version()
        layer_files = get_files_with_prefix(
            self.layer_files, f"{LAYER_FILE_PREFIX}{layer_key}")
        parts = partition_data(layer_files, self.original_tp_degree)
        sds = [{k: _to_numpy(v) for k, v in _torch_load(fs[0]).items()}
               for fs in parts]
        if len(sds) == 1:
            return sds[0]
        merged = merge_state_dicts(sds, cat_dim_fn=get_layer_cat_dim)
        for key in merged:
            if _is_qkv(key):
                merged[key] = merge_query_key_value(
                    [np.asarray(sd[key]) for sd in sds], ckpt_version, dim=0)
        return merged

    def get_pp_transformer_map(self, pp_index: int) -> List[str]:
        return self.pp_to_transformer_map[pp_index]

    def get_2d_parallel_files(self, tp_index: int,
                              pp_index: int) -> List[str]:
        return self.transformer_file_map.get((tp_index, pp_index), [])

    def _load_mp_rank_sd(self, tp_index: int = 0) -> Dict[str, Any]:
        if not self.mp_rank_files:
            return {}
        return _torch_load(self.mp_rank_files[min(tp_index,
                                                  len(self.mp_rank_files) - 1)])

    def get_iteration(self) -> int:
        if ITERATION_KEY not in self.global_state:
            sd = self._load_mp_rank_sd()
            self.global_state[ITERATION_KEY] = sd.get(ITERATION_KEY, 0)
        return self.global_state[ITERATION_KEY]

    def get_args(self):
        if ARGS_KEY not in self.global_state:
            sd = self._load_mp_rank_sd()
            self.global_state[ARGS_KEY] = sd.get(ARGS_KEY)
        return self.global_state[ARGS_KEY]

    def get_checkpoint_info(self, info_key: str = CHECKPOINT_INFO_KEY):
        sd = self._load_mp_rank_sd()
        return sd.get(info_key)

    def validate_files(self) -> None:
        for file in self.file_list:
            if not os.path.isfile(file):
                raise FileNotFoundError(f"{file} is not existent")

    # -- migration --------------------------------------------------------
    def to_universal(self, output_dir: str, tag: str = "migrated") -> str:
        """Merge all TP/PP shards into whole arrays and write this
        framework's universal-checkpoint format; load with
        ``engine.load_universal_checkpoint`` at any mesh layout."""
        from .universal_checkpoint import _save_tree_npz, universal_dir

        merged: Dict[str, np.ndarray] = {}
        if self.layer_keys:
            for layer_key in self.layer_keys:
                sd = self.merged_layer_state(layer_key)
                for k, v in sd.items():
                    merged[f"layer_{layer_key}/{k.replace('.', '/')}"] = v
        else:
            sds = []
            for f in self.mp_rank_files:
                raw = _torch_load(f)
                raw = raw.get("module", raw)
                sds.append({k: _to_numpy(v) for k, v in raw.items()
                            if hasattr(v, "shape")})
            sd = sds[0] if len(sds) == 1 else \
                merge_state_dicts(sds, cat_dim_fn=get_layer_cat_dim)
            for k, v in sd.items():
                merged[k.replace(".", "/")] = v

        out = universal_dir(output_dir, tag)
        os.makedirs(out, exist_ok=True)
        fp32_index = _save_tree_npz(os.path.join(out, "fp32.npz"), merged)
        meta = {
            "tag": tag, "step": int(self.get_iteration()),
            "opt_step": int(self.get_iteration()),
            "global_steps": int(self.get_iteration()),
            "global_samples": 0, "micro_steps": 0, "skipped_steps": 0,
            "lr_scheduler": None, "fp32_index": fp32_index,
            "opt_indices": {},
            "source_dp_world_size": self.original_dp_degree,
            "source_mp_world_size": self.original_tp_degree,
        }
        with open(os.path.join(out, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        logger.info(f"migrated reference checkpoint {self.dir} → {out} "
                    f"({len(merged)} tensors)")
        return out
