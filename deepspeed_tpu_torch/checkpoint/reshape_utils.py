"""Checkpoint reshape primitives: the port's copy of
``deepspeed_tpu/checkpoint/reshape_utils.py`` (numpy and the standard
library only).

Capability parity with reference ``deepspeed/checkpoint/reshape_utils.py`` —
rank-list partitioning and state-dict merge helpers used by the 2D/3D
reshape maps.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np


def basic_folder_validation(dir_: str) -> None:
    assert os.path.exists(dir_), f"{dir_} path does not exist"
    assert os.path.isdir(dir_), f"{dir_} is not a folder"


def get_files_with_prefix(all_files: List[str], prefix: str) -> List[str]:
    return sorted(f for f in all_files if os.path.basename(f).startswith(prefix))


def get_files(dir_: str) -> List[str]:
    file_list = []
    for root, _, files in os.walk(dir_):
        for file in files:
            file_list.append(os.path.join(root, file))
    return file_list


def partition_data(data_list: List[Any], num_partitions: int) -> List[List[Any]]:
    """Split a list into equal contiguous partitions."""
    num_elems = len(data_list)
    assert num_elems % num_partitions == 0, \
        f"cannot partition {num_elems} items into {num_partitions}"
    partition_size = num_elems // num_partitions
    return [data_list[i * partition_size:(i + 1) * partition_size]
            for i in range(num_partitions)]


def merge_state_dicts(sd_list: List[Dict[str, Any]],
                      cat_dim_fn=None) -> Dict[str, Any]:
    """Merge per-TP-rank state dicts: arrays concatenate on their slicing
    dim (``cat_dim_fn(key) -> int | None``; None = must be replicated)."""
    merged: Dict[str, Any] = {}
    for key in sd_list[0]:
        values = [sd[key] for sd in sd_list]
        dim = cat_dim_fn(key) if cat_dim_fn else None
        if dim is None or np.ndim(values[0]) == 0:
            merged[key] = values[0]
        else:
            merged[key] = np.concatenate([np.asarray(v) for v in values],
                                         axis=dim)
    return merged
