"""3D (pp × tp × dp) reshape descriptor: the port's copy of
``deepspeed_tpu/checkpoint/reshape_3d_utils.py``.

Capability parity with reference ``deepspeed/checkpoint/reshape_3d_utils.py``
(:17 ``model_3d_desc``, :73 ``get_model_3d_descriptor``) — describes a 3D
checkpoint layout and computes, for each coordinate of a (smaller) target
layout, the source ranks whose shards must merge.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

from .reshape_meg_2d import meg_2d_parallel_map, reshape_meg_2d_parallel
from .reshape_utils import get_files, get_files_with_prefix

PP_DIM = "PP"
TP_DIM = "TP"
DP_DIM = "DP"

MODEL_FILE_PREFIX = "mp_rank_"
LAYER_FILE_PREFIX = "layer_"
ZERO_FILE_PREFIX = "zero_pp_rank_"


def get_zero_files(dir_: str) -> List[str]:
    return get_files_with_prefix(get_files(dir_), ZERO_FILE_PREFIX)


class model_3d_desc:
    def __init__(self, pp_degree: int = 1, tp_degree: int = 1,
                 dp_degree: int = 1):
        self.pp_degree = pp_degree
        self.tp_degree = tp_degree
        self.dp_degree = dp_degree

    def reshape(self, target_3d_desc: "model_3d_desc",
                verbose: bool = False) -> List[Tuple]:
        valid_reshape, reshape_errors = self.can_reshape(target_3d_desc)
        assert valid_reshape, ",".join(reshape_errors)
        tgt_2d_map = reshape_meg_2d_parallel(
            old_pp_degree=self.pp_degree, old_tp_degree=self.tp_degree,
            new_pp_degree=target_3d_desc.pp_degree,
            new_tp_degree=target_3d_desc.tp_degree, verbose=verbose)
        flat_3d_map = _flatten_dp_dimension(
            tgt_2d_map, self.pp_degree * self.tp_degree, self.dp_degree)
        return _unflatten_dp_dimension(flat_3d_map, target_3d_desc.dp_degree)

    def get_desc(self) -> str:
        return (f"{PP_DIM},{TP_DIM},{DP_DIM} = ({self.pp_degree}, "
                f"{self.tp_degree}, {self.dp_degree})")

    def world_size(self) -> int:
        return self.pp_degree * self.tp_degree * self.dp_degree

    def is_valid(self, pp_index: int, tp_index: int, dp_index: int):
        err_msg = []
        for index, degree, dim_name in [(pp_index, self.pp_degree, PP_DIM),
                                        (tp_index, self.tp_degree, TP_DIM),
                                        (dp_index, self.dp_degree, DP_DIM)]:
            if index >= degree:
                err_msg.append(f"{dim_name} indexing error: index {index} "
                               f">= degree {degree}")
        return len(err_msg) == 0, err_msg

    def can_reshape(self, target_3d_desc: "model_3d_desc"):
        err_msg = []
        for dim_name, old, new in [
                (PP_DIM, self.pp_degree, target_3d_desc.pp_degree),
                (TP_DIM, self.tp_degree, target_3d_desc.tp_degree),
                (DP_DIM, self.dp_degree, target_3d_desc.dp_degree)]:
            if new > old:
                err_msg.append(f"Expansion reshape not supported - "
                               f"{dim_name}: {old} ---> {new}")
        return len(err_msg) == 0, err_msg


def get_model_3d_descriptor(dir_: str) -> model_3d_desc:
    """Infer (pp, tp, dp) from a checkpoint dir's file naming — reference
    reshape_3d_utils.py:73. Works on both reference-format dirs (layer_XX /
    mp_rank_XX .pt) and this framework's dirs."""
    file_list = get_files(dir_)
    zero_file_list = get_zero_files(dir_)
    num_pp0_files = len(get_files_with_prefix(file_list,
                                              f"{LAYER_FILE_PREFIX}01"))
    if num_pp0_files > 0:
        tp_degree = num_pp0_files
        pp_degree = len(get_files_with_prefix(
            file_list, MODEL_FILE_PREFIX)) // tp_degree
        dp_degree = max(1, len(zero_file_list) // (pp_degree * tp_degree))
    else:
        tp_degree = len(get_files_with_prefix(file_list, MODEL_FILE_PREFIX))
        dp_degree = max(1, len(zero_file_list) // max(tp_degree, 1))
        pp_degree = 0
    return model_3d_desc(pp_degree, tp_degree, dp_degree)


def _flatten_dp_dimension(meg_2d_map: meg_2d_parallel_map, src_2d_size: int,
                          dp_degree: int) -> meg_2d_parallel_map:
    new_map = meg_2d_parallel_map(meg_2d_map.pp_degree, meg_2d_map.tp_degree)
    for pp_index in range(meg_2d_map.pp_degree):
        for tp_index in range(meg_2d_map.tp_degree):
            dp0_indices = meg_2d_map.get_data(pp_index, tp_index)
            for idx in dp0_indices:
                new_map.add_data(pp_index, tp_index,
                                 [idx + i * src_2d_size
                                  for i in range(dp_degree)])
    return new_map


def _unflatten_dp_dimension(meg_2d_map: meg_2d_parallel_map,
                            dp_degree: int) -> List[meg_2d_parallel_map]:
    """Split each coordinate's flat rank list into dp_degree maps."""
    dp_maps = [meg_2d_parallel_map(meg_2d_map.pp_degree,
                                   meg_2d_map.tp_degree)
               for _ in range(dp_degree)]
    for key, ranks in meg_2d_map.map.items():
        pp_index, tp_index = map(int, key.split(","))
        assert len(ranks) % dp_degree == 0
        chunk = len(ranks) // dp_degree
        for dp_index in range(dp_degree):
            dp_maps[dp_index].add_data(
                pp_index, tp_index,
                ranks[dp_index * chunk:(dp_index + 1) * chunk])
    return dp_maps
