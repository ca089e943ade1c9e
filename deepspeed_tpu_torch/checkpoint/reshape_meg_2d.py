"""2D (pipeline × tensor) parallel reshape maps: the port's copy of
``deepspeed_tpu/checkpoint/reshape_meg_2d.py``.

Capability parity with reference ``deepspeed/checkpoint/reshape_meg_2d.py:80
reshape_meg_2d_parallel`` — computes, for each (pp, tp) coordinate of a NEW
parallel layout, which OLD ranks' checkpoint shards it must merge. Used by
the offline reshaper and by universal-checkpoint loading of 3D layouts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .reshape_utils import partition_data


class meg_2d_parallel_map:
    def __init__(self, pp_degree: int, tp_degree: int):
        self.pp_degree = pp_degree
        self.tp_degree = tp_degree
        self.map: Dict[str, List[int]] = {}

    def simple_init(self) -> None:
        # rank layout: tp fastest-varying within pp (Megatron convention)
        self.map = {
            self._make_key(i // self.tp_degree, i % self.tp_degree): [i]
            for i in range(self.pp_degree * self.tp_degree)
        }

    def add_data(self, pp_index: int, tp_index: int, data: List[int]) -> None:
        self._validate_indices(pp_index, tp_index)
        assert isinstance(data, list)
        key = self._make_key(pp_index, tp_index)
        self.map.setdefault(key, [])
        self.map[key] += data

    def get_data(self, pp_index: Optional[int] = None,
                 tp_index: Optional[int] = None) -> List[int]:
        self._validate_indices(pp_index, tp_index)
        pp_indices = range(self.pp_degree) if pp_index is None else [pp_index]
        tp_indices = range(self.tp_degree) if tp_index is None else [tp_index]
        result: List[int] = []
        for i in pp_indices:
            for j in tp_indices:
                result += self.map[self._make_key(i, j)]
        return result

    def print_data(self, tag: str) -> None:
        print(tag)
        for key, value in self.map.items():
            print(f"{key} = {value}")

    def _validate_indices(self, pp_index, tp_index) -> None:
        assert pp_index is None or pp_index < self.pp_degree
        assert tp_index is None or tp_index < self.tp_degree

    @staticmethod
    def _make_key(i: int, j: int) -> str:
        return f"{i},{j}"


def _reshape_tp_dimension(old_2d_map: meg_2d_parallel_map,
                          new_tp_degree: int) -> meg_2d_parallel_map:
    new_map = meg_2d_parallel_map(old_2d_map.pp_degree, new_tp_degree)
    for i in range(old_2d_map.pp_degree):
        ranks = old_2d_map.get_data(pp_index=i, tp_index=None)
        for j, split in enumerate(partition_data(ranks, new_tp_degree)):
            new_map.add_data(i, j, split)
    return new_map


def _reshape_pp_dimension(old_2d_map: meg_2d_parallel_map,
                          new_pp_degree: int) -> meg_2d_parallel_map:
    new_map = meg_2d_parallel_map(new_pp_degree, old_2d_map.tp_degree)
    for i in range(old_2d_map.tp_degree):
        ranks = old_2d_map.get_data(pp_index=None, tp_index=i)
        for j, split in enumerate(partition_data(ranks, new_pp_degree)):
            new_map.add_data(j, i, split)
    return new_map


def reshape_meg_2d_parallel(old_pp_degree: int, old_tp_degree: int,
                            new_pp_degree: int, new_tp_degree: int,
                            verbose: bool = False) -> meg_2d_parallel_map:
    assert new_pp_degree <= old_pp_degree, "pp can only shrink in a reshape"
    assert new_tp_degree <= old_tp_degree, "tp can only shrink in a reshape"
    old_2d_map = meg_2d_parallel_map(old_pp_degree, old_tp_degree)
    old_2d_map.simple_init()
    if verbose:
        old_2d_map.print_data("original_2d_map:")
    new_map = old_2d_map
    if old_tp_degree != new_tp_degree:
        new_map = _reshape_tp_dimension(new_map, new_tp_degree)
    if verbose and new_map is not old_2d_map:
        new_map.print_data("after_tp_reshape:")
    if old_pp_degree != new_pp_degree:
        new_map = _reshape_pp_dimension(new_map, new_pp_degree)
    if verbose:
        new_map.print_data("final_2d_map:")
    return new_map


def get_mpu_ranks(tp_size: int = 1, pp_size: int = 1, dp_size: int = 1):
    """Enumerate the (tp, pp, dp) rank groups of a world of
    tp*pp*dp ranks laid out Megatron-style (tp fastest, then pp, then dp).
    Returns (tp_groups, pp_groups, dp_groups) as rank lists."""
    world = tp_size * pp_size * dp_size
    tp_groups = [list(range(i, i + tp_size))
                 for i in range(0, world, tp_size)]
    num_pp_groups = world // pp_size
    pp_groups = []
    for i in range(num_pp_groups):
        ranks = list(range(i, world, num_pp_groups))
        pp_groups.append(ranks)
    dp_groups = []
    ranks_per_pp = world // pp_size
    for i in range(pp_size):
        start = i * ranks_per_pp
        for j in range(tp_size):
            dp_groups.append(list(range(start + j, start + ranks_per_pp,
                                        tp_size)))
    return tp_groups, pp_groups, dp_groups
