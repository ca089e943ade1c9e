"""N-dimensional cartesian process topology with named axes: the port's
own copy of ``deepspeed_tpu/parallel/topology.py`` (pure Python).

``ProcessTopology`` maps coordinates to linear ranks, major axis first;
``get_axis_comm_lists`` enumerates the rank lists that vary along one axis,
from which ``parallel.mesh`` builds one ``torch.distributed`` process group
per axis and coordinate.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Dict, List, Sequence


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates <-> linear global ranks.

    Axes are named and ordered major-to-minor: the *last* axis has
    adjacent-rank locality (put the axis whose collectives are the most
    latency-sensitive last).
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError(f"axes {axes} and dims {dims} must have equal length")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict["ProcessTopology.ProcessCoord", int] = {}
        for rank, coord in enumerate(itertools.product(*[range(d) for d in self.dims])):
            self.mapping[self.ProcessCoord(*coord)] = rank

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}, got {list(coord_kwargs)}")
        return self.mapping[self.ProcessCoord(**coord_kwargs)]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank: int, omit_axes: Sequence[str] = ("data",), inner_sep: str = "_",
                      outer_sep: str = "-") -> str:
        """String like ``pipe_00-model_00`` used in checkpoint file names."""
        omit = frozenset(omit_axes)
        axes = [a for a in self.axes if a not in omit]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_coord(self, rank: int):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology {self}")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Rank groups that vary only along ``axis`` — i.e. the communicator
        groups for that axis (reference pipe/topology.py:127)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for other_coord in itertools.product(*[range(self.get_dim(a)) for a in other_axes]):
            fixed = dict(zip(other_axes, other_coord))
            ranks = [self.get_rank(**{axis: i}, **fixed) for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match the given axis=value filters."""

        def _matches(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return sorted(idx for coord, idx in self.mapping.items() if _matches(coord))

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return sorted(rank for coord, rank in self.mapping.items() if getattr(coord, axis) == idx)

    def world_size(self) -> int:
        import math

        return math.prod(self.dims)

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """pipe-major × data-minor topology (reference pipe/topology.py:232).

    Data-parallel ranks are adjacent (last axis).
    """

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe × data × model 3D topology (reference pipe/topology.py:244).

    Model (tensor) parallel is the innermost axis: TP collectives are the most
    latency-sensitive so they get adjacent devices.
    """

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])
