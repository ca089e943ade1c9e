"""The process mesh and the global group registry: the port of
``deepspeed_tpu/parallel/mesh.py``.

The JAX package names every parallel axis of one ``jax.sharding.Mesh``;
here a mesh is a :class:`~.topology.ProcessTopology` over the ranks of the
``torch.distributed`` world (rank = the row-major index of its coordinate,
major axis first, as the JAX mesh reshapes its device list) plus one
process group for each axis and each coordinate of the other axes, built
from ``get_axis_comm_lists``. "Creating a group" is naming an axis, or a
tuple of axes, as in the JAX package.

Axis layout (major → minor): ``pipe, data, expert, seq, model``; with
MiCS, ``pipe, data_outer, data, expert, seq, model``, where ``data`` is
the shard group of ``mics_shard_size`` ranks and ``data_outer`` the
replica groups. ``data`` and ``model`` run above 1 (``model`` is the
minor axis, so a model group is a block of consecutive ranks, as in the
JAX mesh, whose device list reshapes data-major with the model axis
innermost); ``pipe``, ``expert`` and ``seq`` above 1 raise
``NotImplementedError``. The entry points decide what they serve or train
over: ``init_inference`` takes ``model`` above 1 with ``data`` 1, the
training engine ``data`` ≥ 1 beside ``model`` ≥ 1 (the ZeRO axes stay
``data``, ``expert``, ``seq``: a model group's ranks reduce nothing of
ZeRO's together).

Without a process group the mesh is one rank: every axis has size 1 and
every group is that rank alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from ..utils.logging import logger
from .topology import ProcessTopology

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
DATA_OUTER_AXIS = "data_outer"  # MiCS replica groups (hierarchical ZeRO)
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)
MICS_MESH_AXES = (PIPE_AXIS, DATA_OUTER_AXIS, DATA_AXIS, EXPERT_AXIS,
                  SEQ_AXIS, MODEL_AXIS)

# Axes over which ZeRO (sharded-DP) state is partitioned (the JAX
# ``ZERO_AXES``; expert and seq are 1 in this port).
ZERO_AXES = (DATA_AXIS, EXPERT_AXIS, SEQ_AXIS)
# Axes over which the global batch (sample dim) is split.
BATCH_AXES = (DATA_AXIS, EXPERT_AXIS)

# what each axis above 1 still needs
_NOT_PORTED = {PIPE_AXIS: "pipeline parallelism",
               EXPERT_AXIS: "expert parallelism (MoE)",
               SEQ_AXIS: "sequence parallelism"}


def batch_axes() -> Tuple[str, ...]:
    """Batch (sample-dim) axes of the current mesh: includes the MiCS
    replica axis when present."""
    mesh = get_mesh() if has_mesh() else None
    if mesh is not None and DATA_OUTER_AXIS in mesh.axis_names:
        return (DATA_OUTER_AXIS,) + BATCH_AXES
    return BATCH_AXES


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees of parallelism; -1 for data means "fill the remaining
    ranks"."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.model * self.pipe * self.expert * self.seq
        if n_devices % fixed != 0:
            raise ValueError(
                f"device count {n_devices} not divisible by model×pipe×expert×seq = {fixed}")
        data = self.data
        if data == -1:
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}×{fixed} (dp×rest) != device count {n_devices}")
        return MeshConfig(data=data, model=self.model, pipe=self.pipe, expert=self.expert,
                          seq=self.seq)

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.pipe, self.data, self.expert, self.seq, self.model)


class ProcessMesh:
    """The topology of the world's ranks and the process groups of its
    axes. ``group(axes)`` is the group of this rank's coordinate along
    ``axes`` (a name or a tuple of names): ``None`` when those axes span
    one rank, the default group when they span the world."""

    def __init__(self, axis_names: Sequence[str], dims: Sequence[int],
                 rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(d) for d in dims)
        self.topology = ProcessTopology(list(self.axis_names),
                                        list(self.dims))
        self.rank = rank
        self.coord = self.topology.get_coord(rank)
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in axes)

    def axis_rank(self, axes) -> int:
        """This rank's index within its group along ``axes`` (row-major
        over ``axes`` in the mesh's order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + getattr(self.coord, a)
        return idx

    def comm_lists(self, axes) -> list:
        """Every rank list that varies over ``axes`` jointly, the other
        axes fixed (``ProcessTopology.get_axis_comm_lists`` for a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self.topology.get_axis_comm_lists(axes[0])
        others = [a for a in self.axis_names if a not in axes]
        lists = {}
        for rank in range(self.size):
            coord = self.topology.get_coord(rank)
            key = tuple(getattr(coord, a) for a in others)
            lists.setdefault(key, []).append(rank)
        return [sorted(v) for _, v in sorted(lists.items())]

    def ranks(self, axes) -> Tuple[int, ...]:
        """The global ranks of this rank's group along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return next(tuple(r) for r in self.comm_lists(axes)
                    if self.rank in r) if self.axis_size(axes) > 1 \
            else (self.rank,)

    def build_groups(self, axes) -> None:
        """Create the process groups along ``axes`` (every rank of the
        world must call this, in the same order: ``new_group`` is
        collective)."""
        import torch.distributed as dist

        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key in self._groups:
            return
        n = self.axis_size(key)
        if n == 1:
            self._groups[key] = None
        elif n == self.size:
            self._groups[key] = dist.group.WORLD
        else:
            mine = None
            for ranks in self.comm_lists(key):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[key] = mine

    def group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            self.build_groups(key)
        return self._groups[key]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"


def _dist_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None,
               *,
               data: int = -1,
               model: int = 1,
               pipe: int = 1,
               expert: int = 1,
               seq: int = 1,
               mics_shard_size: int = 0) -> ProcessMesh:
    """Build the mesh over the ``torch.distributed`` world (one rank
    without a process group) and its axes' process groups. ``devices``
    (a sequence whose length is the world size) is accepted for the JAX
    signature; the world decides."""
    if config is None:
        config = MeshConfig(data=data, model=model, pipe=pipe, expert=expert, seq=seq)
    for axis, what in _NOT_PORTED.items():
        if getattr(config, axis) > 1:
            raise NotImplementedError(
                f"mesh.{axis}={getattr(config, axis)}: {what} is not ported "
                f"to the PyTorch/CUDA package yet (data and tensor "
                f"parallelism are)")
    world, rank = _dist_world()
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices given for a world of "
                         f"{world} ranks")
    config = config.resolve(world)

    mics_shard_size = int(mics_shard_size or 0)
    dims = config.dims
    axes = MESH_AXES
    if mics_shard_size > config.data > 0:
        raise ValueError(
            f"mics_shard_size {mics_shard_size} exceeds the data-parallel "
            f"degree {config.data}")
    if mics_shard_size and 0 < mics_shard_size < config.data:
        if config.data % mics_shard_size != 0:
            raise ValueError(
                f"mics_shard_size {mics_shard_size} must divide data "
                f"parallel degree {config.data}")
        dims = (config.pipe, config.data // mics_shard_size,
                mics_shard_size, config.expert, config.seq, config.model)
        axes = MICS_MESH_AXES
    mesh = ProcessMesh(axes, dims, rank)
    if world > 1:
        # new_group is collective: every rank builds every group, in order
        for axis in axes:
            mesh.build_groups(axis)
        mesh.build_groups(ZERO_AXES)
        mesh.build_groups((DATA_OUTER_AXIS,) + ZERO_AXES)
    return mesh


class _GroupsState:
    """The global registry (the reference's ``deepspeed/utils/groups.py``
    module state)."""

    def __init__(self):
        self.mesh: Optional[ProcessMesh] = None
        self.mesh_config: Optional[MeshConfig] = None
        self.topology: Optional[ProcessTopology] = None


_state = _GroupsState()


def initialize_mesh(config: Optional[MeshConfig] = None, devices=None, **kwargs):
    """Create and install the global mesh (≅ ``groups.initialize``)."""
    mesh = build_mesh(config, devices, **kwargs)
    set_mesh(mesh)
    if mesh.size > 1:
        logger.info(f"initialized global mesh: {mesh.shape}")
    return mesh


def set_mesh(mesh: ProcessMesh) -> None:
    _state.mesh = mesh
    dims = mesh.shape
    _state.mesh_config = MeshConfig(
        data=dims.get(DATA_AXIS, 1) * dims.get(DATA_OUTER_AXIS, 1),
        model=dims.get(MODEL_AXIS, 1),
        pipe=dims.get(PIPE_AXIS, 1),
        expert=dims.get(EXPERT_AXIS, 1),
        seq=dims.get(SEQ_AXIS, 1),
    )
    _state.topology = mesh.topology


def get_mesh() -> ProcessMesh:
    if _state.mesh is None:
        initialize_mesh()
    return _state.mesh


def has_mesh() -> bool:
    return _state.mesh is not None


def get_topology() -> ProcessTopology:
    get_mesh()
    return _state.topology


def reset_mesh() -> None:
    _state.mesh = None
    _state.mesh_config = None
    _state.topology = None


def _axis_size(axis: str) -> int:
    return get_mesh().shape.get(axis, 1)


def get_data_parallel_world_size() -> int:
    """Model replicas in the batch sense: the multiplier in ``train_batch
    = micro_batch × gas × dp_world``."""
    return math.prod(_axis_size(a) for a in batch_axes())


def get_data_parallel_rank() -> int:
    """This rank's index over the batch axes: which block of each global
    micro-batch it holds."""
    return get_mesh().axis_rank(batch_axes())


def get_model_parallel_world_size() -> int:
    return _axis_size(MODEL_AXIS)


def get_pipe_parallel_world_size() -> int:
    return _axis_size(PIPE_AXIS)


def get_expert_parallel_world_size() -> int:
    return _axis_size(EXPERT_AXIS)


def get_sequence_parallel_world_size() -> int:
    return _axis_size(SEQ_AXIS)


def get_world_size() -> int:
    return get_mesh().size
