"""MiCS — hierarchical (sub-group) ZeRO sharding: the port of
``deepspeed_tpu/runtime/zero/mics.py``.

MiCS is a mesh shape: the data axis is factored into ``data_outer``
(replica groups) × ``data`` (the shard group of ``mics_shard_size``
ranks). ZeRO state shards over the inner axis only and is replicated
across the replica groups, so parameter all-gathers stay inside one
group; gradients are reduce-scattered inside the shard group and then
all-reduced across the replica groups (the reference's ``MiCS_Optimizer``
all-reduce, mics.py:418). Configure it with
``zero_optimization.mics_shard_size`` (the engine builds the factored
mesh) or build the mesh with :func:`MiCS_Init`.
"""

from __future__ import annotations

from typing import Optional

from ...parallel import mesh as mesh_mod
from ...utils.logging import log_dist


def MiCS_Init(shard_size: int, data: int = -1, model: int = 1, pipe: int = 1,
              expert: int = 1, seq: int = 1, devices=None):
    """Build and install the MiCS-factored mesh over the process group's
    world; returns it. Collective: every rank calls it."""
    mesh = mesh_mod.initialize_mesh(
        data=data, model=model, pipe=pipe, expert=expert, seq=seq,
        mics_shard_size=shard_size, devices=devices)
    dims = mesh.shape
    log_dist(
        f"MiCS: shard group={dims.get(mesh_mod.DATA_AXIS, 1)} ranks, "
        f"replica groups={dims.get(mesh_mod.DATA_OUTER_AXIS, 1)}",
        ranks=[0])
    return mesh


def mics_enabled() -> bool:
    if not mesh_mod.has_mesh():
        return False
    return mesh_mod.DATA_OUTER_AXIS in mesh_mod.get_mesh().axis_names


def mics_shard_size() -> Optional[int]:
    if not mics_enabled():
        return None
    return mesh_mod.get_mesh().shape[mesh_mod.DATA_AXIS]
