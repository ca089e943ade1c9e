"""The port's comm layer, process mesh and topology, and ZeRO's choice of
dimension.

* ``ProcessTopology`` (a copy of the JAX module): ranks, coordinates, axis
  comm lists, rank reprs and filters equal the JAX class's on a table of
  (pipe, data, model) dims.
* ``zero_shard_spec``: the port's spec equals the JAX spec on a table of
  shapes at data = 2, 4 and 8 on the conftest's virtual CPU mesh, with and
  without the persistence threshold; GPT-2's ``wte`` (50257 × 1024, odd
  rows) shards on dim 1.
* The collectives over four gloo ranks (one spawn: ``_torch_dist.py``)
  against numpy on the inputs every rank derives from its rank: all-reduce
  (sum, avg, max, min, bf16), all-gather (dims 0 and 1, stacked, bf16),
  reduce-scatter (dims 0 and 1, avg), all-to-all (two axis pairs),
  broadcast, the host variants, the cross-rank check; under the comms
  logger every op gives the same result and is counted with its input's
  bytes; over the MiCS mesh (2 replica groups of 2) the ``data`` and ``data_outer``
  groups reduce over the right ranks. Exact comparisons: every input is a
  small multiple of 0.25 and every sum of four is exact in fp32 (the bf16
  inputs and every partial sum of them need at most 8 significant bits).
* Without a process group every collective returns its input.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel import initialize_mesh as j_initialize_mesh
from deepspeed_tpu.parallel import topology as JT
from deepspeed_tpu.runtime.zero import policy as JP
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import mesh as PM
from deepspeed_tpu_torch.parallel import topology as PT
from deepspeed_tpu_torch.runtime.zero import policy as PP

from _torch_dist import spawn
from _torch_threads import one_thread  # noqa: F401

WORLD = 4
DIMS = [(1, 1, 1), (1, 4, 1), (2, 2, 1), (1, 2, 3), (2, 3, 2), (3, 1, 2)]


def _topologies(pipe, data, model):
    return [(JT.ProcessTopology(["pipe", "data", "model"], [pipe, data, model]),
             PT.ProcessTopology(["pipe", "data", "model"], [pipe, data, model])),
            (JT.PipeDataParallelTopology(pipe, data),
             PT.PipeDataParallelTopology(pipe, data)),
            (JT.PipeModelDataParallelTopology(pipe, model, data),
             PT.PipeModelDataParallelTopology(pipe, model, data))]


@pytest.mark.parametrize("pipe,data,model", DIMS)
def test_topology_matches_jax(pipe, data, model):
    for jt, pt in _topologies(pipe, data, model):
        assert pt.world_size() == jt.world_size()
        assert pt.get_axis_names() == jt.get_axis_names()
        for rank in range(jt.world_size()):
            assert tuple(pt.get_coord(rank)) == tuple(jt.get_coord(rank))
            assert pt.get_rank(**pt.get_coord(rank)._asdict()) == rank
            assert pt.get_rank_repr(rank) == jt.get_rank_repr(rank)
        for axis in jt.get_axis_names() + ["missing"]:
            assert pt.get_axis_comm_lists(axis) == \
                jt.get_axis_comm_lists(axis)
            assert pt.get_dim(axis) == jt.get_dim(axis)
            for idx in range(max(jt.get_dim(axis), 1)):
                if axis in jt.get_axis_names():
                    assert pt.get_axis_list(axis, idx) == \
                        jt.get_axis_list(axis, idx)
                    assert pt.filter_match(**{axis: idx}) == \
                        jt.filter_match(**{axis: idx})


SHAPES = [(50257, 1024), (1024, 3072), (3072,), (1024,), (7, 5), (12, 8, 6),
          (6, 12), (1, 16), (4096, 11008), (0, 4), (9,)]


@pytest.mark.parametrize("data", [2, 4, 8])
def test_zero_shard_spec_matches_jax(data):
    jmesh = j_initialize_mesh(data=data, devices=jax.devices()[:data])
    pmesh = PM.ProcessMesh(PM.MESH_AXES, (1, data, 1, 1, 1))
    for shape, applies, threshold in itertools.product(
            SHAPES, (True, False), (0, 100)):
        want = JP.zero_shard_spec(shape, jmesh, applies,
                                  persistence_threshold=threshold)
        got = PP.zero_shard_spec(shape, pmesh, applies,
                                 persistence_threshold=threshold)
        assert tuple(got) == tuple(want), (shape, applies, threshold)


def test_gpt2_wte_shards_on_its_columns():
    mesh = PM.ProcessMesh(PM.MESH_AXES, (1, 2, 1, 1, 1))
    spec = PP.zero_shard_spec((50257, 1024), mesh, True)
    assert tuple(spec) == (None, ("data", "expert", "seq"))
    assert PP.shard_dim(spec) == 1


def test_one_rank_without_a_group():
    PM.reset_mesh()
    mesh = PM.get_mesh()
    assert mesh.size == 1 and mesh.group("data") is None
    t = torch.arange(6.0).reshape(2, 3)
    assert comm.all_reduce(t) is t
    assert comm.all_gather_into_tensor(t, axis=1) is t
    assert comm.reduce_scatter_tensor(t) is t
    assert comm.all_to_all_single(t) is t
    np.testing.assert_array_equal(comm.all_gather_host(np.arange(3)),
                                  np.arange(3)[None])
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert PM.get_data_parallel_world_size() == 1
    with pytest.raises(NotImplementedError, match="pipeline"):
        comm.ppermute(t, [])
    # tensor parallelism is ported: a model axis of 2 needs a world of 2
    with pytest.raises(ValueError, match="not divisible"):
        PM.build_mesh(model=2)
    with pytest.raises(NotImplementedError, match="pipe=2"):
        PM.build_mesh(pipe=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn("comm", WORLD, tmp_path_factory.mktemp("comm"), timeout=120)


def _x(rank, shape, dtype=np.float64):
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float64).reshape(shape) * (rank + 1)
            + 0.25 * rank).astype(dtype)


def _xs(shape):
    return [_x(r, shape) for r in range(WORLD)]


def _expected() -> list:
    """Every rank's expected ``ops()`` result (numpy, float64)."""
    out = []
    for rank in range(WORLD):
        e = {}
        xs = _xs((3, 4))
        e["all_reduce_sum"] = sum(xs)
        e["all_reduce_avg"] = sum(xs) / WORLD
        e["all_reduce_max"] = np.max(xs, axis=0)
        e["all_reduce_min"] = np.min(xs, axis=0)
        e["all_reduce_bf16"] = sum(_xs((2, 4)))
        e["gather0"] = np.concatenate(_xs((2, 3)), axis=0)
        e["gather1"] = np.concatenate(_xs((2, 3)), axis=1)
        e["gather_stack"] = np.stack(_xs((2, 3)), axis=1)
        e["gather_bf16"] = np.concatenate(_xs((5,)))
        e["scatter0"] = sum(_xs((8, 3)))[2 * rank:2 * rank + 2]
        e["scatter1"] = sum(_xs((3, 8)))[:, 2 * rank:2 * rank + 2]
        e["scatter_avg"] = e["scatter0"] / WORLD
        e["a2a"] = np.concatenate([x[2 * rank:2 * rank + 2]
                                   for x in _xs((8, 2))])
        e["a2a_01"] = np.concatenate(
            [np.split(x, WORLD, axis=1)[rank] for x in _xs((4, 8))], axis=0)
        e["broadcast"] = _x(WORLD - 1, (4,))
        out.append(e)
    return out


def _hold(got: dict, want: dict):
    for key, value in want.items():
        g = got[key].double().numpy()
        if "bf16" in key:
            value = torch.tensor(value).bfloat16().double().numpy()
        np.testing.assert_array_equal(g, value, err_msg=key)


@pytest.mark.parametrize("part", ["all_reduce", "gather", "scatter", "a2a",
                                  "broadcast"])
def test_collectives_over_four_ranks(world, part):
    for rank, want in enumerate(_expected()):
        _hold(world[rank]["world"],
              {k: v for k, v in want.items() if k.startswith(part)})


def test_logged_ops_equal_the_unlogged_ones(world):
    for rank in range(WORLD):
        plain, logged = world[rank]["world"], world[rank]["logged"]
        assert sorted(plain) == sorted(logged)
        for key in plain:
            assert torch.equal(plain[key], logged[key]), (rank, key)


def test_comms_logger_counts_each_op_and_its_bytes(world):
    # each record: the op's count and its inputs' bytes
    want = {"all_reduce": (5, 4 * 12 * 4 + 8 * 2),
            "all_gather_into_tensor": (4, 3 * 6 * 4 + 5 * 2),
            "reduce_scatter_tensor": (3, 3 * 24 * 4),
            "all_to_all_single": (2, 16 * 4 + 32 * 4),
            "broadcast": (1, 4 * 4)}
    for rank in range(WORLD):
        got = world[rank]["comms"]
        assert {name: (v["count"], v["bytes"]) for name, v in got.items()} \
            == want, rank
        assert all(v["latency_s"] >= 0 for v in got.values())


def test_host_collectives_and_the_consistency_check(world):
    for rank in range(WORLD):
        r = world[rank]
        np.testing.assert_array_equal(r["host_sum"], [6.0, 4.0])
        np.testing.assert_array_equal(r["host_max"], [3, 0])
        np.testing.assert_array_equal(r["host_gather"],
                                      [[10 * i, i] for i in range(WORLD)])
        np.testing.assert_array_equal(r["host_bcast"], [6])
        assert "disagree" in r["mismatch"]
        assert "pipeline" in r["ppermute"] and "pipeline" in r["axis_index"]


def test_mics_mesh_groups(world):
    for rank in range(WORLD):
        r = world[rank]
        assert r["mics_shape"] == {"pipe": 1, "data_outer": 2, "data": 2,
                                   "expert": 1, "seq": 1, "model": 1}
        inner = (rank // 2 * 2, rank // 2 * 2 + 1)
        outer = (rank % 2, rank % 2 + 2)
        assert r["mics_ranks"] == {"data": inner, "data_outer": outer}
        np.testing.assert_array_equal(r["data_sum"].numpy(),
                                      sum(_x(i, (3,)) for i in inner))
        np.testing.assert_array_equal(r["outer_sum"].numpy(),
                                      sum(_x(i, (3,)) for i in outer))
        np.testing.assert_array_equal(r["dp_sum"].numpy(), sum(_xs((3,))))
        np.testing.assert_array_equal(
            r["data_gather"].numpy(),
            np.concatenate([_x(i, (2,)) for i in inner]))
        me = rank % 2
        np.testing.assert_array_equal(
            r["data_scatter"].numpy(),
            sum(_x(i, (4,)) for i in inner)[2 * me:2 * me + 2])
        assert r["sizes"] == {"data": 2, "data_outer": 2, "model": 1}
        assert (r["dp_world"], r["dp_rank"]) == (WORLD, rank)
