"""The port's logical axis rules (``deepspeed_tpu_torch/parallel/
axis_rules.py``) against the JAX package's, on the cases of
``tests/unit/parallel/test_axis_rules.py``: the same table, the same
resolved entries (a JAX ``PartitionSpec``'s tuple against the port's
tuple) for the same layouts, shapes and mesh sizes, and per cache leaf the
same placement (the port's K/V leaves are positions-major, so their
layouts name the same axes in another order; both put ``slots``/``pages``,
then ``kv_heads``, first). The port's meshes are ``ProcessMesh``es of the
same shape without a process group, one for each rank, so each rank's
slice of a cache leaf is checked too: the ranks' slices tile the leaf."""

import itertools

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.parallel import axis_rules as J
from deepspeed_tpu_torch.parallel import axis_rules as A
from deepspeed_tpu_torch.parallel import mesh as PM

from _torch_threads import one_thread  # noqa: F401


def port_mesh(data: int, model: int, rank: int = 0):
    return PM.ProcessMesh(PM.MESH_AXES, (1, data, 1, 1, model), rank)


@pytest.fixture
def meshes(tp_mesh):
    """(JAX mesh, port mesh) at data 4, model 2."""
    return tp_mesh(data=4, model=2), port_mesh(4, 2)


def test_default_table_and_validation():
    assert A.DEFAULT_AXIS_RULES == J.DEFAULT_AXIS_RULES
    for bad in ((("heads", "modle"),), (("", "model"),)):
        for mod in (A, J):
            with pytest.raises(ValueError):
                mod.validate_axis_rules(bad)
    A.validate_axis_rules(A.DEFAULT_AXIS_RULES)


SPEC_CASES = [
    # (data, model, logical layout, shape)
    (8, 1, ("heads", "head_dim"), (4, 8)),
    (8, 1, ("slots",), (8,)),
    (4, 2, ("slots",), (8,)),
    (4, 2, ("slots",), (6,)),
    (4, 2, ("heads", None), (4, 7)),
    (4, 2, ("heads", None), (3, 7)),
    (4, 2, ("layers", "embed", "heads"), (2, 32, 32)),
    (4, 2, ("layers", "heads", "embed"), (2, 32, 32)),
    (4, 2, ("vocab", "embed"), (64, 32)),
    (4, 2, ("embed", "vocab"), (32, 50)),
    (2, 4, ("layers", "slots", "kv_heads", "head_dim", "positions"),
     (2, 8, 2, 8, 16)),
    (2, 4, ("layers", "embed", "ffn"), (2, 32, 128)),
]


@pytest.mark.parametrize("data,model,axes,shape", SPEC_CASES)
def test_spec_for_matches_jax(tp_mesh, data, model, axes, shape):
    jmesh = tp_mesh(data=data, model=model)
    want = J.default_axis_rules().spec_for(axes, shape=shape, mesh=jmesh)
    got = A.default_axis_rules().spec_for(axes, shape=shape,
                                          mesh=port_mesh(data, model))
    assert got == tuple(want)
    assert A.default_axis_rules().spec_entries(axes) == \
        J.default_axis_rules().spec_entries(axes)


PHYSICAL_CASES = [
    (("model", None), (4, 8)),
    (("model", "model"), (4, 4)),
    (("pipe", "model"), (4, 4)),
    ((None, "data", "model"), (2, 8, 4)),
    (("data", "data"), (8, 8)),
    (("model",), (5,)),
]


@pytest.mark.parametrize("entries,shape", PHYSICAL_CASES)
def test_physical_spec_matches_jax(meshes, entries, shape):
    jmesh, pmesh = meshes
    want = J.physical_spec(entries, shape=shape, mesh=jmesh)
    assert A.physical_spec(entries, shape=shape, mesh=pmesh) == tuple(want)
    # no mesh: only the canonical form (no size or divisibility applies)
    assert A.physical_spec(entries) == tuple(J.physical_spec(entries))


def test_first_match_wins_and_rank_mismatch(meshes):
    for mod in (A, J):
        rules = mod.LogicalAxisRules((("heads", "model"), ("heads", "data")))
        assert rules.mesh_axis("heads") == "model"
        assert rules.mesh_axis("unknown-name") is None
        assert rules.mesh_axis(None) is None
    with pytest.raises(ValueError, match="dims"):
        A.default_axis_rules().spec_for(("slots",), shape=(4, 4),
                                        mesh=meshes[1])


# (key, JAX leaf shape, port leaf shape): the port's K/V rows are
# positions-major, (L, B|P, KV, S, D) against the JAX (L, B|P, KV, D, S)
LEAVES = {
    "stacked": [("k", (2, 8, 4, 8, 16), (2, 8, 4, 16, 8)),
                ("k_scale", (2, 8, 4, 16), (2, 8, 4, 16)),
                ("index", (8,), (8,)),
                ("k", (2, 6, 3, 8, 16), (2, 6, 3, 16, 8)),
                ("unknown", (2, 8, 4, 8, 16), (2, 8, 4, 16, 8))],
    "paged": [("k", (2, 12, 4, 8, 16), (2, 12, 4, 16, 8)),
              ("v_scale", (2, 12, 4, 16), (2, 12, 4, 16)),
              ("table", (8, 4), (8, 4))],
}


@pytest.mark.parametrize("kind,case", [(k, i) for k in LEAVES
                                       for i in range(len(LEAVES[k]))])
def test_cache_leaf_sharding_matches_jax(meshes, kind, case):
    jmesh, _ = meshes
    key, jshape, pshape = LEAVES[kind][case]
    want = J.cache_leaf_sharding(kind, mesh=jmesh)(
        key, np.zeros(jshape, np.float32)).spec
    seen = np.zeros(pshape, np.int64)
    for data_rank, model_rank in itertools.product(range(4), range(2)):
        pmesh = port_mesh(4, 2, rank=data_rank * 2 + model_rank)
        spec, index = A.cache_leaf_sharding(kind, mesh=pmesh)(key, pshape)
        assert spec == tuple(want)
        seen[index] += 1
    # the ranks' slices tile the leaf: each element held by as many ranks
    # as the axes it is not split over
    split = {a for a in spec if a is not None}
    copies = 8 // np.prod([{"data": 4, "model": 2}[a] for a in split]) \
        if split else 8
    assert (seen == copies).all()


def test_resolution_defaults_to_the_global_mesh():
    PM.reset_mesh()
    PM.set_mesh(port_mesh(8, 1))
    try:
        assert A.default_axis_rules().spec_for(("slots",), shape=(8,)) == \
            ("data",)
    finally:
        PM.reset_mesh()
    # no mesh at all: the unresolved entries, canonical
    assert A.default_axis_rules().spec_for(("heads", None)) == ("model",)
    assert A.model_dim(("data", None, "model")) == 2
    assert A.model_dim(()) is None
