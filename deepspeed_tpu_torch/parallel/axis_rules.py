"""Logical axis rules: named model dimensions -> mesh axes, the port of
``deepspeed_tpu/parallel/axis_rules.py``.

Modules annotate parameters and cache containers with LOGICAL axis names
("heads", "ffn", "slots", ...); an ordered rules table (first match wins)
maps each name to a mesh axis of :data:`~.mesh.MESH_AXES`. The JAX package
turns a resolved spec into a ``PartitionSpec`` that GSPMD carries out; here
a resolved spec is a plain tuple of mesh-axis names or None, and the
module injection (``module_inject``) and the pools read it to decide which
dimension of a tensor this rank holds a slice of.

Resolution is shape-aware, with the JAX rules kept exactly:

* a mesh axis of size 1 is dropped (partitioning over one rank is
  replication), so a model axis of 1 resolves every rule to the fully
  replicated spec ``()``;
* a dimension the mapped axis size does not divide falls back to
  replicated for that dimension only;
* a mesh axis already used by an earlier dimension is not repeated;
* trailing Nones are stripped, so equivalent placements compare equal.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from . import mesh as mesh_mod
from .mesh import DATA_AXIS, DATA_OUTER_AXIS, MESH_AXES, MODEL_AXIS

#: logical name -> mesh axis (None = always replicated). Ordered, first
#: match wins. ``heads``/``kv_heads``/``ffn``/``vocab`` carry the Megatron
#: placement (column- and row-parallel projections, the vocab-parallel
#: embedding); ``slots`` is the serving batch dimension; ``pages`` stays
#: replicated (the paged pool's free list is host-global).
DEFAULT_AXIS_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("layers", None),
    ("embed", None),
    ("vocab", MODEL_AXIS),
    ("heads", MODEL_AXIS),
    ("kv_heads", MODEL_AXIS),
    ("head_dim", None),
    ("ffn", MODEL_AXIS),
    ("slots", DATA_AXIS),
    ("pages", None),
    ("positions", None),
)

#: logical layouts of the serving cache containers, in the port's leaf
#: order: K/V rows are positions-major, (L, B, KV, S, D) and (L, P, KV,
#: page_size, D) (the JAX package stores D before S for TPU tiling)
STACKED_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("layers", "slots", "kv_heads", "positions", "head_dim"),
    "v": ("layers", "slots", "kv_heads", "positions", "head_dim"),
    "k_scale": ("layers", "slots", "kv_heads", "positions"),
    "v_scale": ("layers", "slots", "kv_heads", "positions"),
    "index": ("slots",),
}
PAGED_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("layers", "pages", "kv_heads", "positions", "head_dim"),
    "v": ("layers", "pages", "kv_heads", "positions", "head_dim"),
    "k_scale": ("layers", "pages", "kv_heads", "positions"),
    "v_scale": ("layers", "pages", "kv_heads", "positions"),
    "index": ("slots",),
    "table": ("slots", None),
}


def validate_axis_rules(
        rules: Sequence[Tuple[str, Optional[str]]]) -> None:
    """Pin every mesh-axis name in ``rules`` against the declared mesh
    axes (``MESH_AXES`` and the MiCS outer axis): a misspelt axis would
    otherwise resolve silently to a replicated placement."""
    universe = set(MESH_AXES) | {DATA_OUTER_AXIS}
    for logical, axis in rules:
        if not isinstance(logical, str) or not logical:
            raise ValueError(f"logical axis name must be a non-empty "
                             f"string, got {logical!r}")
        if axis is not None and axis not in universe:
            raise ValueError(
                f"axis rule ({logical!r} -> {axis!r}) names a mesh axis "
                f"outside the declared universe {sorted(universe)}")


class LogicalAxisRules:
    """Ordered logical -> mesh axis table with shape-aware resolution."""

    def __init__(self, rules: Sequence[Tuple[str, Optional[str]]]
                 = DEFAULT_AXIS_RULES):
        validate_axis_rules(rules)
        self.rules: Tuple[Tuple[str, Optional[str]], ...] = tuple(
            (str(name), axis) for name, axis in rules)

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        """First matching mesh axis for ``logical`` (None if the name is
        None, unmatched, or mapped to replicated)."""
        if logical is None:
            return None
        for name, axis in self.rules:
            if name == logical:
                return axis
        return None

    def spec_entries(self, logical_axes: Sequence[Optional[str]]
                     ) -> Tuple[Optional[str], ...]:
        """The mesh-axis tuple of a logical layout, unresolved (no shape or
        mesh applied): the form ``ShardingRules`` trades in."""
        return tuple(self.mesh_axis(name) for name in logical_axes)

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 mesh: Any = None) -> Tuple[Optional[str], ...]:
        """Resolve a logical layout against ``mesh`` (default: the global
        mesh when one is installed) with the rules of the module
        docstring."""
        if mesh is None and mesh_mod.has_mesh():
            mesh = mesh_mod.get_mesh()
        entries = self.spec_entries(logical_axes)
        if shape is not None and len(shape) != len(entries):
            raise ValueError(
                f"logical layout {tuple(logical_axes)} has {len(entries)} "
                f"axes but shape {tuple(shape)} has {len(shape)} dims")
        return physical_spec(entries, shape=shape, mesh=mesh)


def physical_spec(entries: Sequence[Optional[str]],
                  shape: Optional[Sequence[int]] = None,
                  mesh: Any = None) -> Tuple[Optional[str], ...]:
    """Guard a raw ``(axis_or_None, ...)`` placement into a canonical spec:
    drop size-1 axes and axes absent from ``mesh``, drop axes that do not
    divide their dimension (when ``shape`` is known), never repeat an
    axis, strip trailing Nones."""
    sizes = dict(getattr(mesh, "shape", None) or {}) if mesh is not None \
        else {}
    out = []
    used = set()
    for i, axis in enumerate(entries):
        if axis is None or axis in used:
            out.append(None)
            continue
        size = sizes.get(axis) if sizes else None
        if mesh is not None and size is None:
            out.append(None)          # axis absent from this mesh
            continue
        if size is not None and size <= 1:
            out.append(None)          # one rank: replication
            continue
        if shape is not None and size is not None \
                and int(shape[i]) % int(size) != 0:
            out.append(None)          # divisibility fallback
            continue
        out.append(axis)
        used.add(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def model_dim(spec: Sequence[Optional[str]]) -> Optional[int]:
    """The dimension a resolved spec splits over the model axis, or
    None."""
    for i, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            return i
    return None


_DEFAULT_RULES: Optional[LogicalAxisRules] = None


def default_axis_rules() -> LogicalAxisRules:
    """The process-wide default table (validated once, cached)."""
    global _DEFAULT_RULES
    if _DEFAULT_RULES is None:
        _DEFAULT_RULES = LogicalAxisRules(DEFAULT_AXIS_RULES)
    return _DEFAULT_RULES


def cache_leaf_sharding(kind: str, mesh: Any = None,
                        rules: Optional[LogicalAxisRules] = None
                        ) -> Callable[[str, Any], Tuple]:
    """Per-leaf resolver for a serving cache container (``kind``:
    ``"stacked"`` or ``"paged"``): ``fn(key, leaf)`` (``leaf`` a tensor
    or a shape) returns ``(spec, index)``: the resolved spec of that leaf's
    layout against its shape, and one slice a dimension, this rank's
    share of each (``slice(None)`` where the dimension is whole), so
    ``leaf[index]`` is what this rank holds. An unknown key, or a shape
    whose rank disagrees with the layout, resolves to the whole leaf."""
    layouts = {"stacked": STACKED_CACHE_AXES,
               "paged": PAGED_CACHE_AXES}[kind]
    rules = rules if rules is not None else default_axis_rules()

    def leaf_sharding(key: str, leaf: Any) -> Tuple:
        m = mesh if mesh is not None else mesh_mod.get_mesh()
        axes = layouts.get(key)
        shape = tuple(getattr(leaf, "shape", leaf))
        if axes is None or len(axes) != len(shape):
            return (), (slice(None),) * len(shape)
        spec = rules.spec_for(axes, shape=shape, mesh=m)
        index = []
        for dim in range(len(shape)):
            axis = spec[dim] if dim < len(spec) else None
            if axis is None:
                index.append(slice(None))
                continue
            k = shape[dim] // m.axis_size(axis)
            r = m.axis_rank(axis)
            index.append(slice(r * k, (r + 1) * k))
        return spec, tuple(index)

    return leaf_sharding
