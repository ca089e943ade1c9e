"""``deepspeed_tpu_torch.parallel``: the process mesh over the
``torch.distributed`` world (``mesh.py``), its topology (``topology.py``)
and the logical axis rules that place tensors on it (``axis_rules.py``)."""

from .axis_rules import (  # noqa: F401
    DEFAULT_AXIS_RULES,
    PAGED_CACHE_AXES,
    STACKED_CACHE_AXES,
    LogicalAxisRules,
    cache_leaf_sharding,
    default_axis_rules,
    physical_spec,
    validate_axis_rules,
)
from .mesh import (  # noqa: F401
    BATCH_AXES,
    DATA_AXIS,
    DATA_OUTER_AXIS,
    EXPERT_AXIS,
    MESH_AXES,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    ZERO_AXES,
    MeshConfig,
    ProcessMesh,
    batch_axes,
    build_mesh,
    get_data_parallel_rank,
    get_data_parallel_world_size,
    get_expert_parallel_world_size,
    get_mesh,
    get_model_parallel_world_size,
    get_pipe_parallel_world_size,
    get_sequence_parallel_world_size,
    get_topology,
    get_world_size,
    has_mesh,
    initialize_mesh,
    reset_mesh,
    set_mesh,
)
from .topology import (  # noqa: F401
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    ProcessTopology,
)
