"""``deepspeed_tpu_torch.comm``: the ``deepspeed.comm`` facade on
``torch.distributed`` (``comm.py``)."""

from .comm import (  # noqa: F401
    ReduceOp,
    all_gather_host,
    all_gather_into_tensor,
    all_reduce,
    all_reduce_host,
    all_to_all_single,
    assert_same_across_ranks,
    axis_index,
    barrier,
    broadcast,
    broadcast_host,
    comms_logger,
    configure,
    get_backend,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    log_summary,
    ppermute,
    reduce_scatter_tensor,
    stable_hash,
    timed_op,
)
