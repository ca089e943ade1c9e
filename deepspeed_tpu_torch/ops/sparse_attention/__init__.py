from .sparse_self_attention import (  # noqa: F401
    SparseSelfAttention,
    block_sparse_attention,
    layout_to_gather_indices,
)
from .sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
