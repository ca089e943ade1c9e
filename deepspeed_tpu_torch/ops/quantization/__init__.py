"""Int8 serving compute: the CUDA dequant-GEMM and the int8-at-rest linear
layer (port of ``deepspeed_tpu/ops/quantization``)."""

from .convert import DENSE_KEYS, quantize_lm_params  # noqa: F401
from .int8_matmul import (int8_matmul, int8_matmul_reference,  # noqa: F401
                          quantize_columns)
from .linear import QuantDense  # noqa: F401
