"""Int8-weight matmul with the dequantization fused in: the CUDA kernel's
wrapper and its plain version.

Port of ``deepspeed_tpu/ops/quantization/int8_matmul.py``. The kernel is
``ops/csrc/int8_matmul.cu``, which replaces the TPU kernel ``_int8_matmul_2d``
(int8_matmul.py:143 in the JAX package; ``pallas_call`` at :152, body
``_kernel`` at :114). Its header says what bounds it on the H100 (bytes at
decode, operations at prefill) and how it streams the weights.

Contract (the JAX one): ``y = cast((bf16(x) @ w) * scale)``, the int8
weights widened exactly, an fp32 accumulator, the per-output-channel scale
applied once to the sum, then a cast to ``out_dtype``.

Weight layout: ``w`` is (N, K) int8, row-major like ``nn.Linear.weight``, so
one output channel's K weights are contiguous: the kernel's tensor-core
operand A, whose rows are output channels; ``scales`` is (N,) fp32.
The JAX package stores (K, N) with N on the TPU's lanes; the weight bridge
transposes.

The JAX module's ``kernel_plan``, ``_pick_block`` and ``VMEM_BUDGET_BYTES``
are the TPU's tiling rules (128-lane blocks, a VMEM budget per grid step).
Their counterpart here is :func:`int8_plan`, which picks the CUDA kernel's
tile shape by M and how many blocks split each output tile's K range; the
kernel masks ragged tiles itself and takes any M, K and N, so no shape falls
back to the plain version.

:func:`int8_matmul` takes :func:`int8_matmul_reference` only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_columns", "int8_matmul_reference", "int8_matmul",
           "int8_plan"]

# The tensor-core kernel's tile shapes (ops/csrc/int8_matmul.cu), by code:
# (output channels, tokens, k per pipeline stage) of one block; 1 and 2 are
# the decode tiles (mma.sync), 3 and 4 the prefill tiles (wgmma). Code 0 is
# the scalar kernel (any x dtype, K and alignment).
INT8_TILES = {1: (64, 8, 128), 2: (64, 16, 128), 3: (128, 64, 64),
              4: (128, 128, 64)}
# blocks of every tile shape that share an SM (the kernels' launch bounds)
BLOCKS_PER_SM = 2
# the most blocks one output tile's K range is split over: a portable
# thread-block cluster, whose blocks reduce their partial tiles in order
MAX_SPLITS = 8
# rows at most that take the decode tiles (8 or 16 tokens a block)
DECODE_ROWS = INT8_TILES[2][1]


def int8_plan(M: int, K: int, N: int, sm_count: int, aligned: bool = True):
    """``(tile, splits)`` for the CUDA kernel on (M, K) x (N, K)ᵀ.

    ``tile`` 0 (the scalar kernel) when ``K % 16`` or an unaligned x or w
    rules out the tensor-core kernel; else the smallest token tile that holds
    M (8 or 16 tokens for decode, 64 or 128 for prefill). ``splits``: the
    blocks sharing each output tile's K range. 1 when the output tiles fill
    a quarter of the card's block slots (``sm_count`` SMs,
    :data:`BLOCKS_PER_SM` each) or more: there a split's partial sums and
    reduction cost more than its blocks gain (PERF.md). Fewer tiles
    take 1 to :data:`MAX_SPLITS` splits, at most the tile's number of k
    slices, so that the blocks fill the slots in as few rounds as possible
    for the work each block does (a split's block does 1/splits of a tile):
    the smallest s that minimises ``ceil(tiles * s / slots) / s``."""
    if K % 16 or not aligned:
        return 0, 1
    tile = next(c for c, (_, bt, _) in INT8_TILES.items()
                if M <= bt or c == max(INT8_TILES))
    bw, bt, bk = INT8_TILES[tile]
    tiles = -(-N // bw) * -(-M // bt)
    slots = BLOCKS_PER_SM * sm_count
    if 4 * tiles >= slots:
        return tile, 1
    cap = min(MAX_SPLITS, -(-K // bk))
    splits = min(range(1, cap + 1),
                 key=lambda s: (-(-tiles * s // slots) / s, s))
    return tile, splits


def quantize_columns(w: torch.Tensor, num_bits: int = 8):
    """Per-output-channel symmetric quantization of a (K, N) weight (the
    JAX layout, one column per output channel): returns int8 (K, N) values
    and fp32 (1, N) scales with ``w ≈ q * scales``. A zero column gets scale
    1. Rounding is half to even, as ``np.round``. Runs on ``w``'s device."""
    v = w.float()
    q_range = 2 ** (num_bits - 1) - 1
    # a divisor tensor on w's device: CUDA divides by a Python number as a
    # multiply by its reciprocal, which can differ from the quotient by an
    # ulp, and then the card's scales would not be the host's or numpy's
    scales = v.abs().amax(dim=0, keepdim=True) / torch.full(
        (), q_range, dtype=torch.float32, device=v.device)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.round(v / scales).clamp(-q_range - 1, q_range).to(torch.int8)
    return q, scales


def int8_matmul_reference(x, w, scales, out_dtype=torch.bfloat16):
    """Plain PyTorch version: ``x`` rounded to bf16, the int8 weights
    widened, an fp32 product, the column scales, then ``out_dtype``. A
    bf16 x int8 product is exact in fp32, so this equals the JAX reference
    up to summation order (no bf16 GEMM, which would round its output).
    x (..., K); w (N, K) int8; scales (N,) or (1, N). Returns (..., N)."""
    y = x.to(torch.bfloat16).float() @ w.float().t()
    return (y * scales.reshape(-1).float()).to(out_dtype)


def int8_matmul(x, w, scales, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(bf16(x) @ w.T) * scales`` with the int8 expansion fused into the
    kernel.

    Args:
      x: (..., K) fp32, bf16 or fp16.
      w: (N, K) int8.
      scales: (N,) fp32 per output channel.
      out_dtype: fp32, bf16 or fp16.
    Returns (..., N) in ``out_dtype``. On CUDA each launch adds one to
    ``int8_matmul.launches``, and one more to
    ``int8_matmul.prefill_launches`` when x has more than
    :data:`DECODE_ROWS` rows (the prefill tiles).
    """
    if w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"int8_matmul wants x (..., K) and w (N, K); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    N, K = w.shape
    if scales.numel() != N:
        raise ValueError(f"scales must hold N={N} values, got "
                         f"{tuple(scales.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda, not "
                         f"{x.device.type}")
    from ..op_builder import DTYPE_CODES, launch

    if x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise ValueError(f"int8 kernel supports x/out dtypes "
                         f"{list(DTYPE_CODES)}; got {x.dtype}, {out_dtype}")
    if w.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"int8 kernel wants int8 weights and fp32 scales; "
                         f"got {w.dtype}, {scales.dtype}")
    for name, t in (("x", x), ("w", w), ("scales", scales)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8 kernel needs {name} contiguous on "
                             f"{x.device}")
    lead = x.shape[:-1]
    M = x.numel() // K
    out = torch.empty(*lead, N, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, splits = int8_plan(M, K, N, sms, aligned=x.data_ptr() % 16 == 0
                             and w.data_ptr() % 16 == 0)
    if tile and x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)    # the contract's bf16(x): tensor-core tiles
    launch("int8_matmul", x.device, DTYPE_CODES[x.dtype], x.data_ptr(),
           w.data_ptr(), scales.data_ptr(), DTYPE_CODES[out_dtype],
           out.data_ptr(), M, K, N, tile, splits)
    int8_matmul.launches += 1
    int8_matmul.prefill_launches += M > DECODE_ROWS
    return out


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0
