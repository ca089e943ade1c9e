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
one output channel's K weights are contiguous and the decode kernel streams
each row with 16-byte loads; ``scales`` is (N,) fp32. The JAX package stores
(K, N) with N on the TPU's lanes; the weight bridge transposes.

The JAX module's ``kernel_plan``, ``_pick_block`` and ``VMEM_BUDGET_BYTES``
are the TPU's tiling rules (128-lane blocks, a VMEM budget per grid step).
They have no counterpart here: the CUDA kernel masks ragged tiles itself and
takes any M, K and N, so no shape falls back to the plain version.

:func:`int8_matmul` takes :func:`int8_matmul_reference` only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_columns", "int8_matmul_reference", "int8_matmul"]


def quantize_columns(w: torch.Tensor, num_bits: int = 8):
    """Per-output-channel symmetric quantization of a (K, N) weight (the
    JAX layout, one column per output channel): returns int8 (K, N) values
    and fp32 (1, N) scales with ``w ≈ q * scales``. A zero column gets scale
    1. Rounding is half to even, as ``np.round``. Runs on ``w``'s device."""
    v = w.float()
    q_range = 2 ** (num_bits - 1) - 1
    scales = v.abs().amax(dim=0, keepdim=True) / q_range
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
    ``int8_matmul.launches``.
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
    launch("int8_matmul", x.device, DTYPE_CODES[x.dtype], x.data_ptr(),
           w.data_ptr(), scales.data_ptr(), DTYPE_CODES[out_dtype],
           out.data_ptr(), M, K, N)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
