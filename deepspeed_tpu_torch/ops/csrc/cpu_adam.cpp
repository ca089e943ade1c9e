// Host-side Adam/AdamW and Adagrad for offloaded optimizer state.
//
// The PyTorch/CUDA package's copy of the JAX package's host op (same C ABI,
// same arithmetic), bound by ops/adam/cpu_adam.py (DeepSpeedCPUAdam). It
// updates fp32 master weights and moments in host memory for ZeRO-Offload:
// the gradients come down from the card into pinned buffers, this op runs
// on them, and the new bf16 parameters (ds_f32_to_bf16) go back up.
// Vectorization is left to the compiler (-O3 -march=native + omp simd), so
// the same source serves AVX2, AVX-512 and NEON hosts.
//
// C ABI (ctypes-bound):
//   ds_adam_step     - fused m/v/param update over a flat fp32 span
//   ds_adagrad_step  - Adagrad over a flat fp32 span
//   ds_f32_to_bf16   - round-to-nearest-even fp32 -> bf16 copy
//   ds_has_nonfinite - overflow probe for fp16 loss scaling

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// One fused Adam step over [0, n). Bias corrections are precomputed by the
// caller (bc1 = 1-beta1^t, bc2 = 1-beta2^t; pass 1.0/1.0 to disable).
// adamw != 0 → decoupled weight decay; else L2 added to the gradient.
void ds_adam_step(float* __restrict__ param,
                  const float* __restrict__ grad,
                  float* __restrict__ exp_avg,
                  float* __restrict__ exp_avg_sq,
                  int64_t n,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adamw, float bc1, float bc2) {
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grad[i];
    float p = param[i];
    if (weight_decay != 0.0f && !adamw) g += weight_decay * p;
    float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
    float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    float update = (m * inv_bc1) / denom;
    if (weight_decay != 0.0f && adamw) update += weight_decay * p;
    param[i] = p - lr * update;
  }
}

// Adagrad step (≅ csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(float* __restrict__ param,
                     const float* __restrict__ grad,
                     float* __restrict__ accum,
                     int64_t n, float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grad[i];
    float p = param[i];
    if (weight_decay != 0.0f) g += weight_decay * p;
    float a = accum[i] + g * g;
    accum[i] = a;
    param[i] = p - lr * g / (std::sqrt(a) + eps);
  }
}

// fp32 → bf16 with round-to-nearest-even (what the device expects).
void ds_f32_to_bf16(uint16_t* __restrict__ dst,
                    const float* __restrict__ src, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], 4);
    uint32_t rounding = 0x7FFFu + ((bits >> 16) & 1u);
    dst[i] = (uint16_t)((bits + rounding) >> 16);
  }
}

// Returns 1 if any element is NaN/Inf (overflow probe for dynamic loss
// scaling, ≅ _has_inf_or_nan on the CPU-offload path).
int ds_has_nonfinite(const float* __restrict__ x, int64_t n) {
  int bad = 0;
#pragma omp parallel for schedule(static) reduction(|| : bad)
  for (int64_t i = 0; i < n; ++i) {
    bad = bad || !std::isfinite(x[i]);
  }
  return bad ? 1 : 0;
}

}  // extern "C"
