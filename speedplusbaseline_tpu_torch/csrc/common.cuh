// Shared device helpers for the Ghiasi kernels (instancenorm.cu, resblock.cu).
//
// Split statistics are carried as (count, mean, M2) triples and merged with
// the pairwise update of Chan, Golub and LeVeque. Raw sum / sum-of-squares
// would compute var = s2/n - mean^2, which cancels badly in f32 over a 224^2
// plane when |mean| is much larger than the standard deviation.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and bulk copy (sm_90) -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Global -> this block's shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Merge (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a).
__device__ __forceinline__ void chan_combine(float& n_a, float& mean_a, float& m2_a,
                                             float n_b, float mean_b, float m2_b) {
  if (n_b == 0.f) return;
  const float n = n_a + n_b;
  const float delta = mean_b - mean_a;
  const float r = n_b / n;
  mean_a += delta * r;
  m2_a += m2_b + delta * delta * n_a * r;
  n_a = n;
}

// Rows covered by chunk k when `rows` rows are cut into chunks of `per`.
__device__ __forceinline__ float chunk_rows(int k, int per, int rows) {
  return (float)min(per, rows - k * per);
}

// Instance-norm scale/shift of one channel from its per-chunk partials:
// scale = rsqrt(var + eps) * gamma, shift = beta - mean * scale, with the
// biased variance clamped at 0. `part` points at this sample's (nchunks, C)
// float2 array of (mean, M2); the chunks are merged in index order.
__device__ __forceinline__ void finalize_channel(const float2* __restrict__ part,
                                                 int nchunks, int rows_per_chunk, int rows,
                                                 int C, int c, float gamma, float beta,
                                                 float eps, float* scale, float* shift) {
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    const float2 p = part[(size_t)k * C + c];
    chan_combine(n, mean, m2, chunk_rows(k, rows_per_chunk, rows), p.x, p.y);
  }
  const float var = fmaxf(m2 / (float)rows, 0.f);
  const float sc = rsqrtf(var + eps) * gamma;
  *scale = sc;
  *shift = beta - mean * sc;
}

// finalize_channel for every (b, c): part is (B, nchunks, C) float2, scale
// and shift (B, C); gamma and beta (B, C) or null (1 and 0). Grid (B,
// ceil(C / blockDim.x)).
__global__ void in_finalize_kernel(const float2* __restrict__ part,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ scale,
                                   float* __restrict__ shift, int HW, int C, int rows_per_chunk,
                                   int nchunks, float eps) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t bc = (size_t)b * C + c;
  finalize_channel(part + (size_t)b * nchunks * C, nchunks, rows_per_chunk, HW, C, c,
                   gamma ? gamma[bc] : 1.f, beta ? beta[bc] : 0.f, eps, &scale[bc], &shift[bc]);
}

}  // namespace gk
