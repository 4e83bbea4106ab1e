// Fused InstanceNorm + FiLM (+ ReLU) over (B, H*W, C) tensors, f32 or bf16.
//
// Replaces: speedplusbaseline_tpu/ops/pallas_instancenorm.py,
//   instance_norm_film_pallas (kernel _inf_kernel). Per (b, c) over H*W:
//   mean and biased variance in f32, scale = rsqrt(var + eps) * gamma,
//   shift = beta - mean * scale, y = x * scale + shift, optional ReLU,
//   output in the input dtype.
//
// Bound on an H100: bytes. The function does ~4 flops per element and must
//   read x once and write y once, so at 3.35 TB/s it is memory-bound at every
//   Ghiasi shape (the largest, 48 x 224^2 x 32 bf16, is 154 MB of traffic).
//
// Design: the TPU kernel keeps one sample's whole plane in VMEM and uses one
//   grid step per sample. Here a plane is up to 50,176 rows per channel and a
//   block has 227 KB of shared memory, and 48 blocks would leave most of the
//   132 SMs idle. So the reduction is split over H*W in two launches:
//     1. in_stats_kernel: grid (B, chunks, C/32). Each block reduces one
//        chunk of rows for 32 channels; the 32 threads of a warp read 32
//        neighbouring channels of one row, so loads coalesce. It writes one
//        (mean, M2) partial per (b, chunk, c) to scratch.
//     2. in_apply_kernel: same grid. Each block first merges all partials of
//        its 32 channels (8 lanes per channel over a strided subset, then the
//        8 results in fixed order, so the result is deterministic: no float
//        atomics), then applies scale/shift (+ReLU) to its chunk.
//   Partials are merged with Chan's update (common.cuh), and within a thread
//   the sums are taken about the chunk's first value, so a large mean does
//   not cancel the variance. x is read twice (once per launch); the second
//   read often hits the 50 MB L2 at the smaller shapes.
#include "common.cuh"

namespace {

constexpr int CT = 32;  // channels per block (threadIdx.x)
constexpr int RT = 8;   // row lanes per block (threadIdx.y)

template <typename T>
__global__ void __launch_bounds__(CT * RT)
in_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int HW, int C,
                int rows_per_chunk, int nchunks) {
  const int b = blockIdx.x, chunk = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.z * CT + tx;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);

  __shared__ float s_n[RT][CT], s_mean[RT][CT], s_m2[RT][CT];
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    const T* xb = x + (size_t)b * HW * C + c;
    const float ref = gk::to_f32(xb[(size_t)r0 * C]);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += RT) {
      const float v = gk::to_f32(xb[(size_t)r * C]) - ref;
      s1 += v;
      s2 += v * v;
      n += 1.f;
    }
    if (n > 0.f) {
      mean = ref + s1 / n;
      m2 = fmaxf(s2 - s1 * s1 / n, 0.f);
    }
  }
  s_n[ty][tx] = n;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float na = s_n[0][tx], ma = s_mean[0][tx], m2a = s_m2[0][tx];
    for (int i = 1; i < RT; ++i) gk::chan_combine(na, ma, m2a, s_n[i][tx], s_mean[i][tx], s_m2[i][tx]);
    part[((size_t)b * nchunks + chunk) * C + c] = make_float2(ma, m2a);
  }
}

template <typename T>
__global__ void __launch_bounds__(CT * RT)
in_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float2* __restrict__ part,
                const float* __restrict__ gamma, const float* __restrict__ beta, int HW,
                int C, int rows_per_chunk, int nchunks, float eps, int relu) {
  const int b = blockIdx.x, chunk = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.z * CT + tx;

  // Merge the partials: lane ty takes chunks ty, ty + RT, ...; then lane 0
  // merges the RT results in order.
  __shared__ float s_n[RT][CT], s_mean[RT][CT], s_m2[RT][CT];
  __shared__ float s_scale[CT], s_shift[CT];
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    const float2* pb = part + (size_t)b * nchunks * C + c;
    for (int k = ty; k < nchunks; k += RT) {
      const float2 p = pb[(size_t)k * C];
      gk::chan_combine(n, mean, m2, gk::chunk_rows(k, rows_per_chunk, HW), p.x, p.y);
    }
  }
  s_n[ty][tx] = n;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float na = s_n[0][tx], ma = s_mean[0][tx], m2a = s_m2[0][tx];
    for (int i = 1; i < RT; ++i) gk::chan_combine(na, ma, m2a, s_n[i][tx], s_mean[i][tx], s_m2[i][tx]);
    const float var = fmaxf(m2a / (float)HW, 0.f);
    const float g = gamma ? gamma[(size_t)b * C + c] : 1.f;
    const float be = beta ? beta[(size_t)b * C + c] : 0.f;
    const float sc = rsqrtf(var + eps) * g;
    s_scale[tx] = sc;
    s_shift[tx] = be - ma * sc;
  }
  __syncthreads();
  if (c >= C) return;

  const float sc = s_scale[tx], sh = s_shift[tx];
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const size_t base = (size_t)b * HW * C + c;
#pragma unroll 4
  for (int r = r0 + ty; r < r1; r += RT) {
    float v = gk::to_f32(x[base + (size_t)r * C]) * sc + sh;
    if (relu) v = fmaxf(v, 0.f);
    y[base + (size_t)r * C] = gk::from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, float2* part, const float* gamma, const float* beta,
                   int B, int HW, int C, int rows_per_chunk, int nchunks, float eps, int relu,
                   cudaStream_t stream) {
  const dim3 grid(B, nchunks, (C + CT - 1) / CT);
  const dim3 block(CT, RT);
  in_stats_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), part, HW, C,
                                                 rows_per_chunk, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_apply_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                 part, gamma, beta, HW, C, rows_per_chunk,
                                                 nchunks, eps, relu);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, HW, C) contiguous, dtype by `dtype` (gk::DType). part: scratch of
// B * nchunks * C float2. gamma, beta: (B, C) f32 or null (1 and 0).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int gk_instance_norm_film(const void* x, void* y, void* part, const float* gamma,
                                     const float* beta, int B, int HW, int C,
                                     int rows_per_chunk, int nchunks, int dtype, float eps,
                                     int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(part);
  if (dtype == gk::kFloat32)
    return (int)launch<float>(x, y, p, gamma, beta, B, HW, C, rows_per_chunk, nchunks, eps, relu, s);
  if (dtype == gk::kBFloat16)
    return (int)launch<__nv_bfloat16>(x, y, p, gamma, beta, B, HW, C, rows_per_chunk, nchunks, eps,
                                      relu, s);
  return (int)cudaErrorInvalidValue;
}
