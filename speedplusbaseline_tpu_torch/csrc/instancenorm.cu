// Fused InstanceNorm + FiLM (+ ReLU) over (B, H*W, C) tensors, f32 or bf16.
//
// Replaces: speedplusbaseline_tpu/ops/pallas_instancenorm.py,
//   instance_norm_film_pallas (kernel _inf_kernel). Per (b, c) over H*W:
//   mean and biased variance in f32, scale = rsqrt(var + eps) * gamma,
//   shift = beta - mean * scale, y = x * scale + shift, optional ReLU,
//   output in the input dtype.
//
// Bound on an H100: bytes. About 6 flops per element against one read of x
//   and one write of y, 2 * B*H*W*C * elem bytes at 3.35 TB/s (the main
//   path's six bf16 sites: 0.308 ms per styled step).
//
// Design. The TPU kernel keeps one sample's plane in VMEM: one read of x, one
//   write of y. One Hopper block's 227 KB cannot hold a plane (up to 3.2 MB in
//   bf16), but a thread block cluster can: its blocks read each other's shared
//   memory (DSMEM) and synchronise in hardware. ops/instancenorm.py::plan
//   picks one of two paths from shape, dtype and the card's limits.
//
//   in_cluster_kernel, one read of x: grid (K, B), one cluster of K <= 16
//     blocks per sample. Block r lands bytes [r*S/K, (r+1)*S/K) of the
//     sample's contiguous S-byte slab in shared memory by cp.async.bulk, in
//     LOAD_PIECES pieces on their own mbarriers, so the first sums start while
//     the rest lands. The statistics are two exact passes over shared memory:
//     per-channel sums, published by every block and read back from all K
//     blocks through DSMEM in rank order (deterministic, no atomics), give the
//     mean; the centred sums of squares, the same way, the variance. Each
//     block then applies scale/shift (+ReLU) in place and stores each piece by
//     cp.async.bulk as soon as it is done. Threads * VEC is a multiple of C,
//     so a thread holds the same VEC channels in every sweep and no lane idles
//     at C = 3. A block keeps its shared memory until every peer has read it:
//     it arrives on the cluster barrier after its last DSMEM read and waits on
//     it before it exits.
//   in_stats_kernel -> gk::in_finalize_kernel -> in_apply_kernel, two reads of x:
//     for slabs no cluster holds (f32 224^2 x 32 is 6.4 MB), slabs that do not
//     split on 16-byte bounds, and channel counts no block size serves. H*W is
//     cut into chunks; (mean, M2) partials per chunk, summed about the chunk's
//     first row so that a large mean does not cancel, are merged by Chan's
//     update in chunk order (common.cuh) into per-(b, c) scale/shift, then
//     applied. 16-byte loads where C * elem % 16 == 0; lanes over channel
//     vectors only as many as C needs (4 lanes at C = 3).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LOAD_PIECES = 4;    // bulk loads (and stores) per cluster block
constexpr int MAX_CLUSTER = 16;   // non-portable cluster size of sm_90
constexpr int MAX_THREADS = 512;  // cluster blocks: up to 128 registers a thread
constexpr int BAR_BYTES = 128;    // the mbarriers, ahead of the slab in shared memory
constexpr int TP_THREADS = 256;   // two-pass blocks

// 16 bytes <-> 4 f32 or 8 bf16 values as floats, in registers.
__device__ __forceinline__ void unpack(uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}

// V elements of T at p (16 bytes, or one element) <-> V floats.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  static_assert(V == 1 || V * sizeof(T) == 16, "one element or 16 bytes");
  if constexpr (V == 1)
    v[0] = gk::to_f32(*p);
  else
    unpack(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1)
    *p = gk::from_f32<T>(v[0]);
  else
    *reinterpret_cast<uint4*>(p) = pack(v);
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(gk::smem_u32(src)), "r"(bytes)
               : "memory");
}

// ---- one read of x: a cluster per sample ------------------------------------

// This block's per-channel sums of `acc` into out[C]. Slot k of thread t holds
// channel (c0 + t * VEC + k) % C. red[] is halved while the halves stay
// channel-aligned, then each channel's remaining terms are summed in order.
template <int VEC>
__device__ void block_channel_sums(const float (&acc)[VEC], float* red, float* out, int c0,
                                   int C) {
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[tid * VEC + k] = acc[k];
  __syncthreads();
  int len = nt * VEC;
  while ((len / C) % 2 == 0) {
    const int h = len / 2;
    for (int p = tid; p < h; p += nt) red[p] += red[p + h];
    __syncthreads();
    len = h;
  }
  for (int c = tid; c < C; c += nt) {
    float s = 0.f;
    for (int p = c; p < len; p += C) s += red[p];
    out[(c0 + c) % C] = s;
  }
}

// arr[c] summed over the cluster's blocks in rank order; all loads in flight.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* arr, int c,
                                             int K) {
  float v[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) v[q] = q < K ? cluster.map_shared_rank(arr, q)[c] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) s += v[q];
  return s;
}

// Dynamic shared memory: [mbarriers | slab bytes | red: threads*VEC |
// sum, sumsq, mean, scale, shift: C each] (floats after the slab).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
in_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int HW, int C, int block_bytes, float eps,
                  int relu) {
  constexpr int VEC = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* slab = smem + BAR_BYTES;
  T* data = reinterpret_cast<T*>(slab);
  float* red = reinterpret_cast<float*>(slab + block_bytes);
  float* s_sum = red + nt * VEC;
  float* s_sq = s_sum + C;
  float* s_mean = s_sq + C;
  float* s_scale = s_mean + C;
  float* s_shift = s_scale + C;

  const size_t off = (size_t)b * HW * C * sizeof(T) + (size_t)r * block_bytes;
  const int nvec = block_bytes / 16;
  // Vectors per piece, a whole number of sweeps of the block.
  const int piece = ((nvec + nt - 1) / nt + LOAD_PIECES - 1) / LOAD_PIECES * nt;

  if (tid == 0) {
    for (int j = 0; j < LOAD_PIECES; ++j) gk::mbar_init(&bar[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j * piece < nvec; ++j) {
      const int v0 = j * piece, bytes = min(piece, nvec - v0) * 16;
      gk::mbar_expect_tx(&bar[j], bytes);
      gk::bulk_load(slab + (size_t)v0 * 16, reinterpret_cast<const uint8_t*>(x) + off + v0 * 16,
                    bytes, &bar[j]);
    }
  }

  const int c0 = (int)(((size_t)r * (block_bytes / sizeof(T))) % C);
  int ch[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) ch[k] = (c0 + tid * VEC + k) % C;

  // Pass 1: sums, piece by piece as they land.
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int j = 0; j * piece < nvec; ++j) {
    while (!gk::mbar_try_wait(&bar[j], 0)) {
    }
    const int v1 = min(nvec, (j + 1) * piece);
    for (int v = j * piece + tid; v < v1; v += nt) {
      float e[VEC];
      load_vec<T, VEC>(data + (size_t)v * VEC, e);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += e[k];
    }
  }
  block_channel_sums<VEC>(acc, red, s_sum, c0, C);
  cluster.sync();
  for (int c = tid; c < C; c += nt) s_mean[c] = cluster_sum(cluster, s_sum, c, K) / (float)HW;
  __syncthreads();

  // Pass 2: centred sums of squares.
  float mu[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mu[k] = s_mean[ch[k]];
    acc[k] = 0.f;
  }
  for (int v = tid; v < nvec; v += nt) {
    float e[VEC];
    load_vec<T, VEC>(data + (size_t)v * VEC, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = e[k] - mu[k];
      acc[k] += d * d;
    }
  }
  block_channel_sums<VEC>(acc, red, s_sq, c0, C);
  cluster.sync();
  for (int c = tid; c < C; c += nt) {
    const float var = cluster_sum(cluster, s_sq, c, K) / (float)HW;
    const size_t bc = (size_t)b * C + c;
    const float sc = rsqrtf(var + eps) * (gamma ? gamma[bc] : 1.f);
    s_scale[c] = sc;
    s_shift[c] = (beta ? beta[bc] : 0.f) - s_mean[c] * sc;
  }
  // The last read of a peer's shared memory is done: arrive now, wait at exit.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();

  // Apply in place, and store each piece as soon as it is done.
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sc[k] = s_scale[ch[k]];
    sh[k] = s_shift[ch[k]];
  }
  for (int j = 0; j * piece < nvec; ++j) {
    const int v0 = j * piece, v1 = min(nvec, v0 + piece);
    for (int v = v0 + tid; v < v1; v += nt) {
      float e[VEC];
      load_vec<T, VEC>(data + (size_t)v * VEC, e);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float o = e[k] * sc[k] + sh[k];
        e[k] = relu ? fmaxf(o, 0.f) : o;
      }
      store_vec<T, VEC>(data + (size_t)v * VEC, e);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(reinterpret_cast<uint8_t*>(y) + off + v0 * 16, slab + (size_t)v0 * 16,
                 (v1 - v0) * 16);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T>
cudaError_t cluster_config(int B, int K, int threads, int smem_bytes, cudaStream_t s,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(in_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  if (K > 8) {
    err = cudaFuncSetAttribute(in_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(K, B, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* y, const float* gamma, const float* beta, int B,
                           int HW, int C, int K, int block_bytes, int threads, int smem_bytes,
                           float eps, int relu, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t need = BAR_BYTES + (size_t)block_bytes + 4 * ((size_t)threads * VEC + 5 * C);
  if (K < 1 || K > MAX_CLUSTER || block_bytes % 16 != 0 ||
      (size_t)K * block_bytes != (size_t)HW * C * sizeof(T) || threads % 32 != 0 ||
      threads > MAX_THREADS || (threads * VEC) % C != 0 || (size_t)smem_bytes < need)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(B, K, threads, smem_bytes, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, in_cluster_kernel<T>, static_cast<const T*>(x),
                           static_cast<T*>(y), gamma, beta, HW, C, block_bytes, eps, relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- two reads of x ---------------------------------------------------------
//
// Block (CT, RT), CT * RT = TP_THREADS, grid (samples, chunks, channel tiles):
// thread (tx, ty) holds channels c .. c + V - 1, c = (blockIdx.z * CT + tx) * V,
// and rows r0 + ty, r0 + ty + RT, ... of its chunk.

template <typename T, int V>
__global__ void __launch_bounds__(TP_THREADS)
in_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int HW, int C,
                int rows_per_chunk, int nchunks) {
  const int b = blockIdx.x, chunk = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y, CT = blockDim.x, RT = blockDim.y;
  const int c = (blockIdx.z * CT + tx) * V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);

  __shared__ float s_n[TP_THREADS], s_mean[TP_THREADS * V], s_m2[TP_THREADS * V];
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
  if (c < C) {
    const T* xb = x + (size_t)b * HW * C + c;
    float ref[V], s1[V], s2[V];
    load_vec<T, V>(xb + (size_t)r0 * C, ref);
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += RT) {
      float v[V];
      load_vec<T, V>(xb + (size_t)r * C, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[k] - ref[k];
        s1[k] += d;
        s2[k] += d * d;
      }
      n += 1.f;
    }
    if (n > 0.f) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        mean[k] = ref[k] + s1[k] / n;
        m2[k] = fmaxf(s2[k] - s1[k] * s1[k] / n, 0.f);
      }
    }
  }
  if (tx == 0) s_n[ty] = n;  // lane 0 of a channel tile always holds channels
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_mean[(ty * CT + tx) * V + k] = mean[k];
    s_m2[(ty * CT + tx) * V + k] = m2[k];
  }
  __syncthreads();
  // Thread (tx, k) merges channel c + k over the RT row lanes, in order.
  if (ty < V && c < C) {
    const int k = ty;
    float na = s_n[0], ma = s_mean[tx * V + k], m2a = s_m2[tx * V + k];
    for (int i = 1; i < RT; ++i)
      gk::chan_combine(na, ma, m2a, s_n[i], s_mean[(i * CT + tx) * V + k],
                       s_m2[(i * CT + tx) * V + k]);
    part[((size_t)b * nchunks + chunk) * C + c + k] = make_float2(ma, m2a);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(TP_THREADS)
in_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ scale,
                const float* __restrict__ shift, int HW, int C, int rows_per_chunk, int relu) {
  const int b = blockIdx.x, chunk = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y, CT = blockDim.x, RT = blockDim.y;
  const int c = (blockIdx.z * CT + tx) * V;
  if (c >= C) return;
  float sc[V], sh[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sc[k] = scale[(size_t)b * C + c + k];
    sh[k] = shift[(size_t)b * C + c + k];
  }
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const size_t base = (size_t)b * HW * C + c;
#pragma unroll 4
  for (int r = r0 + ty; r < r1; r += RT) {
    float v[V];
    load_vec<T, V>(x + base + (size_t)r * C, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float o = v[k] * sc[k] + sh[k];
      v[k] = relu ? fmaxf(o, 0.f) : o;
    }
    store_vec<T, V>(y + base + (size_t)r * C, v);
  }
}

template <typename T, int V>
cudaError_t launch_two_pass(const void* xv, void* yv, float2* part, float* scale_shift,
                            const float* gamma, const float* beta, int B, int HW, int C,
                            int rows_per_chunk, int nchunks, int ct, float eps, int relu,
                            cudaStream_t s) {
  if (ct < 1 || ct > 32 || (ct & (ct - 1)) != 0 || C % V != 0 || rows_per_chunk < 1 ||
      (size_t)rows_per_chunk * nchunks < (size_t)HW)
    return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  float* scale = scale_shift;
  float* shift = scale_shift + (size_t)B * C;
  const dim3 block(ct, TP_THREADS / ct);
  const dim3 grid(B, nchunks, (C + ct * V - 1) / (ct * V));
  in_stats_kernel<T, V><<<grid, block, 0, s>>>(x, part, HW, C, rows_per_chunk, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gk::in_finalize_kernel<<<dim3(B, (C + 127) / 128), 128, 0, s>>>(part, gamma, beta, scale, shift,
                                                                  HW, C, rows_per_chunk, nchunks,
                                                                  eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_apply_kernel<T, V><<<grid, block, 0, s>>>(x, y, scale, shift, HW, C, rows_per_chunk, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t two_pass(int vec, const void* x, void* y, float2* part, float* ss, const float* gamma,
                     const float* beta, int B, int HW, int C, int per, int nchunks, int ct,
                     float eps, int relu, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec == 1)
    return launch_two_pass<T, 1>(x, y, part, ss, gamma, beta, B, HW, C, per, nchunks, ct, eps,
                                 relu, s);
  if (vec == VEC)
    return launch_two_pass<T, VEC>(x, y, part, ss, gamma, beta, B, HW, C, per, nchunks, ct, eps,
                                   relu, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One read of x. x, y: (B, HW, C) contiguous, dtype by `dtype` (gk::DType),
// 16-byte aligned. gamma, beta: (B, C) f32 or null (1 and 0). K blocks of
// `threads` each per sample, block_bytes = HW * C * elem / K (a multiple of
// 16), smem_bytes of dynamic shared memory per block (at least 128 +
// block_bytes + 4 * (threads * 16 / elem + 5 * C)). Returns the launch error
// (0 on success); a shape these do not describe is cudaErrorInvalidValue.
extern "C" int gk_in_cluster(const void* x, void* y, const float* gamma, const float* beta, int B,
                             int HW, int C, int K, int block_bytes, int threads, int smem_bytes,
                             int dtype, float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == gk::kFloat32)
    return (int)launch_cluster<float>(x, y, gamma, beta, B, HW, C, K, block_bytes, threads,
                                      smem_bytes, eps, relu, s);
  if (dtype == gk::kBFloat16)
    return (int)launch_cluster<__nv_bfloat16>(x, y, gamma, beta, B, HW, C, K, block_bytes,
                                              threads, smem_bytes, eps, relu, s);
  return (int)cudaErrorInvalidValue;
}

// Two reads of x. part: scratch of B * nchunks * C float2; scale_shift:
// scratch of 2 * B * C f32. vec: 1, or 16 / elem when C * elem % 16 == 0; ct:
// channel lanes per block (a power of two <= 32).
extern "C" int gk_in_two_pass(const void* x, void* y, void* part, float* scale_shift,
                              const float* gamma, const float* beta, int B, int HW, int C,
                              int rows_per_chunk, int nchunks, int vec, int ct, int dtype,
                              float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(part);
  if (dtype == gk::kFloat32)
    return (int)two_pass<float>(vec, x, y, p, scale_shift, gamma, beta, B, HW, C, rows_per_chunk,
                                nchunks, ct, eps, relu, s);
  if (dtype == gk::kBFloat16)
    return (int)two_pass<__nv_bfloat16>(vec, x, y, p, scale_shift, gamma, beta, B, HW, C,
                                        rows_per_chunk, nchunks, ct, eps, relu, s);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters for clusters of K blocks of `threads` threads
// and smem_bytes of dynamic shared memory each, on the current device: the
// count (0 if no such cluster fits), or minus the CUDA error.
extern "C" int gk_in_max_active_clusters(int dtype, int K, int threads, int smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err;
  if (dtype == gk::kFloat32) {
    err = cluster_config<float>(1, K, threads, smem_bytes, nullptr, &cfg, &attr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, in_cluster_kernel<float>, &cfg);
  } else if (dtype == gk::kBFloat16) {
    err = cluster_config<__nv_bfloat16>(1, K, threads, smem_bytes, nullptr, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, in_cluster_kernel<__nv_bfloat16>, &cfg);
  } else {
    err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? n : -(int)err;
}
