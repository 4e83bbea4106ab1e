// Ghiasi residual block, forward only, as a chain of five launches.
//
// Replaces: speedplusbaseline_tpu/ops/pallas_resblock.py,
//   ghiasi_resblock_pallas (kernel _resblock_kernel). Per sample x (H, W, C):
//     y1 = conv3x3(reflect_pad1(x), W1) + b1
//     a1 = relu(FiLM1(instance_norm(y1)))
//     y2 = conv3x3(reflect_pad1(a1), W2) + b2
//     out = x + FiLM2(instance_norm(y2))          (cast to x's dtype)
//   The convs accumulate in f32 from f32 operands, as the Pallas kernel does
//   (it upcasts a bf16 x before its matmuls).
//
// Bound on an H100: operations. At the Ghiasi shape (48, 56, 56, 128) one
//   call is 2 convs x 48 x 2 * 9 * 128^2 * 3136 = 88.8 GFLOP against ~77 MB
//   of compulsory traffic in bf16. In f32 on the CUDA cores (67 TFLOP/s) the
//   floor is 1.33 ms; on bf16 tensor cores (989 TFLOP/s) it would be 0.09 ms.
//
// Design: the Pallas kernel holds a whole 56^2 x 128 slab of one sample
//   (1.6 MB in f32) in VMEM; an SM has 227 KB of shared memory, and the IN
//   between the convs needs a reduction over all H*W per channel. So:
//     1. conv3x3_kernel<T, false>: implicit GEMM, 64 pixels x 64 output
//        channels per block, K = 9 taps x C in steps of 16. The reflect pad is
//        folded into the operand gather (no padded copy is made). The
//        epilogue adds the bias, writes y1 (f32 scratch) and one
//        (mean, M2) partial per (b, pixel tile, c).
//     2. in_finalize_kernel: merges the partials of each (b, c) in order
//        (Chan's update, common.cuh) into scale/shift with FiLM1 folded in.
//     3. conv3x3_kernel<float, true>: conv 2, applying IN1 + FiLM1 + ReLU to
//        each operand as it is gathered, so the normalised y1 never goes to
//        device memory; writes y2 and its partials.
//     4. in_finalize_kernel for IN2 + FiLM2.
//     5. residual_kernel: out = x + y2 * scale + shift, cast to x's dtype.
//   The conv is a plain shared-memory tiled FMA loop (4 x 4 outputs per
//   thread). Tensor cores (wgmma) and TMA pipelining are left for later.
//   Takes any H, W >= 2 (odd sizes included) and any C.
#include "common.cuh"

namespace {

constexpr int TP = 64;   // output pixels per block
constexpr int TC = 64;   // output channels per block
constexpr int KC = 16;   // input channels per K step
constexpr int NT = 256;  // threads per block
constexpr int FIN_THREADS = 128;

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// in: (B, H*W, C) of T. w: (3, 3, C, C) HWIO f32. out: (B, H*W, C) f32.
// part: (B, ntiles, C) float2 of (mean, M2) over each tile's valid pixels.
// NORM: operand = relu(in * in_scale[b, cin] + in_shift[b, cin]).
template <typename T, bool NORM>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ in, const float* __restrict__ in_scale,
               const float* __restrict__ in_shift, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               float2* __restrict__ part, int H, int W, int C, int ntiles) {
  const int tile = blockIdx.x, co0 = blockIdx.y * TC, b = blockIdx.z;
  const int HW = H * W;
  const int p0 = tile * TP;
  const int t = threadIdx.x;

  __shared__ __align__(16) float As[KC][TP + 4];
  __shared__ __align__(16) float Bs[KC][TC];
  __shared__ float s_n[16][TC], s_mean[16][TC], s_m2[16][TC];

  // Operand gather: thread t loads input channel (t % KC) for the four
  // pixels (t / KC) + 16 * i of the tile.
  const int ld_k = t % KC;
  int ld_h[4], ld_w[4];
  bool ld_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + t / KC + 16 * i;
    ld_ok[i] = p < HW;
    ld_h[i] = ld_ok[i] ? p / W : 0;
    ld_w[i] = ld_ok[i] ? p % W : 0;
  }

  const int tp = t % 16, tc = t / 16;  // this thread's 4 pixels / 4 channels
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const T* inb = in + (size_t)b * HW * C;
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    int src[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      src[i] = ld_ok[i] ? reflect1(ld_h[i] + di, H) * W + reflect1(ld_w[i] + dj, W) : -1;

    for (int c0 = 0; c0 < C; c0 += KC) {
      const int cin = c0 + ld_k;
      float sc = 1.f, sh = 0.f;
      if (NORM && cin < C) {
        sc = in_scale[(size_t)b * C + cin];
        sh = in_shift[(size_t)b * C + cin];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.f;
        if (src[i] >= 0 && cin < C) {
          v = gk::to_f32(inb[(size_t)src[i] * C + cin]);
          if (NORM) v = fmaxf(v * sc + sh, 0.f);
        }
        As[ld_k][t / KC + 16 * i] = v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = t + NT * i;
        const int k = idx / TC, cc = idx % TC;
        const int ci = c0 + k, co = co0 + cc;
        Bs[k][cc] = (ci < C && co < C) ? w[((size_t)tap * C + ci) * C + co] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][tp * 4]);
        const float4 bb = *reinterpret_cast<const float4*>(&Bs[k][tc * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue: bias, store, per-thread (n, mean, M2) over its valid pixels.
  float* outb = out + (size_t)b * HW * C;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tc * 4 + j;
    const float bj = co < C ? bias[co] : 0.f;
    float n = 0.f, s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tp * 4 + i;
      acc[i][j] += bj;
      if (p < HW) {
        if (co < C) outb[(size_t)p * C + co] = acc[i][j];
        n += 1.f;
        s += acc[i][j];
      }
    }
    const float mean = n > 0.f ? s / n : 0.f;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + tp * 4 + i < HW) {
        const float d = acc[i][j] - mean;
        m2 += d * d;
      }
    }
    s_n[tp][tc * 4 + j] = n;
    s_mean[tp][tc * 4 + j] = mean;
    s_m2[tp][tc * 4 + j] = m2;
  }
  __syncthreads();
  if (t < TC && co0 + t < C) {
    float n = s_n[0][t], mean = s_mean[0][t], m2 = s_m2[0][t];
    for (int i = 1; i < 16; ++i) gk::chan_combine(n, mean, m2, s_n[i][t], s_mean[i][t], s_m2[i][t]);
    part[((size_t)b * ntiles + tile) * C + co0 + t] = make_float2(mean, m2);
  }
}

__global__ void in_finalize_kernel(const float2* __restrict__ part, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ scale,
                                   float* __restrict__ shift, int HW, int C, int ntiles,
                                   float eps) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t bc = (size_t)b * C + c;
  gk::finalize_channel(part + (size_t)b * ntiles * C, ntiles, TP, HW, C, c, gamma[bc], beta[bc],
                       eps, &scale[bc], &shift[bc]);
}

template <typename T>
__global__ void residual_kernel(const T* __restrict__ x, const float* __restrict__ y,
                                const float* __restrict__ scale, const float* __restrict__ shift,
                                T* __restrict__ out, int HW, int C, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t bc = (i / ((size_t)HW * C)) * C + c;
    out[i] = gk::from_f32<T>(gk::to_f32(x[i]) + y[i] * scale[bc] + shift[bc]);
  }
}

template <typename T>
cudaError_t run(const void* xv, void* outv, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* g1, const float* be1, const float* g2,
                const float* be2, float* y1, float* y2, float2* part, float* scale, float* shift,
                int B, int H, int W, int C, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int HW = H * W;
  const int ntiles = (HW + TP - 1) / TP;
  const dim3 cgrid(ntiles, (C + TC - 1) / TC, B);
  const dim3 fgrid(B, (C + FIN_THREADS - 1) / FIN_THREADS);
  cudaError_t err;

  conv3x3_kernel<T, false><<<cgrid, NT, 0, s>>>(x, nullptr, nullptr, w1, b1, y1, part, H, W, C,
                                                ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_finalize_kernel<<<fgrid, FIN_THREADS, 0, s>>>(part, g1, be1, scale, shift, HW, C, ntiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv3x3_kernel<float, true><<<cgrid, NT, 0, s>>>(y1, scale, shift, w2, b2, y2, part, H, W, C,
                                                   ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_finalize_kernel<<<fgrid, FIN_THREADS, 0, s>>>(part, g2, be2, scale, shift, HW, C, ntiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)B * HW * C;
  const size_t want = (total + 255) / 256;
  const int rblocks = (int)(want < 132 * 16 ? want : 132 * 16);
  residual_kernel<T><<<rblocks, 256, 0, s>>>(x, y2, scale, shift, out, HW, C, total);
  return cudaGetLastError();
}

}  // namespace

// Pixels per conv tile: the wrapper sizes `part` as (B, ceil(H*W / this), C).
extern "C" int gk_resblock_tile_pixels(void) { return TP; }

// x, out: (B, H, W, C) contiguous, dtype by `dtype` (gk::DType). w1, w2:
// (3, 3, C, C) f32 HWIO; b1, b2: (C,) f32; g1, be1, g2, be2: (B, C) f32.
// Scratch: y1, y2 (B, H*W, C) f32; part (B, ntiles, C) float2; scale, shift
// (B, C) f32. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int gk_resblock(const void* x, void* out, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* g1, const float* be1,
                           const float* g2, const float* be2, float* y1, float* y2, void* part,
                           float* scale, float* shift, int B, int H, int W, int C, int dtype,
                           float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(part);
  if (dtype == gk::kFloat32)
    return (int)run<float>(x, out, w1, b1, w2, b2, g1, be1, g2, be2, y1, y2, p, scale, shift, B,
                           H, W, C, eps, s);
  if (dtype == gk::kBFloat16)
    return (int)run<__nv_bfloat16>(x, out, w1, b1, w2, b2, g1, be1, g2, be2, y1, y2, p, scale,
                                   shift, B, H, W, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
