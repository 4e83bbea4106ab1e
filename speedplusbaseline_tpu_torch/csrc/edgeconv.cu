// Reflect pad 4 + 9x9 conv + bias of the Ghiasi generator's first and last
// layers, forward only, bf16 in and out, on the tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (speedplusbaseline_tpu/models/ghiasi.py). On the card, in bf16, cuDNN runs
// layer0 (3 -> 32) on precomputed_convolve_sgemm, which uses no tensor cores,
// and layer10 (32 -> 3) on a tf32 cutlass conv after upcasting its input,
// each after a reflect-padded copy and NCHW <-> NHWC transposes: 31.6 ms of a
// restyle at batch 192 and 224^2 (H100) for 0.40 ms of bound.
//
// Function, per sample, x (H, W, Cin) bf16, w (Cout, Cin, 9, 9) bf16 (OIHW,
// nn.Conv2d's own), b (Cout,) bf16:
//   out[y, x, o] = bf16(b[o] + sum_{i, j, c} x[r(y + i - 4), r(x + j - 4), c] * w[o, c, i, j])
//   with r the reflection (-1 -> 1, H -> H - 2). Products of bf16 values are
//   exact in f32; the sum is f32 and the result is rounded to bf16 once.
//   Layer0 and layer10 are the two instantiations, (Cin, Cout) = (3, 32) and
//   (32, 3). Any H, W >= 5 (reflect pad 4 needs 4 < side); ragged tiles are
//   masked.
//
// Bound on an H100: bytes. Either layer is 2 * 81 * 96 flops a pixel, 150
//   GFLOP at (192, 224, 224) = 0.15 ms at the 989 TFLOP/s bf16 peak, and moves
//   70 bytes a pixel (6 in and 64 out, or 64 in and 6 out) = 0.67 GB = 0.20 ms
//   at 3.35 TB/s. SPN's (48, 227) layer0 and (48, 228) layer10: 0.052 ms each.
//
// Design: an implicit GEMM on mma.sync m16n8k16 (bf16 operands, f32
//   accumulators; the bound is bytes, so the Ampere-form MMA is enough), one
//   block of 8 warps per output tile, persistent over tiles. Each block turns
//   the OIHW weights once into a k-contiguous B image in shared memory (rows
//   padded by 16 bytes so that ldmatrix's eight rows hit distinct banks), and
//   per tile loads the tile's halo, (TH + 8) x (TW + 8) pixels, mirroring the
//   rows and columns outside the image as it indexes x: no padded copy exists
//   in device memory. The two shapes want different GEMMs:
//   - Layer0, Cin 3: M = 16 x 32 output pixels, N = 32 output channels, K =
//     per tap row i the 27 (j, c) values, which lie contiguous in an NHWC halo
//     row, plus one zero weight: 9 x 28 = 252, padded to 256 (95% of the MMA
//     work is the conv's). The 3-channel halo is stored twice, at an even and
//     an odd element offset, so that every (k, k + 1) pair of an A fragment is
//     one aligned 32-bit shared load whatever the pixel's parity. The output
//     goes through shared memory and leaves in 16-byte stores.
//   - Layer10, Cout 3: an N of 3 would waste 5/8 of every MMA and reload A for
//     each. So the column tap j moves from K into N: the GEMM computes, for
//     each input pixel (y, q) of the tile's rows extended by 8 columns,
//     Z[(y, q), (j, o)] = sum_{i, c} x[y + i, q, c] * w[o, c, i, j] (M = 8 x
//     64, K = 9 x 32 = 288, N = 27 padded to 32), and the epilogue sums
//     out[y, x, o] = b[o] + sum_j Z[(y, x + j), (j, o)] through shared memory
//     (72% of the MMA work is the conv's). The 32-channel halo arrives by
//     cp.async in 16-byte groups, XOR-swizzled by pixel, and ldmatrix reads
//     the A fragments bank-conflict free.
//   Two blocks share an SM (<= 128 registers, ~70 / ~85 KB of shared memory),
//   so one block's halo load overlaps the other's MMAs.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int PAD = 4;   // reflect pad of a 9x9 conv
constexpr int TAPS = 9;

template <int CIN, int COUT>
struct Geo;

// Layer0: 3 -> 32.
template <>
struct Geo<3, 32> {
  static constexpr bool FOLD = false;
  static constexpr int TH = 16, TW = 32;           // output tile
  static constexpr int HH = TH + 8, HWID = TW + 8;  // halo
  static constexpr int RS = HWID * 3;               // halo row, elements (even)
  static constexpr int HALO = HH * RS;
  static constexpr int SLACK = 32;                  // zeros past the halo
  static constexpr int KRUN = 28;                   // one tap row: 9 x 3 + 1 zero
  static constexpr int K = 256;                     // 9 x 28 = 252, to a multiple of 16
  static constexpr int N = 32;
  static constexpr int KST = K + 8;                 // B row stride, elements
  static constexpr int OST = 40;                    // staged output row, elements
  static constexpr int BT_BYTES = N * KST * 2;
  static constexpr int KOFF_OFF = BT_BYTES + 128;   // after the bias
  static constexpr int H0_OFF = KOFF_OFF + (K / 2) * 4;
  static constexpr int H1_OFF = H0_OFF + (HALO + SLACK) * 2;
  static constexpr int STG_OFF = H1_OFF + (HALO + SLACK) * 2;
  static constexpr int SMEM = STG_OFF + 8 * 64 * OST * 2;
  static __device__ float weight(const __nv_bfloat16* w, int n, int k) {
    if (k >= TAPS * KRUN) return 0.f;
    const int i = k / KRUN, jc = k - i * KRUN;
    if (jc >= 27) return 0.f;
    const int j = jc / 3, c = jc - j * 3;
    return __bfloat162float(w[((n * 3 + c) * TAPS + i) * TAPS + j]);
  }
};

// Layer10: 32 -> 3, the column tap folded into N.
template <>
struct Geo<32, 3> {
  static constexpr bool FOLD = true;
  static constexpr int TH = 8, TW = 56;
  static constexpr int EW = TW + 8;                 // extended row: 64 pixels
  static constexpr int HH = TH + 8;
  static constexpr int K = TAPS * 32;               // (i, c)
  static constexpr int N = 32;                      // (j, o): n = 3 j + o < 27
  static constexpr int KST = K + 8;
  static constexpr int ZS = 29;                     // Z row stride, floats (odd)
  static constexpr int BT_BYTES = N * KST * 2;
  static constexpr int HALO_OFF = BT_BYTES + 128;
  static constexpr int HALO_BYTES = HH * EW * 64;
  static constexpr int SMEM = HALO_OFF + HALO_BYTES;
  static_assert(TH * EW * ZS * 4 <= HALO_BYTES, "Z overlays the halo");
  static_assert(HALO_OFF % 128 == 0, "halo pixels must stay 64-byte aligned");
  static __device__ float weight(const __nv_bfloat16* w, int n, int k) {
    if (n >= 27 || k >= K) return 0.f;
    const int j = n / 3, o = n - j * 3, i = k >> 5, c = k & 31;
    return __bfloat162float(w[((o * 32 + c) * TAPS + i) * TAPS + j]);
  }
};

// Reflection of a pad of 4, clamped for the rows and columns of a ragged tile
// that lie past the image (their outputs are masked).
__device__ __forceinline__ int reflect4(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The B fragments of k16 step `s` for all four n tiles: b[2 t] and b[2 t + 1]
// of n tile t. Lanes 0-7 / 8-15 / 16-23 / 24-31 address the rows of the four
// 8x8 matrices (n 0-7 k 0-7, n 0-7 k 8-15, n 8-15 k 0-7, n 8-15 k 8-15).
template <int KST>
__device__ __forceinline__ void load_b(uint32_t (&b)[8], uint32_t bt, int lane, int s) {
  const int n = (lane & 7) + ((lane >> 4) << 3);
  const int k = 16 * s + (((lane >> 3) & 1) << 3);
  uint32_t r[4];
  ldmatrix_x4(r, bt + 2 * (n * KST + k));
  b[0] = r[0], b[1] = r[1], b[2] = r[2], b[3] = r[3];
  ldmatrix_x4(r, bt + 2 * ((n + 16) * KST + k));
  b[4] = r[0], b[5] = r[1], b[6] = r[2], b[7] = r[3];
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(NT, 2)
    edge_conv9x9_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        int H, int W, int tiles_x, int tiles_per_image, int ntiles) {
  using G = Geo<CIN, COUT>;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bsh = reinterpret_cast<float*>(smem + G::BT_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t bt_addr = gk::smem_u32(bt);

  for (int e = tid; e < G::N * G::KST; e += NT) {
    const int n = e / G::KST;
    bt[e] = __float2bfloat16(G::weight(w, n, e - n * G::KST));
  }
  if (tid < 32) bsh[tid] = tid < COUT ? __bfloat162float(bias[tid]) : 0.f;

  if constexpr (!G::FOLD) {
    // ---- layer0: Cin 3, K = (tap row i, 28 contiguous halo elements) -------
    uint32_t* koff = reinterpret_cast<uint32_t*>(smem + G::KOFF_OFF);
    __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(smem + G::H0_OFF);
    __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(smem + G::H1_OFF);
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem + G::STG_OFF) + warp * 64 * G::OST;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    // Word offset of the pair (2p, 2p + 1) of K from a pixel's first element.
    for (int p = tid; p < G::K / 2; p += NT) {
      const int k = 2 * p, i = k / G::KRUN;
      koff[p] = k < TAPS * G::KRUN ? (uint32_t)(i * G::RS + (k - i * G::KRUN)) >> 1 : 0u;
    }
    // Zeros that the zero weights multiply: past the halo, and h1's first.
    for (int e = tid; e < G::SLACK; e += NT) {
      h0[G::HALO + e] = zero;
      h1[G::HALO + e] = zero;
    }
    if (tid == 0) h1[0] = zero;
    const uint32_t* h0w = reinterpret_cast<const uint32_t*>(h0);
    const uint32_t* h1w = reinterpret_cast<const uint32_t*>(h1);
    // A rows: m tile mt of this warp is tile row 2 warp + (mt >> 1), columns
    // 16 (mt & 1) + 0..15; this lane's rows g and g + 8 share g's parity.
    const uint32_t* hw = (g & 1) ? h1w : h0w;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int b = tile / tiles_per_image, rem = tile - b * tiles_per_image;
      const int y0 = (rem / tiles_x) * G::TH, x0 = (rem % tiles_x) * G::TW;
      const __nv_bfloat16* xb = x + (size_t)b * H * W * 3;
      __syncthreads();  // the previous tile's halo readers are done
      constexpr int PER = (G::HALO + NT - 1) / NT;
      __nv_bfloat16 v[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * NT;
        if (e < G::HALO) {
          const int hy = e / G::RS, r = e - hy * G::RS, hx = r / 3, c = r - hx * 3;
          const int gy = reflect4(y0 - PAD + hy, H), gx = reflect4(x0 - PAD + hx, W);
          v[q] = xb[((size_t)gy * W + gx) * 3 + c];
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * NT;
        if (e < G::HALO) {
          h0[e] = v[q];
          h1[e + 1] = v[q];
        }
      }
      __syncthreads();

      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      // Word index of row g's first element (odd pixels read h1, one on).
      int wb[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int py = 2 * warp + (mt >> 1), px = 16 * (mt & 1) + g;
        wb[mt] = (py * G::RS + px * 3 + (g & 1)) >> 1;
      }
#pragma unroll 4
      for (int s = 0; s < G::K / 16; ++s) {
        uint32_t bf[8];
        load_b<G::KST>(bf, bt_addr, lane, s);
        const uint32_t o1 = koff[8 * s + t4], o2 = koff[8 * s + t4 + 4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          // Row g + 8 is 8 pixels on: 24 elements, 12 words.
          const uint32_t a[4] = {hw[wb[mt] + o1], hw[wb[mt] + 12 + o1], hw[wb[mt] + o2],
                                 hw[wb[mt] + 12 + o2]};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bf[2 * nt], bf[2 * nt + 1]);
        }
      }

      // Bias, one rounding, staged per warp, then 16-byte stores.
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int lp = (mt >> 1) * 32 + 16 * (mt & 1) + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int co = 8 * nt + 2 * t4;
          const float b0 = bsh[co], b1 = bsh[co + 1];
          *reinterpret_cast<__nv_bfloat162*>(stg + lp * G::OST + co) =
              __floats2bfloat162_rn(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(stg + (lp + 8) * G::OST + co) =
              __floats2bfloat162_rn(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = lane; q < 64 * 4; q += 32) {
        const int lp = q >> 2, part = q & 3;
        const int gy = y0 + 2 * warp + (lp >> 5), gx = x0 + (lp & 31);
        if (gy < H && gx < W)
          *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * 32 + part * 8) =
              *reinterpret_cast<const uint4*>(stg + lp * G::OST + part * 8);
      }
      __syncwarp();
    }
  } else {
    // ---- layer10: Cout 3, K = (tap row i, channel), N = (tap column j, o) --
    uint8_t* halo = smem + G::HALO_OFF;
    const uint32_t halo_addr = gk::smem_u32(halo);
    float* z = reinterpret_cast<float*>(halo);
    // ldmatrix rows of this lane: m-tile row r, k half kc (channels 8 kc on).
    const int r = (lane & 7) + (((lane >> 3) & 1) << 3), kc = lane >> 4;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int b = tile / tiles_per_image, rem = tile - b * tiles_per_image;
      const int y0 = (rem / tiles_x) * G::TH, x0 = (rem % tiles_x) * G::TW;
      const __nv_bfloat16* xb = x + (size_t)b * H * W * 32;
      __syncthreads();  // the previous tile's Z readers are done
      for (int q = tid; q < G::HH * G::EW * 4; q += NT) {
        const int hp = q >> 2, cc = q & 3, hy = hp / G::EW, hx = hp - hy * G::EW;
        const int gy = reflect4(y0 - PAD + hy, H), gx = reflect4(x0 - PAD + hx, W);
        cp_async16(halo_addr + hp * 64 + ((cc ^ ((hp >> 1) & 3)) << 4),
                   xb + ((size_t)gy * W + gx) * 32 + cc * 8);
      }
      cp_async_wait_all();
      __syncthreads();

      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll 2
      for (int s = 0; s < G::K / 16; ++s) {
        uint32_t bf[8];
        load_b<G::KST>(bf, bt_addr, lane, s);
        const int i = s >> 1, cc = ((s & 1) << 1) + kc;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          // Extended row `warp`, pixels 16 mt + r, shifted down by tap row i.
          const int hp = (warp + i) * G::EW + 16 * mt + r;
          uint32_t a[4];
          ldmatrix_x4(a, halo_addr + hp * 64 + ((cc ^ ((hp >> 1) & 3)) << 4));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bf[2 * nt], bf[2 * nt + 1]);
        }
      }
      __syncthreads();  // every warp is done with the halo that Z overlays

#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int e = warp * G::EW + 16 * mt + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = 8 * nt + 2 * t4;
          if (n < 27) {
            z[e * G::ZS + n] = acc[mt][nt][0];
            z[(e + 8) * G::ZS + n] = acc[mt][nt][2];
          }
          if (n + 1 < 27) {
            z[e * G::ZS + n + 1] = acc[mt][nt][1];
            z[(e + 8) * G::ZS + n + 1] = acc[mt][nt][3];
          }
        }
      }
      __syncthreads();
      for (int p = tid; p < G::TH * G::TW; p += NT) {
        const int ry = p / G::TW, px = p - ry * G::TW;
        const int gy = y0 + ry, gx = x0 + px;
        if (gy >= H || gx >= W) continue;
        const float* zp = z + (ry * G::EW + px) * G::ZS;
        __nv_bfloat16* op = out + (((size_t)b * H + gy) * W + gx) * 3;
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          float sum = bsh[o];
#pragma unroll
          for (int j = 0; j < TAPS; ++j) sum += zp[j * G::ZS + 3 * j + o];
          op[o] = __float2bfloat16(sum);
        }
      }
    }
  }
}

template <int CIN, int COUT>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
                   __nv_bfloat16* out, int B, int H, int W, cudaStream_t s) {
  using G = Geo<CIN, COUT>;
  auto kernel = edge_conv9x9_kernel<CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, G::SMEM)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (W + G::TW - 1) / G::TW, tiles_y = (H + G::TH - 1) / G::TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  kernel<<<grid, NT, G::SMEM, s>>>(x, w, b, out, H, W, tiles_x, tiles_x * tiles_y, ntiles);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16 contiguous, 16-byte aligned; w: (Cout, Cin, 9, 9) bf16
// contiguous; b: (Cout,) bf16; out: (B, H, W, Cout) bf16 contiguous, 16-byte
// aligned. (Cin, Cout) is (3, 32) or (32, 3); H, W >= 5. Returns the launch
// error (0 on success).
extern "C" int gk_edgeconv(const void* x, const void* w, const void* b, void* out, int B, int H,
                           int W, int Cin, int Cout, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  auto bp = static_cast<const __nv_bfloat16*>(b);
  auto op = static_cast<__nv_bfloat16*>(out);
  if (H < 5 || W < 5 || B < 1) return (int)cudaErrorInvalidValue;
  if (Cin == 3 && Cout == 32) return (int)launch<3, 32>(xp, wp, bp, op, B, H, W, s);
  if (Cin == 32 && Cout == 3) return (int)launch<32, 3>(xp, wp, bp, op, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
