// Reflect pad 1 + 3x3 conv + bias of the Ghiasi generator's layers 1, 2, 8
// and 9, forward only, bf16 in and out, on the tensor cores, with the stride
// 2 of layers 1 and 2 and the nearest 2x upsample of layers 8 and 9 folded
// into the input gather.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (speedplusbaseline_tpu/models/ghiasi.py). On the card, in bf16, the plain
// path upsampled the input as a whole tensor (layers 8, 9), wrote a
// reflect-padded NCHW copy, let cuDNN transpose it to NHWC and back, and
// copied the result into channels_last for the instance norm: about 33 ms
// of a 49 ms restyle at batch 192 and 224^2 (H100) around 2.8 ms of convs.
//
// Function, per sample, x (H, W, Cin) bf16, w (Cout, 3, 3, Cin) bf16 (OHWI:
// the conv's weight packed once, k = (3 i + j) Cin + c), b (Cout,) f32:
//   stride 2 (layers 1, 2): out[y, x, o] = bf16(b[o] + sum_{i, j, c}
//     x[r(2y + i - 1), r(2x + j - 1), c] * w[o, i, j, c]), Ho = ceil(H / 2)
//   upsample 2 (layers 8, 9): out[y, x, o] = bf16(b[o] + sum_{i, j, c}
//     x[r2(y + i - 1) / 2, r2(x + j - 1) / 2, c] * w[o, i, j, c]), Ho = 2 H
//   with r the reflection in the input (-1 -> 1, H -> H - 2) and r2 the one
//   in the upsampled grid (-1 -> 1, 2H -> 2H - 2), so that r2(u) / 2 is u / 2
//   (floor) clamped to [0, H - 1]. Products of bf16 values are exact in f32;
//   the sum is f32 and the result is rounded to bf16 once. The taps that an
//   upsample makes read one source pixel are not summed first: every product
//   is the plain path's. (Cin, Cout) is (32, 64) and (64, 128) at stride 2,
//   (128, 64) and (64, 32) upsampled.
//
// Bound on an H100 at (192, 224^2): layers 8 and 9 are operations, 2 * 9 *
//   Cin * Cout a pixel = 0.355 TFLOP each = 0.36 ms at the 989 TFLOP/s bf16
//   peak; layers 1 and 2 are bytes, one read of x and one write of out = 0.92
//   / 0.46 GB = 0.28 / 0.14 ms at 3.35 TB/s. About 1.14 ms a restyle (SPN's
//   (48, 227^2): 0.29 ms).
//
// Design: an implicit GEMM on mma.sync m16n8k16 (bf16 operands, f32
//   accumulators), M the tile's output pixels, N = Cout, K = 9 Cin in tap
//   order. One block of 8 warps per output tile, persistent over tiles; each
//   warp computes 16 MT pixels x 32 channels. Each block copies the packed
//   weights once into a k-contiguous B image in shared memory (rows padded
//   by 16 bytes so that ldmatrix's eight rows hit distinct banks: 37-148 KB),
//   and keeps two input halos: while the warps multiply one tile, cp.async
//   brings the next tile's halo. A halo holds the source pixels the tile
//   reads, each pixel's Cin channels in 16-byte groups XOR-swizzled by pixel
//   so that ldmatrix reads eight pixels bank-conflict free; the reflection
//   (stride 2) or the clamp (upsample) is applied as the halo is loaded, so
//   the gather inside the tile is uniform:
//   - stride 2: the halo is the (2 TH + 1) x (2 TW + 1) input pixels from
//     (2 y0 - 1, 2 x0 - 1); a tap reads halo (2 ly + i, 2 lx + j). Its even
//     columns are stored before its odd ones, so that the eight pixels of an
//     ldmatrix, two columns apart in x, lie side by side;
//   - upsample: the halo is the (TH / 2 + 2) x (TW / 2 + 2) source pixels
//     from (y0 / 2 - 1, x0 / 2 - 1); a tap reads halo ((ly + i + 1) / 2,
//     (lx + j + 1) / 2), a quarter of what an upsampled copy would hold.
//   Every channel count is a multiple of 16, so the MMA tiles fit exactly.
//   The layers differ in tile and occupancy only (Geo below): layer 1 keeps
//   two blocks an SM (<= 128 registers); layers 2 and 8, whose weights take
//   148 KB, and layer 9, whose 64 x 32 warp tiles spill at 128 registers,
//   one.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int TAPS = 9;

// A layer's tiling: (Cin, Cout, upsampled), output tile TH x TW, WM warps
// along M (the other 8 / WM along N), MINB blocks an SM.
template <int CIN_, int COUT_, bool UP_, int TH_, int TW_, int WM_, int MINB_>
struct Cfg {
  static constexpr int CIN = CIN_, COUT = COUT_, TH = TH_, TW = TW_, WM = WM_, MINB = MINB_;
  static constexpr bool UP = UP_;
  static constexpr int WN = 8 / WM;                     // warps along N
  static constexpr int MT = TH * TW / WM / 16;          // m tiles a warp
  static constexpr int K = TAPS * CIN;
  static constexpr int KST = K + 8;                     // B row stride, elements
  static constexpr int PIXB = CIN * 2;                  // bytes a halo pixel
  static constexpr int CH = CIN / 8;                    // 16-byte groups a pixel
  static constexpr int HH = UP ? TH / 2 + 2 : 2 * TH + 1;
  static constexpr int HW = UP ? TW / 2 + 2 : 2 * TW + 1;
  static constexpr int HE = TW + 1;                     // stride 2: first odd column's slot
  static constexpr int HALO_BYTES = HH * HW * PIXB;
  static constexpr int BT_BYTES = COUT * KST * 2;
  static constexpr int HALO_OFF = (BT_BYTES + COUT * 4 + 127) / 128 * 128;  // after the bias
  static constexpr int SMEM = HALO_OFF + 2 * HALO_BYTES;
  static_assert(COUT / WN == 32, "a warp computes 32 output channels");
  static_assert(CIN % 16 == 0, "k16 steps never straddle two taps");
  static_assert(TW % 16 == 0 || TW == 8, "the eight rows of an ldmatrix lie in one tile row");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int CIN, int COUT, bool UP>
struct Geo;
template <>  // layer1: 32 -> 64, stride 2
struct Geo<32, 64, false> : Cfg<32, 64, false, 8, 16, 4, 2> {};
template <>  // layer2: 64 -> 128, stride 2
struct Geo<64, 128, false> : Cfg<64, 128, false, 8, 8, 2, 1> {};
template <>  // layer8: 128 -> 64, upsampled
struct Geo<128, 64, true> : Cfg<128, 64, true, 16, 16, 4, 1> {};
template <>  // layer9: 64 -> 32, upsampled
struct Geo<64, 32, true> : Cfg<64, 32, true, 16, 32, 8, 1> {};

// The 16-byte group of a halo pixel that holds group c: 64-byte pixels pair
// up in a 128-byte row, so they swizzle by their pair; wider ones by pixel.
template <int CH>
__device__ __forceinline__ int swz(int sp) {
  return CH >= 8 ? (sp & 7) : ((sp >> 1) & 3);
}

// The input index that halo index i (from the tile's origin) loads: reflected
// by 1 at stride 2, clamped when upsampled (see the header), and clamped for
// the rows and columns of a ragged tile past the image (their outputs are
// masked).
template <bool UP>
__device__ __forceinline__ int source(int i, int n) {
  if (!UP) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * n - 2 - i : i;
  }
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Halo column hx's slot in its row: stride 2 stores even columns first.
template <class G>
__device__ __forceinline__ int column_slot(int hx) {
  return G::UP ? hx : ((hx & 1) ? G::HE + (hx >> 1) : (hx >> 1));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most one group (the newest) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Output tile `tile` -> (sample, first output row, first output column).
struct Tile {
  int b, y0, x0;
};

template <class G>
__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int tiles_per_image) {
  const int b = tile / tiles_per_image, rem = tile - b * tiles_per_image;
  return {b, (rem / tiles_x) * G::TH, (rem % tiles_x) * G::TW};
}

// cp.async the halo of tile t into the halo at shared address dst.
template <class G>
__device__ __forceinline__ void load_halo(uint32_t dst, const __nv_bfloat16* __restrict__ x,
                                          const Tile& t, int H, int W, int tid) {
  const int gy0 = G::UP ? t.y0 / 2 - 1 : 2 * t.y0 - 1;
  const int gx0 = G::UP ? t.x0 / 2 - 1 : 2 * t.x0 - 1;
  const __nv_bfloat16* xb = x + (size_t)t.b * H * W * G::CIN;
  for (int q = tid; q < G::HH * G::HW * G::CH; q += NT) {
    const int pix = q / G::CH, c = q - pix * G::CH;
    const int hy = pix / G::HW, hx = pix - hy * G::HW;
    const int gy = source<G::UP>(gy0 + hy, H), gx = source<G::UP>(gx0 + hx, W);
    const int sp = hy * G::HW + column_slot<G>(hx);
    cp_async16(dst + sp * G::PIXB + ((c ^ swz<G::CH>(sp)) << 4),
               xb + ((size_t)gy * W + gx) * G::CIN + c * 8);
  }
}

// The B fragments of k16 step `s` for the warp's four n tiles from row n0:
// b[2 t] and b[2 t + 1] of n tile t. Lanes 0-7 / 8-15 / 16-23 / 24-31 address
// the rows of the four 8x8 matrices (n 0-7 k 0-7, n 0-7 k 8-15, n 8-15 k 0-7,
// n 8-15 k 8-15).
template <int KST>
__device__ __forceinline__ void load_b(uint32_t (&b)[8], uint32_t bt, int n0, int lane, int s) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int k = 16 * s + (((lane >> 3) & 1) << 3);
  uint32_t r[4];
  ldmatrix_x4(r, bt + 2 * (n * KST + k));
  b[0] = r[0], b[1] = r[1], b[2] = r[2], b[3] = r[3];
  ldmatrix_x4(r, bt + 2 * ((n + 16) * KST + k));
  b[4] = r[0], b[5] = r[1], b[6] = r[2], b[7] = r[3];
}

template <int CIN, int COUT, bool UP>
__global__ void __launch_bounds__(NT, Geo<CIN, COUT, UP>::MINB)
    mid_conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                       int W, int Ho, int Wo, int tiles_x, int tiles_per_image, int ntiles) {
  using G = Geo<CIN, COUT, UP>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* bsh = reinterpret_cast<float*>(smem + G::BT_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t bt_addr = gk::smem_u32(smem);
  const uint32_t halo_addr = gk::smem_u32(smem + G::HALO_OFF);
  // This warp's pixels (from m0) and channels (from n0); the ldmatrix row and
  // k half of this lane.
  const int m0 = (warp % G::WM) * G::MT * 16, n0 = (warp / G::WM) * 32;
  const int r = lane & 15, kh = lane >> 4;

  // The packed weights, once: row o of the B image is w[o] (K elements).
  for (int q = tid; q < COUT * (G::K / 8); q += NT) {
    const int o = q / (G::K / 8), kc = q - o * (G::K / 8);
    cp_async16(bt_addr + 2 * (o * G::KST + kc * 8), w + (size_t)o * G::K + kc * 8);
  }
  if (tid < COUT) bsh[tid] = bias[tid];
  int tile = blockIdx.x;
  load_halo<G>(halo_addr, x, tile_at<G>(tile, tiles_x, tiles_per_image), H, W, tid);
  cp_async_commit();

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const Tile t = tile_at<G>(tile, tiles_x, tiles_per_image);
    const int next = tile + gridDim.x;
    if (next < ntiles)
      load_halo<G>(halo_addr + (buf ^ 1) * G::HALO_BYTES, x,
                   tile_at<G>(next, tiles_x, tiles_per_image), H, W, tid);
    cp_async_commit();
    cp_async_wait_one();  // this tile's halo (and, the first time, the weights)
    __syncthreads();

    const uint32_t halo = halo_addr + buf * G::HALO_BYTES;
    float acc[G::MT][4][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    // One tap row an iteration: unrolling all nine taps lets the compiler
    // hoist every tap's addresses out of the tile loop, past 128 registers.
#pragma unroll 3
    for (int tap = 0; tap < TAPS; ++tap) {
      const int i = tap / 3, j = tap % 3;
      uint32_t base[G::MT];
      int sw[G::MT];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        // This lane's ldmatrix row of m tile mt as a tile pixel (ly, lx): an
        // m tile is 16 pixels of one row, or two rows of 8.
        const int p0 = m0 + 16 * mt;
        const int ly = p0 / G::TW + (G::TW == 8 ? r >> 3 : 0);
        const int lx = p0 % G::TW + (G::TW == 8 ? r & 7 : r);
        const int sp = G::UP ? ((ly + i + 1) >> 1) * G::HW + ((lx + j + 1) >> 1)
                             : (2 * ly + i) * G::HW + (j & 1) * G::HE + lx + (j >> 1);
        base[mt] = halo + sp * G::PIXB;
        sw[mt] = swz<G::CH>(sp);
      }
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc) {
        uint32_t bf[8];
        load_b<G::KST>(bf, bt_addr, n0, lane, tap * (CIN / 16) + kc);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, base[mt] + (((2 * kc + kh) ^ sw[mt]) << 4));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bf[2 * nt], bf[2 * nt + 1]);
        }
      }
    }

    // Bias, one rounding, bf16 pairs straight to the NHWC output.
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + 16 * mt + g + 8 * half;
        const int oy = t.y0 + p / G::TW, ox = t.x0 + p % G::TW;
        if (oy >= Ho || ox >= Wo) continue;
        __nv_bfloat16* op = out + (((size_t)t.b * Ho + oy) * Wo + ox) * COUT + n0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + 8 * nt + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * nt) = __floats2bfloat162_rn(
              acc[mt][nt][2 * half] + bsh[n], acc[mt][nt][2 * half + 1] + bsh[n + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this halo before it is refilled
  }
}

template <int CIN, int COUT, bool UP>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
                   __nv_bfloat16* out, int B, int H, int W, cudaStream_t s) {
  using G = Geo<CIN, COUT, UP>;
  auto kernel = mid_conv3x3_kernel<CIN, COUT, UP>;
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
  const int Ho = UP ? 2 * H : (H + 1) / 2, Wo = UP ? 2 * W : (W + 1) / 2;
  const int tiles_x = (Wo + G::TW - 1) / G::TW, tiles_y = (Ho + G::TH - 1) / G::TH;
  const int ntiles = B * tiles_x * tiles_y;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  kernel<<<grid, NT, G::SMEM, s>>>(x, w, b, out, H, W, Ho, Wo, tiles_x, tiles_x * tiles_y,
                                   ntiles);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16 contiguous, 16-byte aligned; w: (Cout, 3, 3, Cin)
// bf16 contiguous, 16-byte aligned; b: (Cout,) f32; out: (B, Ho, Wo, Cout)
// bf16 contiguous. (Cin, Cout, stride, upsample) is (32, 64, 2, 1), (64, 128,
// 2, 1), (128, 64, 1, 2) or (64, 32, 1, 2); Ho = ceil(H / 2) at stride 2 and
// 2 H upsampled; H, W >= 2 at stride 2 (reflect pad 1 needs 1 < side).
// Returns the launch error (0 on success).
extern "C" int gk_midconv(const void* x, const void* w, const void* b, void* out, int B, int H,
                          int W, int Cin, int Cout, int stride, int upsample, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  auto bp = static_cast<const float*>(b);
  auto op = static_cast<__nv_bfloat16*>(out);
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (stride == 2 && upsample == 1 && H >= 2 && W >= 2) {
    if (Cin == 32 && Cout == 64) return (int)launch<32, 64, false>(xp, wp, bp, op, B, H, W, s);
    if (Cin == 64 && Cout == 128) return (int)launch<64, 128, false>(xp, wp, bp, op, B, H, W, s);
  }
  if (stride == 1 && upsample == 2) {
    if (Cin == 128 && Cout == 64) return (int)launch<128, 64, true>(xp, wp, bp, op, B, H, W, s);
    if (Cin == 64 && Cout == 32) return (int)launch<64, 32, true>(xp, wp, bp, op, B, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
