// Ghiasi residual block, forward only, as a chain of six launches whose two
// 3x3 convs run on the Hopper tensor cores (wgmma) at f32 accuracy.
//
// Replaces: speedplusbaseline_tpu/ops/pallas_resblock.py,
//   ghiasi_resblock_pallas (kernel _resblock_kernel). Per sample x (H, W, C):
//     y1 = conv3x3(reflect_pad1(x), W1) + b1
//     a1 = relu(FiLM1(instance_norm(y1)))
//     y2 = conv3x3(reflect_pad1(a1), W2) + b2
//     out = x + FiLM2(instance_norm(y2))          (cast to x's dtype)
//   The Pallas kernel takes its conv dots in f32 (it upcasts a bf16 x).
//
// Why split-bf16 operands: the tensor cores have no full-rate f32 path (TF32
//   keeps 10 mantissa bits). So each f32 operand v is cut into hi = bf16(v)
//   and lo = bf16(v - hi), 16 significant bits in all, and each product is
//   taken as hi*hi + hi*lo + lo*hi on bf16 tensor cores with f32
//   accumulation. The dropped lo*lo term and the rounding of lo are each about
//   2^-17 relative, so the function stays the f32 one and no tolerance moves.
//   A bf16 x is exact in hi (lo = 0): conv 1 from bf16 x takes two passes
//   (x*w_hi + x*w_lo), conv 2 and conv 1 from f32 x take three.
//
// Bound on an H100: operations. One conv is 2 * 9 * C^2 * H*W * B flops,
//   44.4 GFLOP at the Ghiasi shape (48, 56, 56, 128). With the passes counted,
//   one call from bf16 x is 5 x 44.4 = 222 GFLOP at the 989 TFLOP/s bf16 dense
//   peak = 0.224 ms (f32 x: 6 passes, 0.269 ms). The compulsory traffic, with
//   the f32 y1/y2 scratch written and read back, is ~0.42 GB = 0.13 ms.
//
// The chain:
//   0. split_weights_kernel: w1, w2 (HWIO f32) -> hi/lo bf16, written in the
//      byte image that the wgmma B operand reads from shared memory, so that a
//      plain bulk copy lands each tile ready to use (no tensor map).
//   1. conv3x3_tc_kernel<T, false>: conv 1 + b1 -> y1 (f32 scratch) and one
//      (mean, M2) partial per (b, 128-pixel tile, c).
//   2. gk::in_finalize_kernel: merges the partials of each (b, c) in order (Chan's
//      update, common.cuh) into scale/shift with FiLM1 folded in.
//   3. conv3x3_tc_kernel<float, true>: conv 2, applying relu(y1 * scale +
//      shift) as it loads y1, so the normalised y1 never reaches device
//      memory; + b2 -> y2 and its partials.
//   4. in_finalize_kernel for IN2 + FiLM2.
//   5. residual_kernel: out = x + y2 * scale + shift, cast to x's dtype.
//
// The conv is an implicit GEMM (M = pixels, N = output channels, K = 9 taps
//   x C). One block computes 128 consecutive output pixels (row-major) x 128
//   output channels with two warpgroups of 64 pixels each, wgmma m64n128k16,
//   and two blocks share an SM (<= 128 registers a thread, ~108 KB of shared
//   memory each at W = 56), so that one block's loads, barriers and epilogue
//   overlap the other block's MMAs.
//   - A, a reflect-padded shifted window, is no box in device memory, and
//     nine shifted views of one tile break the fixed strides of a wgmma
//     shared-memory descriptor. So, per 32-channel chunk, the block loads once
//     the image rows its pixels span plus one row above and one below (the
//     halo; the row reflect is applied as it loads, in 16-byte vectors, four in
//     flight per thread), splits it into hi (and lo) bf16, and stores each
//     pixel's four 16-byte channel groups XOR-swizzled by pixel, so that the
//     eight rows of an ldmatrix hit distinct banks. Per tap, each lane points
//     ldmatrix at the halo pixel (reflect(h + di), reflect(w + dj)) of its
//     fragment row, and the fragments feed the register-A form of wgmma.
//   - B, one 128 x 32 bf16 tile each of hi and lo per (tap, chunk) (16 KB),
//     comes from the prep image through a ring of NSTAGE = 4 stages, filled by
//     cp.async.bulk on mbarriers from one elected thread.
//   - One MMA group stays in flight across taps: while tap t's MMAs run, the
//     warpgroup waits for tap t-1's, loads tap t+1's A fragments into the
//     register set those used, and hands tap t-1's B stage back to the loader.
//   - Epilogue: bias, store y, and the tile's per-channel mean and M2 over
//     its valid pixels, read straight from the accumulator layout: per-thread
//     values, warp shuffles over the lanes that share a channel, then the
//     eight warps through shared memory in a fixed order, first for the sum
//     and then for the squared deviations from the tile mean (deterministic,
//     no float atomics).
//   Where the rest of the time goes: the halo load and the y stores, which a
//   block does not overlap with its own MMAs, and the tail of 1,200 blocks on
//   264 slots (4.5 waves). Every block reads all the split weights from L2
//   (~0.7 GB per conv at the Ghiasi shape), which did not limit it when tried.
//   Left for later: the halo loaded ahead (cp.async into a second buffer),
//   the tile stored through shared memory by TMA, TMA tensor maps, a producer
//   warp with warp specialisation, and a persistent grid.
//   Takes any H >= 2, 2 <= W <= 324 (the halo must fit shared memory;
//   gk_resblock_smem_bytes says what a shape needs) and any C % 8 == 0, with
//   16-byte aligned x (16-byte channel loads).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TP = 128;                     // output pixels per block
constexpr int TN = 128;                     // output channels per block
constexpr int KCH = 32;                     // input channels per halo chunk
constexpr int NT = 256;                     // two warpgroups
constexpr int NSTAGE = 4;                   // B ring depth
constexpr int HALO_BATCH = 4;               // halo loads in flight per thread
constexpr int BTILE = TN * KCH;             // bf16 elements of one hi or lo B tile
constexpr int BTILE_BYTES = 2 * BTILE;      // 16 KB
constexpr int STAGE_BYTES = 2 * BTILE_BYTES;  // hi + lo
constexpr int PIX_BYTES = 2 * KCH;          // one halo pixel, 32 bf16 = 64 B
constexpr int KSTEPS = KCH / 16;            // k16 steps per (tap, chunk)
// Shared memory: [B stages][mbarriers, scale, shift][halo hi][halo lo]. The
// epilogue reuses the halo for its reduction (8 warps x TN sums + TN means).
constexpr int BAR_OFF = NSTAGE * STAGE_BYTES;
constexpr int SC_OFF = BAR_OFF + 64;
constexpr int HALO_OFF = BAR_OFF + 1024;
constexpr int EPI_BYTES = (8 * TN + TN) * 4;
constexpr int FIN_THREADS = 128;
static_assert(SC_OFF + 2 * KCH * 4 <= HALO_OFF && HALO_OFF % 128 == 0,
              "halo rows must stay 128-byte aligned");

// Halo pixels a tile can need: the rows 128 consecutive pixels span, plus two.
inline int halo_pixels(int H, int W) {
  const int rows = (TP - 1) / W + 2;
  return ((rows < H ? rows : H) + 2) * W;
}

inline int conv_smem_bytes(int halo_cap, bool split) {
  const int halo = halo_cap * PIX_BYTES * (split ? 2 : 1);
  return HALO_OFF + (halo > EPI_BYTES ? halo : EPI_BYTES);
}

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// ---- mbarrier and bulk copy (helpers in common.cuh) -------------------------

using gk::bulk_load;
using gk::mbar_expect_tx;
using gk::mbar_init;
using gk::mbar_try_wait;
using gk::smem_u32;

// One stage: the hi and lo B tiles of one (tap, chunk), adjacent in the image.
__device__ __forceinline__ void load_stage(uint8_t* dst, const __nv_bfloat16* src,
                                           uint64_t* bar) {
  mbar_expect_tx(bar, STAGE_BYTES);
  bulk_load(dst, src, BTILE_BYTES, bar);
  bulk_load(dst + BTILE_BYTES, src + BTILE, BTILE_BYTES, bar);
}

// ---- ldmatrix and wgmma -----------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Shared-memory descriptor of a B tile for one k16 step: K-major, no swizzle,
// core matrices of 8 channels-out x 8 channels-in (128 contiguous bytes). The
// leading byte offset steps along K (the next 8 input channels, 2048 B on),
// the stride byte offset along N (the next 8 output channels, 128 B on).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= a[64 x 16] (registers, bf16) * b[16 x 128] (shared, bf16);
// accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, bool accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)accumulate));
}

// ---- halo load --------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of 16-byte channel group g (0-3) of halo pixel hp. Two pixels
// share a 128-byte bank line; XOR-ing g with bits 1-2 of hp puts the same
// group of 8 consecutive pixels on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int halo_off(int hp, int g) {
  return hp * PIX_BYTES + ((g ^ ((hp >> 1) & 3)) << 4);
}

// A halo item is 16 bytes of one pixel's channels, 4 f32 or 8 bf16, read as
// raw bits. C % 8 == 0 (the wrapper checks), so an item lies wholly below C
// or wholly past it, where it reads as zero.
__device__ __forceinline__ uint4 halo_fetch(const void* src, bool valid) {
  return valid ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
}

// Stores item cv of halo pixel hp. A bf16 operand goes in as it is (hi
// only, lo = 0). An f32 operand is split into hi and lo (8 bytes each); NORM
// applies relu(v * s_sc + s_sh) first (s_sc = s_sh = 0 past C, so the tail
// stays 0).
template <typename T, bool NORM>
__device__ __forceinline__ void halo_put(uint4 q, int hp, int cv, const float* s_sc,
                                         const float* s_sh, uint8_t* hi, uint8_t* lo) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(hi + halo_off(hp, cv)) = q;
  } else {
    const float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y), __uint_as_float(q.z),
                        __uint_as_float(q.w)};
    uint32_t h[2], l[2];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      float a = v[e], b = v[e + 1];
      if (NORM) {
        a = fmaxf(a * s_sc[4 * cv + e] + s_sh[4 * cv + e], 0.f);
        b = fmaxf(b * s_sc[4 * cv + e + 1] + s_sh[4 * cv + e + 1], 0.f);
      }
      const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
      h[e / 2] = pack_bf16(a, b);
      l[e / 2] = pack_bf16(a - __bfloat162float(ha), b - __bfloat162float(hb));
    }
    const int off = halo_off(hp, cv >> 1) + (cv & 1) * 8;
    *reinterpret_cast<uint2*>(hi + off) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(lo + off) = make_uint2(l[0], l[1]);
  }
}

// The A fragments of one tap for the k16 steps of a chunk: hi, and lo
// for an f32 operand. `row` is this lane's halo pixel for the tap.
template <bool SPLIT>
__device__ __forceinline__ void load_a(uint32_t (&ahi)[KSTEPS][4], uint32_t (&alo)[KSTEPS][4],
                                       const uint8_t* halo_hi, const uint8_t* halo_lo, int row,
                                       int khalf) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int off = halo_off(row, 2 * ks + khalf);
    ldmatrix_x4(ahi[ks], smem_u32(halo_hi + off));
    if (SPLIT) ldmatrix_x4(alo[ks], smem_u32(halo_lo + off));
  }
}

// acc (+)= A * B over one (tap, chunk): per k16 step hi*hi, hi*lo and, for
// an f32 operand, lo*hi. bhi/blo: shared addresses of the stage's B tiles.
// accumulate = false: the first product overwrites acc.
template <bool SPLIT>
__device__ __forceinline__ void mma_tap(float (&acc)[64], const uint32_t (&ahi)[KSTEPS][4],
                                        const uint32_t (&alo)[KSTEPS][4], uint32_t bhi,
                                        uint32_t blo, bool accumulate) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    // k16 step ks starts at input channel 16 * ks: two core matrices on.
    wgmma_m64n128k16(acc, ahi[ks], b_desc(bhi + ks * 4096), ks > 0 || accumulate);
    wgmma_m64n128k16(acc, ahi[ks], b_desc(blo + ks * 4096), true);
    if (SPLIT) wgmma_m64n128k16(acc, alo[ks], b_desc(bhi + ks * 4096), true);
  }
}

// ---- the conv ---------------------------------------------------------------

// in: (B, H*W, C) of T. wimg: this conv's split-weight image, [TN block][chunk]
// [tap][hi, lo][TN x KCH]. out: (B, H*W, C) f32. part: (B, ntiles, C) float2
// of (mean, M2) over each tile's valid pixels. NORM: the operand is
// relu(in * in_scale[b, c] + in_shift[b, c]).
// Two blocks share an SM (<= 128 registers a thread, <= 113 KB of shared
// memory each), so that one block's halo load and barriers overlap the other
// block's MMAs.
template <typename T, bool NORM>
__global__ void __launch_bounds__(NT, 2)
conv3x3_tc_kernel(const T* __restrict__ in, const float* __restrict__ in_scale,
                  const float* __restrict__ in_shift, const __nv_bfloat16* __restrict__ wimg,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float2* __restrict__ part, int H, int W, int C, int ntiles, int halo_cap) {
  constexpr bool SPLIT = sizeof(T) == 4;   // f32 operand: hi and lo
  constexpr int VEC = 16 / sizeof(T);      // channels per 16-byte item
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  float* s_sc = reinterpret_cast<float*>(smem + SC_OFF);
  float* s_sh = s_sc + KCH;
  uint8_t* halo_hi = smem + HALO_OFF;
  uint8_t* halo_lo = halo_hi + (size_t)halo_cap * PIX_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int tile = blockIdx.x, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int HW = H * W, p0 = tile * TP;
  const int nch = (C + KCH - 1) / KCH, niter = 9 * nch;
  const __nv_bfloat16* wblk = wimg + (size_t)blockIdx.y * niter * 2 * BTILE;

  // Image rows h_first - 1 .. h_last + 1 are halo rows 0 .. nvr - 1.
  const int h_first = p0 / W, h_last = min(p0 + TP - 1, HW - 1) / W;
  const int nvr = h_last - h_first + 3;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < min(NSTAGE, niter); ++it)
      load_stage(smem + it * STAGE_BYTES, wblk + (size_t)it * 2 * BTILE, &full[it]);

  // This lane's A fragment row (ldmatrix x4: lanes 0-15 give rows 0-15 at
  // channels 0-7 of a k16 step, lanes 16-31 the same rows at channels 8-15).
  // Rows past the image repeat its last pixel; their outputs are dropped.
  const int pa = min(p0 + 64 * wg + 16 * (warp & 3) + (lane & 15), HW - 1);
  const int pa_h = pa / W - h_first + 1, pa_w = pa % W, khalf = lane >> 4;
  // The halo pixel of this lane's row for a tap. The empty asm makes the
  // compiler compute it at each tap rather than hold all nine taps' ldmatrix
  // addresses in registers across the chunk loop (which spilled them).
  auto tap_row = [&](int tap) {
    int h = pa_h;
    asm volatile("" : "+r"(h));
    return (h + tap / 3 - 1) * W + reflect1(pa_w + tap % 3 - 1, W);
  };

  // No zero fill: the block's first MMA overwrites acc (scale-d = 0). A fill
  // that the compiler sinks to the first MMA makes ptxas serialize wgmma.
  float acc[64];

  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * KCH;
    // The previous chunk's last MMAs read ahi[0]/alo[0], reloaded below; and
    // no MMA is left in flight across the halo code.
    wgmma_wait<0>();
    // Formed per chunk, so that no 64-bit pointer stays live across the MMAs.
    const T* inb = in + (size_t)b * HW * C;
    if (NORM) {
      if (tid < KCH) {
        const bool ok = c0 + tid < C;
        s_sc[tid] = ok ? in_scale[(size_t)b * C + c0 + tid] : 0.f;
        s_sh[tid] = ok ? in_shift[(size_t)b * C + c0 + tid] : 0.f;
      }
      __syncthreads();
    }
    // The halo, HALO_BATCH items per thread in flight.
    constexpr int IPP = KCH / VEC;  // items per pixel
    const int items = nvr * W * IPP;
    for (int i0 = tid; i0 < items; i0 += NT * HALO_BATCH) {
      uint4 q[HALO_BATCH];
#pragma unroll
      for (int u = 0; u < HALO_BATCH; ++u) {
        const int i = i0 + u * NT, hp = i / IPP, c = c0 + (i % IPP) * VEC;
        const int r = reflect1(h_first - 1 + hp / W, H);
        q[u] = halo_fetch(inb + ((size_t)r * W + hp % W) * C + c, i < items && c < C);
      }
#pragma unroll
      for (int u = 0; u < HALO_BATCH; ++u) {
        const int i = i0 + u * NT;
        if (i < items)
          halo_put<T, NORM>(q[u], i / IPP, i % IPP, s_sc, s_sh, halo_hi, halo_lo);
      }
    }
    __syncthreads();

    // Per tap: wait for its B stage and start its MMAs; once the previous
    // tap's MMAs are done (at most one group in flight), load the next tap's
    // A fragments into the register set those used, and hand the previous
    // tap's B stage back to the loader.
    uint32_t ahi[2][KSTEPS][4], alo[2][KSTEPS][4];
    load_a<SPLIT>(ahi[0], alo[0], halo_hi, halo_lo, tap_row(0), khalf);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int it = ch * 9 + tap, stage = it % NSTAGE;
      while (!mbar_try_wait(&full[stage], (it / NSTAGE) & 1)) {
      }
      const uint32_t bhi = smem_u32(smem + stage * STAGE_BYTES);
      wgmma_fence();
      mma_tap<SPLIT>(acc, ahi[tap & 1], alo[tap & 1], bhi, bhi + BTILE_BYTES, it > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (tap < 8)
        load_a<SPLIT>(ahi[(tap + 1) & 1], alo[(tap + 1) & 1], halo_hi, halo_lo,
                      tap_row(tap + 1), khalf);
      __syncthreads();  // every warpgroup is done with the previous stage (and,
                        // after the last tap, with the halo)
      const int next = it - 1 + NSTAGE;
      if (tid == 0 && it > 0 && next < niter)
        load_stage(smem + (next % NSTAGE) * STAGE_BYTES, wblk + (size_t)next * 2 * BTILE,
                   &full[next % NSTAGE]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(acc[j])::"memory");

  // Epilogue. Accumulator j of this thread is pixel row m0 + 8 * ((j >> 1) & 1)
  // and channel 8 * (j >> 2) + 2 * (lane & 3) + (j & 1) of the tile.
  const int m0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const bool ok0 = p0 + m0 < HW, ok1 = p0 + m0 + 8 < HW;
  float* outb = out + ((size_t)b * HW + p0) * C;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const int co = n0 + 8 * nb + 2 * (lane & 3);
    const float bias0 = co < C ? bias[co] : 0.f, bias1 = co < C ? bias[co + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float& v0 = acc[4 * nb + 2 * half];
      float& v1 = acc[4 * nb + 2 * half + 1];
      v0 += bias0;
      v1 += bias1;
      if (!(half ? ok1 : ok0)) continue;
      float* dst = outb + (size_t)(m0 + 8 * half) * C + co;
      if (co < C) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    }
  }

  float* red = reinterpret_cast<float*>(halo_hi);  // [8 warps][TN]
  float* s_mean = red + 8 * TN;
  const int nvalid = min(TP, HW - p0);
  // Pass 1: per-channel sums of the valid pixels -> the tile mean.
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = (ok0 ? acc[4 * nb + e] : 0.f) + (ok1 ? acc[4 * nb + 2 + e] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[warp * TN + 8 * nb + 2 * lane + e] = s;
    }
  __syncthreads();
  if (tid < TN) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * TN + tid];
    s_mean[tid] = s / (float)nvalid;
  }
  __syncthreads();
  // Pass 2: squared deviations from the tile mean -> M2.
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mu = s_mean[8 * nb + 2 * (lane & 3) + e];
      const float d0 = ok0 ? acc[4 * nb + e] - mu : 0.f;
      const float d1 = ok1 ? acc[4 * nb + 2 + e] - mu : 0.f;
      float q = d0 * d0 + d1 * d1;
      q += __shfl_xor_sync(0xffffffffu, q, 4);
      q += __shfl_xor_sync(0xffffffffu, q, 8);
      q += __shfl_xor_sync(0xffffffffu, q, 16);
      if (lane < 4) red[warp * TN + 8 * nb + 2 * lane + e] = q;
    }
  __syncthreads();
  if (tid < TN && n0 + tid < C) {
    float q = 0.f;
    for (int w = 0; w < 8; ++w) q += red[w * TN + tid];
    part[((size_t)b * ntiles + tile) * C + n0 + tid] = make_float2(s_mean[tid], q);
  }
}

// w1, w2: (3, 3, C, C) HWIO f32 -> img: [conv][TN block][chunk][tap][hi, lo]
// tiles of TN x KCH bf16, zero past C. Element (n, k) of a tile sits at
// (k / 8) * (TN * 8) + n * 8 + k % 8: core matrices of 8 n x 8 k, 128 bytes
// each, 2048 B apart along K and 128 B apart along N (see b_desc).
__global__ void split_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                     __nv_bfloat16* __restrict__ img, int C, size_t per_conv) {
  const int nch = (C + KCH - 1) / KCH;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * per_conv;
       i += (size_t)gridDim.x * blockDim.x) {
    const float* w = i < per_conv ? w1 : w2;
    size_t r = i % per_conv;
    const int e = (int)(r % BTILE);
    r /= BTILE;
    const int lo = (int)(r % 2);
    r /= 2;
    const int tap = (int)(r % 9);
    r /= 9;
    const int ch = (int)(r % nch), nb = (int)(r / nch);
    const int ci = ch * KCH + (e / (TN * 8)) * 8 + e % 8, co = nb * TN + (e / 8) % TN;
    const float v = ci < C && co < C ? w[((size_t)tap * C + ci) * C + co] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    img[i] = lo ? __float2bfloat16_rn(v - __bfloat162float(hi)) : hi;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// out = x + y * scale + shift, four channels per item (C % 8 == 0).
template <typename T>
__global__ void residual_kernel(const T* __restrict__ x, const float* __restrict__ y,
                                const float* __restrict__ scale, const float* __restrict__ shift,
                                T* __restrict__ out, int HW, int C, size_t total) {
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < total;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    const size_t bc = (i / ((size_t)HW * C)) * C + i % C;
    float xv[4], yv[4], sc[4], sh[4];
    load4(x + i, xv);
    load4(y + i, yv);
    load4(scale + bc, sc);
    load4(shift + bc, sh);
#pragma unroll
    for (int e = 0; e < 4; ++e) xv[e] += yv[e] * sc[e] + sh[e];
    store4(out + i, xv);
  }
}

size_t split_elems_per_conv(int C) {
  return (size_t)((C + TN - 1) / TN) * ((C + KCH - 1) / KCH) * 9 * 2 * BTILE;
}

template <typename T, bool NORM>
cudaError_t launch_conv(dim3 grid, int halo_cap, cudaStream_t s, const T* in,
                        const float* in_scale, const float* in_shift,
                        const __nv_bfloat16* wimg, const float* bias, float* out, float2* part,
                        int H, int W, int C, int ntiles) {
  const int bytes = conv_smem_bytes(halo_cap, sizeof(T) == 4);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_kernel<T, NORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  conv3x3_tc_kernel<T, NORM><<<grid, NT, bytes, s>>>(in, in_scale, in_shift, wimg, bias, out,
                                                      part, H, W, C, ntiles, halo_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* xv, void* outv, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* g1, const float* be1, const float* g2,
                const float* be2, __nv_bfloat16* wimg, float* y1, float* y2, float2* part,
                float* scale, float* shift, int B, int H, int W, int C, float eps,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int HW = H * W;
  const int ntiles = (HW + TP - 1) / TP;
  const int halo_cap = halo_pixels(H, W);
  const size_t per_conv = split_elems_per_conv(C);
  const dim3 cgrid(ntiles, (C + TN - 1) / TN, B);
  const dim3 fgrid(B, (C + FIN_THREADS - 1) / FIN_THREADS);
  cudaError_t err;

  const size_t pblocks = (2 * per_conv + 255) / 256;
  split_weights_kernel<<<(int)(pblocks < 132 * 8 ? pblocks : 132 * 8), 256, 0, s>>>(
      w1, w2, wimg, C, per_conv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_conv<T, false>(cgrid, halo_cap, s, x, nullptr, nullptr, wimg, b1, y1, part,
                                   H, W, C, ntiles)) != cudaSuccess)
    return err;
  gk::in_finalize_kernel<<<fgrid, FIN_THREADS, 0, s>>>(part, g1, be1, scale, shift, HW, C, TP,
                                                       ntiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_conv<float, true>(cgrid, halo_cap, s, y1, scale, shift, wimg + per_conv, b2,
                                      y2, part, H, W, C, ntiles)) != cudaSuccess)
    return err;
  gk::in_finalize_kernel<<<fgrid, FIN_THREADS, 0, s>>>(part, g2, be2, scale, shift, HW, C, TP,
                                                       ntiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)B * HW * C;
  const size_t want = (total / 4 + 255) / 256;
  const int rblocks = (int)(want < 132 * 16 ? want : 132 * 16);
  residual_kernel<T><<<rblocks, 256, 0, s>>>(x, y2, scale, shift, out, HW, C, total);
  return cudaGetLastError();
}

}  // namespace

// Pixels per conv tile: the wrapper sizes `part` as (B, ceil(H*W / this), C).
extern "C" int gk_resblock_tile_pixels(void) { return TP; }

// Bytes of the split-weight scratch `wsplit` for C channels.
extern "C" int gk_resblock_wsplit_bytes(int C) {
  return (int)(2 * split_elems_per_conv(C) * sizeof(__nv_bfloat16));
}

// Dynamic shared memory one conv block needs at this H, W (the f32 conv).
extern "C" int gk_resblock_smem_bytes(int H, int W) {
  return conv_smem_bytes(halo_pixels(H, W), true);
}

// x, out: (B, H, W, C) contiguous, dtype by `dtype` (gk::DType). w1, w2:
// (3, 3, C, C) f32 HWIO; b1, b2: (C,) f32; g1, be1, g2, be2: (B, C) f32.
// Scratch: wsplit (gk_resblock_wsplit_bytes(C) bytes, 16-byte aligned); y1, y2
// (B, H*W, C) f32; part (B, ntiles, C) float2; scale, shift (B, C) f32.
// Returns the first launch error of the chain (0 on success).
extern "C" int gk_resblock(const void* x, void* out, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* g1, const float* be1,
                           const float* g2, const float* be2, void* wsplit, float* y1, float* y2,
                           void* part, float* scale, float* shift, int B, int H, int W, int C,
                           int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float2*>(part);
  auto wimg = static_cast<__nv_bfloat16*>(wsplit);
  if (dtype == gk::kFloat32)
    return (int)run<float>(x, out, w1, b1, w2, b2, g1, be1, g2, be2, wimg, y1, y2, p, scale,
                           shift, B, H, W, C, eps, s);
  if (dtype == gk::kBFloat16)
    return (int)run<__nv_bfloat16>(x, out, w1, b1, w2, b2, g1, be1, g2, be2, wimg, y1, y2, p,
                                   scale, shift, B, H, W, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
