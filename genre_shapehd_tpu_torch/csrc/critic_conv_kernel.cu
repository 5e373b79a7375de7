// K7 `critic_conv`: LeakyReLU(0.2) of Conv3d(Cin -> Cout, k=4, s=2, p=1),
// no bias, channels-last, for Hopper (sm_90a): the ShapeHD / WGAN-GP
// critic's middle layers (nn/voxel_nets.py::VoxelDiscriminator, Conv3D_1
// .. Conv3D_4 at res 128: 64 -> 64, 64 -> 128, 128 -> 256, 256 -> 512 on
// 64^3 .. 8^3 inputs) in inference and in the frozen critic of ShapeHD's
// fine-tuning, under bf16 autocast.
//
// Replaces no Pallas kernel: the JAX package leaves these layers to XLA.
// It was added because cuDNN runs them, NCDHW, through its generic
// implicit_convolveNd_sgemm (Conv3D_2 .. _4: 20.0, 10.2 and 5.3 ms a call
// at batch 128 on an H100) or through its channels-last kernel with layout
// conversions around it (Conv3D_1: 7.5 ms and 4.8 of conversions), twice
// a ShapeHD batch: ~96 ms of a ~217 ms batch.
//
// Layout: x (B, D, H, W, Cin) bf16 (NDHWC: the caller's (B, Cin, D, H, W)
// in channels_last_3d), Cin a multiple of 64; w (Cout, 64 taps, Cin) bf16,
// tap (kd, kh, kw) = 16 kd + 4 kh + kw, Cout a multiple of 64 -> out (B,
// D/2, H/2, W/2, Cout) bf16.  Output o takes inputs 2 o - 1 + k, k = 0..3,
// on each axis, zero outside the volume.  Each output extent is at least 4.
//
// What bounds it: the tensor cores.  At batch 128 the four layers are
// 2.20, 0.55, 0.27 and 0.14 TFLOP, 2.22, 0.56, 0.28 and 0.14 ms at the
// dense bf16 peak; their bytes (Conv3D_1: 4.3 GB in, 0.54 GB out) take at
// most 1.44 ms at 3.35 TB/s.  The design keeps the tensor cores fed from
// shared memory and L2:
//   - implicit GEMM: M = output positions, N = Cout, K = 64 taps x Cin,
//     tap-major, so a K-step of 64 is one tap's 64 contiguous channels
//     (128 bytes a position);
//   - a tile is 256 output positions, a box (TB, TD, TH, TW) of items,
//     planes, rows and columns chosen from the shape (TW, TH 8 where the
//     extent allows, else 4; TD up to 4 or 16, TB the rest), by 128 output
//     channels (64 where Cout is not a multiple of 128);
//   - the input is read by parity class: along an axis the taps k = 0, 2
//     read the odd inputs 2 (o + j) - 1 and k = 1, 3 the even ones 2 (o +
//     j), j = k / 2, so the 8 taps whose parities agree read one phase
//     patch of (TB, TD + 1, TH + 1, TW + 1) positions, each tap the box
//     shifted by (jd, jh, jw).  One TMA copy with element strides 2 along
//     D, H, W stages a phase patch of 64 channels, zero-filled where it
//     leaves the volume (the padding), with the 128-byte swizzle; it
//     serves 8 K-steps.  Staged per tap, Conv3D_1's input would cross L2 8
//     times (34 GB); by phase patch 1.6 times;
//   - the weight's (BN x 64) tile of each K-step by TMA, 128-byte
//     swizzle, in a ring of 4 stages;
//   - two consumer warpgroups, 128 rows each (two m64 sub-tiles): A, the
//     tap's rows, by ldmatrix from the phase patch into registers (each
//     lane addresses its own row, so the shifted box needs no wgmma
//     descriptor layout of its own; the swizzle keeps the 8 rows of a
//     matrix in 8 bank groups); B by descriptor; wgmma.mma_async
//     m64nBNk16, float32 sums in registers;
//   - one thread of a producer warpgroup issues every copy, waiting on
//     "empty" mbarriers that each consumer warp arrives on once its
//     products have read a stage; the producer group gives its registers
//     to the consumers (setmaxnreg: 232 each, so that the sums, 128 a
//     thread at BN = 128, and the A fragments stay in registers and the
//     products of a K-step run back to back);
//   - persistent blocks, one per SM, walk the tiles (the N tile fastest,
//     so blocks in flight share their phase patches in L2); the next
//     tile's copies run during a tile's epilogue;
//   - the epilogue applies LeakyReLU(0.2) to the float32 sum and rounds
//     once to bf16, stored NDHWC.
// The entry point returns cudaGetLastError() after its launch, and
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int kBM = 256;                       // output positions a tile
constexpr int kConsumers = 2;                  // warpgroups, 128 rows each
constexpr int kSub = 2;                        // m64 sub-tiles a warpgroup
constexpr int kThreads = (kConsumers + 1) * 128;  // and a producer group
constexpr int kPatchStages = 2;
constexpr int kWStages = 4;
constexpr int kRow = 128;                      // bytes: 64 bf16 channels

// A call's shape and its tiling, chosen by plan().
struct Tiling {
  int B, D, H, W, Cin, Cout;                   // input extents, channels
  int OD, OH, OW;                              // output extents
  int TB, TD, TH, TW;                          // the tile's box
  int nb, nd, nh, nw, nn;                      // tiles along each; N tiles
  int BN;                                      // output channels a tile
  int patch_tx;                                // a phase patch's bytes
  int patch_bytes;                             // its stage, 1 KB multiple
  int smem;                                    // dynamic shared memory
};

__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : 0.2f * x;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The descriptor of a (rows x 64) bf16 tile at shared address `addr`
// (1 KB aligned), K-major with the 128-byte swizzle TMA wrote: 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// mbar_wait, but a wait past ~2 s of SM cycles traps: a fault in the
// pipeline's bookkeeping ends the launch with an error, not a hang.
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  }
}

// Orders later reads of a sum after the wgmma that wrote it.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d (64 x 64, float32) += a (64 x 16, the warpgroup's registers) x B
// (64 x 16 at the descriptor: K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128, float32) += a (64 x 16, the warpgroup's registers) x B
// (128 x 16 at the descriptor: K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  wgmma_n64(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_n128(d, a, desc);
}

// The tap of K-step j (0..7) of parity class (pd, ph, pw): along each
// axis k = 1 - p + 2 j', j' the axis's bit of j.
__device__ __forceinline__ int tap_of(int pd, int ph, int pw, int j) {
  const int kd = 1 - pd + 2 * (j >> 2), kh = 1 - ph + 2 * ((j >> 1) & 1),
            kw = 1 - pw + 2 * (j & 1);
  return 16 * kd + 4 * kh + kw;
}

// Tile `tile`'s origin: item, output plane, row, column, channel.
struct Origin {
  int b0, od0, oh0, ow0, n0;
};
__device__ __forceinline__ Origin origin_of(const Tiling& t, int tile,
                                            int BN) {
  Origin o;
  o.n0 = tile % t.nn * BN;
  tile /= t.nn;
  o.ow0 = tile % t.nw * t.TW;
  tile /= t.nw;
  o.oh0 = tile % t.nh * t.TH;
  tile /= t.nh;
  o.od0 = tile % t.nd * t.TD;
  o.b0 = tile / t.nd * t.TB;
  return o;
}

// Shared memory, from the first 1 KB boundary: kPatchStages phase
// patches, kWStages weight tiles (BN rows of 128 bytes), then the
// mbarriers: full and empty for each patch stage, full and empty for
// each weight stage.  A K-step (chunk c of 64 channels, parity class cls,
// tap j) is the same on both sides: chunks outermost, then the 8 classes,
// then their 8 taps.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
critic_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   __nv_bfloat16* __restrict__ out, const Tiling t) {
  constexpr int kAcc = BN / 2;                 // a thread's sums, sub-tile
  constexpr int kWBytes = BN * kRow;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t patch0 = base;
  const uint32_t w0 = patch0 + kPatchStages * t.patch_bytes;
  const uint32_t bar0 = w0 + kWStages * kWBytes;
  auto pfull = [&](int s) { return bar0 + 8 * s; };
  auto pempty = [&](int s) { return bar0 + 8 * (kPatchStages + s); };
  auto wfull = [&](int s) { return bar0 + 8 * (2 * kPatchStages + s); };
  auto wempty = [&](int s) {
    return bar0 + 8 * (2 * kPatchStages + kWStages + s);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPatchStages; ++s) {
      mbar_init(pfull(s), 1);
      mbar_init(pempty(s), kConsumers * 4);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = t.nb * t.nd * t.nh * t.nw * t.nn;
  const int chunks = t.Cin / 64;

  if (warp >= kConsumers * 4) {                // the producer warpgroup:
    // one thread issues every copy, and the group hands its registers to
    // the consumers (2 x 128 x 232 + 128 x 40 <= 64 K)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumers * 4 && lane == 0) {
      int ps = 0, pph = 0, ws = 0, wph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Origin o = origin_of(t, tile, BN);
        for (int c = 0; c < chunks; ++c)
          for (int cls = 0; cls < 8; ++cls) {
            const int pd = cls >> 2, ph = (cls >> 1) & 1, pw = cls & 1;
            // phase patch index i is input 2 o0 - p + 2 i on each axis
            wait_or_trap(pempty(ps), pph ^ 1);
            mbar_expect_tx(pfull(ps), t.patch_tx);
            tma_load_5d(patch0 + ps * t.patch_bytes, &xmap, 64 * c,
                        2 * o.ow0 - pw, 2 * o.oh0 - ph, 2 * o.od0 - pd, o.b0,
                        pfull(ps));
            if (++ps == kPatchStages) ps = 0, pph ^= 1;
            for (int j = 0; j < 8; ++j) {
              wait_or_trap(wempty(ws), wph ^ 1);
              mbar_expect_tx(wfull(ws), kWBytes);
              tma_load_2d(w0 + ws * kWBytes, &wmap,
                          tap_of(pd, ph, pw, j) * t.Cin + 64 * c, o.n0,
                          wfull(ws));
              if (++ws == kWStages) ws = 0, wph ^= 1;
            }
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers: warpgroup wg, its warp wq; rows (wg kSub + s) 64 + 16
  // wq + 0..15 of the tile in sub-tile s, the tile's rows ordered as its
  // box (TB, TD, TH, TW), TW fastest
  const int wg = warp >> 2, wq = warp & 3;
  const int PW = t.TW + 1, PH = t.TH + 1, PD = t.TD + 1;
  // ldmatrix: lane l gives the address of row l % 16 of the warp's 16, the
  // 16-byte chunk 2 kk + l / 16 of its 64 channels
  const int hi = lane >> 4;
  int prow[kSub];                              // its row in a phase patch
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int r = (wg * kSub + s) * 64 + wq * 16 + (lane & 15);
    const int tw = r % t.TW, th = r / t.TW % t.TH,
              td = r / (t.TW * t.TH) % t.TD, tb = r / (t.TW * t.TH * t.TD);
    prow[s] = ((tb * PD + td) * PH + th) * PW + tw;
  }
  const int g = lane >> 2, tq = lane & 3;
  int ps = 0, pph = 0, ws = 0, wph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Origin o = origin_of(t, tile, BN);
    float acc[kSub][kAcc];
#pragma unroll
    for (int s = 0; s < kSub; ++s)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[s][i] = 0.f;
    for (int step = 0; step < chunks * 8; ++step) {
      wait_or_trap(pfull(ps), pph);
      const uint32_t patch = patch0 + ps * t.patch_bytes;
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        // tap j reads the patch shifted by (j >> 2, (j >> 1) & 1, j & 1)
        const int shift = ((j >> 2) * PH + ((j >> 1) & 1)) * PW + (j & 1);
        uint32_t a[kSub][4][4];
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          const int p = prow[s] + shift;
          const uint32_t row = patch + p * kRow;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(a[s][kk], row + (((2 * kk + hi) ^ (p & 7)) << 4));
        }
        wait_or_trap(wfull(ws), wph);
        wgmma_fence();
        const uint64_t desc = sw128_desc(w0 + ws * kWBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int s = 0; s < kSub; ++s)
            wgmma<BN>(acc[s], a[s][kk], desc + 2 * kk);   // +32 bytes of K
        wgmma_commit();
        wgmma_wait0();
        if (lane == 0) mbar_arrive(wempty(ws));
        if (++ws == kWStages) ws = 0, wph ^= 1;
      }
      if (lane == 0) mbar_arrive(pempty(ps));
      if (++ps == kPatchStages) ps = 0, pph ^= 1;
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_operand(acc[s][i]);
    // sums acc[s][4 n + 2 h + e]: row 16 wq + g + 8 h of sub-tile s,
    // channel n0 + 8 n + 2 tq + e
#pragma unroll
    for (int s = 0; s < kSub; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wg * kSub + s) * 64 + wq * 16 + g + 8 * h;
        const int b = o.b0 + r / (t.TW * t.TH * t.TD),
                  od = o.od0 + r / (t.TW * t.TH) % t.TD,
                  oh = o.oh0 + r / t.TW % t.TH, ow = o.ow0 + r % t.TW;
        if (b >= t.B || od >= t.OD || oh >= t.OH || ow >= t.OW) continue;
        __nv_bfloat16* orow =
            out + (((int64_t)(b * t.OD + od) * t.OH + oh) * t.OW + ow) *
                      t.Cout + o.n0 + 2 * tq;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              pack_bf16x2(leaky(acc[s][4 * n + 2 * h]),
                          leaky(acc[s][4 * n + 2 * h + 1]));
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no
// -lcuda at build time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tiling of a call, false for a shape the kernel does not take.
bool plan(Tiling& t, int B, int D, int H, int W, int Cin, int Cout) {
  if (B < 1 || Cin < 64 || Cin % 64 || Cout < 64 || Cout % 64 || D % 2 ||
      H % 2 || W % 2 || D < 8 || H < 8 || W < 8)
    return false;
  t.B = B, t.D = D, t.H = H, t.W = W, t.Cin = Cin, t.Cout = Cout;
  t.OD = D / 2, t.OH = H / 2, t.OW = W / 2;
  t.TW = t.OW >= 8 ? 8 : 4;
  t.TH = t.OH >= 8 ? 8 : 4;
  t.TD = kBM / (t.TW * t.TH);                  // 4 or 16 planes at most,
  while (t.TD > 4 && t.TD / 2 >= t.OD) t.TD /= 2;  // no more than needed
  t.TB = kBM / (t.TW * t.TH * t.TD);
  t.nb = (B + t.TB - 1) / t.TB;
  t.nd = (t.OD + t.TD - 1) / t.TD;
  t.nh = (t.OH + t.TH - 1) / t.TH;
  t.nw = (t.OW + t.TW - 1) / t.TW;
  t.BN = Cout % 128 == 0 ? 128 : 64;
  t.nn = Cout / t.BN;
  t.patch_tx = t.TB * (t.TD + 1) * (t.TH + 1) * (t.TW + 1) * kRow;
  t.patch_bytes = (t.patch_tx + 1023) / 1024 * 1024;
  t.smem = 1024 + kPatchStages * t.patch_bytes + kWStages * t.BN * kRow +
           8 * 2 * (kPatchStages + kWStages);
  return (int64_t)t.nb * t.nd * t.nh * t.nw * t.nn < 0x7fffffff &&
         t.smem <= 227 * 1024;
}

// x as a 5-D tensor (c, w, h, d, b), innermost first; the box of a phase
// patch: 64 channels x every second position of 2 (T + 1) along w, h, d
// x TB items.
bool encode_x(CUtensorMap* map, const void* x, const Tiling& t) {
  EncodeTiled fn = encode_tiled();
  if (!fn || (uintptr_t)x % 16) return false;
  const cuuint64_t e = 2, c = t.Cin;
  const cuuint64_t dims[5] = {c, (cuuint64_t)t.W, (cuuint64_t)t.H,
                              (cuuint64_t)t.D, (cuuint64_t)t.B};
  const cuuint64_t strides[4] = {c * e, c * t.W * e, c * t.W * t.H * e,
                                 c * t.W * t.H * t.D * e};
  const cuuint32_t box[5] = {64, 2 * (cuuint32_t)(t.TW + 1),
                             2 * (cuuint32_t)(t.TH + 1),
                             2 * (cuuint32_t)(t.TD + 1), (cuuint32_t)t.TB};
  const cuuint32_t step[5] = {1, 2, 2, 2, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w as a 2-D tensor (64 Cin, Cout); the box of a K-step: 64 x BN.
bool encode_w(CUtensorMap* map, const void* w, const Tiling& t) {
  EncodeTiled fn = encode_tiled();
  if (!fn || (uintptr_t)w % 16) return false;
  const cuuint64_t k = 64 * (cuuint64_t)t.Cin;
  const cuuint64_t dims[2] = {k, (cuuint64_t)t.Cout};
  const cuuint64_t strides[1] = {k * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)t.BN};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
           const Tiling& t, cudaStream_t st) {
  auto kernel = critic_conv_kernel<BN>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = t.nb * t.nd * t.nh * t.nw * t.nn;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, t.smem, st>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin) bf16, w (Cout, 64, Cin) bf16 -> out (B, D/2, H/2,
// W/2, Cout) bf16, all contiguous.
int critic_conv(const void* x, const void* w, void* out, int B, int D,
                int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Tiling t;
  CUtensorMap xmap{}, wmap{};
  if (!plan(t, B, D, H, W, Cin, Cout) || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  if (!encode_x(&xmap, x, t) || !encode_w(&wmap, w, t))
    return (int)cudaErrorInvalidValue;
  return t.BN == 128 ? launch<128>(xmap, wmap, out, t, st)
                     : launch<64>(xmap, wmap, out, t, st);
}

}  // extern "C"
