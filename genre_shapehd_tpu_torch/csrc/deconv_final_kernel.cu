// K3 `deconv_final`: ConvTranspose3d(Cin -> 1, k=4, s=2, p=1) + bias, the
// last layer (dec6) of the 3D U-Net, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_final_tail_kernel` of
// genre_shapehd_tpu/ops/pallas/subpixel_kernel.py and the XLA phase conv
// in front of it (`_final_fwd`): the whole of `deconv_final_fused`.  The
// TPU splits the layer into an XLA conv that leaves an 8-phase tensor in
// memory and a kernel that interleaves the phases with selection-matrix
// matmuls, because Mosaic cannot interleave lanes.  A GPU thread writes
// wherever it likes, so here one kernel does the contraction and writes
// the interleaved output directly; no phase tensor exists.
//
// Layout (PyTorch's): x (B, Cin, X, Y, Z), weight (Cin, 1, 4, 4, 4) given
// as float32 (Cin, 64) and rounded to x's dtype by the kernel, bias (1,)
// float32 -> out (B, 1, 2X, 2Y, 2 Zo): the output planes of the Zo input
// positions klo .. klo + Zo - 1 along k (Z); klo 0 and Zo = Z for the
// whole layer, klo 1 and Zo = Z - 2 (or fewer) for a Z slab of the
// sharded 3D U-Net whose first and last planes are its neighbours' halo.
// Per axis, output o = 2p + a (a in {0,1}) takes inputs p + d - 1 for
// the offsets d in {0,1,2} with d - a in {0,1}, through tap 3 + a - 2d,
// zero outside the input's extent.
//
// What bounds it: device-memory bytes.  At the main path's shape (B=8,
// Cin=40, S=64, bf16) it reads 168 MB and writes 34 MB, 60 us at
// 3.35 TB/s.  Its 5.4 G multiply-adds take 160 us at the float32 rate of
// the CUDA cores, so the bf16 path runs them on the tensor cores:
//   - the layer is a GEMM per tile: A = positions x (27 offsets x Cin),
//     never formed in memory; B = (27 x Cin_pad) x 8 output phases, the
//     weight with its structured zeros (ops/cuda/subpixel_kernel.py::
//     pack_weight is the same packing in PyTorch);
//   - mma.sync.m16n8k16 (bf16 in, float32 sums): 16 positions along k, 16
//     channels of one offset, the 8 phases.  ldmatrix.trans reads A
//     straight from a channel-major tile in shared memory.  The offset
//     along k is not a shifted view (a one-element shift breaks
//     ldmatrix's 16-byte rows): the sums are kept over unshifted rows and
//     shifted by warp shuffles in the epilogue.  Each k offset but the
//     middle one feeds one output parity f only, so offsets dk = 0 (f = 0
//     columns) and dk = 2 (f = 1 columns) share one product: 18 products
//     per (16 positions, 16 channels) instead of 27, 29 GFLOP in all at
//     Cin_pad = 48, 29 us at the dense bf16 peak;
//   - a tile is a 4 x 4 block of (i, j) rows, one warp each, over the
//     whole k axis (Z <= 64).  Per chunk of 16 channels one TMA copy
//     stages the tile with a one-row halo in i and j, (6, 6, 16, 64)
//     bf16 = 72 KB, zero-filled outside the volume and past Cin, with the
//     128-byte swizzle that keeps ldmatrix free of bank conflicts; the
//     halo makes the copies 2.25x the input, from L2.  (With all threads
//     issuing cp.async copies instead, the issue stalled the products:
//     copies and products took their sum, not their maximum.)  Blocks are
//     persistent, one per SM, and walk tiles; two stages, so the next
//     chunk's copy (the next tile's first chunk at a tile's end) runs
//     during the current chunk's products and the epilogue.  B of every
//     chunk is built once per block, rounded from the float32 weight, in
//     shared memory (14 KB at Cin = 40);
//   - the epilogue adds the float32 bias, rounds once to bf16 and stores
//     the pair (2k, 2k+1) of one output row as 4 bytes (phases are ordered
//     (a, e, f), so a thread's accumulator columns 2t, 2t + 1 are f = 0, 1).
// float32 (dtype 0, the default command's type; the tests' 1e-5 checks,
// which TF32 cannot hold, and 3xTF32 on this GEMM would carry its
// structured zeros: 2.25x the useful products three times over, no faster
// than the CUDA cores' 160 us) and the bf16 shapes this tiling does not
// take (Z > 64, Z not a multiple of 8, Cin > 288) run on the CUDA cores:
//   - per axis, output 2p + a takes input p + d - 1 through tap 3 + a -
//     2d for d - a in {0, 1}, so one input value feeds 4 (output, tap)
//     pairs per axis, 64 in 3-D;
//   - a thread computes all 8 phases of a 2 x 2 x 2 block of input
//     positions (i, j, k pairs): per channel 512 FMAs from the block's
//     4 x 4 x 4 neighbourhood, 16 rows of 4 values read from shared
//     memory as an aligned pair and two single values (8 FMAs a value),
//     and the
//     channel's 64 weights, the same for every thread, read as 16-byte
//     broadcasts;
//   - a tile is 4 x 8 rows of (i, j) by 64 positions along k, a warp
//     per 2 x 2 rows (a lane per k pair), 8 warps; per chunk of 4
//     channels one TMA copy stages the tile with its halo, (6, 10, 68)
//     values a channel (rows of 72 floats, 80 bf16, from 16 bytes before
//     the tile: TMA wants a box's innermost start 16-byte aligned),
//     zero-filled outside the volume and past Cin; where TMA cannot
//     describe x (rows not whole 16-byte units: Z not a multiple of 4,
//     of 8 in bf16) the threads stage it with plain loads, which nothing
//     overlaps (7x the TMA variant's time at dec6's float32 shape);
//   - persistent blocks, one per SM, walk the tiles; two stages, so the
//     next chunk's copy runs during this chunk's FMAs.  Each stage holds
//     its chunk's weights too (rounded to x's type), loaded one per
//     thread during the previous chunk: any Cin.
// Accumulation and the bias add are float32; the result is rounded once
// to the output type (as the Pallas kernel does).
// `dtype` 0 = float32 x/out, 1 = bfloat16.  The entry point returns
// cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ tensor cores
constexpr int kTI = 4, kTJ = 4;              // (i, j) rows per tile, a warp each
constexpr int kWarps = kTI * kTJ;
constexpr int kHI = kTI + 2, kHJ = kTJ + 2;  // the staged tile's halo extents
constexpr int kCh = 16;                      // channels per chunk (mma's k)
constexpr int kKP = 64;                      // positions per row: 128 bytes
constexpr int kNT = kKP / 16;                // m-tiles per row
constexpr int kStage = kHI * kHJ * kCh * kKP * 2;  // 72 KB
constexpr int kBWords = 9 * 2 * 8 * 8;       // a chunk's B, bf16 pairs

// 1 KB of slack to align the stages, two stages, B of every chunk, two
// mbarriers.
__host__ __device__ constexpr int smem_bytes(int chunks) {
  return 1024 + 2 * kStage + chunks * kBWords * 4 + 16;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// B of every chunk, packed as the mma wants it.  Two products per (di,
// dj): set 1 takes dk = 1 for all 8 phases; set 0 takes dk = 0 for the
// phases f = 0 and dk = 2 for f = 1 (each k offset but the middle one
// feeds one f only).  bs[((chunk * 9 + didj) * 2 + set) * 64 + g * 8 + 2t
// + h] is the bf16 pair B[c0 + 2t + 8h + {0,1}][g], rounded from the
// float32 weight: lane (g, t)'s B fragment is one 8-byte load.
__device__ void build_b(const float* __restrict__ w, uint32_t* bs, int Cin,
                        int chunks) {
  for (int n = threadIdx.x; n < chunks * kBWords; n += blockDim.x) {
    const int slot = n & 7, g = (n >> 3) & 7, set = (n >> 6) & 1;
    const int didj = (n >> 7) % 9, chunk = (n >> 7) / 9;
    const int di = didj / 3, dj = didj % 3;
    const int a = g >> 2, e = (g >> 1) & 1, f = g & 1;
    const int dk = set ? 1 : 2 * f;
    const int ch = chunk * kCh + 2 * (slot >> 1) + 8 * (slot & 1);
    const bool ok = (unsigned)(di - a) <= 1u && (unsigned)(dj - e) <= 1u &&
                    (unsigned)(dk - f) <= 1u;
    const int tap = ((3 + a - 2 * di) * 4 + (3 + e - 2 * dj)) * 4 +
                    (3 + f - 2 * dk);
    const float lo = ok && ch < Cin ? __ldg(w + ch * 64 + tap) : 0.f;
    const float hi = ok && ch + 1 < Cin ? __ldg(w + (ch + 1) * 64 + tap) : 0.f;
    bs[n] = pack_bf16x2(lo, hi);
  }
}

// A stage holds the tile of chunk c0 at (b, i0, j0): rows r = (hi * kHJ
// + hj) * kCh + c of 64 positions k (128 bytes) for input (i0 - 1 + hi,
// j0 - 1 + hj, channel c0 + c), zero outside the volume, past Z and past
// Cin (TMA's fill).  The 16-byte chunk k / 8 of row r sits at chunk
// (k / 8) ^ (r % 8): TMA's 128-byte swizzle, which puts the 8 channel rows
// an ldmatrix reads in 8 bank groups.
//
// Persistent: block n walks tiles n, n + gridDim.x, ...; a tile is batch
// item b, rows i0 .. i0+kTI-1, j0 .. j0+kTJ-1, all k.  Its steps are the
// channel chunks.  Thread 0 starts the next step's copy (the next tile's
// first chunk at a tile's end) into the other stage before the current
// step computes.  Warp (wi, wj) owns row (i0 + wi, j0 + wj).  kCube: the
// whole layer on a cube (Y = Zo = X, klo = 0), the main path's call, with
// no more live values than that needs.
template <bool kCube>
__global__ void __launch_bounds__(kWarps * 32, 1)
deconv_final_mma_kernel(__grid_constant__ const CUtensorMap tmap,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int B, int Cin,
                        int X, int Y_, int klo_, int Zo_) {
  const int Y = kCube ? X : Y_, klo = kCube ? 0 : klo_, Zo = kCube ? X : Zo_;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int TJn = (Y + kTJ - 1) / kTJ, TIn = (X + kTI - 1) / kTI;
  const int tiles = B * TIn * TJn, chunks = (Cin + kCh - 1) / kCh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = warp / kTJ, wj = warp % kTJ;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* bs = reinterpret_cast<uint32_t*>(smem + 2 * kStage);
  const uint32_t bar0 = smem_addr(bs + chunks * kBWords);
  auto issue = [&](int tile, int n, int buf) {   // thread 0 only
    const uint32_t bar = bar0 + 8 * buf;
    mbar_expect_tx(bar, kStage);
    tma_load_5d(smem_addr(smem + buf * kStage), &tmap, 0, n * kCh,
                (tile % TJn) * kTJ - 1, (tile / TJn % TIn) * kTI - 1,
                tile / (TJn * TIn), bar);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_fence_init();
    if (blockIdx.x < tiles) issue(blockIdx.x, 0, 0);
  }
  build_b(w, bs, Cin, chunks);
  __syncthreads();

  // this lane's ldmatrix row: matrix q = lane / 8 holds channels
  // 8 * (q / 2) + 0..7 at positions 8 * (q % 2) + 0..7 of an m-tile; its
  // row's swizzle is lane % 8
  const int q = lane >> 3;
  const uint32_t lane_row = ((lane & 7) + 8 * (q >> 1)) * 128;
  uint32_t lane_chunk[kNT];
#pragma unroll
  for (int m = 0; m < kNT; ++m)
    lane_chunk[m] = ((2 * m + (q & 1)) ^ (lane & 7)) << 4;
  const float bv = __ldg(bias);
  const int64_t Oi = 2 * (int64_t)X, Oj = 2 * (int64_t)Y, Ok = 2 * (int64_t)Zo;
  const int up = (lane + 4) & 31, dn = (lane + 28) & 31;
  const uint2* b2 = reinterpret_cast<const uint2*>(bs);
  int buf = 0;
  uint32_t phase = 0;                        // per stage, its next parity
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i0 = (tile / TJn % TIn) * kTI, j0 = (tile % TJn) * kTJ;
    const int bi = tile / (TJn * TIn);
    float acc[2][kNT][4];                    // [set][m-tile][fragment]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int m = 0; m < kNT; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][m][r] = 0.f;
    for (int n = 0; n < chunks; ++n, buf ^= 1) {
      const bool last = n + 1 == chunks;
      if (threadIdx.x == 0 && (!last || tile + (int)gridDim.x < tiles))
        issue(last ? tile + (int)gridDim.x : tile, last ? 0 : n + 1, buf ^ 1);
      mbar_wait(bar0 + 8 * buf, (phase >> buf) & 1);
      phase ^= 1u << buf;
      const uint32_t xa = smem_addr(smem + buf * kStage) + lane_row;
      const uint2* bn = b2 + n * (kBWords / 2);
#pragma unroll
      for (int didj = 0; didj < 9; ++didj) {
        const int di = didj / 3, dj = didj % 3;
        const uint2 b0 = bn[(didj * 2) * 32 + g * 4 + t];
        const uint2 b1 = bn[(didj * 2 + 1) * 32 + g * 4 + t];
        const uint32_t row = xa + ((wi + di) * kHJ + wj + dj) * (kCh * 128);
#pragma unroll
        for (int m = 0; m < kNT; ++m) {
          uint32_t a[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
              : "r"(row + lane_chunk[m]));
          mma_bf16(acc[0][m], a, b0);
          mma_bf16(acc[1][m], a, b1);
        }
      }
      __syncthreads();                       // the stage is refilled next
    }

    // Offset dk reads input p + dk - 1, so out[p] = C_1[p] + C_0[p - 1]
    // for f = 0 and C_1[p] + C_0[p + 1] for f = 1 (set 0 holds dk = 0 in
    // the f = 0 columns and dk = 2 in the f = 1 columns).  Fragment
    // entries [0], [1] are row g, columns 2t (f = 0), 2t + 1 (f = 1); [2],
    // [3] row g + 8.  Row neighbours sit 4 lanes away, or in the other
    // half, or in the neighbouring m-tile.  Position p of the staged row
    // is output position p - klo.
    const int i = i0 + wi, j = j0 + wj, a = t >> 1, e = t & 1;
    const bool row_in = i < X && j < Y;
    __nv_bfloat16* orow = out + (int64_t)bi * Oi * Oj * Ok +
                          ((2 * (int64_t)i + a) * Oj + 2 * j + e) * Ok -
                          2 * klo;
#pragma unroll
    for (int m = 0; m < kNT; ++m) {
      const float lo_prev = __shfl_sync(0xffffffffu, acc[0][m][0], dn);
      const float hi_prev = __shfl_sync(0xffffffffu, acc[0][m][2], dn);
      const float tile_prev =
          m > 0 ? __shfl_sync(0xffffffffu, acc[0][m - 1][2], dn) : 0.f;
      const float lo_next = __shfl_sync(0xffffffffu, acc[0][m][1], up);
      const float hi_next = __shfl_sync(0xffffffffu, acc[0][m][3], up);
      const float tile_next =
          m + 1 < kNT ? __shfl_sync(0xffffffffu, acc[0][m + 1][1], up) : 0.f;
      const float o0 = acc[1][m][0] + (g > 0 ? lo_prev : tile_prev);
      const float o1 = acc[1][m][1] + (g < 7 ? lo_next : hi_next);
      const float o2 = acc[1][m][2] + (g > 0 ? hi_prev : lo_prev);
      const float o3 = acc[1][m][3] + (g < 7 ? hi_next : tile_next);
      const int p = m * 16 + g;
      if (row_in && (unsigned)(p - klo) < (unsigned)Zo)
        *reinterpret_cast<uint32_t*>(orow + 2 * p) =
            pack_bf16x2(o0 + bv, o1 + bv);
      if (row_in && (unsigned)(p + 8 - klo) < (unsigned)Zo)
        *reinterpret_cast<uint32_t*>(orow + 2 * (p + 8)) =
            pack_bf16x2(o2 + bv, o3 + bv);
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

// x as a 5-D tensor (k, c, j, i, b), innermost first, and the box of one
// stage: 64 k x 16 channels x 6 j x 6 i of one item, 128-byte swizzle.
bool encode_x(CUtensorMap* map, const void* x, int B, int Cin, int X, int Y,
              int Z) {
  EncodeTiled fn = encode_tiled();
  if (!fn || Z % 8 != 0 || (uintptr_t)x % 16 != 0) return false;
  const cuuint64_t nx = X, ny = Y, nz = Z, e = 2;
  const cuuint64_t dims[5] = {nz, (cuuint64_t)Cin, ny, nx, (cuuint64_t)B};
  const cuuint64_t strides[4] = {nx * ny * nz * e, nz * e, ny * nz * e,
                                 (cuuint64_t)Cin * nx * ny * nz * e};
  const cuuint32_t box[5] = {kKP, kCh, kHJ, kHI, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core kernel for a bf16 call it takes (Z <= 64 and a multiple
// of 8, B of every chunk beside the two stages in shared memory: Cin <=
// 288), one block per SM (its shared memory admits no second), each
// walking its share of the tiles.  Returns -1 for a call it does not take.
int launch_mma(const void* x, const float* w, const float* bias, void* out,
               int B, int Cin, int X, int Y, int Z, int klo, int Zo,
               cudaStream_t st) {
  CUtensorMap map{};
  if (Z > kKP || smem_bytes((Cin + kCh - 1) / kCh) > 227 * 1024 ||
      (uintptr_t)out % 4 != 0 || !encode_x(&map, x, B, Cin, X, Y, Z))
    return -1;
  static int sms[64];                        // SMs per device; 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(deconv_final_mma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(deconv_final_mma_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 227 * 1024);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t tiles =
      (int64_t)B * ((X + kTI - 1) / kTI) * ((Y + kTJ - 1) / kTJ);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms[dev] ? tiles : sms[dev]);
  const bool cube = X == Y && Y == Z && klo == 0 && Zo == Z;
  (cube ? deconv_final_mma_kernel<true> : deconv_final_mma_kernel<false>)
      <<<grid, kWarps * 32, smem_bytes((Cin + kCh - 1) / kCh), st>>>(
          map, w, bias, static_cast<__nv_bfloat16*>(out), B, Cin, X, Y, klo,
          Zo);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- CUDA cores
constexpr int kFI = 4, kFJ = 8;              // (i, j) rows per tile
constexpr int kFWarps = (kFI / 2) * (kFJ / 2);  // a warp per 2 x 2 rows
constexpr int kFHI = kFI + 2, kFHJ = kFJ + 2;   // the staged halo extents
constexpr int kFK = 64;                      // positions along k per tile
constexpr int kFCh = 4;                      // channels per stage

// A staged row starts 16 bytes before k0 (TMA faults on a box whose
// innermost start is not 16-byte aligned): slot s holds input k0 - kLead
// + s, and k0 + klo - 1 .. k0 + klo + 64 are read (klo 0 or 1).  Rows are
// whole 16-byte units (TMA's box rows): 72 floats or 80 bf16.
template <typename T> __host__ __device__ constexpr int fma_lead() {
  return 16 / (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr int fma_row() {
  return (fma_lead<T>() + 65 + fma_lead<T>() - 1) / fma_lead<T>() *
         fma_lead<T>();
}
template <typename T> __host__ __device__ constexpr int fma_x_bytes() {
  return kFCh * kFHI * kFHJ * fma_row<T>() * (int)sizeof(T);
}
// A stage: the x tile of kFCh channels, then their (kFCh, 64) weights.
template <typename T> __host__ __device__ constexpr int fma_stage_bytes() {
  return fma_x_bytes<T>() + kFCh * 64 * 4;
}
// 1 KB of slack to align the stages, two stages, two mbarriers.
template <typename T> __host__ __device__ constexpr int fma_smem_bytes() {
  return 1024 + 2 * fma_stage_bytes<T>() + 16;
}

// Two neighbouring values of a staged row as floats (p 4 or 8 bytes
// aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Tiles: (b, ti, tj, tk) with tk fastest; tile rows i0 = 4 ti, j0 = 8 tj,
// output positions k0 = 64 tk (input k0 + klo).  A step is one chunk of
// kFCh channels of a tile.
struct FmaGrid {
  int X, Y, Z, klo, Zo, Cin, TIn, TJn, TKn, chunks;
  __device__ void origin(int tile, int& b, int& i0, int& j0, int& k0) const {
    k0 = tile % TKn * kFK;
    j0 = tile / TKn % TJn * kFJ;
    i0 = tile / (TKn * TJn) % TIn * kFI;
    b = tile / (TKn * TJn * TIn);
  }
};

// The stage of chunk n of a tile by plain loads, for shapes TMA cannot
// describe: the same layout and zero fill as the TMA copy.
template <typename T>
__device__ void stage_x_plain(const T* __restrict__ x, T* xs,
                              const FmaGrid& g, int tile, int n) {
  constexpr int R = fma_row<T>(), L = fma_lead<T>();
  int b, i0, j0, k0;
  g.origin(tile, b, i0, j0, k0);
  for (int e = threadIdx.x; e < kFCh * kFHI * kFHJ * 66; e += blockDim.x) {
    const int s = e % 66, row = e / 66;
    const int hj = row % kFHJ, hi = row / kFHJ % kFHI, c = row / (kFHJ * kFHI);
    const int k = k0 + g.klo - 1 + s, j = j0 - 1 + hj, i = i0 - 1 + hi;
    const int ch = n * kFCh + c;
    T v = from_f32<T>(0.f);
    if ((unsigned)k < (unsigned)g.Z && (unsigned)j < (unsigned)g.Y &&
        (unsigned)i < (unsigned)g.X && ch < g.Cin)
      v = x[((((int64_t)b * g.Cin + ch) * g.X + i) * g.Y + j) * g.Z + k];
    xs[row * R + L - 1 + g.klo + s] = v;
  }
}

// Persistent: block n walks tiles n, n + gridDim.x, ...  Thread 0 starts
// the next step's TMA copy (the next tile's first chunk at a tile's end)
// into the other stage before this step computes; each thread loads one
// weight of the next step then and stores it after the FMAs.  Warp (wi,
// wj) owns rows i0 + 2 wi + {0, 1}, j0 + 2 wj + {0, 1}; lane l owns output
// positions k0 + 2 l + {0, 1}.  kOdd: klo is 1, which moves the lane's
// first value to an even slot (the pairs of its 4 values are then the
// aligned ones).
template <typename T, bool kTma, bool kOdd>
__global__ void __launch_bounds__(kFWarps * 32, 1)
deconv_final_fma_kernel(__grid_constant__ const CUtensorMap tmap,
                        const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int B, int Cin, int X, int Y, int Z, int Zo) {
  constexpr int R = fma_row<T>(), klo = kOdd ? 1 : 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  FmaGrid g;
  g.X = X;
  g.Y = Y;
  g.Z = Z;
  g.klo = klo;
  g.Zo = Zo;
  g.Cin = Cin;
  g.TIn = (X + kFI - 1) / kFI;
  g.TJn = (Y + kFJ - 1) / kFJ;
  g.TKn = (Zo + kFK - 1) / kFK;
  g.chunks = (Cin + kFCh - 1) / kFCh;
  const int tiles = B * g.TIn * g.TJn * g.TKn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = warp / (kFJ / 2), wj = warp % (kFJ / 2);
  auto xs_of = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * fma_stage_bytes<T>());
  };
  auto ws_of = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * fma_stage_bytes<T>() +
                                    fma_x_bytes<T>());
  };
  const uint32_t bar0 = smem_addr(smem + 2 * fma_stage_bytes<T>());
  // this thread's weight of a step: channel n * kFCh + t / 64, tap t % 64,
  // rounded to T (the value a cast of it to T gives)
  auto weight = [&](int n) {
    const int ch = n * kFCh + (int)threadIdx.x / 64;
    return ch < Cin
               ? to_f32(from_f32<T>(__ldg(w + ch * 64 + threadIdx.x % 64)))
               : 0.f;
  };
  auto stage = [&](int tile, int n, int buf) {
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        int b, i0, j0, k0;
        g.origin(tile, b, i0, j0, k0);
        const uint32_t bar = bar0 + 8 * buf;
        mbar_expect_tx(bar, fma_x_bytes<T>());
        tma_load_5d(smem_addr(xs_of(buf)), &tmap, k0 - fma_lead<T>(), j0 - 1,
                    i0 - 1, n * kFCh, b, bar);
      }
    } else {
      stage_x_plain<T>(x, xs_of(buf), g, tile, n);
    }
  };
  if (kTma && threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (blockIdx.x < tiles) {
    stage(blockIdx.x, 0, 0);
    ws_of(0)[threadIdx.x] = weight(0);
  }
  __syncthreads();

  const float bv = __ldg(bias);
  const int64_t Oi = 2 * (int64_t)X, Oj = 2 * (int64_t)Y, Ok = 2 * (int64_t)Zo;
  int buf = 0;
  uint32_t phase = 0;                        // per stage, its next parity
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, i0, j0, k0;
    g.origin(tile, b, i0, j0, k0);
    // acc[r][q][p][a][e][f]: position (i0 + 2 wi + r, j0 + 2 wj + q, k0 +
    // 2 lane + p), phase (a, e, f)
    float acc[64];
#pragma unroll
    for (int u = 0; u < 64; ++u) acc[u] = 0.f;
    for (int n = 0; n < g.chunks; ++n, buf ^= 1) {
      const bool last = n + 1 == g.chunks;
      const bool more = !last || tile + (int)gridDim.x < tiles;
      const int next_tile = last ? tile + (int)gridDim.x : tile;
      const int next_n = last ? 0 : n + 1;
      float w_next = 0.f;
      if (more) {
        w_next = weight(next_n);
        stage(next_tile, next_n, buf ^ 1);
      }
      if constexpr (kTma) {
        mbar_wait(bar0 + 8 * buf, (phase >> buf) & 1);
        phase ^= 1u << buf;
      }
      // this lane's first value, input k0 + klo + 2 lane - 1, at slot
      // 2 lane + L - 1 + klo
      const T* xs = xs_of(buf) + ((2 * wi) * kFHJ + 2 * wj) * R + 2 * lane +
                    fma_lead<T>() - 1 + klo;
      const float4* ws = reinterpret_cast<const float4*>(ws_of(buf));
#pragma unroll 1
      for (int c = 0; c < kFCh; ++c, xs += kFHI * kFHJ * R, ws += 16) {
        float wc[64];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const float4 v = ws[t];
          wc[4 * t] = v.x;
          wc[4 * t + 1] = v.y;
          wc[4 * t + 2] = v.z;
          wc[4 * t + 3] = v.w;
        }
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {      // input plane i0 + 2 wi + pi - 1
#pragma unroll
          for (int pj = 0; pj < 4; ++pj) {    // input row j0 + 2 wj + pj - 1
            // v[u]: input k0 + klo + 2 lane + u - 1; the aligned pairs
            // are the middle one (klo 0, the ends single loads) or the
            // two halves (klo 1)
            const T* row = xs + (pi * kFHJ + pj) * R;
            float v[4];
            if constexpr (kOdd) {
              const float2 lo = load2(row), hi = load2(row + 2);
              v[0] = lo.x;
              v[1] = lo.y;
              v[2] = hi.x;
              v[3] = hi.y;
            } else {
              const float2 mid = load2(row + 1);
              v[0] = to_f32(row[0]);
              v[1] = mid.x;
              v[2] = mid.y;
              v[3] = to_f32(row[3]);
            }
            // position r of the block sees the plane at offset di = pi - r
            // (input i + di - 1), which feeds phase a where di - a is 0 or
            // 1, through tap 3 + a - 2 di; likewise (q, dj, e), (p, dk, f)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int di = pi - r;
#pragma unroll
              for (int a = 0; a < 2; ++a) {
                if (di - a < 0 || di - a > 1) continue;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const int dj = pj - q;
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    if (dj - e < 0 || dj - e > 1) continue;
#pragma unroll
                    for (int p = 0; p < 2; ++p)
#pragma unroll
                      for (int f = 0; f < 2; ++f)
#pragma unroll
                        for (int dk = f; dk <= f + 1; ++dk) {
                          const int tap = ((3 + a - 2 * di) * 4 +
                                           (3 + e - 2 * dj)) * 4 +
                                          (3 + f - 2 * dk);
                          float& o = acc[((((r * 2 + q) * 2 + p) * 2 + a) *
                                          2 + e) * 2 + f];
                          o = fmaf(v[p + dk], wc[tap], o);
                        }
                  }
                }
              }
            }
          }
        }
      }
      if (more) ws_of(buf ^ 1)[threadIdx.x] = w_next;
      __syncthreads();                       // the stage is refilled next
    }

    // the bias, one rounding to T, phases f = 0, 1 of one output row as
    // a pair
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 2 * wi + r;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + 2 * wj + q;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int k = k0 + 2 * lane + p;
          if (i >= X || j >= Y || k >= Zo) continue;
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float* o =
                  acc + ((((r * 2 + q) * 2 + p) * 2 + a) * 2 + e) * 2;
              store_pair(out + (((int64_t)b * Oi + 2 * i + a) * Oj + 2 * j +
                                e) * Ok + 2 * k,
                         o[0] + bv, o[1] + bv);
            }
        }
      }
    }
  }
}

// x as a 5-D tensor (k, j, i, c, b), innermost first, and the box of one
// stage: a row of fma_row<T>() k from k0 - fma_lead<T>() x 10 j x 6 i x
// kFCh channels of one item.
// False where TMA cannot describe it: a row of x is no whole number of
// 16-byte units, or x is not 16-byte aligned.
template <typename T>
bool encode_x_fma(CUtensorMap* map, const void* x, int B, int Cin, int X,
                  int Y, int Z) {
  EncodeTiled fn = encode_tiled();
  const cuuint64_t nx = X, ny = Y, nz = Z, e = sizeof(T);
  if (!fn || (nz * e) % 16 != 0 || (uintptr_t)x % 16 != 0) return false;
  const cuuint64_t dims[5] = {nz, ny, nx, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t strides[4] = {nz * e, ny * nz * e, nx * ny * nz * e,
                                 (cuuint64_t)Cin * nx * ny * nz * e};
  const cuuint32_t box[5] = {(cuuint32_t)fma_row<T>(), kFHJ, kFHI, kFCh, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            5, const_cast<void*>(x), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The CUDA-core kernel for any call: TMA staging where x allows it, else
// staging by plain loads; one block per SM (its shared memory admits no
// second), each walking its share of the tiles.
template <typename T>
int launch_fma(const void* x, const float* w, const float* bias, void* out,
               int B, int Cin, int X, int Y, int Z, int klo, int Zo,
               cudaStream_t st) {
  CUtensorMap map{};
  const bool tma = encode_x_fma<T>(&map, x, B, Cin, X, Y, Z);
  auto kernel = tma ? (klo ? deconv_final_fma_kernel<T, true, true>
                           : deconv_final_fma_kernel<T, true, false>)
                    : (klo ? deconv_final_fma_kernel<T, false, true>
                           : deconv_final_fma_kernel<T, false, false>);
  const int smem = fma_smem_bytes<T>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)B * ((X + kFI - 1) / kFI) *
                        ((Y + kFJ - 1) / kFJ) * ((Zo + kFK - 1) / kFK);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kFWarps * 32, smem, st>>>(
      map, static_cast<const T*>(x), w, bias, static_cast<T*>(out), B, Cin,
      X, Y, Z, Zo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, Cin, X, Y, Z), w (Cin, 64) float32, bias (1,) float32 ->
// out (B, 1, 2X, 2Y, 2 Zo), the output planes of input positions klo ..
// klo + Zo - 1 along Z (klo 0 or 1), all contiguous.
int deconv_final_slab(const void* x, const float* w, const float* bias,
                      void* out, int dtype, int B, int Cin, int X, int Y,
                      int Z, int klo, int Zo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Cin < 1 || X < 1 || Y < 1 || Zo < 1 || (klo != 0 && klo != 1) ||
      klo + Zo > Z)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fma<float>(x, w, bias, out, B, Cin, X, Y, Z, klo, Zo, st);
  if (dtype == 1) {
    const int err = launch_mma(x, w, bias, out, B, Cin, X, Y, Z, klo, Zo, st);
    return err >= 0 ? err
                    : launch_fma<__nv_bfloat16>(x, w, bias, out, B, Cin, X, Y,
                                                Z, klo, Zo, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The whole layer on a cube, the main path's call: x (B, Cin, S, S, S) ->
// out (B, 1, 2S, 2S, 2S).
int deconv_final(const void* x, const float* w, const float* bias, void* out,
                 int dtype, int B, int Cin, int S, void* stream) {
  return deconv_final_slab(x, w, bias, out, dtype, B, Cin, S, S, S, 0, S,
                           stream);
}

}  // extern "C"
