// Spherical renderer kernels for Hopper (sm_90a): K1 (stage 1), K2
// (stage 2 + first-hit scan + expected depth) and K5 (stage 2 alone,
// every ray sample written out).
//
// Replaces the Pallas TPU kernels of
// genre_shapehd_tpu/ops/pallas/render_kernel.py:
//   K1 <- _s1_sparse_kernel (and its dense twin _s1_kernel)
//   K2 <- _s2scan_kernel
//   K5 <- _s2_kernel (reached from sample_rays_pallas), which the
//         renderer's backward runs to recompute the ray samples
//
// The TPU kernels spend dense MXU matmuls on the resampling because
// gathers are slow there.  Every hat-weight column has at most two
// adjacent nonzeros, so on this card each stage is a 2x2 bilinear gather
// with at most 4 terms per output.  The host passes per-column tap tables
// (first row `lo` and the weights of rows lo, lo+1), taken from the dense
// weight matrices (ops/render_sph_fast.py::tap_tables).
//
// What bounds them.  Device-memory bytes: at batch 8 (V=128, R=128,
// M=192, S=256, bf16 c) K1 reads the 67.1 MB float32 volume and writes
// the 50.3 MB cylindrical intermediate c, 35.2 us at 3.35 TB/s; K2 reads
// c and writes 0.5 MB, 15.4 us; K5 (batch 4) reads 25.2 MB of c and
// writes 67.1 MB of float32 samples, 27.8 us.  Behind the bytes, for K2
// and K5: the 4 gathers of each of the 33.5 M (K2) / 16.8 M (K5) ray
// samples, ~20 instructions a sample on the CUDA cores, and the tap
// records every (b, th) slab needs for every (ph, s).
//   K1: a streaming gather.  A block owns a run of 64 rows m of one
//       (b, th): consecutive m walk one ray of the (x, y) plane, so
//       neighbouring rows gather the same volume columns, from L1.  The
//       block loads the run's tap tables once, coalesced, into shared
//       memory.  Each thread moves 16 bytes of c per access (8 bf16 or 4
//       float32 along z, the contiguous axis of the volume (B,X,Y,Z) and
//       of c (B,Th,M,Z)), reads the volume in its own dtype (float32 or
//       bf16) with 16-byte loads and rounds each element to the compute
//       dtype in registers, the value a cast followed by a load gives.
//       The taps are uniform across a row, so the branch that skips
//       zero-weight taps never diverges within it.  Where V is not a
//       multiple of the vector width, or a pointer is not 16-byte
//       aligned, the same kernel runs with one element per access.
//   K2, K5: slab groups.  A persistent block (one per SM at the main
//       shape) walks groups of G consecutive flat slabs c[b * Th + th]
//       (M x V each; a group may cross a batch boundary) and holds a
//       group in shared memory, so c is read from device memory once
//       (ops/cuda/render_kernel.py::plan: G = 4 at the main shape, 195 KB;
//       two buffers of G = 2 in the same memory, copies overlapping the
//       work, measured slower: they stream the tap records twice as
//       often).  Rows are staged at a stride of an odd number of 4-byte
//       words (V = 128 bf16: 65 words), so that
//       the samples of one warp, which walk a line across (m, z), fall in
//       different banks; unpadded rows, which a TMA copy would write, put
//       one z of every row in the same bank (tools/probe_stage2_banks.py).
//       So the copies are cp.async of 4 bytes a thread, or plain loads
//       where a row is not 4-byte aligned.  Each warp takes ph rows in
//       turn, reads a row's tap records once (12 bytes a sample for bf16
//       c, 24 for float32, quad-major so that the loads coalesce; K2 has
//       the next row's in flight during this row's work) and applies them
//       to all G slabs: the records cross L2 once per group, not once per
//       ray.  Each sample is 4 shared-memory gathers and 4 multiply-adds
//       with the products of its z and m weights.
//       K2: lane l owns S/32 consecutive samples and keeps its running
//       product of (1 - p); a warp's exclusive product scan (shfl_up)
//       gives each lane the transmittance T before its first sample.  The
//       expected depth sum_s p_s T_s s / (S - 1) + T_S is, summed by
//       parts, sum_{s>=1} T_s / (S - 1): one pass, no log1p and no exp --
//       the product form of ops/stop_prob.py in place of the log-sum form
//       of _s2scan_kernel.
//       K5: lanes own 4 consecutive s and store them as one float4, so a
//       group's G consecutive th write G * S * 4 contiguous bytes per (b,
//       ph).
// Accumulation is float32.  `dtype` 0 = float32 c, 1 = bfloat16 c; K1's
// `in_dtype` codes the volume's dtype the same way.
// Each entry point returns cudaGetLastError() after its launch.

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

// Rounds a float32 value to the compute dtype and back: what a cast of
// the volume to that dtype followed by a load gives.
template <typename Tc> __device__ __forceinline__ float to_compute(float x);
template <> __device__ __forceinline__ float to_compute<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_compute<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// VEC consecutive elements of type Tin at p (aligned to VEC * sizeof(Tin)
// bytes), each rounded to the compute dtype Tc, as float32.
template <typename Tin, typename Tc, int VEC>
__device__ __forceinline__ void load_vec(const Tin* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_compute<Tc>(to_f32(p[0]));
  } else {
    constexpr int kWords = VEC * (int)sizeof(Tin) / 4;
    uint32_t w[kWords];
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = u.x; w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
      }
    } else {
      static_assert(kWords == 2, "8-byte loads");
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float f;
      if constexpr (sizeof(Tin) == 4) {
        f = __uint_as_float(w[k]);
      } else {                               // bf16: element 2i is the low half
        f = __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u)
                                    : (w[k >> 1] << 16));
      }
      v[k] = to_compute<Tc>(f);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// VEC float32 values rounded to Tc, stored as one 16-byte access (VEC > 1).
template <typename Tc, int VEC>
__device__ __forceinline__ void store_vec(Tc* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<Tc>(a[0]);
  } else if constexpr (sizeof(Tc) == 4) {
    static_assert(VEC == 4, "16-byte stores");
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    static_assert(VEC == 8, "16-byte stores");
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]),
                   pack_bf16x2(a[4], a[5]), pack_bf16x2(a[6], a[7]));
  }
}

constexpr int kS1Threads = 256;
constexpr int kS1Run = 64;                   // rows m per block

// c[b, th, m, z] = sum_{i,j in {0,1}} wx_i * wy_j * vox[b, x0+i, y0+j, z]
// Block = a run of kS1Run rows m of one (b, th); each thread owns VEC
// consecutive z of a row (VEC = 16 bytes of c, or 1 on the scalar path)
// and walks the run's rows in steps of kS1Threads * VEC / V.
template <typename Tin, typename Tc, int VEC>
__global__ void __launch_bounds__(kS1Threads)
stage1_kernel(const Tin* __restrict__ vox, Tc* __restrict__ c,
              const int* __restrict__ x_lo, const float2* __restrict__ x_w,
              const int* __restrict__ y_lo, const float2* __restrict__ y_w,
              int V, int Th, int M) {
  __shared__ int s_col[kS1Run];              // x0 * V + y0
  __shared__ float4 s_w[kS1Run];             // wx0, wx1, wy0, wy1
  const int runs = (M + kS1Run - 1) / kS1Run;
  const int64_t bt = blockIdx.x / runs;      // b * Th + th
  const int m0 = (int)(blockIdx.x % runs) * kS1Run;
  const int th = (int)(bt % Th);
  const int b = (int)(bt / Th);
  const int rows = min(kS1Run, M - m0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int t = th * M + m0 + r;
    const float2 wx = __ldg(x_w + t), wy = __ldg(y_w + t);
    s_col[r] = __ldg(x_lo + t) * V + __ldg(y_lo + t);
    s_w[r] = make_float4(wx.x, wx.y, wy.x, wy.y);
  }
  __syncthreads();
  const int nc = V / VEC;                    // chunks of a row
  const Tin* base = vox + (int64_t)b * V * V * V;
  Tc* dst = c + (bt * M + m0) * (int64_t)V;
#pragma unroll 2
  for (int item = threadIdx.x; item < rows * nc; item += kS1Threads) {
    const int r = item / nc;
    const int z = (item - r * nc) * VEC;
    const int col = s_col[r];
    const float4 w4 = s_w[r];
    const float wxs[2] = {w4.x, w4.y};
    const float wys[2] = {w4.z, w4.w};
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (wxs[a] == 0.f) continue;           // uniform across the row
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (wys[e] == 0.f) continue;
        float v[VEC];
        load_vec<Tin, Tc, VEC>(base + (int64_t)(col + a * V + e) * V + z, v);
        const float wgt = wxs[a] * wys[e];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
      }
    }
    store_vec<Tc, VEC>(dst + (int64_t)r * V + z, acc);
  }
}

template <typename Tin, typename Tc>
int launch_stage1(const void* vox, void* c, const int* x_lo,
                  const float2* x_w, const int* y_lo, const float2* y_w,
                  int B, int V, int Th, int M, cudaStream_t st) {
  constexpr int kVec = 16 / (int)sizeof(Tc);
  const int64_t grid = (int64_t)B * Th * ((M + kS1Run - 1) / kS1Run);
  if (grid <= 0 || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)vox % 16 == 0) && ((uintptr_t)c % 16 == 0);
  const Tin* in = static_cast<const Tin*>(vox);
  Tc* out = static_cast<Tc*>(c);
  if (aligned && V % kVec == 0)
    stage1_kernel<Tin, Tc, kVec><<<(unsigned)grid, kS1Threads, 0, st>>>(
        in, out, x_lo, x_w, y_lo, y_w, V, Th, M);
  else                                       // the scalar path
    stage1_kernel<Tin, Tc, 1><<<(unsigned)grid, kS1Threads, 0, st>>>(
        in, out, x_lo, x_w, y_lo, y_w, V, Th, M);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- stage 2
constexpr int kS2Threads = 512;              // 16 warps
constexpr int kS2Warps = kS2Threads / 32;
constexpr int kMaxGroup = 4;                 // slabs a group holds at most

// K2's and K5's shape and plan (ops/cuda/render_kernel.py::plan).
struct S2Shape {
  int B, Th, M, V, Ph, S;
  int s_pad;      // samples per ph row of the record table
  int pe;         // row stride of a staged slab, elements
  int group;      // G: slabs per group, 1 .. kMaxGroup
};

// Words of the tap record of one (ph, s), as ops/cuda/render_kernel.py::
// tap_records packs it.  float32 c: {z_lo, m_lo, z_w0, z_w1, m_w0, m_w1};
// bf16 c: {z_lo | m_lo << 16, z_w0 | z_w1 << 16, m_w0 | m_w1 << 16} with
// bf16 weights, which hold them exactly (they are rounded to the compute
// dtype).  The table is quad-major: the 4 * W words of the records of
// samples 4q .. 4q + 3 form W 16-byte chunks, and chunk c of quad q of
// row ph sits at ((ph * W + c) * s_pad / 4 + q) * 16 bytes, so that lanes
// reading consecutive quads read consecutive 16 bytes.
template <typename T> constexpr int kRecWords = sizeof(T) == 4 ? 6 : 3;

// A decoded record: `off` = (m_lo * pe + z_lo) * sizeof(T), the byte
// offset of the first tap in a staged slab; w_ij = m_w_i * z_w_j.
struct Tap {
  int off;
  float w00, w01, w10, w11;
};

template <typename T>
__device__ __forceinline__ Tap decode_tap(const uint32_t* w, int pe) {
  int z0, m0;
  float wz0, wz1, wr0, wr1;
  if constexpr (sizeof(T) == 4) {
    z0 = (int)w[0];
    m0 = (int)w[1];
    wz0 = __uint_as_float(w[2]);
    wz1 = __uint_as_float(w[3]);
    wr0 = __uint_as_float(w[4]);
    wr1 = __uint_as_float(w[5]);
  } else {
    z0 = (int)(w[0] & 0xffffu);
    m0 = (int)(w[0] >> 16);
    wz0 = __uint_as_float(w[1] << 16);
    wz1 = __uint_as_float(w[1] & 0xffff0000u);
    wr0 = __uint_as_float(w[2] << 16);
    wr1 = __uint_as_float(w[2] & 0xffff0000u);
  }
  Tap t{(m0 * pe + z0) * (int)sizeof(T), wr0 * wz0, wr0 * wz1, wr1 * wz0,
        wr1 * wz1};
  // opaque from here: kept in registers across the slabs of a group, not
  // decoded again for each
  asm volatile("" : "+r"(t.off), "+f"(t.w00), "+f"(t.w01), "+f"(t.w10),
               "+f"(t.w11));
  return t;
}

// The words of NQ consecutive quads from quad q0 of a ph row (`row`
// points at its chunk 0, `quads` = s_pad / 4): quad u's words at
// w[u * 4 * W ..].
template <typename T, int NQ>
__device__ __forceinline__ void load_quads(const uint32_t* __restrict__ row,
                                           int quads, int q0,
                                           uint32_t (&w)[NQ * 4 *
                                                         kRecWords<T>]) {
  constexpr int W = kRecWords<T>;
  const uint4* r = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < W; ++c)
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const uint4 v = __ldg(r + (int64_t)c * quads + q0 + u);
      uint32_t* d = w + u * 4 * W + 4 * c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
}

// One ray sample from a staged slab, the arithmetic of both epilogues:
// p = w00 r0[z0] + w01 r0[z0+1] + w10 r1[z0] + w11 r1[z0+1] in float32,
// r0, r1 the rows m0, m0 + 1 (`row_bytes` apart).
template <typename T>
__device__ __forceinline__ float gather_sample(const T* slab, int row_bytes,
                                               const Tap& t) {
  const char* r0 = reinterpret_cast<const char*>(slab) + t.off;
  const T* a = reinterpret_cast<const T*>(r0);
  const T* b = reinterpret_cast<const T*>(r0 + row_bytes);
  return fmaf(t.w11, to_f32(b[1]),
              fmaf(t.w10, to_f32(b[0]),
                   fmaf(t.w01, to_f32(a[1]), t.w00 * to_f32(a[0]))));
}

// Slab `src` of c (M rows of V elements) into shared `dst` at row stride
// pe.  Warp w copies rows w, w + kS2Warps, ...; its lanes take
// consecutive words: cp.async of 4 bytes (ASYNC: rows 4-byte aligned), or
// plain loads and stores of one element.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_slab(const T* __restrict__ src, T* dst,
                                           const S2Shape& a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (ASYNC) {
    const int words = a.V * (int)sizeof(T) / 4;
    const int stride = a.pe * (int)sizeof(T) / 4;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    const uint32_t d = smem_addr(dst);
    for (int r = warp; r < a.M; r += kS2Warps)
      for (int i = lane; i < words; i += 32)
        cp_async4(d + 4u * (uint32_t)(r * stride + i),
                  s + (int64_t)r * words + i);
  } else {
    for (int r = warp; r < a.M; r += kS2Warps)
      for (int i = lane; i < a.V; i += 32)
        dst[r * a.pe + i] = src[(int64_t)r * a.V + i];
  }
}

// Slabs first .. first + n - 1 into the buffer at `buf`, one group of
// copies.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_group(const T* __restrict__ c, T* buf,
                                            int64_t first, int n,
                                            const S2Shape& a) {
  for (int g = 0; g < n; ++g)
    stage_slab<T, ASYNC>(c + (first + g) * a.M * a.V, buf + g * a.M * a.pe,
                         a);
  if constexpr (ASYNC) cp_async_commit();
}

// The persistent walk of K2 and K5: block i takes groups i, i + gridDim.x,
// ...; group q is slabs q * G .. q * G + G - 1 of the B * Th flat slabs
// (the last one ragged).  Calls body(slabs, bt, n) with the group's n
// slabs staged (slab g at slabs + g * M * pe) and their (b, th) in bt[g];
// the next group's copies start when every warp is done with this one.
template <typename T, bool ASYNC, typename Body>
__device__ __forceinline__ void walk_groups(const T* __restrict__ c,
                                            const S2Shape& a, T* smem,
                                            int2* bt, Body&& body) {
  const int64_t n_slabs = (int64_t)a.B * a.Th;
  const int64_t groups = (n_slabs + a.group - 1) / a.group;
  auto count = [&](int64_t q) {
    const int64_t left = n_slabs - q * a.group;
    return (int)(left < a.group ? left : a.group);
  };
  if (blockIdx.x < groups)
    stage_group<T, ASYNC>(c, smem, (int64_t)blockIdx.x * a.group,
                          count(blockIdx.x), a);
  for (int64_t q = blockIdx.x; q < groups; q += gridDim.x) {
    const int n = count(q);
    if constexpr (ASYNC) cp_async_wait<0>();
    if ((int)threadIdx.x < n) {
      const int64_t s = q * a.group + threadIdx.x;
      bt[threadIdx.x] = make_int2((int)(s / a.Th), (int)(s % a.Th));
    }
    __syncthreads();
    body(static_cast<const T*>(smem), static_cast<const int2*>(bt), n);
    __syncthreads();                         // the buffer is refilled next
    const int64_t next = q + gridDim.x;
    if (next < groups)
      stage_group<T, ASYNC>(c, smem, next * a.group, count(next), a);
  }
}

// K2: out[b, ph, th] = sum_s stop_s * s / (S - 1) + T_S with stop_s =
// p_s * T_s, T_s = prod_{i<s} (1 - p_i), p clipped to [1e-5, 1 - 1e-5];
// summed by parts, the same is sum_{s=1}^{S-1} T_s / (S - 1), so one pass
// keeps each lane's running product and the sum of its T_s.  Lane l owns
// samples l * SPL .. l * SPL + SPL - 1 of a row (32 * SPL = s_pad;
// samples from S on have p = 0 and count in no sum).  The warp's
// exclusive product scan of the lane products gives each lane the T
// before its first sample.  A warp reads the next ph row's records
// during this row's work.
template <typename T, bool ASYNC, int SPL>
__global__ void __launch_bounds__(kS2Threads, 1)
slab_scan_kernel(const T* __restrict__ c, float* __restrict__ out,
                 const uint32_t* __restrict__ rec, S2Shape a) {
  extern __shared__ __align__(16) unsigned char s2_smem[];
  __shared__ int2 s2_bt[kMaxGroup];
  constexpr int W = kRecWords<T>, NQ = SPL / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quads = a.s_pad / 4;
  const int64_t row_words = (int64_t)a.s_pad * W;
  const int row_bytes = a.pe * (int)sizeof(T);
  const int slab_elems = a.M * a.pe;
  const int left = a.S - lane * SPL;         // this lane's samples below S
  const float inv = 1.0f / (float)(a.S - 1);
  walk_groups<T, ASYNC>(
      c, a, reinterpret_cast<T*>(s2_smem), s2_bt,
      [&](const T* slabs, const int2* bt, int n) {
        uint32_t w[NQ * 4 * W];
        if (warp < a.Ph)
          load_quads<T, NQ>(rec + warp * row_words, quads, lane * NQ, w);
        for (int ph = warp; ph < a.Ph; ph += kS2Warps) {
          Tap t[SPL];
#pragma unroll
          for (int k = 0; k < SPL; ++k)
            t[k] = decode_tap<T>(w + k * W, a.pe);
          if (ph + kS2Warps < a.Ph)
            load_quads<T, NQ>(rec + (ph + kS2Warps) * row_words, quads,
                              lane * NQ, w);
          // the slabs' chains are independent: up to 4 in flight
#pragma unroll 4
          for (int g = 0; g < n; ++g) {
            const T* slab = slabs + g * slab_elems;
            float run = 1.f, sum = 0.f;      // local T, sum of T_s
#pragma unroll
            for (int k = 0; k < SPL; ++k) {
              const float p = fminf(
                  fmaxf(gather_sample(slab, row_bytes, t[k]), 1e-5f),
                  1.0f - 1e-5f);
              if (k < left && (lane | k) != 0) sum += run;
              if (k < left) run *= 1.f - p;
            }
            // inclusive product scan across the warp; shifted by one
            // lane, the T before this lane's first sample
            float incl = run;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const float up = __shfl_up_sync(0xffffffffu, incl, off);
              if (lane >= off) incl *= up;
            }
            float before = __shfl_up_sync(0xffffffffu, incl, 1);
            if (lane == 0) before = 1.f;
            float acc = before * sum;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc += __shfl_down_sync(0xffffffffu, acc, off);
            if (lane == 0) {
              const int2 q = bt[g];
              out[((int64_t)q.x * a.Ph + ph) * a.Th + q.y] = acc * inv;
            }
          }
        }
      });
}

// K5: out[b, ph, th, s] for every sample, unclipped.  Lane l owns the
// samples of quad 32 j + l in round j (s = 128 j + 4 l .. + 3) and stores
// them as one float4 (S a multiple of 4), else one by one up to S.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(kS2Threads, 1)
slab_samples_kernel(const T* __restrict__ c, float* __restrict__ out,
                    const uint32_t* __restrict__ rec, S2Shape a) {
  extern __shared__ __align__(16) unsigned char s2_smem[];
  __shared__ int2 s2_bt[kMaxGroup];
  constexpr int W = kRecWords<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quads = a.s_pad / 4;
  const int64_t row_words = (int64_t)a.s_pad * W;
  const int row_bytes = a.pe * (int)sizeof(T);
  const bool vec4 = a.S % 4 == 0;
  const int slab_elems = a.M * a.pe;
  walk_groups<T, ASYNC>(
      c, a, reinterpret_cast<T*>(s2_smem), s2_bt,
      [&](const T* slabs, const int2* bt, int n) {
        for (int ph = warp; ph < a.Ph; ph += kS2Warps) {
          for (int q = lane; 4 * q < a.S; q += 32) {
            uint32_t w[4 * W];
            load_quads<T, 1>(rec + ph * row_words, quads, q, w);
            Tap t[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) t[i] = decode_tap<T>(w + i * W, a.pe);
            for (int g = 0; g < n; ++g) {
              const T* slab = slabs + g * slab_elems;
              float v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = gather_sample(slab, row_bytes, t[i]);
              const int2 bq = bt[g];
              float* dst = out +
                           (((int64_t)bq.x * a.Ph + ph) * a.Th + bq.y) * a.S +
                           4 * q;
              if (vec4) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(v[0], v[1], v[2], v[3]);
              } else {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  if (4 * q + i < a.S) dst[i] = v[i];
              }
            }
          }
        }
      });
}

// Shared memory of a launch: G staged slabs.
template <typename T>
size_t s2_smem_bytes(const S2Shape& a) {
  return (size_t)a.group * a.M * a.pe * sizeof(T);
}

// Rejects what the kernels do not take; the plan (ops/cuda/
// render_kernel.py::plan) never asks for it.
template <typename T>
bool s2_valid(const S2Shape& a, const void* rec) {
  const int elt = (int)sizeof(T);
  return a.B >= 1 && a.Th >= 1 && a.M >= 2 && a.V >= 2 && a.Ph >= 1 &&
         a.S >= 2 && a.group >= 1 && a.group <= kMaxGroup && a.pe >= a.V &&
         (a.pe * elt) % 4 == 0 && a.s_pad % 128 == 0 && a.s_pad >= a.S &&
         (int64_t)a.group * a.M * a.pe < (1 << 30) &&
         (int64_t)a.B * a.Th < (1LL << 31) &&
         s2_smem_bytes<T>(a) + sizeof(int2) * kMaxGroup <= 227 * 1024 &&
         (uintptr_t)rec % 16 == 0;
}

// Rows of c can be copied as 4-byte words.
template <typename T>
bool rows_aligned4(const void* c, int V) {
  return (V * (int)sizeof(T)) % 4 == 0 && (uintptr_t)c % 4 == 0;
}

// One block per SM, or as many as fit, and no more than there are groups.
template <typename Kernel, typename T>
int launch_slabs(Kernel kernel, const T* c, float* out, const uint32_t* rec,
                 const S2Shape& a, cudaStream_t st) {
  const size_t smem = s2_smem_bytes<T>(a);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kS2Threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t groups = ((int64_t)a.B * a.Th + a.group - 1) / a.group;
  const int64_t fit = (int64_t)sms * per_sm;
  const int64_t grid = groups < fit ? groups : fit;
  kernel<<<(unsigned)grid, kS2Threads, smem, st>>>(c, out, rec, a);
  return (int)cudaGetLastError();
}

template <typename T, bool ASYNC>
int scan_spl(const T* c, float* out, const uint32_t* rec, const S2Shape& a,
             cudaStream_t st) {
  switch (a.s_pad / 32) {                    // samples per lane
    case 4:
      return launch_slabs(slab_scan_kernel<T, ASYNC, 4>, c, out, rec, a, st);
    case 8:
      return launch_slabs(slab_scan_kernel<T, ASYNC, 8>, c, out, rec, a, st);
    case 16:
      return launch_slabs(slab_scan_kernel<T, ASYNC, 16>, c, out, rec, a, st);
    default:
      return (int)cudaErrorInvalidValue;     // S > 512
  }
}

template <typename T>
int scan(const void* c, float* out, const uint32_t* rec, const S2Shape& a,
         cudaStream_t st) {
  if (!s2_valid<T>(a, rec)) return (int)cudaErrorInvalidValue;
  const T* ct = static_cast<const T*>(c);
  return rows_aligned4<T>(c, a.V) ? scan_spl<T, true>(ct, out, rec, a, st)
                                  : scan_spl<T, false>(ct, out, rec, a, st);
}

template <typename T>
int samples(const void* c, float* out, const uint32_t* rec, const S2Shape& a,
            cudaStream_t st) {
  if (!s2_valid<T>(a, rec) || (a.S % 4 == 0 && (uintptr_t)out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const T* ct = static_cast<const T*>(c);
  return rows_aligned4<T>(c, a.V)
             ? launch_slabs(slab_samples_kernel<T, true>, ct, out, rec, a, st)
             : launch_slabs(slab_samples_kernel<T, false>, ct, out, rec, a,
                            st);
}

}  // namespace

extern "C" {

// vox (B, V, V, V) in `in_dtype` -> c (B, Th, M, V) in `dtype`; tap
// tables x_lo/y_lo (Th, M) int32, x_w/y_w (Th, M, 2) float32.
int render_stage1(const void* vox, void* c, int in_dtype, int dtype,
                  const int* x_lo, const float* x_w, const int* y_lo,
                  const float* y_w, int B, int V, int Th, int M,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 2 || M < 1) return (int)cudaErrorInvalidValue;
  const float2* xw = reinterpret_cast<const float2*>(x_w);
  const float2* yw = reinterpret_cast<const float2*>(y_w);
  using bf16 = __nv_bfloat16;
  if (in_dtype == 0 && dtype == 0)
    return launch_stage1<float, float>(vox, c, x_lo, xw, y_lo, yw, B, V, Th, M, st);
  if (in_dtype == 0 && dtype == 1)
    return launch_stage1<float, bf16>(vox, c, x_lo, xw, y_lo, yw, B, V, Th, M, st);
  if (in_dtype == 1 && dtype == 0)
    return launch_stage1<bf16, float>(vox, c, x_lo, xw, y_lo, yw, B, V, Th, M, st);
  if (in_dtype == 1 && dtype == 1)
    return launch_stage1<bf16, bf16>(vox, c, x_lo, xw, y_lo, yw, B, V, Th, M, st);
  return (int)cudaErrorInvalidValue;
}

// c (B, Th, M, V) -> out (B, Ph, Th) float32.  `rec`: the tap records
// of ops/cuda/render_kernel.py::tap_records (s_pad samples a ph row),
// 16-byte aligned; pe, group: the plan of ops/cuda/render_kernel.py::plan.
int render_stage2_scan(const void* c, float* out, int dtype, const int* rec,
                       int B, int Th, int M, int V, int Ph, int S,
                       int s_pad, int pe, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S2Shape a{B, Th, M, V, Ph, S, s_pad, pe, group};
  const uint32_t* r = reinterpret_cast<const uint32_t*>(rec);
  if (dtype == 0) return scan<float>(c, out, r, a, st);
  if (dtype == 1) return scan<__nv_bfloat16>(c, out, r, a, st);
  return (int)cudaErrorInvalidValue;
}

// c (B, Th, M, V) -> out (B, Ph, Th, S) float32 ray samples; the records
// and the plan as for render_stage2_scan.
int render_stage2_samples(const void* c, float* out, int dtype,
                          const int* rec, int B, int Th, int M, int V,
                          int Ph, int S, int s_pad, int pe, int group,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S2Shape a{B, Th, M, V, Ph, S, s_pad, pe, group};
  const uint32_t* r = reinterpret_cast<const uint32_t*>(rec);
  if (dtype == 0) return samples<float>(c, out, r, a, st);
  if (dtype == 1) return samples<__nv_bfloat16>(c, out, r, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
