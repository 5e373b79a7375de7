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
// What bounds them: device-memory bytes.  At batch 8 (V=128, R=128,
// M=192, S=256, bf16 c) K1 reads the 67.1 MB float32 volume (in its own
// dtype: no cast kernel runs before it) and writes the 50.3 MB cylindrical
// intermediate c, 35.2 us at 3.35 TB/s; K2 reads c and writes 0.5 MB.
// The arithmetic (~0.25 G multiply-adds plus one log1p and one exp per
// sample) is far below the float32 peak.  The design follows:
//   K1: a streaming gather.  A block owns a run of 64 rows m of one
//       (b, th): consecutive m walk one ray of the (x, y) plane, so
//       neighbouring rows gather the same volume columns, from L1.  The
//       block loads the run's tap tables once, coalesced, into shared
//       memory.  Each thread moves 16 bytes of c per access (8 bf16 or 4
//       float32 along z, the contiguous axis of the volume (B,X,Y,Z) and
//       of c (B,Th,M,Z)), reads the volume in its own dtype (float32 or
//       bf16) with 16-byte loads and rounds each element to the compute
//       dtype in registers, the value a cast followed by a load gives.
//       At V=128 a row is 16 threads, a 256-thread block covers 16 rows
//       a step and 4 steps a run: 3,072 blocks, about 3 waves over the
//       132 SMs.  The taps are uniform across a row, so the branch that
//       skips zero-weight taps never diverges within it.  Where V is not
//       a multiple of the vector width, or a pointer is not 16-byte
//       aligned, the same kernel runs with one element per access.
//   K2: one warp per ray (b, ph, th); each lane owns S/32 consecutive
//       samples and keeps them in registers.  The 4 gathers per sample
//       hit the (b, th) slab of c, 192x128 elements; the warps of a block
//       share (b, th) and differ in ph, so the slab is reused from L1/L2.
//       The (B, R, R, S) ray samples never reach device memory, which is
//       what the Pallas fusion was for.
//   K5: K2's gather without the scan.  Its output, the (B, R, R, S)
//       float32 samples, is the bulk of its bytes (67 MB against 25 MB
//       of c at batch 4), so one warp per ray with the lanes striding
//       over s: the tap-table loads and the float32 stores of a warp are
//       128 contiguous bytes each.  Rays are ordered as in K2, so the
//       warps of a block share the c[b, th] slab.
// Later work: stage the c[b, th] slab in shared memory, or fuse K1 into
// K2 per (b, th).
//
// Accumulation is float32.  `dtype` 0 = float32 c, 1 = bfloat16 c; K1's
// `in_dtype` codes the volume's dtype the same way.
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One warp per ray (b, ph, th): samples -> clip -> stop probability ->
// expected depth + all-miss term.  SPL = samples per lane (S <= 32*SPL).
template <typename T, int SPL>
__global__ void stage2_scan_kernel(const T* __restrict__ c,
                                   float* __restrict__ out,
                                   const int* __restrict__ z_lo,
                                   const float2* __restrict__ z_w,
                                   const int* __restrict__ m_lo,
                                   const float2* __restrict__ m_w, int B,
                                   int Th, int M, int V, int Ph, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_rays = (int64_t)B * Th * Ph;
  if (ray >= n_rays) return;                 // whole warp exits together
  // ray = (b * Th + th) * Ph + ph: neighbouring warps share the c slab
  const int ph = (int)(ray % Ph);
  const int64_t bt = ray / Ph;
  const int th = (int)(bt % Th);
  const int b = (int)(bt / Th);
  const T* slab = c + bt * M * V;

  float p[SPL], lg[SPL];
  float local = 0.f;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int s = lane * SPL + k;
    float pk = 0.f;
    if (s < S) {
      const int t = ph * S + s;
      const int z0 = __ldg(z_lo + t), m0 = __ldg(m_lo + t);
      const float2 wz = __ldg(z_w + t), wr = __ldg(m_w + t);
      const T* r0 = slab + (int64_t)m0 * V + z0;
      const T* r1 = r0 + V;
      const float t0 = wz.x * to_f32(r0[0]) + wz.y * to_f32(r0[1]);
      const float t1 = wz.x * to_f32(r1[0]) + wz.y * to_f32(r1[1]);
      pk = fminf(fmaxf(wr.x * t0 + wr.y * t1, 1e-5f), 1.0f - 1e-5f);
      lg[k] = log1pf(-pk);
    } else {
      lg[k] = 0.f;                           // padding samples: p = 0
    }
    p[k] = pk;
    local += lg[k];
  }
  // exclusive scan of the lane sums across the warp
  float incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  float cum = incl - local;
  const float inv = 1.0f / (float)(S - 1);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int s = lane * SPL + k;
    acc += p[k] * expf(cum) * ((float)s * inv);
    cum += lg[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[((int64_t)b * Ph + ph) * Th + th] = acc + expf(total);
}

// One warp per ray (b, ph, th): out[b, ph, th, s] for every sample s,
// unclipped.  Lane l computes s = l, l + 32, ...
template <typename T>
__global__ void stage2_samples_kernel(const T* __restrict__ c,
                                      float* __restrict__ out,
                                      const int* __restrict__ z_lo,
                                      const float2* __restrict__ z_w,
                                      const int* __restrict__ m_lo,
                                      const float2* __restrict__ m_w, int B,
                                      int Th, int M, int V, int Ph, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_rays = (int64_t)B * Th * Ph;
  if (ray >= n_rays) return;                 // whole warp exits together
  // ray = (b * Th + th) * Ph + ph: neighbouring warps share the c slab
  const int ph = (int)(ray % Ph);
  const int64_t bt = ray / Ph;
  const int th = (int)(bt % Th);
  const int b = (int)(bt / Th);
  const T* slab = c + bt * M * V;
  float* dst = out + (((int64_t)b * Ph + ph) * Th + th) * S;
  for (int s = lane; s < S; s += 32) {
    const int t = ph * S + s;
    const int z0 = __ldg(z_lo + t), m0 = __ldg(m_lo + t);
    const float2 wz = __ldg(z_w + t), wr = __ldg(m_w + t);
    const T* r0 = slab + (int64_t)m0 * V + z0;
    const T* r1 = r0 + V;
    const float t0 = wz.x * to_f32(r0[0]) + wz.y * to_f32(r0[1]);
    const float t1 = wz.x * to_f32(r1[0]) + wz.y * to_f32(r1[1]);
    dst[s] = wr.x * t0 + wr.y * t1;
  }
}

template <typename T, int SPL>
void launch_stage2(const void* c, float* out, const int* z_lo,
                   const float2* z_w, const int* m_lo, const float2* m_w,
                   int B, int Th, int M, int V, int Ph, int S,
                   cudaStream_t stream) {
  const int block = 256;                     // 8 rays per block
  const int64_t threads = (int64_t)B * Th * Ph * 32;
  const int64_t grid = (threads + block - 1) / block;
  stage2_scan_kernel<T, SPL><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(c), out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph,
      S);
}

template <typename T>
int dispatch_stage2(const void* c, float* out, const int* z_lo,
                    const float2* z_w, const int* m_lo, const float2* m_w,
                    int B, int Th, int M, int V, int Ph, int S,
                    cudaStream_t st) {
  const int spl = (S + 31) / 32;
  if (spl <= 1) launch_stage2<T, 1>(c, out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph, S, st);
  else if (spl <= 2) launch_stage2<T, 2>(c, out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph, S, st);
  else if (spl <= 4) launch_stage2<T, 4>(c, out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph, S, st);
  else if (spl <= 8) launch_stage2<T, 8>(c, out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph, S, st);
  else if (spl <= 16) launch_stage2<T, 16>(c, out, z_lo, z_w, m_lo, m_w, B, Th, M, V, Ph, S, st);
  else return (int)cudaErrorInvalidValue;    // S > 512
  return (int)cudaGetLastError();
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

// c (B, Th, M, V) -> out (B, Ph, Th) float32; tap tables z_lo/m_lo
// (Ph, S) int32, z_w/m_w (Ph, S, 2) float32.
int render_stage2_scan(const void* c, float* out, int dtype, const int* z_lo,
                       const float* z_w, const int* m_lo, const float* m_w,
                       int B, int Th, int M, int V, int Ph, int S,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* zw = reinterpret_cast<const float2*>(z_w);
  const float2* mw = reinterpret_cast<const float2*>(m_w);
  if (S < 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_stage2<float>(c, out, z_lo, zw, m_lo, mw, B, Th, M, V,
                                  Ph, S, st);
  if (dtype == 1)
    return dispatch_stage2<__nv_bfloat16>(c, out, z_lo, zw, m_lo, mw, B, Th,
                                          M, V, Ph, S, st);
  return (int)cudaErrorInvalidValue;
}

// c (B, Th, M, V) -> out (B, Ph, Th, S) float32 ray samples; the tap
// tables as for render_stage2_scan.
int render_stage2_samples(const void* c, float* out, int dtype,
                          const int* z_lo, const float* z_w, const int* m_lo,
                          const float* m_w, int B, int Th, int M, int V,
                          int Ph, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* zw = reinterpret_cast<const float2*>(z_w);
  const float2* mw = reinterpret_cast<const float2*>(m_w);
  const int block = 256;                     // 8 rays per block
  const int64_t threads = (int64_t)B * Th * Ph * 32;
  const int64_t grid = (threads + block - 1) / block;
  if (S < 1 || V < 2 || M < 2 || grid <= 0 || grid > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    stage2_samples_kernel<float><<<(unsigned)grid, block, 0, st>>>(
        static_cast<const float*>(c), out, z_lo, zw, m_lo, mw, B, Th, M, V,
        Ph, S);
  } else if (dtype == 1) {
    stage2_samples_kernel<__nv_bfloat16><<<(unsigned)grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(c), out, z_lo, zw, m_lo, mw, B,
        Th, M, V, Ph, S);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
