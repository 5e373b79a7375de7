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
// M=192, S=256, bf16) K1 reads the 33.6 MB volume and writes the 50.3 MB
// cylindrical intermediate c; K2 reads c and writes 0.5 MB.  The
// arithmetic (~0.25 G multiply-adds plus one log1p and one exp per
// sample) is far below the float32 peak.  The design follows:
//   K1: one thread per output element, threads along z, which is the
//       contiguous axis of both the volume (B,X,Y,Z) and c (B,Th,M,Z), so
//       every load and store is coalesced; the taps are uniform across a
//       row, so the branch that skips zero-weight taps never diverges.
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
// Accumulation is float32.  `dtype` 0 = float32 volume/c, 1 = bfloat16.
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

// c[b, th, m, z] = sum_{i,j in {0,1}} wx_i * wy_j * vox[b, x0+i, y0+j, z]
// One block per output row (b, th, m); its threads walk z.
template <typename T>
__global__ void stage1_kernel(const T* __restrict__ vox, T* __restrict__ c,
                              const int* __restrict__ x_lo,
                              const float2* __restrict__ x_w,
                              const int* __restrict__ y_lo,
                              const float2* __restrict__ y_w, int B, int V,
                              int Th, int M) {
  const int64_t row = blockIdx.x;            // (b * Th + th) * M + m
  const int tm = (int)(row % ((int64_t)Th * M));
  const int b = (int)(row / ((int64_t)Th * M));
  const int x0 = __ldg(x_lo + tm), y0 = __ldg(y_lo + tm);
  const float2 wx = __ldg(x_w + tm), wy = __ldg(y_w + tm);
  const float wxs[2] = {wx.x, wx.y};
  const float wys[2] = {wy.x, wy.y};
  const T* base = vox + (int64_t)b * V * V * V;
  T* dst = c + row * V;
  for (int z = threadIdx.x; z < V; z += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (wxs[a] == 0.f) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (wys[e] == 0.f) continue;
        const float v =
            to_f32(base[((int64_t)(x0 + a) * V + (y0 + e)) * V + z]);
        acc = fmaf(wxs[a] * wys[e], v, acc);
      }
    }
    dst[z] = from_f32<T>(acc);
  }
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

// vox (B, V, V, V) -> c (B, Th, M, V); tap tables x_lo/y_lo (Th, M) int32,
// x_w/y_w (Th, M, 2) float32.
int render_stage1(const void* vox, void* c, int dtype, const int* x_lo,
                  const float* x_w, const int* y_lo, const float* y_w, int B,
                  int V, int Th, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int block = 128;
  const int64_t rows = (int64_t)B * Th * M;
  if (rows <= 0 || rows > 0x7fffffff || V < 2) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)rows;
  const float2* xw = reinterpret_cast<const float2*>(x_w);
  const float2* yw = reinterpret_cast<const float2*>(y_w);
  if (dtype == 0) {
    stage1_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(vox), static_cast<float*>(c), x_lo, xw,
        y_lo, yw, B, V, Th, M);
  } else if (dtype == 1) {
    stage1_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(vox),
        static_cast<__nv_bfloat16*>(c), x_lo, xw, y_lo, yw, B, V, Th, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
