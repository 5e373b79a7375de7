// Asynchronous-copy helpers for Hopper (sm_90a), one copy for the port's
// kernels: shared-memory addresses, mbarriers and TMA tensor copies (K3,
// deconv_final_kernel.cu; K7, critic_conv_kernel.cu), and the 4-byte
// cp.async copies that stage the renderer's slabs (K2, K5,
// render_kernel.cu).  The renderer stages its slabs at a padded row
// stride, which a TMA copy of a contiguous slab cannot write, so it takes
// smem_addr and the cp.async half only.
#pragma once

#include <cuda.h>
#include <stdint.h>

// The shared-memory address of a generic pointer into shared memory.
static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
static __device__ __forceinline__ void mbar_init(uint32_t bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA).
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on `bar` and expects `bytes` of copies to complete on it.
static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Arrives on `bar` (one of its expected arrivals).
static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of `bar` with parity `parity` has completed.
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// ------------------------------------------------------------------- TMA
// One box of the 2-D tensor map `map` at coordinates (c0, c1), innermost
// first, into shared memory at `dst`; completes on mbarrier `bar`.
static __device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(bar)
      : "memory");
}

// One box of the 5-D tensor map `map` at coordinates (c0 .. c4), innermost
// first, into shared memory at `dst`; completes on mbarrier `bar`.
static __device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1, int c2,
                                                   int c3, int c4,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// -------------------------------------------------------------- cp.async
// 4 bytes from global `src` (4-byte aligned) to shared `dst`, without
// passing through registers.  Completion: cp_async_commit() closes the
// thread's group of copies, cp_async_wait<N>() waits until at most N of
// its groups are still in flight.
static __device__ __forceinline__ void cp_async4(uint32_t dst,
                                                 const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
