// Hopper (sm_90a) building blocks for the warp-specialized kernels: shared-
// memory addresses, mbarriers, cp.async with zero-fill, the async-proxy
// fence, named barriers, and bf16 wgmma (m64nNk16, f32 accumulation) with
// operands described by 128-byte-swizzled shared-memory descriptors, and
// the tile loads and products that the flash-attention kernels build on them.
//
// Tile layout used with these helpers: a tile of R rows by 64 bf16 columns is
// R rows of 128 bytes, 1024-byte aligned, and 16-byte chunk c of row r sits
// at chunk c ^ (r & 7) of that row (the 128-byte swizzle, Swizzle<3,4,3>).
// Wider rows are split into 64-column panels of the same form.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled panel.
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- cp.async ---------------------------------------------------------------
// 16 bytes from global to shared; zeros where !valid (src is not read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// Arrive on the mbarrier once every cp.async this thread issued so far has
// landed (the barrier's expected count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders generic-proxy shared-memory writes (cp.async included) seen by this
// thread before its later async-proxy accesses (wgmma reads through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (the
// reduction dim contiguous): lbo unused, sbo = 1024 bytes between 8-row
// groups. MN-major operands (the M/N dim contiguous): lbo = bytes between
// 64-element panels of M/N, sbo = 1024 bytes between 8-row groups of K.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma issue / wait points.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32(i) WG_R8(i), WG_R8(i + 8), WG_R8(i + 16), WG_R8(i + 24)

#define WG_W8(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), \
                 "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define WG_W32(i) WG_W8(i), WG_W8(i + 8), WG_W8(i + 16), WG_W8(i + 24)
#define WG_SS_N64                                                                       \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "   \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

// d[64 x 64] = A[64 x 16] . B[16 x 64] (kAcc false) or d += A . B (kAcc
// true); A and B from shared memory, both K-major. Without kAcc d is only
// written, so its earlier values are not kept alive.
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (kAcc) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n" WG_SS_N64
                 : WG_R32(0)
                 : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n" WG_SS_N64
                 : WG_W32(0)
                 : "l"(a), "l"(b), "r"(0));
  }
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_R32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_R32(0), WG_R32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_SS_N64
#undef WG_W32
#undef WG_W8
#undef WG_R32
#undef WG_R8

// ---- tiles and products ------------------------------------------------------
// Copy rows [r0, r0 + R) of a bf16 [S, D] slab (row stride rs) into swizzled
// panels at dst (panel_stride bytes apart), zeros past S and past D; this
// thread takes chunks lane, lane + n, ...
template <int R, int P>
__device__ __forceinline__ void load_rows(uint32_t dst, uint32_t panel_stride,
                                          const __nv_bfloat16* src, int64_t rs, int r0, int S,
                                          int D, int lane, int n) {
#pragma unroll 4
  for (int c = lane; c < R * 8 * P; c += n) {
    const int row = c / (8 * P), ch = c % (8 * P);
    const bool ok = r0 + row < S && ch * 8 < D;
    cp_async16(dst + (ch >> 3) * panel_stride + swizzle128(row, ch & 7),
               ok ? src + (int64_t)(r0 + row) * rs + ch * 8 : src, ok);
  }
}

// The four A fragments (k = 16 columns each) of a 64 x 64 accumulator,
// rounded to bf16: an accumulator's layout is the register A layout.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc[64 x DP] += A (four k16 fragments) . B, B a [64][DP] tile in panels
// tile_panel bytes apart, read MN-major (its rows are the reduction dim).
template <int DP>
__device__ __forceinline__ void product_rs(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                           uint32_t tile, uint32_t tile_panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = wgmma_desc(tile + kk * 2048, tile_panel, 1024);
    if constexpr (DP == 64) wgmma_rs_n64(acc, a[kk], b);
    else wgmma_rs_n128(acc, a[kk], b);
  }
}

// s[64 x 64] = X[64 x DP] . T^T, X 64 rows of panels x_panel bytes apart,
// T a [64][DP] tile of panels t_panel bytes apart, both K-major.
template <int DP>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t x, uint32_t x_panel,
                                           uint32_t t, uint32_t t_panel) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t a = wgmma_desc(x + (kk >> 2) * x_panel + off, 16, 1024);
    const uint64_t b = wgmma_desc(t + (kk >> 2) * t_panel + off, 16, 1024);
    if (kk == 0) wgmma_ss_n64<false>(s, a, b);
    else wgmma_ss_n64<true>(s, a, b);
  }
}
