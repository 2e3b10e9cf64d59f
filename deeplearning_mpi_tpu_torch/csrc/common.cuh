// Shared helpers for the hand-written kernels: dtype codes, conversions,
// vector loads, warp reductions, and the flash-attention kernels' masks and
// tile ranges.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element-type codes, as the Python wrappers pass them.
enum DType : int32_t { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

// Finite mask value, as in ops/attention.py: a fully masked tile gives
// exp(s - m) = 1, so every kernel re-zeroes masked probabilities itself.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Eight consecutive elements of T, loaded with one or two vector loads
// (the caller guarantees alignment: every head dim is a multiple of 8).
template <class T> struct Vec8;
template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void to_f32(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};
template <> struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_f32(float* out) const {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
};
template <> struct Vec8<int8_t> {
  uint2 u;
  __device__ __forceinline__ void load(const int8_t* p) { u = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint2(0, 0); }
  __device__ __forceinline__ void to_f32(float* out) const {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  }
};

// Tensor-core helpers: C[16x8] += A[16x16] * B[16x8], bf16 in, f32 accumulate
// (mma.sync m16n8k16, FlashAttention-2 fragment layout).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Calls f(std::integral_constant<int, D>) for the compiled head dims (every
// multiple of 8 up to 128); returns false for any other.
#include <type_traits>
template <class F>
inline bool dispatch_head_dim(int d, F&& f) {
  switch (d) {
#define HEAD_DIM_CASE(N) \
  case N:                \
    f(std::integral_constant<int, N>{}); \
    return true;
    HEAD_DIM_CASE(8) HEAD_DIM_CASE(16) HEAD_DIM_CASE(24) HEAD_DIM_CASE(32)
    HEAD_DIM_CASE(40) HEAD_DIM_CASE(48) HEAD_DIM_CASE(56) HEAD_DIM_CASE(64)
    HEAD_DIM_CASE(72) HEAD_DIM_CASE(80) HEAD_DIM_CASE(88) HEAD_DIM_CASE(96)
    HEAD_DIM_CASE(104) HEAD_DIM_CASE(112) HEAD_DIM_CASE(120) HEAD_DIM_CASE(128)
#undef HEAD_DIM_CASE
    default:
      return false;
  }
}

// ---- flash-attention masks and tile ranges ------------------------------------
// For the forward's and backward's parameter structs (fields S, causal,
// window, shift): q row i sits at position i + shift; window 0 = none.

// Whether the query at position qpos sees the key at kpos.
template <class P>
__device__ __forceinline__ bool pair_valid(const P& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) {
    ok = ok && qpos >= kpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
  }
  return ok;
}

// Whether q row q sees key k.
template <class P>
__device__ __forceinline__ bool pair_ok(const P& p, int q, int k) {
  return q < p.S && pair_valid(p, q + p.shift, k);
}

// Pairs of q rows [qa, qb] and keys [ka, kb]: 0 none valid, 1 some masked
// (diagonal, window edge, ragged edge), 2 all valid (no per-score test).
template <class P>
__device__ __forceinline__ int tile_kind(const P& p, int qa, int qb, int ka, int kb) {
  if (qa >= p.S || ka >= p.S) return 0;
  if (p.causal) {
    if (qb + p.shift < ka) return 0;
    if (p.window > 0 && qa + p.shift - kb >= p.window) return 0;
  }
  bool all = qb < p.S && kb < p.S;
  if (p.causal)
    all = all && qa + p.shift >= kb && (p.window == 0 || qb + p.shift - ka < p.window);
  return all ? 2 : 1;
}

struct TileRange {
  int lo, hi;
};

// The T-row kv tiles [lo, hi) that can meet some row of the R q rows at q_lo.
template <int R, int T, class P>
__device__ __forceinline__ TileRange kv_tiles(const P& p, int q_lo) {
  const int q_hi = min(q_lo + R - 1, p.S - 1);
  int kv_hi = p.S;
  if (p.causal) kv_hi = min(p.S, q_hi + p.shift + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q_lo + p.shift - p.window + 1);
  const int lo = kv_lo / T;
  return {lo, kv_hi > kv_lo ? (kv_hi + T - 1) / T : lo};
}
