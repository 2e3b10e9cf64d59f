// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces deeplearning_mpi_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _fwd_pallas). Online-softmax attention with float32
// (acc, m, l), scale D**-0.5; causal or full; a sliding window; a static
// q-position shift (the ring schedule's); an optional per-row logsumexp;
// zero output rows where l == 0.
//
// What bounds it on an H100: at prefill and training shapes attention is
// operation-bound (4*S*S*D/2 flops per causal head against 8*S*D bytes of
// q/k/v/o; at S=2048, D=64 that is ~500 flops per byte, above the card's
// ~300 bf16 / ~20 f32 flops-per-byte balance points).
//
// Design. One thread block per (q tile of 64 rows, head, batch); the TPU
// kernel's sequential kv grid axis becomes a loop inside the block whose
// bounds are computed up front — causal: stop at the tile's last row plus
// shift; window: start at the tile holding (q_lo + shift - window + 1) — so
// no tile is loaded and then gated off. The kernel masks the ragged
// sequence edge itself, so any S works, and takes element strides for
// q, k, v and o, so BSHD and BHSD inputs both run without transposes. The
// head dim is a template parameter (every multiple of 8 up to 128); tiles
// are loaded with 16-byte vector loads.
//
// - bf16 inputs run on the tensor cores: mma.sync m16n8k16 with float32
//   accumulation (FlashAttention-2 layout). Each of 4 warps owns 16 q rows;
//   Q stays in registers as A fragments, K and V^T tiles sit in shared
//   memory as bf16 with rows padded by 16 bytes (conflict-free fragment
//   loads), and the probabilities are rounded to bf16 for the V product —
//   the rounding the reference kernel does (p.astype(v.dtype)).
// - float32 inputs run on the CUDA cores in true float32 (no TF32, whose
//   10-bit mantissa would break parity with the reference): tiles staged as
//   float32 with odd row strides, each q row owned by a quad of threads
//   that each score 16 of the tile's 64 keys and own every fourth output
//   column. Its ceiling is the 67 TFLOP/s float32 rate, and one
//   shared-memory load per multiply-add holds it well below that.
//
// Later work (not here): wgmma and TMA with a multi-stage ring, register-
// blocked float32 score tiles, smaller q tiles when B*H*S/64 < the SM count.

#include "common.cuh"

namespace {
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per kv tile
}  // namespace

// Mirrors FwdParams in ops/kernels/flash_attention.py (ctypes.Structure).
struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, S] float32, or null
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t B, H, S, D;
  int32_t causal, window, shift;  // window 0 = none
  int32_t in_dtype, out_dtype;
  float scale;
};

// Range of kv tiles [tile_lo, tile_hi) that can meet some row of the q tile
// starting at q_lo.
struct TileRange {
  int lo, hi;
};
__device__ __forceinline__ TileRange kv_tiles(const FwdParams& p, int q_lo) {
  const int q_hi = min(q_lo + kBQ - 1, p.S - 1);
  int kv_hi = p.S;
  if (p.causal) kv_hi = min(p.S, q_hi + p.shift + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q_lo + p.shift - p.window + 1);
  const int lo = kv_lo / kBK;
  return {lo, kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : lo};
}

__device__ __forceinline__ bool key_valid(const FwdParams& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) {
    ok = ok && qpos >= kpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, a quad of threads per q row.
// ---------------------------------------------------------------------------
namespace f32path {
constexpr int kThreads = 256;
constexpr int kKeys = kBK / 4;  // scores per thread per tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

// Stage rows [r0, r0 + 64) of a [S, D] slab (row stride rs) as float32 with
// row stride D + 1; rows past S become zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t rs, int r0, int S) {
  constexpr int U = kBQ * D / 8;
#pragma unroll
  for (int u = threadIdx.x; u < U; u += kThreads) {
    const int row = u / (D / 8), col = (u % (D / 8)) * 8;
    Vec8<float> x;
    if (r0 + row < S) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    float t[8];
    x.to_f32(t);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[row * (D + 1) + col + e] = t[e];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdParams p) {
  constexpr int DP = D + 1;
  constexpr int kCols = (D + 3) / 4;
  extern __shared__ float smem[];
  float* sQ = smem;             // [kBQ][DP]
  float* sK = sQ + kBQ * DP;    // [kBK][DP]
  float* sV = sK + kBK * DP;    // [kBK][DP]
  float* sP = sV + kBK * DP;    // [kBQ][kBK + 1]

  const int q_lo = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row within the tile
  const int t = tid & 3;   // lane within the row's quad
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage<D>(sQ, q, p.q_ss, q_lo, p.S);

  const TileRange tiles = kv_tiles(p, q_lo);
  const int qpos = q_lo + r + p.shift;  // this row's global position
  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // every thread is done with the previous tile
    stage<D>(sK, k, p.k_ss, k0, p.S);
    stage<D>(sV, v, p.v_ss, k0, p.S);
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.f;
    const float* qrow = sQ + r * DP;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = fmaf(qd, sK[(t + 4 * i) * DP + d], s[i]);
    }
    uint32_t valid = 0;
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const bool ok = key_valid(p, qpos, k0 + t + 4 * i);
      s[i] = ok ? s[i] * p.scale : kNegInf;
      valid |= (uint32_t)ok << i;
      tmax = fmaxf(tmax, s[i]);
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* prow = sP + r * (kBK + 1);
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      // Masked keys are re-zeroed: with the finite mask a fully masked
      // tile would otherwise give exp(0) = 1.
      const float pi = ((valid >> i) & 1u) ? expf(s[i] - m_new) : 0.f;
      psum += pi;
      prow[t + 4 * i] = pi;
    }
    l = l * alpha + quad_sum(psum);
    m = m_new;
    __syncwarp();  // the quad's probabilities are in sP
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pj = prow[j];
      const float* vrow = sV + j * DP + t;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (D % 4 == 0 || t + 4 * c < D) acc[c] = fmaf(pj, vrow[4 * c], acc[c]);
    }
  }

  const int srow = q_lo + r;
  if (srow < p.S) {
    float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + srow * p.o_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = t + 4 * c;
      if (col < D) o[col] = l > 0.f ? acc[c] / l : 0.f;
    }
    if (p.lse != nullptr && t == 0)
      p.lse[((int64_t)b * p.H + h) * p.S + srow] =
          l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : kNegInf;
  }
}
}  // namespace f32path

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16, 16 q rows per warp.
// ---------------------------------------------------------------------------
namespace bf16path {
constexpr int kThreads = 128;

// Head dim rounded up to the mma's k = 16, and padded row strides (in bf16
// elements): +8 keeps rows 16-byte aligned and spreads a fragment load's 8
// rows over distinct banks.
template <int D> __host__ __device__ constexpr int dk() { return (D + 15) / 16 * 16; }
template <int D> __host__ __device__ constexpr int row_stride() { return dk<D>() + 8; }
constexpr int kVtStride = kBK + 8;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * kBQ * row_stride<D>() + D * kVtStride);
}

// Stage rows [r0, r0 + 64) of a bf16 [S, D] slab into dst with row stride
// row_stride<D>(); rows past S and columns in [D, dk) become zeros.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t rs,
                                      int r0, int S) {
  constexpr int VPR = dk<D>() / 8;  // 8-element vectors per staged row
  for (int u = threadIdx.x; u < kBQ * VPR; u += kThreads) {
    const int row = u / VPR, col = (u % VPR) * 8;
    Vec8<__nv_bfloat16> x;
    if (r0 + row < S && col < D) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    *reinterpret_cast<uint4*>(dst + row * row_stride<D>() + col) = x.u;
  }
}

// Stage V rows [r0, r0 + 64) transposed: dst[d][key].
template <int D>
__device__ __forceinline__ void stage_vt(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t rs,
                                         int r0, int S) {
  for (int u = threadIdx.x; u < kBK * (D / 8); u += kThreads) {
    const int row = u / (D / 8), col = (u % (D / 8)) * 8;
    Vec8<__nv_bfloat16> x;
    if (r0 + row < S) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x.u);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * kVtStride + row] = e[i];
  }
}

template <class O, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdParams p) {
  constexpr int DK = dk<D>(), SQ = row_stride<D>();
  constexpr int KT = DK / 16;  // k-steps of the score product
  constexpr int NT = kBK / 8;  // 8-key n-tiles per kv tile
  constexpr int ND = D / 8;    // 8-column n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q, then K: [64][SQ]
  __nv_bfloat16* sK = sQK + kBQ * SQ;                                // [64][SQ]
  __nv_bfloat16* sVt = sK + kBK * SQ;                                // [D][kVtStride]

  const int q_lo = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  stage<D>(sQK, q, p.q_ss, q_lo, p.S);
  __syncthreads();
  const int r0 = warp * 16;  // this warp's first row in the tile
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* base = sQK + (r0 + g) * SQ + kk * 16 + tig * 2;
    qa[kk][0] = lds32(base);
    qa[kk][1] = lds32(base + 8 * SQ);
    qa[kk][2] = lds32(base + 8);
    qa[kk][3] = lds32(base + 8 * SQ + 8);
  }

  const TileRange tiles = kv_tiles(p, q_lo);
  const int qpos0 = q_lo + r0 + g + p.shift;  // rows g and g + 8 of the warp
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // every warp is done with the previous tile
    stage<D>(sK, k, p.k_ss, k0, p.S);
    stage_vt<D>(sVt, v, p.v_ss, k0, p.S);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const __nv_bfloat16* base = sK + (nt * 8 + g) * SQ + kk * 16 + tig * 2;
        mma_bf16(s[nt], qa[kk], lds32(base), lds32(base + 8));
      }
    }
    // Element (nt, i): row g + 8 * (i >> 1), key k0 + nt * 8 + tig * 2 + (i & 1).
    float tmax[2] = {kNegInf, kNegInf};
    uint32_t valid = 0;  // bit nt * 4 + i
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = key_valid(p, qpos0 + 8 * (i >> 1), k0 + nt * 8 + tig * 2 + (i & 1));
        s[nt][i] = ok ? s[nt][i] * p.scale : kNegInf;
        valid |= (uint32_t)ok << (nt * 4 + i);
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[nt][i]);
      }
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Masked keys are re-zeroed: with the finite mask a fully masked
        // tile would otherwise give exp(0) = 1.
        const float pi = ((valid >> (nt * 4 + i)) & 1u) ? expf(s[nt][i] - m_new[i >> 1]) : 0.f;
        psum[i >> 1] += pi;
        s[nt][i] = pi;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // The score tiles 2kk and 2kk+1 are this k-step's A fragment.
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const __nv_bfloat16* base = sVt + (nd * 8 + g) * kVtStride + kk * 16 + tig * 2;
        mma_bf16(acc[nd], pa, lds32(base), lds32(base + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int srow = q_lo + r0 + g + 8 * r;
    if (srow >= p.S) continue;
    O* o = static_cast<O*>(p.o) + b * p.o_sb + h * p.o_sh + srow * p.o_ss;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + tig * 2;
      o[col] = from_f32<O>(l[r] > 0.f ? acc[nd][2 * r] * inv : 0.f);
      o[col + 1] = from_f32<O>(l[r] > 0.f ? acc[nd][2 * r + 1] * inv : 0.f);
    }
    if (p.lse != nullptr && tig == 0)
      p.lse[((int64_t)b * p.H + h) * p.S + srow] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-37f)) : kNegInf;
  }
}
}  // namespace bf16path

template <class Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, int threads, const FwdParams& p,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.S + kBQ - 1) / kBQ, p.H, p.B), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int flash_attention_fwd(const FwdParams* params, void* stream) {
  const FwdParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (p.in_dtype == DT_F32 && p.out_dtype == DT_F32)
      err = launch(f32path::fwd_kernel<D>, f32path::smem_bytes<D>(), f32path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.out_dtype == DT_BF16)
      err = launch(bf16path::fwd_kernel<__nv_bfloat16, D>, bf16path::smem_bytes<D>(),
                   bf16path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.out_dtype == DT_F32)
      err = launch(bf16path::fwd_kernel<float, D>, bf16path::smem_bytes<D>(),
                   bf16path::kThreads, p, s);
  });
  return (int)err;
}
