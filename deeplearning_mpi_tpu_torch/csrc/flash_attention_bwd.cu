// K2 and K3: the flash-attention backward for Hopper (sm_90a).
//
// Replaces deeplearning_mpi_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (K2) and ::_bwd_dkv_kernel (K3), both launched by _bwd_pallas. With the
// forward's per-row logsumexp lse, for every valid (q row i, key j):
//   s = q_i . k_j * scale,  p = exp(s - lse_i),  dp = do_i . v_j,
//   delta_i = rowsum(o_i * do_i),  ds = p * (dp - delta_i) * scale,
//   dq_i += ds * k_j,  dk_j += ds * q_i,  dv_j += p * do_i.
// Causal or full; a sliding window; a static q-position shift (the ring's);
// dq/dk/dv in the input dtype or float32 (grad_dtype). The reference's
// rounding points are kept: p and ds are rounded to the input dtype before
// their products (p.astype(in) . do, ds.astype(in) . k / q), dp and the
// scores accumulate in float32, delta comes from the stored o.
//
// What bounds them on an H100: at the training shape (bf16 B8 S2048 H12
// D64 causal, 201.4 M valid pairs) K2 does 6*D flops a pair (77.3 GFLOP,
// 0.078 ms at 989 TFLOP/s) against ~152 MB (0.045 ms at 3.35 TB/s); K3 does
// 8*D a pair (103.1 GFLOP, 0.104 ms). Both are bound by operations.
//
// Design. The TPU's sequential last grid axis becomes a loop inside the
// block, so the two kernels stay deterministic with no atomics:
// - K2: one block per (q tile of 64 rows, head, batch), looping over the kv
//   tiles from the window's first to the one holding row q_hi + shift;
// - K3: one block per (kv tile of 64 keys, head, batch), looping over the q
//   rows max(0, k_lo - shift) .. min(S-1, k_hi + window - 1 - shift) — the
//   exact form of the reference's clamped q anchor.
// delta is computed once per row by a small pre-pass (launched with K2)
// into [B, H, S] float32 scratch; the reference recomputes it per tile only
// because of the TPU's lane-replicated layout. The lse is [B, H, S] float32,
// as K1 writes it. Both layouts run by element strides, with no transposes;
// the ragged sequence edge is masked in the kernels.
// - bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation).
//   K2: each of 4 warps owns 16 q rows, with Q and dO as A fragments in
//   registers; K, V and K^T tiles in shared memory. K3: each warp owns 16
//   keys, with K and V as A fragments; it computes S^T and dP^T, and Q, dO,
//   Q^T, dO^T tiles sit in shared memory. P and dS leave the accumulators
//   straight as A fragments of the next product.
// - float32 runs on the CUDA cores in true float32 (no TF32): a quad of
//   threads per row (K2) or per key (K3), as in K1's float32 path.
// The finite NEG_INF: p = exp(s - lse) is 1, not 0, on a row whose lse is
// NEG_INF; every score keeps a validity bit and masked p and ds are set to
// 0 explicitly, so a row with no valid key gets zero dq and gives nothing to
// dk / dv.
//
// Later work (not here): wgmma and TMA with a multi-stage ring, ldmatrix
// (.trans) in place of the second transposed copy of each tile, one fused
// kernel with atomics on dq as FlashAttention-2 does.

#include "common.cuh"

namespace {
constexpr int kTile = 64;  // q rows per K2 block, keys per K3 block, and the streamed tile
}  // namespace

// Mirrors BwdParams in ops/kernels/flash_attention.py (ctypes.Structure).
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S] scratch: written by the dq entry, read by dkv
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int32_t B, H, S, D;
  int32_t causal, window, shift;  // window 0 = none
  int32_t in_dtype, grad_dtype;
  float scale;
};

__device__ __forceinline__ bool pair_valid(const BwdParams& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) {
    ok = ok && qpos >= kpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
  }
  return ok;
}

struct TileRange {
  int lo, hi;
};

// K2: kv tiles [lo, hi) that can meet some row of the q tile at q_lo.
__device__ __forceinline__ TileRange kv_tiles(const BwdParams& p, int q_lo) {
  const int q_hi = min(q_lo + kTile - 1, p.S - 1);
  int kv_hi = p.S;
  if (p.causal) kv_hi = min(p.S, q_hi + p.shift + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q_lo + p.shift - p.window + 1);
  const int lo = kv_lo / kTile;
  return {lo, kv_hi > kv_lo ? (kv_hi + kTile - 1) / kTile : lo};
}

// K3: q tiles [lo, hi) holding some row that sees a key of the tile at k_lo.
__device__ __forceinline__ TileRange q_tiles(const BwdParams& p, int k_lo) {
  const int k_hi = min(k_lo + kTile - 1, p.S - 1);
  int i_lo = 0, i_hi = p.S - 1;
  if (p.causal) {
    i_lo = max(0, k_lo - p.shift);
    if (p.window > 0) i_hi = min(p.S - 1, k_hi + p.window - 1 - p.shift);
  }
  const int lo = i_lo / kTile;
  return {lo, i_hi >= i_lo ? i_hi / kTile + 1 : lo};
}

// delta[b, h, s] = sum_d o * do, one thread per row.
template <class T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams p) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (int64_t)p.B * p.H * p.S) return;
  const int s = row % p.S;
  const int h = (row / p.S) % p.H;
  const int b = row / ((int64_t)p.S * p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + s * p.o_ss;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + s * p.do_ss;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    Vec8<T> x, y;
    x.load(o + d);
    y.load(g + d);
    float a[8], c[8];
    x.to_f32(a);
    y.to_f32(c);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], c[e], acc);
  }
  p.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, a quad of threads per row (K2) or per key (K3).
// ---------------------------------------------------------------------------
namespace f32path {
constexpr int kThreads = 256;
constexpr int kPer = kTile / 4;  // scores per thread per tile

template <int D> __host__ __device__ constexpr int pitch() { return D + 1; }  // odd row stride: no bank conflicts

// Stage rows [r0, r0 + 64) of a [S, D] slab (row stride rs) as float32;
// rows past S become zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t rs, int r0, int S) {
  for (int u = threadIdx.x; u < kTile * D / 8; u += kThreads) {
    const int row = u / (D / 8), col = (u % (D / 8)) * 8;
    Vec8<float> x;
    if (r0 + row < S) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    float t[8];
    x.to_f32(t);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[row * pitch<D>() + col + e] = t[e];
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * pitch<D>() + kTile * (kTile + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  constexpr int DP = pitch<D>(), kCols = D / 4;
  extern __shared__ float smem[];
  float* sQ = smem;               // [64][DP]
  float* sDO = sQ + kTile * DP;   // [64][DP]
  float* sK = sDO + kTile * DP;   // [64][DP]
  float* sV = sK + kTile * DP;    // [64][DP]
  float* sDS = sV + kTile * DP;   // [64][65]

  const int q_lo = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  stage<D>(sQ, q, p.q_ss, q_lo, p.S);
  stage<D>(sDO, g, p.do_ss, q_lo, p.S);

  const int srow = q_lo + r;
  const int64_t rowid = ((int64_t)b * p.H + h) * p.S + srow;
  const float lse = srow < p.S ? p.lse[rowid] : 0.f;
  const float delta = srow < p.S ? p.delta[rowid] : 0.f;
  const int qpos = srow + p.shift;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  const TileRange tiles = kv_tiles(p, q_lo);
  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // every thread is done with the previous tile
    stage<D>(sK, k, p.k_ss, k0, p.S);
    stage<D>(sV, v, p.v_ss, k0, p.S);
    __syncthreads();

    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d], gd = sDO[r * DP + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s[i] = fmaf(qd, sK[(t + 4 * i) * DP + d], s[i]);
        dp[i] = fmaf(gd, sV[(t + 4 * i) * DP + d], dp[i]);
      }
    }
    float* dsrow = sDS + r * (kTile + 1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool ok = pair_valid(p, qpos, k0 + t + 4 * i);
      const float pi = ok ? expf(s[i] * p.scale - lse) : 0.f;
      dsrow[t + 4 * i] = ok ? pi * (dp[i] - delta) * p.scale : 0.f;
    }
    __syncwarp();  // the quad's dS row is in shared memory
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float dsj = dsrow[j];
      const float* krow = sK + j * DP + t;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(dsj, krow[4 * c], acc[c]);
    }
  }
  if (srow < p.S) {
    float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + srow * p.dq_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[t + 4 * c] = acc[c];
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * pitch<D>() + 2 * kTile * (kTile + 1) + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const BwdParams p) {
  constexpr int DP = pitch<D>(), kCols = D / 4;
  extern __shared__ float smem[];
  float* sK = smem;                      // [64][DP]
  float* sV = sK + kTile * DP;           // [64][DP]
  float* sQ = sV + kTile * DP;           // [64][DP]
  float* sDO = sQ + kTile * DP;          // [64][DP]
  float* sP = sDO + kTile * DP;          // [64 keys][65]
  float* sDS = sP + kTile * (kTile + 1); // [64 keys][65]
  float* sLse = sDS + kTile * (kTile + 1);
  float* sDelta = sLse + kTile;

  const int k_lo = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* g = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.S;
  stage<D>(sK, k, p.k_ss, k_lo, p.S);
  stage<D>(sV, v, p.v_ss, k_lo, p.S);

  const int kpos = k_lo + r;
  float dk[kCols], dv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dk[c] = dv[c] = 0.f;

  const TileRange tiles = q_tiles(p, k_lo);
  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();
    stage<D>(sQ, q, p.q_ss, q0, p.S);
    stage<D>(sDO, g, p.do_ss, q0, p.S);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      sLse[threadIdx.x] = i < p.S ? p.lse[row0 + i] : 0.f;
      sDelta[threadIdx.x] = i < p.S ? p.delta[row0 + i] : 0.f;
    }
    __syncthreads();

    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = sK[r * DP + d], vd = sV[r * DP + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s[i] = fmaf(kd, sQ[(t + 4 * i) * DP + d], s[i]);
        dp[i] = fmaf(vd, sDO[(t + 4 * i) * DP + d], dp[i]);
      }
    }
    float* prow = sP + r * (kTile + 1);
    float* dsrow = sDS + r * (kTile + 1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = t + 4 * i, qrow = q0 + col;
      const bool ok = qrow < p.S && pair_valid(p, qrow + p.shift, kpos);
      const float pi = ok ? expf(s[i] * p.scale - sLse[col]) : 0.f;
      prow[col] = pi;
      dsrow[col] = ok ? pi * (dp[i] - sDelta[col]) * p.scale : 0.f;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float pj = prow[j], dsj = dsrow[j];
      const float* grow = sDO + j * DP + t;
      const float* qrow = sQ + j * DP + t;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dv[c] = fmaf(pj, grow[4 * c], dv[c]);
        dk[c] = fmaf(dsj, qrow[4 * c], dk[c]);
      }
    }
  }
  if (kpos < p.S) {
    float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + kpos * p.dk_ss;
    float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + kpos * p.dv_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkp[t + 4 * c] = dk[c];
      dvp[t + 4 * c] = dv[c];
    }
  }
}
}  // namespace f32path

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16, 16 rows (K2) or keys (K3) per warp.
// ---------------------------------------------------------------------------
namespace bf16path {
constexpr int kThreads = 128;
constexpr int NT = kTile / 8;  // 8-column n-tiles of a score tile

// Head dim rounded up to the mma's k = 16; padded row strides (+8 bf16:
// rows stay 16-byte aligned, and a fragment load's 8 rows hit distinct banks).
template <int D> __host__ __device__ constexpr int dk() { return (D + 15) / 16 * 16; }
template <int D> __host__ __device__ constexpr int row_stride() { return dk<D>() + 8; }
constexpr int kTStride = kTile + 8;  // transposed tiles [D][64 + 8]

// Stage rows [r0, r0 + 64) of a bf16 [S, D] slab into dst [64][row_stride];
// rows past S and columns in [D, dk) become zeros.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t rs,
                                      int r0, int S) {
  constexpr int VPR = dk<D>() / 8;
  for (int u = threadIdx.x; u < kTile * VPR; u += kThreads) {
    const int row = u / VPR, col = (u % VPR) * 8;
    Vec8<__nv_bfloat16> x;
    if (r0 + row < S && col < D) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    *reinterpret_cast<uint4*>(dst + row * row_stride<D>() + col) = x.u;
  }
}

// Stage the same rows transposed: dst[d][row], d < D.
template <int D>
__device__ __forceinline__ void stage_t(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t rs,
                                        int r0, int S) {
  for (int u = threadIdx.x; u < kTile * (D / 8); u += kThreads) {
    const int row = u / (D / 8), col = (u % (D / 8)) * 8;
    Vec8<__nv_bfloat16> x;
    if (r0 + row < S) x.load(src + (int64_t)(r0 + row) * rs + col); else x.zero();
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x.u);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * kTStride + row] = e[i];
  }
}

// A fragments of the warp's 16 rows (from r0) of a staged [64][row_stride] tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[dk<D>() / 16][4], const __nv_bfloat16* tile,
                                       int r0, int g, int tig) {
  constexpr int SQ = row_stride<D>();
#pragma unroll
  for (int kk = 0; kk < dk<D>() / 16; ++kk) {
    const __nv_bfloat16* base = tile + (r0 + g) * SQ + kk * 16 + tig * 2;
    a[kk][0] = lds32(base);
    a[kk][1] = lds32(base + 8 * SQ);
    a[kk][2] = lds32(base + 8);
    a[kk][3] = lds32(base + 8 * SQ + 8);
  }
}

// c[16 x 64] = A[16 x D] . B^T, B a staged [64][row_stride] tile. Element
// (nt, i) is row g + 8 * (i >> 1), column nt * 8 + tig * 2 + (i & 1).
template <int D>
__device__ __forceinline__ void product_nt(float (&c)[NT][4], uint32_t (&a)[dk<D>() / 16][4],
                                           const __nv_bfloat16* tile, int g, int tig) {
  constexpr int SQ = row_stride<D>();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < dk<D>() / 16; ++kk) {
      const __nv_bfloat16* base = tile + (nt * 8 + g) * SQ + kk * 16 + tig * 2;
      mma_bf16(c[nt], a[kk], lds32(base), lds32(base + 8));
    }
  }
}

// acc[16 x D] += bf16(x)[16 x 64] . B, B given transposed as Bt[d][64]
// (stride kTStride): x's accumulator layout is the next product's A layout.
template <int D>
__device__ __forceinline__ void product_acc(float (&acc)[D / 8][4], float (&x)[NT][4],
                                            const __nv_bfloat16* bt, int g, int tig) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const __nv_bfloat16* base = bt + (nd * 8 + g) * kTStride + kk * 16 + tig * 2;
      mma_bf16(acc[nd], a, lds32(base), lds32(base + 8));
    }
  }
}

// Write rows g and g + 8 of the warp's 16 (from global row row0) of acc.
template <class O, int D>
__device__ __forceinline__ void store_rows(void* out, int64_t sb, int64_t ss, int64_t sh, int b,
                                           int h, int row0, int S, float (&acc)[D / 8][4],
                                           int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    O* o = static_cast<O*>(out) + b * sb + h * sh + row * ss;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd * 8 + tig * 2] = from_f32<O>(acc[nd][2 * r]);
      o[nd * 8 + tig * 2 + 1] = from_f32<O>(acc[nd][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(3 * kTile * row_stride<D>() + D * kTStride);
}

template <class O, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  constexpr int SQ = row_stride<D>(), KT = dk<D>() / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q, then dO: [64][SQ]
  __nv_bfloat16* sK = sA + kTile * SQ;                              // [64][SQ]
  __nv_bfloat16* sV = sK + kTile * SQ;                              // [64][SQ]
  __nv_bfloat16* sKt = sV + kTile * SQ;                             // [D][kTStride]

  const int q_lo = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;

  const int r0 = warp * 16;
  uint32_t qa[KT][4], ga[KT][4];
  stage<D>(sA, q, p.q_ss, q_lo, p.S);
  __syncthreads();
  load_a<D>(qa, sA, r0, g, tig);
  __syncthreads();
  stage<D>(sA, gr, p.do_ss, q_lo, p.S);
  __syncthreads();
  load_a<D>(ga, sA, r0, g, tig);

  // Rows g and g + 8 of the warp: their lse and delta.
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + r0 + g + 8 * r;
    const int64_t id = ((int64_t)b * p.H + h) * p.S + row;
    lse[r] = row < p.S ? p.lse[id] : 0.f;
    delta[r] = row < p.S ? p.delta[id] : 0.f;
  }
  const int qpos0 = q_lo + r0 + g + p.shift;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const TileRange tiles = kv_tiles(p, q_lo);
  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    stage<D>(sK, k, p.k_ss, k0, p.S);
    stage<D>(sV, v, p.v_ss, k0, p.S);
    stage_t<D>(sKt, k, p.k_ss, k0, p.S);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    product_nt<D>(s, qa, sK, g, tig);
    product_nt<D>(dp, ga, sV, g, tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const bool ok = pair_valid(p, qpos0 + 8 * r, k0 + nt * 8 + tig * 2 + (i & 1));
        const float pi = ok ? expf(s[nt][i] * p.scale - lse[r]) : 0.f;
        s[nt][i] = ok ? pi * (dp[nt][i] - delta[r]) * p.scale : 0.f;  // ds
      }
    product_acc<D>(acc, s, sKt, g, tig);
  }
  store_rows<O, D>(p.dq, p.dq_sb, p.dq_ss, p.dq_sh, b, h, q_lo + r0 + g, p.S, acc, tig);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(3 * kTile * row_stride<D>() + 2 * D * kTStride) +
         sizeof(float) * 2 * kTile;
}

template <class O, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const BwdParams p) {
  constexpr int SQ = row_stride<D>(), KT = dk<D>() / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // K, then V: [64][SQ]
  __nv_bfloat16* sQ = sA + kTile * SQ;                              // [64][SQ]
  __nv_bfloat16* sDO = sQ + kTile * SQ;                             // [64][SQ]
  __nv_bfloat16* sQt = sDO + kTile * SQ;                            // [D][kTStride]
  __nv_bfloat16* sDOt = sQt + D * kTStride;                         // [D][kTStride]
  float* sLse = reinterpret_cast<float*>(sDOt + D * kTStride);      // [64]
  float* sDelta = sLse + kTile;                                     // [64]

  const int k_lo = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.S;

  const int r0 = warp * 16;
  uint32_t ka[KT][4], va[KT][4];
  stage<D>(sA, k, p.k_ss, k_lo, p.S);
  __syncthreads();
  load_a<D>(ka, sA, r0, g, tig);
  __syncthreads();
  stage<D>(sA, v, p.v_ss, k_lo, p.S);
  __syncthreads();
  load_a<D>(va, sA, r0, g, tig);

  const int kpos0 = k_lo + r0 + g;  // keys g and g + 8 of the warp
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;

  const TileRange tiles = q_tiles(p, k_lo);
  for (int tile = tiles.lo; tile < tiles.hi; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();
    stage<D>(sQ, q, p.q_ss, q0, p.S);
    stage<D>(sDO, gr, p.do_ss, q0, p.S);
    stage_t<D>(sQt, q, p.q_ss, q0, p.S);
    stage_t<D>(sDOt, gr, p.do_ss, q0, p.S);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      sLse[threadIdx.x] = i < p.S ? p.lse[row0 + i] : 0.f;
      sDelta[threadIdx.x] = i < p.S ? p.delta[row0 + i] : 0.f;
    }
    __syncthreads();
    float s[NT][4], dp[NT][4];  // S^T and dP^T: rows are keys, columns q rows
    product_nt<D>(s, ka, sQ, g, tig);
    product_nt<D>(dp, va, sDO, g, tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + tig * 2 + (i & 1), qrow = q0 + col;
        const bool ok = qrow < p.S && pair_valid(p, qrow + p.shift, kpos0 + 8 * (i >> 1));
        const float pi = ok ? expf(s[nt][i] * p.scale - sLse[col]) : 0.f;
        s[nt][i] = pi;
        dp[nt][i] = ok ? pi * (dp[nt][i] - sDelta[col]) * p.scale : 0.f;  // ds^T
      }
    product_acc<D>(dv, s, sDOt, g, tig);
    product_acc<D>(dk, dp, sQt, g, tig);
  }
  store_rows<O, D>(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, b, h, kpos0, p.S, dk, tig);
  store_rows<O, D>(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, b, h, kpos0, p.S, dv, tig);
}
}  // namespace bf16path

template <class Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, int threads, const BwdParams& p,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.S + kTile - 1) / kTile, p.H, p.B), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// delta pre-pass, then K2.
extern "C" int flash_attention_bwd_dq(const BwdParams* params, void* stream) {
  const BwdParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const int64_t rows = (int64_t)p.B * p.H * p.S;
    const unsigned blocks = (unsigned)((rows + 255) / 256);
    if (p.in_dtype == DT_F32) delta_kernel<float, D><<<blocks, 256, 0, s>>>(p);
    else delta_kernel<__nv_bfloat16, D><<<blocks, 256, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return;
    err = cudaErrorInvalidValue;
    if (p.in_dtype == DT_F32 && p.grad_dtype == DT_F32)
      err = launch(f32path::dq_kernel<D>, f32path::dq_smem_bytes<D>(), f32path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.grad_dtype == DT_BF16)
      err = launch(bf16path::dq_kernel<__nv_bfloat16, D>, bf16path::dq_smem_bytes<D>(),
                   bf16path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.grad_dtype == DT_F32)
      err = launch(bf16path::dq_kernel<float, D>, bf16path::dq_smem_bytes<D>(),
                   bf16path::kThreads, p, s);
  });
  return (int)err;
}

// K3; reads the delta the dq entry wrote.
extern "C" int flash_attention_bwd_dkv(const BwdParams* params, void* stream) {
  const BwdParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (p.in_dtype == DT_F32 && p.grad_dtype == DT_F32)
      err = launch(f32path::dkv_kernel<D>, f32path::dkv_smem_bytes<D>(), f32path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.grad_dtype == DT_BF16)
      err = launch(bf16path::dkv_kernel<__nv_bfloat16, D>, bf16path::dkv_smem_bytes<D>(),
                   bf16path::kThreads, p, s);
    else if (p.in_dtype == DT_BF16 && p.grad_dtype == DT_F32)
      err = launch(bf16path::dkv_kernel<float, D>, bf16path::dkv_smem_bytes<D>(),
                   bf16path::kThreads, p, s);
  });
  return (int)err;
}
