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
// 8*D a pair (103.1 GFLOP, 0.104 ms). Both are bound by operations, so the
// bf16 path is built around the tensor cores' wgmma:
// - Two kernels, deterministic, no atomics (the TPU's sequential last grid
//   axis becomes a loop inside the block). K2: a block owns 128 q rows and
//   loops over the kv tiles from the window's first to the one holding row
//   q_hi + shift. K3: a block owns 128 keys and loops over the q rows
//   max(0, k_lo - shift) .. min(S-1, k_hi + window - 1 - shift), the exact
//   form of the reference's clamped q anchor.
// - bf16: each of two consumer warpgroups owns 64 of the block's rows. The
//   resident rows (Q and dO for K2, K and V for K3) are loaded once; 64-row
//   tiles of the other side (K, V; or Q, dO with their lse and delta) stream
//   through a 4-stage shared-memory ring that a producer warpgroup fills
//   with 16-byte cp.async copies (zero-filled past S and past the head dim;
//   setmaxnreg hands its registers to the consumers). The copies arrive on
//   each stage's mbarrier as they land, so up to four tiles are in flight
//   and loads overlap the math.
//   K3 computes S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16 (both
//   operands in shared memory, K-major), then dV += P^T dO and dK += dS^T Q
//   with P^T / dS^T packed to bf16 straight from the accumulators as the
//   register A operand and the same Q / dO tile read MN-major through its
//   descriptor. K2 does S = Q K^T, dP = dO V^T, dQ += dS K likewise. So each
//   tile has one copy in shared memory (128-byte swizzle, 64-column panels;
//   head dims below 64 or between 64 and 128 are zero-padded to 64 / 128, so
//   one kernel serves every head dim), with no transposed second copy.
//   Within a tile p = exp(s - lse) is computed while dP is still on the
//   tensor cores; every wgmma group is retired before the tile ends, since
//   ptxas serializes all wgmmas of a kernel that keeps one in flight across
//   a branch or a loop's back edge (measured: 0.78 ms for the pair with the
//   next tile's S / dP in flight, 0.62 ms without). The two warpgroups'
//   tiles interleave on the tensor cores.
// - Tiles wholly inside the valid region skip the per-score mask; diagonal,
//   window-edge and ragged-edge tiles take it; a warpgroup skips a tile in
//   which none of its pairs is valid.
// - Causal blocks with the most tiles launch first (blockIdx.y, the slowest
//   launch axis, walks them longest first), so the grid does not end on a
//   tail of long blocks.
// - float32 runs on the CUDA cores in true float32 (no TF32): a quad of
//   threads per row (K2) or per key (K3), 64-row tiles.
// delta is computed once per row by a small pre-pass (launched with K2)
// into [B, H, S] float32 scratch; the reference recomputes it per tile only
// because of the TPU's lane-replicated layout. The lse is [B, H, S] float32,
// as K1 writes it. Both layouts run by element strides, with no transposes.
// The finite NEG_INF: p = exp(s - lse) is 1, not 0, on a row whose lse is
// NEG_INF; on masked tiles every score keeps a validity bit and masked p is
// set to 0 explicitly, and ds = p * (dp - delta) * scale with dp and delta
// finite is 0 there too, so a row with no valid key gets zero dq and gives
// nothing to dk / dv.

#include "common.cuh"
#include "hopper.cuh"

namespace {
constexpr int kTile = 64;  // float32 path: q rows per K2 block, keys per K3 block, streamed tile
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

// K3: the T-row q tiles [lo, hi) holding some row that sees one of the R keys
// at k_lo: rows max(0, k_lo - shift) .. min(S-1, k_hi + window - 1 - shift).
template <int R, int T>
__device__ __forceinline__ TileRange q_tiles(const BwdParams& p, int k_lo) {
  const int k_hi = min(k_lo + R - 1, p.S - 1);
  int i_lo = 0, i_hi = p.S - 1;
  if (p.causal) {
    i_lo = max(0, k_lo - p.shift);
    if (p.window > 0) i_hi = min(p.S - 1, k_hi + p.window - 1 - p.shift);
  }
  const int lo = i_lo / T;
  return {lo, i_hi >= i_lo ? i_hi / T + 1 : lo};
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

  const TileRange tiles = kv_tiles<kTile, kTile>(p, q_lo);
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

  const TileRange tiles = q_tiles<kTile, kTile>(p, k_lo);
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
// One kernel for K2 and K3 (kDKV), for head dims up to 64 (DP 64) or 128
// (DP 128). A block holds kBlockRows resident rows: q rows and their dO (K2)
// or keys and their V (K3), 64 per consumer warpgroup, and streams 64-row
// tiles of the other side (K and V for K2; Q, dO, lse and delta for K3)
// through a kStages ring that a producer warpgroup fills with cp.async.
// Registers move from the producer (40 a thread) to the consumers (232).
constexpr int kBlockRows = 128;
constexpr int kTileRows = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int P = DP / 64;                         // 64-column panels
  static constexpr uint32_t kResPanel = kBlockRows * 128;   // bytes
  static constexpr uint32_t kTilePanel = kTileRows * 128;
  static constexpr uint32_t kRes = P * kResPanel;           // one resident tensor
  static constexpr uint32_t kTile = P * kTilePanel;         // one stage of one streamed tensor
  static constexpr uint32_t X = 0, Y = kRes;                // resident: Q, dO (K2) / K, V (K3)
  static constexpr uint32_t U = 2 * kRes;                   // streamed: K (K2) / Q (K3)
  static constexpr uint32_t W = U + kStages * kTile;        // streamed: V (K2) / dO (K3)
  static constexpr uint32_t LSE = W + kStages * kTile;      // K3: [kStages][64] float
  static constexpr uint32_t DELTA = LSE + kStages * kTileRows * 4;
  static constexpr uint32_t FULL = DELTA + kStages * kTileRows * 4;  // mbarriers
  static constexpr uint32_t EMPTY = FULL + kStages * 8;
  static constexpr size_t kBytes = EMPTY + kStages * 8 + 1024;       // + alignment slack
};

// Write a 64 x DP accumulator (rows row0 + 16 * warp + g (+8), columns < D).
template <class O, int DP>
__device__ __forceinline__ void store_acc(void* out, int64_t sb, int64_t ss, int64_t sh, int b,
                                          int h, int row0, const BwdParams& p,
                                          const float (&acc)[DP / 2], int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.S) continue;
    O* o = static_cast<O*>(out) + b * sb + h * sh + row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= p.D) break;
      const float x0 = acc[4 * j + 2 * r], x1 = acc[4 * j + 2 * r + 1];
      if constexpr (sizeof(O) == 4) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// p = exp(s * scale - lse), in place in sc; with kMask, pairs outside the
// valid region get p = 0. K3: rows are keys my0 (+8), columns q rows r0 +
// col with their lse from the stage; K2: rows are q rows my0 (+8) with nl =
// -lse * log2e, columns keys r0 + col.
template <bool kDKV, bool kMask>
__device__ __forceinline__ void p_of(float (&sc)[32], const BwdParams& p, const float* lse_s,
                                     const float (&nl)[2], int r0, int my0, int t) {
  const float c = p.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 ls = make_float2(0.f, 0.f);
    if (kDKV) ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1, col = 8 * j + 2 * t + (e & 1);
      const float nlse = kDKV ? -((e & 1) ? ls.y : ls.x) * kLog2e : nl[r];
      const float pv = exp2f(fmaf(sc[i], c, nlse));
      if (kMask) {
        const bool ok = kDKV ? pair_ok(p, r0 + col, my0 + 8 * r) : pair_ok(p, my0 + 8 * r, r0 + col);
        sc[i] = ok ? pv : 0.f;
      } else {
        sc[i] = pv;
      }
    }
  }
}

// ds = p * (dp - delta) * scale, in place in dp (zero where p is: dp and
// delta are finite). K3 takes delta by column from the stage, K2 by row (dl).
template <bool kDKV>
__device__ __forceinline__ void ds_of(float (&dp)[32], const float (&sc)[32], const BwdParams& p,
                                      const float* del_s, const float (&dl)[2], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 de = make_float2(0.f, 0.f);
    if (kDKV) de = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float delta = kDKV ? ((e & 1) ? de.y : de.x) : dl[e >> 1];
      dp[i] = sc[i] * (dp[i] - delta) * p.scale;
    }
  }
}

template <class O, int DP, bool kDKV>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const BwdParams p) {
  using L = Layout<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));  // generic view of base

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int nblk = (p.S + kBlockRows - 1) / kBlockRows;
  // Longest work first: causal K3 blocks at low keys and K2 blocks at high q
  // rows walk the most tiles, and blockIdx.y is the slowest launch axis.
  const int blk = (p.causal && !kDKV) ? nblk - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int lo = blk * kBlockRows;
  const TileRange tiles = kDKV ? q_tiles<kBlockRows, kTileRows>(p, lo)
                               : kv_tiles<kBlockRows, kTileRows>(p, lo);
  const int n_tiles = tiles.hi - tiles.lo;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.S;  // this (b, h) in lse / delta

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + L::FULL + 8 * s, kThreads - kConsumers);
      mbar_init(base + L::EMPTY + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Warpgroup index, broadcast from lane 0 so that the compiler sees it is
  // uniform across each warp (branches on it then need no wgmma serialization).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers / 128) {
    // Producer warpgroup: fill stage it % kStages with tile it once the
    // consumers have released it. Each thread's copies arrive on the stage's
    // full barrier as they land, so up to kStages tiles are in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x - kConsumers, n = kThreads - kConsumers;
    const __nv_bfloat16* u = kDKV ? q : k;
    const __nv_bfloat16* w = kDKV ? gr : v;
    const int64_t u_rs = kDKV ? p.q_ss : p.k_ss, w_rs = kDKV ? p.do_ss : p.v_ss;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, r0 = (tiles.lo + it) * kTileRows;
      mbar_wait(base + L::EMPTY + 8 * s, ((it / kStages) & 1) ^ 1);
      load_rows<kTileRows, L::P>(base + L::U + s * L::kTile, L::kTilePanel, u, u_rs, r0, p.S,
                                 p.D, lane, n);
      load_rows<kTileRows, L::P>(base + L::W + s * L::kTile, L::kTilePanel, w, w_rs, r0, p.S,
                                 p.D, lane, n);
      if (kDKV && lane < kTileRows) {
        const bool ok = r0 + lane < p.S;
        const int64_t i = row0 + (ok ? r0 + lane : 0);
        cp_async4(base + L::LSE + (s * kTileRows + lane) * 4, p.lse + i, ok);
        cp_async4(base + L::DELTA + (s * kTileRows + lane) * 4, p.delta + i, ok);
      }
      cp_async_arrive(base + L::FULL + 8 * s);
    }
    cp_async_wait<0>();
    return;
  }

  // Consumer warpgroup wg: resident rows lo + 64 * wg .. + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw0 = lo + 64 * wg;
  const uint32_t x = base + L::X + wg * 64 * 128, y = base + L::Y + wg * 64 * 128;
  load_rows<64, L::P>(x, L::kResPanel, kDKV ? k : q, kDKV ? p.k_ss : p.q_ss, rw0, p.S, p.D,
                      threadIdx.x & 127, 128);
  load_rows<64, L::P>(y, L::kResPanel, kDKV ? v : gr, kDKV ? p.v_ss : p.do_ss, rw0, p.S, p.D,
                      threadIdx.x & 127, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  // K2: this thread's rows my0 and my0 + 8: -lse * log2e and delta.
  const int my0 = rw0 + 16 * warp + g;
  float nl[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (!kDKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (my0 + 8 * r < p.S) {
        nl[r] = -p.lse[row0 + my0 + 8 * r] * kLog2e;
        dl[r] = p.delta[row0 + my0 + 8 * r];
      }
    }
  }
  float acc1[DP / 2], acc2[DP / 2];  // dv, dk (K3); dq, unused (K2)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc1[i] = acc2[i] = 0.f;

  // Per tile: S (S^T) and dP (dP^T) as two wgmma groups; p = exp(...) runs
  // while dP is still on the tensor cores; then ds, and the products that
  // take p and ds as register A operands. Every group is retired within its
  // tile, so no wgmma is in flight across a branch or the loop's back edge
  // (ptxas would serialize all of them). The other warpgroup's tile fills
  // the tensor cores while this one computes.
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, r0 = (tiles.lo + it) * kTileRows;
    const uint32_t ut = base + L::U + s * L::kTile, wt = base + L::W + s * L::kTile;
    mbar_wait(base + L::FULL + 8 * s, (it / kStages) & 1);
    fence_proxy_async();  // the stage's cp.async writes, before wgmma reads them
    const int kind = kDKV ? tile_kind(p, r0, r0 + kTileRows - 1, rw0, rw0 + 63)
                          : tile_kind(p, rw0, rw0 + 63, r0, r0 + kTileRows - 1);
    if (kind != 0) {
      float sc[32], dp[32];
      wgmma_fence();
      product_ss<DP>(sc, x, L::kResPanel, ut, L::kTilePanel);
      wgmma_commit();
      product_ss<DP>(dp, y, L::kResPanel, wt, L::kTilePanel);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      const float* lse_s = reinterpret_cast<const float*>(gbase + L::LSE) + s * kTileRows;
      const float* del_s = reinterpret_cast<const float*>(gbase + L::DELTA) + s * kTileRows;
      if (kind == 1) p_of<kDKV, true>(sc, p, lse_s, nl, r0, my0, t);
      else p_of<kDKV, false>(sc, p, lse_s, nl, r0, my0, t);
      wgmma_wait<0>();
      fence_regs(dp);
      ds_of<kDKV>(dp, sc, p, del_s, dl, t);
      uint32_t da[4][4];
      to_a_frags(da, dp);
      fence_regs(acc1);
      if constexpr (kDKV) {
        uint32_t pa[4][4];
        to_a_frags(pa, sc);
        fence_regs(acc2);
        wgmma_fence();
        product_rs<DP>(acc1, pa, wt, L::kTilePanel);  // dv += p^T . dO
        product_rs<DP>(acc2, da, ut, L::kTilePanel);  // dk += ds^T . Q
      } else {
        wgmma_fence();
        product_rs<DP>(acc1, da, ut, L::kTilePanel);  // dq += ds . K
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc1);
      if constexpr (kDKV) fence_regs(acc2);
    }
    mbar_arrive(base + L::EMPTY + 8 * s);
  }
  if constexpr (kDKV) {
    store_acc<O, DP>(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, b, h, rw0 + 16 * warp, p, acc2, g, t);
    store_acc<O, DP>(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, b, h, rw0 + 16 * warp, p, acc1, g, t);
  } else {
    store_acc<O, DP>(p.dq, p.dq_sb, p.dq_ss, p.dq_sh, b, h, rw0 + 16 * warp, p, acc1, g, t);
  }
}

template <class O, bool kDKV>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.S + kBlockRows - 1) / kBlockRows);
  auto run = [&](auto kernel, size_t smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  };
  if (p.D <= 64) return run(bwd_kernel<O, 64, kDKV>, Layout<64>::kBytes);
  return run(bwd_kernel<O, 128, kDKV>, Layout<128>::kBytes);
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
    if (p.in_dtype == DT_F32)
      err = p.grad_dtype == DT_F32 ? launch(f32path::dq_kernel<D>, f32path::dq_smem_bytes<D>(),
                                            f32path::kThreads, p, s)
                                   : cudaErrorInvalidValue;
  });
  if (err != cudaSuccess || p.in_dtype != DT_BF16) return (int)err;
  if (p.grad_dtype == DT_BF16) return (int)bf16path::launch<__nv_bfloat16, false>(p, s);
  if (p.grad_dtype == DT_F32) return (int)bf16path::launch<float, false>(p, s);
  return (int)cudaErrorInvalidValue;
}

// K3; reads the delta the dq entry wrote.
extern "C" int flash_attention_bwd_dkv(const BwdParams* params, void* stream) {
  const BwdParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.in_dtype == DT_BF16 && p.D % 8 == 0 && p.D >= 8 && p.D <= 128) {
    if (p.grad_dtype == DT_BF16) return (int)bf16path::launch<__nv_bfloat16, true>(p, s);
    if (p.grad_dtype == DT_F32) return (int)bf16path::launch<float, true>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    if (p.in_dtype == DT_F32 && p.grad_dtype == DT_F32)
      err = launch(f32path::dkv_kernel<D>, f32path::dkv_smem_bytes<D>(), f32path::kThreads, p, s);
  });
  return (int)err;
}
