// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces deeplearning_mpi_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _fwd_pallas). Online-softmax attention with float32
// (acc, m, l), scale D**-0.5; causal or full; a sliding window; a static
// q-position shift (the ring schedule's); an optional per-row logsumexp
// [B, H, S] float32, which K2/K3 read; zero output rows and lse = NEG_INF
// where l == 0. The reference's one rounding point is kept: p is rounded to
// the input dtype before the V product (p.astype(v.dtype)), while l sums the
// unrounded float32 p.
//
// What bounds it on an H100: at the training shape (bf16 B8 S2048 H12 D64
// causal, 201.4 M valid pairs) it does 4*D flops a pair (51.6 GFLOP, 0.052
// ms at 989 TFLOP/s) against ~51 MB of q/k/v/o/lse (0.015 ms at 3.35 TB/s);
// at the serving prefill (f32 B1 S512 H12 D64 causal) 0.40 GFLOP, 0.006 ms
// at the 67 TFLOP/s float32 rate. Both are bound by operations.
//
// Common to both paths: the TPU kernel's sequential kv grid axis becomes a
// loop inside the block whose bounds are computed up front (causal: stop at
// the tile holding the block's last row plus shift; window: start at the
// tile holding q_lo + shift - window + 1), so no tile is loaded and then
// gated off. Causal blocks with the most tiles launch first (blockIdx.y, the
// slowest launch axis, walks the q blocks from the last), so the grid does
// not end on a tail of long blocks. The kernels mask the ragged sequence
// edge themselves (any S), and take element strides for q, k, v and o, so
// BSHD, BHSD and BHSD views of BSHD storage run without transposes. Each
// output row is owned by one block and every sum runs in a fixed order: two
// launches on the same inputs are bit-identical.
//
// - bf16 (the training path) runs on the tensor cores' wgmma, as K2/K3 do
//   (csrc/flash_attention_bwd.cu). A block owns 128 q rows: two consumer
//   warpgroups of 64 rows each, and a producer warpgroup that fills a
//   4-stage ring of 64-key K and V tiles with 16-byte zero-filling cp.async
//   (signalled on each stage's mbarrier with cp.async.mbarrier.arrive.noinc;
//   setmaxnreg hands its registers to the consumers). Q is loaded once into
//   128-byte-swizzled 64-column panels. Per tile a consumer computes S =
//   Q K^T (wgmma, both operands K-major in shared memory), the row max and
//   sum by quad shuffles in the accumulator layout, rescales its output by
//   alpha in registers, packs p to bf16 straight into register-A fragments
//   and adds P V with wgmma, V read MN-major from the same tile: there is no
//   transposed copy of V. Head dims up to 64 or 128 are zero-padded to 64 /
//   128 by the copies. Every wgmma group is retired inside its tile: ptxas
//   serializes all wgmmas of a kernel that keeps one in flight across a
//   branch or the loop's back edge (PERF.md). Interior tiles skip the
//   per-score mask; diagonal, window-edge and ragged tiles take it (decided
//   per warpgroup and tile, so uniform); a warpgroup skips a tile in which
//   none of its pairs is valid. At head dims up to 64 an SM holds two
//   blocks, so four consumer warpgroups take turns on the tensor cores and
//   one block's start overlaps the other's tiles (one block an SM: 0.247
//   ms at the training shape; two: 0.190 ms, H100, PERF.md). Issuing the
//   next tile's S with the previous tile's P V inside a warpgroup measured
//   5% slower than this one-tile-at-a-time loop, and is not used.
// - float32 (the serving prefill) runs on the CUDA cores in true float32 (no
//   TF32, whose 10-bit mantissa would break parity with the reference). A
//   block owns 32 q rows, so that B1 H12 S512 gives 192 blocks for the 132
//   SMs; K and V 64-key tiles are double-buffered with cp.async. Each of 128
//   threads computes a 4-row x 4-key tile of scores and a 4-row x 4-column
//   tile of the output (two at D 128) from float4 shared loads: 8 FMAs per
//   16-byte load in both products. Rows are padded to D + 4 floats, so a
//   quarter-warp's float4 loads of 8 rows hit distinct banks. The
//   probabilities pass through shared memory between the two products,
//   within each warp.

#include "common.cuh"
#include "hopper.cuh"

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

namespace {
constexpr int kKeys = 64;  // keys per kv tile, both paths
constexpr float kLog2e = 1.4426950408889634f;
}  // namespace

// The q block of blockIdx.y: from the last for causal attention, whose last
// blocks walk the most tiles.
__device__ __forceinline__ int q_block(const FwdParams& p, int rows) {
  const int nblk = (p.S + rows - 1) / rows;
  return p.causal ? nblk - 1 - (int)blockIdx.y : (int)blockIdx.y;
}

__device__ __forceinline__ float lse_of(float m_scaled, float l) {
  return l > 0.f ? m_scaled + logf(fmaxf(l, 1e-37f)) : kNegInf;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, register-blocked 4 x 4 tiles.
// ---------------------------------------------------------------------------
namespace f32path {
constexpr int kRows = 32;      // q rows per block
constexpr int kThreads = 128;  // 8 row groups of 4 rows x 16 lanes
constexpr int kPP = kKeys + 4;  // row pitch of the probabilities, floats

template <int D> __host__ __device__ constexpr int pitch() { return D + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kRows * pitch<D>() + 4 * kKeys * pitch<D>() + kRows * kPP);
}

// cp.async rows [r0, r0 + R) of a float32 [S, D] slab (row stride rs) into
// dst with row pitch D + 4; rows past S become zeros.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t rs, int r0, int S) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  const uint32_t base = smem_u32(dst);
  for (int u = threadIdx.x; u < R * C; u += kThreads) {
    const int row = u / C, ch = u % C;
    const bool ok = r0 + row < S;
    cp_async16(base + (row * pitch<D>() + ch * 4) * 4,
               ok ? src + (int64_t)(r0 + row) * rs + ch * 4 : src, ok);
  }
}

__device__ __forceinline__ float lanes16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float lanes16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdParams p) {
  constexpr int DP = pitch<D>();
  constexpr int NG = D / 4;             // float4 column groups of a row
  constexpr int NC = (NG + 15) / 16;    // column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // [32][DP]
  float* sK = sQ + kRows * DP;       // [2][64][DP]
  float* sV = sK + 2 * kKeys * DP;   // [2][64][DP]
  float* sP = sV + 2 * kKeys * DP;   // [32][kPP]

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int q_lo = q_block(p, kRows) * kRows;
  // This thread: rows 4 ty .. 4 ty + 3; keys tx + 16 j; column groups tx + 16 c.
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  const TileRange tiles = kv_tiles<kRows, kKeys>(p, q_lo);
  const int n_tiles = tiles.hi - tiles.lo;
  load_rows<kRows, D>(sQ, q, p.q_ss, q_lo, p.S);
  if (n_tiles > 0) {
    load_rows<kKeys, D>(sK, k, p.k_ss, tiles.lo * kKeys, p.S);
    load_rows<kKeys, D>(sV, v, p.v_ss, tiles.lo * kKeys, p.S);
  }
  cp_async_commit();

  const float c = p.scale * kLog2e;
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cg = 0; cg < NC; ++cg) acc[i][cg][0] = acc[i][cg][1] = acc[i][cg][2] = acc[i][cg][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = (tiles.lo + it) * kKeys;
    __syncthreads();  // every thread is done with the buffer the next tile goes to
    if (it + 1 < n_tiles) {
      load_rows<kKeys, D>(sK + (buf ^ 1) * kKeys * DP, k, p.k_ss, k0 + kKeys, p.S);
      load_rows<kKeys, D>(sV + (buf ^ 1) * kKeys * DP, v, p.v_ss, k0 + kKeys, p.S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const float* tK = sK + buf * kKeys * DP;
    const float* tV = sV + buf * kKeys * DP;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(tK + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + 4 * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!pair_ok(p, row, k0 + tx + 16 * j)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = lanes16_max(mx);
      alpha[i] = exp2f((m[i] - mx) * c);
      // A row with no valid key so far keeps mx = NEG_INF: its masked
      // scores then give exp2(NEG_INF * c) = 0, not exp(0) = 1.
      const float nm = mx == kNegInf ? 0.f : -mx * c;
      float* prow = sP + (4 * ty + i) * kPP;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = exp2f(fmaf(s[i][j], c, nm));
        sum += pv;
        prow[tx + 16 * j] = pv;
      }
      l[i] = l[i] * alpha[i] + sum;  // this thread's keys; summed over the 16 lanes at the end
      m[i] = mx;
    }
    __syncwarp();  // the warp's rows of p are in sP
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cg = 0; cg < NC; ++cg)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][cg][e] *= alpha[i];
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * kPP + j);
#pragma unroll
      for (int cg = 0; cg < NC; ++cg) {
        if (NG % 16 != 0 && tx + 16 * cg >= NG) continue;
        const float* vcol = tV + j * DP + 4 * (tx + 16 * cg);
        float4 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = *reinterpret_cast<const float4*>(vcol + e * DP);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][cg][0] = fmaf(pe[e], vv[e].x, acc[i][cg][0]);
            acc[i][cg][1] = fmaf(pe[e], vv[e].y, acc[i][cg][1]);
            acc[i][cg][2] = fmaf(pe[e], vv[e].z, acc[i][cg][2]);
            acc[i][cg][3] = fmaf(pe[e], vv[e].w, acc[i][cg][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = lanes16_sum(l[i]);
    const int row = q_lo + 4 * ty + i;
    if (row >= p.S) continue;
    float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int cg = 0; cg < NC; ++cg) {
      if (NG % 16 != 0 && tx + 16 * cg >= NG) continue;
      *reinterpret_cast<float4*>(o + 4 * (tx + 16 * cg)) =
          make_float4(acc[i][cg][0] * inv, acc[i][cg][1] * inv, acc[i][cg][2] * inv,
                      acc[i][cg][3] * inv);
    }
    if (p.lse != nullptr && tx == 0)
      p.lse[((int64_t)b * p.H + h) * p.S + row] = lse_of(m[i] * p.scale, lt);
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3(p.B * p.H, (p.S + kRows - 1) / kRows), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
}  // namespace f32path

// ---------------------------------------------------------------------------
// bf16: tensor cores, wgmma, a producer warpgroup and a 4-stage ring.
// ---------------------------------------------------------------------------
namespace bf16path {
// A block holds kBlockRows q rows, 64 per consumer warpgroup, and streams
// 64-key K and V tiles through a kStages ring that a producer warpgroup
// fills with cp.async. One kernel for head dims up to 64 (DP 64) or 128
// (DP 128).
constexpr int kBlockRows = 128;
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup

// Blocks an SM holds: two at DP 64 (81 KB of shared memory each), so that
// four consumer warpgroups take turns on the tensor cores and one block's
// start overlaps the other's tiles; one at DP 128. At launch a thread has
// 80 (two blocks) or 168 registers (ptxas gives a kernel that uses
// setmaxnreg the launch bounds' cap); setmaxnreg moves the producer's to the
// consumers: 32 -> 104 and 40 -> 232. The consumers may not take more than
// the producer frees, or setmaxnreg.inc waits forever.
template <int DP> constexpr int kBlocksPerSM = DP == 64 ? 2 : 1;

template <int DP>
struct Layout {
  static constexpr int P = DP / 64;                        // 64-column panels
  static constexpr uint32_t kQPanel = kBlockRows * 128;    // bytes
  static constexpr uint32_t kTilePanel = kKeys * 128;
  static constexpr uint32_t kTile = P * kTilePanel;        // one stage of K or V
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = P * kQPanel;               // [kStages] K tiles
  static constexpr uint32_t V = K + kStages * kTile;       // [kStages] V tiles
  static constexpr uint32_t FULL = V + kStages * kTile;    // mbarriers
  static constexpr uint32_t EMPTY = FULL + kStages * 8;
  static constexpr size_t kBytes = EMPTY + kStages * 8 + 1024;  // + alignment slack
};

// Scores of pairs outside the valid region become NEG_INF. Element 4 j + 2 r
// + e is row my0 + 8 r, key k0 + 8 j + 2 t + e.
__device__ __forceinline__ void mask(float (&sc)[32], const FwdParams& p, int my0, int k0, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (!pair_ok(p, my0 + 8 * r, key)) sc[i] = kNegInf;
  }
}

// 2^x by the special-function unit alone, results below 2^-126 flushed to
// zero (exp2f adds a fix-up for them; such p add nothing a bf16 output can
// hold).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one tile's scores, in place (sc becomes p), for rows
// my0 and my0 + 8: the running max m (raw score units), this thread's part
// of the running sum l, and alpha = exp(m_old - m_new) for the output.
__device__ __forceinline__ void softmax(float (&sc)[32], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    alpha[r] = exp2_ftz((m[r] - mx) * c);
    // A row with no valid key so far keeps mx = NEG_INF: its masked scores
    // then give exp2(NEG_INF * c) = 0, not exp(0) = 1.
    const float nm = mx == kNegInf ? 0.f : -mx * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        sc[i] = exp2_ftz(fmaf(sc[i], c, nm));
        sum += sc[i];
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = mx;
  }
}

template <class O, int DP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<DP>) fwd_kernel(const FwdParams p) {
  using L = Layout<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int lo = q_block(p, kBlockRows) * kBlockRows;
  const TileRange tiles = kv_tiles<kBlockRows, kKeys>(p, lo);
  const int n_tiles = tiles.hi - tiles.lo;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

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
    // Producer warpgroup: fill stage it % kStages with K and V tile it once
    // the consumers have released it. Each thread's copies arrive on the
    // stage's full barrier as they land, so up to kStages tiles are in flight.
    if constexpr (kBlocksPerSM<DP> == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    else asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x - kConsumers, n = kThreads - kConsumers;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, k0 = (tiles.lo + it) * kKeys;
      mbar_wait(base + L::EMPTY + 8 * s, ((it / kStages) & 1) ^ 1);
      load_rows<kKeys, L::P>(base + L::K + s * L::kTile, L::kTilePanel, k, p.k_ss, k0, p.S, p.D,
                             lane, n);
      load_rows<kKeys, L::P>(base + L::V + s * L::kTile, L::kTilePanel, v, p.v_ss, k0, p.S, p.D,
                             lane, n);
      cp_async_arrive(base + L::FULL + 8 * s);
    }
    cp_async_wait<0>();
    return;
  }

  // Consumer warpgroup wg: q rows lo + 64 * wg .. + 63.
  if constexpr (kBlocksPerSM<DP> == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n" ::: "memory");
  else asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw0 = lo + 64 * wg;
  const uint32_t xq = base + L::Q + wg * 64 * 128;
  load_rows<64, L::P>(xq, L::kQPanel, q, p.q_ss, rw0, p.S, p.D, threadIdx.x & 127, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  const int my0 = rw0 + 16 * warp + g;  // this thread's rows: my0 and my0 + 8
  const float c = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  // Per tile: S as one wgmma group, the softmax on the CUDA cores, then P V
  // as a second group with p as the register A operand. Both groups are
  // retired within the tile, so no wgmma is in flight across a branch or the
  // loop's back edge (ptxas would serialize all of them); the other
  // warpgroup's tile fills the tensor cores meanwhile.
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, k0 = (tiles.lo + it) * kKeys;
    const uint32_t kt = base + L::K + s * L::kTile, vt = base + L::V + s * L::kTile;
    mbar_wait(base + L::FULL + 8 * s, (it / kStages) & 1);
    fence_proxy_async();  // the stage's cp.async writes, before wgmma reads them
    const int kind = tile_kind(p, rw0, rw0 + 63, k0, k0 + kKeys - 1);
    if (kind != 0) {
      float sc[32];
      wgmma_fence();
      product_ss<DP>(sc, xq, L::kQPanel, kt, L::kTilePanel);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (kind == 1) mask(sc, p, my0, k0, t);
      float alpha[2];
      softmax(sc, m, l, alpha, c);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[4][4];
      to_a_frags(pa, sc);  // p.astype(v.dtype)
      fence_regs(acc);
      wgmma_fence();
      product_rs<DP>(acc, pa, vt, L::kTilePanel);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(base + L::EMPTY + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const int row = my0 + 8 * r;
    if (row >= p.S) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    O* o = static_cast<O*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= p.D) break;
      const float x0 = acc[4 * j + 2 * r] * inv, x1 = acc[4 * j + 2 * r + 1] * inv;
      if constexpr (sizeof(O) == 4) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(x0, x1);
      }
    }
    if (p.lse != nullptr && t == 0)
      p.lse[((int64_t)b * p.H + h) * p.S + row] = lse_of(m[r] * p.scale, lt);
  }
}

template <class O>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.S + kBlockRows - 1) / kBlockRows);
  auto run = [&](auto kernel, size_t smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  };
  if (p.D <= 64) return run(fwd_kernel<O, 64>, Layout<64>::kBytes);
  return run(fwd_kernel<O, 128>, Layout<128>::kBytes);
}
}  // namespace bf16path

extern "C" int flash_attention_fwd(const FwdParams* params, void* stream) {
  const FwdParams& p = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D % 8 != 0 || p.D < 8 || p.D > 128) return (int)cudaErrorInvalidValue;
  if (p.in_dtype == DT_BF16) {
    if (p.out_dtype == DT_BF16) return (int)bf16path::launch<__nv_bfloat16>(p, s);
    if (p.out_dtype == DT_F32) return (int)bf16path::launch<float>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (p.in_dtype == DT_F32 && p.out_dtype == DT_F32)
    dispatch_head_dim(p.D, [&](auto dc) { err = f32path::launch<decltype(dc)::value>(p, s); });
  return (int)err;
}
