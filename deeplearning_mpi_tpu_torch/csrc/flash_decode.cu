// K4: flash-decode for Hopper (sm_90a), split over the cache.
//
// Replaces deeplearning_mpi_tpu/ops/pallas/flash_decode.py::_decode_kernel
// (launched by flash_decode). One query token per row over a grouped KV
// cache [B, L, Hkv, D] with a per-row fill level index[B]: row b attends
// positions max(index-window+1, 0) .. index[b]; index < 0 marks an inactive
// row, whose output is zero. Grouped-query heads are consumed natively
// (query head i reads kv head i / group, the order repeat_kv uses), so each
// K/V row is read once per kv head. int8 K/V carry per-(token, head) float32
// scales, factored out of both dots: K scales multiply the scores after the
// dot, V scales fold into p before the V dot.
//
// What bounds it on an H100: memory. Each (row, kv head) reads its filled
// K and V rows once and does 4*group flops per element read, far below the
// ~20 flops/byte float32 balance point, so the bound is the filled cache
// bytes over 3.35 TB/s (15.7 MB, 4.7 us at the serving engine's 8 slots of
// 143..527 filled rows). Nothing past index[b] and nothing before the
// window is read (the TPU kernel's clamped index map, here as loop bounds).
// At a bytes bound the kernel's job is to keep enough bytes in flight on
// every SM, so the design is about blocks and copies, not tensor cores:
//
// - The walk is split. Each row's cache is cut into splits of 128 rows,
//   and one block of 4 warps takes one (split, kv head, row): at the
//   serving shape 300 live blocks for 132 SMs, where one block per (kv
//   head, row) gave 96. The wrapper knows L but not the fills (it never
//   synchronises to read them), so it launches ceil(L / 128) splits; a
//   block whose split holds no attended row exits after reading index[b].
//   Longer splits (256 to 1024 rows, a warp walking 2 to 8 chunks through
//   two stages) measured slower at the serving shape and no faster at L8192.
// - Every warp works. Each warp takes one 32-row chunk of the split: a lane
//   scores one key against up to 4 query heads of the group in one pass
//   over its K row, the warp takes the chunk's softmax (m, l) with shuffles
//   and accumulates p V, each lane owning columns lane, lane + 32, ... The
//   warps combine their (m, l, acc[G, D]) in shared memory in warp order.
// - Copies are in flight. Each warp stages its chunk with 16-byte (8 for
//   int8 rows of a head dim that is not a multiple of 16) zero-filling
//   cp.async, K (with the int8 scales) and V as two groups waited for with
//   cp.async.wait_group, so the chunk is scored while its V rows land; the
//   block's whole split (64 KB in float32) is in flight at once, and three
//   blocks fit an SM. Rows are padded to an odd number of 16-byte units, so
//   the lanes' row reads do not conflict.
// - The merge is the last block's. Each live block writes its split's
//   partial (m, l, acc[G, D]) to an f32 workspace [B, Hkv, n_split, G, D]
//   plus (m, l) that the wrapper allocates, then arrives on an integer
//   counter of its (row, kv head); the last to arrive combines the live
//   splits in split order: m = max m_i, o = sum e^(m_i - m) acc_i /
//   sum e^(m_i - m) l_i, holding up to 8 splits' values in registers with
//   every load in flight, staging (m, l) in shared memory beyond. A row with
//   no attended position gets zeros from its split 0. One launch, no
//   second kernel's start (a separate merge kernel cost 3.6 us at the
//   serving shape and 37 us at L8192 on the H100); every sum is taken
//   in a fixed order whichever block is last, with no float atomics, so
//   repeats are bit-identical. The counter wraps back to 0 at its last
//   arrival, ready for the next launch.
//
// Rounding follows the reference: scores and the softmax in f32, p (after
// the V scale) rounded to q's dtype before the p V product.

#include "common.cuh"
#include "hopper.cuh"

namespace {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;  // rows a warp stages: one key per lane
constexpr int kSplit = kWarps * kChunk;  // rows per split: one chunk per warp
constexpr int kMergeInRegisters = 8;  // live splits the merge holds in registers
}  // namespace

// Mirrors DecodeParams in ops/kernels/flash_decode.py (ctypes.Structure).
struct DecodeParams {
  const void* q;          // [B, 1, H, D], contiguous
  const void* k;          // [B, L, Hkv, D], contiguous
  const void* v;
  const float* k_scale;   // [B, L, Hkv] for int8 buffers, else null
  const float* v_scale;
  const int32_t* index;   // [B]
  void* o;                // [B, 1, H, D], q's dtype
  float* part_acc;        // [B, Hkv, n_split, G, D] workspace
  float* part_ml;         // [B, Hkv, n_split, G, 2] workspace: (m, l)
  uint32_t* counters;     // [B, Hkv] arrivals, zero between launches
  int32_t B, L, H, Hkv, D;
  int32_t window;         // 0 = none
  int32_t q_dtype, kv_dtype;
  int32_t n_split;        // ceil(L / kSplit)
  float scale;
};

// Shared-memory geometry of one block for head dim D and cache type T.
template <class T, int D>
struct Geometry {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  // Copy unit: 16 bytes, or 8 for int8 rows that are not a multiple of 16.
  static constexpr int kPiece = kRowBytes % 16 == 0 ? 16 : 8;
  // Row stride: an odd number of 16-byte units, so the 8 lanes of one
  // 16-byte shared load read 8 different bank groups.
  static constexpr int kUnits = (kRowBytes + 15) / 16;
  static constexpr int kStride = 16 * (kUnits % 2 ? kUnits : kUnits + 1);
  // One stage: K rows, V rows, K scales, V scales.
  static constexpr int kStageBytes = 2 * kChunk * kStride + 2 * kChunk * 4;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Query heads scored in one pass over a chunk: 1 for MHA, else 4.
__host__ __device__ inline int heads_per_pass(int G) { return G == 1 ? 1 : 4; }

// Per warp, in floats: p [heads per pass][kChunk], acc [G][D], m [G], l [G].
__host__ __device__ inline int warp_floats(int G, int D) {
  return round4(heads_per_pass(G) * kChunk + G * D + 2 * G);
}

// Block state in floats: q [G rounded up to the heads per pass][D], then
// each warp's.
__host__ __device__ inline int state_floats(int G, int D) {
  const int hp = heads_per_pass(G);
  return (G + hp - 1) / hp * hp * D + kWarps * warp_floats(G, D);
}

template <class T, int D>
static size_t decode_smem_bytes(int G, int n_split) {
  const size_t walk = sizeof(float) * state_floats(G, D) + (size_t)kWarps * Geometry<T, D>::kStageBytes;
  const size_t merge = sizeof(float) * (2 * (size_t)n_split * G + G);  // past kMergeInRegisters
  return walk > merge ? walk : merge;
}

// N bytes of T at p (aligned to N) as floats.
template <class T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int E = N / (int)sizeof(T);
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f32(e[i]);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f32(e[i]);
  }
}

// x rounded to T and back (p's rounding point before the p V product).
template <class T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block per (split, kv head, row): the split's partial (m, l, acc) into
// the workspace; the last block of a (row, kv head) to arrive merges them.
template <class TQ, class TKV, bool kQuant, int D, int kHeads>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeParams p) {
  using Geo = Geometry<TKV, D>;
  constexpr int kPieces = Geo::kRowBytes / Geo::kPiece;  // copy units per row
  constexpr int kElems = Geo::kPiece / (int)sizeof(TKV);  // elements per unit
  constexpr int kCols = (D + 31) / 32;                    // acc columns per lane

  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int L = p.L, Hkv = p.Hkv, G = p.H / Hkv;
  const int Gp = (G + kHeads - 1) / kHeads * kHeads;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t part0 = ((int64_t)b * Hkv + hk) * p.n_split;  // this (row, kv head)'s partials

  // Attended rows: [lo, hi] of the row, [r_lo, r_hi] of this split.
  const int idx = p.index[b];
  const int lo = p.window > 0 ? max(idx - p.window + 1, 0) : 0;
  const int hi = min(idx, L - 1);
  const int s0 = sp * kSplit;
  const int r_lo = max(lo, s0), r_hi = min(hi, s0 + kSplit - 1);
  // The row's live splits: [f_lo, f_lo + n_live).
  const int f_lo = lo / kSplit;
  const int n_live = idx < 0 || lo > hi ? 0 : hi / kSplit - f_lo + 1;
  if (r_lo > r_hi) {  // nothing to attend in this split
    if (n_live == 0 && sp == 0) {  // nor in the row: its output is zero
      TQ* o = static_cast<TQ*>(p.o) + ((int64_t)b * p.H + (int64_t)hk * G) * D;
      for (int i = tid; i < G * D; i += kThreads) o[i] = from_f32<TQ>(0.f);
    }
    return;
  }

  {  // This split's walk, into its partial.
    const int wf = warp_floats(G, D);
    float* sQ = smem;                           // [Gp][D], rows past G zero
    float* sP = smem + Gp * D + warp * wf;      // this warp's [kHeads][kChunk]
    float* sAcc = sP + kHeads * kChunk;         // [G][D]
    float* sM = sAcc + G * D;                   // [G]
    float* sL = sM + G;                         // [G]
    unsigned char* stage = reinterpret_cast<unsigned char*>(smem + state_floats(G, D)) +
                           (size_t)warp * Geo::kStageBytes;

    // This warp's chunk: rows r0 .. r0 + kChunk - 1 of the split, if any of
    // them is attended. Rows outside [r_lo, r_hi] are zero-filled and not
    // read. K (with the int8 scales) and V are two commit groups, so the
    // chunk is scored while its V rows land.
    const int r0 = s0 + warp * kChunk;
    const bool mine = r0 <= r_hi && r0 + kChunk - 1 >= r_lo;
    const TKV* k = static_cast<const TKV*>(p.k);
    const TKV* v = static_cast<const TKV*>(p.v);
    const int64_t row_stride = (int64_t)Hkv * D;
    const int64_t base = ((int64_t)b * L * Hkv + hk) * D;  // position 0 of this (b, hk)
    if (mine) {
      const uint32_t st = smem_u32(stage);
#pragma unroll
      for (int tensor = 0; tensor < 2; ++tensor) {
        const TKV* src = tensor == 0 ? k : v;
        const uint32_t dst0 = st + tensor * kChunk * Geo::kStride;
#pragma unroll 4
        for (int u = lane; u < kChunk * kPieces; u += 32) {
          const int row = u / kPieces, piece = u % kPieces;
          const int pos = r0 + row;
          const bool ok = pos >= r_lo && pos <= r_hi;
          const int64_t off = ok ? base + pos * row_stride + piece * kElems : base;
          const uint32_t dst = dst0 + row * Geo::kStride + piece * Geo::kPiece;
          if constexpr (Geo::kPiece == 16) cp_async16(dst, src + off, ok);
          else cp_async8(dst, src + off, ok);
        }
        if (kQuant && tensor == 0) {
          const int pos = r0 + lane;
          const bool ok = pos >= r_lo && pos <= r_hi;
          const int64_t off = ok ? ((int64_t)b * L + pos) * Hkv + hk : 0;
          const uint32_t dst = st + 2 * kChunk * Geo::kStride + lane * 4;
          cp_async4(dst, p.k_scale + off, ok);
          cp_async4(dst + kChunk * 4, p.v_scale + off, ok);
        }
        cp_async_commit();
      }
    }

    // q and this warp's state, while the chunk is in flight.
    const int64_t head0 = (int64_t)b * p.H + (int64_t)hk * G;  // first query head's row
    const TQ* q = static_cast<const TQ*>(p.q) + head0 * D;
    for (int i = tid; i < Gp * D; i += kThreads) sQ[i] = i < G * D ? to_f32(q[i]) : 0.f;
    for (int i = lane; i < G * D; i += 32) sAcc[i] = 0.f;
    for (int g = lane; g < G; g += 32) {
      sM[g] = kNegInf;
      sL[g] = 0.f;
    }
    __syncthreads();  // sQ complete

    if (mine) {
      cp_async_wait<1>();
      __syncwarp();  // every lane's K rows have landed
      const unsigned char* sV = stage + kChunk * Geo::kStride;
      const float* sKs = reinterpret_cast<const float*>(stage + 2 * kChunk * Geo::kStride);
      const int pos = r0 + lane;
      const bool valid = pos >= r_lo && pos <= r_hi;
      const float kscale = kQuant ? sKs[lane] : 1.f, vscale = kQuant ? sKs[kChunk + lane] : 1.f;
      const TKV* krow = reinterpret_cast<const TKV*>(stage + lane * Geo::kStride);

      for (int g0 = 0; g0 < G; g0 += kHeads) {
        // This lane's key against query heads g0 .. g0 + kHeads - 1.
        float s[kHeads][2];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) s[h][0] = s[h][1] = 0.f;
#pragma unroll
        for (int t = 0; t < D / kElems; ++t) {
          float kv[kElems];
          load_f32<TKV, Geo::kPiece>(krow + t * kElems, kv);
#pragma unroll
          for (int e = 0; e < kElems; e += 4) {
#pragma unroll
            for (int h = 0; h < kHeads; ++h) {
              const float4 qv = *reinterpret_cast<const float4*>(sQ + (g0 + h) * D + t * kElems + e);
              s[h][0] = fmaf(qv.x, kv[e], s[h][0]);
              s[h][1] = fmaf(qv.y, kv[e + 1], s[h][1]);
              s[h][0] = fmaf(qv.z, kv[e + 2], s[h][0]);
              s[h][1] = fmaf(qv.w, kv[e + 3], s[h][1]);
            }
          }
        }
        // The chunk's softmax for each head (at least one of its keys is
        // attended, so m is finite); p, the V scale folded in and rounded to
        // q's dtype, to this warp's sP.
        float m[kHeads], l[kHeads];
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          float sh = (s[h][0] + s[h][1]) * p.scale;
          if (kQuant) sh *= kscale;
          sh = valid ? sh : kNegInf;
          m[h] = warp_max(sh);
          const float ph = expf(sh - m[h]);  // 0 for a masked key
          l[h] = warp_sum(ph);
          sP[h * kChunk + lane] = round_to<TQ>(ph * vscale);
        }
        cp_async_wait<0>();
        __syncwarp();  // V rows landed; sP written
        float a[kHeads][kCols] = {};
#pragma unroll 2
        for (int j = 0; j < kChunk; j += 4) {
          float4 pp[kHeads];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) pp[h] = *reinterpret_cast<const float4*>(sP + h * kChunk + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const TKV* vrow = reinterpret_cast<const TKV*>(sV + (j + jj) * Geo::kStride);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const int d = lane + 32 * c;
              if (D % 32 == 0 || d < D) {
                const float vd = to_f32(vrow[d]);
#pragma unroll
                for (int h = 0; h < kHeads; ++h) a[h][c] = fmaf(lane_of(pp[h], jj), vd, a[h][c]);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          if (g0 + h >= G) break;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int d = lane + 32 * c;
            if (D % 32 == 0 || d < D) sAcc[(g0 + h) * D + d] = a[h][c];
          }
          if (lane == 0) {
            sM[g0 + h] = m[h];
            sL[g0 + h] = l[h];
          }
        }
        __syncwarp();  // every lane has read sP before the next heads' p
      }
    }
    __syncthreads();  // every warp's state complete

    // Combine the warps' states, in warp order, into this split's partial.
    const float* w0 = smem + Gp * D + kHeads * kChunk;  // warp 0's acc
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float m = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* sw = w0 + w * wf;
        if (sw[G * D + G + g] > 0.f) m = fmaxf(m, sw[G * D + g]);
      }
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* sw = w0 + w * wf;
        const float lw = sw[G * D + G + g];
        if (lw > 0.f) {
          const float f = expf(sw[G * D + g] - m);
          acc = fmaf(f, sw[i], acc);
          l = fmaf(f, lw, l);
        }
      }
      p.part_acc[(part0 + sp) * G * D + i] = acc;
      if (i % D == 0) {
        p.part_ml[((part0 + sp) * G + g) * 2] = m;
        p.part_ml[((part0 + sp) * G + g) * 2 + 1] = l;
      }
    }
  }

  // Arrive. atomicInc wraps the counter back to 0 at the n_live-th arrival,
  // which is the last live block's: it alone goes on to merge.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(p.counters + (int64_t)b * Hkv + hk, n_live - 1) == (uint32_t)(n_live - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Merge the live splits in split order: m = max m_i, o = sum e^(m_i - m)
  // acc_i / sum e^(m_i - m) l_i. Every live split has l >= 1.
  const int64_t first = part0 + f_lo;
  TQ* o = static_cast<TQ*>(p.o) + ((int64_t)b * p.H + (int64_t)hk * G) * D;
  if (n_live <= kMergeInRegisters) {
    // Few splits: each thread takes one output element, all its loads in
    // flight at once.
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const float* ml = p.part_ml + (first * G + g) * 2;  // split s at + 2 G s
      const float* src = p.part_acc + first * G * D + i;   // split s at + G D s
      float mi[kMergeInRegisters], li[kMergeInRegisters], ai[kMergeInRegisters];
      float m = kNegInf;
#pragma unroll
      for (int s = 0; s < kMergeInRegisters; ++s)
        if (s < n_live) {
          mi[s] = __ldcg(ml + s * 2 * G);
          li[s] = __ldcg(ml + s * 2 * G + 1);
          ai[s] = __ldcg(src + (int64_t)s * G * D);
          m = fmaxf(m, mi[s]);
        }
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int s = 0; s < kMergeInRegisters; ++s)
        if (s < n_live) {
          const float f = expf(mi[s] - m);
          acc = fmaf(f, ai[s], acc);
          l = fmaf(f, li[s], l);
        }
      o[i] = from_f32<TQ>(acc / l);
    }
    return;
  }
  // Many splits: (m, l) staged in shared memory, the weights e^(m_i - m)
  // computed once per (split, head) by a warp per head.
  float* mw = smem;             // [n_live][G]: m, then the weights
  float* ll = mw + n_live * G;  // [n_live][G]
  float* den = ll + n_live * G; // [G]
  for (int t = tid; t < n_live * G; t += kThreads) {
    mw[t] = __ldcg(p.part_ml + (first * G + t) * 2);
    ll[t] = __ldcg(p.part_ml + (first * G + t) * 2 + 1);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int s = lane; s < n_live; s += 32) m = fmaxf(m, mw[s * G + g]);
    m = warp_max(m);
    float d = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float w = expf(mw[s * G + g] - m);
      mw[s * G + g] = w;
      d = fmaf(w, ll[s * G + g], d);
    }
    d = warp_sum(d);
    if (lane == 0) den[g] = d;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const float* src = p.part_acc + first * G * D + i;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) acc = fmaf(mw[s * G + g], __ldcg(src + (int64_t)s * G * D), acc);
    o[i] = from_f32<TQ>(acc / den[g]);
  }
}

template <class TQ, class TKV, bool kQuant>
static cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const int G = p.H / p.Hkv;
    const size_t smem = decode_smem_bytes<TKV, D>(G, p.n_split);
    auto* kernel = G == 1 ? decode_kernel<TQ, TKV, kQuant, D, 1> : decode_kernel<TQ, TKV, kQuant, D, 4>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return;
    kernel<<<dim3(p.n_split, p.Hkv, p.B), kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
  });
  return err;
}

extern "C" int flash_decode(const DecodeParams* params, void* stream) {
  const DecodeParams& p = *params;
  if (p.Hkv < 1 || p.H % p.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (p.n_split != (p.L + kSplit - 1) / kSplit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.q_dtype == DT_F32 && p.kv_dtype == DT_F32) return (int)launch<float, float, false>(p, s);
  if (p.q_dtype == DT_BF16 && p.kv_dtype == DT_BF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, false>(p, s);
  if (p.q_dtype == DT_F32 && p.kv_dtype == DT_I8) return (int)launch<float, int8_t, true>(p, s);
  if (p.q_dtype == DT_BF16 && p.kv_dtype == DT_I8)
    return (int)launch<__nv_bfloat16, int8_t, true>(p, s);
  return (int)cudaErrorInvalidValue;
}
