// K4: flash-decode for Hopper (sm_90a).
//
// Replaces deeplearning_mpi_tpu/ops/pallas/flash_decode.py::_decode_kernel
// (launched by flash_decode). One query token per row over a grouped KV
// cache [B, L, Hkv, D] with a per-row fill level index[B]: row b attends
// positions max(index-window+1, 0) .. index[b]; index < 0 marks an inactive
// row, whose output is zero. Grouped-query heads are consumed natively
// (query head i reads kv head i / group, the order repeat_kv uses). int8
// K/V carry per-(token, head) float32 scales, factored out of both dots:
// K scales multiply the scores after the dot, V scales fold into p before
// the V dot.
//
// What bounds it on an H100: memory. Each (row, kv head) reads its filled
// K and V rows once and does 4*group flops per element read — far below
// the ~20 flops/byte float32 balance point — so the bound is the filled
// cache bytes over 3.35 TB/s. The design reads only [window start, index]
// of each row, never a row past index[b] (the TPU kernel's clamped index
// map, here as loop bounds).
//
// Design: one thread block (4 warps) per (kv head, batch row). It walks its
// row's range in chunks of CH positions staged in shared memory as float32
// (padded rows: lane j reads key row j without bank conflicts). The next
// chunk's K/V rows are loaded into registers (8-element vector loads, all
// in flight at once) while the current chunk is scored, so memory latency
// overlaps the math. Each warp owns query heads g = warp, warp+4, ... of
// the group: lanes score CH/32 keys each, the online-softmax max and sum
// are warp shuffles, and the accumulator [group, D] lives in shared memory,
// each lane owning columns lane, lane+32, ... The head dim is a template
// parameter (every multiple of 8 up to 128), so every loop is unrolled.
//
// Known limit, first thing a later redesign fixes: at 8 serving slots x 12
// kv heads the grid has 96 blocks for 132 SMs, and each block walks its row
// alone — split the walk over several blocks per row (split-K with a merge
// pass) so short batches fill the card.

#include "common.cuh"

namespace {
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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
  int32_t B, L, H, Hkv, D;
  int32_t window;         // 0 = none
  int32_t q_dtype, kv_dtype;
  float scale;
};

// Positions per chunk: 64, or 32 for head dims above 64 (bounds the
// registers that hold the next chunk in flight).
template <int D> __host__ __device__ constexpr int chunk_rows() { return D <= 64 ? 64 : 32; }

template <int D>
static size_t decode_smem_bytes(int G) {
  constexpr int CH = chunk_rows<D>();
  return sizeof(float) * (size_t)(2 * G * D + 2 * CH * (D + 1) + G * CH + 2 * G + 2 * CH);
}

template <class TQ, class TKV, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeParams p) {
  constexpr int CH = chunk_rows<D>();
  constexpr int DP = D + 1;
  constexpr int KPL = CH / 32;                    // keys per lane
  constexpr int UNITS = CH * D / 8;               // 8-element loads per chunk per tensor
  constexpr int UPT = (UNITS + kThreads - 1) / kThreads;  // per thread
  constexpr int COLS = (D + 31) / 32;             // accumulator columns per lane

  extern __shared__ float smem[];
  const int L = p.L, Hkv = p.Hkv, G = p.H / Hkv;
  float* sQ = smem;                 // [G][D]
  float* sAcc = sQ + G * D;         // [G][D]
  float* sK = sAcc + G * D;         // [CH][DP]
  float* sV = sK + CH * DP;         // [CH][DP]
  float* sP = sV + CH * DP;         // [G][CH]
  float* sM = sP + G * CH;          // [G]
  float* sL = sM + G;               // [G]
  float* sKs = sL + G;              // [CH]
  float* sVs = sKs + CH;            // [CH]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head0 = (int64_t)b * p.H + (int64_t)hk * G;  // first query head's row
  TQ* o = static_cast<TQ*>(p.o) + head0 * D;
  const int idx = p.index[b];
  if (idx < 0) {  // inactive row
    for (int i = tid; i < G * D; i += kThreads) o[i] = from_f32<TQ>(0.f);
    return;
  }
  const int hi = min(idx, L - 1);
  const int lo = p.window > 0 ? max(idx - p.window + 1, 0) : 0;

  const TQ* q = static_cast<const TQ*>(p.q) + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    sQ[i] = to_f32(q[i]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  const TKV* k = static_cast<const TKV*>(p.k);
  const TKV* v = static_cast<const TKV*>(p.v);
  const int64_t row_stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * L * Hkv + hk) * D;  // position 0 of this (b, hk)

  // Registers holding one chunk in flight; rows past hi load as zeros.
  Vec8<TKV> rk[UPT], rv[UPT];
  float rks = 0.f, rvs = 0.f;
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * kThreads;
      const int row = u / (D / 8), col = (u % (D / 8)) * 8;
      if (u < UNITS && c0 + row <= hi) {
        const int64_t off = base + (int64_t)(c0 + row) * row_stride + col;
        rk[i].load(k + off);
        rv[i].load(v + off);
      } else {
        rk[i].zero();
        rv[i].zero();
      }
    }
    if (kQuant && tid < CH) {
      const bool in = c0 + tid <= hi;
      const int64_t off = ((int64_t)b * L + c0 + tid) * Hkv + hk;
      rks = in ? p.k_scale[off] : 0.f;
      rvs = in ? p.v_scale[off] : 0.f;
    }
  };
  if (lo <= hi) fetch(lo);

  for (int c0 = lo; c0 <= hi; c0 += CH) {
    const int n = min(CH, hi - c0 + 1);  // filled rows in this chunk
    __syncthreads();  // previous chunk fully consumed (and init visible)
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * kThreads;
      if (u < UNITS) {
        const int row = u / (D / 8), col = (u % (D / 8)) * 8;
        float tmp[8];
        rk[i].to_f32(tmp);
#pragma unroll
        for (int e = 0; e < 8; ++e) sK[row * DP + col + e] = tmp[e];
        rv[i].to_f32(tmp);
#pragma unroll
        for (int e = 0; e < 8; ++e) sV[row * DP + col + e] = tmp[e];
      }
    }
    if (kQuant && tid < CH) {
      sKs[tid] = rks;
      sVs[tid] = rvs;
    }
    __syncthreads();
    if (c0 + CH <= hi) fetch(c0 + CH);  // next chunk in flight during the math

    for (int g = warp; g < G; g += kWarps) {
      const float* qg = sQ + g * D;
      float s[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[j] = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float qd = qg[d];
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[j] = fmaf(qd, sK[(lane + 32 * j) * DP + d], s[j]);
      }
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int key = lane + 32 * j;
        s[j] *= p.scale;
        if (kQuant) s[j] *= sKs[key];
        s[j] = key < n ? s[j] : kNegInf;
        tmax = fmaxf(tmax, s[j]);
      }
      const float m_old = sM[g], l_old = sL[g];
      const float m_new = fmaxf(m_old, warp_max(tmax));
      const float alpha = expf(m_old - m_new);
      float psum = 0.f;
      float* pg = sP + g * CH;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int key = lane + 32 * j;
        // Masked keys are re-zeroed: with the finite mask a fully masked
        // chunk would otherwise give exp(0) = 1.
        float pj = key < n ? expf(s[j] - m_new) : 0.f;
        psum += pj;
        if (kQuant) pj *= sVs[key];
        pg[key] = pj;
      }
      const float l_new = l_old * alpha + warp_sum(psum);
      __syncwarp();  // p visible to the whole warp; sM/sL reads done
      float* acc = sAcc + g * D;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (D % 32 == 0 || d < D) {
          float a = acc[d] * alpha;
#pragma unroll 16
          for (int j = 0; j < CH; ++j) a = fmaf(pg[j], sV[j * DP + d], a);
          acc[d] = a;
        }
      }
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = l_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = sL[i / D];
    o[i] = from_f32<TQ>(l > 0.f ? sAcc[i] / l : 0.f);
  }
}

template <class TQ, class TKV, bool kQuant>
static cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_head_dim(p.D, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const size_t smem = decode_smem_bytes<D>(p.H / p.Hkv);
    auto* kernel = decode_kernel<TQ, TKV, kQuant, D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return;
    kernel<<<dim3(p.Hkv, p.B), kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
  });
  return err;
}

extern "C" int flash_decode(const DecodeParams* params, void* stream) {
  const DecodeParams& p = *params;
  if (p.Hkv < 1 || p.H % p.Hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.q_dtype == DT_F32 && p.kv_dtype == DT_F32) return (int)launch<float, float, false>(p, s);
  if (p.q_dtype == DT_BF16 && p.kv_dtype == DT_BF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, false>(p, s);
  if (p.q_dtype == DT_F32 && p.kv_dtype == DT_I8) return (int)launch<float, int8_t, true>(p, s);
  if (p.q_dtype == DT_BF16 && p.kv_dtype == DT_I8)
    return (int)launch<__nv_bfloat16, int8_t, true>(p, s);
  return (int)cudaErrorInvalidValue;
}
