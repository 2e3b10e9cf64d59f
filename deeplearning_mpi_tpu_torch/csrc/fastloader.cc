// Native data-loader core: fused, multithreaded batch augmentation on the host.
//
// Port of deeplearning_mpi_tpu/native_src/fastloader.cc, the counterpart of
// the reference's native input machinery (torch DataLoader worker pools:
// num_workers=15 at pytorch/resnet/main.py:100, os.cpu_count()//2 at
// pytorch/unet/train.py:92). One pass over a whole uint8 NHWC batch does
// pad + crop + flip + normalize and writes float32 ready for the card.
//
// The normalization is the numpy transform's arithmetic, in its order and
// in float32: x = u8 / 255, then (x - mean) / std (data/cifar10.py's
// _normalize). The reference's library folds it into u8 * scale + bias,
// which rounds differently (within 1e-6); here the outputs are bitwise the
// numpy path's, so a run's batches do not depend on which path ran. Build
// without -ffast-math (data/native.py's command sets -ffp-contract=off).
//
// Built at first use by deeplearning_mpi_tpu_torch/data/native.py with g++
// into build/native/ (compiler/cache.py), driven through ctypes: plain C
// ABI, raw pointers and ints, no Python.h.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Run fn(first, last) over [0, n) chunks on up to max_threads threads.
void parallel_for(int n, int max_threads, void (*fn)(int, int, void*), void* ctx) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int threads = std::max(1, std::min({max_threads, std::max(hw, 1), n}));
  if (threads == 1) {
    fn(0, n, ctx);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  int chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int first = t * chunk;
    int last = std::min(n, first + chunk);
    if (first >= last) break;
    pool.emplace_back(fn, first, last, ctx);
  }
  for (auto& th : pool) th.join();
}

inline float normalize_u8(uint8_t v, float mean, float std) {
  const float x = static_cast<float>(v) / 255.0f;
  return (x - mean) / std;
}

struct CropCtx {
  const uint8_t* in;    // [N, H, W, C]
  const int32_t* ys;    // [N] crop offsets in the padded image
  const int32_t* xs;    // [N]
  const uint8_t* flip;  // [N] 1 = horizontal flip
  const float* mean;    // [C]
  const float* std;     // [C]
  float* out;           // [N, H, W, C]
  int h, w, c, pad;
};

// One image: an h x w window at (y - pad, x - pad) of the zero-padded input,
// optionally flipped horizontally, then normalized; no padded intermediate.
void crop_flip_normalize_range(int first, int last, void* vctx) {
  const CropCtx& k = *static_cast<CropCtx*>(vctx);
  const int h = k.h, w = k.w, c = k.c, pad = k.pad;
  for (int i = first; i < last; ++i) {
    const uint8_t* img = k.in + static_cast<int64_t>(i) * h * w * c;
    float* dst = k.out + static_cast<int64_t>(i) * h * w * c;
    const int y0 = k.ys[i] - pad;
    const int x0 = k.xs[i] - pad;
    const bool flip = k.flip[i] != 0;
    for (int y = 0; y < h; ++y) {
      const int sy = y0 + y;
      const bool row_in = sy >= 0 && sy < h;
      for (int x = 0; x < w; ++x) {
        const int dx = flip ? (w - 1 - x) : x;
        float* px = dst + (static_cast<int64_t>(y) * w + dx) * c;
        const int sx = x0 + x;
        if (row_in && sx >= 0 && sx < w) {
          const uint8_t* sp = img + (static_cast<int64_t>(sy) * w + sx) * c;
          for (int ch = 0; ch < c; ++ch) px[ch] = normalize_u8(sp[ch], k.mean[ch], k.std[ch]);
        } else {
          for (int ch = 0; ch < c; ++ch) px[ch] = normalize_u8(0, k.mean[ch], k.std[ch]);
        }
      }
    }
  }
}

struct NormCtx {
  const uint8_t* in;
  const float* mean;
  const float* std;
  float* out;
  int64_t pixels;  // h * w per image
  int c;
};

void normalize_range(int first, int last, void* vctx) {
  const NormCtx& k = *static_cast<NormCtx*>(vctx);
  for (int i = first; i < last; ++i) {
    const uint8_t* src = k.in + i * k.pixels * k.c;
    float* dst = k.out + i * k.pixels * k.c;
    for (int64_t p = 0; p < k.pixels; ++p)
      for (int ch = 0; ch < k.c; ++ch, ++src, ++dst) *dst = normalize_u8(*src, k.mean[ch], k.std[ch]);
  }
}

}  // namespace

extern "C" {

// RandomCrop(pad) + RandomHorizontalFlip + normalize, fused. Offsets ys/xs
// are in [0, 2 * pad]: the window's position in the padded image, as
// torchvision's RandomCrop(32, padding=4) (pytorch/resnet/main.py:82-87).
void fl_crop_flip_normalize(const uint8_t* in, int n, int h, int w, int c, const int32_t* ys,
                            const int32_t* xs, const uint8_t* flip, int pad, const float* mean,
                            const float* std, float* out, int max_threads) {
  CropCtx ctx{in, ys, xs, flip, mean, std, out, h, w, c, pad};
  parallel_for(n, max_threads, crop_flip_normalize_range, &ctx);
}

// Normalize only: the eval transform (pytorch/resnet/main.py:88).
void fl_normalize(const uint8_t* in, int n, int h, int w, int c, const float* mean,
                  const float* std, float* out, int max_threads) {
  NormCtx ctx{in, mean, std, out, static_cast<int64_t>(h) * w, c};
  parallel_for(n, max_threads, normalize_range, &ctx);
}

int fl_version(void) { return 2; }

}  // extern "C"
