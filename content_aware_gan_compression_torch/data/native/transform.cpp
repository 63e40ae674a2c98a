// Native batch image transform for the training data path (the same source
// as the JAX package's data/native/transform.cpp, so the two libraries give
// the same bits).
//
// The reference feeds torch DataLoader workers through PIL + torchvision
// transforms (reference train.py:463-477); here the post-decode hot path —
// horizontal flip, antialiased bilinear resize, [-1,1] normalization, and
// HWC->CHW layout — is one multithreaded C++ pass on the host.
//
// The resize implements PIL's antialiased triangle filter (Image.BILINEAR):
// support = max(scale, 1), weights w(d) = 1 - |d|/support, separable
// horizontal-then-vertical passes, matching Image.resize((s, s), BILINEAR)
// to ~1e-2 absolute (PIL quantizes intermediates to uint8; we keep float).
//
// Built at first use with g++ -O3 -shared (data/native_loader.py) and called
// through ctypes. A failed build raises: there is no other float path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Taps {
  std::vector<int> lo;      // first source index per output position
  std::vector<int> count;   // number of taps
  std::vector<float> w;     // weights, max_taps stride
  int max_taps;
};

Taps build_taps(int in_size, int out_size) {
  Taps t;
  double scale = static_cast<double>(in_size) / out_size;
  double support = std::max(scale, 1.0);  // triangle filter, antialiased
  int max_taps = static_cast<int>(std::ceil(support * 2.0)) + 2;
  t.lo.resize(out_size);
  t.count.resize(out_size);
  t.w.assign(static_cast<size_t>(out_size) * max_taps, 0.0f);
  t.max_taps = max_taps;
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, static_cast<int>(std::floor(center - support + 0.5)));
    int hi = std::min(in_size, static_cast<int>(std::floor(center + support + 0.5)));
    double total = 0.0;
    int n = hi - lo;
    for (int k = 0; k < n; ++k) {
      double d = (lo + k + 0.5 - center) / support;
      double wk = 1.0 - std::abs(d);
      if (wk < 0.0) wk = 0.0;
      t.w[static_cast<size_t>(i) * max_taps + k] = static_cast<float>(wk);
      total += wk;
    }
    if (total > 0.0) {
      for (int k = 0; k < n; ++k)
        t.w[static_cast<size_t>(i) * max_taps + k] /=
            static_cast<float>(total);
    }
    t.lo[i] = lo;
    t.count[i] = n;
  }
  return t;
}

// One image: [in_h, in_w, 3] uint8 -> [3, out, out] float in [-1, 1].
void transform_one(const uint8_t* src, int in_h, int in_w, int out_size,
                   bool flip, const Taps& tx, const Taps& ty, float* dst,
                   float* tmp /* [in_h * out_size * 3] */) {
  // horizontal pass (with optional flip folded into the source index)
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    float* trow = tmp + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      int lo = tx.lo[x], n = tx.count[x];
      const float* w = &tx.w[static_cast<size_t>(x) * tx.max_taps];
      for (int k = 0; k < n; ++k) {
        int sx = lo + k;
        if (flip) sx = in_w - 1 - sx;
        const uint8_t* px = row + static_cast<size_t>(sx) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass + normalize + CHW
  size_t plane = static_cast<size_t>(out_size) * out_size;
  for (int y = 0; y < out_size; ++y) {
    int lo = ty.lo[y], n = ty.count[y];
    const float* w = &ty.w[static_cast<size_t>(y) * ty.max_taps];
    for (int x = 0; x < out_size; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float* px =
            tmp + (static_cast<size_t>(lo + k) * out_size + x) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      size_t o = static_cast<size_t>(y) * out_size + x;
      dst[0 * plane + o] = acc[0] / 127.5f - 1.0f;
      dst[1 * plane + o] = acc[1] / 127.5f - 1.0f;
      dst[2 * plane + o] = acc[2] / 127.5f - 1.0f;
    }
  }
}

}  // namespace

extern "C" {

// src: n contiguous [in_h, in_w, 3] uint8 images; flips: n bytes (0/1);
// dst: n contiguous [3, out_size, out_size] float32 images.
void cagc_transform_batch(const uint8_t* src, int n, int in_h, int in_w,
                          int out_size, const uint8_t* flips, float* dst,
                          int num_threads) {
  Taps tx = build_taps(in_w, out_size);
  Taps ty = build_taps(in_h, out_size);
  size_t src_stride = static_cast<size_t>(in_h) * in_w * 3;
  size_t dst_stride = static_cast<size_t>(out_size) * out_size * 3;
  if (num_threads < 1) num_threads = 1;
  num_threads = std::min(num_threads, n);

  auto worker = [&](int t) {
    std::vector<float> tmp(static_cast<size_t>(in_h) * out_size * 3);
    for (int i = t; i < n; i += num_threads) {
      transform_one(src + i * src_stride, in_h, in_w, out_size,
                    flips[i] != 0, tx, ty, dst + i * dst_stride, tmp.data());
    }
  };
  if (num_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
