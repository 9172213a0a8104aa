// The IM2COL unit's shifted view of an NHWC input: A[m, k] of the implicit
// GEMM, M = N*Ho*Wo output pixels, K = kh*kw*C ordered (dy, dx, c). Read
// from the unpadded input with bounds checks, zero outside the image
// (implicit SAME or explicit padding). The dense stem (im2col_conv.cu) and
// the per-column sparse conv's fp32 instantiation (vdbb_conv_bw.cu) take
// their left operand element by element here (`Tap`); the per-column conv's
// int8 instantiation takes it in chunks (`TapChunks`).
#pragma once

#include <cstddef>
#include <cstdint>

template <typename T>
struct Tap {
  const T* x;
  int h, w, c, ho, wo, sh, sw, pt, pl, kw;

  __device__ __forceinline__ T operator()(int m, int k) const {
    const int t = k / c;
    const int ch = k - t * c;
    const int dy = t / kw, dx = t - dy * kw;
    const int ox = m % wo;
    const int r = m / wo;
    const int oy = r % ho, n = r / ho;
    const int iy = oy * sh - pt + dy, ix = ox * sw - pl + dx;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) return T(0);
    return x[(((size_t)n * h + iy) * w + ix) * c + ch];
  }
};

// The same view as the int8 tensor-core path's stager of A (os_mma.cuh), in
// chunks of CH bytes along K. Because C % CH == 0, a chunk lies inside one
// tap: a thread's chunk column k resolves its tap and channel once (`at`),
// for all the rows it copies, and moves from stage to stage without a
// division (`advance`); each tile row resolves its (image, oy, ox) once per
// tile (`row`). A chunk outside the image or past M is
// reported invalid (copied with src-size 0: zeros).
struct TapChunks {
  static constexpr bool kRegisters = false;  // cp.async chunks (os_mma.cuh)
  const int8_t* x;
  int h, w, c, ho, wo, sh, sw, pt, pl, kw;

  struct Row {
    long long base;  // offset of input pixel (image, iy0, ix0), tap (0, 0)
    int iy0, ix0;
    bool ok;
  };

  struct At {
    long long off;  // offset of channel ch of tap (dy, dx) from the tap (0, 0) pixel
    int dy, dx, ch;
  };

  __device__ __forceinline__ Row row(int m, int M) const {
    Row r{0, 0, 0, m < M};
    if (r.ok) {
      const int ox = m % wo;
      const int t = m / wo;
      const int oy = t % ho, n = t / ho;
      r.iy0 = oy * sh - pt;
      r.ix0 = ox * sw - pl;
      r.base = (((long long)n * h + r.iy0) * w + r.ix0) * c;
    }
    return r;
  }

  __device__ __forceinline__ At at(int k) const {
    const int t = k / c;
    const int ch = k - t * c;
    const int dy = t / kw, dx = t - dy * kw;
    return At{((long long)dy * w + dx) * c + ch, dy, dx, ch};
  }

  __device__ __forceinline__ void advance(At& a, int step) const {
    a.ch += step;
    while (a.ch >= c) {
      a.ch -= c;
      if (++a.dx == kw) {
        a.dx = 0;
        ++a.dy;
      }
    }
    a.off = ((long long)a.dy * w + a.dx) * c + a.ch;
  }

  __device__ __forceinline__ const int8_t* chunk(const Row& r, const At& a, bool& ok) const {
    const int iy = r.iy0 + a.dy, ix = r.ix0 + a.dx;
    ok = ok && r.ok && iy >= 0 && iy < h && ix >= 0 && ix < w;
    return ok ? x + r.base + a.off : x;
  }
};
