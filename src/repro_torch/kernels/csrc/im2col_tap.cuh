// The IM2COL unit's shifted view of an NHWC input: A[m, k] of the implicit
// GEMM, M = N*Ho*Wo output pixels, K = kh*kw*C ordered (dy, dx, c). Read
// from the unpadded input with bounds checks, zero outside the image
// (implicit SAME or explicit padding). The dense stem (im2col_conv.cu) and
// the per-column sparse conv (vdbb_conv_bw.cu) take their left operand here.
#pragma once

#include <cstddef>

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
