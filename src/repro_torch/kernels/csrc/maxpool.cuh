// Max-pool over NHWC, int8 codes or fp32: ResNet's 3 x 3 stride-2 pool after
// the stem, a kernel of its own beside the stem's (entry maxpool_nhwc in
// im2col_conv.cu).
//
// No TPU kernel stood here: the JAX package's CNN has no pooling layer but
// the global mean. On the int8-resident chain the pool reads the stem's int8
// codes and writes int8 codes at the same scale: max commutes with the
// monotone requantize (round half to even, then clip), so pooling the codes
// equals requantizing the pooled fp32 outputs, exactly, and the stem keeps
// its fused requantize.
//
// Bound on an H100 at ResNet-50 batch 64 (112 x 112 x 64 codes in, 56 x 56 x
// 64 out): bytes, 51 MB read and 13 MB written, about 19 us at 3.35 TB/s.
// What the design does about it: a thread takes one output pixel's run of 16
// channels (int8: one 16-byte vector, the byte-wise signed max __vmaxs4 on
// its four words; fp32: four float4s), walks the window's in-image taps and
// writes one vector; neighbouring threads take neighbouring runs of one
// pixel, then neighbouring pixels of a row, so a warp's loads and stores are
// contiguous. Padding is never read: a window's taps outside the image are
// skipped (the reference pads with -inf), and every window of a pad below
// the kernel holds at least one in-image tap.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace maxpool {

constexpr int THREADS = 256;
constexpr int RUN = 16;  // channels a thread

struct Geometry {
  int n, h, w, c, ho, wo, k, s, pad;
};

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

// NaN wins, as in the reference's max
__device__ __forceinline__ float fmax_nan(float a, float b) { return (a > b || a != a) ? a : b; }

template <typename T>
struct Run;

template <>
struct Run<int8_t> {
  uint4 v;
  __device__ __forceinline__ static Run lowest() {
    return {make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u)};
  }
  __device__ __forceinline__ void take(const int8_t* p) {
    v = vmax(v, __ldg(reinterpret_cast<const uint4*>(p)));
  }
  __device__ __forceinline__ void store(int8_t* p) const { *reinterpret_cast<uint4*>(p) = v; }
};

template <>
struct Run<float> {
  float v[RUN];
  __device__ __forceinline__ static Run lowest() {
    Run r;
#pragma unroll
    for (int i = 0; i < RUN; ++i) r.v[i] = -__int_as_float(0x7f800000);
    return r;
  }
  __device__ __forceinline__ void take(const float* p) {
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = fmax_nan(x.x, v[4 * q]);
      v[4 * q + 1] = fmax_nan(x.y, v[4 * q + 1]);
      v[4 * q + 2] = fmax_nan(x.z, v[4 * q + 2]);
      v[4 * q + 3] = fmax_nan(x.w, v[4 * q + 3]);
    }
  }
  __device__ __forceinline__ void store(float* p) const {
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) kernel(const T* __restrict__ x, T* __restrict__ out,
                                                  Geometry g) {
  const int runs = g.c / RUN;
  const long long total = (long long)g.n * g.ho * g.wo * runs;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const int r = static_cast<int>(e % runs);
    const long long pix = e / runs;
    const int ox = static_cast<int>(pix % g.wo);
    const long long rest = pix / g.wo;
    const int oy = static_cast<int>(rest % g.ho);
    const int img = static_cast<int>(rest / g.ho);
    const int iy0 = oy * g.s - g.pad, ix0 = ox * g.s - g.pad;
    Run<T> acc = Run<T>::lowest();
    for (int dy = 0; dy < g.k; ++dy) {
      const int iy = iy0 + dy;
      if (iy < 0 || iy >= g.h) continue;
      for (int dx = 0; dx < g.k; ++dx) {
        const int ix = ix0 + dx;
        if (ix < 0 || ix >= g.w) continue;
        acc.take(x + (((size_t)img * g.h + iy) * g.w + ix) * g.c + r * RUN);
      }
    }
    acc.store(out + pix * g.c + r * RUN);
  }
}

// in_kind: 0 int8 codes, 1 fp32 (os_gemm.cuh's InKind). Refuses C not a
// multiple of 16, a pointer not 16-byte aligned, and a pad of the kernel or
// more (a window could hold no in-image tap).
inline cudaError_t launch(const void* x, void* out, int in_kind, int n, int h, int w, int c,
                          int ho, int wo, int k, int s, int pad, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n <= 0 || ho <= 0 || wo <= 0 || k <= 0 || s <= 0 || pad < 0 || pad >= k ||
      c % RUN != 0 || !aligned(x) || !aligned(out))
    return cudaErrorInvalidValue;
  const Geometry g{n, h, w, c, ho, wo, k, s, pad};
  const long long total = (long long)n * ho * wo * (c / RUN);
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  if (in_kind == 0)
    kernel<int8_t><<<blocks, THREADS, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<int8_t*>(out), g);
  else if (in_kind == 1)
    kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), g);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace maxpool
