// Fused IM2COL x VDBB convolution, one sparsity pattern shared across F.
//
// Replaces repro/kernels/vdbb_im2col_conv.py:_vdbb_conv_tc_kernel (launched
// by _launch). The conv is an implicit GEMM over the compressed reduction:
// M = N*Ho*Wo output pixels, K_c = kh*kw*(C/bz)*nnz, N = F. The compressed
// column k belongs to block b = k / nnz = t*cb + c/bz of tap t = (dy, dx);
// it reads input channel c = (b % cb)*bz + idx[k] of the pixel that tap sees
// (the IM2COL unit's shifted view and the VDBB activation mux in one load),
// zero outside the image (implicit SAME/explicit padding). Values are the
// (K_c, F) row-major int8 or fp32 stream; int8 accumulates exactly in int32.
// The TPU's halo tiling only bounded VMEM, so it is gone.
//
// Bound on an H100 at sparse-cnn-s batch 64: the early layers move more bytes
// (int8 activations in and out) than their int8 MACs need time, the deep
// ones are bound by operations at nnz/bz of the dense MACs. This first
// version does int32 multiply-adds on the CUDA cores, not the tensor cores,
// so it runs far below either bound.
#include "os_gemm.cuh"

template <typename T>
struct GatherTap {
  const T* x;
  const int8_t* idx;  // (K_c,) intra-block positions, pattern shared by all F
  int h, w, c, ho, wo, sh, sw, pt, pl, kw, cb, nnz, bz;

  __device__ __forceinline__ T operator()(int m, int k) const {
    const int blk = k / nnz;
    const int t = blk / cb;
    const int ch = (blk - t * cb) * bz + idx[k];
    const int dy = t / kw, dx = t - dy * kw;
    const int ox = m % wo;
    const int r = m / wo;
    const int oy = r % ho, n = r / ho;
    const int iy = oy * sh - pt + dy, ix = ox * sw - pl + dx;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) return T(0);
    return x[(((size_t)n * h + iy) * w + ix) * c + ch];
  }
};

template <typename T>
static cudaError_t run(const void* x, const void* values, const void* idx,
                       EpilogueArgs ep, void* out, int out_kind, int n, int h,
                       int w, int c, int f, int ho, int wo, int kh, int kw,
                       int sh, int sw, int pt, int pl, int bz, int nnz,
                       cudaStream_t stream) {
  const int cb = c / bz;
  GatherTap<T> ld{static_cast<const T*>(x), static_cast<const int8_t*>(idx),
                  h, w, c, ho, wo, sh, sw, pt, pl, kw, cb, nnz, bz};
  os_gemm::DenseB<T> vb{static_cast<const T*>(values), f};
  return os_gemm::launch<T>(out_kind, ld, vb, n * ho * wo, f, kh * kw * cb * nnz,
                            out, ep, stream);
}

extern "C" int vdbb_conv_tc(const void* x, const void* values, const void* idx,
                            const void* scale, const void* bias,
                            const void* out_scale, int relu, void* out,
                            int in_kind, int out_kind, int n, int h, int w,
                            int c, int f, int ho, int wo, int kh, int kw, int sh,
                            int sw, int pt, int pl, int bz, int nnz,
                            void* stream) {
  if (bz <= 0 || nnz <= 0 || c % bz != 0) return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == os_gemm::IN_INT8)
    return run<int8_t>(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo,
                       kh, kw, sh, sw, pt, pl, bz, nnz, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run<float>(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo,
                      kh, kw, sh, sw, pt, pl, bz, nnz, s);
  return cudaErrorInvalidValue;
}
