// Fused IM2COL x VDBB convolution, a sparsity pattern for every output
// channel (bw mode).
//
// Replaces repro/kernels/vdbb_im2col_conv.py:_vdbb_conv_bw_kernel (launched
// by _launch through vdbb_im2col_conv_bw). The conv is an implicit GEMM over
// the dense reduction: M = N*Ho*Wo output pixels, K = kh*kw*C ordered
// (dy, dx, c), N = F. The left operand is the IM2COL unit's shifted view of
// the unpadded input (`Tap`, im2col_tap.cuh), zero outside the image; the
// right operand is the per-column expand of the compressed weight
// (vdbb_expand.cuh), whose block b = k / bz = t*cb + c/bz lies inside one tap
// because C % bz == 0. The TPU's halo tiling only bounded VMEM, so it is gone.
//
// Bound on an H100 at sparse-cnn-s batch 64: as for the tc conv, the early
// layers by their int8 activation bytes, the deep ones by the compressed
// MACs, with the position stream (as many bytes as the values) added to the
// weight bytes. This first version does int32 multiply-adds over the dense
// K on the CUDA cores, bz/nnz times the compressed MACs, so it runs far
// above either bound; staging the expand through shared memory and the
// tensor cores are later work.
#include "im2col_tap.cuh"
#include "os_gemm.cuh"
#include "vdbb_expand.cuh"

template <typename T>
struct ExpandTaps {
  const T* values;
  const int8_t* idx;
  int f, bz, nnz, g;

  __device__ __forceinline__ T operator()(int k, int col) const {
    return vdbb_expand(values, idx, k, col, f, bz, nnz, g);
  }
};

template <typename T>
static cudaError_t run(const void* x, const void* values, const void* idx,
                       EpilogueArgs ep, void* out, int out_kind, int n, int h,
                       int w, int c, int f, int ho, int wo, int kh, int kw,
                       int sh, int sw, int pt, int pl, int bz, int nnz, int g,
                       cudaStream_t stream) {
  Tap<T> la{static_cast<const T*>(x), h, w, c, ho, wo, sh, sw, pt, pl, kw};
  ExpandTaps<T> lb{static_cast<const T*>(values), static_cast<const int8_t*>(idx),
                   f, bz, nnz, g};
  return os_gemm::launch<T>(out_kind, la, lb, n * ho * wo, f, kh * kw * c, out, ep,
                            stream);
}

extern "C" int vdbb_conv_bw(const void* x, const void* values, const void* idx,
                            const void* scale, const void* bias,
                            const void* out_scale, int relu, void* out,
                            int in_kind, int out_kind, int n, int h, int w,
                            int c, int f, int ho, int wo, int kh, int kw, int sh,
                            int sw, int pt, int pl, int bz, int nnz, int g,
                            void* stream) {
  if (bz <= 0 || nnz <= 0 || nnz > bz || c % bz != 0 || g <= 0 || f % g != 0)
    return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == os_gemm::IN_INT8)
    return run<int8_t>(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo,
                       kh, kw, sh, sw, pt, pl, bz, nnz, g, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run<float>(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo,
                      kh, kw, sh, sw, pt, pl, bz, nnz, g, s);
  return cudaErrorInvalidValue;
}
