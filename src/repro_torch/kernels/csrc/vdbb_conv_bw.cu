// Fused IM2COL x VDBB convolution, a sparsity pattern for every output
// channel (bw mode).
//
// Replaces repro/kernels/vdbb_im2col_conv.py:_vdbb_conv_bw_kernel (launched
// by _launch through vdbb_im2col_conv_bw). The conv is an implicit GEMM over
// the dense reduction: M = N*Ho*Wo output pixels, K = kh*kw*C ordered
// (dy, dx, c), N = F. The left operand is the IM2COL unit's shifted view of
// the unpadded input, zero outside the image; the right operand is the
// per-column expand of the compressed weight, whose block b = k / bz =
// t*cb + c/bz lies inside one tap because C % bz == 0. The product runs over
// the dense K, bz/nnz times the compressed MACs, as on the TPU: a column's
// pattern differs from its neighbours', so A cannot be gathered once for a
// tile of columns. The TPU's halo tiling only bounded VMEM, so it is gone.
//
// Bound on an H100 at sparse-cnn-s batch 64: the early layers by their int8
// activation bytes, the deep ones by the compressed MACs at the int8
// tensor-core rate. What the design does about it, for int8 operands
// (os_mma.cuh): the dense-K product runs on the int8 tensor cores
// (mma.sync m16n8k32), so the 8/3 extra MACs cost little; A arrives by
// cp.async in 16-byte chunks (8 when C % 16 != 0), each chunk's tap and
// pixel computed once (`TapChunks`, im2col_tap.cuh); B is expanded once per
// tile into shared memory, 8 rows of a column from one read of the block's
// nnz values and positions (`ExpandTile`, vdbb_expand.cuh), never written
// to device memory. fp32 operands (the calibration forward, TF32 off) keep
// os_gemm.cuh's CUDA-core loop and the per-element expand.
#include "im2col_tap.cuh"
#include "os_gemm.cuh"
#include "os_mma.cuh"
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

static cudaError_t run_fp32(const void* x, const void* values, const void* idx,
                            EpilogueArgs ep, void* out, int out_kind, int n, int h, int w,
                            int c, int f, int ho, int wo, int kh, int kw, int sh, int sw,
                            int pt, int pl, int bz, int nnz, int g, cudaStream_t stream) {
  Tap<float> la{static_cast<const float*>(x), h, w, c, ho, wo, sh, sw, pt, pl, kw};
  ExpandTaps<float> lb{static_cast<const float*>(values), static_cast<const int8_t*>(idx),
                       f, bz, nnz, g};
  return os_gemm::launch<float>(out_kind, la, lb, n * ho * wo, f, kh * kw * c, out, ep,
                                stream);
}

static cudaError_t run_int8(const void* x, const void* values, const void* idx,
                            EpilogueArgs ep, void* out, int out_kind, int n, int h, int w,
                            int c, int f, int ho, int wo, int kh, int kw, int sh, int sw,
                            int pt, int pl, int bz, int nnz, int g, cudaStream_t stream) {
  TapChunks la{static_cast<const int8_t*>(x), h, w, c, ho, wo, sh, sw, pt, pl, kw};
  ExpandTile lb{static_cast<const int8_t*>(values), static_cast<const int8_t*>(idx), f, bz,
                nnz, g};
  return os_mma::launch(out_kind, os_mma::chunk_bytes(c, x), la, lb, n * ho * wo, f,
                        kh * kw * c, out, ep, stream);
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
    return run_int8(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw, sh, sw,
                    pt, pl, bz, nnz, g, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run_fp32(x, values, idx, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw, sh, sw,
                    pt, pl, bz, nnz, g, s);
  return cudaErrorInvalidValue;
}
