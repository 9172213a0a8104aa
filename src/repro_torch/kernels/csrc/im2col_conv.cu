// Dense fused IM2COL convolution (implicit GEMM), NHWC input, HWIO weight.
//
// Replaces repro/kernels/im2col_conv.py:_im2col_conv_kernel (im2col_conv).
// M = N*Ho*Wo, K = kh*kw*C ordered (dy, dx, c), N = F. The left operand is
// read straight from the unpadded input through the tap's shifted view
// (`Tap`, im2col_tap.cuh), zero outside the image, so the kh*kw-duplicated
// im2col tensor never exists.
// On the int8-resident chain it is the fp32 C = 3 stem, whose epilogue fuses
// bias, ReLU and the requantize to int8.
//
// Bound on an H100 at sparse-cnn-s batch 64: the stem's fp32 operations
// (2*M*27*64 flops) against the 67 TFLOP/s of the CUDA cores; its bytes
// (3 channels in, 64 int8 channels out) take less time.
#include "im2col_tap.cuh"
#include "os_gemm.cuh"

template <typename T>
static cudaError_t run(const void* x, const void* wt, EpilogueArgs ep, void* out,
                       int out_kind, int n, int h, int w, int c, int f, int ho,
                       int wo, int kh, int kw, int sh, int sw, int pt, int pl,
                       cudaStream_t stream) {
  Tap<T> ld{static_cast<const T*>(x), h, w, c, ho, wo, sh, sw, pt, pl, kw};
  os_gemm::DenseB<T> wb{static_cast<const T*>(wt), f};
  return os_gemm::launch<T>(out_kind, ld, wb, n * ho * wo, f, kh * kw * c, out, ep,
                            stream);
}

extern "C" int im2col_conv(const void* x, const void* wt, const void* scale,
                           const void* bias, const void* out_scale, int relu,
                           void* out, int in_kind, int out_kind, int n, int h,
                           int w, int c, int f, int ho, int wo, int kh, int kw,
                           int sh, int sw, int pt, int pl, void* stream) {
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == os_gemm::IN_INT8)
    return run<int8_t>(x, wt, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw,
                       sh, sw, pt, pl, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run<float>(x, wt, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw,
                      sh, sw, pt, pl, s);
  return cudaErrorInvalidValue;
}
