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
// ones are bound by operations at nnz/bz of the dense MACs. What the design
// does about it, for int8 operands: the product runs on the int8 tensor
// cores (os_mma.cuh, mma.sync m16n8k32) over the compressed K_c in 64-byte
// stages, never over the dense K; A is gathered through registers by
// `TapMux` (mux_stage.cuh): each stage's 64 column sources (tap and offset)
// resolved once for the whole tile, each row's pixel and in-image taps once
// a tile, each byte a predicated load, in byte lanes (a warp's 32 lanes on
// 32 neighbouring columns of one row, so a warp's load reads one to three
// lines); B is the values read down each column and packed K-major
// (`DenseTile`); the loads of stage kt+1 are in flight during stage kt's
// mmas. fp32 operands (the calibration forward) keep os_gemm.cuh's
// CUDA-core loop (`GatherTap`).
//
// A 1 x 1 conv (kh = kw = 1) launches the same mux as `PointMux`, a type of
// its own, so a device trace tells 1 x 1 convs from 3 x 3 ones. A second
// entry point, vdbb_conv_tc_residual, is the int8 instance with a
// ResNet block's residual operand in its flush (epilogue.cuh's
// ResidualFlush: int8 codes of the output's shape and their scale, added
// after the bias, before ReLU and the requantize), so the block's last conv
// adds the shortcut without leaving int8.
#include "mux_stage.cuh"
#include "os_gemm.cuh"
#include "os_mma.cuh"

struct GatherTap {
  const float* x;
  const int8_t* idx;  // (K_c,) intra-block positions, pattern shared by all F
  int h, w, c, ho, wo, sh, sw, pt, pl, kw, cb, nnz, bz;

  __device__ __forceinline__ float operator()(int m, int k) const {
    const int blk = k / nnz;
    const int t = blk / cb;
    const int ch = (blk - t * cb) * bz + idx[k];
    const int dy = t / kw, dx = t - dy * kw;
    const int ox = m % wo;
    const int r = m / wo;
    const int oy = r % ho, n = r / ho;
    const int iy = oy * sh - pt + dy, ix = ox * sw - pl + dx;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 0.0f;
    return x[(((size_t)n * h + iy) * w + ix) * c + ch];
  }
};

extern "C" int vdbb_conv_tc(const void* x, const void* values, const void* idx,
                            const void* scale, const void* bias,
                            const void* out_scale, int relu, void* out,
                            int in_kind, int out_kind, int n, int h, int w,
                            int c, int f, int ho, int wo, int kh, int kw, int sh,
                            int sw, int pt, int pl, int bz, int nnz, int rows,
                            void* stream) {
  if (bz <= 0 || nnz <= 0 || nnz > bz || c % bz != 0) return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cb = c / bz, m = n * ho * wo, kc = kh * kw * cb * nnz;
  const int8_t* pos = static_cast<const int8_t*>(idx);
  if (in_kind == os_gemm::IN_INT8) {
    if (!TapMux::fits(w, c, kh, kw)) return cudaErrorInvalidValue;
    TapMux la{static_cast<const int8_t*>(x), pos, h, w, c, ho, wo, sh, sw, pt, pl, kh, kw,
              cb, bz, nnz};
    DenseTile lb{static_cast<const int8_t*>(values), f};
    // a gathered A takes the core's 8-byte instance: the chunk width is 8
    if (kh == 1 && kw == 1)
      return os_mma::launch(out_kind, 8, rows, PointMux{la}, lb, m, f, kc, out, ep, s);
    return os_mma::launch(out_kind, 8, rows, la, lb, m, f, kc, out, ep, s);
  }
  if (in_kind == os_gemm::IN_FLOAT32) {
    GatherTap la{static_cast<const float*>(x), pos, h, w, c, ho, wo, sh, sw, pt, pl, kw, cb,
                 nnz, bz};
    os_gemm::DenseB<float> lb{static_cast<const float*>(values), f};
    return os_gemm::launch<float>(out_kind, la, lb, m, f, kc, out, ep, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int vdbb_conv_tc_residual(const void* x, const void* values, const void* idx,
                                     const void* scale, const void* bias,
                                     const void* out_scale, int relu, void* out, int out_kind,
                                     int n, int h, int w, int c, int f, int ho, int wo, int kh,
                                     int kw, int sh, int sw, int pt, int pl, int bz, int nnz,
                                     int rows, const void* res, const void* res_scale,
                                     void* stream) {
  if (bz <= 0 || nnz <= 0 || nnz > bz || c % bz != 0 || res == nullptr || res_scale == nullptr ||
      !TapMux::fits(w, c, kh, kw))
    return cudaErrorInvalidValue;
  ResidualFlush flush{{static_cast<const float*>(scale), static_cast<const float*>(bias),
                       static_cast<const float*>(out_scale), relu},
                      {static_cast<const int8_t*>(res), static_cast<const float*>(res_scale)}};
  const int cb = c / bz, m = n * ho * wo, kc = kh * kw * cb * nnz;
  TapMux la{static_cast<const int8_t*>(x), static_cast<const int8_t*>(idx), h, w, c, ho, wo, sh, sw,
            pt, pl, kh, kw, cb, bz, nnz};
  DenseTile lb{static_cast<const int8_t*>(values), f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 1 && kw == 1)
    return os_mma::launch_flush(out_kind, 8, rows, PointMux{la}, lb, m, f, kc, out, flush, s);
  return os_mma::launch_flush(out_kind, 8, rows, la, lb, m, f, kc, out, flush, s);
}
