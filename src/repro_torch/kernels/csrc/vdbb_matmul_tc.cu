// VDBB sparse matmul, one sparsity pattern shared across N (tc mode).
//
// Replaces repro/kernels/vdbb_matmul.py:_vdbb_tc_kernel (vdbb_matmul_tc,
// launched through core.os_matmul_call). A (M, K) is gathered to the
// compressed reduction K_c = (K/bz)*nnz, column k reading A[:, (k/nnz)*bz +
// idx[k]]: the TPU's one-hot MXU contraction becomes a direct indexed load.
// The product runs against the (K_c, N) row-major values. Any M runs here:
// the TPU's tiny-M fallback existed for its 8-row sublane only.
//
// Bound on an H100 for the sparse-cnn-s head (M = batch, K = 512, K_c =
// 192, N = 1000): bytes, the 192 KB of int8 values and, at batch 64, the
// 256 KB of fp32 logits (0.15 us at 3.35 TB/s); the launch itself costs
// more than either bound at this size, so the time is the latency of a few
// stages on 16 blocks. What the design does about it, for int8 operands:
// the product runs on the int8 tensor cores (os_mma.cuh, mma.sync
// m16n8k32) over K_c in 64-byte stages, three at the head; A is gathered
// through registers (`GatherMux`, mux_stage.cuh), each stage's 64 source
// offsets resolved once for the whole tile, in byte lanes (a warp's 32 lanes
// on 32 neighbouring columns of one row); B is the values read down each
// column and packed K-major (`DenseTile`); the loads of stage kt+1 are in
// flight during stage kt's mmas. The host passes the tile rows (64 or
// 128: `rows`) and, for bf16, the split (`split`; 1 for int8). bf16
// operands (the LM's projections) run on the bf16 tensor cores
// (bf16_mma.cuh: the gather by 4-byte words, the values by cp.async in a
// ring, split-K over a thread block cluster at decode), accumulate in fp32
// and round once at the flush. fp32 operands keep os_gemm.cuh's CUDA-core
// loop (`GatherCols`).
//
// A second entry point, vdbb_matmul_tc_wgmma, runs the int8 product a plan
// has staged at prefill row counts (core.matmul_tc_plan's rule) on
// os_mma_sm90.cuh: TMA, the mux in shared memory (`GatherMuxSmem`) and
// wgmma, against the plan's K-major copy of the values and its block
// selectors.
#include "bf16_mma.cuh"
#include "mux_stage.cuh"
#include "os_gemm.cuh"
#include "os_mma.cuh"
#include "os_mma_sm90.cuh"

struct GatherCols {
  const float* a;
  const int8_t* idx;  // (K_c,) intra-block positions, pattern shared by all N
  int lda, bz, nnz;

  __device__ __forceinline__ float operator()(int m, int k) const {
    return a[(size_t)m * lda + (k / nnz) * bz + idx[k]];
  }
};

extern "C" int vdbb_matmul_tc(const void* a, const void* values, const void* idx,
                              const void* scale, const void* bias,
                              const void* out_scale, int relu, void* out,
                              int in_kind, int out_kind, int m, int k, int n,
                              int bz, int nnz, int rows, int split, void* stream) {
  if (bz <= 0 || nnz <= 0 || nnz > bz || k % bz != 0) return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kc = (k / bz) * nnz;
  if (in_kind == os_gemm::IN_INT8) {
    GatherMux la{static_cast<const int8_t*>(a), static_cast<const int8_t*>(idx), k, bz, nnz};
    DenseTile lb{static_cast<const int8_t*>(values), n};
    // a gathered A takes the core's 8-byte instance: the chunk width is 8;
    // the int8 core has no split of K
    if (split != 1) return cudaErrorInvalidValue;
    return os_mma::launch(out_kind, 8, rows, la, lb, m, n, kc, out, ep, s);
  }
  if (in_kind == os_gemm::IN_FLOAT32) {
    GatherCols la{static_cast<const float*>(a), static_cast<const int8_t*>(idx), k, bz, nnz};
    os_gemm::DenseB<float> lb{static_cast<const float*>(values), n};
    return os_gemm::launch<float>(out_kind, la, lb, m, n, kc, out, ep, s);
  }
  if (in_kind == bf16_mma::IN_BF16) {
    bf16_mma::WordGather la{static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(idx),
                            k, bz, nnz};
    return bf16_mma::launch(out_kind, rows, split, la,
                            static_cast<const __nv_bfloat16*>(values), m, n, kc, out, ep, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int vdbb_matmul_tc_wgmma(const void* a, const void* vt, const void* sel,
                                    const void* scale, const void* bias, const void* out_scale,
                                    int relu, void* out, int out_kind, int m, int k, int n,
                                    int vt_pitch, int bz, int nnz, void* stream) {
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  return os_mma_sm90::launch(out_kind, static_cast<const int8_t*>(a),
                             static_cast<const int8_t*>(vt), vt_pitch,
                             static_cast<const uint32_t*>(sel), m, n, k, bz, nnz, out, ep,
                             static_cast<cudaStream_t>(stream));
}
