// VDBB sparse matmul, one sparsity pattern shared across N (tc mode).
//
// Replaces repro/kernels/vdbb_matmul.py:_vdbb_tc_kernel (vdbb_matmul_tc,
// launched through core.os_matmul_call). A (M, K) is gathered to the
// compressed reduction K_c = (K/bz)*nnz, column k reading A[:, (k/nnz)*bz +
// idx[k]]: the TPU's one-hot MXU contraction becomes a direct indexed load.
// The product runs against the (K_c, N) row-major values. Any M runs here:
// the TPU's tiny-M fallback existed for its 8-row sublane only.
//
// Bound on an H100 for the sparse-cnn-s head (M = batch, K = 512, N = 1000):
// bytes, mostly the 192 KB int8 value stream; the launch itself costs more
// than either bound at this size.
#include "os_gemm.cuh"

template <typename T>
struct GatherCols {
  const T* a;
  const int8_t* idx;  // (K_c,) intra-block positions, pattern shared by all N
  int lda, bz, nnz;

  __device__ __forceinline__ T operator()(int m, int k) const {
    return a[(size_t)m * lda + (k / nnz) * bz + idx[k]];
  }
};

template <typename T>
static cudaError_t run(const void* a, const void* values, const void* idx,
                       EpilogueArgs ep, void* out, int out_kind, int m, int k,
                       int n, int bz, int nnz, cudaStream_t stream) {
  GatherCols<T> ld{static_cast<const T*>(a), static_cast<const int8_t*>(idx), k,
                   bz, nnz};
  os_gemm::DenseB<T> vb{static_cast<const T*>(values), n};
  return os_gemm::launch<T>(out_kind, ld, vb, m, n, (k / bz) * nnz, out, ep, stream);
}

extern "C" int vdbb_matmul_tc(const void* a, const void* values, const void* idx,
                              const void* scale, const void* bias,
                              const void* out_scale, int relu, void* out,
                              int in_kind, int out_kind, int m, int k, int n,
                              int bz, int nnz, void* stream) {
  if (bz <= 0 || nnz <= 0 || k % bz != 0) return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == os_gemm::IN_INT8)
    return run<int8_t>(a, values, idx, ep, out, out_kind, m, k, n, bz, nnz, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run<float>(a, values, idx, ep, out, out_kind, m, k, n, bz, nnz, s);
  return cudaErrorInvalidValue;
}
