// VDBB sparse matmul, a sparsity pattern for every column (bw mode).
//
// Replaces repro/kernels/vdbb_matmul.py:_vdbb_bw_kernel (vdbb_matmul_bw) and
// its dbb_expand_block. A (M, K) row-major is read as it lies; the right
// operand is the dense (K, N) weight that the per-column compressed values
// and positions stand for. The product runs over the dense K, as on the
// TPU: a column's pattern differs from its neighbours', so A cannot be
// gathered once for a whole tile of columns. `g` is the pattern-sharing
// group: 1 per column, or a grouped weight's indices (nb, nnz, N/g) read in
// place.
//
// Bound on an H100 for the sparse-cnn-s head (M = batch, K = 512, N = 1000):
// bytes, the 192 KB of int8 values plus as many bytes of positions; the
// launch itself costs more than either bound at this size. What the design
// does about it, for int8 operands (os_mma.cuh): the 16 column tiles each
// read their slice of both streams once, 8 rows of a column from one read
// of the block's nnz values and positions (`ExpandTile`, vdbb_expand.cuh),
// and multiply on the int8 tensor cores with A arriving by cp.async in
// 16-byte chunks (`RowChunks`); a batch of at most 64 rows takes the
// BM = 64 tile. fp32 operands keep os_gemm.cuh's CUDA-core loop and the
// per-element expand.
#include "os_gemm.cuh"
#include "os_mma.cuh"
#include "vdbb_expand.cuh"

template <typename T>
struct ExpandCols {
  const T* values;
  const int8_t* idx;
  int n, bz, nnz, g;

  __device__ __forceinline__ T operator()(int k, int col) const {
    return vdbb_expand(values, idx, k, col, n, bz, nnz, g);
  }
};

extern "C" int vdbb_matmul_bw(const void* a, const void* values, const void* idx,
                              const void* scale, const void* bias,
                              const void* out_scale, int relu, void* out,
                              int in_kind, int out_kind, int m, int k, int n,
                              int bz, int nnz, int g, void* stream) {
  if (bz <= 0 || nnz <= 0 || nnz > bz || k % bz != 0 || g <= 0 || n % g != 0)
    return cudaErrorInvalidValue;
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == os_gemm::IN_INT8) {
    os_mma::RowChunks la{static_cast<const int8_t*>(a), k};
    ExpandTile lb{static_cast<const int8_t*>(values), static_cast<const int8_t*>(idx), n, bz,
                  nnz, g};
    return os_mma::launch(out_kind, os_mma::chunk_bytes(k, a), la, lb, m, n, k, out, ep, s);
  }
  if (in_kind == os_gemm::IN_FLOAT32) {
    // A is a plain row-major (M, K) matrix: the same read as a dense B's
    os_gemm::DenseB<float> la{static_cast<const float*>(a), k};
    ExpandCols<float> lb{static_cast<const float*>(values), static_cast<const int8_t*>(idx),
                         n, bz, nnz, g};
    return os_gemm::launch<float>(out_kind, la, lb, m, n, k, out, ep, s);
  }
  return cudaErrorInvalidValue;
}
