// VDBB sparse matmul, a sparsity pattern for every column (bw mode).
//
// Replaces repro/kernels/vdbb_matmul.py:_vdbb_bw_kernel (vdbb_matmul_bw) and
// its dbb_expand_block. A (M, K) row-major is read as it lies; the right
// operand is the dense (K, N) weight that the per-column compressed values
// and positions stand for, expanded element by element as the B tile is
// staged (vdbb_expand.cuh). The product runs over the dense K, as on the
// TPU: a column's pattern differs from its neighbours', so A cannot be
// gathered once for a whole tile of columns. `g` is the pattern-sharing
// group: 1 per column, or a grouped weight's indices (nb, nnz, N/g) read in
// place.
//
// Bound on an H100 for the sparse-cnn-s head (M = batch, K = 512, N = 1000):
// bytes, the 192 KB of int8 values plus as many bytes of positions; the
// launch itself costs more than either bound at this size. This first
// version multiplies over the dense K on the CUDA cores, bz/nnz times the
// compressed MACs; staging the expand through shared memory and the tensor
// cores are later work.
#include "os_gemm.cuh"
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

template <typename T>
static cudaError_t run(const void* a, const void* values, const void* idx,
                       EpilogueArgs ep, void* out, int out_kind, int m, int k,
                       int n, int bz, int nnz, int g, cudaStream_t stream) {
  // A is a plain row-major (M, K) matrix: the same read as a dense B's
  os_gemm::DenseB<T> la{static_cast<const T*>(a), k};
  ExpandCols<T> lb{static_cast<const T*>(values), static_cast<const int8_t*>(idx),
                   n, bz, nnz, g};
  return os_gemm::launch<T>(out_kind, la, lb, m, n, k, out, ep, stream);
}

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
  if (in_kind == os_gemm::IN_INT8)
    return run<int8_t>(a, values, idx, ep, out, out_kind, m, k, n, bz, nnz, g, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run<float>(a, values, idx, ep, out, out_kind, m, k, n, bz, nnz, g, s);
  return cudaErrorInvalidValue;
}
