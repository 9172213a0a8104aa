// The bw kernels' "late mux": one element of the dense weight that a
// per-column compressed weight stands for.
//
// Replaces repro/kernels/vdbb_matmul.py:dbb_expand_block. values (nb, nnz, N)
// and idx (nb, nnz, N/g), both row-major, give
//   W[b*bz + i, n] = sum_j [idx[b, j, n/g] == i] * values[b, j, n],
// with g the pattern-sharing group (1 per column). Positions within a
// block-column are distinct, so at most one term is nonzero and the sum is
// exact in int8 as in fp32; the sum form, not a search for the match, is
// the reference's. The TPU expands a whole (kb, nnz, bn) block in VMEM
// before its MXU dot; here each element is expanded as the GEMM's B tile is
// staged, at most nnz compares, with neighbouring threads on neighbouring n
// so a warp reads neighbouring bytes of both streams. A grouped weight's
// indices are read in place (n/g), never repeated into a per-column copy.
#pragma once

#include <cstddef>
#include <cstdint>

template <typename T>
__device__ __forceinline__ T vdbb_expand(const T* __restrict__ values,
                                         const int8_t* __restrict__ idx, int k,
                                         int col, int n, int bz, int nnz, int g) {
  const int b = k / bz;
  const int i = k - b * bz;
  const int ng = n / g;
  const int gcol = col / g;
  T w = T(0);
  for (int j = 0; j < nnz; ++j) {
    const size_t row = (size_t)b * nnz + j;
    const T v = __ldg(values + row * n + col);
    if (__ldg(idx + row * ng + gcol) == i) w += v;
  }
  return w;
}
