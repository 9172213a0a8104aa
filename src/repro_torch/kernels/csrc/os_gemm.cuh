// Output-stationary tiled GEMM shared by the port's five kernels.
//
// Replaces the grid plumbing of repro/kernels/core.py (os_matmul_call and the
// K-innermost grid of os_accumulate). On the TPU the K axis is a sequential
// grid axis and the accumulator lives in VMEM scratch between grid steps. On
// the card thread blocks run in no order, so each block owns one BM x BN
// output tile for its whole life: it loops over K itself in BK-deep slices
// staged through shared memory, keeps its accumulators in registers (a 4x4
// sub-tile per thread), and runs the epilogue once at the end.
//
// Both operands are implicit: `load_a(m, k)` returns A[m, k], which is where
// each kernel does its own gather (the VDBB activation mux, the IM2COL tap),
// reading the unpadded input with bounds checks; `load_b(k, n)` returns
// B[k, n], a dense row-major (K, N) matrix (`DenseB`) or the bw kernels'
// per-column expand of a compressed weight. Ragged M, N and K edges are
// masked here, so no operand is padded in device memory.
//
// Operands are int8 (int32 accumulator) or fp32 (fp32 accumulator).
#pragma once

#include "epilogue.cuh"

namespace os_gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;   // rows per thread, strided by 16
constexpr int TN = 4;   // columns per thread, strided by 16
constexpr int THREADS = 256;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int32_t; };


// B read as it lies: a dense row-major (K, N) matrix.
template <typename T>
struct DenseB {
  const T* b;
  int n;

  __device__ __forceinline__ T operator()(int k, int col) const {
    return __ldg(b + (size_t)k * n + col);
  }
};

template <typename T, typename Out, typename LoadA, typename LoadB>
__global__ void __launch_bounds__(THREADS)
kernel(LoadA load_a, LoadB load_b, int M, int N, int K, Out* __restrict__ out,
       EpilogueArgs ep) {
  using Acc = typename AccOf<T>::type;
  __shared__ T a_tile[BK][BM + 4];
  __shared__ T b_tile[BK][BN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // neighbouring threads take neighbouring k: the gathered channels of one
    // pixel lie close together in the NHWC input
    for (int e = threadIdx.x; e < BK * BM; e += THREADS) {
      const int kk = e % BK, mm = e / BK;
      const int k = k0 + kk, m = m0 + mm;
      a_tile[kk][mm] = (k < K && m < M) ? load_a(m, k) : T(0);
    }
    // neighbouring threads take neighbouring n: B's rows are row-major
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int nn = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + nn;
      b_tile[kk][nn] = (k < K && n < N) ? load_b(k, n) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = static_cast<Acc>(a_tile[kk][ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = static_cast<Acc>(b_tile[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = epilogue_flush<Acc, Out>(acc[i][j], n, ep);
    }
  }
}

template <typename T, typename Out, typename LoadA, typename LoadB>
cudaError_t launch_typed(const LoadA& load_a, const LoadB& load_b, int M, int N,
                         int K, void* out, EpilogueArgs ep, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<T, Out, LoadA, LoadB><<<grid, THREADS, 0, stream>>>(
      load_a, load_b, M, N, K, static_cast<Out*>(out), ep);
  return cudaGetLastError();
}

// Output kinds as the Python wrappers pass them.
enum OutKind { OUT_INT32 = 0, OUT_FLOAT32 = 1, OUT_INT8 = 2 };
// Operand kinds.
enum InKind { IN_INT8 = 0, IN_FLOAT32 = 1 };

template <typename T, typename LoadA, typename LoadB>
cudaError_t launch(int out_kind, const LoadA& load_a, const LoadB& load_b, int M,
                   int N, int K, void* out, EpilogueArgs ep, cudaStream_t stream) {
  if (out_kind == OUT_INT8 && ep.out_scale == nullptr) return cudaErrorInvalidValue;
  switch (out_kind) {
    case OUT_INT32:
      if constexpr (std::is_same<T, int8_t>::value)
        return launch_typed<T, int32_t>(load_a, load_b, M, N, K, out, ep, stream);
      else
        return cudaErrorInvalidValue;
    case OUT_FLOAT32:
      return launch_typed<T, float>(load_a, load_b, M, N, K, out, ep, stream);
    case OUT_INT8:
      return launch_typed<T, int8_t>(load_a, load_b, M, N, K, out, ep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace os_gemm
