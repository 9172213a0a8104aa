// Output-stationary int8 GEMM on the tensor cores: the int8 instantiation of
// the bw kernels and of the tc kernels.
//
// Replaces, for int8 operands, the grid plumbing of repro/kernels/core.py
// (os_matmul_call and the K-innermost grid of os_accumulate), as os_gemm.cuh
// does on the CUDA cores. Each block owns one BM x 64 output tile for its
// whole life and walks K in 64-byte stages; int32 accumulators live in
// registers as mma fragments and the flush (epilogue.cuh) runs once at the
// end on each fragment element.
//
// Per stage:
//  - A (BM x 64 bytes) comes one of two ways, chosen at compile time by the
//    stager's `kRegisters`:
//    - by cp.async in CH-byte chunks (16: .cg, or 8: .ca) into a STAGES-deep
//      ring, for an A whose K runs lie contiguous in memory. A stager
//      resolves each of a thread's rows once per tile (`row`), the thread's
//      column of K once (`at`) and then from stage to stage (`advance`), and
//      each chunk's source from the two (`chunk`); a chunk outside the
//      operand is copied with src-size 0, so it lands as zeros without a
//      branch on the load;
//    - through registers, for an A gathered byte by byte (the tc kernels'
//      activation mux, mux_stage.cuh). The first 64 threads resolve the
//      stage's 64 source offsets (`source`) into a shared row one stage
//      ahead; the bytes are fetched into registers before the stage's mmas
//      and stored after them, into the other of two buffers, as B does.
//      In byte lanes: a warp's 32 lanes take 32 neighbouring columns of one
//      row (a thread columns lane and lane + 32 of rows warp + 8 i), so a
//      warp's load reads a few neighbouring lines; each row's state (`row`)
//      is resolved once a tile into shared memory and read there (a
//      broadcast), each byte fetched by `fetch_byte` and stored alone.
//  - B (64 bytes of K x 64 columns) is built by a stager in two steps:
//    `fetch(k8, n, K)` issues the global loads of B[k8 .. k8+7, n] into
//    registers (a `Raw`), `pack(raw)` turns them into the 8 bytes in a
//    uint64, which one 8-byte store puts in the K-major tile Bs[n][k8 - k0],
//    the .col layout the mma takes. Stage kt+1 is fetched before stage kt's
//    mmas and packed and stored after them, into the other of two buffers,
//    so the loads' latency hides behind the mmas. B rows at or past K are
//    zero, so a register-staged A may hold any byte there.
//  - Two k32 steps of mma.sync.m16n8k32 s8 x s8 -> s32, operands from shared
//    memory by ldmatrix. Rows are 80 bytes apart (64 + 16), so the 8 row
//    addresses of an ldmatrix hit 8 disjoint 4-bank groups.
// One __syncthreads per stage: after it, stage kt's A and B are visible and
// every warp is done with stage kt-1, whose A slot and B buffer are refilled.
//
// The accumulation is exact without .satfinite while |acc| < 2^31, that is
// K * 127 * 127 < 2^31; the wrapper refuses a larger K (MAX_K).
#pragma once

#include <cstdint>

#include "epilogue.cuh"

namespace os_mma {

constexpr int BN = 64;
constexpr int BK = 64;           // bytes of K per stage: two k32 mma steps
constexpr int LDS = BK + 16;     // shared row pitch in bytes
constexpr int STAGES = 3;        // depth of the A ring
constexpr int THREADS = 256;     // 8 warps: 4 x 2 warp tiles of 32 x 32 (BM = 128)
                                 // or 2 x 4 of 32 x 16 (BM = 64)
constexpr int MIN_BLOCKS = 3;    // blocks an SM: caps a thread at 85 registers
                                 // (the staging is issue-bound; 24 warps an SM
                                 // beat 16 on an H100, a few bytes of spill aside)
constexpr int MIN_BLOCKS_REG_A = 2;  // with A's bytes in flight in registers too
constexpr int WM = 32;
constexpr int MAX_K = 2147483647 / (127 * 127);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int CH>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? CH : 0;
  if constexpr (CH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A stager of a plain row-major (M, K) int8 matrix, read as it lies.
struct RowChunks {
  static constexpr bool kRegisters = false;  // cp.async chunks
  const int8_t* a;
  int k;

  struct Row {
    const int8_t* p;
    bool ok;
  };

  __device__ __forceinline__ Row row(int m, int M) const {
    return Row{a + (size_t)(m < M ? m : 0) * k, m < M};
  }

  using At = int;

  __device__ __forceinline__ At at(int kk) const { return kk; }

  __device__ __forceinline__ void advance(At& kk, int step) const { kk += step; }

  __device__ __forceinline__ const int8_t* chunk(const Row& r, At kk, bool& ok) const {
    ok = ok && r.ok;
    return ok ? r.p + kk : a;
  }
};

// What a stager of A keeps per thread from one stage to the next: a cp.async
// stager its column of K (`At`), a register stager 8 of the bytes in flight
// a `Raw` (zero-extended, one a word); the other is an empty struct.
template <typename S, bool = S::kRegisters>
struct AState {
  using At = typename S::At;
  struct Raw {};
};
template <typename S>
struct AState<S, true> {
  struct At {};
  struct Raw {
    uint32_t v[8];
  };
};

// A register stager's source offsets, for the stage being fetched and the
// one after it; nothing for a cp.async stager.
template <bool>
struct Sources {};
template <>
struct Sources<true> {
  int off[2][BK];
};

// A register stager's row states of the tile, in shared memory; nothing
// for a cp.async stager.
template <bool, typename Row, int BM>
struct RowStates {};
template <typename Row, int BM>
struct RowStates<true, Row, BM> {
  Row row[BM];
};

// `Flush`: epilogue.cuh's PlainFlush, or ResidualFlush for a ResNet block's
// last conv (the residual operand added in the flush).
template <int BM, int CH, typename Out, typename StageA, typename StageB, typename Flush>
__global__ void __launch_bounds__(THREADS, StageA::kRegisters ? MIN_BLOCKS_REG_A : MIN_BLOCKS)
kernel(StageA stage_a, StageB stage_b, int M, int N, int K, Out* __restrict__ out,
       Flush flush) {
  constexpr bool REG_A = StageA::kRegisters;
  static_assert(!REG_A || CH == 8, "a register-staged A takes the 8-byte instance");
  constexpr int A_BUFS = REG_A ? 2 : STAGES;      // two buffers as B's, or the cp.async ring
  constexpr int WARPS_N = THREADS / 32 / (BM / WM);
  constexpr int WN = BN / WARPS_N;                // 32 (BM = 128) or 16 (BM = 64)
  static_assert(WN % 16 == 0, "an ldmatrix.x4 of B covers two n8 tiles");
  constexpr int CHUNKS = BK / CH;                 // chunks in a row of a stage
  constexpr int ROW_STEP = THREADS / CHUNKS;      // rows between a thread's chunks
  constexpr int A_ROWS = BM / ROW_STEP;           // chunks a thread copies a stage
  constexpr int COL_STEP = THREADS / BN;          // 8-byte groups between a thread's
  constexpr int B_GROUPS = (BK / 8) / COL_STEP;   // groups a thread builds a stage
  static_assert(BM % ROW_STEP == 0 && (BK / 8) % COL_STEP == 0, "tile and threads");
  // byte lanes: a thread's A_ROWS * 8 bytes are columns lane and lane + 32
  // of rows warp + 8 * (q / 2) for q = i * 8 + j
  constexpr int WARPS = THREADS / 32;
  static_assert(!REG_A || (BK == 64 && A_ROWS * 8 * WARPS * 32 == BM * BK), "byte lanes");

  __shared__ __align__(16) int8_t As[A_BUFS][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];
  __shared__ __align__(16) Sources<REG_A> a_src;
  __shared__ __align__(16) RowStates<REG_A, typename StageA::Row, BM> a_rows;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;

  // a thread copies the same rows' chunks at every stage: resolve them once
  // (in byte lanes, every row once into shared memory)
  const int a_row = tid / CHUNKS, a_col = (tid % CHUNKS) * CH;
  typename StageA::Row rows[A_ROWS];
  if constexpr (REG_A) {
    for (int r = tid; r < BM; r += THREADS) a_rows.row[r] = stage_a.row(m0 + r, M);
  } else {
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) rows[i] = stage_a.row(m0 + a_row + i * ROW_STEP, M);
  }

  using AtA = typename AState<StageA>::At;
  using RawA = typename AState<StageA>::Raw;
  // cp.async: the stages are copied in order, so the thread's column of K
  // moves by BK from one copy to the next
  AtA at{};
  if constexpr (!REG_A) at = stage_a.at(a_col);
  auto load_a = [&](int kt, int s) {
    if constexpr (!REG_A) {
      const int k = kt * BK + a_col;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        bool ok = k < K;
        const int8_t* src = stage_a.chunk(rows[i], at, ok);
        cp_async<CH>(smem_u32(&As[s][a_row + i * ROW_STEP][a_col]), src, ok);
      }
      stage_a.advance(at, BK);
    }
  };
  // registers: stage kt's source offsets, one a thread for the first BK
  // threads, into the row that stage kt - 2 used
  auto resolve_a = [&](int kt) {
    if constexpr (REG_A) {
      if (tid < BK) a_src.off[kt & 1][tid] = stage_a.source(kt * BK + tid, K);
    }
  };
  auto fetch_a = [&](int kt, RawA (&raw)[A_ROWS]) {
    if constexpr (REG_A) {
      const int src[2] = {a_src.off[kt & 1][lane], a_src.off[kt & 1][lane + 32]};
#pragma unroll
      for (int q = 0; q < A_ROWS * 8; ++q)
        raw[q / 8].v[q % 8] = stage_a.fetch_byte(a_rows.row[warp + 8 * (q / 2)], src[q % 2]);
    }
  };
  auto store_a = [&](int s, const RawA (&raw)[A_ROWS]) {
    if constexpr (REG_A) {
#pragma unroll
      for (int q = 0; q < A_ROWS * 8; ++q)
        As[s][warp + 8 * (q / 2)][lane + 32 * (q % 2)] = static_cast<int8_t>(raw[q / 8].v[q % 8]);
    }
  };
  // neighbouring threads build neighbouring columns: the stager's reads of
  // the compressed streams are coalesced
  const int b_col = tid % BN, b_grp = tid / BN;
  using RawB = typename StageB::Raw;
  auto fetch_b = [&](int kt, RawB (&raw)[B_GROUPS]) {
#pragma unroll
    for (int i = 0; i < B_GROUPS; ++i)
      raw[i] = stage_b.fetch(kt * BK + (b_grp + i * COL_STEP) * 8, n0 + b_col, K);
  };
  auto store_b = [&](int s, const RawB (&raw)[B_GROUPS]) {
#pragma unroll
    for (int i = 0; i < B_GROUPS; ++i)
      *reinterpret_cast<uint64_t*>(&Bs[s][b_col][(b_grp + i * COL_STEP) * 8]) =
          stage_b.pack(raw[i]);
  };

  int32_t acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if constexpr (REG_A) {
    resolve_a(0);
    if (ktiles > 1) resolve_a(1);
    __syncthreads();
    RawA raw[A_ROWS];
    fetch_a(0, raw);
    store_a(0, raw);
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load_a(s, s);
      cp_async_commit();
    }
  }
  {
    RawB raw[B_GROUPS];
    fetch_b(0, raw);
    store_b(0, raw);
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    if constexpr (!REG_A) cp_async_wait<STAGES - 2>();
    __syncthreads();
    if constexpr (!REG_A) {
      const int next = kt + STAGES - 1;
      if (next < ktiles) load_a(next, next % STAGES);
      cp_async_commit();
    }
    const bool more = kt + 1 < ktiles;
    RawB raw[B_GROUPS];
    RawA raw_a[A_ROWS];
    if (more) {
      fetch_b(kt + 1, raw);
      fetch_a(kt + 1, raw_a);
    }

    const int8_t(*A)[LDS] = As[kt % A_BUFS];
    const int8_t(*B)[LDS] = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[WM / 16][4], bf[WN / 16][4];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        ldmatrix_x4(af[i], smem_u32(&A[wm + i * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                                       [ks * 32 + (lane / 16) * 16]));
      // one x4 load covers two n8 tiles: registers 0, 1 are the first's
      // two k16 halves, registers 2, 3 the second's
#pragma unroll
      for (int p = 0; p < WN / 16; ++p)
        ldmatrix_x4(bf[p], smem_u32(&B[wn + p * 16 + (lane % 8) + (lane / 16) * 8]
                                       [ks * 32 + ((lane / 8) % 2) * 16]));
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
          mma_s8(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
    }
    if (more) {
      store_b((kt + 1) & 1, raw);
      store_a((kt + 1) % A_BUFS, raw_a);
    }
    if (kt + 2 < ktiles) resolve_a(kt + 2);
  }

  // m16n8 accumulator fragment: elements (e0, e1) at row lane/4, columns
  // 2*(lane%4) + {0, 1}; (e2, e3) eight rows below
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + lane / 4 + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + (lane % 4) * 2 + e;
          if (n < N)
            out[(size_t)m * N + n] =
                flush.template apply<Out>(acc[i][j][h * 2 + e], (size_t)m * N + n, n);
        }
    }
}

template <int BM, int CH, typename Out, typename StageA, typename StageB, typename Flush>
cudaError_t launch_typed(const StageA& stage_a, const StageB& stage_b, int M, int N, int K,
                         void* out, const Flush& flush, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<BM, CH, Out, StageA, StageB, Flush><<<grid, THREADS, 0, stream>>>(
      stage_a, stage_b, M, N, K, static_cast<Out*>(out), flush);
  return cudaGetLastError();
}

// The tile instance the host chose (repro_torch.kernels.core.mma_plan, a
// rule by M or a tuned entry): BM = 64 or 128 rows; any other is refused.
template <int CH, typename Out, typename StageA, typename StageB, typename Flush>
cudaError_t launch_rows(int rows, const StageA& stage_a, const StageB& stage_b, int M, int N,
                        int K, void* out, const Flush& flush, cudaStream_t stream) {
  if (rows == 64) return launch_typed<64, CH, Out>(stage_a, stage_b, M, N, K, out, flush, stream);
  if (rows == 128)
    return launch_typed<128, CH, Out>(stage_a, stage_b, M, N, K, out, flush, stream);
  return cudaErrorInvalidValue;
}

template <typename Out, typename StageA, typename StageB, typename Flush>
cudaError_t launch_chunk(int chunk, int rows, const StageA& stage_a, const StageB& stage_b,
                         int M, int N, int K, void* out, const Flush& flush,
                         cudaStream_t stream) {
  // a register-staged A takes only the 8-byte instance
  if constexpr (!StageA::kRegisters) {
    if (chunk == 16)
      return launch_rows<16, Out>(rows, stage_a, stage_b, M, N, K, out, flush, stream);
  }
  if (chunk == 8) return launch_rows<8, Out>(rows, stage_a, stage_b, M, N, K, out, flush, stream);
  return cudaErrorInvalidValue;
}

// The A chunk width, the same rule as the wrapper's: 16 bytes when a row's
// run of K (the channels of one tap, or a matrix row) is a multiple of 16
// and the operand is 16-byte aligned, else 8 under the same two conditions;
// 0 for what the kernel does not take.
inline int chunk_bytes(int run, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (run % 16 == 0 && a % 16 == 0) return 16;
  if (run % 8 == 0 && a % 8 == 0) return 8;
  return 0;
}

// Output kinds as the Python wrappers pass them (os_gemm.cuh's OutKind);
// `rows` the tile rows the host chose; `flush` epilogue.cuh's PlainFlush or
// ResidualFlush (fp32 or int8 out only: the residual joins a dequantized
// output).
template <typename StageA, typename StageB, typename Flush>
cudaError_t launch_flush(int out_kind, int chunk, int rows, const StageA& stage_a,
                         const StageB& stage_b, int M, int N, int K, void* out,
                         const Flush& flush, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > MAX_K || chunk == 0) return cudaErrorInvalidValue;
  if (out_kind == 2 && flush.ep.out_scale == nullptr) return cudaErrorInvalidValue;
  switch (out_kind) {
    case 0:
      if constexpr (Flush::kResidual) return cudaErrorInvalidValue;
      else
        return launch_chunk<int32_t>(chunk, rows, stage_a, stage_b, M, N, K, out, flush, stream);
    case 1:
      return launch_chunk<float>(chunk, rows, stage_a, stage_b, M, N, K, out, flush, stream);
    case 2:
      return launch_chunk<int8_t>(chunk, rows, stage_a, stage_b, M, N, K, out, flush, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename StageA, typename StageB>
cudaError_t launch(int out_kind, int chunk, int rows, const StageA& stage_a,
                   const StageB& stage_b, int M, int N, int K, void* out, EpilogueArgs ep,
                   cudaStream_t stream) {
  return launch_flush(out_kind, chunk, rows, stage_a, stage_b, M, N, K, out, PlainFlush{ep},
                      stream);
}

}  // namespace os_mma
