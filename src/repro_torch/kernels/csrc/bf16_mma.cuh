// Output-stationary bf16 GEMM on the tensor cores over a gathered A: the bf16
// instantiation of the tc matmul (vdbb_matmul_tc.cu), the LM's projections.
//
// Replaces, for bf16 operands, src/repro/kernels/vdbb_matmul.py:65
// _vdbb_tc_kernel:
//   out[m, n] = Out(sum_{k < K_c} A[m, (k / nnz) * bz + idx[k]] * V[k, n])
// with A (M, K) bf16 row-major, the positions idx (K_c,) int8 shared by every
// output column, the compressed values V (K_c, N) bf16 row-major, the sum in
// fp32 (each bf16 product is exact there, as in the reference's MXU dot with
// preferred_element_type=f32) and one rounding at the flush (epilogue.cuh,
// unchanged: bf16, fp32 with scale, bias and ReLU, or int8 codes).
//
// Bound on an H100 (starcoder2-7b's projections, K_c = 3/8 K):
//  - decode (M = 4): bytes. The values are the whole of it (2 K_c N bytes:
//    63.7 MB for w_up, 19 us at 3.35 TB/s); A, the positions and the output
//    are a few KB. The card reaches its rate only with ~32 KB of values in
//    flight on every SM (3.35 TB/s x ~1.2 us of latency / 132 SMs).
//  - prefill (M = 1024): tensor-core operations (2 M K_c N at 989 TFLOP/s).
// What the design does about each:
//  - mma.sync m16n8k16 bf16 x bf16 -> f32 from shared memory by ldmatrix
//    (A as it lies, B with .trans: the row-major values give the .col
//    fragment directly, no packing step), the fragments of the next k16
//    step loaded before the current step's mmas. 8 warps a CTA: a 16 x 128
//    tile for M <= 16 (decode; warps of 16 x 16, two CTAs an SM), else
//    128 x 256 (2 x 4 warps of 64 x 64, 32 mmas a warp per k16 step, one
//    CTA an SM). The wide tile feeds each gathered A element to 256 output
//    columns; 128 x 128 was slower at every prefill shape (mma_ablation.py).
//  - B (the values) by cp.async in 16-byte chunks along N (`.cg`) into a
//    ring of STAGES stages of BK = 32 compressed columns: at decode eight
//    stages keep 7 x 8 KB = 56 KB of values in flight on a CTA. A narrow or
//    misaligned N takes the instance with B fetched through registers
//    element by element (BCH = 2), chosen on the host.
//  - A (`WordGather`) is gathered once a stage for the whole tile: a warp's
//    32 lanes take the stage's 32 compressed columns of one row, each lane
//    resolving its column's source (k / nnz) * bz + idx[k] once a stage for
//    all its rows (the block and the position advance incrementally; the
//    position is loaded a stage ahead), into a K_c-compact tile that
//    ldmatrix reads. Two ways, by tile:
//    - decode (little mma work a stage to hide a load behind): through the
//      ring, as deep in flight as the values. cp.async moves no 2-byte
//      piece, so each lane copies the aligned 4-byte word that holds its
//      element (4-byte aligned A, even K; refused on the host otherwise)
//      and, once the stage has landed, keeps the half it needs (`compact`).
//    - prefill: through registers, one 2-byte load an element fetched
//      before a stage's mmas and stored after them. With the words' extra
//      copy and compaction the gather was the larger part of a prefill
//      stage (mma_ablation.py); registers also free the words' 64 KB of
//      shared memory.
//    Not the dense window of a stage's blocks in 16-byte chunks: its width
//    depends on nnz (33 blocks a row at nnz = 1), so shared memory would be
//    sized for the worst format.
//  - K_c is split over a thread block cluster of `split` CTAs along x
//    where the tiles alone leave SMs idle (decode: tiles x split >= 132 SMs,
//    at most 16 CTAs a cluster) or end in a short wave (prefill: the split,
//    at most 8, that balances the waves; `split_of`):
//    each CTA sums its share of the stages into registers, parks the partial
//    tile in its own shared memory, and after a cluster barrier every CTA
//    sums one slice of the tile over the cluster's partials in rank order
//    through distributed shared memory and runs the flush. Deterministic (the
//    order is fixed), one launch, no workspace, no atomics; safe inside a
//    CUDA graph.
//  - Ragged edges are masked in the kernel: rows past M and columns past the
//    split's end load as zeros, columns past N are zeros and never stored.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "epilogue.cuh"

namespace bf16_mma {

namespace cg = cooperative_groups;

constexpr int BK = 32;          // compressed columns a stage, one a warp lane
constexpr int THREADS = 256;    // 8 warps
constexpr int SMALL_M = 16;     // M at or below this takes the 16 x 128 tile
constexpr int SMS = 132;        // the split aims at one CTA an SM of an H100
constexpr int IN_BF16 = 2;      // the wrappers' operand kind of bf16
enum OutKind { OUT_FLOAT32 = 1, OUT_INT8 = 2, OUT_BF16 = 3 };

// Per tile instance: the ring's depth, blocks an SM, the largest cluster
// (16 is above the portable 8: allowed per kernel), the warps' layout.
template <int BM, int BN>
struct Tile {
  static constexpr bool SMALL = BM == 16;
  static constexpr bool REG_A = !SMALL;          // A through registers, else by words
  static constexpr int STAGES = SMALL ? 8 : 4;
  static constexpr int MIN_BLOCKS = SMALL ? 2 : 1;
  static constexpr int MAX_SPLIT = SMALL ? 16 : 8;
  static constexpr int WARPS_M = BM >= 64 ? BM / 64 : 1;
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;             // m16 tiles a warp
  static constexpr int NT = WN / 8;              // n8 tiles a warp
  static constexpr int KS = BK / 16;             // k16 steps a stage
  static constexpr int A_ROWS = BM / 8;          // gathered rows a thread a stage
  static constexpr int B_CHUNKS = BK * BN / 8 / THREADS;  // 8-element chunks a thread
  static constexpr int BP = BN + 8;              // B row pitch (elements): 272 B at BN = 128
  static constexpr int AP = BK + 8;              // compact A row pitch: 80 B
  static constexpr int RP = BN + 8;              // fp32 partial row pitch
  static constexpr int B_BYTES = STAGES * BK * BP * 2;
  static constexpr int W_BYTES = REG_A ? 0 : STAGES * BM * BK * 4;
  static constexpr int C_BYTES = 2 * BM * AP * 2;
  static constexpr int S_BYTES = REG_A ? 0 : STAGES * BK;
  static constexpr int RING_BYTES = B_BYTES + W_BYTES + C_BYTES + S_BYTES;
  static constexpr int RED_BYTES = BM * RP * 4;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(NT % 2 == 0, "an ldmatrix.x4.trans of B covers two n8 tiles");
  static_assert(B_CHUNKS * 8 * THREADS == BK * BN && A_ROWS * 8 == BM, "tile and threads");
  static_assert(B_BYTES % 16 == 0 && W_BYTES % 16 == 0 && C_BYTES % 16 == 0, "alignment");
  static_assert(SMEM <= 232448, "shared memory of a CTA");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bytes, zero-extended, loaded only where `ok`; 0 elsewhere. A
// predicated load, not a branch (loads behind an `if` serialise).
__device__ __forceinline__ uint32_t ldg_u16_if(const void* p, bool ok) {
  uint32_t v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "=r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
  return v;
}

// A: the compressed columns of a row-major (M, lda) bf16 matrix, column k
// reading element (k / nnz) * bz + idx[k] of each row. `lda` is even and `a`
// 4-byte aligned (the host refuses otherwise), so the aligned word holding
// any element lies inside its row.
struct WordGather {
  const __nv_bfloat16* a;
  const int8_t* idx;  // (K_c,) positions in their block, shared by every column
  int lda, bz, nnz;
};

// Two outputs of neighbouring columns, stored as one when `pairs`.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

template <typename Out>
__device__ __forceinline__ void store_pair(Out* out, int m, int n, int N, bool pairs, float v0,
                                           float v1, const EpilogueArgs& ep) {
  Out* p = out + (size_t)m * N + n;
  if (pairs && n + 1 < N) {
    *reinterpret_cast<Pair<Out>*>(p) =
        Pair<Out>{epilogue_flush<float, Out>(v0, n, ep), epilogue_flush<float, Out>(v1, n + 1, ep)};
    return;
  }
  if (n < N) p[0] = epilogue_flush<float, Out>(v0, n, ep);
  if (n + 1 < N) p[1] = epilogue_flush<float, Out>(v1, n + 1, ep);
}

struct Args {
  const __nv_bfloat16* v;  // (K_c, N) values
  int M, N, K;             // K: the compressed K_c
  void* out;
  EpilogueArgs ep;
  int pairs;               // N even: neighbouring outputs stored together
};

template <int BM, int BN, int BCH, typename Out, typename Gather>
__global__ void __launch_bounds__(THREADS, Tile<BM, BN>::MIN_BLOCKS)
kernel(Gather ga, Args args) {
  using T = Tile<BM, BN>;
  constexpr int S = T::STAGES, AR = T::A_ROWS;
  static_assert(BCH == 16 || BCH == 2, "B in 16-byte chunks or through registers");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* Aw = reinterpret_cast<uint32_t*>(smem + T::B_BYTES);
  __nv_bfloat16* Ac = reinterpret_cast<__nv_bfloat16*>(smem + T::B_BYTES + T::W_BYTES);
  uint8_t* shf = smem + T::B_BYTES + T::W_BYTES + T::C_BYTES;

  const int M = args.M, N = args.N, K = args.K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
  const int split = gridDim.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  // this CTA's share of the stages: [kt0, kt1) of ceil(K / BK)
  const int kt_all = (K + BK - 1) / BK;
  const int kt0 = blockIdx.x * kt_all / split, kt1 = (blockIdx.x + 1) * kt_all / split;
  const int ktiles = kt1 - kt0;
  const int kend = min(kt1 * BK, K);
  const int rows = min(BM, M - m0);

  // the gather's state for the next stage of A: the lane's compressed
  // column k, its block q = k / nnz and position r = k % nnz in it, and its
  // idx[k], loaded a stage ahead
  int k = kt0 * BK + lane;
  int q = k / ga.nnz, r = k - q * ga.nnz;
  int pos = k < K ? __ldg(ga.idx + k) : 0;
  const int dq = BK / ga.nnz, dr = BK - dq * ga.nnz;
  const __nv_bfloat16* a_rows = ga.a + (size_t)(m0 + warp) * ga.lda;
  auto advance = [&]() {
    k += BK;
    q += dq;
    r += dr;
    if (r >= ga.nnz) {
      r -= ga.nnz;
      ++q;
    }
    pos = k < K ? __ldg(ga.idx + k) : 0;
  };

  // A by words (the small tile): the next stage's aligned 4-byte words into
  // ring slot `slot`, each lane's column's half recorded by warp 0
  auto load_words = [&](int slot) {
    const bool kok = k < kend;
    const int src = q * ga.bz + pos;
    if (warp == 0) shf[slot * BK + lane] = static_cast<uint8_t>(src & 1);
    const __nv_bfloat16* p = a_rows + (src & ~1);
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool ok = kok && warp + 8 * i < rows;
      cp_async<4>(smem_u32(&Aw[(slot * BM + warp + 8 * i) * BK + lane]),
                  ok ? p + (size_t)8 * i * ga.lda : ga.a, ok);
    }
    advance();
  };
  // stage kt's words, landed by this thread's own copies, into the compact
  // tile: each keeps the half its column's source points at
  auto compact = [&](int kt) {
    const int slot = kt % S, sh = shf[slot * BK + lane] * 16;
    uint16_t* dst = reinterpret_cast<uint16_t*>(Ac) + (kt & 1) * BM * T::AP;
#pragma unroll
    for (int i = 0; i < AR; ++i)
      dst[(warp + 8 * i) * T::AP + lane] =
          static_cast<uint16_t>(Aw[(slot * BM + warp + 8 * i) * BK + lane] >> sh);
  };
  // A through registers (the large tile): the next stage's elements, one
  // 2-byte load each, fetched before a stage's mmas and stored after them
  auto fetch_a = [&](uint32_t (&ra)[AR]) {
    const bool kok = k < kend;
    const __nv_bfloat16* p = a_rows + q * ga.bz + pos;
#pragma unroll
    for (int i = 0; i < AR; ++i)
      ra[i] = ldg_u16_if(p + (size_t)8 * i * ga.lda, kok && warp + 8 * i < rows);
    advance();
  };
  auto store_a = [&](int buf, const uint32_t (&ra)[AR]) {
    uint16_t* dst = reinterpret_cast<uint16_t*>(Ac) + buf * BM * T::AP;
#pragma unroll
    for (int i = 0; i < AR; ++i)
      dst[(warp + 8 * i) * T::AP + lane] = static_cast<uint16_t>(ra[i]);
  };
  // B: stage s of this CTA's range into ring slot `slot`
  auto load_b = [&](int s, int slot) {
    const int kb = (kt0 + s) * BK;  // the stage's first compressed column
#pragma unroll
    for (int j = 0; j < T::B_CHUNKS; ++j) {
      const int c = tid + j * THREADS;
      const int kr = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool krow = kb + kr < kend;
      __nv_bfloat16* dst = &Bs[(slot * BK + kr) * T::BP + col];
      const __nv_bfloat16* src_b = args.v + (size_t)(kb + kr) * N + n0 + col;
      if constexpr (BCH == 16) {
        const bool ok = krow && n0 + col < N;
        cp_async<16>(smem_u32(dst), ok ? src_b : args.v, ok);
      } else {
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = ldg_u16_if(src_b + e, krow && n0 + col + e < N);
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                                                    h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ktiles) {
      load_b(s, s);
      if constexpr (!T::REG_A) load_words(s);
    }
    cp_async_commit();
  }
  if constexpr (T::REG_A) {
    uint32_t ra[AR];
    fetch_a(ra);
    store_a(0, ra);
  }
  __syncthreads();  // warp 0's shifts of the first stages; A's stage 0

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<S - 2>();
    if constexpr (!T::REG_A) compact(kt);
    // stage kt's B and compact A visible; every warp done with stage kt - 1
    __syncthreads();
    if (kt + S - 1 < ktiles) {
      load_b(kt + S - 1, (kt + S - 1) % S);
      if constexpr (!T::REG_A) load_words((kt + S - 1) % S);
    }
    cp_async_commit();
    const bool more = T::REG_A && kt + 1 < ktiles;
    uint32_t ra[AR];
    if (more) fetch_a(ra);

    const __nv_bfloat16* A = Ac + (kt & 1) * BM * T::AP;
    const __nv_bfloat16* B = Bs + (kt % S) * BK * T::BP;
    // the fragments of k16 step ks + 1 are loaded before step ks's mmas
    uint32_t af[2][T::MT][4], bf[2][T::NT / 2][4];
    auto frags = [&](int ks, int buf) {
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(af[buf][i],
                    smem_u32(&A[(wm + i * 16 + lane % 16) * T::AP + ks * 16 + (lane / 16) * 8]));
      // one x4.trans covers two n8 tiles: registers 0, 1 are the first's
      // two k8 halves, registers 2, 3 the second's
#pragma unroll
      for (int p = 0; p < T::NT / 2; ++p)
        ldmatrix_x4_trans(bf[buf][p],
                          smem_u32(&B[(ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * T::BP + wn +
                                      p * 16 + (lane / 16) * 8]));
    };
    frags(0, 0);
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      if (ks + 1 < T::KS) frags(ks + 1, (ks + 1) % 2);
      const int b = ks % 2;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          mma_bf16(acc[i][j], af[b][i], bf[b][j / 2][(j % 2) * 2], bf[b][j / 2][(j % 2) * 2 + 1]);
    }
    if (more) store_a((kt + 1) & 1, ra);
  }

  // m16n8 accumulator fragment: elements (e0, e1) at row lane / 4, columns
  // 2 * (lane % 4) + {0, 1}; (e2, e3) eight rows below
  Out* out = static_cast<Out*>(args.out);
  const bool pairs = args.pairs != 0;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + lane / 4 + h * 8;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          store_pair<Out>(out, m, n0 + wn + j * 8 + (lane % 4) * 2, N, pairs, acc[i][j][h * 2],
                          acc[i][j][h * 2 + 1], args.ep);
      }
    return;
  }

  // split-K: the partial tile into this CTA's shared memory (the ring is
  // done), then each CTA sums a slice of the tile over the cluster in rank
  // order, four neighbouring columns at a time (16-byte loads of the
  // partials), and flushes it
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
        *reinterpret_cast<float2*>(
            &red[(wm + i * 16 + lane / 4 + h * 8) * T::RP + wn + j * 8 + (lane % 4) * 2]) =
            make_float2(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = rows * (BN / 4);
  for (int g = rank * THREADS + tid; g < groups; g += split * THREADS) {
    const float* part = &red[(g / (BN / 4)) * T::RP + (g % (BN / 4)) * 4];
    // every rank's partial loaded before any is added: the loads overlap
    float4 v[T::MAX_SPLIT];
#pragma unroll
    for (int s = 0; s < T::MAX_SPLIT; ++s)
      if (s < split) v[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s));
    float4 sum = v[0];
#pragma unroll
    for (int s = 1; s < T::MAX_SPLIT; ++s)
      if (s < split) sum.x += v[s].x, sum.y += v[s].y, sum.z += v[s].z, sum.w += v[s].w;
    const int m = m0 + g / (BN / 4), n = n0 + (g % (BN / 4)) * 4;
    store_pair<Out>(out, m, n, N, pairs, sum.x, sum.y, args.ep);
    store_pair<Out>(out, m, n + 2, N, pairs, sum.z, sum.w, args.ep);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// The split: at most MAX_SPLIT and the stages of K_c. The small tile
// (decode, bound by bytes) splits until tiles x split covers the SMs, so
// that enough of them pull the values. The large tile (bound by
// operations, one CTA an SM) splits only under 4 waves of tiles (beyond,
// a short last wave costs less than a split's ring fills and reduction:
// w_up's 576 tiles ran 8 % slower split in 2 on an H100), and takes the
// split whose waves of CTAs over the SMs cost the fewest stage times, a
// CTA costing its stages plus STAGES (filling the ring, and the flush or
// the reduction): 144 tiles on 132 SMs would otherwise run a second wave
// of 12 CTAs as long as the first.
template <int BM, int BN>
int split_of(int M, int N, int K) {
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ktiles = (K + BK - 1) / BK;
  const int most = Tile<BM, BN>::MAX_SPLIT < ktiles ? Tile<BM, BN>::MAX_SPLIT : ktiles;
  if (Tile<BM, BN>::SMALL) {
    if (tiles >= SMS) return 1;
    const int want = (int)((SMS + tiles - 1) / tiles);
    return want < most ? want : most;
  }
  if (tiles >= 4 * SMS) return 1;
  int best = 1;
  long long best_cost = (tiles + SMS - 1) / SMS * (ktiles + Tile<BM, BN>::STAGES);
  for (int s = 2; s <= most; ++s) {
    const long long cost =
        (tiles * s + SMS - 1) / SMS * ((ktiles + s - 1) / s + Tile<BM, BN>::STAGES);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

inline int b_chunk(int N, const void* v) {
  return N % 8 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 ? 16 : 2;
}

// `static`: the flag below is then this library's own (a function-local
// static of a function with external linkage is one object in the whole
// process, shared by every library that instantiates it).
template <int BM, int BN, int BCH, typename Out>
static cudaError_t launch_typed(const WordGather& ga, const Args& args, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto fn = kernel<BM, BN, BCH, Out, WordGather>;
  static bool configured = false;  // shared memory above 48 KB and clusters
  if (!configured) {                // above 8 CTAs, once an instance
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err == cudaSuccess && T::MAX_SPLIT > 8)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int split = split_of<BM, BN>(args.M, args.N, args.K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (args.M + BM - 1) / BM, (args.N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, ga, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile by M, the same rule as the wrapper's: 16 x 128 for M <= 16
// (decode), else 128 x 256.
template <int BCH, typename Out>
cudaError_t launch_rows(const WordGather& ga, const Args& args, cudaStream_t stream) {
  if (args.M <= SMALL_M) return launch_typed<16, 128, BCH, Out>(ga, args, stream);
  return launch_typed<128, 256, BCH, Out>(ga, args, stream);
}

template <typename Out>
cudaError_t launch_chunk(const WordGather& ga, const Args& args, cudaStream_t stream) {
  if (b_chunk(args.N, args.v) == 16) return launch_rows<16, Out>(ga, args, stream);
  return launch_rows<2, Out>(ga, args, stream);
}

// out_kind as the Python wrappers pass it: fp32, int8 codes (out_scale
// required) or bf16. A not 4-byte aligned or an odd K is refused.
inline cudaError_t launch(int out_kind, const WordGather& ga, const __nv_bfloat16* v, int M,
                          int N, int Kc, void* out, EpilogueArgs ep, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || Kc <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(ga.a) % 4 != 0 || ga.lda % 2 != 0) return cudaErrorInvalidValue;
  if (out_kind == OUT_INT8 && ep.out_scale == nullptr) return cudaErrorInvalidValue;
  Args args{v, M, N, Kc, out, ep,
            N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0 ? 1 : 0};
  switch (out_kind) {
    case OUT_BF16:
      return launch_chunk<__nv_bfloat16>(ga, args, stream);
    case OUT_FLOAT32:
      return launch_chunk<float>(ga, args, stream);
    case OUT_INT8:
      return launch_chunk<int8_t>(ga, args, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bf16_mma
