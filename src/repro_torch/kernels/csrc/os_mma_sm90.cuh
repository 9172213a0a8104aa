// Output-stationary int8 GEMM over the activation mux on Hopper's own
// datapath: TMA loads, the mux in shared memory, wgmma. The tc matmul's
// int8 branch at prefill row counts, for a product a plan has staged.
//
// Replaces, for those launches, os_mma.cuh's GatherMux x DenseTile instance
// (the port of repro/kernels/vdbb_matmul.py:_vdbb_tc_kernel). It computes
// the same product, out[m, n] = sum over k < K_c of
// a[m, (k / nnz) * bz + idx[k]] * v[k, n], as an exact int32 sum flushed
// by epilogue.cuh's epilogue_flush, unchanged.
//
// Bound on an H100 at starcoder2-7b's prefill (M = 1024, K_c = 3/8 K): the
// int8 tensor cores, 2 * M * K_c * N operations at 1 979 TOPS. What stood
// in the way in os_mma.cuh was its instruction count: A fetched one byte per
// load and stored one byte at a time, gathered again for every 64-column
// tile, B fetched byte by byte down each column, and mma.sync, which does
// not reach Hopper's int8 rate. Here, a thread block takes 128 x 128 output
// tiles in turn (persistent: as many clusters as the card holds, each
// walking its work items, so one tile's flush overlaps the next one's
// loads) and walks K in stages of 32 blocks of bz = 8:
//  - one thread of warpgroup 3 (the producer) keeps a ring of STAGES
//    stages filled by TMA, one mbarrier a stage: A's dense rows (128 x 256
//    bytes, two boxes in the 128-byte swizzle), B from the plan's K-major
//    copy of the values (128 x 32 bytes a k32 step, nnz steps, the 32-byte
//    swizzle) and the stage's 32 block selectors (a bulk copy). Two CTAs of
//    neighbouring column tiles form a cluster and share A: each loads one
//    of its two boxes into both (TMA multicast), and a stage is refilled
//    once both are done with it;
//  - warpgroup 2 (the mux) turns the dense rows into the wgmma A operand:
//    a thread a row reads its 256 dense bytes with 16-byte loads (conflict
//    free under the swizzle), picks each block's nnz kept bytes by one
//    byte permute on the block's two words (the selector's nibbles are
//    idx, shared by every row) and moves them to their compressed column
//    by constant permutes; 16-byte stores put them in the 32-byte swizzle
//    the descriptor names. No global byte loads: the 8/3 expansion is paid
//    in shared memory, once for a 128 x 128 tile;
//  - warpgroups 0 and 1 (the consumers) run wgmma.mma_async
//    m64n128k32 s8 x s8 -> s32 on both operands in shared memory, one
//    stage's group in flight while the next is queued, and hold the int32
//    accumulators in registers to the end, where each element is flushed
//    and stored.
// setmaxnreg moves registers from the producer's warpgroup to the mux and
// the consumers. What bounds it instead (kernels/mma_ablation.py, PERF.md):
// the ring's loads. With the mux and the wgmma both switched off it keeps
// about 90 % of its time at starcoder2-7b's shapes. What moved it: the
// cluster's shared A (15 % at w_up), persistent tiles (12 %); what did not:
// B as one bulk copy, a ring for the dense rows apart from the operands',
// a 256-column tile (slower: 0.276 against 0.200 ms at w_up).
//
// The accumulation is exact while K_c * 127 * 127 < 2^31 (MAX_K). The host
// checks what TMA needs: a 16-byte aligned A with K % 16 == 0, a K-major
// copy at a 16-byte aligned address and row pitch; bz = 8 and nnz <= 8.
// Rows at or past M, columns at or past N, dense bytes at or past K and
// compressed columns at or past K_c arrive as zeros (TMA's out-of-bounds
// fill); the selectors are padded to whole stages with zeros.
#pragma once

#include <cstdint>

#include <cuda.h>

#include "epilogue.cuh"

namespace os_mma_sm90 {

constexpr int BM = 128;                 // tile rows: two consumer warpgroups of 64
constexpr int BN = 128;                 // tile columns: one m64n128k32 step a k32 step
constexpr int BZ = 8;                   // the block size the mux is written for
constexpr int BLOCKS = 32;              // blocks of K a stage
constexpr int DENSE = BLOCKS * BZ;      // dense bytes of an A row a stage
constexpr int BOX = 128;                // bytes of K in a TMA box of A (its swizzle span)
constexpr int BOXES = DENSE / BOX;
constexpr int THREADS = 512;            // warpgroups 0, 1: consumers; 2: mux; 3: producer
constexpr int PRODUCER_WARP = 12;
constexpr int CLUSTER = 2;              // CTAs of neighbouring column tiles sharing A's loads
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may take
constexpr int MAX_K = 2147483647 / (127 * 127);
constexpr int MUX_ARRIVALS = 4;         // a mux warp's lane 0 each
// each consumer and mux warp's lane 0, of every CTA of the cluster: a stage
// is refilled (A by multicast) once the whole cluster is done with it
constexpr int EMPTY_ARRIVALS = CLUSTER * (8 + 4);
// registers a thread after setmaxnreg, within the 512 x 128 a block starts
// with: the producer's warpgroup gives up 88 a thread, the mux (its loads
// in flight) takes 32 and the consumers 24
constexpr int REGS_PRODUCER = 40, REGS_MUX = 160, REGS_CONSUMER = 152;

template <int NNZ>
struct Tile {
  static constexpr int KS = BLOCKS * NNZ;  // compressed bytes a stage: nnz k32 steps
  static constexpr int A_DENSE = BM * DENSE;
  static constexpr int A_MUX = BM * KS;
  static constexpr int B = BN * KS;
  static constexpr int SEL = BLOCKS * 8;   // two selector words a block
  static constexpr int OFF_MUX = A_DENSE, OFF_B = A_DENSE + A_MUX;
  static constexpr int STAGE = A_DENSE + A_MUX + B;  // a multiple of 1024
  // a stage in the ring, its selectors and its three barriers after the
  // ring; 1024 bytes to align the ring's start
  static constexpr int FIT = (SMEM_LIMIT - 1024) / (STAGE + SEL + 24);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = STAGES * (STAGE + SEL + 24) + 1024;
  static constexpr int TX = A_DENSE + B + SEL;        // bytes a stage's full barrier expects
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// --- shared memory, mbarriers, TMA, wgmma ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The same box into the same offset of every CTA in `mask`, each CTA's
// barrier at `bar` told of its bytes.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, int x,
                                                      int y, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar), "h"(mask)
      : "memory");
}

// An arrival on the barrier at `bar` in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor in the 32-byte swizzle, K-major: rows
// of 32 bytes (one k32 step), 8-row groups 256 bytes apart (SBO); the
// leading offset is unused when a step's K fits the swizzle's width.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32 | static_cast<uint64_t>(3) << 62;
}

#define OS_MMA_SM90_D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),      \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, this thread's 64) += A (64 x 32) * B (32 x 128), both from
// shared memory; the accumulators are always added to (they start at zero).
__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : OS_MMA_SM90_D8(0), OS_MMA_SM90_D8(8), OS_MMA_SM90_D8(16), OS_MMA_SM90_D8(24),
        OS_MMA_SM90_D8(32), OS_MMA_SM90_D8(40), OS_MMA_SM90_D8(48), OS_MMA_SM90_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef OS_MMA_SM90_D8

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// --- the mux ---------------------------------------------------------------

// A: the tc matmul's activation mux in shared memory. One thread a tile
// row: `mux` turns the row's DENSE bytes of a stage (two 128-byte rows of
// TMA boxes in the 128-byte swizzle: 16-byte group g of row r lies at
// g ^ (r % 8)) into its KS compressed bytes, nnz 32-byte k32 rows in the
// 32-byte swizzle (16-byte half h of row r lies at h ^ (r / 4 % 2)).
// Block b's two words (x, y) give its kept bytes by one permute whose
// nibbles are the block's positions (`sel`: slots 0-3, then 4-7); constant
// permutes then move each slot to its compressed column b * nnz + slot.
struct GatherMuxSmem {
  template <int NNZ>
  static __device__ __forceinline__ void mux(const uint8_t* dense, const uint4* sel, uint8_t* out,
                                             int r) {
    constexpr int KS = BLOCKS * NNZ;
    constexpr int PW = NNZ > 4 ? 2 : 1;  // permuted words a block
    uint32_t p[BLOCKS][PW];
    uint32_t w[KS / 4];
    const int swz = r % 8, half = r / 4 % 2;
#pragma unroll
    for (int g = 0; g < BLOCKS / 2; ++g) {  // the row's 16-byte groups: blocks 2g, 2g + 1
      const uint4 v = *reinterpret_cast<const uint4*>(dense + (g / 8) * BM * BOX + r * BOX +
                                                      (((g % 8) ^ swz) << 4));
      const uint4 s = sel[g];  // the two blocks' selectors (a broadcast)
      p[2 * g][0] = __byte_perm(v.x, v.y, s.x);
      p[2 * g + 1][0] = __byte_perm(v.z, v.w, s.z);
      if constexpr (PW == 2) {
        p[2 * g][PW - 1] = __byte_perm(v.x, v.y, s.y);
        p[2 * g + 1][PW - 1] = __byte_perm(v.z, v.w, s.w);
      }
      // the output words whose last byte these blocks hold
#pragma unroll
      for (int q = 0; q < KS / 4; ++q)
        if ((4 * q + 3) / NNZ / 2 == g) w[q] = word<NNZ, PW>(p, q);
      // and the 16-byte groups they complete
#pragma unroll
      for (int h = 0; h < KS / 16; ++h)
        if ((16 * h + 15) / NNZ / 2 == g)
          *reinterpret_cast<uint4*>(out + (h / 2) * BM * 32 + r * 32 + (((h % 2) ^ half) << 4)) =
              make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
    }
  }

  // Compressed columns 4q .. 4q + 3: each from its block's permuted word,
  // one permute per run of columns that word holds (all constant after
  // unrolling).
  template <int NNZ, int PW>
  static __device__ __forceinline__ uint32_t word(const uint32_t (&p)[BLOCKS][PW], int q) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * q + i, b = c / NNZ, j = c % NNZ;
      if (i > 0 && (c - 1) / NNZ == b && (c - 1) % NNZ / 4 == j / 4) continue;  // same run
      uint32_t s = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int ct = 4 * q + t;
        const bool run = ct / NNZ == b && ct % NNZ / 4 == j / 4;
        s |= static_cast<uint32_t>(run ? 4 + ct % NNZ % 4 : t) << (4 * t);
      }
      acc = __byte_perm(acc, p[b][j / 4], s);
    }
    return acc;
  }
};

// --- the kernel ------------------------------------------------------------

struct Args {
  const uint32_t* sel;  // (stages * 32, 2) block selectors, zero past the last block
  int M, N, stages;
  int tiles_m, items;   // row tiles; (row tile, cluster of column tiles) pairs
  void* out;
  int out_kind;         // os_gemm.cuh's OutKind: int32, fp32, int8 codes
  int pairs;            // N even and an 8-byte aligned output: two columns a store
  EpilogueArgs ep;
};

template <typename Out>
struct Pair {
  Out a, b;
};

template <typename Out>
__device__ __forceinline__ void store_pair(const Args& args, int m, int n, int32_t v0,
                                           int32_t v1) {
  Out* p = static_cast<Out*>(args.out) + (size_t)m * args.N + n;
  if (args.pairs && n + 1 < args.N) {
    *reinterpret_cast<Pair<Out>*>(p) = Pair<Out>{epilogue_flush<int32_t, Out>(v0, n, args.ep),
                                                 epilogue_flush<int32_t, Out>(v1, n + 1, args.ep)};
    return;
  }
  if (n < args.N) p[0] = epilogue_flush<int32_t, Out>(v0, n, args.ep);
  if (n + 1 < args.N) p[1] = epilogue_flush<int32_t, Out>(v1, n + 1, args.ep);
}

template <int NNZ, typename StageA>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
       Args args) {
  using T = Tile<NNZ>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzles are of address bits: every buffer starts on 1024 bytes
  uint8_t* const smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(smem);
  const uint32_t sels = base + S * T::STAGE, bars = sels + S * T::SEL;
  auto full = [&](int s) { return bars + 8 * s; };
  auto muxed = [&](int s) { return bars + 8 * (S + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * S + s); };
  auto stage = [&](int s) { return base + s * T::STAGE; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(muxed(s), MUX_ARRIVALS);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are ready before any multicast or remote arrival

  // persistent: cluster c takes work items c, c + clusters, ...: item i is
  // row tile i % tiles_m and column tiles (i / tiles_m) * CLUSTER + rank,
  // walked by every role in the same order, stage slots counted across them
  const int nst = args.stages;
  const uint32_t rank = cluster_rank();
  const int clusters = gridDim.x / CLUSTER, first = blockIdx.x / CLUSTER;
  auto tile_m0 = [&](int i) { return (i % args.tiles_m) * BM; };
  auto tile_n0 = [&](int i) { return ((i / args.tiles_m) * CLUSTER + (int)rank) * BN; };
  // a stage slot is free of this CTA's readers: told to each CTA of the cluster
  auto release = [&](int s) {
#pragma unroll
    for (uint32_t c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(empty(s), c);
  };

  if (warp >= PRODUCER_WARP) {  // the producer's warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER));
    if (warp == PRODUCER_WARP && lane == 0) {
      int kg = 0;  // stages requested so far
      for (int i = first; i < args.items; i += clusters) {
        const int m0 = tile_m0(i), n0 = tile_n0(i);
        for (int k = 0; k < nst; ++k, ++kg) {
          const int s = kg % S;
          if (kg >= S) mbar_wait(empty(s), (kg / S - 1) & 1);
          mbar_expect_tx(full(s), T::TX);
          // A's boxes, each loaded by one CTA of the cluster for all of
          // them (its rows are every CTA's: the cluster runs along N)
#pragma unroll
          for (int b = rank; b < BOXES; b += CLUSTER)
            tma_load_2d_multicast(stage(s) + b * BM * BOX, &map_a, k * DENSE + b * BOX, m0,
                                  full(s), (1u << CLUSTER) - 1);
#pragma unroll
          for (int c = 0; c < NNZ; ++c)
            tma_load_2d(stage(s) + T::OFF_B + c * BN * 32, &map_b, k * T::KS + c * 32, n0,
                        full(s));
          bulk_load(sels + s * T::SEL, args.sel + (size_t)k * BLOCKS * 2, T::SEL, full(s));
        }
      }
      // the last releases of every slot, the other CTA's included, have
      // arrived: no arrival comes after this CTA leaves
      for (int k = kg; k < kg + S; ++k)
        if (k >= S) mbar_wait(empty(k % S), (k / S - 1) & 1);
    }
  } else if (warp >= 8) {  // the mux: a thread a row
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_MUX));
    const int r = tid - 256;
    const int total = (args.items - first + clusters - 1) / clusters * nst;
    for (int k = 0; k < total; ++k) {
      const int s = k % S;
      mbar_wait(full(s), (k / S) & 1);
      uint8_t* const st = smem + s * T::STAGE;
      StageA::template mux<NNZ>(st, reinterpret_cast<const uint4*>(smem + S * T::STAGE + s * T::SEL),
                                st + T::OFF_MUX, r);
      // the generic proxy's stores, seen by wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(muxed(s));
        release(s);
      }
    }
  } else {  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER));
    const int wg = warp / 4;
    int kg = 0;  // stages consumed so far
    for (int item = first; item < args.items; item += clusters) {
      int32_t acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0;
      for (int k = 0; k < nst; ++k, ++kg) {
        const int s = kg % S;
        mbar_wait(full(s), (kg / S) & 1);
        mbar_wait(muxed(s), (kg / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NNZ; ++c)
          wgmma_n128(acc, desc_sw32(stage(s) + T::OFF_MUX + c * BM * 32 + wg * 64 * 32),
                     desc_sw32(stage(s) + T::OFF_B + c * BN * 32));
        wgmma_commit();
        wgmma_wait<1>();  // the stage before's products are done: its slot is free
        if (k > 0 && lane == 0) release((kg - 1) % S);
      }
      wgmma_wait<0>();
      if (lane == 0) release((kg - 1) % S);

      // the flush, while the producer and the mux fill the ring with the
      // next item's stages. m64nN accumulator: warp w of the warpgroup
      // holds rows 16 w + lane / 4 (+ 8); element 4 j + 2 i + e is column
      // 8 j + 2 (lane % 4) + e of row + 8 i
      const int row = tile_m0(item) + wg * 64 + (warp % 4) * 16 + lane / 4;
      const int n0 = tile_n0(item);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = row + 8 * i;
        if (m >= args.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * (lane % 4);
          const int32_t v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if (n >= args.N) continue;
          if (args.out_kind == 0) store_pair<int32_t>(args, m, n, v0, v1);
          else if (args.out_kind == 1) store_pair<float>(args, m, n, v0, v1);
          else store_pair<int8_t>(args, m, n, v0, v1);
        }
      }
    }
  }
}

// --- the host side ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda); `static`: this library's own.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D int8 map of `rows` x `cols` bytes, rows `pitch` bytes apart, read
// in boxes of box_rows x box_cols; out-of-bounds bytes arrive as zeros.
static bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int pitch,
                       int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NNZ>
static cudaError_t launch_typed(const int8_t* a, const int8_t* vt, int vt_pitch, int K, int Kc,
                                const Args& args, cudaStream_t stream) {
  using T = Tile<NNZ>;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, args.M, K, K, BM, BOX, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&map_b, vt, args.N, Kc, vt_pitch, BN, 32, CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  auto fn = kernel<NNZ, GatherMuxSmem>;
  static bool configured = false;  // shared memory above 48 KB, once an instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // the cluster runs along N: a last CTA past N (its B zeros, nothing
  // stored) still loads its share of A. As many clusters as the card holds
  // at once (persistent), at most one a work item.
  Args run = args;
  run.tiles_m = (args.M + BM - 1) / BM;
  run.items = run.tiles_m * (((args.N + BN - 1) / BN + CLUSTER - 1) / CLUSTER);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;  // clusters the card runs at once, once an instance
  if (resident == 0) {
    cfg.gridDim = dim3(CLUSTER * run.items);
    cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, fn, &cfg);
    if (err != cudaSuccess || resident <= 0) return err != cudaSuccess ? err : cudaErrorInvalidValue;
  }
  cfg.gridDim = dim3(CLUSTER * (run.items < resident ? run.items : resident));
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, map_a, map_b, run);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A (M, K) int8 at `a`, gathered through `sel` (the plan's block
// selectors, kernels/vdbb_matmul.py:mux_selectors) against `vt`, the
// values K-major: (N, K_c) rows `vt_pitch` bytes apart; out_kind as
// os_gemm.cuh's. Refuses what TMA cannot address and what the mux is not
// written for.
inline cudaError_t launch(int out_kind, const int8_t* a, const int8_t* vt, int vt_pitch,
                          const uint32_t* sel, int M, int N, int K, int bz, int nnz, void* out,
                          EpilogueArgs ep, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M <= 0 || N <= 0 || K <= 0 || bz != BZ || nnz < 1 || nnz > BZ || K % 16 != 0)
    return cudaErrorInvalidValue;
  const int Kc = K / BZ * nnz;
  if (Kc > MAX_K || vt_pitch < Kc || vt_pitch % 16 != 0 || !aligned(a) || !aligned(vt) ||
      !aligned(sel))
    return cudaErrorInvalidValue;
  if (out_kind < 0 || out_kind > 2 || (out_kind == 2 && ep.out_scale == nullptr))
    return cudaErrorInvalidValue;
  Args args{sel, M, N, (K / BZ + BLOCKS - 1) / BLOCKS, 0, 0, out, out_kind,
            N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0 ? 1 : 0, ep};
  switch (nnz) {
    case 1: return launch_typed<1>(a, vt, vt_pitch, K, Kc, args, stream);
    case 2: return launch_typed<2>(a, vt, vt_pitch, K, Kc, args, stream);
    case 3: return launch_typed<3>(a, vt, vt_pitch, K, Kc, args, stream);
    case 4: return launch_typed<4>(a, vt, vt_pitch, K, Kc, args, stream);
    case 5: return launch_typed<5>(a, vt, vt_pitch, K, Kc, args, stream);
    case 6: return launch_typed<6>(a, vt, vt_pitch, K, Kc, args, stream);
    case 7: return launch_typed<7>(a, vt, vt_pitch, K, Kc, args, stream);
    default: return launch_typed<8>(a, vt, vt_pitch, K, Kc, args, stream);
  }
}

}  // namespace os_mma_sm90
