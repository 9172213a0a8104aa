// The tc kernels' stagers on the int8 tensor cores (os_mma.cuh): the
// activation mux as a stager of A, over a matrix (`GatherMux`, the head) or
// over a conv's taps (`TapMux`), and the compressed values as they lie as a
// stager of B (`DenseTile`).
//
// Replaces, for int8 operands, the TPU's one-hot MXU contraction of
// repro/kernels/vdbb_matmul.py:_vdbb_tc_kernel: with one pattern shared by
// every output column, compressed column k of the reduction reads
//   A[m, (k / nnz) * bz + idx[k]]
// for all N alike, so the product runs over the compressed K_c = nb * nnz
// against the (K_c, N) values, and the gather is done once per tile of
// columns, not once per column.
#pragma once

#include <cstddef>
#include <cstdint>

// Eight bytes, each the low byte of a word, into one little-endian uint64
// (byte i from v[i]): three byte permutes (PRMT) per 4 bytes.
__device__ __forceinline__ uint64_t pack_bytes8(const uint32_t (&v)[8]) {
  const uint32_t lo =
      __byte_perm(__byte_perm(v[0], v[1], 0x40), __byte_perm(v[2], v[3], 0x40), 0x5410);
  const uint32_t hi =
      __byte_perm(__byte_perm(v[4], v[5], 0x40), __byte_perm(v[6], v[7], 0x40), 0x5410);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// A: the compressed columns of a row-major (M, lda) int8 matrix, staged
// through registers in byte lanes (os_mma.cuh's register path). The offsets
// of a stage's 64 compressed columns are resolved once per stage, one
// division each (`source`), and shared by every row of the tile. A warp's 32
// lanes then load 32 neighbouring compressed columns of one row
// (`fetch_byte`), about 32 / nnz blocks of bz bytes, so a warp's load reads
// one or two lines.
//
// Byte loads, not 8-byte blocks picked apart by PRMT: 8 compressed columns
// span ceil(8 / nnz) + 1 blocks of bz bytes, a number that depends on nnz and
// on where the group starts, so a block-wise extract needs a block loop and
// a selector per block. The byte gather is the same load for every nnz and
// bz, and a row of A (512 bytes for the head) stays in L1, so the loads cost
// issue slots, not memory traffic.
//
// Rows at or past M read row M - 1 (their outputs are never stored);
// compressed columns at or past K read byte 0 of the row (B is zero there).
struct GatherMux {
  static constexpr bool kRegisters = true;
  const int8_t* a;
  const int8_t* idx;  // (K_c,) positions in their block, shared by every column
  int lda, bz, nnz;

  using Row = const int8_t*;

  __device__ __forceinline__ Row row(int m, int M) const {
    return a + (size_t)(m < M ? m : M - 1) * lda;
  }

  __device__ __forceinline__ int source(int k, int K) const {
    return k < K ? (k / nnz) * bz + __ldg(idx + k) : 0;
  }

  __device__ __forceinline__ uint32_t fetch_byte(Row r, int src) const {
    return static_cast<uint8_t>(__ldg(r + src));
  }
};

// One byte, zero-extended, loaded only where `ok`; 0 elsewhere. A predicated
// load, not a branch (loads behind an `if` serialise) and not a select of a
// clamped address: a MOV and an @P LDG.
__device__ __forceinline__ uint32_t ldg_u8_if(const int8_t* p, bool ok) {
  uint32_t v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.nc.u8 %0, [%1];\n}\n"
      : "=r"(v)
      : "l"(p), "r"(static_cast<int>(ok)));
  return v;
}

// A: the tc conv's activation mux over the IM2COL unit's shifted view of an
// NHWC int8 input (vdbb_conv_tc.cu), staged through registers like
// `GatherMux`. Compressed column k of the implicit GEMM belongs to block
// b = k / nnz = t*cb + c/bz of tap t = (dy, dx) and reads input channel
// (b % cb)*bz + idx[k] of the pixel that tap sees, zero outside the image.
//
// - Per stage (`source`, one column a thread for 64 threads): the column's
//   tap t and its offset (dy*w + dx)*c + ch from a row's tap-(0, 0) pixel,
//   packed as t << TAP_SHIFT | offset. A 64-column stage may span many
//   taps (a tap holds cb*nnz columns, 24 at C = 64, nnz = 3); each column
//   resolves its own, so the compressed K is one run with no padding per
//   tap.
// - Per row, once a tile (`row`): the address of the row's tap-(0, 0)
//   pixel (n, oy*sh - pt, ox*sw - pl), which may lie outside the image, and
//   a mask with bit t set where tap t lies inside it. The mask carries the
//   padding (SAME, VALID or explicit) and the stride.
// - Per byte (`fetch_byte`): a predicated load of row + offset on the tap's
//   bit. In os_mma.cuh's byte lanes a warp's 32 lanes load 32 neighbouring
//   columns of one row, which lie in one or two taps of one pixel, so a
//   warp's load reads one to three lines (a thread loading 8 neighbouring
//   columns of each of 4 rows instead made a warp's load read 4 rows' lines,
//   and was 10-24 % slower at l1, l3 and l7; PERF.md).
//
// The host (core.mma_tap_plan) and the entry point refuse what the packing
// cannot hold (`fits`): more than 32 taps, or an offset of 2^27 or more.
// Rows at or past M read row M - 1 (their outputs are never stored);
// compressed columns at or past K read tap 0, channel 0 (B is zero there).
struct TapMux {
  static constexpr bool kRegisters = true;
  static constexpr int TAP_SHIFT = 27;  // the tap in the top 5 bits
  static constexpr uint32_t OFFSET_MASK = (1u << TAP_SHIFT) - 1u;
  const int8_t* x;
  const int8_t* idx;  // (K_c,) positions in their block, shared by every column
  int h, w, c, ho, wo, sh, sw, pt, pl, kh, kw, cb, bz, nnz;

  static __host__ __device__ bool fits(int w, int c, int kh, int kw) {
    return kh > 0 && kw > 0 && kh * kw <= 32 &&
           ((long long)(kh - 1) * w + kw) * c <= (1ll << TAP_SHIFT);
  }

  struct __align__(16) Row {
    const int8_t* p;  // the row's tap-(0, 0) pixel
    uint32_t taps;    // bit t: tap t inside the image
  };

  __device__ __forceinline__ Row row(int m, int M) const {
    m = m < M ? m : M - 1;
    const int ox = m % wo, r = m / wo;
    const int oy = r % ho, n = r / ho;
    const int iy0 = oy * sh - pt, ix0 = ox * sw - pl;
    // dx in [lo, hi) lands inside the image's width
    const int lo = ix0 < 0 ? -ix0 : 0, hi = w - ix0 < kw ? w - ix0 : kw;
    uint32_t cols = 0;
    if (hi > lo) cols = (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
    uint32_t taps = 0;
    for (int dy = 0; dy < kh; ++dy) {
      const int iy = iy0 + dy;
      if (iy >= 0 && iy < h) taps |= cols << (dy * kw);
    }
    return Row{x + (((long long)n * h + iy0) * w + ix0) * c, taps};
  }

  __device__ __forceinline__ int source(int k, int K) const {
    if (k >= K) return 0;
    const int blk = k / nnz, t = blk / cb;
    const int ch = (blk - t * cb) * bz + __ldg(idx + k);
    const int dy = t / kw, dx = t - dy * kw;
    return static_cast<int>(static_cast<uint32_t>(t) << TAP_SHIFT |
                            static_cast<uint32_t>((dy * w + dx) * c + ch));
  }

  __device__ __forceinline__ uint32_t fetch_byte(const Row& r, int src) const {
    const uint32_t s = static_cast<uint32_t>(src);
    // the tap's bit and the offset depend on the column only: unpacked once
    // a stage for all of a thread's rows after inlining
    return ldg_u8_if(r.p + (s & OFFSET_MASK), (r.taps & 1u << (s >> TAP_SHIFT)) != 0u);
  }

};

// TapMux at kh = kw = 1 (a ResNet's 1 x 1 convs and projections), the same
// code under a type of its own, so a device trace tells a 1 x 1 conv's
// launches from a 3 x 3's (os_mma::kernel<..., PointMux, ...>).
struct PointMux : TapMux {};

// B: a dense row-major (K, n) int8 matrix, the tc kernels' compressed values
// (nb, nnz, n) read as (K_c, n). `fetch` makes 8 byte loads down column
// `col` (neighbouring threads take neighbouring columns, so each load of a
// warp reads 32 neighbouring bytes of one row); `pack` makes them the 8
// K-major bytes the mma takes. Rows at or past K are zero; columns at or
// past n read column n - 1 (their outputs are never stored). The loads are
// unconditional, from a clamped row, and the zeros are selected after them.
struct DenseTile {
  const int8_t* b;
  int n;

  struct Raw {
    uint32_t v[8];
  };

  __device__ __forceinline__ Raw fetch(int k8, int col, int K) const {
    const int8_t* p = b + (col < n ? col : n - 1);
    Raw raw;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k8 + i;
      const uint32_t v = static_cast<uint8_t>(__ldg(p + (size_t)(k < K ? k : K - 1) * n));
      raw.v[i] = k < K ? v : 0u;
    }
    return raw;
  }

  __device__ __forceinline__ uint64_t pack(const Raw& raw) const { return pack_bytes8(raw.v); }
};
