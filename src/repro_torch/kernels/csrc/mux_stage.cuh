// The tc kernels' stagers on the int8 tensor cores (os_mma.cuh): the
// activation mux as a stager of A (`GatherMux`), and the compressed values
// as they lie as a stager of B (`DenseTile`).
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
// through registers (os_mma.cuh's register path). The offsets of a stage's
// 64 compressed columns are resolved once per stage, one division each
// (`source`), and shared by every row of the tile. A thread then gathers 8
// bytes of a row with 8 byte loads and packs them with 6 PRMTs.
//
// Byte loads, not 8-byte blocks picked apart by PRMT: 8 compressed columns
// span ceil(8 / nnz) + 1 blocks of bz bytes, a number that depends on nnz and
// on where the group starts, so a block-wise extract needs a block loop and
// a selector per block. The byte gather is the same 8 loads and 6 PRMTs for
// every nnz and bz, and a row of A (512 bytes for the head) stays in L1, so
// the loads cost issue slots, not memory traffic.
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

  struct Raw {
    uint32_t v[8];
  };

  __device__ __forceinline__ Raw fetch(Row r, const int (&off)[8]) const {
    Raw raw;
#pragma unroll
    for (int j = 0; j < 8; ++j) raw.v[j] = static_cast<uint8_t>(__ldg(r + off[j]));
    return raw;
  }

  __device__ __forceinline__ uint64_t pack(const Raw& raw) const { return pack_bytes8(raw.v); }
};

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
