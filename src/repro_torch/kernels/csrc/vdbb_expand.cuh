// The bw kernels' "late mux": the dense weight that a per-column compressed
// weight stands for, one element at a time (`vdbb_expand`, the fp32
// instantiation on os_gemm.cuh) or 8 rows of one column at a time
// (`ExpandTile`, the int8 instantiation on os_mma.cuh).
//
// Replaces repro/kernels/vdbb_matmul.py:dbb_expand_block. values (nb, nnz, N)
// and idx (nb, nnz, N/g), both row-major, give
//   W[b*bz + i, n] = sum_j [idx[b, j, n/g] == i] * values[b, j, n],
// with g the pattern-sharing group (1 per column). Positions within a
// block-column are distinct, so at most one term is nonzero and the sum is
// exact in int8 as in fp32; the sum form, not a search for the match, is
// the reference's. The TPU expands a whole (kb, nnz, bn) block in VMEM
// before its MXU dot; `vdbb_expand` expands each element as the GEMM's B
// tile is staged, at most nnz compares, with neighbouring threads on neighbouring n
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

// The int8 tensor-core path's stager of B (os_mma.cuh): the 8 bytes
// W[k8 .. k8+7, col], byte i holding row k8 + i, in two steps so that the
// loads of a stage are in flight while the mma's of the previous one run.
// With bz = 8 the 8 rows are one block column, and the reference's sum
// Σ_j [idx==i]·v, positions in a block column being distinct, takes for
// each byte i the one value whose position is i, or zero: a byte
// permutation. `fetch` reads each of the block's nnz values and positions
// once (2*nnz loads per 8 weight bytes, where vdbb_expand makes 2*nnz per
// byte), puts value j in byte j of (lo, hi) by byte permutes, and writes j
// into nibble idx[j] of the selector `sel`, whose other nibbles pick a zero
// byte; `pack` is two more byte permutes (PRMT). Another bz (8 rows may touch
// several blocks, or part of one) is summed in `fetch` as is and packed by
// the identity selector. Rows at or past K and columns at or past n are
// zero. The dense weight is never written to device memory.
struct ExpandTile {
  const int8_t* values;  // (nb, nnz, n)
  const int8_t* idx;     // (nb, nnz, n/g)
  int n, bz, nnz, g;

  struct Raw {
    uint32_t lo, hi, sel;
  };

  __device__ __forceinline__ Raw fetch(int k8, int col, int K) const {
    constexpr uint32_t kIdentity = 0x76543210u;
    if (col >= n || k8 >= K) return Raw{0, 0, kIdentity};
    const int ng = n / g, gcol = col / g;
    if (bz == 8) {
      const int8_t* vp = values + (size_t)(k8 / 8) * nnz * n + col;
      const int8_t* ip = idx + (size_t)(k8 / 8) * nnz * ng + gcol;
      // the loads of a half are unconditional and issued before any is used
      // (a j past nnz reads row 0 again, an L1 hit, and is never selected),
      // so no branch serialises their latencies; nnz <= 4 skips the second
      // half
      uint32_t v[8], q[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t jj = j < nnz ? j : 0;
        v[j] = static_cast<uint8_t>(__ldg(vp + jj * n));
        q[j] = static_cast<uint8_t>(__ldg(ip + jj * ng));
      }
      Raw r;
      r.lo = __byte_perm(__byte_perm(v[0], v[1], 0x40), __byte_perm(v[2], v[3], 0x40), 0x5410);
      if (nnz <= 4) {
        // byte 4 (hi's first) is zero: the nibbles of absent positions pick it
        r.hi = 0;
        r.sel = 0x44444444u;
#pragma unroll
        for (int j = 0; j < 4; ++j) r.sel ^= j < nnz ? (4u ^ j) << (4 * q[j]) : 0u;
        return r;
      }
#pragma unroll
      for (int j = 4; j < 8; ++j) {
        const size_t jj = j < nnz ? j : 0;
        v[j] = static_cast<uint8_t>(__ldg(vp + jj * n));
        q[j] = static_cast<uint8_t>(__ldg(ip + jj * ng));
      }
      // bytes nnz..7 zeroed: byte nnz & 7 is the zero the absent positions
      // pick (with nnz = 8 every nibble is overwritten)
      r.hi = __byte_perm(__byte_perm(v[4], v[5], 0x40), __byte_perm(v[6], v[7], 0x40), 0x5410) &
             (0xffffffffu >> (8 * (8 - nnz)));
      const uint32_t z = static_cast<uint32_t>(nnz & 7);
      r.sel = z * 0x11111111u;
#pragma unroll
      for (int j = 0; j < 8; ++j) r.sel ^= j < nnz ? (z ^ j) << (4 * q[j]) : 0u;
      return r;
    }
    uint64_t w = 0;
    const int kend = k8 + 8 < K ? k8 + 8 : K;
    for (int b = k8 / bz; b * bz < kend; ++b) {
      for (int j = 0; j < nnz; ++j) {
        const size_t row = (size_t)b * nnz + j;
        const uint8_t v = static_cast<uint8_t>(__ldg(values + row * n + col));
        const int pos = b * bz + __ldg(idx + row * ng + gcol) - k8;
        if (pos >= 0 && pos < 8) w += static_cast<uint64_t>(v) << (8 * pos);
      }
    }
    return Raw{static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32), kIdentity};
  }

  __device__ __forceinline__ uint64_t pack(const Raw& r) const {
    const uint32_t lo = __byte_perm(r.lo, r.hi, r.sel & 0xffffu);
    const uint32_t hi = __byte_perm(r.lo, r.hi, r.sel >> 16);
    return static_cast<uint64_t>(hi) << 32 | lo;
  }
};
