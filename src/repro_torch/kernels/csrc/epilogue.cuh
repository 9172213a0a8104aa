// Accumulator-flush epilogue shared by every kernel of the port.
//
// Replaces the flush of repro/kernels/core.py:os_accumulate (the `_store`
// branch): dequantize, add the bias, ReLU, requantize to int8. It runs once
// per output element, after the K loop, in the reference's order, and each
// step rounds once as it does there. The explicit `_rn` intrinsics are never
// contracted into a fused multiply-add: nvcc would otherwise turn
// `acc * scale + bias` into one FMA (its default --fmad=true), and the
// single rounding would move int8 codes by one against the reference.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct EpilogueArgs {
  const float* scale;      // (N,) dequantization scale, or nullptr
  const float* bias;       // (N,) bias, or nullptr
  const float* out_scale;  // (N,) requantization scale, or nullptr
  int relu;                // clamp at zero
};

__device__ __forceinline__ float acc_to_float(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_float(float v) { return v; }

// The residual operand of a ResNet block's last conv: int8 codes laid out
// as the output, (M, N), and their per-tensor scale, one float on the card
// (read there, so a captured graph needs no host value).
struct ResidualArgs {
  const int8_t* codes;
  const float* scale;
};

// A residual element dequantized: code x scale, rounded once.
__device__ __forceinline__ float residual_value(const ResidualArgs& r, size_t i) {
  return __fmul_rn(__int2float_rn(r.codes[i]), *r.scale);
}

// Out is int32_t only for the raw integer accumulator (ReLU at most), float
// when a scale or bias moves the tile to fp32, int8_t when requantizing,
// __nv_bfloat16 for bf16 operands (rounded once, to nearest even).
// `Residual` (compile time; a ResNet block's last conv) adds `res`, the
// residual element already dequantized, after the bias and before ReLU,
// rounded once; without it the flush is the plain one, unchanged.
template <typename Acc, typename Out, bool Residual = false>
__device__ __forceinline__ Out epilogue_flush(Acc acc, int n, const EpilogueArgs& ep,
                                              float res = 0.0f) {
  if constexpr (std::is_same<Out, int32_t>::value) {
    static_assert(std::is_same<Acc, int32_t>::value, "int32 output needs an int32 accumulator");
    static_assert(!Residual, "a residual is added to a dequantized output");
    return (ep.relu && acc < 0) ? 0 : acc;
  } else {
    float y = acc_to_float(acc);
    if (ep.scale != nullptr) y = __fmul_rn(y, ep.scale[n]);
    if (ep.bias != nullptr) y = __fadd_rn(y, ep.bias[n]);
    if constexpr (Residual) y = __fadd_rn(y, res);
    // NaN passes ReLU as it does through jnp.maximum (fmaxf would give 0);
    // -0 stays -0, which compares equal to 0
    if (ep.relu) y = y < 0.0f ? 0.0f : y;
    if constexpr (std::is_same<Out, int8_t>::value) {
      // round half to even (rintf), as jnp.round does; IEEE division. A zero
      // dividend (after ReLU, about half the outputs) would take the
      // division's slow path; 0 / s is +-0, code 0 either way, so it skips
      // the division. NaN still takes it.
      float q = y == 0.0f ? 0.0f : rintf(__fdiv_rn(y, ep.out_scale[n]));
      // a NaN quotient is code 0, as the reference's clip + int8 cast gives
      // on its devices; the clip (fmaxf would make it -127) and the cast (of
      // a NaN, undefined) never see one
      q = q != q ? 0.0f : fminf(fmaxf(q, -127.0f), 127.0f);
      return static_cast<int8_t>(q);
    } else if constexpr (std::is_same<Out, __nv_bfloat16>::value) {
      return __float2bfloat16_rn(y);
    } else {
      return y;
    }
  }
}

// How a GEMM core flushes output element (m, n), at offset mn = m * N + n:
// the plain flush, or with the residual operand (a compile-time variant, so
// a kernel's name in a device trace tells the two apart).
struct PlainFlush {
  static constexpr bool kResidual = false;
  EpilogueArgs ep;
  template <typename Out>
  __device__ __forceinline__ Out apply(int32_t acc, size_t, int n) const {
    return epilogue_flush<int32_t, Out>(acc, n, ep);
  }
};

struct ResidualFlush {
  static constexpr bool kResidual = true;
  EpilogueArgs ep;
  ResidualArgs res;
  template <typename Out>
  __device__ __forceinline__ Out apply(int32_t acc, size_t mn, int n) const {
    return epilogue_flush<int32_t, Out, true>(acc, n, ep, residual_value(res, mn));
  }
};
