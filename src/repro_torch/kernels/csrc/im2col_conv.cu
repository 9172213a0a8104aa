// Dense fused IM2COL convolution, NHWC input, HWIO weight.
//
// Replaces repro/kernels/im2col_conv.py:_im2col_conv_kernel (im2col_conv).
// M = N*Ho*Wo output pixels, K = kh*kw*C ordered (dy, dx, c), N = F. On the
// int8-resident chain it is the fp32 C = 3 stem, whose epilogue fuses bias,
// ReLU and the requantize to int8. Two paths, chosen by the wrapper from the
// shape (kernels/im2col_conv.py:conv_path), never as a fallback:
//  - `direct_conv` (fp32, when a block's input halo and weight slice fit
//    SMEM_BYTES of shared memory; the stem);
//  - the implicit GEMM on os_gemm.cuh (int8, and fp32 at larger C): the left
//    operand read straight from the unpadded input through the tap's
//    shifted view (`Tap`, im2col_tap.cuh), zero outside the image, so the
//    kh*kw-duplicated im2col tensor never exists.
//
// Bound on an H100 at sparse-cnn-s batch 64 (64x64 images, C = 3, F = 64):
// operations, 2*M*27*64 = 0.91 GFLOP at the 67 TFLOP/s of fp32 FFMA on the
// CUDA cores, 13.5 us; its bytes (3.1 MB in, 16.8 MB of int8 codes out) take
// 6 us. What the direct path does about it: K = 27 is too short for a GEMM's
// K loop over shared stages (two 16-deep stages padded out of 27, A
// element-wise with a div/mod chain, the weight tile staged again at every
// stage). A block instead stages, once, the input halo of a 4 x 32 pixel
// tile of one image (row runs of contiguous floats) and the weight slice of
// 64 filters; each thread keeps 4 pixels x 8 filters in registers and walks
// the 27 taps with 32 FFMAs to 6 shared loads; 4 blocks an SM (32 warps)
// hide latency (a 4 x 16 thread tile at 2 blocks an SM was slower;
// kernels/mma_ablation.py times both). The flush is epilogue.cuh's, once per
// output, its IEEE division kept (exactness first); a ReLU zero sends that
// division down its slow path (FCHK flags a zero dividend), a call per
// output, and half the stem's outputs are zero. A pixel's 8 int8 codes
// leave in one 8-byte store.
#include "im2col_tap.cuh"
#include "maxpool.cuh"
#include "os_gemm.cuh"

namespace direct_conv {

constexpr int TH = 4;                            // output rows of a block's tile
constexpr int TW = 32;                           // output columns of a block's tile
constexpr int BF = 64;                           // filters of a block
constexpr int FT = 8;                            // filters of a thread
constexpr int PX = 4;                            // pixels of a thread, PY rows apart
constexpr int MIN_BLOCKS = 4;                    // blocks an SM: 32 warps hide the
                                                 // flush's latency
constexpr int FGROUPS = BF / FT;
constexpr int THREADS = TH * TW * FGROUPS / PX;  // 256
constexpr int PY = THREADS / FGROUPS / TW;       // 1
constexpr int WPAD = FT + 4;      // a group's filters padded by 4 floats: the
                                  // groups' 16-byte loads hit disjoint banks
constexpr int WROW = FGROUPS * WPAD;             // floats per weight row (one k)
constexpr int SMEM_BYTES = 66 * 1024;            // the wrapper's DIRECT_SMEM_BYTES: the
                                                 // 7 x 7 stride-2 stem at C = 3 (ResNet's,
                                                 // 65.6 KB) fits, three blocks an SM
static_assert(PY * PX == TH && THREADS == 256, "a thread's pixels cover the tile's rows");
static_assert(FT == 8 || FT == 16, "a pixel's codes leave in one 8- or 16-byte store");

// The geometry of a conv and the input it reads.
struct HaloTile {
  const float* x;  // (n, h, w, c)
  int h, w, c, ho, wo, kh, kw, sh, sw, pt, pl;

  __host__ __device__ int rows() const { return (TH - 1) * sh + kh; }
  __host__ __device__ int run() const { return ((TW - 1) * sw + kw) * c; }  // floats a halo row
  __host__ __device__ int halo_floats() const { return (rows() * run() + 3) / 4 * 4; }
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)(halo_floats() + kh * kw * c * WROW) * sizeof(float);
  }
};

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x40), __byte_perm(c, d, 0x40), 0x5410);
}

// A pixel's FT outputs of filters fb .. fb + FT - 1: int8 codes in one
// FT-byte store, fp32 in 16-byte stores.
__device__ __forceinline__ void store_group(int8_t* o, const float (&acc)[FT], int fb,
                                            const EpilogueArgs& ep) {
  uint32_t q[FT], wd[FT / 4];
#pragma unroll
  for (int f = 0; f < FT; ++f)
    q[f] = static_cast<uint8_t>(epilogue_flush<float, int8_t>(acc[f], fb + f, ep));
#pragma unroll
  for (int i = 0; i < FT / 4; ++i) wd[i] = pack4(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
  if constexpr (FT == 16)
    *reinterpret_cast<uint4*>(o) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  else
    *reinterpret_cast<uint2*>(o) = make_uint2(wd[0], wd[1]);
}

__device__ __forceinline__ void store_group(float* o, const float (&acc)[FT], int fb,
                                            const EpilogueArgs& ep) {
#pragma unroll
  for (int f = 0; f < FT; f += 4)
    *reinterpret_cast<float4*>(o + f) = make_float4(
        epilogue_flush<float, float>(acc[f], fb + f, ep),
        epilogue_flush<float, float>(acc[f + 1], fb + f + 1, ep),
        epilogue_flush<float, float>(acc[f + 2], fb + f + 2, ep),
        epilogue_flush<float, float>(acc[f + 3], fb + f + 3, ep));
}

// grid: (column tiles, row tiles, images x filter tiles). `vec`: F and the
// output allow a group's vector stores.
template <typename Out>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
kernel(HaloTile t, const float* __restrict__ wt, int F, int vec, Out* __restrict__ out,
       EpilogueArgs ep) {
  extern __shared__ __align__(16) float smem[];
  const int run = t.run(), K = t.kh * t.kw * t.c;
  float* halo = smem;                     // [rows][run]
  float* ws = smem + t.halo_floats();     // [K][WROW]
  const int tiles_f = (F + BF - 1) / BF;
  const int img = blockIdx.z / tiles_f, f0 = (blockIdx.z - img * tiles_f) * BF;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * t.sh - t.pt, ix0 = ox0 * t.sw - t.pl;

  // the input halo, zero outside the image: a halo row is one run of
  // contiguous floats of the NHWC input, read by neighbouring threads
  const float* xi = t.x + (size_t)img * t.h * t.w * t.c;
  for (int e = threadIdx.x; e < t.rows() * run; e += THREADS) {
    const int r = e / run, q = e - r * run;
    const int iy = iy0 + r, ix = ix0 + q / t.c;
    float v = 0.0f;
    if (iy >= 0 && iy < t.h && ix >= 0 && ix < t.w)
      v = __ldg(xi + ((long long)iy * t.w + ix0) * t.c + q);
    halo[e] = v;
  }
  // the weight slice of filters f0 .. f0 + BF - 1, zero past F
  for (int e = threadIdx.x; e < K * BF; e += THREADS) {
    const int k = e / BF, fl = e - k * BF, f = f0 + fl;
    ws[k * WROW + (fl / FT) * WPAD + fl % FT] = f < F ? __ldg(wt + (size_t)k * F + f) : 0.0f;
  }
  __syncthreads();

  // neighbouring threads take a pixel's filter groups, then neighbouring
  // pixels of a row: a warp's stores of a group are contiguous
  const int fg = threadIdx.x % FGROUPS, lp = threadIdx.x / FGROUPS;
  const int py = lp / TW, px = lp % TW;
  const int pstep = PY * t.sh * run;      // halo floats between a thread's pixels
  const float* hp = halo + py * t.sh * run + px * t.sw * t.c;
  const float* wp = ws + fg * WPAD;
  float acc[PX][FT];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[j][f] = 0.0f;

  for (int dy = 0; dy < t.kh; ++dy)
    for (int dx = 0; dx < t.kw; ++dx) {
      const float* hq = hp + dy * run + dx * t.c;
      const float* wq = wp + (dy * t.kw + dx) * t.c * WROW;
      for (int ch = 0; ch < t.c; ++ch) {
        float a[PX], wv[FT];
#pragma unroll
        for (int j = 0; j < PX; ++j) a[j] = hq[j * pstep + ch];
        const float4* w4 = reinterpret_cast<const float4*>(wq + ch * WROW);
#pragma unroll
        for (int q = 0; q < FT / 4; ++q) {
          const float4 v = w4[q];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < PX; ++j)
#pragma unroll
          for (int f = 0; f < FT; ++f) acc[j][f] = fmaf(a[j], wv[f], acc[j][f]);
      }
    }

  const int fb = f0 + fg * FT;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int oy = oy0 + py + PY * j, ox = ox0 + px;
    if (oy >= t.ho || ox >= t.wo) continue;
    Out* o = out + (((size_t)img * t.ho + oy) * t.wo + ox) * F + fb;
    if (vec && fb + FT <= F) {
      store_group(o, acc[j], fb, ep);
    } else {
#pragma unroll
      for (int f = 0; f < FT; ++f)
        if (fb + f < F) o[f] = epilogue_flush<float, Out>(acc[j][f], fb + f, ep);
    }
  }
}

template <typename Out>
cudaError_t launch_typed(const HaloTile& t, const float* wt, int n, int f, void* out,
                         EpilogueArgs ep, cudaStream_t stream) {
  const int tiles_f = (f + BF - 1) / BF;
  // int8: a pixel's group of FT codes is FT-aligned when F is a multiple of
  // FT; fp32: 16-aligned when F is a multiple of 4
  const int vec = f % (sizeof(Out) == 1 ? FT : 4) == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dim3 grid((t.wo + TW - 1) / TW, (t.ho + TH - 1) / TH, n * tiles_f);
  static bool configured = false;  // shared memory above 48 KB, once an instance
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<Out><<<grid, THREADS, t.smem_bytes(), stream>>>(t, wt, f, vec, static_cast<Out*>(out),
                                                         ep);
  return cudaGetLastError();
}

// fp32 operands only; fp32 or int8 (requantized) output.
cudaError_t launch(int out_kind, const HaloTile& t, const float* wt, int n, int f, void* out,
                   EpilogueArgs ep, cudaStream_t stream) {
  if (n <= 0 || f <= 0 || t.ho <= 0 || t.wo <= 0 || t.smem_bytes() > SMEM_BYTES ||
      (long long)n * ((f + BF - 1) / BF) > 65535 || (t.ho + TH - 1) / TH > 65535)
    return cudaErrorInvalidValue;
  switch (out_kind) {
    case os_gemm::OUT_FLOAT32:
      return launch_typed<float>(t, wt, n, f, out, ep, stream);
    case os_gemm::OUT_INT8:
      if (ep.out_scale == nullptr) return cudaErrorInvalidValue;
      return launch_typed<int8_t>(t, wt, n, f, out, ep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace direct_conv

template <typename T>
static cudaError_t run_gemm(const void* x, const void* wt, EpilogueArgs ep, void* out,
                            int out_kind, int n, int h, int w, int c, int f, int ho, int wo,
                            int kh, int kw, int sh, int sw, int pt, int pl,
                            cudaStream_t stream) {
  Tap<T> ld{static_cast<const T*>(x), h, w, c, ho, wo, sh, sw, pt, pl, kw};
  os_gemm::DenseB<T> wb{static_cast<const T*>(wt), f};
  return os_gemm::launch<T>(out_kind, ld, wb, n * ho * wo, f, kh * kw * c, out, ep, stream);
}

// `direct`: 1 for the direct path (fp32 only), 0 for the implicit GEMM.
extern "C" int im2col_conv(const void* x, const void* wt, const void* scale,
                           const void* bias, const void* out_scale, int relu,
                           void* out, int in_kind, int out_kind, int n, int h,
                           int w, int c, int f, int ho, int wo, int kh, int kw,
                           int sh, int sw, int pt, int pl, int direct, void* stream) {
  EpilogueArgs ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const float*>(out_scale), relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct) {
    if (in_kind != os_gemm::IN_FLOAT32) return cudaErrorInvalidValue;
    direct_conv::HaloTile t{static_cast<const float*>(x), h, w, c, ho, wo, kh, kw, sh, sw, pt, pl};
    return direct_conv::launch(out_kind, t, static_cast<const float*>(wt), n, f, out, ep, s);
  }
  if (in_kind == os_gemm::IN_INT8)
    return run_gemm<int8_t>(x, wt, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw, sh, sw, pt,
                            pl, s);
  if (in_kind == os_gemm::IN_FLOAT32)
    return run_gemm<float>(x, wt, ep, out, out_kind, n, h, w, c, f, ho, wo, kh, kw, sh, sw, pt,
                           pl, s);
  return cudaErrorInvalidValue;
}

// ResNet's max-pool after the stem (maxpool.cuh), counted as im2col_conv's
// variant `maxpool`.
extern "C" int maxpool_nhwc(const void* x, void* out, int in_kind, int n, int h, int w, int c,
                            int ho, int wo, int k, int s, int pad, void* stream) {
  return maxpool::launch(x, out, in_kind, n, h, w, c, ho, wo, k, s, pad,
                         static_cast<cudaStream_t>(stream));
}
