// fused_linear: out[M, N] = act(scale[n] * sum_k x[m, k] w[n, k] + bias[n])
// for x [M, K] and a FullyConnected weight w [N, K] as it is stored, so no
// transposed copy of the weight is made.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py fused_linear (l.813): the GEMM
// with its epilogue on the accumulator, _gemm_epi_kernel l.725 under
// _matmul_epilogue l.748. The second C entry, mx_fused_conv_bn_act,
// replaces fused_conv_bn_act (l.838), the eval-time conv -> BatchNorm ->
// act chain: the same GEMM over the conv's patches [N*OH*OW, kh*kw*C] and
// the weight permuted once to [O, kh*kw*C] (k order (ky, kx, c)), with the
// folded BatchNorm scale and bias in the epilogue. The entry's signature
// carries the conv's geometry (N, H, W, C, OH, OW, O, kernel, stride,
// padding, dilation) and x channels-last [N, H, W, C]: in f32 the kernel
// gathers each patch row from x in its tile loader (an implicit GEMM,
// gemm.cuh ConvRows), so the patches never exist in device memory; bf16
// takes the patches made outside the kernel (as JAX makes them with
// conv_general_dilated_patches) as the x of a 1x1 stride-1 conv over
// [1, 1, M, K]. The LM's fc -> relu chain passes no scale. act: 0 linear,
// 1 relu, 2 sigmoid, 3 tanh.
//
// Bound on the H100: at the 124M LM's ffn1 (M = 8192 tokens, K = 768,
// N = 3072, bf16) the product does 38.7 GFLOP on ~67 MB, ~580 flops per
// byte, so the tensor cores bound it. Design: a block of 8 warps owns a
// 128 x 128 output tile and walks K in steps of 64; each warp computes a
// 64 x 32 quarter in mma.sync m16n8k16 steps (bf16 in, f32 accumulate),
// its fragments taken by ldmatrix from a three-stage cp.async ring in
// swizzled dynamic shared memory (gemm.cuh mma_tile: two steps in flight
// while one is multiplied, one barrier a step, two blocks an SM). The
// epilogue (scale, bias, activation) runs on the f32 accumulators before
// the one store of the output, so the pre-activation never reaches device
// memory. 16-byte copies serve K a multiple of 8 with aligned rows; any
// other K (ragged, or a misaligned view) takes the same ring with
// bounds-checked element loads.
//
// f32 (the SP step's layers, ResNet-50's eval forward) stays true f32 on
// the CUDA cores (67 TFLOP/s): the SP ffn1 (M = 2048) does 9.7 GFLOP on
// ~41 MB, stage 1's 3x3 conv at B = 256 59 GFLOP on ~411 MB of x and out,
// so the FFMAs bound both. Design: gemm.cuh f32_tile, 128 x 128 or 128 x 64
// tiles (f32_width: 64 columns where N <= 64, as at ResNet-50's stage 1,
// or where 128-wide tiles would leave the last wave short), 8 x 8 or
// 8 x 4 outputs a thread in registers, K steps of 16 double-buffered
// through shared memory by float4 register loads, one barrier a step. On
// an H100 it reaches 55-57% of the f32 peak at the LM's ffn1 shape (M =
// 8192), 1.24x cuBLAS's time; launch bounds of one or three blocks an SM,
// a warp-tiled thread layout and a k loop unrolled 2, 4 or 8 deep did not
// move it by more than 3%. The
// tile loops live in gemm.cuh, shared with matmul_stats.cu. wgmma/TMA
// pipelines for bf16 and the implicit loader for mma_tile (the bf16 conv
// still gathers its patches) are later work.
#include "gemm.cuh"

using namespace mxk;
using namespace mxk::gemm;

namespace {

__device__ __forceinline__ float epilogue(float acc, int n,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          int act) {
  float y = acc * (scale ? scale[n] : 1.f) + (bias ? bias[n] : 0.f);
  switch (act) {
    case 1:
      return fmaxf(y, 0.f);
    case 2:
      return 1.f / (1.f + expf(-y));
    case 3:
      return tanhf(y);
    default:
      return y;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_linear_mma(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 64 * (warp % 2), wn = 32 * (warp / 2);
  // row tiles fastest: the blocks that share a weight tile run together
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4][4];
  mma_tile<VEC>(x, w, M, N, K, m0, n0, acc);

  const bool pairs = N % 2 == 0;  // (m, n..n+1) is one aligned 4-byte store
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * mt + g + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* row = out + (size_t)m * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + 8 * nt + 2 * t;
        if (n >= N) continue;
        const float y0 = epilogue(acc[mt][nt][2 * h], n, scale, bias, act);
        if (pairs) {
          const float y1 =
              epilogue(acc[mt][nt][2 * h + 1], n + 1, scale, bias, act);
          *reinterpret_cast<uint32_t*>(row + n) = pack_bf16(y0, y1);
        } else {
          row[n] = __float2bfloat16_rn(y0);
          if (n + 1 < N)
            row[n + 1] = __float2bfloat16_rn(
                epilogue(acc[mt][nt][2 * h + 1], n + 1, scale, bias, act));
        }
      }
    }
}

template <int FN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_linear_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int K, int act) {
  __shared__ __align__(16) float sm[FTile<FN>::SMEM];
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FN;
  float acc[8][FN / 16];
  f32_tile<FN>(DenseRows<VEC, FBM>(x, M, K, m0),
               DenseRows<VEC, FN>(w, N, K, n0), K, acc, sm);
  f32_store<FN>(acc, out, M, N, m0, n0, [&](float a, int n) {
    return epilogue(a, n, scale, bias, act);
  });
}

// the implicit-GEMM conv: x channels-last [N, H, W, C], w [O, kh*kw*C];
// the 64-wide tile (ResNet-50's stage 1, the stem) at three blocks an SM
// (80 registers, no spill), 4.6% faster at stage 1's 3x3 conv than two
template <int FN, bool VEC>
__global__ void __launch_bounds__(THREADS, FN == 64 ? 3 : 2)
conv_f32(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ scale, const float* __restrict__ bias,
         float* __restrict__ out, ConvGeom g, int M, int O, int act) {
  __shared__ __align__(16) float sm[FTile<FN>::SMEM];
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FN;
  const int K = g.kh * g.kw * g.C;
  float acc[8][FN / 16];
  f32_tile<FN>(ConvRows<VEC>(x, g, M, m0), DenseRows<VEC, FN>(w, O, K, n0),
               K, acc, sm);
  f32_store<FN>(acc, out, M, O, m0, n0, [&](float a, int n) {
    return epilogue(a, n, scale, bias, act);
  });
}

int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int N, int K, int act, int dtype,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (M < 1 || N < 1 || K < 1 || act < 0 || act > 3 || N > 65535 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    const auto kernel = vec_ok(x, w, K) ? fused_linear_mma<true>
                                        : fused_linear_mma<false>;
    const cudaError_t e = ring_smem(kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, THREADS, RING_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sc, bi,
        static_cast<__nv_bfloat16*>(out), M, N, K, act);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (vec_ok_f32(x, w, K))
    return launch_f32<fused_linear_f32<128, true>, fused_linear_f32<64, true>>(
        M, N, st, xf, wf, sc, bi, of, M, N, K, act);
  return launch_f32<fused_linear_f32<128, false>, fused_linear_f32<64, false>>(
      M, N, st, xf, wf, sc, bi, of, M, N, K, act);
}

}  // namespace

// x [M, K], w [N, K], out [M, N], contiguous, all of one dtype; scale and
// bias f32 [N] or null (1 and 0).
extern "C" int mx_fused_linear(const void* x, const void* w,
                               const void* scale, const void* bias,
                               void* out, int M, int N, int K, int act,
                               int dtype, void* stream) {
  return launch(x, w, scale, bias, out, M, N, K, act, dtype, stream);
}

// The eval conv chain: x channels-last [N, H, W, C] (contiguous NHWC), w
// the conv weight permuted to [O, kh*kw*C] (k order (ky, kx, c)), out
// [N*OH*OW, O]; scale and bias the folded BatchNorm (and conv bias), f32
// [O]. f32 gathers the patches in the kernel (a pointwise stride-1 conv
// reads x as the [N*H*W, C] matrix it is); bf16 takes the patches
// [M, K] made by the caller as the x of a 1x1 stride-1 unpadded conv over
// [1, 1, M, K] and refuses any other geometry. An entry of its own so that
// its launches are counted apart from the FC chain's.
extern "C" int mx_fused_conv_bn_act(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int N, int H, int W, int C,
                                    int OH, int OW, int O, int kh, int kw,
                                    int sh, int sw, int ph, int pw, int dh,
                                    int dw, int act, int dtype,
                                    void* stream) {
  const ConvGeom g{N, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, dh, dw};
  const bool pointwise =
      kh == 1 && kw == 1 && sh == 1 && sw == 1 && ph == 0 && pw == 0;
  const long long M = (long long)N * OH * OW;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0 || dh < 1 || dw < 1 ||
      OH != (H + 2 * ph - dh * (kh - 1) - 1) / sh + 1 ||
      OW != (W + 2 * pw - dw * (kw - 1) - 1) / sw + 1 || OH < 1 || OW < 1 ||
      M > 0x7fffffff || (long long)H * W * C > 0x7fffffff ||
      (long long)kh * kw * C > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (!pointwise) return static_cast<int>(cudaErrorInvalidValue);
    return launch(x, w, scale, bias, out, (int)M, O, C, act, dtype, stream);
  }
  if (dtype != kF32 || act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pointwise)
    return launch(x, w, scale, bias, out, (int)M, O, C, act, dtype, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (C % 4 == 0 && vec_ok_f32(x, w, 4))
    return launch_f32<conv_f32<128, true>, conv_f32<64, true>>(
        M, O, st, xf, wf, sc, bi, of, g, (int)M, O, act);
  return launch_f32<conv_f32<128, false>, conv_f32<64, false>>(
      M, O, st, xf, wf, sc, bi, of, g, (int)M, O, act);
}
