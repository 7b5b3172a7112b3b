// fused_linear: out[M, N] = act(scale[n] * sum_k x[m, k] w[n, k] + bias[n])
// for x [M, K] and a FullyConnected weight w [N, K] as it is stored, so no
// transposed copy of the weight is made.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py fused_linear (l.813): the GEMM
// with its epilogue on the accumulator, _gemm_epi_kernel l.725 under
// _matmul_epilogue l.748. The second C entry, mx_fused_conv_bn_act,
// replaces fused_conv_bn_act (l.838), the eval-time conv -> BatchNorm ->
// act chain: the same GEMM over the im2col patches [N*OH*OW, C*kh*kw]
// (made outside the kernel, as JAX makes them with
// conv_general_dilated_patches) and the conv weight [O, C*kh*kw] as
// stored, with the folded BatchNorm scale and bias in the epilogue. The
// LM's fc -> relu chain passes no scale. act: 0 linear, 1 relu, 2 sigmoid,
// 3 tanh.
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
// bounds-checked element loads. f32 inputs take a CUDA-core kernel (64 x 64
// tiles, 4 x 4 outputs a thread). The tile loops live in gemm.cuh, shared
// with matmul_stats.cu. wgmma/TMA pipelines, and for the conv an implicit
// GEMM that gathers the patches in the tile loader, are later work.
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

__global__ void __launch_bounds__(THREADS)
fused_linear_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int K, int act) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  float acc[4][4];
  f32_tile(x, w, M, N, K, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N)
        out[(size_t)m * N + n] = epilogue(acc[i][j], n, scale, bias, act);
    }
  }
}

int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int M, int N, int K, int act, int dtype,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (M < 1 || N < 1 || K < 1 || act < 0 || act > 3 || N > 65535 * FN)
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
  } else if (dtype == kF32) {
    fused_linear_f32<<<dim3((M + FM - 1) / FM, (N + FN - 1) / FN), THREADS,
                       0, st>>>(static_cast<const float*>(x),
                                static_cast<const float*>(w), sc, bi,
                                static_cast<float*>(out), M, N, K, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// The same GEMM for the eval conv chain: x the im2col patches
// [N*OH*OW, C*kh*kw], w the conv weight [O, C*kh*kw], out [N*OH*OW, O];
// scale and bias the folded BatchNorm (and conv bias), f32 [O]. An entry of
// its own so that its launches are counted apart from the FC chain's.
extern "C" int mx_fused_conv_bn_act(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int M, int N, int K, int act,
                                    int dtype, void* stream) {
  return launch(x, w, scale, bias, out, M, N, K, act, dtype, stream);
}
