// matmul_stats: y[M, N] = x[M, K] w[N, K]^T, and per-column partial sums of
// y and y^2 taken from the f32 accumulator before y is rounded to its
// storage type: s1p[b, n] and s2p[b, n] for each M-tile b (f32
// [ceil(M / tile), N]); the caller sums the partials over b.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py matmul_stats (l.969), kernel
// _gemm_stats_kernel (l.876) under _matmul_stats_impl (l.904): the
// training 1x1 conv -> BatchNorm chain, whose batch statistics come from
// the GEMM's epilogue instead of a second read of the activation. x is the
// NHWC-flattened activation [N*H*W, C] and w the conv weight [O, C] as
// stored.
//
// Bound on the H100: at ResNet-50's pointwise convs (B=256: M = 802816 down
// to 12544 rows, K and N from 64 to 2048, bf16) the product does at most
// ~2 K N flops per 2 (K + N) bytes of a row, 16-512 flops per byte, so
// most of these convs sit below the ~295 flops per byte where the tensor
// cores, and not the memory, would bound them: x's and y's bytes bound it.
// Design: the tile loops of fused_linear (gemm.cuh: 128 x 128 tiles of
// mma.sync fed by a three-stage cp.async ring for bf16; for f32 the
// register-tiled CUDA-core f32_tile, 128 x 128 or, at N <= 64 as in stage
// 1, 128 x 64), then one epilogue that stores y and reduces the same
// accumulators per column: each thread sums its rows, the lanes of a
// column meet through shuffles, the warps through shared memory, always
// in the same order and without atomics, so every run gives the same
// bits. Both dtypes' M-tiles have 128 rows, so the partials have
// ceil(M / 128) rows. Rows past M and columns past N are zero in the
// accumulators and add exactly 0. The bf16 tile of 128 columns is half
// idle at N = 64 (stage 1's convs); a 64-column bf16 form, wgmma/TMA and
// channels-last activations (no NCHW <-> [M, C] copies around the call)
// are later work.
#include "gemm.cuh"

using namespace mxk;
using namespace mxk::gemm;

namespace {

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
matmul_stats_mma(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ s1p,
                 float* __restrict__ s2p, int M, int N, int K) {
  // per column of the tile, the two warp rows' sums: [s1/s2][half][column]
  __shared__ float red[2][2][BN];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 64 * (warp % 2), wn = 32 * (warp / 2);
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
      __nv_bfloat16* row = y + (size_t)m * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + 8 * nt + 2 * t;
        if (n >= N) continue;
        const float y0 = acc[mt][nt][2 * h], y1 = acc[mt][nt][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<uint32_t*>(row + n) = pack_bf16(y0, y1);
        } else {
          row[n] = __float2bfloat16_rn(y0);
          if (n + 1 < N) row[n + 1] = __float2bfloat16_rn(y1);
        }
      }
    }

  // column (wn + 8 nt + 2 t + j) of the warp's 64 rows: this thread's 8
  // rows, then the 8 lanes that share t (lane bits 2-4)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[mt][nt][2 * h + j];
          s += v;
          q += v * v;
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (g == 0) {
        red[0][warp % 2][wn + 8 * nt + 2 * t + j] = s;
        red[1][warp % 2][wn + 8 * nt + 2 * t + j] = q;
      }
    }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < BN && n0 + c < N) {
    const size_t o = (size_t)blockIdx.x * N + n0 + c;
    s1p[o] = red[0][0][c] + red[0][1][c];
    s2p[o] = red[1][0][c] + red[1][1][c];
  }
}

template <int FN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
matmul_stats_f32(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, float* __restrict__ s1p,
                 float* __restrict__ s2p, int M, int N, int K) {
  constexpr int TN = FN / 16;
  __shared__ __align__(16) float sm[FTile<FN>::SMEM];
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FN;
  float acc[8][TN];
  f32_tile<FN>(DenseRows<VEC, FBM>(x, M, K, m0),
               DenseRows<VEC, FN>(w, N, K, n0), K, acc, sm);
  f32_store<FN>(acc, y, M, N, m0, n0, [](float a, int) { return a; });

  // per column of the tile, each warp's sums ([s1/s2][warp][column], in
  // the tile's shared memory, free after f32_tile's last barrier): this
  // thread's 8 rows, then the lane 16 apart (the other ty of the warp)
  float* red = sm;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += acc[i][j];
      q += acc[i][j] * acc[i][j];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    if (threadIdx.x % 32 < 16) {
      red[warp * FN + fcol(threadIdx.x, j)] = s;
      red[(8 + warp) * FN + fcol(threadIdx.x, j)] = q;
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < FN && n0 + c < N) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < 8; ++r) {
      s += red[r * FN + c];
      q += red[(8 + r) * FN + c];
    }
    const size_t o = (size_t)blockIdx.x * N + n0 + c;
    s1p[o] = s;
    s2p[o] = q;
  }
}

}  // namespace

// x [M, K], w [N, K], y [M, N], contiguous, all of one dtype; s1p and s2p
// f32 [ceil(M / 128), N] (both dtypes' tiles have 128 rows).
extern "C" int mx_matmul_stats(const void* x, const void* w, void* y,
                               void* s1p, void* s2p, int M, int N, int K,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p1 = static_cast<float*>(s1p);
  float* p2 = static_cast<float*>(s2p);
  if (M < 1 || N < 1 || K < 1 || N > 65535 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    const auto kernel = vec_ok(x, w, K) ? matmul_stats_mma<true>
                                        : matmul_stats_mma<false>;
    const cudaError_t e = ring_smem(kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, THREADS, RING_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), p1, p2, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (vec_ok_f32(x, w, K))
    return launch_f32<matmul_stats_f32<128, true>, matmul_stats_f32<64, true>>(
        M, N, st, xf, wf, yf, p1, p2, M, N, K);
  return launch_f32<matmul_stats_f32<128, false>,
                    matmul_stats_f32<64, false>>(M, N, st, xf, wf, yf, p1, p2,
                                                 M, N, K);
}
