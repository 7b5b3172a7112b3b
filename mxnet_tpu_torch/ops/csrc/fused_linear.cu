// fused_linear: out[M, N] = act(scale[n] * sum_k x[m, k] w[n, k] + bias[n])
// for x [M, K] and a FullyConnected weight w [N, K] as it is stored, so no
// transposed copy of the weight is made.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py fused_linear (l.813): the GEMM
// with its epilogue on the accumulator, _gemm_epi_kernel l.725 under
// _matmul_epilogue l.748. `scale` (per output column, optional) is the
// folded BatchNorm scale of fused_conv_bn_act (l.838), which shares this
// GEMM; the LM's fc -> relu chain passes none. act: 0 linear, 1 relu,
// 2 sigmoid, 3 tanh.
//
// Bound on the H100: at the 124M LM's ffn1 (M = 8192 tokens, K = 768,
// N = 3072, bf16) the product does 38.7 GFLOP on ~67 MB, ~580 flops per
// byte, so the tensor cores bound it. Design: a block of 8 warps owns a
// 128 x 128 output tile and walks K in steps of 32; each warp computes a
// 64 x 32 quarter in mma.sync m16n8k16 steps (bf16 in, f32 accumulate).
// The next step's tiles are loaded into registers while the tensor cores
// work on the current one (a two-stage software pipeline through shared
// memory rows padded against bank conflicts). The epilogue (scale, bias,
// activation) runs on the f32 accumulators before the one store of the
// output, so the pre-activation never reaches device memory. 16-byte loads
// serve K a multiple of 8 with aligned rows; any other K (ragged, or a
// misaligned view) takes the same kernel with bounds-checked scalar loads.
// f32 inputs take a CUDA-core kernel (64 x 64 tiles, 4 x 4 outputs a
// thread). wgmma/TMA pipelines are later work.
#include "common.cuh"

using namespace mxk;

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

// -- bf16: tensor cores -----------------------------------------------------

constexpr int BM = 128, BN = 128, BKT = 32;
constexpr int THREADS = 256;
constexpr int LDS = BKT + 8;  // padded bf16 row of a staged tile (80 bytes)

// 8 consecutive values of row r from column c: one 16-byte load (VEC), or
// eight guarded scalar loads; zeros past the matrix
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ a,
                                       int r, int c, int R, int C) {
  if (VEC) {
    if (r < R && c < C)
      return __ldg(reinterpret_cast<const uint4*>(a + (size_t)r * C + c));
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = (r < R && c + 2 * i < C)
                         ? __bfloat162float(a[(size_t)r * C + c + 2 * i])
                         : 0.f;
    const float hi = (r < R && c + 2 * i + 1 < C)
                         ? __bfloat162float(a[(size_t)r * C + c + 2 * i + 1])
                         : 0.f;
    w[i] = pack_bf16(lo, hi);  // exact: the values are bf16 already
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_linear_mma(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 64 * (warp % 2);  // the warp's rows in the tile
  const int wn = 32 * (warp / 2);  // the warp's columns in the tile
  // row tiles fastest: the blocks that share a weight tile run together
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BKT - 1) / BKT;
  // loaders: rows lr and lr + 64, 8 values from column lc
  const int lr = tid / 4, lc = 8 * (tid % 4);
  uint4 xr[2], wr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    xr[i] = load8<VEC>(x, m0 + lr + 64 * i, lc, M, K);
    wr[i] = load8<VEC>(w, n0 + lr + 64 * i, lc, N, K);
  }
  float acc[4][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&xs[lr + 64 * i][lc]) = xr[i];
      *reinterpret_cast<uint4*>(&ws[lr + 64 * i][lc]) = wr[i];
    }
    __syncthreads();
    if (kt + 1 < nk) {  // the next step's loads fly during the products
      const int k1 = (kt + 1) * BKT + lc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xr[i] = load8<VEC>(x, m0 + lr + 64 * i, k1, M, K);
        wr[i] = load8<VEC>(w, n0 + lr + 64 * i, k1, N, K);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* p = &xs[wm + 16 * mt + g][kk + 2 * t];
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = &ws[wn + 8 * nt + g][kk + 2 * t];
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

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

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
fused_linear_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int K, int act) {
  __shared__ __align__(16) float xs[FK][FM + 4];
  __shared__ __align__(16) float ws[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // rows 4*ty .. 4*ty+3
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  // loaders: row lr, 4 values from column lc
  const int lr = tid / 4, lc = 4 * (tid % 4);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + lc + i;
      const int m = m0 + lr, n = n0 + lr;
      xs[lc + i][lr] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
      ws[lc + i][lr] = (n < N && k < K) ? w[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
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

}  // namespace

// x [M, K], w [N, K], out [M, N], contiguous, all of one dtype; scale and
// bias f32 [N] or null (1 and 0).
extern "C" int mx_fused_linear(const void* x, const void* w,
                               const void* scale, const void* bias,
                               void* out, int M, int N, int K, int act,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (M < 1 || N < 1 || K < 1 || act < 0 || act > 3 || N > 65535 * FN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec)
      fused_linear_mma<true><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w), sc, bi,
          static_cast<__nv_bfloat16*>(out), M, N, K, act);
    else
      fused_linear_mma<false><<<grid, THREADS, 0, st>>>(
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
