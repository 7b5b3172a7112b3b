// The GEMM tile loops shared by fused_linear.cu (fused_linear,
// fused_conv_bn_act) and matmul_stats.cu: one block computes one output
// tile of acc[m, n] = sum_k x[m, k] w[n, k] for x [M, K] and a weight
// w [N, K] as it is stored (a FullyConnected weight, or a conv weight
// [O, C*kh*kw]), accumulated in f32 registers, and leaves the epilogue
// to its caller. Rows past M and columns past N load as zeros, so their
// accumulators are exactly 0.
#pragma once

#include "common.cuh"

namespace mxk {
namespace gemm {

// -- bf16: tensor cores -----------------------------------------------------
//
// A block of 8 warps owns a 128 x 128 tile and walks K in steps of 32; each
// warp computes a 64 x 32 part in mma.sync m16n8k16 steps. The next step's
// tiles are loaded into registers while the tensor cores work on the
// current one (a two-stage pipeline through shared rows padded against
// bank conflicts). With g = lane / 4 and t = lane % 4, acc[mt][nt][i] holds
// the tile element (wm + 16 mt + g + 8 (i / 2), wn + 8 nt + 2 t + i % 2),
// wm = 64 (warp % 2), wn = 32 (warp / 2).

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
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w,
                                         int M, int N, int K, int m0, int n0,
                                         float (&acc)[4][4][4]) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 64 * (warp % 2), wn = 32 * (warp / 2);
  const int nk = (K + BKT - 1) / BKT;
  // loaders: rows lr and lr + 64, 8 values from column lc
  const int lr = tid / 4, lc = 8 * (tid % 4);
  uint4 xr[2], wr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    xr[i] = load8<VEC>(x, m0 + lr + 64 * i, lc, M, K);
    wr[i] = load8<VEC>(w, n0 + lr + 64 * i, lc, N, K);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
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
}

// 16-byte loads need K a multiple of 8 and both operands on 16-byte
// boundaries; anything else takes the guarded scalar loads
inline bool vec_ok(const void* x, const void* w, int K) {
  return K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// -- f32: CUDA cores ----------------------------------------------------------
//
// 64 x 64 tiles, 4 x 4 outputs a thread: acc[i][j] is the tile element
// (4 ty + i, 4 tx + j), tx = tid % 16, ty = tid / 16.

constexpr int FM = 64, FN = 64, FK = 16;

__device__ __forceinline__ void f32_tile(const float* __restrict__ x,
                                         const float* __restrict__ w, int M,
                                         int N, int K, int m0, int n0,
                                         float (&acc)[4][4]) {
  __shared__ __align__(16) float xs[FK][FM + 4];
  __shared__ __align__(16) float ws[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // loaders: row lr, 4 values from column lc
  const int lr = tid / 4, lc = 4 * (tid % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
}

}  // namespace gemm
}  // namespace mxk
