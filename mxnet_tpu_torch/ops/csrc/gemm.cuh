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
// A block of 8 warps owns a 128 x 128 tile and walks K in steps of BK = 64;
// each warp computes a 64 x 32 part in mma.sync m16n8k16 steps (bf16 in,
// f32 accumulate). With g = lane / 4 and t = lane % 4, acc[mt][nt][i] holds
// the tile element (wm + 16 mt + g + 8 (i / 2), wn + 8 nt + 2 t + i % 2),
// wm = 64 (warp % 2), wn = 32 (warp / 2).
//
// The tiles of x and w come through a ring of STAGES = 3 stages in dynamic
// shared memory (96 KB: two blocks an SM), filled by 16-byte cp.async
// copies: while step k's products run, steps k + 1 and k + 2 are in flight,
// and one barrier a step both publishes the arrived stage and frees the one
// the next copies overwrite. Every step commits a group, empty past the
// last tile, so that the wait counts hold. A stage holds each operand as
// 128 rows of 64 bf16 (128 bytes), the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8): the ldmatrix .x4 reads that take every A and B
// fragment touch 8 rows at one logical chunk, which this XOR swizzle puts
// in 8 distinct bank groups. Rows past M or N and columns past K are
// zero-filled without being read. The ring is shaped for the next step,
// wgmma fed by TMA: 128-byte rows under the 128-byte swizzle are the
// layout a TMA tile copy with CU_TENSOR_MAP_SWIZZLE_128B writes and a
// wgmma shared-memory descriptor of that swizzle reads; what is left is
// the copy (one thread's TMA and an mbarrier per stage in place of 256
// threads' cp.async), the product (4 warps' wgmma m64n128k16 in place of
// 8 warps' mma.sync, the accumulator layout changing with it) and a
// producer warp.
//
// A K that is not a multiple of 8, or an operand off a 16-byte boundary,
// takes guarded element loads into the same ring (VEC = false).


constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * BK * 2;  // one operand's tile of a stage
constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;

// byte offset of 16-byte chunk c of row r in a swizzled operand tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * (BK * 2) + ((c ^ (r & 7)) << 4);
}

// issue step kt's tiles of x and w into ring stage st
template <bool VEC>
__device__ __forceinline__ void load_stage(
    uint8_t* ring, int st, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, int M, int N, int K, int m0,
    int n0, int kt) {
  uint8_t* xs = ring + st * 2 * TILE_BYTES;
  uint8_t* ws = xs + TILE_BYTES;
  const int k = kt * BK;
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < BM * BK / 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / 8, c = i % 8, kc = k + 8 * c;
      const int off = swz(r, c);
      const bool inx = m0 + r < M && kc < K, inw = n0 + r < N && kc < K;
      cp_async16(xs + off, inx ? x + (size_t)(m0 + r) * K + kc : x, inx);
      cp_async16(ws + off, inw ? w + (size_t)(n0 + r) * K + kc : w, inw);
    }
  } else {
    // element by element (the values are bf16 bits, copied as they are)
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
    const uint16_t* wb = reinterpret_cast<const uint16_t*>(w);
#pragma unroll 1
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, e = i % BK, kc = k + e;
      const int off = swz(r, e / 8) + 2 * (e % 8);
      *reinterpret_cast<uint16_t*>(xs + off) =
          m0 + r < M && kc < K ? xb[(size_t)(m0 + r) * K + kc] : 0;
      *reinterpret_cast<uint16_t*>(ws + off) =
          n0 + r < N && kc < K ? wb[(size_t)(n0 + r) * K + kc] : 0;
    }
  }
}

// The kernel that runs mma_tile launches with RING_BYTES of dynamic shared
// memory, after ring_smem(kernel) lifts the 48 KB default.
template <bool VEC>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w,
                                         int M, int N, int K, int m0, int n0,
                                         float (&acc)[4][4][4]) {
  extern __shared__ __align__(128) uint8_t ring[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = 64 * (warp % 2), wn = 32 * (warp / 2);
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<VEC>(ring, st, x, w, M, N, K, m0, n0, st);
    cp_async_commit();
  }
  // ldmatrix rows: A's matrices are (rows 0-7, 8-15) x (k 0-7, 8-15) in
  // fragment order, B's (n 0-7 at k 0-7, k 8-15; n 8-15 at k 0-7, k 8-15).
  // A step takes B's fragments, then A's one 16-row slice at a time, each
  // slice's four products issued as soon as it lands.
  const int ar = wm + (lane & 15), ac = lane >> 4;
  const int br = wn + (lane & 7) + ((lane >> 4) << 3), bc = (lane >> 3) & 1;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt's copies have landed
    __syncthreads();              // ... for every thread; step kt - 1 done
    const int nx = kt + STAGES - 1;
    if (nx < nk) load_stage<VEC>(ring, nx % STAGES, x, w, M, N, K, m0, n0, nx);
    cp_async_commit();
    const uint8_t* xs = ring + (kt % STAGES) * 2 * TILE_BYTES;
    const uint8_t* ws = xs + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, ws + swz(br + 16 * np, 2 * kk + bc));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xs + swz(ar + 16 * mt, 2 * kk + ac));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a, b[nt]);
      }
    }
  }
  cp_async_wait<0>();
}

// lift a kernel's dynamic shared memory limit to the ring's size
template <typename Kernel>
inline cudaError_t ring_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
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
