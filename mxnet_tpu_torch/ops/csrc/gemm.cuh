// The GEMM tile loops shared by fused_linear.cu (fused_linear,
// fused_conv_bn_act) and matmul_stats.cu: one block computes one output
// tile of acc[m, n] = sum_k x[m, k] w[n, k] for x [M, K] and a weight
// w [N, K] as it is stored (a FullyConnected weight, or a conv weight
// permuted to [O, kh*kw*C]), accumulated in f32 registers, and leaves the
// epilogue to its caller. Two cores: mma_tile, bf16 on the tensor cores;
// f32_tile, true f32 FFMA on the CUDA cores, whose x may also be the
// patches of a convolution gathered from a channels-last input in the
// tile loader (an implicit GEMM). Rows past M and columns past N load as
// zeros, so their accumulators are exactly 0.
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
// True f32 FFMA (no TF32), register-tiled: a block of 256 threads owns a
// 128 x FN output tile, FN = 128 or 64 (f32_width), and each thread an
// 8 x TN block of it in registers, TN = FN / 16: with tx = tid % 16 and
// ty = tid / 16, acc[i][j] is the tile element (frow(tid, i), fcol(tid,
// j)), frow = 4 ty + i % 4 + 64 (i / 4), fcol = 4 tx + j % 4 + 64 (j / 4). K
// advances in steps of FBK = 16. The product wants each operand k-major in
// shared memory (xs[k][m], ws[k][n]), so that one float4 read gives four
// rows' (columns') values of one k: per k a thread reads two float4 of x
// and TN / 4 of w for 8 TN FFMAs, the reads of x broadcast within a
// quarter warp and those of w 128 contiguous bytes. Both operands are
// K-contiguous in device memory ("NT"), and cp.async cannot transpose, so
// each thread loads its part of the next step's tiles as float4 into
// registers before the current step's FFMAs and stores it transposed into
// the other of two shared buffers after them: one barrier a step. A loader
// thread takes row tid % R of an R-row tile, 32 consecutive rows a warp, so
// the transposed stores hit 32 distinct banks.
//
// The A operand comes through a loader: DenseRows reads a row-major x [M, K]
// (fused_linear, matmul_stats, a pointwise conv over a channels-last x);
// ConvRows is the implicit GEMM of a convolution, gathering patch row
// m = (n, oy, ox), column k = (ky, kx, c) straight from a channels-last x
// [N, H, W, C] as x[n, oy sh - ph + ky dh, ox sw - pw + kx dw, c], zero
// outside the image: no patches matrix exists. Each thread decomposes its
// one row m before the K loop. With VEC (K, or C for the conv, a multiple
// of 4 and 16-byte aligned operands) four consecutive k are one float4
// (for the conv, four channels of one pixel); otherwise each value is a
// guarded element load (a ragged K, a misaligned view, the stem's C = 3).
// Rows past M, columns past N and k past K load as zeros, so their
// accumulators are exactly 0.

constexpr int FBM = 128, FBK = 16;

template <int FN>
struct FTile {
  static constexpr int TN = FN / 16;                  // columns a thread owns
  static constexpr int NB = FN * FBK / 4 / THREADS;   // float4 of w a step
  static constexpr int SMEM = 2 * FBK * (FBM + FN);   // floats, two buffers
};

// the tile row of accumulator row i of thread tid, and the tile column
// of its column j; the rows of i and i + 4, and the columns of j and j + 4,
// are RSTEP and CSTEP apart
constexpr int RSTEP = 64, CSTEP = 64;
__device__ __forceinline__ int frow(int tid, int i) {
  return 4 * (tid / 16) + (i & 3) + RSTEP * (i >> 2);
}
__device__ __forceinline__ int fcol(int tid, int j) {
  return 4 * (tid % 16) + (j & 3) + CSTEP * (j >> 2);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// row[k .. k + 3], zeros at and past K (and for a null row); VEC: one
// float4 load (k % 4 == 0, K % 4 == 0, the row on a 16-byte boundary)
template <bool VEC>
__device__ __forceinline__ float4 row4(const float* __restrict__ row, int k,
                                       int K) {
  if (!row) return zero4();
  if constexpr (VEC) {
    return k < K ? *reinterpret_cast<const float4*>(row + k) : zero4();
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = k + i < K ? row[k + i] : 0.f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
}

// Loaders: each thread owns one row of its operand's tile and, in every K
// step, NC float4 chunks of it (4 NC consecutive k from an offset of its
// own). start(k) sets the first k; next(v) loads the chunks at this step's
// k and moves on to the next step's, k + FBK.

// row r0 + (tid % R) of a row-major [rows, K] matrix, R rows a tile
template <bool VEC, int R>
struct DenseRows {
  const float* row;
  int K, k = 0;
  __device__ __forceinline__ DenseRows(const float* __restrict__ p, int rows,
                                       int K_, int r0)
      : K(K_) {
    const int r = r0 + threadIdx.x % R;
    row = r < rows ? p + (size_t)r * K_ : nullptr;
  }
  __device__ __forceinline__ void start(int k0) { k = k0; }
  template <int NC>
  __device__ __forceinline__ void next(float4 (&v)[NC]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = row4<VEC>(row, k + 4 * c, K);
    k += FBK;
  }
};

// a convolution over a channels-last x [N, H, W, C]: output OH x OW, kernel
// kh x kw, stride (sh, sw), padding (ph, pw), dilation (dh, dw)
struct ConvGeom {
  int N, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, dh, dw;
};

// The implicit GEMM's A: patch row m0 + tid % FBM, its columns k in (ky,
// kx, c) order, gathered from x. The column is carried as (c, kx, ky) and
// advanced by adding, so the K loop divides by nothing: the divisions run
// once per thread, for its row and its first column.
template <bool VEC>
struct ConvRows {
  ConvGeom g;
  const float* img;  // image n of x; null past M
  int iy0 = 0, ix0 = 0;
  int c = 0, kx = 0, ky = 0;  // the next column to load
  __device__ __forceinline__ ConvRows(const float* __restrict__ x,
                                      const ConvGeom& g_, int M, int m0)
      : g(g_), img(nullptr) {
    const int m = m0 + threadIdx.x % FBM;
    if (m < M) {
      const int n = m / (g.OH * g.OW), r = m - n * (g.OH * g.OW);
      const int oy = r / g.OW, ox = r - oy * g.OW;
      img = x + (size_t)n * g.H * g.W * g.C;
      iy0 = oy * g.sh - g.ph;
      ix0 = ox * g.sw - g.pw;
    }
  }
  __device__ __forceinline__ void start(int k0) {
    const int t = k0 / g.C;
    c = k0 - t * g.C;
    ky = t / g.kw;
    kx = t - ky * g.kw;
  }
  __device__ __forceinline__ void advance(int d) {
    c += d;
    while (c >= g.C) {
      c -= g.C;
      if (++kx == g.kw) {
        kx = 0;
        ++ky;
      }
    }
  }
  // the offset in the image of the next column's value; -1 outside the
  // image or past K (ky == kh)
  // (an image holds fewer than 2^31 values: the launcher checks)
  __device__ __forceinline__ int offset() const {
    const int iy = iy0 + ky * g.dh, ix = ix0 + kx * g.dw;
    if (!img || ky >= g.kh || (unsigned)iy >= (unsigned)g.H ||
        (unsigned)ix >= (unsigned)g.W)
      return -1;
    return (iy * g.W + ix) * g.C + c;
  }
  template <int NC>
  __device__ __forceinline__ void next(float4 (&v)[NC]) {
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if constexpr (VEC) {
        // C % 4 == 0: columns k..k+3 are four channels of one pixel
        const int o = offset();
        v[q] = o < 0 ? zero4() : *reinterpret_cast<const float4*>(img + o);
        advance(4);
      } else {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = offset();
          e[i] = o < 0 ? 0.f : img[o];
          advance(1);
        }
        v[q] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    advance(FBK - 4 * NC);
  }
};

// acc = the block's 128 x FN tile of sum_k A[m, k] w[n, k] over K columns;
// a loads A's rows m0.. (DenseRows<., FBM> or ConvRows), b w's rows n0..
// (DenseRows<., FN>); sm holds FTile<FN>::SMEM floats. Ends with a barrier,
// so the caller may reuse sm.
template <int FN, class ARows, class BRows>
__device__ __forceinline__ void f32_tile(ARows a, BRows b,
                                         int K, float (&acc)[8][FN / 16],
                                         float* sm) {
  constexpr int TN = FTile<FN>::TN, NB = FTile<FN>::NB;
  float* xs = sm;                  // [2][FBK][FBM]
  float* ws = sm + 2 * FBK * FBM;  // [2][FBK][FN]
  const int tid = threadIdx.x;
  // this thread's loads: x row tid % FBM at k offsets ak + 4c (c < 2), w
  // row tid % FN at bk + 4c (c < NB)
  const int ar = tid % FBM, ak = (tid / FBM) * 8;
  const int br = tid % FN, bk = (tid / FN) * 4 * NB;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int nk = (K + FBK - 1) / FBK;
  float4 va[2], vb[NB];
  a.start(ak);
  b.start(bk);
  auto stash = [&](int buf) {
    float* xd = xs + buf * FBK * FBM + ar;
    float* wd = ws + buf * FBK * FN + br;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = ak + 4 * c;
      xd[(k + 0) * FBM] = va[c].x;
      xd[(k + 1) * FBM] = va[c].y;
      xd[(k + 2) * FBM] = va[c].z;
      xd[(k + 3) * FBM] = va[c].w;
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int k = bk + 4 * c;
      wd[(k + 0) * FN] = vb[c].x;
      wd[(k + 1) * FN] = vb[c].y;
      wd[(k + 2) * FN] = vb[c].z;
      wd[(k + 3) * FN] = vb[c].w;
    }
  };
  a.next(va);
  b.next(vb);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    // the next step's loads are in flight during this step's FFMAs
    if (kt + 1 < nk) {
      a.next(va);
      b.next(vb);
    }
    const float* xc = xs + buf * FBK * FBM + frow(tid, 0);
    const float* wc = ws + buf * FBK * FN + fcol(tid, 0);
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float av[8], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(xc + k * FBM);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xc + k * FBM + RSTEP);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
#pragma unroll
      for (int jc = 0; jc < TN / 4; ++jc) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(wc + k * FN + CSTEP * jc);
        bv[4 * jc] = b4.x;
        bv[4 * jc + 1] = b4.y;
        bv[4 * jc + 2] = b4.z;
        bv[4 * jc + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // buffer buf ^ 1 was last read in step kt - 1, which every thread
    // finished before the barrier that ended it
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }
}

// out[m, n] = f(acc, n) for the thread's part of the tile at (m0, n0) of an
// [M, N] f32 output: four columns at once where N % 4 == 0
template <int FN, class F>
__device__ __forceinline__ void f32_store(const float (&acc)[8][FN / 16],
                                          float* __restrict__ out, int M,
                                          int N, int m0, int n0, F f) {
  constexpr int TN = FN / 16;
  const int tid = threadIdx.x;
  const bool quads = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frow(tid, i);
    if (m >= M) continue;
    float* row = out + (size_t)m * N;
#pragma unroll
    for (int jc = 0; jc < TN / 4; ++jc) {
      const int n = n0 + fcol(tid, 4 * jc);
      if (quads && n < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(f(acc[i][4 * jc], n), f(acc[i][4 * jc + 1], n + 1),
                        f(acc[i][4 * jc + 2], n + 2),
                        f(acc[i][4 * jc + 3], n + 3));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = f(acc[i][4 * jc + e], n + e);
      }
    }
  }
}

// blocks of `Kernel` (THREADS threads, static shared memory) an SM holds
template <auto Kernel>
int blocks_per_sm() {
  static const int n = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, Kernel, THREADS, 0);
    return b > 0 ? b : 1;
  }();
  return n;
}

// The f32 tile width for an M x N product, K128 and K64 the kernel's two
// widths: 64 where N <= 64 (a 128-wide tile would leave half its threads
// idle), else the width whose last wave of blocks is the less empty: each
// choice's waves (ceil(tiles / (blocks an SM x SMs))) times the work of a
// wave, a 64-wide tile's counted 10% dearer per output for its extra
// shared-memory reads a FFMA.
template <auto K128, auto K64>
int f32_width(long long M, int N) {
  if (N <= 64) return 64;
  const long long mt = (M + FBM - 1) / FBM, sms = sm_count();
  const long long s128 = blocks_per_sm<K128>() * sms;
  const long long s64 = blocks_per_sm<K64>() * sms;
  const long long w128 = (mt * ((N + 127) / 128) + s128 - 1) / s128;
  const long long w64 = (mt * ((N + 63) / 64) + s64 - 1) / s64;
  return w64 * s64 * 64 * 11 < w128 * s128 * 128 * 10 ? 64 : 128;
}

// launch K128 or K64 (f32_width) over the M x N product's tiles, row tiles
// fastest: the blocks that share a weight tile run together
template <auto K128, auto K64, typename... Args>
int launch_f32(long long M, int N, cudaStream_t st, Args... args) {
  if (M < 1 || N < 1 || (M + FBM - 1) / FBM > 0x7fffffff ||
      (N + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = f32_width<K128, K64>(M, N);
  const dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM),
                  (N + bn - 1) / bn);
  if (bn == 128)
    K128<<<grid, THREADS, 0, st>>>(args...);
  else
    K64<<<grid, THREADS, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte f32 loads need K a multiple of 4 and both operands on 16-byte
// boundaries; anything else takes the guarded element loads
inline bool vec_ok_f32(const void* x, const void* w, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace gemm
}  // namespace mxk
