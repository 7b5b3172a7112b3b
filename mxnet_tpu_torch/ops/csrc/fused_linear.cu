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
// reads x itself, as Winograd F(2x2, 3x3) for a stride-1 3x3 conv and as
// an implicit GEMM otherwise (gemm.cuh ConvRows gathers each patch row in
// its tile loader), so no patches matrix exists in device memory; bf16
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
// move it by more than 3%. The tile loops live in gemm.cuh, shared with
// matmul_stats.cu.
//
// The f32 conv's path is a rule on its geometry (conv_algo in
// ops/kernels.py mirrors it): a stride-1 3x3 conv with C % 4 == 0 (13 of
// ResNet-50's 53 eval chains) is Winograd F(2x2, 3x3), 16 multiplies for
// the direct product's 36 (26.3 of 59.2 GFLOP at stage 2, B = 256), its
// input and output transforms fused into one kernel with the 16 GEMMs
// (conv_wino below; the weight transform a small kernel of the same
// entry, into the caller's workspace), so that neither transformed tensor
// reaches device memory (~411 MB each way at stage 2); a pointwise
// stride-1 conv is the plain GEMM; every other conv the implicit GEMM.
// wgmma/TMA pipelines for bf16 and the implicit loader for mma_tile (the
// bf16 conv still gathers its patches) are later work.
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

// -- f32 Winograd F(2x2, 3x3): the stride-1 3x3 convs ------------------------
//
// Y = A^T [(G g G^T) . (B^T d B)] A for each 2 x 2 output tile, d its 4 x 4
// input patch (rows 2 ty - ph .. + 3, columns 2 tx - pw .. + 3, zero outside
// the image), g a 3 x 3 filter; summed over the channels the product is 16
// GEMMs, one for each position (xi, nu) of the transformed tile:
// M[xi nu][tile][o] = sum_c V[xi nu][tile][c] U[xi nu][c][o], 16 multiplies
// for the direct product's 36. wino_weights writes U = G g G^T, [16][Cp][Op]
// (C and O rounded up to the step and the block, zero-padded), into the
// caller's workspace; conv_wino then runs the 16 GEMMs for BT = 32 tiles x
// BO = 64 output channels a block of 256 threads, thread group xi nu = tid
// / 16 one position's 32 x 64 product as 8 x 16 register tiles (tiles ti 4
// + (i % 4) + 16 (i / 4), channels oi 4 + (j % 4) + 16 (j / 4)): 24 floats
// read from shared memory for 128 FFMAs. Each step of CK = 8 channels, a
// thread loads one tile's patch of one channel (a warp's lanes over 8
// neighbouring channels of 4 tiles: 32-byte runs of x) into registers while
// the step before runs its FFMAs, forms V = B^T d B (additions only) and
// stores it into the other stage of a two-stage ring in shared memory,
// V[xi nu][c][tile]; U's stage comes by 16-byte cp.async; one barrier a
// step. The epilogue puts the 16 M tiles through shared memory (over the
// ring), and each thread takes one output channel of 8 tiles: Y = A^T M A,
// then scale, bias and the activation, each output pixel stored once,
// channels-last. Neither V nor M reaches device memory. On an H100 the
// 8 x 8 tiles of 32 channels (two blocks an SM) spilled at 128 registers
// and ran 1-12% slower at stages 2-4; the raw patches staged by cp.async
// in place of registers, and an epilogue in two 32-channel passes, were
// slower still (PERF.md §6).
namespace wino {
constexpr int BT = 32, BO = 64, CK = 8, NT = 256, JN = BO / 4;
constexpr int VLD = BT + 4;  // V's tile stride: the loader's stores hit 32
                             // banks
constexpr int ULD = BO, MLD = BO + 4;
constexpr int VSTAGE = 16 * CK * VLD, USTAGE = 16 * CK * ULD;  // floats
constexpr int RING = 2 * (VSTAGE + USTAGE), MTILE = 16 * BT * MLD;
constexpr int SMEM = (RING > MTILE ? RING : MTILE) * 4;  // bytes
}  // namespace wino

// U[xi nu][c][o] = (G g G^T)[xi][nu] for the filter g[ky][kx] = w[o][(ky 3
// + kx) C + c], zero for c >= C or o >= O; one thread an (o, c)
__global__ void wino_weights(const float* __restrict__ w,
                             float* __restrict__ u, int C, int O, int Cp,
                             int Op) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x, c = blockIdx.y;
  if (o >= Op) return;
  const bool in = c < C && o < O;
  float t[4][3];  // G g
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float g[3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
      g[ky] = in ? w[(size_t)o * 9 * C + (ky * 3 + kx) * C + c] : 0.f;
    t[0][kx] = g[0];
    t[1][kx] = 0.5f * (g[0] + g[1] + g[2]);
    t[2][kx] = 0.5f * (g[0] - g[1] + g[2]);
    t[3][kx] = g[2];
  }
  float* dst = u + (size_t)c * Op + o;
  const size_t plane = (size_t)Cp * Op;
#pragma unroll
  for (int xi = 0; xi < 4; ++xi) {
    dst[(4 * xi + 0) * plane] = t[xi][0];
    dst[(4 * xi + 1) * plane] = 0.5f * (t[xi][0] + t[xi][1] + t[xi][2]);
    dst[(4 * xi + 2) * plane] = 0.5f * (t[xi][0] - t[xi][1] + t[xi][2]);
    dst[(4 * xi + 3) * plane] = t[xi][2];
  }
}

// the Winograd conv of x channels-last [N, H, W, C] (any C; the rule takes
// C % 4 == 0) with U from wino_weights: block b owns output channels
// (b % nob) * BO .. and tiles (b / nob) * BT .., nob = Op / BO (the blocks
// that share a tile range run together, so x is read from device memory
// about once); 254 registers, one block an SM
__global__ void __launch_bounds__(wino::NT, 1)
conv_wino(const float* __restrict__ x, const float* __restrict__ u,
          const float* __restrict__ scale, const float* __restrict__ bias,
          float* __restrict__ out, ConvGeom g, int TH, int TW, int P, int O,
          int Cp, int Op, int act) {
  using namespace wino;
  extern __shared__ __align__(16) float wsm[];
  float* vs = wsm;               // [2][16][CK][VLD]
  float* us = wsm + 2 * VSTAGE;  // [2][16][CK][ULD]
  const int tid = threadIdx.x, nob = Op / BO;
  const int o0 = (blockIdx.x % nob) * BO, p0 = (blockIdx.x / nob) * BT;
  // the loader's tile and channel; the patch's in-image cells as bits
  const int lt = tid / CK, lc = tid % CK;
  const float* img = x;
  int base = 0;
  unsigned inside = 0;
  if (p0 + lt < P) {
    const int p = p0 + lt, n = p / (TH * TW), r = p - n * (TH * TW);
    const int ty = r / TW, tx = r - ty * TW;
    const int iy0 = 2 * ty - g.ph, ix0 = 2 * tx - g.pw;
    img = x + (size_t)n * g.H * g.W * g.C;
    base = (iy0 * g.W + ix0) * g.C;  // may be negative: read only inside
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int iy = iy0 + e / 4, ix = ix0 + e % 4;
      if ((unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W)
        inside |= 1u << e;
    }
  }
  const int rowstep = g.W * g.C;
  float d[16];
  // the thread's patch of channel c0 + lc into registers, zero outside the
  // image and past C
  auto load_v = [&](int c0) {
    const int c = c0 + lc;
    const unsigned m = c < g.C ? inside : 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      d[e] = (m >> e) & 1u ? img[base + (e / 4) * rowstep + (e % 4) * g.C + c]
                           : 0.f;
  };
  // V = B^T d B into stage buf: rows (B^T d), then columns (. B)
  auto stash_v = [&](int buf) {
    float t[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t[0][j] = d[j] - d[8 + j];
      t[1][j] = d[4 + j] + d[8 + j];
      t[2][j] = d[8 + j] - d[4 + j];
      t[3][j] = d[4 + j] - d[12 + j];
    }
    float* dst = vs + buf * VSTAGE + lc * VLD + lt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[(4 * i + 0) * CK * VLD] = t[i][0] - t[i][2];
      dst[(4 * i + 1) * CK * VLD] = t[i][1] + t[i][2];
      dst[(4 * i + 2) * CK * VLD] = t[i][2] - t[i][1];
      dst[(4 * i + 3) * CK * VLD] = t[i][1] - t[i][3];
    }
  };
  // U[.][c0 .. c0 + CK)[o0 .. o0 + BO) into stage buf, 16-byte copies
  auto load_u = [&](int c0, int buf) {
#pragma unroll
    for (int it = 0; it < 16 * CK * BO / 4 / NT; ++it) {
      const int i = it * NT + tid;
      const int xn = i / (CK * BO / 4), rem = i % (CK * BO / 4);
      const int c = rem / (BO / 4), q = rem % (BO / 4);
      cp_async16(us + buf * USTAGE + (xn * CK + c) * ULD + 4 * q,
                 u + ((size_t)xn * Cp + c0 + c) * Op + o0 + 4 * q, true);
    }
  };
  const int xn = tid / 16, ti = tid % 4, oi = (tid / 4) % 4;
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
  const int steps = Cp / CK;
  load_u(0, 0);
  cp_async_commit();
  load_v(0);
  stash_v(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    // the next step's U copies and x loads are in flight during the FFMAs
    if (st + 1 < steps) {
      load_u((st + 1) * CK, buf ^ 1);
      load_v((st + 1) * CK);
    }
    cp_async_commit();
    const float* vb = vs + buf * VSTAGE + xn * CK * VLD + 4 * ti;
    const float* ub = us + buf * USTAGE + xn * CK * ULD + 4 * oi;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(vb + c * VLD);
      const float4 a1 = *reinterpret_cast<const float4*>(vb + c * VLD + 16);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[JN];
#pragma unroll
      for (int jc = 0; jc < JN / 4; ++jc) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(ub + c * ULD + 16 * jc);
        bv[4 * jc] = b4.x;
        bv[4 * jc + 1] = b4.y;
        bv[4 * jc + 2] = b4.z;
        bv[4 * jc + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // stage buf ^ 1 was last read in step st - 1, which every thread
    // finished before the barrier that ended it
    if (st + 1 < steps) stash_v(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // the 16 M tiles through shared memory, over the ring: [16][BT][MLD]
  float* ms = wsm;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 4 * ti + (i & 3) + 16 * (i >> 2);
#pragma unroll
    for (int jc = 0; jc < JN / 4; ++jc)
      *reinterpret_cast<float4*>(ms + (xn * BT + t) * MLD + 4 * oi + 16 * jc) =
          make_float4(acc[i][4 * jc], acc[i][4 * jc + 1], acc[i][4 * jc + 2],
                      acc[i][4 * jc + 3]);
  }
  __syncthreads();
  const int eo = tid % BO, o = o0 + eo;
  if (o >= O) return;
#pragma unroll
  for (int k = 0; k < BT * BO / NT; ++k) {
    const int t = tid / BO + (NT / BO) * k, p = p0 + t;
    if (p >= P) continue;
    float r0[4], r1[4];  // A^T M
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m0 = ms[((0 + j) * BT + t) * MLD + eo];
      const float m1 = ms[((4 + j) * BT + t) * MLD + eo];
      const float m2 = ms[((8 + j) * BT + t) * MLD + eo];
      const float m3 = ms[((12 + j) * BT + t) * MLD + eo];
      r0[j] = m0 + m1 + m2;
      r1[j] = m1 - m2 - m3;
    }
    const float y[2][2] = {{r0[0] + r0[1] + r0[2], r0[1] - r0[2] - r0[3]},
                           {r1[0] + r1[1] + r1[2], r1[1] - r1[2] - r1[3]}};
    const int n = p / (TH * TW), r = p - n * (TH * TW);
    const int oy = 2 * (r / TW), ox = 2 * (r % TW);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        if (oy + dy < g.OH && ox + dx < g.OW)
          out[(((size_t)n * g.OH + oy + dy) * g.OW + ox + dx) * O + o] =
              epilogue(y[dy][dx], o, scale, bias, act);
  }
}

// the geometry rule: a 3x3 kernel, stride 1, dilation 1 and C % 4 == 0
// (any padding) takes Winograd in f32; kernels.conv_algo mirrors it
bool winograd(const ConvGeom& g) {
  return g.kh == 3 && g.kw == 3 && g.sh == 1 && g.sw == 1 && g.dh == 1 &&
         g.dw == 1 && g.C % 4 == 0;
}

// U into ws (16 * Cp * Op floats, kernels._winograd_workspace; refused if
// ws_n is fewer), then the conv; both on stream st
int launch_wino(const float* x, const float* w, float* ws, long long ws_n,
                const float* sc, const float* bi, float* out,
                const ConvGeom& g, int O, int act, cudaStream_t st) {
  using namespace wino;
  const int Cp = (g.C + CK - 1) / CK * CK, Op = (O + BO - 1) / BO * BO;
  const int TH = (g.OH + 1) / 2, TW = (g.OW + 1) / 2;
  const long long P = (long long)g.N * TH * TW;
  const long long blocks = (P + BT - 1) / BT * (Op / BO);
  if (!ws || ws_n < 16LL * Cp * Op || Cp > 65535 || P > 0x7fffffff ||
      blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  wino_weights<<<dim3((Op + 127) / 128, Cp), 128, 0, st>>>(w, ws, g.C, O, Cp,
                                                          Op);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(conv_wino,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_wino<<<static_cast<unsigned>(blocks), NT, SMEM, st>>>(
      x, ws, sc, bi, out, g, TH, TW, static_cast<int>(P), O, Cp, Op, act);
  return static_cast<int>(cudaGetLastError());
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
// [O]; ws an f32 workspace of ws_n floats, at least 16 * ceil(C / 8) * 8 *
// ceil(O / 64) * 64 where the Winograd rule holds
// (kernels._winograd_workspace; the entry refuses a smaller one), else
// unused (null, 0). The path is a rule on the dtype and the geometry alone
// (kernels.conv_algo mirrors it): f32 stride-1 3x3 convs with C % 4 == 0
// take Winograd F(2x2, 3x3); an f32 pointwise stride-1 conv reads x as the
// [N*H*W, C] matrix it is; every other f32 conv is the implicit GEMM; bf16
// takes the patches [M, K] made by the caller as the x of a 1x1 stride-1
// unpadded conv over [1, 1, M, K] and refuses any other geometry. An
// entry of its own so that its launches are counted apart from the FC
// chain's.
extern "C" int mx_fused_conv_bn_act(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, void* ws, long long ws_n,
                                    int N, int H, int W,
                                    int C, int OH, int OW, int O, int kh,
                                    int kw, int sh, int sw, int ph, int pw,
                                    int dh, int dw, int act, int dtype,
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
  if (winograd(g)) {
    return launch_wino(xf, wf, static_cast<float*>(ws), ws_n, sc, bi, of, g,
                       O, act, st);
  }
  if (C % 4 == 0 && vec_ok_f32(x, w, 4))
    return launch_f32<conv_f32<128, true>, conv_f32<64, true>>(
        M, O, st, xf, wf, sc, bi, of, g, (int)M, O, act);
  return launch_f32<conv_f32<128, false>, conv_f32<64, false>>(
      M, O, st, xf, wf, sc, bi, of, g, (int)M, O, act);
}
