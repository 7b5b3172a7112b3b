// quant_matmul: out[M, F] = x[M, E] @ dequant(q)[F, E]^T, f32 accumulation.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py quant_matmul (l.1259; kernel
// _quant_mm_kernel l.1250, _dequant_w l.1239, _unpack4_block l.1226).
//
// Weights: int8 [F, E] with one f32 scale per output channel, applied to
// the accumulated product; or uint8 [F, E/2] holding two signed nibbles
// per byte (low nibble = even element) with f32 scales [F, E/group],
// applied to each weight before the product.
//
// Bound on the H100: at decode (M = 32 rows) the product does 64 flops
// per weight byte it streams, far below the ~295 the card needs to be
// compute-bound, so the weight bytes bound it; at prefill (M <= 256) it
// nears the line. Design: a block owns a 32-row x 64-channel output tile
// and walks its share of E in steps of 32, staging the x tile and the
// weight tile (dequantized, int4 unpacked on the way) in shared memory.
// Row tiles are the fastest grid index, so the blocks that share a weight
// tile run together and each weight byte comes from device memory about
// once. Narrow weights (few 64-channel tiles) would leave most SMs idle,
// so the contraction is split over blockIdx.z into `ksplit` ranges whose
// f32 partial sums go to a workspace; a second kernel adds them in split
// order and applies the int8 scale. The split depends on F and E only,
// never on M, so a row's result does not depend on the batch it rides in.
// Two forms of the tile loop, chosen from the inputs:
//   * bf16 x, E a multiple of 32, int8 or int4 with groups of >= 16: the
//     tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); int8 and
//     int4 values are exact in bf16, and an int4 group's scale multiplies
//     each 16-deep partial product;
//   * otherwise (f32 x, small int4 groups, ragged E): the CUDA cores in
//     f32, the weight tile scaled per value, each of 256 threads keeping
//     2 rows x 4 channels of accumulators.
// wgmma/TMA pipelines are later work.
#include "common.cuh"

using namespace mxk;

namespace {

constexpr int BM = 32;       // rows of x per block
constexpr int BF = 64;       // output channels per block
constexpr int BK = 32;       // contraction step
constexpr int THREADS = 256;

// Four consecutive x values of row m from e on, as f32 (zeros past E).
template <typename TX>
__device__ __forceinline__ void load_x4(const TX* __restrict__ x, int m,
                                        int e, int M, int E, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (m < M && e + i < E) ? to_f32(x[(size_t)m * E + e + i]) : 0.f;
}

template <typename TX, int BITS>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, float* __restrict__ part,
                    int M, int E, int F, int group, int steps_per_split) {
  __shared__ float xs[BK][BM + 1];
  __shared__ __align__(16) float ws[BK][BF];
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // channels 4*tx .. 4*tx+3
  const int ty = tid / 16;      // rows ty and ty + 16
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  const int nk = (E + BK - 1) / BK;
  const int kbeg = blockIdx.z * steps_per_split;
  const int kend = min(nk, kbeg + steps_per_split);
  const int rowbytes = BITS == 4 ? E / 2 : E;
  const int sw = BITS == 4 ? E / group : 1;
  // loaders: x row xm, quad xq; weight channel wf, k chunk wk (8 values)
  const int xm = tid / 8, xq = tid % 8;
  const int wf = tid % BF, wk = tid / BF;
  const bool wvec = rowbytes % 8 == 0;
  float acc[2][4] = {};

  for (int kt = kbeg; kt < kend; ++kt) {
    const int k0 = kt * BK;
    float xv[4];
    load_x4(x, m0 + xm, k0 + 4 * xq, M, E, xv);
    float wv[8];
    const int f = f0 + wf, e = k0 + 8 * wk;
    if (BITS == 8) {
      const int8_t* row = reinterpret_cast<const int8_t*>(q) +
                          (size_t)f * rowbytes;
      if (f < F && wvec && e + 8 <= E) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + e));
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wv[i] = static_cast<float>(static_cast<int8_t>(
              ((i < 4 ? u.x : u.y) >> (8 * (i & 3))) & 0xff));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wv[i] = (f < F && e + i < E) ? static_cast<float>(row[e + i]) : 0.f;
      }
    } else {
      const uint8_t* row = q + (size_t)f * rowbytes;
      const float* srow = s + (size_t)f * sw;
      uint32_t word = 0;
      if (f < F && e < E) {  // E is even and e a multiple of 8
        if (wvec && e + 8 <= E) {
          word = __ldg(reinterpret_cast<const uint32_t*>(row + e / 2));
        } else {
          for (int b = 0; b < 4 && e + 2 * b < E; ++b)
            word |= static_cast<uint32_t>(row[e / 2 + b]) << (8 * b);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint8_t byte = static_cast<uint8_t>((word >> (8 * b)) & 0xff);
        const bool ok = f < F && e + 2 * b < E;
        const float sc = ok ? srow[(e + 2 * b) / group] : 0.f;
        wv[2 * b] = nibble(byte, 0) * sc;
        wv[2 * b + 1] = nibble(byte, 1) * sc;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[4 * xq + i][xm] = xv[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[8 * wk + i][wf] = wv[i];
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float a0 = xs[k][ty], a1 = xs[k][ty + 16];
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      acc[0][0] += a0 * b.x;
      acc[0][1] += a0 * b.y;
      acc[0][2] += a0 * b.z;
      acc[0][3] += a0 * b.w;
      acc[1][0] += a1 * b.x;
      acc[1][1] += a1 * b.y;
      acc[1][2] += a1 * b.z;
      acc[1][3] += a1 * b.w;
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * M * F;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + 4 * tx + j;
      if (f < F) dst[(size_t)m * F + f] = acc[i][j];
    }
  }
}

// The tensor-core form for bf16 x: the same tiles, each warp a 16-row x
// 32-channel quarter of the block's tile in mma.sync m16n8k16 steps (bf16
// inputs, f32 accumulation). int8 and int4 weight values are exact in
// bf16, so the products are those of the f32 form; an int4 group's scale
// (groups of 16 or more values) multiplies each 16-deep partial product.
constexpr int MMA_THREADS = 128;
constexpr int LDS = BK + 8;  // padded bf16 row of a staged tile

template <int BITS>
__global__ void __launch_bounds__(MMA_THREADS)
quant_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ q,
                        const float* __restrict__ s,
                        float* __restrict__ part, int M, int E, int F,
                        int group, int steps_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BF][LDS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 16 * (warp % 2);   // the warp's rows in the tile
  const int wn = 32 * (warp / 2);   // the warp's channels in the tile
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  const int nk = E / BK;
  const int kbeg = blockIdx.z * steps_per_split;
  const int kend = min(nk, kbeg + steps_per_split);
  const int rowbytes = BITS == 4 ? E / 2 : E;
  const int sw = BITS == 4 ? E / group : 1;
  // loaders: x row tid/4, 8 values from 8*(tid%4); weight row tid/2,
  // 16 values from 16*(tid%2)
  const int xr = tid / 4, xc = 8 * (tid % 4);
  const int wr = tid / 2, wc = 16 * (tid % 2);
  float acc[4][4] = {};

  for (int kt = kbeg; kt < kend; ++kt) {
    const int k0 = kt * BK;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + xr < M)
      xv = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr) * E +
                                                k0 + xc));
    *reinterpret_cast<uint4*>(&xs[xr][xc]) = xv;
    uint32_t wv[8];
    const int f = f0 + wr;
    if (BITS == 8) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (f < F)
        u = __ldg(reinterpret_cast<const uint4*>(q + (size_t)f * rowbytes +
                                                 k0 + wc));
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = words[i / 2] >> (16 * (i & 1));
        wv[i] = pack_bf16(static_cast<float>(static_cast<int8_t>(w & 0xff)),
                          static_cast<float>(
                              static_cast<int8_t>((w >> 8) & 0xff)));
      }
    } else {
      uint2 u = make_uint2(0u, 0u);
      if (f < F)
        u = __ldg(reinterpret_cast<const uint2*>(q + (size_t)f * rowbytes +
                                                 (k0 + wc) / 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint8_t b =
            static_cast<uint8_t>(((i < 4 ? u.x : u.y) >> (8 * (i & 3))) & 0xff);
        wv[i] = pack_bf16(nibble(b, 0), nibble(b, 1));
      }
    }
    *reinterpret_cast<uint4*>(&ws[wr][wc]) =
        make_uint4(wv[0], wv[1], wv[2], wv[3]);
    *reinterpret_cast<uint4*>(&ws[wr][wc + 8]) =
        make_uint4(wv[4], wv[5], wv[6], wv[7]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&xs[wm + g][kk + 2 * t]);
      a[1] = *reinterpret_cast<const uint32_t*>(&xs[wm + g + 8][kk + 2 * t]);
      a[2] = *reinterpret_cast<const uint32_t*>(&xs[wm + g][kk + 8 + 2 * t]);
      a[3] =
          *reinterpret_cast<const uint32_t*>(&xs[wm + g + 8][kk + 8 + 2 * t]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&ws[n + g][kk + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&ws[n + g][kk + 8 + 2 * t]);
        if (BITS == 8) {
          mma16816(acc[j], a, b);
        } else {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(c, a, b);
          const int gi = (k0 + kk) / group;
          const int fa = min(f0 + n + 2 * t, F - 1);
          const int fb = min(f0 + n + 2 * t + 1, F - 1);
          const float sa = s[(size_t)fa * sw + gi];
          const float sb = s[(size_t)fb * sw + gi];
          acc[j][0] += c[0] * sa;
          acc[j][1] += c[1] * sb;
          acc[j][2] += c[2] * sa;
          acc[j][3] += c[3] * sb;
        }
      }
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * M * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = f0 + wn + 8 * j + 2 * t + i;
        if (f < F) dst[(size_t)m * F + f] = acc[j][2 * h + i];
      }
    }
  }
}

// out[m, f] = (sum over splits of part[z, m, f]) * (int8: s[f]), in split
// order, converted to the output dtype.
template <typename TO, int BITS>
__global__ void finish_kernel(const float* __restrict__ part,
                              const float* __restrict__ s,
                              TO* __restrict__ out, int M, int F,
                              int ksplit) {
  const size_t n = (size_t)M * F;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < ksplit; ++z) v += part[(size_t)z * n + i];
    if (BITS == 8) v *= s[i % F];
    out[i] = from_f32<TO>(v);
  }
}

template <typename TX, typename TO, int BITS>
void launch(const void* x, const void* q, const float* s, void* out,
            float* part, int M, int E, int F, int group, int ksplit,
            cudaStream_t stream) {
  const int nk = (E + BK - 1) / BK;
  const int steps = (nk + ksplit - 1) / ksplit;
  // row tiles fastest: the blocks that share a weight tile run together
  const dim3 grid((M + BM - 1) / BM, (F + BF - 1) / BF, ksplit);
  if (sizeof(TX) == 2 && E % BK == 0 && (BITS == 8 || group % 16 == 0) &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    quant_matmul_mma_kernel<BITS><<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint8_t*>(q), s, part, M, E, F, group, steps);
  } else {
    quant_matmul_kernel<TX, BITS><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const uint8_t*>(q), s, part,
        M, E, F, group, steps);
  }
  const size_t n = (size_t)M * F;
  const int blocks = static_cast<int>(min((n + 255) / 256, (size_t)4096));
  finish_kernel<TO, BITS><<<blocks, 256, 0, stream>>>(
      part, s, static_cast<TO*>(out), M, F, ksplit);
}

template <typename TX, typename TO>
void dispatch_bits(int bits, const void* x, const void* q, const float* s,
                   void* out, float* part, int M, int E, int F, int group,
                   int ksplit, cudaStream_t st) {
  if (bits == 8)
    launch<TX, TO, 8>(x, q, s, out, part, M, E, F, group, ksplit, st);
  else
    launch<TX, TO, 4>(x, q, s, out, part, M, E, F, group, ksplit, st);
}

}  // namespace

// part: f32 workspace [ksplit, M, F]; ksplit must not exceed ceil(E / 32).
extern "C" int mx_quant_matmul(const void* x, const void* q, const float* s,
                               void* out, void* part, int M, int E, int F,
                               int bits, int group, int ksplit, int x_dtype,
                               int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(part);
  if ((bits != 8 && bits != 4) || ksplit < 1 || ksplit > (E + BK - 1) / BK ||
      (bits == 4 && (group < 2 || E % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kF32 && out_dtype == kF32) {
    dispatch_bits<float, float>(bits, x, q, s, out, ws, M, E, F, group,
                                ksplit, st);
  } else if (x_dtype == kF32 && out_dtype == kBF16) {
    dispatch_bits<float, __nv_bfloat16>(bits, x, q, s, out, ws, M, E, F,
                                        group, ksplit, st);
  } else if (x_dtype == kBF16 && out_dtype == kF32) {
    dispatch_bits<__nv_bfloat16, float>(bits, x, q, s, out, ws, M, E, F,
                                        group, ksplit, st);
  } else if (x_dtype == kBF16 && out_dtype == kBF16) {
    dispatch_bits<__nv_bfloat16, __nv_bfloat16>(bits, x, q, s, out, ws, M, E,
                                                F, group, ksplit, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
