// The int8/int4 weight-streaming GEMM shared by quant_matmul.cu and
// fused_decode_attention.cu: out[M, F] = A[M, E] @ dequant(q)[F, E]^T with
// f32 sums, tile by tile.
//
// Weights: int8 [F, E] (a per-channel scale the caller's epilogue applies
// to the sum) or uint8 [F, E/2] holding two signed nibbles a byte (low
// nibble the even element) with f32 scales [F, E/group] applied to each
// 16-deep partial product.
//
// A tile is BM = 32 rows x BF = 64 channels over a range of the
// contraction in whole stages of KS = 128 values; the stages of E are cut
// into `ksplit` ranges by a rule of F and E alone (kernels.
// quant_matmul_splits), never of M, and every tile walks its range in the
// same order, so a row's result does not depend on the rows it rides with.
// A block of 128 threads (four warps) computes a tile's partial sum into a
// shared-memory tile (`red`); finish_tile then adds the split ranges of a
// tile in split order: each block writes its partial to a workspace, and
// the last of the tile's blocks to arrive (an atomic count after a memory
// fence) adds them, hands each sum to the caller's epilogue and sets the
// count back to 0 for the next launch, so no second kernel and no memset
// are launched.
//
// Two forms of the tile:
//   * mma_tile, bf16 A with E a multiple of 128, int8 or int4 with groups
//     of a multiple of 16: a four-stage ring of 16-byte cp.async copies,
//     each stage the A tile (32 x 128 bf16, 8 KB) and the raw weight tile
//     (64 rows x 128 bytes int8 or 64 bytes int4), three stages in flight
//     while one is consumed. Each warp takes a 32-deep slice of every
//     stage for all 32 x 64 outputs (mma.sync m16n8k16, bf16 in, f32
//     accumulate), and the four warps' sums meet in a fixed order at the
//     end. The B fragments are built in registers straight from the stored
//     bytes (i8x4_bf16, i4x4_bf16: exact, every int8 and int4 value is a
//     bf16), so no dequantized copy of the tile is staged. A lane's four
//     contraction values of a fragment are four consecutive values in
//     memory: the contraction order inside a 16-deep product is permuted
//     the same way for A and B (int8: lane t takes values 8t..8t+7 of the
//     warp's 32, the first product 8t..8t+3, its k 2t, 2t+1 the values +0,
//     +2 and k 2t+8, 2t+9 the values +1, +3, as i8x4_bf16 pairs them; int4:
//     16j + 4t..4t+3 of product j in order, so a product never straddles a
//     16-value scale group), so a lane loads its A values by 16- or 8-byte
//     reads and its weight bytes by 8- or 2-byte reads; the tiles are
//     XOR-swizzled by 16-byte chunk so that those reads meet no bank
//     conflict.
//   * simt_tile, everything else (f32 A, int4 groups of fewer than 16
//     values, ragged E): the CUDA cores in f32, 32-deep steps staged in
//     shared memory (int4 scaled per value), 4 rows x 4 channels a thread.
//
// Bound on the H100: at decode (M = 32 rows) a tile does 64 flops per
// weight byte, far below the ~295 at which the tensor cores would bound
// it, so the weight stream does: the ring keeps 24 KB of weights in flight
// a block (three blocks an SM at 64 KB of shared memory).
#pragma once

#include "common.cuh"

namespace mxk {
namespace qmm {

constexpr int BM = 32;        // rows of A a tile
constexpr int BF = 64;        // output channels a tile
constexpr int KS = 128;       // contraction values a stage (the split unit)
constexpr int THREADS = 128;  // four warps
constexpr int STAGES = 4;
constexpr int RS = BF + 8;    // floats of a row of the reduction tile
constexpr int X_BYTES = BM * KS * 2;  // a stage's bf16 A tile

template <int BITS>
__host__ __device__ constexpr int w_row_bytes() {
  return KS * BITS / 8;
}
template <int BITS>
__host__ __device__ constexpr int stage_bytes() {
  return X_BYTES + BF * w_row_bytes<BITS>();
}
// shared memory of mma_tile (the four warps' reduction tiles fit in it)
template <int BITS>
__host__ __device__ constexpr int mma_smem() {
  return STAGES * stage_bytes<BITS>();
}
static_assert(4 * BM * RS * 4 <= mma_smem<4>(), "reduction tiles");

constexpr int SIMT_BK = 32;
// shared memory of simt_tile: the A step [32][33] and the weight step
// [32][64] in f32 (the reduction tile fits in it)
constexpr int SIMT_SMEM = (SIMT_BK * (BM + 1) + SIMT_BK * BF) * 4;
static_assert(BM * RS * 4 <= SIMT_SMEM, "reduction tile");

// rows [m0, m0 + BM), channels [f0, f0 + BF), stages [st0, st1)
struct Tile {
  int m0, f0, st0, st1;
};

// XOR swizzles of the 16-byte chunks of a stage's tiles: chunk c of A row
// r is stored at c ^ xsw(r) (16 chunks a row), chunk c of weight row n at
// c ^ wsw(n) (8 chunks a row for int8, 4 for int4)
__device__ __forceinline__ int xsw(int r) { return ((r & 1) << 2) | (r & 2); }
template <int BITS>
__device__ __forceinline__ int wsw(int n) {
  return BITS == 8 ? 2 * (n & 3) : (n >> 1) & 3;
}

// Four int4 values (two bytes, the low nibble the even value) as two bf16
// pairs, lo = values 0, 1, hi = values 2, 3. A nibble with its sign bit
// flipped is n + 8 in [0, 16), which in the mantissa of the bf16 128 (whose
// unit is 1) gives 136 + n; less 136 in bf16 arithmetic, exact.
__device__ __forceinline__ void i4x4_bf16(uint32_t h, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = h ^ 0x8888u;
  const uint32_t a = 0x43004300u | (u & 0xfu) | ((u & 0xf0u) << 12);
  const uint32_t b = 0x43004300u | ((u >> 8) & 0xfu) | ((u & 0xf000u) << 4);
  const __nv_bfloat162 k = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 ra =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), k);
  const __nv_bfloat162 rb =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), k);
  lo = *reinterpret_cast<const uint32_t*>(&ra);
  hi = *reinterpret_cast<const uint32_t*>(&rb);
}

// issue stage st of a tile (A rows past M and weight rows past F
// zero-filled, nothing read)
template <int BITS>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* x,
                                           const uint8_t* q, int M, int E,
                                           int F, int m0, int f0, int st,
                                           uint8_t* sm) {
  constexpr int RB = w_row_bytes<BITS>(), CR = RB / 16;
  const int tid = threadIdx.x;
  const int k0 = st * KS;
#pragma unroll
  for (int j = 0; j < BM * 16 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i >> 4, c = i & 15;
    const bool in = m0 + r < M;
    cp_async16(sm + r * (KS * 2) + 16 * (c ^ xsw(r)),
               x + (in ? (size_t)(m0 + r) * E + k0 + 8 * c : 0), in);
  }
  const size_t rowbytes = (size_t)E * BITS / 8;
  uint8_t* ws = sm + X_BYTES;
#pragma unroll
  for (int j = 0; j < BF * CR / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int n = i / CR, c = i % CR;
    const bool in = f0 + n < F;
    cp_async16(ws + n * RB + 16 * (c ^ wsw<BITS>(n)),
               q + (in ? (f0 + n) * rowbytes + (size_t)k0 * BITS / 8 + 16 * c
                       : 0),
               in);
  }
}

// one stage's products: warp w takes values [32 w, 32 w + 32) of the
// stage, two m16n8k16 products deep, for both 16-row halves and all eight
// 8-channel blocks. int4: each product's sum is scaled by its group's
// scale before it is added.
template <int BITS>
__device__ __forceinline__ void mma_stage(const uint8_t* sm, int k0,
                                          float (&acc)[2][8][4],
                                          const float* __restrict__ s, int F,
                                          int f0, int sw, int group) {
  constexpr int RB = w_row_bytes<BITS>();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const uint8_t* ws = sm + X_BYTES;
  uint32_t a[2][2][4];  // [16-row half][product][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      const uint8_t* row = sm + r * (KS * 2);
      if (BITS == 8) {
        // values 0, 2 of each four for k 2t, 2t+1 and 1, 3 for 2t+8, 2t+9,
        // as i8x4_bf16 pairs the weights
        const uint4 v = *reinterpret_cast<const uint4*>(
            row + 16 * ((4 * w + t) ^ xsw(r)));
        a[mt][0][h] = __byte_perm(v.x, v.y, 0x5410);
        a[mt][0][2 + h] = __byte_perm(v.x, v.y, 0x7632);
        a[mt][1][h] = __byte_perm(v.z, v.w, 0x5410);
        a[mt][1][2 + h] = __byte_perm(v.z, v.w, 0x7632);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              row + 16 * ((4 * w + 2 * j + (t >> 1)) ^ xsw(r)) + 8 * (t & 1));
          a[mt][j][h] = v.x;
          a[mt][j][2 + h] = v.y;
        }
      }
    }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + g;
    const uint8_t* row = ws + n * RB;
    if (BITS == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          row + 16 * ((2 * w + (t >> 1)) ^ wsw<8>(n)) + 8 * (t & 1));
      const uint32_t words[2] = {u.x, u.y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[2];
        i8x4_bf16(words[j], b[0], b[1]);
        mma16816(acc[0][nt], a[0][j], b);
        mma16816(acc[1][nt], a[1][j], b);
      }
    } else {
      const int fa = min(f0 + 8 * nt + 2 * t, F - 1);
      const int fb = min(f0 + 8 * nt + 2 * t + 1, F - 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t hw = *reinterpret_cast<const uint16_t*>(
            row + 16 * (w ^ wsw<4>(n)) + 8 * j + 2 * t);
        uint32_t b[2];
        i4x4_bf16(hw, b[0], b[1]);
        const int gi = (k0 + 32 * w + 16 * j) / group;
        const float sa = __ldg(s + (size_t)fa * sw + gi);
        const float sb = __ldg(s + (size_t)fb * sw + gi);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(c, a[mt][j], b);
          acc[mt][nt][0] += c[0] * sa;
          acc[mt][nt][1] += c[1] * sb;
          acc[mt][nt][2] += c[2] * sa;
          acc[mt][nt][3] += c[3] * sb;
        }
      }
    }
  }
}

// The tile's partial sum over its stages, into red [BM][RS] (in sm, which
// must hold mma_smem<BITS>() bytes, 16-byte aligned), followed by a
// barrier. The four warps' sums meet in warp order.
template <int BITS>
__device__ void mma_tile(const __nv_bfloat16* __restrict__ x,
                         const uint8_t* __restrict__ q,
                         const float* __restrict__ s, int M, int E, int F,
                         int group, const Tile& tl, uint8_t* sm,
                         float* red) {
  constexpr int SB = stage_bytes<BITS>();
  const int n = tl.st1 - tl.st0;
  const int sw = BITS == 4 ? E / group : 1;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n)
      load_stage<BITS>(x, q, M, E, F, tl.m0, tl.f0, tl.st0 + i, sm + i * SB);
    cp_async_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1 consumed by every warp
    const int nx = i + STAGES - 1;
    if (nx < n)
      load_stage<BITS>(x, q, M, E, F, tl.m0, tl.f0, tl.st0 + nx,
                       sm + (nx % STAGES) * SB);
    cp_async_commit();
    mma_stage<BITS>(sm + (i % STAGES) * SB, (tl.st0 + i) * KS, acc, s, F,
                    tl.f0, sw, group);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' sums
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  float* mine = reinterpret_cast<float*>(sm) + w * BM * RS;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            mine + (16 * mt + g + 8 * h) * RS + 8 * nt + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(sm);
  for (int i = threadIdx.x; i < BM * BF; i += THREADS) {
    const int o = (i / BF) * RS + i % BF;
    red[o] = ((all[o] + all[BM * RS + o]) + all[2 * BM * RS + o]) +
             all[3 * BM * RS + o];
  }
  __syncthreads();
}

// Eight weight values of channel f from value e on, dequantized to f32
// (int8 unscaled, int4 scaled by its group's scale); zeros past F or past
// value lim (<= E).
template <int BITS>
__device__ __forceinline__ void load_w8(const uint8_t* __restrict__ q,
                                        const float* __restrict__ s, int f,
                                        int e, int E, int lim, int F,
                                        int group, float* wv) {
  const size_t rowbytes = (size_t)E * BITS / 8;
  const bool wvec = rowbytes % 8 == 0;
  if (BITS == 8) {
    const int8_t* row = reinterpret_cast<const int8_t*>(q) + f * rowbytes;
    if (f < F && wvec && e + 8 <= lim) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + e));
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wv[i] = static_cast<float>(static_cast<int8_t>(
            ((i < 4 ? u.x : u.y) >> (8 * (i & 3))) & 0xff));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wv[i] = (f < F && e + i < lim) ? static_cast<float>(row[e + i]) : 0.f;
    }
  } else {
    const uint8_t* row = q + f * rowbytes;
    const float* srow = s + (size_t)f * (E / group);
    uint32_t word = 0;
    if (f < F && e < lim) {  // lim is even and e a multiple of 8
      if (wvec && e + 8 <= lim) {
        word = __ldg(reinterpret_cast<const uint32_t*>(row + e / 2));
      } else {
        for (int b = 0; b < 4 && e + 2 * b < lim; ++b)
          word |= static_cast<uint32_t>(row[e / 2 + b]) << (8 * b);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint8_t byte = static_cast<uint8_t>((word >> (8 * b)) & 0xff);
      const bool ok = f < F && e + 2 * b < lim;
      const float sc = ok ? srow[(e + 2 * b) / group] : 0.f;
      wv[2 * b] = nibble(byte, 0) * sc;
      wv[2 * b + 1] = nibble(byte, 1) * sc;
    }
  }
}

// The CUDA-core form of the tile: 32-deep steps of A and the dequantized
// weights staged in f32, each thread 4 rows x 4 channels of sums; then the
// sums into red [BM][RS] (in sm, SIMT_SMEM bytes), followed by a barrier.
template <typename TX, int BITS>
__device__ void simt_tile(const TX* __restrict__ x,
                          const uint8_t* __restrict__ q,
                          const float* __restrict__ s, int M, int E, int F,
                          int group, const Tile& tl, float* sm, float* red) {
  float* xs = sm;                          // [SIMT_BK][BM + 1]
  float* wsm = sm + SIMT_BK * (BM + 1);    // [SIMT_BK][BF]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // channels 4 tx.., rows ty + 8 i
  const int xm = tid / 4, xq = tid % 4;    // A loader: row, 8 values
  const int wf = tid % BF, wk = tid / BF;  // weight loader: 16 values
  const int kb = tl.st0 * KS, ke = min(E, tl.st1 * KS);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += SIMT_BK) {
    const int m = tl.m0 + xm;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = k0 + 8 * xq + i;
      xs[(8 * xq + i) * (BM + 1) + xm] =
          (m < M && e < ke) ? to_f32(x[(size_t)m * E + e]) : 0.f;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float wv[8];
      const int e = k0 + 16 * wk + 8 * hh;
      load_w8<BITS>(q, s, tl.f0 + wf, e, E, ke, F, group, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wsm[(16 * wk + 8 * hh + i) * BF + wf] = wv[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < SIMT_BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(wsm + k * BF + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = xs[k * (BM + 1) + ty + 8 * i];
        acc[i][0] += av * b.x;
        acc[i][1] += av * b.y;
        acc[i][2] += av * b.z;
        acc[i][3] += av * b.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(red + (ty + 8 * i) * RS + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
}

// Hand each of the tile's outputs (m, f, its sum over every split) to
// epi(m, f, v). With ksplit > 1 the block's partial goes to part (tile
// `tile`'s ksplit partials of BM x BF floats, contiguous), and the last
// block of the tile to arrive at count[tile] adds them in split order and
// resets the count. One thread publishes the block's writes (a barrier,
// then a fence before its arrival) and, in the last block, orders the
// block's reads after the others' writes (a fence after the arrival, then
// a barrier); each thread's 16 sums take float4 loads, four splits of them
// in flight at once.
template <class Epi>
__device__ void finish_tile(const float* red, const Tile& tl, int M, int F,
                            int ksplit, int z, int tile,
                            float* __restrict__ part, int* __restrict__ count,
                            const Epi& epi) {
  constexpr int V = BM * BF / 4 / THREADS;  // float4s a thread
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (ksplit == 1) {
    for (int i = tid; i < BM * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      if (tl.m0 + r < M && tl.f0 + c < F)
        epi(tl.m0 + r, tl.f0 + c, red[r * RS + c]);
    }
    return;
  }
  float4* base =
      reinterpret_cast<float4*>(part + (size_t)tile * ksplit * (BM * BF));
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * THREADS;  // row i / 16, columns 4 (i % 16) on
    base[z * (BM * BF / 4) + i] =
        *reinterpret_cast<const float4*>(red + (i / (BF / 4)) * RS +
                                         4 * (i % (BF / 4)));
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(count + tile, 1) == ksplit - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  float4 acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = __ldcg(base + tid + j * THREADS);
#pragma unroll 4
  for (int zz = 1; zz < ksplit; ++zz)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float4 v = __ldcg(base + zz * (BM * BF / 4) + tid + j * THREADS);
      acc[j].x += v.x;
      acc[j].y += v.y;
      acc[j].z += v.z;
      acc[j].w += v.w;
    }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = tid + j * THREADS;
    const int m = tl.m0 + i / (BF / 4), f = tl.f0 + 4 * (i % (BF / 4));
    if (m >= M) continue;
    const float vals[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (f + e < F) epi(m, f + e, vals[e]);
  }
  if (tid == 0) count[tile] = 0;
}

// Every tile of out[M, F] = A @ dequant(q)^T, ksplit ranges each, as work
// items it = blockIdx.x, blockIdx.x + gridDim.x, ... (row tiles fastest,
// then channel tiles, then splits). MMA: mma_tile (TX bf16), else
// simt_tile. sm: mma_smem<BITS>() or SIMT_SMEM bytes, 16-byte aligned.
template <typename TX, int BITS, bool MMA, class Epi>
__device__ void gemm_items(const TX* x, const uint8_t* q, const float* s,
                           int M, int E, int F, int group, int ksplit,
                           float* part, int* count, const Epi& epi,
                           uint8_t* sm) {
  const int nmt = (M + BM - 1) / BM, nft = (F + BF - 1) / BF;
  const int nst = (E + KS - 1) / KS, sps = (nst + ksplit - 1) / ksplit;
  const int n = nmt * nft * ksplit;
  float* red = reinterpret_cast<float*>(sm);
  for (int it = blockIdx.x; it < n; it += gridDim.x) {
    __syncthreads();  // the last item is done with the shared memory
    const int mt = it % nmt, ft = it / nmt % nft, z = it / (nmt * nft);
    const Tile tl{mt * BM, ft * BF, z * sps, min(nst, (z + 1) * sps)};
    if constexpr (MMA)
      mma_tile<BITS>(x, q, s, M, E, F, group, tl, sm, red);
    else
      simt_tile<TX, BITS>(x, q, s, M, E, F, group, tl,
                          reinterpret_cast<float*>(sm), red);
    finish_tile(red, tl, M, F, ksplit, z, ft * nmt + mt, part, count, epi);
  }
}

}  // namespace qmm
}  // namespace mxk
