// fused_decode_attention: one decode step of an attention node in one launch.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py fused_decode_attention (l.1389;
// kernel _fused_decode_kernel l.1331).
//
// Per slot s at position p = pos[s]: qkv = dequant(wqkv) @ x + bqkv; rope
// (half-split, angles from the caller's cos/sin tables) on the H query
// heads and the KV key heads; per query head h (kv head h / G) one plain
// softmax over the cache rows [0, p) and the new token's own k/v; then
// out = dequant(wo) @ o + bo. The cache is not written here: the roped
// k_new and v_new rows go out for the caller to write.
//
// Bound on the H100: bytes — the int8 (or packed int4) QKV and output
// weights, ~2.4 MB per layer at the 124M LM, plus each slot's live cache
// rows; the flops per byte are a few at most. Design: the TPU version ran
// one grid step per slot with the whole weight block resident in VMEM.
// Here a block owns one (slot, kv head) pair, so a 32-slot step of a
// 12-head model keeps 384 blocks in flight over the 132 SMs:
//   1. it projects only its own rows of wqkv (the kv head's G query heads,
//      its key and its value), rotates them, and keeps them in shared
//      memory;
//   2. it scores the live keys (one thread per key, 16-byte vector loads
//      of the key row) into a full score row per query head, takes one
//      max and one sum per row — the plain softmax of the TPU kernel —
//      and forms the weighted sum of v with the threads split into key
//      groups that each own a 16-byte column chunk of v, the groups'
//      partial sums meeting in a fixed order;
//   3. its heads' columns of wo give a partial output row (E sums), which
//      goes to a workspace; the last block of the slot to finish (an
//      atomic count, after a memory fence) adds the KV partials in kv-head
//      order, applies the int8 scales and the bias, and writes the row.
//      The order of every sum is fixed, so the result is deterministic.
// Every weight load is a 4-byte word per lane, several rows and words in
// flight per lane before any arithmetic, since latency, not bandwidth,
// limits a block. The weights are re-read from L2 (50 MB) by each slot.
// Tensor cores and keeping the weights resident across slots are later
// work.
#include "common.cuh"

using namespace mxk;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 2;  // row steps a warp takes at once
constexpr int CPL = 8;  // 4-byte words of each row a lane loads at once

// The dequantized dot of one stored 4-byte word with its x values: int8,
// 4 values at local e = 4c (unscaled: the per-channel scale multiplies
// the sum); int4, 8 values at local e = 8c, each pair scaled by its
// group's scale (srow[(e0 + e) / group], e0 = the segment's first column).
template <int BITS>
__device__ __forceinline__ float word_dot(uint32_t w, const float* xs, int c,
                                          const float* srow, int e0,
                                          int group) {
  if (BITS == 8) {
    const float4 xv = reinterpret_cast<const float4*>(xs)[c];
    return xv.x * static_cast<float>(static_cast<int8_t>(w & 0xff)) +
           xv.y * static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff)) +
           xv.z * static_cast<float>(static_cast<int8_t>((w >> 16) & 0xff)) +
           xv.w * static_cast<float>(static_cast<int8_t>(w >> 24));
  }
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 xv = reinterpret_cast<const float4*>(xs)[2 * c + h];
    const uint8_t b0 = static_cast<uint8_t>((w >> (16 * h)) & 0xff);
    const uint8_t b1 = static_cast<uint8_t>((w >> (16 * h + 8)) & 0xff);
    const int e = e0 + 8 * c + 4 * h;
    acc += (xv.x * nibble(b0, 0) + xv.y * nibble(b0, 1)) * srow[e / group] +
           (xv.z * nibble(b1, 0) + xv.w * nibble(b1, 1)) *
               srow[(e + 2) / group];
  }
  return acc;
}

// dst[r] = sum_{e < width} xs[e] * dequant(w)[f0 + r, col0 + e] for the
// rows r < nrows (int8 unscaled), by the block's warps: a row takes the
// fewest lanes (a power of two, at most 32) that load its words in one
// step of CPL words each, so short row segments share a warp. xs must be
// 16-byte aligned; col0 a multiple of 4 (int8) or 8 (int4) values.
template <int BITS>
__device__ void project(const float* xs, const uint8_t* __restrict__ w,
                        const float* __restrict__ s, int E, int group,
                        int f0, int nrows, int col0, int width, float* dst,
                        int warp, int lane) {
  const int rowbytes = BITS == 8 ? E : E / 2;
  const int sw = BITS == 8 ? 1 : E / group;
  const int nw = BITS == 8 ? width / 4 : width / 8;  // words per segment
  int lpr = 1;
  while (lpr * CPL < nw && lpr < 32) lpr <<= 1;
  const int rpi = 32 / lpr;                          // rows per warp step
  const int sub = lane / lpr, cl = lane % lpr;
  const uint8_t* base = w + (BITS == 8 ? col0 : col0 / 2);
  for (int r0 = warp * rpi * RPW; r0 < nrows; r0 += WARPS * rpi * RPW) {
    float acc[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < nw; c0 += lpr * CPL) {
      uint32_t wv[RPW][CPL];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int r = r0 + u * rpi + sub;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            base + (size_t)(f0 + r) * rowbytes);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + cl + k * lpr;
          wv[u][k] = (r < nrows && c < nw) ? __ldg(row + c) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int r = r0 + u * rpi + sub;
        const float* srow = s + (size_t)(f0 + r) * sw;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + cl + k * lpr;
          if (r < nrows && c < nw)
            acc[u] += word_dot<BITS>(wv[u][k], xs, c, srow, col0, group);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      float a = acc[u];
      for (int off = lpr / 2; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      const int r = r0 + u * rpi + sub;
      if (cl == 0 && r < nrows) dst[r] = a;
    }
  }
}

// 16 bytes of a cache row as f32 values: 8 bf16 or 4 f32.
template <typename TC>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(uint4 u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32; the first one is the low half
      // of the little-endian word
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename TX, typename TC, int BITS>
__global__ void __launch_bounds__(THREADS)
fused_decode_kernel(const TX* __restrict__ x, const int* __restrict__ pos,
                    const TC* __restrict__ kc, const TC* __restrict__ vc,
                    const uint8_t* __restrict__ wqkv,
                    const float* __restrict__ sqkv,
                    const float* __restrict__ bqkv,
                    const uint8_t* __restrict__ wo,
                    const float* __restrict__ so,
                    const float* __restrict__ bo,
                    const float* __restrict__ cs,
                    const float* __restrict__ sn, TX* __restrict__ out,
                    TC* __restrict__ kn, TC* __restrict__ vn,
                    float* __restrict__ part, int* __restrict__ count,
                    int E, int H, int KV, int D, int L, int group,
                    float scale) {
  using V = Vec16<TC>;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / KV;
  const int GD = G * D;
  const int half = D / 2;
  const int p = min(max(pos[s], 0), L);
  float* xs = smem;              // [E]        the token
  float* qv = xs + E;            // [(G+2)*D]  G query heads, k, v
  float* ov = qv + (G + 2) * D;  // [G*D]      attention output
  float* red = ov + GD;          // [WARPS*D]  v partial sums
  float* sc = red + WARPS * D;   // [G][L+1]   softmax rows
  float* kq = qv + GD;
  float* vq = kq + D;

  for (int e = tid; e < E; e += THREADS) xs[e] = to_f32(x[(size_t)s * E + e]);
  __syncthreads();

  // 1. this kv head's rows of the QKV projection, then scale, bias, rope
  project<BITS>(xs, wqkv, sqkv, E, group, kvh * GD, GD, 0, E, qv, warp,
                lane);
  project<BITS>(xs, wqkv, sqkv, E, group, E + kvh * D, D, 0, E, kq, warp,
                lane);
  project<BITS>(xs, wqkv, sqkv, E, group, E + (KV + kvh) * D, D, 0, E, vq,
                warp, lane);
  __syncthreads();
  for (int i = tid; i < (G + 2) * D; i += THREADS) {
    const int f = i < GD ? kvh * GD + i
                         : (i < GD + D ? E + kvh * D + (i - GD)
                                       : E + (KV + kvh) * D + (i - GD - D));
    qv[i] = (BITS == 8 ? qv[i] * sqkv[f] : qv[i]) + bqkv[f];
  }
  __syncthreads();
  const float* cr = cs + (size_t)s * half;
  const float* sr = sn + (size_t)s * half;
  for (int i = tid; i < (G + 1) * half; i += THREADS) {  // q heads and k
    float* hv = qv + (i / half) * D;
    const int t = i % half;
    const float t1 = hv[t], t2 = hv[t + half];
    hv[t] = t1 * cr[t] - t2 * sr[t];
    hv[t + half] = t2 * cr[t] + t1 * sr[t];
  }
  __syncthreads();

  // 2. attention over the p cache rows and the new token (score p)
  const int nvec = D / V::N;  // 16-byte chunks per cache row
  for (int j = tid; j <= p; j += THREADS) {
    const uint4* kr = reinterpret_cast<const uint4*>(
        kc + (((size_t)s * L + j) * KV + kvh) * D);
    for (int g = 0; g < G; ++g) {
      const float* qh = qv + g * D;
      float a = 0.f;
      if (j < p) {
#pragma unroll 4
        for (int c = 0; c < nvec; ++c) {
          float k8[V::N];
          V::load(__ldg(kr + c), k8);
#pragma unroll
          for (int i = 0; i < V::N; ++i) a += qh[c * V::N + i] * k8[i];
        }
      } else {
        for (int d = 0; d < D; ++d) a += qh[d] * kq[d];
      }
      sc[(size_t)g * (L + 1) + j] = a * scale;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float* row = sc + (size_t)g * (L + 1);
    float mx = -1e30f;
    for (int j = lane; j <= p; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j <= p; j += 32) {
      const float w = expf(row[j] - mx);
      row[j] = w;
      sum += w;
    }
    sum = warp_sum(sum);
    if (lane == 0) ov[g * D] = sum;  // parked until the v sum below
  }
  __syncthreads();
  const int groups = THREADS / nvec;  // key groups of the weighted v sum
  const int kg = tid / nvec, cv = tid % nvec;
  const uint4* vcol =
      reinterpret_cast<const uint4*>(vc + ((size_t)s * L * KV + kvh) * D) + cv;
  const size_t vstride = (size_t)KV * D / V::N;  // uint4s per cache row
  for (int g = 0; g < G; ++g) {
    const float* wrow = sc + (size_t)g * (L + 1);
    float acc[V::N];
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = kg; j < p; j += groups) {
      float vv[V::N];
      V::load(__ldg(vcol + (size_t)j * vstride), vv);
      const float w = wrow[j];
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] += w * vv[i];
    }
    for (int off = nvec; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < V::N; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    const float dsum = ov[g * D];
    __syncthreads();  // every thread has read the parked sum
    if (lane < nvec) {
#pragma unroll
      for (int i = 0; i < V::N; ++i) red[warp * D + cv * V::N + i] = acc[i];
    }
    __syncthreads();
    for (int d = tid; d < D; d += THREADS) {
      float a = 0.f;
      for (int w2 = 0; w2 < WARPS; ++w2) a += red[w2 * D + d];
      ov[g * D + d] = (a + wrow[p] * vq[d]) / dsum;
    }
    __syncthreads();
  }

  // 3. this block's partial output row over its heads' columns of wo
  float* prow = part + ((size_t)s * KV + kvh) * E;
  project<BITS>(ov, wo, so, E, group, 0, E, kvh * GD, GD, prow, warp, lane);
  for (int i = tid; i < D; i += THREADS) {
    kn[((size_t)s * KV + kvh) * D + i] = from_f32<TC>(kq[i]);
    vn[((size_t)s * KV + kvh) * D + i] = from_f32<TC>(vq[i]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + s, 1) == KV - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pslot = part + (size_t)s * KV * E;
  for (int f = tid; f < E; f += THREADS) {
    float a = 0.f;
    for (int b = 0; b < KV; ++b) a += __ldcg(pslot + (size_t)b * E + f);
    out[(size_t)s * E + f] = from_f32<TX>((BITS == 8 ? a * so[f] : a) + bo[f]);
  }
}

template <typename TX, typename TC, int BITS>
int launch(const void* x, const int* pos, const void* kc, const void* vc,
           const void* wqkv, const float* sqkv, const float* bqkv,
           const void* wo, const float* so, const float* bo, const float* cs,
           const float* sn, void* out, void* kn, void* vn, float* part,
           int* count, int S, int E, int H, int KV, int D, int L, int group,
           int smem, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<TX, TC, BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(count, 0, sizeof(int) * S, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_decode_kernel<TX, TC, BITS><<<dim3(S, KV), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), pos, static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const uint8_t*>(wqkv), sqkv,
      bqkv, static_cast<const uint8_t*>(wo), so, bo, cs, sn,
      static_cast<TX*>(out), static_cast<TC*>(kn), static_cast<TC*>(vn),
      part, count, E, H, KV, D, L, group, scale);
  return 0;
}

template <typename TX, typename TC>
int dispatch_bits(int bits, const void* x, const int* pos, const void* kc,
                  const void* vc, const void* wqkv, const float* sqkv,
                  const float* bqkv, const void* wo, const float* so,
                  const float* bo, const float* cs, const float* sn,
                  void* out, void* kn, void* vn, float* part, int* count,
                  int S, int E, int H, int KV, int D, int L, int group,
                  int smem, float scale, cudaStream_t st) {
  // whole 16-byte chunks per cache row, a power-of-two count of them at
  // most 32; whole 4-byte words per weight row segment
  const int nvec = D * static_cast<int>(sizeof(TC)) / 16;
  if (D * static_cast<int>(sizeof(TC)) % 16 != 0 || nvec > 32 ||
      (nvec & (nvec - 1)) != 0 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8)
    return launch<TX, TC, 8>(x, pos, kc, vc, wqkv, sqkv, bqkv, wo, so, bo,
                             cs, sn, out, kn, vn, part, count, S, E, H, KV,
                             D, L, group, smem, scale, st);
  if (bits == 4 && group >= 2 && E % group == 0)
    return launch<TX, TC, 4>(x, pos, kc, vc, wqkv, sqkv, bqkv, wo, so, bo,
                             cs, sn, out, kn, vn, part, count, S, E, H, KV,
                             D, L, group, smem, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// part: f32 workspace [S, KV, E]; count: int32 workspace [S] (zeroed here).
extern "C" int mx_fused_decode_attention(
    const void* x, const int* pos, const void* kc, const void* vc,
    const void* wqkv, const float* sqkv, const float* bqkv, const void* wo,
    const float* so, const float* bo, const float* cs, const float* sn,
    void* out, void* kn, void* vn, void* part, void* count, int S, int E,
    int H, int KV, int D, int L, int bits, int group, int smem, float scale,
    int x_dtype, int cache_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV != 0 || H * D != E)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pw = static_cast<float*>(part);
  int* cw = static_cast<int*>(count);
  int rc;
  if (x_dtype == kF32 && cache_dtype == kF32) {
    rc = dispatch_bits<float, float>(bits, x, pos, kc, vc, wqkv, sqkv, bqkv,
                                     wo, so, bo, cs, sn, out, kn, vn, pw, cw,
                                     S, E, H, KV, D, L, group, smem, scale,
                                     st);
  } else if (x_dtype == kF32 && cache_dtype == kBF16) {
    rc = dispatch_bits<float, __nv_bfloat16>(
        bits, x, pos, kc, vc, wqkv, sqkv, bqkv, wo, so, bo, cs, sn, out, kn,
        vn, pw, cw, S, E, H, KV, D, L, group, smem, scale, st);
  } else if (x_dtype == kBF16 && cache_dtype == kF32) {
    rc = dispatch_bits<__nv_bfloat16, float>(
        bits, x, pos, kc, vc, wqkv, sqkv, bqkv, wo, so, bo, cs, sn, out, kn,
        vn, pw, cw, S, E, H, KV, D, L, group, smem, scale, st);
  } else if (x_dtype == kBF16 && cache_dtype == kBF16) {
    rc = dispatch_bits<__nv_bfloat16, __nv_bfloat16>(
        bits, x, pos, kc, vc, wqkv, sqkv, bqkv, wo, so, bo, cs, sn, out, kn,
        vn, pw, cw, S, E, H, KV, D, L, group, smem, scale, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
