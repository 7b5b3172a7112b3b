// The attention kernels shared by flash_attention.cu and
// striped_pair_attention.cu: a forward that writes o and the per-row
// logsumexp, and the backward's two kernels, dQ over query tiles and dK/dV
// over key tiles, for bf16 (tensor cores) and f32 (CUDA cores). Each kernel
// is a template on SP, which selects the mask:
//
// * SP = false, flash attention (mxnet_tpu/ops/pallas_kernels.py
//   flash_attention l.373): key k is visible from query q when k < Tk,
//   q < Tq, (causal) q >= k and (window > 0) q - k < window.
// * SP = true, one striped ring hop (striped_pair_attention l.664): local
//   query a and key b stand at global positions a*n + q_off and
//   b*n + k_off, and b is visible from a when a < Tq, b < Tk and
//   a*n + q_off >= b*n + k_off (_spair_fwd_kernel l.445). The lse
//   cotangent g_lse of the hop's output is folded into the backward's row
//   term: dcap = rowsum(dO * O) - g_lse (_spair_bwd_impl l.603-604).
//
// A masked score is -1e30 and its probability exactly 0; the row sum is
// clamped at 1e-30, so a row with no visible key gives o = 0 and
// lse = -1e30 + log(1e-30), which is -1e30 in f32 (the striped hop's
// empty-row convention, l.482-485), instead of NaN. Whole key tiles that
// no row of a query tile can see (and query tiles no key of a key tile is
// seen by) are skipped: for a striped hop the bounds of l.453-458 and
// l.537-541, which skip the half of the hop above the striped diagonal.
//
// Design: one block of 4 warps owns a 64-row tile of the output (queries
// for o and dQ, keys for dK/dV) and walks the tiles of the other side,
// staging each 64-row K/V (or Q/dO) tile in shared memory. Each warp runs
// 16 rows in mma.sync m16n8k16 steps (bf16 in, f32 accumulate): the scores
// stay in registers and are reused as the A operand of the next product
// (P.V, dS.K, P^T.dO, dS^T.Q), and the transposed B operands come from the
// same row-major tiles through ldmatrix .trans. P and dS are rounded to
// bf16 for those products while the row sums and the softmax stay f32.
// Each output tile has one owner, so there are no atomics and a step's
// gradients are the same bits every run. The dQ kernel also writes dcap,
// which the dK/dV kernel, launched after it on the same stream, reads. f32
// inputs take a CUDA-core form of the same three kernels (several threads
// per row, one key or query at a time). cp.async/TMA pipelining and wgmma
// are later work.
#pragma once

#include "common.cuh"

using namespace mxk;

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int THREADS = 128;

struct Shape {
  int B, H, Tq, Tk;
  float scale;
  int causal, window;
  // batch and time strides (elements) of q, k and v; a head's D values
  // are contiguous and the heads D apart. o, dO, dQ, dK and dV are
  // contiguous [B, T, H, D].
  long long qsb, qst, ksb, kst, vsb, vst;
  // the striped hop (SP kernels only): ring size and the ring positions
  // of the query and key blocks, and the lse cotangent [B*H, Tq]
  int n, q_off, k_off;
  const float* glse;
};

// batch and time strides of a contiguous [B, T, H, D] tensor
struct Lay {
  long long sb, st;
};
__device__ __forceinline__ Lay lay_q(const Shape& s, int D) {
  return {(long long)s.Tq * s.H * D, (long long)s.H * D};
}
__device__ __forceinline__ Lay lay_k(const Shape& s, int D) {
  return {(long long)s.Tk * s.H * D, (long long)s.H * D};
}

template <bool SP>
__device__ __forceinline__ bool visible(int qp, int kp, const Shape& s) {
  bool ok = qp < s.Tq && kp < s.Tk;
  if constexpr (SP) {
    ok = ok && qp * s.n + s.q_off >= kp * s.n + s.k_off;
  } else {
    if (s.causal) ok = ok && qp >= kp;
    if (s.window) ok = ok && qp - kp < s.window;
  }
  return ok;
}

// key tiles [lo, hi) any row of query tile qi (bq rows) can see
template <bool SP>
__device__ __forceinline__ void key_range(int qi, int bq, int bk,
                                          const Shape& s, int& lo,
                                          int& hi) {
  hi = (s.Tk + bk - 1) / bk;
  if constexpr (SP) {
    // the tile of the last key the tile's last row sees (l.453-458); C++
    // division rounds toward zero, as lax.div does, then the clamp at 0
    const int numer = ((qi + 1) * bq - 1) * s.n + s.q_off - s.k_off;
    hi = max(0, min(hi, numer / (bk * s.n) + 1));
    lo = 0;
  } else {
    if (s.causal) hi = min(hi, ((qi + 1) * bq + bk - 1) / bk);
    lo = s.window ? max(0, (qi * bq - (s.window - 1)) / bk) : 0;
  }
}

// query tiles [lo, hi) that see any key of key tile kj (bk keys)
template <bool SP>
__device__ __forceinline__ void query_range(int kj, int bq, int bk,
                                            const Shape& s, int& lo,
                                            int& hi) {
  hi = (s.Tq + bq - 1) / bq;
  if constexpr (SP) {
    // the first row that sees the tile's first key (l.537-541)
    lo = max(0, (kj * bk + (s.k_off > s.q_off ? 1 : 0)) / bq);
  } else {
    lo = s.causal ? (kj * bk) / bq : 0;
    if (s.window) hi = min(hi, (kj * bk + bk - 1 + s.window - 1) / bq + 1);
  }
}

// row t of head h of batch b, the heads D apart
template <typename T>
__device__ __forceinline__ T* row_ptr(T* base, int b, int t, int h, Lay l,
                                      int D) {
  return base + b * l.sb + t * l.st + (long long)h * D;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int BQ = 64, BK = 64;  // rows of a query / key tile

// rows [t0, t0 + 64) of head (b, h) into a [64][D + 8] shared tile, zeros
// past T
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* base, int b,
                                          int t0, int T_, int h, Lay l) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_)
      v = *reinterpret_cast<const uint4*>(row_ptr(base, b, t, h, l, D) + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = v;
  }
}

// A fragments of 16 rows (from r0) x D of a [64][D + 8] tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*f)[4],
                                       const __nv_bfloat16* sm, int r0,
                                       int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sm + (r0 + g) * LD + kk * 16 + 2 * t;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }
}

// acc[n] (16 x 8, n < 8) = A (16 x D, fragments) . M^T for the 64 rows of
// a [64][D + 8] tile M: the scores of 16 rows against 64 rows
template <int D>
__device__ __forceinline__ void rows_dot_tile(float (*acc)[4],
                                              uint32_t (*a)[4],
                                              const __nv_bfloat16* sm, int g,
                                              int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* p = sm + (n * 8 + g) * LD + kk * 16 + 2 * t;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(p);
      b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
      mma16816(acc[n], a[kk], b);
    }
  }
}

// out (16 x D) += P (16 x 64, the f32 accumulators of rows_dot_tile,
// rounded to bf16) . M for the 64 rows of a [64][D + 8] tile M
template <int D>
__device__ __forceinline__ void probs_times_tile(float (*out)[4],
                                                 float (*p)[4],
                                                 const __nv_bfloat16* sm,
                                                 int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_trans(b, sm + (kk * 16 + (mi & 1) * 8 + r) * LD + dn * 16 +
                           (mi >> 1) * 8);
      mma16816(out[2 * dn], a, b);
      mma16816(out[2 * dn + 1], a, b + 2);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// store 16 rows (from row t0) x D of f32 accumulators as bf16, times
// mul[h] for the row half h
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           float (*acc)[4], int b, int t0,
                                           int T_, int h, Lay l, int g, int t,
                                           const float* mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = t0 + g + 8 * hf;
    if (row >= T_) continue;
    __nv_bfloat16* dst = row_ptr(base, b, row, h, l, D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * hf] * mul[hf], acc[dn][2 * hf + 1] * mul[hf]);
  }
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
fwd_mma(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
        float* __restrict__ lse, Shape s) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  load_tile<D>(qs, q, b, qi * BQ, s.Tq, h, lq);
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a<D>(qf, qs, wr, g, t);
  const int qp[2] = {qi * BQ + wr + g, qi * BQ + wr + g + 8};

  float acc[D / 8][4] = {};
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  int lo, hi;
  key_range<SP>(qi, BQ, BK, s, lo, hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the last tile's readers are done
    load_tile<D>(ks, k, b, j * BK, s.Tk, h, lk);
    load_tile<D>(vs, v, b, j * BK, s.Tk, h, lv);
    __syncthreads();
    float sc[8][4];
    rows_dot_tile<D>(sc, qf, ks, g, t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = j * BK + n * 8 + 2 * t + (e & 1);
        const float x =
            visible<SP>(qp[e >> 1], kp, s) ? sc[n][e] * s.scale : NEG_BIG;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = j * BK + n * 8 + 2 * t + (e & 1);
        const float p = visible<SP>(qp[e >> 1], kp, s)
                            ? expf(sc[n][e] - m[e >> 1])
                            : 0.f;
        sc[n][e] = p;
        l[e >> 1] += p;  // this thread's share; summed over the quad below
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    probs_times_tile<D>(acc, sc, vs, lane);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && qp[r] < s.Tq)
      lse[(size_t)bh * s.Tq + qp[r]] = m[r] + logf(l[r]);
  }
  store_rows<D>(o, acc, b, qi * BQ + wr, s.Tq, h, lay_q(s, D), g, t, inv);
}

// dcap[row] = sum_d dO[row, d] * O[row, d] (minus g_lse[row] for a striped
// hop) for the rows of a query tile (two threads a row), into shared
// memory and, for real rows, to dcap
template <typename T, int D, bool SP>
__device__ __forceinline__ void tile_dcap(float* dcs, float* __restrict__ dcap,
                                          const T* __restrict__ o,
                                          const T* __restrict__ dout, int b,
                                          int t0, int bh, int rows,
                                          const Shape& s, int h) {
  for (int i = threadIdx.x; i < 2 * rows; i += blockDim.x) {
    const int r = i / 2, half = i % 2, tq = t0 + r;
    float acc = 0.f;
    if (tq < s.Tq) {
      const T* po = row_ptr(o, b, tq, h, lay_q(s, D), D);
      const T* pd = row_ptr(dout, b, tq, h, lay_q(s, D), D);
      for (int d = half; d < D; d += 2) acc += to_f32(po[d]) * to_f32(pd[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if constexpr (SP) {
      if (tq < s.Tq) acc -= s.glse[(size_t)bh * s.Tq + tq];
    }
    if (half == 0) {
      dcs[r] = acc;
      if (tq < s.Tq) dcap[(size_t)bh * s.Tq + tq] = acc;
    }
  }
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
dq_mma(const __nv_bfloat16* __restrict__ q,
       const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v,
       const __nv_bfloat16* __restrict__ o,
       const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ dcap,
       __nv_bfloat16* __restrict__ dq, Shape s) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds_ = qs + BQ * LD;
  __nv_bfloat16* ks = ds_ + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  float* lses = reinterpret_cast<float*>(vs + BK * LD);
  float* dcs = lses + BQ;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  load_tile<D>(qs, q, b, qi * BQ, s.Tq, h, lq);
  load_tile<D>(ds_, dout, b, qi * BQ, s.Tq, h, lay_q(s, D));
  tile_dcap<__nv_bfloat16, D, SP>(dcs, dcap, o, dout, b, qi * BQ, bh, BQ, s,
                                  h);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int tq = qi * BQ + r;
    lses[r] = tq < s.Tq ? lse[(size_t)bh * s.Tq + tq] : 0.f;
  }
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, qs, wr, g, t);
  load_a<D>(df, ds_, wr, g, t);
  const int qp[2] = {qi * BQ + wr + g, qi * BQ + wr + g + 8};
  const float rl[2] = {lses[wr + g], lses[wr + g + 8]};
  const float rd[2] = {dcs[wr + g], dcs[wr + g + 8]};

  float acc[D / 8][4] = {};
  int lo, hi;
  key_range<SP>(qi, BQ, BK, s, lo, hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();
    load_tile<D>(ks, k, b, j * BK, s.Tk, h, lk);
    load_tile<D>(vs, v, b, j * BK, s.Tk, h, lv);
    __syncthreads();
    float sc[8][4], dp[8][4];
    rows_dot_tile<D>(sc, qf, ks, g, t);
    rows_dot_tile<D>(dp, df, vs, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = j * BK + n * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p = visible<SP>(qp[r], kp, s)
                            ? expf(sc[n][e] * s.scale - rl[r])
                            : 0.f;
        sc[n][e] = p * (dp[n][e] - rd[r]) * s.scale;  // dS
      }
    probs_times_tile<D>(acc, sc, ks, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, b, qi * BQ + wr, s.Tq, h, lay_q(s, D), g, t, one);
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
dkv_mma(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dcap,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        Shape s) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * LD;
  __nv_bfloat16* qs = vs + BK * LD;
  __nv_bfloat16* ds_ = qs + BQ * LD;
  float* lses = reinterpret_cast<float*>(ds_ + BQ * LD);
  float* dcs = lses + BQ;
  // under a causal mask the first key tiles are seen by the most queries
  const int kj = blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  load_tile<D>(ks, k, b, kj * BK, s.Tk, h, lk);
  load_tile<D>(vs, v, b, kj * BK, s.Tk, h, lv);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, ks, wr, g, t);
  load_a<D>(vf, vs, wr, g, t);
  const int kp[2] = {kj * BK + wr + g, kj * BK + wr + g + 8};

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  int lo, hi;
  query_range<SP>(kj, BQ, BK, s, lo, hi);
  for (int i = lo; i < hi; ++i) {
    __syncthreads();
    load_tile<D>(qs, q, b, i * BQ, s.Tq, h, lq);
    load_tile<D>(ds_, dout, b, i * BQ, s.Tq, h, lay_q(s, D));
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int tq = i * BQ + r;
      const bool in = tq < s.Tq;
      lses[r] = in ? lse[(size_t)bh * s.Tq + tq] : 0.f;
      dcs[r] = in ? dcap[(size_t)bh * s.Tq + tq] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's 16 keys, columns the tile's
    // 64 queries
    float st[8][4], dpt[8][4];
    rows_dot_tile<D>(st, kf, qs, g, t);
    rows_dot_tile<D>(dpt, vf, ds_, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const float p = visible<SP>(i * BQ + c, kp[e >> 1], s)
                            ? expf(st[n][e] * s.scale - lses[c])
                            : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dcs[c]) * s.scale;  // dS^T
      }
    probs_times_tile<D>(dva, st, ds_, lane);
    probs_times_tile<D>(dka, dpt, qs, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dka, b, kj * BK + wr, s.Tk, h, lay_k(s, D), g, t, one);
  store_rows<D>(dv, dva, b, kj * BK + wr, s.Tk, h, lay_k(s, D), g, t, one);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. P = max(1, D / 32) neighbouring threads share a row,
// each holding DP = D / P of its values; dot products are summed over the
// P lanes with shuffles. A block holds 128 / P rows; the other side's rows
// stream through shared memory 32 at a time.

constexpr int FT = 32;  // rows of the streamed tile

template <int D>
struct Split {
  static constexpr int P = D > 32 ? D / 32 : 1;
  static constexpr int DP = D / P;
  static constexpr int ROWS = THREADS / P;
};

template <int P>
__device__ __forceinline__ float part_sum(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [t0, t0 + FT) of head (b, h) into an [FT][D] f32 tile, zeros past T
template <int D>
__device__ __forceinline__ void load_tile_f32(float* sm,
                                              const float* __restrict__ base,
                                              int b, int t0, int T_, int h,
                                              Lay l) {
  for (int i = threadIdx.x; i < FT * D; i += THREADS) {
    const int r = i / D, c = i % D, t = t0 + r;
    sm[i] = t < T_ ? row_ptr(base, b, t, h, l, D)[c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_part(float* dst, const float* base,
                                          int b, int t, int T_, int h, Lay l,
                                          int part) {
  constexpr int DP = Split<D>::DP;
  const float* p = t < T_ ? row_ptr(base, b, t, h, l, D) + part * DP
                          : nullptr;
#pragma unroll
  for (int i = 0; i < DP; ++i) dst[i] = p ? p[i] : 0.f;
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, Shape s) {
  using S = Split<D>;
  __shared__ float ks[FT * D], vs[FT * D];
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int part = threadIdx.x % S::P;
  const int qp = qi * S::ROWS + threadIdx.x / S::P;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  float qr[S::DP], acc[S::DP];
  load_part<D>(qr, q, b, qp, s.Tq, h, lq, part);
#pragma unroll
  for (int i = 0; i < S::DP; ++i) acc[i] = 0.f;
  float m = NEG_BIG, l = 0.f;
  int lo, hi;
  key_range<SP>(qi, S::ROWS, FT, s, lo, hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();
    load_tile_f32<D>(ks, k, b, j * FT, s.Tk, h, lk);
    load_tile_f32<D>(vs, v, b, j * FT, s.Tk, h, lv);
    __syncthreads();
    for (int c = 0; c < FT; ++c) {
      const float* kr = ks + c * D + part * S::DP;
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) x += qr[i] * kr[i];
      x = part_sum<S::P>(x) * s.scale;
      if (!visible<SP>(qp, j * FT + c, s)) continue;
      const float mn = fmaxf(m, x);
      const float corr = expf(m - mn), p = expf(x - mn);
      m = mn;
      l = l * corr + p;
      const float* vr = vs + c * D + part * S::DP;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) acc[i] = acc[i] * corr + p * vr[i];
    }
  }
  if (qp >= s.Tq) return;
  l = fmaxf(l, 1e-30f);
  float* dst = row_ptr(o, b, qp, h, lay_q(s, D), D) + part * S::DP;
#pragma unroll
  for (int i = 0; i < S::DP; ++i) dst[i] = acc[i] / l;
  if (part == 0) lse[(size_t)bh * s.Tq + qp] = m + logf(l);
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ dcap, float* __restrict__ dq, Shape s) {
  using S = Split<D>;
  __shared__ float ks[FT * D], vs[FT * D], dcs[S::ROWS];
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int part = threadIdx.x % S::P, row = threadIdx.x / S::P;
  const int qp = qi * S::ROWS + row;
  tile_dcap<float, D, SP>(dcs, dcap, o, dout, b, qi * S::ROWS, bh, S::ROWS,
                          s, h);
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  float qr[S::DP], dr[S::DP], acc[S::DP];
  load_part<D>(qr, q, b, qp, s.Tq, h, lq, part);
  load_part<D>(dr, dout, b, qp, s.Tq, h, lay_q(s, D), part);
#pragma unroll
  for (int i = 0; i < S::DP; ++i) acc[i] = 0.f;
  const float rl = qp < s.Tq ? lse[(size_t)bh * s.Tq + qp] : 0.f;
  int lo, hi;
  key_range<SP>(qi, S::ROWS, FT, s, lo, hi);
  __syncthreads();  // dcs
  const float rd = dcs[row];
  for (int j = lo; j < hi; ++j) {
    __syncthreads();
    load_tile_f32<D>(ks, k, b, j * FT, s.Tk, h, lk);
    load_tile_f32<D>(vs, v, b, j * FT, s.Tk, h, lv);
    __syncthreads();
    for (int c = 0; c < FT; ++c) {
      const float* kr = ks + c * D + part * S::DP;
      const float* vr = vs + c * D + part * S::DP;
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) {
        x += qr[i] * kr[i];
        dp += dr[i] * vr[i];
      }
      x = part_sum<S::P>(x);
      dp = part_sum<S::P>(dp);
      if (!visible<SP>(qp, j * FT + c, s)) continue;
      const float ds = expf(x * s.scale - rl) * (dp - rd) * s.scale;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) acc[i] += ds * kr[i];
    }
  }
  if (qp >= s.Tq) return;
  float* dst = row_ptr(dq, b, qp, h, lay_q(s, D), D) + part * S::DP;
#pragma unroll
  for (int i = 0; i < S::DP; ++i) dst[i] = acc[i];
}

template <int D, bool SP>
__global__ void __launch_bounds__(THREADS)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dcap,
        float* __restrict__ dk, float* __restrict__ dv, Shape s) {
  using S = Split<D>;
  __shared__ float qs[FT * D], ds_[FT * D], lses[FT], dcs[FT];
  const int kj = blockIdx.x;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int part = threadIdx.x % S::P;
  const int kp = kj * S::ROWS + threadIdx.x / S::P;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  float kr[S::DP], vr[S::DP], dka[S::DP], dva[S::DP];
  load_part<D>(kr, k, b, kp, s.Tk, h, lk, part);
  load_part<D>(vr, v, b, kp, s.Tk, h, lv, part);
#pragma unroll
  for (int i = 0; i < S::DP; ++i) dka[i] = dva[i] = 0.f;
  int lo, hi;
  query_range<SP>(kj, FT, S::ROWS, s, lo, hi);
  for (int i0 = lo; i0 < hi; ++i0) {
    __syncthreads();
    load_tile_f32<D>(qs, q, b, i0 * FT, s.Tq, h, lq);
    load_tile_f32<D>(ds_, dout, b, i0 * FT, s.Tq, h, lay_q(s, D));
    for (int r = threadIdx.x; r < FT; r += THREADS) {
      const int tq = i0 * FT + r;
      const bool in = tq < s.Tq;
      lses[r] = in ? lse[(size_t)bh * s.Tq + tq] : 0.f;
      dcs[r] = in ? dcap[(size_t)bh * s.Tq + tq] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < FT; ++c) {
      const float* qr = qs + c * D + part * S::DP;
      const float* dr = ds_ + c * D + part * S::DP;
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) {
        x += kr[i] * qr[i];
        dp += vr[i] * dr[i];
      }
      x = part_sum<S::P>(x);
      dp = part_sum<S::P>(dp);
      if (!visible<SP>(i0 * FT + c, kp, s)) continue;
      const float p = expf(x * s.scale - lses[c]);
      const float ds = p * (dp - dcs[c]) * s.scale;
#pragma unroll
      for (int i = 0; i < S::DP; ++i) {
        dva[i] += p * dr[i];
        dka[i] += ds * qr[i];
      }
    }
  }
  if (kp >= s.Tk) return;
  float* pk = row_ptr(dk, b, kp, h, lay_k(s, D), D) + part * S::DP;
  float* pv = row_ptr(dv, b, kp, h, lay_k(s, D), D) + part * S::DP;
#pragma unroll
  for (int i = 0; i < S::DP; ++i) {
    pk[i] = dka[i];
    pv[i] = dva[i];
  }
}

// ---------------------------------------------------------------------------
// launchers

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, bool SP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      const int smem = 3 * 64 * (D + 8) * 2;
      cudaError_t e = set_smem(fwd_mma<D, SP>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      fwd_mma<D, SP><<<dim3((s.Tq + BQ - 1) / BQ, bh), THREADS, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, s);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int rows = Split<D>::ROWS;
  fwd_f32<D, SP><<<dim3((s.Tq + rows - 1) / rows, bh), THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SP>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const float* lse, float* dcap, void* dqp,
       const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      const int smem = 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
      cudaError_t e = set_smem(dq_mma<D, SP>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dq_mma<D, SP><<<dim3((s.Tq + BQ - 1) / BQ, bh), THREADS, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), lse, dcap,
          static_cast<__nv_bfloat16*>(dqp), s);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int rows = Split<D>::ROWS;
  dq_f32<D, SP><<<dim3((s.Tq + rows - 1) / rows, bh), THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, dcap, static_cast<float*>(dqp),
      s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SP>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dcap, void* dk, void* dv,
        const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      const int smem = 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
      cudaError_t e = set_smem(dkv_mma<D, SP>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dkv_mma<D, SP><<<dim3((s.Tk + BK - 1) / BK, bh), THREADS, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout), lse, dcap,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          s);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int rows = Split<D>::ROWS;
  dkv_f32<D, SP><<<dim3((s.Tk + rows - 1) / rows, bh), THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      dcap, static_cast<float*>(dk), static_cast<float*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// the dtypes and head dims the kernels take, for batch*heads blocks
inline bool valid_dims(int D, int dtype, const Shape& s) {
  if (dtype != kF32 && dtype != kBF16) return false;
  if (s.B < 1 || s.H < 1 || s.Tq < 1 || s.Tk < 1 || s.B * s.H > 65535)
    return false;
  if (dtype == kBF16) return D == 16 || D == 32 || D == 64 || D == 128;
  return D == 8 || D == 16 || D == 32 || D == 64 || D == 128;
}

#define MX_ATTN_DISPATCH(call)             \
  switch (D) {                             \
    case 8:                                \
      return call(8);                      \
    case 16:                               \
      return call(16);                     \
    case 32:                               \
      return call(32);                     \
    case 64:                               \
      return call(64);                     \
    case 128:                              \
      return call(128);                    \
  }                                        \
  return static_cast<int>(cudaErrorInvalidValue);

}  // namespace
