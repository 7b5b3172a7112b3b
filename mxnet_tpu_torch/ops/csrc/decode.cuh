// The split-KV decode read shared by paged_attention.cu
// (mx_paged_attention_decode) and fused_decode_attention.cu: one split of
// a slot's cache rows [S, L, KV, D] against the query rows of one kv head,
// leaving the split's running softmax state (m, l, acc[D], scores in base
// 2) in a workspace for a merge. paged_attention.cu's header describes the
// design.
#pragma once

#include <math.h>

#include "common.cuh"

using namespace mxk;

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_U = 4;  // keys a lane group scores per tile
// keys of a tile: DEC_THREADS / lanes-per-key groups x DEC_U keys, each
// row 16 x lanes-per-key bytes, so a stage is always DEC_STAGE bytes of K
// (and as many of V)
constexpr int DEC_STAGE = DEC_THREADS * DEC_U * 16;
constexpr int DEC_TK_MAX = DEC_THREADS * DEC_U;

struct DecArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 row scales [S, L, KV] (null for a float cache)
  const float* vs;
  const int* pos;
  void* out;
  float* ws;  // [S, KV, NS, G*C, D + 2]: m, l, acc[D] of each split
  int S, C, H, KV, L, D, NS;
  float scale;  // softmax scale x log2(e)
  // chunk row c sees keys [0, pos + c + kofs]: 0 for a paged chunk (its
  // rows are written before the read), -1 for a decode step whose new
  // row is not in the cache yet
  int kofs;
};

template <int N>
struct Bits;
template <>
struct Bits<1> {
  using T = uint8_t;
};
template <>
struct Bits<2> {
  using T = uint16_t;
};
template <>
struct Bits<4> {
  using T = uint32_t;
};

// the 16 / sizeof(T) values of one 16-byte chunk, as f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8 b as the f32 2^23 + 128 + b, built by a byte permute of b + 128 into
// the mantissa of 2^23, less 2^23 + 128: exact, and on the full-rate ALUs
// where a conversion instruction runs at a quarter of their rate
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __uint_as_float(__byte_perm(w[i] ^ 0x80808080u, 0x4b000000u,
                                      0x7540u | b)) -
          8388736.f;
}

// merge running state (mo, lo, ao) into (m, l, a); a row whose max is
// still -inf takes 0 as its reference, so an empty state adds exactly 0.
// The read's softmax arithmetic is spelled out (__fmul_rn, __fadd_rn,
// fmaf) wherever the compiler could otherwise contract a product and a sum
// one way in one instantiation and another way in the next: a row's result
// is then the same bits whatever RT and the other rows of its block (a
// verify chunk's rows equal C = 1 reads at their positions).
template <int E>
__device__ __forceinline__ void merge_state(float& m, float& l, float* a,
                                            float mo, float lo,
                                            const float* ao) {
  const float mn = fmaxf(m, mo);
  const float ref = mn == -INFINITY ? 0.f : mn;
  const float ca = fast_exp2(m - ref), cb = fast_exp2(mo - ref);
  l = __fadd_rn(__fmul_rn(l, ca), __fmul_rn(lo, cb));
#pragma unroll
  for (int e = 0; e < E; ++e)
    a[e] = __fadd_rn(__fmul_rn(a[e], ca), __fmul_rn(ao[e], cb));
  m = mn;
}

// query rows a block of decode_split takes at most: 32 f32 registers
// of q and 32 of acc a lane (8 f32, 4 bf16 or 2 int8 rows)
template <typename TKV>
__host__ __device__ constexpr int dec_rows() {
  return 2 * sizeof(TKV);
}

// q of slot s, chunk row c, head h, dim d from q [S, C, H, D] as stored
template <typename TQ>
struct PlainQ {
  const TQ* q;
  int C, H, D;
  __device__ __forceinline__ float operator()(int s, int c, int h,
                                              int d) const {
    return to_f32(q[(((size_t)s * C + c) * H + h) * D + d]);
  }
};

// One split of the read: keys [sp ceil(L / NS), (sp + 1) ceil(L / NS)) of
// query rows [r0, r0 + RT) of the G*C rows of kv head kvh of slot s (RT =
// 1 for a read without GQA, which then holds a quarter of the registers),
// q from qsrc(s, c, h, d). Writes the split's (m, l, acc[D]) per row to
// a.ws. ring: 2 x 2 x DEC_STAGE bytes of shared memory (16-byte aligned);
// scl: 2 x 2 x DEC_TK_MAX floats for an int8 cache, else unused. Called by
// every thread of a DEC_THREADS block; the caller syncs before it reuses
// the shared memory.
template <typename TKV, bool QUANT, int RT, class QSrc>
__device__ __forceinline__ void decode_split(const DecArgs& a,
                                             const QSrc& qsrc, bool vec,
                                             int sp, int r0, int kvh, int s,
                                             uint8_t* ring, float* scl) {
  constexpr int E = 16 / sizeof(TKV);  // values of a 16-byte chunk

  const int G = a.H / a.KV, GC = G * a.C;
  const int tid = threadIdx.x;
  const int nrows = min(RT, GC - r0);
  const int p = max(a.pos[s], 0);
  const int nk = min(a.L, p + a.C + a.kofs);  // keys the last row sees
  const int ks_ = (a.L + a.NS - 1) / a.NS;
  const int k0 = sp * ks_, k1 = min(k0 + ks_, nk);
  const int D = a.D, W = D + 2;
  float* ws =
      a.ws + ((((size_t)s * a.KV + kvh) * a.NS + sp) * GC + r0) * W;
  if (k0 >= k1) {  // past the slot's last live key: an empty partial
    if (tid < nrows) {
      ws[tid * W] = -INFINITY;
      ws[tid * W + 1] = 0.f;
    }
    return;
  }

  // a key row as 16-byte chunks, padded to a power of two of them: one
  // lane a chunk, lpk lanes a key, ng lane groups, tk keys a tile
  const int nch = (D + E - 1) / E;
  int lg = 0;
  while ((1 << lg) < nch) ++lg;
  const int lpk = 1 << lg;
  const int rbytes = 16 * lpk;
  const int ng = DEC_THREADS / lpk, tk = ng * DEC_U;
  const int ch = tid & (lpk - 1), grp = tid >> lg;
  const int lane = tid % 32, warp = tid / 32;

  using B = typename Bits<sizeof(TKV)>::T;
  const TKV* kg = static_cast<const TKV*>(a.k);
  const TKV* vg = static_cast<const TKV*>(a.v);
  // issue tile t's rows (and int8 scales) into stage st; rows at and past
  // k1 and chunks past the row are zero-filled
  auto load = [&](int t, int st) {
    const int j0 = k0 + t * tk;
    uint8_t* kd = ring + (2 * st) * DEC_STAGE;
    uint8_t* vd = ring + (2 * st + 1) * DEC_STAGE;
    for (int i = tid; i < tk * lpk; i += DEC_THREADS) {
      const int jj = i >> lg, c = i & (lpk - 1), j = j0 + jj;
      const bool in = j < k1 && c < nch;
      const size_t row = ((size_t)s * a.L + (j < k1 ? j : k0)) * a.KV + kvh;
      if (vec) {
        const size_t src = row * D + (in ? c : 0) * E;
        cp_async16(kd + jj * rbytes + c * 16, kg + src, in);
        cp_async16(vd + jj * rbytes + c * 16, vg + src, in);
      } else {
        const B* kb = reinterpret_cast<const B*>(kg) + row * D;
        const B* vb = reinterpret_cast<const B*>(vg) + row * D;
        B* kt = reinterpret_cast<B*>(kd + jj * rbytes) + c * E;
        B* vt = reinterpret_cast<B*>(vd + jj * rbytes) + c * E;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = c * E + e;
          kt[e] = in && d < D ? kb[d] : B(0);
          vt[e] = in && d < D ? vb[d] : B(0);
        }
      }
    }
    if constexpr (QUANT) {
      for (int i = tid; i < tk; i += DEC_THREADS) {
        const int j = j0 + i;
        const size_t row =
            ((size_t)s * a.L + (j < k1 ? j : k0)) * a.KV + kvh;
        cp_async4(scl + (2 * st) * DEC_TK_MAX + i, a.ks + row, j < k1);
        cp_async4(scl + (2 * st + 1) * DEC_TK_MAX + i, a.vs + row,
                  j < k1);
      }
    }
  };

  float m[RT], l[RT], acc[RT][E];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // the first tile's copies fly while q is read
  const int ntile = (k1 - k0 + tk - 1) / tk;
  load(0, 0);
  cp_async_commit();

  // q rows of the tile in registers, scaled into base 2
  float qr[RT][E];
  int qlim[RT];  // the last key each row sees
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    qlim[r] = -1;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    if (r < nrows) {
      const int rr = r0 + r, g = rr / a.C, c = rr % a.C;
      qlim[r] = p + c + a.kofs;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = ch * E + e;
        if (d < D) qr[r][e] = qsrc(s, c, kvh * G + g, d) * a.scale;
      }
    }
  }

  for (int t = 0; t < ntile; ++t) {
    if (t + 1 < ntile) load(t + 1, (t + 1) & 1);
    cp_async_commit();  // also when empty, so that the wait below holds
    cp_async_wait<1>();
    __syncthreads();
    const int st = t & 1, j0 = k0 + t * tk;
    // this group's keys j0 + grp + ng u: scores, reduced over the group
    float sc[DEC_U][RT];
    uint4 vr[DEC_U];
#pragma unroll
    for (int u = 0; u < DEC_U; ++u) {
      const int jj = grp + ng * u;
      const uint4 kc = *reinterpret_cast<const uint4*>(
          ring + (2 * st) * DEC_STAGE + jj * rbytes + ch * 16);
      vr[u] = *reinterpret_cast<const uint4*>(
          ring + (2 * st + 1) * DEC_STAGE + jj * rbytes + ch * 16);
      float kf[E];
      unpack16<TKV>(kc, kf);
      const float kscale =
          QUANT ? scl[(2 * st) * DEC_TK_MAX + jj] : 1.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= nrows) continue;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);
        sc[u][r] = __fmul_rn(d, kscale);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= nrows) continue;  // uniform across the block
#pragma unroll
      for (int u = 0; u < DEC_U; ++u)
        for (int o = 1; o < lpk; o <<= 1)
          sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= nrows) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < DEC_U; ++u) {
        const int j = j0 + grp + ng * u;
        if (!(j < k1 && j <= qlim[r])) sc[u][r] = -INFINITY;
        mx = fmaxf(mx, sc[u][r]);
      }
      if (mx == -INFINITY) continue;  // no key of this group is visible
      const float mn = fmaxf(m[r], mx);
      const float corr = fast_exp2(m[r] - mn);
      l[r] = __fmul_rn(l[r], corr);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = __fmul_rn(acc[r][e], corr);
#pragma unroll
      for (int u = 0; u < DEC_U; ++u) {
        const float pj = fast_exp2(sc[u][r] - mn);  // 0 where masked
        l[r] = __fadd_rn(l[r], pj);
        const float w =
            QUANT ? __fmul_rn(pj,
                              scl[(2 * st + 1) * DEC_TK_MAX + grp + ng * u])
                  : pj;
        float vf[E];
        unpack16<TKV>(vr[u], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(w, vf[e], acc[r][e]);
      }
      m[r] = mn;
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();

  // the lane groups of a warp, then the warps (through the free ring)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r >= nrows) continue;
    for (int o = lpk; o < 32; o <<= 1) {
      float ao[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge_state<E>(m[r], l[r], acc[r], mo, lo, ao);
    }
  }
  // the warps' row states, at most 8 rows of 130 floats each
  static_assert(DEC_WARPS * 8 * 130 * 4 <= 2 * 2 * DEC_STAGE,
                "ring too small");
  float* red = reinterpret_cast<float*>(ring);
  const int rw = lpk * E + 2;  // floats of a row's state
  if (lane < lpk) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= nrows) continue;
      float* b = red + (warp * RT + r) * rw;
      if (lane == 0) {
        b[0] = m[r];
        b[1] = l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) b[2 + lane * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * W; i += DEC_THREADS) {
    const int r = i / W, x = i % W;
    float mw[DEC_WARPS], mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      mw[w] = red[(w * RT + r) * rw];
      mx = fmaxf(mx, mw[w]);
    }
    float val = mx;
    if (x > 0) {
      const float ref = mx == -INFINITY ? 0.f : mx;
      val = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w)
        val = fmaf(red[(w * RT + r) * rw + x], fast_exp2(mw[w] - ref),
                   val);
    }
    ws[r * W + x] = val;
  }
}

}  // namespace
