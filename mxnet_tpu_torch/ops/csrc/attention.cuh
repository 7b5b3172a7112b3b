// The attention kernels shared by flash_attention.cu,
// striped_pair_attention.cu and paged_attention.cu: a forward that writes o
// and the per-row logsumexp, and the backward's two kernels, dQ over query
// tiles and dK/dV over key tiles, for bf16 (tensor cores) and f32 (CUDA
// cores). Each kernel is a template on the mask (enum Mask):
//
// * Flash, flash attention (mxnet_tpu/ops/pallas_kernels.py
//   flash_attention l.373): key k is visible from query q when k < Tk,
//   q < Tq, (causal) q >= k and (window > 0) q - k < window.
// * Striped, one striped ring hop (striped_pair_attention l.664): local
//   query a and key b stand at global positions a*n + q_off and
//   b*n + k_off, and b is visible from a when a < Tq, b < Tk and
//   a*n + q_off >= b*n + k_off (_spair_fwd_kernel l.445). The lse
//   cotangent g_lse of the hop's output is folded into the backward's row
//   term: dcap = rowsum(dO * O) - g_lse (_spair_bwd_impl l.603-604).
// * Paged, the slot-paged prefill chunk (paged_attention l.1115; forward
//   only, a bf16 q over a bf16 or an int8 cache, no lse): chunk row c of
//   slot b sees cached key k when k <= pos[b] + c, the block reading
//   pos[b] itself; query head h reads kv head h / group (GQA).
//
// A row with no visible key gives o = 0 and lse = -1e30 (the striped
// hop's empty-row convention, l.482-485), instead of NaN. Whole key tiles
// that no row of a query tile can see (and query tiles no key of a key
// tile is seen by) are skipped: for a striped hop the bounds of l.453-458
// and l.537-541, which skip the half of the hop above the striped
// diagonal; for a paged chunk every key past the tile's last row's
// pos + c.
//
// Bound on the H100: at the 124M LM's training shape a causal bf16
// forward does ~257 flops per byte of q/k/v/o, near the ~295 where the
// tensor cores become the limit, so bytes and operations bound it about
// equally (flash_attention.cu has the numbers); a paged prefill chunk of
// C rows over a cache of pos + C live keys does ~2 C flops per cached
// element. What kept the first kernels far above either bound was
// latency: tiles loaded synchronously between barriers while the tensor
// cores idled, and scalar mask and softmax work between the products.
//
// The bf16 forward (fwd_mma): one block of BQ / 16 warps (BQ = 64 or
// 128) owns a BQ-row query tile, its Q fragments in registers, and walks
// the visible 64-row K/V tiles through a two-stage ring in dynamic shared
// memory filled by 16-byte cp.async: tile j+1's K and V are in flight
// while tile j's products run. K and V are separate commit groups, so
// Q.K^T waits only for K and P.V only for V, one barrier each; rows past
// the last key the tile may read are zero-filled (src-size 0) and never
// read from device memory. BQ = 128 feeds each staged K/V tile to twice
// the rows; it is taken where the grid gives every SM two such blocks,
// each held to 128 registers. The grid runs the (batch, head) pairs
// fastest and the query tiles from the last, so all of the causal mask's
// heaviest tiles start first and the lightest fill the tail. The K
// fragments of Q.K^T come by ldmatrix, the V fragments of P.V by
// ldmatrix .trans. A key tile that every row of the query tile sees whole
// skips the mask; only the boundary tiles (the diagonal, a ragged end, a
// window edge, the striped diagonal, the paged chunk's last live keys)
// evaluate it, setting masked scores to -inf. The softmax runs in base 2
// with scale * log2(e) folded into one FMA per score (ex2.approx), and a
// row whose running max is still -inf takes 0 as its reference, so masked
// probabilities are exactly 0. lse is still the natural-log
// m * scale + log(l).
//
// The bf16 backward (dq_mma, dkv_mma) keeps the JAX package's two kernels,
// each with its own sequential loop: dQ over query tiles, dK/dV over key
// tiles, P recomputed from (q, k, lse). Each output tile has one owner, so
// there are no atomics and a step's gradients are the same bits every run.
// One block of 4 warps owns a 64-row tile of the output, each warp 16 rows,
// and walks the 64-row tiles of the other side through a two-stage cp.async
// ring, one barrier a step: tile j+1's copies are in flight while tile j's
// products run; dK/dV stages each query tile's lse and dcap beside its Q and
// dO. The block's own Q and dO (K and V) stay in shared memory, their A
// fragments taken by ldmatrix at each product, so that up to D = 64 a thread
// holds at most 168 registers and three blocks (12 warps) share an SM (at D
// = 128 two blocks fill its shared memory, and keep up to 255 registers).
// Counted from a step's operations at the card's peak rates, its shared-
// memory reads, its ex2 and its mma.sync take comparable times, and more
// warps overlap them: on an H100 at the LM's shape, two blocks an SM holding
// the fragments in registers, and 128-row tiles of 8 warps, were both
// slower. The grid runs the (batch, head) pairs fastest and the heaviest
// tiles first (dQ's last query tiles, dK/dV's first key tiles under a causal
// mask). Each warp runs mma.sync m16n8k16 steps (bf16 in, f32 accumulate)
// with every fragment taken by ldmatrix (.trans for the products by P and
// dS): the scores stay in registers as the A operand of the next product
// (dS.K; P^T.dO, dS^T.Q). P = exp2(S * scale * log2(e) - lse * log2(e)), one
// FMA and ex2.approx a score; dS is taken without the scale, which
// multiplies dQ and dK once at the store. Only boundary tiles evaluate the
// mask (probability 0), and a warp whose rows see no key of the tile skips
// it (its terms are exact zeros). P and dS are rounded to bf16 for the
// products while the row sums and the softmax stay f32. The dQ kernel also
// writes dcap, which the dK/dV kernel, launched after it on the same stream,
// reads. wgmma and TMA (a warp-specialised pipeline) are later work.
//
// f32 inputs (the SP step's hops) stay true f32 on the CUDA cores, where a
// hop's ~3.2 GFLOP forward and ~5.6 GFLOP backward bound it (67 TFLOP/s).
// The f32 kernels work tile-wise as the bf16 ones do: a block of 128
// threads (256 at D = 128) owns a 64-row tile of its output and walks the
// visible 64-row tiles of the other side through a two-stage cp.async ring
// (16-byte copies where every row is 16-byte aligned), with every product
// register-tiled: 4 owned rows x 8 streamed rows a thread for the scores,
// 4 rows x D / 8 columns for the accumulation over a score tile in shared
// memory (2 rows at D = 128). The forward (fwd_f32) takes one row max, one
// row sum and one correction a tile. The backward keeps the bf16 one's two
// kernels: dq_f32 (Q and dO resident; K in the ring and V in one stage
// refilled once dP has read it) forms S = Q.K^T, P = exp2(S c - lse
// log2(e)) with one FMA and ex2 a score, dP = dO.V^T and dS / scale = P (dP
// - dcap) in the score tile, then dQ += dS.K, and writes dcap; dkv_f32 (K
// and V resident; Q with its rows' lse and dcap in the ring, dO in one
// stage) forms the transposed S^T, P^T and dP^T, then dV += P^T.dO and, the
// score tile refilled, dK += dS^T.Q. The scale multiplies dQ and dK once at
// the store; each output tile has one owner, so there are no atomics and
// the gradients are the same bits every run. Every f32 kernel evaluates the
// mask only where full_tile is false (probability exactly 0 outside it) and
// walks only the tiles key_range / query_range name. Flash's and the striped
// hop's f32 kernels are these templates, so an n = 1 hop equals flash causal
// bit for bit.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

using namespace mxk;

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int THREADS = 128;

enum class Mask { Flash, Striped, Paged };

struct Shape {
  int B, H, Tq, Tk;
  float scale;
  int causal, window;
  // batch and time strides (elements) of q, k and v; a head's D values
  // are contiguous and the heads D apart. o, dO, dQ, dK and dV are
  // contiguous [B, T, H, D].
  long long qsb, qst, ksb, kst, vsb, vst;
  // the striped hop (Striped kernels only): ring size and the ring
  // positions of the query and key blocks, and the lse cotangent
  // [B*H, Tq]
  int n, q_off, k_off;
  const float* glse;
  // the paged chunk (Paged only): query heads per kv head, and each
  // slot's chunk start [B] in device memory
  int group = 1;
  const int* pos = nullptr;
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

// p0 is the paged chunk's start (Paged only)
template <Mask M>
__device__ __forceinline__ bool visible(int qp, int kp, const Shape& s,
                                        int p0 = 0) {
  bool ok = qp < s.Tq && kp < s.Tk;
  if constexpr (M == Mask::Striped) {
    ok = ok && qp * s.n + s.q_off >= kp * s.n + s.k_off;
  } else if constexpr (M == Mask::Paged) {
    ok = ok && kp <= p0 + qp;
  } else {
    if (s.causal) ok = ok && qp >= kp;
    if (s.window) ok = ok && qp - kp < s.window;
  }
  return ok;
}

// one past the last key row any row of query tile qi (bq rows) may read:
// for a paged chunk, the key of its last row (never past the rows the
// chunk has written)
template <Mask M>
__device__ __forceinline__ int key_end(int qi, int bq, const Shape& s,
                                       int p0) {
  if constexpr (M == Mask::Paged) {
    const int clast = min((qi + 1) * bq, s.Tq) - 1;
    return min(s.Tk, p0 + clast + 1);
  }
  return s.Tk;
}

// key tiles [lo, hi) any row of query tile qi (bq rows) can see
template <Mask M>
__device__ __forceinline__ void key_range(int qi, int bq, int bk,
                                          const Shape& s, int& lo, int& hi,
                                          int p0 = 0) {
  hi = (s.Tk + bk - 1) / bk;
  if constexpr (M == Mask::Striped) {
    // the tile of the last key the tile's last row sees (l.453-458); C++
    // division rounds toward zero, as lax.div does, then the clamp at 0
    const int numer = ((qi + 1) * bq - 1) * s.n + s.q_off - s.k_off;
    hi = max(0, min(hi, numer / (bk * s.n) + 1));
    lo = 0;
  } else if constexpr (M == Mask::Paged) {
    hi = (key_end<M>(qi, bq, s, p0) + bk - 1) / bk;
    lo = 0;
  } else {
    if (s.causal) hi = min(hi, ((qi + 1) * bq + bk - 1) / bk);
    lo = s.window ? max(0, (qi * bq - (s.window - 1)) / bk) : 0;
  }
}

// true when every row of the query tile at q0 (bq rows) sees every key of
// the key tile at k0 (bk keys) whole, so the tile needs no mask; rows past
// Tq count as seeing (their outputs are not stored)
template <Mask M>
__device__ __forceinline__ bool full_tile(int q0, int bq, int k0, int bk,
                                          const Shape& s, int p0, int kend) {
  if (k0 + bk > kend) return false;  // a ragged end: zero rows to mask
  if constexpr (M == Mask::Striped) {
    return q0 * s.n + s.q_off >= (k0 + bk - 1) * s.n + s.k_off;
  } else if constexpr (M == Mask::Paged) {
    return k0 + bk - 1 <= p0 + q0;
  } else {
    bool ok = true;
    if (s.causal) ok = ok && q0 >= k0 + bk - 1;
    if (s.window) ok = ok && q0 + bq - 1 - k0 < s.window;
    return ok;
  }
}

// query tiles [lo, hi) that see any key of key tile kj (bk keys)
template <Mask M>
__device__ __forceinline__ void query_range(int kj, int bq, int bk,
                                            const Shape& s, int& lo,
                                            int& hi) {
  hi = (s.Tq + bq - 1) / bq;
  if constexpr (M == Mask::Striped) {
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

// rows of the streamed tiles: the query tiles dK/dV walks, the key tiles
// the forward and dQ walk
constexpr int BQ = 64, BK = 64;

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

// out (16 x D) += P (16 x 64, the f32 accumulators of rows_dot_tile_ldsm,
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

// issue rows [t0, t0 + R) of head (b, h) into an [R][D + 8] shared tile by
// NT threads, zeros at and past row tend (not read)
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* sm,
                                                const __nv_bfloat16* base,
                                                int b, int t0, int tend,
                                                int h, Lay l) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((R * CH) % NT != 0 && i >= R * CH) break;
    const int r = i / CH, c = (i % CH) * 8;
    const int t = t0 + r;
    const bool in = t < tend;
    cp_async16(sm + r * LD + c, in ? row_ptr(base, b, t, h, l, D) + c : base,
               in);
  }
}

// rows_dot_tile with the B fragments of two 8-key column blocks taken by
// one ldmatrix: matrices (n, k lo), (n, k hi), (n+1, k lo), (n+1, k hi)
template <int D>
__device__ __forceinline__ void rows_dot_tile_ldsm(float (*acc)[4],
                                                   uint32_t (*a)[4],
                                                   const __nv_bfloat16* sm,
                                                   int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < 8; n += 2)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b,
              sm + ((n + (mi >> 1)) * 8 + r) * LD + kk * 16 + (mi & 1) * 8);
      mma16816(acc[n], a[kk], b);
      mma16816(acc[n + 1], a[kk], b + 2);
    }
}

// rows_dot_tile_ldsm with the A fragments too taken by ldmatrix, from
// rows [r0, r0 + 16) of a [.][D + 8] tile As, one 16-column step at a
// time: the backward keeps its resident tiles in shared memory instead of
// registers, so that three blocks share an SM. Each acc[n] sums the same
// products in the same order as rows_dot_tile_ldsm.
template <int D>
__device__ __forceinline__ void rows_dot_tile_smem(float (*acc)[4],
                                                   const __nv_bfloat16* As,
                                                   int r0,
                                                   const __nv_bfloat16* sm,
                                                   int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // matrices (rows lo, k lo), (rows hi, k lo), (rows lo, k hi), (rows
    // hi, k hi): the A fragment of mma16816
    uint32_t a[4];
    ldsm_x4(a, As + (r0 + (mi & 1) * 8 + r) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b,
              sm + ((n + (mi >> 1)) * 8 + r) * LD + kk * 16 + (mi & 1) * 8);
      mma16816(acc[n], a, b);
      mma16816(acc[n + 1], a, b + 2);
    }
  }
}

// issue rows [t0, t0 + R) of int8 head (b, h) into an unpadded [R][D]
// shared tile by NT threads, 16 values a copy, zeros at and past row tend
// (not read)
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile_i8_async(int8_t* sm,
                                                   const int8_t* base, int b,
                                                   int t0, int tend, int h,
                                                   Lay l) {
  constexpr int CH = D / 16;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((R * CH) % NT != 0 && i >= R * CH) break;
    const int r = i / CH, c = (i % CH) * 16;
    const int t = t0 + r;
    const bool in = t < tend;
    cp_async16(sm + r * D + c, in ? row_ptr(base, b, t, h, l, D) + c : base,
               in);
  }
}

// issue the f32 scales of rows [t0, t0 + R) of kv head hk of slot b from
// [B, Tk, KV] into shared memory, one a thread from thread `first`, zeros
// at and past row tend (not read: a masked probability is 0, but 0 times
// an unwritten NaN scale would still be NaN)
template <int R>
__device__ __forceinline__ void load_scales_async(float* sm,
                                                  const float* base, int b,
                                                  int t0, int tend, int hk,
                                                  int KV, int Tk, int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < R) {
    const int t = t0 + i;
    const bool in = t < tend;
    cp_async4(sm + i, in ? base + ((size_t)b * Tk + t) * KV + hk : base, in);
  }
}

// an unpadded [R][D] int8 tile as the [R][D + 8] bf16 tile the products
// read, by NT threads, 16 values a thread at a time: every int8 value is
// a bf16 integer, so the conversion is exact (i8x4_bf16, its pairs put
// back in order by byte permutes)
template <int D, int R, int NT>
__device__ __forceinline__ void tile_i8_to_bf16(__nv_bfloat16* dst,
                                                const int8_t* src) {
  constexpr int CH = D / 16, LD = D + 8;
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if ((R * CH) % NT != 0 && i >= R * CH) break;
    const int r = i / CH, c = (i % CH) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * D + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t ev, od;  // values (0, 2) and (1, 3) of word e
      i8x4_bf16(w[e], ev, od);
      o[2 * e] = __byte_perm(ev, od, 0x5410);      // values 0, 1
      o[2 * e + 1] = __byte_perm(ev, od, 0x7632);  // values 2, 3
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// the bf16 forward: o (and, but for a paged chunk, lse) of a QT-row query
// tile, QT / 16 warps of 16 rows; the header's note gives the design.
// Up to D = 64 two 128-row blocks share an SM (at most 128 registers, a
// few bytes spilled): the launcher takes them only where the grid gives
// every SM two. The body of the kernels fwd_mma (a bf16 cache) and
// fwd_mma_i8 (below).
//
// TK = int8_t (Mask::Paged only): the int8 cache with its f32 row scales
// kscale, vscale [B, Tk, H / group]. Each K/V tile and its 64 + 64 row
// scales come through a two-stage ring of raw int8 (16-byte copies) and
// f32 (4-byte copies), one commit group a tile, and are turned into the
// bf16 tiles the products read, exactly: the products take the cache's
// integers, and the row scales apply outside them, kscale[key] to each
// score column before the mask and the running max, vscale[key] to each
// probability column after l has summed it and before P is rounded to
// bf16 for P.V. Step j waits for tile j, issues tile j+1, converts tile
// j, and passes one barrier before its products.
template <int D, Mask M, int QT, typename TK>
__device__ __forceinline__ void fwd_tile(
    const __nv_bfloat16* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, Shape s, const float* __restrict__ kscale,
    const float* __restrict__ vscale) {
  constexpr bool I8 = std::is_same<TK, int8_t>::value;
  static_assert(!I8 || M == Mask::Paged, "an int8 cache is paged");
  constexpr int NT = QT * 2;
  constexpr int LD = D + 8;
  constexpr int STAGE = BK * LD;  // elements of one K or V stage
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  // bf16: [2][BK][LD] each; int8: one [BK][LD] tile each, then the ring
  __nv_bfloat16* ks = qs + QT * LD;
  __nv_bfloat16* vs = ks + (I8 ? 1 : 2) * STAGE;
  int8_t* k8 = reinterpret_cast<int8_t*>(vs + (I8 ? 1 : 2) * STAGE);
  int8_t* v8 = k8 + 2 * BK * D;                        // [2][BK][D] each
  float* ksc = reinterpret_cast<float*>(v8 + 2 * BK * D);
  float* vsc = ksc + 2 * BK;                           // [2][BK] each
  // the last query tiles see the most keys under a causal mask: the grid
  // runs the (b, h) pairs fastest and the tiles from the last, so the
  // heaviest tiles of all heads start before any lighter one
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int hk = h / s.group;  // the kv head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const int q0 = qi * QT;
  int p0 = 0;
  if constexpr (M == Mask::Paged) p0 = max(s.pos[b], 0);
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  const int kend = key_end<M>(qi, QT, s, p0);
  int lo, hi;
  key_range<M>(qi, QT, BK, s, lo, hi, p0);
  // int8: issue tile j's rows and scales into ring stage st
  auto issue_i8 = [&](int j, int st) {
    if constexpr (I8) {
      const int kv = s.H / s.group;
      load_tile_i8_async<D, BK, NT>(k8 + st * BK * D, k, b, j * BK, kend,
                                    hk, lk);
      load_tile_i8_async<D, BK, NT>(v8 + st * BK * D, v, b, j * BK, kend,
                                    hk, lv);
      load_scales_async<BK>(ksc + st * BK, kscale, b, j * BK, kend, hk, kv,
                            s.Tk, 0);
      load_scales_async<BK>(vsc + st * BK, vscale, b, j * BK, kend, hk, kv,
                            s.Tk, BK);
    }
  };

  // commit groups, in order: Q, K[lo], V[lo], then K[j+1], V[j+1] in each
  // step j (empty past the last tile, so the counts below hold throughout);
  // int8: Q, tile lo, then tile j+1 in each step j
  load_tile_async<D, QT, NT>(qs, q, b, q0, s.Tq, h, lq);
  cp_async_commit();
  if constexpr (I8) {
    if (lo < hi) issue_i8(lo, 0);
    cp_async_commit();
    cp_async_wait<1>();  // Q
  } else {
    if (lo < hi) load_tile_async<D, BK, NT>(ks, k, b, lo * BK, kend, hk, lk);
    cp_async_commit();
    if (lo < hi) load_tile_async<D, BK, NT>(vs, v, b, lo * BK, kend, hk, lv);
    cp_async_commit();
    cp_async_wait<2>();  // Q
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a<D>(qf, qs, wr, g, t);
  // scores are taken raw and scaled inside the exponent's FMA by c > 0: a
  // negative scale flips Q's signs (exact in bf16), and a zero one is
  // taken as the smallest positive, so masked (-inf) scores stay -inf
  float sc = s.scale;
  if (sc < 0.f) {
    sc = -sc;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] ^= 0x80008000u;
  }
  const float c = fmaxf(sc * LOG2E, 1e-30f);
  const int qp[2] = {q0 + wr + g, q0 + wr + g + 8};

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    const __nv_bfloat16* kt = ks + (I8 ? 0 : stage * STAGE);
    const __nv_bfloat16* vt = vs + (I8 ? 0 : stage * STAGE);
    if constexpr (I8) {
      cp_async_wait<0>();  // tile j
      // tile j is visible to every warp, and every warp is done with step
      // j-1: its bf16 tiles and its ring stage, which tile j+1 takes
      __syncthreads();
      if (j + 1 < hi) issue_i8(j + 1, stage ^ 1);
      cp_async_commit();
      tile_i8_to_bf16<D, BK, NT>(ks, k8 + stage * BK * D);
      tile_i8_to_bf16<D, BK, NT>(vs, v8 + stage * BK * D);
      __syncthreads();  // the bf16 tiles are visible to every warp
    } else {
      cp_async_wait<1>();  // K[j]; V[j] may still be in flight
      // K[j] is visible to every warp, and every warp is done with step
      // j-1, whose stage the next tile takes
      __syncthreads();
      if (j + 1 < hi)
        load_tile_async<D, BK, NT>(ks + (stage ^ 1) * STAGE, k, b,
                                   (j + 1) * BK, kend, hk, lk);
      cp_async_commit();
      if (j + 1 < hi)
        load_tile_async<D, BK, NT>(vs + (stage ^ 1) * STAGE, v, b,
                                   (j + 1) * BK, kend, hk, lv);
      cp_async_commit();
    }

    float sv[8][4];
    rows_dot_tile_ldsm<D>(sv, qf, kt, lane);
    if constexpr (I8) {
      // score = ks[key] * (q . k_int8)
      const float* kr = ksc + stage * BK + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(kr + n * 8);
        sv[n][0] *= f.x;
        sv[n][1] *= f.y;
        sv[n][2] *= f.x;
        sv[n][3] *= f.y;
      }
    }
    if (!full_tile<M>(q0, QT, j * BK, BK, s, p0, kend)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = j * BK + n * 8 + 2 * t + (e & 1);
          if (!visible<M>(qp[e >> 1], kp, s, p0)) sv[n][e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sv[n][e]);
    float mr[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // the reference point, in log2 units; 0 while the row has seen no
      // key, so that exp2(-inf - 0) = 0
      mr[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;
      corr[r] = m[r] == -INFINITY ? 0.f : fast_exp2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(sv[n][e], c, -mr[e >> 1]));
        sv[n][e] = p;
        l[e >> 1] += p;  // this thread's share; summed over the quad below
      }
    if constexpr (I8) {
      // P.V = (p * vs[key]) . v_int8; l keeps the unscaled p
      const float* vr = vsc + stage * BK + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(vr + n * 8);
        sv[n][0] *= f.x;
        sv[n][1] *= f.y;
        sv[n][2] *= f.x;
        sv[n][3] *= f.y;
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    if constexpr (!I8) {
      cp_async_wait<2>();  // V[j]; K[j+1] and V[j+1] may still be in flight
      __syncthreads();
    }
    probs_times_tile<D>(acc, sv, vt, lane);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    if constexpr (M != Mask::Paged) {
      if (t == 0 && qp[r] < s.Tq)
        lse[(size_t)bh * s.Tq + qp[r]] =
            l[r] > 0.f ? m[r] * sc + logf(l[r]) : NEG_BIG;
    }
  }
  store_rows<D>(o, acc, b, q0 + wr, s.Tq, h, lay_q(s, D), g, t, inv);
}

template <int D, Mask M, int QT>
__global__ void __launch_bounds__(QT * 2, QT == 128 && D <= 64 ? 2 : 1)
fwd_mma(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
        float* __restrict__ lse, Shape s) {
  fwd_tile<D, M, QT, __nv_bfloat16>(q, k, v, o, lse, s, nullptr, nullptr);
}

// the paged chunk over an int8 cache (64-row query tiles)
template <int D>
__global__ void __launch_bounds__(128, 1)
fwd_mma_i8(const __nv_bfloat16* __restrict__ q,
           const int8_t* __restrict__ k, const int8_t* __restrict__ v,
           __nv_bfloat16* __restrict__ o, Shape s,
           const float* __restrict__ kscale,
           const float* __restrict__ vscale) {
  fwd_tile<D, Mask::Paged, 64, int8_t>(q, k, v, o, nullptr, s, kscale,
                                       vscale);
}

// start copying rows [t0, t0 + R) of the f32 row terms of head bh
// ([B*H, T]) into shared memory, one a thread from thread `first`, zeros
// at and past T
template <int R>
__device__ __forceinline__ void load_terms_async(float* sm,
                                                 const float* base, int bh,
                                                 int t0, int T_, int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < R) {
    const int t = t0 + i;
    const bool in = t < T_;
    cp_async4(sm + i, in ? base + (size_t)bh * T_ + t : base, in);
  }
}

// false when no query of [q0, q0 + bq) sees any key of [k0, k0 + bk): the
// range of q - k is then wholly outside what the mask keeps
template <Mask M>
__device__ __forceinline__ bool any_visible(int q0, int bq, int k0, int bk,
                                            const Shape& s) {
  if (q0 >= s.Tq || k0 >= s.Tk) return false;
  const int q1 = min(q0 + bq, s.Tq) - 1, k1 = min(k0 + bk, s.Tk) - 1;
  if constexpr (M == Mask::Striped) {
    return q1 * s.n + s.q_off >= k0 * s.n + s.k_off;
  } else {
    bool ok = true;
    if (s.causal) ok = ok && q1 >= k0;
    if (s.window) ok = ok && q0 - k1 < s.window;
    return ok;
  }
}

// dcap[row] = sum_d dO[row, d] * O[row, d] (minus g_lse[row] for a striped
// hop) for the BQ rows of a query tile, dO from its staged [BQ][D + 8]
// tile and O from device memory by 16-byte loads, D / 8 neighbouring
// threads a row; into shared memory and, for real rows, to dcap
template <int D, Mask M>
__device__ __forceinline__ void tile_dcap_bf16(
    float* dcs, float* __restrict__ dcap, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* dos, int b, int q0, int bh, const Shape& s, int h) {
  constexpr int CH = D / 8, LD = D + 8;
  static_assert((BQ * CH) % THREADS == 0 && 32 % CH == 0,
                "whole warps a row");
#pragma unroll
  for (int it = 0; it < BQ * CH / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CH, c = (i % CH) * 8, tq = q0 + r;
    float acc = 0.f;
    if (tq < s.Tq) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          row_ptr(o, b, tq, h, lay_q(s, D), D) + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + r * LD + c);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(op[e]);
        const float2 d = __bfloat1622float2(dp[e]);
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
      }
    }
#pragma unroll
    for (int off = 1; off < CH; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if constexpr (M == Mask::Striped) {
      if (tq < s.Tq) acc -= s.glse[(size_t)bh * s.Tq + tq];
    }
    if (c == 0) {
      dcs[r] = acc;
      if (tq < s.Tq) dcap[(size_t)bh * s.Tq + tq] = acc;
    }
  }
}

// The bf16 dQ kernel: dQ of a 64-row query tile, 4 warps of 16 rows; the
// header's note gives the design.
template <int D, Mask M>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
dq_mma(const __nv_bfloat16* __restrict__ q,
       const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v,
       const __nv_bfloat16* __restrict__ o,
       const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ dcap,
       __nv_bfloat16* __restrict__ dq, Shape s) {
  constexpr int LD = D + 8;
  constexpr int STAGE = BK * LD;  // elements of one K or V stage
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + BQ * LD;
  __nv_bfloat16* ks = dos + BQ * LD;  // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * STAGE;  // [2][BK][LD]
  float* dcs = reinterpret_cast<float*>(vs + 2 * STAGE);
  // under a causal mask the last query tiles see the most keys: the grid
  // runs the (b, h) pairs fastest and the tiles from the last
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const int q0 = qi * BQ;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  int lo, hi;
  key_range<M>(qi, BQ, BK, s, lo, hi);

  // commit groups, in order: Q and dO, K[lo] and V[lo], then K[j+1] and
  // V[j+1] in each step j (empty past the last tile)
  load_tile_async<D, BQ, THREADS>(qs, q, b, q0, s.Tq, h, lq);
  load_tile_async<D, BQ, THREADS>(dos, dout, b, q0, s.Tq, h, lay_q(s, D));
  cp_async_commit();
  if (lo < hi) {
    load_tile_async<D, BK, THREADS>(ks, k, b, lo * BK, s.Tk, h, lk);
    load_tile_async<D, BK, THREADS>(vs, v, b, lo * BK, s.Tk, h, lv);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  tile_dcap_bf16<D, M>(dcs, dcap, o, dos, b, q0, bh, s, h);
  __syncthreads();
  const int qp[2] = {q0 + wr + g, q0 + wr + g + 8};
  // P = exp2(S * c - lse * log2(e)): one FMA per score; dS is taken
  // without the scale, which multiplies dQ once at the end
  const float c = s.scale * LOG2E;
  float nl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    nl[r] = qp[r] < s.Tq ? -lse[(size_t)bh * s.Tq + qp[r]] * LOG2E : 0.f;
    rd[r] = dcs[wr + g + 8 * r];
  }

  float acc[D / 8][4] = {};
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    const __nv_bfloat16* kt = ks + stage * STAGE;
    const __nv_bfloat16* vt = vs + stage * STAGE;
    cp_async_wait<0>();  // K[j] and V[j]
    // the tile is visible to every warp, and every warp is done with step
    // j-1, whose stage the next tile takes
    __syncthreads();
    if (j + 1 < hi) {
      load_tile_async<D, BK, THREADS>(ks + (stage ^ 1) * STAGE, k, b,
                                      (j + 1) * BK, s.Tk, h, lk);
      load_tile_async<D, BK, THREADS>(vs + (stage ^ 1) * STAGE, v, b,
                                      (j + 1) * BK, s.Tk, h, lv);
    }
    cp_async_commit();
    // a warp whose 16 rows see no key of the tile adds exact zeros: skip
    if (!any_visible<M>(q0 + wr, 16, j * BK, BK, s)) continue;
    float sv[8][4], dp[8][4];
    rows_dot_tile_smem<D>(sv, qs, wr, kt, lane);
    rows_dot_tile_smem<D>(dp, dos, wr, vt, lane);
    if (full_tile<M>(q0 + wr, 16, j * BK, BK, s, 0, s.Tk)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = fast_exp2(fmaf(sv[n][e], c, nl[r]));
          sv[n][e] = p * (dp[n][e] - rd[r]);  // dS / scale
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kp = j * BK + n * 8 + 2 * t + (e & 1);
          const float p = visible<M>(qp[r], kp, s)
                              ? fast_exp2(fmaf(sv[n][e], c, nl[r]))
                              : 0.f;
          sv[n][e] = p * (dp[n][e] - rd[r]);
        }
    }
    probs_times_tile<D>(acc, sv, kt, lane);
  }
  const float mul[2] = {s.scale, s.scale};
  store_rows<D>(dq, acc, b, q0 + wr, s.Tq, h, lay_q(s, D), g, t, mul);
}

// The bf16 dK/dV kernel: dK and dV of a 64-row key tile, 4 warps of 16
// keys; each staged 64-row Q/dO tile comes with its rows' lse and dcap.
template <int D, Mask M>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
dkv_mma(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dcap,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        Shape s) {
  constexpr int LD = D + 8;
  // one stage: Q and dO [BQ][LD], then lse and dcap [BQ] f32
  constexpr int STAGE = 2 * BQ * LD * 2 + 2 * BQ * 4;  // bytes
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + BK * LD);
  // under a causal mask the first key tiles are seen by the most queries:
  // the grid runs the (b, h) pairs fastest and the tiles from the first
  const int kj = blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = 16 * warp;
  const int k0 = kj * BK;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  int lo, hi;
  query_range<M>(kj, BQ, BK, s, lo, hi);

  // stage i's Q, dO, lse and dcap, by every thread (the row terms by the
  // first 2 * BQ threads)
  auto load_stage = [&](int i, unsigned char* st) {
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(st);
    float* ls = reinterpret_cast<float*>(qt + 2 * BQ * LD);
    load_tile_async<D, BQ, THREADS>(qt, q, b, i * BQ, s.Tq, h, lq);
    load_tile_async<D, BQ, THREADS>(qt + BQ * LD, dout, b, i * BQ, s.Tq,
                                    h, lay_q(s, D));
    load_terms_async<BQ>(ls, lse, bh, i * BQ, s.Tq, 0);
    load_terms_async<BQ>(ls + BQ, dcap, bh, i * BQ, s.Tq, BQ);
  };
  // commit groups, in order: K and V, stage lo, then stage i+1 in each
  // step i (empty past the last tile)
  load_tile_async<D, BK, THREADS>(ks, k, b, k0, s.Tk, h, lk);
  load_tile_async<D, BK, THREADS>(vs, v, b, k0, s.Tk, h, lv);
  cp_async_commit();
  if (lo < hi) load_stage(lo, ring);
  cp_async_commit();
  const int kp[2] = {k0 + wr + g, k0 + wr + g + 8};
  const float c = s.scale * LOG2E;

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int i = lo; i < hi; ++i) {
    unsigned char* st = ring + ((i - lo) & 1) * STAGE;
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* dot = qt + BQ * LD;
    const float* ls = reinterpret_cast<const float*>(dot + BQ * LD);
    const float* dcs = ls + BQ;
    cp_async_wait<0>();  // stage i (and, at i = lo, K and V)
    // stage i is visible to every warp, and every warp is done with step
    // i-1, whose stage the next one takes
    __syncthreads();
    if (i + 1 < hi) load_stage(i + 1, ring + ((i + 1 - lo) & 1) * STAGE);
    cp_async_commit();
    // a warp whose 16 keys no query of the tile sees adds exact zeros
    if (!any_visible<M>(i * BQ, BQ, k0 + wr, 16, s)) continue;
    // transposed scores: rows are this warp's 16 keys, columns the tile's
    // 64 queries
    float sv[8][4], dp[8][4];
    rows_dot_tile_smem<D>(sv, ks, wr, qt, lane);
    rows_dot_tile_smem<D>(dp, vs, wr, dot, lane);
    const bool full = full_tile<M>(i * BQ, BQ, k0 + wr, 16, s, 0, s.Tk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int cq = n * 8 + 2 * t;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(ls + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dcs + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float nl = -(e & 1 ? l2.y : l2.x) * LOG2E;
        float p = fast_exp2(fmaf(sv[n][e], c, nl));
        if (!full && !visible<M>(i * BQ + cq + (e & 1), kp[e >> 1], s))
          p = 0.f;
        sv[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (e & 1 ? d2.y : d2.x));  // dS^T / scale
      }
    }
    probs_times_tile<D>(dva, sv, dot, lane);
    probs_times_tile<D>(dka, dp, qt, lane);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {s.scale, s.scale};
  store_rows<D>(dk, dka, b, k0 + wr, s.Tk, h, lay_k(s, D), g, t, mul);
  store_rows<D>(dv, dva, b, k0 + wr, s.Tk, h, lay_k(s, D), g, t, one);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. The forward (fwd_f32) and the backward's two kernels
// (dq_f32, dkv_f32) share one tile scheme. A block of F32Tile<D>::NT
// threads (128; 256 at D = 128) owns a 64-row tile (FQ) of its output and
// walks the visible 64-row tiles of the other side through a cp.async ring
// in dynamic shared memory, rows D + 4 floats apart, rows past the last
// readable one zero-filled and never read. With tx = tid % 8 and ty =
// tid / 8 a thread holds the owned rows ty + RS i (i < RT; RT = 4 and RS =
// 16, or at D = 128 RT = 2 and RS = 32, so that the accumulators fit in
// registers): f32_scores gives it the products of those rows with the
// streamed rows tx + 8 j (j < 8), reading both tiles as float4 along D
// (the 8 rows a quarter warp reads fall in 8 distinct bank groups), and
// f32_accumulate adds a score tile in shared memory times a streamed tile
// into its output columns F32Tile<D>::col, reading the scores' rows as
// float4 and the tile's rows as the thread's columns, 128 contiguous bytes
// a quarter warp. A row's values meet over its 8 threads (tx is the lane's
// low 3 bits, so they share a warp) by shuffles. At D = 64 a block takes
// about 105 KB of shared memory: two blocks an SM.
constexpr int FQ = 64;

template <int D>
struct F32Tile {
  static constexpr int LD = D + 4;   // row stride of the Q, K, V, dO tiles
  static constexpr int LP = FQ + 8;  // row stride of the score tile
  // owned rows a thread holds, RS apart; threads a block
  static constexpr int RT = D >= 128 ? 2 : 4, RS = FQ / RT;
  static constexpr int NT = 8 * RS;
  // a thread's output columns: DC chunks of VW, chunk dc of thread tx at
  // tx * VW + 8 * VW * dc
  static constexpr int VW = D >= 32 ? 4 : D / 8;
  static constexpr int DC = D / 8 / VW;
  static constexpr int TILE = FQ * LD;  // floats of one row tile
  // five row tiles and the score tile (the forward: Q and two stages of K
  // and V; dQ: Q, dO, two stages of K, V; dK/dV: K, V, two stages of Q,
  // dO), dK/dV's row terms (two stages of lse and dcap) besides
  static constexpr int SMEM = (5 * TILE + FQ * LP + 4 * FQ) * 4;  // bytes
  __device__ static int col(int tx, int dc) { return tx * VW + 8 * VW * dc; }
};

// VW consecutive floats of shared memory into a register array
template <int VW>
__device__ __forceinline__ void load_vw(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

// issue rows [t0, t0 + FQ) of head (b, h) into an [FQ][D + 4] f32 tile,
// zeros at and past row tend (not read); vec: 16-byte copies (every row on
// a 16-byte boundary), else 4-byte ones
template <int D>
__device__ __forceinline__ void load_rows_f32(float* sm,
                                              const float* __restrict__ base,
                                              int b, int t0, int tend, int h,
                                              Lay l, bool vec) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  constexpr int LD = F32Tile<D>::LD, NT = F32Tile<D>::NT;
#pragma unroll
  for (int it = 0; it < FQ * CH / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / CH, c = (i % CH) * 4, t = t0 + r;
    const bool in = t < tend;
    const float* src = in ? row_ptr(base, b, t, h, l, D) + c : base;
    if (vec) {
      cp_async16(sm + r * LD + c, src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(sm + r * LD + c + e, src + e, in);
    }
  }
}

__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// sv[i][j] = sum_d A[ty + RS i][d] * B[tx + 8 j][d] over two [FQ][D + 4]
// tiles: the owned rows' products with the streamed rows
template <int D>
__device__ __forceinline__ void f32_scores(float (&sv)[F32Tile<D>::RT][8],
                                           const float* A, const float* B,
                                           int tx, int ty) {
  using F = F32Tile<D>;
  constexpr int LD = F::LD, RT = F::RT, RS = F::RS;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sv[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 av[RT], bv[8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + RS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = sv[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        sv[i][j] = fmaf(av[i].w, bv[j].w, x);
      }
  }
}

// acc[i][.] += sum_c S[ty + RS i][c] * T[c][col(tx, .)] for the [FQ][LP]
// score tile S and an [FQ][D + 4] row tile T
template <int D>
__device__ __forceinline__ void f32_accumulate(
    float (&acc)[F32Tile<D>::RT][F32Tile<D>::DC * F32Tile<D>::VW],
    const float* S, const float* T, int tx, int ty) {
  using F = F32Tile<D>;
  constexpr int LD = F::LD, LP = F::LP, VW = F::VW, DC = F::DC;
  constexpr int RT = F::RT, RS = F::RS;
#pragma unroll 4
  for (int c0 = 0; c0 < FQ; c0 += 4) {
    float4 pv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      pv[i] = *reinterpret_cast<const float4*>(S + (ty + RS * i) * LP + c0);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float vv[DC * VW];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
        load_vw<VW>(vv + dc * VW, T + (c0 + cc) * LD + F::col(tx, dc));
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float p = cc == 0   ? pv[i].x
                        : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z
                                  : pv[i].w;
#pragma unroll
        for (int e = 0; e < DC * VW; ++e)
          acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }
}

// store the thread's rows of an owned tile at t0 (rows past T_ dropped),
// times mul, into a contiguous [B, T, H, D] tensor
template <int D>
__device__ __forceinline__ void f32_store(
    float* base,
    const float (&acc)[F32Tile<D>::RT][F32Tile<D>::DC * F32Tile<D>::VW],
    int b, int t0, int T_, int h, Lay l, int tx, int ty, float mul) {
  using F = F32Tile<D>;
#pragma unroll
  for (int i = 0; i < F::RT; ++i) {
    const int row = t0 + ty + F::RS * i;
    if (row >= T_) continue;
    float* dst = row_ptr(base, b, row, h, l, D);
#pragma unroll
    for (int dc = 0; dc < F::DC; ++dc)
#pragma unroll
      for (int e = 0; e < F::VW; ++e)
        dst[F::col(tx, dc) + e] = acc[i][dc * F::VW + e] * mul;
  }
}

// The f32 forward: o and lse of a 64-row query tile, the visible 64-key
// tiles through a two-stage ring (K and V separate commit groups, as the
// bf16 forward's): S = Q.K^T (f32_scores), the mask on boundary tiles, one
// row max, one row sum and one correction of the accumulators a tile, P
// into shared memory, O += P.V (f32_accumulate).
template <int D, Mask M>
__global__ void __launch_bounds__(F32Tile<D>::NT, D >= 128 ? 1 : 2)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, Shape s, int vec) {
  using F = F32Tile<D>;
  constexpr int LP = F::LP, VW = F::VW, DC = F::DC;
  constexpr int RT = F::RT, RS = F::RS;
  constexpr int STAGE = F::TILE;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [FQ][LD]
  float* ks = qs + STAGE;                      // [2][FQ][LD]
  float* vs = ks + 2 * STAGE;                  // [2][FQ][LD]
  float* ps = vs + 2 * STAGE;                  // [FQ][LP]
  // the heaviest tiles of all heads first, as in fwd_mma
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int q0 = qi * FQ;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  int lo, hi;
  key_range<M>(qi, FQ, FQ, s, lo, hi);

  // commit groups, in order: Q, K[lo], V[lo], then K[j+1], V[j+1] in each
  // step j (empty past the last tile)
  load_rows_f32<D>(qs, q, b, q0, s.Tq, h, lq, vec);
  cp_async_commit();
  if (lo < hi) load_rows_f32<D>(ks, k, b, lo * FQ, s.Tk, h, lk, vec);
  cp_async_commit();
  if (lo < hi) load_rows_f32<D>(vs, v, b, lo * FQ, s.Tk, h, lv, vec);
  cp_async_commit();
  // scores are taken raw (their sign flipped for a negative scale, which
  // is exact) and scaled inside the exponent's FMA by c > 0; a zero scale
  // is taken as the smallest positive, so masked (-inf) scores stay -inf
  const bool flip = s.scale < 0.f;
  const float sc = fabsf(s.scale);
  const float c = fmaxf(sc * LOG2E, 1e-30f);

  float acc[RT][DC * VW];
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC * VW; ++e) acc[i][e] = 0.f;
  }
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    const float* kt = ks + stage * STAGE;
    const float* vt = vs + stage * STAGE;
    cp_async_wait<1>();  // Q and K[j]; V[j] may still be in flight
    // K[j] is visible to every thread, and every thread is done with step
    // j-1, whose stage (and P) the next writes take
    __syncthreads();
    if (j + 1 < hi)
      load_rows_f32<D>(ks + (stage ^ 1) * STAGE, k, b, (j + 1) * FQ, s.Tk,
                       h, lk, vec);
    cp_async_commit();
    if (j + 1 < hi)
      load_rows_f32<D>(vs + (stage ^ 1) * STAGE, v, b, (j + 1) * FQ, s.Tk,
                       h, lv, vec);
    cp_async_commit();

    float sv[RT][8];
    f32_scores<D>(sv, qs, kt, tx, ty);
    const bool full = full_tile<M>(q0, FQ, j * FQ, FQ, s, 0, s.Tk);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (flip) sv[i][jj] = -sv[i][jj];
        if (!full && !visible<M>(q0 + ty + RS * i, j * FQ + tx + 8 * jj, s))
          sv[i][jj] = -INFINITY;
      }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, sv[i][jj]);
      mx = row8_max(mx);
      // the reference point, in log2 units; 0 while the row has seen no
      // key, so that exp2(-inf - 0) = 0
      const float mr = mx == -INFINITY ? 0.f : mx * c;
      const float corr =
          m[i] == -INFINITY ? 0.f : fast_exp2((m[i] - mx) * c);
      m[i] = mx;
      l[i] *= corr;
      float* prow = ps + (ty + RS * i) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = fast_exp2(fmaf(sv[i][jj], c, -mr));
        l[i] += p;  // this thread's share; summed over the row's 8 below
        prow[8 * jj] = p;
      }
#pragma unroll
      for (int e = 0; e < DC * VW; ++e) acc[i][e] *= corr;
    }
    cp_async_wait<2>();  // V[j]; K[j+1] and V[j+1] may still be in flight
    __syncthreads();     // ... and P, for every thread
    f32_accumulate<D>(acc, ps, vt, tx, ty);
  }
  float inv[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float li = row8_sum(l[i]);
    const int row = q0 + ty + RS * i;
    if (tx == 0 && row < s.Tq)
      lse[(size_t)bh * s.Tq + row] = li > 0.f ? m[i] * sc + logf(li) : NEG_BIG;
    inv[i] = 1.f / fmaxf(li, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < DC * VW; ++e) acc[i][e] *= inv[i];
  f32_store<D>(o, acc, b, q0, s.Tq, h, lay_q(s, D), tx, ty, 1.f);
}

// dcap[row] = sum_d dO[row, d] * O[row, d] (minus g_lse[row] for a striped
// hop) for the FQ rows of a query tile, dO from its staged [FQ][D + 4]
// tile and O from device memory, NT / FQ neighbouring threads a row; into
// shared memory and, for real rows, to dcap
template <int D, Mask M>
__device__ __forceinline__ void tile_dcap_f32(float* dcs,
                                              float* __restrict__ dcap,
                                              const float* __restrict__ o,
                                              const float* dos, int b,
                                              int q0, int bh, const Shape& s,
                                              int h) {
  constexpr int TPR = F32Tile<D>::NT / FQ, LD = F32Tile<D>::LD;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, tq = q0 + r;
  float acc = 0.f;
  if (tq < s.Tq) {
    const float* po = row_ptr(o, b, tq, h, lay_q(s, D), D);
#pragma unroll 4
    for (int d = part; d < D; d += TPR) acc = fmaf(po[d], dos[r * LD + d], acc);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if constexpr (M == Mask::Striped) {
    if (tq < s.Tq) acc -= s.glse[(size_t)bh * s.Tq + tq];
  }
  if (part == 0) {
    dcs[r] = acc;
    if (tq < s.Tq) dcap[(size_t)bh * s.Tq + tq] = acc;
  }
}

// The f32 dQ kernel: dQ of a 64-row query tile, with Q and dO resident and
// the visible 64-key tiles streamed, K through a two-stage ring and V
// through one stage, refilled once the step's dP has read it (so that five
// row tiles and the score tile hold two blocks an SM at D = 64). Per tile:
// S = Q.K^T, P = exp2(S c - lse log2(e)) (one FMA and ex2 a score; the
// mask only where full_tile is false) into shared memory, dP = dO.V^T,
// dS / scale = P (dP - dcap) over P's place, then dQ += dS.K. The scale
// multiplies dQ once at the store. The kernel also writes dcap, which the
// dK/dV kernel, launched after it on the same stream, reads.
template <int D, Mask M>
__global__ void __launch_bounds__(F32Tile<D>::NT, D >= 128 ? 1 : 2)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ dcap, float* __restrict__ dq, Shape s, int vec) {
  using F = F32Tile<D>;
  constexpr int LP = F::LP, VW = F::VW, DC = F::DC;
  constexpr int RT = F::RT, RS = F::RS;
  constexpr int STAGE = F::TILE;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [FQ][LD]
  float* dos = qs + STAGE;                     // [FQ][LD]
  float* ks = dos + STAGE;                     // [2][FQ][LD]
  float* vs = ks + 2 * STAGE;                  // [FQ][LD]
  float* ps = vs + STAGE;                      // [FQ][LP]
  float* dcs = ps + FQ * LP;                   // [FQ]
  // under a causal mask the last query tiles see the most keys: the grid
  // runs the (b, h) pairs fastest and the tiles from the last
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int q0 = qi * FQ;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  int lo, hi;
  key_range<M>(qi, FQ, FQ, s, lo, hi);

  // commit groups, in order: Q and dO, K[lo], V[lo], then in each step j
  // K[j+1] at its start and V[j+1] once dP(j) is done (empty past the
  // last tile): at each wait the group it needs is the second newest
  load_rows_f32<D>(qs, q, b, q0, s.Tq, h, lq, vec);
  load_rows_f32<D>(dos, dout, b, q0, s.Tq, h, lay_q(s, D), vec);
  cp_async_commit();
  if (lo < hi) load_rows_f32<D>(ks, k, b, lo * FQ, s.Tk, h, lk, vec);
  cp_async_commit();
  if (lo < hi) load_rows_f32<D>(vs, v, b, lo * FQ, s.Tk, h, lv, vec);
  cp_async_commit();
  cp_async_wait<2>();  // Q and dO
  __syncthreads();
  tile_dcap_f32<D, M>(dcs, dcap, o, dos, b, q0, bh, s, h);
  __syncthreads();
  // P = exp2(S * c - lse * log2(e)); dS is taken without the scale
  const float c = s.scale * LOG2E;
  float nl[RT], rd[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty + RS * i;
    nl[i] = row < s.Tq ? -lse[(size_t)bh * s.Tq + row] * LOG2E : 0.f;
    rd[i] = dcs[ty + RS * i];
  }

  float acc[RT][DC * VW];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < DC * VW; ++e) acc[i][e] = 0.f;
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    const float* kt = ks + stage * STAGE;
    cp_async_wait<1>();  // K[j]; V[j] may still be in flight
    // K[j] is visible to every thread, and every thread is done with step
    // j-1: its K stage, which K[j+1] takes, and the score tile
    __syncthreads();
    if (j + 1 < hi)
      load_rows_f32<D>(ks + (stage ^ 1) * STAGE, k, b, (j + 1) * FQ, s.Tk,
                       h, lk, vec);
    cp_async_commit();
    float sv[RT][8];
    f32_scores<D>(sv, qs, kt, tx, ty);
    const bool full = full_tile<M>(q0, FQ, j * FQ, FQ, s, 0, s.Tk);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* prow = ps + (ty + RS * i) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        prow[8 * jj] =
            full || visible<M>(q0 + ty + RS * i, j * FQ + tx + 8 * jj, s)
                ? fast_exp2(fmaf(sv[i][jj], c, nl[i]))
                : 0.f;
    }
    cp_async_wait<1>();  // V[j]; K[j+1] may still be in flight
    __syncthreads();     // V[j] is visible to every thread
    f32_scores<D>(sv, dos, vs, tx, ty);  // dP
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* prow = ps + (ty + RS * i) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        prow[8 * jj] *= sv[i][jj] - rd[i];  // dS / scale, over this thread's P
    }
    __syncthreads();  // dS is visible, and every thread is done with V[j]
    if (j + 1 < hi)
      load_rows_f32<D>(vs, v, b, (j + 1) * FQ, s.Tk, h, lv, vec);
    cp_async_commit();
    f32_accumulate<D>(acc, ps, kt, tx, ty);
  }
  f32_store<D>(dq, acc, b, q0, s.Tq, h, lay_q(s, D), tx, ty, s.scale);
}

// The f32 dK/dV kernel: dK and dV of a 64-row key tile, with K and V
// resident and the 64-row query tiles that see it streamed, Q (with its
// rows' lse and dcap) through a two-stage ring and dO through one stage,
// refilled once the step's dV product has read it (two blocks an SM at D =
// 64, as the dQ kernel). Per tile, transposed:
// S^T = K.Q^T, P^T (as the dQ kernel's P) into shared memory, dP^T =
// V.dO^T, dS^T / scale = P^T (dP^T - dcap) kept in registers, dV += P^T.dO;
// then dS^T over P^T's place and dK += dS^T.Q. The scale multiplies dK
// once at the store.
template <int D, Mask M>
__global__ void __launch_bounds__(F32Tile<D>::NT, D >= 128 ? 1 : 2)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ dcap,
        float* __restrict__ dk, float* __restrict__ dv, Shape s, int vec) {
  using F = F32Tile<D>;
  constexpr int LP = F::LP, VW = F::VW, DC = F::DC;
  constexpr int RT = F::RT, RS = F::RS;
  constexpr int STAGE = F::TILE;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [FQ][LD]
  float* vs = ks + STAGE;                      // [FQ][LD]
  float* qs = vs + STAGE;                      // [2][FQ][LD]
  float* dos = qs + 2 * STAGE;                 // [FQ][LD]
  float* ps = dos + STAGE;                     // [FQ][LP]
  float* ts = ps + FQ * LP;                    // [2][lse, dcap][FQ]
  // under a causal mask the first key tiles are seen by the most queries:
  // the grid runs the (b, h) pairs fastest and the tiles from the first
  const int kj = blockIdx.y;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int k0 = kj * FQ;
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  int lo, hi;
  query_range<M>(kj, FQ, FQ, s, lo, hi);

  // query tile i's Q and row terms into ring slot sl
  auto load_q = [&](int i, int sl) {
    load_rows_f32<D>(qs + sl * STAGE, q, b, i * FQ, s.Tq, h, lq, vec);
    load_terms_async<FQ>(ts + sl * 2 * FQ, lse, bh, i * FQ, s.Tq, 0);
    load_terms_async<FQ>(ts + sl * 2 * FQ + FQ, dcap, bh, i * FQ, s.Tq, FQ);
  };
  // commit groups, in order: K and V, Q[lo], dO[lo], then in each step i
  // Q[i+1] at its start and dO[i+1] once dV has read dO[i] (empty past the
  // last tile): at each wait the group it needs is the second newest
  load_rows_f32<D>(ks, k, b, k0, s.Tk, h, lk, vec);
  load_rows_f32<D>(vs, v, b, k0, s.Tk, h, lv, vec);
  cp_async_commit();
  if (lo < hi) load_q(lo, 0);
  cp_async_commit();
  if (lo < hi)
    load_rows_f32<D>(dos, dout, b, lo * FQ, s.Tq, h, lay_q(s, D), vec);
  cp_async_commit();
  const float c = s.scale * LOG2E;

  float dka[RT][DC * VW], dva[RT][DC * VW];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < DC * VW; ++e) dka[r][e] = dva[r][e] = 0.f;
  for (int i = lo; i < hi; ++i) {
    const int sl = (i - lo) & 1;
    const float* qt = qs + sl * STAGE;
    const float* ls = ts + sl * 2 * FQ;
    const float* dcs = ls + FQ;
    cp_async_wait<1>();  // Q[i] and its terms (and K, V); dO[i] may not be
    // Q[i] is visible to every thread, and every thread is done with step
    // i-1: its Q slot, which Q[i+1] takes, and the score tile
    __syncthreads();
    if (i + 1 < hi) load_q(i + 1, sl ^ 1);
    cp_async_commit();
    float sv[RT][8];
    f32_scores<D>(sv, ks, qt, tx, ty);  // S^T: rows keys, columns queries
    const bool full = full_tile<M>(i * FQ, FQ, k0, FQ, s, 0, s.Tk);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float* prow = ps + (ty + RS * r) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int cq = tx + 8 * jj;
        prow[8 * jj] =
            full || visible<M>(i * FQ + cq, k0 + ty + RS * r, s)
                ? fast_exp2(fmaf(sv[r][jj], c, -ls[cq] * LOG2E))
                : 0.f;
      }
    }
    cp_async_wait<1>();  // dO[i]; Q[i+1] may still be in flight
    __syncthreads();     // dO[i] and P^T are visible to every thread
    f32_scores<D>(sv, vs, dos, tx, ty);  // dP^T
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float* prow = ps + (ty + RS * r) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        sv[r][jj] = prow[8 * jj] * (sv[r][jj] - dcs[tx + 8 * jj]);
    }
    f32_accumulate<D>(dva, ps, dos, tx, ty);
    __syncthreads();  // every thread is done with P^T and dO[i]
    if (i + 1 < hi)
      load_rows_f32<D>(dos, dout, b, (i + 1) * FQ, s.Tq, h, lay_q(s, D),
                       vec);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float* prow = ps + (ty + RS * r) * LP + tx;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) prow[8 * jj] = sv[r][jj];  // dS^T / scale
    }
    __syncthreads();  // dS^T is visible to every thread
    f32_accumulate<D>(dka, ps, qt, tx, ty);
  }
  f32_store<D>(dk, dka, b, k0, s.Tk, h, lay_k(s, D), tx, ty, s.scale);
  f32_store<D>(dv, dva, b, k0, s.Tk, h, lay_k(s, D), tx, ty, 1.f);
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

// the f32 kernels' 16-byte copies need every row they stage (q, k, v
// and, in the backward, dO: contiguous, rows D apart) on a 16-byte
// boundary; anything else takes 4-byte copies
inline bool f32_vec(const Shape& s, const void* q, const void* k,
                    const void* v, const void* dout) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) |
           reinterpret_cast<uintptr_t>(dout)) % 16 == 0) &&
         ((s.qsb | s.qst | s.ksb | s.kst | s.vsb | s.vst) % 4 == 0);
}

template <int D, Mask M, int QT>
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             float* lse, const Shape& s, cudaStream_t st) {
  const int smem = (QT + 4 * BK) * (D + 8) * 2;  // Q + 2 stages of K and V
  cudaError_t e = set_smem(fwd_mma<D, M, QT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_mma<D, M, QT>
      <<<dim3(s.B * s.H, (s.Tq + QT - 1) / QT), QT * 2, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

// the paged chunk over an int8 cache with its row scales
template <int D>
int fwd_i8(const void* q, const void* k, const void* v, void* o,
           const float* kscale, const float* vscale, const Shape& s,
           cudaStream_t st) {
  // Q, one bf16 K and V tile, then 2 stages of int8 K and V and of their
  // row scales
  const int smem = (64 + 2 * BK) * (D + 8) * 2 + 4 * BK * D + 16 * BK;
  cudaError_t e = set_smem(fwd_mma_i8<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_mma_i8<D><<<dim3(s.B * s.H, (s.Tq + 63) / 64), 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<__nv_bfloat16*>(o), s,
      kscale, vscale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, Mask M>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, int dtype, cudaStream_t st) {
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      // 128-row query tiles where they give every SM two blocks (the LM's
      // 768 tiles), else 64: with fewer, 64-row tiles spread the work over
      // more SMs; a paged chunk (C <= 256 rows over few slots) always 64
      if constexpr (M != Mask::Paged) {
        const long long tiles =
            (long long)s.B * s.H * ((s.Tq + 127) / 128);
        if (tiles >= 2 * sm_count())
          return fwd_bf16<D, M, 128>(q, k, v, o, lse, s, st);
      }
      return fwd_bf16<D, M, 64>(q, k, v, o, lse, s, st);
    }
  }
  if constexpr (M == Mask::Paged) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int smem = F32Tile<D>::SMEM;
    const cudaError_t e = set_smem(fwd_f32<D, M>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fwd_f32<D, M><<<dim3(s.B * s.H, (s.Tq + FQ - 1) / FQ), F32Tile<D>::NT,
                    smem, st>>>(static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<float*>(o), lse, s,
                          f32_vec(s, q, k, v, nullptr));
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D, Mask M>
int dq_bf16(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* dcap, void* dqp,
            const Shape& s, cudaStream_t st) {
  // Q and dO, 2 stages of K and V, dcap of the tile's rows
  const int smem = (2 * BQ + 4 * BK) * (D + 8) * 2 + BQ * 4;
  cudaError_t e = set_smem(dq_mma<D, M>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_mma<D, M><<<dim3(s.B * s.H, (s.Tq + BQ - 1) / BQ), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, dcap,
      static_cast<__nv_bfloat16*>(dqp), s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, Mask M>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const float* lse, float* dcap, void* dqp,
       const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16)
      return dq_bf16<D, M>(q, k, v, o, dout, lse, dcap, dqp, s, st);
  }
  constexpr int smem = F32Tile<D>::SMEM;
  const cudaError_t e = set_smem(dq_f32<D, M>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_f32<D, M><<<dim3(bh, (s.Tq + FQ - 1) / FQ), F32Tile<D>::NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, dcap, static_cast<float*>(dqp),
      s, f32_vec(s, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <int D, Mask M>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* dcap, void* dk, void* dv,
             const Shape& s, cudaStream_t st) {
  // K and V, then 2 stages of Q, dO, lse and dcap
  const int smem = 2 * BK * (D + 8) * 2 + 2 * (4 * BQ * (D + 8) + 8 * BQ);
  cudaError_t e = set_smem(dkv_mma<D, M>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_mma<D, M><<<dim3(s.B * s.H, (s.Tk + BK - 1) / BK), THREADS, smem,
                  st>>>(static_cast<const __nv_bfloat16*>(q),
                        static_cast<const __nv_bfloat16*>(k),
                        static_cast<const __nv_bfloat16*>(v),
                        static_cast<const __nv_bfloat16*>(dout), lse, dcap,
                        static_cast<__nv_bfloat16*>(dk),
                        static_cast<__nv_bfloat16*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, Mask M>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dcap, void* dk, void* dv,
        const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16)
      return dkv_bf16<D, M>(q, k, v, dout, lse, dcap, dk, dv, s, st);
  }
  constexpr int smem = F32Tile<D>::SMEM;
  const cudaError_t e = set_smem(dkv_f32<D, M>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_f32<D, M><<<dim3(bh, (s.Tk + FQ - 1) / FQ), F32Tile<D>::NT, smem,
                  st>>>(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(dout), lse, dcap,
                        static_cast<float*>(dk), static_cast<float*>(dv), s,
                        f32_vec(s, q, k, v, dout));
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
