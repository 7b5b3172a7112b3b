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
//   only, bf16, no lse): chunk row c of slot b sees cached key k when
//   k <= pos[b] + c, the block reading pos[b] itself; query head h reads
//   kv head h / group (GQA).
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
// The backward (dq_mma, dkv_mma): one block of 4 warps owns a 64-row tile
// of the output (queries for dQ, keys for dK/dV) and walks the tiles of
// the other side, staging each 64-row tile in shared memory
// synchronously. Each warp runs 16 rows in mma.sync m16n8k16 steps (bf16
// in, f32 accumulate): the scores stay in registers and are reused as the
// A operand of the next product (P.V, dS.K, P^T.dO, dS^T.Q), and the
// transposed B operands come from the same row-major tiles through
// ldmatrix .trans. P and dS are rounded to bf16 for those products while
// the row sums and the softmax stay f32. Each output tile has one owner,
// so there are no atomics and a step's gradients are the same bits every
// run. The dQ kernel also writes dcap, which the dK/dV kernel, launched
// after it on the same stream, reads. f32 inputs take a CUDA-core form of
// the same three kernels (several threads per row, one key or query at a
// time), masked scores at -1e30 with probability exactly 0. wgmma and TMA
// (a warp-specialised forward) are later work.
#pragma once

#include <math.h>

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

// rows of the backward's query tiles and of every key tile
constexpr int BQ = 64, BK = 64;

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

// 16 bytes from global to shared memory without passing through
// registers (cp.async.cg: L2 only); with in = false nothing is read
// (src-size 0) and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(a), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// 2^x (ex2.approx.ftz: about 2^-22 relative error, subnormal results
// flushed to 0, 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// the bf16 forward: o (and, but for a paged chunk, lse) of a QT-row query
// tile, QT / 16 warps of 16 rows; the header's note gives the design.
// Up to D = 64 two 128-row blocks share an SM (at most 128 registers, a
// few bytes spilled): the launcher takes them only where the grid gives
// every SM two.
template <int D, Mask M, int QT>
__global__ void __launch_bounds__(QT * 2, QT == 128 && D <= 64 ? 2 : 1)
fwd_mma(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
        float* __restrict__ lse, Shape s) {
  constexpr int NT = QT * 2;
  constexpr int LD = D + 8;
  constexpr int STAGE = BK * LD;  // elements of one K or V stage
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + QT * LD;     // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * STAGE;   // [2][BK][LD]
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

  // commit groups, in order: Q, K[lo], V[lo], then K[j+1], V[j+1] in each
  // step j (empty past the last tile, so the counts below hold throughout)
  load_tile_async<D, QT, NT>(qs, q, b, q0, s.Tq, h, lq);
  cp_async_commit();
  if (lo < hi) load_tile_async<D, BK, NT>(ks, k, b, lo * BK, kend, hk, lk);
  cp_async_commit();
  if (lo < hi) load_tile_async<D, BK, NT>(vs, v, b, lo * BK, kend, hk, lv);
  cp_async_commit();
  cp_async_wait<2>();  // Q
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
    const __nv_bfloat16* kt = ks + stage * STAGE;
    const __nv_bfloat16* vt = vs + stage * STAGE;
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

    float sv[8][4];
    rows_dot_tile_ldsm<D>(sv, qf, kt, lane);
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
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    cp_async_wait<2>();  // V[j]; K[j+1] and V[j+1] may still be in flight
    __syncthreads();
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

// dcap[row] = sum_d dO[row, d] * O[row, d] (minus g_lse[row] for a striped
// hop) for the rows of a query tile (two threads a row), into shared
// memory and, for real rows, to dcap
template <typename T, int D, Mask M>
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
    if constexpr (M == Mask::Striped) {
      if (tq < s.Tq) acc -= s.glse[(size_t)bh * s.Tq + tq];
    }
    if (half == 0) {
      dcs[r] = acc;
      if (tq < s.Tq) dcap[(size_t)bh * s.Tq + tq] = acc;
    }
  }
}

template <int D, Mask M>
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
  tile_dcap<__nv_bfloat16, D, M>(dcs, dcap, o, dout, b, qi * BQ, bh, BQ, s,
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
  key_range<M>(qi, BQ, BK, s, lo, hi);
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
        const float p = visible<M>(qp[r], kp, s)
                            ? expf(sc[n][e] * s.scale - rl[r])
                            : 0.f;
        sc[n][e] = p * (dp[n][e] - rd[r]) * s.scale;  // dS
      }
    probs_times_tile<D>(acc, sc, ks, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, b, qi * BQ + wr, s.Tq, h, lay_q(s, D), g, t, one);
}

template <int D, Mask M>
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
  query_range<M>(kj, BQ, BK, s, lo, hi);
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
        const float p = visible<M>(i * BQ + c, kp[e >> 1], s)
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

template <int D, Mask M>
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
  key_range<M>(qi, S::ROWS, FT, s, lo, hi);
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
      if (!visible<M>(qp, j * FT + c, s)) continue;
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

template <int D, Mask M>
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
  tile_dcap<float, D, M>(dcs, dcap, o, dout, b, qi * S::ROWS, bh, S::ROWS,
                          s, h);
  const Lay lq{s.qsb, s.qst}, lk{s.ksb, s.kst}, lv{s.vsb, s.vst};
  float qr[S::DP], dr[S::DP], acc[S::DP];
  load_part<D>(qr, q, b, qp, s.Tq, h, lq, part);
  load_part<D>(dr, dout, b, qp, s.Tq, h, lay_q(s, D), part);
#pragma unroll
  for (int i = 0; i < S::DP; ++i) acc[i] = 0.f;
  const float rl = qp < s.Tq ? lse[(size_t)bh * s.Tq + qp] : 0.f;
  int lo, hi;
  key_range<M>(qi, S::ROWS, FT, s, lo, hi);
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
      if (!visible<M>(qp, j * FT + c, s)) continue;
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

template <int D, Mask M>
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
  query_range<M>(kj, FT, S::ROWS, s, lo, hi);
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
      if (!visible<M>(i0 * FT + c, kp, s)) continue;
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

// the card's SM count (cached)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
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
    const int rows = Split<D>::ROWS;
    fwd_f32<D, M><<<dim3((s.Tq + rows - 1) / rows, s.B * s.H), THREADS, 0,
                    st>>>(static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<float*>(o), lse, s);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D, Mask M>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const float* lse, float* dcap, void* dqp,
       const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      const int smem = 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
      cudaError_t e = set_smem(dq_mma<D, M>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dq_mma<D, M><<<dim3((s.Tq + BQ - 1) / BQ, bh), THREADS, smem, st>>>(
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
  dq_f32<D, M><<<dim3((s.Tq + rows - 1) / rows, bh), THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, dcap, static_cast<float*>(dqp),
      s);
  return static_cast<int>(cudaGetLastError());
}

template <int D, Mask M>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* dcap, void* dk, void* dv,
        const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if constexpr (D % 16 == 0) {
    if (dtype == kBF16) {
      const int smem = 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
      cudaError_t e = set_smem(dkv_mma<D, M>, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dkv_mma<D, M><<<dim3((s.Tk + BK - 1) / BK, bh), THREADS, smem, st>>>(
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
  dkv_f32<D, M><<<dim3((s.Tk + rows - 1) / rows, bh), THREADS, 0, st>>>(
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
