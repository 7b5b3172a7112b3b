// paged_attention: slot-paged attention over each slot's live KV rows.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py paged_attention (l.1115; kernel
// _paged_attn_kernel l.1037).
//
// q [S, C, H, D] (each slot's C-token chunk, starting at pos[s]) against a
// cache k, v [S, L, KV, D] (f32/bf16, or int8 with f32 row scales
// [S, L, KV]). Query row c of head h sees keys [0, pos + c] of kv head
// h / (H / KV). Online softmax in f32; a row's output is acc / max(l,
// 1e-30). Three C entries; the wrapper (kernels.paged_entry) picks one by
// dtype and shape, and none gives way to another:
//
// * mx_paged_attention_decode: every chunk with C < 16 (the C = 1 decode
//   read of every serving configuration but the fused decode chain,
//   speculative verify chunks), any q and cache dtype, head_dim <= 128.
//   Bound on the H100: the bytes of the live rows, read once per kv head
//   (a decode read does 2-4 flops a byte; the int8 scales count in the
//   bytes). Flash-decoding: the grid is (split x row tile, kv head, slot),
//   each split a fixed range of key positions whose count comes from L,
//   head_dim and the SM count alone (kernels._paged_decode_splits), never
//   from pos, so the wrapper reads nothing of the device. A split past its
//   slot's last live key writes an empty partial (m = -inf, l = 0) and
//   exits. A block takes up to RT = 2 sizeof(cache element) query rows,
//   all G*C rows of its kv head in the common cases (C = 1 with G <= 4 in
//   bf16, a C = 4 verify chunk), so every query head of a GQA group shares
//   one read of each K/V row; a decode read without GQA (G*C = 1) takes a
//   one-row form that holds a quarter of the registers, so more blocks
//   share an SM. Its live rows come through a two-stage ring
//   of 16-byte cp.async copies (8 KB of K and 8 KB of V a stage, the next
//   tile in flight while this one is scored; rows past the slot's last
//   live key are zero-filled, never read, so a NaN there cannot reach the
//   output). Each key row is cut into 16-byte chunks (8 bf16, 4 f32 or 16
//   int8; head_dim padded with zeros to a power of two of chunks), one
//   lane a chunk: a group of lanes scores a key by partial dot products and
//   a shuffle reduction, and a warp scores 32 / lanes-per-key keys at once.
//   int8 is dequantized by its row scale in registers, once per score and
//   once per probability. Each lane group keeps its own running (m, l,
//   acc) per row, updated once per four keys; groups merge by shuffles,
//   warps through shared memory, and the split's (m, l, acc[D]) goes to
//   the f32 workspace [S, KV, splits, G*C, D + 2] the wrapper allocates. A
//   second kernel of the same entry merges the splits: o = sum e^(m_i - M)
//   acc_i / max(sum e^(m_i - M) l_i, 1e-30). Scores are kept in base 2
//   (scale * log2(e) folded into q), and a row whose running max is still
//   -inf takes 0 as its reference, so masked probabilities are exactly 0.
//   A cache whose rows are not whole 16-byte chunks on 16-byte boundaries
//   (head_dim 100 in bf16, a view) takes guarded element loads into the
//   same ring. CUDA-core f32 math: at 2-4 flops a byte the tensor cores
//   would not help.
// * mx_paged_attention_chunk: a bf16 q over a bf16 or an int8 cache with
//   C >= 16 and a tensor-core head_dim (16, 32, 64, 128): the serving
//   path's prefill chunk, and the int8-KV serve's. Bound on the H100: a
//   C-row chunk at pos 0 does ~2 C flops per cached element (C = 256:
//   ~0.4 GFLOP on ~1.6 MB of bf16, ~0.8 MB of int8 and its scales), a few
//   microseconds of either rate. What held the scalar kernel (below) at
//   150-180x that bound on the H100 was its arithmetic: serial f32 dot
//   products from shared memory, probabilities broadcast by shuffles, and
//   every 16-row tile of the chunk restaging the same keys. This entry is
//   attention.cuh's pipelined tensor-core forward with the paged mask
//   (Mask::Paged, 64-row query tiles, one block per (slot, query head,
//   tile); the block reads pos[s] itself). A query tile walks the key
//   tiles up to its last row's pos + c; the cp.async loader zero-fills
//   every row past min(L, that key + 1), so rows past a slot's last live
//   key are never read and an unwritten row cannot put a NaN into P.V.
//   Tiles wholly below the chunk's diagonal skip the mask. No lse. The
//   int8 cache (fwd_mma_i8<D>) keeps its integers on the tensor cores:
//   each raw int8 tile and its row scales come through the ring (scales
//   past the live keys zero-filled too, since 0 times an unwritten NaN
//   scale is NaN), the tile is turned into the
//   bf16 tile the products read (exact: every int8 value is a bf16
//   integer), and the row scales apply outside the products: ks[key]
//   multiplies each score column, vs[key] each probability column after
//   the row sum l has taken it and before P is rounded to bf16. So the
//   scores are the JAX kernel's f32 q . (ks k) up to the order of
//   rounding, and the only bf16 rounding is the bf16 chunk's, of P.
// * mx_paged_attention: what is left, C >= 16 with an f32 q or cache, an
//   int8 cache under an f32 q, or a head_dim the tensor cores do not take
//   (none on a serving path: the f32 chunk stays here until a path runs
//   it). Bound: the bytes of the live rows, read once per kv head. The
//   TPU version cut dead-row DMA by revisiting a clamped block index in
//   its grid; here a block owns one (slot, kv head, tile of 16 query
//   rows) and loops over the key tiles up to the tile's own last live
//   key, p + (largest chunk offset among its rows), so dead rows are
//   never loaded. Each tile of 32 keys is staged once in shared memory
//   (int8 rows dequantized on the way) and serves all 16 rows, i.e. every
//   query head of the GQA group; each warp owns 2 rows and each lane
//   scores one key of the tile, then the probabilities are broadcast by
//   shuffles into per-lane accumulators over head_dim (<= 128). Scalar
//   CUDA-core math.
#include "attention.cuh"
#include "decode.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int BKEYS = 32;                    // keys per tile = lanes
constexpr int DMAX = 128;
constexpr int DT = DMAX / 32;                // accumulators per lane

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ pos, TQ* __restrict__ out,
                       int C, int H, int KV, int L, int D, float scale) {
  __shared__ float qs[ROWS][DMAX];
  __shared__ float kt[BKEYS][DMAX + 1];
  __shared__ float vt[BKEYS][DMAX];
  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int GC = G * C;
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int p = max(pos[s], 0);

  for (int i = tid; i < ROWS * D; i += WARPS * 32) {
    const int rr = i / D, d = i % D, r = r0 + rr;
    float val = 0.f;
    if (r < GC) {
      const int g = r / C, c = r % C;
      val = to_f32(q[(((size_t)s * C + c) * H + kvh * G + g) * D + d]);
    }
    qs[rr][d] = val;
  }

  // keys this tile of rows needs: [0, p + cmax], cmax = the largest chunk
  // offset among its rows (rows of one query head have rising offsets)
  const int rlast = min(r0 + ROWS, GC) - 1;
  const int cmax = (rlast / C == r0 / C) ? rlast % C : C - 1;
  const int nkeys = min(p + cmax + 1, L);

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DT];
  int qlim[ROWS_PER_WARP];  // last key each row sees; -1 past the rows
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = r0 + warp * ROWS_PER_WARP + i;
    qlim[i] = r < GC ? p + r % C : -1;
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[i][t] = 0.f;
  }

  for (int j0 = 0; j0 < nkeys; j0 += BKEYS) {
    __syncthreads();  // the last tile is consumed (and qs is staged)
    for (int i = tid; i < BKEYS * D; i += WARPS * 32) {
      const int jj = i / D, d = i % D, j = j0 + jj;
      float kk = 0.f, vv = 0.f;
      if (j < nkeys) {
        const size_t row = ((size_t)s * L + j) * KV + kvh;
        kk = to_f32(k[row * D + d]);
        vv = to_f32(v[row * D + d]);
        if (QUANT) {
          kk *= ks[row];
          vv *= vs[row];
        }
      }
      kt[jj][d] = kk;
      vt[jj][d] = vv;
    }
    __syncthreads();
    const int j = j0 + lane;  // the key this lane scores
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      if (qlim[i] < 0) continue;  // uniform across the warp
      const float* qr = qs[warp * ROWS_PER_WARP + i];
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc += qr[d] * kt[lane][d];
      const bool ok = j <= qlim[i];
      sc = ok ? sc * scale : -1e30f;
      const float mnew = fmaxf(m[i], warp_max(sc));
      const float pj = ok ? expf(sc - mnew) : 0.f;
      const float corr = expf(m[i] - mnew);
      l[i] = l[i] * corr + warp_sum(pj);
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[i][t] *= corr;
      for (int jj = 0; jj < BKEYS; ++jj) {
        const float w = __shfl_sync(0xffffffffu, pj, jj);
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[i][t] += w * vt[jj][d];
        }
      }
      m[i] = mnew;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = r0 + warp * ROWS_PER_WARP + i;
    if (r >= GC) continue;
    const int g = r / C, c = r % C;
    const float den = fmaxf(l[i], 1e-30f);
    TQ* o = out + (((size_t)s * C + c) * H + kvh * G + g) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) o[d] = from_f32<TQ>(acc[i][t] / den);
    }
  }
}

template <typename TQ, typename TKV, bool QUANT>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* pos, void* out, int S, int C, int H,
            int KV, int L, int D, float scale, cudaStream_t stream) {
  const int GC = (H / KV) * C;
  const dim3 grid((GC + ROWS - 1) / ROWS, KV, S);
  paged_attention_kernel<TQ, TKV, QUANT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, pos, static_cast<TQ*>(out), C, H,
      KV, L, D, scale);
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const float* ks, const float* vs, const int* pos, void* out,
                int S, int C, int H, int KV, int L, int D, float scale,
                cudaStream_t st) {
  if (kv_dtype == kF32) {
    launch<TQ, float, false>(q, k, v, ks, vs, pos, out, S, C, H, KV, L, D,
                             scale, st);
  } else if (kv_dtype == kBF16) {
    launch<TQ, __nv_bfloat16, false>(q, k, v, ks, vs, pos, out, S, C, H, KV,
                                     L, D, scale, st);
  } else if (kv_dtype == kI8) {
    launch<TQ, int8_t, true>(q, k, v, ks, vs, pos, out, S, C, H, KV, L, D,
                             scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" int mx_paged_attention(const void* q, const void* k,
                                  const void* v, const float* ks,
                                  const float* vs, const int* pos, void* out,
                                  int S, int C, int H, int KV, int L, int D,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > DMAX || D < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (q_dtype == kF32) {
    rc = dispatch_kv<float>(kv_dtype, q, k, v, ks, vs, pos, out, S, C, H, KV,
                            L, D, scale, st);
  } else if (q_dtype == kBF16) {
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, pos, out, S,
                                    C, H, KV, L, D, scale, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// q [S, C, H, D] bf16 and k, v [S, L, KV, D] bf16, or int8 (kv_dtype)
// with f32 row scales ks, vs [S, L, KV], contiguous, rows on 16-byte
// boundaries; pos int32 [S]; out like q. Takes D in {16, 32, 64, 128};
// anything else is refused (the wrapper routes it to mx_paged_attention).
extern "C" int mx_paged_attention_chunk(const void* q, const void* k,
                                        const void* v, const float* ks,
                                        const float* vs, const int* pos,
                                        void* out, int S, int C, int H,
                                        int KV, int L, int D, float scale,
                                        int kv_dtype, void* stream) {
  if (KV < 1 || H % KV != 0 || L < 1 || C < 1 ||
      (kv_dtype != kBF16 && kv_dtype != kI8) ||
      (kv_dtype == kI8) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{S,
          H,
          C,
          L,
          scale,
          0,
          0,
          (long long)C * H * D,
          (long long)H * D,
          (long long)L * KV * D,
          (long long)KV * D,
          (long long)L * KV * D,
          (long long)KV * D,
          1,
          0,
          0,
          nullptr,
          H / KV,
          pos};
  if (!valid_dims(D, kBF16, s))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kI8) {
    switch (D) {
      case 16:
        return fwd_i8<16>(q, k, v, out, ks, vs, s, st);
      case 32:
        return fwd_i8<32>(q, k, v, out, ks, vs, s, st);
      case 64:
        return fwd_i8<64>(q, k, v, out, ks, vs, s, st);
      case 128:
        return fwd_i8<128>(q, k, v, out, ks, vs, s, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16:
      return fwd<16, Mask::Paged>(q, k, v, out, nullptr, s, kBF16, st);
    case 32:
      return fwd<32, Mask::Paged>(q, k, v, out, nullptr, s, kBF16, st);
    case 64:
      return fwd<64, Mask::Paged>(q, k, v, out, nullptr, s, kBF16, st);
    case 128:
      return fwd<128, Mask::Paged>(q, k, v, out, nullptr, s, kBF16, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// mx_paged_attention_decode: the split-KV read for C < 16 (see the top)

namespace {

// One block: split blockIdx.x / nrt, query rows [r0, r0 + RT) of the
// G*C rows of kv head blockIdx.y of slot blockIdx.z.
template <typename TQ, typename TKV, bool QUANT, int RT>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_split(DecArgs a, bool vec) {
  __shared__ __align__(16) uint8_t ring[2 * 2 * DEC_STAGE];  // [stage][k, v]
  __shared__ float scl[QUANT ? 2 * 2 * DEC_TK_MAX : 1];
  const int nrt = ((a.H / a.KV) * a.C + RT - 1) / RT;
  decode_split<TKV, QUANT, RT>(a, PlainQ<TQ>{static_cast<const TQ*>(a.q),
                                             a.C, a.H, a.D},
                               vec, blockIdx.x / nrt,
                               (blockIdx.x % nrt) * RT, blockIdx.y,
                               blockIdx.z, ring, scl);
}

// o of each row: the splits' states merged, one thread a (row, dim). The
// loads of every split's (m, l), then of every split's acc, are in flight
// together (NS <= 32); a split with l = 0 saw no key of the row and weighs
// exactly 0 (its acc is not read).
template <typename TQ>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_combine(DecArgs a) {
  const int G = a.H / a.KV, GC = G * a.C, D = a.D, W = D + 2;
  const int i = blockIdx.x * DEC_THREADS + threadIdx.x;  // of S*KV*GC*D
  if (i >= a.S * a.KV * GC * D) return;
  const int d = i % D, row = i / D;
  const int r = row % GC, kvh = row / GC % a.KV, s = row / GC / a.KV;
  const float* ws = a.ws + ((size_t)s * a.KV + kvh) * a.NS * (size_t)GC * W +
                    (size_t)r * W;
  const size_t step = (size_t)GC * W;  // from one split's row to the next
  float m[32], l[32];
#pragma unroll
  for (int sp = 0; sp < 32; ++sp) {
    m[sp] = -INFINITY;
    l[sp] = 0.f;
    if (sp < a.NS) {
      m[sp] = ws[sp * step];
      l[sp] = ws[sp * step + 1];
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int sp = 0; sp < 32; ++sp)
    if (l[sp] > 0.f) mx = fmaxf(mx, m[sp]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int sp = 0; sp < 32; ++sp) {
    if (l[sp] > 0.f) {
      const float w = fast_exp2(m[sp] - mx);
      den = fmaf(w, l[sp], den);
      num = fmaf(w, ws[sp * step + 2 + d], num);
    }
  }
  const int g = r / a.C, c = r % a.C;
  static_cast<TQ*>(a.out)[(((size_t)s * a.C + c) * a.H + kvh * G + g) * D +
                          d] = from_f32<TQ>(num / fmaxf(den, 1e-30f));
}

template <typename TQ, typename TKV, bool QUANT>
int launch_decode(const DecArgs& a, cudaStream_t st) {
  constexpr int RT = dec_rows<TKV>();
  const int GC = (a.H / a.KV) * a.C;
  const bool vec = (a.D * sizeof(TKV)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  if (GC == 1)
    paged_decode_split<TQ, TKV, QUANT, 1>
        <<<dim3(a.NS, a.KV, a.S), DEC_THREADS, 0, st>>>(a, vec);
  else
    paged_decode_split<TQ, TKV, QUANT, RT>
        <<<dim3(a.NS * ((GC + RT - 1) / RT), a.KV, a.S), DEC_THREADS, 0,
           st>>>(a, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int outs = a.S * a.KV * GC * a.D;
  paged_decode_combine<TQ>
      <<<(outs + DEC_THREADS - 1) / DEC_THREADS, DEC_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int decode_kv(int kv_dtype, const DecArgs& a, cudaStream_t st) {
  if (kv_dtype == kF32) return launch_decode<TQ, float, false>(a, st);
  if (kv_dtype == kBF16)
    return launch_decode<TQ, __nv_bfloat16, false>(a, st);
  if (kv_dtype == kI8) return launch_decode<TQ, int8_t, true>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [S, C, H, D] f32 or bf16 and k, v [S, L, KV, D] f32, bf16 or int8
// (with f32 row scales ks, vs [S, L, KV]), contiguous; pos int32 [S]; out
// like q; ws f32 [S, KV, NS, (H / KV) C, D + 2], written before it is read;
// NS <= 32.
// Two launches on the stream: the splits, then their merge.
extern "C" int mx_paged_attention_decode(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* pos, void* out, float* ws, int S, int C,
    int H, int KV, int L, int D, int NS, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (D > DMAX || D < 1 || KV < 1 || H % KV != 0 || C < 1 || L < 1 ||
      NS < 1 || NS > 32 || S < 1 || S > 65535 || KV > 65535 ||
      (kv_dtype == kI8) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecArgs a{q,  k, v, ks, vs, pos, out, ws, S, C, H,
                  KV, L, D, NS, scale * 1.4426950408889634f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) return decode_kv<float>(kv_dtype, a, st);
  if (q_dtype == kBF16) return decode_kv<__nv_bfloat16>(kv_dtype, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
