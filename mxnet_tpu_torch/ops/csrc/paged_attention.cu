// paged_attention: slot-paged attention over each slot's live KV rows.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py paged_attention (l.1115; kernel
// _paged_attn_kernel l.1037).
//
// q [S, C, H, D] (each slot's C-token chunk, starting at pos[s]) against a
// cache k, v [S, L, KV, D] (f32/bf16, or int8 with f32 row scales
// [S, L, KV]). Query row r = g*C + c of kv head kvh is head kvh*G + g at
// chunk offset c and sees keys [0, pos + c]. Online softmax in f32 with
// -1e30 masking; out = acc / max(l, 1e-30).
//
// Bound on the H100: the bytes of the live rows, read once per kv head
// (decode and short chunks do a few flops per byte); a 256-token prefill
// chunk does ~2*C flops per cached element and leans to the flop side.
// Design: the TPU version cut dead-row DMA by revisiting a clamped block
// index in its grid; here a block owns one (slot, kv head, tile of 16
// query rows) and loops over the key tiles up to the tile's own last live
// key, p + (largest chunk offset among its rows), so dead rows are never
// loaded. Each tile of 32 keys is staged once in shared memory (int8 rows
// dequantized on the way) and serves all 16 rows, i.e. every query head of
// the GQA group; each warp owns 2 rows and each lane scores one key of the
// tile, then the probabilities are broadcast by shuffles into per-lane
// accumulators over head_dim (<= 128). The 256-row prefill chunk is cut
// into 16 such tiles of rows, keeping the f32 accumulators in registers.
// Scalar CUDA-core math; tensor-core tiles are later work.
#include "common.cuh"

using namespace mxk;

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
