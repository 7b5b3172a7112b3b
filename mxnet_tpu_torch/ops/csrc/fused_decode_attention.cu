// fused_decode_attention: one decode step of an attention node in one C call.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py fused_decode_attention (l.1389;
// kernel _fused_decode_kernel l.1331).
//
// Per slot s at position p = pos[s]: qkv = dequant(wqkv) @ x + bqkv; rope
// (half-split, angles from the caller's cos/sin tables) on the H query
// heads and the KV key heads; per query head h (kv head h / G) one softmax
// over the cache rows [0, p) and the new token's own k/v; then out =
// dequant(wo) @ o + bo. The cache is not written here: the roped k_new and
// v_new rows go out for the caller to write.
//
// Bound on the H100: bytes — the int8 (or packed int4) QKV and output
// weights, ~2.4 MB a layer at the 124M LM, plus each slot's live cache
// rows; a few flops a byte. The TPU version ran one grid step per slot
// with the weights resident in VMEM. Here the step is three phases, each
// a list of work items the blocks take in turn:
//   1. the QKV projection as one GEMM over all S slots (qgemm.cuh's tiles,
//      the weights streamed once from device memory, split over the
//      contraction by kernels.quant_matmul_splits): the last block of each
//      tile adds the splits in order, applies the int8 scale and the bias
//      into an f32 workspace [S, FQ];
//   2. the attention, split over keys as mx_paged_attention_decode reads
//      (decode.cuh's decode_split; splits from kernels.fused_decode_splits,
//      a function of L, head_dim and the SM count, never of pos or S), q
//      roped as it is loaded; each split's (m, l, acc) goes to a workspace;
//   3. per (slot, kv head) the merge of the splits in order and then the
//      new token (its score from the roped q and k_new): the heads' rows of
//      o [S, E] (in x's dtype), k_new and v_new out. A split past the
//      slot's live rows is empty (l = 0) and weighs exactly 0, so a slot
//      at pos 0 gets v_new. Then a grid-wide barrier, and the output
//      projection as a GEMM over all slots with wo, the last block of each
//      tile applying the scale and bo.
// They run as three kernels on the stream, each with the grid, registers
// and shared memory its phase wants; the third is a cooperative launch,
// sized from the kernel's occupancy so that every block is resident at its
// grid barrier. Every sum has one order whatever S and pos are, so a
// slot's result is the same bits alone or among 32 slots. The GEMMs'
// arrival counts are reset by the blocks that read them (no memset).
#include <cooperative_groups.h>

#include "decode.cuh"
#include "qgemm.cuh"

namespace {

namespace cg = cooperative_groups;

struct FdArgs {
  const void* x;
  const int* pos;
  const void* kc;
  const void* vc;
  const uint8_t* wqkv;
  const float* sqkv;
  const float* bqkv;
  const uint8_t* wo;
  const float* so;
  const float* bo;
  const float* cs;  // [S, D/2] rope cos, sin
  const float* sn;
  void* out;     // [S, E] in x's dtype
  void* kn;      // [S, KV, D] in bf16 or f32 (new_bf16)
  void* vn;
  float* qkv;    // [S, FQ]: the projection, scaled and biased, not roped
  void* o;       // [S, E] in x's dtype: the attention output
  float* part;   // the GEMMs' split partials (phase 1, then phase 3)
  float* att;    // [S, KV, NS, G, D + 2]: each split's (m, l, acc)
  int* count;    // arrival counts: phase 1 tiles, then phase 3 tiles
  int S, E, H, KV, D, L, group, ns, ks1, ks3;
  float scale;   // the softmax scale
  bool vec;      // cache rows are whole 16-byte chunks on 16-byte bounds
  bool new_bf16; // k_new and v_new in bf16, else f32
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// element d of a head's roped row hv (half-split rope)
__device__ __forceinline__ float rope(const float* hv, const float* cr,
                                      const float* sr, int d, int half) {
  if (d < half) return hv[d] * cr[d] - hv[d + half] * sr[d];
  const int t = d - half;
  return hv[d] * cr[t] + hv[t] * sr[t];
}

// decode_split's q: head h of slot s, roped, from the projection
struct RopeQ {
  const float* qkv;
  const float* cs;
  const float* sn;
  int FQ, D;
  __device__ __forceinline__ float operator()(int s, int, int h,
                                              int d) const {
    const int half = D / 2;
    return rope(qkv + (size_t)s * FQ + h * D, cs + (size_t)s * half,
                sn + (size_t)s * half, d, half);
  }
};

// phase 1's epilogue: qkv[m, f] = (int8: s[f] x) v + b[f]
template <int BITS>
struct QkvOut {
  float* qkv;
  const float* s;
  const float* b;
  int FQ;
  __device__ __forceinline__ void operator()(int m, int f, float v) const {
    qkv[(size_t)m * FQ + f] = (BITS == 8 ? v * s[f] : v) + b[f];
  }
};

// phase 3's epilogue: out[m, f] = (int8: s[f] x) v + b[f] in x's dtype
template <typename TX, int BITS>
struct StepOut {
  TX* out;
  const float* s;
  const float* b;
  int E;
  __device__ __forceinline__ void operator()(int m, int f, float v) const {
    out[(size_t)m * E + f] = from_f32<TX>((BITS == 8 ? v * s[f] : v) + b[f]);
  }
};

// shared memory the merge takes: roped q [G][D], k_new [D], and per query
// row its new-token score, the new token's and the splits' weights [32]
// and the denominator
__host__ __device__ __forceinline__ int merge_smem(int G, int D) {
  return 4 * ((G + 1) * D + 35 * G);
}

// element i of k_new or v_new, rounded once from the f32 value when the
// caller asked for bf16
__device__ __forceinline__ void store_new(void* p, size_t i, float x,
                                          bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = from_f32<__nv_bfloat16>(x);
  else
    static_cast<float*>(p)[i] = x;
}

// The merge of (slot s, kv head kvh): k_new and v_new out; per query row
// (a warp, a lane a split) the new token's score, the running maximum over
// it and the live splits, each split's weight and the denominator (the new
// token's term added last); then per row and dim the splits' accs in split
// order, the new token's v last. A split with l = 0 saw no key: weight 0,
// its acc not read.
template <typename TX>
__device__ void merge_pair(const FdArgs& a, int s, int kvh, float* sm) {
  const int G = a.H / a.KV, D = a.D, W = D + 2, half = D / 2;
  const int FQ = a.E + 2 * a.KV * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* row = a.qkv + (size_t)s * FQ;
  const float* cr = a.cs + (size_t)s * half;
  const float* sr = a.sn + (size_t)s * half;
  const float* vrow = row + a.E + (a.KV + kvh) * D;
  float* qn = sm;            // [G][D] roped q, then k_new [D]
  float* kq = qn + G * D;
  float* wt = kq + D;        // [G][32] the splits' weights
  float* wn = wt + 32 * G;   // [G] the new token's weight
  float* dn = wn + G;        // [G] the denominator
  float* sc = dn + G;        // [G] the new token's score, base 2
  for (int i = tid; i < (G + 1) * D; i += DEC_THREADS) {
    const int hh = i / D, d = i % D;
    qn[i] = rope(hh < G ? row + (kvh * G + hh) * D : row + a.E + kvh * D, cr,
                 sr, d, half);
  }
  __syncthreads();
  const size_t nrow = ((size_t)s * a.KV + kvh) * D;
  for (int d = tid; d < D; d += DEC_THREADS) {
    store_new(a.kn, nrow + d, kq[d], a.new_bf16);
    store_new(a.vn, nrow + d, vrow[d], a.new_bf16);
  }
  const float c2 = a.scale * 1.4426950408889634f;
  const size_t step = (size_t)G * W;  // from one split's row to the next
  const float* ws = a.att + ((size_t)s * a.KV + kvh) * a.ns * step;
  for (int g = warp; g < G; g += DEC_WARPS) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += qn[g * D + d] * kq[d];
    const float snew = warp_sum(dot) * c2;
    float m = -INFINITY, l = 0.f;
    if (lane < a.ns) {
      m = __ldcg(ws + lane * step + (size_t)g * W);
      l = __ldcg(ws + lane * step + (size_t)g * W + 1);
    }
    const float mx = fmaxf(snew, warp_max(l > 0.f ? m : -INFINITY));
    const float w = l > 0.f ? fast_exp2(m - mx) : 0.f;
    const float den = warp_sum(w * l);
    wt[g * 32 + lane] = w;
    if (lane == 0) {
      wn[g] = fast_exp2(snew - mx);
      dn[g] = den + wn[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    const float* acc = ws + (size_t)g * W + 2 + d;
    float num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < a.ns; ++sp) {
      const float w = wt[g * 32 + sp];
      const float v = w > 0.f ? __ldcg(acc + sp * step) : 0.f;
      num += w * v;
    }
    num += wn[g] * vrow[d];
    static_cast<TX*>(a.o)[(size_t)s * a.E + (kvh * G + g) * D + d] =
        from_f32<TX>(num / dn[g]);
  }
}

// phase 2: the work items (slot, kv head, split, row tile of RT query
// heads), row tiles fastest
template <typename TC, int RT>
__device__ void split_items(const FdArgs& a, uint8_t* sm) {
  const int G = a.H / a.KV, nrt = cdiv(G, RT), per = a.ns * nrt;
  const int FQ = a.E + 2 * a.KV * a.D;
  // C = 1 row a head, seeing keys [0, pos - 1] of the cache
  const DecArgs da{nullptr, a.kc,  a.vc, nullptr, nullptr,
                   a.pos,   nullptr, a.att, a.S,  1,
                   a.H,     a.KV,  a.L,  a.D,  a.ns,
                   a.scale * 1.4426950408889634f, -1};
  const RopeQ rq{a.qkv, a.cs, a.sn, FQ, a.D};
  const int n = a.S * a.KV * per;
  for (int it = blockIdx.x; it < n; it += gridDim.x) {
    __syncthreads();  // the last item is done with the shared memory
    const int pair = it / per, sp = it / nrt % a.ns, rt = it % nrt;
    decode_split<TC, false, RT>(da, rq, a.vec, sp, rt * RT, pair % a.KV,
                                pair / a.KV, sm, nullptr);
  }
}

// phase 3's first part: the merges, a (slot, kv head) an item
template <typename TX>
__device__ void merge_items(const FdArgs& a, uint8_t* sm) {
  for (int it = blockIdx.x; it < a.S * a.KV; it += gridDim.x) {
    __syncthreads();  // the last item is done with the shared memory
    merge_pair<TX>(a, it / a.KV, it % a.KV, reinterpret_cast<float*>(sm));
  }
}

// PH 1: the QKV GEMM; PH 2: the key splits; PH 3: the merges, a grid
// barrier, the output GEMM (a cooperative launch). RT: query heads a key
// split item takes (1 without GQA, which holds fewer registers).
template <typename TX, typename TC, int BITS, bool MMA, int RT, int PH>
__global__ void __launch_bounds__(qmm::THREADS, PH == 2 && RT == 1 ? 5 : 1)
fused_decode_kernel(FdArgs a) {
  static_assert(qmm::THREADS == DEC_THREADS, "one block shape");
  extern __shared__ __align__(16) uint8_t smem[];
  const int FQ = a.E + 2 * a.KV * a.D;
  const int tiles1 = cdiv(a.S, qmm::BM) * cdiv(FQ, qmm::BF);
  if constexpr (PH == 1)
    qmm::gemm_items<TX, BITS, MMA>(
        static_cast<const TX*>(a.x), a.wqkv, a.sqkv, a.S, a.E, FQ, a.group,
        a.ks1, a.part, a.count, QkvOut<BITS>{a.qkv, a.sqkv, a.bqkv, FQ},
        smem);
  if constexpr (PH == 2) split_items<TC, RT>(a, smem);
  if constexpr (PH == 3) {
    merge_items<TX>(a, smem);
    cg::this_grid().sync();
    qmm::gemm_items<TX, BITS, MMA>(
        static_cast<const TX*>(a.o), a.wo, a.so, a.S, a.E, a.E, a.group,
        a.ks3, a.part, a.count + tiles1,
        StepOut<TX, BITS>{static_cast<TX*>(a.out), a.so, a.bo, a.E}, smem);
  }
}

template <typename TX, typename TC, int BITS, bool MMA, int RT, int PH>
int run(const FdArgs& a, int items, int smem, bool coop, cudaStream_t st) {
  auto kern = fused_decode_kernel<TX, TC, BITS, MMA, RT, PH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) {
    kern<<<items, qmm::THREADS, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      qmm::THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = min(items, per_sm * sm_count());
  FdArgs args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(grid), dim3(qmm::THREADS),
      params, smem, st));
}

template <typename TX, typename TC, int BITS, bool MMA, int RT>
int launch(const FdArgs& a, cudaStream_t st) {
  const int G = a.H / a.KV, FQ = a.E + 2 * a.KV * a.D;
  const int nmt = cdiv(a.S, qmm::BM);
  const int n1 = nmt * cdiv(FQ, qmm::BF) * a.ks1;
  const int n2 = a.S * a.KV * a.ns * cdiv(G, RT);
  const int n3 = nmt * cdiv(a.E, qmm::BF) * a.ks3;
  const int gemm = MMA ? qmm::mma_smem<BITS>() : qmm::SIMT_SMEM;
  const int merge = max(gemm, merge_smem(G, a.D));
  const int pairs = a.S * a.KV;
  int rc = run<TX, TX, BITS, MMA, 1, 1>(a, n1, gemm, false, st);
  if (rc == 0)
    rc = run<TC, TC, 8, false, RT, 2>(a, n2, 2 * 2 * DEC_STAGE, false, st);
  if (rc == 0)
    rc = run<TX, TX, BITS, MMA, 1, 3>(a, max(n3, pairs), merge, true, st);
  return rc;
}

template <typename TX, typename TC, int BITS, bool MMA>
int launch_rows(const FdArgs& a, cudaStream_t st) {
  if (a.H == a.KV) return launch<TX, TC, BITS, MMA, 1>(a, st);
  return launch<TX, TC, BITS, MMA, dec_rows<TC>()>(a, st);
}

template <typename TX, typename TC>
int dispatch(const FdArgs& a, int bits, cudaStream_t st) {
  const bool mma = sizeof(TX) == 2 && a.E % qmm::KS == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   (bits == 8 || a.group % 16 == 0);
  if constexpr (sizeof(TX) == 2) {
    if (mma)
      return bits == 8 ? launch_rows<TX, TC, 8, true>(a, st)
                       : launch_rows<TX, TC, 4, true>(a, st);
  }
  return bits == 8 ? launch_rows<TX, TC, 8, false>(a, st)
                   : launch_rows<TX, TC, 4, false>(a, st);
}

}  // namespace

// x [S, E] f32 or bf16; k_cache, v_cache [S, L, KV, D] f32 or bf16; wqkv
// [FQ = E + 2 KV D, E] and wo [E, E] int8 (scales [rows]) or packed int4
// (scales [rows, E / group]); bqkv, bo, cos, sin f32. Workspaces: qkv f32
// [S, FQ]; o [S, E] in x's dtype; part f32, ceil(S/32) x max(ceil(FQ/64)
// ks1, ceil(E/64) ks3) tiles of 32 x 64 (unused where both splits are 1);
// att f32 [S, KV, ns, H/KV, D + 2]; count int32 [ceil(S/32) (ceil(FQ/64) +
// ceil(E/64))], all 0, left all 0. ns <= 32 key splits, ks1 and ks3 <=
// ceil(E/128) contraction splits. k_new and v_new [S, KV, D] come out in
// new_dtype (f32 or bf16), each rounded once from its f32 value.
extern "C" int mx_fused_decode_attention(
    const void* x, const int* pos, const void* kc, const void* vc,
    const void* wqkv, const float* sqkv, const float* bqkv, const void* wo,
    const float* so, const float* bo, const float* cs, const float* sn,
    void* out, void* kn, void* vn, void* qkv, void* o, void* part, void* att,
    void* count, int S, int E, int H, int KV, int D, int L, int bits,
    int group, int ns, int ks1, int ks3, float scale,
    int x_dtype, int cache_dtype, int new_dtype, void* stream) {
  const int nst = (E + qmm::KS - 1) / qmm::KS;
  if (S < 1 || KV < 1 || H % KV != 0 || H * D != E || D < 2 || D % 2 ||
      D > 128 || L < 1 || ns < 1 || ns > 32 || ks1 < 1 || ks1 > nst ||
      ks3 < 1 || ks3 > nst ||
      (bits != 8 && bits != 4) ||
      (bits == 4 && (group < 2 || E % group != 0)) ||
      (new_dtype != kF32 && new_dtype != kBF16) ||
      merge_smem(H / KV, D) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int csz = static_cast<int>(cache_dtype == kF32 ? 4 : 2);
  const FdArgs a{x,
                 pos,
                 kc,
                 vc,
                 static_cast<const uint8_t*>(wqkv),
                 sqkv,
                 bqkv,
                 static_cast<const uint8_t*>(wo),
                 so,
                 bo,
                 cs,
                 sn,
                 out,
                 kn,
                 vn,
                 static_cast<float*>(qkv),
                 o,
                 static_cast<float*>(part),
                 static_cast<float*>(att),
                 static_cast<int*>(count),
                 S,
                 E,
                 H,
                 KV,
                 D,
                 L,
                 group,
                 ns,
                 ks1,
                 ks3,
                 scale,
                 (D * csz) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kc) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vc) % 16 == 0,
                 new_dtype == kBF16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && cache_dtype == kF32)
    return dispatch<float, float>(a, bits, st);
  if (x_dtype == kF32 && cache_dtype == kBF16)
    return dispatch<float, __nv_bfloat16>(a, bits, st);
  if (x_dtype == kBF16 && cache_dtype == kF32)
    return dispatch<__nv_bfloat16, float>(a, bits, st);
  if (x_dtype == kBF16 && cache_dtype == kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(a, bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
