// striped_pair_attention: one hop of the striped causal ring. The local
// query block q and one arriving K/V block, each [BH, C, D] with local row
// a at global position a*n + q_off (resp. a*n + k_off), attend under the
// striped causal mask a*n + q_off >= b*n + k_off; the forward writes o,
// normalized over the hop's visible keys, and the per-row logsumexp, an
// output that the ring merges hops by (logaddexp); the backward takes the
// cotangents of both.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py striped_pair_attention (l.664):
// _spair_fwd_kernel l.445 (_spair_fwd l.580), _spair_dq_kernel l.491 and
// _spair_dkv_kernel l.528 (_spair_bwd_impl l.598). The ring positions are
// host ints here, kernel arguments: the controller knows every rank's and
// hop's, where the Pallas kernel reads them from an SMEM operand (l.589).
//
// The kernels are attention.cuh's with the striped mask (Mask::Striped):
// the flash kernels' tiles, a row with no visible key (row 0 whenever
// k_off > q_off) gives o = 0 and lse = -1e30, key tiles past the striped
// diagonal are never read (l.453-458) and, in dK/dV, nor are the query
// tiles before it (l.537-541), so a hop costs about half a block. The dQ
// kernel writes dcap = rowsum(dO * O) - g_lse, the lse cotangent folded in
// (l.603-604), and the dK/dV kernel reads it. Every kernel, bf16 and f32,
// is a pipelined, tiled one of attention.cuh: tiles wholly below the
// striped diagonal skip the mask.
//
// Bound on the H100: at the 124M LM's sequence-parallel hop (BH = 24,
// C = 1024, D = 64) a hop does 4 D flops per visible pair forward (~3.2
// GFLOP on ~25 MB in f32), 6 D in dQ and 8 D in dK/dV: the operations bound
// it, on the CUDA cores in f32 (67 TFLOP/s) and on the tensor cores in
// bf16. The f32 kernels keep the CUDA cores busy with register-tiled
// products (128 FFMAs a thread for each 12 float4 reads of shared memory
// in the score products) over 64 x 64 tiles staged by cp.async.
#include "attention.cuh"

using namespace mxk;

namespace {

Shape hop_shape(int BH, int Cq, int Ck, int D, float scale, int n, int q_off,
                int k_off, const void* glse) {
  return Shape{BH,
               1,
               Cq,
               Ck,
               scale,
               0,
               0,
               (long long)Cq * D,
               D,
               (long long)Ck * D,
               D,
               (long long)Ck * D,
               D,
               n,
               q_off,
               k_off,
               static_cast<const float*>(glse)};
}

bool valid_hop(int D, int dtype, const Shape& s) {
  return valid_dims(D, dtype, s) && s.n >= 1 && s.q_off >= 0 &&
         s.q_off < s.n && s.k_off >= 0 && s.k_off < s.n;
}

}  // namespace

// q [BH, Cq, D], k/v [BH, Ck, D] contiguous, of one dtype; o like q; lse
// f32 [BH, Cq].
extern "C" int mx_striped_pair_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Cq, int Ck, int D, float scale, int n,
                                   int q_off, int k_off, int dtype,
                                   void* stream) {
  const Shape s = hop_shape(BH, Cq, Ck, D, scale, n, q_off, k_off, nullptr);
  if (!valid_hop(D, dtype, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MX_CALL(DD) fwd<DD, Mask::Striped>(q, k, v, o, l, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}

// dout and dq like q; glse (the lse cotangent) f32 [BH, Cq]; writes dcap
// f32 [BH, Cq] for mx_striped_pair_dkv.
extern "C" int mx_striped_pair_dq(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  const void* glse, void* dcap, void* dqp,
                                  int BH, int Cq, int Ck, int D, float scale,
                                  int n, int q_off, int k_off, int dtype,
                                  void* stream) {
  const Shape s = hop_shape(BH, Cq, Ck, D, scale, n, q_off, k_off, glse);
  if (!valid_hop(D, dtype, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dc = static_cast<float*>(dcap);
#define MX_CALL(DD) \
  dq<DD, Mask::Striped>(q, k, v, o, dout, l, dc, dqp, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}

// dk/dv like k; reads the dcap mx_striped_pair_dq wrote.
extern "C" int mx_striped_pair_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dcap,
                                   void* dk, void* dv, int BH, int Cq, int Ck,
                                   int D, float scale, int n, int q_off,
                                   int k_off, int dtype, void* stream) {
  const Shape s = hop_shape(BH, Cq, Ck, D, scale, n, q_off, k_off, nullptr);
  if (!valid_hop(D, dtype, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dc = static_cast<const float*>(dcap);
#define MX_CALL(DD) \
  dkv<DD, Mask::Striped>(q, k, v, dout, l, dc, dk, dv, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}
