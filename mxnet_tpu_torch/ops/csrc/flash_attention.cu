// flash_attention: o = softmax(scale * q k^T + mask) v over [B, T, H, D]
// tensors, with the per-row logsumexp the backward recomputes from, and
// the backward's two kernels: dQ over query tiles, dK/dV over key tiles.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py flash_attention (l.373):
// _attn_fwd_kernel l.107 (_flash_fwd l.167), _attn_dq_kernel l.200 and
// _attn_dkv_kernel l.241 (_flash_bwd l.291).
//
// The kernels are attention.cuh's with the flash mask (Mask::Flash): key
// k is visible from query q when k < Tk, q < Tq, (causal) q >= k and
// (window > 0) q - k < window. The header describes the tile design.
//
// Bound on the H100: at the 124M LM's shape (B*H = 96, T = 1024, D = 64,
// causal, bf16) the forward does ~12.9 GFLOP on ~50 MB (~257 flops a byte,
// near the ~295 where the tensor cores become the limit): 0.0151 ms of
// bytes against 0.0130 of operations; the dQ kernel's bound is its bytes
// (0.0228 ms), the dK/dV kernel's its operations (0.0261). Far above
// either, what bounds a forward of mma.sync tiles is latency: K/V tiles
// arriving while the tensor cores wait, and the mask and softmax between
// the two products (a forward with synchronous loads, 64-row tiles and
// the mask on every score took 0.20 ms on an H100, 3.9x PyTorch's SDPA).
// So the forward overlaps tile j+1's cp.async copies with tile j's
// products in 128-row query tiles, masks only the diagonal's tiles, takes
// exp2 with the scale folded into one FMA, and starts the heaviest tiles
// first; the backward does the same in 64-row tiles, three blocks an SM
// (a backward with synchronous loads and the mask and expf on every score
// took 0.22 ms for dQ and 0.29 for dK/dV, 2.5x SDPA's backward).
#include "attention.cuh"

using namespace mxk;

// q [B, Tq, H, D], k/v [B, Tk, H, D] of one dtype, each with its batch and
// time strides (q/k/v may be views into one packed qkv tensor); o, like q,
// contiguous; lse f32 [B*H, Tq].
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int Tq, int Tk, int D,
                                      long long qsb, long long qst,
                                      long long ksb, long long kst,
                                      long long vsb, long long vst,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  const Shape s{B,   H,   Tq,  Tk,  scale, causal, window,
                qsb, qst, ksb, kst, vsb,   vst};
  if (!valid_dims(D, dtype, s) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MX_CALL(DD) fwd<DD, Mask::Flash>(q, k, v, o, l, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}

// dout and dq like q; writes dcap f32 [B*H, Tq] for mx_flash_attention_dkv.
extern "C" int mx_flash_attention_dq(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dcap, void* dqp, int B, int H,
                                     int Tq, int Tk, int D, long long qsb,
                                     long long qst, long long ksb,
                                     long long kst, long long vsb,
                                     long long vst, float scale, int causal,
                                     int window, int dtype, void* stream) {
  const Shape s{B,   H,   Tq,  Tk,  scale, causal, window,
                qsb, qst, ksb, kst, vsb,   vst};
  if (!valid_dims(D, dtype, s) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dc = static_cast<float*>(dcap);
#define MX_CALL(DD) \
  dq<DD, Mask::Flash>(q, k, v, o, dout, l, dc, dqp, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}

// dk/dv like k; reads the dcap mx_flash_attention_dq wrote.
extern "C" int mx_flash_attention_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dcap,
                                      void* dk, void* dv, int B, int H,
                                      int Tq, int Tk, int D, long long qsb,
                                      long long qst, long long ksb,
                                      long long kst, long long vsb,
                                      long long vst, float scale, int causal,
                                      int window, int dtype, void* stream) {
  const Shape s{B,   H,   Tq,  Tk,  scale, causal, window,
                qsb, qst, ksb, kst, vsb,   vst};
  if (!valid_dims(D, dtype, s) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dc = static_cast<const float*>(dcap);
#define MX_CALL(DD) \
  dkv<DD, Mask::Flash>(q, k, v, dout, l, dc, dk, dv, s, dtype, st)
  MX_ATTN_DISPATCH(MX_CALL)
#undef MX_CALL
}
