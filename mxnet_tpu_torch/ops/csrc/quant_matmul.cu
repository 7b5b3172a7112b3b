// quant_matmul: out[M, F] = x[M, E] @ dequant(q)[F, E]^T, f32 accumulation.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py quant_matmul (l.1259; kernel
// _quant_mm_kernel l.1250, _dequant_w l.1239, _unpack4_block l.1226).
//
// Weights: int8 [F, E] with one f32 scale per output channel, applied to
// the accumulated product; or uint8 [F, E/2] holding two signed nibbles
// per byte (low nibble = even element) with f32 scales [F, E/group],
// applied to each weight before the product.
//
// Bound on the H100: at decode (M = 32 rows) the product does 64 flops
// per weight byte it streams, far below the ~295 the card needs to be
// compute-bound, so the weight bytes bound it; at prefill (M <= 256) it
// nears the line. Design: qgemm.cuh's tiles, one work item a block: a
// block owns a 32-row x 64-channel output tile over one of `ksplit` ranges
// of the contraction (a rule of F and E alone, so a row's result does not
// depend on the batch it rides in), the weight bytes streamed through a
// four-stage cp.async ring and turned into tensor-core fragments in
// registers (bf16 x, E a multiple of 128, int8 or int4 with groups of a
// multiple of 16), or through the CUDA-core f32 tile otherwise (f32 x,
// small int4 groups, ragged E). Row tiles are the fastest grid index, so
// the blocks that share a weight tile run together and each weight byte
// comes from device memory about once. The last block of a tile to finish
// adds the ranges' partial sums in split order, applies the int8 scale and
// writes the tile: one launch a call. wgmma/TMA are later work: at M = 32
// the tensor cores idle most of the time.
#include "qgemm.cuh"

using namespace mxk;

namespace {

// out[m, f] = (int8: s[f] x) the sum, in the output dtype
template <typename TO, int BITS>
struct StoreOut {
  TO* out;
  const float* s;
  int F;
  __device__ __forceinline__ void operator()(int m, int f, float v) const {
    out[(size_t)m * F + f] = from_f32<TO>(BITS == 8 ? v * s[f] : v);
  }
};

template <typename TX, typename TO, int BITS, bool MMA>
__global__ void __launch_bounds__(qmm::THREADS)
quant_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s, TO* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ count, int M,
                    int E, int F, int group, int ksplit) {
  extern __shared__ __align__(16) uint8_t smem[];
  qmm::gemm_items<TX, BITS, MMA>(x, q, s, M, E, F, group, ksplit, part,
                                 count, StoreOut<TO, BITS>{out, s, F}, smem);
}

template <typename TX, typename TO, int BITS, bool MMA>
int launch(const void* x, const void* q, const float* s, void* out,
           float* part, int* count, int M, int E, int F, int group,
           int ksplit, cudaStream_t stream) {
  const int smem = MMA ? qmm::mma_smem<BITS>() : qmm::SIMT_SMEM;
  auto kern = quant_matmul_kernel<TX, TO, BITS, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = ((M + qmm::BM - 1) / qmm::BM) *
                    ((F + qmm::BF - 1) / qmm::BF) * ksplit;
  kern<<<items, qmm::THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(q), s,
      static_cast<TO*>(out), part, count, M, E, F, group, ksplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TO, int BITS>
int launch_form(bool mma, const void* x, const void* q, const float* s,
                void* out, float* part, int* count, int M, int E, int F,
                int group, int ksplit, cudaStream_t st) {
  if constexpr (sizeof(TX) == 2) {
    if (mma)
      return launch<TX, TO, BITS, true>(x, q, s, out, part, count, M, E, F,
                                        group, ksplit, st);
  }
  return launch<TX, TO, BITS, false>(x, q, s, out, part, count, M, E, F,
                                     group, ksplit, st);
}

template <typename TX, typename TO>
int dispatch(int bits, const void* x, const void* q, const float* s,
             void* out, float* part, int* count, int M, int E, int F,
             int group, int ksplit, cudaStream_t st) {
  // the tensor cores take bf16 x in whole 128-value stages on 16-byte
  // boundaries, and int4 scale groups that no 16-deep product straddles
  const bool mma = sizeof(TX) == 2 && E % qmm::KS == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (bits == 8 || group % 16 == 0);
  if (bits == 8)
    return launch_form<TX, TO, 8>(mma, x, q, s, out, part, count, M, E, F,
                                  group, ksplit, st);
  return launch_form<TX, TO, 4>(mma, x, q, s, out, part, count, M, E, F,
                                group, ksplit, st);
}

}  // namespace

// part: f32 workspace of ceil(M/32) ceil(F/64) ksplit 32 x 64 tiles (unused
// with ksplit = 1); count: int32 [ceil(M/32) ceil(F/64)], all 0, left all 0
// (unused with ksplit = 1); ksplit must not exceed ceil(E / 128). q 16-byte
// aligned.
extern "C" int mx_quant_matmul(const void* x, const void* q, const float* s,
                               void* out, void* part, void* count, int M,
                               int E, int F, int bits, int group, int ksplit,
                               int x_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(part);
  int* cnt = static_cast<int*>(count);
  if ((bits != 8 && bits != 4) || M < 1 || ksplit < 1 ||
      ksplit > (E + qmm::KS - 1) / qmm::KS ||
      (ksplit > 1 && (ws == nullptr || cnt == nullptr)) ||
      (bits == 4 && (group < 2 || E % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kF32 && out_dtype == kF32)
    return dispatch<float, float>(bits, x, q, s, out, ws, cnt, M, E, F,
                                  group, ksplit, st);
  if (x_dtype == kF32 && out_dtype == kBF16)
    return dispatch<float, __nv_bfloat16>(bits, x, q, s, out, ws, cnt, M, E,
                                          F, group, ksplit, st);
  if (x_dtype == kBF16 && out_dtype == kF32)
    return dispatch<__nv_bfloat16, float>(bits, x, q, s, out, ws, cnt, M, E,
                                          F, group, ksplit, st);
  if (x_dtype == kBF16 && out_dtype == kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        bits, x, q, s, out, ws, cnt, M, E, F, group, ksplit, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
