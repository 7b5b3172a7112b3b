// Helpers shared by the kernels of mxnet_tpu_torch/ops/kernels.py.
//
// Dtype codes of the C interfaces: 0 = float32, 1 = bfloat16, 2 = int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxk {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 2^x (ex2.approx.ftz: about 2^-22 relative error, subnormal results
// flushed to 0, 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One signed 4-bit value of a packed byte: the low nibble is the even
// element, the high nibble the odd one, two's complement.
__device__ __forceinline__ float nibble(uint8_t b, int high) {
  int v = high ? (b >> 4) : (b & 15);
  return static_cast<float>(v >= 8 ? v - 16 : v);
}

// Four int8 values (the first in the low byte) as two bf16 pairs: ev =
// values 0, 2 and od = values 1, 3 (the first in the low half). A byte's
// low 7 bits in the mantissa of the bf16 128 (whose unit is 1) give 128 + b
// & 127, which is 128 + v for v >= 0 and 256 + v for v < 0; less 128 or
// 256 (0x4300 with the sign bit as the exponent's lowest bit), exact.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& ev,
                                          uint32_t& od) {
  const uint32_t wo = w >> 8;
  const uint32_t ve = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t se = (w & 0x00800080u) | 0x43004300u;
  const uint32_t vo = (wo & 0x007f007fu) | 0x43004300u;
  const uint32_t so = (wo & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 re =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&ve),
              *reinterpret_cast<const __nv_bfloat162*>(&se));
  const __nv_bfloat162 ro =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&vo),
              *reinterpret_cast<const __nv_bfloat162*>(&so));
  ev = *reinterpret_cast<const uint32_t*>(&re);
  od = *reinterpret_cast<const uint32_t*>(&ro);
}

// Tensor-core helpers (mma.sync m16n8k16, bf16 in, f32 accumulate). With
// g = lane / 4 and t = lane % 4, a warp's fragments hold:
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..],
//                           a[2] = A[g][2t+8..],     a[3] = A[g+8][2t+8..];
//   B (16 x 8, "col"):      b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g];
//   C (16 x 8, f32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..].
// Each 32-bit register holds two bf16 values, the lower index in the low
// half.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix .x4): lane l gives
// the address of row l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte
// aligned), and r[i] receives elements (g, 2t) and (g, 2t+1) of matrix i.
// Over a row-major tile M[n][k] that is the B fragment of a product by
// M^T (k the contraction index): b[0] from the matrix of columns k0..k0+7,
// b[1] from columns k0+8..k0+15.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed on the way
// (ldmatrix .x4 .trans): lane l gives the address of row l % 8 of matrix
// l / 8 (16 contiguous bytes, 16-byte aligned), and r[i] receives, for
// matrix i, elements (2t, g) and (2t+1, g). Over a row-major tile M[k][n]
// that is the B fragment of a product by M (k the contraction index):
// b[0] from the matrix of rows k0..k0+7, b[1] from rows k0+8..k0+15.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// 4 bytes from global to shared memory (cp.async.ca), zero-filled with
// in = false (nothing read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(a), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

}  // namespace mxk
