// Small device helpers shared by every kernel source (gemm.cu,
// gemm_sm90.cu, layer_inference.cu, attention.cu, encoder_tail.cu,
// dropout_bits.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mdm {

typedef __nv_bfloat16 bf16;

constexpr float kLnEps = 1e-5f;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to T and back: the working-dtype rounding points of the TPU kernels.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu_exact(float u) {
  return u * 0.5f * (1.0f + erff(u * kInvSqrt2));
}

// GELU's tanh form, 0.5 u (1 + tanh(sqrt(2/pi) (u + 0.044715 u^3))): DiT's
// MLP (torch's F.gelu(approximate="tanh")).
__device__ __forceinline__ float gelu_tanh(float u) {
  return 0.5f * u * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * u * u * u)));
}

// d gelu / du = Phi(u) + u phi(u), exact (encoder_tail.py::_gelu_grad_f32).
__device__ __forceinline__ float gelu_grad(float u) {
  const float phi = expf(-0.5f * u * u) * kInvSqrt2Pi;
  const float cdf = 0.5f * (1.0f + erff(u * kInvSqrt2));
  return cdf + u * phi;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy global -> shared; src_bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[i] = the sum over z = 0 .. splits - 1, in that order, of work[z * n + i]
// (gemm.cu): the split-K partials' and the column sums' second pass. Above
// 64 splits, in 32 runs of consecutive splits, each summed in order, then
// the runs in order.
cudaError_t sum_splits(const float* work, float* out, size_t n, int splits, cudaStream_t st);

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace mdm
