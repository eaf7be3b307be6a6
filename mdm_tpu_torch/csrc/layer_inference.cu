// The residual LayerNorm of the sampling layer chain, DiT's adaptive
// LayerNorm (adaln_modulate, below), and the error string every binding
// reads. With the products of gemm_sm90.cu and the attention
// core of attention.cu it replaces the Pallas whole-layer kernel
// mdm_tpu/ops/layer_inference.py::fused_layer_inference (_layer_kernel).
//
// The TPU kernel runs one program per batch cell with every layer weight
// resident in VMEM. A flagship layer (D=512, F=1024) holds ~4.2 MB of bf16
// weights, far more than an SM's 227 KB of shared memory, so the layer runs
// here as a short chain of kernels that pass activations through device
// memory (L2 at these sizes):
//
//   attention block    attn = (softmax(q k^T / sqrt(Dh) + m) v) . Wo^T + bo,
//                      q|k|v = x . Wqkv^T + b: the train block's rate-0
//                      forward (ops/attention_train_block.py::_fwd_chain)
//   residual_layernorm y    = LN1(x + attn)                   (dt and f32)
//   gemm, GELU epilogue h   = gelu(y . W1^T + b1)             (dt)
//   gemm                o   = h . W2^T + b2                   (f32)
//   residual_layernorm  z   = LN2(y32 + o)                    (dt)
//
// Precision contract (the TPU kernel's): products accumulate in f32; values
// are rounded to the working type dt only at q/k/v, P, ctx, attn, y, the
// GELU output and z. y32 and o stay f32, so LN2 sees the same residual sum.
// LayerNorm variance is one-pass, E[s^2] - E[s]^2, with eps 1e-5.
//
// Bound on this card: the LayerNorm moves bytes (a row of 512 values in,
// one or two out, a handful of FLOPs per value). One warp owns a row and
// reads it once, in 16-byte loads, holding the sums x + r in registers
// (16 values per lane at D = 512) for the normalisation; past 2048 bf16 or
// 1024 f32 values the rest of the row is read a second time.
//
// Every entry point has a plain C interface (bound with ctypes) and returns
// cudaGetLastError() right after its launch.

#include <cstdint>

#include "common.cuh"

using mdm::bf16;
using mdm::warp_sum;

namespace {

// Two bf16 packed in a 32-bit word <-> two floats (the conversion up is
// exact; down rounds to nearest even, as __float2bfloat16_rn).
__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// N (4 or 8) consecutive values at p as floats, in 8- or 16-byte loads.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const bf16* p, float* v) {
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, v), unpack2(u.y, v + 2), unpack2(u.z, v + 4), unpack2(u.w, v + 6);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, v), unpack2(u.y, v + 2);
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_n(bf16* p, const float* v) {
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// The normalised chunk of V values s at column col of the row at off.
template <int V, typename T>
__device__ __forceinline__ void normalise_chunk(const float* s, const T* __restrict__ g,
                                                const T* __restrict__ beta, T* __restrict__ out,
                                                float* __restrict__ out32, size_t off, int col,
                                                float mu, float rstd) {
  float gv[V], bv[V], v[V];
  load_n<V>(g + col, gv);
  load_n<V>(beta + col, bv);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (s[i] - mu) * rstd * gv[i] + bv[i];
  store_n<V>(out + off + col, v);
  if (out32) store_n<V>(out32 + off + col, v);
}

// out = LN(a + r) * g + beta per row, one warp per row, statistics in f32.
// out32 (optional) receives the f32 result before rounding to T. Lane l
// holds the 16-byte chunks l, l + 32, ... (CH of them at most) of the row
// in registers; a row longer than 32 CH chunks reads its chunks past CH
// twice, once for the statistics and once for the normalisation.
template <typename TI, typename T, int CH>
__global__ void __launch_bounds__(256)
residual_layernorm(const TI* __restrict__ a, const TI* __restrict__ r,
                   const T* __restrict__ g, const T* __restrict__ beta,
                   T* __restrict__ out, float* __restrict__ out32, int M, int D) {
  constexpr int V = 16 / sizeof(TI);  // values per chunk
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  auto load_sum = [&](int col, float* s) {
    float y[V];
    load_n<V>(a + off + col, s);
    load_n<V>(r + off + col, y);
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += y[i];
  };
  float s[CH][V];
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < D) {
      load_sum(col, s[c]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sum += s[c][i];
        sq += s[c][i] * s[c][i];
      }
    }
  }
  for (int col = (lane + 32 * CH) * V; col < D; col += 32 * V) {
    float t[V];
    load_sum(col, t);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum += t[i];
      sq += t[i] * t[i];
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / D;
  const float var = sq / D - mu * mu;
  const float rstd = rsqrtf(var + mdm::kLnEps);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < D) normalise_chunk<V>(s[c], g, beta, out, out32, off, col, mu, rstd);
  }
  for (int col = (lane + 32 * CH) * V; col < D; col += 32 * V) {
    float t[V];
    load_sum(col, t);
    normalise_chunk<V>(t, g, beta, out, out32, off, col, mu, rstd);
  }
}

// The instance whose CH chunks per lane cover D (D % V == 0), or CH = 8
// for a longer row (D > 256 V: its chunks past 8 are read twice).
template <typename TI, typename T>
cudaError_t launch_layernorm(const void* a, const void* r, const void* g, const void* beta,
                             void* out, float* out32, int M, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TI);
  const int chunks = (D / V + 31) / 32;
  if (D % V) return cudaErrorInvalidValue;
  const dim3 grid((M + 7) / 8);
  const TI *A = static_cast<const TI*>(a), *R = static_cast<const TI*>(r);
  const T *G = static_cast<const T*>(g), *Bt = static_cast<const T*>(beta);
  T* O = static_cast<T*>(out);
  if (chunks <= 1) residual_layernorm<TI, T, 1><<<grid, 256, 0, st>>>(A, R, G, Bt, O, out32, M, D);
  else if (chunks <= 2) residual_layernorm<TI, T, 2><<<grid, 256, 0, st>>>(A, R, G, Bt, O, out32, M, D);
  else if (chunks <= 4) residual_layernorm<TI, T, 4><<<grid, 256, 0, st>>>(A, R, G, Bt, O, out32, M, D);
  else residual_layernorm<TI, T, 8><<<grid, 256, 0, st>>>(A, R, G, Bt, O, out32, M, D);
  return cudaSuccess;
}

// DiT's adaptive LayerNorm (AdaLN-Zero, Peebles & Xie 2022), a row kernel
// of residual_layernorm's design: per row of x [M, D], M = B * S, of sample
// b = row / S,
//
//   x' = x + gate[b] * y                          (RES: the gated residual)
//   h  = LN(x') * (1 + scale[b]) + shift[b]       (LayerNorm without affine)
//
// gate, shift and scale are f32 rows [B, ld] of the stacked modulation
// product (models/mdm.py), each pointer at its own column block. x, y, x'
// and h are T; x' is rounded to T, the LayerNorm reads the f32 sum. No TPU
// kernel has it: DiT is no configuration of the JAX package. It fuses what
// DiT runs as four elementwise passes and a LayerNorm, so a row is read and
// written once: bound by bytes (8 a bf16 value with the residual, 4
// without), which the warp-per-row layout moves in 16-byte loads. The
// variance is two-pass, from the values held in registers.
template <typename T, int CH, bool RES>
__global__ void __launch_bounds__(256)
adaln_modulate(const T* __restrict__ x, const T* __restrict__ y, const float* __restrict__ gate,
               const float* __restrict__ shift, const float* __restrict__ scale, int ld,
               T* __restrict__ x_out, T* __restrict__ h, int M, int S, int D, float eps) {
  constexpr int V = 16 / sizeof(T);  // values per chunk
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D, mod = (size_t)(row / S) * ld;
  // the row's f32 sum at col; the first time (store) it also writes x'
  auto load_sum = [&](int col, float* s, bool store) {
    load_n<V>(x + off + col, s);
    if constexpr (RES) {
      float yv[V], g[V];
      load_n<V>(y + off + col, yv);
      load_n<V>(gate + mod + col, g);
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] += g[i] * yv[i];
      if (store) store_n<V>(x_out + off + col, s);
    }
  };
  float s[CH][V];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < D) {
      load_sum(col, s[c], true);
#pragma unroll
      for (int i = 0; i < V; ++i) sum += s[c][i];
    }
  }
  for (int col = (lane + 32 * CH) * V; col < D; col += 32 * V) {
    float t[V];
    load_sum(col, t, true);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += t[i];
  }
  const float mu = warp_sum(sum) / D;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < D) {
#pragma unroll
      for (int i = 0; i < V; ++i) sq += (s[c][i] - mu) * (s[c][i] - mu);
    }
  }
  for (int col = (lane + 32 * CH) * V; col < D; col += 32 * V) {
    float t[V];
    load_sum(col, t, false);
#pragma unroll
    for (int i = 0; i < V; ++i) sq += (t[i] - mu) * (t[i] - mu);
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  auto modulate = [&](const float* v, int col) {
    float sh[V], sc[V], o[V];
    load_n<V>(shift + mod + col, sh);
    load_n<V>(scale + mod + col, sc);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (v[i] - mu) * rstd * (1.0f + sc[i]) + sh[i];
    store_n<V>(h + off + col, o);
  };
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < D) modulate(s[c], col);
  }
  for (int col = (lane + 32 * CH) * V; col < D; col += 32 * V) {
    float t[V];
    load_sum(col, t, false);
    modulate(t, col);
  }
}

template <typename T, int CH>
void launch_adaln(bool res, const void* x, const void* y, const float* gate, const float* shift,
                  const float* scale, int ld, void* x_out, void* h, int M, int S, int D,
                  float eps, cudaStream_t st) {
  const dim3 grid((M + 7) / 8);
  const T *X = static_cast<const T*>(x), *Y = static_cast<const T*>(y);
  T *XO = static_cast<T*>(x_out), *H = static_cast<T*>(h);
  if (res)
    adaln_modulate<T, CH, true><<<grid, 256, 0, st>>>(X, Y, gate, shift, scale, ld, XO, H, M, S, D, eps);
  else
    adaln_modulate<T, CH, false><<<grid, 256, 0, st>>>(X, Y, gate, shift, scale, ld, XO, H, M, S, D, eps);
}

// The instance whose CH chunks per lane cover D (as launch_layernorm's).
template <typename T>
void dispatch_adaln(bool res, const void* x, const void* y, const float* gate,
                    const float* shift, const float* scale, int ld, void* x_out, void* h, int M,
                    int S, int D, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = (D / V + 31) / 32;
  if (chunks <= 1) launch_adaln<T, 1>(res, x, y, gate, shift, scale, ld, x_out, h, M, S, D, eps, st);
  else if (chunks <= 2) launch_adaln<T, 2>(res, x, y, gate, shift, scale, ld, x_out, h, M, S, D, eps, st);
  else if (chunks <= 4) launch_adaln<T, 4>(res, x, y, gate, shift, scale, ld, x_out, h, M, S, D, eps, st);
  else launch_adaln<T, 8>(res, x, y, gate, shift, scale, ld, x_out, h, M, S, D, eps, st);
}

}  // namespace

extern "C" const char* mdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (g, beta, out). inputs_f32: a and r are
// float32 (LN2's y32 + o); otherwise they are dtype. Rows of D values, D a
// multiple of 8 (read once up to 2048 for bf16 inputs or 1024 for f32);
// pointers 16-byte aligned.
extern "C" int mdm_residual_layernorm(const void* a, const void* r, const void* g,
                                      const void* beta, void* out, void* out32, int M,
                                      int D, int dtype, int inputs_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  float* o32 = static_cast<float*>(out32);
  cudaError_t e;
  if (dtype == 0)
    e = launch_layernorm<float, float>(a, r, g, beta, out, o32, M, D, st);
  else if (dtype == 1 && inputs_f32)
    e = launch_layernorm<float, bf16>(a, r, g, beta, out, o32, M, D, st);
  else if (dtype == 1)
    e = launch_layernorm<bf16, bf16>(a, r, g, beta, out, o32, M, D, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// DiT's adaptive LayerNorm (adaln_modulate above): x [M, D], y [M, D] (or
// null: the LayerNorm and the modulation alone, x_out unused), x_out and h
// [M, D], all of dtype (0 = float32, 1 = bfloat16); gate (with y), shift and
// scale f32, the row of sample b at + b * ld, M = B * S. D a multiple of 8,
// ld of 4; every pointer 16-byte aligned.
extern "C" int mdm_adaln_modulate(const void* x, const void* y, const void* gate,
                                  const void* shift, const void* scale, int ld, void* x_out,
                                  void* h, int M, int S, int D, float eps, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = y != nullptr;
  if (M <= 0 || S <= 0 || M % S || D <= 0 || D % 8 || ld < D || ld % 4 || !shift || !scale ||
      !h || (res && (!gate || !x_out)) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const float *g = static_cast<const float*>(gate), *sh = static_cast<const float*>(shift),
              *sc = static_cast<const float*>(scale);
  if (dtype == 0)
    dispatch_adaln<float>(res, x, y, g, sh, sc, ld, x_out, h, M, S, D, eps, st);
  else
    dispatch_adaln<bf16>(res, x, y, g, sh, sc, ld, x_out, h, M, S, D, eps, st);
  return (int)cudaGetLastError();
}
