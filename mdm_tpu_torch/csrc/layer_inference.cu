// Hand-written Hopper kernels for one post-LN transformer encoder layer,
// forward only. Together they replace the Pallas whole-layer kernel
// mdm_tpu/ops/layer_inference.py::fused_layer_inference (_layer_kernel).
//
// The TPU kernel runs one program per batch cell with every layer weight
// resident in VMEM. A flagship layer (D=512, F=1024) holds ~4.2 MB of bf16
// weights, far more than an SM's 227 KB of shared memory, so the layer runs
// here as a short chain of kernels that pass activations through device
// memory (L2 at these sizes):
//
//   gemm (gemm.cu)       qkv  = x . Wqkv^T + b                 (dt)
//   attention_rowmask    ctx  = softmax(q k^T / sqrt(Dh) + m) v (dt)
//   gemm                 attn = ctx . Wo^T + bo                 (dt)
//   residual_layernorm   y    = LN1(x + attn)                   (dt and f32)
//   gemm, GELU epilogue  h    = gelu(y . W1^T + b1)             (dt)
//   gemm                 o    = h . W2^T + b2                   (f32)
//   residual_layernorm   z    = LN2(y32 + o)                    (dt)
//
// The products are gemm.cu's, shared with the training chains; this file
// holds the layer's attention and residual LayerNorm.
//
// Precision contract (the TPU kernel's): products accumulate in f32; values
// are rounded to the working type dt only at q/k/v, P, ctx, attn, y, the
// GELU output and z. y32 and o stay f32, so LN2 sees the same residual sum.
// LayerNorm variance is one-pass, E[s^2] - E[s]^2, with eps 1e-5.
//
// Bounds on this card: at the CFG batch (B=64, S=197) the four GEMMs carry
// ~90% of the FLOPs, so the chain is bound by tensor-core throughput; the
// bf16 GEMMs run WMMA tensor-core fragments with f32 accumulators on
// double-buffered cp.async tiles, and the attention runs Q.K^T and P.V on
// WMMA fragments too. At serving batch 1 the
// work per layer is a few microseconds and the chain is bound by its seven
// launches per layer; every launch is asynchronous on the caller's stream,
// allocates nothing and never synchronises, so the host can run ahead.
//
// Every entry point has a plain C interface (bound with ctypes) and returns
// cudaGetLastError() right after its launch.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using mdm::bf16;
using mdm::cp_async16;
using mdm::cp_async_commit;
using mdm::cp_async_wait;
using mdm::from_f;
using mdm::to_f;
using mdm::warp_max;
using mdm::warp_sum;

namespace {

// ------------------------------------------------------ attention, bf16 WMMA
// qkv [B*S, 3D] (q | k | v, head h at columns h*DH), mask [B, S] additive f32
// or null, ctx [B*S, D]. One block per (64-query tile, head, batch), 4 warps
// of 16 query rows each. Two passes over the key tiles: the first finds each
// row's max and exp-sum, the second forms the normalised P, rounds it to
// bf16 as the TPU kernel does, and accumulates P.V in f32. Keys past S are
// skipped (the TPU wrapper's -1e9 padding contributes exp(..) == 0 there).
constexpr int AT_Q = 64, AT_K = 64, AT_THREADS = 128;
constexpr int AT_LDS = AT_K + 4;  // f32 scores row
constexpr int AT_LDP = AT_K + 8;  // bf16 P row

template <int DH>
struct AttnSmem {
  static constexpr int LD = DH + 8;   // bf16 q/k/v row
  static constexpr int LDO = DH + 4;  // f32 ctx staging row
  static constexpr int Q = 0;
  static constexpr int K = Q + AT_Q * LD * 2;
  static constexpr int V = K + AT_K * LD * 2;
  static constexpr int S = V + AT_K * LD * 2;
  static constexpr int P = S + AT_Q * AT_LDS * 4;
  static constexpr int BYTES = P + AT_Q * AT_LDP * 2;
  static_assert(AT_Q * LDO * 4 <= S - K, "ctx staging must fit over K and V");
};

template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attention_bf16_wmma(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                    bf16* __restrict__ ctx, int S, int H, float scale) {
  using L = AttnSmem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::K);  // after the last tile

  const int D = H * DH, ld = 3 * D;
  const int q0 = blockIdx.x * AT_Q, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + (size_t)b * S * ld;
  const float* mrow = mask ? mask + (size_t)b * S : nullptr;
  constexpr int VPR = DH / 8;  // 16-byte vectors per row

  auto load_rows = [&](bf16* dst, int row0, int col0) {
    for (int v = tid; v < 64 * VPR; v += AT_THREADS) {
      int r = v / VPR, c = (v % VPR) * 8;
      int s = row0 + r;
      bool ok = s < S;
      cp_async16(dst + r * L::LD + c, ok ? base + (size_t)s * ld + col0 + c : base,
                 ok ? 16 : 0);
    }
  };
  // Scores of this warp's 16 query rows against the 64 keys in Ks -> Ss.
  auto scores = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[AT_K / 16];
#pragma unroll
    for (int j = 0; j < AT_K / 16; ++j) wmma::fill_fragment(sacc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Qs + warp * 16 * L::LD + kk, L::LD);
#pragma unroll
      for (int j = 0; j < AT_K / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Ks + j * 16 * L::LD + kk, L::LD);
        wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < AT_K / 16; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * AT_LDS + j * 16, sacc[j], AT_LDS,
                              wmma::mem_row_major);
    __syncwarp();
  };
  auto logit = [&](int r, int c, int k0) {
    int j = k0 + c;
    if (j >= S) return -INFINITY;
    float v = Ss[(warp * 16 + r) * AT_LDS + c] * scale;
    return mrow ? v + mrow[j] : v;
  };

  load_rows(Qs, q0, h * DH);
  cp_async_commit();

  // Pass 1: row max and exp-sum (lane-replicated, 16 rows per warp).
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < S; k0 += AT_K) {
    load_rows(Ks, k0, D + h * DH);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float a = logit(r, lane, k0), c = logit(r, lane + 32, k0);
      float mn = fmaxf(m[r], warp_max(fmaxf(a, c)));
      float e = warp_sum(expf(a - mn) + expf(c - mn));
      l[r] = l[r] * expf(m[r] - mn) + e;
      m[r] = mn;
    }
    __syncthreads();
  }

  // Pass 2: P = exp(s - m) / l rounded to bf16, ctx += P . V in f32.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  for (int k0 = 0; k0 < S; k0 += AT_K) {
    load_rows(Ks, k0, D + h * DH);
    load_rows(Vs, k0, 2 * D + h * DH);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int c = lane + 32 * half;
        float p = k0 + c < S ? expf(logit(r, c, k0) - m[r]) / l[r] : 0.0f;
        Ps[(warp * 16 + r) * AT_LDP + c] = __float2bfloat16_rn(p);
      }
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < AT_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, Ps + warp * 16 * AT_LDP + kk, AT_LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + kk * L::LD + j * 16, L::LD);
        wmma::mma_sync(oacc[j], fp, fv, oacc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * L::LDO + j * 16, oacc[j], L::LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < AT_Q * DH; v += AT_THREADS) {
    int r = v / DH, c = v % DH;
    int s = q0 + r;
    if (s < S)
      ctx[((size_t)b * S + s) * D + h * DH + c] = __float2bfloat16_rn(Os[r * L::LDO + c]);
  }
}

// ---------------------------------------------------------- attention, f32
// The float32 path: one block per (query, head, batch). Logits for the whole
// key row live in shared memory; exact two-pass softmax.
constexpr int AS_THREADS = 128;

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < AS_THREADS / 32 ? red[lane] : (is_max ? -INFINITY : 0.0f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  float out = red[32];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(AS_THREADS)
attention_f32_rowwise(const float* __restrict__ qkv, const float* __restrict__ mask,
                      float* __restrict__ ctx, int S, int H, int DH, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;          // [DH]
  float* ps = sm + DH;     // [S]
  __shared__ float red[33];
  const int D = H * DH, ld = 3 * D;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float* base = qkv + (size_t)b * S * ld;
  for (int d = threadIdx.x; d < DH; d += AS_THREADS) qs[d] = base[(size_t)s * ld + h * DH + d];
  __syncthreads();
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < S; j += AS_THREADS) {
    const float* kr = base + (size_t)j * ld + D + h * DH;
    float acc = 0.0f;
    for (int d = 0; d < DH; ++d) acc = fmaf(qs[d], kr[d], acc);
    float v = acc * scale + (mask ? mask[(size_t)b * S + j] : 0.0f);
    ps[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.0f;
  for (int j = threadIdx.x; j < S; j += AS_THREADS) {
    float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int j = threadIdx.x; j < S; j += AS_THREADS) ps[j] = ps[j] / sum;
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += AS_THREADS) {
    float acc = 0.0f;
    for (int j = 0; j < S; ++j)
      acc = fmaf(ps[j], base[(size_t)j * ld + 2 * D + h * DH + d], acc);
    ctx[((size_t)b * S + s) * D + h * DH + d] = acc;
  }
}

// ------------------------------------------------------- residual + LayerNorm
// out = LN(a + r) * g + beta per row, one warp per row, statistics in f32.
// out32 (optional) receives the f32 result before rounding to T.
template <typename TI, typename T>
__global__ void __launch_bounds__(256)
residual_layernorm(const TI* __restrict__ a, const TI* __restrict__ r,
                   const T* __restrict__ g, const T* __restrict__ beta,
                   T* __restrict__ out, float* __restrict__ out32, int M, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < D; c += 32) {
    float s = to_f(a[off + c]) + to_f(r[off + c]);
    sum += s;
    sq += s * s;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / D;
  const float var = sq / D - mu * mu;
  const float rstd = rsqrtf(var + mdm::kLnEps);
  for (int c = lane; c < D; c += 32) {
    float s = to_f(a[off + c]) + to_f(r[off + c]);
    float v = (s - mu) * rstd * to_f(g[c]) + to_f(beta[c]);
    out[off + c] = from_f<T>(v);
    if (out32) out32[off + c] = v;
  }
}

template <int DH>
cudaError_t launch_attention_bf16(const void* qkv, const float* mask, void* ctx,
                                  int B, int S, int H, float scale, cudaStream_t st) {
  constexpr int bytes = AttnSmem<DH>::BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_bf16_wmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((S + AT_Q - 1) / AT_Q, H, B);
  attention_bf16_wmma<DH><<<grid, AT_THREADS, bytes, st>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(ctx), S, H, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* mdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers.
extern "C" int mdm_attention_rowmask(const void* qkv, const void* mask, void* ctx, int B,
                                     int S, int H, int Dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float scale = (float)(1.0 / sqrt((double)Dh));  // np.float32(1 / sqrt(Dh))
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    cudaError_t e;
    switch (Dh) {
      case 32: e = launch_attention_bf16<32>(qkv, m, ctx, B, S, H, scale, st); break;
      case 64: e = launch_attention_bf16<64>(qkv, m, ctx, B, S, H, scale, st); break;
      case 128: e = launch_attention_bf16<128>(qkv, m, ctx, B, S, H, scale, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == 0) {
    size_t bytes = (size_t)(Dh + S) * sizeof(float);
    if (Dh > 128 || bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    dim3 grid(S, H, B);
    attention_f32_rowwise<<<grid, AS_THREADS, bytes, st>>>(
        static_cast<const float*>(qkv), m, static_cast<float*>(ctx), S, H, Dh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// inputs_f32: a and r are float32 (LN2's y32 + o); otherwise they are dtype.
extern "C" int mdm_residual_layernorm(const void* a, const void* r, const void* g,
                                      const void* beta, void* out, void* out32, int M,
                                      int D, int dtype, int inputs_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + 7) / 8);
  float* o32 = static_cast<float*>(out32);
  if (dtype == 0) {
    residual_layernorm<float, float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(r),
        static_cast<const float*>(g), static_cast<const float*>(beta),
        static_cast<float*>(out), o32, M, D);
  } else if (dtype == 1 && inputs_f32) {
    residual_layernorm<float, bf16><<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(r),
        static_cast<const bf16*>(g), static_cast<const bf16*>(beta),
        static_cast<bf16*>(out), o32, M, D);
  } else if (dtype == 1) {
    residual_layernorm<bf16, bf16><<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(r),
        static_cast<const bf16*>(g), static_cast<const bf16*>(beta),
        static_cast<bf16*>(out), o32, M, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
