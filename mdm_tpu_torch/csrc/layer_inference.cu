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
//   gemm_bias_act        qkv  = x . Wqkv^T + b                 (dt)
//   attention_rowmask    ctx  = softmax(q k^T / sqrt(Dh) + m) v (dt)
//   gemm_bias_act        attn = ctx . Wo^T + bo                 (dt)
//   residual_layernorm   y    = LN1(x + attn)                   (dt and f32)
//   gemm_bias_act        h    = gelu(y . W1^T + b1)             (dt)
//   gemm_bias_act        o    = h . W2^T + b2                   (f32)
//   residual_layernorm   z    = LN2(y32 + o)                    (dt)
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLnEps = 1e-5f;
constexpr float kInvSqrt2 = 0.70710678118654752f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu_exact(float u) {
  return u * 0.5f * (1.0f + erff(u * kInvSqrt2));
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

// ---------------------------------------------------------------- GEMM, bf16
// C[M,N] = act(A[M,K] . W[N,K]^T + bias[N]); A, W, bias bf16, f32 accumulate.
// Block tile 128x64x32, 8 warps in a 4x2 grid, each warp 32x32 (2x2 WMMA
// 16x16x16 fragments). Requires K % 8 == 0 (16-byte rows); M, N and K are
// otherwise ragged and masked here.
constexpr int GB_M = 128, GB_N = 64, GB_K = 32;
constexpr int G_LDS = GB_K + 8;  // bf16 per shared row: keeps 32-byte fragment alignment
constexpr int G_LDC = GB_N + 4;  // f32 per staging row
constexpr int G_THREADS = 256;
constexpr int G_SMEM_AB = 2 * (GB_M + GB_N) * G_LDS * 2;
constexpr int G_SMEM_C = GB_M * G_LDC * 4;
constexpr int G_SMEM = G_SMEM_AB > G_SMEM_C ? G_SMEM_AB : G_SMEM_C;

template <typename TO, bool GELU>
__global__ void __launch_bounds__(G_THREADS)
gemm_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const bf16* __restrict__ bias, TO* __restrict__ C, int M, int N,
               int K) {
  __shared__ __align__(128) unsigned char smem[G_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [2][GB_M][G_LDS]
  bf16* Bs = As + 2 * GB_M * G_LDS;                // [2][GB_N][G_LDS]
  float* Cs = reinterpret_cast<float*>(smem);      // [GB_M][G_LDC], after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * GB_M * G_LDS;
    bf16* bs = Bs + stage * GB_N * G_LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 vectors of 8
      int v = tid + i * G_THREADS;
      int r = v >> 2, c = (v & 3) * 8;
      int gr = m0 + r, gc = k0 + c;
      bool ok = gr < M && gc < K;
      cp_async16(as + r * G_LDS + c, ok ? A + (size_t)gr * K + gc : A, ok ? 16 : 0);
    }
    {  // W: 64 rows x 4 vectors of 8
      int r = tid >> 2, c = (tid & 3) * 8;
      int gr = n0 + r, gc = k0 + c;
      bool ok = gr < N && gc < K;
      cp_async16(bs + r * G_LDS + c, ok ? W + (size_t)gr * K + gc : W, ok ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + GB_K - 1) / GB_K;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) & 1, (kt + 1) * GB_K);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As + (kt & 1) * GB_M * G_LDS;
    const bf16* bs = Bs + (kt & 1) * GB_N * G_LDS;
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * G_LDS + kk, G_LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * G_LDC + wn * 32 + j * 16,
                              acc[i][j], G_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < GB_M * GB_N; idx += G_THREADS) {
    int r = idx / GB_N, c = idx % GB_N;
    int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = Cs[r * G_LDC + c] + to_f(bias[gc]);
      if (GELU) v = gelu_exact(v);
      C[(size_t)gr * N + gc] = from_f<TO>(v);
    }
  }
}

// ----------------------------------------------------------------- GEMM, f32
// The float32 path (compute_dtype="float32"): plain FMA, 64x64x16 tiles,
// 256 threads with a 4x4 register block each. Fully ragged.
constexpr int FB_M = 64, FB_N = 64, FB_K = 16;

template <bool GELU>
__global__ void __launch_bounds__(256)
gemm_f32_fma(const float* __restrict__ A, const float* __restrict__ W,
             const float* __restrict__ bias, float* __restrict__ C, int M, int N,
             int K) {
  __shared__ float As[FB_K][FB_M + 4];
  __shared__ float Ws[FB_K][FB_N + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FB_M, n0 = blockIdx.x * FB_N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FB_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int v = tid + i * 256;
      int r = v / FB_K, c = v % FB_K;
      int gk = k0 + c;
      As[c][r] = (m0 + r < M && gk < K) ? A[(size_t)(m0 + r) * K + gk] : 0.0f;
      Ws[c][r] = (n0 + r < N && gk < K) ? W[(size_t)(n0 + r) * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FB_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = n0 + tx * 4 + j;
      if (gc < N) {
        float v = acc[i][j] + bias[gc];
        if (GELU) v = gelu_exact(v);
        C[(size_t)gr * N + gc] = v;
      }
    }
  }
}

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
  const float rstd = rsqrtf(var + kLnEps);
  for (int c = lane; c < D; c += 32) {
    float s = to_f(a[off + c]) + to_f(r[off + c]);
    float v = (s - mu) * rstd * to_f(g[c]) + to_f(beta[c]);
    out[off + c] = from_f<T>(v);
    if (out32) out32[off + c] = v;
  }
}

template <typename TO, bool GELU>
void launch_gemm_bf16(const void* a, const void* w, const void* bias, void* c, int M,
                      int N, int K, cudaStream_t st) {
  dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
  gemm_bf16_wmma<TO, GELU><<<grid, G_THREADS, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<TO*>(c), M, N, K);
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
extern "C" int mdm_gemm_bias_act(const void* a, const void* w, const void* bias, void* c,
                                 int M, int N, int K, int dtype, int out_f32, int gelu,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    dim3 grid((N + FB_N - 1) / FB_N, (M + FB_M - 1) / FB_M);
    const float* A = static_cast<const float*>(a);
    const float* Wp = static_cast<const float*>(w);
    const float* bp = static_cast<const float*>(bias);
    float* Cp = static_cast<float*>(c);
    if (gelu)
      gemm_f32_fma<true><<<grid, 256, 0, st>>>(A, Wp, bp, Cp, M, N, K);
    else
      gemm_f32_fma<false><<<grid, 256, 0, st>>>(A, Wp, bp, Cp, M, N, K);
  } else if (dtype == 1) {
    if (K % 8 != 0) return (int)cudaErrorInvalidValue;
    if (out_f32) {
      if (gelu) launch_gemm_bf16<float, true>(a, w, bias, c, M, N, K, st);
      else launch_gemm_bf16<float, false>(a, w, bias, c, M, N, K, st);
    } else {
      if (gelu) launch_gemm_bf16<bf16, true>(a, w, bias, c, M, N, K, st);
      else launch_gemm_bf16<bf16, false>(a, w, bias, c, M, N, K, st);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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
