// Attention with probability dropout, forward and backward: the attention
// core of the training attention block. With the projections (gemm.cu) it
// replaces the TPU kernels mdm_tpu/ops/attention_train_block.py::_fwd_kernel
// (pallas_call at :286,294) and ::_bwd_kernel (:334,344).
//
// qkv [B*S, 3D] (q | k | v, head h at columns h*Dh), mask [B, S] additive
// f32 or null, ctx [B*S, D]. Per head, at the TPU kernel's rounding points:
//   p   = softmax(q k^T / sqrt(Dh) + mask)              f32
//   w   = keep ? p * inv_keep : 0, rounded to dt        (the dropout)
//   ctx = w . v, rounded to dt
// Backward, from dctx (dt) and the recomputed p and keep mask:
//   dv  = w^T . dctx (dt);  dw = dctx . v^T (f32);  dp = keep * dw
//   dlog = p * (dp - rowsum(dp * p)) / sqrt(Dh), rounded to dt
//   dq  = dlog . k (dt);  dk = dlog^T . q (dt);  ctx recomputed for dWo
// Nothing quadratic in S is stored: the backward recomputes p and replays
// the bits (philox.cuh), keyed on (key column, query row, head, batch).
//
// The TPU kernel holds a whole [S, S] head in VMEM per batch cell. Here a
// block owns a 64-row tile and walks the other axis in 64-wide tiles:
// - forward: per query tile, pass 1 finds each row's max and exp-sum,
//   pass 2 forms the normalised p, drops, rounds and accumulates w . v
//   (a flash-style online rescale would round w before normalising);
// - backward dq kernel: per query tile, the same two passes plus dw and the
//   row sums delta in pass 2, then pass 3 forms dlog and dq; it writes ctx,
//   dq and the row statistics (max, sum, delta);
// - backward dkv kernel: per key tile, walks the query tiles with those
//   statistics and accumulates dk and dv in registers, so no float atomics.
// The bf16 path runs WMMA 16x16x16 fragments (4 warps, 16 rows each); the
// f32 path is scalar FMA, one block per row. Bound on an H100 at the
// flagship shape (S=197, Dh=128): tensor-core throughput of the products,
// with the exp and Philox work per element beside it.

#include <mma.h>

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

using namespace nvcuda;
using mdm::bf16;
using mdm::Dropout;

namespace {

constexpr int AT = 64, AT_THREADS = 128;
constexpr int LDS = AT + 4;  // f32 score row
constexpr int LDP = AT + 8;  // bf16 probability row

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

// Shared-memory layout: four [64][DH+8] bf16 row tiles, two f32 [64][68]
// score tiles and two bf16 [64][72] probability tiles, 16-byte aligned.
template <int DH>
struct Smem {
  static constexpr int LD = DH + 8;
  static constexpr int LDO = DH + 4;  // f32 output staging row
  static constexpr int T0 = 0;
  static constexpr int T1 = T0 + AT * LD * 2;
  static constexpr int T2 = T1 + AT * LD * 2;
  static constexpr int T3 = T2 + AT * LD * 2;
  static constexpr int S0 = T3 + AT * LD * 2;
  static constexpr int S1 = S0 + AT * LDS * 4;
  static constexpr int P0 = S1 + AT * LDS * 4;
  static constexpr int P1 = P0 + AT * LDP * 2;
  static constexpr int ST = P1 + AT * LDP * 2;  // three [64] f32 statistics rows
  static constexpr int BYTES = ST + 3 * AT * 4;
  static_assert(AT * LDO * 4 <= 2 * AT * LD * 2, "output staging must fit over two tiles");
};

struct Attn {
  const bf16* qkv;
  const float* mask;
  int S, H;
  float scale;
  Dropout drop;
};

// Rows [row0, row0+64) of the columns [col0, col0+DH) of qkv (or of a
// [B*S, ld] tensor) of batch b into a [64][LD] tile; rows past S are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int ld, int row0,
                                          int col0, int S) {
  constexpr int VPR = DH / 8;
  for (int v = threadIdx.x; v < AT * VPR; v += AT_THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const int s = row0 + r;
    const bool ok = s < S;
    mdm::cp_async16(dst + r * Smem<DH>::LD + c, ok ? base + (size_t)s * ld + col0 + c : base,
                    ok ? 16 : 0);
  }
}

// This warp's 16 rows of a . b^T over DH (a, b: [64][LD] tiles) -> f32 [16][LDS].
template <int DH>
__device__ __forceinline__ void rows_dot(float* out, const bf16* a, const bf16* b) {
  constexpr int LD = Smem<DH>::LD;
  const int warp = threadIdx.x >> 5;
  Acc acc[AT / 16];
#pragma unroll
  for (int j = 0; j < AT / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * LD + kk, LD);
#pragma unroll
    for (int j = 0; j < AT / 16; ++j) {
      FragBc fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < AT / 16; ++j)
    wmma::store_matrix_sync(out + warp * 16 * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
}

// acc[DH/16] += this warp's 16 rows of p (bf16 [64][LDP]) . t ([64][LD] tile).
template <int DH>
__device__ __forceinline__ void rows_pv(Acc* acc, const bf16* p, const bf16* t) {
  constexpr int LD = Smem<DH>::LD;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < AT; kk += 16) {
    FragA fp;
    wmma::load_matrix_sync(fp, p + warp * 16 * LDP + kk, LDP);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragBr fv;
      wmma::load_matrix_sync(fv, t + kk * LD + j * 16, LD);
      wmma::mma_sync(acc[j], fp, fv, acc[j]);
    }
  }
}

// Store this block's 64 x DH accumulators (each warp its 16 rows) to
// out[(b*S + row0 + r) * ld + col0 + c] in bf16, rows past S skipped.
template <int DH>
__device__ __forceinline__ void store_rows(Acc* acc, float* stage, bf16* out, int ld,
                                           size_t row_base, int row0, int col0, int S) {
  constexpr int LDO = Smem<DH>::LDO;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int v = threadIdx.x; v < AT * DH; v += AT_THREADS) {
    const int r = v / DH, c = v % DH;
    if (row0 + r < S)
      out[(row_base + row0 + r) * ld + col0 + c] = __float2bfloat16_rn(stage[r * LDO + c]);
  }
  __syncthreads();
}

// Pass 1 over the key tiles: each row's max m and exp-sum l of the logits
// (lane-replicated, 16 rows per warp).
template <int DH>
__device__ __forceinline__ void row_stats(const Attn& a, const bf16* base, int h, const float* mrow,
                                          bf16* Qs, bf16* Ks, float* Ss, float* m, float* l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.H * DH;
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < a.S; k0 += AT) {
    load_rows<DH>(Ks, base, 3 * D, k0, D + h * DH, a.S);
    mdm::cp_async_commit();
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(Ss, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float x[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = k0 + lane + 32 * hf;
        x[hf] = j < a.S ? Ss[(warp * 16 + r) * LDS + lane + 32 * hf] * a.scale +
                              (mrow ? mrow[j] : 0.0f)
                        : -INFINITY;
      }
      const float mn = fmaxf(m[r], mdm::warp_max(fmaxf(x[0], x[1])));
      const float e = mdm::warp_sum(expf(x[0] - mn) + expf(x[1] - mn));
      l[r] = l[r] * expf(m[r] - mn) + e;
      m[r] = mn;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- forward, bf16
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_fwd_bf16(Attn a, bf16* __restrict__ ctx) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T2);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P0);
  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, D = a.H * DH;
  const bf16* base = a.qkv + (size_t)b * S * 3 * D;
  const float* mrow = a.mask ? a.mask + (size_t)b * S : nullptr;

  load_rows<DH>(Qs, base, 3 * D, q0, h * DH, S);
  mdm::cp_async_commit();
  float m[16], l[16];
  row_stats<DH>(a, base, h, mrow, Qs, Ks, Ss, m, l);

  Acc acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, base, 3 * D, k0, D + h * DH, S);
    load_rows<DH>(Vs, base, 3 * D, k0, 2 * D + h * DH, S);
    mdm::cp_async_commit();
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(Ss, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = q0 + warp * 16 + r;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf, j = k0 + c;
        float w = 0.0f;
        if (j < S && i < S) {
          const float x = Ss[(warp * 16 + r) * LDS + c] * a.scale + (mrow ? mrow[j] : 0.0f);
          const float p = expf(x - m[r]) / l[r];
          w = p * a.drop.keep((((size_t)b * a.H + h) * S + i) * S + j, b, h, i, j);
        }
        Ps[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(w);
      }
    }
    __syncwarp();
    rows_pv<DH>(acc, Ps, Vs);
    __syncthreads();
  }
  store_rows<DH>(acc, reinterpret_cast<float*>(smem + L::T1), ctx, D, (size_t)b * S, q0, h * DH, S);
}

// --------------------------------------------------- backward, dq side, bf16
// Per query tile: ctx (recomputed), dq, and the row statistics m, l, delta
// into stats[3][B*H*S] for the dkv kernel.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dq_bf16(Attn a, const bf16* __restrict__ dctx, bf16* __restrict__ ctx,
                 bf16* __restrict__ dqkv, float* __restrict__ stats, int B) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::T1);  // dctx rows
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T3);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  float* Ds = reinterpret_cast<float*>(smem + L::S1);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P0);
  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, D = a.H * DH;
  const bf16* base = a.qkv + (size_t)b * S * 3 * D;
  const float* mrow = a.mask ? a.mask + (size_t)b * S : nullptr;

  load_rows<DH>(Qs, base, 3 * D, q0, h * DH, S);
  load_rows<DH>(Cs, dctx + (size_t)b * S * D, D, q0, h * DH, S);
  mdm::cp_async_commit();
  float m[16], l[16], delta[16];
  row_stats<DH>(a, base, h, mrow, Qs, Ks, Ss, m, l);

  // p, keep and dw of element (row r of this warp, column c) of key tile k0.
  auto element = [&](int r, int c, int k0, float& p, float& kf) {
    const int i = q0 + warp * 16 + r, j = k0 + c;
    p = 0.0f;
    kf = 0.0f;
    if (i < S && j < S) {
      const float x = Ss[(warp * 16 + r) * LDS + c] * a.scale + (mrow ? mrow[j] : 0.0f);
      p = expf(x - m[r]) / l[r];
      kf = a.drop.keep((((size_t)b * a.H + h) * S + i) * S + j, b, h, i, j);
    }
  };

  // Pass 2: ctx = w . v and delta = rowsum(dp * p).
  Acc acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int r = 0; r < 16; ++r) delta[r] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, base, 3 * D, k0, D + h * DH, S);
    load_rows<DH>(Vs, base, 3 * D, k0, 2 * D + h * DH, S);
    mdm::cp_async_commit();
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(Ss, Qs, Ks);
    rows_dot<DH>(Ds, Cs, Vs);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf;
        float p, kf;
        element(r, c, k0, p, kf);
        Ps[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(p * kf);
        delta[r] += (kf * Ds[(warp * 16 + r) * LDS + c]) * p;
      }
    }
    __syncwarp();
    rows_pv<DH>(acc, Ps, Vs);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) delta[r] = mdm::warp_sum(delta[r]);
  store_rows<DH>(acc, reinterpret_cast<float*>(smem + L::S0), ctx, D, (size_t)b * S, q0, h * DH, S);

  // Pass 3: dlog and dq = dlog . k.
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, base, 3 * D, k0, D + h * DH, S);
    load_rows<DH>(Vs, base, 3 * D, k0, 2 * D + h * DH, S);
    mdm::cp_async_commit();
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(Ss, Qs, Ks);
    rows_dot<DH>(Ds, Cs, Vs);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf;
        float p, kf;
        element(r, c, k0, p, kf);
        const float dp = kf * Ds[(warp * 16 + r) * LDS + c];
        Ps[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(p * (dp - delta[r]) * a.scale);
      }
    }
    __syncwarp();
    rows_pv<DH>(acc, Ps, Ks);
    __syncthreads();
  }
  store_rows<DH>(acc, reinterpret_cast<float*>(smem + L::S0), dqkv, 3 * D, (size_t)b * S, q0,
                 h * DH, S);

  if (lane == 0) {
    const size_t n = (size_t)B * a.H * S;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = q0 + warp * 16 + r;
      if (i < S) {
        const size_t o = ((size_t)b * a.H + h) * S + i;
        stats[o] = m[r];
        stats[n + o] = l[r];
        stats[2 * n + o] = delta[r];
      }
    }
  }
}

// -------------------------------------------------- backward, dkv side, bf16
// Per key tile: walks every query tile with the saved row statistics and
// accumulates dv = w^T . dctx and dk = dlog^T . q in registers.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dkv_bf16(Attn a, const bf16* __restrict__ dctx, const float* __restrict__ stats,
                  bf16* __restrict__ dqkv, int B) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::T3);
  float* St = reinterpret_cast<float*>(smem + L::S0);  // [key][query] logits
  float* Dt = reinterpret_cast<float*>(smem + L::S1);  // [key][query] dw
  bf16* Wt = reinterpret_cast<bf16*>(smem + L::P0);
  bf16* Gt = reinterpret_cast<bf16*>(smem + L::P1);
  float* st = reinterpret_cast<float*>(smem + L::ST);  // m, l, delta of the query tile
  const int k0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, D = a.H * DH;
  const bf16* base = a.qkv + (size_t)b * S * 3 * D;
  const bf16* cbase = dctx + (size_t)b * S * D;
  const float* mrow = a.mask ? a.mask + (size_t)b * S : nullptr;
  const size_t n = (size_t)B * a.H * S;
  const float* srow = stats + ((size_t)b * a.H + h) * S;

  load_rows<DH>(Ks, base, 3 * D, k0, D + h * DH, S);
  load_rows<DH>(Vs, base, 3 * D, k0, 2 * D + h * DH, S);
  mdm::cp_async_commit();

  Acc dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.0f);
    wmma::fill_fragment(dv[j], 0.0f);
  }
  for (int q0 = 0; q0 < S; q0 += AT) {
    load_rows<DH>(Qs, base, 3 * D, q0, h * DH, S);
    load_rows<DH>(Cs, cbase, D, q0, h * DH, S);
    mdm::cp_async_commit();
    for (int v = threadIdx.x; v < 3 * AT; v += AT_THREADS) {
      const int which = v / AT, i = q0 + v % AT;
      st[v] = i < S ? srow[which * n + i] : (which == 1 ? 1.0f : 0.0f);
    }
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(St, Ks, Qs);
    rows_dot<DH>(Dt, Vs, Cs);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int j = k0 + warp * 16 + r;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = lane + 32 * hf, i = q0 + c;
        float w = 0.0f, g = 0.0f;
        if (i < S && j < S) {
          const float x = St[(warp * 16 + r) * LDS + c] * a.scale + (mrow ? mrow[j] : 0.0f);
          const float p = expf(x - st[c]) / st[AT + c];
          const float kf = a.drop.keep((((size_t)b * a.H + h) * S + i) * S + j, b, h, i, j);
          w = p * kf;
          const float dp = kf * Dt[(warp * 16 + r) * LDS + c];
          g = p * (dp - st[2 * AT + c]) * a.scale;
        }
        Wt[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(w);
        Gt[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(g);
      }
    }
    __syncwarp();
    rows_pv<DH>(dv, Wt, Cs);
    rows_pv<DH>(dk, Gt, Qs);
    __syncthreads();
  }
  float* stage = reinterpret_cast<float*>(smem + L::T2);
  store_rows<DH>(dk, stage, dqkv, 3 * D, (size_t)b * S, k0, D + h * DH, S);
  store_rows<DH>(dv, stage, dqkv, 3 * D, (size_t)b * S, k0, 2 * D + h * DH, S);
}

// ------------------------------------------------------------ float32 path
// One block per row; the row's S logits live in shared memory.
constexpr int AF_THREADS = 128;

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? mdm::warp_max(v) : mdm::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < AF_THREADS / 32 ? red[lane] : (is_max ? -INFINITY : 0.0f);
    w = is_max ? mdm::warp_max(w) : mdm::warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

struct AttnF {
  const float* qkv;
  const float* mask;
  int S, H, DH;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ float dotf(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Row (b, h, i): p_j into ps, returns nothing; m and l through the pointers.
__device__ void row_softmax_f32(const AttnF& a, const float* base, const float* qs, int b, int h,
                                float* ps, float* red, float* m_out, float* l_out) {
  const int D = a.H * a.DH, ld = 3 * D;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) {
    const float v = dotf(qs, base + (size_t)j * ld + D + h * a.DH, a.DH) * a.scale +
                    (a.mask ? a.mask[(size_t)b * a.S + j] : 0.0f);
    ps[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.0f;
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) ps[j] = ps[j] / sum;
  __syncthreads();
  *m_out = mx;
  *l_out = sum;
}

__global__ void __launch_bounds__(AF_THREADS)
attn_fwd_f32(AttnF a, float* __restrict__ ctx) {
  extern __shared__ float sm[];
  float* qs = sm;           // [DH]
  float* ps = sm + a.DH;    // [S]
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = a.H * a.DH, ld = 3 * D;
  const float* base = a.qkv + (size_t)b * a.S * ld;
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) qs[d] = base[(size_t)i * ld + h * a.DH + d];
  __syncthreads();
  float m, l;
  row_softmax_f32(a, base, qs, b, h, ps, red, &m, &l);
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS)
    ps[j] *= a.drop.keep((((size_t)b * a.H + h) * a.S + i) * a.S + j, b, h, i, j);
  __syncthreads();
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) {
    float acc = 0.0f;
    for (int j = 0; j < a.S; ++j) acc = fmaf(ps[j], base[(size_t)j * ld + 2 * D + h * a.DH + d], acc);
    ctx[((size_t)b * a.S + i) * D + h * a.DH + d] = acc;
  }
}

__global__ void __launch_bounds__(AF_THREADS)
attn_bwd_dq_f32(AttnF a, const float* __restrict__ dctx, float* __restrict__ ctx,
                float* __restrict__ dqkv, float* __restrict__ stats, int B) {
  extern __shared__ float sm[];
  float* qs = sm;                  // [DH]
  float* cs = qs + a.DH;           // [DH] dctx row
  float* ps = cs + a.DH;           // [S] p
  float* ws = ps + a.S;            // [S] w = p * keep
  float* gs = ws + a.S;            // [S] dp, then dlog
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = a.H * a.DH, ld = 3 * D, S = a.S;
  const float* base = a.qkv + (size_t)b * S * ld;
  const size_t row = (size_t)b * S + i;
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) {
    qs[d] = base[(size_t)i * ld + h * a.DH + d];
    cs[d] = dctx[row * D + h * a.DH + d];
  }
  __syncthreads();
  float m, l;
  row_softmax_f32(a, base, qs, b, h, ps, red, &m, &l);
  float part = 0.0f;
  for (int j = threadIdx.x; j < S; j += AF_THREADS) {
    const float kf = a.drop.keep((((size_t)b * a.H + h) * S + i) * S + j, b, h, i, j);
    const float dp = kf * dotf(cs, base + (size_t)j * ld + 2 * D + h * a.DH, a.DH);
    ws[j] = ps[j] * kf;
    gs[j] = dp;
    part += dp * ps[j];
  }
  const float delta = block_reduce(part, red, false);
  for (int j = threadIdx.x; j < S; j += AF_THREADS) gs[j] = ps[j] * (gs[j] - delta) * a.scale;
  __syncthreads();
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) {
    float c = 0.0f, q = 0.0f;
    for (int j = 0; j < S; ++j) {
      c = fmaf(ws[j], base[(size_t)j * ld + 2 * D + h * a.DH + d], c);
      q = fmaf(gs[j], base[(size_t)j * ld + D + h * a.DH + d], q);
    }
    ctx[row * D + h * a.DH + d] = c;
    dqkv[row * ld + h * a.DH + d] = q;
  }
  if (threadIdx.x == 0) {
    const size_t n = (size_t)B * a.H * S, o = ((size_t)b * a.H + h) * S + i;
    stats[o] = m;
    stats[n + o] = l;
    stats[2 * n + o] = delta;
  }
}

__global__ void __launch_bounds__(AF_THREADS)
attn_bwd_dkv_f32(AttnF a, const float* __restrict__ dctx, const float* __restrict__ stats,
                 float* __restrict__ dqkv, int B) {
  extern __shared__ float sm[];
  float* ks = sm;             // [DH]
  float* vs = ks + a.DH;      // [DH]
  float* ws = vs + a.DH;      // [S] w over queries
  float* gs = ws + a.S;       // [S] dlog over queries
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int D = a.H * a.DH, ld = 3 * D, S = a.S;
  const float* base = a.qkv + (size_t)b * S * ld;
  const size_t n = (size_t)B * a.H * S, so = ((size_t)b * a.H + h) * S;
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) {
    ks[d] = base[(size_t)j * ld + D + h * a.DH + d];
    vs[d] = base[(size_t)j * ld + 2 * D + h * a.DH + d];
  }
  __syncthreads();
  const float mj = a.mask ? a.mask[(size_t)b * S + j] : 0.0f;
  for (int i = threadIdx.x; i < S; i += AF_THREADS) {
    const float x = dotf(base + (size_t)i * ld + h * a.DH, ks, a.DH) * a.scale + mj;
    const float p = expf(x - stats[so + i]) / stats[n + so + i];
    const float kf = a.drop.keep((((size_t)b * a.H + h) * S + i) * S + j, b, h, i, j);
    const float dp = kf * dotf(dctx + ((size_t)b * S + i) * D + h * a.DH, vs, a.DH);
    ws[i] = p * kf;
    gs[i] = p * (dp - stats[2 * n + so + i]) * a.scale;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < a.DH; d += AF_THREADS) {
    float dk = 0.0f, dv = 0.0f;
    for (int i = 0; i < S; ++i) {
      dv = fmaf(ws[i], dctx[((size_t)b * S + i) * D + h * a.DH + d], dv);
      dk = fmaf(gs[i], base[(size_t)i * ld + h * a.DH + d], dk);
    }
    dqkv[((size_t)b * S + j) * ld + D + h * a.DH + d] = dk;
    dqkv[((size_t)b * S + j) * ld + 2 * D + h * a.DH + d] = dv;
  }
}

Dropout make_drop(const void* bits, int seed, unsigned thr, float inv_keep, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), (uint32_t)seed, thr, inv_keep, mode};
}

template <int DH>
cudaError_t launch_bf16(const Attn& a, int B, const void* dctx, void* ctx, void* dqkv,
                        float* stats, bool backward, cudaStream_t st) {
  constexpr int bytes = Smem<DH>::BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = mdm::allow_smem(attn_fwd_bf16<DH>, bytes);
    if (e == cudaSuccess) e = mdm::allow_smem(attn_bwd_dq_bf16<DH>, bytes);
    if (e == cudaSuccess) e = mdm::allow_smem(attn_bwd_dkv_bf16<DH>, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.S + AT - 1) / AT, a.H, B);
  if (!backward) {
    attn_fwd_bf16<DH><<<grid, AT_THREADS, bytes, st>>>(a, static_cast<bf16*>(ctx));
    return cudaGetLastError();
  }
  attn_bwd_dq_bf16<DH><<<grid, AT_THREADS, bytes, st>>>(
      a, static_cast<const bf16*>(dctx), static_cast<bf16*>(ctx), static_cast<bf16*>(dqkv),
      stats, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_bf16<DH><<<grid, AT_THREADS, bytes, st>>>(
      a, static_cast<const bf16*>(dctx), stats, static_cast<bf16*>(dqkv), B);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* qkv, const void* mask, Dropout drop, const void* dctx, void* ctx,
                     void* dqkv, void* stats, int B, int S, int H, int Dh, int dtype,
                     bool backward, cudaStream_t st) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)Dh));  // np.float32(1 / sqrt(Dh))
  const float* m = static_cast<const float*>(mask);
  float* sp = static_cast<float*>(stats);
  if (dtype == 1) {
    Attn a{static_cast<const bf16*>(qkv), m, S, H, scale, drop};
    switch (Dh) {
      case 32: return launch_bf16<32>(a, B, dctx, ctx, dqkv, sp, backward, st);
      case 64: return launch_bf16<64>(a, B, dctx, ctx, dqkv, sp, backward, st);
      case 128: return launch_bf16<128>(a, B, dctx, ctx, dqkv, sp, backward, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  AttnF a{static_cast<const float*>(qkv), m, S, H, Dh, scale, drop};
  dim3 grid(S, H, B);
  if (!backward) {
    const size_t bytes = (size_t)(Dh + S) * sizeof(float);
    if (bytes > 48 * 1024) return cudaErrorInvalidValue;
    attn_fwd_f32<<<grid, AF_THREADS, bytes, st>>>(a, static_cast<float*>(ctx));
    return cudaGetLastError();
  }
  const size_t bytes = (size_t)(2 * Dh + 3 * S) * sizeof(float);
  if (bytes > 48 * 1024) return cudaErrorInvalidValue;
  attn_bwd_dq_f32<<<grid, AF_THREADS, bytes, st>>>(
      a, static_cast<const float*>(dctx), static_cast<float*>(ctx), static_cast<float*>(dqkv),
      sp, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_f32<<<grid, AF_THREADS, bytes, st>>>(a, static_cast<const float*>(dctx), sp,
                                                    static_cast<float*>(dqkv), B);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 no dropout, 1 injected bits
// ([B, H, S, S] uint32), 2 in-kernel Philox keyed on seed.
extern "C" int mdm_attn_train_fwd(const void* qkv, const void* mask, const void* bits, int seed,
                                  unsigned thr, float inv_keep, int mode, void* ctx, int B,
                                  int S, int H, int Dh, int dtype, void* stream) {
  return (int)dispatch(qkv, mask, make_drop(bits, seed, thr, inv_keep, mode), nullptr, ctx,
                       nullptr, nullptr, B, S, H, Dh, dtype, false,
                       static_cast<cudaStream_t>(stream));
}

// Writes ctx [B*S, D] (recomputed), dqkv [B*S, 3D] and stats (f32 [3, B*H*S]).
extern "C" int mdm_attn_train_bwd(const void* qkv, const void* mask, const void* bits, int seed,
                                  unsigned thr, float inv_keep, int mode, const void* dctx,
                                  void* ctx, void* dqkv, void* stats, int B, int S, int H,
                                  int Dh, int dtype, void* stream) {
  return (int)dispatch(qkv, mask, make_drop(bits, seed, thr, inv_keep, mode), dctx, ctx, dqkv,
                       stats, B, S, H, Dh, dtype, true, static_cast<cudaStream_t>(stream));
}
