// The attention core of every attention kernel of the port, forward and
// backward, with optional probability dropout. It replaces these TPU kernels:
//   mdm_tpu/ops/attention_train_block.py::_fwd_kernel (pallas_call at :286,294)
//     and ::_bwd_kernel (:334,344), with the projections of gemm.cu;
//   mdm_tpu/ops/attention_dropout.py::_fwd_kernel (:181,187) and ::_bwd_kernel
//     (:214,220);
//   mdm_tpu/ops/attention.py::_fused_attention_pallas (:76);
//   mdm_tpu/ops/attention_v2.py::_fused_attention_v2 (:69);
//   mdm_tpu/ops/attention_block.py::_fused_block (:84), with gemm.cu.
// The TPU kernels differ in layout, mask form and where the projections
// sit; here one core takes them all as arguments:
// - a View gives each operand's (batch, head, row) strides: q/k/v packed in
//   one [B*S, 3D] tensor, separate [B, S, H*Dh] tensors, or [B, H, S, Dh];
// - a Bias gives the additive f32 logit bias: a key-padding row [B, S]
//   (row stride 0) or a full [B, 1|H, S, S] tile, or none;
// - the output is stored in bf16 or f32, the gradients in the inputs' dtype.
//
// Per head, at the TPU kernels' rounding points:
//   p   = softmax(q k^T * scale + bias)                 f32
//   w   = keep ? p * inv_keep : 0, rounded to dt        (the dropout)
//   out = w . v, f32 accumulation, stored in the output dtype
// Backward, from dout (dt) and the recomputed p and keep mask:
//   dv  = w^T . dout;  dw = dout . v^T (f32);  dp = keep * dw
//   dlog = p * (dp - rowsum(dp * p)) * scale, rounded to dt
//   dq  = dlog . k;  dk = dlog^T . q;  the three stored in the inputs'
//   dtype; the forward's out optionally recomputed (the train block's dWo)
// Nothing quadratic in S is stored: the backward recomputes p and replays
// the bits (philox.cuh), keyed on (key column, query row, head, batch).
//
// The TPU kernels hold a whole [S, S] head in VMEM per batch cell. Here a
// block owns a 64-row tile and walks the other axis in 64-wide tiles:
// - forward: per query tile, pass 1 finds each row's max and exp-sum,
//   pass 2 forms the normalised p, drops, rounds and accumulates w . v
//   (a flash-style online rescale would round w before normalising);
// - backward dq kernel: per query tile, the same two passes plus dw and the
//   row sums delta in pass 2, then pass 3 forms dlog and dq; it writes dq,
//   the row statistics (max, sum, delta) and optionally out;
// - backward dkv kernel: per key tile, walks the query tiles with those
//   statistics and accumulates dk and dv in registers, so no float atomics
//   and two backward runs are bitwise equal.
// The bf16 path runs WMMA 16x16x16 fragments (4 warps, 16 rows each); the
// f32 path is scalar FMA, one block per row. Bound on an H100 at the
// flagship shapes (S=197, Dh=128): the probabilities' exp and Philox work
// and the products of a 64-row tile; with separate q/k/v and an f32 output
// (#7, #10, #11) the bytes of the operands come close to it.

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

// Row s of head h of batch b starts at b*sb + h*sh + s*ld elements; its Dh
// values are contiguous.
struct View {
  long long sb, sh;
  int ld;
  __device__ __forceinline__ size_t head(int b, int h) const {
    return (size_t)b * sb + (size_t)h * sh;
  }
};

// Additive f32 bias of logit (b, h, query i, key j) at b*bb + h*bh + i*bi + j:
// bi = 0 for a key-padding row, S for a full [S, S] tile; p null for none.
struct Bias {
  const float* p;
  long long bb, bh;
  int bi;
  __device__ __forceinline__ float at(int b, int h, int i, int j) const {
    return p ? p[(size_t)b * bb + (size_t)h * bh + (size_t)i * bi + j] : 0.0f;
  }
};

template <typename T>
struct Attn {
  const T *q, *k, *v;  // all three through `in`
  View in;
  Bias bias;
  int S, H;
  float scale;
  Dropout drop;

  __device__ __forceinline__ float keep(int b, int h, int i, int j) const {
    return drop.keep((((size_t)b * H + h) * S + i) * S + j, b, h, i, j);
  }
};

// Rows [row0, row0+64) of a head (base: its row 0, row stride ld) into a
// [64][LD] tile; rows past S are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int ld, int row0, int S) {
  constexpr int VPR = DH / 8;
  for (int v = threadIdx.x; v < AT * VPR; v += AT_THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const int s = row0 + r;
    const bool ok = s < S;
    mdm::cp_async16(dst + r * Smem<DH>::LD + c, ok ? base + (size_t)s * ld + c : base,
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

// Store this block's 64 x DH accumulators (each warp its 16 rows) to rows
// [row0, row0+64) of a head (base: its row 0, row stride ld) in OT, rows
// past S skipped.
template <int DH, typename OT>
__device__ __forceinline__ void store_rows(Acc* acc, float* stage, OT* base, int ld, int row0,
                                           int S) {
  constexpr int LDO = Smem<DH>::LDO;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int v = threadIdx.x; v < AT * DH; v += AT_THREADS) {
    const int r = v / DH, c = v % DH;
    if (row0 + r < S) base[(size_t)(row0 + r) * ld + c] = mdm::from_f<OT>(stage[r * LDO + c]);
  }
  __syncthreads();
}

// Pass 1 over the key tiles: each row's max m and exp-sum l of the logits
// (lane-replicated, 16 rows per warp). Rows past S read row S-1's bias.
template <int DH>
__device__ __forceinline__ void row_stats(const Attn<bf16>& a, const bf16* kb, int b, int h, int q0,
                                          bf16* Qs, bf16* Ks, float* Ss, float* m, float* l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 16; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < a.S; k0 += AT) {
    load_rows<DH>(Ks, kb, a.in.ld, k0, a.S);
    mdm::cp_async_commit();
    mdm::cp_async_wait<0>();
    __syncthreads();
    rows_dot<DH>(Ss, Qs, Ks);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = min(q0 + warp * 16 + r, a.S - 1);
      float x[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = k0 + lane + 32 * hf;
        x[hf] = j < a.S ? Ss[(warp * 16 + r) * LDS + lane + 32 * hf] * a.scale + a.bias.at(b, h, i, j)
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
template <int DH, typename OT>
__global__ void __launch_bounds__(AT_THREADS)
attn_fwd_bf16(Attn<bf16> a, OT* __restrict__ out, View ov) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T2);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P0);
  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  const bf16 *qb = a.q + hb, *kb = a.k + hb, *vb = a.v + hb;

  load_rows<DH>(Qs, qb, ld, q0, S);
  mdm::cp_async_commit();
  float m[16], l[16];
  row_stats<DH>(a, kb, b, h, q0, Qs, Ks, Ss, m, l);

  Acc acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, kb, ld, k0, S);
    load_rows<DH>(Vs, vb, ld, k0, S);
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
          const float x = Ss[(warp * 16 + r) * LDS + c] * a.scale + a.bias.at(b, h, i, j);
          const float p = expf(x - m[r]) / l[r];
          w = p * a.keep(b, h, i, j);
        }
        Ps[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(w);
      }
    }
    __syncwarp();
    rows_pv<DH>(acc, Ps, Vs);
    __syncthreads();
  }
  store_rows<DH, OT>(acc, reinterpret_cast<float*>(smem + L::T1), out + ov.head(b, h), ov.ld, q0,
                     S);
}

// --------------------------------------------------- backward, dq side, bf16
// Per query tile: dq, the row statistics m, l, delta into stats[3][B*H*S]
// for the dkv kernel, and (when ctx is not null) the forward's out.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dq_bf16(Attn<bf16> a, const bf16* __restrict__ dout, bf16* __restrict__ ctx, View ov,
                 bf16* __restrict__ dq, float* __restrict__ stats, int B) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::T1);  // dout rows
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::T3);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  float* Ds = reinterpret_cast<float*>(smem + L::S1);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P0);
  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  const bf16 *qb = a.q + hb, *kb = a.k + hb, *vb = a.v + hb;

  load_rows<DH>(Qs, qb, ld, q0, S);
  load_rows<DH>(Cs, dout + ov.head(b, h), ov.ld, q0, S);
  mdm::cp_async_commit();
  float m[16], l[16], delta[16];
  row_stats<DH>(a, kb, b, h, q0, Qs, Ks, Ss, m, l);

  // p and keep of element (row r of this warp, column c) of key tile k0.
  auto element = [&](int r, int c, int k0, float& p, float& kf) {
    const int i = q0 + warp * 16 + r, j = k0 + c;
    p = 0.0f;
    kf = 0.0f;
    if (i < S && j < S) {
      const float x = Ss[(warp * 16 + r) * LDS + c] * a.scale + a.bias.at(b, h, i, j);
      p = expf(x - m[r]) / l[r];
      kf = a.keep(b, h, i, j);
    }
  };

  // Pass 2: delta = rowsum(dp * p), and out = w . v when asked for.
  Acc acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int r = 0; r < 16; ++r) delta[r] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, kb, ld, k0, S);
    load_rows<DH>(Vs, vb, ld, k0, S);
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
    if (ctx) rows_pv<DH>(acc, Ps, Vs);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) delta[r] = mdm::warp_sum(delta[r]);
  if (ctx)
    store_rows<DH, bf16>(acc, reinterpret_cast<float*>(smem + L::S0), ctx + ov.head(b, h), ov.ld,
                         q0, S);

  // Pass 3: dlog and dq = dlog . k.
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < S; k0 += AT) {
    load_rows<DH>(Ks, kb, ld, k0, S);
    load_rows<DH>(Vs, vb, ld, k0, S);
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
  store_rows<DH, bf16>(acc, reinterpret_cast<float*>(smem + L::S0), dq + hb, ld, q0, S);

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
// accumulates dv = w^T . dout and dk = dlog^T . q in registers.
template <int DH>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dkv_bf16(Attn<bf16> a, const bf16* __restrict__ dout, View ov,
                  const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int B) {
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
  const int S = a.S, ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  const bf16 *qb = a.q + hb, *kb = a.k + hb, *vb = a.v + hb;
  const bf16* cb = dout + ov.head(b, h);
  const size_t n = (size_t)B * a.H * S;
  const float* srow = stats + ((size_t)b * a.H + h) * S;

  load_rows<DH>(Ks, kb, ld, k0, S);
  load_rows<DH>(Vs, vb, ld, k0, S);
  mdm::cp_async_commit();

  Acc gk[DH / 16], gv[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(gk[j], 0.0f);
    wmma::fill_fragment(gv[j], 0.0f);
  }
  for (int q0 = 0; q0 < S; q0 += AT) {
    load_rows<DH>(Qs, qb, ld, q0, S);
    load_rows<DH>(Cs, cb, ov.ld, q0, S);
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
          const float x = St[(warp * 16 + r) * LDS + c] * a.scale + a.bias.at(b, h, i, j);
          const float p = expf(x - st[c]) / st[AT + c];
          const float kf = a.keep(b, h, i, j);
          w = p * kf;
          const float dp = kf * Dt[(warp * 16 + r) * LDS + c];
          g = p * (dp - st[2 * AT + c]) * a.scale;
        }
        Wt[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(w);
        Gt[(warp * 16 + r) * LDP + c] = __float2bfloat16_rn(g);
      }
    }
    __syncwarp();
    rows_pv<DH>(gv, Wt, Cs);
    rows_pv<DH>(gk, Gt, Qs);
    __syncthreads();
  }
  float* stage = reinterpret_cast<float*>(smem + L::T2);
  store_rows<DH, bf16>(gk, stage, dk + hb, ld, k0, S);
  store_rows<DH, bf16>(gv, stage, dv + hb, ld, k0, S);
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
  Attn<float> a;
  int DH;
};

__device__ __forceinline__ float dotf(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Row (b, h, i): p_j into ps; its max and sum through the pointers.
__device__ void row_softmax_f32(const AttnF& f, const float* kb, const float* qs, int b, int h,
                                int i, float* ps, float* red, float* m_out, float* l_out) {
  const Attn<float>& a = f.a;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) {
    const float v = dotf(qs, kb + (size_t)j * a.in.ld, f.DH) * a.scale + a.bias.at(b, h, i, j);
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
attn_fwd_f32(AttnF f, float* __restrict__ out, View ov) {
  extern __shared__ float sm[];
  const Attn<float>& a = f.a;
  float* qs = sm;           // [DH]
  float* ps = sm + f.DH;    // [S]
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) qs[d] = a.q[hb + (size_t)i * ld + d];
  __syncthreads();
  float m, l;
  row_softmax_f32(f, a.k + hb, qs, b, h, i, ps, red, &m, &l);
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) ps[j] *= a.keep(b, h, i, j);
  __syncthreads();
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) {
    float acc = 0.0f;
    for (int j = 0; j < a.S; ++j) acc = fmaf(ps[j], a.v[hb + (size_t)j * ld + d], acc);
    out[ov.head(b, h) + (size_t)i * ov.ld + d] = acc;
  }
}

__global__ void __launch_bounds__(AF_THREADS)
attn_bwd_dq_f32(AttnF f, const float* __restrict__ dout, float* __restrict__ ctx, View ov,
                float* __restrict__ dq, float* __restrict__ stats, int B) {
  extern __shared__ float sm[];
  const Attn<float>& a = f.a;
  float* qs = sm;                  // [DH]
  float* cs = qs + f.DH;           // [DH] dout row
  float* ps = cs + f.DH;           // [S] p
  float* ws = ps + a.S;            // [S] w = p * keep
  float* gs = ws + a.S;            // [S] dp, then dlog
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld, S = a.S;
  const size_t hb = a.in.head(b, h), ob = ov.head(b, h) + (size_t)i * ov.ld;
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) {
    qs[d] = a.q[hb + (size_t)i * ld + d];
    cs[d] = dout[ob + d];
  }
  __syncthreads();
  float m, l;
  row_softmax_f32(f, a.k + hb, qs, b, h, i, ps, red, &m, &l);
  float part = 0.0f;
  for (int j = threadIdx.x; j < S; j += AF_THREADS) {
    const float kf = a.keep(b, h, i, j);
    const float dp = kf * dotf(cs, a.v + hb + (size_t)j * ld, f.DH);
    ws[j] = ps[j] * kf;
    gs[j] = dp;
    part += dp * ps[j];
  }
  const float delta = block_reduce(part, red, false);
  for (int j = threadIdx.x; j < S; j += AF_THREADS) gs[j] = ps[j] * (gs[j] - delta) * a.scale;
  __syncthreads();
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) {
    float c = 0.0f, q = 0.0f;
    for (int j = 0; j < S; ++j) {
      if (ctx) c = fmaf(ws[j], a.v[hb + (size_t)j * ld + d], c);
      q = fmaf(gs[j], a.k[hb + (size_t)j * ld + d], q);
    }
    if (ctx) ctx[ob + d] = c;
    dq[hb + (size_t)i * ld + d] = q;
  }
  if (threadIdx.x == 0) {
    const size_t n = (size_t)B * a.H * S, o = ((size_t)b * a.H + h) * S + i;
    stats[o] = m;
    stats[n + o] = l;
    stats[2 * n + o] = delta;
  }
}

__global__ void __launch_bounds__(AF_THREADS)
attn_bwd_dkv_f32(AttnF f, const float* __restrict__ dout, View ov,
                 const float* __restrict__ stats, float* __restrict__ dk,
                 float* __restrict__ dv, int B) {
  extern __shared__ float sm[];
  const Attn<float>& a = f.a;
  float* ks = sm;             // [DH]
  float* vs = ks + f.DH;      // [DH]
  float* ws = vs + f.DH;      // [S] w over queries
  float* gs = ws + a.S;       // [S] dlog over queries
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld, S = a.S;
  const size_t hb = a.in.head(b, h), cb = ov.head(b, h);
  const size_t n = (size_t)B * a.H * S, so = ((size_t)b * a.H + h) * S;
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) {
    ks[d] = a.k[hb + (size_t)j * ld + d];
    vs[d] = a.v[hb + (size_t)j * ld + d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += AF_THREADS) {
    const float x = dotf(a.q + hb + (size_t)i * ld, ks, f.DH) * a.scale + a.bias.at(b, h, i, j);
    const float p = expf(x - stats[so + i]) / stats[n + so + i];
    const float kf = a.keep(b, h, i, j);
    const float dp = kf * dotf(dout + cb + (size_t)i * ov.ld, vs, f.DH);
    ws[i] = p * kf;
    gs[i] = p * (dp - stats[2 * n + so + i]) * a.scale;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < f.DH; d += AF_THREADS) {
    float gk = 0.0f, gv = 0.0f;
    for (int i = 0; i < S; ++i) {
      gv = fmaf(ws[i], dout[cb + (size_t)i * ov.ld + d], gv);
      gk = fmaf(gs[i], a.q[hb + (size_t)i * ld + d], gk);
    }
    dk[hb + (size_t)j * ld + d] = gk;
    dv[hb + (size_t)j * ld + d] = gv;
  }
}

// Everything one call needs. Forward: out in out_dtype. Backward: dq, dk,
// dv through `in` in dtype, stats, and out (ctx) when not null.
struct Call {
  const void *q, *k, *v;
  View in;
  Bias bias;
  Dropout drop;
  void* out;
  View ov;
  int out_dtype;
  const void* dout;
  void *dq, *dk, *dv;
  float* stats;
  int B, S, H, Dh, dtype;
};

template <typename K>
cudaError_t opt_in(K kernel, bool& done, int bytes) {
  if (done) return cudaSuccess;
  const cudaError_t e = mdm::allow_smem(kernel, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int DH, typename OT>
cudaError_t launch_fwd(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  constexpr int bytes = Smem<DH>::BYTES;
  static bool done = false;
  cudaError_t e = opt_in(attn_fwd_bf16<DH, OT>, done, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((c.S + AT - 1) / AT, c.H, c.B);
  attn_fwd_bf16<DH, OT><<<grid, AT_THREADS, bytes, st>>>(a, static_cast<OT*>(c.out), c.ov);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  constexpr int bytes = Smem<DH>::BYTES;
  static bool done_dq = false, done_dkv = false;
  cudaError_t e = opt_in(attn_bwd_dq_bf16<DH>, done_dq, bytes);
  if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_bf16<DH>, done_dkv, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((c.S + AT - 1) / AT, c.H, c.B);
  const bf16* dout = static_cast<const bf16*>(c.dout);
  attn_bwd_dq_bf16<DH><<<grid, AT_THREADS, bytes, st>>>(
      a, dout, static_cast<bf16*>(c.out), c.ov, static_cast<bf16*>(c.dq), c.stats, c.B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_bf16<DH><<<grid, AT_THREADS, bytes, st>>>(
      a, dout, c.ov, c.stats, static_cast<bf16*>(c.dk), static_cast<bf16*>(c.dv), c.B);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const Attn<bf16>& a, const Call& c, bool backward, cudaStream_t st) {
  if (!backward)
    return c.out_dtype == 1 ? launch_fwd<DH, bf16>(a, c, st) : launch_fwd<DH, float>(a, c, st);
  return launch_bwd<DH>(a, c, st);
}

cudaError_t dispatch(const Call& c, bool backward, cudaStream_t st) {
  if (c.B <= 0 || c.S <= 0 || c.H <= 0 || c.out_dtype < 0 || c.out_dtype > 1)
    return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)c.Dh));  // np.float32(1 / sqrt(Dh))
  if (c.dtype == 1) {
    const Attn<bf16> a{static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k),
                       static_cast<const bf16*>(c.v), c.in, c.bias, c.S, c.H, scale, c.drop};
    switch (c.Dh) {
      case 32: return launch_bf16<32>(a, c, backward, st);
      case 64: return launch_bf16<64>(a, c, backward, st);
      case 128: return launch_bf16<128>(a, c, backward, st);
      default: return cudaErrorInvalidValue;
    }
  }
  // float32 inputs: f32 outputs only.
  if (c.dtype != 0 || c.out_dtype != 0) return cudaErrorInvalidValue;
  const AttnF f{{static_cast<const float*>(c.q), static_cast<const float*>(c.k),
                 static_cast<const float*>(c.v), c.in, c.bias, c.S, c.H, scale, c.drop}, c.Dh};
  dim3 grid(c.S, c.H, c.B);
  if (!backward) {
    const size_t bytes = (size_t)(c.Dh + c.S) * sizeof(float);
    if (bytes > 48 * 1024) return cudaErrorInvalidValue;
    attn_fwd_f32<<<grid, AF_THREADS, bytes, st>>>(f, static_cast<float*>(c.out), c.ov);
    return cudaGetLastError();
  }
  const size_t bytes = (size_t)(2 * c.Dh + 3 * c.S) * sizeof(float);
  if (bytes > 48 * 1024) return cudaErrorInvalidValue;
  const float* dout = static_cast<const float*>(c.dout);
  attn_bwd_dq_f32<<<grid, AF_THREADS, bytes, st>>>(f, dout, static_cast<float*>(c.out), c.ov,
                                                    static_cast<float*>(c.dq), c.stats, c.B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_f32<<<grid, AF_THREADS, bytes, st>>>(f, dout, c.ov, c.stats,
                                                     static_cast<float*>(c.dk),
                                                     static_cast<float*>(c.dv), c.B);
  return cudaGetLastError();
}

Dropout make_drop(const void* bits, int seed, unsigned thr, float inv_keep, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), (uint32_t)seed, thr, inv_keep, mode};
}

}  // namespace

// dtype, out_dtype: 0 = float32, 1 = bfloat16. q, k, v share the view
// (sb, sh, ld); out and dout the view (osb, osh, old); bias is additive
// f32 with strides (bb, bh, bi), or null. mode: 0 no dropout, 1 injected
// bits ([B, H, S, S] uint32), 2 in-kernel Philox keyed on seed.
extern "C" int mdm_attention_fwd(const void* q, const void* k, const void* v, long long sb,
                                 long long sh, int ld, const void* bias, long long bb,
                                 long long bh, int bi, const void* bits, int seed, unsigned thr,
                                 float inv_keep, int mode, void* out, long long osb,
                                 long long osh, int old, int out_dtype, int B, int S, int H,
                                 int Dh, int dtype, void* stream) {
  const Call c{q, k, v, View{sb, sh, ld}, Bias{static_cast<const float*>(bias), bb, bh, bi},
               make_drop(bits, seed, thr, inv_keep, mode), out, View{osb, osh, old}, out_dtype,
               nullptr, nullptr, nullptr, nullptr, nullptr, B, S, H, Dh, dtype};
  return (int)dispatch(c, false, static_cast<cudaStream_t>(stream));
}

// Writes dq, dk, dv (through the q/k/v view, in dtype), the row statistics
// stats (f32 [3, B*H*S]) and, when ctx is not null, the forward's out
// recomputed into ctx (dtype, through the out view).
extern "C" int mdm_attention_bwd(const void* q, const void* k, const void* v, long long sb,
                                 long long sh, int ld, const void* bias, long long bb,
                                 long long bh, int bi, const void* bits, int seed, unsigned thr,
                                 float inv_keep, int mode, const void* dout, void* ctx,
                                 long long osb, long long osh, int old, void* dq, void* dk,
                                 void* dv, void* stats, int B, int S, int H, int Dh,
                                 int dtype, void* stream) {
  const Call c{q, k, v, View{sb, sh, ld}, Bias{static_cast<const float*>(bias), bb, bh, bi},
               make_drop(bits, seed, thr, inv_keep, mode), ctx, View{osb, osh, old}, dtype,
               dout, dq, dk, dv, static_cast<float*>(stats), B, S, H, Dh, dtype};
  return (int)dispatch(c, true, static_cast<cudaStream_t>(stream));
}
