// The float32 attention core for head dims up to 256 (see attention.cu for
// the core's contract; above 256 the row kernels there run): forward, and
// the backward's dq and dk/dv kernels, in exact f32 FMA. f32 inputs are
// what compute_dtype="float32" (every CLI's default) and the DistilBERT
// tower give #2/#3, #7/#8 and #10-#12.
//
// Tiled as the bf16 core is (attention_fwd.cu, attention_bwd.cu): a block
// of 128 threads owns 64 rows of a head (queries; keys in the dk/dv
// kernel) and walks the other axis in 32-row tiles that a cp.async ring
// stages in shared memory next to its own 64 rows: two stages deep, or one
// where that lets two blocks share an SM that two stages leave to one
// (F32Smem; mdm_attention_f32_plan reports the plan). Thread (ty, tx) =
// (tid / 8, tid % 8) holds rows ty + 16i (i < 4) and, of a score tile,
// columns tx + 8j (j < 4): a score product is register-blocked 4 x 4 over
// float4 reads of both tiles ([rows][Dh + 4]: the 8 lanes of a quarter warp
// hit 32 distinct banks), and a row's 8 lanes are neighbours in a warp, so
// its max and sums reduce by three shuffles. The probabilities (or dlog)
// of a tile go through a [64][32 + 8] shared tile into the product with the
// streamed tile, which the thread adds to its rows' output columns tx*4 +
// 32q as float4s.
//
// - forward: per key tile the logits once, the online row max m and exp-sum
//   l (the output rescaled by exp(m_old - m) as m grows), e * keep into the
//   shared tile, out += it . V; out / l at the end.
// - backward, as the bf16 one: the dq kernel walks the key tiles twice, (1)
//   q . k^T and dO . v^T with the online m, l and A = sum e * dp (delta =
//   A / l = rowsum(dp * p)), leaving (m, l, delta) per row in stats; (2) both
//   again, p = e / l, dlog = p (dp - delta) * scale, dq += dlog . K. The dk/dv
//   kernel walks the query tiles once with K and V resident: p^T from k .
//   q^T and the statistics, dv += (p keep)^T . dO and dk += dlog^T . Q, its
//   accumulators in registers (above head dim 128 the columns split over
//   two blocks, each recomputing the scores). Per element that is q . k^T
//   and dO . v^T three times, as the bf16 backward: no atomics, every sum in
//   a fixed order, two runs bitwise equal. The recomputed out (ctx) is this
//   forward's own launch.
// exp is expf and p = e / l a division, as the row kernels compute them.
// Every walk stops at the batch element's live extent (live_extent, its
// key-padding row read while the block's own rows are in flight): the
// forward and dq walk the 32-key tiles up to its last live key, and a
// dk/dv block whose 64 keys all lie past it stores zero dk and dv.
// Bound on an H100 (flagship S = 197, Dh = 128, B = 64, H = 4: 5.1 GFLOP
// forward): 0.031 ms, the products' three TF32 passes at 495 TFLOP/s (f32
// accuracy on the tensor cores) and the bytes alike; 0.076 ms at the 67
// TFLOP/s of the f32 FMA this core runs.

#include <cstdint>

#include "attention.cuh"

namespace {

using mdm::Dropout;
using namespace mdm::attn;

constexpr int FR = 64;       // rows a block owns
constexpr int FC = 32;       // rows of a streamed tile
constexpr int FT = 128;      // threads a block
constexpr int LP = FC + 8;   // a score tile's row: [64][40] floats

constexpr int SM_SMEM = 233472;  // an H100 SM's shared memory (228 KB), 1 KB of it a block's

// Blocks of a kernel taking `bytes` of shared memory that an SM holds: at
// most two, all the register file holds of 128-thread blocks at up to 255
// registers a thread; 0 past the 227 KB a block may take.
__host__ __device__ constexpr int blocks_per_sm(int bytes) {
  return bytes > MAX_SMEM ? 0 : SM_SMEM / (bytes + 1024) < 2 ? SM_SMEM / (bytes + 1024) : 2;
}

// The ring's depth, given a kernel's bytes at one stage and at two: two,
// unless one stage puts more blocks on an SM (the only way to overlap one
// block's copies with another's products where two stages leave one block
// an SM) or two do not fit.
__host__ __device__ constexpr int ring_stages(int one, int two) {
  return blocks_per_sm(two) > 0 && blocks_per_sm(two) >= blocks_per_sm(one) ? 2 : 1;
}

// Shared memory of each kernel, in bytes, for padded head dim DH:
// forward: Q [64][DH+4], stages of (K, V) [32][DH+4] each, P [64][LP];
// dq: Q and dO, stages of (K, V), dlog; dk/dv: K and V, stages of (Q, dO
// and the tile's statistics [3][32]), w^T and dlog^T. Stages by
// ring_stages: one for dk/dv at 96, dq at 128 and the forward at 192 (two
// blocks an SM), for dq and dk/dv at 256 (two do not fit), else two.
template <int DH>
struct F32Smem {
  static constexpr int LD = DH + 4;
  static constexpr int OWN = FR * LD * 4;
  static constexpr int TILE = FC * LD * 4;
  static constexpr int SCORE = FR * LP * 4;
  static constexpr int STATS = 3 * FC * 4;
  __host__ __device__ static constexpr int fwd(int st) { return OWN + st * 2 * TILE + SCORE; }
  __host__ __device__ static constexpr int dq(int st) { return 2 * OWN + st * 2 * TILE + SCORE; }
  __host__ __device__ static constexpr int dkv(int st) {
    return 2 * OWN + st * (2 * TILE + STATS) + 2 * SCORE;
  }
  static constexpr int FWD_ST = ring_stages(fwd(1), fwd(2));
  static constexpr int DQ_ST = ring_stages(dq(1), dq(2));
  static constexpr int DKV_ST = ring_stages(dkv(1), dkv(2));
};
static_assert(F32Smem<256>::fwd(F32Smem<256>::FWD_ST) <= MAX_SMEM &&
                  F32Smem<256>::dq(F32Smem<256>::DQ_ST) <= MAX_SMEM &&
                  F32Smem<256>::dkv(F32Smem<256>::DKV_ST) <= MAX_SMEM,
              "the widest instances must fit");

// Output columns a dk/dv block accumulates: above 128 the head's split in two.
template <int DH>
__host__ __device__ constexpr int kv_chunks() { return DH <= 128 ? 1 : 2; }

// Rows [row0, row0 + ROWS) of a head (base: its row 0, row stride ld) into
// a [ROWS][DH+4] tile: the first dh columns from memory, the other columns
// and rows past S zero. VEC: 16-byte copies (dh a multiple of 4, every row
// start 16-byte aligned); else 4-byte ones.
template <int ROWS, int DH, bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* base, int ld, int row0, int S,
                                          int dh) {
  constexpr int LD = DH + 4;
  if constexpr (VEC) {
    constexpr int CPR = DH / 4;
#pragma unroll 4
    for (int v = threadIdx.x; v < ROWS * CPR; v += FT) {
      const int r = v / CPR, c = (v % CPR) * 4;
      const bool ok = c < dh && row0 + r < S;
      mdm::cp_async16(dst + r * LD + c, ok ? base + (size_t)(row0 + r) * ld + c : base,
                      ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < ROWS * DH; e += FT) {
      const int r = e / DH, c = e % DH;
      const bool ok = c < dh && row0 + r < S;
      cp_async4(dst + r * LD + c, ok ? base + (size_t)(row0 + r) * ld + c : base, ok ? 4 : 0);
    }
  }
}

// x[i][j] = A[ty + 16i] . B[tx + 8j] over the DH columns (A: a [64][DH+4]
// tile, B: a [32][DH+4] tile), in column order.
template <int DH>
__device__ __forceinline__ void score_tile(float (&x)[4][4], const float* A, const float* B) {
  constexpr int LD = DH + 4;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.0f;
  const float* a = A + ty * LD;
  const float* b = B + tx * LD;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 8 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(av[i].x, bv[j].x, x[i][j]);
        x[i][j] = fmaf(av[i].y, bv[j].y, x[i][j]);
        x[i][j] = fmaf(av[i].z, bv[j].z, x[i][j]);
        x[i][j] = fmaf(av[i].w, bv[j].w, x[i][j]);
      }
  }
}

// o[i][4q + e] += sum over the tile's 32 rows c of P[ty + 16i][c] *
// T[c][tx*4 + 32q + e] (P: a [64][LP] score tile, T: a [32][DH+4] tile
// offset to its first column), in row order.
template <int DH, int DC>
__device__ __forceinline__ void tile_product(float (&o)[4][DC / 8], const float* P,
                                             const float* T) {
  constexpr int LD = DH + 4;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const float* p = P + ty * LP;
  const float* tc = T + tx * 4;
#pragma unroll 4
  for (int c = 0; c < FC; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[16 * i * LP + c];
#pragma unroll
    for (int q = 0; q < DC / 32; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(tc + c * LD + 32 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][4 * q] = fmaf(pv[i], v.x, o[i][4 * q]);
        o[i][4 * q + 1] = fmaf(pv[i], v.y, o[i][4 * q + 1]);
        o[i][4 * q + 2] = fmaf(pv[i], v.z, o[i][4 * q + 2]);
        o[i][4 * q + 3] = fmaf(pv[i], v.w, o[i][4 * q + 3]);
      }
    }
  }
}

// The max and the sum over a row's 8 lanes (neighbours in the warp).
__device__ __forceinline__ float row_max8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The logit of (query i, key j): x * scale + bias, -inf for a key past S
// (a query past S reads no bias).
__device__ __forceinline__ float logit(const Attn<float>& a, float x, int b, int h, int i, int j) {
  if (j >= a.S) return -INFINITY;
  return i < a.S ? x * a.scale + a.bias.at(b, h, i, j) : x * a.scale;
}

// The keep factor of (query i, key j), 0 off the head (no bits read there).
__device__ __forceinline__ float keep_at(const Attn<float>& a, int b, int h, int i, int j) {
  return i < a.S && j < a.S ? a.keep(b, h, i, j) : 0.0f;
}

// Rows ty + 16i of the accumulators (row r0 + ...), columns c0 + tx*4 +
// 32q + e below dh, divided by div[i] (1 for none): float4 stores where VEC.
template <int DC, bool VEC>
__device__ __forceinline__ void store_rows(const float (&o)[4][DC / 8], const float (&div)[4],
                                           float* base, int ld, int r0, int S, int c0, int dh) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    float* dst = base + (size_t)row * ld;
#pragma unroll
    for (int q = 0; q < DC / 32; ++q) {
      const int col = c0 + tx * 4 + 32 * q;
      const float4 v = make_float4(o[i][4 * q] / div[i], o[i][4 * q + 1] / div[i],
                                   o[i][4 * q + 2] / div[i], o[i][4 * q + 3] / div[i]);
      if (VEC) {
        if (col < dh) *reinterpret_cast<float4*>(dst + col) = v;
      } else {
        if (col < dh) dst[col] = v.x;
        if (col + 1 < dh) dst[col + 1] = v.y;
        if (col + 2 < dh) dst[col + 2] = v.z;
        if (col + 3 < dh) dst[col + 3] = v.w;
      }
    }
  }
}

// A ring of `nst` (1 or 2) stages over `total` tiles, tile 0 already
// issued into stage 0: step(u, stage) after tile u has landed for every
// thread; tile u + 1 in flight meanwhile when nst is 2. issue(u, slot)
// starts tile u (nothing past total) and commits.
template <typename Issue, typename Step>
__device__ __forceinline__ void walk(int total, int nst, Issue issue, Step step) {
#pragma unroll 1
  for (int u = 0; u < total; ++u) {
    mdm::cp_async_wait<0>();
    __syncthreads();
    if (nst == 2) issue(u + 1, (u + 1) & 1);
    step(u, nst == 2 ? u & 1 : 0);
    if (nst == 1) {
      __syncthreads();
      issue(u + 1, 0);
    }
  }
}

template <int DH, bool VEC>
__global__ void __launch_bounds__(FT)
attn_fwd_f32_tiled(Attn<float> a, float* __restrict__ out, View ov) {
  using L = F32Smem<DH>;
  constexpr int LD = L::LD, NST = L::FWD_ST;
  extern __shared__ __align__(128) float fsm[];
  float* Qs = fsm;
  float* ring = Qs + FR * LD;               // stage s: K at s * 2 * FC * LD, then V
  float* Ps = ring + NST * 2 * FC * LD;     // e * keep of the key tile
  const int q0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h);
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;

  const float fb = first_bias(a.bias, bias0, S, FC);
  int nkt = (S + FC - 1) / FC;  // the key tiles walked: up to the live extent once it is read
  auto issue = [&](int kt, int slot) {
    if (kt < nkt) {
      float* st = ring + slot * 2 * FC * LD;
      load_rows<FC, DH, VEC>(st, a.k + hb, ld, kt * FC, S, dh);
      load_rows<FC, DH, VEC>(st + FC * LD, a.v + hb, ld, kt * FC, S, dh);
    }
    mdm::cp_async_commit();
  };
  load_rows<FR, DH, VEC>(Qs, a.q + hb, ld, q0, S, dh);  // rides in group 0 with tile 0
  issue(0, 0);
  const int full = nkt;
  nkt = (live_extent<FT / 32>(a.bias, bias0, S, FC, fb) + FC - 1) / FC;
  count_tiles(a.tiles, nkt, full);
  float o[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) o[i][c] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.0f;

  walk(nkt, NST, issue, [&](int kt, int slot) {
    const float* Ks = ring + slot * 2 * FC * LD;
    float x[4][4];
    score_tile<DH>(x, Qs, Ks);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = logit(a, x[i][j], b, h, qi, kt * FC + tx + 8 * j);
        mx = fmaxf(mx, x[i][j]);
      }
      const float mn = fmaxf(m[i], row_max8(mx));
      const float base = mn == -INFINITY ? 0.0f : mn;  // a row with no finite logit yet
      const float corr = expf(m[i] - base);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * FC + tx + 8 * j;
        const float e = expf(x[i][j] - base);
        sum += e;
        Ps[(ty + 16 * i) * LP + tx + 8 * j] = a.drop.mode ? e * keep_at(a, b, h, qi, kj) : e;
      }
      l[i] = l[i] * corr + row_sum8(sum);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    tile_product<DH, DH>(o, Ps, Ks + FC * LD);
  });
  store_rows<DH, VEC>(o, l, out + ov.head(b, h), ov.ld, q0, S, 0, dh);
}

template <int DH, bool VEC>
__global__ void __launch_bounds__(FT)
attn_bwd_dq_f32_tiled(Attn<float> a, const float* __restrict__ dout, View ov,
                      float* __restrict__ dq, float* __restrict__ stats, int B) {
  using L = F32Smem<DH>;
  constexpr int LD = L::LD, NST = L::DQ_ST;
  extern __shared__ __align__(128) float fsm[];
  float* Qs = fsm;
  float* Cs = Qs + FR * LD;                 // dO rows
  float* ring = Cs + FR * LD;               // stage s: K, then V
  float* Gs = ring + NST * 2 * FC * LD;     // dlog of the key tile
  const int q0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h);
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;

  const float fb = first_bias(a.bias, bias0, S, FC);
  int nkt = (S + FC - 1) / FC;  // the key tiles of a walk: up to the live extent once it is read
  auto issue = [&](int u, int slot) {
    if (u < 2 * nkt) {
      const int kt = u % nkt;
      float* st = ring + slot * 2 * FC * LD;
      load_rows<FC, DH, VEC>(st, a.k + hb, ld, kt * FC, S, dh);
      load_rows<FC, DH, VEC>(st + FC * LD, a.v + hb, ld, kt * FC, S, dh);
    }
    mdm::cp_async_commit();
  };
  load_rows<FR, DH, VEC>(Qs, a.q + hb, ld, q0, S, dh);  // Q and dO ride in group 0
  load_rows<FR, DH, VEC>(Cs, dout + ov.head(b, h), ov.ld, q0, S, dh);
  issue(0, 0);  // key tile 0 at any extent
  const int full = nkt;
  nkt = (live_extent<FT / 32>(a.bias, bias0, S, FC, fb) + FC - 1) / FC;
  count_tiles(a.tiles, nkt, full);
  float m[4], l[4], A[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = A[i] = delta[i] = 0.0f;
  float acc[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) acc[i][c] = 0.0f;

  walk(2 * nkt, NST, issue, [&](int u, int slot) {
    const int kt = u % nkt;
    const float* Ks = ring + slot * 2 * FC * LD;
    const float* Vs = Ks + FC * LD;
    float x[4][4], dw[4][4];
    score_tile<DH>(x, Qs, Ks);
    score_tile<DH>(dw, Cs, Vs);
    if (u < nkt) {  // walk 1: the statistics
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[i][j] = logit(a, x[i][j], b, h, qi, kt * FC + tx + 8 * j);
          mx = fmaxf(mx, x[i][j]);
        }
        const float mn = fmaxf(m[i], row_max8(mx));
        const float base = mn == -INFINITY ? 0.0f : mn;
        const float corr = expf(m[i] - base);
        float sum = 0.0f, dot = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(x[i][j] - base);
          const float kf = a.drop.mode ? keep_at(a, b, h, qi, kt * FC + tx + 8 * j) : 1.0f;
          sum += e;
          dot += e * (kf * dw[i][j]);
        }
        l[i] = l[i] * corr + row_sum8(sum);
        A[i] = A[i] * corr + row_sum8(dot);
        m[i] = mn;
      }
      if (u == nkt - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          delta[i] = A[i] / l[i];
          const int qi = q0 + ty + 16 * i;
          if (tx == 0 && qi < S) {
            const size_t n = (size_t)B * a.H * S, o = ((size_t)b * a.H + h) * S + qi;
            stats[o] = m[i];
            stats[n + o] = l[i];
            stats[2 * n + o] = delta[i];
          }
        }
      }
      return;
    }
    // walk 2: dlog, and dq += dlog . K
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * FC + tx + 8 * j;
        const float p = expf(logit(a, x[i][j], b, h, qi, kj) - m[i]) / l[i];
        const float kf = a.drop.mode ? keep_at(a, b, h, qi, kj) : 1.0f;
        Gs[(ty + 16 * i) * LP + tx + 8 * j] = p * (kf * dw[i][j] - delta[i]) * a.scale;
      }
    }
    __syncthreads();
    tile_product<DH, DH>(acc, Gs, Ks);
  });
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<DH, VEC>(acc, one, dq + hb, ld, q0, S, 0, dh);
}

template <int DH, bool VEC>
__global__ void __launch_bounds__(FT)
attn_bwd_dkv_f32_tiled(Attn<float> a, const float* __restrict__ dout, View ov,
                       const float* __restrict__ stats, float* __restrict__ dk,
                       float* __restrict__ dv, int B) {
  using L = F32Smem<DH>;
  constexpr int LD = L::LD, NST = L::DKV_ST, NC = kv_chunks<DH>(), DC = DH / NC;
  constexpr int STAGE = 2 * FC * LD + 3 * FC;  // floats: Q, dO, the statistics
  extern __shared__ __align__(128) float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + FR * LD;
  float* ring = Vs + FR * LD;
  float* Ws = ring + NST * STAGE;  // (p keep)^T: keys x queries
  float* Gs = Ws + FR * LP;        // dlog^T
  const int chunk = blockIdx.x % NC, k0 = (blockIdx.x / NC) * FR, h = blockIdx.y,
            b = blockIdx.z;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h), cb = ov.head(b, h);
  const size_t n = (size_t)B * a.H * S;
  const float* srow = stats + ((size_t)b * a.H + h) * S;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;

  const float fb = first_bias(a.bias, bias0, S, FR);
  int nqt = (S + FC - 1) / FC;  // 0 once the block's keys prove to lie past the live extent
  auto issue = [&](int qt, int slot) {
    if (qt < nqt) {
      float* st = ring + slot * STAGE;
      const int q0 = qt * FC;
      load_rows<FC, DH, VEC>(st, a.q + hb, ld, q0, S, dh);
      load_rows<FC, DH, VEC>(st + FC * LD, dout + cb, ov.ld, q0, S, dh);
      float* sd = st + 2 * FC * LD;
      for (int v = threadIdx.x; v < 3 * FC; v += FT) {
        const int i = q0 + v % FC;
        cp_async4(sd + v, i < S ? srow + (v / FC) * n + i : srow, i < S ? 4 : 0);
      }
    }
    mdm::cp_async_commit();
  };
  load_rows<FR, DH, VEC>(Ks, a.k + hb, ld, k0, S, dh);  // K and V ride in group 0
  load_rows<FR, DH, VEC>(Vs, a.v + hb, ld, k0, S, dh);
  issue(0, 0);
  const int full = nqt;
  if (k0 >= live_extent<FT / 32>(a.bias, bias0, S, FR, fb)) nqt = 0;
  count_tiles(a.tiles, nqt, full);
  float gk[4][DC / 8], gv[4][DC / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC / 8; ++c) gk[i][c] = gv[i][c] = 0.0f;

  walk(nqt, NST, issue, [&](int qt, int slot) {
    const float* Qs = ring + slot * STAGE;
    const float* Cs = Qs + FC * LD;
    const float* sd = Cs + FC * LD;  // m, l, delta of the tile's queries
    float x[4][4], dw[4][4];
    score_tile<DH>(x, Ks, Qs);  // x[i][j]: key k0 + ty + 16i, query qt*FC + tx + 8j
    score_tile<DH>(dw, Vs, Cs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j, qi = qt * FC + c;
        float w = 0.0f, g = 0.0f;
        if (qi < S && kj < S) {
          const float p = expf(x[i][j] * a.scale + a.bias.at(b, h, qi, kj) - sd[c]) / sd[FC + c];
          const float kf = a.drop.mode ? a.keep(b, h, qi, kj) : 1.0f;
          w = p * kf;
          g = p * (kf * dw[i][j] - sd[2 * FC + c]) * a.scale;
        }
        Ws[(ty + 16 * i) * LP + c] = w;
        Gs[(ty + 16 * i) * LP + c] = g;
      }
    }
    __syncthreads();
    tile_product<DH, DC>(gv, Ws, Cs + chunk * DC);
    tile_product<DH, DC>(gk, Gs, Qs + chunk * DC);
  });
  if (!nqt) mdm::cp_async_wait<0>();  // a block past the extent: its copies land before it exits
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<DC, VEC>(gk, one, dk + hb, ld, k0, S, chunk * DC, dh);
  store_rows<DC, VEC>(gv, one, dv + hb, ld, k0, S, chunk * DC, dh);
}

// The three kernels' shared memory, allowed once per instance.
template <int DH, bool VEC>
cudaError_t f32_opt_in() {
  using L = F32Smem<DH>;
  static bool done_fwd = false, done_dq = false, done_kv = false;
  cudaError_t e = opt_in(attn_fwd_f32_tiled<DH, VEC>, done_fwd, L::fwd(L::FWD_ST));
  if (e == cudaSuccess) e = opt_in(attn_bwd_dq_f32_tiled<DH, VEC>, done_dq, L::dq(L::DQ_ST));
  if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_f32_tiled<DH, VEC>, done_kv, L::dkv(L::DKV_ST));
  return e;
}

template <int DH, bool VEC>
cudaError_t launch_dh(const Attn<float>& a, const Call& c, bool backward, cudaStream_t st) {
  using L = F32Smem<DH>;
  const int fwd_bytes = L::fwd(L::FWD_ST), dq_bytes = L::dq(L::DQ_ST),
            kv_bytes = L::dkv(L::DKV_ST);
  cudaError_t e = f32_opt_in<DH, VEC>();
  if (e != cudaSuccess) return e;
  const dim3 grid((c.S + FR - 1) / FR, c.H, c.B);
  if (!backward || c.out) {  // the forward, or the backward's recomputed out
    attn_fwd_f32_tiled<DH, VEC><<<grid, FT, fwd_bytes, st>>>(a, static_cast<float*>(c.out),
                                                             c.ov);
    e = cudaGetLastError();
    if (e != cudaSuccess || !backward) return e;
  }
  const float* dout = static_cast<const float*>(c.dout);
  attn_bwd_dq_f32_tiled<DH, VEC><<<grid, FT, dq_bytes, st>>>(
      a, dout, c.ov, static_cast<float*>(c.dq), c.stats, c.B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((c.S + FR - 1) / FR * kv_chunks<DH>(), c.H, c.B);
  attn_bwd_dkv_f32_tiled<DH, VEC><<<kv_grid, FT, kv_bytes, st>>>(
      a, dout, c.ov, c.stats, static_cast<float*>(c.dk), static_cast<float*>(c.dv), c.B);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const Attn<float>& a, const Call& c, bool backward, cudaStream_t st) {
  return a.vec ? launch_dh<DH, true>(a, c, backward, st)
               : launch_dh<DH, false>(a, c, backward, st);
}

// plan[0..10]: DH; the forward's, dq's and dk/dv's stages; their shared
// bytes; dk/dv's column chunks; their resident blocks per SM (the 16-byte
// instances).
template <int DH>
cudaError_t plan_dh(int* plan) {
  using L = F32Smem<DH>;
  const int stages[3] = {L::FWD_ST, L::DQ_ST, L::DKV_ST};
  const int bytes[3] = {L::fwd(L::FWD_ST), L::dq(L::DQ_ST), L::dkv(L::DKV_ST)};
  plan[0] = DH;
  for (int i = 0; i < 3; ++i) plan[1 + i] = stages[i], plan[4 + i] = bytes[i];
  plan[7] = kv_chunks<DH>();
  cudaError_t e = f32_opt_in<DH, true>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 8, attn_fwd_f32_tiled<DH, true>, FT,
                                                      bytes[0]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 9, attn_bwd_dq_f32_tiled<DH, true>,
                                                      FT, bytes[1]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 10, attn_bwd_dkv_f32_tiled<DH, true>,
                                                      FT, bytes[2]);
  return e;
}

}  // namespace

// The f32 core's plan for head dim Dh into plan[11] (ops/_chain.py
// attention_f32_plan_on_card): the tile instance's padded head dim; the
// forward's, dq's and dk/dv's ring stages and shared bytes; dk/dv's column
// chunks; each kernel's resident blocks per SM. Above 256 (the row kernels
// of attention.cu) plan[0] = 0 and nothing else is written.
extern "C" int mdm_attention_f32_plan(int Dh, int* plan) {
  switch (mdm::attn::padded_head_dim(Dh)) {
    case 32: return (int)plan_dh<32>(plan);
    case 64: return (int)plan_dh<64>(plan);
    case 96: return (int)plan_dh<96>(plan);
    case 128: return (int)plan_dh<128>(plan);
    case 192: return (int)plan_dh<192>(plan);
    case 256: return (int)plan_dh<256>(plan);
    default: plan[0] = 0; return Dh < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
  }
}

namespace mdm {
namespace attn {

cudaError_t launch_f32_tiled(const Attn<float>& a, const Call& c, bool backward,
                             cudaStream_t st) {
  switch (padded_head_dim(a.dh)) {
    case 32: return launch_dh<32>(a, c, backward, st);
    case 64: return launch_dh<64>(a, c, backward, st);
    case 96: return launch_dh<96>(a, c, backward, st);
    case 128: return launch_dh<128>(a, c, backward, st);
    case 192: return launch_dh<192>(a, c, backward, st);
    case 256: return launch_dh<256>(a, c, backward, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace mdm
