// The bf16 attention core for head dims above 256 (see attention.cu for the
// core's contract): the configurations --latent_dim 1024 --num_heads 2 or 1
// (Dh 512, 1024) and the like. A tile kernel holds a whole head's rows in
// shared memory and its output columns in registers; at Dh = 512 one
// [64][520] bf16 tile is 66.5 KB, so Q, dO and a ring of K/V stages would
// not fit the 227 KB. Here every score product (q . k^T, dO . v^T, k . q^T,
// v . dO^T) streams both operands through shared memory in slabs of 64
// head-dim columns, two stages deep, summing the f32 scores over the slabs,
// and each block accumulates only a chunk of the output columns (128 for
// the forward and dq, 64 for dk/dv: those two sets of accumulators share
// the registers), recomputing the scores per chunk. The rounding points,
// the keep draws (keep_bits: Philox4x32-10 keyed on (b, h, query, key), or
// the injected bits), the statistics and every sum order are the tile
// kernels' two-pass ones: the forward's row max and exp-sum merged tile by
// tile, then w = bf16(p keep) per tile; the backward's dq kernel leaving
// (max, 1/sum, delta) per row for the dk/dv kernel, which walks the query
// tiles with dk and dv in registers. No float atomics; two runs are
// bitwise equal.
//
// A simple kernel: one slab product at a time, and the scores recomputed
// for every output chunk (Dh / 128 or Dh / 64 times), so it runs several
// times the tile kernels' product work per head. Bound on an H100: the
// products (the bound counts each once), which mma.sync runs well below
// the tensor-core peak.

#include "attention.cuh"

namespace {

using mdm::bf16;
using mdm::Dropout;
using namespace mdm::attn;

constexpr int SL = 64;               // head-dim columns per slab
constexpr int SLAB = AT * (SL + 8);  // one [64][SL+8] slab tile, elements
constexpr int DC = 128;              // output columns per block: forward, dq
constexpr int KV_DC = 64;            // output columns per block: dk/dv

// Shared memory: two stages of two slab tiles, one column-chunk tile
// [64][DC+8], a full bias tile [64][LDB] (or the key-padding row), the
// query tile's statistics [3][64] and the key-padding row of a key tile.
constexpr int CHUNK0 = 2 * 2 * SLAB * 2;
constexpr int BIAS0 = CHUNK0 + AT * (DC + 8) * 2;
constexpr int STATS0 = BIAS0 + AT * LDB * 4;
constexpr int ROWB0 = STATS0 + 3 * AT * 4;
constexpr int BYTES = ROWB0 + LDB * 4;

// x = this warp's 16 rows of A[ra0..] . B[rb0..]^T over all dh columns (A,
// B: row 0 of a head, row strides lda, ldb), the slabs of both through two
// ring stages; rows past S are zero. Every earlier committed copy group is
// complete when the first slab's product starts. Starts and ends with
// every thread past its reads of the ring. VEC: 16-byte row copies
// (load_tile); each kernel below has an instance of either width.
template <bool VEC>
__device__ void slab_product(float (&x)[8][4], const bf16* A, int lda, int ra0, const bf16* B,
                             int ldb, int rb0, const Attn<bf16>& a, bf16* ring) {
  const int S = a.S, dh = a.dh, ns = (dh + SL - 1) / SL;
  const int pairs = min(4, (S - rb0 + 15) >> 4);
  auto issue = [&](int s) {
    if (s < ns) {
      bf16* st = ring + (s & 1) * 2 * SLAB;
      const int cols = min(SL, dh - s * SL);
      load_tile<SL, VEC>(st, A + s * SL, lda, ra0, S, cols);
      load_tile<SL, VEC>(st + SLAB, B + s * SL, ldb, rb0, S, cols);
    }
    mdm::cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
  issue(0);
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    issue(s + 1);  // into the stage every thread left at the end of step s - 1
    mdm::cp_async_wait<1>();
    __syncthreads();
    const bf16* st = ring + (s & 1) * 2 * SLAB;
    qk_tile<SL, false>(x, st, st + SLAB, pairs);
    __syncthreads();
  }
}

// Rows [row0, row0 + 64) of `cols` columns from base into the chunk tile,
// waited for: every thread must be past its last reads of the tile.
template <int NC, bool VEC>
__device__ __forceinline__ void load_chunk(bf16* Ct, const bf16* base, int ld, int row0, int cols,
                                           const Attn<bf16>& a) {
  load_tile<NC, VEC>(Ct, base, ld, row0, a.S, cols);
  mdm::cp_async_commit();
  mdm::cp_async_wait<0>();
  __syncthreads();
}

// Per query tile and column chunk: the rows' max and exp-sum merged over
// the key tiles, then per key tile the logits again, w = bf16(p keep) and
// out += w . v.
template <typename OT, bool VEC>
__global__ void __launch_bounds__(AT_THREADS)
attn_fwd_wide(Attn<bf16> a, OT* __restrict__ out, View ov) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* Ct = reinterpret_cast<bf16*>(smem + CHUNK0);
  float* bs = reinterpret_cast<float*>(smem + BIAS0);
  const int nc = (a.dh + DC - 1) / DC;
  const int chunk = blockIdx.x % nc, q0 = blockIdx.x / nc * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, form = bias_form(a.bias), cols = min(DC, a.dh - chunk * DC);
  const size_t hb = a.in.head(b, h);
  const int nkt = (S + AT - 1) / AT;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int i0 = q0 + warp * 16 + g;  // this thread's rows: i0, i0 + 8
  int rb[2];
  bias_rows(rb, a, form, bias0, i0);
  auto logits = [&](float (&x)[8][4], int k0) {
    __syncthreads();  // every thread is past its reads of the bias and chunk tiles
    if (form) load_bias(bs, a.bias.p, bias0, form == 2 ? a.bias.bi : 0, q0, k0, S, form == 2);
    mdm::cp_async_commit();
    slab_product<VEC>(x, a.q + hb, ld, q0, a.k + hb, ld, k0, a, ring);
    finish_logits(x, a, bs, form, rb, k0);
  };

  float x[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int kt = 0; kt < nkt; ++kt) {
    logits(x, kt * AT);
    float mn[2] = {m[0], m[1]}, sum[2] = {0.0f, 0.0f};
    row_max(x, mn);
    quad_max(mn);
    tile_exps(x, mn, sum);
    quad_sum(sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * ex2((m[r] - mn[r]) * LOG2E) + sum[r];
      m[r] = mn[r];
    }
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll 1
  for (int kt = 0; kt < nkt; ++kt) {
    logits(x, kt * AT);
    float sum[2] = {0.0f, 0.0f};
    tile_exps(x, m, sum);
    uint32_t w[4][4];
    tile_pack(w, x, inv, a.drop.mode ? keep_bits<2>(a, b, h, i0, kt * AT + 2 * t) : 0u, a);
    load_chunk<DC, VEC>(Ct, a.v + hb + chunk * DC, ld, kt * AT, cols, a);
    tile_pv<DC, DC>(o, w, Ct, min(4, (S - kt * AT + 15) >> 4));
  }
  store_out<DC, VEC>(o, out + ov.head(b, h) + chunk * DC, ov.ld, i0, S, cols);
}

// Per query tile and column chunk, as attention_bwd.cu's dq kernel: walk 1
// over the key tiles, dw = dO . v^T and the logits, online per row the max
// m, the exp-sum l and A = sum e * keep * dw, so delta = A / l; the row
// statistics (m, 1/l, delta) go to stats[3][B*H*S] (chunk 0). Walk 2: dw
// and the logits again, p = e / l, dlog = p (keep dw - delta) * scale
// rounded to bf16 in registers and dq += dlog . k.
template <bool VEC>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dq_wide(Attn<bf16> a, const bf16* __restrict__ dout, View ov, bf16* __restrict__ dq,
                 float* __restrict__ stats, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* Ct = reinterpret_cast<bf16*>(smem + CHUNK0);
  float* bs = reinterpret_cast<float*>(smem + BIAS0);
  const int nc = (a.dh + DC - 1) / DC;
  const int chunk = blockIdx.x % nc, q0 = blockIdx.x / nc * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, form = bias_form(a.bias), cols = min(DC, a.dh - chunk * DC);
  const size_t hb = a.in.head(b, h);
  const bf16* cb = dout + ov.head(b, h);
  const int nkt = (S + AT - 1) / AT;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int i0 = q0 + warp * 16 + g;
  const Dropout& d = a.drop;
  int rb[2];
  bias_rows(rb, a, form, bias0, i0);
  auto products = [&](float (&dw)[8][4], float (&x)[8][4], int k0) {
    __syncthreads();
    if (form) load_bias(bs, a.bias.p, bias0, form == 2 ? a.bias.bi : 0, q0, k0, S, form == 2);
    mdm::cp_async_commit();
    slab_product<VEC>(dw, cb, ov.ld, q0, a.v + hb, ld, k0, a, ring);
    slab_product<VEC>(x, a.q + hb, ld, q0, a.k + hb, ld, k0, a, ring);
    finish_logits(x, a, bs, form, rb, k0);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, A[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int kt = 0; kt < nkt; ++kt) {
    float dw[8][4], x[8][4];
    products(dw, x, kt * AT);
    const uint32_t kw = d.mode ? keep_bits<2>(a, b, h, i0, kt * AT + 2 * t) : 0u;
    float mn[2] = {m[0], m[1]}, sum[2] = {0.0f, 0.0f}, dot[2] = {0.0f, 0.0f};
    row_max(x, mn);
    quad_max(mn);
    tile_exps(x, mn, sum);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot[e >> 1] += x[n][e] * (keep_factor(d, kw, 4 * n + e) * dw[n][e]);
    quad_sum(sum);
    quad_sum(dot);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float corr = ex2((m[r] - mn[r]) * LOG2E);
      l[r] = l[r] * corr + sum[r];
      A[r] = A[r] * corr + dot[r];
      m[r] = mn[r];
    }
  }
  float inv[2], delta[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.0f / l[r];
    delta[r] = A[r] * inv[r];
    ml[r] = m[r] * LOG2E;
  }
  if (chunk == 0 && t == 0) {
    const size_t n = (size_t)B * a.H * S, o = ((size_t)b * a.H + h) * S + i0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (i0 + 8 * r < S) {
        stats[o + 8 * r] = m[r];
        stats[n + o + 8 * r] = inv[r];
        stats[2 * n + o + 8 * r] = delta[r];
      }
    }
  }

  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 1
  for (int kt = 0; kt < nkt; ++kt) {
    float dw[8][4], x[8][4];
    products(dw, x, kt * AT);
    const uint32_t kw = d.mode ? keep_bits<2>(a, b, h, i0, kt * AT + 2 * t) : 0u;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(x[n][e], LOG2E, -ml[e >> 1])) * inv[e >> 1];
        x[n][e] = p * (keep_factor(d, kw, 4 * n + e) * dw[n][e] - delta[e >> 1]) * a.scale;
      }
    uint32_t gw[4][4];
    pack_tile(gw, x);
    load_chunk<DC, VEC>(Ct, a.k + hb + chunk * DC, ld, kt * AT, cols, a);
    tile_pv<DC, DC>(acc, gw, Ct, min(4, (S - kt * AT + 15) >> 4));
  }
  store_out<DC, VEC>(acc, dq + hb + chunk * DC, ld, i0, S, cols);
}

// Per key tile and column chunk, as attention_bwd.cu's dk/dv kernel: walks
// the query tiles with their saved statistics. With keys as rows: p^T from
// the logits k . q^T, w^T = p^T keep rounded to bf16, dv += w^T . dO; dw^T
// = v . dO^T; dlog^T = p^T (keep dw^T - delta) * scale rounded to bf16, dk
// += dlog^T . q.
template <bool VEC>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dkv_wide(Attn<bf16> a, const bf16* __restrict__ dout, View ov,
                  const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* Ct = reinterpret_cast<bf16*>(smem + CHUNK0);
  float* bs = reinterpret_cast<float*>(smem + BIAS0);
  float* sd = reinterpret_cast<float*>(smem + STATS0);  // m, 1/l, delta of the query tile
  float* rowb = reinterpret_cast<float*>(smem + ROWB0);  // the key-padding row's values
  const int nc = (a.dh + KV_DC - 1) / KV_DC;
  const int chunk = blockIdx.x % nc, k0 = blockIdx.x / nc * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, form = bias_form(a.bias);
  const int cols = min(KV_DC, a.dh - chunk * KV_DC);
  const size_t hb = a.in.head(b, h);
  const bf16 *qb = a.q + hb, *cb = dout + ov.head(b, h);
  const size_t n = (size_t)B * a.H * S;
  const float* srow = stats + ((size_t)b * a.H + h) * S;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int j0 = k0 + warp * 16 + g;  // this thread's keys: j0, j0 + 8
  const int nqt = (S + AT - 1) / AT;
  // A bias value (query i, key j) of a staged row starts at (o & 3) of
  // flat offset o = bias0 + i*bi + k0 (load_bias): ob + i*b3 modulo 4.
  const int ob = (int)((bias0 + k0) & 3), b3 = (int)(a.bias.bi & 3);
  const Dropout& d = a.drop;
  if (form == 1) load_bias(rowb, a.bias.p, bias0, 0, 0, k0, S, false);  // rides with the first stats

  float gk[KV_DC / 8][4], gv[KV_DC / 8][4];
#pragma unroll
  for (int c = 0; c < KV_DC / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.0f;
#pragma unroll 1
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * AT, pairs = min(4, (S - q0 + 15) >> 4);
    __syncthreads();  // every thread is past its reads of the statistics, bias and chunk tiles
    for (int v = threadIdx.x; v < 3 * AT; v += AT_THREADS) {
      const int i = q0 + v % AT;
      cp_async4(sd + v, i < S ? srow + (v / AT) * n + i : srow, i < S ? 4 : 0);
    }
    if (form == 2)
      load_bias(bs, a.bias.p, bias0, a.bias.bi, q0, k0, S, true);
    mdm::cp_async_commit();
    float x[8][4];
    slab_product<VEC>(x, a.k + hb, ld, k0, qb, ld, q0, a, ring);  // x[n][e]: key j0 + 8 (e >> 1),
                                                             // query q0 + 8n + 2t + (e & 1)
    const uint32_t kw = d.mode ? keep_bits<2, true>(a, b, h, j0, q0 + 2 * t) : 0u;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nn + 2 * t + (e & 1), jr = warp * 16 + g + 8 * (e >> 1);
        const float bias = form == 1   ? rowb[ob + jr]
                           : form == 2 ? bs[c * LDB + ((ob + (q0 + c) * b3) & 3) + jr]
                                       : 0.0f;
        const float xv = q0 + c < S ? fmaf(x[nn][e], a.scale, bias) : -INFINITY;
        x[nn][e] = ex2(fmaf(xv, LOG2E, -sd[c] * LOG2E)) * sd[AT + c];
      }
    uint32_t pw[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int nn = 2 * ks + hf, e = 2 * r;
          pw[ks][2 * hf + r] = pack_bf16(x[nn][e] * keep_factor(d, kw, 4 * nn + e),
                                         x[nn][e + 1] * keep_factor(d, kw, 4 * nn + e + 1));
        }
    load_chunk<KV_DC, VEC>(Ct, cb + chunk * KV_DC, ov.ld, q0, cols, a);
    tile_pv<KV_DC, KV_DC>(gv, pw, Ct, pairs);
    float dw[8][4];
    slab_product<VEC>(dw, a.v + hb, ld, k0, cb, ov.ld, q0, a, ring);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nn + 2 * t + (e & 1);
        x[nn][e] = x[nn][e] * (keep_factor(d, kw, 4 * nn + e) * dw[nn][e] - sd[2 * AT + c]) *
                   a.scale;
      }
    pack_tile(pw, x);
    load_chunk<KV_DC, VEC>(Ct, qb + chunk * KV_DC, ld, q0, cols, a);  // slab_product's syncs:
    tile_pv<KV_DC, KV_DC>(gk, pw, Ct, pairs);                    // every thread is past dv's
  }
  store_out<KV_DC, VEC>(gk, dk + hb + chunk * KV_DC, ld, j0, S, cols);
  store_out<KV_DC, VEC>(gv, dv + hb + chunk * KV_DC, ld, j0, S, cols);
}

template <typename K>
cudaError_t wide_opt_in(K kernel, bool& done) {
  return opt_in(kernel, done, BYTES);
}

template <typename OT, bool VEC>
cudaError_t launch_fwd_as(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  static bool done = false;
  const cudaError_t e = wide_opt_in(attn_fwd_wide<OT, VEC>, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((c.S + AT - 1) / AT * ((a.dh + DC - 1) / DC), c.H, c.B);
  attn_fwd_wide<OT, VEC><<<grid, AT_THREADS, BYTES, st>>>(a, static_cast<OT*>(c.out), c.ov);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bwd_as(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  static bool done_dq = false, done_kv = false;
  cudaError_t e = wide_opt_in(attn_bwd_dq_wide<VEC>, done_dq);
  if (e == cudaSuccess) e = wide_opt_in(attn_bwd_dkv_wide<VEC>, done_kv);
  if (e != cudaSuccess) return e;
  const int tiles = (c.S + AT - 1) / AT;
  const bf16* dout = static_cast<const bf16*>(c.dout);
  attn_bwd_dq_wide<VEC><<<dim3(tiles * ((a.dh + DC - 1) / DC), c.H, c.B), AT_THREADS, BYTES,
                          st>>>(a, dout, c.ov, static_cast<bf16*>(c.dq), c.stats, c.B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attn_bwd_dkv_wide<VEC><<<dim3(tiles * ((a.dh + KV_DC - 1) / KV_DC), c.H, c.B), AT_THREADS,
                           BYTES, st>>>(a, dout, c.ov, c.stats, static_cast<bf16*>(c.dk),
                                        static_cast<bf16*>(c.dv), c.B);
  return cudaGetLastError();
}

}  // namespace

namespace mdm {
namespace attn {

cudaError_t launch_fwd_wide(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  if (c.out_dtype == 1)
    return a.vec ? launch_fwd_as<bf16, true>(a, c, st) : launch_fwd_as<bf16, false>(a, c, st);
  return a.vec ? launch_fwd_as<float, true>(a, c, st) : launch_fwd_as<float, false>(a, c, st);
}

cudaError_t launch_bwd_wide(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  return a.vec ? launch_bwd_as<true>(a, c, st) : launch_bwd_as<false>(a, c, st);
}

}  // namespace attn
}  // namespace mdm
