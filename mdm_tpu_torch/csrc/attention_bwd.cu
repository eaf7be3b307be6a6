// The bf16 backward of the attention core (see attention.cu for the design):
// a dq kernel per 64-row query tile, which also leaves each row's
// statistics, and a dk/dv kernel per 64-row key tile that reads them. Both
// run 4 warps of mma.sync m16n8k16 with every score, probability and dlog
// fragment in registers, and bring their tiles through a cp.async ring.
// Both stop at the batch element's live extent (live_extent): the dq
// kernel's two walks end at its last live 64-key tile, and a dk/dv block
// whose keys all lie past it stores zero dk and dv (its p is exactly 0)
// without walking a query tile.

#include "attention.cuh"

namespace {

using mdm::bf16;
using mdm::Dropout;
using namespace mdm::attn;

// The output columns a block accumulates: a head dim above 128 splits its
// columns over blocks of 128 (256) or 64 (192: 96 spilled registers), each
// of which recomputes the scores (the dq or dk/dv accumulators of the whole
// head would not fit the registers).
template <int DH>
__host__ __device__ constexpr int chunks() {
  return DH <= 128 ? 1 : DH % 128 ? DH / 64 : DH / 128;
}

// dq kernel: the keep words of the first RES_TILES key tiles ([RES_TILES]
// [128], one per thread and tile: drawn in the first walk, read in the
// second), Q, dO, then a ring of stages, each a V or K tile and a K tile's
// bias (as the forward's: three stages, two with a full bias).
template <int DH>
struct DqSmem {
  static constexpr int TILE = AT * (DH + 8) * 2;
  static constexpr int KEPT = RES_TILES * AT_THREADS * 4;
  __host__ __device__ static constexpr int stages(int form) { return form == 2 ? 2 : 3; }
  __host__ __device__ static constexpr int stage(int form) {
    return TILE + (form == 2 ? AT * LDB * 4 : form == 1 ? LDB * 4 : 0);
  }
  __host__ __device__ static constexpr int bytes(int form) {
    return KEPT + 2 * TILE + stages(form) * stage(form);
  }
  __host__ __device__ static constexpr int max_bytes() {
    return bytes(2) > bytes(1) ? bytes(2) : bytes(1);
  }
};

// dk/dv kernel: the block's K and V tiles and its key-padding row's bias,
// then a ring of stages, each a query tile's Q, dO, statistics [3][64]
// and, for a full bias, its [64][LDB] tile: two stages where they fit.
template <int DH>
struct KvSmem {
  static constexpr int TILE = AT * (DH + 8) * 2;
  static constexpr int STATS = 3 * AT * 4;
  static constexpr int FIXED = 2 * TILE + LDB * 4;
  __host__ __device__ static constexpr int stage(int form) {
    return 2 * TILE + STATS + (form == 2 ? AT * LDB * 4 : 0);
  }
  __host__ __device__ static constexpr int stages(int form) {
    return FIXED + 2 * stage(form) <= MAX_SMEM ? 2 : 1;
  }
  __host__ __device__ static constexpr int bytes(int form) {
    return FIXED + stages(form) * stage(form);
  }
  __host__ __device__ static constexpr int max_bytes() {
    return bytes(2) > bytes(1) ? bytes(2) : bytes(1);
  }
};
static_assert(DqSmem<256>::max_bytes() <= MAX_SMEM && KvSmem<256>::max_bytes() <= MAX_SMEM,
              "the widest instances must fit");

// Per query tile (and column chunk) of a head. Walk 1 over the key tiles
// (each value tile, then its key tile): dw = dO . v^T, the logits, the keep
// word, and online per row the max m, the exp-sum l and A = sum e * dp
// (dp = keep * dw), rescaled as the max grows, so delta = rowsum(dp * p) =
// A / l. The row statistics (m, 1/l, delta) go to stats[3][B*H*S] for the
// dk/dv kernel. Walk 2: dw and the logits again, p = e / l exact, dlog = p
// (dp - delta) * scale rounded to bf16 in registers and dq += dlog . k.
template <int DH, bool VEC>
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_bwd_dq_bf16(Attn<bf16> a, const bf16* __restrict__ dout, View ov, bf16* __restrict__ dq,
                 float* __restrict__ stats, int B) {
  using L = DqSmem<DH>;
  constexpr int NC = chunks<DH>(), DC = DH / NC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int form = bias_form(a.bias), stage = L::stage(form), nst = L::stages(form);
  uint32_t* kept = reinterpret_cast<uint32_t*>(smem) + threadIdx.x;  // [kt * AT_THREADS]
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::KEPT);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::KEPT + L::TILE);  // dout rows
  unsigned char* ring = smem + L::KEPT + 2 * L::TILE;
  const int chunk = blockIdx.x % NC, q0 = (blockIdx.x / NC) * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h);
  const bf16 *kb = a.k + hb, *vb = a.v + hb;
  // Two walks of (V, K) tile pairs over the key tiles up to the live extent
  // (set once tiles 0 and 1, V and K tile 0 at any extent, are in flight).
  int nkt = (S + AT - 1) / AT, total = 4 * nkt;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int i0 = q0 + warp * 16 + g;       // this thread's rows: i0, i0 + 8
  const bool active = q0 + warp * 16 < S;  // the warp has a row below S

  auto issue = [&](int u, int slot) {
    if (u < total) {
      const int w = u % (2 * nkt), kt = w >> 1;
      const bool is_k = w & 1;
      unsigned char* st = ring + slot * stage;
      load_tile<DH, VEC>(reinterpret_cast<bf16*>(st), is_k ? kb : vb, ld, kt * AT, S, dh);
      if (is_k && form)
        load_bias(reinterpret_cast<float*>(st + L::TILE), a.bias.p, bias0,
                  form == 2 ? a.bias.bi : 0, q0, kt * AT, S, form == 2);
    }
    mdm::cp_async_commit();
  };
  // Wait for tile u (tile u + 1 may stay in flight), then start tile u +
  // nst - 1 into the stage of tile u - 1: every thread is past it.
  int u = 0, rd = 0;
  auto next = [&]() {
    if (nst == 3) mdm::cp_async_wait<1>();
    else mdm::cp_async_wait<0>();
    __syncthreads();
    issue(u + nst - 1, rd == 0 ? nst - 1 : rd - 1);
    unsigned char* st = ring + rd * stage;
    rd = rd + 1 == nst ? 0 : rd + 1;
    ++u;
    return st;
  };
  const float fb = first_bias(a.bias, bias0, S, AT);
  load_tile<DH, VEC>(Qs, a.q + hb, ld, q0, S, dh);  // Q and dO ride in group 0 with tile 0
  load_tile<DH, VEC>(Cs, dout + ov.head(b, h), ov.ld, q0, S, dh);
  issue(0, 0);
  if (nst == 3) issue(1, 1);
  const int full = nkt;
  nkt = (live_extent<AT_THREADS / 32>(a.bias, bias0, S, AT, fb) + AT - 1) / AT;
  total = 4 * nkt;
  count_tiles(a.tiles, nkt, full);

  int rb[2];
  bias_rows(rb, a, form, bias0, i0);
  auto logits = [&](float (&x)[8][4], const unsigned char* st, int k0) {
    tile_logits<DH>(x, a, Qs, reinterpret_cast<const bf16*>(st),
                    reinterpret_cast<const float*>(st + L::TILE), form, rb, k0);
  };
  const Dropout& d = a.drop;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, A[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int kt = 0; kt < nkt; ++kt) {
    const int pairs = min(4, (S - kt * AT + 15) >> 4);
    const bf16* Vs = reinterpret_cast<const bf16*>(next());
    float dw[8][4];
    uint32_t kw = 0;
    if (active) {
      qk_tile<DH>(dw, Cs, Vs, pairs);
      if (d.mode) {
        kw = keep_bits<2>(a, b, h, i0, kt * AT + 2 * t);
        if (kt < RES_TILES) kept[kt * AT_THREADS] = kw;
      }
    }
    const unsigned char* st = next();
    if (!active) continue;
    float x[8][4];
    logits(x, st, kt * AT);
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
  if (active && chunk == 0 && t == 0) {
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
    const int pairs = min(4, (S - kt * AT + 15) >> 4);
    const bf16* Vs = reinterpret_cast<const bf16*>(next());
    float dw[8][4];
    uint32_t kw = 0;
    if (active) {
      qk_tile<DH>(dw, Cs, Vs, pairs);
      if (d.mode)
        kw = kt < RES_TILES ? kept[kt * AT_THREADS] : keep_bits<2>(a, b, h, i0, kt * AT + 2 * t);
    }
    const unsigned char* st = next();
    if (!active) continue;
    float x[8][4];
    logits(x, st, kt * AT);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(x[n][e], LOG2E, -ml[e >> 1])) * inv[e >> 1];
        x[n][e] = p * (keep_factor(d, kw, 4 * n + e) * dw[n][e] - delta[e >> 1]) * a.scale;
      }
    uint32_t gw[4][4];
    pack_tile(gw, x);
    tile_pv<DH, DC>(acc, gw, reinterpret_cast<const bf16*>(st) + chunk * DC, pairs);
  }
  if (active) store_out<DC, VEC>(acc, dq + hb + chunk * DC, ld, i0, S, dh - chunk * DC);
}

// Per key tile (and column chunk) of a head: walks the query tiles with
// their saved statistics, the block's K and V resident. With keys as rows:
// p^T from the logits k . q^T, w^T = p^T keep rounded to bf16, dv += w^T .
// dO; dw^T = v . dO^T; dlog^T = p^T (keep dw^T - delta) * scale rounded to
// bf16, dk += dlog^T . q. dk and dv stay in registers: no float atomics.
template <int DH, bool VEC>
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_bwd_dkv_bf16(Attn<bf16> a, const bf16* __restrict__ dout, View ov,
                  const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int B) {
  using L = KvSmem<DH>;
  constexpr int NC = chunks<DH>(), DC = DH / NC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int form = bias_form(a.bias), stage = L::stage(form), nst = L::stages(form);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::TILE);
  float* rowb = reinterpret_cast<float*>(smem + 2 * L::TILE);  // the key-padding row's values
  unsigned char* ring = smem + L::FIXED;
  const int chunk = blockIdx.x % NC, k0 = (blockIdx.x / NC) * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h);
  const bf16 *qb = a.q + hb, *cb = dout + ov.head(b, h);
  const size_t n = (size_t)B * a.H * S;
  const float* srow = stats + ((size_t)b * a.H + h) * S;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int j0 = k0 + warp * 16 + g;       // this thread's keys: j0, j0 + 8
  const bool active = k0 + warp * 16 < S;  // the warp has a key below S
  int nqt = (S + AT - 1) / AT;  // 0 once the block's keys prove to lie past the live extent
  // A bias value (query i, key j) of a staged row starts at (o & 3) of
  // flat offset o = bias0 + i*bi + k0 (load_bias): ob + i*b3 modulo 4.
  const int ob = (int)((bias0 + k0) & 3), b3 = (int)(a.bias.bi & 3);

  auto issue = [&](int qt, int slot) {
    if (qt < nqt) {
      unsigned char* st = ring + slot * stage;
      const int q0 = qt * AT;
      load_tile<DH, VEC>(reinterpret_cast<bf16*>(st), qb, ld, q0, S, dh);
      load_tile<DH, VEC>(reinterpret_cast<bf16*>(st + L::TILE), cb, ov.ld, q0, S, dh);
      float* sd = reinterpret_cast<float*>(st + 2 * L::TILE);
      for (int v = threadIdx.x; v < 3 * AT; v += AT_THREADS) {
        const int i = q0 + v % AT;
        cp_async4(sd + v, i < S ? srow + (v / AT) * n + i : srow, i < S ? 4 : 0);
      }
      if (form == 2)
        load_bias(reinterpret_cast<float*>(st + 2 * L::TILE + L::STATS), a.bias.p, bias0,
                  a.bias.bi, q0, k0, S, true);
    }
    mdm::cp_async_commit();
  };
  const float fb = first_bias(a.bias, bias0, S, AT);
  load_tile<DH, VEC>(Ks, a.k + hb, ld, k0, S, dh);  // K, V and the row ride in group 0 with tile 0
  load_tile<DH, VEC>(Vs, a.v + hb, ld, k0, S, dh);
  if (form == 1) load_bias(rowb, a.bias.p, bias0, 0, 0, k0, S, false);
  issue(0, 0);
  const int full = nqt;
  if (k0 >= live_extent<AT_THREADS / 32>(a.bias, bias0, S, AT, fb)) nqt = 0;
  count_tiles(a.tiles, nqt, full);

  float gk[DC / 8][4], gv[DC / 8][4];
#pragma unroll
  for (int c = 0; c < DC / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.0f;
  const Dropout& d = a.drop;
#pragma unroll 1
  for (int qt = 0; qt < nqt; ++qt) {
    if (nst == 2) {
      issue(qt + 1, (qt + 1) & 1);
      mdm::cp_async_wait<1>();
    } else {
      mdm::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = ring + (nst == 2 ? qt & 1 : 0) * stage;
    if (active) {
      const int q0 = qt * AT, pairs = min(4, (S - q0 + 15) >> 4);
      const bf16* Qs = reinterpret_cast<const bf16*>(st);
      const bf16* Cs = reinterpret_cast<const bf16*>(st + L::TILE);
      const float* sd = reinterpret_cast<const float*>(st + 2 * L::TILE);  // m, 1/l, delta
      const float* bs = reinterpret_cast<const float*>(st + 2 * L::TILE + L::STATS);
      float x[8][4];
      qk_tile<DH>(x, Ks, Qs, pairs);  // x[n][e]: key j0 + 8 (e >> 1), query q0 + 8n + 2t + (e & 1)
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
      tile_pv<DH, DC>(gv, pw, Cs + chunk * DC, pairs);
      float dw[8][4];
      qk_tile<DH>(dw, Vs, Cs, pairs);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nn + 2 * t + (e & 1);
          x[nn][e] = x[nn][e] * (keep_factor(d, kw, 4 * nn + e) * dw[nn][e] - sd[2 * AT + c]) *
                     a.scale;
        }
      pack_tile(pw, x);
      tile_pv<DH, DC>(gk, pw, Qs + chunk * DC, pairs);
    }
    __syncthreads();
    if (nst == 1) issue(qt + 1, 0);
  }
  if (!nqt) mdm::cp_async_wait<0>();  // a block past the extent: its copies land before it exits
  if (active) {
    store_out<DC, VEC>(gk, dk + hb + chunk * DC, ld, j0, S, dh - chunk * DC);
    store_out<DC, VEC>(gv, dv + hb + chunk * DC, ld, j0, S, dh - chunk * DC);
  }
}

template <int DH, bool VEC>
cudaError_t bwd_opt_in() {
  static bool done_dq = false, done_kv = false;
  cudaError_t e = opt_in(attn_bwd_dq_bf16<DH, VEC>, done_dq, DqSmem<DH>::max_bytes());
  if (e == cudaSuccess) e = opt_in(attn_bwd_dkv_bf16<DH, VEC>, done_kv, KvSmem<DH>::max_bytes());
  return e;
}

template <int DH, bool VEC>
cudaError_t launch_dh(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  cudaError_t e = bwd_opt_in<DH, VEC>();
  if (e != cudaSuccess) return e;
  const int form = bias_form(a.bias);
  const dim3 grid((c.S + AT - 1) / AT * chunks<DH>(), c.H, c.B);
  const bf16* dout = static_cast<const bf16*>(c.dout);
  attn_bwd_dq_bf16<DH, VEC><<<grid, AT_THREADS, DqSmem<DH>::bytes(form), st>>>(
      a, dout, c.ov, static_cast<bf16*>(c.dq), c.stats, c.B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_bf16<DH, VEC><<<grid, AT_THREADS, KvSmem<DH>::bytes(form), st>>>(
      a, dout, c.ov, c.stats, static_cast<bf16*>(c.dk), static_cast<bf16*>(c.dv), c.B);
  return cudaGetLastError();
}

// VEC: 16-byte row copies (load_tile), else the 2-byte instances.
template <int DH>
cudaError_t launch_dh(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  return a.vec ? launch_dh<DH, true>(a, c, st) : launch_dh<DH, false>(a, c, st);
}

template <int DH>
cudaError_t occupancy_dh(int form, int kernel, int* blocks) {
  const cudaError_t e = bwd_opt_in<DH, true>();
  if (e != cudaSuccess) return e;
  return kernel == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, attn_bwd_dq_bf16<DH, true>, AT_THREADS, DqSmem<DH>::bytes(form))
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, attn_bwd_dkv_bf16<DH, true>, AT_THREADS, KvSmem<DH>::bytes(form));
}

}  // namespace

namespace mdm {
namespace attn {

cudaError_t launch_bwd(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(a.bias.p) % 16) return cudaErrorInvalidValue;  // load_bias
  if (c.out) {  // the forward's out, recomputed by the forward kernel itself
    const cudaError_t e = launch_fwd(a, c, st);
    if (e != cudaSuccess) return e;
  }
  if (a.dh > MAX_TILE_DH) return launch_bwd_wide(a, c, st);
  switch (padded_head_dim(a.dh)) {
    case 32: return launch_dh<32>(a, c, st);
    case 64: return launch_dh<64>(a, c, st);
    case 96: return launch_dh<96>(a, c, st);
    case 128: return launch_dh<128>(a, c, st);
    case 192: return launch_dh<192>(a, c, st);
    case 256: return launch_dh<256>(a, c, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_occupancy(int dh, int form, int kernel, int* blocks) {
  switch (padded_head_dim(dh)) {
    case 32: return occupancy_dh<32>(form, kernel, blocks);
    case 64: return occupancy_dh<64>(form, kernel, blocks);
    case 96: return occupancy_dh<96>(form, kernel, blocks);
    case 128: return occupancy_dh<128>(form, kernel, blocks);
    case 192: return occupancy_dh<192>(form, kernel, blocks);
    case 256: return occupancy_dh<256>(form, kernel, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace mdm
