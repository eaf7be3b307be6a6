// The bf16 forward of the attention core (see attention.cu for the design):
// one block of 4 warps per 64-row query tile, mma.sync m16n8k16 from
// ldmatrix, the row's logits in registers up to S = 256 (RESIDENT) for the
// head dims up to 128, two passes over the keys otherwise. The key walk
// stops at the batch element's last live 64-key tile (live_extent: its
// key-padding row, read while the stream's first two tiles are in flight);
// the stream, the keep draws and the resident tiles follow it.

#include "attention.cuh"

namespace {

using mdm::bf16;
using namespace mdm::attn;

// The keep draws of a resident row ([RES_TILES][128] words, one per thread
// and key tile), Q, then a ring of stages, each a K or V tile ([64][DH+8]
// bf16) and a K tile's bias: [64][LDB] f32 for a full bias (two stages,
// so that two blocks fit an SM at Dh=128), one [LDB] row for a key-padding
// row or none (three stages).
template <int DH>
struct FwdSmem {
  static constexpr int LD = DH + 8;
  static constexpr int TILE = AT * LD * 2;
  static constexpr int KEPT = RES_TILES * AT_THREADS * 4;  // the keep words' bytes; Q follows
  __host__ __device__ static constexpr int stages(int form) { return form == 2 ? 2 : 3; }
  __host__ __device__ static constexpr int stage(int form) {
    return TILE + (form == 2 ? AT * LDB * 4 : form == 1 ? LDB * 4 : 0);
  }
  __host__ __device__ static constexpr int bytes(int form) {
    return KEPT + TILE + stages(form) * stage(form);
  }
  __host__ __device__ static constexpr int max_bytes() {  // bytes(1) >= bytes(0)
    return bytes(2) > bytes(1) ? bytes(2) : bytes(1);
  }
};
static_assert(FwdSmem<256>::max_bytes() <= MAX_SMEM, "the widest instance must fit");

// RESIDENT (S <= RES_TILES * 64): the row's logits stay in registers, K and
// the bias are read once; the stream is the key tiles, then the value
// tiles. Otherwise two passes over the keys, one tile resident at a time:
// the rows' max and exp-sum merged tile by tile, then each key tile's
// logits again and its value tile. VEC: 16-byte row copies (load_tile);
// the 2-byte instances (!VEC) are two-pass only.
template <int DH, typename OT, bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_fwd_bf16(Attn<bf16> a, OT* __restrict__ out, View ov) {
  using L = FwdSmem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int form = bias_form(a.bias), stage = L::stage(form), nst = L::stages(form);
  uint32_t* kept = reinterpret_cast<uint32_t*>(smem) + threadIdx.x;  // [kt * AT_THREADS]
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::KEPT);
  unsigned char* ring = smem + L::KEPT + L::TILE;
  const int q0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = a.S, ld = a.in.ld, dh = a.dh;
  const size_t hb = a.in.head(b, h);
  const bf16 *kb = a.k + hb, *vb = a.v + hb;
  // Key tiles walked and tiles in the stream: a full walk's until the live
  // extent is read, with the stream's first tiles in flight.
  int nkt = (S + AT - 1) / AT, total = (RESIDENT ? 2 : 3) * nkt;
  const long long bias0 = (long long)b * a.bias.bb + (long long)h * a.bias.bh;
  const int i0 = q0 + warp * 16 + g;       // this thread's rows: i0, i0 + 8
  const bool active = q0 + warp * 16 < S;  // the warp has a row below S

  // Stream tile u into stage `slot`: key tiles 0..nkt-1, then the value
  // tiles (RESIDENT) or each key tile again followed by its value tile.
  // v_only: u is a value tile (RESIDENT), which no bias goes with.
  auto issue = [&](int u, int slot, bool v_only) {
    if (u < total) {
      int kt = u;
      bool is_v = false;
      if (v_only || u >= nkt) {
        kt = RESIDENT ? u - nkt : (u - nkt) >> 1;
        is_v = v_only || RESIDENT || ((u - nkt) & 1);
      }
      unsigned char* st = ring + slot * stage;
      load_tile<DH, VEC>(reinterpret_cast<bf16*>(st), is_v ? vb : kb, ld, kt * AT, S, dh);
      if (!is_v && form)
        load_bias(reinterpret_cast<float*>(st + L::TILE), a.bias.p, bias0,
                  form == 2 ? a.bias.bi : 0, q0, kt * AT, S, form == 2);
    }
    mdm::cp_async_commit();
  };
  // Wait for tile u (tile u + 1 may stay in flight), then start tile u +
  // nst - 1 into the stage of tile u - 1: every thread is past it.
  int u = 0, rd = 0;  // the next tile and its stage
  auto next = [&](bool v_only) {
    if (nst == 3) mdm::cp_async_wait<1>();
    else mdm::cp_async_wait<0>();
    __syncthreads();
    issue(u + nst - 1, rd == 0 ? nst - 1 : rd - 1, v_only);
    unsigned char* st = ring + rd * stage;
    rd = rd + 1 == nst ? 0 : rd + 1;
    ++u;
    return st;
  };
  const float fb = first_bias(a.bias, bias0, S, AT);
  load_tile<DH, VEC>(Qs, a.q + hb, ld, q0, S, dh);  // rides in group 0 with tile 0
  issue(0, 0, false);
  if (nst == 3) issue(1, 1, false);
  const int full = nkt;
  nkt = (live_extent<AT_THREADS / 32>(a.bias, bias0, S, AT, fb) + AT - 1) / AT;
  total = (RESIDENT ? 2 : 3) * nkt;
  count_tiles(a.tiles, nkt, full);
  if (nst == 3 && nkt == 1 && full > 1) {
    // Tile 1 of a one-tile walk is not key tile 1 (the value tile 0, or key
    // tile 0 again): once every copy has landed, fetch it over key tile 1.
    mdm::cp_async_wait<0>();
    __syncthreads();
    issue(1, 1, false);
  }

  int rb[2];
  bias_rows(rb, a, form, bias0, i0);
  float o[DH / 8][4];
  auto logits = [&](float (&x)[8][4], const unsigned char* st, int k0) {
    tile_logits<DH>(x, a, Qs, reinterpret_cast<const bf16*>(st),
                    reinterpret_cast<const float*>(st + L::TILE), form, rb, k0);
  };

  if constexpr (RESIDENT) {
    // The keep draws first, while nothing is resident; each thread reads
    // back only its own words.
    if (active && a.drop.mode) {
#pragma unroll 1
      for (int kt = 0; kt < nkt; ++kt)
        kept[kt * AT_THREADS] = keep_bits<8>(a, b, h, i0, kt * AT + 2 * t);
    }
    // The logits of every key tile, resident (the switch picks the tile's
    // registers), and the rows' max.
    float sx[RES_TILES][8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const unsigned char* st = next(false);
      if (!active) continue;
      switch (kt) {
        case 0: logits(sx[0], st, 0); row_max(sx[0], mx); break;
        case 1: logits(sx[1], st, AT); row_max(sx[1], mx); break;
        case 2: logits(sx[2], st, 2 * AT); row_max(sx[2], mx); break;
        default: logits(sx[3], st, 3 * AT); row_max(sx[3], mx); break;
      }
    }
    // The rows' exact max and exp-sum from the resident logits; then w,
    // packed: what stays resident for the products halves.
    uint32_t w[RES_TILES][4][4];
    if (active) {
      float sum[2] = {0.0f, 0.0f};
      quad_max(mx);
#pragma unroll
      for (int kt = 0; kt < RES_TILES; ++kt)
        if (kt < nkt) tile_exps(sx[kt], mx, sum);
      quad_sum(sum);
      const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
      for (int kt = 0; kt < RES_TILES; ++kt)
        if (kt < nkt) tile_pack(w[kt], sx[kt], inv, a.drop.mode ? kept[kt * AT_THREADS] : 0u, a);
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const bf16* Vs = reinterpret_cast<const bf16*>(next(true));
      if (!active) continue;
      const int pairs = min(4, (S - kt * AT + 15) >> 4);
      switch (kt) {
        case 0: tile_pv<DH, DH>(o, w[0], Vs, pairs); break;
        case 1: tile_pv<DH, DH>(o, w[1], Vs, pairs); break;
        case 2: tile_pv<DH, DH>(o, w[2], Vs, pairs); break;
        default: tile_pv<DH, DH>(o, w[3], Vs, pairs); break;
      }
    }
  } else {
    float x[8][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const unsigned char* st = next(false);
      if (!active) continue;
      logits(x, st, kt * AT);
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
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const unsigned char* st = next(false);
      uint32_t w[4][4];
      if (active) {
        float sum[2] = {0.0f, 0.0f};
        logits(x, st, kt * AT);
        tile_exps(x, m, sum);
        tile_pack(w, x, inv, a.drop.mode ? keep_bits<2>(a, b, h, i0, kt * AT + 2 * t) : 0u, a);
      }
      const bf16* Vs = reinterpret_cast<const bf16*>(next(false));
      if (active) tile_pv<DH, DH>(o, w, Vs, min(4, (S - kt * AT + 15) >> 4));
    }
  }
  if (active) store_out<DH, VEC>(o, out + ov.head(b, h), ov.ld, i0, S, dh);
}

// The head dims up to 128 have a resident instance; above, the row's
// logits and the accumulators would not fit the registers together.
template <int DH>
__host__ __device__ constexpr bool has_resident() { return DH <= 128; }

template <int DH, typename OT, bool RESIDENT, bool VEC = true>
cudaError_t fwd_opt_in() {
  static bool done = false;
  return opt_in(attn_fwd_bf16<DH, OT, RESIDENT, VEC>, done, FwdSmem<DH>::max_bytes());
}

template <int DH, typename OT>
cudaError_t launch_dh(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  const dim3 grid((c.S + AT - 1) / AT, c.H, c.B);
  const int bytes = FwdSmem<DH>::bytes(bias_form(a.bias));
  OT* out = static_cast<OT*>(c.out);
  if (!a.vec) {
    const cudaError_t e = fwd_opt_in<DH, OT, false, false>();
    if (e != cudaSuccess) return e;
    attn_fwd_bf16<DH, OT, false, false><<<grid, AT_THREADS, bytes, st>>>(a, out, c.ov);
    return cudaGetLastError();
  }
  if constexpr (has_resident<DH>()) {
    if (c.S <= RES_TILES * AT) {
      const cudaError_t e = fwd_opt_in<DH, OT, true>();
      if (e != cudaSuccess) return e;
      attn_fwd_bf16<DH, OT, true, true><<<grid, AT_THREADS, bytes, st>>>(a, out, c.ov);
      return cudaGetLastError();
    }
  }
  const cudaError_t e = fwd_opt_in<DH, OT, false>();
  if (e != cudaSuccess) return e;
  attn_fwd_bf16<DH, OT, false, true><<<grid, AT_THREADS, bytes, st>>>(a, out, c.ov);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  return c.out_dtype == 1 ? launch_dh<DH, bf16>(a, c, st) : launch_dh<DH, float>(a, c, st);
}

template <int DH, typename OT>
cudaError_t occupancy_dh(int form, bool resident, int* blocks) {
  if constexpr (has_resident<DH>()) {
    if (resident) {
      const cudaError_t e = fwd_opt_in<DH, OT, true>();
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn_fwd_bf16<DH, OT, true, true>,
                                                           AT_THREADS, FwdSmem<DH>::bytes(form));
    }
  }
  const cudaError_t e = fwd_opt_in<DH, OT, false>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn_fwd_bf16<DH, OT, false, true>,
                                                       AT_THREADS, FwdSmem<DH>::bytes(form));
}

template <int DH>
cudaError_t occupancy_dh(int out_dtype, int form, bool resident, int* blocks) {
  return out_dtype == 1 ? occupancy_dh<DH, bf16>(form, resident, blocks)
                        : occupancy_dh<DH, float>(form, resident, blocks);
}

}  // namespace

namespace mdm {
namespace attn {

cudaError_t launch_fwd(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(a.bias.p) % 16) return cudaErrorInvalidValue;  // load_bias
  if (a.dh > MAX_TILE_DH) return launch_fwd_wide(a, c, st);
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

cudaError_t fwd_occupancy(int dh, int out_dtype, int form, bool resident, int* blocks) {
  switch (padded_head_dim(dh)) {
    case 32: return occupancy_dh<32>(out_dtype, form, resident, blocks);
    case 64: return occupancy_dh<64>(out_dtype, form, resident, blocks);
    case 96: return occupancy_dh<96>(out_dtype, form, resident, blocks);
    case 128: return occupancy_dh<128>(out_dtype, form, resident, blocks);
    case 192: return occupancy_dh<192>(out_dtype, form, resident, blocks);
    case 256: return occupancy_dh<256>(out_dtype, form, resident, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace mdm
