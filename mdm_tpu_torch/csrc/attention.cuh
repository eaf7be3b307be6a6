// What the attention core's sources share (attention.cu: the f32 row
// kernels above head dim 256 and the C entry points; attention_fwd.cu: the
// bf16 forward; attention_bwd.cu: the bf16 backward; attention_f32.cu: the
// f32 tile kernels): the operand views, the bias and
// dropout arguments, and the mma.sync m16n8k16 fragment helpers. The design
// is described at the top of attention.cu.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace mdm {
namespace attn {

constexpr int AT = 64, AT_THREADS = 128;  // a block: 4 warps over a 64-row tile
constexpr int MAX_SMEM = 232448;          // an H100 block's dynamic shared memory
constexpr int RES_TILES = 4;              // 64-key tiles resident per row: S <= 256
constexpr int LDB = AT + 4;               // f32 bias row: 64 values after up to 3 of slack
constexpr float LOG2E = 1.4426950408889634f;

// The instance a head dim runs in: the least of 32, 64, 96, 128, 192, 256
// that holds it, for 1 to 256; else 0 (above 256 the wide kernels of
// attention_wide.cu run it). The kernels read the true dh columns, zero the
// rest of each shared-memory tile and store only the true columns.
constexpr int MAX_TILE_DH = 256;
__host__ __device__ constexpr int padded_head_dim(int dh) {
  return dh < 1 || dh > MAX_TILE_DH ? 0
         : dh <= 32                 ? 32
         : dh <= 64                 ? 64
         : dh <= 96                 ? 96
         : dh <= 128                ? 128
         : dh <= 192                ? 192
                                    : 256;
}

// Row s of head h of batch b starts at b*sb + h*sh + s*ld elements; its dh
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

// 0: no bias, 1: a row per (batch, head) (bi = 0), 2: a full [S, S] tile.
__host__ __device__ __forceinline__ int bias_form(const Bias& bias) {
  return !bias.p ? 0 : bias.bi == 0 ? 1 : 2;
}

template <typename T>
struct Attn {
  const T *q, *k, *v;  // all three through `in`
  View in;
  Bias bias;
  int S, H, dh;  // dh: the true head dim
  float scale;
  Dropout drop;
  // every row start 16-byte aligned and dh a whole number of 16 bytes (8 bf16,
  // 4 f32; vec_rows): the 16-byte instances (load_tile, attention_f32.cu's load_rows)
  bool vec;
  // the launch's key-tile counter while a profiler records (count_tiles), else null
  unsigned long long* tiles;

  __device__ __forceinline__ float keep(int b, int h, int i, int j) const {
    return drop.keep((((size_t)b * H + h) * S + i) * S + j, b, h, i, j);
  }
};

// Everything one call needs. Forward: out in out_dtype. Backward: dq, dk,
// dv through `in` in dtype, the row statistics, and out (ctx) when not null.
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
  unsigned long long* tiles;  // Attn::tiles
};

// attention_fwd.cu
cudaError_t launch_fwd(const Attn<bf16>& a, const Call& c, cudaStream_t st);
cudaError_t fwd_occupancy(int dh, int out_dtype, int form, bool resident, int* blocks);
// attention_bwd.cu
cudaError_t launch_bwd(const Attn<bf16>& a, const Call& c, cudaStream_t st);
cudaError_t bwd_occupancy(int dh, int form, int kernel, int* blocks);
// attention_wide.cu: head dims above MAX_TILE_DH
cudaError_t launch_fwd_wide(const Attn<bf16>& a, const Call& c, cudaStream_t st);
cudaError_t launch_bwd_wide(const Attn<bf16>& a, const Call& c, cudaStream_t st);
// attention_f32.cu: f32 head dims up to MAX_TILE_DH, forward (and, when
// backward, the backward after the forward into c.out where it is not null)
cudaError_t launch_f32_tiled(const Attn<float>& a, const Call& c, bool backward,
                             cudaStream_t st);

template <typename K>
cudaError_t opt_in(K kernel, bool& done, int bytes) {
  if (done) return cudaSuccess;
  const cudaError_t e = mdm::allow_smem(kernel, bytes);
  done = e == cudaSuccess;
  return e;
}

// ------------------------------------------------------- the walk's extent
// A key is dead where its key-padding bias is DEAD_BIAS or below (what
// ops/_mask.py's row_bias_contrib writes for a masked key; -inf too), live
// otherwise (NaN too). Where a row has a live key, exp(x * scale - 1e9 - m)
// is 0 in f32 for its dead keys, so the key tiles past its last live key
// add exact zeros to every sum and product: each walk stops there.
constexpr float DEAD_BIAS = -1e9f;

// Whether a walk over tiles of `tile` keys can stop short: a key-padding
// row (bias form 1) over more than one tile.
__host__ __device__ __forceinline__ bool shortens(const Bias& bias, int S, int tile) {
  return bias_form(bias) == 1 && S > tile;
}

// This thread's first value of the key-padding row at bias.p + row (key
// threadIdx.x) for live_extent. A kernel loads it before it issues its
// first copies, so that the row's read is in flight beside them.
__device__ __forceinline__ float first_bias(const Bias& bias, long long row, int S, int tile) {
  return shortens(bias, S, tile) && (int)threadIdx.x < S ? bias.p[row + threadIdx.x] : 0.0f;
}

// One past the last live key of the row (first: this thread's first_bias);
// S where the walk cannot stop short (no bias, a full [S, S] tile, a row
// within one tile), and for a row with no live key (its softmax runs over
// the masked logits, as a full walk gives it). Every thread of the block
// (NW warps) calls it: the rest of a coalesced read of the S values, a
// warp max and one barrier.
template <int NW>
__device__ __forceinline__ int live_extent(const Bias& bias, long long row, int S, int tile,
                                           float first) {
  if (!shortens(bias, S, tile)) return S;
  static __shared__ int last_of[NW];
  int last = (int)threadIdx.x < S && !(first <= DEAD_BIAS) ? (int)threadIdx.x : -1;
  for (int j = threadIdx.x + 32 * NW; j < S; j += 32 * NW)
    if (!(bias.p[row + j] <= DEAD_BIAS)) last = j;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) last_of[threadIdx.x >> 5] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w) last = max(last, last_of[w]);
  return last < 0 ? S : last + 1;
}

// The engagement counter: a block adds the (query tile, key tile) score
// tiles it computed and those a full walk would have to tiles[0] and
// tiles[1]. Null (no atomic) unless the launch's caller saw a profiler
// recording (ops/_chain.py::key_tile_counter).
__device__ __forceinline__ void count_tiles(unsigned long long* tiles, int walked, int full) {
  if (tiles && threadIdx.x == 0) {
    atomicAdd(tiles, (unsigned long long)walked);
    atomicAdd(tiles + 1, (unsigned long long)full);
  }
}

// ------------------------------------------------------------ device helpers
// A block of 4 warps owns a 64-row tile, each warp 16 rows as mma.sync
// m16n8k16 fragments: a thread holds rows g and g+8 (g = lane/4) and
// columns 2t, 2t+1 (t = lane%4) of every 8-column n-tile. Tiles in shared
// memory are [64][DH+8] bf16 (DH: the padded head dim): the 8 columns of
// slack put ldmatrix's eight rows on distinct banks.

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a . b: one m16n8k16 product, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, the hardware's approximation (relative error below 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, lo first
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4-byte asynchronous copy global -> shared; src_bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, int src_bytes) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

// Rows [row0, row0+64) of a head (base: its row 0, row stride ld) into a
// [64][DH+8] tile: the first dh columns from memory, the other columns and
// rows past S zero. VEC (dh a multiple of 8, base and ld 16-byte aligned:
// Attn::vec): where 128 threads split the rows evenly a thread copies one
// 16-byte column of every (128 / (DH/8))-th row, its addresses fixed but
// for the row. Otherwise 2-byte loads and stores, each thread every 128th
// element. VEC is a template argument, not a branch: a kernel's 16-byte
// instance is the same code as before the 2-byte path existed (a branch
// in the loops of the tiles cost the forward 5-7%).
template <int DH, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int ld, int row0, int S,
                                          int dh) {
  constexpr int LD = DH + 8, VPR = DH / 8;
  if constexpr (!VEC) {
#pragma unroll 8  // 8 loads in flight a thread: a rolled loop waited out each one
    for (int e = threadIdx.x; e < AT * DH; e += AT_THREADS) {
      const int r = e / DH, c = e % DH;
      dst[r * LD + c] = c < dh && row0 + r < S ? base[(size_t)(row0 + r) * ld + c]
                                               : __float2bfloat16_rn(0.0f);
    }
  } else if constexpr (AT_THREADS % VPR == 0) {
    constexpr int STEP = AT_THREADS / VPR;
    const int r = threadIdx.x / VPR, c = (threadIdx.x % VPR) * 8;
    const bool col = c < dh;
    const bf16* src = base + (size_t)(row0 + r) * ld + c;
    bf16* d = dst + r * LD + c;
#pragma unroll
    for (int k = 0; k < AT / STEP; ++k) {
      const bool ok = col && row0 + r + k * STEP < S;
      mdm::cp_async16(d + k * STEP * LD, ok ? src + (size_t)k * STEP * ld : base, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < AT * VPR / AT_THREADS; ++k) {
      const int v = threadIdx.x + k * AT_THREADS, r = v / VPR, c = (v % VPR) * 8;
      const bool ok = c < dh && row0 + r < S;
      mdm::cp_async16(dst + r * LD + c, ok ? base + (size_t)(row0 + r) * ld + c : base,
                      ok ? 16 : 0);
    }
  }
}

// A key tile's bias into shared memory: 64 rows for a full bias (row r:
// query row q0 + r) or the one key-padding row, of the 64 values from key
// column k0; two threads a row. A row's values start at flat offset o =
// base + i*bi + k0 of the 16-byte aligned bias; the copy starts at o & ~3
// (within the tensor), so value c sits at [(o & 3) + c]. Nothing past a
// row's S values is read; rows past S are zero.
__device__ __forceinline__ void load_bias(float* dst, const float* p, long long base, int bi,
                                          int q0, int k0, int S, bool full) {
  constexpr int CH = LDB / 4;  // 16-byte chunks per row
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  if (!full && r > 0) return;
  const long long row = base + (long long)(q0 + r) * bi;  // full rows: bi = S; else bi = 0
  const long long end = q0 + r < S ? row + S : 0;          // past the row's last value
  const long long src0 = ((row + k0) & ~3LL) + 4 * half;
#pragma unroll
  for (int j = 0; j < (CH + 1) / 2; ++j) {
    if (half + 2 * j < CH) {
      const long long src = src0 + 8 * j, n = end - src;
      const int bytes = n <= 0 ? 0 : n >= 4 ? 16 : (int)(4 * n);
      mdm::cp_async16(dst + r * LDB + 4 * half + 8 * j, bytes ? p + src : p, bytes);
    }
  }
}

// s[n] = this warp's 16 rows of a . b^T over the DH columns (a, b: [64][DH+8]
// tiles; n-tile n: b's rows 8n..8n+7), or s[n] += that when !ZERO; pairs of
// n-tiles from `pairs` on lie past S and are left as they are.
template <int DH, bool ZERO = true>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const bf16* A, const bf16* Bt,
                                        int pairs) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (ZERO) {
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  }
  const bf16* arow = A + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* brow = Bt + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t qa[4];
    ldsm4(qa, arow + kk);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < pairs) {
        uint32_t kf[4];
        ldsm4(kf, brow + np * 16 * LD + kk);
        mma16816(s[2 * np], qa, kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
  }
}

// o += w . T[16 rows ks*16.., NC columns] (T: a [64][DH+8] tile, already
// offset to its first column); w (bf16) is the A operand, built in
// registers from this thread's values.
template <int DH, int NC>
__device__ __forceinline__ void pv_cols(float (&o)[NC / 8][4], const uint32_t (&w)[4],
                                        const bf16* T, int ks) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31;
  const bf16* trow = T + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < NC / 16; ++dp) {
    uint32_t vf[4];
    ldsm4_t(vf, trow + dp * 16);
    mma16816(o[2 * dp], w, vf[0], vf[1]);
    mma16816(o[2 * dp + 1], w, vf[2], vf[3]);
  }
}

// o += w . T over the first `pairs` 16-row steps of a tile.
template <int DH, int NC>
__device__ __forceinline__ void tile_pv(float (&o)[NC / 8][4], const uint32_t (&w)[4][4],
                                        const bf16* T, int pairs) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < pairs) pv_cols<DH, NC>(o, w[ks], T, ks);
}

// Bit 4n + e: the keep draw of this thread's element e of n-tile n of a
// tile (e = 0, 1: row r0, columns c0 + 8n, +1; e = 2, 3: row r0 + 8), with
// (query, key) = (row, column), or (column, row) when TRANSPOSED (the
// backward's key-major tiles); elements past S are 0. The same rule and
// stream as Attn::keep. In-kernel draws are computed for every element and
// masked after, so the UNROLL words of an iteration are independent chains.
template <int UNROLL, bool TRANSPOSED = false>
__device__ __forceinline__ uint32_t keep_bits(const Attn<bf16>& a, int b, int h, int r0, int c0) {
  const Dropout& d = a.drop;
  const int S = a.S;
  uint32_t bits = 0;
  if (d.mode == 1) {
#pragma unroll 1
    for (int x = 0; x < 32; ++x) {
      const int r = r0 + ((x >> 1) & 1) * 8, c = c0 + 8 * (x >> 2) + (x & 1);
      const int i = TRANSPOSED ? c : r, j = TRANSPOSED ? r : c;
      if (i < S && j < S && d.bits[(((size_t)b * a.H + h) * S + i) * S + j] < d.thr)
        bits |= 1u << x;
    }
    return bits;
  }
#pragma unroll (UNROLL)
  for (int x = 0; x < 32; ++x) {
    const int r = r0 + ((x >> 1) & 1) * 8, c = c0 + 8 * (x >> 2) + (x & 1);
    const int i = TRANSPOSED ? c : r, j = TRANSPOSED ? r : c;
    const uint32_t w = mdm::philox_word(d.seed, (uint32_t)j, (uint32_t)i, (uint32_t)h,
                                        (uint32_t)b + d.boff);
    bits |= (uint32_t)(w < d.thr && i < S && j < S) << x;
  }
  return bits;
}

// The keep factor of element 4n + e of a word: 1/(1-rate) or 0; 1 with
// no dropout.
__device__ __forceinline__ float keep_factor(const Dropout& d, uint32_t bits, int x) {
  return d.mode == 0 ? 1.0f : (bits >> x) & 1 ? d.inv_keep : 0.0f;
}

// This warp's rows i0, i0 + 8 (rows past S skipped) of the first dh
// columns from the accumulators, one value per store where !VEC (see
// load_tile).
template <int NC, typename OT>
__device__ __forceinline__ void store_narrow(const float (&o)[NC / 8][4], OT* base, int ld,
                                             int i0, int S, int dh) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      if (row < S && col < dh) base[(size_t)row * ld + col] = mdm::from_f<OT>(o[n][e]);
    }
}

// Where VEC, 16 bytes per store (dh a multiple of 8). f32: lane pairs trade
// a row's two values, so each lane holds 4 contiguous columns of one row.
template <int NC, bool VEC>
__device__ __forceinline__ void store_out(const float (&o)[NC / 8][4], float* base, int ld, int i0,
                                          int S, int dh) {
  if constexpr (!VEC) return store_narrow<NC>(o, base, ld, i0, S, dh);
  const int t = threadIdx.x & 3;
  const bool odd = t & 1;
  const int row = i0 + (odd ? 8 : 0);
  float* dst = base + (size_t)row * ld + 2 * (t & ~1);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? o[n][0] : o[n][2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? o[n][1] : o[n][3], 1);
    const float4 v = odd ? make_float4(x0, x1, o[n][2], o[n][3])
                         : make_float4(o[n][0], o[n][1], x0, x1);
    if (row < S && 8 * n < dh) *reinterpret_cast<float4*>(dst + 8 * n) = v;
  }
}

// bf16: per pair of n-tiles a lane holds one bf16x2 word of four items (row
// i0 or i0 + 8, n-tile 2p or 2p + 1); a 4x4 exchange in the quad gives lane
// t item t whole, word s from lane s.
template <int NC, bool VEC>
__device__ __forceinline__ void store_out(const float (&o)[NC / 8][4], bf16* base, int ld, int i0,
                                          int S, int dh) {
  if constexpr (!VEC) return store_narrow<NC>(o, base, ld, i0, S, dh);
  const int t = threadIdx.x & 3;
  const int row = i0 + (t & 1) * 8;
  bf16* dst = base + (size_t)row * ld + 8 * (t >> 1);
#pragma unroll
  for (int p = 0; p < NC / 16; ++p) {
    const uint32_t w[4] = {pack_bf16(o[2 * p][0], o[2 * p][1]), pack_bf16(o[2 * p][2], o[2 * p][3]),
                           pack_bf16(o[2 * p + 1][0], o[2 * p + 1][1]),
                           pack_bf16(o[2 * p + 1][2], o[2 * p + 1][3])};
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // lane t sends item t ^ r, receives word t ^ r of item t
      const int x = t ^ r;
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, x == 0 ? w[0] : x == 1 ? w[1] : x == 2 ? w[2] : w[3], r);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = x == k ? got : v[k];
    }
    if (row < S && 16 * p + 8 * (t >> 1) < dh)
      *reinterpret_cast<uint4*>(dst + 16 * p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// x = x * scale (+ bias) for this warp's products x = q.k against the key
// tile k0.. (its bias at bs), -inf past S. rb: where this thread's two
// rows' bias values start in bs.
__device__ __forceinline__ void finish_logits(float (&x)[8][4], const Attn<bf16>& a,
                                              const float* bs, int form, const int (&rb)[2],
                                              int k0) {
  const int t = threadIdx.x & 3, S = a.S;
  if (form) {
    bs += 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = fmaf(x[n][e], a.scale, bs[rb[e >> 1] + 8 * n + (e & 1)]);
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] *= a.scale;
  }
  if (k0 + AT > S) {
    const int lim = S - k0 - 2 * t;  // this thread's columns 8n + (e & 1) below lim are keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * n + (e & 1) >= lim) x[n][e] = -INFINITY;
  }
}

// x = this warp's logits against the key tile k0.. (Ks, its bias at bs).
template <int DH>
__device__ __forceinline__ void tile_logits(float (&x)[8][4], const Attn<bf16>& a, const bf16* Qs,
                                            const bf16* Ks, const float* bs, int form,
                                            const int (&rb)[2], int k0) {
  qk_tile<DH>(x, Qs, Ks, min(4, (a.S - k0 + 15) >> 4));
  finish_logits(x, a, bs, form, rb, k0);
}

// Where this thread's rows i0, i0 + 8 (block rows warp*16 + g, + 8) start
// in a staged bias: a full bias's row, or the key-padding row's offset.
__device__ __forceinline__ void bias_rows(int (&rb)[2], const Attn<bf16>& a, int form,
                                          long long bias0, int i0) {
  const int g = (threadIdx.x & 31) >> 2, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rb[r] = form == 2 ? (warp * 16 + g + 8 * r) * LDB +
                            (int)((bias0 + (long long)(i0 + 8 * r) * a.bias.bi) & 3)
                      : (int)(bias0 & 3);
}

__device__ __forceinline__ void row_max(const float (&x)[8][4], float (&mx)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[n][e]);
}

// x = exp(x - mx) in place, as 2^(x log2 e - mx log2 e); adds this
// thread's part of each row's sum to sum.
__device__ __forceinline__ void tile_exps(float (&x)[8][4], const float (&mx)[2],
                                          float (&sum)[2]) {
  const float ml[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
  float part[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = ex2(fmaf(x[n][e], LOG2E, -ml[e >> 1]));
      part[e >> 1][n & 1] += x[n][e];
    }
  sum[0] += part[0][0] + part[0][1];
  sum[1] += part[1][0] + part[1][1];
}

// The quad's four parts of each of this thread's two rows, combined.
__device__ __forceinline__ void quad_max(float (&v)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 1));
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 2));
  }
}
__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 1);
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 2);
  }
}

// The A operands of a tile's four 16-column steps from this thread's f32
// values, each rounded to bf16: w[ks] holds n-tiles 2ks, 2ks + 1.
__device__ __forceinline__ void pack_tile(uint32_t (&w)[4][4], const float (&v)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 2 * ks + hf;
        w[ks][2 * hf + r] = pack_bf16(v[n][2 * r], v[n][2 * r + 1]);
      }
}

// w = p kept per kbits (keep_bits) and scaled by 1/(1-rate), rounded to
// bf16 and packed as the A operands of the tile's four 16-key steps, with
// p = e * (1 / sum): a multiply by the row's reciprocal instead of a
// division, within an f32 ulp.
__device__ __forceinline__ void tile_pack(uint32_t (&w)[4][4], const float (&e)[8][4],
                                          const float (&inv)[2], uint32_t kbits,
                                          const Attn<bf16>& a) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 2 * ks + hf, x = 4 * n + 2 * r;
        float w0 = e[n][2 * r] * inv[r], w1 = e[n][2 * r + 1] * inv[r];
        if (a.drop.mode) {
          w0 = (kbits >> x) & 1 ? w0 * a.drop.inv_keep : 0.0f;
          w1 = (kbits >> (x + 1)) & 1 ? w1 * a.drop.inv_keep : 0.0f;
        }
        w[ks][2 * hf + r] = pack_bf16(w0, w1);
      }
}

}  // namespace attn
}  // namespace mdm
