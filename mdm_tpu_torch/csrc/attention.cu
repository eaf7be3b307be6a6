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
// - forward (its own layout and helpers, FwdSmem): 4 warps of mma.sync
//   m16n8k16, 16 query rows each, operands from shared memory by ldmatrix.
//   While S <= 256 (FW_RES key tiles, the RESIDENT instance) a row's f32
//   logits stay in registers, so K and the bias are read once: the exact
//   row max and exp-sum come from the resident row, then p = e * (1 / sum)
//   (a multiply by the row's reciprocal instead of a division: within an
//   f32 ulp), dropped and rounded to bf16 in registers, packed as the A
//   operands of the products with V (FlashAttention-2's register layout:
//   no score or probability tile goes through shared memory). exp is
//   2^(x log2 e) on the hardware's ex2.approx (relative error below 2^-22),
//   held to the plain versions' tolerances. Past 256 keys the two-pass
//   instance keeps one tile of logits at a time: the row statistics merged
//   tile by tile, then each tile's logits again (a flash-style online
//   rescale would round w before normalising). K, V and bias tiles
//   (16-byte copies) come through a cp.async ring, tile t+1 in flight
//   while tile t computes; the output leaves in 16-byte stores straight
//   from the accumulators. Dh=128: 214-217 registers resident, 168-180 in
//   two passes, no spills; 89 KB of shared memory with a full bias (two
//   stages), 72 KB with a key-padding row or none (three): two blocks per
//   SM. With 2 warps per scheduler the kernel is latency-bound, so its
//   code stays short enough for the instruction cache (loops over the
//   tiles, a switch picking a tile's registers): fully unrolled, it ran
//   several times slower;
// - backward dq kernel: per query tile, the same two passes plus dw and the
//   row sums delta in pass 2, then pass 3 forms dlog and dq; it writes dq,
//   the row statistics (max, sum, delta) and optionally out;
// - backward dkv kernel: per key tile, walks the query tiles with those
//   statistics and accumulates dk and dv in registers, so no float atomics
//   and two backward runs are bitwise equal.
// The bf16 backward runs WMMA 16x16x16 fragments (4 warps, 16 rows each);
// the f32 path is scalar FMA, one block per row. Bound on an H100 at the
// flagship shapes (S=197, Dh=128): with separate q/k/v and an f32 output
// (#7, #10, #11) the bytes of the operands; the forward's products are a
// quarter of that time. #7's Philox (one word per element, ~60 integer
// instructions) is a floor the bound omits, ~0.05-0.1 ms at B=128, H=4.

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
// The forward's own layout and helpers; the backward's above stay as they
// are. A block of 4 warps owns a 64-row query tile, each warp 16 rows as
// mma.sync m16n8k16 fragments: a thread holds rows g and g+8 (g = lane/4)
// and columns 2t, 2t+1 (t = lane%4) of every 8-column n-tile.
constexpr int FW_RES = 4;       // 64-key tiles of logits resident per chunk: S <= 256 in one pass
constexpr int FW_LDB = AT + 4;  // f32 bias row: 64 values after up to 3 of alignment slack
constexpr float FW_LOG2E = 1.4426950408889634f;

// The keep draws of a resident row ([FW_RES][128] words, one per thread
// and key tile), Q, then a ring of stages, each a K or V tile ([64][LD]
// bf16) and a K tile's bias: [64][FW_LDB] f32 for a full bias (two stages,
// so that two blocks fit an SM at Dh=128), one [FW_LDB] row for a
// key-padding row or none (three stages).
template <int DH>
struct FwdSmem {
  static constexpr int LD = Smem<DH>::LD;
  static constexpr int TILE = AT * LD * 2;
  static constexpr int KEPT = FW_RES * AT_THREADS * 4;  // the keep words' bytes; Q follows
  __host__ __device__ static constexpr int stages(int form) { return form == 2 ? 2 : 3; }
  __host__ __device__ static constexpr int stage(int form) {
    return TILE + (form == 2 ? AT * FW_LDB * 4 : form == 1 ? FW_LDB * 4 : 0);
  }
  __host__ __device__ static constexpr int bytes(int form) {
    return KEPT + TILE + stages(form) * stage(form);
  }
  __host__ __device__ static constexpr int max_bytes() {  // bytes(1) >= bytes(0)
    return bytes(2) > bytes(1) ? bytes(2) : bytes(1);
  }
};

// 0: no bias, 1: a row per (batch, head) (bi = 0), 2: a full [S, S] tile.
__host__ __device__ __forceinline__ int bias_form(const Bias& bias) {
  return !bias.p ? 0 : bias.bi == 0 ? 1 : 2;
}

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

// Rows [row0, row0+64) of a head (base: its row 0, row stride ld) into a
// [64][LD] tile, rows past S zero: a thread copies one 16-byte column of
// every (128 / (DH/8))-th row, its addresses fixed but for the row.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int ld, int row0, int S) {
  constexpr int LD = FwdSmem<DH>::LD, VPR = DH / 8, STEP = AT_THREADS / VPR;
  const int r = threadIdx.x / VPR, c = (threadIdx.x % VPR) * 8;
  const bf16* src = base + (size_t)(row0 + r) * ld + c;
  bf16* d = dst + r * LD + c;
#pragma unroll
  for (int k = 0; k < AT / STEP; ++k) {
    const bool ok = row0 + r + k * STEP < S;
    mdm::cp_async16(d + k * STEP * LD, ok ? src + (size_t)k * STEP * ld : base, ok ? 16 : 0);
  }
}

// A key tile's bias into a stage: 64 rows for a full bias (row r: query
// row q0 + r) or the one key-padding row, of the 64 values from key column
// k0; two threads a row. A row's values start at flat offset o = base +
// i*bi + k0 of the 16-byte aligned bias; the copy starts at o & ~3 (within
// the tensor), so value c sits at [(o & 3) + c]. Nothing past a row's S
// values is read; rows past S are zero.
__device__ __forceinline__ void load_bias(float* dst, const float* p, long long base, int bi,
                                          int q0, int k0, int S, bool full) {
  constexpr int CH = FW_LDB / 4;  // 16-byte chunks per row
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
      mdm::cp_async16(dst + r * FW_LDB + 4 * half + 8 * j, bytes ? p + src : p, bytes);
    }
  }
}

// s[n] = this warp's 16 rows of q . k^T against a key tile (n-tile n: key
// columns 8n..8n+7); pairs of n-tiles from `pairs` on lie past S and stay 0.
template <int DH>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const bf16* Qs, const bf16* Ks,
                                        int pairs) {
  constexpr int LD = FwdSmem<DH>::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const bf16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* krow = Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t qa[4];
    ldsm4(qa, qrow + kk);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < pairs) {
        uint32_t kf[4];
        ldsm4(kf, krow + np * 16 * LD + kk);
        mma16816(s[2 * np], qa, kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
  }
}

// o += w . v over the 16 keys ks*16.. of a value tile; w (bf16) is the A
// operand, built in registers from this thread's probabilities.
template <int DH>
__device__ __forceinline__ void pv_step(float (&o)[DH / 8][4], const uint32_t (&w)[4],
                                        const bf16* Vs, int ks) {
  constexpr int LD = FwdSmem<DH>::LD;
  const int lane = threadIdx.x & 31;
  const bf16* vrow = Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t vf[4];
    ldsm4_t(vf, vrow + dp * 16);
    mma16816(o[2 * dp], w, vf[0], vf[1]);
    mma16816(o[2 * dp + 1], w, vf[2], vf[3]);
  }
}

// Bit 4n + e: the keep draw of this thread's element e of n-tile n of a key
// tile (e = 0, 1: row i0, columns j0 + 8n, +1; e = 2, 3: row i0 + 8), with
// j0 = k0 + 2t; elements past S are 0. The same rule and stream as
// Attn::keep. In-kernel draws are computed for every element and masked
// after, so the UNROLL words of an iteration are independent chains.
template <int UNROLL>
__device__ __forceinline__ uint32_t keep_bits(const Attn<bf16>& a, int b, int h, int i0, int j0) {
  const Dropout& d = a.drop;
  const int S = a.S;
  uint32_t bits = 0;
  if (d.mode == 1) {
#pragma unroll 1
    for (int x = 0; x < 32; ++x) {
      const int i = i0 + ((x >> 1) & 1) * 8, j = j0 + 8 * (x >> 2) + (x & 1);
      if (i < S && j < S && d.bits[(((size_t)b * a.H + h) * S + i) * S + j] < d.thr)
        bits |= 1u << x;
    }
    return bits;
  }
#pragma unroll (UNROLL)
  for (int x = 0; x < 32; ++x) {
    const int i = i0 + ((x >> 1) & 1) * 8, j = j0 + 8 * (x >> 2) + (x & 1);
    const uint32_t r = mdm::philox_word(d.seed, (uint32_t)j, (uint32_t)i, (uint32_t)h, (uint32_t)b);
    bits |= (uint32_t)(r < d.thr && i < S && j < S) << x;
  }
  return bits;
}

// This warp's rows i0, i0 + 8 (rows past S skipped) from the accumulators,
// 16 bytes per store. f32: lane pairs trade a row's two values, so each
// lane holds 4 contiguous columns of one row.
template <int DH>
__device__ __forceinline__ void store_out(const float (&o)[DH / 8][4], float* base, int ld, int i0,
                                          int S) {
  const int t = threadIdx.x & 3;
  const bool odd = t & 1;
  const int row = i0 + (odd ? 8 : 0);
  float* dst = base + (size_t)row * ld + 2 * (t & ~1);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? o[n][0] : o[n][2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? o[n][1] : o[n][3], 1);
    const float4 v = odd ? make_float4(x0, x1, o[n][2], o[n][3])
                         : make_float4(o[n][0], o[n][1], x0, x1);
    if (row < S) *reinterpret_cast<float4*>(dst + 8 * n) = v;
  }
}

// bf16: per pair of n-tiles a lane holds one bf16x2 word of four items (row
// i0 or i0 + 8, n-tile 2p or 2p + 1); a 4x4 exchange in the quad gives lane
// t item t whole, word s from lane s.
template <int DH>
__device__ __forceinline__ void store_out(const float (&o)[DH / 8][4], bf16* base, int ld, int i0,
                                          int S) {
  const int t = threadIdx.x & 3;
  const int row = i0 + (t & 1) * 8;
  bf16* dst = base + (size_t)row * ld + 8 * (t >> 1);
#pragma unroll
  for (int p = 0; p < DH / 16; ++p) {
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
    if (row < S) *reinterpret_cast<uint4*>(dst + 16 * p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// x = this warp's logits against the key tile k0.. in stage st: q.k *
// scale (+ bias), -inf past S. rb: where this thread's two rows' bias
// values start in the stage's bias.
template <int DH>
__device__ __forceinline__ void tile_logits(float (&x)[8][4], const Attn<bf16>& a, const bf16* Qs,
                                            const unsigned char* st, int form, const int (&rb)[2],
                                            int k0) {
  const int t = threadIdx.x & 3, S = a.S;
  qk_tile<DH>(x, Qs, reinterpret_cast<const bf16*>(st), min(4, (S - k0 + 15) >> 4));
  if (form) {
    const float* bs = reinterpret_cast<const float*>(st + FwdSmem<DH>::TILE) + 2 * t;
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
  const float ml[2] = {mx[0] * FW_LOG2E, mx[1] * FW_LOG2E};
  float part[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = ex2(fmaf(x[n][e], FW_LOG2E, -ml[e >> 1]));
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

// o += w . v over the value tile in Vs, its first `pairs` 16-key steps.
template <int DH>
__device__ __forceinline__ void tile_pv(float (&o)[DH / 8][4], const uint32_t (&w)[4][4],
                                        const bf16* Vs, int pairs) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < pairs) pv_step<DH>(o, w[ks], Vs, ks);
}

// RESIDENT (S <= FW_RES * 64): the row's logits stay in registers, K and
// the bias are read once; the stream is the key tiles, then the value
// tiles. Otherwise two passes over the keys, one tile resident at a time:
// the rows' max and exp-sum merged tile by tile (as row_stats), then each
// key tile's logits again and its value tile.
template <int DH, typename OT, bool RESIDENT>
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
  const int S = a.S, ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  const bf16 *kb = a.k + hb, *vb = a.v + hb;
  const int nkt = (S + AT - 1) / AT, total = (RESIDENT ? 2 : 3) * nkt;  // tiles in the stream
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
      load_tile<DH>(reinterpret_cast<bf16*>(st), is_v ? vb : kb, ld, kt * AT, S);
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
  load_tile<DH>(Qs, a.q + hb, ld, q0, S);  // rides in group 0 with tile 0
  issue(0, 0, false);
  if (nst == 3) issue(1, 1, false);

  int rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rb[r] = form == 2 ? (warp * 16 + g + 8 * r) * FW_LDB +
                            (int)((bias0 + (long long)(i0 + 8 * r) * a.bias.bi) & 3)
                      : (int)(bias0 & 3);
  float o[DH / 8][4];

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
    float sx[FW_RES][8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const unsigned char* st = next(false);
      if (!active) continue;
      switch (kt) {
        case 0: tile_logits<DH>(sx[0], a, Qs, st, form, rb, 0); row_max(sx[0], mx); break;
        case 1: tile_logits<DH>(sx[1], a, Qs, st, form, rb, AT); row_max(sx[1], mx); break;
        case 2: tile_logits<DH>(sx[2], a, Qs, st, form, rb, 2 * AT); row_max(sx[2], mx); break;
        default: tile_logits<DH>(sx[3], a, Qs, st, form, rb, 3 * AT); row_max(sx[3], mx); break;
      }
    }
    // The rows' exact max and exp-sum from the resident logits; then w,
    // packed: what stays resident for the products halves.
    uint32_t w[FW_RES][4][4];
    if (active) {
      float sum[2] = {0.0f, 0.0f};
      quad_max(mx);
#pragma unroll
      for (int kt = 0; kt < FW_RES; ++kt)
        if (kt < nkt) tile_exps(sx[kt], mx, sum);
      quad_sum(sum);
      const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
      for (int kt = 0; kt < FW_RES; ++kt)
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
        case 0: tile_pv<DH>(o, w[0], Vs, pairs); break;
        case 1: tile_pv<DH>(o, w[1], Vs, pairs); break;
        case 2: tile_pv<DH>(o, w[2], Vs, pairs); break;
        default: tile_pv<DH>(o, w[3], Vs, pairs); break;
      }
    }
  } else {
    float x[8][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      const unsigned char* st = next(false);
      if (!active) continue;
      tile_logits<DH>(x, a, Qs, st, form, rb, kt * AT);
      float mn[2] = {m[0], m[1]}, sum[2] = {0.0f, 0.0f};
      row_max(x, mn);
      quad_max(mn);
      tile_exps(x, mn, sum);
      quad_sum(sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * ex2((m[r] - mn[r]) * FW_LOG2E) + sum[r];
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
        tile_logits<DH>(x, a, Qs, st, form, rb, kt * AT);
        tile_exps(x, m, sum);
        tile_pack(w, x, inv, a.drop.mode ? keep_bits<2>(a, b, h, i0, kt * AT + 2 * t) : 0u, a);
      }
      const bf16* Vs = reinterpret_cast<const bf16*>(next(false));
      if (active) tile_pv<DH>(o, w, Vs, min(4, (S - kt * AT + 15) >> 4));
    }
  }
  if (active) store_out<DH>(o, out + ov.head(b, h), ov.ld, i0, S);
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

template <int DH, typename OT, bool RESIDENT>
cudaError_t fwd_opt_in() {
  static bool done = false;
  return opt_in(attn_fwd_bf16<DH, OT, RESIDENT>, done, FwdSmem<DH>::max_bytes());
}

template <int DH, typename OT>
cudaError_t launch_fwd(const Attn<bf16>& a, const Call& c, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(a.bias.p) % 16) return cudaErrorInvalidValue;  // load_bias
  const bool resident = c.S <= FW_RES * AT;
  cudaError_t e = resident ? fwd_opt_in<DH, OT, true>() : fwd_opt_in<DH, OT, false>();
  if (e != cudaSuccess) return e;
  const dim3 grid((c.S + AT - 1) / AT, c.H, c.B);
  const int bytes = FwdSmem<DH>::bytes(bias_form(a.bias));
  OT* out = static_cast<OT*>(c.out);
  if (resident) attn_fwd_bf16<DH, OT, true><<<grid, AT_THREADS, bytes, st>>>(a, out, c.ov);
  else attn_fwd_bf16<DH, OT, false><<<grid, AT_THREADS, bytes, st>>>(a, out, c.ov);
  return cudaGetLastError();
}

template <int DH, typename OT, bool RESIDENT>
cudaError_t fwd_occupancy(int form, int* blocks) {
  const cudaError_t e = fwd_opt_in<DH, OT, RESIDENT>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn_fwd_bf16<DH, OT, RESIDENT>,
                                                       AT_THREADS, FwdSmem<DH>::bytes(form));
}

template <int DH>
cudaError_t fwd_occupancy(int out_dtype, int form, bool resident, int* blocks) {
  if (out_dtype == 1)
    return resident ? fwd_occupancy<DH, bf16, true>(form, blocks)
                    : fwd_occupancy<DH, bf16, false>(form, blocks);
  return resident ? fwd_occupancy<DH, float, true>(form, blocks)
                  : fwd_occupancy<DH, float, false>(form, blocks);
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

// Resident blocks per SM of the bf16 forward into *blocks, for out_dtype
// (0 = float32, 1 = bfloat16), bias form 0 none, 1 row (bi = 0), 2 full,
// and the kernel S picks: resident logits (S <= 256, resident = 1) or two
// passes (resident = 0).
extern "C" int mdm_attention_fwd_occupancy(int Dh, int out_dtype, int form, int resident,
                                           int* blocks) {
  if (form < 0 || form > 2 || out_dtype < 0 || out_dtype > 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return (int)fwd_occupancy<32>(out_dtype, form, resident != 0, blocks);
    case 64: return (int)fwd_occupancy<64>(out_dtype, form, resident != 0, blocks);
    case 128: return (int)fwd_occupancy<128>(out_dtype, form, resident != 0, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
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
