// The attention core of every attention kernel of the port, forward and
// backward, with optional probability dropout. It replaces these TPU kernels:
//   mdm_tpu/ops/attention_train_block.py::_fwd_kernel (pallas_call at :286,294)
//     and ::_bwd_kernel (:334,344), with the projections of gemm_sm90.cu;
//   mdm_tpu/ops/attention_dropout.py::_fwd_kernel (:181,187) and ::_bwd_kernel
//     (:214,220);
//   mdm_tpu/ops/attention.py::_fused_attention_pallas (:76);
//   mdm_tpu/ops/attention_v2.py::_fused_attention_v2 (:69);
//   mdm_tpu/ops/attention_block.py::_fused_block (:84), with gemm_sm90.cu.
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
// block of 4 warps owns a 64-row tile and walks the other axis in 64-wide
// tiles, with mma.sync m16n8k16 from ldmatrix (each warp 16 rows) and the
// score, probability and dlog fragments in registers, FlashAttention-2's
// layout: an accumulator tile of one product is the A operand of the next
// once rounded to bf16, so no score tile goes through shared memory. exp is
// 2^(x log2 e) on the hardware's ex2.approx (relative error below 2^-22),
// and p = e * (1 / sum), a multiply by the row's reciprocal (within an f32
// ulp), held to the plain versions' tolerances. Tiles (16-byte copies, the
// bias too) come through a cp.async ring, tile t+1 in flight while tile t
// computes; loops over the tiles stay rolled, a switch picking a tile's
// registers: fully unrolled, the code ran several times slower, bound by
// instruction fetch at 2 warps per scheduler.
//
// Head dims: every one from 1 to 256 runs in the least instance of 32, 64,
// 96, 128, 192, 256 that holds it (padded_head_dim): the kernels copy the
// true dh columns, zero the rest of each shared-memory tile (zero columns
// change no product) and store only the true columns. The rows are 16-byte
// copies where every row start is 16-byte aligned and dh a multiple of 8
// (4 in f32; vec_rows, decided per launch); otherwise 2-byte loads and stores, in
// instances of their own (two-pass forwards; a head of 4 values packed in
// a row starts 8 bytes on), so that the 16-byte ones keep no branch for
// them.
// Above 256 even half a head's accumulators would not fit the registers,
// nor its Q and dO tiles shared memory beside a ring of K/V stages: the
// wide kernels of attention_wide.cu stream q . k^T and dO . v^T through
// shared memory in 64-column slabs and split the output columns over
// blocks, at the same rounding points, keep draws and fixed sum orders.
//
// - forward (attention_fwd.cu): while S <= 256 and Dh <= 128 (the RESIDENT
//   instance) a row's f32 logits stay in registers, so K and the bias are
//   read once: the exact row max and exp-sum come from the resident row,
//   then w is dropped, rounded and packed as the A operands of the products
//   with V. Otherwise two passes: the row statistics merged tile by tile,
//   then each tile's logits again (a flash-style online rescale would round
//   w before normalising). Dh=128: 213 registers resident, 168-177 in
//   two passes, no spills; two blocks per SM.
// - backward (attention_bwd.cu): a dq kernel per query tile walks the keys
//   twice: online row max, exp-sum and A = sum e dp (rescaled as the max
//   grows), so delta = rowsum(dp * p) = A / sum in f32 from the recomputed
//   p; then dlog in registers and dq += dlog . k. It leaves (max, 1/sum,
//   delta) per row for the dk/dv kernel, which per key tile walks the
//   query tiles once with K and V resident and dk, dv in registers: no
//   float atomics, every sum in a fixed order, two runs bitwise equal. Per
//   element that is q . k^T and dO . v^T three times and the keep draw
//   twice (the dq kernel keeps its words of the first 256 keys in shared
//   memory for its second walk). The recomputed out is the forward kernel's
//   own launch, so it equals the forward's bitwise. Head dims above 128
//   split their output columns over blocks of 128 (256) or 64 (192), each
//   recomputing the scores. Dh=128: 214 registers (dq) and 255 (dk/dv), no
//   spills; two blocks of 4 warps per SM (mdm_attention_bwd_occupancy).
// The f32 path (attention_f32.cu) is tiled as the bf16 one, in exact f32
// FMA: register-blocked score tiles, the online row statistics in
// registers, each logit once per pass of the forward and q . k^T and dO .
// v^T three times per element in the backward, for every head dim up to
// 256 and any S; above 256 the row kernels below (the f32 wide instance).
// Bound on an H100 at the flagship shapes (S=197, Dh=128): the bf16
// forward by the bytes of its operands (#7, #10, #11), its products a
// quarter of that time; the backward (#8) by the bytes too (0.062 ms), but
// it runs nine score-sized products where the bound counts four, and an exp
// and two Philox words per element; the f32 core by its products' three
// TF32 passes at 495 TFLOP/s (f32 accuracy on the tensor cores), where the
// f32 FMA it runs would take them at 67.
// Philox (one word per element, ~60 integer instructions) is a floor the
// bound omits, ~0.05-0.1 ms per draw at B=128, H=4.
//
// The walk's extent (attention.cuh::live_extent). A key-padding row's dead
// keys carry -1e9 (ops/_mask.py), and MDM's live keys are a prefix (the
// condition token and the motion's frames), so a row walks only up to its
// last live key. Each tile kernel reads its batch element's S-float row once,
// while its first tiles are in flight, and takes one past the last key whose
// bias is above -1e9 (NaN counts as live) as the extent: the forward and dq
// kernels walk the key tiles up to it, and a dk/dv block whose keys all lie
// past it stores zero dk and dv. No launch, argument or host work is added.
// The result is bitwise the full walk's wherever the row has a live key: a
// skipped logit is below the row max by about 1e9, so its exp is 0 in f32
// (ex2.approx and expf flush it), the max and the sums it would have met
// are unchanged (a max over smaller values; + 0; an online rescale by
// exp(0) = 1), its keep word is not drawn and no other moves (Philox is
// keyed on the element), and a zero probability adds 0 . v, 0 . dO and
// 0 . q. That holds while every live logit exceeds every dead one by less
// than about 1e9 - 88, which finite activations meet. A row with no live
// key keeps the full walk (its softmax over the masked logits), as do no
// bias and a full [S, S] bias (CLIP's causal mask). Tiles are skipped
// whole, so what still bounds the core is the live tiles' work: at MDM's
// lengths 40-196 a row walks 2.32 of 4 key tiles, the last one partly
// masked, and the f32 core computes exactly in FMA (attention_f32.cu).
// While a profiler records, each block adds its walked and full score
// tiles to a counter (count_tiles), the engagement the benchmark reads.

#include <cstdint>

#include "attention.cuh"

using mdm::bf16;
using mdm::Dropout;
using namespace mdm::attn;

namespace {

// ------------------------------------------------- float32, head dims > 256
// The f32 wide instance: one block per row. Nothing Dh- or S-long is
// staged whole: the q and dO rows are read through L1 by every thread, the
// row's statistics come from an online max and exp-sum (merged over the
// block), and the S-long rows of p (and dlog) pass through shared memory
// AF_CHUNK keys at a time, each chunk's products added to the output row in
// global memory by the thread that owns its column. So every head dim and
// every S runs; each logit is computed twice (statistics, then p), in the
// backward three times, all scalar.
constexpr int AF_THREADS = 128, AF_CHUNK = 1024;

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

__device__ __forceinline__ float dotf(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Logit of query row qrow against key j of the head at kb.
__device__ __forceinline__ float logit_f32(const Attn<float>& a, const float* qrow,
                                           const float* kb, int b, int h, int i, int j) {
  return dotf(qrow, kb + (size_t)j * a.in.ld, a.dh) * a.scale + a.bias.at(b, h, i, j);
}

// Max m and exp-sum l of row (b, h, i)'s logits: online per thread (a -inf
// logit adds nothing), then merged over the block.
__device__ void row_stats_f32(const Attn<float>& a, const float* qrow, const float* kb, int b,
                              int h, int i, float* red, float& m, float& l) {
  float mx = -INFINITY, sum = 0.0f;
  for (int j = threadIdx.x; j < a.S; j += AF_THREADS) {
    const float x = logit_f32(a, qrow, kb, b, h, i, j);
    if (x > mx) {
      sum = sum * expf(mx - x) + 1.0f;
      mx = x;
    } else if (x != -INFINITY) {
      sum += expf(x - mx);
    }
  }
  m = block_reduce(mx, red, true);
  l = block_reduce(sum == 0.0f ? 0.0f : sum * expf(mx - m), red, false);
}

__global__ void __launch_bounds__(AF_THREADS)
attn_fwd_f32_rows(Attn<float> a, float* __restrict__ out, View ov) {
  __shared__ float ps[AF_CHUNK];  // p * keep of one chunk of keys
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld;
  const size_t hb = a.in.head(b, h);
  const float* qrow = a.q + hb + (size_t)i * ld;
  float* orow = out + ov.head(b, h) + (size_t)i * ov.ld;
  float m, l;
  row_stats_f32(a, qrow, a.k + hb, b, h, i, red, m, l);
  for (int j0 = 0; j0 < a.S; j0 += AF_CHUNK) {
    const int n = min(AF_CHUNK, a.S - j0);
    for (int jj = threadIdx.x; jj < n; jj += AF_THREADS) {
      const int j = j0 + jj;
      ps[jj] = expf(logit_f32(a, qrow, a.k + hb, b, h, i, j) - m) / l * a.keep(b, h, i, j);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < a.dh; d += AF_THREADS) {
      float acc = j0 ? orow[d] : 0.0f;
      for (int jj = 0; jj < n; ++jj) acc = fmaf(ps[jj], a.v[hb + (size_t)(j0 + jj) * ld + d], acc);
      orow[d] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(AF_THREADS)
attn_bwd_dq_f32_rows(Attn<float> a, const float* __restrict__ dout, float* __restrict__ ctx,
                     View ov, float* __restrict__ dq, float* __restrict__ stats, int B) {
  __shared__ float ws[AF_CHUNK];  // w = p * keep of one chunk of keys
  __shared__ float gs[AF_CHUNK];  // dlog of the chunk
  __shared__ float red[33];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld, S = a.S;
  const size_t hb = a.in.head(b, h), ob = ov.head(b, h) + (size_t)i * ov.ld;
  const float *qrow = a.q + hb + (size_t)i * ld, *crow = dout + ob;
  float* dqrow = dq + hb + (size_t)i * ld;
  float m, l;
  row_stats_f32(a, qrow, a.k + hb, b, h, i, red, m, l);
  // p_j and dp_j = keep_j (dO . v_j), recomputed in each walk of the keys.
  auto p_dp = [&](int j, float& p, float& kf, float& dp) {
    p = expf(logit_f32(a, qrow, a.k + hb, b, h, i, j) - m) / l;
    kf = a.keep(b, h, i, j);
    dp = kf * dotf(crow, a.v + hb + (size_t)j * ld, a.dh);
  };
  float part = 0.0f;
  for (int j = threadIdx.x; j < S; j += AF_THREADS) {
    float p, kf, dp;
    p_dp(j, p, kf, dp);
    part += dp * p;
  }
  const float delta = block_reduce(part, red, false);
  for (int j0 = 0; j0 < S; j0 += AF_CHUNK) {
    const int n = min(AF_CHUNK, S - j0);
    for (int jj = threadIdx.x; jj < n; jj += AF_THREADS) {
      float p, kf, dp;
      p_dp(j0 + jj, p, kf, dp);
      ws[jj] = p * kf;
      gs[jj] = p * (dp - delta) * a.scale;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < a.dh; d += AF_THREADS) {
      float c = ctx && j0 ? ctx[ob + d] : 0.0f, q = j0 ? dqrow[d] : 0.0f;
      for (int jj = 0; jj < n; ++jj) {
        const size_t r = hb + (size_t)(j0 + jj) * ld + d;
        if (ctx) c = fmaf(ws[jj], a.v[r], c);
        q = fmaf(gs[jj], a.k[r], q);
      }
      if (ctx) ctx[ob + d] = c;
      dqrow[d] = q;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const size_t n = (size_t)B * a.H * S, o = ((size_t)b * a.H + h) * S + i;
    stats[o] = m;
    stats[n + o] = l;
    stats[2 * n + o] = delta;
  }
}

__global__ void __launch_bounds__(AF_THREADS, 4)  // (AF_THREADS) alone spills 16 bytes
attn_bwd_dkv_f32_rows(Attn<float> a, const float* __restrict__ dout, View ov,
                      const float* __restrict__ stats, float* __restrict__ dk,
                      float* __restrict__ dv, int B) {
  __shared__ float ws[AF_CHUNK];  // w over one chunk of queries
  __shared__ float gs[AF_CHUNK];  // dlog over the chunk
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = a.in.ld, S = a.S;
  const size_t hb = a.in.head(b, h), cb = ov.head(b, h);
  const size_t n = (size_t)B * a.H * S, so = ((size_t)b * a.H + h) * S;
  const float *krow = a.k + hb + (size_t)j * ld, *vrow = a.v + hb + (size_t)j * ld;
  float *dkrow = dk + hb + (size_t)j * ld, *dvrow = dv + hb + (size_t)j * ld;
  for (int i0 = 0; i0 < S; i0 += AF_CHUNK) {
    const int cnt = min(AF_CHUNK, S - i0);
    for (int ii = threadIdx.x; ii < cnt; ii += AF_THREADS) {
      const int i = i0 + ii;
      const float x = dotf(a.q + hb + (size_t)i * ld, krow, a.dh) * a.scale + a.bias.at(b, h, i, j);
      const float p = expf(x - stats[so + i]) / stats[n + so + i];
      const float kf = a.keep(b, h, i, j);
      const float dp = kf * dotf(dout + cb + (size_t)i * ov.ld, vrow, a.dh);
      ws[ii] = p * kf;
      gs[ii] = p * (dp - stats[2 * n + so + i]) * a.scale;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < a.dh; d += AF_THREADS) {
      float gk = i0 ? dkrow[d] : 0.0f, gv = i0 ? dvrow[d] : 0.0f;
      for (int ii = 0; ii < cnt; ++ii) {
        const int i = i0 + ii;
        gv = fmaf(ws[ii], dout[cb + (size_t)i * ov.ld + d], gv);
        gk = fmaf(gs[ii], a.q[hb + (size_t)i * ld + d], gk);
      }
      dkrow[d] = gk;
      dvrow[d] = gv;
    }
    __syncthreads();
  }
}

// Whether every row of every operand starts 16-byte aligned and holds a
// multiple of `per16` values (16 bytes of the dtype: 8 bf16, 4 f32): the
// tiles' 16-byte copies and stores (load_tile, attention_f32.cu's
// load_rows).
bool vec_rows(const Call& c, int per16) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const auto view = [per16](const View& v) {
    return v.sb % per16 == 0 && v.sh % per16 == 0 && v.ld % per16 == 0;
  };
  return c.Dh % per16 == 0 && view(c.in) && view(c.ov) && aligned(c.q) && aligned(c.k) &&
         aligned(c.v) && aligned(c.out) && aligned(c.dout) && aligned(c.dq) && aligned(c.dk) &&
         aligned(c.dv);
}

cudaError_t dispatch(const Call& c, bool backward, cudaStream_t st) {
  if (c.B <= 0 || c.S <= 0 || c.H <= 0 || c.Dh <= 0 || c.out_dtype < 0 || c.out_dtype > 1)
    return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)c.Dh));  // np.float32(1 / sqrt(Dh))
  if (c.dtype == 1) {
    const Attn<bf16> a{static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k),
                       static_cast<const bf16*>(c.v), c.in, c.bias, c.S, c.H, c.Dh, scale,
                       c.drop, vec_rows(c, 8), c.tiles};
    return backward ? launch_bwd(a, c, st) : launch_fwd(a, c, st);
  }
  // float32 inputs: f32 outputs only.
  if (c.dtype != 0 || c.out_dtype != 0) return cudaErrorInvalidValue;
  const Attn<float> a{static_cast<const float*>(c.q), static_cast<const float*>(c.k),
                      static_cast<const float*>(c.v), c.in, c.bias, c.S, c.H, c.Dh, scale, c.drop,
                      vec_rows(c, 4), c.tiles};
  if (c.Dh <= MAX_TILE_DH) return launch_f32_tiled(a, c, backward, st);
  dim3 grid(c.S, c.H, c.B);
  if (!backward) {
    attn_fwd_f32_rows<<<grid, AF_THREADS, 0, st>>>(a, static_cast<float*>(c.out), c.ov);
    return cudaGetLastError();
  }
  const float* dout = static_cast<const float*>(c.dout);
  attn_bwd_dq_f32_rows<<<grid, AF_THREADS, 0, st>>>(a, dout, static_cast<float*>(c.out), c.ov,
                                                    static_cast<float*>(c.dq), c.stats, c.B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_f32_rows<<<grid, AF_THREADS, 0, st>>>(a, dout, c.ov, c.stats,
                                                     static_cast<float*>(c.dk),
                                                     static_cast<float*>(c.dv), c.B);
  return cudaGetLastError();
}

Dropout make_drop(const void* bits, int seed, int boff, unsigned thr, float inv_keep, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), (uint32_t)seed, (uint32_t)boff, thr, inv_keep,
                 mode};
}

}  // namespace

// dtype, out_dtype: 0 = float32, 1 = bfloat16. q, k, v share the view
// (sb, sh, ld); out and dout the view (osb, osh, old); bias is additive
// f32 with strides (bb, bh, bi), or null. mode: 0 no dropout, 1 injected
// bits ([B, H, S, S] uint32), 2 in-kernel Philox keyed on seed, with boff
// added to the batch index of its counter. Dh: any head dim from 1. tiles:
// null, or an int64 [2] that the tile kernels' blocks add their walked and
// full (query tile, key tile) score tiles to (count_tiles).
extern "C" int mdm_attention_fwd(const void* q, const void* k, const void* v, long long sb,
                                 long long sh, int ld, const void* bias, long long bb,
                                 long long bh, int bi, const void* bits, int seed, int boff,
                                 unsigned thr, float inv_keep, int mode, void* out, long long osb,
                                 long long osh, int old, int out_dtype, void* tiles, int B, int S,
                                 int H, int Dh, int dtype, void* stream) {
  const Call c{q, k, v, View{sb, sh, ld}, Bias{static_cast<const float*>(bias), bb, bh, bi},
               make_drop(bits, seed, boff, thr, inv_keep, mode), out, View{osb, osh, old},
               out_dtype, nullptr, nullptr, nullptr, nullptr, nullptr, B, S, H, Dh, dtype,
               static_cast<unsigned long long*>(tiles)};
  return (int)dispatch(c, false, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the bf16 forward into *blocks, for head dim Dh,
// out_dtype (0 = float32, 1 = bfloat16), bias form 0 none, 1 row (bi = 0),
// 2 full, and the kernel S picks: resident logits (S <= 256, resident = 1)
// or two passes (resident = 0). Head dims above 128 have the two-pass
// kernel only, which either value reports; above 256 (the wide kernels)
// none: cudaErrorInvalidValue.
extern "C" int mdm_attention_fwd_occupancy(int Dh, int out_dtype, int form, int resident,
                                           int* blocks) {
  if (form < 0 || form > 2 || out_dtype < 0 || out_dtype > 1) return (int)cudaErrorInvalidValue;
  return (int)fwd_occupancy(Dh, out_dtype, form, resident != 0, blocks);
}

// Resident blocks per SM of the bf16 backward's kernel (0: dq, 1: dk/dv)
// into *blocks, for head dim Dh and bias form 0 none, 1 row, 2 full.
extern "C" int mdm_attention_bwd_occupancy(int Dh, int form, int kernel, int* blocks) {
  if (form < 0 || form > 2 || kernel < 0 || kernel > 1) return (int)cudaErrorInvalidValue;
  return (int)bwd_occupancy(Dh, form, kernel, blocks);
}

// Writes dq, dk, dv (through the q/k/v view, in dtype), the row statistics
// stats (f32 [3, B*H*S]: bf16 inputs max, 1/sum, delta; f32 inputs max,
// sum, delta) and, when ctx is not null, the forward's out recomputed into
// ctx (dtype, through the out view); tiles as mdm_attention_fwd's, over
// every kernel of the call.
extern "C" int mdm_attention_bwd(const void* q, const void* k, const void* v, long long sb,
                                 long long sh, int ld, const void* bias, long long bb,
                                 long long bh, int bi, const void* bits, int seed, int boff,
                                 unsigned thr, float inv_keep, int mode, const void* dout, void* ctx,
                                 long long osb, long long osh, int old, void* dq, void* dk,
                                 void* dv, void* stats, void* tiles, int B, int S, int H, int Dh,
                                 int dtype, void* stream) {
  const Call c{q, k, v, View{sb, sh, ld}, Bias{static_cast<const float*>(bias), bb, bh, bi},
               make_drop(bits, seed, boff, thr, inv_keep, mode), ctx, View{osb, osh, old}, dtype,
               dout, dq, dk, dv, static_cast<float*>(stats), B, S, H, Dh, dtype,
               static_cast<unsigned long long*>(tiles)};
  return (int)dispatch(c, true, static_cast<cudaStream_t>(stream));
}
