// Row and elementwise kernels of the encoder-layer tail, forward and
// backward. With the products of gemm_sm90.cu (gemm.cu in f32) they replace
// the TPU kernels mdm_tpu/ops/encoder_tail.py::_fwd_kernel (pallas_call at
// :309,313) and ::_bwd_kernel (:358,364):
//
//   s1 = x + drop0(attn);  y32 = LN1(s1);  y = dt(y32)           tail_ln_fwd (site 0)
//   u  = y . W1^T + b1 (f32)                                      gemm
//   hd = dt(drop1(gelu(u)))                                       tail_gelu_dropout
//   o  = hd . W2^T + b2 (f32)                                     gemm
//   z  = dt(LN2(y32 + drop2(o)))                                  tail_ln_fwd (site 2)
//
// backward, from the forward's y, y32, u, hd, o and its packed keep masks:
//   ds2 = LN2'(dz);  do = drop2(ds2);  dg2, dbl2, db2             tail_ln_bwd<3>
//   dhd = do16 . W2;  du = drop1(dhd) gelu'(u);  db1              tail_gelu_bwd
//   dy  = ds2 + du16 . W1;  dx = ds1 = LN1'(dy), da = drop0(ds1);  dg1, dbl1
//                                                                 tail_ln_bwd<2>
// The rounding points are the TPU kernel's: y32 and o stay f32, hd and y go
// to dt, do and du go to dt for the products while db2 and db1 sum their
// f32 values. LayerNorm variance is E[s^2] - E[s]^2 (eps 1e-5); its
// backward follows encoder_tail.py::_ln_bwd. GELU uses erff and the exact
// derivative Phi(u) + u phi(u) (the TPU kernel's A&S 7.1.26 erf is within
// 1.5e-7).
//
// Bound on an H100 by their bytes (a few per element) once the dropout
// words are paid for: a Philox4x32-10 word is ~60 integer instructions,
// and the forward draws (2D + F) of them a row. So:
// - each dropout word is drawn once. With dropout on, the forward stores
//   each site's keep decisions as a packed mask, bit c % 32 of word c / 32
//   of row m ((2D + F) / 8 bytes a row), and the backward reads the masks
//   and draws nothing. In mode 1 the mask packs the injected bits (kept
//   where bits < thr), in mode 2 the Philox words of philox.cuh, so the
//   stream and the dumps are unchanged;
// - a lane owns chunks of 8 consecutive values (one 16-byte access in bf16,
//   two in f32), chunk ci at lanes ci % 32: the 4 lanes of a mask word
//   combine their 8 bits with two shuffles;
// - the LayerNorm kernels hold a row in registers: a warp a row up to D =
//   32 x 4 x 8 = 1024 (K = 1, 2, 4 chunks a lane), read once, normalised
//   and stored from registers; above it the whole block takes a row in
//   segments of ROW_THREADS chunks, read again in each pass when there are
//   several (the keep bits then come back from the mask it wrote);
// - the column sums are fused: a backward block owns CHUNK_ROWS rows (a
//   constant, never the grid or the SM count), adds its rows' terms per
//   column in row order, reduces its warps in warp order through shared
//   memory and writes one f32 partial row per chunk; mdm::sum_splits adds
//   the partials in chunk order. No float atomics: two runs are bitwise
//   equal.

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

using mdm::bf16;
using mdm::Dropout;

namespace {

constexpr int ROW_THREADS = 256, ROW_WARPS = ROW_THREADS / 32;
constexpr int CHUNK_ROWS = 32;     // rows per backward block: one column partial each
constexpr int GELU_FWD_ROWS = 16;  // rows per tail_gelu_dropout block
constexpr int STREAM_CHUNKS = 1;   // chunks per thread per segment of a block-wide row
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Keep bits of the 8 values from column c0 of row (b, s) at a site, bit j
// for column c0 + j: mode 0 keeps all; 1 reads the injected words at idx;
// 2 draws one Philox word per value, the only draw of the value.
__device__ __forceinline__ unsigned draw8(const Dropout& d, size_t idx, uint32_t b,
                                          uint32_t site, uint32_t s, uint32_t c0) {
  if (d.mode == 0) return 0xffu;
  unsigned byte = 0;
  if (d.mode == 1) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(d.bits + idx);
    const uint4 w1 = *reinterpret_cast<const uint4*>(d.bits + idx + 4);
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) byte |= (unsigned)(w[j] < d.thr) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      byte |= (unsigned)(mdm::philox_word(d.seed, c0 + j, s, site, b + d.boff) < d.thr) << j;
  }
  return byte;
}

// The mask word of the 4 chunks held by lanes 4q .. 4q+3 (chunk ci at a
// lane with ci % 4 == lane % 4); every lane of the warp calls it.
__device__ __forceinline__ uint32_t pack_word(unsigned byte) {
  uint32_t w = (uint32_t)byte << (8 * (threadIdx.x & 3));
  w |= __shfl_xor_sync(FULL, w, 1);
  w |= __shfl_xor_sync(FULL, w, 2);
  return w;
}

// Chunk ci's 8 keep bits from a packed mask row (all kept without one).
__device__ __forceinline__ unsigned mask_byte(const uint32_t* mask, size_t row_word, int ci) {
  return mask ? (mask[row_word + ci / 4] >> (8 * (ci & 3))) & 0xffu : 0xffu;
}

__device__ __forceinline__ float keep_factor(unsigned byte, int j, float inv_keep) {
  return (byte >> j) & 1u ? inv_keep : 0.0f;
}

// The threads that own one row of D values in chunks of 8: a warp (BLOCK
// false: K chunks a lane, D <= 32 K 8, the row in registers) or the whole
// block (true: segments of ROW_THREADS K chunks).
template <int K, bool BLOCK>
struct RowGroup {
  static constexpr int kSize = BLOCK ? ROW_THREADS : 32;
  int gi, nc, nseg;
  __device__ explicit RowGroup(int D)
      : gi(BLOCK ? threadIdx.x : threadIdx.x & 31),
        nc(D / 8),
        nseg(BLOCK ? (D / 8 + kSize * K - 1) / (kSize * K) : 1) {}
  __device__ int chunk(int seg, int k) const { return gi + kSize * (seg * K + k); }
  // a and b summed over the group, in a fixed order.
  __device__ void sum2(float& a, float& b, float* red) const {
    a = mdm::warp_sum(a);
    b = mdm::warp_sum(b);
    if (BLOCK) {
      const int w = threadIdx.x >> 5;
      __syncthreads();  // the last call's reads are done
      if ((threadIdx.x & 31) == 0) red[2 * w] = a, red[2 * w + 1] = b;
      __syncthreads();
      a = b = 0.0f;
#pragma unroll
      for (int i = 0; i < ROW_WARPS; ++i) a += red[2 * i], b += red[2 * i + 1];
    }
  }
};

// out = dt(LN(r + drop(h)) g + beta) (and out32 = its f32 value, site 0),
// drop the site's dropout: its mask row written where dropout is on.
template <typename T, typename R, int K, bool BLOCK>
__global__ void __launch_bounds__(ROW_THREADS)
tail_ln_fwd(const R* __restrict__ r, const R* __restrict__ h, Dropout d, int site,
            uint32_t* __restrict__ mask, const T* __restrict__ g, const T* __restrict__ beta,
            T* __restrict__ out, float* __restrict__ out32, int M, int S, int D) {
  __shared__ float red[2 * ROW_WARPS];
  const RowGroup<K, BLOCK> grp(D);
  const int m = BLOCK ? blockIdx.x : blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;  // a whole warp (BLOCK: never)
  const size_t off = (size_t)m * D, moff = (size_t)m * ((D + 31) / 32);
  const uint32_t b = m / S, s = m % S;
  const bool again = BLOCK && grp.nseg > 1;  // the row does not stay in registers
  float v[K][8];
  float sum = 0.0f, sq = 0.0f;
  for (int seg = 0; seg < grp.nseg; ++seg) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ci = grp.chunk(seg, k);
      const bool on = ci < grp.nc;
      const unsigned keep = on ? draw8(d, off + ci * 8, b, site, s, ci * 8) : 0u;
      if (d.mode) {
        const uint32_t w = pack_word(keep);
        if (on && (ci & 3) == 0) mask[moff + ci / 4] = w;
      }
      if (on) {
        float hv[8];
        load8(r + off + ci * 8, v[k]);
        load8(h + off + ci * 8, hv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[k][j] += hv[j] * keep_factor(keep, j, d.inv_keep);
          sum += v[k][j];
          sq += v[k][j] * v[k][j];
        }
      }
    }
  }
  grp.sum2(sum, sq, red);  // BLOCK: its barrier also publishes the mask words
  const float mu = sum / D, rstd = rsqrtf(sq / D - mu * mu + mdm::kLnEps);
  for (int seg = 0; seg < grp.nseg; ++seg) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ci = grp.chunk(seg, k);
      if (ci >= grp.nc) continue;
      const size_t e = off + ci * 8;
      if (again) {
        const unsigned keep = mask_byte(d.mode ? mask : nullptr, moff, ci);
        float hv[8];
        load8(r + e, v[k]);
        load8(h + e, hv);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[k][j] += hv[j] * keep_factor(keep, j, d.inv_keep);
      }
      float gv[8], bv[8], o[8];
      load8(g + ci * 8, gv);
      load8(beta + ci * 8, bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (v[k][j] - mu) * rstd * gv[j] + bv[j];
      store8(out + e, o);
      if (out32) store8(out32 + e, o);
    }
  }
}

// hd = dt(gelu(u) drop1), its mask row written where dropout is on. A
// thread owns one chunk of 8 columns over GELU_FWD_ROWS rows.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_gelu_dropout(const float* __restrict__ u, Dropout d, uint32_t* __restrict__ mask,
                  T* __restrict__ hd, int M, int S, int F) {
  const int nc = F / 8, W = (F + 31) / 32;
  const int ci = blockIdx.y * blockDim.x + threadIdx.x;
  const bool on = ci < nc;
  const int r1 = min(M, (int)(blockIdx.x + 1) * GELU_FWD_ROWS);
  for (int m = blockIdx.x * GELU_FWD_ROWS; m < r1; ++m) {
    const size_t e = (size_t)m * F + ci * 8;
    const unsigned keep = on ? draw8(d, e, m / S, 1, m % S, ci * 8) : 0u;
    if (d.mode) {
      const uint32_t w = pack_word(keep);
      if (on && (ci & 3) == 0) mask[(size_t)m * W + ci / 4] = w;
    }
    if (on) {
      float v[8];
      load8(u + e, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = mdm::gelu_exact(v[j]) * keep_factor(keep, j, d.inv_keep);
      store8(hd + e, v);
    }
  }
}

// The LayerNorm backward of rows s = r + drop(h) given the upstream dout
// (encoder_tail.py::_ln_bwd): ds = (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)) rstd, dxhat = dout g. Stores ds in f32 (ds32) and/or
// dt (ds16) and dt(ds keep) (dk16); the block's column partials into
// work[chunk][q][D]: q = 0 dout xhat, 1 dout, and with NQ = 3 also 2 ds
// keep.
template <typename T, typename R, typename G, int K, bool BLOCK, int NQ>
__global__ void __launch_bounds__(ROW_THREADS, 1)  // (ROW_THREADS) alone spills K = 1, 2
tail_ln_bwd(const R* __restrict__ r, const R* __restrict__ h, const uint32_t* __restrict__ mask,
            float inv_keep, const T* __restrict__ g, const G* __restrict__ dout,
            float* __restrict__ ds32, T* __restrict__ ds16, T* __restrict__ dk16,
            float* __restrict__ work, int M, int D) {
  __shared__ float red[2 * ROW_WARPS];
  __shared__ __align__(16) float cols[BLOCK ? 4 : ROW_WARPS * K * 256];
  const RowGroup<K, BLOCK> grp(D);
  const int W = (D + 31) / 32, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * CHUNK_ROWS, r1 = min(M, r0 + CHUNK_ROWS);
  const bool again = BLOCK && grp.nseg > 1;
  float* part = work + (size_t)blockIdx.x * NQ * D;
  float acc[NQ][K][8];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][k][j] = 0.0f;
  for (int m = r0 + (BLOCK ? 0 : warp); m < r1; m += BLOCK ? 1 : ROW_WARPS) {
    const size_t off = (size_t)m * D, moff = (size_t)m * W;
    // s (then xhat) and the keep bits stay in registers; dout is read in
    // each pass that uses it (from L1), which keeps the row's registers
    // within reach of the column partials.
    float v[K][8];
    unsigned kb[K];
    auto load = [&](int seg, int k) {  // s into v[k] and its keep bits
      const int ci = grp.chunk(seg, k);
      if (ci >= grp.nc) return;
      const size_t e = off + ci * 8;
      float hv[8];
      kb[k] = mask_byte(mask, moff, ci);
      load8(r + e, v[k]);
      load8(h + e, hv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] += hv[j] * keep_factor(kb[k], j, inv_keep);
    };
    float sum = 0.0f, sq = 0.0f;
    for (int seg = 0; seg < grp.nseg; ++seg) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        load(seg, k);
        if (grp.chunk(seg, k) >= grp.nc) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += v[k][j], sq += v[k][j] * v[k][j];
      }
    }
    grp.sum2(sum, sq, red);
    const float mu = sum / D, rstd = rsqrtf(sq / D - mu * mu + mdm::kLnEps);
    float m1 = 0.0f, m2 = 0.0f;
    for (int seg = 0; seg < grp.nseg; ++seg) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (again) load(seg, k);
        const int ci = grp.chunk(seg, k);
        if (ci >= grp.nc) continue;
        float gv[8], dv[8];
        load8(g + ci * 8, gv);
        load8(dout + off + ci * 8, dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = (v[k][j] - mu) * rstd, dxhat = dv[j] * gv[j];
          v[k][j] = xhat;
          m1 += dxhat;
          m2 += dxhat * xhat;
        }
      }
    }
    grp.sum2(m1, m2, red);
    m1 /= D;
    m2 /= D;
    for (int seg = 0; seg < grp.nseg; ++seg) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int ci = grp.chunk(seg, k);
        if (again) {
          load(seg, k);
          if (ci < grp.nc)
#pragma unroll
            for (int j = 0; j < 8; ++j) v[k][j] = (v[k][j] - mu) * rstd;
        }
        if (ci >= grp.nc) continue;
        const size_t e = off + ci * 8;
        float gv[8], dv[8], ds[8], dk[8];
        load8(g + ci * 8, gv);
        load8(dout + e, dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = v[k][j], dxhat = dv[j] * gv[j];
          ds[j] = (dxhat - m1 - xhat * m2) * rstd;
          dk[j] = ds[j] * keep_factor(kb[k], j, inv_keep);
        }
        if (ds32) store8(ds32 + e, ds);
        if (ds16) store8(ds16 + e, ds);
        store8(dk16 + e, dk);
        float t[NQ][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          t[0][j] = dv[j] * v[k][j];
          t[1][j] = dv[j];
          if (NQ == 3) t[NQ - 1][j] = dk[j];
        }
        if (BLOCK) {  // the thread owns these columns for the whole chunk of rows
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float* p = part + (size_t)q * D + ci * 8;
            float prev[8];
            if (m == r0) {
              store8(p, t[q]);
            } else {
              load8(p, prev);
#pragma unroll
              for (int j = 0; j < 8; ++j) prev[j] += t[q][j];
              store8(p, prev);
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[q][k][j] += t[q][j];
        }
      }
    }
  }
  if (BLOCK) return;
  // The warps' partials, summed in warp order, one quantity at a time.
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) store8(cols + warp * K * 256 + (lane + 32 * k) * 8, acc[q][k]);
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += ROW_THREADS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < ROW_WARPS; ++w) s += cols[w * K * 256 + c];
      part[(size_t)q * D + c] = s;
    }
    __syncthreads();
  }
}

// du = dt((dhd drop1) gelu'(u)), and db1's partial over the block's
// CHUNK_ROWS rows into work[chunk][F]. A thread owns one chunk of 8 columns.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_gelu_bwd(const float* __restrict__ u, const float* __restrict__ dhd,
              const uint32_t* __restrict__ mask, float inv_keep, T* __restrict__ du16,
              float* __restrict__ work, int M, int F) {
  const int nc = F / 8, W = (F + 31) / 32;
  const int ci = blockIdx.y * blockDim.x + threadIdx.x;
  if (ci >= nc) return;
  const int r0 = blockIdx.x * CHUNK_ROWS, r1 = min(M, r0 + CHUNK_ROWS);
  float acc[8] = {};
#pragma unroll 2
  for (int m = r0; m < r1; ++m) {
    const size_t e = (size_t)m * F + ci * 8;
    const unsigned keep = mask_byte(mask, (size_t)m * W, ci);
    float uv[8], dv[8];
    load8(u + e, uv);
    load8(dhd + e, dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dv[j] = (dv[j] * keep_factor(keep, j, inv_keep)) * mdm::gelu_grad(uv[j]);
      acc[j] += dv[j];
    }
    store8(du16 + e, dv);
  }
  store8(work + (size_t)blockIdx.x * F + ci * 8, acc);
}

// Chunks of 8 a lane that hold a row of D in a warp's registers; 0 above
// 1024 (the block-wide instance).
int resident_chunks(int D) {
  const int nc = D / 8;
  return nc <= 32 ? 1 : nc <= 64 ? 2 : nc <= 128 ? 4 : 0;
}

unsigned chunks_of(int M) { return (unsigned)((M + CHUNK_ROWS - 1) / CHUNK_ROWS); }

// Threads along the 8-value column chunks of an elementwise kernel, and the
// grid: (row blocks, column tiles).
dim3 elem_grid(int M, int rows, int F, int& threads) {
  const int nc = F / 8;
  threads = min(ROW_THREADS, (nc + 31) / 32 * 32);
  return dim3((unsigned)((M + rows - 1) / rows), (unsigned)((nc + threads - 1) / threads));
}

template <typename T, typename R>
cudaError_t launch_ln_fwd(const void* r, const void* h, Dropout d, int site, void* mask,
                          const void* g, const void* beta, void* out, void* out32, int M, int S,
                          int D, cudaStream_t st) {
#define MDM_LN_FWD_ARGS                                                                        \
  static_cast<const R*>(r), static_cast<const R*>(h), d, site, static_cast<uint32_t*>(mask), \
      static_cast<const T*>(g), static_cast<const T*>(beta), static_cast<T*>(out),           \
      static_cast<float*>(out32), M, S, D
  const unsigned warps = (unsigned)((M + ROW_WARPS - 1) / ROW_WARPS);
  switch (resident_chunks(D)) {
    case 1: tail_ln_fwd<T, R, 1, false><<<warps, ROW_THREADS, 0, st>>>(MDM_LN_FWD_ARGS); break;
    case 2: tail_ln_fwd<T, R, 2, false><<<warps, ROW_THREADS, 0, st>>>(MDM_LN_FWD_ARGS); break;
    case 4: tail_ln_fwd<T, R, 4, false><<<warps, ROW_THREADS, 0, st>>>(MDM_LN_FWD_ARGS); break;
    default:
      tail_ln_fwd<T, R, STREAM_CHUNKS, true><<<(unsigned)M, ROW_THREADS, 0, st>>>(MDM_LN_FWD_ARGS);
  }
#undef MDM_LN_FWD_ARGS
  return cudaGetLastError();
}

template <typename T, typename R, typename G, int NQ>
cudaError_t launch_ln_bwd(const void* r, const void* h, const void* mask, float inv_keep,
                          const void* g, const void* dout, void* ds32, void* ds16, void* dk16,
                          void* work, void* sums, int M, int D, cudaStream_t st) {
#define MDM_LN_BWD_ARGS                                                                   \
  static_cast<const R*>(r), static_cast<const R*>(h), static_cast<const uint32_t*>(mask), \
      inv_keep, static_cast<const T*>(g), static_cast<const G*>(dout),                    \
      static_cast<float*>(ds32), static_cast<T*>(ds16), static_cast<T*>(dk16),            \
      static_cast<float*>(work), M, D
  const unsigned chunks = chunks_of(M);
  switch (resident_chunks(D)) {
    case 1: tail_ln_bwd<T, R, G, 1, false, NQ><<<chunks, ROW_THREADS, 0, st>>>(MDM_LN_BWD_ARGS); break;
    case 2: tail_ln_bwd<T, R, G, 2, false, NQ><<<chunks, ROW_THREADS, 0, st>>>(MDM_LN_BWD_ARGS); break;
    case 4: tail_ln_bwd<T, R, G, 4, false, NQ><<<chunks, ROW_THREADS, 0, st>>>(MDM_LN_BWD_ARGS); break;
    default:
      tail_ln_bwd<T, R, G, STREAM_CHUNKS, true, NQ><<<chunks, ROW_THREADS, 0, st>>>(MDM_LN_BWD_ARGS);
  }
#undef MDM_LN_BWD_ARGS
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return mdm::sum_splits(static_cast<const float*>(work), static_cast<float*>(sums),
                         (size_t)NQ * D, (int)chunks, st);
}

Dropout make_drop(const void* bits, int seed, int boff, unsigned thr, float inv_keep, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), (uint32_t)seed, (uint32_t)boff, thr, inv_keep,
                 mode};
}

// Whether a forward's dropout arguments hold: mode 0-2, the mask to write
// where dropout is on, the bits to read in mode 1.
bool drop_ok(const void* bits, int mode, const void* mask) {
  return mode >= 0 && mode <= 2 && (mode == 0 || mask) && (mode != 1 || bits);
}

bool shape_ok(int M, int S, int D) { return M > 0 && S > 0 && D > 0 && D % 8 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, attn, the LayerNorm parameters and
// the dt outputs); y32, u, o, dhd, dy, ds2 and the partials are f32. Forward
// mode: 0 no dropout (mask unused), 1 injected bits (the site's [B, S, n]
// uint32), 2 Philox on seed, boff added to the batch index of its
// counter; modes 1 and 2 write the site's packed keep
// mask, uint32 [M, ceil(n / 32)]. D and F: multiples of 8, 16-byte aligned
// operands. Backward: mask null for no dropout; work f32 [ceil(M / 32), q,
// n] holds the column partials, sums f32 [q, n] their sums.
extern "C" int mdm_tail_ln1_fwd(const void* x, const void* a, const void* bits, int seed,
                                int boff, unsigned thr, float inv_keep, int mode, void* mask,
                                const void* g, const void* beta, void* y, void* y32, int M, int S,
                                int D, int dtype, void* stream) {
  if (!shape_ok(M, S, D) || !drop_ok(bits, mode, mask)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout d = make_drop(bits, seed, boff, thr, inv_keep, mode);
  if (dtype == 0) return (int)launch_ln_fwd<float, float>(x, a, d, 0, mask, g, beta, y, y32, M, S, D, st);
  if (dtype == 1) return (int)launch_ln_fwd<bf16, bf16>(x, a, d, 0, mask, g, beta, y, y32, M, S, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mdm_tail_gelu_dropout(const void* u, const void* bits, int seed, int boff,
                                     unsigned thr, float inv_keep, int mode, void* mask, void* hd,
                                     int M, int S, int F, int dtype, void* stream) {
  if (!shape_ok(M, S, F) || !drop_ok(bits, mode, mask)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout d = make_drop(bits, seed, boff, thr, inv_keep, mode);
  int threads;
  const dim3 grid = elem_grid(M, GELU_FWD_ROWS, F, threads);
  const float* uf = static_cast<const float*>(u);
  uint32_t* mk = static_cast<uint32_t*>(mask);
  if (dtype == 0)
    tail_gelu_dropout<float><<<grid, threads, 0, st>>>(uf, d, mk, static_cast<float*>(hd), M, S, F);
  else if (dtype == 1)
    tail_gelu_dropout<bf16><<<grid, threads, 0, st>>>(uf, d, mk, static_cast<bf16*>(hd), M, S, F);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int mdm_tail_ln2_fwd(const void* y32, const void* o, const void* bits, int seed,
                                int boff, unsigned thr, float inv_keep, int mode, void* mask,
                                const void* g, const void* beta, void* z, int M, int S, int D,
                                int dtype, void* stream) {
  if (!shape_ok(M, S, D) || !drop_ok(bits, mode, mask)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout d = make_drop(bits, seed, boff, thr, inv_keep, mode);
  if (dtype == 0)
    return (int)launch_ln_fwd<float, float>(y32, o, d, 2, mask, g, beta, z, nullptr, M, S, D, st);
  if (dtype == 1)
    return (int)launch_ln_fwd<bf16, float>(y32, o, d, 2, mask, g, beta, z, nullptr, M, S, D, st);
  return (int)cudaErrorInvalidValue;
}

// ds2 (f32) and do16 = dt(ds2 keep2); sums [3, D]: dg2, dbl2, db2.
extern "C" int mdm_tail_ln2_bwd(const void* y32, const void* o, const void* mask, float inv_keep,
                                const void* g, const void* dz, void* ds2, void* do16, void* work,
                                void* sums, int M, int D, int dtype, void* stream) {
  if (!shape_ok(M, 1, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_ln_bwd<float, float, float, 3>(y32, o, mask, inv_keep, g, dz, ds2, nullptr,
                                                      do16, work, sums, M, D, st);
  if (dtype == 1)
    return (int)launch_ln_bwd<bf16, float, bf16, 3>(y32, o, mask, inv_keep, g, dz, ds2, nullptr,
                                                    do16, work, sums, M, D, st);
  return (int)cudaErrorInvalidValue;
}

// du16 = dt((dhd keep1) gelu'(u)); db1 [F] its column sum in f32.
extern "C" int mdm_tail_gelu_bwd(const void* u, const void* dhd, const void* mask,
                                 float inv_keep, void* du16, void* work, void* db1, int M, int F,
                                 int dtype, void* stream) {
  if (!shape_ok(M, 1, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int threads;
  const dim3 grid = elem_grid(M, CHUNK_ROWS, F, threads);
  const float *uf = static_cast<const float*>(u), *df = static_cast<const float*>(dhd);
  const uint32_t* mk = static_cast<const uint32_t*>(mask);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    tail_gelu_bwd<float><<<grid, threads, 0, st>>>(uf, df, mk, inv_keep, static_cast<float*>(du16),
                                                   wk, M, F);
  else if (dtype == 1)
    tail_gelu_bwd<bf16><<<grid, threads, 0, st>>>(uf, df, mk, inv_keep, static_cast<bf16*>(du16),
                                                  wk, M, F);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)mdm::sum_splits(wk, static_cast<float*>(db1), (size_t)F, (int)chunks_of(M), st);
}

// dx = ds1 and da = dt(ds1 keep0); sums [2, D]: dg1, dbl1.
extern "C" int mdm_tail_ln1_bwd(const void* x, const void* a, const void* mask, float inv_keep,
                                const void* g, const void* dy, void* dx, void* da, void* work,
                                void* sums, int M, int D, int dtype, void* stream) {
  if (!shape_ok(M, 1, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_ln_bwd<float, float, float, 2>(x, a, mask, inv_keep, g, dy, nullptr, dx, da,
                                                      work, sums, M, D, st);
  if (dtype == 1)
    return (int)launch_ln_bwd<bf16, bf16, float, 2>(x, a, mask, inv_keep, g, dy, nullptr, dx, da,
                                                    work, sums, M, D, st);
  return (int)cudaErrorInvalidValue;
}
