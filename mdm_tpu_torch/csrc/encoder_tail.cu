// Row and elementwise kernels of the encoder-layer tail, forward and
// backward. With the products of gemm.cu they replace the TPU kernels
// mdm_tpu/ops/encoder_tail.py::_fwd_kernel (pallas_call at :309,313) and
// ::_bwd_kernel (:358,364):
//
//   s1 = x + drop0(attn);  y32 = LN1(s1);  y = dt(y32)           tail_ln1_fwd
//   u  = y . W1^T + b1 (f32)                                      gemm.cu
//   hd = dt(drop1(gelu(u)))                                       tail_gelu_dropout
//   o  = hd . W2^T + b2 (f32)                                     gemm.cu
//   z  = dt(LN2(y32 + drop2(o)))                                  tail_ln2_fwd
//
// The backward recomputes that chain (no activation is saved) and replays
// the three dropout masks from the same (seed, site, row, column) counters:
//   ds2 = LN2'(dz);  do = drop2(ds2)                              tail_ln2_bwd
//   dhd = do16 . W2;  du = drop1(dhd) gelu'(u)                    tail_gelu_bwd
//   dy  = ds2 + du16 . W1;  ds1 = LN1'(dy);  dx = ds1, da = drop0(ds1)   tail_ln1_bwd
// with the weight products and column sums in gemm.cu. The rounding
// points are the TPU kernel's: y32 and o stay f32, hd and y go to dt, do
// and du go to dt for the products while db2 and db1 sum their f32 values.
// LayerNorm variance is E[s^2] - E[s]^2 (eps 1e-5); its backward follows
// encoder_tail.py::_ln_bwd. GELU uses erff and the exact derivative
// Phi(u) + u phi(u) (the TPU kernel's A&S 7.1.26 erf is within 1.5e-7).
//
// One warp per row of D; elementwise kernels grid-stride over [M, F].
// Bound by memory traffic (a few bytes per element against 10 Philox
// rounds where dropout draws in-kernel).

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

using mdm::bf16;
using mdm::Dropout;
using mdm::from_f;
using mdm::to_f;

namespace {

constexpr int ROWS_PER_BLOCK = 8, ROW_THREADS = 256;

struct Row {
  int m, b, s;  // flat row, batch index, sequence position
};

__device__ __forceinline__ bool row_of(int M, int S, Row& r) {
  r.m = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r.m >= M) return false;
  r.b = r.m / S;
  r.s = r.m % S;
  return true;
}

// Mean and rstd of the row s(c), c < D, produced by f (lane-strided).
template <typename F>
__device__ __forceinline__ void row_moments(F f, int D, float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float v = f(c);
    sum += v;
    sq += v * v;
  }
  sum = mdm::warp_sum(sum);
  sq = mdm::warp_sum(sq);
  mu = sum / D;
  rstd = rsqrtf(sq / D - mu * mu + mdm::kLnEps);
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_ln1_fwd(const T* __restrict__ x, const T* __restrict__ a, Dropout d0,
             const T* __restrict__ g, const T* __restrict__ beta, T* __restrict__ y,
             float* __restrict__ y32, int M, int S, int D) {
  Row r;
  if (!row_of(M, S, r)) return;
  const size_t off = (size_t)r.m * D;
  auto s1 = [&](int c) {
    return to_f(x[off + c]) + to_f(a[off + c]) * d0.keep(off + c, r.b, 0, r.s, c);
  };
  float mu, rstd;
  row_moments(s1, D, mu, rstd);
  for (int c = threadIdx.x & 31; c < D; c += 32) {
    const float v = (s1(c) - mu) * rstd * to_f(g[c]) + to_f(beta[c]);
    y[off + c] = from_f<T>(v);
    y32[off + c] = v;
  }
}

template <typename T>
__global__ void tail_gelu_dropout(const float* __restrict__ u, Dropout d1, T* __restrict__ hd,
                                  int M, int S, int F) {
  const size_t n = (size_t)M * F;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / F), c = (int)(i % F);
    hd[i] = from_f<T>(mdm::gelu_exact(u[i]) * d1.keep(i, m / S, 1, m % S, c));
  }
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_ln2_fwd(const float* __restrict__ y32, const float* __restrict__ o, Dropout d2,
             const T* __restrict__ g, const T* __restrict__ beta, T* __restrict__ z, int M,
             int S, int D) {
  Row r;
  if (!row_of(M, S, r)) return;
  const size_t off = (size_t)r.m * D;
  auto s2 = [&](int c) { return y32[off + c] + o[off + c] * d2.keep(off + c, r.b, 2, r.s, c); };
  float mu, rstd;
  row_moments(s2, D, mu, rstd);
  for (int c = threadIdx.x & 31; c < D; c += 32)
    z[off + c] = from_f<T>((s2(c) - mu) * rstd * to_f(g[c]) + to_f(beta[c]));
}

// LayerNorm backward of one row (encoder_tail.py::_ln_bwd): calls
// out(c, ds, xhat) for every column with ds = (dxhat - m1 - xhat m2) rstd.
template <typename SF, typename DF, typename OUT, typename T>
__device__ __forceinline__ void ln_row_bwd(SF s, DF dout, const T* g, int D, OUT out) {
  float mu, rstd;
  row_moments(s, D, mu, rstd);
  const int lane = threadIdx.x & 31;
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float xhat = (s(c) - mu) * rstd;
    const float dxhat = dout(c) * to_f(g[c]);
    m1 += dxhat;
    m2 += dxhat * xhat;
  }
  m1 = mdm::warp_sum(m1) / D;
  m2 = mdm::warp_sum(m2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xhat = (s(c) - mu) * rstd;
    const float dxhat = dout(c) * to_f(g[c]);
    out(c, (dxhat - m1 - xhat * m2) * rstd, xhat);
  }
}

// ds2 (f32), do = drop2(ds2) in dt and f32, and dz * xhat2 for dg2.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_ln2_bwd(const float* __restrict__ y32, const float* __restrict__ o, Dropout d2,
             const T* __restrict__ g, const T* __restrict__ dz, float* __restrict__ ds2,
             T* __restrict__ do16, float* __restrict__ do32, float* __restrict__ gz, int M,
             int S, int D) {
  Row r;
  if (!row_of(M, S, r)) return;
  const size_t off = (size_t)r.m * D;
  auto keep = [&](int c) { return d2.keep(off + c, r.b, 2, r.s, c); };
  auto s2 = [&](int c) { return y32[off + c] + o[off + c] * keep(c); };
  auto dout = [&](int c) { return to_f(dz[off + c]); };
  ln_row_bwd(s2, dout, g, D, [&](int c, float ds, float xhat) {
    const float dov = ds * keep(c);
    ds2[off + c] = ds;
    do16[off + c] = from_f<T>(dov);
    do32[off + c] = dov;
    gz[off + c] = dout(c) * xhat;
  });
}

// du = drop1(dhd) * gelu'(u), in dt and f32.
template <typename T>
__global__ void tail_gelu_bwd(const float* __restrict__ u, const float* __restrict__ dhd,
                              Dropout d1, T* __restrict__ du16, float* __restrict__ du32, int M,
                              int S, int F) {
  const size_t n = (size_t)M * F;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / F), c = (int)(i % F);
    const float du = (dhd[i] * d1.keep(i, m / S, 1, m % S, c)) * mdm::gelu_grad(u[i]);
    du16[i] = from_f<T>(du);
    du32[i] = du;
  }
}

// dx = ds1, da = drop0(ds1) (both dt), and dy * xhat1 for dg1.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
tail_ln1_bwd(const T* __restrict__ x, const T* __restrict__ a, Dropout d0,
             const T* __restrict__ g, const float* __restrict__ dy, T* __restrict__ dx,
             T* __restrict__ da, float* __restrict__ gy, int M, int S, int D) {
  Row r;
  if (!row_of(M, S, r)) return;
  const size_t off = (size_t)r.m * D;
  auto keep = [&](int c) { return d0.keep(off + c, r.b, 0, r.s, c); };
  auto s1 = [&](int c) { return to_f(x[off + c]) + to_f(a[off + c]) * keep(c); };
  auto dout = [&](int c) { return dy[off + c]; };
  ln_row_bwd(s1, dout, g, D, [&](int c, float ds, float xhat) {
    dx[off + c] = from_f<T>(ds);
    da[off + c] = from_f<T>(ds * keep(c));
    gy[off + c] = dy[off + c] * xhat;
  });
}

Dropout make_drop(const void* bits, int seed, unsigned thr, float inv_keep, int mode) {
  return Dropout{static_cast<const uint32_t*>(bits), (uint32_t)seed, thr, inv_keep, mode};
}

unsigned row_blocks(int M) { return (unsigned)((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }
unsigned elem_blocks(size_t n) { return (unsigned)((n + 255) / 256 < 16384 ? (n + 255) / 256 : 16384); }

// Launch the kernel call given after dtype with T = float (dtype 0) or bf16 (1).
#define MDM_TAIL_DISPATCH(dtype, ...)       \
  if ((dtype) == 0) {                       \
    typedef float T;                        \
    __VA_ARGS__;                            \
  } else if ((dtype) == 1) {                \
    typedef bf16 T;                         \
    __VA_ARGS__;                            \
  } else {                                  \
    return (int)cudaErrorInvalidValue;      \
  }                                         \
  return (int)cudaGetLastError();

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, attn, LN parameters and the dt
// outputs); y32, u, o and the gradient scratch are f32. mode: 0 no
// dropout, 1 injected bits (the site's [B, S, n] uint32), 2 Philox on seed.
extern "C" int mdm_tail_ln1_fwd(const void* x, const void* a, const void* bits, int seed,
                                unsigned thr, float inv_keep, int mode, const void* g,
                                const void* beta, void* y, void* y32, int M, int S, int D,
                                int dtype, void* stream) {
  if (M <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_ln1_fwd<T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), d, static_cast<const T*>(g),
      static_cast<const T*>(beta), static_cast<T*>(y), static_cast<float*>(y32), M, S, D))
}

extern "C" int mdm_tail_gelu_dropout(const void* u, const void* bits, int seed, unsigned thr,
                                     float inv_keep, int mode, void* hd, int M, int S, int F,
                                     int dtype, void* stream) {
  if (M <= 0 || S <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_gelu_dropout<T><<<elem_blocks((size_t)M * F), 256, 0, st>>>(
      static_cast<const float*>(u), d, static_cast<T*>(hd), M, S, F))
}

extern "C" int mdm_tail_ln2_fwd(const void* y32, const void* o, const void* bits, int seed,
                                unsigned thr, float inv_keep, int mode, const void* g,
                                const void* beta, void* z, int M, int S, int D, int dtype,
                                void* stream) {
  if (M <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_ln2_fwd<T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      static_cast<const float*>(y32), static_cast<const float*>(o), d, static_cast<const T*>(g),
      static_cast<const T*>(beta), static_cast<T*>(z), M, S, D))
}

extern "C" int mdm_tail_ln2_bwd(const void* y32, const void* o, const void* bits, int seed,
                                unsigned thr, float inv_keep, int mode, const void* g,
                                const void* dz, void* ds2, void* do16, void* do32, void* gz,
                                int M, int S, int D, int dtype, void* stream) {
  if (M <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_ln2_bwd<T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      static_cast<const float*>(y32), static_cast<const float*>(o), d, static_cast<const T*>(g),
      static_cast<const T*>(dz), static_cast<float*>(ds2), static_cast<T*>(do16),
      static_cast<float*>(do32), static_cast<float*>(gz), M, S, D))
}

extern "C" int mdm_tail_gelu_bwd(const void* u, const void* dhd, const void* bits, int seed,
                                 unsigned thr, float inv_keep, int mode, void* du16, void* du32,
                                 int M, int S, int F, int dtype, void* stream) {
  if (M <= 0 || S <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_gelu_bwd<T><<<elem_blocks((size_t)M * F), 256, 0, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(dhd), d, static_cast<T*>(du16),
      static_cast<float*>(du32), M, S, F))
}

extern "C" int mdm_tail_ln1_bwd(const void* x, const void* a, const void* bits, int seed,
                                unsigned thr, float inv_keep, int mode, const void* g,
                                const void* dy, void* dx, void* da, void* gy, int M, int S,
                                int D, int dtype, void* stream) {
  if (M <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dropout d = make_drop(bits, seed, thr, inv_keep, mode);
  MDM_TAIL_DISPATCH(dtype, tail_ln1_bwd<T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), d, static_cast<const T*>(g),
      static_cast<const float*>(dy), static_cast<T*>(dx), static_cast<T*>(da),
      static_cast<float*>(gy), M, S, D))
}
