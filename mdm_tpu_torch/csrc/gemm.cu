// The float32 matrix products of the kernel chains (every bf16 product is
// gemm_sm90.cu's wgmma kernel), the split-K partials' sum of both (also the
// encoder tail's column partials), and the train attention block's column
// sums: the products of the sampling layer (ops/layer_inference.py), the
// train attention block (ops/attention_train_block.py) and the encoder tail
// (ops/encoder_tail.py).
// ops/_chain.py::gemm_kernel holds the rule. Together with the attention and
// row kernels they replace the bodies of the TPU kernels
// mdm_tpu/ops/layer_inference.py::_layer_kernel,
// mdm_tpu/ops/attention_train_block.py::_fwd_kernel/_bwd_kernel and
// mdm_tpu/ops/encoder_tail.py::_fwd_kernel/_bwd_kernel, whose products run
// on the MXU with f32 accumulation.
//
//   C[M,N] = act(op(A) . op(B) (+ bias[N])) (+ R[M,N]),  act: identity or GELU
//   op(A): A stored [M,K] (a_km = 0) or [K,M] (a_km = 1, the dW = dY^T X form)
//   op(B): B stored [N,K] (b_kn = 0, a torch weight: x W^T) or [K,N] (b_kn = 1,
//          the backward's dY W form)
//
// The f32 path is plain FMA (compute_dtype="float32" runs it; its speed is
// not on a main path). The weight gradients reduce over all M = B*S rows (K
// of the dW product) into few output tiles, so they run split-K: the split
// z owns a fixed K range and writes its f32 partial; sum_splits adds the
// partials in split order. No float atomics anywhere, so every gradient is
// bitwise reproducible (bit-exact resume depends on it). The column sums
// (bias, LayerNorm gradients) are two fixed-order passes too.
//
// Every entry point has a plain C interface (bound with ctypes) and returns
// cudaGetLastError() right after its launches.

#include "common.cuh"

using mdm::bf16;

namespace {

// The float32 path: plain FMA, 64x64x16 tiles, 256 threads with a 4x4
// register block each, any layout, fully ragged.
constexpr int FM = 64, FN = 64, FK = 16;

template <bool AKM, bool BKN>
__global__ void __launch_bounds__(256)
gemm_f32_fma(const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ bias, const float* __restrict__ R,
             float* __restrict__ C, int M, int N, int K, int kchunk, bool gelu) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  C += (size_t)blockIdx.z * M * N;
  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * 256;
      // (r, c) with the stored layout's contiguous index fastest
      const int kk = AKM ? v / FM : v % FK, mm = AKM ? v % FM : v / FK;
      const int gk = k0 + kk, gm = m0 + mm;
      As[kk][mm] = (gm < M && gk < kend) ? (AKM ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk])
                                         : 0.0f;
      const int kb = BKN ? v / FN : v % FK, nn = BKN ? v % FN : v / FK;
      const int gkb = k0 + kb, gn = n0 + nn;
      Bs[kb][nn] = (gn < N && gkb < kend) ? (BKN ? B[(size_t)gkb * N + gn] : B[(size_t)gn * K + gkb])
                                          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx * 4 + j;
      if (gc < N) {
        float v = acc[i][j];
        if (bias) v += bias[gc];
        if (gelu) v = mdm::gelu_exact(v);
        if (R) v += R[(size_t)gr * N + gc];
        C[(size_t)gr * N + gc] = v;
      }
    }
  }
}

// Above GROUPED_SPLITS splits (the encoder tail's column partials: one per
// 32 rows) one thread per column would walk hundreds of splits alone on a
// few SMs, so a block of 32 x 32 threads takes 32 columns: thread row y sums
// its run of consecutive splits in order, then row 0 adds the 32 runs in
// order. Fixed by the split count alone: every run sums in the same order.
constexpr int GROUPED_SPLITS = 64;

__global__ void __launch_bounds__(1024)
sum_splits_grouped(const float* __restrict__ work, float* __restrict__ out, size_t n, int splits) {
  __shared__ float runs[32][33];
  const size_t i = blockIdx.x * (size_t)32 + threadIdx.x;
  const int per = (splits + 31) / 32, z0 = threadIdx.y * per, z1 = min(splits, z0 + per);
  float s = 0.0f;
  if (i < n)
    for (int z = z0; z < z1; ++z) s += work[z * n + i];
  runs[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.0f;
#pragma unroll
    for (int y = 0; y < 32; ++y) t += runs[y][threadIdx.x];
    out[i] = t;
  }
}

// out[i] = sum over splits z, in order, of work[z][i].
__global__ void sum_splits_kernel(const float* __restrict__ work, float* __restrict__ out,
                                  size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += work[z * n + i];
    out[i] = s;
  }
}

// Column sums in two fixed-order passes: chunk p of the rows -> work[p][n],
// then out[n] = sum over p in order.
constexpr int CS_THREADS = 128;

template <typename T>
__global__ void colsum_chunks(const T* __restrict__ in, float* __restrict__ work, int M,
                              int N, int rows_per_chunk) {
  const int n = blockIdx.x * CS_THREADS + threadIdx.x;
  const int p = blockIdx.y;
  if (n >= N) return;
  const int r1 = min(M, (p + 1) * rows_per_chunk);
  float s = 0.0f;
  for (int r = p * rows_per_chunk; r < r1; ++r) s += mdm::to_f(in[(size_t)r * N + n]);
  work[(size_t)p * N + n] = s;
}

}  // namespace

namespace mdm {

cudaError_t sum_splits(const float* work, float* out, size_t n, int splits, cudaStream_t st) {
  if (splits > GROUPED_SPLITS) {
    sum_splits_grouped<<<(unsigned)((n + 31) / 32), dim3(32, 32), 0, st>>>(work, out, n, splits);
    return cudaGetLastError();
  }
  sum_splits_kernel<<<(unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      work, out, n, splits);
  return cudaGetLastError();
}

}  // namespace mdm

// Float32 A, B, bias, R and C (the bf16 products are mdm_gemm_wgmma's).
// gelu: the exact GELU after the bias. splits > 1: split-K over `work` (f32
// [splits, M, N]) in chunks of whole 32-row steps; then bias and R null and
// gelu 0.
extern "C" int mdm_gemm_f32(const void* a, const void* b, const void* bias, const void* r,
                            void* c, void* work, int M, int N, int K, int a_km, int b_kn,
                            int splits, int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (bias || r || gelu || !work)) return (int)cudaErrorInvalidValue;
  const int kchunk = splits > 1 ? ((K + splits - 1) / splits + 31) / 32 * 32 : K;
  const float *A = static_cast<const float*>(a), *B = static_cast<const float*>(b);
  const float *bs = static_cast<const float*>(bias), *rr = static_cast<const float*>(r);
  float* C = static_cast<float*>(splits > 1 ? work : c);
  dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM, splits);
  if (!a_km && !b_kn) gemm_f32_fma<false, false><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
  else if (!a_km && b_kn) gemm_f32_fma<false, true><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
  else if (a_km && b_kn) gemm_f32_fma<true, true><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
  else gemm_f32_fma<true, false><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)mdm::sum_splits(static_cast<const float*>(work), static_cast<float*>(c),
                              (size_t)M * N, splits, st);
}

// out[n] = sum over rows of in[:, n] (f32), in a fixed order: `chunks`
// row chunks into work [chunks, N], then their sum in chunk order.
extern "C" int mdm_colsum(const void* in, void* out, void* work, int M, int N, int chunks,
                          int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  const int rows = (M + chunks - 1) / chunks;
  dim3 grid((N + CS_THREADS - 1) / CS_THREADS, chunks);
  float* w = static_cast<float*>(work);
  if (in_dtype == 0)
    colsum_chunks<float><<<grid, CS_THREADS, 0, st>>>(static_cast<const float*>(in), w, M, N, rows);
  else if (in_dtype == 1)
    colsum_chunks<bf16><<<grid, CS_THREADS, 0, st>>>(static_cast<const bf16*>(in), w, M, N, rows);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)mdm::sum_splits(w, static_cast<float*>(out), (size_t)N, chunks, st);
}
