// The matrix products of the kernel chains that gemm_sm90.cu does not take
// (the backward's dY . W and dY^T . X forms in bf16, and every float32
// product), and the column sums of the training chains: the sampling layer
// (ops/layer_inference.py), the train attention block
// (ops/attention_train_block.py) and the encoder tail (ops/encoder_tail.py).
// ops/_chain.py::gemm_kernel holds the rule. Together with the attention and row kernels they
// replace the bodies of the TPU kernels
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
// The bf16 path runs WMMA 16x16x16 tensor-core fragments with f32
// accumulators on cp.async double-buffered 128x64x32 tiles (zero-filled
// scalar loads where a row is not 16-byte aligned); the f32 path is plain
// FMA. Bounds on an H100: the training step's products carry ~90% of its
// FLOPs, so the chain is bound by tensor-core throughput.
//
// The weight gradients reduce over all M = B*S rows (K of the dW product)
// into only 32-96 output tiles, too few for 132 SMs. They run split-K: the
// split z owns a fixed K range and writes its f32 partial; a second pass
// sums the partials in split order. No float atomics anywhere, so every
// gradient is bitwise reproducible (bit-exact resume depends on it). The
// column sums (bias, LayerNorm gradients) are two fixed-order passes too.
//
// Every entry point has a plain C interface (bound with ctypes) and returns
// cudaGetLastError() right after its launches.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
using mdm::bf16;

namespace {

constexpr int GM = 128, GN = 64, GK = 32, G_THREADS = 256;
constexpr int G_LDC = GN + 4;

template <bool AKM, bool BKN>
struct GemmSmem {
  static constexpr int A_ROWS = AKM ? GK : GM, A_COLS = AKM ? GM : GK;
  static constexpr int B_ROWS = BKN ? GK : GN, B_COLS = BKN ? GN : GK;
  static constexpr int A_LD = A_COLS + 8, B_LD = B_COLS + 8;  // 32-byte fragment alignment
  static constexpr int A_TILE = A_ROWS * A_LD, B_TILE = B_ROWS * B_LD;
  static constexpr int AB = 2 * (A_TILE + B_TILE) * 2;
  static constexpr int CS = GM * G_LDC * 4;
  static constexpr int BYTES = AB > CS ? AB : CS;
};

// Copy the tile [ROWS][COLS] at (r0, c0) of a row-major source with row
// stride ld into shared memory with row stride LD. Elements at or past
// (rmax, cmax) are zero. vec: 16-byte cp.async (the caller guarantees that
// cmax, ld and c0 are multiples of 8 and the base is 16-byte aligned).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld, int r0, int c0,
                                          int rmax, int cmax, bool vec) {
  if (vec) {
    constexpr int VPR = COLS / 8;
    static_assert(ROWS * VPR % G_THREADS == 0, "every thread copies whole vectors");
    // A fixed trip count, unrolled, so that each thread's offsets stay in
    // registers across the K loop; a strided loop recomputes them at every
    // K step, and the products spend much of their time there.
#pragma unroll
    for (int i = 0; i < ROWS * VPR / G_THREADS; ++i) {
      const int v = threadIdx.x + i * G_THREADS;
      const int r = v / VPR, c = (v % VPR) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rmax && gc < cmax;
      mdm::cp_async16(dst + r * LD + c, ok ? src + (size_t)gr * ld + gc : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += G_THREADS) {
      const int r = e / COLS, c = e % COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * LD + c] = (gr < rmax && gc < cmax) ? src[(size_t)gr * ld + gc]
                                                 : __float2bfloat16_rn(0.0f);
    }
  }
}

// One 128x64 output tile of split blockIdx.z (K range [z*kchunk, +kchunk)).
// 8 warps in a 4x2 grid, each 32x32 = 2x2 fragments.
template <typename TO, bool AKM, bool BKN>
__global__ void __launch_bounds__(G_THREADS)
gemm_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const bf16* __restrict__ bias, const float* __restrict__ R,
               TO* __restrict__ C, int M, int N, int K, int kchunk, bool gelu, bool vec_a,
               bool vec_b) {
  using L = GemmSmem<AKM, BKN>;
  __shared__ __align__(128) unsigned char smem[L::BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * L::A_TILE;
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  C += (size_t)blockIdx.z * M * N;  // split partials (gridDim.z == 1: no offset)

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * L::A_TILE;
    bf16* bs = Bs + stage * L::B_TILE;
    if (AKM) load_tile<GK, GM, L::A_LD>(as, A, M, k0, m0, kend, M, vec_a);
    else load_tile<GM, GK, L::A_LD>(as, A, K, m0, k0, M, kend, vec_a);
    if (BKN) load_tile<GK, GN, L::B_LD>(bs, B, N, k0, n0, kend, N, vec_b);
    else load_tile<GN, GK, L::B_LD>(bs, B, K, n0, k0, N, kend, vec_b);
  };

  using LayA = typename std::conditional<AKM, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<BKN, wmma::row_major, wmma::col_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = kend > kbeg ? (kend - kbeg + GK - 1) / GK : 0;
  if (nk > 0) load_stage(0, kbeg);
  mdm::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, kbeg + (kt + 1) * GK);
    mdm::cp_async_commit();
    mdm::cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As + (kt & 1) * L::A_TILE;
    const bf16* bs = Bs + (kt & 1) * L::B_TILE;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16;
        wmma::load_matrix_sync(fa[i], AKM ? as + kk * L::A_LD + m : as + m * L::A_LD + kk,
                               L::A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], BKN ? bs + kk * L::B_LD + n : bs + n * L::B_LD + kk,
                               L::B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  mdm::cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * G_LDC + wn * 32 + j * 16, acc[i][j],
                              G_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < GM * GN; idx += G_THREADS) {
    const int r = idx / GN, c = idx % GN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = Cs[r * G_LDC + c];
      if (bias) v += mdm::to_f(bias[gc]);
      if (gelu) v = mdm::gelu_exact(v);
      if (R) v += R[(size_t)gr * N + gc];
      C[(size_t)gr * N + gc] = mdm::from_f<TO>(v);
    }
  }
}

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

// out[i] = sum over splits z, in order, of work[z][i].
__global__ void sum_splits(const float* __restrict__ work, float* __restrict__ out,
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

template <typename TO, bool AKM, bool BKN>
void launch_bf16(const void* a, const void* b, const void* bias, const float* r, void* c,
                 int M, int N, int K, int kchunk, int splits, bool gelu, cudaStream_t st) {
  dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, splits);
  // 16-byte vectors need the stored rows' contiguous extent to be a multiple of 8.
  const bool vec_a = (AKM ? M : K) % 8 == 0 && (kchunk % 8 == 0 || AKM);
  const bool vec_b = (BKN ? N : K) % 8 == 0 && (kchunk % 8 == 0 || BKN);
  gemm_bf16_wmma<TO, AKM, BKN><<<grid, G_THREADS, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(bias), r, static_cast<TO*>(c), M, N, K, kchunk, gelu, vec_a,
      vec_b);
}

// The bf16 x . W^T form (a_km = b_kn = 0) is gemm_sm90.cu's: refused here.
template <typename TO>
cudaError_t dispatch_bf16(int a_km, int b_kn, const void* a, const void* b, const void* bias,
                          const float* r, void* c, int M, int N, int K, int kchunk, int splits,
                          bool gelu, cudaStream_t st) {
  if (!a_km && !b_kn) return cudaErrorInvalidValue;
  if (!a_km) launch_bf16<TO, false, true>(a, b, bias, r, c, M, N, K, kchunk, splits, gelu, st);
  else if (b_kn) launch_bf16<TO, true, true>(a, b, bias, r, c, M, N, K, kchunk, splits, gelu, st);
  else launch_bf16<TO, true, false>(a, b, bias, r, c, M, N, K, kchunk, splits, gelu, st);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B, bias; R is always f32; in bf16
// the a_km = b_kn = 0 form is refused: mdm_gemm_wgmma runs it). out_f32:
// C is f32, otherwise dtype. gelu: the exact GELU after the bias. splits >
// 1: split-K over `work` (f32 [splits, M, N]); then C must be f32, bias and
// R null and gelu 0.
extern "C" int mdm_gemm(const void* a, const void* b, const void* bias, const void* r, void* c,
                        void* work, int M, int N, int K, int a_km, int b_kn, int dtype,
                        int out_f32, int splits, int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (!out_f32 || bias || r || gelu || !work)) return (int)cudaErrorInvalidValue;
  const int kchunk = splits > 1 ? ((K + splits - 1) / splits + GK - 1) / GK * GK : K;
  void* dst = splits > 1 ? work : c;
  const float* rr = static_cast<const float*>(r);
  if (dtype == 1) {
    const cudaError_t e =
        out_f32 ? dispatch_bf16<float>(a_km, b_kn, a, b, bias, rr, dst, M, N, K, kchunk, splits, gelu, st)
                : dispatch_bf16<bf16>(a_km, b_kn, a, b, bias, rr, dst, M, N, K, kchunk, splits, gelu, st);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == 0) {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM, splits);
    const float *A = static_cast<const float*>(a), *B = static_cast<const float*>(b);
    const float* bs = static_cast<const float*>(bias);
    float* C = static_cast<float*>(dst);
    if (!a_km && !b_kn) gemm_f32_fma<false, false><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
    else if (!a_km && b_kn) gemm_f32_fma<false, true><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
    else if (a_km && b_kn) gemm_f32_fma<true, true><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
    else gemm_f32_fma<true, false><<<grid, 256, 0, st>>>(A, B, bs, rr, C, M, N, K, kchunk, gelu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t n = (size_t)M * N;
    sum_splits<<<(unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
        static_cast<const float*>(work), static_cast<float*>(c), n, splits);
  }
  return (int)cudaGetLastError();
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
  sum_splits<<<(N + 255) / 256, 256, 0, st>>>(w, static_cast<float*>(out), (size_t)N, chunks);
  return (int)cudaGetLastError();
}
