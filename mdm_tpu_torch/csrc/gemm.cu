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
// The f32 path is 3xTF32 on the tensor cores (gemm_f32_tf32x3 below;
// compute_dtype="float32", every CLI's default, runs it). The weight
// gradients reduce over all M = B*S rows (K
// of the dW product) into few output tiles, so they run split-K: the split
// z owns a fixed K range and writes its f32 partial; sum_splits adds the
// partials in split order. No float atomics anywhere, so every gradient is
// bitwise reproducible (bit-exact resume depends on it). The column sums
// (bias, LayerNorm gradients) are two fixed-order passes too.
//
// Every entry point has a plain C interface (bound with ctypes) and returns
// cudaGetLastError() right after its launches.

#include <cstdint>

#include "common.cuh"

using mdm::bf16;

namespace {

// The float32 path: 3xTF32 on the tensor cores. Bound on an H100: exact
// f32 FMA outside the tensor cores peaks at 67 TFLOP/s; TF32 mma at 495,
// so three passes of it (a third of that) beat it where the operands reach
// the tensor cores fast enough. Each f32 operand x splits as it leaves
// shared memory into hi = tf32(x) (cvt.rna: round to nearest, ties away,
// on the 13 dropped mantissa bits) and lo = tf32(x - hi); a . b ~ alo.bhi
// + ahi.blo + ahi.bhi (alo.blo, 2^-22 of the product, is dropped) on
// mma.sync m16n8k8 .tf32 with f32 accumulation. The tensor cores'
// accumulation truncates (rounds toward zero), so over a long K its bias
// grows past f32's: each 32-deep K tile is summed into zeroed registers
// and added to the f32 accumulator by an ordinary (round to nearest) add,
// which keeps the product at f32 FMA's accuracy (tests/test_torch_gemm.py
// emulates the scheme; chip_smoke.py holds it to the f32 tolerances).
//
// A block of 4 warps owns a 128x64 output tile (each warp 64x32: 4 x 4
// m16n8 tiles) and walks K in 32-deep tiles through a 3-stage cp.async
// ring. Tiles keep their stored layout in shared memory (16-byte copies
// where every stored row is a multiple of 4 floats and 16-byte aligned,
// VEC; 4-byte copies otherwise), padded so that a fragment's 32 scalar
// loads fall on 32 banks: [rows][32 + 4] where K is contiguous, [32][cols +
// 8] where it is not. Any layout, fully ragged: copies past M, N or the
// split's K range zero-fill.
constexpr int TM = 128, TN = 64, TK = 32, TSTAGES = 3, TTHREADS = 128;
constexpr int A_STAGE = TM * (TK + 4);  // floats: [128][36] or [32][136] (4352)
constexpr int B_STAGE = TN * (TK + 4);  // [64][36] or [32][72]: both 2304
constexpr int T_STAGE = A_STAGE + B_STAGE;
constexpr int T_SMEM = TSTAGES * T_STAGE * 4;  // 82944 bytes: two blocks per SM

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major matrix
// (row stride ldg) into a [ROWS][LDS] tile; past rlim rows or clim
// columns zero.
template <int ROWS, int COLS, int LDS, bool VEC>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src, int ldg, int r0,
                                              int rlim, int c0, int clim) {
  if constexpr (VEC) {
    constexpr int CPR = COLS / 4;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < ROWS * CPR / TTHREADS; ++i) {
      const int v = threadIdx.x + i * TTHREADS, r = v / CPR, c = (v % CPR) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rlim ? min(4, clim - gc) : 0;
      mdm::cp_async16(dst + r * LDS + c, n > 0 ? src + (size_t)gr * ldg + gc : src,
                      n > 0 ? 4 * n : 0);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < ROWS * COLS / TTHREADS; ++i) {
      const int v = threadIdx.x + i * TTHREADS, r = v / COLS, c = v % COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rlim && gc < clim;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * LDS + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(ok ? src + (size_t)gr * ldg + gc : src), "r"(ok ? 4 : 0));
    }
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a tf32 value in a 32-bit register.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a . b: one m16n8k8 product, tf32 operands, f32 accumulation.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C[M, N] (or split z's partial) = act(op(A) . op(B) + bias) + R over K
// range [z * kchunk, min(K, (z + 1) * kchunk)). AKM: A stored [K, M];
// BKN: B stored [K, N]; VEC: 16-byte copies (see above); TANH: gelu is
// GELU's tanh form (DiT's MLP) in place of the exact one.
template <bool AKM, bool BKN, bool VEC, bool TANH = false>
__global__ void __launch_bounds__(TTHREADS)
gemm_f32_tf32x3(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ R,
                float* __restrict__ C, int M, int N, int K, int kchunk, bool gelu) {
  constexpr int LDA = AKM ? TM + 8 : TK + 4, LDB = BKN ? TN + 8 : TK + 4;
  extern __shared__ __align__(128) float tsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;  // the warp's 64x32 of the tile
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int ntiles = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;
  C += (size_t)blockIdx.z * M * N;

  auto issue = [&](int kt, int slot) {
    if (kt < ntiles) {
      float* As = tsm + slot * T_STAGE;
      float* Bs = As + A_STAGE;
      const int k0 = kbeg + kt * TK;
      if constexpr (AKM) load_f32_tile<TK, TM, LDA, VEC>(As, A, M, k0, kend, m0, M);
      else load_f32_tile<TM, TK, LDA, VEC>(As, A, K, m0, M, k0, kend);
      if constexpr (BKN) load_f32_tile<TK, TN, LDB, VEC>(Bs, B, N, k0, kend, n0, N);
      else load_f32_tile<TN, TK, LDB, VEC>(Bs, B, K, n0, N, k0, kend);
    }
    mdm::cp_async_commit();
  };
  // op(A)[m][k] and op(B)[k][n] of a stage, m and n within the block's tile.
  auto a_at = [](const float* As, int m, int k) {
    return AKM ? As[k * LDA + m] : As[m * LDA + k];
  };
  auto b_at = [](const float* Bs, int k, int n) {
    return BKN ? Bs[k * LDB + n] : Bs[n * LDB + k];
  };

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) issue(s, s);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

#pragma unroll 1
  for (int kt = 0; kt < ntiles; ++kt) {
    mdm::cp_async_wait<TSTAGES - 2>();  // tile kt has landed (kt + 1 may be in flight)
    __syncthreads();                    // ... for every thread; all are past tile kt - 1
    issue(kt + TSTAGES - 1, (kt + TSTAGES - 1) % TSTAGES);
    const float* As = tsm + (kt % TSTAGES) * T_STAGE;
    const float* Bs = As + A_STAGE;
    float part[4][4][4];  // this K tile's sum, from zero
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        split_tf32(b_at(Bs, kk + t, n), bh[j][0], bl[j][0]);
        split_tf32(b_at(Bs, kk + t + 4, n), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(a_at(As, m, kk + t), ah[0], al[0]);
        split_tf32(a_at(As, m + 8, kk + t), ah[1], al[1]);
        split_tf32(a_at(As, m, kk + t + 4), ah[2], al[2]);
        split_tf32(a_at(As, m + 8, kk + t + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // the small terms first, then hi . hi
          mma1688(part[i][j], al, bh[j][0], bh[j][1]);
          mma1688(part[i][j], ah, bl[j][0], bl[j][1]);
          mma1688(part[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  mdm::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int gr = m0 + wm + i * 16 + g + 8 * e2;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int gc = n0 + wn + j * 8 + 2 * t + e1;
          if (gc < N) {
            float v = acc[i][j][2 * e2 + e1];
            if (bias) v += bias[gc];
            if (gelu) v = TANH ? mdm::gelu_tanh(v) : mdm::gelu_exact(v);
            if (R) v += R[(size_t)gr * N + gc];
            C[(size_t)gr * N + gc] = v;
          }
        }
    }
}

template <bool AKM, bool BKN, bool VEC, bool TANH = false>
cudaError_t launch_tf32x3(dim3 grid, cudaStream_t st, const float* A, const float* B,
                          const float* bias, const float* R, float* C, int M, int N, int K,
                          int kchunk, bool gelu) {
  static bool done = false;  // more than 48 KB of shared memory: opt in once
  if (!done) {
    const cudaError_t e = mdm::allow_smem(gemm_f32_tf32x3<AKM, BKN, VEC, TANH>, T_SMEM);
    if (e != cudaSuccess) return e;
    done = true;
  }
  gemm_f32_tf32x3<AKM, BKN, VEC, TANH><<<grid, TTHREADS, T_SMEM, st>>>(A, B, bias, R, C, M, N, K,
                                                                 kchunk, gelu);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_layout(bool a_km, bool b_kn, dim3 grid, cudaStream_t st, const float* A,
                          const float* B, const float* bias, const float* R, float* C, int M,
                          int N, int K, int kchunk, int gelu) {
  if (!a_km && !b_kn && gelu == 2)
    return launch_tf32x3<false, false, VEC, true>(grid, st, A, B, bias, R, C, M, N, K, kchunk, true);
  if (!a_km && !b_kn)
    return launch_tf32x3<false, false, VEC>(grid, st, A, B, bias, R, C, M, N, K, kchunk, gelu);
  if (!a_km && b_kn)
    return launch_tf32x3<false, true, VEC>(grid, st, A, B, bias, R, C, M, N, K, kchunk, gelu);
  if (a_km && b_kn)
    return launch_tf32x3<true, true, VEC>(grid, st, A, B, bias, R, C, M, N, K, kchunk, gelu);
  return launch_tf32x3<true, false, VEC>(grid, st, A, B, bias, R, C, M, N, K, kchunk, gelu);
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
// gelu: 1 the exact GELU after the bias, 2 its tanh form (A [M, K] and B [N, K]
// only). splits > 1: split-K over `work` (f32
// [splits, M, N]) in chunks of whole 32-row steps; then bias and R null and
// gelu 0.
extern "C" int mdm_gemm_f32(const void* a, const void* b, const void* bias, const void* r,
                            void* c, void* work, int M, int N, int K, int a_km, int b_kn,
                            int splits, int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || gelu < 0 || gelu > 2 ||
      (gelu == 2 && (a_km || b_kn)))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (bias || r || gelu || !work)) return (int)cudaErrorInvalidValue;
  const int kchunk = splits > 1 ? ((K + splits - 1) / splits + 31) / 32 * 32 : K;
  const float *A = static_cast<const float*>(a), *B = static_cast<const float*>(b);
  const float *bs = static_cast<const float*>(bias), *rr = static_cast<const float*>(r);
  float* C = static_cast<float*>(splits > 1 ? work : c);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  // 16-byte copies where every stored row is a multiple of 4 floats and
  // both operands start 16-byte aligned.
  const bool vec = (a_km ? M : K) % 4 == 0 && (b_kn ? N : K) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const cudaError_t e = vec ? launch_layout<true>(a_km, b_kn, grid, st, A, B, bs, rr, C, M, N, K,
                                                  kchunk, gelu)
                            : launch_layout<false>(a_km, b_kn, grid, st, A, B, bs, rr, C, M, N, K,
                                                   kchunk, gelu);
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
