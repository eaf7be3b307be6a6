// The forward product form of every kernel chain on Hopper's own path:
//
//   C[M,N] = act(A[M,K] . B[N,K]^T + bias[N]),  act: identity or exact GELU
//
// A (activations) and B (a torch weight) bf16 and K-major, f32 accumulation,
// C bf16 or f32. It is the x . W^T product of the sampling layer
// (ops/layer_inference.py), the train attention block's and #12's forward
// (ops/attention_train_block.py, ops/attention_block.py) and the encoder
// tail's forward (ops/encoder_tail.py). With the attention core and the row
// kernels it replaces the products in the bodies of the TPU kernels
// mdm_tpu/ops/layer_inference.py::_layer_kernel,
// mdm_tpu/ops/attention_train_block.py::_fwd_kernel,
// mdm_tpu/ops/attention_block.py::_fused_block and
// mdm_tpu/ops/encoder_tail.py::_fwd_kernel, which run on the MXU with f32
// accumulation. The backward's product forms (dY . W, dY^T . X split-K) stay
// on gemm.cu's WMMA kernel.
//
// Bound on an H100: at the flagship shapes (M = 12608 or 25216 rows, N =
// 512-1536, K = 512 or 1024) every product does 130-400 FLOPs per byte it
// must move, above the card's ~295: tensor-core throughput. The only way to
// the full rate is wgmma, fed from shared memory by TMA:
//
// - A block owns 128x128 output tiles and walks them persistently (grid =
//   min(tiles, SMs), tile = blockIdx.x + i * gridDim.x, N tiles fastest so
//   that neighbouring blocks share A's rows in L2). At M = 12608 the 99 row
//   tiles times N / 128 make 3, 6 or 9 whole waves on 132 SMs.
// - One producer warp (of a third warpgroup that gives its registers back
//   with setmaxnreg) issues TMA copies of 128x64 bf16 tiles of A and B into
//   a ring of 4-5 stages with the 128-byte swizzle, behind full/empty
//   mbarriers; ragged M, N and K are the TMA's zero fill, never padding.
// - Two consumer warpgroups run wgmma.mma_async m64n128k16 on their 64 rows
//   of the tile, one commit group per K tile with one group in flight, and
//   release each stage as soon as its products are done. K is only 8-16
//   tiles deep, so the producer runs on into the next tile's stages while
//   the consumers run the epilogue.
// - Epilogue from the accumulator registers: bias and GELU in f32, rounding
//   to C's type, a 128-byte-swizzled staging tile per warpgroup (bank
//   conflict free for bf16), and TMA stores that clip the ragged edge.
//
// Deterministic: every output's K sum runs in one fixed order inside one
// block; no split-K, no atomics. Two runs are bitwise equal.
//
// The tensor maps are encoded on the host through cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint so that the library links against
// the runtime alone. Every entry point has a plain C interface (bound with
// ctypes) and returns cudaGetLastError() right after its launch.

#include <cuda.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

using mdm::bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK * 2 bytes = one 128-byte swizzle row
constexpr int THREADS = 384;                // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TILE_BYTES = BM * BK * 2;     // one stage of A or of B (BM == BN)
constexpr int BOX_BYTES = 64 * 128;         // one TMA store box: 64 rows of 128 bytes
static_assert(BM == BN, "A's and B's stage tiles share one size");

template <typename TO>
struct Plan {
  static constexpr int STAGES = sizeof(TO) == 2 ? 5 : 4;
  static constexpr int BOX_N = 128 / sizeof(TO);        // output columns in a store box
  static constexpr int HALF = 64 * BN * sizeof(TO);     // one warpgroup's staging tile
  static constexpr int A0 = 0;
  static constexpr int B0 = STAGES * TILE_BYTES;
  static constexpr int C0 = 2 * STAGES * TILE_BYTES;
  static constexpr int BAR = C0 + 2 * HALF;              // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of 2^34
// clocks (~10 s) traps: a broken pipeline fails its launch, never hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence, commit and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MDM_ACC8(i)                                                                           \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x16] . B[128x16]^T; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : MDM_ACC8(0), MDM_ACC8(8), MDM_ACC8(16), MDM_ACC8(24), MDM_ACC8(32), MDM_ACC8(40),
        MDM_ACC8(48), MDM_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MDM_ACC8

// Where the pair (row r, columns col, col + 1) of a warpgroup's 64 x 128
// tile lies in its staging tile: 128-byte store boxes of 64 rows, each
// 16-byte chunk at (chunk ^ row % 8), as the TMA's 128-byte swizzle reads.
template <typename TO>
__device__ __forceinline__ uint32_t staging_offset(int r, int col) {
  constexpr int PER = 16 / sizeof(TO);  // elements per 16-byte chunk
  const int box = col / Plan<TO>::BOX_N, cc = col % Plan<TO>::BOX_N;
  return box * BOX_BYTES + r * 128 + (((cc / PER) ^ (r & 7)) << 4) + (cc % PER) * sizeof(TO);
}

__device__ __forceinline__ void store_pair(unsigned char* p, float v0, float v1, bf16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(unsigned char* p, float v0, float v1, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <typename TO, bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                const __grid_constant__ CUtensorMap tma_c, const bf16* __restrict__ bias, int M,
                int N, int K) {
  using P = Plan<TO>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's address pattern needs 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + P::BAR, empty0 = full0 + 8 * P::STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx; the TMA's bytes complete it
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, 2 * TILE_BYTES);
          tma_load(base + P::A0 + stage * TILE_BYTES, &tma_a, kt * BK, m0, full0 + 8 * stage);
          tma_load(base + P::B0 + stage * TILE_BYTES, &tma_b, kt * BK, n0, full0 + 8 * stage);
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const int warp = t / 32, lane = t % 32;
    const int row = warp * 16 + lane / 4, q = lane % 4;  // the accumulator fragment's layout
    const uint32_t staging = P::C0 + wg * P::HALF;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint64_t da = smem_desc(base + P::A0 + stage * TILE_BYTES + wg * (TILE_BYTES / 2));
        const uint64_t db = smem_desc(base + P::B0 + stage * TILE_BYTES);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 deep = 32 bytes = 2 descriptor units
          wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(acc);
        if (kt > 0) {  // the previous K tile's products are done: release its stage
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // Epilogue. The staging tile is free once the last tile's stores read it.
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_sync(1 + wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * q;
        float b0 = 0.0f, b1 = 0.0f;
        if (bias != nullptr && n0 + col < N) {  // N % 8 == 0: col + 1 < N too
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v0 = acc[4 * j + 2 * i] + b0, v1 = acc[4 * j + 2 * i + 1] + b1;
          if (GELU) {
            v0 = mdm::gelu_exact(v0);
            v1 = mdm::gelu_exact(v1);
          }
          store_pair(smem + staging + staging_offset<TO>(row + 8 * i, col), v0, v1,
                     static_cast<TO*>(nullptr));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + wg);
      if (t == 0) {
#pragma unroll
        for (int b = 0; b < BN / P::BOX_N; ++b)
          tma_store(&tma_c, base + staging + b * BOX_BYTES, n0 + b * P::BOX_N, m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [outer, inner] tensor with rows of row_bytes, cut into boxes
// of [box_outer, box_inner] with the 128-byte swizzle; reads past its edge
// are zeros, writes past it are dropped.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int inner, int outer,
            size_t row_bytes, int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elems[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elems,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO, bool GELU>
cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t e = mdm::allow_smem(gemm_bf16_wgmma<TO, GELU>, Plan<TO>::BYTES);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

template <typename TO, bool GELU>
cudaError_t launch(const void* a, const void* b, const void* bias, void* c, int M, int N, int K,
                   int grid, cudaStream_t st) {
  const bool f32 = std::is_same<TO, float>::value;
  CUtensorMap ta, tb, tc;
  if (!encode(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M, (size_t)K * 2, BK, BM) ||
      !encode(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, K, N, (size_t)K * 2, BK, BN) ||
      !encode(&tc, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c, N,
              M, (size_t)N * sizeof(TO), Plan<TO>::BOX_N, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = configure<TO, GELU>();
  if (e != cudaSuccess) return e;
  gemm_bf16_wgmma<TO, GELU><<<grid, THREADS, Plan<TO>::BYTES, st>>>(
      ta, tb, tc, static_cast<const bf16*>(bias), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C = act(A . B^T + bias): A [M, K], B [N, K] and bias [N] (or null) bf16,
// C [M, N] f32 when out_f32, else bf16; gelu: the exact GELU after the bias.
// grid: the persistent blocks (ops/_chain.py::wgmma_plan). The caller
// guarantees contiguous operands with 16-byte aligned bases; K and N must be
// multiples of 8 (the TMA's 16-byte row strides).
extern "C" int mdm_gemm_wgmma(const void* a, const void* b, const void* bias, void* c, int M,
                              int N, int K, int out_f32, int gelu, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || grid <= 0) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return (int)(gelu ? launch<float, true>(a, b, bias, c, M, N, K, grid, st)
                      : launch<float, false>(a, b, bias, c, M, N, K, grid, st));
  return (int)(gelu ? launch<bf16, true>(a, b, bias, c, M, N, K, grid, st)
                    : launch<bf16, false>(a, b, bias, c, M, N, K, grid, st));
}

// Resident blocks per SM of the instance storing f32 (out_f32) or bf16,
// with or without GELU: cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int mdm_gemm_wgmma_occupancy(int out_f32, int gelu, int* blocks) {
  cudaError_t e;
  if (out_f32) {
    e = gelu ? configure<float, true>() : configure<float, false>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gelu ? gemm_bf16_wgmma<float, true> : gemm_bf16_wgmma<float, false>, THREADS,
          Plan<float>::BYTES);
  } else {
    e = gelu ? configure<bf16, true>() : configure<bf16, false>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gelu ? gemm_bf16_wgmma<bf16, true> : gemm_bf16_wgmma<bf16, false>, THREADS,
          Plan<bf16>::BYTES);
  }
  return (int)e;
}
