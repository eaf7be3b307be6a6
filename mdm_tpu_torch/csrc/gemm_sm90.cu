// Every bf16 matrix product of the kernel chains on Hopper's own path:
//
//   C[M,N] = act(op(A) . op(B) (+ bias[N])) (+ R[M,N]),  act: identity, exact GELU or
//                                                          GELU's tanh form (DiT's MLP)
//   op(A): A stored [M,K] (K-major), or [K,M] (TA, M-major: the dW = dY^T X form)
//   op(B): B stored [N,K] (K-major, a torch weight: x W^T), or [K,N] (TB,
//          N-major: the backward's dY W and dY^T X forms)
//
// bf16 operands, f32 accumulation, C bf16 or f32, R f32 (dY . W only). The
// forms taken:
// x . W^T (the forward of the sampling layer, ops/layer_inference.py, the
// train attention block and #12, ops/attention_train_block.py and
// ops/attention_block.py, and the encoder tail, ops/encoder_tail.py), dY . W
// (TB: the backwards' input gradients, the tail's with its f32 residual) and
// dY^T . X (TA and TB: the weight gradients, split-K). With the attention
// core and the row kernels it replaces the products in the bodies of the
// TPU kernels mdm_tpu/ops/layer_inference.py::_layer_kernel,
// mdm_tpu/ops/attention_train_block.py::_fwd_kernel and ::_bwd_kernel,
// mdm_tpu/ops/attention_block.py::_fused_block and
// mdm_tpu/ops/encoder_tail.py::_fwd_kernel and ::_bwd_kernel, which run on
// the MXU with f32 accumulation.
//
// Bound on an H100: at the flagship shapes (M = 12608 or 25216 rows, N =
// 512-1536, K = 512 or 1024; the weight gradients reduce K = 25216 rows into
// [512-1536, 512-1024]) every product does 130-400 FLOPs per byte it must
// move, above the card's ~295: tensor-core throughput. The only way to the
// full rate is wgmma, fed from shared memory by TMA:
//
// - A block owns 128x128 output tiles and walks (tile, split) items
//   persistently (grid = min(items, SMs), item = blockIdx.x + i * gridDim.x,
//   N tiles fastest so that neighbouring blocks share A's rows in L2, the
//   split slowest). At M = 12608 the 99 row tiles times N / 128 make 3, 6 or
//   9 whole waves on 132 SMs.
// - One producer warp (of a third warpgroup that gives its registers back
//   with setmaxnreg) issues TMA copies into a ring of 4-5 stages with the
//   128-byte swizzle, behind full/empty mbarriers; ragged M, N and K are the
//   TMA's zero fill, never padding. A stage holds 128 x 64 of A and of B, 16
//   KB each: a K-major operand as one box of 128 rows of 64 K (128 bytes), an
//   MN-major one as two boxes of 64 K rows of 64 M or N (128 bytes), the
//   second 8 KB on; a box wholly past M or N is not fetched (it feeds only
//   outputs the store clips).
// - Two consumer warpgroups run wgmma.mma_async m64n128k16 on their 64 rows
//   of the tile, one commit group per K tile with one group in flight, and
//   release each stage as soon as its products are done. An MN-major
//   operand sets wgmma's transpose bit; its descriptor steps K by 16 rows
//   (2048 bytes) where a K-major one steps 32 bytes, and its leading offset
//   is the 8 KB to the next 64-wide box (B's columns 64-127). K is 8-16
//   tiles deep per item, so the producer runs on into the next item's stages
//   while the consumers run the epilogue.
// - Epilogue from the accumulator registers: bias, then GELU (x . W^T) or
//   the f32 residual (dY . W) in instances of their own, in f32, rounding
//   to C's type, a 128-byte-swizzled staging tile per warpgroup (bank
//   conflict free for bf16), and TMA stores that clip the ragged edge.
// - Split-K (the weight gradients: 16-48 output tiles for 132 SMs): split z
//   owns the K rows [z kchunk, (z + 1) kchunk), kchunk a whole number of K
//   tiles, and stores its f32 partial into work[z]; sum_splits (gemm.cu)
//   then adds the partials in split order.
//
// Deterministic: every output's K sum runs in one fixed order inside one
// block, the partials in split order; no atomics. Two runs are bitwise
// equal.
//
// The tensor maps are encoded on the host through cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint so that the library links against
// the runtime alone. Every entry point has a plain C interface (bound with
// ctypes) and returns cudaGetLastError() right after its launches.

#include <cuda.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

using mdm::bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK * 2 bytes = one 128-byte swizzle row
constexpr int THREADS = 384;                // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TILE_BYTES = BM * BK * 2;     // one stage of A or of B (BM == BN)
constexpr int HALF_TILE = TILE_BYTES / 2;   // a warpgroup's 64 rows; an MN-major box
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

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma's shared-memory descriptor of a tile with the 128-byte swizzle, 1024-
// byte aligned, its 8-row groups 1024 bytes apart (SBO). K-major: rows of 64
// K values, the leading offset unused (1). MN-major: rows of 64 M or N values
// along K, the next 64 M or N values one 8 KB box on (LBO).
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t lbo = MN_MAJOR ? HALF_TILE >> 4 : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) | (64ull << 32) | (1ull << 62);
}

// A descriptor's step to the next 16 K values, in its 16-byte units: 32
// bytes along a K-major row, 16 rows of 128 bytes of an MN-major tile.
template <bool MN_MAJOR>
__host__ __device__ constexpr uint64_t k16_step() { return MN_MAJOR ? 16 * 128 / 16 : 2; }

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence, commit and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MDM_ACC8(i)                                                                           \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= op(A)[64x16] . op(B)[16x128]; scale_d == 0 overwrites d.
// TA, TB: the operand is MN-major (wgmma's transpose bit).
template <bool TA, bool TB>
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
      "%64, %65, p, 1, 1, %67, %68;\n\t}"
      : MDM_ACC8(0), MDM_ACC8(8), MDM_ACC8(16), MDM_ACC8(24), MDM_ACC8(32), MDM_ACC8(40),
        MDM_ACC8(48), MDM_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(int(TA)), "n"(int(TB)));
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

// The epilogue of an instance: + bias (any), then the exact GELU or its tanh
// form (x . W^T) or + the f32 residual (dY . W). Each is an instance of its
// own: a kernel that also held the residual's path, even behind one branch
// per item, ran the x . W^T products 2-7% slower. GELU_TANH (DiT) comes last
// so that the other instances keep their numbers and their code.
enum Epi { PLAIN, GELU, RESIDUAL, GELU_TANH };

// A warpgroup's 64 x 128 outputs from its accumulators (rows r0.., columns
// n0..) into its staging tile, in f32, rounded to TO.
template <typename TO, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[64], unsigned char* staging,
                                         const bf16* __restrict__ bias,
                                         const float* __restrict__ res, int r0, int n0, int M,
                                         int N) {
  const int t = threadIdx.x % 128;
  const int row = t / 32 * 16 + t % 32 / 4, q = t % 4;  // the accumulator fragment's layout
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q, c = n0 + col;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr && c < N) {  // N % 8 == 0: c + 1 < N too
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
      b0 = __low2float(bb);
      b1 = __high2float(bb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * j + 2 * i] + b0, v1 = acc[4 * j + 2 * i + 1] + b1;
      if constexpr (EPI == GELU) {
        v0 = mdm::gelu_exact(v0);
        v1 = mdm::gelu_exact(v1);
      }
      if constexpr (EPI == GELU_TANH) {
        v0 = mdm::gelu_tanh(v0);
        v1 = mdm::gelu_tanh(v1);
      }
      if constexpr (EPI == RESIDUAL) {
        const int r = r0 + row + 8 * i;
        if (r < M && c < N) {
          const float2 rr = *reinterpret_cast<const float2*>(res + (size_t)r * N + c);
          v0 += rr.x;
          v1 += rr.y;
        }
      }
      store_pair(staging + staging_offset<TO>(row + 8 * i, col), v0, v1,
                 static_cast<TO*>(nullptr));
    }
  }
}

// One (tile, split) item of the persistent walk: its output corner, its
// split and its K rows [k0, k0 + 64 nk).
struct Item {
  int m0, n0, z, k0, nk;
};

__device__ __forceinline__ Item item_at(int w, int tiles_n, int tiles, int K, int kchunk) {
  const int tile = w % tiles, z = w / tiles, k0 = z * kchunk;
  return Item{tile / tiles_n * BM, tile % tiles_n * BN, z, k0,
              (min(kchunk, K - k0) + BK - 1) / BK};
}

template <typename TO, int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                const __grid_constant__ CUtensorMap tma_c, const bf16* __restrict__ bias,
                const float* __restrict__ res, int M, int N, int K, int splits, int kchunk) {
  using P = Plan<TO>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's address pattern needs 1024
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + P::BAR, empty0 = full0 + 8 * P::STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n, items = tiles * splits;
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
    // Producer: one thread keeps the ring full, across items.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item_at(w, tiles_n, tiles, K, kchunk);
        const bool a2 = !TA || it.m0 + 64 < M, b2 = !TB || it.n0 + 64 < N;  // second boxes
        const uint32_t bytes = (a2 ? 2 : 1) * HALF_TILE + (b2 ? 2 : 1) * HALF_TILE;
        for (int kt = 0; kt < it.nk; ++kt) {
          const int k = it.k0 + kt * BK;
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = base + P::A0 + stage * TILE_BYTES, b = base + P::B0 + stage * TILE_BYTES;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, bytes);
          if (TA) {
            tma_load(a, &tma_a, it.m0, k, full);
            if (a2) tma_load(a + HALF_TILE, &tma_a, it.m0 + 64, k, full);
          } else {
            tma_load(a, &tma_a, k, it.m0, full);
          }
          if (TB) {
            tma_load(b, &tma_b, it.n0, k, full);
            if (b2) tma_load(b + HALF_TILE, &tma_b, it.n0 + 64, k, full);
          } else {
            tma_load(b, &tma_b, k, it.n0, full);
          }
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
    const int lane = t % 32;
    const uint32_t staging = P::C0 + wg * P::HALF;
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = item_at(w, tiles_n, tiles, K, kchunk);
      int prev = 0;
      for (int kt = 0; kt < it.nk; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint64_t da = smem_desc<TA>(base + P::A0 + stage * TILE_BYTES + wg * HALF_TILE);
        const uint64_t db = smem_desc<TB>(base + P::B0 + stage * TILE_BYTES);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n128k16<TA, TB>(acc, da + k16_step<TA>() * kk, db + k16_step<TB>() * kk,
                                   kt > 0 || kk > 0);
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

      // Epilogue. The staging tile is free once the last item's stores read it.
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_sync(1 + wg);
      epilogue<TO, EPI>(acc, smem + staging, bias, res, it.m0 + wg * 64, it.n0, M, N);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + wg);
      if (t == 0) {
#pragma unroll
        for (int b = 0; b < BN / P::BOX_N; ++b)
          tma_store(&tma_c, base + staging + b * BOX_BYTES, it.n0 + b * P::BOX_N,
                    it.m0 + wg * 64, it.z);
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

// A row-major tensor of `rank` dimensions (dims innermost first, the byte
// strides of the outer ones), cut into boxes with the 128-byte swizzle;
// reads past its edge are zeros, writes past it are dropped. Returns the
// driver's CUresult, whose codes the runtime's cudaError_t shares.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t elems[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elems,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A bf16 operand stored [outer, inner]: boxes of 64 inner values (128
// bytes) by box_outer rows.
CUresult encode_operand(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 2, dims, strides, box);
}

// cuTensorMapEncodeTiled is a driver call: it needs a context current in
// the calling thread, which the runtime binds only at its own first call
// there. A product may be a thread's first CUDA call (autograd runs the
// backward in a device thread of its own), so bind it once per thread.
cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t e = cudaFree(nullptr);  // no work: initialises and binds the context
    if (e != cudaSuccess) return e;
    bound = true;
  }
  return cudaSuccess;
}

template <typename TO, int EPI, bool TA, bool TB>
cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t e = mdm::allow_smem(gemm_bf16_wgmma<TO, EPI, TA, TB>, Plan<TO>::BYTES);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

template <typename TO, int EPI, bool TA, bool TB>
cudaError_t launch(const void* a, const void* b, const void* bias, const float* r, void* c,
                   int M, int N, int K, int splits, int kchunk, int grid, cudaStream_t st) {
  const bool f32 = std::is_same<TO, float>::value;
  CUtensorMap ta, tb, tc;
  // C (or the split partials) as [splits][M][N], stored in boxes of 64 rows.
  const cuuint64_t cdims[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)splits};
  const cuuint64_t cstrides[2] = {(cuuint64_t)N * sizeof(TO), (cuuint64_t)M * N * sizeof(TO)};
  const cuuint32_t cbox[3] = {(cuuint32_t)Plan<TO>::BOX_N, 64, 1};
  CUresult res = TA ? encode_operand(&ta, a, M, K, BK) : encode_operand(&ta, a, K, M, BM);
  if (res == CUDA_SUCCESS)
    res = TB ? encode_operand(&tb, b, N, K, BK) : encode_operand(&tb, b, K, N, BN);
  if (res == CUDA_SUCCESS)
    res = encode(&tc, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c,
                 3, cdims, cstrides, cbox);
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(res);
  cudaError_t e = configure<TO, EPI, TA, TB>();
  if (e != cudaSuccess) return e;
  gemm_bf16_wgmma<TO, EPI, TA, TB><<<grid, THREADS, Plan<TO>::BYTES, st>>>(
      ta, tb, tc, static_cast<const bf16*>(bias), r, M, N, K, splits, kchunk);
  return cudaGetLastError();
}

// The instances, each storing bf16 or f32: x . W^T plain, with the exact
// GELU (gelu 1) or with its tanh form (gelu 2), dY . W plain or with the
// residual, dY^T . X plain; the epilogue of a (form, gelu, residual) no
// instance has: cudaErrorInvalidValue.
template <typename TO>
cudaError_t dispatch(int a_km, int b_kn, int gelu, const void* a, const void* b,
                     const void* bias, const float* r, void* c, int M, int N, int K, int splits,
                     int kchunk, int grid, cudaStream_t st) {
  if (!a_km && !b_kn && !r && gelu == 2)
    return launch<TO, GELU_TANH, false, false>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st);
  if (!a_km && !b_kn && !r)
    return gelu ? launch<TO, GELU, false, false>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st)
                : launch<TO, PLAIN, false, false>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st);
  if (!a_km && b_kn && !gelu)
    return r ? launch<TO, RESIDUAL, false, true>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st)
             : launch<TO, PLAIN, false, true>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st);
  if (a_km && b_kn && !gelu && !r)
    return launch<TO, PLAIN, true, true>(a, b, bias, r, c, M, N, K, splits, kchunk, grid, st);
  return cudaErrorInvalidValue;
}

template <typename TO, int EPI, bool TA, bool TB>
cudaError_t occupancy_of(int* blocks) {
  const cudaError_t e = configure<TO, EPI, TA, TB>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gemm_bf16_wgmma<TO, EPI, TA, TB>,
                                                       THREADS, Plan<TO>::BYTES);
}

template <typename TO>
cudaError_t occupancy(int a_km, int b_kn, int gelu, int* blocks) {
  if (!a_km && !b_kn && gelu == 2) return occupancy_of<TO, GELU_TANH, false, false>(blocks);
  if (!a_km && !b_kn)
    return gelu ? occupancy_of<TO, GELU, false, false>(blocks)
                : occupancy_of<TO, PLAIN, false, false>(blocks);
  if (gelu || (a_km && !b_kn)) return cudaErrorInvalidValue;
  return a_km ? occupancy_of<TO, PLAIN, true, true>(blocks)
              : occupancy_of<TO, PLAIN, false, true>(blocks);
}

}  // namespace

// C = act(op(A) . op(B) + bias) + R: op(A) is A [M, K], or A^T of A stored
// [K, M] when a_km; op(B) is B^T of B [N, K], or B stored [K, N] when b_kn.
// A, B and bias [N] (or null) bf16, R [M, N] f32 (or null); C [M, N] f32
// when out_f32, else bf16; gelu: 1 the exact GELU after the bias, 2 its tanh
// form (the x . W^T form only); R: the dY . W form only. splits > 1: split-K into `work` (f32
// [splits, M, N]), summed in split order into C; then C is f32, bias and R
// null, gelu 0. kchunk: the K rows of each split, a whole number of 64-deep
// K tiles with none empty (ops/_chain.py::split_rows; K or more when splits
// is 1). grid: the persistent blocks (ops/_chain.py::wgmma_plan). The caller guarantees contiguous operands with 16-byte
// aligned bases; N and the stored rows of A and B (K, or M and N when
// stored [K, .]) must be multiples of 8 (the TMA's 16-byte row strides).
extern "C" int mdm_gemm_wgmma(const void* a, const void* b, const void* bias, const void* r,
                              void* c, void* work, int M, int N, int K, int a_km, int b_kn,
                              int out_f32, int gelu, int splits, int kchunk, int grid,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || (a_km ? M : K) % 8 || (b_kn ? N : K) % 8 ||
      grid <= 0 || splits < 1 || kchunk <= 0 || kchunk % BK || gelu < 0 || gelu > 2 ||
      (long long)(splits - 1) * kchunk >= K || (long long)splits * kchunk < K)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (!out_f32 || bias || r || gelu || !work))
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t e = bind_context()) return (int)e;
  void* dst = splits > 1 ? work : c;
  const float* rr = static_cast<const float*>(r);
  const cudaError_t e =
      out_f32 ? dispatch<float>(a_km, b_kn, gelu, a, b, bias, rr, dst, M, N, K, splits, kchunk, grid, st)
              : dispatch<bf16>(a_km, b_kn, gelu, a, b, bias, rr, dst, M, N, K, splits, kchunk, grid, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)mdm::sum_splits(static_cast<const float*>(work), static_cast<float*>(c),
                              (size_t)M * N, splits, st);
}

// Resident blocks per SM of the instance of the form (a_km, b_kn) storing
// f32 (out_f32) or bf16, without GELU (gelu 0), with it (1) or its tanh form (2):
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int mdm_gemm_wgmma_occupancy(int a_km, int b_kn, int out_f32, int gelu, int* blocks) {
  return (int)(out_f32 ? occupancy<float>(a_km, b_kn, gelu, blocks)
                       : occupancy<bf16>(a_km, b_kn, gelu, blocks));
}
