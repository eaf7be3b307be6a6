// Dumps of the Philox dropout bits, replacing the TPU test kernels
// mdm_tpu/ops/attention_dropout.py::dropout_bits and
// mdm_tpu/ops/encoder_tail.py::tail_dropout_bits. They write exactly the
// words the training kernels draw in-kernel (philox.cuh), so a test can
// feed them to the injected-bits path and hold the two paths bitwise
// equal, and the plain routes take their masks from them.
//
// Bound by the draws, not the bytes: a word costs one Philox4x32-10 (ten
// rounds of two 32x32->64 multiplies and two three-way xors) against 4
// bytes stored. So the design spends as few integer instructions beside
// the draws as it can:
// - each multiply is one mul.wide.u32 (one IMAD.WIDE.U32 giving both
//   halves); philox.cuh's 64-bit product compiles to an IMAD.WIDE.U32, an
//   IMAD and an add (15% slower here);
// - one thread per four 16-byte groups of a row, g + v ceil(G / 4) of its
//   G groups for v = 0..3: sixteen words, each four stored with one
//   16-byte store, or word by word where a group straddles the row's start
//   or end (a row of C words starts 16-byte aligned only when its flat
//   offset is a multiple of 4); a warp's lanes store neighbouring groups;
// - the thread's coordinates in 32 bits, from its index by three
//   divisions by invariant integers (a multiply-high, an add and a shift
//   each), once for its sixteen words; the row's flat offset in 64 bits;
// - the sixteen words share row, site and batch index, so the compiler
//   computes round 1's site product and the row-uniform half of rounds 1-2
//   once for all of them;
// - the key schedule (k0 of each round) is computed on the host and read
//   from the kernel's parameters; k1's are constants;
// - the tail's three sites are three segments of one grid: one launch.
//
// Under tensor parallelism a rank holds heads [h0, h0 + H) of an attention
// and FFN columns [f0, f0 + F) of a layer. The plan's head offset is added
// to the site word where the heads are the sites, and a segment's column
// offset to its column word (the tail's site 1, the FFN-hidden mask), so
// the rank's dump is exactly its slice of the whole layer's; at offset 0
// every word is the one before.

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 3;
// 16-byte groups of a row per thread. On the H100 the tail's dump took 5%
// longer with 2 and 17% with 1 (scripts/dropout_bits_probe.py).
constexpr int kGroups = 4;
constexpr uint32_t kHeadSite = 0xFFFFFFFFu;  // the site is the head index h

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 (Granlund and Montgomery,
// "Division by invariant integers using multiplication", PLDI'94):
// (umulhi(n, magic) + n) >> shift, with shift = ceil(log2 d) and
// magic = floor(2^32 (2^shift - d) / d) + 1. The error of the product is
// below n / 2^(32 + shift) < 1 / (2d), less than the distance 1/d from
// n/d to the next integer; umulhi(n, magic) < n, so the add stays in 32 bits.
// On the H100 the dumps ran 3-4.6% slower with 32-bit `/` and `%` in its
// place (scripts/dropout_bits_probe.py, in turns; PERF.md, PR 9).
struct FastDiv {
  uint32_t d, magic, shift;

  static FastDiv make(uint32_t d) {
    uint32_t s = 0;
    while ((1ull << s) < d) ++s;
    return {d, (uint32_t)((((1ull << 32) * ((1ull << s) - d)) / d) + 1), s};
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

// One output [B][H][R][C] (the tail's: H = 1), a segment of the grid.
struct Seg {
  uint32_t* out;
  FastDiv threads_per_row, R, H;  // threads_per_row = ceil(G / kGroups)
  uint32_t C, G, site;  // G groups a row; site kHeadSite: the heads are the sites
  uint32_t coff;        // added to the column word (a rank's first FFN column)
  uint32_t threads;     // rows x threads per row, at most 2^31 - kThreads
  uint32_t block0;      // first block of the segment in the launch
};

struct Plan {
  Seg seg[kMaxSegs];
  uint32_t k0[10];  // k0 of each round: seed + round x 0x9E3779B9
  uint32_t boff;    // added to the counter's batch word (philox.cuh::Dropout::boff)
  uint32_t hoff;    // added to the site word where the heads are the sites
  int nseg;
};

// philox.cuh::philox_round with each product one mul.wide.u32.
__device__ __forceinline__ void philox_round_wide(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                                  uint32_t& c3, uint32_t k0, uint32_t k1) {
  uint64_t p0, p1;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p0) : "r"(c0), "r"(0xD2511F53u));
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p1) : "r"(c2), "r"(0xCD9E8D57u));
  c0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
  c1 = (uint32_t)p1;
  c2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
  c3 = (uint32_t)p0;
}

// philox.cuh::philox_word with k0's schedule given: the same word.
__device__ __forceinline__ uint32_t philox_word_keyed(const uint32_t (&k0)[10], uint32_t c0,
                                                      uint32_t c1, uint32_t c2, uint32_t c3) {
  uint32_t k1 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) k1 += 0xBB67AE85u;
    philox_round_wide(c0, c1, c2, c3, k0[i], k1);
  }
  return c0;
}

// out[b][h][r][c] = philox(seed; c + coff, r, site == kHeadSite ? h + hoff : site,
// b + boff).
// Group g of a row at flat offset o covers the flat words
// [o - o % 4 + 4g, o - o % 4 + 4g + 4), columns 4g - o % 4 onwards; thread
// t of the row takes groups t + v ceil(G / kGroups), v = 0 .. kGroups - 1.
__global__ void __launch_bounds__(kThreads) philox_dump(const __grid_constant__ Plan p) {
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i) s += i < p.nseg && blockIdx.x >= p.seg[i].block0;
  const Seg& sg = p.seg[s];
  const uint32_t lt = (blockIdx.x - sg.block0) * kThreads + threadIdx.x;
  if (lt >= sg.threads) return;
  const uint32_t row = sg.threads_per_row.div(lt);  // flat row (b, h, r)
  const uint32_t t = lt - row * sg.threads_per_row.d;
  const uint32_t bh = sg.R.div(row), r = row - bh * sg.R.d;
  const uint32_t b = sg.H.div(bh), h = bh - b * sg.H.d;
  const uint32_t site = sg.site == kHeadSite ? h + p.hoff : sg.site;
  const size_t base = (size_t)row * sg.C;
  const uint32_t off = (uint32_t)base & 3u;
  // Columns are unsigned: a group's first column 4g - off wraps past 2^32
  // - 4 where the group starts before its row, so `c + j < C` keeps only
  // the row's own words at both ends.
  uint32_t w[kGroups][4];
#pragma unroll
  for (int v = 0; v < kGroups; ++v) {
    const uint32_t c = 4 * (t + v * sg.threads_per_row.d) - off;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[v][j] = philox_word_keyed(p.k0, c + j + sg.coff, r, site, b + p.boff);
  }
#pragma unroll
  for (int v = 0; v < kGroups; ++v) {
    const uint32_t g = t + v * sg.threads_per_row.d;
    if (g >= sg.G) break;
    const uint32_t c = 4 * g - off;  // column of the group's first word
    uint32_t* dst = sg.out + (base - off) + 4 * (size_t)g;
    if (c < sg.C && sg.C - c >= 4) {
      __stwb(reinterpret_cast<uint4*>(dst), make_uint4(w[v][0], w[v][1], w[v][2], w[v][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < sg.C) dst[j] = w[v][j];
    }
  }
}

struct Out {
  void* ptr;
  int C, site;  // site < 0: the heads are the sites
  int coff;     // the column word of column 0
};

// One segment per output, one launch. What the kernel takes: rows
// B x H x R below 2^31 and an output's threads (rows x ceil(G / 4)) at most
// 2^31 - 256, so the thread and row indices stay in FastDiv's range (an
// output may hold 2^35 words, more than the card's memory); a row width C
// below 2^31 (an int), so a group's columns, at most C + 17, fit 32
// unsigned bits; offsets at least 0, a column offset plus C below 2^31.
cudaError_t dump(const Out* outs, int n_out, int seed, int boff, int hoff, int B, int H, int R,
                 cudaStream_t st) {
  if (B <= 0 || H <= 0 || R <= 0 || hoff < 0 || n_out > kMaxSegs) return cudaErrorInvalidValue;
  const uint64_t rows = (uint64_t)B * H * R;
  if (rows >= (1ull << 31)) return cudaErrorInvalidValue;
  Plan p{};
  p.nseg = n_out;
  p.boff = (uint32_t)boff;
  p.hoff = (uint32_t)hoff;
  for (int i = 0; i < 10; ++i) p.k0[i] = (uint32_t)seed + (uint32_t)i * 0x9E3779B9u;
  uint32_t blocks = 0;
  for (int i = 0; i < n_out; ++i) {
    const Out& o = outs[i];
    if (o.C <= 0 || o.coff < 0 || o.C > INT32_MAX - o.coff) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(o.ptr) % 16) return cudaErrorMisalignedAddress;
    // Groups a row touches: (o % 4 + C - 1) / 4 + 1 at most, o % 4 = 0
    // for every row when C % 4 == 0, at most 2 when C % 4 == 2, else 3.
    const uint32_t max_off = o.C % 4 == 0 ? 0 : o.C % 4 == 2 ? 2 : 3;
    const uint32_t G = (max_off + o.C - 1) / 4 + 1;
    const uint32_t T = (G + kGroups - 1) / kGroups;
    const uint64_t threads = rows * T;
    if (threads > (1ull << 31) - kThreads) return cudaErrorInvalidValue;
    p.seg[i] = Seg{static_cast<uint32_t*>(o.ptr), FastDiv::make(T), FastDiv::make((uint32_t)R),
                   FastDiv::make((uint32_t)H), (uint32_t)o.C, G,
                   o.site < 0 ? kHeadSite : (uint32_t)o.site, (uint32_t)o.coff,
                   (uint32_t)threads, blocks};
    blocks += (uint32_t)((threads + kThreads - 1) / kThreads);
  }
  philox_dump<<<blocks, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// out [B][H][R][C]: site < 0 draws site h + hoff for head h (the attention
// block's bits), else the one site for every head. boff: the global batch
// index of row 0 (0 outside data parallelism); hoff: the global index of
// head 0 (0 outside tensor parallelism).
extern "C" int mdm_philox_dump(void* out, int seed, int boff, int B, int H, int site, int R,
                               int C, int hoff, void* stream) {
  const Out o{out, C, site, 0};
  return (int)dump(&o, 1, seed, boff, hoff, B, H, R, static_cast<cudaStream_t>(stream));
}

// The tail's three outputs [B][R][C0], [B][R][C1], [B][R][C2] at sites 0,
// 1 and 2, in one launch. foff: the global index of site 1's column 0 (a
// tensor-parallel rank's first FFN column); sites 0 and 2 are [B, R, D],
// whole on every rank, so their columns do not move.
extern "C" int mdm_philox_dump3(void* out0, void* out1, void* out2, int seed, int boff, int B,
                                int R, int C0, int C1, int C2, int foff, void* stream) {
  const Out o[3] = {{out0, C0, 0, 0}, {out1, C1, 1, foff}, {out2, C2, 2, 0}};
  return (int)dump(o, 3, seed, boff, 0, B, 1, R, static_cast<cudaStream_t>(stream));
}
