// Philox4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), written out here rather than taken from curand,
// and the dropout rule of the training kernels.
//
// Every dropout site draws one 32-bit word per element: word 0 of
// Philox(counter = (column, row, site, batch index), key = (seed, 0)). The
// bits of an element therefore depend on its coordinates alone, so a
// backward kernel with another tiling replays the forward's mask exactly.
// The plain PyTorch version is mdm_tpu_torch/ops/dropout_bits.py::philox4x32.
#pragma once

#include <cstdint>

namespace mdm {

__host__ __device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                                      uint32_t& c2, uint32_t& c3,
                                                      uint32_t k0, uint32_t k1) {
  const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
  const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
  const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
  const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
  c0 = hi1 ^ c1 ^ k0;
  c1 = lo1;
  c2 = hi0 ^ c3 ^ k1;
  c3 = lo0;
}

// Word 0 of Philox4x32-10 at counter (c0, c1, c2, c3), key (k0, 0).
__host__ __device__ __forceinline__ uint32_t philox_word(uint32_t k0, uint32_t c0,
                                                         uint32_t c1, uint32_t c2,
                                                         uint32_t c3) {
  uint32_t k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    philox_round(c0, c1, c2, c3, k0, k1);
  }
  return c0;
}

// The dropout of one site. mode 0: no dropout (rate 0, no bits drawn);
// 1: injected bits (tests: the TPU kernels' use_prng=False path);
// 2: in-kernel Philox. Keep where bits < thr, scaled by inv_keep
// (attention_train_block.py::_keep_threshold). boff is added to the
// counter's batch word: a data-parallel rank whose rows start at global row
// boff draws exactly the words of those rows in the whole batch (the
// counterpart of mdm_tpu/ops/__init__.py::shard_seed_offset).
struct Dropout {
  const uint32_t* bits;  // mode 1: the site's bits, indexed by the caller
  uint32_t seed;
  uint32_t boff;  // the first row's global batch index
  uint32_t thr;
  float inv_keep;
  int mode;

  __device__ __forceinline__ float keep(size_t idx, uint32_t b, uint32_t site,
                                        uint32_t row, uint32_t col) const {
    if (mode == 0) return 1.0f;
    const uint32_t r = mode == 1 ? bits[idx] : philox_word(seed, col, row, site, b + boff);
    return r < thr ? inv_keep : 0.0f;
  }
};

}  // namespace mdm
