// Dumps of the Philox dropout bits, replacing the TPU test kernels
// mdm_tpu/ops/attention_dropout.py::dropout_bits and
// mdm_tpu/ops/encoder_tail.py::tail_dropout_bits. They write exactly the
// words the training kernels draw in-kernel (philox.cuh), so a test can
// feed them to the injected-bits path and hold the two paths bitwise
// equal. Bound by the store of 4 bytes per element; each thread computes
// one Philox4x32-10 (10 rounds of two 32x32->64 multiplies).

#include <cstdint>

#include "common.cuh"
#include "philox.cuh"

namespace {

// out[b][h][r][c] = philox(seed; c, r, site < 0 ? h : site, b).
__global__ void philox_dump(uint32_t* __restrict__ out, uint32_t seed, int B, int H, int site,
                            int R, int C) {
  const size_t n = (size_t)B * H * R * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t c = (uint32_t)(i % C);
    const uint32_t r = (uint32_t)((i / C) % R);
    const uint32_t h = (uint32_t)((i / ((size_t)C * R)) % H);
    const uint32_t b = (uint32_t)(i / ((size_t)C * R * H));
    out[i] = mdm::philox_word(seed, c, r, site < 0 ? h : (uint32_t)site, b);
  }
}

}  // namespace

extern "C" int mdm_philox_dump(void* out, int seed, int B, int H, int site, int R, int C,
                               void* stream) {
  if (B <= 0 || H <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * H * R * C;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  philox_dump<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), (uint32_t)seed, B, H, site, R, C);
  return (int)cudaGetLastError();
}
