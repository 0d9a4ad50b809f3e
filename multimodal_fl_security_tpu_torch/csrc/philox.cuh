// Philox4x32-10, the counter-based generator of Salmon et al. (SC'11,
// "Parallel random numbers: as easy as 1, 2, 3"), with the Random123
// constants: a 128-bit counter and a 64-bit key give four 32-bit words, and
// the same (counter, key) always gives the same words. It takes the place of
// the TPU's own generator (pltpu.prng_seed / prng_random_bits), whose bits
// no other device reproduces: reseeding is recomputing.
//
// The port's counter layout (ops/philox.py says the same): for a mask of
// logical shape [C, B, F] at global SGD step s, element (c, b, f) takes
// j = b * F + f, counter (j / 4, c, s, stream), key (seed & 0xffffffff,
// seed >> 32), and word j % 4 of the result.

#pragma once

#include <cstdint>

namespace mft_philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 round1(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t lo0 = kM0 * c.x;
  const uint32_t hi0 = __umulhi(kM0, c.x);
  const uint32_t lo1 = kM1 * c.z;
  const uint32_t hi1 = __umulhi(kM1, c.z);
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

// Ten rounds, the key bumped between them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    c = round1(c, k0, k1);
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

}  // namespace mft_philox
