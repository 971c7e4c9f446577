// Draw sources of the NUTS kernel; the plain version is smcnuts_torch/ops/draws.py.
//
// A draw is addressed by its place in the tree, key (seed of the run's
// iteration, 0) and counter (global particle index within its run, kind,
// doubling j, slot l), so it depends neither on the block layout, nor on
// when a thread reaches it, nor on the run's place in a batch, nor on which
// rank holds the particle. One Philox4x32-10 block per draw; its first word
// is used.
#pragma once

#include <cstdint>

namespace smcnuts {

// Kinds 4 and 5 address a run's own stream (resampling uniforms, tree seeds;
// ops/draws.py), so the epilogue's accept-reject draw takes 6.
enum DrawKind : uint32_t {
  kPrologue = 0, kDirection = 1, kAccept = 2, kLeaf = 3, kAccRej = 6
};

__device__ __forceinline__ uint32_t philox4x32_10_word0(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

struct TreeDraws {
  uint32_t key0;      // seed of the run's iteration
  uint32_t particle;  // global particle index within the run
  bool zero_bits;     // every word 0: every uniform is 2^-24

  // u = ((w >> 8) + 1) * 2^-24 in (0, 1]; exact in float.
  __device__ __forceinline__ float uniform(uint32_t kind, uint32_t j, uint32_t l) const {
    const uint32_t w = zero_bits ? 0u : philox4x32_10_word0(particle, kind, j, l, key0, 0u);
    return static_cast<float>((w >> 8) + 1u) * 5.9604644775390625e-08f;
  }
};

}  // namespace smcnuts
