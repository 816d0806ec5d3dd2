// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11; Random123's constants), the counter-based generator
// that stands in for the TPU core's `pltpu.prng_random_bits` in every
// kernel of the port that rounds stochastically. The noise of a flat
// element e is word e % 4 of philox(counter = (e / 4 low, e / 4 high,
// stream, 0), key = (k0, k1)): it depends on (key, stream, element),
// never on the launch shape, so the plain PyTorch versions
// (ops/fused_adamw.py: philox_words) reproduce it bit for bit.
//
// Streams in use: AdamW (fused_adamw.cu, fused_adamw8.cu) keys
// (seed + leaf_id * 1000003, 0) with stream 0 for the master's SR, 1 for
// the int8 m codes and 2 for the int8 sqrt(v) codes; the SR column
// quantize (quantize.cu) keys (seed, 1), stream 0.
#pragma once

#include <stdint.h>

namespace ptt {

// (hi, lo) of the 64-bit product a * b: one IMAD.WIDE.U32 (nvcc was
// seen to emit a second, low-word IMAD for the same product written in
// C++).
__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b,
                                        uint32_t& hi, uint32_t& lo) {
  asm("{\n.reg .u64 t;\nmul.wide.u32 t, %2, %3;\nmov.b64 {%1, %0}, t;\n}"
      : "=r"(hi), "=r"(lo)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(kM0, c.x, hi0, lo0);
    mulhilo(kM1, c.z, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words of flat elements 4 * grp .. 4 * grp + 3.
__device__ __forceinline__ uint4 philox_group(long long grp, uint32_t stream,
                                              uint32_t k0, uint32_t k1) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(grp),
                                  static_cast<uint32_t>(grp >> 32), stream,
                                  0u),
                       k0, k1);
}

// The reference kernels' uniform in [0, 1): the top 23 bits of the word
// as the mantissa of a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fsub_rn(__uint_as_float(0x3F800000u | (bits >> 9)), 1.f);
}

}  // namespace ptt
