// The keep-mask of attention dropout, shared by K1's dropout branch
// (fused_attention_fwd.cu) and K2 (fused_attention_bwd.cu).
//
// The TPU kernels draw the mask from the TPU's own generator, seeded per
// batch row, and K2 replays it by drawing again in the same order
// (sign_language_nlp_tpu/ops/pallas_attention_train.py:56-66, 153-154).
// Here the mask is a stateless hash of (seed_b, h, i, j), with i and j
// the global query and key indices, so every kernel can rebuild any
// element whatever its tiling:
//
//     row_key = mix(mix(mix(seed_b ^ 0x9e3779b9) ^ h) ^ i)
//     keep    = (mix(row_key ^ j) >> 8) >= threshold
//
// mix is the lowbias32 integer finaliser (two multiplies and three
// xor-shifts, a bijection of 32-bit words). The rule on the bits is the
// TPU kernel's: keep iff the top 24 bits are >= rate * 2^24, truncated in
// f32. The plain version, ops/fused_attention.py:dropout_keep_mask,
// gives the same bits with torch integer ops.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t slt_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t slt_dropout_row_key(int seed, int h,
                                                        int i) {
  uint32_t x = slt_mix32(static_cast<uint32_t>(seed) ^ 0x9e3779b9U);
  x = slt_mix32(x ^ static_cast<uint32_t>(h));
  return slt_mix32(x ^ static_cast<uint32_t>(i));
}

__device__ __forceinline__ bool slt_dropout_keep(uint32_t row_key, int j,
                                                 int threshold) {
  return static_cast<int>(slt_mix32(row_key ^ static_cast<uint32_t>(j)) >>
                          8) >= threshold;
}

// rate in [0, 1]: threshold in [0, 2^24]; rate 1 keeps nothing.
inline int slt_dropout_threshold(float rate) {
  return static_cast<int>(rate * 16777216.0f);
}

// K1's scale of the kept probabilities (pallas_attention_train.py:124).
inline float slt_dropout_inv(float rate) {
  const float keep = 1.0f - rate;
  return 1.0f / (keep > 1e-6f ? keep : 1e-6f);
}
