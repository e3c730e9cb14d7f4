// dropout.cuh — the attention-dropout mask shared by the flash kernels.
//
// The TPU kernels seed the chip's hardware generator per (bh, q tile,
// k tile), so their bits depend on the tiling and cannot be reproduced.
// Here a keep bit is a pure function of (seed, bh, query index, key
// index): a 32-bit integer mixing hash (Wellons' "lowbias32" finaliser)
// applied three times for the row and once more for the key. The mask
// therefore does not depend on any kernel's tile shape: the forward, both
// backward kernels and the plain PyTorch versions (ops/attention.py:
// dropout_keep_mask, which spells the same arithmetic out in int64 ops
// masked to 32 bits) all regenerate the same mask.
//
// A pair is kept when bits >= threshold, threshold = uint32(rate * 2**32)
// (the JAX rule); kept probabilities are divided by (1 - rate).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t dropout_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// the per-row part of the hash: one value per (seed, bh, query)
__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed, int bh,
                                                    int q) {
  return dropout_mix32(dropout_mix32(dropout_mix32(seed) ^ (uint32_t)bh) ^
                       (uint32_t)q);
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_key, int k,
                                             uint32_t threshold) {
  return dropout_mix32(row_key ^ (uint32_t)k) >= threshold;
}
