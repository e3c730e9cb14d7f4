// key_tiles.cuh — the key tiles a tensor-core flash block walks under a
// per-key validity mask (kv_mask [B, Sk], nonzero = attend), shared by the
// forward (flash_fwd.cu) and dQ (flash_bwd.cu) kernels.
//
// A padding mask leaves whole key tiles with no valid key (past a row's
// length, or in a hole) and most of the others with every key valid. So,
// when kv_mask is set, a block reads its batch's mask row in a short
// prologue (Sk int32: every head and query block of the batch reads the
// same row, so it is L2-resident), packs it into validity bits with warp
// ballots and sorts the key tiles it would walk into empty, full and
// mixed, all in shared memory. The block then walks only the non-empty
// tiles, in order: a tile's position in the list drives the ring stage and
// its phase, its absolute index the TMA coordinate, the causal test and the
// dropout column. A full tile takes the mask-free path (only the ragged
// edge and the causal diagonal apply); a mixed one reads its validity from
// the bits. Skipping an empty tile changes no bit of the result: its scores
// would all be -inf, giving p = 0, alpha = 1 and O += 0.
//
// The room in shared memory is fixed per kernel (kMaxKeys keys). A row
// with more tiles than that is walked whole, every tile treated as mixed,
// and each warp forms a tile's bits with ballots over the mask row in
// device memory when it reaches the tile (one coalesced load a lane for 32
// keys, not one per score element).

#pragma once

#include <stdint.h>

namespace key_tiles {

constexpr uint32_t kMixed = 0x8000u;  // list entry: a tile with masked keys

// Shared memory for up to kMaxKeys keys in tiles of BN: the validity bits,
// the list of non-empty tiles (index | kMixed), the list's length and a
// flag (1: the row had too many tiles and is walked whole).
template <int BN, int kMaxKeys>
struct Smem {
  static_assert(BN % 32 == 0 && kMaxKeys % BN == 0, "whole words and tiles");
  static constexpr int kWords = kMaxKeys / 32;
  static constexpr int kMaxTiles = kMaxKeys / BN;
  static_assert(kMaxTiles <= 0x7fff, "a tile index fits 15 bits");
  static constexpr int kBits = 0;
  static constexpr int kList = kBits + 4 * kWords;
  static constexpr int kCount = kList + ((2 * kMaxTiles + 15) / 16) * 16;
  static constexpr int kWhole = kCount + 4;
  static constexpr int kBytes = kCount + 16;  // a multiple of 16
};

// Sort the first n tiles of BN keys (keys beyond Sk are invalid): every
// thread of the block takes part, and every thread gets the number of
// tiles to walk (the non-empty ones, or all n when they outnumber the
// room). `at` is the Smem region.
template <int BN, int kMaxKeys>
__device__ __forceinline__ int prepare(uint8_t* at,
                                       const int* __restrict__ mask_row,
                                       int Sk, int n) {
  using S = Smem<BN, kMaxKeys>;
  constexpr int kW = BN / 32;  // words a tile spans
  uint32_t* bits = reinterpret_cast<uint32_t*>(at + S::kBits);
  uint16_t* list = reinterpret_cast<uint16_t*>(at + S::kList);
  int* count = reinterpret_cast<int*>(at + S::kCount);
  int* whole = reinterpret_cast<int*>(at + S::kWhole);
  if (n > S::kMaxTiles) {
    if (threadIdx.x == 0) {
      *whole = 1;
      *count = n;
    }
    __syncthreads();
    return n;
  }
  if (threadIdx.x == 0) *whole = 0;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  for (int w = warp; w < n * kW; w += warps) {
    const int key = 32 * w + lane;
    const bool ok = key < Sk && mask_row[key] != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) bits[w] = word;
  }
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      bool any = false, mixed = false;
      if (t < n) {
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const int first = t * BN + 32 * i;  // the word's first key
          const uint32_t in_range =
              first + 32 <= Sk ? 0xffffffffu
              : first >= Sk    ? 0u
                               : (1u << (Sk - first)) - 1u;
          const uint32_t word = bits[t * kW + i];
          any |= word != 0u;
          mixed |= word != in_range;
        }
      }
      const uint32_t take = __ballot_sync(0xffffffffu, any);
      if (any) {
        list[total + __popc(take & ((1u << lane) - 1u))] =
            static_cast<uint16_t>(t | (mixed ? kMixed : 0u));
      }
      total += __popc(take);
    }
    if (lane == 0) *count = total;
  }
  __syncthreads();
  return *count;
}

// The walk's entry t: tile t, full, without a mask; tile t, mixed, on a
// whole walk; else list[t]. (The kernels pass `at` as their shared base
// plus a constant, so no pointer stays live across their loops.)
template <int BN, int kMaxKeys>
__device__ __forceinline__ uint32_t entry(const uint8_t* at, bool masked,
                                          int t) {
  using S = Smem<BN, kMaxKeys>;
  if (!masked) return static_cast<uint32_t>(t);
  if (*reinterpret_cast<const int*>(at + S::kWhole)) {
    return static_cast<uint32_t>(t) | kMixed;
  }
  return reinterpret_cast<const uint16_t*>(at + S::kList)[t];
}

__device__ __forceinline__ int tile_of(uint32_t e) {
  return static_cast<int>(e & (kMixed - 1u));
}
__device__ __forceinline__ bool is_mixed(uint32_t e) {
  return (e & kMixed) != 0u;
}

// Word w of tile j's validity bits (bit c: key j * BN + 32 w + c): from
// shared memory when the row was listed, else one ballot over the mask row
// (every lane of the warp must call it). A caller takes the words one at a
// time, as its loop over the tile's columns reaches them, so that one
// register holds them.
template <int BN, int kMaxKeys>
__device__ __forceinline__ uint32_t tile_word(const uint8_t* at,
                                              const int* __restrict__ mask_row,
                                              int Sk, int j, int w) {
  using S = Smem<BN, kMaxKeys>;
  if (!*reinterpret_cast<const int*>(at + S::kWhole)) {
    return reinterpret_cast<const uint32_t*>(at + S::kBits)[j * (BN / 32) + w];
  }
  const int key = j * BN + 32 * w + static_cast<int>(threadIdx.x % 32);
  return __ballot_sync(0xffffffffu, key < Sk && mask_row[key] != 0);
}

}  // namespace key_tiles
