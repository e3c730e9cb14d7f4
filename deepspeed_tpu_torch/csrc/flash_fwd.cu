// flash_fwd.cu — flash-attention forward, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/attention.py, the Pallas kernel _fwd_kernel
// (launched by _flash_fwd_impl). Same function: softmax(q k^T * scale) v
// over [B, H, S, D] with an online softmax (running max m, normaliser l and
// the weighted-value sum in float32), a causal mask aligned bottom-right
// (key j visible to query i when j <= i + (Sk - Sq)), an optional per-key
// validity vector kv_mask [B, Sk] (int32, nonzero = attend), rows with no
// visible key written as exact zeros, and lse = m + log(l) per row; with
// dropout, the probabilities that weight V are dropped with the mask of
// dropout.cuh and the kept ones divided by (1 - rate), while l and lse are
// taken from the undropped p (as the TPU kernel does). The TPU kernel's
// lse rode a 128-lane trailing dim for TPU tiling; here it is a plain
// [B, H, Sq] float32 array.
//
// What bounds it on the H100: attention at GPT-2 small's training shape
// (B=8, H=12, S=1024, D=64, causal) is 4*D flops per visible (query, key)
// pair, 12.9 GFLOP, 13 us of bf16 tensor-core time at 989 TFLOP/s, against
// 51 MB of q, k, v, out and lse, 15 us of HBM time at 3.35 TB/s: the two
// bounds meet, so the score matrix must never touch device memory and the
// products must run on the tensor cores. At D = 256 (B=8, H=4, S=1024,
// causal) the same holds: 17.2 GFLOP, 17 us, against 67 MB, 20 us.
//
// Two routes, chosen by dtype in ds_flash_fwd:
//
// bfloat16 and float16 — flash_fwd_kernel_tc, the tensor-core kernel, at
// D = 64, 128 and 256. A block owns 128 query rows of one (batch, head):
// two consumer warpgroups of 64 rows each. The block's Q tile is loaded
// once and a ring of K and V tiles is kept in flight with TMA (3-D tensor
// maps over [B*H, S, D], so a ragged last tile reads zeros, not the next
// head), signalled through mbarriers; a K stage is released when its S
// has completed and a V stage when its P V has. Each consumer forms
// S = Q K^T with wgmma from shared memory (both operands K-major,
// 128-byte swizzle), keeps m, l and the rescale factor in float32
// registers, applies the causal/key/length mask only on the tiles that
// need it and the dropout hash in the accumulator fragment itself (each
// thread knows the (row, key) of its registers; a row's hash key is
// computed once), rounds P to the storage type in registers and issues
// O += P V with P as the register A operand and V read MN-major from the
// ring. Within a warpgroup the work is software-pipelined: S of tile t is
// issued together with P V of tile t - 1, and the softmax of tile t runs
// while that P V is on the tensor cores. The loop stops at the diagonal
// tile; query tiles are issued heaviest first. The epilogue divides by l
// and writes out and lse. Softmax runs in the exp2 domain (scale * log2 e
// folded into one FMA, the special-function unit's ex2); lse is converted
// back to natural-log units at the edge.
//
// Under a key mask (BERT's padding) the block first sorts the key tiles it
// would walk into empty, full and mixed (key_tiles.cuh: one pass over its
// batch's mask row with warp ballots, into shared memory), then the loader
// and the consumers walk only the non-empty tiles: a full tile takes the
// mask-free path, a mixed one reads its validity bits from shared memory
// (not the mask from device memory per score element), and a row with no
// valid key walks none and takes the epilogue's zeros.
//
// The tiles depend on the head dim (tc::Cfg; tc::Tile adds a 64-key form
// at D = 64 and 128, chosen by the caller's block_k): at D = 64, 128-key
// tiles in a three-stage ring fed by a third, producer warpgroup, whose
// registers go to the consumers (setmaxnreg 24 / 240). A 384-thread block
// gets 168 registers a thread at compile time, whatever setmaxnreg gives
// at run time: at D = 128 a thread's O (64 float32 registers), S of a 128-key
// tile (64) and P of the previous tile (32) spilled there and serialised
// the wgmmas. So at D = 128 and 256 the block has no producer warpgroup
// (256 threads, up to 255 registers each) and consumer thread 0 issues
// the loads right after its warpgroup's products. D = 128 keeps 128-key
// tiles in a three-stage ring (Q 32 KB + 3 x (32 + 32) KB; two stages and
// 64-key tiles each ran about 10% slower). At D = 256 O alone is 128
// registers, so the tiles hold 64 keys in a two-stage ring (Q 64 KB + 2 x
// (32 + 32) KB), and O += P V runs as two 128-column products a k16 step.
//
// float32 — flash_fwd_kernel, the first (FMA) version, kept because the
// tensor cores take float32 only as TF32 (about three digits), which would
// break the port's float32 checks (1e-4, and float32 greedy-token
// equality). One thread block owns (b*h, a tile of BQ = 32 query rows); a
// loop walks the K/V tiles up to the causal diagonal, each staged once in
// shared memory; four threads share a query row (eight at D = 256, each
// holding 32 of its dims, with 16-key tiles: 32 KB of static shared
// memory) and finish each dot product with warp shuffles.
//
// Numerics follow the TPU kernel on both routes: scores, m, l and the
// accumulator in float32; p is rounded to the input type before the value
// product (the TPU kernel's p.astype(v.dtype)); masked scores contribute
// exactly 0.
//
// C interface: ds_flash_fwd(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError() (or the error that stopped it
// before the launch: a misaligned pointer, a tensor map that
// cuTensorMapEncodeTiled refused).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"
#include "key_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 32;  // query rows per block

// The FMA kernel (float32). D: head dim; BK: keys per staged tile; G:
// threads that share a query row (each holds D / G of its dims). Shared
// memory is 2 * BK * D * 4 bytes = 32 KB for every instantiation (BK = 64,
// 32, 16 at D = 64, 128, 256).
template <int D, int BK, int G>
__global__ void __launch_bounds__(kBQ * G)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_mask,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Sq, int Sk, int causal, float sm_scale, int dropout,
                 uint32_t threshold, float keep, uint32_t seed) {
  constexpr int kThreads = kBQ * G;
  constexpr int kDPT = D / G;       // dims per thread (16, 32 or 32)
  constexpr int kChunks = kDPT / 4;  // float4 chunks per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ int valid_s[BK];

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int row = tid / G;
  const int g = tid % G;  // this thread's share of the row
  const int qi = qt * kBQ + row;
  const bool row_ok = qi < Sq;
  const int diag = Sk - Sq;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  // the thread's dims: float4 chunks c = g + G * i, i < kChunks (the G
  // threads of a row read 16 * G contiguous floats of a K/V row)
  float qr[kDPT];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (g + G * i) + e;
      qr[4 * i + e] = row_ok ? qb[(size_t)qi * D + d] : 0.f;
    }
  }
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const uint32_t row_key = dropout ? dropout_row_key(seed, bh, qi) : 0u;

  // keys this query tile can see (block-uniform, so every thread runs
  // the same number of tiles and reaches every barrier)
  int kend = Sk;
  if (causal) {
    const int last_q = min(qt * kBQ + kBQ - 1, Sq - 1);
    kend = min(Sk, last_q + diag + 1);
  }
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk) {
        kx = kb[(size_t)kj * D + c];
        vx = vb[(size_t)kj * D + c];
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    for (int r = tid; r < BK; r += kThreads) {
      const int kj = k0 + r;
      valid_s[r] = (kj < Sk) &&
                   (kv_mask == nullptr || kv_mask[(size_t)b * Sk + kj] != 0);
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 x = kr[g + G * i];
        part = fmaf(qr[4 * i + 0], x.x, part);
        part = fmaf(qr[4 * i + 1], x.y, part);
        part = fmaf(qr[4 * i + 2], x.z, part);
        part = fmaf(qr[4 * i + 3], x.w, part);
      }
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      const int kj = k0 + j;
      const bool ok = valid_s[j] && (!causal || kj <= qi + diag);
      const float sj = ok ? part * sm_scale : kNegInf;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // masked entries contribute exactly 0 (also when m_new is -1e30)
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      l += p;
      // the TPU kernel's where(keep, p / (1 - rate), 0)
      const float pu = !dropout                                  ? p
                       : dropout_keep(row_key, k0 + j, threshold) ? p / keep
                                                                  : 0.f;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 x = vr[g + G * i];
        acc[4 * i + 0] = fmaf(pu, x.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(pu, x.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(pu, x.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(pu, x.w, acc[4 * i + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float ld = (l == 0.f) ? 1.f : l;  // no visible key -> zeros
    float* orow = out + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[4 * (g + G * i) + e] = acc[4 * i + e] / ld;
      }
    }
    if (g == 0) lse[(size_t)bh * Sq + qi] = m + logf(ld);
  }
}

template <int D, int BK, int G>
int launch(const void* q, const void* k, const void* v, const int* kv_mask,
           void* out, float* lse, int B, int H, int Sq, int Sk, int causal,
           float sm_scale, int dropout, uint32_t threshold, float keep,
           uint32_t seed, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D, BK, G><<<grid, kBQ * G, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_mask, static_cast<float*>(out), lse,
      H, Sq, Sk, causal, sm_scale, dropout, threshold, keep, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// the tensor-core route (bfloat16, float16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;         // query rows a block owns
constexpr int kConsumers = 256;  // two warpgroups of 64 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiles by head dim. D = 64: 128-key K/V tiles in a three-stage ring,
// fed by a producer warpgroup whose registers go to the consumers (a
// 384-thread block). D = 128: O, S and P (64 + 64 + 32 float32 registers
// a thread) spilled past the 168 that ptxas gives a 384-thread block; so
// no producer warpgroup (256 threads, up to 255 registers each): consumer
// thread 0 issues the TMA loads right after its warpgroup has issued its
// products, so a wait for the other warpgroup to release a stage overlaps
// its own wgmma. 128-key tiles in a three-stage ring (Q 32 KB + 3 x
// (32 + 32) KB = 224 KB), so the loader runs two tiles ahead. D = 256: one
// K or V tile of 128 keys is 64 KB,
// and O alone is 128 registers; so 64-key tiles in a two-stage ring (Q
// 64 KB + 2 x (32 + 32) KB = 192 KB), no producer warpgroup either.
// kMaskKeys: the keys whose validity a block sorts into tiles in shared
// memory (key_tiles.cuh); D = 128 has 1.9 KB left beside its ring.
template <int D>
struct Cfg {
  static constexpr int kBN = 128;  // keys a K/V tile holds
  static constexpr int kStages = 3;
  static constexpr bool kProducer = true;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kMaskKeys = 16384;
};
template <>
struct Cfg<128> {
  static constexpr int kBN = 128;
  static constexpr int kStages = 3;
  static constexpr bool kProducer = false;
  static constexpr int kThreads = kConsumers;
  static constexpr int kMaskKeys = 8192;
};
template <>
struct Cfg<256> {
  static constexpr int kBN = 64;
  static constexpr int kStages = 2;
  static constexpr bool kProducer = false;
  static constexpr int kThreads = kConsumers;
  static constexpr int kMaskKeys = 16384;
};
// A form of the kernel: the head dim's configuration with BN keys a K/V
// tile. Cfg<D>::kBN is the default form; D = 64 and D = 128 also have a
// 64-key form (the same ring depth, half the bytes a stage), for the
// tile autotuner (ops/autotune.py) to choose between.
template <int D, int BN>
struct Tile : Cfg<D> {
  static constexpr int kBN = BN;
};

// shared memory, byte offsets from a 1024-aligned base: the Q tile, the
// K and V rings, the key tiles (key_tiles.cuh), the mbarriers (q_full,
// k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages])
template <int D, int BN>
struct Layout {
  static constexpr int kStages = Cfg<D>::kStages;
  static constexpr int kQT = kBM * D * 2;  // the Q tile
  static constexpr int kKV = BN * D * 2;   // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQT;  // stage s at kK + s * kKV
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kTiles = kV + kStages * kKV;
  using Tiles = key_tiles::Smem<BN, Cfg<D>::kMaskKeys>;
  static constexpr int kBars = kTiles + Tiles::kBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

template <typename T, int D, int BN>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const int* __restrict__ kv_mask, T* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                    float scale_log2, int dropout, uint32_t threshold,
                    float inv_keep, uint32_t seed) {
  using C = Tile<D, BN>;
  using L = Layout<D, BN>;
  constexpr int kBN = C::kBN;
  constexpr int kStages = C::kStages;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kBoxes = D / 64;  // 64-column TMA boxes per row
  // O += P V runs as kNH products of kNW columns (wgmma's n is at most
  // 128 here): O is kNH arrays of a 64 x kNW accumulator
  constexpr int kNW = D < 128 ? D : 128;
  constexpr int kNH = D / kNW;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  // the key tiles' region (key_tiles.cuh)
  uint8_t* const tiles = smem + (base - sm90::smem_addr(smem)) + L::kTiles;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full0 = q_full + 8;  // k_full[s] at k_full0 + 8 * s
  const uint32_t v_full0 = k_full0 + 8 * kStages;
  const uint32_t k_empty0 = v_full0 + 8 * kStages;
  const uint32_t v_empty0 = k_empty0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest tiles first
  const int diag = Sk - Sq;
  // keys the block's rows can see: up to the diagonal of its last row
  const int kend = causal ? min(Sk, min(q0 + kBM, Sq) + diag) : Sk;
  int ntiles = kend > 0 ? (kend + kBN - 1) / kBN : 0;
  // the batch's mask row, formed where it is used (not held in registers
  // across the loop)
  auto mask_row = [&]() { return kv_mask + (size_t)(bh / H) * Sk; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full0 + 8 * s, 1);
      sm90::mbar_init(v_full0 + 8 * s, 1);
      sm90::mbar_init(k_empty0 + 8 * s, kConsumers);
      sm90::mbar_init(v_empty0 + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // under a mask: walk only the non-empty key tiles (a row with no valid
  // key walks none and takes the epilogue's zeros)
  if (kv_mask != nullptr) {
    ntiles =
        key_tiles::prepare<kBN, C::kMaskKeys>(tiles, mask_row(), Sk, ntiles);
  }
  // walk entry t: the absolute key tile and whether it is mixed
  auto entry = [&](int t) {
    return key_tiles::entry<kBN, C::kMaskKeys>(tiles, kv_mask != nullptr, t);
  };

  // The TMA loads, each issued by one thread: the block's Q tile, and the
  // K (or V) tile of walk entry j into ring stage j % kStages once every
  // consumer has released what the stage held. K and V are released apart: K when its
  // S has completed, V when its P V has.
  auto load_q = [&]() {
    sm90::mbar_arrive_tx(q_full, L::kQT);
    for (int c = 0; c < kBoxes; ++c) {
      sm90::tma_load(base + L::kQ + c * kBM * 128, &tm_q, q_full, 64 * c, q0,
                     bh);
    }
  };
  auto load_kv = [&](const CUtensorMap* map, int ring, uint32_t full0,
                     uint32_t empty0, int j) {
    const int s = j % kStages;
    sm90::mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    sm90::mbar_arrive_tx(full, L::kKV);
    for (int c = 0; c < kBoxes; ++c) {
      sm90::tma_load(base + ring + s * L::kKV + c * kBN * 128, map, full,
                     64 * c, key_tiles::tile_of(entry(j)) * kBN, bh);
    }
  };
  auto load_k = [&](int j) { load_kv(&tm_k, L::kK, k_full0, k_empty0, j); };
  auto load_v = [&](int j) { load_kv(&tm_v, L::kV, v_full0, v_empty0, j); };

  if constexpr (C::kProducer) {
    if (tid >= kConsumers) {  // the producer warpgroup: one thread loads
      sm90::setmaxnreg_dec<24>();
      if (tid == kConsumers && ntiles > 0) {
        load_q();
        for (int t = 0; t < ntiles; ++t) {
          load_k(t);
          load_v(t);
        }
      }
      return;
    }
    sm90::setmaxnreg_inc<240>();
  } else if (tid == 0 && ntiles > 0) {
    load_q();
    for (int j = 0; j < kStages - 1 && j < ntiles; ++j) {
      load_k(j);
      load_v(j);
    }
  }
  // the consumer thread that issues the ring's loads (none where a
  // producer warpgroup does)
  const bool loader = !C::kProducer && tid == 0;

  // a consumer warpgroup: rows r0 .. r0 + 63; this thread holds rows
  // row0 and row0 + 8, columns 8 j + col_off + {0, 1} of each tile
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r0 = q0 + 64 * wg;
  const int row0 = r0 + 16 * ((tid % 128) / 32) + lane / 4;
  const int col_off = 2 * (lane % 4);

  float o[kNH][kNW / 2];
#pragma unroll
  for (int n = 0; n < kNH; ++n) {
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) o[n][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the normaliser
  uint32_t rkey[2] = {0u, 0u};
  if (dropout) {
    rkey[0] = dropout_row_key(seed, bh, row0);
    rkey[1] = dropout_row_key(seed, bh, row0 + 8);
  }
  const uint32_t q_tile = base + L::kQ + wg * 64 * 128;

  float sc[kBN / 2];          // S of the current tile, then its P
  uint32_t pa[kBN / 16][4];   // P of the previous tile, as A fragments
  float alpha[2];

  // S = Q K^T of tile t, 64 x kBN float32, issued (not waited for)
  auto issue_s = [&](int t) {
    const uint32_t k_tile = base + L::kK + (t % kStages) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBM * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBN * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBN, kHalf>::ss(sc, sm90::desc_k(q_tile + a_off),
                                  sm90::desc_k(k_tile + b_off), kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V of tile t (P from pa), issued; product n writes columns
  // n * kNW .. + kNW - 1, which start kNW / 64 boxes into the V tile
  auto issue_pv = [&](int t) {
    const uint32_t v_tile = base + L::kV + (t % kStages) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kNH; ++n) {
        const uint32_t box = n * (kNW / 64) * kBN * 128;
        sm90::Wgmma<kNW, kHalf>::rs(
            o[n], pa[kk], sm90::desc_mn(v_tile + box + 2048 * kk, kBN * 128),
            1);
      }
    }
    sm90::wgmma_commit();
  };
  // the masks (only on the tiles that need them: a mixed tile, the
  // ragged edge, the causal diagonal) and the online softmax of walk entry
  // t in the exp2 domain: sc becomes the dropped P; m, alpha and the
  // undropped row sums (into lsum) advance. A row that has seen no key yet
  // keeps m = -inf and takes mu = 0, so its masked entries give
  // exp2(-inf) = 0.
  float lsum[2];
  auto softmax = [&](int t) {
    const uint32_t e = entry(t);
    const int k0 = key_tiles::tile_of(e) * kBN;
    const bool mixed = key_tiles::is_mixed(e);
    // compiled twice: with the key mask (a mixed tile) and without, so
    // that the mask's ballots and branches stay out of the other tiles'
    // code
    auto mask = [&](auto key_mask) {
      constexpr bool kKeyMask = decltype(key_mask)::value;
      uint32_t word = ~0u;  // the key validity of columns 32 w .. + 31
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        if constexpr (kKeyMask) {
          if (i % 16 == 0) {
            word = key_tiles::tile_word<kBN, C::kMaskKeys>(
                tiles, mask_row(), Sk, k0 / kBN, i / 16);
          }
        }
        const int col = k0 + 8 * (i / 4) + col_off + (i % 2);
        const int row = row0 + 8 * ((i % 4) / 2);
        bool ok = col < Sk && (!causal || col <= row + diag);
        if constexpr (kKeyMask) {
          // the key's bit in word i / 16: 8 ((i / 4) % 4) + col_off + i % 2
          ok = ok && ((word >> (8 * ((i / 4) % 4) + col_off + (i % 2))) & 1u);
        }
        if (!ok) sc[i] = -INFINITY;
      }
    };
    if (mixed) {
      mask(std::true_type{});
    } else if (k0 + kBN > Sk || (causal && k0 + kBN - 1 > r0 + diag)) {
      mask(std::false_type{});
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      mu[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = sm90::exp2_approx(m[h] - mu[h]);
      m[h] = m_new;
      lsum[h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int h = (i % 4) / 2;
      float p = sm90::exp2_approx(fmaf(sc[i], scale_log2, -mu[h]));
      lsum[h] += p;  // l from the undropped p
      if (dropout) {
        const int col = k0 + 8 * (i / 4) + col_off + (i % 2);
        p = dropout_keep(rkey[h], col, threshold) ? p * inv_keep : 0.f;
      }
      sc[i] = p;
    }
  };
  // P rounded to T as the A fragments of the next O += P V
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      sm90::to_a_frag<T>(sc, kk, pa[kk]);
      sm90::fence_regs(pa[kk]);
    }
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int n = 0; n < kNH; ++n) sm90::fence_regs(o[n]);
  };

  // Software pipeline within the warpgroup: S of tile t is issued with
  // P V of tile t - 1, and the softmax of tile t runs while that P V is
  // on the tensor cores. Without a producer, the loader refills the ring
  // right after the issue: K of tile t + kStages - 1 into the stage K of
  // t - 1 left, V of tile t + kStages - 2 into the stage V of t - 2 left
  // (both released in the previous step), so each load has kStages - 1
  // steps to land.
  if (ntiles > 0) {
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(k_full0, 0);
    sm90::wgmma_fence();
    issue_s(0);
    if (loader && kStages - 1 < ntiles) load_k(kStages - 1);
    __syncwarp();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::mbar_arrive(k_empty0);
    softmax(0);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = lsum[h];
    pack_p();
  }
  for (int t = 1; t < ntiles; ++t) {
    sm90::mbar_wait(k_full0 + 8 * (t % kStages), (t / kStages) & 1);
    sm90::mbar_wait(v_full0 + 8 * ((t - 1) % kStages),
                    ((t - 1) / kStages) & 1);
    fence_o();
    sm90::wgmma_fence();
    issue_s(t);
    issue_pv(t - 1);
    if (loader) {
      if (t + kStages - 1 < ntiles) load_k(t + kStages - 1);
      if (t + kStages - 2 < ntiles) load_v(t + kStages - 2);
    }
    __syncwarp();
    sm90::wgmma_wait<1>();  // S of tile t is done
    sm90::fence_regs(sc);
    sm90::mbar_arrive(k_empty0 + 8 * (t % kStages));
    softmax(t);
    sm90::wgmma_wait<0>();  // P V of tile t - 1 is done
    fence_o();
    sm90::mbar_arrive(v_empty0 + 8 * ((t - 1) % kStages));
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + lsum[h];
#pragma unroll
    for (int n = 0; n < kNH; ++n) {
#pragma unroll
      for (int i = 0; i < kNW / 2; ++i) o[n][i] *= alpha[(i % 4) / 2];
    }
    pack_p();
  }
  if (ntiles > 0) {
    const int t = ntiles - 1;
    sm90::mbar_wait(v_full0 + 8 * (t % kStages), (t / kStages) & 1);
    fence_o();
    sm90::wgmma_fence();
    issue_pv(t);
    sm90::wgmma_wait<0>();
    fence_o();
    sm90::mbar_arrive(v_empty0 + 8 * (t % kStages));
  }

  // epilogue: out = O / l in T, lse in natural-log units; a row with no
  // visible key gives exact zeros and lse = -1e30 (as the plain version)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float inv = lh > 0.f ? 1.f / lh : 1.f;
    T* orow = out + ((size_t)bh * Sq + row) * D + col_off;
#pragma unroll
    for (int n = 0; n < kNH; ++n) {
#pragma unroll
      for (int j = 0; j < kNW / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + n * kNW + 8 * j) =
            sm90::pack2<T>(o[n][4 * j + 2 * h] * inv,
                           o[n][4 * j + 2 * h + 1] * inv);
      }
    }
    if (lane % 4 == 0) {
      lse[(size_t)bh * Sq + row] =
          lh > 0.f ? (m[h] + log2f(lh)) * kLn2 : -1e30f;
    }
  }
}

template <typename T, int D, int BN>
int launch(const void* q, const void* k, const void* v, const int* kv_mask,
           void* out, float* lse, int B, int H, int Sq, int Sk, int dtype,
           int causal, float sm_scale, int dropout, uint32_t threshold,
           float keep, uint32_t seed, cudaStream_t stream) {
  using C = Tile<D, BN>;
  using L = Layout<D, BN>;
  CUtensorMap tq, tk, tv;
  int err = sm90::make_map(&tq, q, dtype, B * H, Sq, D, kBM);
  if (err == 0) err = sm90::make_map(&tk, k, dtype, B * H, Sk, D, C::kBN);
  if (err == 0) err = sm90::make_map(&tv, v, dtype, B * H, Sk, D, C::kBN);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<T, D, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_fwd_kernel_tc<T, D, BN><<<grid, C::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, kv_mask, static_cast<T*>(out), lse, H, Sq, Sk, causal,
      sm_scale * kLog2e, dropout, threshold, 1.f / keep, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 float32 (the FMA kernel), 1 bfloat16, 2 float16 (the
// tensor-core kernel). D must be 64, 128 or 256 (the wrapper checks).
// dropout: 0 off; else keep a pair when its bits >= threshold and divide
// the kept probabilities by keep = 1 - rate. block_k: the keys a K/V tile
// holds, 0 for the head dim's default form; the tensor-core kernel also
// has 64 at D = 64 and 128, the FMA kernel only its one tile (64, 32, 16
// keys at D = 64, 128, 256). Any other value returns cudaErrorInvalidValue.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const int* kv_mask, void* out, float* lse, int B,
                            int H, int Sq, int Sk, int D, int dtype,
                            int causal, float sm_scale, int dropout,
                            unsigned int threshold, float keep,
                            unsigned int seed, int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B * H <= 0) return static_cast<int>(cudaGetLastError());
#define DS_FLASH_FWD_TC(T, DIM, BN)                                        \
  if (D == DIM && block_k == BN)                                           \
  return tc::launch<T, DIM, BN>(q, k, v, kv_mask, out, lse, B, H, Sq, Sk, \
                                dtype, causal, sm_scale, dropout, threshold, \
                                keep, seed, s)
#define DS_FLASH_FWD_TC_FORMS(T)  \
  DS_FLASH_FWD_TC(T, 64, 128);    \
  DS_FLASH_FWD_TC(T, 64, 64);     \
  DS_FLASH_FWD_TC(T, 128, 128);   \
  DS_FLASH_FWD_TC(T, 128, 64);    \
  DS_FLASH_FWD_TC(T, 256, 64)
  if (dtype == 1 || dtype == 2) {
    if (block_k == 0) block_k = D == 256 ? tc::Cfg<256>::kBN : 128;
    if (dtype == 1) {
      DS_FLASH_FWD_TC_FORMS(__nv_bfloat16);
    } else {
      DS_FLASH_FWD_TC_FORMS(__half);
    }
  }
#undef DS_FLASH_FWD_TC_FORMS
#undef DS_FLASH_FWD_TC
#define DS_FLASH_FWD_FMA(DIM, BK, G)                                    \
  if (D == DIM && (block_k == 0 || block_k == BK))                      \
  return launch<DIM, BK, G>(q, k, v, kv_mask, out, lse, B, H, Sq, Sk,   \
                            causal, sm_scale, dropout, threshold, keep, \
                            seed, s)
  if (dtype == 0) {
    DS_FLASH_FWD_FMA(64, 64, 4);
    DS_FLASH_FWD_FMA(128, 32, 4);
    DS_FLASH_FWD_FMA(256, 16, 8);
  }
#undef DS_FLASH_FWD_FMA
  return static_cast<int>(cudaErrorInvalidValue);
}
