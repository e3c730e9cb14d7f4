// flash_bwd.cu — flash-attention backward, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/attention.py, the Pallas kernels
// _bwd_dq_kernel and _bwd_dkv_kernel (both launched by _flash_bwd). Same
// function: with the forward's lse per row and delta = rowsum(dO * O)
// (computed beside the kernels, as the JAX package leaves it to XLA),
//   p  = exp(s - lse) on visible pairs, 0 elsewhere   (s = q k^T * scale)
//   dp = dO v^T, dropped with the forward's mask and divided by (1 - rate)
//   ds = p * (dp - delta)
//   dQ = scale * ds K,   dK = scale * ds^T Q,   dV = p_drop^T dO
// under the same causal mask (aligned bottom-right), per-key validity
// vector and dropout mask (dropout.cuh) as flash_fwd.cu. Operands are
// rounded to the storage type before each product, as the Pallas kernels
// do (p_drop.astype(do.dtype), ds.astype(q.dtype)); every sum is float32.
//
// What bounds it on the H100: at the GPT-2 small training shape (B=8,
// H=12, S=1024, D=64, causal, bf16) the backward needs 5 products of 2*D
// flops per visible (query, key) pair (s, dp, dQ, dK, dV), 32 GFLOP, 33 us
// of tensor-core time, against 88 MB of q, k, v, dO, lse, delta read and
// dQ, dK, dV written, 26 us of HBM time: operations bound it, narrowly.
// (Split in two kernels, s and dp are formed by both: 7 products.)
//
// No kernel here uses atomics: each output element is summed by one thread
// in a fixed order, so the results are the same bit for bit from run to
// run.
//
// dK/dV, bfloat16 and float16 — flash_bwd_dkv_kernel_tc, the tensor-core
// kernel (FA3's structure without dQ), at D = 64, 128 and 256. A block owns
// 128 keys of one (batch, head): two consumer warpgroups of 64 keys each.
// The block's K and V tiles are loaded once by TMA, then tiles of Q and dO
// (3-D tensor maps, zero-filled past S) stream through a ring, starting at
// the first query tile that can see the key tile, and one warp stages each
// tile's lse (in log2 units), delta and dropout row keys beside them. Each
// consumer forms S^T = K Q^T and dP^T = V dO^T with wgmma from shared
// memory (all K-major), computes P^T = exp(S^T - lse), the dropout and
// dS^T = P^T (dP^T - delta) in float32 registers (masks only on the tiles
// that need them), rounds P_drop^T and dS^T to the storage type in
// registers and accumulates dV += P_drop^T dO and dK += dS^T Q with them
// as the register A operand and dO, Q read MN-major from the same ring
// tiles. dK is scaled by `scale` in the epilogue. Under a key mask the
// block first learns how its 128 keys stand (two block votes): all masked,
// it walks no query tile and writes zero dK and dV; all valid, it takes the
// mask-free path; else each thread masks with its keys' validity, held in
// registers. The tiles depend on the
// head dim (tc::DkvCfg): at D = 64, 64-query tiles in a two-stage ring fed
// by a producer warpgroup (setmaxnreg 24 / 240). At D = 128 a thread's dK
// and dV are 128 float32 registers, past the 168 that ptxas gives a
// 384-thread block: the block has no producer warpgroup (256 threads, up
// to 255 registers each), consumer warp 0 loads the ring right after its
// warpgroup has issued its products, 32-query tiles stream through four
// stages, and tile t's S^T and dP^T go to the tensor cores ahead of tile
// t - 1's dK/dV products, which then run under tile t's softmax. At
// D = 256 dK or dV alone is 128 registers: a block accumulates one of
// them (two passes over the key tile, blockIdx.z 0 dK and 1 dV; the dV
// pass forms no dP^T and loads no V), S^T is formed in both (5 products
// of 2*D flops a visible pair instead of 4), and each product over D runs
// as two 128-column wgmmas a k16 step.
//
// dQ, bfloat16 and float16 — flash_bwd_dq_kernel_tc, the same structure
// turned around (the forward's shape), at D = 64, 128 and 256. A block
// owns 128 query rows of one (batch, head): two consumer warpgroups of 64
// rows each. The block's Q and dO tiles are loaded once by TMA, then K and
// V tiles stream through a ring from key tile 0 up to the causal
// diagonal. Each consumer thread computes the lse (log2 units), delta and
// dropout row key of its two rows once and keeps them in shared memory,
// since registers are the scarcer. Per key tile it forms S = Q K^T and
// dP = dO V^T with wgmma from shared memory (both K-major), computes
// P = exp2(S scale log2 e - lse), the masks (only on the tiles that need
// them), the dropout of dP and
// dS = P (dP - delta) in float32 registers, rounds dS to the storage type
// as the register A operand (the Pallas kernel's ds.astype(k.dtype)) and
// accumulates dQ += dS K with K read MN-major from the same ring tile.
// The epilogue scales by `scale` and stores in T. Query tiles are issued
// heaviest first. The tiles depend on the head dim (tc::DqCfg): at D = 64
// and 128, 64-key tiles in a two-stage ring fed by a producer warpgroup
// (setmaxnreg 24 / 240; ptxas holds a 384-thread block to 168 registers
// a thread, whatever setmaxnreg gives the consumers at run time, and 128
// keys at D = 64 spilled S, dP and dQ and serialised the wgmmas). At
// D = 256 dQ alone is 128 float32 registers a thread: the block has no
// producer warpgroup (256 threads, up to 255 registers each), consumer
// thread 0 issues the loads, the tiles hold 32 keys in a three-stage
// ring, and dQ += dS K runs as two 128-column products a k16 step. Under
// a key mask the block sorts its key tiles as the forward does
// (key_tiles.cuh) and walks only the non-empty ones, a mixed tile's
// validity read from shared memory (at D = 64 and 128 staged there by the
// producer's first warp, as the length's always is).
//
// dQ and dK/dV in float32 — flash_bwd_dq_kernel and flash_bwd_dkv_kernel,
// the first (FMA) versions (the tensor cores take float32 only as TF32,
// about three digits, which would break the port's float32 checks at
// 1e-4). The dQ kernel gives one thread block to (bh, a tile of 32 query
// rows) and loops over the key tiles up to the causal diagonal; the dK/dV
// kernel gives one block to (bh, a tile of 32 key rows) and loops over the
// query tiles from the diagonal on. In both, the loop's other operand is
// staged in shared memory, four threads share a row and hold a quarter of
// its vectors and accumulators in registers, and each dot product closes
// with two warp shuffles. Causal tiles are issued heaviest first.
//
// At head dim 256 the FMA kernels take eight threads a row (32 of its
// dims each, so dK/dV's four row vectors fit in registers) and stage 16
// rows a tile (32 KB of static shared memory): simple kernels that are
// right, bound by their FMAs.
//
// C interface: ds_flash_bwd_dq(...) and ds_flash_bwd_dkv(...) launch on the
// given stream, allocate nothing, and return cudaGetLastError() (or the
// error that stopped them before the launch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"
#include "key_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 32;  // rows a block owns

// The FMA kernels (float32). G: threads that share a row, each holding
// the float4 chunks c = g + G * i of its D-vectors.

template <int D, int G>
__device__ __forceinline__ void load_share(const float* row, bool ok, int g,
                                           float* out) {
#pragma unroll
  for (int i = 0; i < D / G / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[4 * i + e] = ok ? row[4 * (g + G * i) + e] : 0.f;
    }
  }
}

template <int D, int G>
__device__ __forceinline__ float dot_share(const float* mine,
                                           const float* shared_row, int g) {
  const float4* r = reinterpret_cast<const float4*>(shared_row);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / G / 4; ++i) {
    const float4 x = r[g + G * i];
    part = fmaf(mine[4 * i + 0], x.x, part);
    part = fmaf(mine[4 * i + 1], x.y, part);
    part = fmaf(mine[4 * i + 2], x.z, part);
    part = fmaf(mine[4 * i + 3], x.w, part);
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, o);
  }
  return part;
}

template <int D, int G>
__device__ __forceinline__ void axpy_share(float a, const float* shared_row,
                                           int g, float* acc) {
  const float4* r = reinterpret_cast<const float4*>(shared_row);
#pragma unroll
  for (int i = 0; i < D / G / 4; ++i) {
    const float4 x = r[g + G * i];
    acc[4 * i + 0] = fmaf(a, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
  }
}

template <int D, int G>
__device__ __forceinline__ void store_share(float* row, int g, float scale,
                                            const float* acc) {
#pragma unroll
  for (int i = 0; i < D / G / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      row[4 * (g + G * i) + e] = acc[4 * i + e] * scale;
    }
  }
}

// dQ: one block per (bh, query tile); BK keys staged per step.
template <int D, int BK, int G>
__global__ void __launch_bounds__(kRows * G)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ kv_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H,
                    int Sq, int Sk, int causal, float sm_scale, int dropout,
                    uint32_t threshold, float keep, uint32_t seed) {
  constexpr int kThreads = kRows * G;
  constexpr int kDPT = D / G;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ int valid_s[BK];

  const int nq = (Sq + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qi = qt * kRows + tid / G;
  const bool row_ok = qi < Sq;
  const int diag = Sk - Sq;

  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  float qr[kDPT], dor[kDPT], acc[kDPT];
  load_share<D, G>(q + ((size_t)bh * Sq + qi) * D, row_ok, g, qr);
  load_share<D, G>(dout + ((size_t)bh * Sq + qi) * D, row_ok, g, dor);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;
  const float lse_i = row_ok ? lse[(size_t)bh * Sq + qi] : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * Sq + qi] : 0.f;
  const uint32_t row_key = dropout ? dropout_row_key(seed, bh, qi) : 0u;

  int kend = Sk;
  if (causal) {
    const int last_q = min(qt * kRows + kRows - 1, Sq - 1);
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
      ks[r][c] = kj < Sk ? kb[(size_t)kj * D + c] : 0.f;
      vs[r][c] = kj < Sk ? vb[(size_t)kj * D + c] : 0.f;
    }
    for (int r = tid; r < BK; r += kThreads) {
      const int kj = k0 + r;
      valid_s[r] = (kj < Sk) &&
                   (kv_mask == nullptr || kv_mask[(size_t)b * Sk + kj] != 0);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float s = dot_share<D, G>(qr, &ks[j][0], g) * sm_scale;
      float dp = dot_share<D, G>(dor, &vs[j][0], g);
      const int kj = k0 + j;
      const bool ok = row_ok && valid_s[j] && (!causal || kj <= qi + diag);
      const float p = ok ? expf(s - lse_i) : 0.f;
      if (dropout) {
        dp = dropout_keep(row_key, kj, threshold) ? dp / keep : 0.f;
      }
      axpy_share<D, G>(p * (dp - delta_i), &ks[j][0], g, acc);
    }
  }
  if (row_ok) {
    store_share<D, G>(dq + ((size_t)bh * Sq + qi) * D, g, sm_scale, acc);
  }
}

// dK, dV: one block per (bh, key tile); BQ queries staged per step.
template <int D, int BQ, int G>
__global__ void __launch_bounds__(kRows * G)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ kv_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float sm_scale, int dropout, uint32_t threshold,
                     float keep, uint32_t seed) {
  constexpr int kThreads = kRows * G;
  constexpr int kDPT = D / G;
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float dos[BQ][D];
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ uint32_t key_s[BQ];  // the rows' dropout keys

  const int kt = blockIdx.x;  // low key tiles see the most queries
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int kj = kt * kRows + tid / G;
  const int diag = Sk - Sq;
  const bool key_ok =
      kj < Sk && (kv_mask == nullptr || kv_mask[(size_t)b * Sk + kj] != 0);

  const float* qb = q + (size_t)bh * Sq * D;
  const float* db = dout + (size_t)bh * Sq * D;
  float kr[kDPT], vr[kDPT], acc_k[kDPT], acc_v[kDPT];
  load_share<D, G>(k + ((size_t)bh * Sk + kj) * D, kj < Sk, g, kr);
  load_share<D, G>(v + ((size_t)bh * Sk + kj) * D, kj < Sk, g, vr);
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  // queries that can see this key tile (block-uniform): qi >= kj - diag
  int qbegin = 0;
  if (causal) qbegin = max(0, kt * kRows - diag);
  const int t0 = qbegin / BQ;
  const int ntiles = (Sq + BQ - 1) / BQ;

  for (int t = t0; t < ntiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BQ * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int qi = q0 + r;
      qs[r][c] = qi < Sq ? qb[(size_t)qi * D + c] : 0.f;
      dos[r][c] = qi < Sq ? db[(size_t)qi * D + c] : 0.f;
    }
    for (int r = tid; r < BQ; r += kThreads) {
      const int qi = q0 + r;
      lse_s[r] = qi < Sq ? lse[(size_t)bh * Sq + qi] : 0.f;
      delta_s[r] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
      key_s[r] = dropout ? dropout_row_key(seed, bh, qi) : 0u;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float s = dot_share<D, G>(kr, &qs[i][0], g) * sm_scale;
      float dp = dot_share<D, G>(vr, &dos[i][0], g);
      const int qi = q0 + i;
      const bool ok = key_ok && qi < Sq && (!causal || kj <= qi + diag);
      const float p = ok ? expf(s - lse_s[i]) : 0.f;
      float p_drop = p;
      if (dropout) {
        if (dropout_keep(key_s[i], kj, threshold)) {
          p_drop = p / keep;
          dp = dp / keep;
        } else {
          p_drop = 0.f;
          dp = 0.f;
        }
      }
      axpy_share<D, G>(p_drop, &dos[i][0], g, acc_v);
      axpy_share<D, G>(p * (dp - delta_s[i]), &qs[i][0], g, acc_k);
    }
  }
  if (kj < Sk) {
    store_share<D, G>(dk + ((size_t)bh * Sk + kj) * D, g, sm_scale, acc_k);
    store_share<D, G>(dv + ((size_t)bh * Sk + kj) * D, g, 1.f, acc_v);
  }
}

template <int D, int BS, int G>
int launch_dq(const void* q, const void* k, const void* v, const int* kv_mask,
              const void* dout, const float* lse, const float* delta,
              void* dq, int B, int H, int Sq, int Sk, int causal,
              float sm_scale, int dropout, uint32_t threshold, float keep,
              uint32_t seed, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D, BS, G><<<grid, kRows * G, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), H, Sq, Sk, causal, sm_scale,
      dropout, threshold, keep, seed);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BS, int G>
int launch_dkv(const void* q, const void* k, const void* v,
               const int* kv_mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq,
               int Sk, int causal, float sm_scale, int dropout,
               uint32_t threshold, float keep, uint32_t seed,
               cudaStream_t stream) {
  const dim3 grid((Sk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<D, BS, G><<<grid, kRows * G, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
      causal, sm_scale, dropout, threshold, keep, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// dK/dV on the tensor cores (bfloat16, float16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBN = 128;         // keys a dK/dV block owns
constexpr int kBM = 128;         // query rows a dQ block owns
constexpr int kConsumers = 256;  // two warpgroups of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV's tiles by head dim. D = 64: 64-query Q/dO tiles in a two-stage
// ring fed by a producer warpgroup (a 384-thread block; ptxas holds its
// threads to 168 registers, whatever setmaxnreg gives the consumers at
// run time). D = 128: a thread's dK and dV are 2 x 64 float32 registers,
// which spilled in that block, so the block has no producer warpgroup (256
// threads, up to 255 registers each), 32-query tiles (S^T and dP^T 16
// registers each) and a four-stage ring that consumer warp 0 fills; tile
// t's S^T and dP^T are issued ahead of tile t - 1's dK/dV products, which
// run under tile t's softmax (kOverlap; 248 registers). D = 256: dK or dV
// alone is 128 registers, so a block accumulates one of them (two passes
// over the same key tile, blockIdx.z 0 dK and 1 dV, each forming S^T) in
// the D = 128 block shape; K and V 64 KB each and three stages of Q and dO
// (16 KB each) fill 224 KB. The overlapped schedule spilled there (255
// registers) and gained 1%, so each tile's products run in turn.
template <int D>
struct DkvCfg {
  static constexpr int kBQ = 64;  // queries a ring stage holds
  static constexpr int kStages = 2;
  static constexpr bool kProducer = true;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kPasses = 1;
  static constexpr bool kOverlap = false;
};
template <>
struct DkvCfg<128> {
  static constexpr int kBQ = 32;
  static constexpr int kStages = 4;
  static constexpr bool kProducer = false;
  static constexpr int kThreads = kConsumers;
  static constexpr int kPasses = 1;
  static constexpr bool kOverlap = true;
};
template <>
struct DkvCfg<256> {
  static constexpr int kBQ = 32;
  static constexpr int kStages = 3;
  static constexpr bool kProducer = false;
  static constexpr int kThreads = kConsumers;
  static constexpr int kPasses = 2;
  static constexpr bool kOverlap = false;
};

// shared memory, byte offsets from a 1024-aligned base: the K and V
// tiles, the Q and dO rings, each stage's row data (lse in log2 units,
// delta, dropout row key: kBQ 4-byte values each), the mbarriers
// (kv_full, full[kStages], empty[kStages]), how the block's keys stand
template <int D>
struct Layout {
  static constexpr int kBQ = DkvCfg<D>::kBQ;
  static constexpr int kStages = DkvCfg<D>::kStages;
  static constexpr int kKV = kBN * D * 2;  // the K (or V) tile
  static constexpr int kQT = kBQ * D * 2;  // a Q (or dO) tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;  // stage s at kQ + s * kQT
  static constexpr int kDO = kQ + kStages * kQT;
  static constexpr int kRows = kDO + kStages * kQT;
  static constexpr int kRowBytes = 3 * kBQ * 4;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  static constexpr int kKeys = kBars + 8 * (1 + 2 * kStages);  // block_keys
  static constexpr int kBytes = kKeys + 8 + 1024;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

// Under a key mask, how the block's kBN keys stand (every thread of the
// block calls it): kKeysNone, no key valid (the block walks no query tile
// and writes zero dK and dV); kKeysAll, every key below Sk valid (the
// mask-free path); kKeysSome, the rest (each thread masks with its keys'
// validity, held in registers). Under a mask also written to shared
// memory at `at`, where the loop reads it (no register held across it).
constexpr int kKeysNone = 0;
constexpr int kKeysAll = 1;
constexpr int kKeysSome = 2;
__device__ __forceinline__ int block_keys(const int* __restrict__ kv_mask,
                                          int bh, int H, int Sk, int k0,
                                          int* at) {
  if (kv_mask == nullptr) return kKeysAll;
  const int key = k0 + static_cast<int>(threadIdx.x);
  const bool in = threadIdx.x < kBN && key < Sk;
  const bool ok = in && kv_mask[(size_t)(bh / H) * Sk + key] != 0;
  const int keys = !__syncthreads_or(ok)          ? kKeysNone
                   : __syncthreads_and(ok || !in) ? kKeysAll
                                                  : kKeysSome;
  if (threadIdx.x == 0) *at = keys;
  __syncthreads();
  return keys;
}

// D = 64: two consumer warpgroups of 64 keys and a producer warpgroup,
// whose registers go to the consumers (setmaxnreg 24 / 240).
template <typename T, int D>
__device__ __forceinline__ void dkv_producer_form(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const CUtensorMap& tm_do,
    const int* __restrict__ kv_mask, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Sq, int Sk, int causal, float sm_scale, float scale_log2,
    int dropout, uint32_t threshold, float inv_keep, uint32_t seed) {
  using L = Layout<D>;
  constexpr int kBQ = L::kBQ;
  constexpr int kStages = L::kStages;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kBoxes = D / 64;  // 64-column TMA boxes per row
  extern __shared__ uint8_t smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  uint8_t* const sbase = smem + (base - sm90::smem_addr(smem));
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full0 = kv_full + 8;  // full[s] at full0 + 8 * s
  const uint32_t empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBN;  // low key tiles see the most queries
  const int diag = Sk - Sq;
  // the first query tile that can see the key tile: qi >= k0 - diag
  const int t0 = causal ? max(0, k0 - diag) / kBQ : 0;
  int nt = (Sq + kBQ - 1) / kBQ;

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival and the 32 lanes that stage the rows
      sm90::mbar_init(full0 + 8 * s, 33);
      sm90::mbar_init(empty0 + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (block_keys(kv_mask, bh, H, Sk, k0,
                 reinterpret_cast<int*>(sbase + L::kKeys)) == kKeysNone) {
    nt = t0;  // no load, no wait: zeros out
  }
  // whether the block's keys are partly masked, read where it is needed
  auto keys_some = [&]() {
    return kv_mask != nullptr &&
           *reinterpret_cast<const int*>(sbase + L::kKeys) == kKeysSome;
  };

  if (tid >= kConsumers) {  // the producer warpgroup: its first warp works
    sm90::setmaxnreg_dec<24>();
    const int lane = tid - kConsumers;
    if (lane >= 32) return;
    if (lane == 0 && t0 < nt) {
      sm90::mbar_arrive_tx(kv_full, 2 * L::kKV);
      for (int c = 0; c < kBoxes; ++c) {
        const uint32_t off = c * kBN * 128;
        sm90::tma_load(base + L::kK + off, &tm_k, kv_full, 64 * c, k0, bh);
        sm90::tma_load(base + L::kV + off, &tm_v, kv_full, 64 * c, k0, bh);
      }
    }
    for (int t = t0; t < nt; ++t) {
      const int i = t - t0;
      const int s = i % kStages;
      sm90::mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        sm90::mbar_arrive_tx(full, 2 * L::kQT);
        for (int c = 0; c < kBoxes; ++c) {
          const uint32_t off = s * L::kQT + c * kBQ * 128;
          sm90::tma_load(base + L::kQ + off, &tm_q, full, 64 * c, t * kBQ, bh);
          sm90::tma_load(base + L::kDO + off, &tm_do, full, 64 * c, t * kBQ,
                         bh);
        }
      }
      float* rows = reinterpret_cast<float*>(sbase + L::kRows +
                                             s * L::kRowBytes);
      for (int r = lane; r < kBQ; r += 32) {
        const int qi = t * kBQ + r;
        const bool in = qi < Sq;
        rows[r] = in ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
        rows[kBQ + r] = in ? delta[(size_t)bh * Sq + qi] : 0.f;
        reinterpret_cast<uint32_t*>(rows)[2 * kBQ + r] =
            dropout ? dropout_row_key(seed, bh, qi) : 0u;
      }
      sm90::mbar_arrive(full);
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();

  // a consumer warpgroup: keys kw0 .. kw0 + 63; this thread holds keys
  // key0 and key0 + 8 (rows of S^T), queries 8 j + col_off + {0, 1} of
  // each tile (its columns)
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * ((tid % 128) / 32) + lane / 4;
  const int col_off = 2 * (lane % 4);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    key_ok[h] = key < Sk &&
                (kv_mask == nullptr || kv_mask[(size_t)(bh / H) * Sk + key] != 0);
  }

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  const uint32_t k_rows = base + L::kK + wg * 64 * 128;
  const uint32_t v_rows = base + L::kV + wg * 64 * 128;
  if (t0 < nt) sm90::mbar_wait(kv_full, 0);
  for (int t = t0; t < nt; ++t) {
    const int i = t - t0;
    const int s = i % kStages;
    const int q0 = t * kBQ;
    sm90::mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    const uint32_t q_tile = base + L::kQ + s * L::kQT;
    const uint32_t do_tile = base + L::kDO + s * L::kQT;
    const float* lse2_s =
        reinterpret_cast<const float*>(sbase + L::kRows + s * L::kRowBytes);
    const float* delta_s = lse2_s + kBQ;
    const uint32_t* key_s = reinterpret_cast<const uint32_t*>(lse2_s) + 2 * kBQ;

    // S^T = K Q^T and dP^T = V dO^T, 64 x kBQ each, float32
    float st[kBQ / 2], dpt[kBQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBN * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBQ * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBQ, kHalf>::ss(st, sm90::desc_k(k_rows + a_off),
                                  sm90::desc_k(q_tile + b_off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBN * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBQ * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBQ, kHalf>::ss(dpt, sm90::desc_k(v_rows + a_off),
                                  sm90::desc_k(do_tile + b_off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T, dropout, dS^T; masks only on the tiles that need them: keys
    // of the block masked, the ragged edge, the causal diagonal (a tile
    // that needs none holds no row without a visible key, so its lse is
    // finite)
    const bool need_mask = keys_some() || q0 + kBQ > Sq ||
                           (causal && kw0 + 63 > q0 + diag);
#pragma unroll
    for (int j = 0; j < kBQ / 2; ++j) {
      const int h = (j % 4) / 2;
      const int r = 8 * (j / 4) + col_off + (j % 2);  // query in the tile
      const int key = key0 + 8 * h;
      float p = sm90::exp2_approx(fmaf(st[j], scale_log2, -lse2_s[r]));
      if (need_mask) {
        const int qi = q0 + r;
        if (!(key_ok[h] && qi < Sq && (!causal || key <= qi + diag))) p = 0.f;
      }
      float dp = dpt[j];
      float p_drop = p;
      if (dropout) {
        const bool keep = dropout_keep(key_s[r], key, threshold);
        p_drop = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      st[j] = p_drop;
      dpt[j] = p * (dp - delta_s[r]);
    }

    // dV += P_drop^T dO, dK += dS^T Q: A from registers, B MN-major
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      sm90::to_a_frag<T>(st, kk, pa[kk]);
      sm90::to_a_frag<T>(dpt, kk, da[kk]);
      sm90::fence_regs(pa[kk]);
      sm90::fence_regs(da[kk]);
    }
    sm90::fence_regs(acc_k);
    sm90::fence_regs(acc_v);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      sm90::Wgmma<D, kHalf>::rs(
          acc_v, pa[kk], sm90::desc_mn(do_tile + 2048 * kk, kBQ * 128), 1);
      sm90::Wgmma<D, kHalf>::rs(
          acc_k, da[kk], sm90::desc_mn(q_tile + 2048 * kk, kBQ * 128), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_k);
    sm90::fence_regs(acc_v);
    sm90::mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: dK * scale and dV in T (a masked key's rows are exact zeros)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const size_t row = ((size_t)bh * Sk + key) * D + col_off;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * j) =
          sm90::pack2<T>(acc_k[4 * j + 2 * h] * sm_scale,
                         acc_k[4 * j + 2 * h + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * j) = sm90::pack2<T>(
          acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}


// which outputs a pass of the 256-thread form accumulates
constexpr int kOutDV = 1;
constexpr int kOutDK = 2;

// D = 128 and 256: two consumer warpgroups of 64 keys and no producer
// warpgroup. Warp 0 loads the block's K (and V) tiles once, then each
// query tile into ring stage (t - t0) % kStages once every consumer has
// released what the stage held: lane 0 issues the TMA copies, and the 32
// lanes stage the tile's rows, all arriving on the stage's full barrier.
// It loads the next tile right after its warpgroup has issued tile t's
// S^T (and dP^T), so a wait for the other warpgroup to release a stage
// overlaps its own wgmma.
template <typename T, int D, int kOut>
__device__ __forceinline__ void dkv_consumers_form(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const CUtensorMap& tm_do,
    const int* __restrict__ kv_mask, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Sq, int Sk, int causal, float sm_scale, float scale_log2,
    int dropout, uint32_t threshold, float inv_keep, uint32_t seed) {
  using L = Layout<D>;
  constexpr int kBQ = L::kBQ;
  constexpr int kStages = L::kStages;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kBoxes = D / 64;  // 64-column TMA boxes per row
  constexpr bool kDV = (kOut & kOutDV) != 0;
  constexpr bool kDK = (kOut & kOutDK) != 0;
  // an output is kNH 64 x 128 accumulators (wgmma's n is at most 128
  // here); acc[0] is dV where the pass takes it, acc[kNO - 1] dK
  constexpr int kNH = D / 128;
  constexpr int kNO = int(kDV) + int(kDK);
  extern __shared__ uint8_t smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  uint8_t* const sbase = smem + (base - sm90::smem_addr(smem));
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full0 = kv_full + 8;  // full[s] at full0 + 8 * s
  const uint32_t empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBN;  // low key tiles see the most queries
  const int diag = Sk - Sq;
  // the first query tile that can see the key tile: qi >= k0 - diag
  const int t0 = causal ? max(0, k0 - diag) / kBQ : 0;
  int nt = (Sq + kBQ - 1) / kBQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival and the 32 lanes that stage the rows
      sm90::mbar_init(full0 + 8 * s, 33);
      sm90::mbar_init(empty0 + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (block_keys(kv_mask, bh, H, Sk, k0,
                 reinterpret_cast<int*>(sbase + L::kKeys)) == kKeysNone) {
    nt = t0;  // no load, no wait: zeros out
  }
  // whether the block's keys are partly masked, read where it is needed
  auto keys_some = [&]() {
    return kv_mask != nullptr &&
           *reinterpret_cast<const int*>(sbase + L::kKeys) == kKeysSome;
  };

  const bool loader = tid < 32;  // warp 0
  auto load_q = [&](int t) {
    const int i = t - t0;
    const int s = i % kStages;
    sm90::mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    if (lane == 0) {
      sm90::mbar_arrive_tx(full, 2 * L::kQT);
      for (int c = 0; c < kBoxes; ++c) {
        const uint32_t off = s * L::kQT + c * kBQ * 128;
        sm90::tma_load(base + L::kQ + off, &tm_q, full, 64 * c, t * kBQ, bh);
        sm90::tma_load(base + L::kDO + off, &tm_do, full, 64 * c, t * kBQ,
                       bh);
      }
    }
    float* rows =
        reinterpret_cast<float*>(sbase + L::kRows + s * L::kRowBytes);
    for (int r = lane; r < kBQ; r += 32) {
      const int qi = t * kBQ + r;
      const bool in = qi < Sq;
      rows[r] = in ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
      rows[kBQ + r] = kDK && in ? delta[(size_t)bh * Sq + qi] : 0.f;
      reinterpret_cast<uint32_t*>(rows)[2 * kBQ + r] =
          dropout ? dropout_row_key(seed, bh, qi) : 0u;
    }
    sm90::mbar_arrive(full);
  };
  if (loader && t0 < nt) {
    if (lane == 0) {
      sm90::mbar_arrive_tx(kv_full, (kDK ? 2 : 1) * L::kKV);  // dV: no V
      for (int c = 0; c < kBoxes; ++c) {
        const uint32_t off = c * kBN * 128;
        sm90::tma_load(base + L::kK + off, &tm_k, kv_full, 64 * c, k0, bh);
        if constexpr (kDK) {
          sm90::tma_load(base + L::kV + off, &tm_v, kv_full, 64 * c, k0, bh);
        }
      }
    }
    for (int t = t0; t < t0 + kStages - 1 && t < nt; ++t) load_q(t);
  }

  // a consumer warpgroup: keys kw0 .. kw0 + 63; this thread holds keys
  // key0 and key0 + 8 (rows of S^T), queries 8 j + col_off + {0, 1} of
  // each tile (its columns)
  const int wg = tid / 128;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * ((tid % 128) / 32) + lane / 4;
  const int col_off = 2 * (lane % 4);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    key_ok[h] = key < Sk &&
                (kv_mask == nullptr || kv_mask[(size_t)(bh / H) * Sk + key] != 0);
  }

  float acc[kNO][kNH][64];
#pragma unroll
  for (int o = 0; o < kNO; ++o) {
#pragma unroll
    for (int n = 0; n < kNH; ++n) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[o][n][i] = 0.f;
    }
  }
  auto fence_acc = [&]() {
#pragma unroll
    for (int o = 0; o < kNO; ++o) {
#pragma unroll
      for (int n = 0; n < kNH; ++n) sm90::fence_regs(acc[o][n]);
    }
  };

  const uint32_t k_rows = base + L::kK + wg * 64 * 128;
  const uint32_t v_rows = base + L::kV + wg * 64 * 128;
  const uint32_t* const rows0 =
      reinterpret_cast<const uint32_t*>(sbase + L::kRows);
  float st[kBQ / 2], dpt[kBQ / 2];
  uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];

  // S^T = K Q^T (and dP^T = V dO^T) of the tile in stage s, 64 x kBQ
  // each, float32
  auto issue_s = [&](int s) {
    const uint32_t q_tile = base + L::kQ + s * L::kQT;
    const uint32_t do_tile = base + L::kDO + s * L::kQT;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBN * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBQ * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBQ, kHalf>::ss(st, sm90::desc_k(k_rows + a_off),
                                  sm90::desc_k(q_tile + b_off), kk > 0);
    }
    if constexpr (kDK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * kBN * 128 + 32 * (kk % 4);
        const uint32_t b_off = (kk / 4) * kBQ * 128 + 32 * (kk % 4);
        sm90::Wgmma<kBQ, kHalf>::ss(dpt, sm90::desc_k(v_rows + a_off),
                                    sm90::desc_k(do_tile + b_off), kk > 0);
      }
    }
    sm90::wgmma_commit();
  };

  // P^T, dropout, dS^T of query tile t in stage s, in place (st becomes
  // P_drop^T, dpt dS^T); masks only on the tiles that need them: keys of
  // the block masked, the ragged edge, the causal diagonal (a tile that
  // needs none holds no row without a visible key, so its lse is finite)
  auto softmax = [&](int t, int s) {
    const int q0 = t * kBQ;
    const float* lse2_s = reinterpret_cast<const float*>(
        rows0 + s * L::kRowBytes / 4);
    const float* delta_s = lse2_s + kBQ;
    const uint32_t* key_s = rows0 + s * L::kRowBytes / 4 + 2 * kBQ;
    const bool need_mask = keys_some() || q0 + kBQ > Sq ||
                           (causal && kw0 + 63 > q0 + diag);
#pragma unroll
    for (int j = 0; j < kBQ / 2; ++j) {
      const int h = (j % 4) / 2;
      const int r = 8 * (j / 4) + col_off + (j % 2);  // query in the tile
      const int key = key0 + 8 * h;
      float p = sm90::exp2_approx(fmaf(st[j], scale_log2, -lse2_s[r]));
      if (need_mask) {
        const int qi = q0 + r;
        if (!(key_ok[h] && qi < Sq && (!causal || key <= qi + diag))) p = 0.f;
      }
      float dp = kDK ? dpt[j] : 0.f;
      float p_drop = p;
      if (dropout) {
        const bool keep = dropout_keep(key_s[r], key, threshold);
        p_drop = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      if constexpr (kDV) st[j] = p_drop;
      if constexpr (kDK) dpt[j] = p * (dp - delta_s[r]);
    }
  };

  // P_drop^T and dS^T rounded to T, as wgmma's register A operand
  auto make_frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      if constexpr (kDV) {
        sm90::to_a_frag<T>(st, kk, pa[kk]);
        sm90::fence_regs(pa[kk]);
      }
      if constexpr (kDK) {
        sm90::to_a_frag<T>(dpt, kk, da[kk]);
        sm90::fence_regs(da[kk]);
      }
    }
  };

  // dV += P_drop^T dO, dK += dS^T Q with the fragments, dO and Q read
  // MN-major from stage s; product n writes columns 128 n .. 128 n + 127,
  // two 64-column boxes in (the caller fences the accumulators and
  // issues wgmma_fence first)
  auto issue_dkv = [&](int s) {
    const uint32_t q_tile = base + L::kQ + s * L::kQT;
    const uint32_t do_tile = base + L::kDO + s * L::kQT;
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kNH; ++n) {
        const uint32_t off = n * 2 * kBQ * 128 + 2048 * kk;
        if constexpr (kDV) {
          sm90::Wgmma<128, kHalf>::rs(
              acc[0][n], pa[kk], sm90::desc_mn(do_tile + off, kBQ * 128), 1);
        }
        if constexpr (kDK) {
          sm90::Wgmma<128, kHalf>::rs(acc[kNO - 1][n], da[kk],
                                      sm90::desc_mn(q_tile + off, kBQ * 128),
                                      1);
        }
      }
    }
    sm90::wgmma_commit();
  };

  if (t0 < nt) sm90::mbar_wait(kv_full, 0);
  if constexpr (!DkvCfg<D>::kOverlap) {
    for (int t = t0; t < nt; ++t) {
      const int i = t - t0;
      const int s = i % kStages;
      sm90::mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      sm90::wgmma_fence();
      issue_s(s);
      // warp 0 refills the stage that tile t - 1 left while S^T and dP^T
      // are on the tensor cores
      if (loader && t + kStages - 1 < nt) load_q(t + kStages - 1);
      __syncwarp();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      if constexpr (kDK) sm90::fence_regs(dpt);
      softmax(t, s);
      make_frags();
      fence_acc();
      sm90::wgmma_fence();
      issue_dkv(s);
      sm90::wgmma_wait<0>();
      fence_acc();
      sm90::mbar_arrive(empty0 + 8 * s);
    }
  } else if (t0 < nt) {
    // tile t's S^T and dP^T go to the tensor cores ahead of tile t - 1's
    // dK/dV products, whose run overlaps tile t's softmax; tile t - 1's
    // stage is released once they are done, so the ring runs kStages - 2
    // tiles ahead. The first tile is peeled off, so that every wait of
    // the loop covers the same groups.
    sm90::mbar_wait(full0, 0);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    if constexpr (kDK) sm90::fence_regs(dpt);
    softmax(t0, 0);
    make_frags();
    for (int t = t0 + 1; t < nt; ++t) {
      const int i = t - t0;
      const int s = i % kStages;
      const int s_prev = (i + kStages - 1) % kStages;
      sm90::mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      fence_acc();
      sm90::wgmma_fence();
      issue_s(s);
      issue_dkv(s_prev);
      if (loader && t + kStages - 2 < nt) load_q(t + kStages - 2);
      __syncwarp();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);
      if constexpr (kDK) sm90::fence_regs(dpt);
      softmax(t, s);
      sm90::wgmma_wait<0>();
      fence_acc();
      sm90::mbar_arrive(empty0 + 8 * s_prev);
      make_frags();
    }
    fence_acc();
    sm90::wgmma_fence();
    issue_dkv((nt - 1 - t0) % kStages);
    sm90::wgmma_wait<0>();
    fence_acc();
  }

  // epilogue: dK * scale and dV in T (a masked key's rows are exact zeros)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const size_t row = ((size_t)bh * Sk + key) * D + col_off;
#pragma unroll
    for (int n = 0; n < kNH; ++n) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const size_t c = row + 128 * n + 8 * j;
        if constexpr (kDK) {
          const float* a = acc[kNO - 1][n];
          *reinterpret_cast<uint32_t*>(dk + c) = sm90::pack2<T>(
              a[4 * j + 2 * h] * sm_scale, a[4 * j + 2 * h + 1] * sm_scale);
        }
        if constexpr (kDV) {
          const float* a = acc[0][n];
          *reinterpret_cast<uint32_t*>(dv + c) =
              sm90::pack2<T>(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
flash_bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const int* __restrict__ kv_mask,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Sq, int Sk, int causal,
                        float sm_scale, float scale_log2, int dropout,
                        uint32_t threshold, float inv_keep, uint32_t seed) {
#define DS_DKV_FORM(...)                                                     \
  __VA_ARGS__(tm_q, tm_k, tm_v, tm_do, kv_mask, lse, delta, dk, dv, H, Sq, \
              Sk, causal, sm_scale, scale_log2, dropout, threshold,        \
              inv_keep, seed)
  if constexpr (DkvCfg<D>::kProducer) {
    DS_DKV_FORM(dkv_producer_form<T, D>);
  } else if constexpr (DkvCfg<D>::kPasses == 1) {
    DS_DKV_FORM(dkv_consumers_form<T, D, kOutDV | kOutDK>);
  } else if (blockIdx.z == 0) {
    DS_DKV_FORM(dkv_consumers_form<T, D, kOutDK>);
  } else {
    DS_DKV_FORM(dkv_consumers_form<T, D, kOutDV>);
  }
#undef DS_DKV_FORM
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const int* kv_mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq,
               int Sk, int dtype, int causal, float sm_scale, int dropout,
               uint32_t threshold, float keep, uint32_t seed,
               cudaStream_t stream) {
  using C = DkvCfg<D>;
  using L = Layout<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::make_map(&tq, q, dtype, B * H, Sq, D, C::kBQ);
  if (err == 0) err = sm90::make_map(&tdo, dout, dtype, B * H, Sq, D, C::kBQ);
  if (err == 0) err = sm90::make_map(&tk, k, dtype, B * H, Sk, D, kBN);
  if (err == 0) err = sm90::make_map(&tv, v, dtype, B * H, Sk, D, kBN);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // dK and dV, or (two passes) dK in blockIdx.z 0 and dV in 1
  const dim3 grid(B * H, (Sk + kBN - 1) / kBN, C::kPasses);
  flash_bwd_dkv_kernel_tc<T, D><<<grid, C::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, tdo, kv_mask, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, causal, sm_scale, sm_scale * kLog2e,
      dropout, threshold, 1.f / keep, seed);
  return static_cast<int>(cudaGetLastError());
}


// The dQ kernel's tiles by head dim. D = 64 and 128: 64-key K/V tiles in
// a two-stage ring fed by a producer warpgroup (a 384-thread block;
// 128-key tiles at D = 64 spilled S, dP and dQ and serialised the
// wgmmas). D = 256: dQ alone is 128 float32 registers a thread, past the
// 168 that ptxas gives a 384-thread block; so 32-key tiles (S and dP 16
// registers each) in a three-stage ring (Q and dO 64 KB each + 3 x (16 +
// 16) KB = 224 KB) and no producer warpgroup (256 threads, up to 255
// registers each): consumer thread 0 issues the loads right after its
// warpgroup has issued S and dP, so a wait for the other warpgroup to
// release a stage overlaps its own wgmma. Under a key mask every form walks
// only the non-empty key tiles (key_tiles.cuh; kMaskKeys is the keys a
// block sorts in shared memory, D = 256 having 456 bytes left beside its
// ring). At D = 64 and 128 the producer's first warp stages each walked
// tile's key validity (the length and the mask) beside it, as before the
// walk: the consumers reading the mask from device memory per element ran
// 12-26% slower there, and any mask code in their loop spilled or slowed
// the 168-register form. At D = 256 a mixed tile's consumers read the
// tile's bits a word at a time.
template <int D>
struct DqCfg {
  static constexpr int kBK = 64;  // keys a ring stage holds
  static constexpr int kStages = 2;
  static constexpr bool kProducer = true;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kMaskKeys = 16384;
};
template <>
struct DqCfg<256> {
  static constexpr int kBK = 32;
  static constexpr int kStages = 3;
  static constexpr bool kProducer = false;
  static constexpr int kThreads = kConsumers;
  static constexpr int kMaskKeys = 2048;
};

// shared memory of the dQ kernel, byte offsets from a 1024-aligned base:
// the Q and dO tiles, the K and V rings, each stage's key validity (kBK
// int32, then the walked tile's first key and whether it is mixed, where
// a producer stages them), the key tiles (key_tiles.cuh), the block's row
// data (lse in log2 units, delta, dropout row key: kBM
// 4-byte values each), the mbarriers (qdo_full, full[kStages],
// empty[kStages])
template <int D>
struct DqLayout {
  static constexpr int kStages = DqCfg<D>::kStages;
  static constexpr int kQT = kBM * D * 2;             // the Q (or dO) tile
  static constexpr int kKT = DqCfg<D>::kBK * D * 2;  // a K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQT;
  static constexpr int kK = kDO + kQT;  // stage s at kK + s * kKT
  static constexpr int kV = kK + kStages * kKT;
  static constexpr int kValid = kV + kStages * kKT;
  // a stage's staged ints: kBK validities, the tile's first key, mixed
  static constexpr int kStaged = DqCfg<D>::kBK + 4;
  static constexpr int kTiles =
      kValid + (DqCfg<D>::kProducer ? kStages * kStaged * 4 : 0);
  using Tiles = key_tiles::Smem<DqCfg<D>::kBK, DqCfg<D>::kMaskKeys>;
  static constexpr int kRows = kTiles + Tiles::kBytes;
  static constexpr int kBars = kRows + 3 * kBM * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
flash_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const int* __restrict__ kv_mask,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int H, int Sq, int Sk, int causal, float sm_scale,
                       float scale_log2, int dropout, uint32_t threshold,
                       float inv_keep, uint32_t seed) {
  using C = DqCfg<D>;
  using L = DqLayout<D>;
  constexpr int kBK = C::kBK;
  constexpr int kStages = C::kStages;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kBoxes = D / 64;  // 64-column TMA boxes per row
  // dQ += dS K runs as kNH products of kNW columns (wgmma's n is at most
  // 128 here): dQ is kNH arrays of a 64 x kNW accumulator
  constexpr int kNW = D < 128 ? D : 128;
  constexpr int kNH = D / kNW;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  uint8_t* const sbase = smem + (base - sm90::smem_addr(smem));
  const uint32_t qdo_full = base + L::kBars;
  const uint32_t full0 = qdo_full + 8;  // full[s] at full0 + 8 * s
  const uint32_t empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest tiles first
  const int diag = Sk - Sq;
  // keys the block's rows can see: up to the diagonal of its last row
  const int kend = causal ? min(Sk, min(q0 + kBM, Sq) + diag) : Sk;
  int nt = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival, and the 32 lanes that stage the
      // validity where a producer warp does
      sm90::mbar_init(full0 + 8 * s, C::kProducer ? 33 : 1);
      sm90::mbar_init(empty0 + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  int* const valid0 = reinterpret_cast<int*>(sbase + L::kValid);
  // the batch's mask row, formed where it is used (not held in registers
  // across the loop)
  auto mask_row = [&]() { return kv_mask + (size_t)(bh / H) * Sk; };
  // under a mask: walk only the non-empty key tiles (a row with no valid
  // key walks none and writes zeros)
  uint8_t* const tiles = sbase + L::kTiles;  // the key tiles' region
  if (kv_mask != nullptr) {
    nt = key_tiles::prepare<kBK, C::kMaskKeys>(tiles, mask_row(), Sk, nt);
  }
  // walk entry t: the absolute key tile and whether it is mixed
  auto entry = [&](int t) {
    return key_tiles::entry<kBK, C::kMaskKeys>(tiles, kv_mask != nullptr, t);
  };

  // The TMA loads, each issued by one thread: the block's Q and dO tiles,
  // and walk entry j's K and V into ring stage j % kStages once every
  // consumer has released what the stage held.
  auto load_qdo = [&]() {
    sm90::mbar_arrive_tx(qdo_full, 2 * L::kQT);
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = c * kBM * 128;
      sm90::tma_load(base + L::kQ + off, &tm_q, qdo_full, 64 * c, q0, bh);
      sm90::tma_load(base + L::kDO + off, &tm_do, qdo_full, 64 * c, q0, bh);
    }
  };
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    sm90::mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    sm90::mbar_arrive_tx(full, 2 * L::kKT);
    const int k0 = key_tiles::tile_of(entry(j)) * kBK;
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = s * L::kKT + c * kBK * 128;
      sm90::tma_load(base + L::kK + off, &tm_k, full, 64 * c, k0, bh);
      sm90::tma_load(base + L::kV + off, &tm_v, full, 64 * c, k0, bh);
    }
  };

  if constexpr (C::kProducer) {
    if (tid >= kConsumers) {  // the producer warpgroup: its first warp
      sm90::setmaxnreg_dec<24>();
      const int lane = tid - kConsumers;
      if (lane >= 32) return;
      if (lane == 0 && nt > 0) load_qdo();
      for (int t = 0; t < nt; ++t) {
        const int s = t % kStages;
        if (lane == 0) {
          load_kv(t);
        } else {
          sm90::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        }
        // the walked tile's key validity (length and mask), first key and
        // class beside it
        const uint32_t e = entry(t);
        const int j = key_tiles::tile_of(e);
        int* valid = valid0 + s * L::kStaged;
        if (lane == 0) {
          valid[kBK] = j * kBK;
          valid[kBK + 1] = key_tiles::is_mixed(e);
        }
#pragma unroll
        for (int w = 0; w < kBK / 32; ++w) {
          const int key = j * kBK + 32 * w + lane;
          bool ok = key < Sk;
          if (kv_mask != nullptr) {
            ok = ok && ((key_tiles::tile_word<kBK, C::kMaskKeys>(
                             tiles, mask_row(), Sk, j, w) >> lane) & 1u);
          }
          valid[32 * w + lane] = ok;
        }
        sm90::mbar_arrive(full0 + 8 * s);
      }
      return;
    }
    sm90::setmaxnreg_inc<240>();
  } else if (tid == 0 && nt > 0) {
    load_qdo();
    for (int j = 0; j < kStages - 1 && j < nt; ++j) load_kv(j);
  }
  // the consumer thread that issues the ring's loads (none where a
  // producer warpgroup does)
  const bool loader = !C::kProducer && tid == 0;

  // a consumer warpgroup: rows r0 .. r0 + 63; this thread holds rows
  // row0 and row0 + 8, keys 8 j + col_off + {0, 1} of each tile
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r0 = q0 + 64 * wg;
  const int row0 = r0 + 16 * ((tid % 128) / 32) + lane / 4;
  const int col_off = 2 * (lane % 4);
  // the row data of the thread's two rows, computed once and kept in
  // shared memory (registers are the scarcer): the four threads of a row
  // write the same values, and each reads back only its own rows
  float* const rows = reinterpret_cast<float*>(sbase + L::kRows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const int r = row - q0;
    const bool in = row < Sq;
    rows[r] = in ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    rows[kBM + r] = in ? delta[(size_t)bh * Sq + row] : 0.f;
    reinterpret_cast<uint32_t*>(rows)[2 * kBM + r] =
        dropout ? dropout_row_key(seed, bh, row) : 0u;
  }

  float acc[kNH][kNW / 2];
#pragma unroll
  for (int n = 0; n < kNH; ++n) {
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) acc[n][i] = 0.f;
  }
  auto fence_acc = [&]() {
#pragma unroll
    for (int n = 0; n < kNH; ++n) sm90::fence_regs(acc[n]);
  };

  const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
  const uint32_t do_rows = base + L::kDO + wg * 64 * 128;
  if (nt > 0) sm90::mbar_wait(qdo_full, 0);
  // the walk's length, re-read where it is compared (not held in a
  // register across the loop): the table's count under a mask
  const int* const walk_len =
      valid0 + (L::kTiles - L::kValid + L::Tiles::kCount) / 4;
  const int nt_all = kend > 0 ? (kend + kBK - 1) / kBK : 0;
  for (int t = 0; t < (kv_mask != nullptr ? *walk_len : nt_all); ++t) {
    const int s = t % kStages;
    sm90::mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t k_tile = base + L::kK + s * L::kKT;
    const uint32_t v_tile = base + L::kV + s * L::kKT;

    // S = Q K^T and dP = dO V^T, 64 x kBK each, float32
    float sc[kBK / 2], dp[kBK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBM * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBK * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBK, kHalf>::ss(sc, sm90::desc_k(q_rows + a_off),
                                  sm90::desc_k(k_tile + b_off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBM * 128 + 32 * (kk % 4);
      const uint32_t b_off = (kk / 4) * kBK * 128 + 32 * (kk % 4);
      sm90::Wgmma<kBK, kHalf>::ss(dp, sm90::desc_k(do_rows + a_off),
                                  sm90::desc_k(v_tile + b_off), kk > 0);
    }
    sm90::wgmma_commit();
    // without a producer, the loader refills the stage that tile t - 1
    // left with tile t + kStages - 1 while S and dP are on the tensor cores
    if constexpr (!C::kProducer) {
      if (loader && t + kStages - 1 < nt) load_kv(t + kStages - 1);
      __syncwarp();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    // the walked tile, read only now (held across the products, or read
    // through a pointer to the tile table, it pushed the 384-thread form
    // past its 168 registers): where a producer staged it, beside the
    // tile's validity
    int k0;
    bool mixed;
    if constexpr (C::kProducer) {
      k0 = valid0[s * L::kStaged + kBK];
      mixed = valid0[s * L::kStaged + kBK + 1] != 0;
    } else {
      const uint32_t e = entry(t);
      k0 = key_tiles::tile_of(e) * kBK;
      mixed = key_tiles::is_mixed(e);
    }

    // P, dropout, dS; masks only on the tiles that need them: a mixed
    // tile, the ragged edge, the causal diagonal (a tile that needs none
    // holds no row without a visible key, so its lse is finite). Compiled
    // twice: with the key mask (a mixed tile) and without, so that the
    // mask's ballots and branches stay out of the other tiles' code; the
    // producer form reads the validity its producer staged.
    auto p_ds = [&](auto key_mask) {
      constexpr bool kKeyMask = decltype(key_mask)::value;
      const bool need_mask = mixed || k0 + kBK > Sk ||
                             (causal && k0 + kBK - 1 > r0 + diag);
      uint32_t word = ~0u;  // the key validity of columns 32 w .. + 31
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const int h = (j % 4) / 2;
        const int key = k0 + 8 * (j / 4) + col_off + (j % 2);
        const int r = row0 + 8 * h - q0;  // the row in the block
        float p = sm90::exp2_approx(fmaf(sc[j], scale_log2, -rows[r]));
        if constexpr (kKeyMask) {
          if (j % 16 == 0) {
            word = key_tiles::tile_word<kBK, C::kMaskKeys>(
                tiles, mask_row(), Sk, k0 / kBK, j / 16);
          }
        }
        if (need_mask) {
          bool ok;
          if constexpr (C::kProducer) {
            ok = valid0[s * L::kStaged + (key - k0)] &&
                 (!causal || key <= q0 + r + diag);
          } else {
            ok = key < Sk && (!causal || key <= q0 + r + diag);
            if constexpr (kKeyMask) {
              // the key's bit in word j / 16: 8 ((j / 4) % 4) + col_off +
              // j % 2
              ok = ok &&
                   ((word >> (8 * ((j / 4) % 4) + col_off + (j % 2))) & 1u);
            }
          }
          if (!ok) p = 0.f;
        }
        float d = dp[j];
        if (dropout) {
          const uint32_t rkey =
              reinterpret_cast<const uint32_t*>(rows)[2 * kBM + r];
          d = dropout_keep(rkey, key, threshold) ? d * inv_keep : 0.f;
        }
        sc[j] = p * (d - rows[kBM + r]);
      }
    };
    if constexpr (C::kProducer) {
      p_ds(std::false_type{});
    } else if (mixed) {
      p_ds(std::true_type{});
    } else {
      p_ds(std::false_type{});
    }

    // dQ += dS K: dS from registers, K MN-major from the same ring tile;
    // product n writes columns n * kNW .. + kNW - 1, kNW / 64 boxes in
    uint32_t da[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      sm90::to_a_frag<T>(sc, kk, da[kk]);
      sm90::fence_regs(da[kk]);
    }
    fence_acc();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kNH; ++n) {
        const uint32_t box = n * (kNW / 64) * kBK * 128;
        sm90::Wgmma<kNW, kHalf>::rs(
            acc[n], da[kk],
            sm90::desc_mn(k_tile + box + 2048 * kk, kBK * 128), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_acc();
    sm90::mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: dQ * scale in T (a row that sees no key is exact zeros)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    T* drow = dq + ((size_t)bh * Sq + row) * D + col_off;
#pragma unroll
    for (int n = 0; n < kNH; ++n) {
#pragma unroll
      for (int j = 0; j < kNW / 8; ++j) {
        *reinterpret_cast<uint32_t*>(drow + n * kNW + 8 * j) =
            sm90::pack2<T>(acc[n][4 * j + 2 * h] * sm_scale,
                           acc[n][4 * j + 2 * h + 1] * sm_scale);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v,
              const int* kv_mask, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Sq, int Sk,
              int dtype, int causal, float sm_scale, int dropout,
              uint32_t threshold, float keep, uint32_t seed,
              cudaStream_t stream) {
  using C = DqCfg<D>;
  using L = DqLayout<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::make_map(&tq, q, dtype, B * H, Sq, D, kBM);
  if (err == 0) err = sm90::make_map(&tdo, dout, dtype, B * H, Sq, D, kBM);
  if (err == 0) err = sm90::make_map(&tk, k, dtype, B * H, Sk, D, C::kBK);
  if (err == 0) err = sm90::make_map(&tv, v, dtype, B * H, Sk, D, C::kBK);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_bwd_dq_kernel_tc<T, D><<<grid, C::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, tdo, kv_mask, lse, delta, static_cast<T*>(dq), H, Sq, Sk,
      causal, sm_scale, sm_scale * kLog2e, dropout, threshold, 1.f / keep,
      seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 float32, 1 bfloat16, 2 float16; D 64, 128 or 256 (the wrapper
// checks). lse and delta are [B, H, Sq] float32. dropout as in
// ds_flash_fwd. float32 takes the FMA kernel, bfloat16 and float16 the
// tensor-core kernel.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const int* kv_mask, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               int B, int H, int Sq, int Sk, int D, int dtype,
                               int causal, float sm_scale, int dropout,
                               unsigned int threshold, float keep,
                               unsigned int seed, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_FLASH_DQ_TC(T, DIM)                                                \
  return tc::launch_dq<T, DIM>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, \
                               Sq, Sk, dtype, causal, sm_scale, dropout,     \
                               threshold, keep, seed, s)
  if (dtype == 1 && D == 64) DS_FLASH_DQ_TC(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DS_FLASH_DQ_TC(__nv_bfloat16, 128);
  if (dtype == 1 && D == 256) DS_FLASH_DQ_TC(__nv_bfloat16, 256);
  if (dtype == 2 && D == 64) DS_FLASH_DQ_TC(__half, 64);
  if (dtype == 2 && D == 128) DS_FLASH_DQ_TC(__half, 128);
  if (dtype == 2 && D == 256) DS_FLASH_DQ_TC(__half, 256);
#undef DS_FLASH_DQ_TC
#define DS_FLASH_DQ_FMA(DIM, BK, G)                                           \
  return launch_dq<DIM, BK, G>(q, k, v, kv_mask, dout, lse, delta, dq, B, H, \
                               Sq, Sk, causal, sm_scale, dropout, threshold,  \
                               keep, seed, s)
  if (dtype == 0 && D == 64) DS_FLASH_DQ_FMA(64, 64, 4);
  if (dtype == 0 && D == 128) DS_FLASH_DQ_FMA(128, 32, 4);
  if (dtype == 0 && D == 256) DS_FLASH_DQ_FMA(256, 16, 8);
#undef DS_FLASH_DQ_FMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// dK/dV: float32 on the FMA kernel, bfloat16 and float16 on the
// tensor-core kernel.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* dout,
                                const float* lse, const float* delta, void* dk,
                                void* dv, int B, int H, int Sq, int Sk, int D,
                                int dtype, int causal, float sm_scale,
                                int dropout, unsigned int threshold, float keep,
                                unsigned int seed, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_FLASH_DKV_TC(T, DIM)                                               \
  return tc::launch_dkv<T, DIM>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, \
                                H, Sq, Sk, dtype, causal, sm_scale, dropout,   \
                                threshold, keep, seed, s)
  if (dtype == 1 && D == 64) DS_FLASH_DKV_TC(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DS_FLASH_DKV_TC(__nv_bfloat16, 128);
  if (dtype == 1 && D == 256) DS_FLASH_DKV_TC(__nv_bfloat16, 256);
  if (dtype == 2 && D == 64) DS_FLASH_DKV_TC(__half, 64);
  if (dtype == 2 && D == 128) DS_FLASH_DKV_TC(__half, 128);
  if (dtype == 2 && D == 256) DS_FLASH_DKV_TC(__half, 256);
#undef DS_FLASH_DKV_TC
#define DS_FLASH_DKV_FMA(DIM, BQ, G)                                           \
  return launch_dkv<DIM, BQ, G>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B, \
                                H, Sq, Sk, causal, sm_scale, dropout,         \
                                threshold, keep, seed, s)
  if (dtype == 0 && D == 64) DS_FLASH_DKV_FMA(64, 64, 4);
  if (dtype == 0 && D == 128) DS_FLASH_DKV_FMA(128, 32, 4);
  if (dtype == 0 && D == 256) DS_FLASH_DKV_FMA(256, 16, 8);
#undef DS_FLASH_DKV_FMA
  return static_cast<int>(cudaErrorInvalidValue);
}
