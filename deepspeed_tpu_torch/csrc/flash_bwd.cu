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
// kernel (FA3's structure without dQ). A block owns 128 keys of one
// (batch, head): two consumer warpgroups of 64 keys each and one producer
// warpgroup, whose registers go to the consumers (setmaxnreg 24 / 240).
// The producer loads the block's K and V tiles once by TMA, then
// streams tiles of Q and dO (3-D tensor maps, zero-filled past S) through a
// two-stage ring, starting at the first query tile that can see the key
// tile, and its 32 lanes stage each tile's lse (in log2 units), delta and
// dropout row keys beside them. Each consumer forms S^T = K Q^T and
// dP^T = V dO^T with wgmma from shared memory (all K-major), computes
// P^T = exp(S^T - lse), the dropout and dS^T = P^T (dP^T - delta) in
// float32 registers (masks only on the tiles that need them), rounds
// P_drop^T and dS^T to the storage type in registers and accumulates
// dV += P_drop^T dO and dK += dS^T Q with them as the register A operand
// and dO, Q read MN-major from the same ring tiles. dK is scaled by
// `scale` in the epilogue.
//
// dQ, bfloat16 and float16 — flash_bwd_dq_kernel_tc, the same structure
// turned around (the forward's shape). A block owns 128 query rows of one
// (batch, head): two consumer warpgroups of 64 rows each and one producer
// warpgroup (setmaxnreg 24 / 240). The producer loads the block's Q and
// dO tiles once by TMA, then streams K and V tiles through a two-stage
// ring from key tile 0 up to the causal diagonal, and its 32 lanes stage
// each tile's key validity (the length and kv_mask) beside it. Each
// consumer thread computes the lse (log2 units), delta and dropout row key
// of its two rows once and keeps them in shared memory, since registers
// are the scarcer (ptxas holds a 384-thread block to 168 a thread,
// whatever setmaxnreg gives the consumers at run time). The ring holds
// 64-key tiles at both head dims: at 128 keys and D = 64 S, dP and dQ
// spill and serialise the wgmmas. Per key tile it forms
// S = Q K^T and dP = dO V^T with wgmma from shared memory (both K-major),
// computes P = exp2(S scale log2 e - lse), the masks (only on the tiles
// that need them), the dropout of dP and dS = P (dP - delta) in float32
// registers, rounds dS to the storage type as the register A operand
// (the Pallas kernel's ds.astype(k.dtype)) and accumulates dQ += dS K with
// K read MN-major from the same ring tile. The epilogue scales by `scale`
// and stores in T. Query tiles are issued heaviest first.
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
// C interface: ds_flash_bwd_dq(...) and ds_flash_bwd_dkv(...) launch on the
// given stream, allocate nothing, and return cudaGetLastError() (or the
// error that stopped them before the launch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"
#include "sm90.cuh"

namespace {

constexpr int kGroup = 4;               // threads per row
constexpr int kRows = 32;               // rows a block owns
constexpr int kThreads = kRows * kGroup;  // 128

// the thread's quarter of a D-vector: float4 chunks c = g + kGroup * i
template <int D>
__device__ __forceinline__ void load_quarter(const float* row, bool ok, int g,
                                             float* out) {
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[4 * i + e] = ok ? row[4 * (g + kGroup * i) + e] : 0.f;
    }
  }
}

template <int D>
__device__ __forceinline__ float dot_quarter(const float* mine,
                                             const float* shared_row, int g) {
  const float4* r = reinterpret_cast<const float4*>(shared_row);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
    const float4 x = r[g + kGroup * i];
    part = fmaf(mine[4 * i + 0], x.x, part);
    part = fmaf(mine[4 * i + 1], x.y, part);
    part = fmaf(mine[4 * i + 2], x.z, part);
    part = fmaf(mine[4 * i + 3], x.w, part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

template <int D>
__device__ __forceinline__ void axpy_quarter(float a, const float* shared_row,
                                             int g, float* acc) {
  const float4* r = reinterpret_cast<const float4*>(shared_row);
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
    const float4 x = r[g + kGroup * i];
    acc[4 * i + 0] = fmaf(a, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(a, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, x.w, acc[4 * i + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_quarter(float* row, int g, float scale,
                                              const float* acc) {
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      row[4 * (g + kGroup * i) + e] = acc[4 * i + e] * scale;
    }
  }
}

// dQ: one block per (bh, query tile); BK keys staged per step.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ kv_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H,
                    int Sq, int Sk, int causal, float sm_scale, int dropout,
                    uint32_t threshold, float keep, uint32_t seed) {
  constexpr int kDPT = D / kGroup;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ int valid_s[BK];

  const int nq = (Sq + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int g = tid % kGroup;
  const int qi = qt * kRows + tid / kGroup;
  const bool row_ok = qi < Sq;
  const int diag = Sk - Sq;

  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  float qr[kDPT], dor[kDPT], acc[kDPT];
  load_quarter<D>(q + ((size_t)bh * Sq + qi) * D, row_ok, g, qr);
  load_quarter<D>(dout + ((size_t)bh * Sq + qi) * D, row_ok, g, dor);
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
      const float s = dot_quarter<D>(qr, &ks[j][0], g) * sm_scale;
      float dp = dot_quarter<D>(dor, &vs[j][0], g);
      const int kj = k0 + j;
      const bool ok = row_ok && valid_s[j] && (!causal || kj <= qi + diag);
      const float p = ok ? expf(s - lse_i) : 0.f;
      if (dropout) {
        dp = dropout_keep(row_key, kj, threshold) ? dp / keep : 0.f;
      }
      const float ds = p * (dp - delta_i);
      axpy_quarter<D>(ds, &ks[j][0], g, acc);
    }
  }
  if (row_ok) {
    store_quarter<D>(dq + ((size_t)bh * Sq + qi) * D, g, sm_scale, acc);
  }
}

// dK, dV: one block per (bh, key tile); BQ queries staged per step.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ kv_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     float sm_scale, int dropout, uint32_t threshold,
                     float keep, uint32_t seed) {
  constexpr int kDPT = D / kGroup;
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float dos[BQ][D];
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ uint32_t key_s[BQ];  // the rows' dropout keys

  const int kt = blockIdx.x;  // low key tiles see the most queries
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int g = tid % kGroup;
  const int kj = kt * kRows + tid / kGroup;
  const int diag = Sk - Sq;
  const bool key_ok =
      kj < Sk && (kv_mask == nullptr || kv_mask[(size_t)b * Sk + kj] != 0);

  const float* qb = q + (size_t)bh * Sq * D;
  const float* db = dout + (size_t)bh * Sq * D;
  float kr[kDPT], vr[kDPT], acc_k[kDPT], acc_v[kDPT];
  load_quarter<D>(k + ((size_t)bh * Sk + kj) * D, kj < Sk, g, kr);
  load_quarter<D>(v + ((size_t)bh * Sk + kj) * D, kj < Sk, g, vr);
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
      const float s = dot_quarter<D>(kr, &qs[i][0], g) * sm_scale;
      float dp = dot_quarter<D>(vr, &dos[i][0], g);
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
      const float ds = p * (dp - delta_s[i]);
      axpy_quarter<D>(p_drop, &dos[i][0], g, acc_v);
      axpy_quarter<D>(ds, &qs[i][0], g, acc_k);
    }
  }
  if (kj < Sk) {
    store_quarter<D>(dk + ((size_t)bh * Sk + kj) * D, g, sm_scale, acc_k);
    store_quarter<D>(dv + ((size_t)bh * Sk + kj) * D, g, 1.f, acc_v);
  }
}

// float32 only: bfloat16 and float16 take tc::launch_dq
template <int D, int BS>
int launch_dq(const void* q, const void* k, const void* v, const int* kv_mask,
              const void* dout, const float* lse, const float* delta,
              void* dq, int B, int H, int Sq, int Sk, int causal,
              float sm_scale, int dropout, uint32_t threshold, float keep,
              uint32_t seed, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_mask, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), H, Sq, Sk, causal, sm_scale,
      dropout, threshold, keep, seed);
  return static_cast<int>(cudaGetLastError());
}

// float32 only: bfloat16 and float16 take tc::launch_dkv
template <int D, int BS>
int launch_dkv(const void* q, const void* k, const void* v,
               const int* kv_mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq,
               int Sk, int causal, float sm_scale, int dropout,
               uint32_t threshold, float keep, uint32_t seed,
               cudaStream_t stream) {
  const dim3 grid((Sk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<D, BS><<<grid, kThreads, 0, stream>>>(
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

constexpr int kBN = 128;                   // keys a dK/dV block owns
constexpr int kBM = 128;                   // query rows a dQ block owns
constexpr int kStages = 2;                 // dK/dV's Q/dO ring, dQ's K/V ring
constexpr int kBK = 64;                    // keys a dQ ring stage holds
constexpr int kConsumers = 256;             // two warpgroups of 64 keys
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, byte offsets from a 1024-aligned base: the K and V
// tiles, the Q and dO rings, each stage's row data (lse in log2 units,
// delta, dropout row key: kBQ 4-byte values each), the mbarriers
// (kv_full, full[kStages], empty[kStages])
template <int D>
struct Layout {
  // queries a ring stage holds: 32 at D = 128 keeps dK, dV, S^T and dP^T
  // of a thread (2 x 64 + 2 x 16 float32) within its registers
  static constexpr int kBQ = D == 64 ? 64 : 32;
  static constexpr int kKV = kBN * D * 2;  // the K (or V) tile
  static constexpr int kQT = kBQ * D * 2;  // a Q (or dO) tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;  // stage s at kQ + s * kQT
  static constexpr int kDO = kQ + kStages * kQT;
  static constexpr int kRows = kDO + kStages * kQT;
  static constexpr int kRowBytes = 3 * kBQ * 4;
  static constexpr int kBars = kRows + kStages * kRowBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
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
  using L = Layout<D>;
  constexpr int kBQ = L::kBQ;
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
  const int nt = (Sq + kBQ - 1) / kBQ;

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

    // P^T, dropout, dS^T; masks only on the tiles that need them (a tile
    // that needs none holds no row without a visible key, so its lse is
    // finite)
    const bool need_mask = kv_mask != nullptr || q0 + kBQ > Sq ||
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

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const int* kv_mask, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq,
               int Sk, int dtype, int causal, float sm_scale, int dropout,
               uint32_t threshold, float keep, uint32_t seed,
               cudaStream_t stream) {
  constexpr int kBQ = Layout<D>::kBQ;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::make_map(&tq, q, dtype, B * H, Sq, D, kBQ);
  if (err == 0) err = sm90::make_map(&tdo, dout, dtype, B * H, Sq, D, kBQ);
  if (err == 0) err = sm90::make_map(&tk, k, dtype, B * H, Sk, D, kBN);
  if (err == 0) err = sm90::make_map(&tv, v, dtype, B * H, Sk, D, kBN);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sk + kBN - 1) / kBN);
  flash_bwd_dkv_kernel_tc<T, D>
      <<<grid, kThreads, Layout<D>::kBytes, stream>>>(
          tq, tk, tv, tdo, kv_mask, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), H, Sq, Sk, causal, sm_scale,
          sm_scale * kLog2e, dropout, threshold, 1.f / keep, seed);
  return static_cast<int>(cudaGetLastError());
}


// shared memory of the dQ kernel, byte offsets from a 1024-aligned base:
// the Q and dO tiles, the K and V rings, each stage's key validity (kBK
// int32), the block's row data (lse in log2 units, delta, dropout row
// key: kBM 4-byte values each), the mbarriers (qdo_full, full[kStages],
// empty[kStages])
template <int D>
struct DqLayout {
  static constexpr int kQT = kBM * D * 2;  // the Q (or dO) tile
  static constexpr int kKT = kBK * D * 2;  // a K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQT;
  static constexpr int kK = kDO + kQT;  // stage s at kK + s * kKT
  static constexpr int kV = kK + kStages * kKT;
  static constexpr int kValid = kV + kStages * kKT;
  static constexpr int kRows = kValid + kStages * kBK * 4;
  static constexpr int kBars = kRows + 3 * kBM * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
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
  using L = DqLayout<D>;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kBoxes = D / 64;  // 64-column TMA boxes per row
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
  const int nt = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival and the 32 lanes that stage the validity
      sm90::mbar_init(full0 + 8 * s, 33);
      sm90::mbar_init(empty0 + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: its first warp works
    sm90::setmaxnreg_dec<24>();
    const int lane = tid - kConsumers;
    if (lane >= 32) return;
    if (lane == 0 && nt > 0) {
      sm90::mbar_arrive_tx(qdo_full, 2 * L::kQT);
      for (int c = 0; c < kBoxes; ++c) {
        const uint32_t off = c * kBM * 128;
        sm90::tma_load(base + L::kQ + off, &tm_q, qdo_full, 64 * c, q0, bh);
        sm90::tma_load(base + L::kDO + off, &tm_do, qdo_full, 64 * c, q0,
                       bh);
      }
    }
    const int* mask_row =
        kv_mask ? kv_mask + (size_t)(bh / H) * Sk : nullptr;
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages;
      sm90::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        sm90::mbar_arrive_tx(full, 2 * L::kKT);
        for (int c = 0; c < kBoxes; ++c) {
          const uint32_t off = s * L::kKT + c * kBK * 128;
          sm90::tma_load(base + L::kK + off, &tm_k, full, 64 * c, t * kBK, bh);
          sm90::tma_load(base + L::kV + off, &tm_v, full, 64 * c, t * kBK, bh);
        }
      }
      int* valid = reinterpret_cast<int*>(sbase + L::kValid + s * kBK * 4);
      for (int r = lane; r < kBK; r += 32) {
        const int key = t * kBK + r;
        valid[r] = key < Sk && (mask_row == nullptr || mask_row[key] != 0);
      }
      sm90::mbar_arrive(full);
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();

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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
  const uint32_t do_rows = base + L::kDO + wg * 64 * 128;
  if (nt > 0) sm90::mbar_wait(qdo_full, 0);
  for (int t = 0; t < nt; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBK;
    sm90::mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t k_tile = base + L::kK + s * L::kKT;
    const uint32_t v_tile = base + L::kV + s * L::kKT;
    const int* valid =
        reinterpret_cast<const int*>(sbase + L::kValid + s * kBK * 4);

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
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // P, dropout, dS; masks only on the tiles that need them (a tile that
    // needs none holds no row without a visible key, so its lse is finite)
    const bool need_mask = kv_mask != nullptr || k0 + kBK > Sk ||
                           (causal && k0 + kBK - 1 > r0 + diag);
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int h = (j % 4) / 2;
      const int c = 8 * (j / 4) + col_off + (j % 2);  // key in the tile
      const int key = k0 + c;
      const int r = row0 + 8 * h - q0;  // the row in the block
      float p = sm90::exp2_approx(fmaf(sc[j], scale_log2, -rows[r]));
      if (need_mask) {
        if (!(valid[c] && (!causal || key <= q0 + r + diag))) p = 0.f;
      }
      float d = dp[j];
      if (dropout) {
        const uint32_t rkey =
            reinterpret_cast<const uint32_t*>(rows)[2 * kBM + r];
        d = dropout_keep(rkey, key, threshold) ? d * inv_keep : 0.f;
      }
      sc[j] = p * (d - rows[kBM + r]);
    }

    // dQ += dS K: dS from registers, K MN-major from the same ring tile
    uint32_t da[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      sm90::to_a_frag<T>(sc, kk, da[kk]);
      sm90::fence_regs(da[kk]);
    }
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      sm90::Wgmma<D, kHalf>::rs(
          acc, da[kk], sm90::desc_mn(k_tile + 2048 * kk, kBK * 128), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: dQ * scale in T (a row that sees no key is exact zeros)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    T* drow = dq + ((size_t)bh * Sq + row) * D + col_off;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(drow + 8 * j) =
          sm90::pack2<T>(acc[4 * j + 2 * h] * sm_scale,
                         acc[4 * j + 2 * h + 1] * sm_scale);
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
  using L = DqLayout<D>;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::make_map(&tq, q, dtype, B * H, Sq, D, kBM);
  if (err == 0) err = sm90::make_map(&tdo, dout, dtype, B * H, Sq, D, kBM);
  if (err == 0) err = sm90::make_map(&tk, k, dtype, B * H, Sk, D, kBK);
  if (err == 0) err = sm90::make_map(&tv, v, dtype, B * H, Sk, D, kBK);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_bwd_dq_kernel_tc<T, D><<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, tdo, kv_mask, lse, delta, static_cast<T*>(dq), H, Sq, Sk,
      causal, sm_scale, sm_scale * kLog2e, dropout, threshold, 1.f / keep,
      seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 float32, 1 bfloat16, 2 float16; D 64 or 128 (the wrapper
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
  if (dtype == 2 && D == 64) DS_FLASH_DQ_TC(__half, 64);
  if (dtype == 2 && D == 128) DS_FLASH_DQ_TC(__half, 128);
#undef DS_FLASH_DQ_TC
  if (dtype == 0 && D == 64) {
    return launch_dq<64, 64>(q, k, v, kv_mask, dout, lse, delta, dq, B, H,
                             Sq, Sk, causal, sm_scale, dropout, threshold,
                             keep, seed, s);
  }
  if (dtype == 0 && D == 128) {
    return launch_dq<128, 32>(q, k, v, kv_mask, dout, lse, delta, dq, B, H,
                              Sq, Sk, causal, sm_scale, dropout, threshold,
                              keep, seed, s);
  }
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
  if (dtype == 2 && D == 64) DS_FLASH_DKV_TC(__half, 64);
  if (dtype == 2 && D == 128) DS_FLASH_DKV_TC(__half, 128);
#undef DS_FLASH_DKV_TC
  if (dtype == 0 && D == 64) {
    return launch_dkv<64, 64>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B,
                              H, Sq, Sk, causal, sm_scale, dropout, threshold,
                              keep, seed, s);
  }
  if (dtype == 0 && D == 128) {
    return launch_dkv<128, 32>(q, k, v, kv_mask, dout, lse, delta, dk, dv, B,
                               H, Sq, Sk, causal, sm_scale, dropout,
                               threshold, keep, seed, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
