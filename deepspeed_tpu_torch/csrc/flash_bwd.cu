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
// What this design does about it, first version: the S x S matrices never
// touch device memory, and there are no atomics. The dQ kernel gives one
// thread block to (bh, a tile of 32 query rows) and loops over the key
// tiles up to the causal diagonal; the dK/dV kernel gives one block to
// (bh, a tile of 32 key rows) and loops over the query tiles from the
// diagonal on. In both, the loop's other operand is staged in shared
// memory as float32 (K and V, or Q and dO), four threads share a row and
// hold a quarter of its vectors and accumulators in registers, and each
// dot product closes with two warp shuffles; a row's s and dp are formed
// one pair at a time and used at once. Causal tiles are issued heaviest
// first. The products run on the CUDA cores (FMA), not the tensor cores:
// right and simple first; a tensor-core (mma/wgmma + TMA) version is later
// work, and its distance from the bound is in PERF.md.
//
// C interface: ds_flash_bwd_dq(...) and ds_flash_bwd_dkv(...) launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGroup = 4;               // threads per row
constexpr int kRows = 32;               // rows a block owns
constexpr int kThreads = kRows * kGroup;  // 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the thread's quarter of a D-vector: float4 chunks c = g + kGroup * i
template <typename T, int D>
__device__ __forceinline__ void load_quarter(const T* row, bool ok, int g,
                                             float* out) {
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[4 * i + e] = ok ? to_f32(row[4 * (g + kGroup * i) + e]) : 0.f;
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

template <typename T, int D>
__device__ __forceinline__ void store_quarter(T* row, int g, float scale,
                                              const float* acc) {
#pragma unroll
  for (int i = 0; i < D / kGroup / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      row[4 * (g + kGroup * i) + e] = from_f32<T>(acc[4 * i + e] * scale);
    }
  }
}

// dQ: one block per (bh, query tile); BK keys staged per step.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
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

  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  float qr[kDPT], dor[kDPT], acc[kDPT];
  load_quarter<T, D>(q + ((size_t)bh * Sq + qi) * D, row_ok, g, qr);
  load_quarter<T, D>(dout + ((size_t)bh * Sq + qi) * D, row_ok, g, dor);
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
      ks[r][c] = kj < Sk ? to_f32(kb[(size_t)kj * D + c]) : 0.f;
      vs[r][c] = kj < Sk ? to_f32(vb[(size_t)kj * D + c]) : 0.f;
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
      const float ds = round_to<T>(p * (dp - delta_i));
      axpy_quarter<D>(ds, &ks[j][0], g, acc);
    }
  }
  if (row_ok) store_quarter<T, D>(dq + ((size_t)bh * Sq + qi) * D, g, sm_scale, acc);
}

// dK, dV: one block per (bh, key tile); BQ queries staged per step.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int causal,
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

  const T* qb = q + (size_t)bh * Sq * D;
  const T* db = dout + (size_t)bh * Sq * D;
  float kr[kDPT], vr[kDPT], acc_k[kDPT], acc_v[kDPT];
  load_quarter<T, D>(k + ((size_t)bh * Sk + kj) * D, kj < Sk, g, kr);
  load_quarter<T, D>(v + ((size_t)bh * Sk + kj) * D, kj < Sk, g, vr);
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
      qs[r][c] = qi < Sq ? to_f32(qb[(size_t)qi * D + c]) : 0.f;
      dos[r][c] = qi < Sq ? to_f32(db[(size_t)qi * D + c]) : 0.f;
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
      const float ds = round_to<T>(p * (dp - delta_s[i]));
      axpy_quarter<D>(round_to<T>(p_drop), &dos[i][0], g, acc_v);
      axpy_quarter<D>(ds, &qs[i][0], g, acc_k);
    }
  }
  if (kj < Sk) {
    store_quarter<T, D>(dk + ((size_t)bh * Sk + kj) * D, g, sm_scale, acc_k);
    store_quarter<T, D>(dv + ((size_t)bh * Sk + kj) * D, g, 1.f, acc_v);
  }
}

template <typename T, int D, int BS>
int launch(const void* q, const void* k, const void* v, const int* kv_mask,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Sq, int Sk, int causal,
           float sm_scale, int dropout, uint32_t threshold, float keep,
           uint32_t seed, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  if (dq != nullptr) {
    const dim3 grid((Sq + kRows - 1) / kRows, B * H);
    flash_bwd_dq_kernel<T, D, BS><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, kv_mask, dt, lse, delta, static_cast<T*>(dq), H, Sq, Sk,
        causal, sm_scale, dropout, threshold, keep, seed);
  } else {
    const dim3 grid((Sk + kRows - 1) / kRows, B * H);
    flash_bwd_dkv_kernel<T, D, BS><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, kv_mask, dt, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Sq, Sk, causal, sm_scale, dropout, threshold,
        keep, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory per block: 2 * BS * D * 4 bytes = 32 KB for both D.
int dispatch(const void* q, const void* k, const void* v, const int* kv_mask,
             const void* dout, const float* lse, const float* delta, void* dq,
             void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
             int dtype, int causal, float sm_scale, int dropout,
             uint32_t threshold, float keep, uint32_t seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
#define DS_FLASH_BWD(T, DIM, BS)                                            \
  return launch<T, DIM, BS>(q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, \
                            B, H, Sq, Sk, causal, sm_scale, dropout,        \
                            threshold, keep, seed, s)
  if (dtype == 0 && D == 64) DS_FLASH_BWD(float, 64, 64);
  if (dtype == 0 && D == 128) DS_FLASH_BWD(float, 128, 32);
  if (dtype == 1 && D == 64) DS_FLASH_BWD(__nv_bfloat16, 64, 64);
  if (dtype == 1 && D == 128) DS_FLASH_BWD(__nv_bfloat16, 128, 32);
  if (dtype == 2 && D == 64) DS_FLASH_BWD(__half, 64, 64);
  if (dtype == 2 && D == 128) DS_FLASH_BWD(__half, 128, 32);
#undef DS_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16; D 64 or 128 (the wrapper
// checks). lse and
// delta are [B, H, Sq] float32. dropout as in ds_flash_fwd.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const int* kv_mask, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               int B, int H, int Sq, int Sk, int D, int dtype,
                               int causal, float sm_scale, int dropout,
                               unsigned int threshold, float keep,
                               unsigned int seed, void* stream) {
  return dispatch(q, k, v, kv_mask, dout, lse, delta, dq, nullptr, nullptr, B,
                  H, Sq, Sk, D, dtype, causal, sm_scale, dropout, threshold,
                  keep, seed, stream);
}

extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const int* kv_mask, const void* dout,
                                const float* lse, const float* delta, void* dk,
                                void* dv, int B, int H, int Sq, int Sk, int D,
                                int dtype, int causal, float sm_scale,
                                int dropout, unsigned int threshold, float keep,
                                unsigned int seed, void* stream) {
  return dispatch(q, k, v, kv_mask, dout, lse, delta, nullptr, dk, dv, B, H,
                  Sq, Sk, D, dtype, causal, sm_scale, dropout, threshold, keep,
                  seed, stream);
}
