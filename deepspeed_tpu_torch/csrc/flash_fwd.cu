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
// What bounds it on the H100: attention at the GPT-2 prefill shape
// (B=1, H=12, S=1024, D=64, causal) is 2*2*B*H*S^2*D/2 = 1.6 GFLOP over
// (3+1)*B*H*S*D elements of traffic (q, k, v in, out written): in bf16
// that is 1.6 us of tensor-core time at 989 TFLOP/s against 1.9 us of
// HBM time at 3.35 TB/s, so the kernel should sit near the
// compute/bandwidth ridge and neither a large working set nor the score
// matrix may touch device memory.
//
// What this design does about it: the S x S score matrix never leaves
// registers. One thread block owns (b*h, a tile of BQ = 32 query rows);
// a loop inside the block walks the K/V tiles (replacing the TPU grid's
// sequential ik axis) and stops at the diagonal tile under causal, so
// causal attention does half the work. Each K/V tile is staged once in
// shared memory as float32 and read by all 32 rows of the block. Four
// threads share a query row: each holds a quarter of q and of the output
// accumulator in registers and the dot products are finished with two
// warp shuffles. Query tiles are issued heaviest-first (last tiles have
// the most keys under causal) to balance the tail. This first version
// multiplies with FMA on the CUDA cores, not the tensor cores (no
// mma/wgmma, no TMA): simple and right first; the tensor-core version is
// later work, and its distance from the bound is in PERF.md.
//
// Numerics follow the TPU kernel: scores, m, l and the accumulator in
// float32 whatever the input type; p is rounded to the input type before
// the value product (the TPU kernel's p.astype(v.dtype)); masked scores
// are -1e30 and contribute exactly 0.
//
// C interface: ds_flash_fwd(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGroup = 4;                  // threads per query row
constexpr int kBQ = 32;                    // query rows per block
constexpr int kThreads = kBQ * kGroup;     // 128

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

// x rounded to T's precision and back (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// D: head dim (64 or 128); BK: keys per staged tile. Shared memory is
// 2 * BK * D * 4 bytes = 32 KB for both instantiations.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, float sm_scale, int dropout,
                 uint32_t threshold, float keep, uint32_t seed) {
  constexpr int kDPT = D / kGroup;   // dims per thread (16 or 32)
  constexpr int kChunks = kDPT / 4;  // float4 chunks per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ int valid_s[BK];

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int row = tid / kGroup;
  const int g = tid % kGroup;  // this thread's quarter of the row
  const int qi = qt * kBQ + row;
  const bool row_ok = qi < Sq;
  const int diag = Sk - Sq;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  // the thread's dims: float4 chunks c = g + kGroup * i, i < kChunks
  // (the four threads of a row read 64 contiguous bytes of a K/V row)
  float qr[kDPT];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (g + kGroup * i) + e;
      qr[4 * i + e] = row_ok ? to_f32(qb[(size_t)qi * D + d]) : 0.f;
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
        kx = to_f32(kb[(size_t)kj * D + c]);
        vx = to_f32(vb[(size_t)kj * D + c]);
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
        const float4 x = kr[g + kGroup * i];
        part = fmaf(qr[4 * i + 0], x.x, part);
        part = fmaf(qr[4 * i + 1], x.y, part);
        part = fmaf(qr[4 * i + 2], x.z, part);
        part = fmaf(qr[4 * i + 3], x.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
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
      float pu;
      if (dropout) {  // the TPU kernel's where(keep, p / (1 - rate), 0)
        pu = dropout_keep(row_key, k0 + j, threshold) ? round_to<T>(p / keep)
                                                      : 0.f;
      } else {
        pu = round_to<T>(p);
      }
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 x = vr[g + kGroup * i];
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
    T* orow = out + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[4 * (g + kGroup * i) + e] = from_f32<T>(acc[4 * i + e] / ld);
      }
    }
    if (g == 0) lse[(size_t)bh * Sq + qi] = m + logf(ld);
  }
}

template <typename T, int D, int BK>
void launch(const void* q, const void* k, const void* v, const int* kv_mask,
            void* out, float* lse, int B, int H, int Sq, int Sk, int causal,
            float sm_scale, int dropout, uint32_t threshold, float keep,
            uint32_t seed, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_mask, static_cast<T*>(out), lse, H, Sq, Sk,
      causal, sm_scale, dropout, threshold, keep, seed);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. D must be 64 or 128 (the
// wrapper checks). dropout: 0 off; else keep a pair when its bits >=
// threshold and divide the kept probabilities by keep = 1 - rate.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const int* kv_mask, void* out, float* lse, int B,
                            int H, int Sq, int Sk, int D, int dtype,
                            int causal, float sm_scale, int dropout,
                            unsigned int threshold, float keep,
                            unsigned int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B * H <= 0) return static_cast<int>(cudaGetLastError());
#define DS_FLASH_FWD(T, DIM, BK)                                          \
  launch<T, DIM, BK>(q, k, v, kv_mask, out, lse, B, H, Sq, Sk, causal,     \
                     sm_scale, dropout, threshold, keep, seed, s)
  if (dtype == 0 && D == 64) {
    DS_FLASH_FWD(float, 64, 64);
  } else if (dtype == 0 && D == 128) {
    DS_FLASH_FWD(float, 128, 32);
  } else if (dtype == 1 && D == 64) {
    DS_FLASH_FWD(__nv_bfloat16, 64, 64);
  } else if (dtype == 1 && D == 128) {
    DS_FLASH_FWD(__nv_bfloat16, 128, 32);
  } else if (dtype == 2 && D == 64) {
    DS_FLASH_FWD(__half, 64, 64);
  } else if (dtype == 2 && D == 128) {
    DS_FLASH_FWD(__half, 128, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_FLASH_FWD
  return static_cast<int>(cudaGetLastError());
}
