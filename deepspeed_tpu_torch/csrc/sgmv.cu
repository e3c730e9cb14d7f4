// sgmv.cu — the multi-LoRA decode product (Punica's SGMV shape), written by
// hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/decode_attention.py, the Pallas kernel
// _sgmv_kernel (launched by lora_sgmv). Same function: for each slot b with
// adapter id = ids[b],
//   t      = x[b] . A[id]          (accumulated in float32)
//   t      = round(t to A/B's type) (the TPU kernel's t.astype(b.dtype))
//   out[b] = t . B[id]             (accumulated and stored in float32)
// with x [B, in], the A pool [rows, in, r] and the B pool [rows, r, out]
// read in place by the slot's id: no gathered [B, in, r] / [B, r, out]
// weight stacks. Row 0 of both pools is the all-zeros identity adapter;
// id 0 writes exact zeros without reading the pool. An id outside
// [0, rows) writes NaNs (the engine never hands one out; NaN makes a bug
// loud instead of reading another tenant's rows or out of bounds).
//
// What bounds it on the H100: two skinny products, 2*(in*r + r*out) flops
// a slot against the in*r + r*out adapter elements they read once: a
// matrix-vector product, far below the ~295 flops/byte ridge. The bound is
// the bytes of the distinct adapter rows of the batch, plus x and out,
// over 3.35 TB/s: about a third of a microsecond for GPT-2 small's widest
// target at rank 16, B = 8. Launch latency, not bytes, sets its time.
//
// What this design does about it: it is the simple design that is right.
// One thread block per (slot, tile of 1024 output columns) reads its own
// slot's id (the TPU kernel's scalar prefetch). Phase 1: the block's 256
// threads stride over `in`, each accumulating float32 partials of up to 16
// rank columns at a time (neighbouring threads read neighbouring A rows, so
// a warp's loads are contiguous), then a warp-shuffle and shared-memory
// reduction leaves t, rounded to the storage type, in shared memory.
// Phase 2: threads own output columns and loop over r, so each B row is
// read coalesced. A block of a wide target recomputes t for its own tile
// (the A row comes from L2 after the first tile). Nothing is read back to
// the host.
//
// C interface: ds_sgmv(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;      // rank columns accumulated per pass
constexpr int kTileOut = 1024;  // output columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_kernel(const T* __restrict__ x, const T* __restrict__ a_pool,
            const T* __restrict__ b_pool, const int* __restrict__ ids,
            float* __restrict__ out, int rows, int din, int rank, int dout) {
  extern __shared__ float t_smem[];  // [rank]: t in the storage type's values
  __shared__ float red[kWarps][kChunk];

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kTileOut;
  const int col1 = min(col0 + kTileOut, dout);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* o = out + (size_t)b * dout;

  const int id = ids[b];
  if (id == 0 || id < 0 || id >= rows) {
    // the identity row gives exact zeros; an invalid id is made loud
    const float fill = id == 0 ? 0.f : nanf("");
    for (int c = col0 + threadIdx.x; c < col1; c += kThreads) o[c] = fill;
    return;
  }
  const T* xb = x + (size_t)b * din;
  const T* A = a_pool + (size_t)id * din * rank;
  const T* B = b_pool + (size_t)id * rank * dout;

  // ---- phase 1: t = x . A[id], float32 accumulation, rounded to T ----
  for (int c0 = 0; c0 < rank; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
    const int nc = min(kChunk, rank - c0);
    for (int i = threadIdx.x; i < din; i += kThreads) {
      const float xi = to_f32(xb[i]);
      const T* arow = A + (size_t)i * rank + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < nc) acc[j] = fmaf(xi, to_f32(arow[j]), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < nc) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      t_smem[c0 + threadIdx.x] = round_to<T>(s);
    }
    __syncthreads();
  }

  // ---- phase 2: out = t . B[id] over this block's output columns ----
  for (int c = col0 + threadIdx.x; c < col1; c += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < rank; ++k) {
      acc = fmaf(t_smem[k], to_f32(B[(size_t)k * dout + c]), acc);
    }
    o[c] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* a_pool, const void* b_pool,
           const int* ids, float* out, int B, int rows, int din, int rank,
           int dout, cudaStream_t stream) {
  const size_t smem = (size_t)rank * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((dout + kTileOut - 1) / kTileOut, B);
  sgmv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_pool),
      static_cast<const T*>(b_pool), ids, out, rows, din, rank, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, A and B share it; out is float32).
// rank * 4 bytes of t must fit 48 KB of shared memory: rank <= 12288, the
// wrapper's SGMV_MAX_RANK (ops/decode_attention.py) checks the same limit.
extern "C" int ds_sgmv(const void* x, const void* a_pool, const void* b_pool,
                       const int* ids, float* out, int B, int rows, int din,
                       int rank, int dout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || dout <= 0) return static_cast<int>(cudaGetLastError());
  if (rank <= 0 || din <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(x, a_pool, b_pool, ids, out, B, rows, din, rank,
                         dout, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, a_pool, b_pool, ids, out, B, rows, din,
                                 rank, dout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
