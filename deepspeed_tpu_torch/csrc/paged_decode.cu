// paged_decode.cu — single-query attention over the paged KV pool, written
// by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/decode_attention.py, the Pallas kernel
// _flash_decode_kernel (launched by paged_flash_decode). Same function:
// for each slot b and head h, softmax(q . k * scale) v over the keys of
// the slot's logical pages j with j * block_size <= positions[b], read in
// place from the pool through the block table (page j of slot b lives at
// physical page block_tables[b, j]); a page whose physical id is 0 (the
// NULL page: dead slots, unallocated table entries, wherever it sits in
// the table) is skipped whole, keys past positions[b] are masked, and a
// slot with no visible key is written as exact zeros. The caller has
// already written this step's k/v into the pool.
//
// What bounds it on the H100: one query per slot and head makes this a
// matrix-vector product: 4 flops per key element against the 2-4 bytes
// that element costs to read, far below the ~295 flops/byte ridge. The
// bound is the live K/V bytes (the keys up to each slot's position) over
// 3.35 TB/s.
//
// What this design does about it: it reads each live K/V element once,
// from the pool in place — no gathered [B, heads, max_len, hd] copy, no
// pages past a slot's position, no NULL pages. One thread block per
// (head, slot) reads its own block-table row and position (the TPU
// kernel's scalar prefetch); its 8 warps take the slot's pages in turn
// (page j to warp j % 8) so eight pages stream at once, and within a page
// four lanes share a token (a contiguous 64-128 byte slice of its key
// row each) so a warp scores eight tokens per pass with all loads issued
// together. Each warp keeps its own online softmax (running max, sum and
// value accumulator in float32 registers) and the warps merge through
// shared memory at the end. A slot's context is split across one block
// only: splitting a long context across blocks (flash-decoding) is later
// work.
//
// Numerics follow the TPU kernel: float32 scores and softmax state, p
// rounded to the pool's type before the value product, masked scores
// -1e30 contributing exactly 0.
//
// C interface: ds_paged_decode(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerToken = 4;
constexpr int kTokensPerPass = 32 / kLanesPerToken;  // 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// N consecutive elements at p (16-byte aligned; N * sizeof(T) a multiple
// of 16) into float registers, with 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* out) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "row slice must be whole 16-byte vectors");
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < N / kPer; ++i) {
    const uint4 raw = __ldg(src + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f32(e[j]);
  }
}

__device__ __forceinline__ float warp_max_over_tokens(float x) {
  // lanes 4t..4t+3 hold token t's value: reduce across tokens
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
  return x;
}

__device__ __forceinline__ float warp_sum_over_tokens(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// HD: head dim (64 or 128)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ positions, T* __restrict__ out,
                    int heads, int block_size, int max_blocks,
                    float sm_scale) {
  constexpr int kDPL = HD / kLanesPerToken;  // score dims per lane: 16/32
  constexpr int kDV = HD / 32;               // value dims per lane: 2/4
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tok_lane = lane / kLanesPerToken;  // token within a pass
  const int sub = lane % kLanesPerToken;       // slice of the key row
  const int pos = positions[b];
  const size_t tok_stride = (size_t)heads * HD;
  const size_t page_stride = (size_t)block_size * tok_stride;

  float qr[kDPL];
  load_row<T, kDPL>(q + ((size_t)b * heads + h) * HD + sub * kDPL, qr);

  float m = kNegInf;
  float l = 0.f;
  float acc[kDV];
#pragma unroll
  for (int e = 0; e < kDV; ++e) acc[e] = 0.f;

  const int n_pages = pos >= 0 ? min(max_blocks, pos / block_size + 1) : 0;
  for (int j = warp; j < n_pages; j += kWarps) {
    const int phys = block_tables[(size_t)b * max_blocks + j];
    if (phys == 0) continue;  // the NULL page: skipped whole (warp-uniform)
    const T* kp = k_pool + (size_t)phys * page_stride + (size_t)h * HD;
    const T* vp = v_pool + (size_t)phys * page_stride + (size_t)h * HD;
    for (int t0 = 0; t0 < block_size; t0 += kTokensPerPass) {
      const int t = t0 + tok_lane;
      const int tok = j * block_size + t;
      float part = 0.f;
      if (t < block_size) {
        float kr[kDPL];
        load_row<T, kDPL>(kp + (size_t)t * tok_stride + sub * kDPL, kr);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) part = fmaf(qr[i], kr[i], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const bool ok = t < block_size && tok <= pos;
      const float s = ok ? part * sm_scale : kNegInf;
      const float m_new = fmaxf(m, warp_max_over_tokens(s));
      const float alpha = expf(m - m_new);
      const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
      // each token's p sits on its 4 lanes; summing across tokens (xor
      // 4, 8, 16) adds one copy per token, on every lane
      l = l * alpha + warp_sum_over_tokens(p);
      const float pu = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < kDV; ++e) acc[e] *= alpha;
#pragma unroll
      for (int tt = 0; tt < kTokensPerPass; ++tt) {
        const float pt = __shfl_sync(0xffffffffu, pu, tt * kLanesPerToken);
        if (t0 + tt < block_size) {  // warp-uniform
          const T* vr = vp + (size_t)(t0 + tt) * tok_stride + lane * kDV;
#pragma unroll
          for (int e = 0; e < kDV; ++e) {
            acc[e] = fmaf(pt, to_f32(vr[e]), acc[e]);
          }
        }
      }
      m = m_new;
    }
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kDV; ++e) sm_acc[warp][lane * kDV + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);
      lsum += sm_l[w] * f;
      a += sm_acc[w][d] * f;
    }
    if (lsum == 0.f) lsum = 1.f;  // no visible key -> exact zeros
    out[((size_t)b * heads + h) * HD + d] = from_f32<T>(a / lsum);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const int* block_tables, const int* positions, void* out, int B,
            int heads, int block_size, int max_blocks, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(heads, B);
  paged_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, positions,
      static_cast<T*>(out), heads, block_size, max_blocks, sm_scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. hd must be 64 or 128 (the wrapper checks).
extern "C" int ds_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const int* block_tables,
                               const int* positions, void* out, int B,
                               int heads, int hd, int block_size,
                               int max_blocks, int dtype, float sm_scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || heads <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0 && hd == 64) {
    launch<float, 64>(q, k_pool, v_pool, block_tables, positions, out, B,
                      heads, block_size, max_blocks, sm_scale, s);
  } else if (dtype == 0 && hd == 128) {
    launch<float, 128>(q, k_pool, v_pool, block_tables, positions, out, B,
                       heads, block_size, max_blocks, sm_scale, s);
  } else if (dtype == 1 && hd == 64) {
    launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables, positions,
                              out, B, heads, block_size, max_blocks,
                              sm_scale, s);
  } else if (dtype == 1 && hd == 128) {
    launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables, positions,
                               out, B, heads, block_size, max_blocks,
                               sm_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
