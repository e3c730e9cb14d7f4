// lamb_phase1.cu — phase 1 of fused LAMB, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas.py, the Pallas kernel
// _lamb_phase1_kernel, at both of its launch sites (lamb_leaf_update: one
// leaf per launch; lamb_multi_tensor_update: many small leaves packed into
// one launch with a block -> segment map). Same function, per element:
//   g  = round_to_G(f32(g) * grad_scale)   (the JAX FusedLamb pre-scales
//                                           the grads in their own dtype)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)   or / sqrt(v' / c2 + eps)
//   u += weight_decay * p                    (when weight_decay != 0)
// and per block the partial sums of p*p and u*u. Phase 2 (the per-group
// sum of the partials, then the clamped trust ratio) and phase 3
// (p -= lr * ratio * u) stay in PyTorch, as the JAX package leaves them
// to XLA.
//
// Layout: instead of the TPU's one padded [rows, 128] buffer, the kernel
// reads a device table of tensor descriptors (p, g, m, v, u pointers,
// length, first block). Every tensor covers ceil(n / kBlock) blocks of the
// grid; a block finds its tensor by a binary search over first_block and
// masks the ragged end itself. m and v are updated IN PLACE in the
// optimizer state (the JAX kernel returns new arrays); u is written to a
// scratch buffer the size of p.
//
// What bounds it on the H100: nothing is reused, so bytes. Per element it
// reads p, m, v (f32) and g (f32, bf16 or fp16) and writes m, v, u (f32):
// 28 B with f32 grads, 26 B with 16-bit ones. For GPT-2 small (124M parameters) that
// is ~3.5 GB, 1.0 ms at 3.35 TB/s.
//
// What this design does about it: one pass, every element touched once,
// 256 threads each walking the block's 4096 elements at a stride of the
// block width (coalesced 4-byte accesses), the two partial sums kept in
// registers and reduced with warp shuffles and one shared-memory step.
// Products and sums use the _rn intrinsics so nvcc does not contract them
// into FMAs: the element results then follow the plain PyTorch version's
// roundings (m and v exactly; u to an ulp, where PyTorch divides by a
// scalar through its reciprocal), and the partial sums differ only in
// summation order.
//
// C interface: ds_lamb_phase1(...) launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 4096;  // elements per block (matches fused_lamb.BLOCK)

struct LambTensor {
  const float* p;
  const void* g;
  float* m;
  float* v;
  float* u;
  long long n;
  long long first_block;
  long long pad;  // 64-byte descriptors
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
// x rounded to the grad type's precision and back (identity for float)
template <typename G>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const LambTensor* __restrict__ table, int ntensors,
                   float* __restrict__ wsq, float* __restrict__ usq, float c1,
                   float c2, float grad_scale, float b1, float omb1, float b2,
                   float omb2, float eps, float weight_decay,
                   int eps_inside_sqrt) {
  const long long blk = blockIdx.x;
  int lo = 0, hi = ntensors - 1;
  while (lo < hi) {  // last tensor whose first block is <= blk
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  const LambTensor t = table[lo];
  const G* g = static_cast<const G*>(t.g);
  const long long start = (blk - t.first_block) * kBlock;

  float wacc = 0.f, uacc = 0.f;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const long long idx = start + i;
    if (idx >= t.n) break;
    const float p = t.p[idx];
    const float gs = round_to<G>(__fmul_rn(to_f32(g[idx]), grad_scale));
    const float m = __fadd_rn(__fmul_rn(b1, t.m[idx]), __fmul_rn(omb1, gs));
    const float v = __fadd_rn(__fmul_rn(b2, t.v[idx]),
                              __fmul_rn(__fmul_rn(omb2, gs), gs));
    const float denom = eps_inside_sqrt
                            ? sqrtf(__fadd_rn(__fdiv_rn(v, c2), eps))
                            : __fadd_rn(sqrtf(__fdiv_rn(v, c2)), eps);
    float u = __fdiv_rn(__fdiv_rn(m, c1), denom);
    if (weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(weight_decay, p));
    t.m[idx] = m;
    t.v[idx] = v;
    t.u[idx] = u;
    wacc = fmaf(p, p, wacc);
    uacc = fmaf(u, u, uacc);
  }

  // block reduction: warp shuffles, then one value per warp in shared memory
  __shared__ float ws[kThreads / 32], us[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wacc += __shfl_xor_sync(0xffffffffu, wacc, off);
    uacc += __shfl_xor_sync(0xffffffffu, uacc, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ws[warp] = wacc;
    us[warp] = uacc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float w = 0.f, u = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      w += ws[i];
      u += us[i];
    }
    wsq[blk] = w;
    usq[blk] = u;
  }
}

}  // namespace

// table: ntensors LambTensor descriptors on the device; nblocks = the
// table's total block count. gdtype: 0 float32 grads, 1 bfloat16, 2
// float16.
extern "C" int ds_lamb_phase1(const void* table, int ntensors, int nblocks,
                              float* wsq, float* usq, int gdtype, float c1,
                              float c2, float grad_scale, float b1, float omb1,
                              float b2, float omb2, float eps,
                              float weight_decay, int eps_inside_sqrt,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks <= 0 || ntensors <= 0) return static_cast<int>(cudaGetLastError());
  const LambTensor* t = static_cast<const LambTensor*>(table);
  if (gdtype == 0) {
    lamb_phase1_kernel<float><<<nblocks, kThreads, 0, s>>>(
        t, ntensors, wsq, usq, c1, c2, grad_scale, b1, omb1, b2, omb2, eps,
        weight_decay, eps_inside_sqrt);
  } else if (gdtype == 1) {
    lamb_phase1_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        t, ntensors, wsq, usq, c1, c2, grad_scale, b1, omb1, b2, omb2, eps,
        weight_decay, eps_inside_sqrt);
  } else if (gdtype == 2) {
    lamb_phase1_kernel<__half><<<nblocks, kThreads, 0, s>>>(
        t, ntensors, wsq, usq, c1, c2, grad_scale, b1, omb1, b2, omb2, eps,
        weight_decay, eps_inside_sqrt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
