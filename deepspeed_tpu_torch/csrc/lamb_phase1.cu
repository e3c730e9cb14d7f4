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
// and per block of kBlock elements the partial sums of p*p and u*u. Phase
// 2 (the per-group sum of the partials, then the clamped trust ratio) and
// phase 3 (p -= lr * ratio * u) stay in PyTorch, as the JAX package leaves
// them to XLA.
//
// Layout: instead of the TPU's one padded [rows, 128] buffer, the kernel
// reads a device table of tensor descriptors (p, g, m, v, u pointers,
// length, first block, a vector flag) and an int32 block -> tensor map.
// Every tensor covers ceil(n / kBlock) blocks of the grid; a block reads
// its tensor's index from the map (no search) and masks the ragged end
// itself. The wrapper builds both once per set of tensors and keeps them
// on the device (ops/fused_lamb.py), so a step whose tensors have not
// moved uploads nothing. m and v are updated IN PLACE in the optimizer
// state (the JAX kernel returns new arrays); u is written to a scratch
// buffer the size of p.
//
// What bounds it on the H100: nothing is reused, so bytes. Per element it
// reads p, m, v (f32) and g (f32, bf16 or fp16) and writes m, v, u (f32):
// 28 B with f32 grads, 26 B with 16-bit ones. For GPT-2 small (124M
// parameters) that is ~3.5 GB, 1.04 ms at 3.35 TB/s.
//
// What this design does about it: one pass, every element touched once,
// with 16-byte accesses and the loads in flight together. Each of the 256
// threads of a block owns 4 vectors of 4 elements at a stride of 1024
// elements; it issues all 16 loads (p, m and v as float4, g as a float4 or
// an 8-byte vector of 16-bit values) before any arithmetic, then stores
// m, v and u as float4. A tensor whose pointers are not 16-byte aligned
// (8-byte for 16-bit grads) or whose length is not a multiple of 4 is
// flagged scalar in its descriptor and walked a 4-byte element at a time,
// coalesced. The two partial sums are kept in registers and reduced with
// warp shuffles and one shared-memory step. Products and sums use the _rn
// intrinsics so nvcc does not contract them into FMAs, and m / c1 and
// v / c2 are products with the float32 reciprocals (the wrapper passes
// 1/c1 and 1/c2), as PyTorch's CUDA ops divide by a scalar: the element
// results then equal the plain PyTorch version's on the card bit for bit
// (m, v and u), and the partial sums differ only in summation order.
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
constexpr int kVecs = kBlock / (4 * kThreads);  // float4s a thread: 4

struct LambTensor {
  const float* p;
  const void* g;
  float* m;
  float* v;
  float* u;
  long long n;
  long long first_block;
  long long vec;  // 1: every pointer aligned for its vector, n % 4 == 0
};
static_assert(sizeof(LambTensor) == 64, "64-byte descriptors");

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

// a 16-bit grad from its bits
template <typename G>
__device__ __forceinline__ float from_bits(uint32_t bits);
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact
}
template <>
__device__ __forceinline__ float from_bits<__half>(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

// 4 grads from g + i (i a multiple of 4): one 16-byte load for float, one
// 8-byte load for the 16-bit types
template <typename G>
struct Grad4 {
  uint2 raw;
  __device__ __forceinline__ void load(const G* g, long long i) {
    raw = __ldg(reinterpret_cast<const uint2*>(g + i));
  }
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = e < 2 ? raw.x : raw.y;
    return from_bits<G>((e & 1) ? (w >> 16) : (w & 0xffffu));
  }
};
template <>
struct Grad4<float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* g, long long i) {
    raw = __ldg(reinterpret_cast<const float4*>(g + i));
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? raw.x : e == 1 ? raw.y : e == 2 ? raw.z : raw.w;
  }
};

__device__ __forceinline__ float& lane(float4& f, int e) {
  return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
}

struct Hyper {
  float inv_c1, inv_c2, grad_scale, b1, omb1, b2, omb2, eps, weight_decay;
  int eps_inside_sqrt;
};

// one element's update; returns u, writes m and v
template <typename G>
__device__ __forceinline__ float update(const Hyper& h, float p, float graw,
                                        float& m, float& v) {
  const float gs = round_to<G>(__fmul_rn(graw, h.grad_scale));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gs));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
  // m / c1 and v / c2 as PyTorch's CUDA ops compute a division by a
  // scalar: a product with the float32 reciprocal
  const float denom = h.eps_inside_sqrt
                          ? sqrtf(__fadd_rn(__fmul_rn(v, h.inv_c2), h.eps))
                          : __fadd_rn(sqrtf(__fmul_rn(v, h.inv_c2)), h.eps);
  float u = __fdiv_rn(__fmul_rn(m, h.inv_c1), denom);
  if (h.weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(h.weight_decay, p));
  return u;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const LambTensor* __restrict__ table,
                   const int* __restrict__ block_map, float* __restrict__ wsq,
                   float* __restrict__ usq, Hyper h) {
  const int blk = blockIdx.x;
  const LambTensor t = table[block_map[blk]];
  const G* g = static_cast<const G*>(t.g);
  const long long start = (blk - t.first_block) * (long long)kBlock;

  float wacc = 0.f, uacc = 0.f;
  if (t.vec) {
    // every load of the thread's 4 vectors first, then the arithmetic
    float4 pv[kVecs], mv[kVecs], vv[kVecs];
    Grad4<G> gv[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = start + 4 * (threadIdx.x + j * kThreads);
      if (i < t.n) {  // n % 4 == 0: the whole vector
        pv[j] = __ldg(reinterpret_cast<const float4*>(t.p + i));
        mv[j] = *reinterpret_cast<const float4*>(t.m + i);
        vv[j] = *reinterpret_cast<const float4*>(t.v + i);
        gv[j].load(g, i);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long i = start + 4 * (threadIdx.x + j * kThreads);
      if (i >= t.n) break;
      float4 uv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lane(pv[j], e);
        const float u = update<G>(h, p, gv[j].at(e), lane(mv[j], e),
                                  lane(vv[j], e));
        lane(uv, e) = u;
        wacc = fmaf(p, p, wacc);
        uacc = fmaf(u, u, uacc);
      }
      *reinterpret_cast<float4*>(t.m + i) = mv[j];
      *reinterpret_cast<float4*>(t.v + i) = vv[j];
      *reinterpret_cast<float4*>(t.u + i) = uv;
    }
  } else {
    for (int k = threadIdx.x; k < kBlock; k += kThreads) {
      const long long i = start + k;
      if (i >= t.n) break;
      const float p = t.p[i];
      float m = t.m[i], v = t.v[i];
      const float u = update<G>(h, p, to_f32(g[i]), m, v);
      t.m[i] = m;
      t.v[i] = v;
      t.u[i] = u;
      wacc = fmaf(p, p, wacc);
      uacc = fmaf(u, u, uacc);
    }
  }

  // block reduction: warp shuffles, then one value per warp in shared memory
  __shared__ float ws[kThreads / 32], us[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wacc += __shfl_xor_sync(0xffffffffu, wacc, off);
    uacc += __shfl_xor_sync(0xffffffffu, uacc, off);
  }
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  if (ln == 0) {
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

// table: LambTensor descriptors on the device; block_map: nblocks int32
// tensor indices (block b belongs to tensor block_map[b], whose first
// block is table[block_map[b]].first_block); nblocks = the table's total
// block count. gdtype: 0 float32 grads, 1 bfloat16, 2 float16. inv_c1,
// inv_c2: the float32 reciprocals of the bias corrections.
extern "C" int ds_lamb_phase1(const void* table, const int* block_map,
                              int nblocks, float* wsq, float* usq, int gdtype,
                              float inv_c1, float inv_c2, float grad_scale,
                              float b1,
                              float omb1, float b2, float omb2, float eps,
                              float weight_decay, int eps_inside_sqrt,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks <= 0) return static_cast<int>(cudaGetLastError());
  const LambTensor* t = static_cast<const LambTensor*>(table);
  const Hyper h{inv_c1, inv_c2, grad_scale, b1, omb1, b2, omb2, eps,
                weight_decay, eps_inside_sqrt};
  if (gdtype == 0) {
    lamb_phase1_kernel<float><<<nblocks, kThreads, 0, s>>>(t, block_map, wsq,
                                                           usq, h);
  } else if (gdtype == 1) {
    lamb_phase1_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        t, block_map, wsq, usq, h);
  } else if (gdtype == 2) {
    lamb_phase1_kernel<__half><<<nblocks, kThreads, 0, s>>>(t, block_map,
                                                            wsq, usq, h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
