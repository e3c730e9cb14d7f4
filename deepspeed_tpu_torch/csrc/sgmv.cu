// sgmv.cu — the multi-LoRA decode product (Punica's SGMV shape), written by
// hand for Hopper (sm_90a), with the LoRA add as an optional epilogue.
//
// Replaces: deepspeed_tpu/ops/decode_attention.py, the Pallas kernel
// _sgmv_kernel (launched by lora_sgmv). Same function: for each slot b with
// adapter id = ids[b],
//   t      = x[b] . A[id]          (accumulated in float32)
//   t      = round(t to A/B's type) (the TPU kernel's t.astype(b.dtype))
//   delta  = t . B[id]             (accumulated in float32)
// with x [B, in], the A pool [rows, in, r] and the B pool [rows, r, out]
// read in place by the slot's id: no gathered [B, in, r] / [B, r, out]
// weight stacks. Row 0 of both pools is the all-zeros identity adapter;
// id 0 gives exact zeros without reading the pool. An id outside
// [0, rows) gives NaNs (the engine never hands one out; NaN makes a bug
// loud instead of reading another tenant's rows or out of bounds).
// ds_sgmv stores delta in float32 (the JAX lora_sgmv's contract).
// ds_sgmv_add stores instead, in y's type T,
//   y_out = round_T(f32(y) + f32(round_T(scale * delta)))
// which is bit for bit what `y + (scale * delta).to(T)` computes in
// PyTorch (and the JAX package's `y + (scale * delta).astype(y.dtype)`):
// the scale, cast and add of apply_lora without three more launches.
//
// What bounds it on the H100: two skinny products, 2*(in*r + r*out) flops
// a slot against the in*r + r*out adapter elements they read once: a
// matrix-vector product, far below the ~295 flops/byte ridge. The bound is
// the bytes of the distinct adapter rows of the batch, plus x and the
// output, over 3.35 TB/s: about 0.2 us for GPT-2 small's widest target at
// rank 16, B = 8, far under one launch's fixed latency. So the aim is a
// kernel whose time is close to the launch floor: enough blocks, and each
// thread's loads issued together, so that a block pays two or three memory
// latencies and no more.
//
// The design:
// - Grid (tiles of kTileOut = 256 output columns, slots): 96 blocks at
//   inter_w's 3072 columns and B = 8, 24 at 768 columns. Each block reads
//   its slot's id itself (the TPU kernel's scalar prefetch) and recomputes
//   t for its tile; A[id] comes from L2 after the first tile. Each thread
//   first asks L2 for the B vectors of phase 2 and the A rows of phase 1's
//   later passes (prefetch.global.L2), so that the block's memory
//   latencies overlap instead of following one another.
// - Phase 1 (t = x . A[id]): where an A row is a power of two of 16-byte
//   vectors, at most 32 (rank 8..256 in bf16, 4..128 in f32) and the pool
//   is 16-byte aligned, the block's 256 threads cover the rows as
//   [rows a pass][vectors a row]; each thread issues the 16-byte loads of
//   kUnrollA rows (and their x elements) before it uses any, accumulates
//   its vector's columns in float32, and the partials reduce with xor
//   shuffles across the lanes that share a vector, then across warps in
//   one shared-memory step for the whole rank: two barriers in all. Other
//   ranks take a scalar path (16 rank columns a pass, two barriers a pass).
//   t is rounded to T in shared memory.
// - Phase 2 (delta = t . B[id]): where `out` is a multiple of a 16-byte
//   vector and the pool is aligned, a thread owns one vector of 8 bf16 (4
//   f32) output columns of the tile and a 1/G share of the rank rows (G = 8
//   in bf16, 4 in f32), issues kUnrollB independent 16-byte loads of B rows
//   before it uses any, and the G partial sums of each column add in
//   shared memory in a fixed order. Otherwise a thread owns one column and
//   all rank rows (independent scalar loads).
// - Tensor cores are deliberately not used: at decode batch sizes an
//   adapter serves a handful of rows, below wgmma's 64-row tile and far
//   below the ridge point, so they would only add latency.
// Every sum runs in a fixed order, so the output is the same bit for bit
// from call to call, and both entry points compute delta the same way.
//
// C interface: ds_sgmv(...) and ds_sgmv_add(...) launch on the given
// stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileOut = 256;  // output columns per block
constexpr int kChunk = 16;     // rank columns a pass of the scalar phase 1
constexpr int kUnrollA = 8;    // A rows a thread loads before using them
constexpr int kUnrollB = 4;    // B rows a thread loads before using them
// shared scratch beside t: phase 1's [kWarps][rank <= 256] partials and
// phase 2's [G][kTileOut] partials, 8 KB either way
constexpr int kScratch = 2048;
// dynamic shared memory of the largest launch: t at SGMV_MAX_RANK (48 KB)
// and the scratch
constexpr int kMaxSmem = 48 * 1024 + kScratch * 4;

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
  return __float2bfloat16(x);  // round to nearest even, as PyTorch's cast
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// a 16-byte vector of T as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[4]) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);  // bfloat16 -> float, exact
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ask L2 for the line holding p (no register, no wait)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// where the block's columns go: the float32 delta, or y's epilogue
template <typename T, bool kAdd>
struct Store {
  float* out;
  const T* y;
  T* y_out;
  float scale;
  __device__ __forceinline__ void operator()(size_t at, float delta) const {
    if (kAdd) {
      // y + (scale * delta).to(T): the product and the sum rounded apart
      const float d = round_to<T>(__fmul_rn(scale, delta));
      y_out[at] = from_f32<T>(__fadd_rn(to_f32(y[at]), d));
    } else {
      out[at] = delta;
    }
  }
};

// vec_a: phase 1 by 16-byte vectors (rank / kE a power of two <= 32, the
// pool aligned); vec_b: phase 2 by 16-byte vectors (dout a multiple of kE,
// the pool aligned)
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads)
sgmv_kernel(const T* __restrict__ x, const T* __restrict__ a_pool,
            const T* __restrict__ b_pool, const int* __restrict__ ids,
            Store<T, kAdd> store, int rows, int din, int rank, int dout,
            int vec_a, int vec_b) {
  constexpr int kE = 16 / sizeof(T);  // elements of a 16-byte vector
  extern __shared__ float smem[];     // t [rank (to a multiple of 4)], then
  float* const t_s = smem;            // the scratch
  float* const scratch = smem + ((rank + 3) & ~3);

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kTileOut;
  const int ncol = min(kTileOut, dout - col0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t orow = (size_t)b * dout + col0;

  const int id = ids[b];
  if (id == 0 || id < 0 || id >= rows) {
    // the identity row gives exact zeros; an invalid id is made loud
    const float fill = id == 0 ? 0.f : nanf("");
    for (int c = threadIdx.x; c < ncol; c += kThreads) store(orow + c, fill);
    return;
  }
  const T* xb = x + (size_t)b * din;
  const T* A = a_pool + (size_t)id * din * rank;
  const T* B = b_pool + (size_t)id * rank * dout;

  // phase 2's share of B, and phase 1's A rows past its first batch of
  // loads, requested from L2 now: their loads later find them there
  constexpr int kOwners = kTileOut / kE;  // threads that own a B vector
  constexpr int kG = kThreads / kOwners;  // rank shares of phase 2
  const int ov = threadIdx.x % kOwners;
  const int g = threadIdx.x / kOwners;
  if (vec_b && ov * kE < ncol) {
    for (int k = g; k < rank; k += kG) {
      prefetch_l2(B + (size_t)k * dout + col0 + ov * kE);
    }
  }
  if (vec_a) {
    const int krv = rank / kE;
    const int rpp = kThreads / krv;
    const T* acol = A + (threadIdx.x % krv) * kE;
    for (int i = threadIdx.x / krv + kUnrollA * rpp; i < din; i += rpp) {
      prefetch_l2(acol + (size_t)i * rank);
    }
  }

  // ---- phase 1: t = x . A[id], float32 accumulation, rounded to T ----
  if (vec_a) {
    const int krv = rank / kE;             // vectors of an A row
    const int rpp = kThreads / krv;        // rows a pass
    const int cv = threadIdx.x % krv;      // this thread's vector of a row
    const T* acol = A + cv * kE;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int i0 = threadIdx.x / krv; i0 < din; i0 += kUnrollA * rpp) {
      uint4 av[kUnrollA];
      float xv[kUnrollA];
#pragma unroll
      for (int u = 0; u < kUnrollA; ++u) {  // every load before any use
        const int i = i0 + u * rpp;
        const bool ok = i < din;
        av[u] = ok ? ldg16(acol + (size_t)i * rank) : make_uint4(0, 0, 0, 0);
        xv[u] = ok ? to_f32(xb[i]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnrollA; ++u) {
        float af[kE];
        unpack(av[u], af);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(xv[u], af[e], acc[e]);
      }
    }
    // the lanes that share a vector (lane % krv) hold partials of the same
    // columns: fold them, then one shared step across the warps
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      for (int o = krv; o < 32; o <<= 1) {
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      }
    }
    if (lane < krv) {
#pragma unroll
      for (int e = 0; e < kE; ++e) scratch[warp * rank + lane * kE + e] = acc[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < rank; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += scratch[w * rank + c];
      t_s[c] = round_to<T>(s);
    }
    __syncthreads();
  } else {
    float(*red)[kChunk] = reinterpret_cast<float(*)[kChunk]>(scratch);
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
        t_s[c0 + threadIdx.x] = round_to<T>(s);
      }
      __syncthreads();
    }
  }

  // ---- phase 2: delta = t . B[id] over this block's output columns ----
  if (vec_b) {
    static_assert(kG * kTileOut <= kScratch, "phase 2's partials fit");
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    if (ov * kE < ncol) {  // dout is a multiple of kE: the whole vector
      const T* bcol = B + col0 + ov * kE;
      for (int k0 = g; k0 < rank; k0 += kUnrollB * kG) {
        uint4 bv[kUnrollB];
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {  // every load before any use
          const int k = k0 + u * kG;
          bv[u] = k < rank ? ldg16(bcol + (size_t)k * dout)
                           : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
          const int k = k0 + u * kG;
          const float tk = k < rank ? t_s[k] : 0.f;
          float bf[kE];
          unpack(bv[u], bf);
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[e] = fmaf(tk, bf[e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) scratch[g * kTileOut + ov * kE + e] = acc[e];
    __syncthreads();
    for (int c = threadIdx.x; c < ncol; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kG; ++j) s += scratch[j * kTileOut + c];
      store(orow + c, s);
    }
  } else {
    for (int c = threadIdx.x; c < ncol; c += kThreads) {
      const T* bcol = B + col0 + c;
      float acc = 0.f;
      for (int k0 = 0; k0 < rank; k0 += kUnrollB) {
        float bv[kUnrollB];
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
          const int k = k0 + u;
          bv[u] = k < rank ? to_f32(bcol[(size_t)k * dout]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
          if (k0 + u < rank) acc = fmaf(t_s[k0 + u], bv[u], acc);
        }
      }
      store(orow + c, acc);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kAdd>
int launch(const void* x, const void* a_pool, const void* b_pool,
           const int* ids, Store<T, kAdd> store, int B, int rows, int din,
           int rank, int dout, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sgmv_kernel<T, kAdd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int kE = 16 / sizeof(T);
  const int krv = rank / kE;
  const int vec_a = rank % kE == 0 && krv <= 32 && (krv & (krv - 1)) == 0 &&
                    aligned16(a_pool);
  const int vec_b = dout % kE == 0 && aligned16(b_pool);
  const size_t smem = (((size_t)rank + 3) & ~(size_t)3) * 4 + kScratch * 4;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((dout + kTileOut - 1) / kTileOut, B);
  sgmv_kernel<T, kAdd><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_pool),
      static_cast<const T*>(b_pool), ids, store, rows, din, rank, dout, vec_a,
      vec_b);
  return static_cast<int>(cudaGetLastError());
}

int check_args(int B, int rows, int din, int rank, int dout) {
  if (B <= 0 || dout <= 0) return -1;  // nothing to do
  if (rank <= 0 || din <= 0 || rows <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, A and B share it; out is float32).
// rank * 4 bytes of t must fit 48 KB of shared memory: rank <= 12288, the
// wrapper's SGMV_MAX_RANK (ops/decode_attention.py) checks the same limit.
extern "C" int ds_sgmv(const void* x, const void* a_pool, const void* b_pool,
                       const int* ids, float* out, int B, int rows, int din,
                       int rank, int dout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = check_args(B, rows, din, rank, dout);
  if (bad) return bad < 0 ? static_cast<int>(cudaGetLastError()) : bad;
  if (dtype == 0) {
    return launch<float, false>(x, a_pool, b_pool, ids,
                                {out, nullptr, nullptr, 0.f}, B, rows, din,
                                rank, dout, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, false>(x, a_pool, b_pool, ids,
                                        {out, nullptr, nullptr, 0.f}, B, rows,
                                        din, rank, dout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The epilogue form: y and y_out [B, dout] in the pools' dtype; y_out =
// y + (scale * delta).to(dtype). y_out may not overlap x or the pools.
extern "C" int ds_sgmv_add(const void* x, const void* a_pool,
                           const void* b_pool, const int* ids, const void* y,
                           void* y_out, float scale, int B, int rows, int din,
                           int rank, int dout, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = check_args(B, rows, din, rank, dout);
  if (bad) return bad < 0 ? static_cast<int>(cudaGetLastError()) : bad;
  if (dtype == 0) {
    return launch<float, true>(
        x, a_pool, b_pool, ids,
        {nullptr, static_cast<const float*>(y), static_cast<float*>(y_out),
         scale},
        B, rows, din, rank, dout, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, true>(
        x, a_pool, b_pool, ids,
        {nullptr, static_cast<const __nv_bfloat16*>(y),
         static_cast<__nv_bfloat16*>(y_out), scale},
        B, rows, din, rank, dout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
