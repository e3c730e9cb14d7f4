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
// pages past a slot's position, no NULL pages — and splits a slot's
// context across blocks (flash-decoding), since one block per (head,
// slot) leaves most of the card idle behind the longest slot.
//
// The split. The grid is (heads, slots, splits); block z takes the fixed
// run of logical pages [z * pages_per_split, (z + 1) * pages_per_split).
// The wrapper picks `splits` from the slot count, heads and the table's
// width alone (one wave of blocks for the longest possible slot: an SM
// holds three, each with a 64 KB ring), never from the positions, which
// would cost a device-to-host sync. A block whose pages all lie past the
// position or on the NULL page contributes an empty partial (m = -1e30,
// l = 0, acc = 0).
//
// Inside a block, each of 4 warps walks its share of the block's pages
// (page p0 + warp + 4 n) a step at a time: up to 16 tokens of one page
// (8 for float32 at hd 128). Its lanes copy every token's K and V rows of
// a step into the warp's ring in shared memory with 16-byte cp.async
// (zero-filled past the position), and the ring keeps 16 KB of K and V
// in flight per warp (4 steps of bfloat16 at hd 64): the copies of the
// next steps run while a step is scored. A row is split over 8-32 lanes
// and each lane reads back only the chunks it copied, so the warp needs
// no barrier. A step takes one max and one sum reduction over the warp
// (one softmax step a page for pages of 16 tokens), p is rounded to the
// pool's type before the value product, and each lane keeps a partial
// value sum for its slice of hd, reduced over the warp once at the end.
// The warps' (m, l, acc) merge in warp order through shared memory. The
// block loads its slot's position and its run of the block table at
// once, before it knows which pages are live.
//
// The merge, in the same launch. With more than one split each block
// writes its partial (acc[hd], m, l) to a float32 workspace, fences, and
// takes a ticket from a per-(slot, head) int32 counter. The block that
// draws the last ticket reads all the splits' partials in split order,
// merges them, writes the output and resets the counter to 0 for the next
// launch. Every partial is a function of its own pages only and the merge
// order is fixed, so the result does not depend on which block finished
// last: it is the same bit for bit from run to run. The wrapper owns the
// workspace and the counters (zeroed once); the kernel allocates nothing.
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
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// a 16-byte chunk of T as floats
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; ok = false writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the step shape of a (T, HD) instantiation
template <typename T, int HD>
struct Step {
  static constexpr int kE = 16 / sizeof(T);  // elements of a 16-byte chunk
  static constexpr int kRC = HD / kE;        // chunks of a row: 8, 16 or 32
  // tokens a step takes, and chunks a lane copies of each of K and V
  static constexpr int kG = 256 / kRC < 16 ? 256 / kRC : 16;
  static constexpr int kNC = kG * kRC / 32;
  // ring stages: 16 KB of K and V per warp (4 steps, or 2 at kNC = 8)
  static constexpr int kStages = 16 / kNC;
  static constexpr int kRingBytes = kWarps * kStages * 2 * kNC * 32 * 16;
};

// HD: head dim (64 or 128)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ positions, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int heads, int block_size, int max_blocks,
                    int pages_per_split, float sm_scale) {
  using S = Step<T, HD>;
  constexpr int kE = S::kE;
  constexpr int kRC = S::kRC;
  constexpr int kG = S::kG;
  constexpr int kNC = S::kNC;
  constexpr int kStages = S::kStages;
  constexpr int kTokStride = 32 / kRC;  // a lane's tokens lie this far apart
  extern __shared__ uint4 ring[];  // [kWarps][kStages][K, V][kNC][32 lanes]
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];
  __shared__ int sm_last;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = lane % kRC;      // the lane's chunk of a row
  const int tok_lane = lane / kRC;  // its first token in a step
  const size_t tok_stride = (size_t)heads * HD;
  const int* table = block_tables + (size_t)b * max_blocks;
  const int p0 = split * pages_per_split;
  const int p_end = min(max_blocks, p0 + pages_per_split);
  // lane i holds the physical id of the warp's page 32 * (n / 32) + i
  // (page p0 + warp + kWarps * n), loaded beside the position
  int ptab = p0 + warp + kWarps * lane < p_end
                 ? table[p0 + warp + kWarps * lane]
                 : 0;
  const int pos = positions[b];

  float qv[kE];
  unpack(__ldg(reinterpret_cast<const uint4*>(
             q + ((size_t)b * heads + h) * HD + part * kE)),
         qv);

  const int n_pages = pos >= 0 ? min(max_blocks, pos / block_size + 1) : 0;
  const int p1 = min(n_pages, p_end);
  // this warp's pages: p0 + warp + kWarps * n, n = 0 .. my_pages - 1
  const int my_pages = p1 - p0 > warp ? (p1 - p0 - warp + kWarps - 1) / kWarps
                                      : 0;
  const int steps = (block_size + kG - 1) / kG;  // steps a page takes
  const int n_items = my_pages * steps;

  // this lane's chunk c of K (kv 0) or V (kv 1) in ring stage st
  uint4* const ring_lane = ring + warp * kStages * 2 * kNC * 32 + lane;
  auto chunk = [&](int st, int kv, int c) {
    return ring_lane + ((st * 2 + kv) * kNC + c) * 32;
  };

  // The next step to copy: page n of the warp, step g of the page.
  int fn = 0, fg = 0, fphys = 0;
  // copies that step into ring stage st; returns its live tokens (0 on
  // the NULL page or past the position, where nothing is copied)
  auto issue = [&](int st) {
    if (fg == 0) {
      if (fn % 32 == 0 && fn > 0) {
        const int jj = p0 + warp + kWarps * (fn + lane);
        ptab = jj < p_end ? table[jj] : 0;
      }
      fphys = __shfl_sync(0xffffffffu, ptab, fn % 32);
    }
    const int t0 = fg * kG;
    const int tok0 = (p0 + warp + kWarps * fn) * block_size + t0;
    const int ntok =
        fphys == 0 ? 0 : min(min(kG, block_size - t0), pos - tok0 + 1);
    if (ntok > 0) {
      const size_t off = ((size_t)fphys * block_size + t0) * tok_stride +
                         (size_t)h * HD + part * kE;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int t = tok_lane + c * kTokStride;
        const bool ok = t < ntok;
        const size_t at = ok ? off + t * tok_stride : 0;
        cp_async16(smem_addr(chunk(st, 0, c)), k_pool + at, ok);
        cp_async16(smem_addr(chunk(st, 1, c)), v_pool + at, ok);
      }
    }
    if (++fg == steps) {
      fg = 0;
      ++fn;
    }
    return ntok;
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;

  // the step in ring stage st: scores, one softmax step, the value sum
  auto consume = [&](int st, int ntok) {
    // scores: each lane's slice of a token's dot product, summed over the
    // kRC lanes that share the token
    float s[kNC];
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const uint4 raw = *chunk(st, 0, c);
      float kf[kE];
      unpack(raw, kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qv[e], kf[e], d);
#pragma unroll
      for (int o = 1; o < kRC; o <<= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, o);
      }
      s[c] = tok_lane + c * kTokStride < ntok ? d * sm_scale : kNegInf;
    }
    // one max and one sum over the step's tokens
    float mx = s[0];
#pragma unroll
    for (int c = 1; c < kNC; ++c) mx = fmaxf(mx, s[c]);
#pragma unroll
    for (int o = kRC; o < 32; o <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float pu[kNC];
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const float p = s[c] > 0.5f * kNegInf ? expf(s[c] - m_new) : 0.f;
      psum += p;
      pu[c] = round_to<T>(p);
    }
#pragma unroll
    for (int o = kRC; o < 32; o <<= 1) {
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= alpha;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const uint4 raw = *chunk(st, 1, c);
      float vf[kE];
      unpack(raw, vf);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(pu[c], vf[e], acc[e]);
    }
    m = m_new;
  };

  // the ring: kStages steps in flight; each lane waits for its own copies
  // (cp.async.wait_group) and reads back only the chunks it copied
  int ntk[kStages];
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    ntk[st] = st < n_items ? issue(st) : 0;
    cp_async_commit();
  }
  for (int u0 = 0; u0 < n_items; u0 += kStages) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      const int u = u0 + st;
      if (u >= n_items) break;  // warp-uniform
      cp_async_wait<kStages - 1>();
      if (ntk[st] > 0) consume(st, ntk[st]);  // warp-uniform
      ntk[st] = u + kStages < n_items ? issue(st) : 0;
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // the warp's value sum: add the lanes that share a slice of hd
#pragma unroll
  for (int o = kRC; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < kRC) {
#pragma unroll
    for (int e = 0; e < kE; ++e) sm_acc[warp][part * kE + e] = acc[e];
  }
  __syncthreads();

  // the block's partial: the warps merged in warp order (thread d holds
  // element d of the value sum)
  const int d = threadIdx.x;
  float bm = kNegInf, bl = 0.f, ba = 0.f;
  if (d < HD) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, sm_m[w]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - bm);
      bl += sm_l[w] * f;
      ba += sm_acc[w][d] * f;
    }
  }
  T* orow = out + ((size_t)b * heads + h) * HD;
  if (splits == 1) {
    if (d < HD) orow[d] = from_f32<T>(ba / (bl == 0.f ? 1.f : bl));
    return;
  }

  // write the partial, take a ticket; the last block merges every split
  float* slot = ws + ((size_t)b * heads + h) * splits * (HD + 2);
  float* mine = slot + (size_t)split * (HD + 2);
  if (d < HD) mine[d] = ba;
  if (d == 0) {
    mine[HD] = bm;
    mine[HD + 1] = bl;
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * heads + h;
  if (d == 0) sm_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (d < HD) {
    float gm = kNegInf;
    for (int z = 0; z < splits; ++z) {
      gm = fmaxf(gm, __ldcg(slot + (size_t)z * (HD + 2) + HD));
    }
    float gl = 0.f, ga = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float* pz = slot + (size_t)z * (HD + 2);
      const float f = expf(__ldcg(pz + HD) - gm);
      gl += __ldcg(pz + HD + 1) * f;
      ga += __ldcg(pz + d) * f;
    }
    orow[d] = from_f32<T>(ga / (gl == 0.f ? 1.f : gl));  // no key -> zeros
  }
  if (d == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_tables, const int* positions, void* out,
           float* ws, int* counters, int B, int heads, int block_size,
           int max_blocks, int splits, float sm_scale, cudaStream_t stream) {
  constexpr int kRing = Step<T, HD>::kRingBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRing);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int pages_per_split = (max_blocks + splits - 1) / splits;
  const dim3 grid(heads, B, splits);
  paged_decode_kernel<T, HD><<<grid, kThreads, kRing, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, positions,
      static_cast<T*>(out), ws, counters, heads, block_size, max_blocks,
      pages_per_split, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. hd must be 64 or 128 (the wrapper checks).
// splits >= 1 blocks per (slot, head); with more than one, ws holds
// B * heads * splits * (hd + 2) floats and counters B * heads int32 zeros
// (left zero again by every launch).
extern "C" int ds_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const int* block_tables,
                               const int* positions, void* out, float* ws,
                               int* counters, int B, int heads, int hd,
                               int block_size, int max_blocks, int splits,
                               int dtype, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || heads <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || max_blocks < 1 || block_size < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define DS_PAGED_DECODE(T, HD)                                               \
  return launch<T, HD>(q, k_pool, v_pool, block_tables, positions, out, ws, \
                       counters, B, heads, block_size, max_blocks, splits,  \
                       sm_scale, s)
  if (dtype == 0 && hd == 64) DS_PAGED_DECODE(float, 64);
  if (dtype == 0 && hd == 128) DS_PAGED_DECODE(float, 128);
  if (dtype == 1 && hd == 64) DS_PAGED_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) DS_PAGED_DECODE(__nv_bfloat16, 128);
#undef DS_PAGED_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
