// Shared helpers for the attention kernels (flash_prefill.cu and the
// split-K decode of decode_split.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace moss {

// Running-max initial value: finite, as in the TPU kernels, so a row that
// has seen no valid key keeps m = NEG_INF, alpha = exp(0) = 1 and l = 0.
// Masked scores themselves are -inf, so their probability is exactly 0 and
// a fully masked row comes out as 0 / max(0, 1e-30) = 0, never NaN.
constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-30f;

// Elements of T in one 16-byte vector.
template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec16<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (the identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Unpack one 16-byte vector at p (16-byte aligned) into floats.
__device__ __forceinline__ void unpack16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)   // sign-extend byte e of word i
      out[4 * i + e] = static_cast<float>(
          static_cast<int>(static_cast<unsigned>(w[i]) << (24 - 8 * e)) >> 24);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Two consecutive elements at p (8-byte aligned for float, 4 for bf16).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {   // 2-byte aligned
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// One key tile's online-softmax step, one warp per head (heads warp,
// warp + nwarp, ...). The tile's scores P[g * BK + r] (-inf where masked)
// become the probabilities that P.V reads: e^(s - m_new), times vscale[r]
// where given (an int8 cache's v scales), rounded to T once here, as the
// TPU kernels round them before P.V (p.astype(v.dtype) over a bf16 cache,
// (p * vs).astype(q.dtype) over an int8 one). The denominator sums the
// unrounded, unscaled e^(s - m_new). M and L carry the running max and
// denominator of each head; A takes the tile's rescale e^(m_old - m_new).
template <typename T, int BK>
__device__ __forceinline__ void softmax_tile(float* P, float* M, float* L,
                                             float* A, int G,
                                             const float* vscale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += blockDim.x / 32) {
    float* pg = P + g * BK;
    float mx = -INFINITY;
    for (int r = lane; r < BK; r += 32) mx = fmaxf(mx, pg[r]);
    mx = warp_max(mx);
    const float m_old = M[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int r = lane; r < BK; r += 32) {
      const float p = expf(pg[r] - m_new);   // masked: exp(-inf) = 0
      pg[r] = round_to<T>(vscale != nullptr ? p * vscale[r] : p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      A[g] = alpha;
      L[g] = L[g] * alpha + sum;
      M[g] = m_new;
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K decode (flash-decoding): the cache's slots are cut into n_split
// chunks and one block per (chunk s, kv-head hk, batch row b) attends over
// its chunk. Partial layout, part = (b * Hkv + hk) * n_split + s:
//   acc[part][g][d]   the chunk's unnormalised sum  sum_j e^(s_j - m) v_j,
//   ml[part][g][0|1]  its running max m and denominator l = sum_j e^(s_j - m),
// fp32, in a workspace the wrapper allocates. A chunk with no valid key (at
// or past the row's extent, or all masked) leaves m = NEG_INF, l = 0 and no
// sums. The block that arrives last for its (b, hk) merges the n_split
// partials in the same launch.
// ---------------------------------------------------------------------------

// True, in every thread, for the block that arrives last of the n_split
// blocks that share *counter; that block re-arms the counter to 0 for the
// next launch. The counters are zeroed once, when the wrapper creates them.
// Every thread must call it, after writing its share of the partial.
__device__ __forceinline__ bool split_arrive_last(int* counter, int n_split) {
  __shared__ int last;
  __threadfence();                     // this block's partial is visible
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n_split - 1;
    if (last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (last) __threadfence();           // ... before the others' are read
  return last;
}

// Merge the n_split partials of one (b, hk) (acc, ml point at its first
// part) into out[g * so_h + d] for the G heads of the group:
//   m = max over chunks with l_s > 0 of m_s,   w_s = e^(m_s - m) (0 if empty),
//   out = sum_s w_s acc_s / max(sum_s w_s l_s, L_FLOOR),
// 0 for a head row with no valid key in any chunk. The (m, l) of all chunks
// are read at once into `scratch` (2 * n_split * G + G floats of shared
// memory), then every output sums its non-empty partials with independent
// loads (eight in flight). Partials written by other blocks are read
// through L2 (__ldcg).
template <typename T>
__device__ void split_merge(const float* acc, const float* ml, int n_split,
                            int G, int D, T* out, long long so_h,
                            float* scratch) {
  float* w = scratch;                  // [s][g]: m_s, then the weight w_s
  float* ls = w + n_split * G;         // [s][g]: l_s
  float* inv = ls + n_split * G;       // [g]: 1 / max(sum w_s l_s, L_FLOOR)
  for (int i = threadIdx.x; i < n_split * G; i += blockDim.x) {
    w[i] = __ldcg(ml + 2 * i);
    ls[i] = __ldcg(ml + 2 * i + 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      if (ls[s * G + g] > 0.f) m = fmaxf(m, w[s * G + g]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float x = ls[s * G + g] > 0.f ? expf(w[s * G + g] - m) : 0.f;
      w[s * G + g] = x;
      l += x * ls[s * G + g];
    }
    inv[g] = 1.f / fmaxf(l, L_FLOOR);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      // an empty chunk's sums were never written: it is not read (the test
      // is uniform across the threads of a head)
      const float ws = w[s * G + g];
      if (ws > 0.f)
        o = fmaf(ws, __ldcg(acc + ((long long)s * G + g) * D + d), o);
    }
    out[g * so_h + d] = from_float<T>(o * inv[g]);
  }
}

}  // namespace moss
