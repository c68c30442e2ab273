// Single-query GQA decode attention over the head-major KV cache.
//
// Replaces the TPU kernel moss_ttsd_tpu/ops/pallas_attention.py
// flash_decode_hs / _decode_kernel (pallas_call at :203).
//
// Contract (the same as the TPU kernel's): q (B, 1, H, D); k/v (B, Hkv, S, D)
// with D contiguous; key_valid (B, S) bool; an optional per-row extent (B,)
// int32 or a scalar extent: cache slots at or past a row's extent are never
// read (every such slot must be key_valid = false). Out (B, 1, H, D) in q's
// type. Softmax in fp32, finite for a row with no valid key (output 0).
//
// What bounds it on an H100: bytes. Each decode step reads every written
// K/V slot of the layer once (2 * B * Hkv * extent * D elements) for
// 4 * G * D flops per slot, G flops per bf16 byte (2 on the main path), far
// below the card's ~295 flop/byte ridge. So the design reads each K/V row
// exactly once and never past the extent:
//   * one thread block per (kv-head, batch row); all G = H / Hkv q-heads of
//     the group share each K/V tile read (the TPU kernel's shared block);
//   * the block loops over 64-slot key tiles up to min(S, extent[b]) only —
//     the counterpart of the TPU's DMA elision + compute skip;
//   * tiles move as 16-byte vectors into shared memory (K rows padded by 16
//     bytes so the per-key dot products read conflict-free), then scores,
//     the online-softmax rescale and the P.V accumulation run from shared
//     memory with fp32 state.
// Known limits, left for later work: at B <= 8 and Hkv = 8 the grid is at
// most 64 blocks on 132 SMs (split-K / flash-decoding would fill the card),
// and tile loads are not double-buffered (cp.async / TMA would overlap
// them with the math).

#include "common.cuh"

namespace {

using moss::L_FLOOR;
using moss::NEG_INF;

constexpr int THREADS = 128;
constexpr int BK = 64;     // key slots per tile
constexpr int MAXO = 16;   // outputs per thread: G * D <= MAXO * THREADS

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              const int* __restrict__ extent, int extent_scalar,
              T* __restrict__ out, int S, int G, float scale,
              long long sq_b, long long sq_h,
              long long sk_b, long long sk_h, long long sk_s,
              long long sv_b, long long sv_h, long long sv_s,
              long long sval_b, long long so_b, long long so_h) {
  constexpr int VEC = moss::Vec16<T>::N;
  constexpr int KROW = D + VEC;        // padded K row: +16 bytes
  constexpr int CPR = D / VEC;         // 16-byte chunks per row
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);          // BK x KROW
  T* Vs = Ks + BK * KROW;                          // BK x D
  float* Qs = reinterpret_cast<float*>(Vs + BK * D);   // G x D
  float* Ps = Qs + G * D;                          // G x BK scores / probs
  float* Ms = Ps + G * BK;                         // G running max
  float* Ls = Ms + G;                              // G running denominators
  float* As = Ls + G;                              // G tile rescale factors

  const int h0 = hk * G;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    Qs[i] = moss::to_float(q[b * sq_b + (h0 + g) * sq_h + d]);
  }
  for (int g = tid; g < G; g += THREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  int kend = extent != nullptr ? extent[b] : extent_scalar;
  kend = max(0, min(kend, S));

  float acc[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) acc[o] = 0.f;

  const T* kb = k + b * sk_b + hk * sk_h;
  const T* vb = v + b * sv_b + hk * sv_h;
  const uint8_t* validb = valid + b * sval_b;
  __syncthreads();

  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int rows = min(BK, kend - j0);
    for (int i = tid; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      *reinterpret_cast<uint4*>(Ks + r * KROW + c) =
          *reinterpret_cast<const uint4*>(kb + (j0 + r) * sk_s + c);
      *reinterpret_cast<uint4*>(Vs + r * D + c) =
          *reinterpret_cast<const uint4*>(vb + (j0 + r) * sv_s + c);
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and pass; masked -> -inf
    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, r = i % BK;
      float s = -INFINITY;
      if (r < rows && validb[j0 + r]) {
        const float* qg = Qs + g * D;
        const T* kr = Ks + r * KROW;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += VEC) {
          float kv[VEC];
          moss::unpack16(kr + c, kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qg[c + e], kv[e], dot);
        }
        s = dot * scale;
      }
      Ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += THREADS / 32) {
      float* pg = Ps + g * BK;
      float mx = -INFINITY;
      for (int r = lane; r < BK; r += 32) mx = fmaxf(mx, pg[r]);
      mx = moss::warp_max(mx);
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < BK; r += 32) {
        const float p = expf(pg[r] - m_new);     // masked: exp(-inf) = 0
        pg[r] = p;
        sum += p;
      }
      sum = moss::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V, one (head, dim) output per thread and slot
#pragma unroll
    for (int o = 0; o < MAXO; ++o) {
      const int i = tid + o * THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pg = Ps + g * BK;
        float a = acc[o] * As[g];
        for (int r = 0; r < rows; ++r)
          a = fmaf(pg[r], moss::to_float(Vs[r * D + d]), a);
        acc[o] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 0; o < MAXO; ++o) {
    const int i = tid + o * THREADS;
    if (i < G * D) {
      const int g = i / D, d = i % D;
      out[b * so_b + (h0 + g) * so_h + d] =
          moss::from_float<T>(acc[o] / fmaxf(Ls[g], L_FLOOR));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           const int* extent, int extent_scalar, void* out, int B, int Hkv,
           int G, int S, float scale, long long sq_b, long long sq_h,
           long long sk_b, long long sk_h, long long sk_s, long long sv_b,
           long long sv_h, long long sv_s, long long sval_b, long long so_b,
           long long so_h, cudaStream_t stream) {
  if (G * D > MAXO * THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BK * (D + moss::Vec16<T>::N) * sizeof(T) +
                      (size_t)BK * D * sizeof(T) +
                      sizeof(float) * ((size_t)G * D + (size_t)G * BK + 3 * G);
  auto kern = decode_kernel<T, D>;
  // raise the dynamic shared-memory cap once per size, not per launch (so
  // a launch captured into a CUDA graph makes no attribute call)
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_cap = smem;
  }
  dim3 grid(Hkv, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, extent, extent_scalar,
      static_cast<T*>(out), S, G, scale, sq_b, sq_h, sk_b, sk_h, sk_s, sv_b,
      sv_h, sv_s, sval_b, so_b, so_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported
// dtype / head_dim / group size.
extern "C" int moss_flash_decode(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* valid, const int* extent, int extent_scalar, void* out,
    int B, int Hkv, int G, int S, int D, float scale, long long sq_b,
    long long sq_h, long long sk_b, long long sk_h, long long sk_s,
    long long sv_b, long long sv_h, long long sv_s, long long sval_b,
    long long so_b, long long so_h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOSS_DECODE(T, DD)                                                   \
  return launch<T, DD>(q, k, v, valid, extent, extent_scalar, out, B, Hkv, G, \
                       S, scale, sq_b, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h,    \
                       sv_s, sval_b, so_b, so_h, st)
#define MOSS_DECODE_D(T)          \
  switch (D) {                    \
    case 16: MOSS_DECODE(T, 16);  \
    case 32: MOSS_DECODE(T, 32);  \
    case 64: MOSS_DECODE(T, 64);  \
    case 128: MOSS_DECODE(T, 128); \
    default: break;               \
  }
  if (dtype == 0) {
    MOSS_DECODE_D(float)
  } else if (dtype == 1) {
    MOSS_DECODE_D(__nv_bfloat16)
  }
#undef MOSS_DECODE_D
#undef MOSS_DECODE
  return (int)cudaErrorInvalidValue;
}
