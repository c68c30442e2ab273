// Single-query GQA decode attention over an int8 KV cache.
//
// Replaces the TPU kernel moss_ttsd_tpu/ops/pallas_attention.py
// flash_decode_int8_hs / _decode_int8_kernel (pallas_call at :311).
//
// Contract (the TPU kernel's, and flash_decode.cu's): q (B, 1, H, D) fp32 or
// bf16; kq/vq (B, Hkv, S, D) int8 with D contiguous and 16-byte aligned
// rows; ks/vs (B, Hkv, S) fp32 per-head-per-token scales, k ~ kq * ks;
// key_valid (B, S) bool; an optional per-row extent (B,) int32 or a scalar
// extent: slots at or past a row's extent are never read (every such slot
// must be key_valid = false). Out (B, 1, H, D) in q's type. Softmax in fp32;
// a row with no valid key gives exactly 0.
//
// Dequantization is folded around the two products, as in the TPU kernel:
//   score = (q . kq[s]) * (ks[s] * scale),   acc += (p * vs[s]) * vq[s]
// so the int8 rows are read as they are, one byte an element, and only two
// fp32 scales a slot ride along.
//
// What bounds it on an H100: bytes. Each step reads every written slot of
// the layer once: 2 * (D + 4) bytes per slot and kv-head, for 4 * G * D
// flops — about 4 flops a byte at G = 2, far below the card's ~295. So, as
// in flash_decode.cu:
//   * one thread block per (kv-head, batch row); the G = H / Hkv q-heads of
//     the group share each K/V tile read;
//   * the block loops over 64-slot tiles up to min(S, extent[b]) only;
//   * int8 rows move as 16-byte vectors into shared memory (K rows padded by
//     16 bytes so the per-key dot products read conflict-free), the tile's
//     scales beside them; scores, the online-softmax rescale and P.V run
//     from shared memory with fp32 state.
// Known limits, left for later work: the grid is B x Hkv blocks (8 at the
// long-form batch 1 on 132 SMs; split-K would fill the card), tile loads
// are not double-buffered, and the products run on CUDA cores.

#include "common.cuh"

namespace {

using moss::L_FLOOR;
using moss::NEG_INF;

constexpr int THREADS = 128;
constexpr int BK = 64;     // key slots per tile
constexpr int MAXO = 16;   // outputs per thread: G * D <= MAXO * THREADS
constexpr int VEC = 16;    // int8 elements per 16-byte vector
// Shared memory stays below the 48 KB default at every supported shape
// (D <= 128, G * D <= 2048: at most 30,400 bytes), so no attribute call.

// Unpack one 16-byte vector of int8 at p (16-byte aligned) into floats.
__device__ __forceinline__ void unpack16_i8(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)   // sign-extend byte e of word i
      out[4 * i + e] =
          static_cast<float>(static_cast<int>(
              static_cast<unsigned>(w[i]) << (24 - 8 * e)) >> 24);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                   const float* __restrict__ ks,
                   const int8_t* __restrict__ vq,
                   const float* __restrict__ vs,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ extent, int extent_scalar,
                   T* __restrict__ out, int S, int G, float scale,
                   long long sq_b, long long sq_h, long long sk_b,
                   long long sk_h, long long sk_s, long long sks_b,
                   long long sks_h, long long sv_b, long long sv_h,
                   long long sv_s, long long svs_b, long long svs_h,
                   long long sval_b, long long so_b, long long so_h) {
  constexpr int KROW = D + VEC;        // padded K row: +16 bytes
  constexpr int CPR = D / VEC;         // 16-byte chunks per row
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Kt = reinterpret_cast<int8_t*>(smem_raw);     // BK x KROW
  int8_t* Vt = Kt + BK * KROW;                          // BK x D
  float* Qs = reinterpret_cast<float*>(Vt + BK * D);    // G x D
  float* Ps = Qs + G * D;                               // G x BK
  float* KSc = Ps + G * BK;                             // BK k scales
  float* VSc = KSc + BK;                                // BK v scales
  float* Ms = VSc + BK;                                 // G running max
  float* Ls = Ms + G;                                   // G denominators
  float* As = Ls + G;                                   // G rescale factors

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

  const int8_t* kb = kq + b * sk_b + hk * sk_h;
  const int8_t* vb = vq + b * sv_b + hk * sv_h;
  const float* ksb = ks + b * sks_b + hk * sks_h;
  const float* vsb = vs + b * svs_b + hk * svs_h;
  const uint8_t* validb = valid + b * sval_b;
  __syncthreads();

  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int rows = min(BK, kend - j0);
    for (int i = tid; i < rows * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      *reinterpret_cast<int4*>(Kt + r * KROW + c) =
          *reinterpret_cast<const int4*>(kb + (j0 + r) * sk_s + c);
      *reinterpret_cast<int4*>(Vt + r * D + c) =
          *reinterpret_cast<const int4*>(vb + (j0 + r) * sv_s + c);
    }
    for (int r = tid; r < rows; r += THREADS) {
      KSc[r] = ksb[j0 + r];
      VSc[r] = vsb[j0 + r];
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and pass; masked -> -inf
    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, r = i % BK;
      float s = -INFINITY;
      if (r < rows && validb[j0 + r]) {
        const float* qg = Qs + g * D;
        const int8_t* kr = Kt + r * KROW;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += VEC) {
          float kv[VEC];
          unpack16_i8(kr + c, kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qg[c + e], kv[e], dot);
        }
        s = dot * (KSc[r] * scale);
      }
      Ps[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per head; the stored probability row carries
    // the v scale (the denominator sums the unscaled probabilities)
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
        pg[r] = r < rows ? p * VSc[r] : 0.f;
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

    // acc = acc * alpha + (P * vs) @ Vq, one (head, dim) output per thread
#pragma unroll
    for (int o = 0; o < MAXO; ++o) {
      const int i = tid + o * THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pg = Ps + g * BK;
        float a = acc[o] * As[g];
        for (int r = 0; r < rows; ++r)
          a = fmaf(pg[r], static_cast<float>(Vt[r * D + d]), a);
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
int launch(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, const uint8_t* valid, const int* extent,
           int extent_scalar, void* out, int B, int Hkv, int G, int S,
           float scale, long long sq_b, long long sq_h, long long sk_b,
           long long sk_h, long long sk_s, long long sks_b, long long sks_h,
           long long sv_b, long long sv_h, long long sv_s, long long svs_b,
           long long svs_h, long long sval_b, long long so_b, long long so_h,
           cudaStream_t stream) {
  if (G * D > MAXO * THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BK * (D + VEC) + (size_t)BK * D +
                      sizeof(float) * ((size_t)G * D + (size_t)G * BK +
                                       2 * BK + 3 * G);
  dim3 grid(Hkv, B);
  decode_int8_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), kq, ks, vq, vs, valid, extent, extent_scalar,
      static_cast<T*>(out), S, G, scale, sq_b, sq_h, sk_b, sk_h, sk_s, sks_b,
      sks_h, sv_b, sv_h, sv_s, svs_b, svs_h, sval_b, so_b, so_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype / head_dim / group size.
extern "C" int moss_flash_decode_int8(
    int dtype, const void* q, const int8_t* kq, const float* ks,
    const int8_t* vq, const float* vs, const uint8_t* valid,
    const int* extent, int extent_scalar, void* out, int B, int Hkv, int G,
    int S, int D, float scale, long long sq_b, long long sq_h, long long sk_b,
    long long sk_h, long long sk_s, long long sks_b, long long sks_h,
    long long sv_b, long long sv_h, long long sv_s, long long svs_b,
    long long svs_h, long long sval_b, long long so_b, long long so_h,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOSS_DECODE8(T, DD)                                                  \
  return launch<T, DD>(q, kq, ks, vq, vs, valid, extent, extent_scalar, out, \
                       B, Hkv, G, S, scale, sq_b, sq_h, sk_b, sk_h, sk_s,    \
                       sks_b, sks_h, sv_b, sv_h, sv_s, svs_b, svs_h, sval_b, \
                       so_b, so_h, st)
#define MOSS_DECODE8_D(T)          \
  switch (D) {                     \
    case 16: MOSS_DECODE8(T, 16);  \
    case 32: MOSS_DECODE8(T, 32);  \
    case 64: MOSS_DECODE8(T, 64);  \
    case 128: MOSS_DECODE8(T, 128); \
    default: break;                \
  }
  if (dtype == 0) {
    MOSS_DECODE8_D(float)
  } else if (dtype == 1) {
    MOSS_DECODE8_D(__nv_bfloat16)
  }
#undef MOSS_DECODE8_D
#undef MOSS_DECODE8
  return (int)cudaErrorInvalidValue;
}
