// Causal GQA prefill attention.
//
// Replaces the TPU kernel moss_ttsd_tpu/ops/pallas_attention.py
// flash_prefill / _prefill_kernel (pallas_call at :426).
//
// Contract (the same as the TPU kernel's): q (B, T, H, D); k/v (B, T, Hkv, D)
// with D contiguous; key_valid (B, T) bool masks left padding; query t sees
// keys s <= t that are valid. Out (B, T, H, D) in q's type. Online softmax in
// fp32 over key tiles; a query row with no valid key (a left-padded row)
// comes out as 0, finite.
//
// What bounds it on an H100: causal prefill does ~2 * T^2 * D flops per
// head against ~4 * T * D elements of traffic, ~T / 4 flops per bf16 byte:
// ~94 at the main path's T = 377, below the card's ~295 ridge, so the
// roofline bound is the bytes (a few microseconds), and above T ~ 1200 it
// is the tensor-core rate. This first version is a plain register-tiled
// SIMT kernel: its own limit is fp32 FMA issue from shared memory, far
// above either bound. The design keeps it right and simple:
//   * one thread block per (64-query tile, q-head, batch row); the kv-head
//     is h / G, so the G q-heads of a group re-read the same K/V (from L2);
//   * the block walks 32-key tiles from 0 to its causal limit only — whole
//     tiles after the query tile are never loaded (the TPU kernel's causal
//     block skip), and the ragged edge at T is masked inside the kernel,
//     with no padded copies of q/k/v;
//   * Q, K and V tiles sit in shared memory as fp32 (rows padded by one
//     word so the column reads of the score loop are conflict-free); each
//     thread owns 4 query rows x 4 keys of the score tile and 4 rows x D/8
//     dims of the output, and the online-softmax statistics of its rows
//     stay in registers, reduced across the 8 threads of a row by shuffles.
// Later work: mma.sync / wgmma tensor-core tiles with bf16 operands in
// shared memory, and TMA-fed double buffering.

#include "common.cuh"

namespace {

using moss::L_FLOOR;
using moss::NEG_INF;

constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int BQ = 64;         // queries per block
constexpr int BKP = 32;        // keys per tile
constexpr int RQ = BQ / 16;    // query rows per thread
constexpr int CK = BKP / 8;    // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKP * (D + 1) +
                          (size_t)BKP * D + (size_t)BQ * (BKP + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               T* __restrict__ out, int T_len, int G, float scale,
               long long sq_b, long long sq_t, long long sq_h,
               long long sk_b, long long sk_t, long long sk_h,
               long long sv_b, long long sv_t, long long sv_h,
               long long sval_b, long long so_b, long long so_t,
               long long so_h) {
  constexpr int QROW = D + 1;
  constexpr int KROW = D + 1;
  constexpr int PROW = BKP + 1;
  constexpr int DE = D / 8;            // output dims per thread
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;   // tx = lane % 8: a row's 8 threads
                                          // share one warp

  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x QROW
  float* Ks = Qs + BQ * QROW;          // BKP x KROW
  float* Vs = Ks + BKP * KROW;         // BKP x D
  float* Ps = Vs + BKP * D;            // BQ x PROW

  const T* qb = q + b * sq_b + h * sq_h;
  const T* kb = k + b * sk_b + hk * sk_h;
  const T* vb = v + b * sv_b + hk * sv_h;
  const uint8_t* validb = valid + b * sval_b;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * QROW + d] = t < T_len ? moss::to_float(qb[t * sq_t + d]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][DE];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  const int kmax = min(T_len, q0 + BQ);     // causal limit of this q tile
  for (int k0 = 0; k0 < kmax; k0 += BKP) {
    __syncthreads();          // Q loaded / previous tile fully consumed
    for (int i = tid; i < BKP * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < T_len) {
        kv = moss::to_float(kb[t * sk_t + d]);
        vv = moss::to_float(vb[t * sv_t + d]);
      }
      Ks[r * KROW + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RQ], c[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty * RQ + i) * QROW + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) c[j] = Ks[(tx + 8 * j) * KROW + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool ok = kj <= qi && kj < T_len && validb[kj] != 0;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
        Ps[(ty * RQ + i) * PROW + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();          // P tile complete

    const int ncols = min(BKP, kmax - k0);
    for (int c = 0; c < ncols; ++c) {
      float vv[DE];
#pragma unroll
      for (int e = 0; e < DE; ++e) vv[e] = Vs[c * D + tx + 8 * e];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty * RQ + i) * PROW + c];
#pragma unroll
        for (int e = 0; e < DE; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t < T_len) {
      const float denom = fmaxf(l[i], L_FLOOR);
      T* orow = out + b * so_b + t * so_t + h * so_h;
#pragma unroll
      for (int e = 0; e < DE; ++e)
        orow[tx + 8 * e] = moss::from_float<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* out, int B, int T_len, int H, int G, float scale,
           long long sq_b, long long sq_t, long long sq_h, long long sk_b,
           long long sk_t, long long sk_h, long long sv_b, long long sv_t,
           long long sv_h, long long sval_b, long long so_b, long long so_t,
           long long so_h, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kern = prefill_kernel<T, D>;
  // raise the dynamic shared-memory cap once, not per launch (so a launch
  // captured into a CUDA graph makes no attribute call)
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), T_len, G, scale,
      sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, sval_b, so_b,
      so_t, so_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported
// dtype / head_dim.
extern "C" int moss_flash_prefill(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* valid, void* out, int B, int T_len, int H, int G, int D,
    float scale, long long sq_b, long long sq_t, long long sq_h,
    long long sk_b, long long sk_t, long long sk_h, long long sv_b,
    long long sv_t, long long sv_h, long long sval_b, long long so_b,
    long long so_t, long long so_h, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOSS_PREFILL(T, DD)                                                  \
  return launch<T, DD>(q, k, v, valid, out, B, T_len, H, G, scale, sq_b,     \
                       sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, sval_b, \
                       so_b, so_t, so_h, st)
#define MOSS_PREFILL_D(T)           \
  switch (D) {                      \
    case 16: MOSS_PREFILL(T, 16);   \
    case 32: MOSS_PREFILL(T, 32);   \
    case 64: MOSS_PREFILL(T, 64);   \
    case 128: MOSS_PREFILL(T, 128); \
    default: break;                 \
  }
  if (dtype == 0) {
    MOSS_PREFILL_D(float)
  } else if (dtype == 1) {
    MOSS_PREFILL_D(__nv_bfloat16)
  }
#undef MOSS_PREFILL_D
#undef MOSS_PREFILL
  return (int)cudaErrorInvalidValue;
}
