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
// below the card's ~295 flop/byte ridge. At the main path's B 2 x Hkv 8 one
// block per (kv-head, row) would leave 116 of 132 SMs idle, so the design is
// split-K (flash-decoding):
//   * the cache's capacity S is cut into n_split chunks of a multiple of 64
//     slots, chosen on the host from S alone (decode_split_plan in
//     ops/flash_attention.py) so that B x Hkv x n_split blocks fill the card:
//     at the main path's S = 633 that is 10 chunks of 64, 160 blocks. The
//     extent never reaches the host (a tensor extent or a captured step
//     needs no read): a chunk at or past its row's extent exits at once;
//   * one block per (chunk, kv-head, row), 128 threads; all G = H / Hkv
//     q-heads of the group share each K/V tile read. 64-slot tiles move by
//     16-byte cp.async into two stages, tile j + 1 in flight while tile j
//     computes. Scores: a key per CPR = D / (16 bytes) lanes, each lane a
//     16-byte slice of the row, reduced by shuffles; softmax one warp per
//     head; P.V two output dims per thread;
//   * each block writes its chunk's (m, l, acc) in fp32 to a workspace; the
//     last block of a (kv-head, row) to arrive (an atomic ticket on the
//     launching stream's counter array, which the wrapper zeroes once)
//     merges them in the same launch
//     (common.cuh split_merge) and re-arms the counter, so a call is still
//     one launch. n_split = 1 writes the output directly.

#include "common.cuh"
#include "sm90.cuh"

namespace {

using moss::L_FLOOR;
using moss::NEG_INF;

constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;
constexpr int BK = 64;     // key slots per tile (the chunk is a multiple)
constexpr int MAXP = 8;    // output pairs per thread: G * D <= 2 * MAXP * THREADS

template <typename T, int D>
constexpr size_t smem_bytes(int G) {
  return 4 * (size_t)BK * D * sizeof(T) +
         sizeof(float) * ((size_t)G * D + (size_t)G * BK + 3 * (size_t)G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    const int* __restrict__ extent, int extent_scalar,
                    T* __restrict__ out, int S, int G, float scale, int chunk,
                    int n_split, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int* __restrict__ counters,
                    long long sq_b, long long sq_h, long long sk_b,
                    long long sk_h, long long sk_s, long long sv_b,
                    long long sv_h, long long sv_s, long long sval_b,
                    long long so_b, long long so_h) {
  constexpr int VEC = moss::Vec16<T>::N;
  constexpr int CPR = D / VEC;         // 16-byte chunks per row = lanes/key
  constexpr int KPW = 32 / CPR;        // keys per warp and pass
  constexpr int NPASS = BK * CPR / THREADS;   // passes over a tile
  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);          // 2 stages x BK x D
  T* Vs = Ks + 2 * BK * D;                         // 2 stages x BK x D
  float* Qs = reinterpret_cast<float*>(Vs + 2 * BK * D);   // G x D
  float* Ps = Qs + G * D;                          // G x BK scores / probs
  float* Ms = Ps + G * BK;                         // G running max
  float* Ls = Ms + G;                              // G running denominators
  float* As = Ls + G;                              // G tile rescale factors

  int kend = extent != nullptr ? extent[b] : extent_scalar;
  kend = max(0, min(kend, S));
  const int c0 = sp * chunk;
  const int c1 = min(kend, c0 + chunk);
  const int h0 = hk * G;
  const long long part = ((long long)b * Hkv + hk) * n_split + sp;
  float* ml = ws_ml + part * G * 2;
  float* pacc = ws_acc + part * G * D;
  T* outb = out + b * so_b + h0 * so_h;
  const int npair = G * D / 2;

  if (c0 < c1) {
    const T* kb = k + b * sk_b + hk * sk_h;
    const T* vb = v + b * sv_b + hk * sv_h;
    const uint8_t* validb = valid + b * sval_b;
    auto load_tile = [&](int stage, int j0) {
      T* kd = Ks + stage * BK * D;
      T* vd = Vs + stage * BK * D;
      for (int i = tid; i < BK * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * VEC;
        const bool ok = j0 + r < c1;
        sm90::cp_async16(kd + r * D + c, ok ? kb + (j0 + r) * sk_s + c : kb,
                         ok);
        sm90::cp_async16(vd + r * D + c, ok ? vb + (j0 + r) * sv_s + c : vb,
                         ok);
      }
    };
    load_tile(0, c0);
    sm90::cp_async_commit();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      Qs[i] = moss::to_float(q[b * sq_b + (h0 + g) * sq_h + d]);
    }
    for (int g = tid; g < G; g += THREADS) {
      Ms[g] = NEG_INF;
      Ls[g] = 0.f;
    }
    float acc[MAXP][2];
#pragma unroll
    for (int o = 0; o < MAXP; ++o) acc[o][0] = acc[o][1] = 0.f;

    const int sub = lane % CPR;        // this lane's 16-byte slice of a row
    const int kw = lane / CPR;         // this lane's key within the pass
    int st = 0;
    for (int j0 = c0; j0 < c1; j0 += BK, st ^= 1) {
      const int rows = min(BK, c1 - j0);
      if (j0 + BK < c1) load_tile(st ^ 1, j0 + BK);
      sm90::cp_async_commit();         // (empty on the last tile)
      // key validity of this lane's keys, read while tile j0 lands
      bool ok_key[NPASS];
#pragma unroll
      for (int ps = 0; ps < NPASS; ++ps) {
        const int r = (warp + ps * NWARP) * KPW + kw;
        ok_key[ps] = r < rows && validb[j0 + r] != 0;
      }
      sm90::cp_async_wait<1>();        // tile j0 landed
      __syncthreads();
      const T* Kt = Ks + st * BK * D;
      const T* Vt = Vs + st * BK * D;

      // scores: CPR lanes per key, one 16-byte slice each; masked -> -inf
#pragma unroll
      for (int ps = 0; ps < NPASS; ++ps) {
        const int r = (warp + ps * NWARP) * KPW + kw;
        const bool ok = ok_key[ps];
        float kv[VEC];
        moss::unpack16(Kt + r * D + sub * VEC, kv);
        for (int g = 0; g < G; ++g) {
          const float* qg = Qs + g * D + sub * VEC;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qg[e], kv[e], dot);
#pragma unroll
          for (int o = CPR / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (sub == 0) Ps[g * BK + r] = ok ? dot * scale : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax: one warp per head
      for (int g = warp; g < G; g += NWARP) {
        float* pg = Ps + g * BK;
        float mx = -INFINITY;
        for (int r = lane; r < BK; r += 32) mx = fmaxf(mx, pg[r]);
        mx = moss::warp_max(mx);
        const float m_old = Ms[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int r = lane; r < BK; r += 32) {
          const float p = expf(pg[r] - m_new);   // masked: exp(-inf) = 0
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

      // acc = acc * alpha + P @ V, two (head, dim) outputs per thread
#pragma unroll
      for (int o = 0; o < MAXP; ++o) {
        const int i = tid + o * THREADS;
        if (i < npair) {
          const int g = 2 * i / D, d = 2 * i % D;
          const float* pg = Ps + g * BK;
          const float alpha = As[g];
          float a0 = acc[o][0] * alpha, a1 = acc[o][1] * alpha;
          for (int r = 0; r < rows; ++r) {
            const float2 vv = moss::load2(Vt + r * D + d);
            a0 = fmaf(pg[r], vv.x, a0);
            a1 = fmaf(pg[r], vv.y, a1);
          }
          acc[o][0] = a0;
          acc[o][1] = a1;
        }
      }
      __syncthreads();                 // stage st and Ps consumed
    }

    // the chunk's partial (or, unsplit, the output)
#pragma unroll
    for (int o = 0; o < MAXP; ++o) {
      const int i = tid + o * THREADS;
      if (i < npair) {
        const int g = 2 * i / D, d = 2 * i % D;
        if (n_split == 1) {
          const float inv = 1.f / fmaxf(Ls[g], L_FLOOR);
          outb[g * so_h + d] = moss::from_float<T>(acc[o][0] * inv);
          outb[g * so_h + d + 1] = moss::from_float<T>(acc[o][1] * inv);
        } else {
          *reinterpret_cast<float2*>(pacc + g * D + d) =
              make_float2(acc[o][0], acc[o][1]);
        }
      }
    }
    if (n_split > 1)
      for (int g = tid; g < G; g += THREADS) {
        ml[2 * g] = Ms[g];
        ml[2 * g + 1] = Ls[g];
      }
  } else if (n_split == 1) {           // nothing below the extent: 0
    for (int i = tid; i < G * D; i += THREADS)
      outb[(i / D) * so_h + i % D] = moss::from_float<T>(0.f);
  } else {                             // an empty partial
    for (int g = tid; g < G; g += THREADS) {
      ml[2 * g] = NEG_INF;
      ml[2 * g + 1] = 0.f;
    }
  }
  if (n_split == 1) return;
  if (!moss::split_arrive_last(counters + (long long)b * Hkv + hk, n_split))
    return;
  const long long first = ((long long)b * Hkv + hk) * n_split;
  // the tiles' shared memory is free: it holds the merge's weights
  moss::split_merge<T>(ws_acc + first * G * D, ws_ml + first * G * 2,
                       n_split, G, D, outb, so_h,
                       reinterpret_cast<float*>(smem_raw));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           const int* extent, int extent_scalar, void* out, int B, int Hkv,
           int G, int S, float scale, int chunk, int n_split, float* ws_acc,
           float* ws_ml, int* counters, long long sq_b, long long sq_h,
           long long sk_b, long long sk_h, long long sk_s, long long sv_b,
           long long sv_h, long long sv_s, long long sval_b, long long so_b,
           long long so_h, cudaStream_t stream) {
  if (G * D > 2 * MAXP * THREADS || chunk <= 0 || chunk % BK || n_split <= 0 ||
      (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  // the tiles, or the merge's weights if those take more
  const size_t smem = max(smem_bytes<T, D>(G),
                          sizeof(float) * (2 * (size_t)n_split * G + G));
  auto kern = decode_split_kernel<T, D>;
  // raise the dynamic shared-memory cap once per size, not per launch (so
  // a launch captured into a CUDA graph makes no attribute call)
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_cap = smem;
  }
  dim3 grid(n_split, Hkv, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, extent, extent_scalar,
      static_cast<T*>(out), S, G, scale, chunk, n_split, ws_acc, ws_ml,
      counters, sq_b, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s, sval_b, so_b,
      so_h);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. chunk (a multiple of 64) and n_split
// (n_split * chunk >= S) come from decode_split_plan; for n_split > 1,
// ws_acc holds B * Hkv * n_split * G * D floats, ws_ml B * Hkv * n_split *
// G * 2, and counters B * Hkv ints that are 0 between launches. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype / head_dim / group size /
// split.
extern "C" int moss_flash_decode(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* valid, const int* extent, int extent_scalar, void* out,
    int B, int Hkv, int G, int S, int D, float scale, int chunk, int n_split,
    float* ws_acc, float* ws_ml, int* counters, long long sq_b,
    long long sq_h, long long sk_b, long long sk_h, long long sk_s,
    long long sv_b, long long sv_h, long long sv_s, long long sval_b,
    long long so_b, long long so_h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOSS_DECODE(T, DD)                                                   \
  return launch<T, DD>(q, k, v, valid, extent, extent_scalar, out, B, Hkv, G, \
                       S, scale, chunk, n_split, ws_acc, ws_ml, counters,     \
                       sq_b, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s, sval_b, \
                       so_b, so_h, st)
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
