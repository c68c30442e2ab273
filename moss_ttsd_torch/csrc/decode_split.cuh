// The split-K single-query GQA decode kernel, one template over the cache's
// element type C: flash_decode.cu instantiates it over a bf16 or fp32 cache
// (C = q's type T), flash_decode_int8.cu over an int8 cache with fp32
// per-head-per-token scales (C = int8_t). Each of those files says which TPU
// kernel it replaces and what bounds it.
//
// One block per (chunk, kv-head, row), 128 threads; all G = H / Hkv q-heads
// of the group share each tile read:
//   * the capacity S is cut into n_split chunks of a multiple of 64 slots,
//     chosen on the host from S alone (decode_split_plan in
//     ops/flash_attention.py). The extent never reaches the host: a block
//     reads its row's extent on the device, and a chunk at or past it exits
//     at once (still taking its ticket), so a call is graph-capturable;
//   * a window W > 0 (an AFMoE sliding layer, over a cache of q's type; the
//     TPU kernels have none) reads only the slots [extent - W, extent): the
//     kernel is instantiated apart for it (WIN), and a chunk wholly before
//     the window exits at once as one past the extent does;
//   * 64-slot tiles move by 16-byte cp.async into two stages (over an int8
//     cache the tile's k and v scales beside them, 4 bytes a slot), tile
//     j + 1 in flight while tile j computes;
//   * scores: a key per CPR = D * sizeof(C) / 16 lanes, each lane one
//     16-byte slice of the row unpacked to fp32, reduced by shuffles; the
//     score is dot * scale, or dot * (ks[s] * scale) over an int8 cache;
//     a masked slot gives -inf;
//   * softmax one warp per head (common.cuh softmax_tile): the row that P.V
//     reads is p, or p * vs[s], rounded to T, as the TPU kernels round it;
//     the denominator sums the unrounded p;
//   * P.V: two (head, dim) outputs per thread, two cache elements a load
//     (float2, bf16x2 or char2), fp32 accumulators;
//   * each block writes its chunk's (m, l, acc) in fp32 to a workspace the
//     wrapper allocates; the last block of a (kv-head, row) to arrive (an
//     atomic ticket) merges them in the same launch (common.cuh
//     split_merge) and re-arms its counter, so a call is one launch.
//     n_split = 1 writes the output directly.
// The ticket counters are one array per CUDA stream (the wrapper's
// _arrival_counters), shared by both decode kernels: launches on one stream
// do not overlap, and each merge re-arms its counter to 0.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace moss {
namespace decode {

constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;
constexpr int BK = 64;     // key slots per tile (the chunk is a multiple)
constexpr int MAXP = 8;    // output pairs per thread: G * D <= 2 * MAXP * THREADS

// Pointers, sizes and element strides of one launch. q and out are (B, 1, H,
// D) in T; k and v are (B, Hkv, S, D) in C with D contiguous; ks and vs
// (B, Hkv, S) fp32 with S contiguous, or null for a float cache; valid (B, S).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const uint8_t* valid;
  const int* extent;         // (B,) int32, or null: extent_scalar for all
  int extent_scalar;
  void* out;
  int S, G;
  float scale;
  int chunk, n_split;
  float* ws_acc;             // n_split > 1: B * Hkv * n_split * G * D floats,
  float* ws_ml;              //   B * Hkv * n_split * G * 2 floats
  int* counters;             //   and B * Hkv ints, 0 between launches
  int window;                // WIN: slots [extent - window, extent)
  long long sq_b, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s, sks_b, sks_h,
      svs_b, svs_h, sval_b, so_b, so_h;
};

template <typename C>
constexpr bool kInt8 = std::is_same<C, int8_t>::value;

template <typename C, int D>
size_t smem_bytes(int G) {
  return 4 * (size_t)BK * D * sizeof(C) + (kInt8<C> ? 4 * BK * 4 : 0) +
         sizeof(float) * ((size_t)G * D + (size_t)G * BK + 3 * (size_t)G);
}

template <typename T, typename C, int D, bool WIN>
__global__ void __launch_bounds__(THREADS) split_kernel(const Args a) {
  constexpr bool Q8 = kInt8<C>;
  constexpr int VEC = Vec16<C>::N;
  constexpr int CPR = D / VEC;         // 16-byte chunks per row = lanes/key
  constexpr int KPW = 32 / CPR;        // keys per warp and pass
  // passes over a tile; an int8 row of D 16 is one lane, so half the warps
  // of the last pass have no key (whole warps: BK is a multiple of KPW)
  constexpr int NPASS = (BK * CPR + THREADS - 1) / THREADS;
  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int G = a.G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* Ks = reinterpret_cast<C*>(smem_raw);          // 2 stages x BK x D
  C* Vs = Ks + 2 * BK * D;                         // 2 stages x BK x D
  float* Sc = reinterpret_cast<float*>(Vs + 2 * BK * D);  // int8: 2 x (k, v)
  float* Qs = Sc + (Q8 ? 4 * BK : 0);              // G x D
  float* Ps = Qs + G * D;                          // G x BK scores / probs
  float* Ms = Ps + G * BK;                         // G running max
  float* Ls = Ms + G;                              // G running denominators
  float* As = Ls + G;                              // G tile rescale factors

  int kend = a.extent != nullptr ? a.extent[b] : a.extent_scalar;
  kend = max(0, min(kend, a.S));
  const int c0 = WIN ? max(sp * a.chunk, kend - a.window) : sp * a.chunk;
  const int c1 = min(kend, sp * a.chunk + a.chunk);
  const int h0 = hk * G;
  const long long part = ((long long)b * Hkv + hk) * a.n_split + sp;
  float* ml = a.ws_ml + part * G * 2;
  float* pacc = a.ws_acc + part * G * D;
  T* outb = static_cast<T*>(a.out) + b * a.so_b + h0 * a.so_h;
  const int npair = G * D / 2;

  if (c0 < c1) {
    const T* q = static_cast<const T*>(a.q);
    const C* kb = static_cast<const C*>(a.k) + b * a.sk_b + hk * a.sk_h;
    const C* vb = static_cast<const C*>(a.v) + b * a.sv_b + hk * a.sv_h;
    const float* ksb = nullptr;
    const float* vsb = nullptr;
    if constexpr (Q8) {
      ksb = a.ks + b * a.sks_b + hk * a.sks_h;
      vsb = a.vs + b * a.svs_b + hk * a.svs_h;
    }
    const uint8_t* validb = a.valid + b * a.sval_b;
    auto load_tile = [&](int stage, int j0) {
      C* kd = Ks + stage * BK * D;
      C* vd = Vs + stage * BK * D;
      for (int i = tid; i < BK * CPR; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * VEC;
        const bool ok = j0 + r < c1;
        sm90::cp_async16(kd + r * D + c, ok ? kb + (j0 + r) * a.sk_s + c : kb,
                         ok);
        sm90::cp_async16(vd + r * D + c, ok ? vb + (j0 + r) * a.sv_s + c : vb,
                         ok);
      }
      if constexpr (Q8) {              // the tile's scales; 0 past c1
        float* sd = Sc + stage * 2 * BK;
        for (int r = tid; r < BK; r += THREADS) {
          const bool ok = j0 + r < c1;
          sm90::cp_async4(sd + r, ok ? ksb + j0 + r : ksb, ok);
          sm90::cp_async4(sd + BK + r, ok ? vsb + j0 + r : vsb, ok);
        }
      }
    };
    load_tile(0, c0);
    sm90::cp_async_commit();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      Qs[i] = to_float(q[b * a.sq_b + (h0 + g) * a.sq_h + d]);
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
      const C* Kt = Ks + st * BK * D;
      const C* Vt = Vs + st * BK * D;
      const float* KSt = Sc + st * 2 * BK;     // int8 only
      const float* VSt = Q8 ? KSt + BK : nullptr;

      // scores: CPR lanes per key, one 16-byte slice each; masked -> -inf
#pragma unroll
      for (int ps = 0; ps < NPASS; ++ps) {
        const int r = (warp + ps * NWARP) * KPW + kw;
        if (BK * CPR % THREADS != 0 && r >= BK) break;   // warp-uniform
        const bool ok = ok_key[ps];
        float kv[VEC];
        unpack16(Kt + r * D + sub * VEC, kv);
        float kscale = a.scale;
        if constexpr (Q8) kscale = KSt[r] * a.scale;
        for (int g = 0; g < G; ++g) {
          const float* qg = Qs + g * D + sub * VEC;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qg[e], kv[e], dot);
#pragma unroll
          for (int o = CPR / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (sub == 0) Ps[g * BK + r] = ok ? dot * kscale : -INFINITY;
        }
      }
      __syncthreads();

      softmax_tile<T, BK>(Ps, Ms, Ls, As, G, VSt);
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
            const float2 vv = load2(Vt + r * D + d);
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
        if (a.n_split == 1) {
          const float inv = 1.f / fmaxf(Ls[g], L_FLOOR);
          outb[g * a.so_h + d] = from_float<T>(acc[o][0] * inv);
          outb[g * a.so_h + d + 1] = from_float<T>(acc[o][1] * inv);
        } else {
          *reinterpret_cast<float2*>(pacc + g * D + d) =
              make_float2(acc[o][0], acc[o][1]);
        }
      }
    }
    if (a.n_split > 1)
      for (int g = tid; g < G; g += THREADS) {
        ml[2 * g] = Ms[g];
        ml[2 * g + 1] = Ls[g];
      }
  } else if (a.n_split == 1) {         // nothing below the extent: 0
    for (int i = tid; i < G * D; i += THREADS)
      outb[(i / D) * a.so_h + i % D] = from_float<T>(0.f);
  } else {                             // an empty partial
    for (int g = tid; g < G; g += THREADS) {
      ml[2 * g] = NEG_INF;
      ml[2 * g + 1] = 0.f;
    }
  }
  if (a.n_split == 1) return;
  if (!split_arrive_last(a.counters + (long long)b * Hkv + hk, a.n_split))
    return;
  const long long first = ((long long)b * Hkv + hk) * a.n_split;
  // the tiles' shared memory is free: it holds the merge's weights
  split_merge<T>(a.ws_acc + first * G * D, a.ws_ml + first * G * 2,
                 a.n_split, G, D, outb, a.so_h,
                 reinterpret_cast<float*>(smem_raw));
}

template <typename T, typename C, int D, bool WIN>
int launch_typed(const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (a.G * D > 2 * MAXP * THREADS || a.chunk <= 0 || a.chunk % BK ||
      a.n_split <= 0 || (long long)a.n_split * a.chunk < a.S)
    return (int)cudaErrorInvalidValue;
  // the tiles, or the merge's weights if those take more
  const size_t smem = max(smem_bytes<C, D>(a.G),
                          sizeof(float) * (2 * (size_t)a.n_split * a.G + a.G));
  auto kern = split_kernel<T, C, D, WIN>;
  // raise the dynamic shared-memory cap once per size, not per launch (so
  // a launch captured into a CUDA graph makes no attribute call)
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_cap = smem;
  }
  kern<<<dim3(a.n_split, Hkv, B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool INT8_CACHE, bool WIN>
int launch_d(int D, const Args& a, int B, int Hkv, cudaStream_t stream) {
  using C = typename std::conditional<INT8_CACHE, int8_t, T>::type;
  switch (D) {
    case 16: return launch_typed<T, C, 16, WIN>(a, B, Hkv, stream);
    case 32: return launch_typed<T, C, 32, WIN>(a, B, Hkv, stream);
    case 64: return launch_typed<T, C, 64, WIN>(a, B, Hkv, stream);
    case 128: return launch_typed<T, C, 128, WIN>(a, B, Hkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a.window > 0 selects the windowed instantiation; only a cache of q's
// type has one (an int8 cache with a window is refused)
template <typename T, bool INT8_CACHE>
int launch_w(int D, const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (a.window < 0) return (int)cudaErrorInvalidValue;
  if (a.window == 0) return launch_d<T, INT8_CACHE, false>(D, a, B, Hkv, stream);
  if constexpr (INT8_CACHE) return (int)cudaErrorInvalidValue;
  else return launch_d<T, false, true>(D, a, B, Hkv, stream);
}

// dtype (of q and out): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype / head_dim / group size /
// split.
template <bool INT8_CACHE>
int launch(int dtype, int D, const Args& a, int B, int Hkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float, INT8_CACHE>(D, a, B, Hkv, st);
  if (dtype == 1) return launch_w<__nv_bfloat16, INT8_CACHE>(D, a, B, Hkv, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace moss
