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
// is the tensor-core rate. Two kernels, chosen by dtype, never one for the
// other:
//
// bf16, D in {64, 128} — prefill_wgmma_kernel, the serving path:
//   * one warpgroup (128 threads) per (64-query tile, q-head, batch row):
//     at the main path's (B 2, T 377, H 16) that is 6 x 16 x 2 = 192 blocks
//     of 80 KB shared memory, two resident per SM, all 192 in one wave on
//     132 SMs; the longest causal rows are issued first;
//   * S = Q K^T is D/16 wgmma.m64n64k16 from shared memory (Q and K tiles
//     bf16, K-major, 128-byte swizzle, sm90.cuh); O += P V is 4 x D/64
//     wgmma.m64n64k16 with P from registers (the S accumulator fragment
//     rounded to bf16 as the TPU kernel's p.astype(v.dtype)) and V from
//     shared memory through the transpose flag; S and O stay in fp32
//     registers, and the online softmax runs on the accumulator layout with
//     quad shuffles (row sums of the fp32 P are reduced once, at the end);
//   * K/V tiles of 64 keys arrive by 16-byte cp.async into a ring of two
//     stages, tile j + 1 in flight while tile j computes; ragged rows are
//     zero-filled, the ragged edge, causal limit and key_valid are masked on
//     the S fragment, and key tiles past the causal limit are never loaded.
//   Its limit at T = 377 is latency — each block walks up to 6 dependent
//   tiles — not the tensor cores or the bytes.
//
// float32 — prefill_simt_kernel, for the --tiny path and the parity checks
// (TF32 tensor cores would miss the fp32 tolerance): the register-tiled
// SIMT kernel of the first port, one block per (64-query tile, q-head, batch
// row), 32-key tiles of fp32 in shared memory, scalar FMA products.

#include "common.cuh"
#include "sm90.cuh"

namespace {

using moss::L_FLOOR;
using moss::NEG_INF;

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int BQ = 64;         // queries per block
constexpr int BKP = 32;        // keys per tile
constexpr int RQ = BQ / 16;    // query rows per thread
constexpr int CK = BKP / 8;    // score columns per thread

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKP * (D + 1) +
                          (size_t)BKP * D + (size_t)BQ * (BKP + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
prefill_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ valid, float* __restrict__ out,
                    int T_len, int G, float scale, long long sq_b,
                    long long sq_t, long long sq_h, long long sk_b,
                    long long sk_t, long long sk_h, long long sv_b,
                    long long sv_t, long long sv_h, long long sval_b,
                    long long so_b, long long so_t, long long so_h) {
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

  const float* qb = q + b * sq_b + h * sq_h;
  const float* kb = k + b * sk_b + hk * sk_h;
  const float* vb = v + b * sv_b + hk * sv_h;
  const uint8_t* validb = valid + b * sval_b;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * QROW + d] = t < T_len ? qb[t * sq_t + d] : 0.f;
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
        kv = kb[t * sk_t + d];
        vv = vb[t * sv_t + d];
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
      float* orow = out + b * so_b + t * so_t + h * so_h;
#pragma unroll
      for (int e = 0; e < DE; ++e) orow[tx + 8 * e] = acc[i][e] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int WG = 128;        // one warpgroup
constexpr int TQ = 64;         // queries per block (the wgmma M)
constexpr int TK = 64;         // keys per tile (the S wgmma N)
constexpr int PANEL = 64 * 128;   // bytes of one 64-row x 64-column panel

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q tile + two K stages + two V stages, each 64 x D bf16, plus the slack
  // that aligns the first tile to the 1024-byte swizzle atom
  return 5 * (size_t)(D / 64) * PANEL + 1024;
}

// Issue the 16-byte cp.async copies of rows [r0, r0 + 64) of one (T, D)
// bf16 matrix (row stride ld elements) into a swizzled tile; rows at or
// past T_len are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(uint8_t* dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int r0,
                                                int T_len, int tid) {
  constexpr int CPR = D / 8;           // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / WG; ++it) {
    const int i = tid + it * WG;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < T_len;
    const __nv_bfloat16* g = ok ? src + (r0 + r) * ld + c * 8 : src;
    sm90::cp_async16(dst + (c / 8) * PANEL + sm90::sw128(r, c % 8), g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(WG)
prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ out, int T_len, int G,
                     float scale_log2, long long sq_b, long long sq_t,
                     long long sq_h, long long sk_b, long long sk_t,
                     long long sk_h, long long sv_b, long long sv_t,
                     long long sv_h, long long sval_b, long long so_b,
                     long long so_t, long long so_h) {
  constexpr int NP = D / 64;           // 64-column panels per row
  constexpr int TILE = NP * PANEL;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int q0 = qt * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + TILE;             // stage s at Ks + s * TILE
  uint8_t* Vs = Ks + 2 * TILE;

  const __nv_bfloat16* qb = q + b * sq_b + h * sq_h;
  const __nv_bfloat16* kb = k + b * sk_b + hk * sk_h;
  const __nv_bfloat16* vb = v + b * sv_b + hk * sv_h;
  const uint8_t* validb = valid + b * sval_b;

  load_tile_async<D>(Qs, qb, sq_t, q0, T_len, tid);
  load_tile_async<D>(Ks, kb, sk_t, 0, T_len, tid);
  load_tile_async<D>(Vs, vb, sv_t, 0, T_len, tid);
  sm90::cp_async_commit();

  // accumulator fragment: this thread holds rows rw + 8 * v1 (v1 = 0, 1) and
  // columns 8 * j + 2 * (lane % 4) + v0 in element 4 * j + 2 * v1 + v0
  const int rw = q0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // running max (log2 domain)
  float l_r[2] = {0.f, 0.f};           // this thread's share of the row sum

  const int ntiles = qt + 1;           // causal limit: tiles 0 .. qt
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile_async<D>(Ks + (st ^ 1) * TILE, kb, sk_t, (j + 1) * TK, T_len,
                         tid);
      load_tile_async<D>(Vs + (st ^ 1) * TILE, vb, sv_t, (j + 1) * TK, T_len,
                         tid);
    }
    sm90::cp_async_commit();           // (empty on the last tile)
    const int k0 = j * TK;
    // key validity of this thread's 16 columns, read while tile j lands
    bool kv_ok[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        const int c = k0 + 8 * jj + cq + v0;
        kv_ok[2 * jj + v0] = c < T_len && validb[c] != 0;
      }
    sm90::cp_async_wait<1>();          // tile j (and Q) landed
    sm90::fence_proxy_async();
    __syncthreads();

    const uint8_t* Kt = Ks + st * TILE;
    const uint8_t* Vt = Vs + st * TILE;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * PANEL + (kk % 4) * 32;
      sm90::wgmma_m64n64k16_ss(s, sm90::desc_sw128(Qs + off),
                               sm90::desc_sw128(Kt + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // mask (causal, ragged edge, key_valid), then the online softmax per row
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      const int row = rw + 8 * v1;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          const int i = 4 * jj + 2 * v1 + v0;
          const bool ok = kv_ok[2 * jj + v0] && k0 + 8 * jj + cq + v0 <= row;
          s[i] = ok ? s[i] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[v1], mx);
      const float alpha = exp2f(m_r[v1] - m_new);
      m_r[v1] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          const int i = 4 * jj + 2 * v1 + v0;
          s[i] = exp2f(s[i] - m_new);      // masked: exp2(-inf) = 0
          sum += s[i];
        }
      l_r[v1] = l_r[v1] * alpha + sum;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int v0 = 0; v0 < 2; ++v0) o[p][4 * jj + 2 * v1 + v0] *= alpha;
    }

    // P (bf16) as the register A operand: k-step kk covers keys
    // 16 kk .. 16 kk + 15, i.e. S elements 8 kk .. 8 kk + 7
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sm90::wgmma_m64n64k16_rs_tb(
            o[p], a[kk], sm90::desc_sw128(Vt + p * PANEL + kk * 2048), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) sm90::fence_regs(o[p]);
    __syncthreads();                   // stage st consumed before its refill
  }

#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    float l = l_r[v1];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, L_FLOOR);
    const int row = rw + 8 * v1;
    if (row < T_len) {
      __nv_bfloat16* orow = out + b * so_b + row * so_t + h * so_h;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 4 * jj + 2 * v1;
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * p + 8 * jj + cq) =
              __floats2bfloat162_rn(o[p][i] * inv, o[p][i + 1] * inv);
        }
    }
  }
}

// Launches made through this library of each kernel, counted on the host
// right where it is launched: [0] SIMT (fp32), [1] wgmma (bf16).
long long kernel_launches[2] = {0, 0};

// Raise a kernel's dynamic shared-memory cap once (a launch captured into a
// CUDA graph then makes no attribute call).
template <typename K>
int smem_cap_once(K kern, size_t smem, bool& done) {
  if (smem > 48 * 1024 && !done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v,
                const uint8_t* valid, void* out, int B, int T_len, int H,
                int G, float scale, long long sq_b, long long sq_t,
                long long sq_h, long long sk_b, long long sk_t, long long sk_h,
                long long sv_b, long long sv_t, long long sv_h,
                long long sval_b, long long so_b, long long so_t,
                long long so_h, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<D>();
  auto kern = prefill_simt_kernel<D>;
  static bool cap = false;
  if (const int e = smem_cap_once(kern, smem, cap)) return e;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), valid, static_cast<float*>(out), T_len, G,
      scale, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, sval_b,
      so_b, so_t, so_h);
  const int e = (int)cudaGetLastError();
  kernel_launches[0] += e == 0;
  return e;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const uint8_t* valid, void* out, int B, int T_len, int H,
                 int G, float scale, long long sq_b, long long sq_t,
                 long long sq_h, long long sk_b, long long sk_t,
                 long long sk_h, long long sv_b, long long sv_t,
                 long long sv_h, long long sval_b, long long so_b,
                 long long so_t, long long so_h, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<D>();
  auto kern = prefill_wgmma_kernel<D>;
  static bool cap = false;
  if (const int e = smem_cap_once(kern, smem, cap)) return e;
  dim3 grid((T_len + TQ - 1) / TQ, H, B);
  kern<<<grid, WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), valid,
      static_cast<__nv_bfloat16*>(out), T_len, G, scale * 1.4426950408889634f,
      sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, sval_b, so_b,
      so_t, so_h);
  const int e = (int)cudaGetLastError();
  kernel_launches[1] += e == 0;
  return e;
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel, D in {16, 32, 64, 128}), 1 = bfloat16
// (wgmma kernel, D in {64, 128}); no dtype falls back to the other kernel.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype / head_dim.
extern "C" int moss_flash_prefill(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* valid, void* out, int B, int T_len, int H, int G, int D,
    float scale, long long sq_b, long long sq_t, long long sq_h,
    long long sk_b, long long sk_t, long long sk_h, long long sv_b,
    long long sv_t, long long sv_h, long long sval_b, long long so_b,
    long long so_t, long long so_h, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MOSS_PREFILL(FN, DD)                                                 \
  return FN<DD>(q, k, v, valid, out, B, T_len, H, G, scale, sq_b, sq_t, sq_h, \
                sk_b, sk_t, sk_h, sv_b, sv_t, sv_h, sval_b, so_b, so_t, so_h, \
                st)
  if (dtype == 0) {
    switch (D) {
      case 16: MOSS_PREFILL(launch_simt, 16);
      case 32: MOSS_PREFILL(launch_simt, 32);
      case 64: MOSS_PREFILL(launch_simt, 64);
      case 128: MOSS_PREFILL(launch_simt, 128);
      default: break;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64: MOSS_PREFILL(launch_wgmma, 64);
      case 128: MOSS_PREFILL(launch_wgmma, 128);
      default: break;
    }
  }
#undef MOSS_PREFILL
  return (int)cudaErrorInvalidValue;
}

// Launches of one kernel so far: kernel 0 = SIMT (fp32), 1 = wgmma (bf16).
extern "C" long long moss_flash_prefill_kernel_launches(int kernel) {
  return kernel == 0 || kernel == 1 ? kernel_launches[kernel] : -1;
}
