// The routed experts of the AFMoE block: each token's weighted sum over the
// held experts it is routed to, in one grouped call. Two designs, one
// contract: moss::moe for a decode step's few tokens (bound by the weight
// bytes), moss::moe_grouped for a prefill's thousands (bound by the
// products).
//
// Replaces no TPU kernel: the JAX package has no expert layer. It was added
// with the AFMoE block (models/lm.AFMoEBlock, ops/moe.py), whose decode step
// would otherwise loop over the held experts in Python: thousands of small
// kernels a step inside the captured graph.
//
// Contract (ops/moe.moe_experts_plain is the same function in torch): x (N,
// H) in T; idx (N, k) int64 expert ids of the router's width, w (N, k) fp32
// weights; the held experts [offset, offset + E) as gate and up (E, I, H)
// and down (E, H, I) in T, contiguous. A pair (n, j) whose expert is not
// held is dropped. For a held pair, act = silu(x gate^T) * (x up^T) in fp32
// rounded to T, y = act down^T in fp32, and out[n] = sum over j in order of
// w[n, j] * y, rounded to T. counters (3,) int64, when given, gain the held
// pairs, the held experts read and one call.
//
// moss::moe, the decode step (at most MAX_ROWS tokens). What bounds it on
// an H100: bytes. At decode a held expert sees a token or two (B 16, top 8
// of 128, 64 held: ~64 pairs over ~41 experts a layer), so the work is a
// matrix-vector product per pair, ~1 flop per weight byte read, far below
// the card's ~295 flop/byte ridge; the 3 * H * I weights of each expert that
// is hit are the bytes. So:
//   * the grid is fixed and sized for the worst case, (tiles, E): each block
//     finds its expert's pairs by scanning idx itself (no grouping pass, no
//     host read, so a call is graph-capturable); a block whose expert no
//     token chose exits before reading a weight;
//   * each warp streams whole weight rows (16-byte loads that skip L1, four
//     in flight a row) and applies each row to every token of the expert
//     while it holds it in registers: an expert's weights are read once for
//     all its tokens (in groups of TOKB, more re-read from L2);
//   * gate_up_kernel: a warp per neuron, its gate and up rows (8 KB at H
//     2048); down_kernel: a warp per two output rows (4 KB at I 1024),
//     writing w * y per pair into an fp32 buffer; combine_kernel sums each
//     token's held pairs in slot order, so the result does not depend on
//     which block ran first (no atomics on the output).
//
// moss::moe_grouped, any number of tokens (the prefill: 16 rows of up to
// 640, ~40 k held pairs, ~640 a held expert). Each expert's weights now
// serve hundreds of tokens, so the products bound it: a grouped GEMM.
//   * group_kernel (one block) counts the held pairs of each expert, lays
//     the experts' segments and 64-pair tiles out by prefix sums, and
//     scatters the pair ids into their expert's segment: no host read;
//   * gemm_kernel<GATED>: a block per (tile, 64 output columns) computes
//     the tile's 64 pairs x 64 columns over the whole reduction in 32-wide
//     steps staged in shared memory (the next step's loads in registers
//     while this one computes); bf16 on the tensor cores (wmma 16x16x16,
//     fp32 accumulators), fp32 on the CUDA cores (no TF32). The grid is
//     sized for the worst case, ceil(N k / 64) + E tiles: Sum ceil(c_e /
//     64) never exceeds it, and blocks past the last tile exit. GATED:
//     gate and up together, act = silu(g) * u; else down, w * y per pair;
//   * combine_kernel as moss::moe's: each token's held pairs in slot order.
// Pairs land in a tile in the order the scatter's atomics give, but a
// pair's row of a product does not depend on the other rows of its tile,
// so the result is the same on every run.

#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace moss {
namespace moe {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 256;   // tokens a call: a pair list fits in smem
constexpr int TOKB = 4;         // tokens applied per pass over a weight row
constexpr int U = 4;            // 16-byte loads in flight per weight row
constexpr int DOWN_ROWS = 2;    // output rows per warp in down_kernel

struct Args {
  const void* x;
  const long long* idx;
  const float* w;
  const void* gate;
  const void* up;
  const void* down;
  void* act;                    // (N * k, I) T, held pairs only
  float* ybuf;                  // (N * k, H) fp32, held pairs only
  void* out;                    // (N, H) T
  unsigned long long* counters; // (3,) or null
  int N, k, H, I, E;
  long long offset, sx, so;
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The pairs routed to held expert e, into list (at most MAX_ROWS: a row
// chooses an expert once); returns their count. Every thread returns it.
__device__ __forceinline__ int collect(const Args& a, int e, int* list,
                                       int* cnt) {
  if (threadIdx.x == 0) *cnt = 0;
  __syncthreads();
  const long long want = a.offset + e;
  for (int p = threadIdx.x; p < a.N * a.k; p += THREADS)
    if (a.idx[p] == want) {
      const int s = atomicAdd(cnt, 1);
      if (s < MAX_ROWS) list[s] = p;
    }
  __syncthreads();
  return min(*cnt, MAX_ROWS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gate_up_kernel(const Args a) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ int list[MAX_ROWS];
  __shared__ int cnt;
  const int e = blockIdx.y;
  const int nt = collect(a, e, list, &cnt);
  if (a.counters != nullptr && threadIdx.x == 0) {
    if (blockIdx.x == 0 && nt > 0) {
      atomicAdd(a.counters, (unsigned long long)nt);
      atomicAdd(a.counters + 1, 1ull);
    }
    if (blockIdx.x == 0 && e == 0) atomicAdd(a.counters + 2, 1ull);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;        // this warp's neuron
  if (nt == 0 || n >= a.I) return;
  const T* g = static_cast<const T*>(a.gate) + ((long long)e * a.I + n) * a.H;
  const T* u = static_cast<const T*>(a.up) + ((long long)e * a.I + n) * a.H;
  const T* x = static_cast<const T*>(a.x);
  T* act = static_cast<T*>(a.act);
  for (int t0 = 0; t0 < nt; t0 += TOKB) {
    float ag[TOKB], au[TOKB];
#pragma unroll
    for (int t = 0; t < TOKB; ++t) ag[t] = au[t] = 0.f;
    for (int k0 = lane * VEC; k0 < a.H; k0 += 32 * VEC * U) {
      uint4 wg[U], wu[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int kk = k0 + i * 32 * VEC;
        if (kk < a.H) {
          wg[i] = ld_stream(g + kk);
          wu[i] = ld_stream(u + kk);
        }
      }
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        if (t0 + t >= nt) break;                   // warp-uniform
        const T* xr = x + (long long)(list[t0 + t] / a.k) * a.sx;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int kk = k0 + i * 32 * VEC;
          if (kk < a.H) {
            float xv[VEC], gv[VEC], uv[VEC];
            unpack(*reinterpret_cast<const uint4*>(xr + kk), xv, T());
            unpack(wg[i], gv, T());
            unpack(wu[i], uv, T());
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              ag[t] = fmaf(xv[v], gv[v], ag[t]);
              au[t] = fmaf(xv[v], uv[v], au[t]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TOKB; ++t) {
      if (t0 + t >= nt) break;
      const float gs = warp_sum(ag[t]), us = warp_sum(au[t]);
      if (lane == 0)
        act[(long long)list[t0 + t] * a.I + n] =
            from_float<T>(gs / (1.f + expf(-gs)) * us);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) down_kernel(const Args a) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ int list[MAX_ROWS];
  __shared__ int cnt;
  const int e = blockIdx.y;
  const int nt = collect(a, e, list, &cnt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (blockIdx.x * WARPS + warp) * DOWN_ROWS;  // output rows
  if (nt == 0 || m0 >= a.H) return;
  const T* d = static_cast<const T*>(a.down) + ((long long)e * a.H + m0) * a.I;
  const T* act = static_cast<const T*>(a.act);
  for (int t0 = 0; t0 < nt; t0 += TOKB) {
    float acc[DOWN_ROWS][TOKB];
#pragma unroll
    for (int r = 0; r < DOWN_ROWS; ++r)
#pragma unroll
      for (int t = 0; t < TOKB; ++t) acc[r][t] = 0.f;
    for (int k0 = lane * VEC; k0 < a.I; k0 += 32 * VEC * U) {
      uint4 wd[DOWN_ROWS][U];
#pragma unroll
      for (int r = 0; r < DOWN_ROWS; ++r)
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int kk = k0 + i * 32 * VEC;
          if (kk < a.I && m0 + r < a.H)
            wd[r][i] = ld_stream(d + (long long)r * a.I + kk);
        }
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        if (t0 + t >= nt) break;                   // warp-uniform
        const T* ar = act + (long long)list[t0 + t] * a.I;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int kk = k0 + i * 32 * VEC;
          if (kk < a.I) {
            float av[VEC];
            unpack(*reinterpret_cast<const uint4*>(ar + kk), av, T());
#pragma unroll
            for (int r = 0; r < DOWN_ROWS; ++r) {
              if (m0 + r < a.H) {
                float wv[VEC];
                unpack(wd[r][i], wv, T());
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                  acc[r][t] = fmaf(av[v], wv[v], acc[r][t]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TOKB; ++t) {
      if (t0 + t >= nt) break;
      const int p = list[t0 + t];
#pragma unroll
      for (int r = 0; r < DOWN_ROWS; ++r) {
        const float y = warp_sum(acc[r][t]);
        if (lane == 0 && m0 + r < a.H)
          a.ybuf[(long long)p * a.H + m0 + r] = a.w[p] * y;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(const Args a) {
  const int n = blockIdx.x;
  const long long* idx = a.idx + (long long)n * a.k;
  T* out = static_cast<T*>(a.out) + n * a.so;
  for (int m = threadIdx.x; m < a.H; m += THREADS) {
    float acc = 0.f;
    for (int j = 0; j < a.k; ++j) {
      const long long e = idx[j] - a.offset;
      if (e >= 0 && e < a.E)
        acc += a.ybuf[((long long)n * a.k + j) * a.H + m];
    }
    out[m] = from_float<T>(acc);
  }
}

template <typename T>
int launch_t(const Args& a, cudaStream_t st) {
  constexpr int VEC = Vec16<T>::N;
  if (a.N > MAX_ROWS || a.k <= 0 || a.H % VEC || a.I % VEC || a.sx % VEC)
    return (int)cudaErrorInvalidValue;
  if (a.N == 0 || a.E == 0) return 0;
  gate_up_kernel<T><<<dim3((a.I + WARPS - 1) / WARPS, a.E), THREADS, 0,
                      st>>>(a);
  const int rows = WARPS * DOWN_ROWS;
  down_kernel<T><<<dim3((a.H + rows - 1) / rows, a.E), THREADS, 0, st>>>(a);
  combine_kernel<T><<<a.N, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace moe
}  // namespace moss

namespace moss {
namespace moe_grouped {

constexpr int THREADS = 256;
constexpr int BM = 64;          // pairs a tile
constexpr int BN = 64;          // output columns a tile
constexpr int BK = 32;          // reduction columns a staged step
constexpr int LDC = BN + 4;     // fp32 row of the output tile in smem
constexpr int MAX_E = 1024;     // held experts the grouping block takes

struct Args {
  const void* x;
  const long long* idx;
  const float* w;
  const void* gate;
  const void* up;
  const void* down;
  int* perm;                    // (N * k) held pair ids, by expert
  int* meta;                    // (2 (E + 1)): segment starts, tile starts
  void* act;                    // (N * k, I) T, held pairs only
  float* ybuf;                  // (N * k, H) fp32, held pairs only
  void* out;                    // (N, H) T
  unsigned long long* counters; // (3,) or null
  int N, k, H, I, E;
  long long offset, sx, so;
};

__global__ void __launch_bounds__(1024) group_kernel(const Args a) {
  extern __shared__ int gsm[];
  int* cnt = gsm;
  int* fill = gsm + a.E;
  int* seg = gsm + 2 * a.E;     // E + 1
  for (int e = threadIdx.x; e < a.E; e += blockDim.x) cnt[e] = fill[e] = 0;
  __syncthreads();
  const int P = a.N * a.k;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const long long e = a.idx[p] - a.offset;
    if (e >= 0 && e < a.E) atomicAdd(cnt + e, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0, t = 0, read = 0;
    for (int e = 0; e < a.E; ++e) {
      seg[e] = a.meta[e] = s;
      a.meta[a.E + 1 + e] = t;
      s += cnt[e];
      t += (cnt[e] + BM - 1) / BM;
      read += cnt[e] > 0;
    }
    seg[a.E] = a.meta[a.E] = s;
    a.meta[2 * a.E + 1] = t;
    if (a.counters != nullptr) {
      a.counters[0] += (unsigned long long)s;
      a.counters[1] += (unsigned long long)read;
      a.counters[2] += 1ull;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const long long e = a.idx[p] - a.offset;
    if (e >= 0 && e < a.E) a.perm[seg[e] + atomicAdd(fill + e, 1)] = p;
  }
}

// The staged tiles (A: BM x BK, B: NB of BN x BK, rows padded by one
// 16-byte vector) and, after the reduction, the fp32 output tiles in the
// same shared memory.
template <typename T, int NB>
struct Smem {
  static constexpr int LDS = BK + Vec16<T>::N;
  static constexpr int STAGE = (BM + NB * BN) * LDS * (int)sizeof(T);
  static constexpr int OUT = NB * BM * LDC * (int)sizeof(float);
  static constexpr int BYTES = STAGE > OUT ? STAGE : OUT;
};

template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Args a) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int NB = GATED ? 2 : 1;
  using S = Smem<T, NB>;
  constexpr int LDS = S::LDS;
  constexpr int CHUNKS = BK / VEC;                // 16-byte loads a row
  constexpr int LOADS = BM * CHUNKS / THREADS;    // a thread's, a matrix
  static_assert(BM == BN && LOADS * THREADS == BM * CHUNKS, "tile loads");
  __shared__ __align__(128) unsigned char smem[S::BYTES];
  __shared__ int pid[BM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * LDS;                          // NB tiles of BN x LDS
  float* Cs = reinterpret_cast<float*>(smem);     // NB tiles of BM x LDC

  const int* seg = a.meta;
  const int* tiles = a.meta + a.E + 1;
  const int t = blockIdx.x;
  if (t >= tiles[a.E]) return;
  int lo = 0, hi = a.E - 1;                       // last e: tiles[e] <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tiles[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int e = lo;
  const int r0 = seg[e] + (t - tiles[e]) * BM;
  const int nr = min(BM, seg[e + 1] - r0);
  if (threadIdx.x < BM) pid[threadIdx.x] =
      threadIdx.x < nr ? a.perm[r0 + threadIdx.x] : -1;
  __syncthreads();

  const int K = GATED ? a.H : a.I;
  const int NOUT = GATED ? a.I : a.H;
  const int n0 = blockIdx.y * BN;
  const T* A = static_cast<const T*>(GATED ? a.x : a.act);
  const long long sa = GATED ? a.sx : a.I;
  const T* W[NB];
  W[0] = static_cast<const T*>(GATED ? a.gate : a.down) +
         (long long)e * NOUT * K;
  if constexpr (GATED)
    W[NB - 1] = static_cast<const T*>(a.up) + (long long)e * NOUT * K;

  uint4 ra[LOADS], rb[NB][LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / CHUNKS, kk = k0 + (c % CHUNKS) * VEC;
      const int p = pid[r];
      ra[i] = make_uint4(0, 0, 0, 0);
      if (p >= 0 && kk < K)
        ra[i] = *reinterpret_cast<const uint4*>(
            A + (long long)(GATED ? p / a.k : p) * sa + kk);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        rb[b][i] = make_uint4(0, 0, 0, 0);
        if (n0 + r < NOUT && kk < K)
          rb[b][i] = __ldg(reinterpret_cast<const uint4*>(
              W[b] + (long long)(n0 + r) * K + kk));
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int off = (c / CHUNKS) * LDS + (c % CHUNKS) * VEC;
      *reinterpret_cast<uint4*>(As + off) = ra[i];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        *reinterpret_cast<uint4*>(Bs + b * BN * LDS + off) = rb[b][i];
    }
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 8 warps: 4 row blocks of 16 x 2 column halves of 32
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][j], 0.f);
    load(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < K) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + wm * 16 * LDS + kk, LDS);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> fb;
            wmma::load_matrix_sync(
                fb, Bs + b * BN * LDS + (wn * 32 + j * 16) * LDS + kk, LDS);
            wmma::mma_sync(acc[b][j], fa, fb, acc[b][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + b * BM * LDC + wm * 16 * LDC + wn * 32 + j * 16, acc[b][j],
            LDC, wmma::mem_row_major);
  } else {
    // 16 x 16 threads, each 4 rows x 4 columns
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[NB][4][4] = {};
    load(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < K) load(k0 + BK);
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = to_float(As[(ty * 4 + i) * LDS + kk]);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bv =
                to_float(Bs[b * BN * LDS + (tx * 4 + j) * LDS + kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[b][i][j] = fmaf(av[i], bv, acc[b][i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cs[b * BM * LDC + (ty * 4 + i) * LDC + tx * 4 + j] = acc[b][i][j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, p = pid[r], n = n0 + c;
    if (p < 0 || n >= NOUT) continue;
    if constexpr (GATED) {
      const float g = Cs[r * LDC + c], u = Cs[BM * LDC + r * LDC + c];
      static_cast<T*>(a.act)[(long long)p * a.I + n] =
          from_float<T>(g / (1.f + expf(-g)) * u);
    } else {
      a.ybuf[(long long)p * a.H + n] = a.w[p] * Cs[r * LDC + c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(const Args a) {
  const int n = blockIdx.x;
  const long long* idx = a.idx + (long long)n * a.k;
  T* out = static_cast<T*>(a.out) + n * a.so;
  for (int m = threadIdx.x; m < a.H; m += THREADS) {
    float acc = 0.f;
    for (int j = 0; j < a.k; ++j) {
      const long long e = idx[j] - a.offset;
      if (e >= 0 && e < a.E)
        acc += a.ybuf[((long long)n * a.k + j) * a.H + m];
    }
    out[m] = from_float<T>(acc);
  }
}

template <typename T>
int launch_t(const Args& a, cudaStream_t st) {
  constexpr int VEC = Vec16<T>::N;
  if (a.k <= 0 || a.E > MAX_E || (long long)a.N * a.k > 0x7fffffffLL ||
      a.H % VEC || a.I % VEC || a.sx % VEC)
    return (int)cudaErrorInvalidValue;
  if (a.N == 0) return 0;
  if (a.E > 0) {
    group_kernel<<<1, 1024, (3 * a.E + 1) * sizeof(int), st>>>(a);
    const int tiles = (a.N * a.k + BM - 1) / BM + a.E;
    gemm_kernel<T, true><<<dim3(tiles, (a.I + BN - 1) / BN), THREADS, 0,
                           st>>>(a);
    gemm_kernel<T, false><<<dim3(tiles, (a.H + BN - 1) / BN), THREADS, 0,
                            st>>>(a);
  }
  combine_kernel<T><<<a.N, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace moe_grouped
}  // namespace moss

// dtype (of x, the weights, act and out): 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the three launches (0 on success), or
// cudaErrorInvalidValue for more than 256 tokens, widths not a multiple of
// a 16-byte vector, or an unknown dtype.
extern "C" int moss_moe_experts(int dtype, const void* x, const long long* idx,
                                const float* w, const void* gate,
                                const void* up, const void* down, void* act,
                                float* ybuf, void* out,
                                unsigned long long* counters, int N, int k,
                                int H, int I, int E, long long offset,
                                long long sx, long long so, void* stream) {
  const moss::moe::Args a{x,    idx,  w,        gate, up, down, act, ybuf,
                          out,  counters, N,    k,    H,  I,    E,   offset,
                          sx,   so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return moss::moe::launch_t<float>(a, st);
  if (dtype == 1) return moss::moe::launch_t<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The grouped GEMM (moss::moe_grouped), any number of tokens; perm (N * k)
// and meta (2 (E + 1)) int32 are its scratch. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for more than 1024 held
// experts, N * k past int32, widths not a multiple of a 16-byte vector, or
// an unknown dtype.
extern "C" int moss_moe_experts_grouped(
    int dtype, const void* x, const long long* idx, const float* w,
    const void* gate, const void* up, const void* down, int* perm, int* meta,
    void* act, float* ybuf, void* out, unsigned long long* counters, int N,
    int k, int H, int I, int E, long long offset, long long sx, long long so,
    void* stream) {
  const moss::moe_grouped::Args a{x,    idx,  w,    gate, up,       down,
                                  perm, meta, act,  ybuf, out,      counters,
                                  N,    k,    H,    I,    E,        offset,
                                  sx,   so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return moss::moe_grouped::launch_t<float>(a, st);
  if (dtype == 1) return moss::moe_grouped::launch_t<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
