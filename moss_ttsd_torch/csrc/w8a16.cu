// The weight-only int8 product (w8a16): y = x (W_q s)^T for activations x
// (M, K), an int8 weight W_q (N, K) and fp32 per-output-row scales s (N).
// Three kernels, one contract: moss::w8a16 for a decode step's at most 16
// rows of bf16 (bound by the weight bytes), moss::w8a16_gemm for more rows of
// bf16 (a prefill: bound by the products), moss::w8a16_simt for fp32 x.
//
// Replaces no TPU kernel: the JAX package's QDense writes the dequantisation
// as jnp ops and XLA fuses it into the dot's read. PyTorch has no call that
// multiplies bf16 by int8 with per-row scales, so without these kernels every
// QLinear call and every int8 head wrote a copy of its whole weight in x's
// type (read 1 byte, write 2, read 2, write 2, then the GEMM reads 2 again).
//
// Contract (ops/w8a16.w8a16_plain is the same function in torch):
//   * head 0, a projection (QLinear): the weight the product reads is
//     bf16(bf16(q) * bf16(s)) element by element, as the plain path's
//     `weight_q.to(bf16) * weight_s.to(bf16)` rounds it; the sum is fp32,
//     plus bf16(bias) where given, rounded once to the bf16 output;
//   * head 1, a tied int8 head: the weight is bf16(q) (exact), the sum fp32,
//     times s in fp32 (the plain path's `matmul_f32_out(h, q^T) * s`); the
//     output is fp32.
//   * fp32 x (moss::w8a16_simt): a projection's weight is fp32(q * s), a
//     head's float(q), the sum fp32.
// So each kernel equals the plain path up to the order of the fp32 sum.
//
// moss::w8a16, the decode step. What bounds it on an H100: bytes. At M <= 16
// rows each weight byte feeds at most 32 flops, far below the ~295 flop/byte
// ridge, and the weights are the bytes (a MOSS-TTSD step reads 1.74 GB of them). So each weight byte is
// read once from HBM and widened in registers; nothing else is written.
//   * The tensor cores do the sums with the roles swapped: 16 weight rows are
//     the A operand of mma.sync.m16n8k16 (bf16, fp32 accumulators) and the
//     activation rows the n = 8 operand (two of them above 8 rows), so a
//     decode step's 8 rows use the tensor cores without padding.
//   * A lane reads 16 contiguous bytes of two weight rows (g and g + 8 of
//     its block's 16) per 64-wide chunk of K, with 16-byte loads that skip
//     L1, U chunks in flight a warp. The 16 bytes are the lane's k-slots of
//     four consecutive mma steps: the sum runs over K in any order, so slot
//     2t (+1, +8, +9) of step q is K = 16t + 4q (+1, +2, +3) of the chunk,
//     for the weights and for the activations alike. The activation bytes
//     of that map are two 16-byte loads a lane (L1-resident: x is at most
//     16 x K bf16, read by every block).
//   * Widening: each int8 goes to an exact float by a byte permute into the
//     mantissa of 2^23 and one subtraction; a projection multiplies it by
//     bf16(s) in fp32 (exact: 8 x 8 significant bits) and rounds the pair to
//     bf16 once, so its weights are the plain path's bit for bit.
//   * A block (8 warps) owns 16 weight rows; its warps take turns over the
//     K chunks and sum their accumulators through shared memory in a fixed
//     order, so the result is the same on every run.
//   * One launch may cover up to three weights that read the same x (q/k/v,
//     gate/up): their row tiles follow each other in the grid, and a block
//     finds its weight in a table of (pointer, N, output). A MOSS-TTSD layer
//     is four launches, not seven: a launch's fixed cost (3-5 us on the
//     H100, PERF.md §6) is as long as reading 10-15 MB. For the same reason
//     the K range is never split across blocks: a second pass over partial
//     sums cost more than the idle SMs it fills, at every shape measured.

#include <cuda.h>

#include "common.cuh"
#include "sm90.cuh"

namespace moss {
namespace w8a16 {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;       // weight rows a block: the mma's M
constexpr int CHUNK = 64;      // K of a row that a warp reads a step
constexpr int U = 4;           // chunks whose loads a warp keeps in flight
constexpr int MAX_M = 16;      // activation rows: two n = 8 operands
constexpr int MAX_GROUP = 3;   // weights of one launch (q, k, v)

// One weight of a launch: its rows are the launch's row tiles [tile0,
// tile0 + ceil(N / the kernel's tile rows)), in blockIdx.x.
struct Entry {
  const int8_t* w;             // (N, K), row stride sw
  const float* s;              // (N,)
  const void* bias;            // (N,) in x's type, or null (projections only)
  void* out;                   // (M, N), row stride so: x's type, or fp32 (head)
  long long sw, so;
  int N, tile0;
};

struct Args {
  const void* x;               // (M, K), row stride sx: bf16, or fp32 (simt)
  Entry e[MAX_GROUP];
  long long sx;
  int groups, tiles, M, K;
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four int8 of a 32-bit word as exact floats: byte b of w ^ 0x80 (q +
// 128, in [1, 255]) into the low mantissa byte of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void widen(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Two widened weights as a bf16x2 operand register (a in the low half). A
// head takes bf16(q): the upper halves of the floats, exact for |q| <= 127.
// A projection takes bf16(q * bf16(s)), rounded to nearest even.
template <bool HEAD>
__device__ __forceinline__ uint32_t pack(float a, float b, float sc) {
  if (HEAD)
    return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
  const __nv_bfloat162 h = __floats2bfloat162_rn(a * sc, b * sc);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// NT: n = 8 operands (1: M <= 8, 2: M <= 16). A block a row tile of 16,
// over the entries' tiles in turn.
template <int NT, bool HEAD>
__global__ void __launch_bounds__(THREADS) product_kernel(const Args a) {
  __shared__ float red[WARPS][ROWS][8 * NT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x;
  int gi = 0;
  while (gi + 1 < a.groups && tile >= a.e[gi + 1].tile0) ++gi;
  const Entry& e = a.e[gi];
  const int rA = (tile - e.tile0) * ROWS + g, rB = rA + 8;
  const bool okA = rA < e.N, okB = rB < e.N;
  const int8_t* wA = e.w + (okA ? rA : 0) * e.sw + t * 16;
  const int8_t* wB = e.w + (okB ? rB : 0) * e.sw + t * 16;
  float sA = 0.f, sB = 0.f;
  if (!HEAD) {
    sA = okA ? round_to<__nv_bfloat16>(e.s[rA]) : 0.f;
    sB = okB ? round_to<__nv_bfloat16>(e.s[rB]) : 0.f;
  }
  const __nv_bfloat16* xr[NT];
  bool xok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = nt * 8 + g;
    xok[nt] = m < a.M;
    xr[nt] = static_cast<const __nv_bfloat16*>(a.x) + (xok[nt] ? m : 0) * a.sx +
             t * 16;
  }
  const int chunks = (a.K + CHUNK - 1) / CHUNK;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int base = warp * U; base < chunks; base += WARPS * U) {
    uint4 va[U], vb[U];            // this lane's 16 bytes of rows g, g + 8
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long off = (long long)(base + j) * CHUNK;
      const bool in = off + t * 16 < a.K;
      va[j] = in && okA ? ld_stream(wA + off) : make_uint4(0, 0, 0, 0);
      vb[j] = in && okB ? ld_stream(wB + off) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (base + j >= chunks) break;               // warp-uniform
      const long long off = (long long)(base + j) * CHUNK;
      const bool kin = off + t * 16 < a.K;
      uint4 xv[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (xok[nt] && kin) {
          xv[nt][0] = __ldg(reinterpret_cast<const uint4*>(xr[nt] + off));
          xv[nt][1] = __ldg(reinterpret_cast<const uint4*>(xr[nt] + off + 8));
        } else {
          xv[nt][0] = xv[nt][1] = make_uint4(0, 0, 0, 0);
        }
      }
      const uint32_t wa[4] = {va[j].x, va[j].y, va[j].z, va[j].w};
      const uint32_t wb[4] = {vb[j].x, vb[j].y, vb[j].z, vb[j].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {               // K = 16t + 4q .. + 3
        float fa[4], fb[4];
        widen(wa[q], fa);
        widen(wb[q], fb);
        const uint32_t a0 = pack<HEAD>(fa[0], fa[1], sA);
        const uint32_t a1 = pack<HEAD>(fb[0], fb[1], sB);
        const uint32_t a2 = pack<HEAD>(fa[2], fa[3], sA);
        const uint32_t a3 = pack<HEAD>(fb[2], fb[3], sB);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4& xx = xv[nt][q / 2];
          mma(acc[nt], a0, a1, a2, a3, q % 2 ? xx.z : xx.x,
              q % 2 ? xx.w : xx.y);
        }
      }
    }
  }

  // accumulator (row g | g + 8, activation row nt * 8 + 2t | + 1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = nt * 8 + 2 * t;
    red[warp][g][m] = acc[nt][0];
    red[warp][g][m + 1] = acc[nt][1];
    red[warp][g + 8][m] = acc[nt][2];
    red[warp][g + 8][m + 1] = acc[nt][3];
  }
  __syncthreads();
  // one output (row r, activation row m) a thread, summed over the warps
  // in a fixed order
  static_assert(THREADS >= ROWS * 8 * NT, "an output a thread");
  const int o = threadIdx.x, r = o % ROWS, m = o / ROWS;
  const int n = (tile - e.tile0) * ROWS + r;
  if (o >= ROWS * 8 * NT || m >= a.M || n >= e.N) return;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v += red[w][r][m];
  const long long at = (long long)m * e.so + n;
  if (HEAD) {
    static_cast<float*>(e.out)[at] = v * e.s[n];
  } else {
    const float y =
        e.bias != nullptr
            ? v + __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[n])
            : v;
    static_cast<__nv_bfloat16*>(e.out)[at] = __float2bfloat16(y);
  }
}

template <int NT, bool HEAD>
int launch_t(const Args& a, cudaStream_t st) {
  product_kernel<NT, HEAD><<<a.tiles, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace w8a16

// ---------------------------------------------------------------------------
// moss::w8a16_gemm: more than 16 rows of bf16 (a prefill, the pool's
// admission bursts). Each weight byte now serves hundreds of rows, so the
// products bound it, and the tensor cores' wgmma does them; the int8 tile is
// widened in shared memory on its way to the tensor cores, and no bf16 copy
// of the weight reaches HBM.
//   * A block: 128 weight rows by 256 activation rows (8 rows of a 128-token
//     bucket make a multiple of 256), over K in 64-wide stages, in a ring of
//     STAGES slots (x tile, raw int8 tile, widened tile). Three warpgroups
//     with their own work (warp specialisation), handing slots over by
//     mbarriers:
//   * the producer (warpgroup 0, one thread, few registers) waits for an
//     empty slot and fetches the stage's x box (bf16, 128-byte swizzle, the
//     wgmma layout) and int8 box by TMA; the copy engine zero-fills past the
//     tensors' edges;
//   * two consumers (warpgroups 1 and 2, 64 weight rows each): for each
//     full slot, widen their half of the int8 tile to bf16(bf16(q) bf16(s))
//     (a projection) or bf16(q) (a head) with the decode kernel's
//     permute-and-subtract into the slot's operand tile, then issue one
//     m64n256k16 a 16-wide k-step (the widest N: the fewest shared-memory
//     operand bytes a product). A stage is widened while the tensor cores
//     run the previous stage's products; its slot is marked empty once its
//     products are done, a stage later;
//   * the fp32 tile goes through shared memory to coalesced rows of out:
//     bias added and one rounding to bf16 (a projection), or times s in
//     fp32 (a head, fp32 out).
// The K order of the sum is fixed, so the result is the same on every run.
namespace w8a16_gemm {

constexpr int WG = 128;            // one warpgroup
constexpr int THREADS = 3 * WG;    // a producer and two consumers
constexpr int BW = 128;            // weight rows a block
constexpr int BX = 256;            // activation rows a block
constexpr int BK = 64;             // K a stage: one 128-byte bf16 panel
constexpr int STAGES = 4;          // slots of the ring
constexpr int XT = BX * 128;       // bytes of a stage's x tile
constexpr int WT = BW * 128;       // bytes of a widened weight tile
constexpr int RT = BW * BK;        // bytes of a stage's int8 tile
constexpr int LDC = BW + 4;        // fp32 row of the staged output tile
constexpr int RING = STAGES * (XT + WT + RT);
constexpr size_t SMEM = RING + 1024;   // + the swizzle atom's alignment
static_assert(BX * LDC * (int)sizeof(float) <= RING, "output tile fits");

// The launch's tensor maps: x, and each weight of the group.
struct Maps {
  CUtensorMap x;
  CUtensorMap w[w8a16::MAX_GROUP];
};

template <bool HEAD>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const w8a16::Args a, const __grid_constant__ Maps maps) {
  extern __shared__ uint8_t smem_raw[];
  // a slot's phases: its boxes landed (TMA bytes), its products done
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* Xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Wb = Xs + STAGES * XT;                  // widened tiles
  uint8_t* Wr = Wb + STAGES * WT;                  // int8 tiles
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int tile = blockIdx.x;
  int gi = 0;
  while (gi + 1 < a.groups && tile >= a.e[gi + 1].tile0) ++gi;
  const w8a16::Entry& e = a.e[gi];
  const int n0 = (tile - e.tile0) * BW, m0 = blockIdx.y * BX;
  const int nk = (a.K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * WG);
    }
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer. The registers it gives up are what the consumers
    // take: launched at 168 a thread, (168 - 40) x 128 >= (232 - 168) x 256
    sm90::regs_dec<40>();
    if (t == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect(&full[s], XT + RT);
        sm90::tma_2d(Xs + s * XT, &maps.x, i * BK, m0, &full[s]);
        sm90::tma_2d(Wr + s * RT, &maps.w[gi], i * BK, n0, &full[s]);
      }
    }
    return;
  }

  // ---- the consumers: 64 weight rows each, all 256 activation rows
  sm90::regs_inc<232>();
  const int c = wg - 1;
  // this thread's int8 pieces: 16 bytes at column 16 cw of rows rw + 32 j
  const int rw = 64 * c + t / 4, cw = t % 4;
  float sc[2] = {0.f, 0.f};
  if (!HEAD) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + rw + 32 * j;
      sc[j] = n < e.N ? round_to<__nv_bfloat16>(e.s[n]) : 0.f;
    }
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* wr = Wr + s * RT;
    uint8_t* wb = Wb + s * WT;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rw + 32 * j;
      const uint4 v = *reinterpret_cast<const uint4*>(wr + r * BK + cw * 16);
      const uint32_t q4[4] = {v.x, v.y, v.z, v.w};
      uint32_t p[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
        w8a16::widen(q4[q], f);
        p[2 * q] = w8a16::pack<HEAD>(f[0], f[1], sc[j]);
        p[2 * q + 1] = w8a16::pack<HEAD>(f[2], f[3], sc[j]);
      }
      // bf16 columns 16 cw .. 16 cw + 15: chunks 2 cw and 2 cw + 1
      *reinterpret_cast<uint4*>(wb + sm90::sw128(r, 2 * cw)) =
          make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(wb + sm90::sw128(r, 2 * cw + 1)) =
          make_uint4(p[4], p[5], p[6], p[7]);
    }
    sm90::fence_proxy_async();                     // the widened half
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    const uint8_t* xs = Xs + s * XT;
    wb += c * 64 * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_m64n256k16_ss(acc, sm90::desc_sw128(wb + kk * 32),
                                sm90::desc_sw128(xs + kk * 32), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();                         // stage i - 1 done
    sm90::fence_regs(acc);
    if (i > 0) sm90::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // both consumers' products done: the ring becomes the output tile
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * WG) : "memory");

  // accumulator element 4 j + 2 v1 + v0: weight row 64 c + 16 warp +
  // lane / 4 + 8 v1, activation row 8 j + 2 (lane % 4) + v0
  float* Cs = reinterpret_cast<float*>(Xs);
  const int warp = t / 32, lane = t % 32;
  const int rn = c * 64 + warp * 16 + lane / 4, cm = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BX / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      Cs[(8 * j + cm + v % 2) * LDC + rn + 8 * (v / 2)] = acc[4 * j + v];
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * WG) : "memory");
  for (int i = tid - WG; i < BX * BW; i += 2 * WG) {
    const int m = i / BW, r = i % BW, n = n0 + r;
    if (m0 + m >= a.M || n >= e.N) continue;
    const float v = Cs[m * LDC + r];
    const long long at = (long long)(m0 + m) * e.so + n;
    if (HEAD) {
      static_cast<float*>(e.out)[at] = v * e.s[n];
    } else {
      const float y =
          e.bias != nullptr
              ? v + __bfloat162float(
                        static_cast<const __nv_bfloat16*>(e.bias)[n])
              : v;
      static_cast<__nv_bfloat16*>(e.out)[at] = __float2bfloat16(y);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// The map of a (rows, K) row-major matrix (row stride `ld` bytes) read in
// boxes of 64 columns by `box_rows` rows.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type,
                   const void* base, int K, int rows, long long ld,
                   int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool HEAD>
int launch_t(const w8a16::Args& a, cudaStream_t st) {
  Maps maps;
  if (!encode(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M,
              a.sx * 2, BX, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.groups; ++i)
    if (!encode(&maps.w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, a.e[i].w, a.K,
                a.e[i].N, a.e[i].sw, BW, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  auto kern = gemm_kernel<HEAD>;
  static bool cap = false;       // the shared-memory limit, raised once
  if (!cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    cap = true;
  }
  kern<<<dim3(a.tiles, (a.M + BX - 1) / BX), THREADS, SMEM, st>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace w8a16_gemm

// ---------------------------------------------------------------------------
// moss::w8a16_simt: fp32 activations, any number of rows (an fp32 compute
// dtype on the card: the tiny engines of the tests). The plain version's
// weight is fp32(q s) for a projection, and float(q) with s on the fp32 sum
// for a head; the tensor cores take no fp32, so CUDA cores do the products:
// 64 x 64 output tiles, 4 x 4 a thread, K staged 32 at a time.
namespace w8a16_simt {

constexpr int THREADS = 256;
constexpr int BW = 64;             // weight rows a block
constexpr int BX = 64;             // activation rows a block
constexpr int BK = 32;

template <bool HEAD>
__global__ void __launch_bounds__(THREADS) simt_kernel(const w8a16::Args a) {
  __shared__ float Ws[BK][BW + 1];
  __shared__ float Xs[BK][BX + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x;
  int gi = 0;
  while (gi + 1 < a.groups && tile >= a.e[gi + 1].tile0) ++gi;
  const w8a16::Entry& e = a.e[gi];
  const int n0 = (tile - e.tile0) * BW, m0 = blockIdx.y * BX;
  const float* x = static_cast<const float*>(a.x);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    for (int i = tid; i < BW * BK; i += THREADS) {
      const int r = i / BK, k = i % BK, n = n0 + r, m = m0 + r;
      float w = 0.f, xv = 0.f;
      if (n < e.N && k0 + k < a.K) {
        w = (float)e.w[(long long)n * e.sw + k0 + k];
        if (!HEAD) w *= e.s[n];                     // fp32(q s), the copy's
      }
      if (m < a.M && k0 + k < a.K) xv = x[(long long)m * a.sx + k0 + k];
      Ws[k][r] = w;
      Xs[k][r] = xv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float wv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i] = Ws[k][ty * 4 + i];
        xv[i] = Xs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= e.N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx * 4 + j;
      if (m >= a.M) continue;
      float* out = static_cast<float*>(e.out) + (long long)m * e.so + n;
      if (HEAD)
        *out = acc[i][j] * e.s[n];
      else
        *out = e.bias != nullptr
                   ? acc[i][j] + static_cast<const float*>(e.bias)[n]
                   : acc[i][j];
    }
  }
}

template <bool HEAD>
int launch_t(const w8a16::Args& a, cudaStream_t st) {
  simt_kernel<HEAD><<<dim3(a.tiles, (a.M + BX - 1) / BX), THREADS, 0, st>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace w8a16_simt
}  // namespace moss

// One launch over `groups` (1-3) weights that read the same x: entry i is
// w[i] (N[i], K) int8 with row stride sw[i], s[i] (N[i],) fp32, bias[i]
// (N[i],) in x's type or null, out[i] (M, N[i]) with row stride so[i].
// kernel: 0 = the decode product (bf16 x, M 1-16), 1 = the wgmma GEMM (bf16
// x, any M), 2 = the SIMT product (fp32 x, any M). head: 0 = projections
// (out in x's type, the scale inside the weight, optional bias), 1 = tied
// heads (fp32 out, the scale on the fp32 sum, no bias). Strides in
// elements; for bf16, x and w rows 16-byte aligned. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown kernel, M outside its range, K not a positive multiple of 16, a
// misaligned row stride or an empty weight.
extern "C" int moss_w8a16(int kernel, int head, int groups, const void* x,
                          long long sx, const void* const* w,
                          const long long* sw, const float* const* s,
                          const void* const* bias, void* const* out,
                          const long long* so, const int* N, int M, int K,
                          void* stream) {
  using namespace moss;
  constexpr int tile_rows[3] = {w8a16::ROWS, w8a16_gemm::BW, w8a16_simt::BW};
  if (kernel < 0 || kernel > 2 || groups < 1 || groups > w8a16::MAX_GROUP ||
      M < 1 || (kernel == 0 && M > w8a16::MAX_M) || M > (1 << 21) ||
      K < 16 || K % 16 || (kernel < 2 && sx % 8))
    return (int)cudaErrorInvalidValue;
  w8a16::Args a{};
  a.x = x;
  a.sx = sx;
  a.groups = groups;
  a.M = M;
  a.K = K;
  int tiles = 0;
  for (int i = 0; i < groups; ++i) {
    if (N[i] < 1 || (kernel < 2 && sw[i] % 16) ||
        (head && bias[i] != nullptr))
      return (int)cudaErrorInvalidValue;
    a.e[i] = w8a16::Entry{static_cast<const int8_t*>(w[i]), s[i], bias[i],
                          out[i], sw[i], so[i], N[i], tiles};
    tiles += (N[i] + tile_rows[kernel] - 1) / tile_rows[kernel];
  }
  a.tiles = tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 1)
    return head ? w8a16_gemm::launch_t<true>(a, st)
                : w8a16_gemm::launch_t<false>(a, st);
  if (kernel == 2)
    return head ? w8a16_simt::launch_t<true>(a, st)
                : w8a16_simt::launch_t<false>(a, st);
  if (head)
    return M <= 8 ? w8a16::launch_t<1, true>(a, st)
                  : w8a16::launch_t<2, true>(a, st);
  return M <= 8 ? w8a16::launch_t<1, false>(a, st)
                : w8a16::launch_t<2, false>(a, st);
}
