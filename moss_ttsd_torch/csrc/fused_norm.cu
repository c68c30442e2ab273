// The elementwise glue between a cached decoder block's projections, fused:
//   moss::residual_rms_norm  x' = x + (y, or RMSNorm(y; w_y)), h = RMSNorm(x'; w)
//   moss::qk_norm_rope       per-head RMSNorm of q and k, then rotate-half RoPE
//   moss::silu_mul           silu(gate) * up
//
// Replaces no TPU kernel: the JAX package writes these chains as jnp ops and
// XLA fuses each into one loop. PyTorch runs them op by op: an RMSNorm was 7
// launches (fp32 copy, square, mean, + eps, rsqrt, multiply, bf16 copy, times
// the weight), RoPE 7 more for q and again for k, so a MOSS-TTSD decode step
// launched ~1200 of these tiny kernels (ops/fused_norm.py's plain versions
// are those chains, and each kernel's oracle).
//
// What bounds them on an H100: a decode step's rows are 8-16 x 2048 values,
// microseconds of bytes, so one launch's fixed cost (~2 us in a graph replay)
// is the whole time; a prefill's 5120 x 2048 rows are bound by their bytes,
// read once and written once here. So each kernel is one pass, keeps the
// values in registers between its reductions and writes only its outputs.
//
// Numerics: the plain chains' rounding points, kept one by one. The sums of
// squares are fp32 (only their order differs), the mean is the sum times 1/N
// (torch's mean), the statistic rsqrtf(mean + eps) as torch's rsqrt; the
// normed value is rounded to T before the weight multiply, which rounds once;
// RoPE is fp32 over the normed (rounded) q or k, x c + rot(x) s with each
// product rounded before the sum (no fused multiply-add: torch computes the
// two products and the sum as three ops), rounded once to T; a residual sum
// is rounded once to T. So the outputs equal the plain versions' up to the
// order of the fp32 reductions.

#include "common.cuh"

namespace moss {
namespace fused_norm {

constexpr int MAX_THREADS = 1024;
constexpr int QK_WARPS = 8;          // warps a block, one (row, head) each

// Store 16 bytes of T at p (16-byte aligned), rounding each float once.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The block's sum of v, the same value in every thread (each warp adds the
// warps' partials in the same order). `red` holds 32 floats; the leading
// barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x / 32) ? red[lane] : 0.f);
}

// rsqrt(mean of squares + eps) over a row, as torch computes it.
__device__ __forceinline__ float inv_rms(float sum_sq, float inv_n, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sum_sq, inv_n), eps));
}

// rms_norm_fn's value: T(T(v r) w).
template <typename T>
__device__ __forceinline__ float normed(float v, float r, float w) {
  return round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(v, r)), w));
}

struct RowArgs {
  const void* x; long long sx;       // (rows, N), row stride in elements
  const void* y; long long sy;       // the addend, or null
  const void* wy;                    // the addend's norm weight, or null
  const void* w;                     // the output's norm weight, or null
  void* xo; long long sxo;           // x + y', written when y is given
  void* ho; long long sho;           // RMSNorm(x'; w), written when w is given
  int N;
  float eps, inv_n;
};

// One block a row, VPT 16-byte vectors a thread.
template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
residual_rms_norm_kernel(RowArgs a) {
  constexpr int V = Vec16<T>::N;
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* x = static_cast<const T*>(a.x) + row * a.sx;
  float xv[VPT][V];
  int at[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    at[j] = (threadIdx.x + j * blockDim.x) * V;
    if (at[j] < a.N) unpack16(x + at[j], xv[j]);
  }
  if (a.y != nullptr) {
    const T* y = static_cast<const T*>(a.y) + row * a.sy;
    float yv[VPT][V];
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (at[j] < a.N) unpack16(y + at[j], yv[j]);
    if (a.wy != nullptr) {     // block-uniform: every thread takes it
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (at[j] >= a.N) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) ss += __fmul_rn(yv[j][e], yv[j][e]);
      }
      const float r = inv_rms(block_sum(ss, red), a.inv_n, a.eps);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (at[j] >= a.N) continue;
        float wv[V];
        unpack16(static_cast<const T*>(a.wy) + at[j], wv);
#pragma unroll
        for (int e = 0; e < V; ++e) yv[j][e] = normed<T>(yv[j][e], r, wv[e]);
      }
    }
    T* xo = static_cast<T*>(a.xo) + row * a.sxo;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (at[j] >= a.N) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        xv[j][e] = round_to<T>(__fadd_rn(xv[j][e], yv[j][e]));
      store16(xo + at[j], xv[j]);
    }
  }
  if (a.w == nullptr) return;  // block-uniform
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (at[j] >= a.N) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) ss += __fmul_rn(xv[j][e], xv[j][e]);
  }
  const float r = inv_rms(block_sum(ss, red), a.inv_n, a.eps);
  T* ho = static_cast<T*>(a.ho) + row * a.sho;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (at[j] >= a.N) continue;
    float wv[V];
    unpack16(static_cast<const T*>(a.w) + at[j], wv);
#pragma unroll
    for (int e = 0; e < V; ++e) wv[e] = normed<T>(xv[j][e], r, wv[e]);
    store16(ho + at[j], wv);
  }
}

struct QKArgs {
  const void* src[2];                 // q (B, T, H, D), k (B, T, Hkv, D)
  long long sb[2], st[2], sh[2];      // their batch, time and head strides
  const void* w[2];                   // q_norm, k_norm weights (D,)
  void* out[2];                       // contiguous (B, T, H | Hkv, D)
  const float* cos; const float* sin; // (B, T, D) fp32, strided by
  long long cos_b, cos_t, sin_b, sin_t;  // batch and time
  int B, T, H, Hkv, D, rope;
  float eps, inv_d;
};

// One warp a (b, t, head) row of q (heads [0, H)) or k (heads [H, H + Hkv)).
// A lane holds P rotate-half pairs (d, d + D/2), d = lane + 32 p, so the
// rotation needs no exchange between lanes.
template <typename T, int P>
__global__ void __launch_bounds__(QK_WARPS * 32) qk_norm_rope_kernel(QKArgs a) {
  const long long warp = (long long)blockIdx.x * QK_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int heads = a.H + a.Hkv;
  if (warp >= (long long)a.B * a.T * heads) return;   // warp-uniform
  const int hh = warp % heads;
  const long long bt = warp / heads;
  const int b = bt / a.T, t = bt % a.T;
  const int s = hh < a.H ? 0 : 1;
  const int h = s == 0 ? hh : hh - a.H;
  const T* src = static_cast<const T*>(a.src[s]) + b * a.sb[s] + t * a.st[s] +
                 h * a.sh[s];
  const T* w = static_cast<const T*>(a.w[s]);
  T* out = static_cast<T*>(a.out[s]) +
           (bt * (s == 0 ? a.H : a.Hkv) + h) * (long long)a.D;
  const int half = a.D / 2;
  float lo[P], hi[P];
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int d = lane + 32 * p;
    if (d >= half) continue;
    lo[p] = to_float(src[d]);
    hi[p] = to_float(src[d + half]);
    ss += __fmul_rn(lo[p], lo[p]) + __fmul_rn(hi[p], hi[p]);
  }
  const float r = inv_rms(warp_sum(ss), a.inv_d, a.eps);
  const float* c = a.cos + b * a.cos_b + t * a.cos_t;
  const float* sn = a.sin + b * a.sin_b + t * a.sin_t;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int d = lane + 32 * p;
    if (d >= half) continue;
    float l = normed<T>(lo[p], r, to_float(w[d]));
    float u = normed<T>(hi[p], r, to_float(w[d + half]));
    if (a.rope) {
      const float l2 = __fadd_rn(__fmul_rn(l, c[d]), -__fmul_rn(u, sn[d]));
      u = __fadd_rn(__fmul_rn(u, c[d + half]), __fmul_rn(l, sn[d + half]));
      l = l2;
    }
    out[d] = from_float<T>(l);
    out[d + half] = from_float<T>(u);
  }
}

// silu(g) * u over n elements, 16-byte vectors, a scalar tail.
template <typename T>
__device__ __forceinline__ float silu_mul1(float g, float u) {
  return round_to<T>(__fmul_rn(round_to<T>(g / (1.f + expf(-g))), u));
}

template <typename T>
__global__ void silu_mul_kernel(const T* __restrict__ g,
                                const T* __restrict__ u, T* __restrict__ o,
                                long long n) {
  constexpr int V = Vec16<T>::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = first; i < nvec; i += stride) {
    float gv[V], uv[V];
    unpack16(g + i * V, gv);
    unpack16(u + i * V, uv);
#pragma unroll
    for (int e = 0; e < V; ++e) gv[e] = silu_mul1<T>(gv[e], uv[e]);
    store16(o + i * V, gv);
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    o[i] = from_float<T>(silu_mul1<T>(to_float(g[i]), to_float(u[i])));
}

template <typename T>
int launch_rows(const RowArgs& a, int rows, cudaStream_t st) {
  const int nvec = a.N / Vec16<T>::N;
  const int vpt = nvec <= MAX_THREADS ? 1 : nvec <= 2 * MAX_THREADS ? 2 : 4;
  const int threads = ((nvec + vpt - 1) / vpt + 31) / 32 * 32;
  if (vpt == 1)
    residual_rms_norm_kernel<T, 1><<<rows, threads, 0, st>>>(a);
  else if (vpt == 2)
    residual_rms_norm_kernel<T, 2><<<rows, threads, 0, st>>>(a);
  else
    residual_rms_norm_kernel<T, 4><<<rows, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qk(const QKArgs& a, cudaStream_t st) {
  const long long warps = (long long)a.B * a.T * (a.H + a.Hkv);
  const unsigned blocks = (unsigned)((warps + QK_WARPS - 1) / QK_WARPS);
  const int half = a.D / 2;
  if (half <= 32)
    qk_norm_rope_kernel<T, 1><<<blocks, QK_WARPS * 32, 0, st>>>(a);
  else if (half <= 64)
    qk_norm_rope_kernel<T, 2><<<blocks, QK_WARPS * 32, 0, st>>>(a);
  else
    qk_norm_rope_kernel<T, 4><<<blocks, QK_WARPS * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_silu(const void* g, const void* u, void* o, long long n,
                cudaStream_t st) {
  const long long nvec = (n + Vec16<T>::N - 1) / Vec16<T>::N;
  const long long want = (nvec + 255) / 256;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  silu_mul_kernel<T><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(o),
      n);
  return (int)cudaGetLastError();
}

}  // namespace fused_norm
}  // namespace moss

// dtype: 0 fp32, 1 bf16. Rows 16-byte aligned, N a multiple of a 16-byte
// vector, at most 4 vectors a thread (ops/fused_norm.py checks all of it).
extern "C" int moss_residual_rms_norm(int dtype, int rows, int N, float eps,
                                      const void* x, long long sx,
                                      const void* y, long long sy,
                                      const void* wy, const void* w, void* xo,
                                      long long sxo, void* ho, long long sho,
                                      void* stream) {
  using namespace moss::fused_norm;
  const int V = dtype == 1 ? 8 : 4;
  if (dtype < 0 || dtype > 1 || rows < 1 || N < V || N % V ||
      N / V > 4 * MAX_THREADS || (y == nullptr && w == nullptr) ||
      (y != nullptr && xo == nullptr) || (w != nullptr && ho == nullptr))
    return (int)cudaErrorInvalidValue;
  RowArgs a{x, sx, y, sy, wy, w, xo, sxo, ho, sho, N, eps, 1.0f / N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rows<__nv_bfloat16>(a, rows, st)
                    : launch_rows<float>(a, rows, st);
}

extern "C" int moss_qk_norm_rope(int dtype, int B, int T, int H, int Hkv,
                                 int D, float eps, int rope, const void* q,
                                 const long long* sq, const void* k,
                                 const long long* sk, const void* wq,
                                 const void* wk, const float* cos,
                                 const float* sin, const long long* sc,
                                 void* qo, void* ko, void* stream) {
  using namespace moss::fused_norm;
  if (dtype < 0 || dtype > 1 || B < 1 || T < 1 || H < 1 || Hkv < 1 ||
      D < 2 || D % 2 || D > 256 || (rope && (cos == nullptr || sin == nullptr)))
    return (int)cudaErrorInvalidValue;
  QKArgs a{};
  a.src[0] = q; a.src[1] = k;
  a.sb[0] = sq[0]; a.st[0] = sq[1]; a.sh[0] = sq[2];
  a.sb[1] = sk[0]; a.st[1] = sk[1]; a.sh[1] = sk[2];
  a.w[0] = wq; a.w[1] = wk;
  a.out[0] = qo; a.out[1] = ko;
  a.cos = cos; a.sin = sin;
  a.cos_b = sc[0]; a.cos_t = sc[1]; a.sin_b = sc[2]; a.sin_t = sc[3];
  a.B = B; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D; a.rope = rope;
  a.eps = eps; a.inv_d = 1.0f / D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_qk<__nv_bfloat16>(a, st) : launch_qk<float>(a, st);
}

extern "C" int moss_silu_mul(int dtype, long long n, const void* g,
                             const void* u, void* o, void* stream) {
  using namespace moss::fused_norm;
  if (dtype < 0 || dtype > 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_silu<__nv_bfloat16>(g, u, o, n, st)
                    : launch_silu<float>(g, u, o, n, st);
}
