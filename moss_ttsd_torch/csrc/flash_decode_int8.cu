// Single-query GQA decode attention over an int8 KV cache.
//
// Replaces the TPU kernel moss_ttsd_tpu/ops/pallas_attention.py
// flash_decode_int8_hs / _decode_int8_kernel (pallas_call at :311).
//
// Contract (the TPU kernel's, and flash_decode.cu's): q (B, 1, H, D) fp32 or
// bf16; kq/vq (B, Hkv, S, D) int8 with D contiguous and 16-byte aligned
// rows; ks/vs (B, Hkv, S) fp32 per-head-per-token scales, k ~ kq * ks, with
// S contiguous; key_valid (B, S) bool; an optional per-row extent (B,) int32
// or a scalar extent: slots at or past a row's extent are never read (every
// such slot must be key_valid = false). Out (B, 1, H, D) in q's type.
// Softmax in fp32; a row with no valid key gives exactly 0.
//
// Dequantization is folded around the two products, as in the TPU kernel:
//   score = (q . kq[s]) * (ks[s] * scale),   acc += round_q(p * vs[s]) * vq[s]
// so the int8 rows are read as they are, one byte an element, and two fp32
// scales a slot ride along; p * vs is formed in fp32 and rounded to q's type
// once, where the softmax writes it ((p * vs).astype(q.dtype)); the
// denominator sums the unscaled, unrounded p.
//
// What bounds it on an H100: bytes. Each step reads every written slot of
// the layer once: 2 * (D + 4) bytes per slot and kv-head, for 4 * G * D
// flops, about 4 flops a byte at G = 2, far below the card's ~295. At
// G = 2 a tensor-core product would fill 2 of its 64 rows, so the products
// run on CUDA cores in fp32. One block per (kv-head, row) gives 8 blocks on
// 132 SMs at the long form's batch 1, each walking its whole extent tile
// after tile; so the design is decode_split.cuh's split-K kernel over an
// int8 cache: the capacity cut into chunks of 64-slot tiles
// (decode_split_plan: at the long form's S = 1557, 25 chunks of 64 slots,
// 200 blocks, of which those below the extent each load one tile by
// cp.async), the chunks' fp32 partials merged in the same launch by the
// last block of each (kv-head, row).

#include "decode_split.cuh"

// chunk, n_split, ws_acc, ws_ml and counters as moss_flash_decode's. See
// moss::decode::launch for dtype and the return code.
extern "C" int moss_flash_decode_int8(
    int dtype, const void* q, const int8_t* kq, const float* ks,
    const int8_t* vq, const float* vs, const uint8_t* valid,
    const int* extent, int extent_scalar, void* out, int B, int Hkv, int G,
    int S, int D, float scale, int chunk, int n_split, float* ws_acc,
    float* ws_ml, int* counters, long long sq_b, long long sq_h,
    long long sk_b, long long sk_h, long long sk_s, long long sks_b,
    long long sks_h, long long sv_b, long long sv_h, long long sv_s,
    long long svs_b, long long svs_h, long long sval_b, long long so_b,
    long long so_h, void* stream) {
  const moss::decode::Args a{
      q, kq, vq, ks, vs, valid, extent, extent_scalar, out, S, G, scale,
      chunk, n_split, ws_acc, ws_ml, counters, sq_b, sq_h, sk_b, sk_h, sk_s,
      sv_b, sv_h, sv_s, sks_b, sks_h, svs_b, svs_h, sval_b, so_b, so_h};
  return moss::decode::launch<true>(dtype, D, a, B, Hkv, stream);
}
