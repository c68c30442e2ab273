// Single-query GQA decode attention over the head-major KV cache.
//
// Replaces the TPU kernel moss_ttsd_tpu/ops/pallas_attention.py
// flash_decode_hs / _decode_kernel (pallas_call at :203).
//
// Contract (the same as the TPU kernel's): q (B, 1, H, D); k/v (B, Hkv, S, D)
// with D contiguous; key_valid (B, S) bool; an optional per-row extent (B,)
// int32 or a scalar extent: cache slots at or past a row's extent are never
// read (every such slot must be key_valid = false). Out (B, 1, H, D) in q's
// type. Softmax in fp32, finite for a row with no valid key (output 0). As
// in the TPU kernel (p.astype(v.dtype)), the probabilities are rounded to
// the cache's type before P.V (bf16; fp32 is exact) and the denominator sums
// them unrounded.
//
// What bounds it on an H100: bytes. Each decode step reads every written
// K/V slot of the layer once (2 * B * Hkv * extent * D elements) for
// 4 * G * D flops per slot, G flops per bf16 byte (2 on the main path), far
// below the card's ~295 flop/byte ridge. At the main path's B 2 x Hkv 8 one
// block per (kv-head, row) would leave 116 of 132 SMs idle, so the design is
// split-K (flash-decoding), decode_split.cuh's kernel over a cache of q's
// type: the capacity S is cut into n_split chunks of 64-slot tiles so that
// B x Hkv x n_split blocks fill the card (main path, S = 633: 10 chunks of
// 64, 160 blocks); a chunk past its row's extent exits at once; the last
// block of each (kv-head, row) merges the chunks' fp32 partials in the same
// launch.

#include "decode_split.cuh"

// chunk (a multiple of 64) and n_split (n_split * chunk >= S) come from
// decode_split_plan; for n_split > 1, ws_acc holds B * Hkv * n_split * G * D
// floats, ws_ml B * Hkv * n_split * G * 2, and counters B * Hkv ints that
// are 0 between launches. See moss::decode::launch for dtype and the
// return code.
extern "C" int moss_flash_decode(
    int dtype, const void* q, const void* k, const void* v,
    const uint8_t* valid, const int* extent, int extent_scalar, void* out,
    int B, int Hkv, int G, int S, int D, float scale, int chunk, int n_split,
    float* ws_acc, float* ws_ml, int* counters, long long sq_b,
    long long sq_h, long long sk_b, long long sk_h, long long sk_s,
    long long sv_b, long long sv_h, long long sv_s, long long sval_b,
    long long so_b, long long so_h, void* stream) {
  const moss::decode::Args a{
      q, k, v, nullptr, nullptr, valid, extent, extent_scalar, out, S, G,
      scale, chunk, n_split, ws_acc, ws_ml, counters, sq_b, sq_h, sk_b, sk_h,
      sk_s, sv_b, sv_h, sv_s, 0, 0, 0, 0, sval_b, so_b, so_h};
  return moss::decode::launch<false>(dtype, D, a, B, Hkv, stream);
}
