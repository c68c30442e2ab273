#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (moss_ttsd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line:
  1. device   — the card (nvidia-smi name + power limit), torch / CUDA versions;
  2. build    — nvcc builds of the kernels from csrc/ (seconds, ptxas report);
  3. kernels vs plain — every kernel against its plain PyTorch version on
     the same inputs: the main path's and the long-form run's shapes, the
     edge cases (left padding, fully masked rows, ragged T and S, per-row
     extents, extent 1, layer views, G 2 and 4), the voice-cloning run's
     prefill (T 512, left pads 54 / 79 / 140) and decode (batch 3,
     capacity 761: chunks of two tiles, first, mid-run and last extents),
     the bf16 prefill's
     tensor-core tile edges, the bf16 rounding of P in the prefill and of
     P (p * vs over the int8 cache) in both decodes (held to the bf16-P
     plain version at a tolerance the fp32-P one misses), both split-K
     decodes' chunk boundaries (every decode case also against the plain
     split arithmetic at the kernel's own plan), batch 8 and the --tiny
     shapes (fp32, head_dim 16); which prefill kernel each dtype launches
     (the library's launch counts); quantize_kv on the card vs the CPU;
     reference — small fp32 models on the card vs the same on the CPU (LM
     hidden states, greedy tokens of the bf16 and int8 engines, codec wav,
     codec encode latents and codes);
  4. main path — TTSPipeline.process_batch at the full MOSS-TTSD-v0.5 width
     (LMConfig(), CodecConfig(), random weights from a seeded generator,
     bf16 LM and codec) over examples/examples_only_text.jsonl with
     max_new_tokens=256; launch counts must be 28 x prefills and 28 x steps;
  5. logits   — fp32-output vs bf16-rounded tied-head logits (time, error);
  6. clone    — voice cloning at the same width: TTSPipeline.process_batch
     over the two voice items of examples/ (a two-speaker prompt, a
     single-reference one) and a third whose prompt is a stereo 24 kHz
     (wav, sr) tuple, so the native resampler runs; one batched codec
     encode, prefill and decode launch counts, the native audio library
     built and used, and a repeated single-voice batch served from the
     prompt-encode LRU (its batch-1 codes against the voice's row of the
     batched encode);
  7. int8     — int8 serving at the same width, the weights quantized inside
     the engine: TTSPipeline(quant="int8"); the same with the restricted text
     head and its audit; the long-form engine (quant and kv_quant "int8",
     batch 1, 800 decode steps in a 1500-step cache) whose every decode
     step runs flash_decode_int8_hs;
  8. stream   — TTSPipeline.stream_item over item 0 of
     examples_only_text.jsonl at the main path's width (batch 1, 256 steps,
     chunks of 25 steps after a first one of 12): time to first audio,
     chunks, launch counts, host syncs per step; the streamed tokens equal
     engine.generate's on the same row and seed, the samples equal
     frames x 1920, every chunk finite;
  9. overlap  — process_batch over the two items at 400 steps (393
     decodable frames, more than one 375-code codec window) with
     overlap_vocode off and on: the overlap branch ran (two segments, the
     first ending at step 382), identical tokens, byte-identical wavs, the
     same vocode calls;
 9b. podcast  — the podcast generator over the same pipeline: a short
     English .txt through podcast.process_input_to_audio (the detected
     language, the offline fallback script, both default voices cloned in
     one encode, 256 steps at batch 1): 28 B1 + 28 x steps B2 launches, a
     finite 24 kHz wav of frames x 1920 samples, e2e s, tokenize_s,
     prefill ms, steps/s, RTF, peak GiB beside the serving_memory
     estimate (each of main path, int8 long form and pool lines carries
     its own estimate_gib too); the gradio callbacks synthesize_single,
     synthesize_role and synthesize_single_stream at 256 steps (int16
     audio at 24 kHz, the English status strings, more than one finite
     streamed chunk whose samples are frames x 1920, the stream's time to
     first audio); create_gradio_interface raises an ImportError naming
     gradio where gradio is absent, and builds the Blocks where it is not;
 10. server   — the window-scheduler SpeechServer over the same pipeline on
     127.0.0.1: /health, three concurrent wav requests in one batch, a
     voice-cloning request (a base64 reference wav), a streamed request
     (PCM16), the port's API client, /v1/metrics; a lone request equals
     process_batch within one int16 step;
     Then the continuous scheduler over the same pipeline (8 slots, base
     512, max_steps 128, int8 KV by the auto rule, a LoRA voice): five
     wav requests 0.3 s apart, two streams decoding in the pool at once, a
     voiced request, an over-budget request routed to the overflow
     worker; /v1/models lists the voice; latency p50/p95, TTFA p50,
     joins, segments, routed overflow and the launches of B1, B2, B3;
 10b. pool    — the continuous slot pool at the server's default geometry
     (8 slots, base 512, max_steps 2048: a 2560-slot cache), two random
     rank-16 LoRA adapters on all seven projections: eight greedy requests
     in one burst (budgets 64-256, three base, five voiced) give the
     static engine's tokens at the same batch exactly, with the int8 KV
     cache (B3) and with the bf16 cache (B2); fp32 weights and cache,
     requests joining at three segment boundaries, greedy and sampled,
     each row equal to its isolated batch-1 generate (a flip prints the
     row, the step and the logit gap); the throughput line (pool steps/s,
     frames/s at B 8, launches and host syncs a step, the per-row draws,
     peak memory, admission prefill ms per burst size);
 11. train    — LM finetuning at the full width (LMConfig(): fp32 master
     weights, bf16 compute, remat, ce_chunks 8; random weights from seed
     0): one batch of two synthetic examples laid out as
     build_training_example lays them out (the text rows masked, the
     audio rows and the EOS supervised), delay-shifted and collated to T
     2048, run as B 2 with gradient accumulation 2; 6 full-finetune steps
     and 6 layerwise LoRA steps (rank 16, alpha 32, rslora, the seven
     projections) at a constant 1e-4: finite and falling losses, the LoRA
     run's base bitwise unchanged and lora_b non-zero after step 2, s/step,
     tokens/s, 6 N tokens / step time / 989e12, peak memory; the trained
     factors saved in the JAX layout, loaded through LoraRegistry into the
     main-path pipeline (a bf16 copy of the same base) and served to item 0
     of examples_only_text.jsonl for 64 steps (finite wavs, 28 B1 launches
     a prefill, 28 B2 launches a step); a tiny fp32 model's 3 full and 3
     LoRA steps on the card against the CPU;
 11b. codec_train — codec training at the full XY-Tokenizer width
     (CodecConfig(), 524 M fp32 parameters, TF32 off): a reference-format
     .ckpt of random weights loaded through convert_codec +
     codec_state_from_jax; one batch of 2 x 10 s (examples/*.wav tiled,
     row 1 padded past 7.5 s); a k-means bootstrap and 6 steps (AdamW 1e-4,
     cosine over 100 steps), one more profiled (launches, idle share) and
     one FLOP-counted: losses, grad norms, s/step,
     codec_train_audio_sec_per_s, the fp32 peak share, peak memory; finite
     losses, grad_norm > 0, codebook_usage > 0, the codebook and the
     semantic encoder moved, no serving kernel launched; the trained codec
     written as the JAX npz tree, loaded by load_from_checkpoint (codes =
     the in-memory module's) and the codec round-trip CLI; the tiny codec's
     bootstrap and 2 steps, every draw pinned, on the card against the CPU;
 10c. load    — real checkpoints through every loader, from files the phase
     writes at the full width: the main path's LM as an HF-format
     directory (bf16 safetensors over two shards by
     save_asteroid_checkpoint, configs/lm_moss_ttsd_v0.5.json as its
     config.json with the main path's whole-vocab speech range, a greedy
     generation_config.json) and a reference-format
     codec .ckpt + yaml of random weights (configs/xy_codec_defaults.json's
     geometry, weight norms unfolded); TTSPipeline.load (MockTokenizer put
     in through load_tokenizer) gives the in-memory pipeline's greedy
     tokens at B 2 over examples_only_text.jsonl (128 steps), in bf16 and
     int8, and an int8-KV engine on the loaded int8 weights the in-memory
     one's (B1, B2, B3 launches counted); the loaded fp32 codec's codes on
     the card equal the CPU's, its bf16 decode within 3 % relative RMS of
     fp32; the inference and codec round-trip CLIs with the
     real-checkpoint flags write their wavs; write and load seconds, the
     host peak RSS the streamed loader adds (a fresh process; fails above
     the largest tensor + 0.5 GiB), the card's peak, RTF and steps/s;
 12. cli      — the --tiny CLIs on the card write wavs, six processes at
     once: inference plain, with --profile_dir (a torch.profiler trace),
     with --quant int8
     --restricted_text_head, and cloning the voices of
     examples/examples.jsonl; the codec round trip over examples/; the
     podcast generator over a .txt (its JSON line has JAX's keys); the
     finetune workflow over the examples' voices (the port's codec encodes
     them), full finetuning checkpointed and resumed, LoRA finetuning;
then the ``kernels`` line (times, bounds, launches; flash_prefill and
flash_decode_hs also at the clone run's shapes; with ``--phases ...,sweep``
also both decodes at other splits, ``split_sweep_ms``, and flash_decode_hs
so at (8, 633), longer caches at B 1, 3 and 8 and the stream's capacity,
``shape_sweep``; with the pool phase each kernel also at the pool's
shapes, ``pool``: flash_prefill at (8, 512) and (1, 512), both decodes at
(8, 2560) at the extents the pool reached and at the full extent) and,
last, the result line {"ok": true, "device": {...}}. Any failing phase
exits non-zero with no result line. Without a CUDA device it exits 1 at
once.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "examples")
JSONL = os.path.join(EXAMPLES, "examples_only_text.jsonl")
CLONE_JSONLS = ("examples.jsonl", "examples_single_reference.jsonl")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor cores
TOL = {"bfloat16": 1e-2, "float32": 2e-5}
REL = {"bfloat16": 2.0 ** -8, "float32": 0.0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Device time of one ``fn(i)``: calls i = 0 .. iters-1 captured into a
    CUDA graph, one replay timed with CUDA events. The graph takes the
    host's launch overhead (Python wrapper, ctypes) out of the measurement,
    which for a ~30 us kernel would otherwise be most of it. ``fn`` picks
    its inputs by ``i``; callers rotate over enough input sets that the
    replay reads them from HBM, not from the 50 MB L2."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm: build, caps, allocator
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def compare(out, ref) -> dict:
    """Kernel output vs the plain version's fp32 result from the same
    inputs: |out - ref| <= TOL + REL * |ref|, where REL covers the one
    rounding of a bf16 output (half an ulp, 2^-8 relative) and TOL the
    fp32 accumulation order."""
    import torch
    dn = str(out.dtype).replace("torch.", "")
    diff = (out.float() - ref).abs()
    excess = float((diff - REL[dn] * ref.abs()).max())
    finite = bool(torch.isfinite(out).all())
    return {"dtype": dn, "max_abs_err": float(diff.max()),
            "tolerance": f"{TOL[dn]:g} + {REL[dn]:g}*|ref|",
            "finite": finite, "ok": finite and excess <= TOL[dn]}


def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _left_pad_valid(B, T, pads):
    import torch
    valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        valid[b, :p] = False
    return valid


def prefill_case(gen, name, B, T, H, Hkv, D, dtype, pads):
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    q = _rand(gen, (B, T, H, D), dtype)
    k = _rand(gen, (B, T, Hkv, D), dtype)
    v = _rand(gen, (B, T, Hkv, D), dtype)
    valid = _left_pad_valid(B, T, pads)
    out = fa.flash_prefill(q, k, v, valid, D ** -0.5)
    torch.cuda.synchronize()
    ref = fa.flash_prefill_plain(q, k, v, valid, D ** -0.5,
                                 out_dtype=torch.float32)
    return {"kernel": "flash_prefill", "case": name,
            "shape": [B, T, H, Hkv, D], "left_pad": list(pads),
            **compare(out, ref)}


def _decode_check(name, kernel, inputs, valid, extent, layer, shape):
    """One decode kernel (``kernel`` = "flash_decode_hs" or
    "flash_decode_int8_hs", ``inputs`` its q and cache tensors) against its
    plain version and against the plain split-K arithmetic at the kernel's
    own (n_split, chunk) plan, both with P rounded to q's type as the
    kernel rounds it: the two references agree to fp32 rounding, so the
    kernel is held to both."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    B, S, H, Hkv, D = shape
    q = inputs[0]
    ext = extent
    if isinstance(extent, list):
        ext = torch.tensor(extent, dtype=torch.int32, device="cuda")
    args = (*inputs, valid, D ** -0.5)
    out = getattr(fa, kernel)(*args, extent=ext, layer=layer)
    torch.cuda.synchronize()
    kw = dict(extent=ext, layer=layer, out_dtype=torch.float32,
              p_dtype=q.dtype)
    ref = getattr(fa, kernel + "_plain")(*args, **kw)
    n_split, chunk = fa.decode_split_plan(B, Hkv, S, fa.sm_count(q.device))
    split = getattr(fa, kernel + "_split_plain")(
        *args, n_split=n_split, chunk=chunk, **kw)
    vs_split = compare(out, split)
    res = compare(out, ref)
    return {"kernel": kernel, "case": name, "shape": list(shape),
            "extent": extent, "layer": layer, "n_split": n_split,
            "chunk": chunk, "blocks": B * Hkv * n_split,
            **res, "split_plain_max_abs_err": vs_split["max_abs_err"],
            "ok": res["ok"] and vs_split["ok"]}


def _valid_spans(B, S, valid_spans):
    import torch
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, (lo, hi) in enumerate(valid_spans):
        valid[b, lo:hi] = True
    return valid


def decode_case(gen, name, B, S, H, Hkv, D, dtype, valid_spans, extent,
                layers=None, layer=None):
    """flash_decode_hs on random inputs (``_decode_check``)."""
    q = _rand(gen, (B, 1, H, D), dtype)
    shape = (B, Hkv, S, D) if layers is None else (layers, B, Hkv, S, D)
    kt = _rand(gen, shape, dtype)
    vt = _rand(gen, shape, dtype)
    return _decode_check(name, "flash_decode_hs", (q, kt, vt),
                         _valid_spans(B, S, valid_spans), extent, layer,
                         (B, S, H, Hkv, D))


def _int8_kv(gen, shape):
    import torch
    from moss_ttsd_torch.ops.quantize import quantize_kv
    return quantize_kv(_rand(gen, shape, torch.float32))


def int8_decode_case(gen, name, B, S, H, Hkv, D, dtype, valid_spans, extent,
                     layers=None, layer=None):
    """flash_decode_int8_hs on a random cache quantized by quantize_kv
    (``_decode_check``)."""
    q = _rand(gen, (B, 1, H, D), dtype)
    shape = (B, Hkv, S, D) if layers is None else (layers, B, Hkv, S, D)
    kq, ks = _int8_kv(gen, shape)
    vq, vs = _int8_kv(gen, shape)
    return _decode_check(name, "flash_decode_int8_hs", (q, kq, ks, vq, vs),
                         _valid_spans(B, S, valid_spans), extent, layer,
                         (B, S, H, Hkv, D))


def quantize_kv_check(gen):
    """quantize_kv (plain torch ops, the cache write of kv_quant="int8") on
    the card gives the CPU's int8 bytes and scales."""
    import torch
    from moss_ttsd_torch.ops.quantize import quantize_kv
    x = _rand(gen, (2, 8, 57, 128), torch.float32) * 3
    x[1, 2, 5] = 0.0                                  # an all-zero row
    ok = True
    for xx in (x, x.to(torch.bfloat16)):
        qg, sg = quantize_kv(xx)
        qc, sc = quantize_kv(xx.cpu())
        ok &= torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    return {"kernel": "quantize_kv", "case": "card_vs_cpu_bytes",
            "shape": list(x.shape), "dtype": "float32,bfloat16",
            "max_abs_err": 0.0 if ok else None, "tolerance": "bytes equal",
            "finite": True, "ok": bool(ok)}


def _p_rounding_inputs(gen, B, T, H, Hkv, D):
    """bf16 q, k, v (for scale 1) on which rounding P to bf16 before P.V
    decides the output: every score of a row is the row's max (even keys)
    or 2^-10 below it (odd keys), so e^(s - m) is 1 or e^(-2^-10), which
    bf16 rounds to 1; v is +c on even keys and -c on odd keys, |c| in
    [32, 64), a multiple of 1/2 (so 2c fits an int8). An odd row (as many
    odd keys as even) then comes out exactly 0 with bf16 P and
    c (1 - e^(-2^-10)) / (1 + e^(-2^-10)) ~ c 2^-11, at least 0.0156, with
    fp32 P."""
    import torch
    bf = torch.bfloat16
    q = torch.zeros((B, T, H, D), device="cuda")
    q[..., 0], q[..., 1] = 1.0, 2.0 ** -10
    k = torch.zeros((B, T, Hkv, D), device="cuda")
    k[..., 0] = 1.0
    k[:, 1::2, :, 1] = -1.0
    c = torch.randint(64, 128, (B, 1, Hkv, D), generator=gen,
                      device="cuda") / 2
    c = c * (2 * torch.randint(0, 2, c.shape, generator=gen, device="cuda")
             - 1)
    sign = 1 - 2 * (torch.arange(T, device="cuda") % 2)
    return q.to(bf), k.to(bf), c.to(bf) * sign[None, :, None, None].to(bf)


P_TOL = 1e-3     # the bf16-P check: far below the fp32-P gap of >= 0.0156


def prefill_p_rounding_case(gen, name, B, T, H, Hkv, D):
    """The bf16 kernel rounds P to bf16 before P.V, as the TPU kernel's
    ``p.astype(v.dtype)`` does: on ``_p_rounding_inputs`` it is held to
    the bf16-P plain version at P_TOL + 2^-8 |ref|, which the fp32-P plain
    version must miss (both readings are reported)."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    q, k, v = _p_rounding_inputs(gen, B, T, H, Hkv, D)
    valid = _left_pad_valid(B, T, ())
    out = fa.flash_prefill(q, k, v, valid, 1.0)
    torch.cuda.synchronize()
    refs = {p_name: fa.flash_prefill_plain(q, k, v, valid, 1.0,
                                           out_dtype=torch.float32,
                                           p_dtype=p_dtype)
            for p_name, p_dtype in (("bf16_p", torch.bfloat16),
                                    ("fp32_p", None))}
    return {"kernel": "flash_prefill", "case": name,
            "shape": [B, T, H, Hkv, D], **_p_rounding_verdict(out, refs)}


def _p_rounding_verdict(out, refs):
    """out held to refs["bf16_p"] at P_TOL + 2^-8 |ref|, which
    refs["fp32_p"] must miss."""
    import torch
    excess = {p_name: float(((out.float() - ref).abs()
                             - REL["bfloat16"] * ref.abs()).max())
              for p_name, ref in refs.items()}
    finite = bool(torch.isfinite(out).all())
    return {"dtype": "bfloat16",
            "max_abs_err": float((out.float() - refs["bf16_p"]).abs().max()),
            "tolerance": f"{P_TOL:g} + 2^-8*|ref| vs the bf16-P plain; "
                         "the fp32-P plain must exceed it",
            "excess_over_rel": excess, "finite": finite,
            "ok": (finite and excess["bf16_p"] <= P_TOL
                   and excess["fp32_p"] > P_TOL)}


def decode_p_rounding_case(gen, name, kernel, B, S, H, Hkv, D, extent):
    """B2 rounds P, and B3 p * vs, to bf16 before P.V, as the TPU kernels
    do: ``_p_rounding_inputs`` at decode shapes (as a bf16 cache for
    flash_decode_hs; for flash_decode_int8_hs as an int8 one with kq = k,
    ks = 1, vq = 2v, vs = 1/2, powers of two that blur nothing), an even
    extent and an even left pad, so every row has as many valid even keys
    as odd and comes out 0 with bf16 P; held to the bf16-P plain version at
    P_TOL + 2^-8 |ref|, which the fp32-P plain version must miss."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    q, k, v = _p_rounding_inputs(gen, B, S, H, Hkv, D)
    q = q[:, :1].contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    if kernel == "flash_decode_int8_hs":
        ones = torch.ones((B, Hkv, S), device="cuda")
        inputs = (q, kt.to(torch.int8), ones, (2 * vt).to(torch.int8),
                  ones / 2)
    else:
        inputs = (q, kt, vt)
    valid = _valid_spans(B, S, [(2 * (b % 2), extent) for b in range(B)])
    out = getattr(fa, kernel)(*inputs, valid, 1.0, extent=extent)
    torch.cuda.synchronize()
    refs = {p_name: getattr(fa, kernel + "_plain")(
                *inputs, valid, 1.0, extent=extent, out_dtype=torch.float32,
                p_dtype=p_dtype)
            for p_name, p_dtype in (("bf16_p", torch.bfloat16),
                                    ("fp32_p", None))}
    return {"kernel": kernel, "case": name, "shape": [B, S, H, Hkv, D],
            "extent": extent, **_p_rounding_verdict(out, refs)}


def prefill_dispatch_check(gen):
    """Which prefill kernel each dtype launches, from the library's own
    per-kernel launch counts around one bf16 and one fp32 call: bf16 must
    add one prefill_wgmma_kernel launch and no SIMT one, fp32 the
    reverse."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    added = {}
    for dt in (torch.bfloat16, torch.float32):
        q = _rand(gen, (2, 130, 16, 128), dt)
        kv = _rand(gen, (2, 130, 8, 128), dt)
        valid = _left_pad_valid(2, 130, (0, 7))
        before = fa.prefill_kernel_launches()
        fa.flash_prefill(q, kv, kv, valid, 128 ** -0.5)
        after = fa.prefill_kernel_launches()
        added[str(dt).replace("torch.", "")] = {k: after[k] - before[k]
                                                 for k in after}
    ok = added == {"bfloat16": {"simt": 0, "wgmma": 1},
                   "float32": {"simt": 1, "wgmma": 0}}
    return {"kernel": "flash_prefill", "case": "dispatch_by_dtype",
            "launches_added": added, "dtype": "bfloat16,float32",
            "max_abs_err": 0.0, "tolerance": "kernel launch counts",
            "finite": True, "ok": ok}


def kernel_checks():
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # chunk boundaries of the split decode at the shapes below
    sms = fa.sm_count(torch.device("cuda"))
    _, ch4k = fa.decode_split_plan(2, 8, 4096, sms)
    _, ch633 = fa.decode_split_plan(2, 8, 633, sms)
    _, ch1557 = fa.decode_split_plan(1, 8, 1557, sms)
    cases = [
        # the main path's own shapes: bf16, 16/8 heads, D=128, T = base 377,
        # the two example items left-padded by 92 and 177 slots
        prefill_case(gen, "main", 2, 377, 16, 8, 128, bf, (92, 177)),
        prefill_case(gen, "main_fp32", 2, 377, 16, 8, 128, f32, (92, 177)),
        # the voice-cloning run: the bucketed prompt of 512 rows (eight
        # 64-row tiles) with the two voice items left-padded by 54 and 79
        # slots, and the run's own prefill: batch 3, T = base 505 (the
        # bucket less C - 1), the third item's 140 pads (two whole tiles)
        prefill_case(gen, "clone", 2, 512, 16, 8, 128, bf, (54, 79)),
        prefill_case(gen, "clone_fp32", 2, 512, 16, 8, 128, f32, (54, 79)),
        prefill_case(gen, "clone_B3_T505", 3, 505, 16, 8, 128, bf,
                     (54, 79, 140)),
        # ragged T (never a tile multiple), left padding, fully masked rows
        prefill_case(gen, "T1", 2, 1, 16, 8, 128, bf, (0, 1)),
        prefill_case(gen, "T7", 2, 7, 16, 8, 128, bf, (0, 3)),
        prefill_case(gen, "T121", 3, 121, 16, 8, 128, bf, (0, 40, 121)),
        prefill_case(gen, "D64", 2, 70, 8, 2, 64, f32, (5, 0)),
        prefill_case(gen, "D32", 2, 33, 4, 4, 32, f32, (0, 2)),
        # --tiny shapes: fp32, 4/2 heads, D=16
        prefill_case(gen, "tiny", 2, 57, 4, 2, 16, f32, (0, 9)),
        # the tensor-core kernel's tile edges (64-row tiles), left pads, a
        # fully padded row, D 64 with G 4, batch 8 at the main path's T
        prefill_case(gen, "bf16_T63", 2, 63, 16, 8, 128, bf, (5, 0)),
        prefill_case(gen, "bf16_T64", 2, 64, 16, 8, 128, bf, (0, 64)),
        prefill_case(gen, "bf16_T65", 2, 65, 16, 8, 128, bf, (64, 1)),
        prefill_case(gen, "bf16_T128", 2, 128, 16, 8, 128, bf, (3, 100)),
        prefill_case(gen, "bf16_T1024", 2, 1024, 16, 8, 128, bf, (0, 333)),
        prefill_case(gen, "bf16_D64_G4", 2, 200, 16, 4, 64, bf, (17, 0)),
        prefill_case(gen, "bf16_B8_T377", 8, 377, 16, 8, 128, bf,
                     (92, 177, 0, 1, 63, 64, 65, 376)),
        # P rounded to bf16 before P.V, as the TPU kernel does
        prefill_p_rounding_case(gen, "bf16_p_rounding", 2, 377, 16, 8, 128),
        prefill_p_rounding_case(gen, "bf16_p_rounding_D64_G4", 2, 130, 16, 4,
                                64),
        prefill_dispatch_check(gen),
        decode_case(gen, "main", 2, 633, 16, 8, 128, bf,
                    [(92, 505), (177, 505)], 505),
        decode_case(gen, "main_fp32", 2, 633, 16, 8, 128, f32,
                    [(92, 505), (177, 505)], 505),
        decode_case(gen, "per_row_extent", 2, 633, 16, 8, 128, bf,
                    [(0, 1), (61, 633)], [1, 633]),
        decode_case(gen, "extent1", 2, 100, 16, 8, 128, bf,
                    [(0, 1), (0, 1)], 1),
        decode_case(gen, "no_extent_ragged_S", 3, 70, 16, 8, 128, bf,
                    [(0, 70), (5, 69), (64, 65)], None),
        decode_case(gen, "fully_masked_row", 2, 90, 16, 8, 128, bf,
                    [(0, 0), (3, 50)], 50),
        decode_case(gen, "layer_view", 2, 97, 16, 8, 128, bf,
                    [(0, 60), (7, 60)], 60, layers=3, layer=2),
        decode_case(gen, "tiny", 2, 89, 4, 2, 16, f32,
                    [(0, 70), (9, 70)], 70),
        decode_case(gen, "D64_G4", 2, 130, 16, 4, 64, f32,
                    [(0, 129), (1, 129)], [129, 129]),
        # the split-K boundaries: a long cache, extents exactly at chunk
        # boundaries, a whole in-extent chunk with no valid key (row 1's
        # keys start two chunks in), batch 8, a layer view of the 28-layer
        # stack, fp32
        decode_case(gen, "split_S4096_ext4000", 2, 4096, 16, 8, 128, bf,
                    [(0, 4000), (2000, 4000)], 4000),
        decode_case(gen, "split_ext_at_chunk", 2, 4096, 16, 8, 128, bf,
                    [(0, ch4k), (5, 3 * ch4k)], [ch4k, 3 * ch4k]),
        decode_case(gen, "split_ext_at_chunk_633", 2, 633, 16, 8, 128, bf,
                    [(0, 2 * ch633), (1, 7 * ch633)],
                    [2 * ch633, 7 * ch633]),
        decode_case(gen, "split_empty_chunk", 2, 633, 16, 8, 128, bf,
                    [(0, 505), (2 * ch633 + 3, 505)], 505),
        decode_case(gen, "split_B8", 8, 633, 16, 8, 128, bf,
                    [(92, 505), (177, 505), (0, 505), (0, 1), (63, 64),
                     (64, 65), (300, 505), (0, 0)], 505),
        decode_case(gen, "split_layer27", 2, 633, 16, 8, 128, bf,
                    [(92, 505), (177, 400)], [505, 400], layers=28,
                    layer=27),
        decode_case(gen, "split_fp32_S4096", 2, 4096, 16, 8, 128, f32,
                    [(0, 3001), (1000, 3001)], 3001),
        # the voice-cloning run: batch 3, capacity 761 (base 505 + 256
        # steps; 6 chunks of two tiles), the three items left-padded by
        # 54, 79 and 140 slots, layer views of the 28-layer stack; the
        # first decode step's extent, the mid-run one, the last step's,
        # and per-row extents
        decode_case(gen, "clone", 3, 761, 16, 8, 128, bf,
                    [(54, 633), (79, 633), (140, 633)], 633, layers=28,
                    layer=27),
        decode_case(gen, "clone_first_step", 3, 761, 16, 8, 128, bf,
                    [(54, 506), (79, 506), (140, 506)], 506, layers=28,
                    layer=0),
        decode_case(gen, "clone_last_step", 3, 761, 16, 8, 128, bf,
                    [(54, 761), (79, 761), (140, 761)], 761),
        decode_case(gen, "clone_per_row_extent", 3, 761, 16, 8, 128, bf,
                    [(54, 633), (79, 700), (140, 761)], [633, 700, 761]),
        # the stream (batch 1, item 0 alone: base 377, 92 left pads,
        # capacity 633) and a long batch-1 cache (capacity 4096), a layer
        # view of the 28-layer stack at the stream's last step
        decode_case(gen, "stream_B1", 1, 633, 16, 8, 128, bf, [(92, 505)],
                    505, layers=28, layer=27),
        decode_case(gen, "stream_B1_last_step", 1, 633, 16, 8, 128, bf,
                    [(92, 633)], 633),
        decode_case(gen, "split_B1_S4096", 1, 4096, 16, 8, 128, bf,
                    [(0, 4000)], 4000),
        # P rounded to bf16 before P.V, as the TPU kernel does
        decode_p_rounding_case(gen, "bf16_p_rounding", "flash_decode_hs", 2,
                               633, 16, 8, 128, 506),
        # int8 cache: the long-form run's shapes (B 1, S 1557 = base 57 +
        # 1500 steps, mid-run extent 807, a layer view of the 28-layer
        # stack), then the edge cases and the --tiny shapes
        int8_decode_case(gen, "longform", 1, 1557, 16, 8, 128, bf,
                         [(0, 807)], 807, layers=28, layer=27),
        int8_decode_case(gen, "per_row_extent_B2", 2, 633, 16, 8, 128, bf,
                         [(92, 505), (177, 300)], [505, 300]),
        int8_decode_case(gen, "extent1", 2, 100, 16, 8, 128, bf,
                         [(0, 1), (0, 1)], 1),
        int8_decode_case(gen, "fully_masked_row", 2, 90, 16, 8, 128, bf,
                         [(0, 0), (3, 50)], 50),
        int8_decode_case(gen, "G2_fp32", 2, 333, 16, 8, 128, f32,
                         [(0, 200), (30, 150)], 200),
        int8_decode_case(gen, "G4", 2, 130, 16, 4, 128, bf,
                         [(0, 129), (1, 129)], [129, 129]),
        int8_decode_case(gen, "tiny", 2, 89, 4, 2, 16, f32,
                         [(0, 70), (9, 70)], 70),
        # the split-K boundaries over the int8 cache, as B2's above: a long
        # cache, extents exactly at chunk boundaries, a whole in-extent
        # chunk with no valid key, batch 8, the first long-form step (extent
        # 58, layer 0 of the 28-layer stack), fp32, head_dim 16 (a row is
        # one lane) and 64
        int8_decode_case(gen, "split_S4096_ext4000", 2, 4096, 16, 8, 128, bf,
                         [(0, 4000), (2000, 4000)], 4000),
        int8_decode_case(gen, "split_ext_at_chunk", 2, 4096, 16, 8, 128, bf,
                         [(0, ch4k), (5, 3 * ch4k)], [ch4k, 3 * ch4k]),
        int8_decode_case(gen, "split_ext_at_chunk_1557", 1, 1557, 16, 8, 128,
                         bf, [(0, 7 * ch1557)], 7 * ch1557),
        int8_decode_case(gen, "split_empty_chunk", 2, 633, 16, 8, 128, bf,
                         [(0, 505), (2 * ch633 + 3, 505)], 505),
        int8_decode_case(gen, "split_B8", 8, 633, 16, 8, 128, bf,
                         [(92, 505), (177, 505), (0, 505), (0, 1), (63, 64),
                          (64, 65), (300, 505), (0, 0)], 505),
        int8_decode_case(gen, "split_longform_first_step", 1, 1557, 16, 8,
                         128, bf, [(0, 58)], 58, layers=28, layer=0),
        int8_decode_case(gen, "split_B1_S4096", 1, 4096, 16, 8, 128, bf,
                         [(0, 4000)], 4000),
        int8_decode_case(gen, "split_fp32_S4096", 2, 4096, 16, 8, 128, f32,
                         [(0, 3001), (1000, 3001)], 3001),
        int8_decode_case(gen, "split_D64_G4", 2, 700, 16, 4, 64, bf,
                         [(0, 650), (13, 650)], 650),
        int8_decode_case(gen, "split_tiny_S300", 2, 300, 4, 2, 16, f32,
                         [(0, 250), (70, 250)], [250, 250]),
        # p * vs rounded to bf16 before P.V, as the TPU kernel does
        decode_p_rounding_case(gen, "bf16_p_rounding", "flash_decode_int8_hs",
                               1, 1557, 16, 8, 128, 808),
        quantize_kv_check(gen),
    ]
    for c in cases:
        emit({"phase": "kernel_check", **c})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel checks failed: {bad}")
    return {c["kernel"] + ":" + c["case"]: c for c in cases}


# ---------------------------------------------------------------------------
# phase 4: the full-width main path
# ---------------------------------------------------------------------------

def full_width_parts(max_new_tokens: int = 256):
    """The main path's parts at the full width: LMConfig() with the whole
    vocab counted as speech (random weights never trigger the EOS flush, so
    the decode runs its whole budget, as bench.py does), random bf16 LM and
    codec from seed 0, the sampled config."""
    import torch
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             CodecConfig, LMConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.models.lm import AsteroidLM

    cfg = LMConfig()
    cfg = LMConfig.from_dict({**cfg.to_dict(),
                              "speech_token_range": [0, cfg.vocab_size],
                              "param_dtype": "bfloat16"})
    model = AsteroidLM.init_random(cfg, seed=0, device="cuda",
                                   dtype=torch.bfloat16)
    spt = XYTokenizer.init_random(CodecConfig(), seed=0, dtype="bfloat16",
                                  device="cuda")
    sampling = SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=True, temperature=0.9,
                                        top_k=50, top_p=0.95)
                  for _ in range(cfg.channels)],
        max_new_tokens=max_new_tokens)
    return cfg, model, spt, sampling


def build_full_pipeline():
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    cfg, model, spt, sampling = full_width_parts()
    return TTSPipeline(MockTokenizer(), cfg, model, spt, sampling,
                       bucket=128, device="cuda"), cfg


def load_items():
    with open(JSONL) as f:
        return [json.loads(line) for line in f if line.strip()]


def timed_batch(pipe, items, max_new_tokens: int = 256):
    """Warm-up (handles, autotuning, allocator), then one counted run of
    process_batch: launch counts and peak memory cover that run only.
    Returns (texts, audio, e2e seconds, launch counts, peak bytes, the
    engine's stats of the run)."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    pipe.process_batch(items, max_new_tokens=16, seed=1)
    torch.cuda.synchronize()
    pipe.timings.__init__()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    texts, audio = pipe.process_batch(items, max_new_tokens=max_new_tokens,
                                      seed=0)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    return (texts, audio, e2e_s, fa.launch_counts(),
            torch.cuda.max_memory_allocated(), dict(pipe.engine.last_stats))


def audio_problems(texts, audio, steps: int, channels: int):
    """Every item gave finite audio whose length fits the steps run.
    Returns (problems, wav lengths, seconds of audio)."""
    import numpy as np
    problems, wav_lens, audio_s = [], [], 0.0
    if any("error" in t for t in texts):
        problems.append(f"item errors: {texts}")
    for res in audio:
        if res is None:
            problems.append("an item produced no audio")
            continue
        w = res["audio_data"]
        n = w.shape[-1]
        wav_lens.append(n)
        audio_s += n / res["sample_rate"]
        if not np.isfinite(w).all():
            problems.append("non-finite audio")
        if n == 0 or n % 1920 or n > (steps - (channels - 1)) * 1920:
            problems.append(f"wav length {n} for {steps} steps")
    return problems, wav_lens, audio_s


def engine_state(eng, ids, mask, buf_steps: int):
    """A prefilled decode state of ``eng`` on a (B, L, C) prompt (for the
    measurements that drive the engine's step loop directly)."""
    import torch
    ids, m, base = eng._bucket_prompt(ids, mask)
    st = eng.prefill(torch.as_tensor(ids, device="cuda"),
                     torch.as_tensor(m, device="cuda"), base, buf_steps)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    return eng, st, base, gen


def decode_inputs(pipe, items):
    """(engine, prompt ids, mask) of the pipeline's batch of text-only
    ``items``."""
    from moss_ttsd_torch.pipeline import prompt as pp
    from moss_ttsd_torch.pipeline.batch import SYSTEM_PROMPT
    shifted = [pipe._assemble(pipe._prepare_text(it, False)[0], None,
                              SYSTEM_PROMPT) for it in items]
    batch, mask = pp.left_pad_batch(shifted, pipe.tokenizer.pad_token_id,
                                    pipe.lm_cfg.speech_pad_token)
    return pipe.engine, batch, mask


def decode_state(pipe, items):
    """engine_state of the pipeline's batch of text-only ``items``."""
    return engine_state(*decode_inputs(pipe, items), 256)


def count_syncs_per_step(eng, st, base, gen, steps: int = 16) -> float:
    """Host syncs of the decode step of a prefilled state, counted by
    torch's sync debug mode over ``steps`` steps past the teacher-forcing
    window (C - 1 steps), i.e. the step that runs for all but the first
    C - 1 of the budget."""
    import torch
    eng.run(st, base, eng.cfg.channels - 1, gen)
    start = st.step
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng.run(st, base, start + steps, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(x.message) for x in w)
    return n / max(st.step - start, 1)


def in_path_prefill(eng, ids, mask, buf_steps: int = 256):
    """engine_state of a (B, L, C) prompt, with every flash_prefill launch
    of its prefill bracketed by CUDA events: the in-path device ms of each
    call, at the path's own layouts and cache state. A spin kernel of about
    1 ms runs before each bracket, so the device is still busy when the
    host enqueues the start event, the kernel and the end event: the host's
    launch gaps between them are not counted. Returns (engine_state,
    {"median", "min", "max"} of the ms per call)."""
    import torch
    from moss_ttsd_torch.models import lm
    orig, spans = lm.flash_prefill, []

    def bracketed(*a, **kw):
        torch.cuda._sleep(2_000_000)          # ~1 ms of device work
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    lm.flash_prefill = bracketed
    try:
        state = engine_state(eng, ids, mask, buf_steps)
    finally:
        lm.flash_prefill = orig
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in spans)
    return state, {"median": ms[len(ms) // 2], "min": ms[0], "max": ms[-1]}


def profile_decode(run, eng, st, base, gen, steps: int = 16):
    """torch.profiler over ``steps`` decode steps of a prefilled state (run
    = the name of the run it belongs to): device busy time per step (sum of
    kernel times; one stream, so kernels do not overlap), the idle share of
    the window, launches per step and the kernels that take the most device
    time. Profiler overhead inflates the window's host time, so the idle
    share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    warm = eng.cfg.channels                         # past the TF window
    eng.run(st, base, warm, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(st, base, warm + steps, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = []
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kern.append((e.key, t, e.count))
    busy_us = sum(t for _, t, _ in kern)
    kern.sort(key=lambda x: -x[1])
    split = [(t, c) for k, t, c in kern if "split_kernel" in k]
    emit({"phase": "profile", "run": run, "steps": steps,
          "decode_split_kernel_ms_per_call":
              sum(t for t, _ in split) / 1e3 / max(1, sum(c for _, c in split)),
          "host_ms_per_step": wall / steps * 1e3,
          "device_busy_ms_per_step": busy_us / 1e3 / steps,
          "device_idle_share": 1.0 - busy_us / (wall * 1e6),
          "kernel_launches_per_step": sum(c for _, _, c in kern) / steps,
          "top": [{"kernel": k[:80], "ms_per_step": t / 1e3 / steps,
                   "calls_per_step": c / steps} for k, t, c in kern[:12]]})


def reference_check():
    """The same small models on the card (kernels) and on the CPU (plain
    versions), fp32 with TF32 off: LM prefill + 3 cached decode steps, the
    greedy tokens of a short generate, and a codec decode must agree."""
    import numpy as np
    import torch
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             CodecConfig, LMConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.models.lm import AsteroidLM, init_cache

    cfg = LMConfig(dtype="float32", param_dtype="float32").tiny()
    cpu = AsteroidLM.init_random(cfg, seed=0, device="cpu")
    gpu = AsteroidLM.init_random(cfg, seed=0, device="cpu").to("cuda")
    rng = np.random.default_rng(0)
    B, T, S = 2, 37, 48
    ids = rng.integers(0, cfg.speech_vocab_size, (B, T + 3, cfg.channels))
    attn = np.ones((B, T), np.int64)
    attn[1, :11] = 0
    pos = np.maximum(np.cumsum(attn, 1) - 1, 0)
    hid = {}
    with torch.no_grad():
        for name, m, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            kv = torch.zeros((B, S), dtype=torch.bool, device=dev)
            kv[:, :T] = torch.as_tensor(attn, device=dev).bool()
            cache = init_cache(cfg, B, S, torch.float32, dev)
            p = torch.as_tensor(pos, device=dev)
            h, _ = m.backbone(torch.as_tensor(ids[:, :T], device=dev), p, kv,
                              cache, 0)
            outs = [h[1:, 11:], h[:1]]
            for s in range(3):
                kv[:, T + s] = True
                p = p[:, -1:] + 1
                h, _ = m.backbone(torch.as_tensor(ids[:, T + s:T + s + 1],
                                                  device=dev), p, kv, cache,
                                  T + s)
                outs.append(h)
            hid[name] = torch.cat([o.reshape(-1).cpu() for o in outs])
    lm_err = float((hid["cuda"] - hid["cpu"]).abs().max())

    greedy = SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(cfg.channels)], max_new_tokens=12)
    prompt = np.full((B, 20, cfg.channels), cfg.speech_pad_token, np.int64)
    prompt[..., 0] = rng.integers(1, 90, (B, 20))
    mask = np.ones((B, 20), np.int64)
    mask[0, :5] = 0
    tok_match = {}
    for name, policy in (("bf16_path", {}),
                         ("int8_kv8", dict(quant="int8", kv_quant="int8"))):
        toks = [GenerationEngine(cfg, m, greedy, bucket=32, device=dev,
                                 **policy).generate(prompt, mask, 12).tokens
                for m, dev in ((cpu, "cpu"), (gpu, "cuda"))]
        tok_match[name] = float(np.mean(toks[0] == toks[1])) \
            if toks[0].shape == toks[1].shape else 0.0

    ccfg = CodecConfig().tiny()
    spt_cpu = XYTokenizer.init_random(ccfg, seed=0, device="cpu")
    spt_gpu = XYTokenizer(ccfg, {k: v.clone() for k, v in
                                 spt_cpu.module.state_dict().items()},
                          device="cuda")
    codes = [rng.integers(0, ccfg.quantizer.codebook_size,
                          (spt_cpu.nq, n)).astype(np.int32) for n in (90, 41)]
    wa = spt_cpu.decode(codes)["syn_wav_list"]
    wb = spt_gpu.decode(codes)["syn_wav_list"]
    codec_err = max(float(np.abs(a - b).max()) for a, b in zip(wa, wb))
    enc = encode_reference(spt_cpu, spt_gpu)
    ok = (lm_err <= 1e-4 and codec_err <= 1e-4 and enc["latent_max_abs_err"]
          <= 1e-4 and enc["code_agreement"] >= 0.99)
    emit({"phase": "reference", "lm_hidden_max_abs_err": lm_err,
          "lm_tol": 1e-4, "greedy_token_match": tok_match,
          "codec_wav_max_abs_err": codec_err, "codec_tol": 1e-4,
          "codec_encode": enc, "ok": ok})
    if not ok:
        raise SystemExit("card vs CPU reference check failed")


def prompt_voices():
    """The examples' prompt voices as 16 kHz mono: voice_s1 + voice_s2
    (the two-speaker prompt, 6 s) and voice_both (4 s)."""
    import numpy as np
    from moss_ttsd_torch.pipeline.jsonl import load_audio_data
    return [load_audio_data({"speaker1": os.path.join(EXAMPLES, "voice_s1.wav"),
                             "speaker2": os.path.join(EXAMPLES, "voice_s2.wav")}),
            np.asarray(load_audio_data(os.path.join(EXAMPLES,
                                                    "voice_both.wav")))]


def encode_reference(spt_cpu, spt_gpu):
    """The tiny fp32 codec encode of the examples' voices on the card vs the
    CPU (TF32 off): the pre-RVQ latents of one padded window within 1e-4;
    the codes identical, or at least 99 % equal, with the differing codes
    (flips on near ties of the codebook distances) counted."""
    import numpy as np
    import torch
    wavs = prompt_voices()
    x = np.zeros((len(wavs), spt_cpu.chunk_samples), np.float32)
    for b, w in enumerate(wavs):
        x[b, :len(w)] = w
    lens = np.array([len(w) for w in wavs])
    with torch.no_grad():
        lat = [spt.module._encode_latents(
            torch.as_tensor(x, device=spt.device),
            torch.as_tensor(lens, device=spt.device))[0].cpu()
            for spt in (spt_cpu, spt_gpu)]
    ca = spt_cpu.encode(wavs)["codes_list"]
    cb = spt_gpu.encode(wavs)["codes_list"]
    same = [a.shape == b.shape for a, b in zip(ca, cb)]
    n_diff = sum(int((a != b).sum()) for a, b in zip(ca, cb)) \
        if all(same) else None
    n_all = sum(a.size for a in ca)
    return {"latent_max_abs_err": float((lat[0] - lat[1]).abs().max()),
            "latent_tol": 1e-4,
            "code_shapes": [list(a.shape) for a in cb],
            "codes_identical": n_diff == 0,
            "codes_differing": n_diff,
            "code_agreement": 0.0 if n_diff is None else 1 - n_diff / n_all}


def main_path():
    import torch
    t0 = time.perf_counter()
    pipe, cfg = build_full_pipeline()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    items = load_items()
    texts, audio, e2e_s, counts, peak, st = timed_batch(pipe, items)
    L = cfg.num_hidden_layers
    problems, wav_lens, audio_s = audio_problems(texts, audio, st["steps"],
                                                 cfg.channels)
    if counts["flash_prefill"] != L * 1:
        problems.append(f"prefill launches {counts['flash_prefill']} != {L}")
    if counts["flash_decode_hs"] != L * st["steps"]:
        problems.append(f"decode launches {counts['flash_decode_hs']} != "
                        f"{L} x {st['steps']}")
    if counts["flash_decode_int8_hs"]:
        problems.append("the bf16 path ran the int8-cache kernel")
    if st["steps"] != 256:
        problems.append(f"decode ran {st['steps']} of 256 steps")

    state, prefill_ms = in_path_prefill(*decode_inputs(pipe, items))
    syncs = count_syncs_per_step(*state)
    tm = pipe.timings
    line = {"phase": "main_path", "layers": L, "batch": st["batch"],
            "base": st["base"], "buf_steps": st["buf_steps"],
            "left_pad": st["left_pad"], "steps": st["steps"],
            "init_s": init_s, "prefill_ms": st["prefill_s"] * 1e3,
            "decode_s": st["decode_s"],
            "decode_steps_per_s": st["steps"] / st["decode_s"],
            "vocode_s": tm.vocode_s, "e2e_s": e2e_s,
            "audio_s": audio_s, "rtf": audio_s / e2e_s,
            "wav_samples": wav_lens, "peak_mem_gib": peak / 2 ** 30,
            "estimate_gib": memory_estimate_gib(cfg, st["batch"],
                                                st["steps"], st["base"]),
            "host_syncs_per_step": syncs, "launches": counts,
            "prefill_in_path_ms": prefill_ms,
            "ok": not problems, "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"main path failed: {problems}")
    return pipe, line


# ---------------------------------------------------------------------------
# phase 6: voice cloning at the full width
# ---------------------------------------------------------------------------

def clone_items():
    """The two voice items of examples/ (a two-speaker prompt of voice_s1 +
    voice_s2, a single-reference voice_both) and a third whose prompt is
    voice_s1 as a stereo 24 kHz (wav, sr) tuple (channel 2 at half gain),
    which the prompt loader resamples to 16 kHz."""
    import numpy as np
    from moss_ttsd_torch.ops.dsp import resample
    from moss_ttsd_torch.utils.audio_io import read_wav
    items = []
    for name in CLONE_JSONLS:
        with open(os.path.join(EXAMPLES, name)) as f:
            items += [json.loads(line) for line in f if line.strip()]
    w, sr = read_wav(os.path.join(EXAMPLES, "voice_s1.wav"))
    w24 = resample(w[0], sr, 24000)
    items.append({"text": items[0]["text"],
                  "prompt_audio": (np.stack([w24, 0.5 * w24]), 24000),
                  "prompt_text": "[S1]This is the first speaker reference "
                                 "voice."})
    return items


def _spy(obj, name, record):
    """Wrap ``obj.name`` so that each call appends (args, result) to
    ``record``."""
    orig = getattr(obj, name)

    def call(*a, **kw):
        out = orig(*a, **kw)
        record.append((a, out))
        return out

    setattr(obj, name, call)


def clone_phase(profile: bool = False):
    """Voice cloning at the LMConfig() / CodecConfig() width (bf16 LM and
    codec, seed 0, 256 steps): the three items of ``clone_items`` through
    TTSPipeline.process_batch, counted as the main path is; then a repeated
    single-voice batch, which must be served from the prompt-encode LRU.
    ``profile``: a decode profile of the run's batch besides (B2 in the
    path at the clone shape)."""
    import numpy as np
    import torch
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils import native
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer

    cfg, model, spt, sampling = full_width_parts()
    pipe = TTSPipeline(MockTokenizer(), cfg, model, spt, sampling,
                       bucket=128, device="cuda")
    del model
    encodes, generates = [], []
    _spy(pipe.spt, "encode", encodes)
    _spy(pipe.engine, "generate", generates)
    items = clone_items()
    native.reset_calls()
    texts, audio, e2e_s, counts, peak, st = timed_batch(pipe, items)
    L, C, steps = cfg.num_hidden_layers, cfg.channels, st["steps"]
    problems, wav_lens, audio_s = audio_problems(texts, audio, steps, C)
    codes = encodes[-1][1]["codes_list"]
    want_shapes = [[8, 75], [8, 50], [8, 37]]
    if [list(c.shape) for c in codes] != want_shapes:
        problems.append(f"prompt codes {[c.shape for c in codes]}")
    if not all(c.min() >= 0 and c.max() < spt.cfg.quantizer.codebook_size
               for c in codes):
        problems.append("prompt codes out of [0, codebook_size)")
    prompt_s = sum(len(w) for w in encodes[-1][0][0]) / spt.input_sample_rate
    want = {"flash_prefill": L, "flash_decode_hs": L * steps,
            "flash_decode_int8_hs": 0}
    if counts != want:
        problems.append(f"launches {counts} != {want}")
    if steps != 256:
        problems.append(f"decode ran {steps} of 256 steps")
    tm = pipe.timings.as_dict()
    if not tm["tokenize_s"] > 0:
        problems.append("tokenize_s is 0")
    native_calls = dict(native.calls)
    if not (native.available() and native.LIB_PATH.exists()
            and native_calls["read_wav"] >= 3 and native_calls["resample"]):
        problems.append(f"native library not built or not used: "
                        f"{native.build_info} {native_calls}")

    ids, mask = generates[-1][0][:2]
    state, prefill_ms = in_path_prefill(pipe.engine, ids, mask)
    syncs = count_syncs_per_step(*state)
    del state
    if profile:
        profile_decode("clone", *engine_state(pipe.engine, ids, mask, 256))

    # a repeated single-voice batch: the first encodes (batch 1) and fills
    # the LRU, the second takes its codes from it
    single = items[1:2]
    n_enc, n_gen = len(encodes), len(generates)
    pipe.process_batch(single, max_new_tokens=8)
    pipe.process_batch(single, max_new_tokens=8)
    solo = encodes[n_enc][1]["codes_list"][0]
    lru = {"encodes": [len(a[0]) for a, _ in encodes[n_enc:]],
           "same_ids": bool(np.array_equal(generates[n_gen][0][0],
                                           generates[n_gen + 1][0][0])),
           "cached_voices": len(pipe._encode_cache)}
    # the LRU's batch-1 codes against the same voice's row of the batch-3
    # encode: bf16 GEMMs of another shape may flip codes on near ties
    if solo.shape == codes[1].shape:
        lru["solo_vs_batched_code_agreement"] = float(np.mean(solo == codes[1]))
        lru["solo_vs_batched_first_stage"] = float(np.mean(solo[0]
                                                           == codes[1][0]))
    if lru["encodes"] != [1] or not lru["same_ids"]:
        problems.append(f"prompt-encode LRU: {lru}")
    if not lru.get("solo_vs_batched_code_agreement", 0.0) >= 0.85:
        problems.append(f"solo vs batched encode of voice_both: {lru}")

    line = {"phase": "clone", "layers": L, "batch": st["batch"],
            "base": st["base"], "buf_steps": st["buf_steps"],
            "left_pad": st["left_pad"], "steps": steps,
            "prompt_codes": [list(c.shape) for c in codes],
            "prompt_audio_s": prompt_s, "tokenize_s": tm["tokenize_s"],
            "encode_rtf": prompt_s / tm["tokenize_s"],
            "prefill_ms": st["prefill_s"] * 1e3,
            "prefill_in_path_ms": prefill_ms,
            "decode_s": st["decode_s"],
            "decode_steps_per_s": steps / st["decode_s"],
            "vocode_s": tm["vocode_s"], "e2e_s": e2e_s, "audio_s": audio_s,
            "rtf": audio_s / e2e_s, "wav_samples": wav_lens,
            "peak_mem_gib": peak / 2 ** 30, "host_syncs_per_step": syncs,
            "launches": counts, "native": {"lib": str(native.LIB_PATH),
                                           "build": {k: native.build_info.get(k)
                                                     for k in ("ok", "seconds")},
                                           "calls": native_calls},
            "lru": lru, "ok": not problems, "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"clone phase failed: {problems}")
    return line


# ---------------------------------------------------------------------------
# phase 7: int8 serving at the full width
# ---------------------------------------------------------------------------

def int8_pipeline_run(name, pipe, items):
    """One counted TTSPipeline run of the int8 phase: the bf16-cache decode
    kernel at every step, audio checked. Without the restricted head the
    whole vocab is speech and the run must take all 256 steps; with it a
    row may stop on <|end_of_speech|>, so it must take at least C - 1 steps
    past the teacher-forcing window, and its audit must have counted rows."""
    texts, audio, e2e_s, counts, peak, st = timed_batch(pipe, items)
    cfg = pipe.lm_cfg
    C, L, steps = cfg.channels, cfg.num_hidden_layers, st["steps"]
    problems, wav_lens, audio_s = audio_problems(texts, audio, steps, C)
    want = {"flash_prefill": L, "flash_decode_hs": L * steps,
            "flash_decode_int8_hs": 0}
    if counts != want:
        problems.append(f"launches {counts} != {want}")
    if not cfg.restricted_text_head and steps != 256:
        problems.append(f"decode ran {steps} of 256 steps")
    if cfg.restricted_text_head and steps < 2 * (C - 1):
        problems.append(f"{steps} steps: fewer than C - 1 past the "
                        "teacher-forcing window")
    audit = st["audit"]
    if cfg.restricted_audit_every and not (audit and audit[0] > 0):
        problems.append(f"audit counters {audit}")
    line = {"phase": "int8", "run": name, "quantized": cfg.quantized,
            "kv_quant": cfg.kv_quant, "batch": st["batch"],
            "base": st["base"], "steps": steps,
            "prefill_ms": st["prefill_s"] * 1e3, "decode_s": st["decode_s"],
            "decode_steps_per_s": steps / st["decode_s"],
            "vocode_s": pipe.timings.vocode_s, "e2e_s": e2e_s,
            "audio_s": audio_s, "rtf": audio_s / e2e_s,
            "wav_samples": wav_lens, "peak_mem_gib": peak / 2 ** 30,
            "host_syncs_per_step": count_syncs_per_step(
                *decode_state(pipe, items)),
            "audit_rows_flagged": audit, "launches": counts,
            "ok": not problems, "problems": problems}
    emit(line)
    return line


def int8_phase(profile: bool = False):
    """int8 serving at the LMConfig() width, the seeded bf16 random weights
    quantized inside the engine: (1) TTSPipeline(quant="int8"); (2) the same
    with the restricted text head and its audit under the speech window
    (151665, 152695) of bench.py; (3) the long-form engine of bench_full.py
    (quant and kv_quant "int8", bucket 64, step_bucket 1500, batch 1, a
    64-row random text prompt, 800 of the 1500 steps the cache holds).
    ``profile``: a decode profile of runs 1 and 3 besides."""
    import numpy as np
    import torch
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer

    cfg, model, spt, sampling = full_width_parts()
    items = load_items()
    C, L = cfg.channels, cfg.num_hidden_layers
    lines = []

    pipe = TTSPipeline(MockTokenizer(), cfg, model, spt, sampling,
                       bucket=128, quant="int8", device="cuda")
    lines.append(int8_pipeline_run("quant_int8", pipe, items))
    if profile:
        profile_decode("int8:quant_int8", *decode_state(pipe, items))
    del pipe

    # the window [151665, 152695) holds the speech ids and
    # <|end_of_speech|>; counting all of it as speech keeps random weights
    # from the EOS flush, but a row still stops when it samples the EOS id
    rcfg = LMConfig.from_dict({**cfg.to_dict(),
                               "speech_token_range": [151665, 152695]})
    pipe = TTSPipeline(MockTokenizer(), rcfg, model, spt, sampling,
                       bucket=128, quant="int8", restricted_text_head=True,
                       restricted_audit_every=16, device="cuda")
    lines.append(int8_pipeline_run("restricted_head_audit16", pipe, items))
    del pipe, spt

    steps = 800
    sampling.max_new_tokens = steps
    eng = GenerationEngine(cfg, model, sampling, bucket=64, quant="int8",
                           kv_quant="int8", step_bucket=1500, device="cuda")
    del model
    rng = np.random.default_rng(0)
    ids = np.full((1, 64, C), cfg.speech_pad_token, np.int64)
    ids[..., 0] = rng.integers(1, 10000, (1, 64))
    mask = np.ones((1, 64), np.int64)
    eng.generate(ids, mask, max_new_tokens=16, seed=1)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(ids, mask, max_new_tokens=steps, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, st = fa.launch_counts(), eng.last_stats
    problems = []
    want = {"flash_prefill": L, "flash_decode_hs": 0,
            "flash_decode_int8_hs": L * steps}
    if counts != want:
        problems.append(f"launches {counts} != {want}")
    if res.steps != steps:
        problems.append(f"decode ran {res.steps} of {steps} steps")
    gen = res.tokens[:, res.base:]
    if not ((gen[..., 0] >= 0).all() and (gen[..., 0] < cfg.vocab_size).all()
            and (gen[..., 1:] < cfg.speech_vocab_size).all()):
        problems.append("generated ids out of range")
    line = {"phase": "int8", "run": "longform_kv8", "quantized": True,
            "kv_quant": "int8", "batch": 1, "base": res.base,
            "buf_steps": st["buf_steps"], "steps": res.steps,
            "prefill_ms": st["prefill_s"] * 1e3, "decode_s": st["decode_s"],
            "decode_steps_per_s": res.steps / st["decode_s"],
            "generate_s": wall, "decode_rtf": res.steps / st["decode_s"] / 12.5,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "estimate_gib": memory_estimate_gib(cfg, 1, st["buf_steps"],
                                                res.base,
                                                "int8", cache_bytes=1),
            "host_syncs_per_step": count_syncs_per_step(
                *engine_state(eng, ids, mask, steps)),
            "launches": counts, "ok": not problems, "problems": problems}
    emit(line)
    lines.append(line)
    if profile:
        profile_decode("int8:longform_kv8",
                       *engine_state(eng, ids, mask, steps))
    bad = [ln["run"] for ln in lines if not ln["ok"]]
    if bad:
        raise SystemExit(f"int8 phase failed: {bad}")
    return lines


def logits_check(pipe):
    """The tied text head: fp32-output product (the port's choice) vs a
    bf16 product rounded to bf16, on one decode step's hidden state."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.models.lm import matmul_f32_out
    model = pipe.engine.model
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((2, model.cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = model.embed_text
    f32 = matmul_f32_out(h, w.t())
    b16 = F.linear(h, w).float()
    exact = h.double() @ w.double().t()
    top_f32 = f32.topk(50).indices
    top_b16 = b16.topk(50).indices
    top_ref = exact.topk(50).indices
    line = {"phase": "logits", "vocab": w.shape[0],
            # the 625 MB table exceeds L2, so one input set reads HBM
            "f32_out_ms": cuda_ms(lambda i: matmul_f32_out(h, w.t()), 50),
            "bf16_out_ms": cuda_ms(lambda i: F.linear(h, w).float(), 50),
            "f32_out_max_abs_err": float((f32.double() - exact).abs().max()),
            "bf16_out_max_abs_err": float((b16.double() - exact).abs().max()),
            "top50_match_f32": float((top_f32 == top_ref).float().mean()),
            "top50_match_bf16": float((top_b16 == top_ref).float().mean())}
    emit(line)


# ---------------------------------------------------------------------------
# phases 8-10: streaming, the decode/vocode overlap, the speech server
# ---------------------------------------------------------------------------

def _spy_stream(engine, record):
    """Wrap engine.generate_stream so that each run appends (its args, the
    list of results it yielded, the host clock at each yield) to
    ``record``."""
    orig = engine.generate_stream

    def generate_stream(*a, **kw):
        seen, times = [], []
        record.append((a, kw, seen, times))
        for r in orig(*a, **kw):
            seen.append(r)
            times.append(time.perf_counter())
            yield r

    engine.generate_stream = generate_stream
    return orig


def _b2_plan(B, S):
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    n_split, chunk = fa.decode_split_plan(B, 8, S,
                                          fa.sm_count(torch.device("cuda")))
    return {"n_split": n_split, "chunk": chunk, "blocks": B * 8 * n_split}


def _launch_problems(counts, L, prefills, steps):
    want = {"flash_prefill": L * prefills, "flash_decode_hs": L * steps,
            "flash_decode_int8_hs": 0}
    return [] if counts == want else [f"launches {counts} != {want}"]


def stream_phase(pipe, steps: int = 256):
    """TTSPipeline.stream_item over item 0 of examples_only_text.jsonl
    (batch 1), chunks of 25 steps after a first of 12, seed 0: the time to
    first audio (wall seconds from the call to the first chunk), chunks,
    samples, steps/s, launch counts, host syncs per step; the streamed
    tokens against engine.generate on the same row and seed, the samples
    against frames x 1920, every chunk finite; the max |diff| against the
    serial process_batch wav is information (a sliding window with 25
    frames of context is not the serial 30 s window). The TTFA splits into
    the first segment (prefill and 12 steps) and the first chunk's vocode;
    the host seconds spent in StreamVocoder.feed / finish, and the engine's
    steps/s with no vocoder between its segments, say what slows the
    streamed step."""
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.pipeline.batch import StreamVocoder
    item = load_items()[0]
    kw = dict(max_new_tokens=steps, chunk_steps=25, first_chunk_steps=12,
              seed=0)
    eng = pipe.engine
    L, C = pipe.lm_cfg.num_hidden_layers, pipe.lm_cfg.channels
    for _ in pipe.stream_item(item, **{**kw, "max_new_tokens": 30}):
        pass                                               # warm-up
    torch.cuda.synchronize()
    runs, vocoder_s = [], [0.0]
    orig = _spy_stream(eng, runs)
    orig_feed, orig_finish = StreamVocoder.feed, StreamVocoder.finish

    def timed(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                vocoder_s[0] += time.perf_counter() - t
        return call

    StreamVocoder.feed, StreamVocoder.finish = (timed(orig_feed),
                                                timed(orig_finish))
    pipe.timings.__init__()
    fa.reset_launch_counts()
    chunks, t_first = [], None
    t0 = time.perf_counter()
    try:
        for chunk, sr in pipe.stream_item(item, **kw):
            if t_first is None:
                t_first = time.perf_counter() - t0
            chunks.append(chunk)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
    finally:
        eng.generate_stream = orig
        StreamVocoder.feed, StreamVocoder.finish = orig_feed, orig_finish
    counts, st = fa.launch_counts(), dict(eng.last_stats)
    (args, skw, results, yield_t), = runs
    last = results[-1]
    problems = _launch_problems(counts, L, 1, last.steps)
    if last.steps != steps:
        problems.append(f"stream ran {last.steps} of {steps} steps")
    full = eng.generate(*args, seed=skw["seed"])
    if not np.array_equal(full.tokens, last.tokens):
        problems.append("streamed tokens != engine.generate's")
    _, ends = pipe.unshift_end(last.tokens, last.base)
    frames = int(ends[0])
    samples = sum(len(c) for c in chunks)
    if samples != frames * 1920:
        problems.append(f"{samples} samples for {frames} frames")
    if not all(np.isfinite(c).all() for c in chunks):
        problems.append("non-finite chunk")
    _, audio = pipe.process_batch([item], max_new_tokens=steps, seed=0)
    serial = audio[0]["audio_data"][0]
    streamed = np.concatenate(chunks)
    # host syncs of the engine's segmented loop alone
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            segs = list(eng.generate_stream(*args, **skw))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(x.message) for x in w)
    alone_s = eng.last_stats["decode_s"]
    line = {"phase": "stream", "layers": L, "batch": 1, "base": last.base,
            "buf_steps": st["buf_steps"], "left_pad": st["left_pad"],
            "steps": last.steps,
            "boundaries": skw["boundaries"][:4] + ["..."],
            "segments": len(results), "chunks": len(chunks),
            "chunk_samples_first": [len(c) for c in chunks[:4]],
            "ttfa_s": t_first, "first_segment_s": yield_t[0] - t0,
            "first_vocode_s": t_first - (yield_t[0] - t0), "e2e_s": e2e_s,
            "prefill_ms": st["prefill_s"] * 1e3,
            "decode_loop_s": st["decode_s"],
            "decode_steps_per_s": last.steps / st["decode_s"],
            "frames": frames, "samples": samples,
            "audio_s": samples / pipe.spt.output_sample_rate,
            "rtf": samples / pipe.spt.output_sample_rate / e2e_s,
            "vocode_readback_s": pipe.timings.vocode_s,
            "vocoder_host_s": vocoder_s[0],
            "engine_alone_steps_per_s": segs[-1].steps / alone_s,
            "launches": counts,
            "host_syncs_per_step": syncs / max(segs[-1].steps, 1),
            "host_syncs": syncs,
            "b2_plan": _b2_plan(1, last.base + st["buf_steps"]),
            "tokens_equal_generate": "streamed tokens != engine.generate's"
                                     not in problems,
            "vs_serial_wav_max_abs_diff":
                float(np.abs(streamed - serial).max())
                if streamed.shape == serial.shape else None,
            "ok": not problems, "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"stream phase failed: {problems}")
    return line


def overlap_phase(pipe, steps: int = 400):
    """process_batch over the two items of examples_only_text.jsonl at 400
    steps, overlap_vocode off, then on: 393 decodable frames exceed the
    375-code codec window, so the overlap branch runs two segments (the
    first ends at step 382, where window 0 completes) and vocodes window 0
    while the second decodes. Tokens identical, wavs byte-identical, the
    same vocode calls (shapes) in both branches."""
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    items = load_items()
    eng, spt = pipe.engine, pipe.spt
    L = pipe.lm_cfg.num_hidden_layers
    gens, streams, vocodes = [], [], []
    orig_gen, orig_det = eng.generate, spt._detokenize
    _spy(eng, "generate", gens)
    orig_stream = _spy_stream(eng, streams)

    def detokenize(codes, lens, pcm16):
        vocodes.append((list(codes.shape), [int(x) for x in lens]))
        return orig_det(codes, lens, pcm16)

    spt._detokenize = detokenize
    out = {}
    try:
        for overlap in (False, True):
            pipe.overlap_vocode = overlap
            pipe.process_batch(items, max_new_tokens=24, seed=1)  # warm-up
            torch.cuda.synchronize()
            n_voc = len(vocodes)
            pipe.timings.__init__()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            _, audio = pipe.process_batch(items, max_new_tokens=steps,
                                          seed=0)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
            out[overlap] = {"audio": audio, "e2e_s": e2e,
                            "tokens": (streams[-1][2][-1] if overlap
                                       else gens[-1][1]).tokens,
                            "launches": fa.launch_counts(),
                            "timings": pipe.timings.as_dict(),
                            "vocode_calls": vocodes[n_voc:]}
    finally:
        eng.generate, eng.generate_stream = orig_gen, orig_stream
        spt._detokenize = orig_det
        pipe.overlap_vocode = True
    serial, ovl = out[False], out[True]
    seg_steps = [r.steps for r in streams[-1][2]]
    problems = []
    if seg_steps != [382, steps]:
        problems.append(f"overlap segments {seg_steps} != [382, {steps}]")
    if not np.array_equal(serial["tokens"], ovl["tokens"]):
        problems.append("tokens differ between the branches")
    same = [a is not None and b is not None
            and np.array_equal(a["audio_data"], b["audio_data"])
            for a, b in zip(serial["audio"], ovl["audio"])]
    if not all(same):
        diffs = [float(np.abs(a["audio_data"] - b["audio_data"]).max())
                 if a["audio_data"].shape == b["audio_data"].shape else None
                 for a, b in zip(serial["audio"], ovl["audio"])]
        problems.append(f"wavs differ: max |diff| {diffs}")
    if serial["vocode_calls"] != ovl["vocode_calls"]:
        problems.append("vocode calls differ")
    for o in (serial, ovl):
        problems += _launch_problems(o["launches"], L, 1, steps)
    audio_s = sum(a["audio_data"].shape[-1] for a in ovl["audio"]
                  if a is not None) / spt.output_sample_rate
    line = {"phase": "overlap", "batch": len(items), "steps": steps,
            "segments": seg_steps, "vocode_calls": ovl["vocode_calls"],
            "wav_samples": [a["audio_data"].shape[-1] for a in ovl["audio"]],
            "byte_identical": all(same), "audio_s": audio_s,
            "serial": {"e2e_s": serial["e2e_s"],
                       "rtf": audio_s / serial["e2e_s"],
                       **serial["timings"]},
            "overlap": {"e2e_s": ovl["e2e_s"], "rtf": audio_s / ovl["e2e_s"],
                        **ovl["timings"]},
            "launches": ovl["launches"], "ok": not problems,
            "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"overlap phase failed: {problems}")
    return line


def server_phase(pipe, max_tokens: int = 128):
    """The window-scheduler SpeechServer over the full-width pipeline on
    127.0.0.1 (max_batch 4, a 0.2 s window): /health; three concurrent wav
    requests, which must share one batch (launches 28 prefill, 28 x steps
    decode); a request cloning a voice from a base64 wav of examples/; a
    streamed request read to its end (its PCM16 equal in length, and
    within one int16 step, to stream_item's on the same pipeline); the
    port's API client; /v1/metrics; and a lone request after the others
    (a batch of one) against process_batch within one int16 step."""
    import base64
    import http.client
    import threading
    import urllib.request
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.serve.api_client import (SpeechAPIClient,
                                                  wav_bytes_to_array)
    from moss_ttsd_torch.serve.server import SpeechServer
    from moss_ttsd_torch.utils.profiling import metrics

    L = pipe.lm_cfg.num_hidden_layers
    srv = SpeechServer(pipe, "127.0.0.1", 0, max_batch=4, batch_window_s=0.2)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    problems, line = [], {"phase": "server", "max_tokens": max_tokens}

    def post(payload):
        req = urllib.request.Request(f"{base}/v1/audio/speech",
                                     json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    texts = [it["text"] for it in load_items()] + [
        "[S1]A third request joins the batch.[S2]It does."]
    try:
        line["health"] = urllib.request.urlopen(f"{base}/health",
                                                timeout=60).read().decode()
        srv.warmup(max_tokens=16)
        metrics.reset()
        fa.reset_launch_counts()
        bodies = [None] * 3

        def work(i):
            bodies[i] = post({"input": texts[i], "max_tokens": max_tokens,
                              "seed": 0})

        threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        line["concurrent_s"] = time.perf_counter() - t0
        line["concurrent_launches"] = fa.launch_counts()
        st = pipe.engine.last_stats
        line["concurrent_b2_plan"] = _b2_plan(st["batch"],
                                              st["base"] + st["buf_steps"])
        snap = metrics.snapshot()
        line["batches"] = [snap.get("server_batches"),
                           snap.get("server_batched_requests")]
        if line["batches"] != [1, 3]:
            problems.append(f"3 concurrent requests: batches/requests "
                            f"{line['batches']} != [1, 3]")
        problems += _launch_problems(line["concurrent_launches"], L, 1,
                                     max_tokens)
        wavs = [wav_bytes_to_array(b)[0] for b in bodies]
        line["concurrent_samples"] = [len(w) for w in wavs]
        if not all(len(w) and np.isfinite(w).all() for w in wavs):
            problems.append("a concurrent wav is empty or not finite")

        with open(os.path.join(EXAMPLES, "voice_both.wav"), "rb") as f:
            ref = base64.b64encode(f.read()).decode()
        w, sr = wav_bytes_to_array(post({
            "input": texts[0], "max_tokens": max_tokens, "seed": 0,
            "references": [{"audio": ref, "text": "[S1]This is the first "
                            "speaker reference voice."}]}))
        line["clone_samples"] = len(w)
        if not (len(w) and np.isfinite(w).all() and sr == 24000):
            problems.append("the voice-cloning request gave no audio")

        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech", json.dumps(
            {"input": texts[0], "stream": True, "max_tokens": max_tokens,
             "seed": 0}), {"Content-Type": "application/json"})
        r = conn.getresponse()
        reads, first_s = [], None
        while True:
            b = r.read1(65536)
            if not b:
                break
            if first_s is None:
                first_s = time.perf_counter() - t0
            reads.append(b)
        conn.close()
        pcm = b"".join(reads)
        ref_chunks = [c for c, _ in pipe.stream_item(
            {"text": texts[0]}, max_new_tokens=max_tokens, seed=0)]
        ref_wav = np.concatenate(ref_chunks)
        got = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
        line["stream"] = {"status": r.status, "bytes": len(pcm),
                          "samples": len(ref_wav),
                          "client_first_bytes_s": first_s,
                          "content_type": r.headers["Content-Type"]}
        if r.status != 200 or len(pcm) != 2 * len(ref_wav):
            problems.append(f"stream: {line['stream']}")
        elif float(np.abs(got - ref_wav).max()) > 1.01 / 32768:
            problems.append("streamed PCM != stream_item's")

        client = SpeechAPIClient(f"{base}/v1", model="moss-ttsd",
                                 max_retries=1)
        w, _ = wav_bytes_to_array(client.generate_speech(
            texts[1], extra={"max_tokens": max_tokens, "seed": 0}))
        line["client_samples"] = len(w)
        if not len(w):
            problems.append("the API client got no audio")

        item = {"text": texts[2]}
        w, _ = wav_bytes_to_array(post({"input": item["text"],
                                        "max_tokens": max_tokens, "seed": 7}))
        _, audio = pipe.process_batch([item], max_new_tokens=max_tokens,
                                      seed=7)
        ref = audio[0]["audio_data"][0]
        line["lone_vs_process_batch_max_abs_diff"] = (
            float(np.abs(w - ref).max()) if w.shape == ref.shape else None)
        if w.shape != ref.shape or float(np.abs(w - ref).max()) \
                > 1.01 / 32768:
            problems.append("the lone request != process_batch")

        m = json.loads(urllib.request.urlopen(f"{base}/v1/metrics",
                                              timeout=60).read())
        line["metrics"] = {k: m.get(k) for k in (
            "server_request_latency_s_p50", "server_request_latency_s_p95",
            "server_request_latency_s_observed", "server_ttfa_s_p50",
            "server_batches", "server_batched_requests", "vocode_s",
            "prefill_decode_s", "generated_steps", "tokenize_s",
            "server_queue_depth")}
        if not (m.get("server_ttfa_s_observed") == 1
                and m.get("server_request_latency_s_observed") == 6
                and m.get("vocode_s", 0) > 0
                and m.get("prefill_decode_s", 0) > 0):
            problems.append(f"metrics: {line['metrics']}")
    finally:
        srv.stop()
    torch.cuda.synchronize()
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"server phase failed: {problems}")
    return line


# ---------------------------------------------------------------------------
# phase 9b: the podcast generator and the gradio app's synthesis paths
# ---------------------------------------------------------------------------

PODCAST_SOURCE = (
    "Speech codecs turn a second of audio into a dozen frames of discrete "
    "tokens. A language model writes those tokens the way it writes text, "
    "and the codec turns them back into sound.\n")


def memory_estimate_gib(cfg, batch: int, steps: int, prompt_len: int,
                        quant=None, cache_bytes: int = 2) -> float:
    """``utils/memory.serving_memory`` at a run's shape, in GiB. It counts
    neither the codec nor activations: information beside the measured
    peak, not a check."""
    from moss_ttsd_torch.utils.memory import FRAME_RATE, serving_memory
    est = serving_memory(cfg, batch, steps / FRAME_RATE, prompt_len, quant,
                         cache_bytes)
    return est.total_gb * 1e9 / 2 ** 30


def _gradio_calls(pipe):
    """The three gradio callbacks over the pipeline (loader=lambda: pipe,
    the module's pipeline reset before each) at its step budget: each
    call's seconds, the stream's chunks and time to first audio. Returns
    (line, problems)."""
    import numpy as np
    import torch
    from moss_ttsd_torch.serve import gradio_app as ga

    def first_item(name):
        with open(os.path.join(EXAMPLES, name)) as f:
            return json.loads(f.readline())

    single, role = (first_item(n) for n in
                    ("examples_single_reference.jsonl", "examples.jsonl"))
    voice = lambda it, k: os.path.join(EXAMPLES, it[k])
    en = ga.UI_STRINGS["en"]
    eng = pipe.engine
    steps = eng.sampling.max_new_tokens
    problems, line = [], {"steps": steps}
    streamed, runs = [], []
    orig_stream = pipe.stream_item

    def stream_item(*a, **kw):                 # records the float chunks
        for chunk, sr in orig_stream(*a, **kw):
            streamed.append(chunk)
            yield chunk, sr

    pipe.stream_item = stream_item
    _spy_stream(eng, runs)
    try:
        for name, call in (
                ("single", lambda: ga.synthesize_single(
                    single["text"], single["prompt_text"],
                    voice(single, "prompt_audio"), loader=lambda: pipe)),
                ("role", lambda: ga.synthesize_role(
                    role["text"], role["prompt_text_speaker1"],
                    voice(role, "prompt_audio_speaker1"),
                    role["prompt_text_speaker2"],
                    voice(role, "prompt_audio_speaker2"),
                    loader=lambda: pipe))):
            ga._PIPELINE = None
            t0 = time.perf_counter()
            out, status = call()
            torch.cuda.synchronize()
            line[f"{name}_s"] = time.perf_counter() - t0
            ok = (out is not None and out[0] == 24000
                  and out[1].dtype == np.int16 and out[1].ndim == 1
                  and len(out[1]) > 0
                  and status.startswith(en["status_generated"].format(
                      seconds=len(out[1]) / 24000)))
            line[f"{name}_samples"] = None if out is None else len(out[1])
            line[f"{name}_status"] = status[:80]
            if not ok:
                problems.append(f"gradio {name}: {status!r}")
        ga._PIPELINE = None
        chunks, t_first = [], None
        t0 = time.perf_counter()
        for out, status in ga.synthesize_single_stream(
                single["text"], single["prompt_text"],
                voice(single, "prompt_audio"), loader=lambda: pipe):
            if t_first is None:
                t_first = time.perf_counter() - t0
            chunks.append(out)
            if not status.startswith(en["status_streaming"][:9]):
                problems.append(f"gradio stream status {status!r}")
        torch.cuda.synchronize()
        line["stream_s"] = time.perf_counter() - t0
    finally:
        del eng.generate_stream, pipe.stream_item
        ga._PIPELINE = None
    last = runs[-1][2][-1]
    frames = int(pipe.unshift_end(last.tokens, last.base)[1][0])
    samples = sum(len(c[1]) for c in chunks if c is not None)
    line.update(stream_chunks=len(chunks), stream_ttfa_s=t_first,
                stream_frames=frames, stream_samples=samples,
                stream_steps=last.steps)
    if len(chunks) < 2 or any(c is None or c[0] != 24000
                              or c[1].dtype != np.int16 for c in chunks):
        problems.append(f"gradio stream gave {len(chunks)} chunks")
    if not all(np.isfinite(c).all() for c in streamed):
        problems.append("non-finite streamed chunk")
    if samples != frames * 1920:
        problems.append(f"gradio stream: {samples} samples for {frames} "
                        "frames")
    if last.steps != steps:
        problems.append(f"gradio stream ran {last.steps} steps")
    return line, problems


def podcast_phase(pipe):
    """The podcast generator at the main path's width over its pipeline: a
    short English .txt through ``podcast.process_input_to_audio`` (the
    language detected, the offline fallback script, the default voices
    cloned, 256 steps, batch 1), checked for the language, the script,
    one encode of both voices, 28 B1 + 28 x steps B2 launches, a finite
    24 kHz wav of frames x 1920 samples and its ``duration_s``; e2e s,
    ``tokenize_s``, prefill ms, steps/s, RTF, peak GiB beside the
    ``serving_memory`` estimate. Then the gradio callbacks
    (``_gradio_calls``) and ``create_gradio_interface``: an ImportError
    naming gradio where gradio is absent, the Blocks built (not launched)
    where it is there."""
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.serve import gradio_app as ga
    from moss_ttsd_torch.serve import podcast as pod
    from moss_ttsd_torch.utils.audio_io import read_wav, to_mono_16k
    root = os.path.join(ROOT, "build", "chip_smoke_podcast")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    txt, out_wav = (os.path.join(root, n) for n in ("notes.txt",
                                                    "podcast.wav"))
    with open(txt, "w") as f:
        f.write(PODCAST_SOURCE)
    os.environ.pop("PODCAST_LLM_BASE", None)
    eng, spt, cfg = pipe.engine, pipe.spt, pipe.lm_cfg
    L, steps = cfg.num_hidden_layers, eng.sampling.max_new_tokens
    base = pod.default_asset_base()
    voices = pod.DEFAULT_VOICES["en"]
    # warm-up at this item's shapes (the clone path's first encode), then
    # an empty prompt-encode LRU, so the counted run encodes the voices
    pipe.process_batch([{"base_path": base, "text": pod.FALLBACK_SCRIPT_EN,
                         **voices}], max_new_tokens=16, seed=1)
    pipe._encode_cache.clear()
    encodes, generates = [], []
    _spy(spt, "encode", encodes)
    _spy(eng, "generate", generates)
    try:
        pipe.timings.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        info = pod.process_input_to_audio(txt, pipe, out_wav)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        counts, peak = fa.launch_counts(), torch.cuda.max_memory_allocated()
    finally:
        del spt.encode, eng.generate
    st, tm = dict(eng.last_stats), pipe.timings.as_dict()
    res = generates[-1][1]
    problems = _launch_problems(counts, L, 1, res.steps)
    if res.steps != steps:
        problems.append(f"decode ran {res.steps} of {steps} steps")
    if info["language"] != "en" or pod.detect_language(PODCAST_SOURCE) != "en":
        problems.append(f"language {info['language']}")
    if info["script"] != pod.FALLBACK_SCRIPT_EN:
        problems.append("the script is not the fallback script")
    want = sum(len(to_mono_16k(*read_wav(os.path.join(base, voices[k]))))
               for k in ("prompt_audio_speaker1", "prompt_audio_speaker2"))
    enc = [[len(w) for w in a[0]] for a, _ in encodes]
    codes = encodes[-1][1]["codes_list"][0] if encodes else None
    # one encode of both voices: 16 kHz at 12.5 codec frames a second
    if enc != [[want]] or codes is None or codes.shape[1] != want // 1280:
        problems.append(f"voice encodes {enc} (want one of {want} samples)")
    frames = pipe.extract_codes(res)[0].shape[1]
    wav, sr = read_wav(out_wav)
    if not (sr == 24000 and np.isfinite(wav).all()
            and wav.shape[-1] == frames * 1920):
        problems.append(f"wav {wav.shape} at {sr} Hz for {frames} frames")
    if info["duration_s"] != wav.shape[-1] / sr:
        problems.append(f"duration_s {info['duration_s']} for "
                        f"{wav.shape[-1]} samples")
    audio_s = wav.shape[-1] / sr
    line = {"phase": "podcast", "layers": L, "batch": 1, "base": res.base,
            "buf_steps": st["buf_steps"], "steps": res.steps,
            "language": info["language"], "script_chars": len(info["script"]),
            "prompt_codes": None if codes is None else list(codes.shape),
            "tokenize_s": tm["tokenize_s"],
            "prefill_ms": st["prefill_s"] * 1e3, "decode_s": st["decode_s"],
            "decode_steps_per_s": res.steps / st["decode_s"],
            "vocode_s": tm["vocode_s"], "e2e_s": e2e_s, "audio_s": audio_s,
            "rtf": audio_s / e2e_s, "wav_samples": wav.shape[-1],
            "peak_mem_gib": peak / 2 ** 30,
            "estimate_gib": memory_estimate_gib(cfg, 1, res.steps, res.base),
            "launches": counts}
    line["gradio"], bad = _gradio_calls(pipe)
    problems += bad
    try:
        import gradio  # noqa: F401
    except ImportError:
        try:
            ga.create_gradio_interface(loader=lambda: pipe)
            problems.append("create_gradio_interface without gradio")
        except ImportError as e:
            line["gradio"]["interface"] = f"ImportError: {str(e)[:60]}"
            if "gradio" not in str(e):
                problems.append(f"the ImportError names no gradio: {e}")
    else:
        ga.create_gradio_interface(loader=lambda: pipe)
        line["gradio"]["interface"] = "built"
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"podcast phase failed: {problems}")
    shutil.rmtree(root, ignore_errors=True)
    return line


# ---------------------------------------------------------------------------
# phase: pool (the continuous slot pool, multi-LoRA)
# ---------------------------------------------------------------------------

POOL_TEXTS = (
    "[S1]Welcome back to the show, it is good to have you here.[S2]Thanks, "
    "glad to be back.",
    "[S1]Short one.[S2]Yes.",
    "[S1]Today we talk about the weather on the coast and why the fog "
    "comes in so early in the summer months.[S2]It is the cold current, "
    "mostly, and the warm air above it.",
    "[S1]Can you say that again?[S2]Of course. The fog comes from the "
    "cold water.",
    "[S1]What about the mountains?[S2]Different story there.",
    "[S1]Let us take a question from a listener who wrote in last week "
    "about the long drive home.[S2]Happy to.")


def _greedy(channels: int, n: int = 256):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    return SamplingConfig(channels=[ChannelSamplingConfig(
        do_sample=False, temperature=None, top_k=None, top_p=None)
        for _ in range(channels)], max_new_tokens=n)


def pool_adapter(cfg, seed: int, rank: int = 16):
    """A random rank-16 LoRA adapter on all seven projections of every
    layer (the reference's finetune targets), layer-stacked factors in the
    flat registry format; a and b N(0, 0.02), so with alpha 32 / rslora the
    delta is of the order of the projections' own output."""
    import numpy as np
    g = np.random.default_rng(seed)
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    hid, inter, L = (cfg.hidden_size, cfg.intermediate_size,
                     cfg.num_hidden_layers)
    dims = {"q_proj": (hid, H * D), "k_proj": (hid, Hkv * D),
            "v_proj": (hid, Hkv * D), "o_proj": (H * D, hid),
            "gate_proj": (hid, inter), "up_proj": (hid, inter),
            "down_proj": (inter, hid)}
    return {f"layers/block/{t}/kernel": {
        "a": (g.standard_normal((L, fi, rank), np.float32) * 0.02),
        "b": (g.standard_normal((L, rank, fo), np.float32) * 0.02)}
        for t, (fi, fo) in dims.items()}


def pool_prompts(pipe, n: int):
    """n delay-shifted prompts of the main path's text items and more."""
    texts = [it["text"] for it in load_items()] + list(POOL_TEXTS)
    return [pipe.prepare_item({"text": t})[0] for t in texts[:n]]


def _make_pool(cfg, model, sampling, kv_quant, adapters):
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    cb = ContinuousBatcher(cfg, model, sampling, slots=8, base=512,
                           max_steps=2048, device="cuda", kv_quant=kv_quant)
    for name, tree in adapters.items():
        cb.register_adapter(name, tree, alpha=32.0, use_rslora=True)
    return cb


def _run_to_end(cb, n, segment: int = 25):
    """Run the pool in segments until n rows have finished; returns (pool
    steps, wall seconds)."""
    import torch
    t0, steps = time.perf_counter(), 0
    while len(cb.finished()) < n:
        ran = cb.run(steps=segment)
        if not ran:
            break
        steps += ran
    torch.cuda.synchronize()
    return steps, time.perf_counter() - t0


def _pool_extent(cb):
    """The (B,) extent the pool's next step gives each row (the last valid
    slot + 1 for live rows, 1 for the others) and its valid bits."""
    import torch
    st = cb.state
    adv = st.active & st.unfinished
    iota = torch.arange(1, cb.S + 1, device="cuda")
    last = torch.where(st.key_valid, iota, 0).amax(dim=1)
    return (st.key_valid.clone(),
            torch.where(adv, last, 1).to(torch.int32))


def burst_check(pipe, adapters, prompts, kv_quant):
    """Eight greedy requests admitted in ONE burst at pool step 0 (budgets
    64-256; three on the base model, five split between two LoRA voices)
    against the static engine at the same batch, adapters, capacity
    (step_bucket 2048) and kv_quant: every row's tokens identical up to
    its own budget (the pool writes the same slots in the same batch as
    the static run). Counts the launches of the pool's run alone; with
    int8 KV also snapshots the valid bits and extents the pool reached
    (half-way) for the kernel rows."""
    import numpy as np
    import torch
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.pipeline import prompt as pp
    cfg, model = pipe.engine.cfg, pipe.engine.model
    C, L = cfg.channels, cfg.num_hidden_layers
    greedy = _greedy(C)
    budgets = [64, 96, 128, 160, 192, 224, 256, 80]
    rows = [None, None, None, "v1", "v1", "v1", "v2", "v2"]
    cb = _make_pool(cfg, model, greedy, kv_quant, adapters)
    line = {"kv_quant": kv_quant, "budgets": budgets, "adapters": rows,
            "prompt_rows": [len(p) for p in prompts]}
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    slots = cb.submit_many([(p, b, 0, a) for p, b, a in
                            zip(prompts, budgets, rows)])
    torch.cuda.synchronize()
    line["admission_ms"] = (time.perf_counter() - t0) * 1e3
    snap = None
    if kv_quant == "int8":
        half = cb.run(128)
        snap = _pool_extent(cb)
        steps = half + _run_to_end(cb, 8)[0]
    else:
        steps = _run_to_end(cb, 8)[0]
    line["launches"] = fa.launch_counts()
    line["pool_steps"] = steps
    got = {s: cb.collect(s) for s in slots}
    want_launch = {"flash_prefill": L,
                   "flash_decode_hs": 0 if kv_quant == "int8" else L * steps,
                   "flash_decode_int8_hs": L * steps if kv_quant == "int8"
                   else 0}
    problems = []
    if line["launches"] != want_launch:
        problems.append(f"launches {line['launches']} != {want_launch}")
    del cb
    torch.cuda.empty_cache()

    eng = GenerationEngine(cfg, model, greedy, bucket=512 + C - 1,
                           step_bucket=2048, device="cuda",
                           kv_quant=kv_quant)
    for name, tree in adapters.items():
        eng.register_adapter(name, tree, alpha=32.0, use_rslora=True)
    # left pads as the pool's (cfg.pad_token_id), so the prompts are the
    # same ids
    batch, mask = pp.left_pad_batch(prompts, cfg.pad_token_id,
                                    cfg.speech_pad_token)
    ref = eng.generate(batch, mask, max(budgets), adapter=rows)
    del eng
    torch.cuda.empty_cache()
    same = []
    for i, s in enumerate(slots):
        g, b = got[s], budgets[i]
        ok = (g.steps == b and g.base == ref.base and np.array_equal(
            g.tokens[0, g.base:g.base + b], ref.tokens[i, ref.base:ref.base
                                                       + b]))
        same.append(bool(ok))
    line["rows_identical"] = same
    if not all(same):
        problems.append(f"burst {kv_quant}: rows != static engine: {same}")
    line["problems"] = problems
    return line, snap


def _flip_report(eng, prompt, seed, adapter, step, chan, tok_a, tok_b):
    """The logits of the isolated engine at ``step`` of one request: the
    gap between the two tokens that differ on channel ``chan``."""
    import numpy as np
    import torch
    ids = prompt[None]
    mask = np.ones((1, len(prompt)), np.int64)
    st, base, _, _, gen, *_rest, ad = eng._start(ids, mask, max(step, 1),
                                                 seed, adapter)
    eng.run(st, base, step, gen, ad)
    t, s = eng.model.logits_all(st.hidden_last)
    row = t[0, 0] if chan == 0 else s[0, 0, chan - 1]
    return {"step": step, "channel": chan, "pool_token": int(tok_a),
            "isolated_token": int(tok_b),
            "logit_gap": float(row[tok_b] - row[tok_a])}


def staggered_check(pipe, adapters32, prompts):
    """fp32 weights and cache, TF32 off, at full width: requests join the
    pool at three segment boundaries (mixed adapters), one greedy pool and
    one sampled pool; each row against its isolated batch-1 generate
    (same seed, adapter and capacity). On a flip: the row, the step and
    the logit gap there."""
    import numpy as np
    import torch
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    cfg = LMConfig.from_dict({**pipe.engine.cfg.to_dict(),
                              "dtype": "float32", "param_dtype": "float32"})
    model = AsteroidLM.init_random(cfg, seed=1, device="cuda",
                                   dtype=torch.float32)
    C = cfg.channels
    budgets = [64, 48, 56, 40]
    rows = [None, "v1", "v2", "v1"]
    seeds = [11, 12, 13, 14]
    line, problems = {"budgets": budgets, "adapters": rows}, []
    for mode, sampling in (("greedy", _greedy(C)), ("sampled",
                                                    pipe.engine.sampling)):
        cb = _make_pool(cfg, model, sampling, "none", adapters32)
        slots = cb.submit_many([(prompts[0], budgets[0], seeds[0], rows[0]),
                                (prompts[1], budgets[1], seeds[1], rows[1])])
        cb.run(25)
        slots.append(cb.submit(prompts[2], budgets[2], seeds[2], rows[2]))
        cb.run(25)
        slots.append(cb.submit(prompts[3], budgets[3], seeds[3], rows[3]))
        _run_to_end(cb, 4)
        got = [cb.collect(s) for s in slots]
        del cb
        torch.cuda.empty_cache()
        eng = GenerationEngine(cfg, model, sampling, bucket=512 + C - 1,
                               step_bucket=2048, device="cuda")
        for name, tree in adapters32.items():
            eng.register_adapter(name, tree, alpha=32.0, use_rslora=True)
        res = []
        for i, g in enumerate(got):
            p = prompts[i]
            ref = eng.generate(p[None], np.ones((1, len(p)), np.int64),
                               budgets[i], seed=seeds[i], adapter=rows[i])
            a = g.tokens[0, g.base:]
            b = ref.tokens[0, ref.base:]
            ok = g.steps == ref.steps and np.array_equal(a, b)
            res.append(bool(ok))
            if not ok:
                n = min(len(a), len(b))
                diff = np.argwhere(a[:n] != b[:n])
                if len(diff):
                    s, ch = (int(x) for x in diff[0])
                    rep = _flip_report(eng, p, seeds[i], rows[i], s, ch,
                                       a[s, ch], b[s, ch])
                else:
                    rep = {"steps": [g.steps, ref.steps]}
                problems.append({"mode": mode, "row": i, **rep})
        line[mode] = res
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    line["problems"] = problems
    return line


def _launches_per_step(cb, steps):
    """(kernel events, launch API calls) a pool step over ``steps`` steps,
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = cb.run(steps)
        torch.cuda.synchronize()
    kern = launch = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern += e.count
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launch += e.count
    return kern / max(n, 1), launch / max(n, 1)


def throughput_run(pipe, adapters, prompts):
    """The serving geometry under the pipeline's sampled config (top-k 50,
    top-p 0.95, T 0.9 on every channel), int8 KV, eight requests of 128
    steps in one burst (three base, five voiced): pool steps/s and frames/s
    at B 8, host syncs a step (sync debug mode), launches a step
    (torch.profiler: kernel events and launch API calls), the per-row
    draws a step, peak memory; then admission prefill ms and flash_prefill
    launches per burst size (counted in the timed admission alone), and
    the launches a step of eight base-model rows with the voices still
    registered (no adapter work then)."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.ops import sampling as sam
    cfg, model = pipe.engine.cfg, pipe.engine.model
    rows = [None, None, None, "v1", "v1", "v1", "v2", "v2"]
    cb = _make_pool(cfg, model, pipe.engine.sampling, "int8", adapters)
    line = {"batch": 8, "steps_per_request": 128, "kv_quant": "int8",
            "sampling": "top_k 50, top_p 0.95, T 0.9"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.submit_many([(p, 128, i, a) for i, (p, a) in
                    enumerate(zip(prompts, rows))])
    cb.run(cfg.channels)                          # past the TF window
    torch.cuda.synchronize()
    draws0 = sam.categorical.row_draws
    t0 = time.perf_counter()
    ran = cb.run(64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line["pool_steps_per_s"] = ran / wall
    line["frames_per_s"] = 8 * ran / wall
    line["row_draws_per_step"] = (sam.categorical.row_draws - draws0) / ran
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            n = cb.run(8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    line["host_syncs_per_step"] = sum(
        "synchroniz" in str(x.message) for x in w) / max(n, 1)
    (line["kernel_events_per_step"],
     line["launch_calls_per_step"]) = _launches_per_step(cb, 8)
    _run_to_end(cb, 8)
    line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    line["estimate_gib"] = memory_estimate_gib(cfg, 8, 2048, 512,
                                               cache_bytes=1)
    for s, _ in cb.poll():
        cb.collect(s)
    prefill_ms, prefill_launches = {}, {}
    for K in (1, 2, 4, 8):
        for _ in range(2):              # the second is timed and counted
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            slots = cb.submit_many([(p, 16, 0, None) for p in prompts[:K]])
            torch.cuda.synchronize()
            prefill_ms[str(K)] = (time.perf_counter() - t0) * 1e3
            prefill_launches[str(K)] = fa.launch_counts()["flash_prefill"]
            for s in slots:
                cb.release(s)
    line["admission_prefill_ms"] = prefill_ms
    line["admission_prefill_launches"] = prefill_launches
    cb.submit_many([(p, 64, i, None) for i, p in enumerate(prompts)])
    cb.run(cfg.channels)
    (line["base_rows_kernel_events_per_step"],
     line["base_rows_launch_calls_per_step"]) = _launches_per_step(cb, 8)
    del cb
    torch.cuda.empty_cache()
    return line


def pool_phase(pipe):
    """The continuous pool at the server's default geometry (8 slots, base
    512, max_steps 2048: a 2560-slot cache), full width: the exact burst
    check with int8 KV (B3) and with the bf16 cache (B2), the fp32
    staggered check, the throughput line. Returns the line (with the
    shapes, launches and snapshot the kernel rows need)."""
    import torch
    cfg = pipe.engine.cfg
    adapters = {"v1": pool_adapter(cfg, 1), "v2": pool_adapter(cfg, 2)}
    prompts = pool_prompts(pipe, 8)
    C = cfg.channels
    line = {"phase": "pool", "slots": 8, "base": 512, "max_steps": 2048,
            "adapter_rank": 16, "adapter_targets": 7}
    problems = []
    t0 = time.perf_counter()
    b8, snap = burst_check(pipe, adapters, prompts, "int8")
    b16, _ = burst_check(pipe, adapters, prompts, "none")
    line["burst_int8"], line["burst_bf16"] = b8, b16
    problems += b8["problems"] + b16["problems"]
    line["burst_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = staggered_check(pipe, adapters, prompts)
    line["staggered_fp32"] = st
    problems += [f"staggered fp32 flip: {p}" for p in st["problems"]]
    line["staggered_s"] = time.perf_counter() - t0
    line["throughput"] = throughput_run(pipe, adapters, prompts)
    torch.cuda.synchronize()
    adm = line["throughput"]["admission_prefill_launches"]
    if any(n != cfg.num_hidden_layers for n in adm.values()):
        problems.append(f"admission prefill launches {adm}: one a layer")
    pads = [512 + C - 1 - len(p) for p in prompts]
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"pool phase failed: {problems}")
    return {**line, "prefill_pads": pads, "snapshot": snap,
            "layers": cfg.num_hidden_layers}



def pool_decode_times(gen, valid, ext, kind, SETS, H=16, Hkv=8):
    """flash_decode_hs (kind "bf16") or flash_decode_int8_hs ("int8") at the
    pool's (8, 2560) with its (B,) int32 extent and ring-addressed valid
    bits, over a SETS-layer stack read through the layer index (as the
    path reads it): kernel, plain and library ms (SDPA over the slots below
    the longest extent; for int8 no PyTorch call attends over the cache,
    so library_ms is null and dequant_sdpa_ms is the reference point), the
    check against the plain version, the bytes and flops of the valid
    slots below each row's extent."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.ops import flash_attention as fa
    B, S = valid.shape
    D = 128
    bf = torch.bfloat16
    scale = D ** -0.5
    q = _rand(gen, (B, 1, H, D), bf)
    shape = (SETS, B, Hkv, S, D)
    if kind == "int8":
        kq, ks = _int8_kv(gen, shape)
        vq, vs = _int8_kv(gen, shape)
        cache = (kq, ks, vq, vs)
        kernel, plain = fa.flash_decode_int8_hs, fa.flash_decode_int8_hs_plain
    else:
        cache = (_rand(gen, shape, bf), _rand(gen, shape, bf))
        kernel, plain = fa.flash_decode_hs, fa.flash_decode_hs_plain
    iota = torch.arange(S, device="cuda")
    below = valid & (iota[None, :] < ext[:, None].long())
    nv = int(below.sum())
    emax = int(ext.max())
    mask = below[:, None, None, :emax]
    qh = q.transpose(1, 2)
    per = 1 if kind == "int8" else 2
    nbytes = (2 * Hkv * D * per * nv + (2 * Hkv * 4 * nv if kind == "int8"
                                        else 0)
              + 2 * 2 * q.numel() + int(ext.long().sum()) + 4 * B)
    flops = 4 * D * H * nv

    def lib(i):
        l = i % SETS
        if kind == "int8":
            k = cache[0][l][:, :, :emax].to(bf) * cache[1][l][
                :, :, :emax, None].to(bf)
            v = cache[2][l][:, :, :emax].to(bf) * cache[3][l][
                :, :, :emax, None].to(bf)
        else:
            k, v = cache[0][l][:, :, :emax], cache[1][l][:, :, :emax]
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    out = kernel(q, *cache, valid, scale, extent=ext, layer=0)
    ref = plain(q, *cache, valid, scale, extent=ext, layer=0,
                out_dtype=torch.float32, p_dtype=bf)
    check = compare(out, ref)
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    res = {"shape": [B, S, H, Hkv, D], "extent_max": emax,
           "extent": [int(x) for x in ext.tolist()], "valid_slots": nv,
           "n_split": n_split, "chunk": chunk, "blocks": B * Hkv * n_split,
           "max_abs_err": check["max_abs_err"],
           "tolerance": check["tolerance"], "pass": check["ok"],
           "ms": cuda_ms(lambda i: kernel(q, *cache, valid, scale,
                                          extent=ext, layer=i % SETS),
                         2 * SETS),
           "plain_ms": cuda_ms(lambda i: plain(
               q, *cache, valid, scale, extent=ext, layer=i % SETS,
               p_dtype=bf), SETS),
           "bytes": nbytes, "flops": flops, **_bound(nbytes, flops)}
    lib_ms = cuda_ms(lib, 2 * SETS)
    if kind == "int8":
        res.update(library_ms=None, dequant_sdpa_ms=lib_ms)
    else:
        res["library_ms"] = lib_ms
    del cache
    torch.cuda.empty_cache()
    return res


def pool_kernel_rows(pool, checks_ok, SETS):
    """The pool's shapes for the kernels line: flash_prefill at the burst
    admission (8, 512) and a lone join (1, 512) with the prompts' left
    pads; both decodes at (8, 2560), at the extents the pool reached
    half-way through the int8 burst (four rows live, four frozen) and at
    the full extent (a full ring, every row live)."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(7)
    H, Hkv, D = 16, 8, 128
    pads = pool["prefill_pads"]
    out = {"flash_prefill": {}, "flash_decode_hs": {},
           "flash_decode_int8_hs": {}}
    # the burst's (8, 512) prefill ran in the int8 burst check, a lone
    # join's (1, 512) in the throughput run's timed Kb-1 admission
    launches = {8: pool["burst_int8"]["launches"]["flash_prefill"],
                1: pool["throughput"]["admission_prefill_launches"]["1"]}
    for B in (8, 1):
        pd = pads[:B]
        t = prefill_times(gen, B, 512, pd, H, Hkv, D, SETS)
        chk = prefill_case(gen, f"pool_B{B}", B, 512, H, Hkv, D,
                           torch.bfloat16, pd)
        out["flash_prefill"][f"pool_B{B}_T512"] = {
            "shape": [B, 512, H, Hkv, D], "left_pad": pd,
            "launches": launches[B],
            "max_abs_err": chk["max_abs_err"], "pass": chk["ok"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bytes": t["bytes"],
            "flops": t["flops"]}
        checks_ok.append(chk["ok"])
    valid, ext = pool["snapshot"]
    S = valid.shape[1]
    full_valid = torch.zeros_like(valid)
    for b, p in enumerate(pads):
        full_valid[b, p:] = True
    full_ext = torch.full_like(ext, S)
    for kind, name, burst in (("bf16", "flash_decode_hs", "burst_bf16"),
                              ("int8", "flash_decode_int8_hs",
                               "burst_int8")):
        for tag, v, e in (("reached", valid, ext),
                          ("full", full_valid, full_ext)):
            r = pool_decode_times(gen, v, e, kind, SETS)
            r["launches"] = pool[burst]["launches"][name]
            out[name][f"pool_B8_S{S}_{tag}"] = r
            checks_ok.append(r["pass"])
    return out


def continuous_server_part(pipe):
    """SpeechServer(scheduler="continuous") over the same pipeline on
    127.0.0.1: 8 slots, base 512, max_steps 128 (a 640-slot cache, so the
    auto KV policy picks int8, and an over-budget request stays cheap),
    segments of 25, one LoRA voice "narrator". Five wav requests arriving
    0.3 s apart, two streamed requests at once (both decode in the pool
    together), one request naming the voice, one over-budget request routed
    to the overflow worker; /v1/models lists the voice, an unknown voice
    is a 400. Reports latency p50 / p95, stream TTFA p50, joins, segments,
    routed-overflow and the launch counts of the part."""
    import http.client
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.serve.api_client import wav_bytes_to_array
    from moss_ttsd_torch.serve.server import SpeechServer
    from moss_ttsd_torch.utils.profiling import metrics

    eng = pipe.engine
    srv = SpeechServer(pipe, "127.0.0.1", 0, max_batch=8,
                       scheduler="continuous", pool_base=512,
                       pool_max_steps=128, segment_steps=25,
                       lora_adapters={"narrator": pool_adapter(eng.cfg, 3)})
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    worker = srv.worker
    problems = []
    line = {"phase": "server_continuous", "slots": 8, "pool_base": 512,
            "pool_max_steps": 128, "segment_steps": 25,
            "pool_kv_quant": worker.cb.cfg.kv_quant}
    # the most streams decoding in one segment, seen from the worker
    seen = {"streams": 0}
    orig_service = worker._service

    def service():
        live = sum(r.stream_q is not None for r in worker._live.values())
        seen["streams"] = max(seen["streams"], live)
        return orig_service()

    worker._service = service

    def post(payload):
        req = urllib.request.Request(f"{base}/v1/audio/speech",
                                     json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    def stream(payload, out, i):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        conn.request("POST", "/v1/audio/speech", json.dumps(
            {**payload, "stream": True}), {"Content-Type":
                                           "application/json"})
        r = conn.getresponse()
        out[i] = (r.status, r.read())
        conn.close()

    texts = [it["text"] for it in load_items()] + list(POOL_TEXTS)
    try:
        line["voices"] = json.loads(urllib.request.urlopen(
            f"{base}/v1/models", timeout=60).read())["data"][0]["voices"]
        if line["voices"] != ["narrator"]:
            problems.append(f"/v1/models voices {line['voices']}")
        try:
            post({"input": texts[0], "max_tokens": 8, "voice": "nobody"})
            problems.append("an unknown voice was served")
        except urllib.error.HTTPError as e:
            line["unknown_voice_status"] = e.code
            if e.code != 400:
                problems.append(f"unknown voice: HTTP {e.code}")
        srv.warmup(max_tokens=16)
        torch.cuda.synchronize()
        metrics.reset()
        fa.reset_launch_counts()
        bodies, streams = [None] * 7, [None] * 2
        jobs = []
        for i in range(5):
            jobs.append(threading.Thread(target=lambda i=i: bodies.__setitem__(
                i, post({"input": texts[i], "max_tokens": 64 + 16 * i,
                         "seed": i}))))
        jobs.append(threading.Thread(target=lambda: bodies.__setitem__(
            5, post({"input": texts[5], "max_tokens": 96, "seed": 5,
                     "voice": "narrator"}))))
        jobs.append(threading.Thread(target=lambda: bodies.__setitem__(
            6, post({"input": texts[6], "max_tokens": 136, "seed": 6}))))
        for i in range(2):
            jobs.append(threading.Thread(target=stream, args=(
                {"input": texts[i], "max_tokens": 96, "seed": 10 + i},
                streams, i)))
        t0 = time.perf_counter()
        # the streams and the overflow request first, then the wav
        # requests 0.3 s apart
        order = [7, 8, 6, 0, 1, 2, 3, 4, 5]
        for n, j in enumerate(order):
            jobs[j].start()
            if n >= 3:
                time.sleep(0.3)
        for j in jobs:
            j.join()
        line["wall_s"] = time.perf_counter() - t0
        line["launches"] = fa.launch_counts()
        for i, b in enumerate(bodies):
            w = wav_bytes_to_array(b)[0] if b else np.zeros(0)
            if not (len(w) and np.isfinite(w).all()):
                problems.append(f"request {i} gave no audio")
        line["wav_samples"] = [len(wav_bytes_to_array(b)[0]) if b else 0
                               for b in bodies]
        line["stream_bytes"] = [len(s[1]) if s else 0 for s in streams]
        if not all(s and s[0] == 200 and len(s[1]) > 0 for s in streams):
            problems.append(f"streams: {[s and s[0] for s in streams]}")
        line["streams_in_pool_at_once"] = seen["streams"]
        if seen["streams"] < 2:
            problems.append("the two streams never decoded in one segment")
        m = json.loads(urllib.request.urlopen(f"{base}/v1/metrics",
                                              timeout=60).read())
        line["metrics"] = {k: m.get(k) for k in (
            "server_request_latency_s_p50", "server_request_latency_s_p95",
            "server_request_latency_s_observed", "server_ttfa_s_p50",
            "server_ttfa_s_observed", "server_continuous_joins",
            "server_continuous_segments", "server_routed_overflow",
            "server_streamed", "server_pool_active_slots")}
        mm = line["metrics"]
        if not (mm["server_routed_overflow"] == 1
                and mm["server_streamed"] == 2
                and mm["server_continuous_joins"] == 8
                and mm["server_request_latency_s_observed"] == 7
                and mm["server_ttfa_s_observed"] == 2):
            problems.append(f"metrics: {mm}")
        lc = line["launches"]
        if not (lc["flash_prefill"] > 0 and lc["flash_decode_int8_hs"] > 0
                and lc["flash_decode_hs"] > 0):
            problems.append(f"launches {lc}: B1, B3 (pool) and B2 "
                            "(overflow) must all run")
    finally:
        srv.stop()
        worker._service = orig_service
    torch.cuda.synchronize()
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"continuous server failed: {problems}")
    return line


# ---------------------------------------------------------------------------
# phase 11: LM finetuning at the full width, and the trained voice served
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_T = 2048
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")


def train_batch(seed: int = 0):
    """Two synthetic examples as ``build_training_example`` lays them out
    (style and text rows masked, random audio codes and the EOS
    supervised), written as one shard, read back through
    ``TrainingDataset`` (the delay shift) and collated to T 2048, as K 2
    micro batches of one row. Returns (batch, masked rows per example)."""
    import numpy as np
    from moss_ttsd_torch.train.data import (TrainingDataset,
                                            build_training_example, collate)
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    tok = MockTokenizer()
    g = np.random.default_rng(seed)
    data_dir = os.path.join(TRAIN_DIR, "data")
    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)
    flat, masked = {}, []
    for i, (text, short) in enumerate((
            ("[S1]Welcome back.[S2]Thanks.", 0),
            ("[S1]Hello.[S2]Hi there.", TRAIN_T // 8))):     # a padded row
        rows = len(build_training_example(tok, text, np.zeros((0, 8)))[0])
        codes = g.integers(0, 1024, (TRAIN_T - 7 - rows - short, 8))
        ids, labels = build_training_example(tok, text, codes)
        flat[f"input_ids_{i}"], flat[f"labels_{i}"] = ids, labels
        masked.append(int((labels[:, 0] == -100).sum()))
    np.savez(os.path.join(data_dir, "processed_data_00000.npz"), **flat)
    ds = TrainingDataset(data_dir, 8, tok.pad_token_id, 1024, seed=seed)
    batch = collate([ds[0], ds[1]], tok.pad_token_id, max_length=TRAIN_T,
                    pad_token=1024, pad_to_multiple=64)
    return {k: v.reshape((2, 1) + v.shape[1:]) for k, v in batch.items()}, \
        masked


def _train_steps(state, step_fn, batch, steps, after=None):
    """``steps`` optimizer steps; the host clock of each ends in a sync.
    ``after(n, state)`` runs after step n (1-based)."""
    import torch
    losses, norms, times = [], [], []
    for n in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        if after is not None:
            after(n, state)
    return state, losses, norms, times


def profile_train_step(run, state, step_fn, batch):
    """torch.profiler over one more optimizer step (``run`` names it):
    device busy ms (the sum of kernel times, one stream), the idle share of
    the step's wall time, kernel launches and the kernels that take the
    most device time, emitted as a ``profile`` line and returned. Profiler
    overhead inflates the host time, so the idle share is an upper
    bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, host_ops = [], 0
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0))
        # a user annotation (``Optimizer.step#AdamW.step``) spans kernels
        # already counted
        if (t > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kern.append((e.key, t, e.count))
    host_ops = sum(1 for e in prof.events()
                   if e.name.startswith("aten::") and (
                       e.cpu_parent is None
                       or not e.cpu_parent.name.startswith("aten::")))
    busy_us = sum(t for _, t, _ in kern)
    kern.sort(key=lambda x: -x[1])
    line = {"phase": "profile", "run": run, "step_s": wall,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / (wall * 1e6),
            "kernel_launches": sum(c for _, _, c in kern),
            "top_level_aten_ops": host_ops,
            "top": [{"kernel": k[:80], "ms": t / 1e3, "calls": c}
                    for k, t, c in kern[:12]]}
    emit(line)
    return line


def _train_numbers(losses, norms, times, sup_tokens, tokens, n_params,
                   peak):
    import math
    step_s = sorted(times[1:])[len(times[1:]) // 2]      # median past step 1
    problems = []
    if not all(math.isfinite(x) for x in losses + norms):
        problems.append(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "first_step_s": times[0], "s_per_step": step_s,
            "supervised_tokens_per_s": sup_tokens / step_s,
            "tokens_per_s": tokens / step_s,
            "six_n_tokens_per_step_s_over_989e12":
                6 * n_params * tokens / step_s / PEAK_BF16_FLOPS,
            "peak_mem_gib": peak / 2 ** 30}, problems


def _params_gap(a, b, lr):
    """The largest gaps between two state dicts after a few Adam steps
    (fp32), and whether they pass: within rel 1e-4 (atol 1e-6) but for at
    most max(4, n/1000) elements of a tensor, and those within one update
    (lr): Adam divides each gradient element by its own magnitude, so an
    element whose gradient sits within rounding of zero (|g| near eps
    1e-8) takes a step that reassociation changes."""
    worst_abs = worst_rel = 0.0
    outside_max, ok = 0, True
    for k, x in a.items():
        x, y = x.detach().float().cpu(), b[k].detach().float().cpu()
        err = (x - y).abs()
        rel = err / (y.abs() + 1e-6)
        outside = int((err > 1e-4 * y.abs() + 1e-6).sum())
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float(rel.max()))
        outside_max = max(outside_max, outside)
        ok = ok and outside <= max(4, x.numel() // 1000) \
            and float(err.max()) <= lr
    return {"max_abs_gap": worst_abs, "max_rel_gap": worst_rel,
            "most_elements_outside_rel_1e-4": outside_max, "ok": ok}


def train_reference():
    """A tiny fp32 model (the --tiny geometry) takes 3 full steps (cosine
    with a warmup step, weight decay, K 2 accumulation, remat) and 3
    layerwise LoRA steps on the card and on the CPU, TF32 off: the losses
    and every parameter must agree."""
    import dataclasses
    import numpy as np
    import torch
    from moss_ttsd_torch.cli.inference import tiny_lm_config
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.train import lora as tl
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step)
    cfg = tiny_lm_config()
    lcfg = dataclasses.replace(cfg, lora_rank=4, lora_alpha=8.0)
    g = np.random.default_rng(1)
    B, T = 4, 40
    ids = g.integers(0, cfg.speech_vocab_size, (B, T, cfg.channels))
    ids[..., 0] = g.integers(0, cfg.vocab_size, (B, T))
    labels = ids.copy()
    for b in range(B):
        labels[b, : 5 + 3 * b] = -100
    mask = np.ones((B, T), np.int64)
    mask[3, T - 6:] = 0
    batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in
             (("input_ids", ids), ("labels", labels),
              ("attention_mask", mask))}
    lr = 1e-3
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = make_optimizer(learning_rate=lr, warmup_ratio=0.1,
                             total_steps=10, weight_decay=0.01)
        model = AsteroidLM.init_random(cfg, seed=0, device="cpu").to(dev)
        state = init_train_state(cfg, opt, model=model)
        step = make_train_step(cfg, opt, remat=True, ce_chunks=2,
                               grad_accum_steps=2)
        full = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
        lmodel = tl.graft_lora_params(
            AsteroidLM.init_random(cfg, seed=0, device="cpu"), lcfg,
            seed=1).to(dev)
        lstate = tl.init_lora_state(lmodel, opt)
        lstep = tl.make_layerwise_lora_step(lcfg, opt, remat=True,
                                            ce_chunks=2, grad_accum_steps=2)
        lora = [float(lstep(lstate, batch)[1]["loss"]) for _ in range(3)]
        runs[dev] = (full, model.state_dict(), lora, lmodel.state_dict())
    (fc, mc, lc, lmc), (fg, mg, lg, lmg) = runs["cpu"], runs["cuda"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(fg + lg, fc + lc))
    full_gap = _params_gap(mg, mc, lr)
    lora_gap = _params_gap(lmg, lmc, lr)
    ok = loss_gap <= 1e-4 and full_gap["ok"] and lora_gap["ok"]
    return {"losses_cpu": fc + lc, "losses_cuda": fg + lg,
            "loss_max_rel_gap": loss_gap, "full_params": full_gap,
            "lora_params": lora_gap, "tol": "loss rel 1e-4; params rel 1e-4 "
            "(atol 1e-6) but max(4, n/1000) elements within lr",
            "ok": ok}


def serve_back(base, lcfg, factors, steps: int = 64):
    """The trained factors, exported in the JAX layout (``save_pytree`` of
    ``lm_state_to_jax``) and read back (``load_pytree``), register as a
    voice of the main-path pipeline (a bf16 serving copy of the same fp32
    base, the full-width codec): ``process_batch`` over
    examples_only_text.jsonl with item 0 voiced, ``steps`` decode steps,
    launch counts from that run alone."""
    import torch
    from moss_ttsd_torch.core.checkpoint import load_pytree, save_pytree
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             CodecConfig, LMConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.convert_jax import lm_state_to_jax
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    path = os.path.join(TRAIN_DIR, "lora_factors.npz")
    save_pytree(path, lm_state_to_jax(factors, lcfg))
    tree = load_pytree(path)
    cfg = LMConfig()
    cfg = LMConfig.from_dict({**cfg.to_dict(),
                              "speech_token_range": [0, cfg.vocab_size]})
    sampling = SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=True, temperature=0.9,
                                        top_k=50, top_p=0.95)
                  for _ in range(cfg.channels)], max_new_tokens=steps)
    spt = XYTokenizer.init_random(CodecConfig(), seed=0, dtype="bfloat16",
                                  device="cuda")
    pipe = TTSPipeline(MockTokenizer(), cfg, base, spt, sampling,
                       bucket=128, device="cuda")
    pipe.engine.register_adapter("trained", tree, alpha=lcfg.lora_alpha,
                                 use_rslora=lcfg.lora_rslora)
    items = load_items()
    items[0] = {**items[0], "voice": "trained"}
    voices = [it.get("voice") for it in items]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    texts, audio = pipe.process_batch(items, max_new_tokens=steps, seed=0,
                                      adapter=voices)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    st = dict(pipe.engine.last_stats)
    L = cfg.num_hidden_layers
    problems, wav_lens, _ = audio_problems(texts, audio, st["steps"],
                                           cfg.channels)
    problems += _launch_problems(counts, L, 1, st["steps"])
    if st["steps"] != steps:
        problems.append(f"decode ran {st['steps']} of {steps} steps")
    a_q = pipe.engine.lora.stacks["q_proj"][0]
    if tuple(a_q.shape) != (L, 2, cfg.hidden_size, lcfg.lora_rank):
        problems.append(f"registry stack shape {tuple(a_q.shape)}")
    del pipe, spt
    return {"voices": voices, "steps": st["steps"], "e2e_s": e2e_s,
            "wav_samples": wav_lens, "launches": counts,
            "registered_stacks": sorted(tree["params"]["layers"]["block"]),
            "problems": problems}


def train_phase(card: str, profile: bool = False):
    """Full finetuning and layerwise LoRA at the full MOSS-TTSD-v0.5 width
    (LMConfig(): fp32 masters, bf16 compute, remat, ce_chunks 8), 6 steps
    each at a constant 1e-4 on one batch (B 2, T 2048, K 2 micro batches of
    one row); the trained voice served back through the main path; the
    tiny card-vs-CPU reference. ``card``: nvidia-smi's name and power
    limit, printed beside the times; ``profile``: one more step of each
    under torch.profiler (``profile`` lines)."""
    import dataclasses
    import torch
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.ops.chunked_ce import valid_label_counts
    from moss_ttsd_torch.train import lora as tl
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step, to_device)
    problems = []
    cfg = LMConfig()
    np_batch, masked = train_batch()
    batch = to_device(np_batch, torch.device("cuda"))
    sup = int(valid_label_counts(batch["labels"])[0])
    tokens = int(batch["attention_mask"].sum())
    opt = make_optimizer(learning_rate=1e-4, lr_scheduler_type="constant",
                         total_steps=TRAIN_STEPS)
    geometry = {"layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
                "vocab": cfg.vocab_size, "batch": 2, "micro_batch": 1,
                "grad_accum": 2, "T": int(batch["labels"].shape[2]),
                "masked_rows": masked, "tokens": tokens,
                "supervised_tokens_ch0": sup, "dtype": cfg.dtype,
                "param_dtype": "float32", "remat": True, "ce_chunks": 8}

    # full finetune
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    model = AsteroidLM.init_random(cfg, seed=0, device="cuda",
                                   dtype=torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(cfg, opt, model=model)
    step = make_train_step(cfg, opt, remat=True, ce_chunks=8,
                           grad_accum_steps=2)
    state, losses, norms, times = _train_steps(state, step, batch,
                                               TRAIN_STEPS)
    full, p = _train_numbers(losses, norms, times, sup, tokens, n_params,
                             torch.cuda.max_memory_allocated())
    problems += [f"full: {x}" for x in p]
    full["library_launches"] = fa.launch_counts()
    if any(full["library_launches"].values()):
        problems.append("the training step ran a serving kernel")
    if profile:
        profile_train_step("train_full", state, step, batch)
    del state, model, step
    _release()

    # layerwise LoRA over the same base
    torch.cuda.reset_peak_memory_stats()
    base = AsteroidLM.init_random(cfg, seed=0, device="cuda",
                                  dtype=torch.float32)
    lcfg = dataclasses.replace(cfg, lora_rank=16, lora_alpha=32.0,
                               lora_rslora=True)
    lmodel = tl.graft_lora_params(base, lcfg, seed=1)
    lstate = tl.init_lora_state(lmodel, opt)
    lstep = tl.make_layerwise_lora_step(lcfg, opt, remat=True, ce_chunks=8,
                                        grad_accum_steps=2)
    b_after_2 = {}

    def after(n, st):
        if n == 2:
            b_after_2["max_abs"] = max(
                float(v.detach().abs().max()) for k, v in st.params.items()
                if k.endswith("lora_b"))

    lstate, losses, norms, times = _train_steps(lstate, lstep, batch,
                                                TRAIN_STEPS, after)
    # 6 N tokens with the model's N, as for the full step (a LoRA step
    # does about 4 N tokens: no weight gradients but the factors')
    lora, p = _train_numbers(losses, norms, times, sup, tokens, n_params,
                             torch.cuda.max_memory_allocated())
    problems += [f"lora: {x}" for x in p]
    base_sd = base.state_dict()
    lora["trainable_params"] = sum(v.numel() for v in lstate.params.values())
    lora["base_bitwise_unchanged"] = all(
        torch.equal(v, base_sd[k]) for k, v in lmodel.state_dict().items()
        if "lora_" not in k)
    lora["lora_b_max_abs_after_step_2"] = b_after_2["max_abs"]
    if not lora["base_bitwise_unchanged"]:
        problems.append("lora: the base weights changed")
    if not b_after_2["max_abs"] > 0:
        problems.append("lora: lora_b is zero after step 2")
    if profile:
        profile_train_step("train_lora", lstate, lstep, batch)
    factors = {k: v.detach() for k, v in lstate.params.items()}
    del lstate, lmodel, lstep
    _release()

    served = serve_back(base, lcfg, factors)
    problems += [f"serve_back: {x}" for x in served.pop("problems")]
    del base
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    _release()
    reference = train_reference()
    if not reference["ok"]:
        problems.append("card vs CPU reference disagrees")
    line = {"phase": "train", "card": card,
            "params": n_params, **geometry, "full": full, "lora": lora,
            "serve_back": served, "reference": reference,
            "ok": not problems, "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"train phase failed: {problems}")
    return line


# ---------------------------------------------------------------------------
# phase 11b: codec training at the full XY-Tokenizer width
# ---------------------------------------------------------------------------

CODEC_TRAIN_STEPS = 6
CODEC_TRAIN_LENGTHS = (160000, 120000)      # 10 s and 7.5 s at 16 kHz
CODEC_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_codec_train")
PEAK_FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores


def codec_train_batch():
    """examples/*.wav read by the port's audio IO, mono at 16 kHz, one
    after another and tiled into two rows of 10 s; row 1 keeps 7.5 s and
    is zero-padded past them."""
    import glob
    import numpy as np
    from moss_ttsd_torch.utils.audio_io import read_wav, to_mono_16k
    audio = np.concatenate([to_mono_16k(*read_wav(p)) for p in
                            sorted(glob.glob(os.path.join(EXAMPLES,
                                                          "*.wav")))])
    n = CODEC_TRAIN_LENGTHS[0]
    wav = np.resize(audio.astype(np.float32), 2 * n).reshape(2, n).copy()
    wav[1, CODEC_TRAIN_LENGTHS[1]:] = 0.0
    return wav, np.array(CODEC_TRAIN_LENGTHS, np.int64)


def codec_train_reference():
    """The tiny codec's k-means bootstrap and 2 steps with every draw
    pinned (``tests/torch_codec_train_ref.pinned_run``), fp32 with TF32
    off, on the card and on the CPU: losses and grad norms within rel
    1e-5, the EMA state within 1e-5, the parameters by ``_params_gap``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_codec_train_ref as tref
    cpu, gpu = tref.pinned_run("cpu"), tref.pinned_run("cuda")
    metric_gap = max(float(np.max(np.abs(gpu[k] - cpu[k])
                                  / np.maximum(np.abs(cpu[k]), 1e-30)))
                     for k in ("loss", "wave_l1", "mel_l1", "grad_norm"))
    ema_gap = max(float(np.abs(gpu[k] - cpu[k]).max()) for k in (
        "cluster_size", "embed_avg", "param/quantizer.codebook"))
    params = _params_gap(
        {k: torch.from_numpy(v) for k, v in gpu.items()
         if k.startswith("param/") and k != "param/quantizer.codebook"},
        {k: torch.from_numpy(v) for k, v in cpu.items()}, tref.LR)
    return {"losses_cpu": cpu["loss"].tolist(),
            "losses_cuda": gpu["loss"].tolist(),
            "grad_norms_cpu": cpu["grad_norm"].tolist(),
            "grad_norms_cuda": gpu["grad_norm"].tolist(),
            "metric_max_rel_gap": metric_gap, "ema_max_abs_gap": ema_gap,
            "params": params,
            "tol": "metrics rel 1e-5; EMA state atol 1e-5; params rel 1e-4 "
                   "(atol 1e-6) but max(4, n/1000) elements within lr",
            "ok": metric_gap <= 1e-5 and ema_gap <= 1e-5 and params["ok"]}


def codec_train_phase(card: str):
    """Codec training at the full XY-Tokenizer width (``CodecConfig()``,
    524 M fp32 parameters, TF32 off): the reference-format ``.ckpt`` of
    random weights (``tests/torch_ref_codec.write_reference_codec``) loaded
    through ``convert_codec`` + ``codec_state_from_jax`` as a finetuning
    user loads the published one; one batch of 2 x 10 s (examples/*.wav,
    row 1 padded past 7.5 s); AdamW 1e-4 with the cosine schedule over 100
    steps; one k-means bootstrap, then ``CODEC_TRAIN_STEPS`` steps, one
    more under torch.profiler (launches, idle share) and one under
    ``FlopCounterMode`` (matmul and convolution FLOPs from the op shapes).
    Checks: finite losses and grad norms, grad_norm > 0, codebook_usage >
    0, the codebook and the semantic encoder's first weight moved,
    cluster_size sums above 0, no serving kernel launched. The trained
    codec goes out as the JAX tree (``codec_state_to_jax`` +
    ``save_pytree``), comes back through ``XYTokenizer.load_from_checkpoint``
    (its codes for one example equal the in-memory module's) and the codec
    round-trip CLI; then the tiny card-vs-CPU reference."""
    import math
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from moss_ttsd_torch.cli import codec_roundtrip as cli_codec
    from moss_ttsd_torch.core.checkpoint import save_pytree
    from moss_ttsd_torch.core.config import CodecConfig
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.train.codec_step import (init_codec_train_state,
                                                  kmeans_bootstrap,
                                                  make_codec_train_step)
    from moss_ttsd_torch.train.step import make_optimizer
    from moss_ttsd_torch.utils.convert_codec import convert_codec_checkpoint
    from moss_ttsd_torch.utils.convert_jax import (codec_state_from_jax,
                                                   codec_state_to_jax)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_ref_codec import write_reference_codec

    problems, line = [], {"phase": "codec_train", "card": card}
    shutil.rmtree(CODEC_TRAIN_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        yaml_path, ckpt = write_reference_codec(CODEC_TRAIN_DIR,
                                                CodecConfig(), seed=0)
        line["ckpt_write_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg = CodecConfig.from_yaml(yaml_path)
        sd = codec_state_from_jax(convert_codec_checkpoint(cfg, ckpt), cfg)
        opt = make_optimizer(learning_rate=1e-4, total_steps=100)
        state = init_codec_train_state(cfg, opt, params=sd, device="cuda")
        del sd
        torch.cuda.synchronize()
        line["ckpt_load_s"] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.params.values())
        np_wav, np_lens = codec_train_batch()
        batch = {"wav": torch.from_numpy(np_wav).cuda(),
                 "lengths": torch.from_numpy(np_lens).cuda()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        audio_s = float(np_lens.sum()) / cfg.input_sample_rate
        line.update(params=n_params, batch=2, samples=list(map(int, np_lens)),
                    audio_s_per_step=audio_s, dtype="float32", tf32=False,
                    lr="1e-4 cosine over 100 steps, 10 warmup")

        fa.reset_launch_counts()
        t0 = time.perf_counter()
        kmeans_bootstrap(cfg, state, batch["wav"], batch["lengths"], gen)
        torch.cuda.synchronize()
        line["kmeans_bootstrap_s"] = time.perf_counter() - t0
        cb0 = state.module.quantizer.codebook.detach().clone()
        enc = state.module.semantic_encoder.conv1.weight
        enc0 = enc.detach().clone()

        step = make_codec_train_step(cfg, opt)
        losses, norms, times, metrics = [], [], [], []
        for _ in range(CODEC_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            m = {k: float(v) for k, v in m.items()}
            metrics.append(m)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        s_step = sorted(times[1:])[len(times[1:]) // 2]
        line.update(losses=losses, grad_norms=norms, step_s=times,
                    metrics=metrics, first_step_s=times[0],
                    s_per_step=s_step,
                    codec_train_audio_sec_per_s=audio_s / s_step,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        prof = profile_train_step("codec_train", state,
                                  lambda st, b: step(st, b, gen), batch)
        line.update(launches_per_step=prof["kernel_launches"],
                    device_idle_share=prof["device_idle_share"],
                    device_busy_ms=prof["device_busy_ms"],
                    profiled_step_s=prof["step_s"])
        with FlopCounterMode(display=False) as fc:
            step(state, batch, gen)
        flops = fc.get_total_flops()
        line.update(flops_per_step=flops,
                    fp32_peak_share=flops / s_step / PEAK_FP32_FLOPS,
                    fp32_peak_flops=PEAK_FP32_FLOPS)
        line["library_launches"] = fa.launch_counts()
        if any(line["library_launches"].values()):
            problems.append("the codec train step ran a serving kernel")
        if not all(math.isfinite(x) for x in losses + norms):
            problems.append(f"non-finite loss or grad norm: {losses} {norms}")
        if not min(norms) > 0:
            problems.append(f"grad_norm not above 0: {norms}")
        if not all(m["codebook_usage"] > 0 for m in metrics):
            problems.append("codebook_usage 0")
        moved = {"codebook": float((state.module.quantizer.codebook.detach()
                                    - cb0).abs().max()),
                 "semantic_encoder.conv1.weight":
                     float((enc.detach() - enc0).abs().max())}
        line["moved_max_abs"] = moved
        if not all(v > 0 for v in moved.values()):
            problems.append(f"did not move: {moved}")
        line["cluster_size_sum"] = float(state.cluster_size.sum())
        if not line["cluster_size_sum"] > 0:
            problems.append("cluster_size sums to 0")

        # served back: the JAX tree, XYTokenizer.load_from_checkpoint, CLI
        sd = {k: v.detach() for k, v in state.module.state_dict().items()}
        del state, step, cb0, enc0
        _release()
        npz = os.path.join(CODEC_TRAIN_DIR, "codec_trained.npz")
        t0 = time.perf_counter()
        save_pytree(npz, codec_state_to_jax(sd, cfg))
        line["npz_write_s"] = time.perf_counter() - t0
        memory = XYTokenizer(cfg, sd)
        del sd
        one = [np_wav[0, :CODEC_TRAIN_LENGTHS[0]]]
        want = memory.encode(one)["codes_list"][0]
        del memory
        _release()
        t0 = time.perf_counter()
        loaded = XYTokenizer.load_from_checkpoint(yaml_path, npz)
        torch.cuda.synchronize()
        line["npz_load_s"] = time.perf_counter() - t0
        got = loaded.encode(one)["codes_list"][0]
        del loaded
        _release()
        same = got.shape == want.shape and bool(np.array_equal(got, want))
        line["served_back"] = {"codes_shape": list(got.shape),
                               "loaded_codes_eq_in_memory": same}
        if not same:
            problems.append("the loaded codec's codes differ from the "
                            "trained module's")
        out = os.path.join(CODEC_TRAIN_DIR, "recon")
        t0 = time.perf_counter()
        rc = cli_codec.main(["--input_dir", EXAMPLES, "--config", yaml_path,
                             "--checkpoint", npz, "--output_dir", out])
        wavs = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
        line["served_back"]["cli"] = {"rc": rc, "wavs": wavs,
                                      "seconds": time.perf_counter() - t0}
        if rc != 0 or wavs != ["voice_both_recon.wav", "voice_s1_recon.wav",
                               "voice_s2_recon.wav"]:
            problems.append(f"codec round-trip CLI: {rc} {wavs}")
        _release()
    finally:
        shutil.rmtree(CODEC_TRAIN_DIR, ignore_errors=True)
    reference = codec_train_reference()
    if not reference["ok"]:
        problems.append("card vs CPU codec training reference disagrees")
    line.update(reference=reference, ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"codec_train phase failed: {problems}")
    return line


def train_cli_check():
    """The finetune CLIs --tiny on the card: the workflow preprocesses a
    training JSONL over the examples' voices with the port's codec and
    trains (full, checkpointed at step 2); then, as two processes at once,
    --resume continues to step 4 and --lora writes lora_factors.npz and
    model_merged.npz."""
    out = os.path.join(ROOT, "build", "chip_smoke_finetune")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    voice = lambda n: os.path.join(EXAMPLES, n)
    items = [{"file_path": voice("voice_both.wav"),
              "full_transcript": "[S1]This is the first speaker reference "
                                 "voice.[S2]And this is the second speaker "
                                 "reference voice."},
             {"reference_audio": voice("voice_s1.wav"),
              "reference_text": "[S1]This is the first speaker reference "
                                "voice.",
              "audio": voice("voice_s2.wav"),
              "text": "[S2]And this is the second speaker reference voice."}]
    jsonl = os.path.join(out, "train.jsonl")
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(it) + "\n" for it in items)
    data = os.path.join(out, "processed")
    full = os.path.join(out, "full")
    with open(os.path.join(out, "train.yaml"), "w") as f:
        f.write("save_steps: 2\nlogging_steps: 1\n")
    with open(os.path.join(out, "wf.yaml"), "w") as f:
        f.write(f"data_preprocess:\n  jsonl: {jsonl}\n  output_dir: {data}\n"
                f"finetune:\n  output_dir: {full}\n  training_config: "
                f"{os.path.join(out, 'train.yaml')}\n  max_steps: 2\n")
    ft = [sys.executable, "-m", "moss_ttsd_torch.cli.finetune", "--tiny",
          "--data_dir", data]
    runs = [
        ("finetune_workflow",
         [sys.executable, "-m", "moss_ttsd_torch.cli.finetune_workflow",
          "--tiny", "--config", os.path.join(out, "wf.yaml")],
         full, ["model.npz", "checkpoints"]),
        ("finetune_resume", ft + ["--output_dir", full, "--max_steps", "4",
                                  "--save_steps", "2", "--resume"],
         full, ["model.npz", "checkpoints"]),
        ("finetune_lora", ft + ["--output_dir", os.path.join(out, "lora"),
                                "--lora", "--max_steps", "2"],
         os.path.join(out, "lora"), ["lora_factors.npz",
                                     "model_merged.npz"]),
    ]
    def check(results):
        for (name, cmd, out_dir, want), proc, seconds in results:
            files = (sorted(os.listdir(out_dir)) if os.path.isdir(out_dir)
                     else [])
            ok = proc.returncode == 0 and set(want) <= set(files)
            meta = {}
            if ok:
                with open(os.path.join(out_dir, "train_config.json")) as f:
                    meta = json.load(f)
            if name == "finetune_resume":
                ok = ok and "resumed from" in proc.stdout \
                    and meta["steps"] == 4 and sorted(os.listdir(
                        os.path.join(out_dir, "checkpoints"))) \
                    == ["step_2", "step_4"]
            if name == "finetune_workflow":
                with open(os.path.join(data,
                                       "processed_data_index.json")) as f:
                    ok = ok and json.load(f)["total"] == 2
            emit({"phase": "cli", "run": name, "flags": cmd[3:],
                  "rc": proc.returncode, "files": files,
                  "steps": meta.get("steps"), "seconds_since_start": seconds,
                  "ok": ok, "tail": proc.stdout.strip().splitlines()[-2:]})
            if not ok:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"tiny CLI run {name} failed")

    # the workflow writes the data both later runs read; those two run at
    # once
    check(_run_all(runs[:1]))
    check(_run_all(runs[1:]))
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: real checkpoints (the reference codec's yaml and .ckpt come
# from tests/torch_ref_codec.py, the writer the CPU tests use too)
# ---------------------------------------------------------------------------


LOAD_JSONS = ("lm_moss_ttsd_v0.5.json", "xy_codec_defaults.json")


def _rss_gib() -> float:
    """This process's resident set now, GiB (VmRSS: VmHWM is missing under
    some sandboxed kernels, and ru_maxrss carries a parent's peak across
    exec)."""
    with open("/proc/self/status") as f:
        for row in f:
            if row.startswith("VmRSS:"):
                return int(row.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


class _PeakRss:
    """The resident set's peak while the block runs, sampled every 2 ms by
    a thread."""

    def __enter__(self):
        import threading
        self.peak, self._stop = _rss_gib(), threading.Event()

        def sample():
            while not self._stop.is_set():
                self.peak = max(self.peak, _rss_gib())
                time.sleep(0.002)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gib())


# the host RSS a streamed LM load may add beyond the file's largest tensor
# (its buffer, then its cast copy before the move): the allocator's and
# the reader's own; the whole-file fp32 loader it replaced added 11 GiB
RSS_MARGIN_GIB = 0.5


def _largest_tensor_bytes(model_dir: str) -> int:
    """The largest tensor's bytes over the directory's safetensors files,
    from their headers."""
    import glob
    import struct
    most = 0
    for path in glob.glob(os.path.join(model_dir, "*.safetensors")):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        most = max([most] + [e - b for k, v in header.items()
                             if k != "__metadata__"
                             for b, e in [v["data_offsets"]]])
    return most


def rss_probe(model_dir: str) -> int:
    """One streamed LM load (``load_asteroid_checkpoint`` to the card in
    the compute dtype, as ``TTSPipeline.load`` loads) in this fresh
    process, for its host peak RSS. Prints one JSON line."""
    import torch
    from moss_ttsd_torch.core.config import LMConfig
    from moss_ttsd_torch.utils.convert_lm import load_asteroid_checkpoint
    cfg = LMConfig.from_hf_config_json(os.path.join(model_dir, "config.json"))
    torch.zeros(1, device="cuda")
    base = _rss_gib()
    t0 = time.perf_counter()
    with _PeakRss() as rss:
        state = load_asteroid_checkpoint(model_dir, cfg, dtype=torch.bfloat16,
                                         device="cuda")
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "baseline_rss_gib": base,
                      "peak_rss_gib": rss.peak, "tensors": len(state)}),
          flush=True)
    return 0


def _probe(model_dir: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--rss_probe", model_dir], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise SystemExit("the streamed load probe failed")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _tokens_run(pipe, items, steps):
    """timed_batch with the counted run's tokens (the last generate)."""
    seen = []
    _spy(pipe.engine, "generate", seen)
    texts, audio, e2e_s, counts, peak, st = timed_batch(pipe, items, steps)
    del pipe.engine.generate
    return seen[-1][1], texts, audio, e2e_s, counts, st


def load_phase(pipe, smi_line: str, steps: int = 128):
    """Real-checkpoint loading at the full width, from files this phase
    writes: the main path's in-memory LM saved by ``save_asteroid_checkpoint``
    as bf16 safetensors over two shards (``configs/lm_moss_ttsd_v0.5.json``
    as its config.json, its speech range widened to the whole vocab as the
    main path's is, and a greedy generation_config.json), and a
    reference-format codec ``.ckpt`` of random weights with its yaml (the
    geometry of ``configs/xy_codec_defaults.json``). The tokenizer is
    ``MockTokenizer``, put in through ``load_tokenizer`` (the smoke needs
    no ``transformers``). Checks: (a) ``TTSPipeline.load``'s greedy tokens
    at B 2 over examples_only_text.jsonl equal the in-memory pipeline's on
    the same weights, in bf16 and with quant="int8", and an int8-KV engine
    on the loaded int8 weights equals the in-memory one (B1, B2 and B3
    launched, counted); (b) the loaded fp32 codec's codes on the card equal
    the CPU's, and its bf16 decode of those codes is within 3 % relative
    RMS of the fp32 decode; (c) the inference and codec round-trip CLIs
    run with the real-checkpoint flags and write their wavs; (d) the
    streamed LM load, in a fresh process, adds no more host RSS than the
    largest tensor + ``RSS_MARGIN_GIB``. The write and load times, that
    host RSS and the card's peak go on one line."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from moss_ttsd_torch.cli import codec_roundtrip as cli_codec
    from moss_ttsd_torch.cli import inference as cli_infer
    from moss_ttsd_torch.core.config import (CodecConfig, LMConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.ops import flash_attention as fa
    from moss_ttsd_torch.pipeline import batch as pbatch
    from moss_ttsd_torch.utils.convert_lm import save_asteroid_checkpoint
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_ref_codec import write_reference_codec

    lm_json, codec_json = (os.path.join(ROOT, "configs", n)
                           for n in LOAD_JSONS)
    # the main path's widening of the speech range to the whole vocab:
    # random weights would leave it at once, and the rows would end in the
    # teacher-forcing window with no audio
    with open(lm_json) as f:
        lm_config = json.load(f)
    lm_config["speech_token_range"] = [0, lm_config["vocab_size"]]
    cfg = LMConfig.from_dict(lm_config)
    with open(codec_json) as f:
        geometry = json.load(f)
    base = CodecConfig()
    ccfg = dataclasses.replace(base, **{
        k: type(getattr(base, k))(**v) if isinstance(v, dict) else v
        for k, v in geometry.items()})
    L, problems, line = cfg.num_hidden_layers, [], {"phase": "load"}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_load_",
                           dir=os.path.join(ROOT, "build"))
    load_tokenizer = pbatch.load_tokenizer
    pbatch.load_tokenizer = lambda path: MockTokenizer()
    try:
        torch.cuda.reset_peak_memory_stats()
        lm_dir, codec_dir = (os.path.join(tmp, n) for n in ("lm", "codec"))
        state = pipe.engine.model.state_dict()        # bf16, on the card
        t0 = time.perf_counter()
        save_asteroid_checkpoint(state, cfg, lm_dir, dtype=torch.bfloat16,
                                 shards=2)
        with open(os.path.join(lm_dir, "config.json"), "w") as f:
            json.dump(lm_config, f, indent=2)
        with open(os.path.join(lm_dir, "generation_config.json"), "w") as f:
            json.dump({"do_samples": [False] * cfg.channels,
                       "layers": [{} for _ in range(cfg.channels)]}, f)
        line["lm_write_s"] = time.perf_counter() - t0
        line["lm_files"] = sorted(os.listdir(lm_dir))
        line["lm_bytes"] = sum(os.path.getsize(os.path.join(lm_dir, n))
                               for n in line["lm_files"])
        t0 = time.perf_counter()
        yaml_path, ckpt = write_reference_codec(codec_dir, ccfg, seed=0)
        line["codec_write_s"] = time.perf_counter() - t0
        line["codec_ckpt_bytes"] = os.path.getsize(ckpt)

        probe = _probe(lm_dir)
        added = probe["peak_rss_gib"] - probe["baseline_rss_gib"]
        bound = _largest_tensor_bytes(lm_dir) / 2 ** 30 + RSS_MARGIN_GIB
        line["lm_load_s"] = probe["seconds"]
        line["host_rss_gib"] = {"baseline": probe["baseline_rss_gib"],
                                "peak": probe["peak_rss_gib"],
                                "added": added, "added_bound": bound}
        if not added <= bound:
            problems.append(f"streamed LM load added {added:.3f} GiB of host "
                            f"RSS, over its bound {bound:.3f}")
        t0 = time.perf_counter()
        spt16 = XYTokenizer.load_from_checkpoint(yaml_path, ckpt,
                                                 dtype="bfloat16")
        torch.cuda.synchronize()
        line["codec_load_s"] = time.perf_counter() - t0

        # (a) loaded vs in-memory greedy tokens, bf16 and int8
        items = load_items()
        sampling = SamplingConfig.from_generation_config_json(
            os.path.join(lm_dir, "generation_config.json"), cfg.channels)
        t0 = time.perf_counter()
        loaded = pbatch.TTSPipeline.load(lm_dir, yaml_path, ckpt)
        torch.cuda.synchronize()
        line["pipeline_load_s"] = time.perf_counter() - t0
        memory = pbatch.TTSPipeline(MockTokenizer(), cfg, state, loaded.spt,
                                    sampling)
        runs, launches = {}, {}
        for name, quant in (("bf16", None), ("int8", "int8")):
            if quant:
                loaded = pbatch.TTSPipeline.load(lm_dir, yaml_path, ckpt,
                                                 quant=quant)
                memory = pbatch.TTSPipeline(MockTokenizer(), cfg, state,
                                            loaded.spt, sampling, quant=quant)
            got = _tokens_run(loaded, items, steps)
            ref = _tokens_run(memory, items, steps)
            n = got[0].steps
            same = (n == ref[0].steps and np.array_equal(
                np.asarray(got[0].tokens), np.asarray(ref[0].tokens)))
            audio_bad, _, audio_s = audio_problems(got[1], got[2], n,
                                                   cfg.channels)
            runs[name] = {"steps": n, "tokens_identical": same,
                          "rtf": audio_s / got[3],
                          "decode_steps_per_s": n / got[5]["decode_s"],
                          "e2e_s": got[3], "audio_s": audio_s,
                          "audio_problems": audio_bad}
            launches[name] = got[4]
            want = {"flash_prefill": L, "flash_decode_hs": L * n,
                    "flash_decode_int8_hs": 0}
            if not same or audio_bad or got[4] != want or n < 1:
                problems.append(f"{name}: tokens identical {same}, audio "
                                f"{audio_bad}, launches {got[4]} != {want}")
        # B3 on the loaded int8 weights: an int8-KV engine over them
        _, batch, mask = decode_inputs(loaded, items)
        toks = {}
        for name, weights in (("loaded", loaded.engine.model),
                              ("memory", state)):
            eng = GenerationEngine(cfg, weights, sampling, device="cuda",
                                   quant="int8", kv_quant="int8")
            fa.reset_launch_counts()
            res = eng.generate(batch, mask, steps)
            torch.cuda.synchronize()
            toks[name] = (res.steps, np.asarray(res.tokens))
            if name == "loaded":
                launches["int8_kv8"] = fa.launch_counts()
                n = res.steps
            del eng
        same = (toks["loaded"][0] == toks["memory"][0]
                and np.array_equal(toks["loaded"][1], toks["memory"][1]))
        runs["int8_kv8"] = {"steps": n, "tokens_identical": same}
        want = {"flash_prefill": L, "flash_decode_hs": 0,
                "flash_decode_int8_hs": L * n}
        if not same or launches["int8_kv8"] != want:
            problems.append(f"int8_kv8: tokens identical {same}, launches "
                            f"{launches['int8_kv8']} != {want}")
        line.update(runs=runs, launches=launches)
        del loaded, memory
        _release()

        # (b) the loaded codec: fp32 codes card == CPU; bf16 decode vs fp32
        wavs = prompt_voices()
        spt_cpu = XYTokenizer.load_from_checkpoint(yaml_path, ckpt,
                                                   device="cpu")
        codes_cpu = spt_cpu.encode(wavs)["codes_list"]
        del spt_cpu
        spt32 = XYTokenizer.load_from_checkpoint(yaml_path, ckpt)
        codes = spt32.encode(wavs)["codes_list"]
        same = all(np.array_equal(a, b) for a, b in zip(codes, codes_cpu))
        w32 = spt32.decode(codes)["syn_wav_list"]
        w16 = spt16.decode(codes)["syn_wav_list"]
        rel = max(float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9))
                  for a, b in zip(w32, w16))
        finite = all(np.isfinite(w).all() and w.size for w in w32 + w16)
        line["codec"] = {"code_shapes": [list(c.shape) for c in codes],
                         "codes_card_eq_cpu": same,
                         "distinct_codes": int(len(np.unique(
                             np.concatenate([c.reshape(-1) for c in codes])))),
                         "bf16_vs_fp32_rel_rms": rel, "rel_rms_tol": 0.03,
                         "finite": finite}
        if not (same and finite and rel < 0.03):
            problems.append(f"codec: {line['codec']}")
        del spt32, spt16
        _release()

        # (c) the CLIs with the real-checkpoint flags
        out = os.path.join(tmp, "cli")
        cli = {}
        for name, fn, argv, want in (
                ("inference", cli_infer.main,
                 ["--jsonl", JSONL, "--model_path", lm_dir, "--spt_config",
                  yaml_path, "--spt_ckpt", ckpt, "--max_new_tokens", "32",
                  "--output_dir", os.path.join(out, "infer")],
                 ["output_0.wav", "output_1.wav"]),
                ("codec_roundtrip", cli_codec.main,
                 ["--input_dir", EXAMPLES, "--config", yaml_path,
                  "--checkpoint", ckpt, "--output_dir",
                  os.path.join(out, "codec")],
                 ["voice_both_recon.wav", "voice_s1_recon.wav",
                  "voice_s2_recon.wav"])):
            t0 = time.perf_counter()
            rc = fn(argv)
            d = argv[-1]
            wavs_out = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
            cli[name] = {"rc": rc, "wavs": wavs_out,
                         "seconds": time.perf_counter() - t0}
            if rc != 0 or wavs_out != want:
                problems.append(f"cli {name}: {cli[name]}")
            _release()
        line["cli"] = cli
        line["card_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        pbatch.load_tokenizer = load_tokenizer
        shutil.rmtree(tmp, ignore_errors=True)
    line.update(config_json=f"configs/{LOAD_JSONS[0]}, speech_token_range "
                            f"{lm_config['speech_token_range']}",
                tokenizer="MockTokenizer through load_tokenizer (no "
                          "transformers needed)",
                nvidia_smi=smi_line, ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit(f"load phase failed: {problems}")
    return line


# ---------------------------------------------------------------------------
# phase 12: the --tiny CLIs on the card
# ---------------------------------------------------------------------------

def _trace_kernel_events(path) -> int:
    """Kernel events in a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(e.get("cat") == "kernel" for e in events)


def _run_all(runs):
    """Start every (name, cmd, ...) run as its own process at once and
    wait for all: [(run, CompletedProcess, seconds since the start)].
    A process still running when this returns or raises is killed."""
    t0 = time.perf_counter()
    procs = [(run, subprocess.Popen(run[1], cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for run in runs]
    results = []
    try:
        for run, p in procs:
            out, err = p.communicate(timeout=600)
            results.append((run, subprocess.CompletedProcess(
                p.args, p.returncode, out, err), time.perf_counter() - t0))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def cli_check():
    """The --tiny CLIs on the card, as six processes at once (each its own
    output directory, so their seconds are wall times of runs sharing the
    card and the host): inference plain, with --profile_dir, with int8
    serving, and cloning the voices of examples/examples.jsonl (one item,
    one wav); the codec round trip over examples/ (three wavs and their
    metrics); the podcast generator over a .txt (one wav, its JSON line
    with JAX's keys). The native audio library is built first, once."""
    from moss_ttsd_torch.utils import native
    if not native.available():
        raise SystemExit(f"the native audio library did not build: "
                         f"{native.build_info}")
    root = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)

    def infer(name, *flags):
        out = os.path.join(root, name)
        return [sys.executable, "-m", "moss_ttsd_torch.cli.inference",
                "--tiny", "--max_new_tokens", "32", "--output_dir", out,
                *flags], out

    runs = []
    for name, flags, want in (
            ("text", ["--jsonl", JSONL], ["output_0.wav", "output_1.wav"]),
            ("text_profile_dir", ["--jsonl", JSONL, "--profile_dir",
                                  os.path.join(root, "text_profile_dir",
                                               "trace")],
             ["output_0.wav", "output_1.wav"]),
            ("text_int8", ["--jsonl", JSONL, "--quant", "int8",
                           "--restricted_text_head"],
             ["output_0.wav", "output_1.wav"]),
            ("voice_clone", ["--jsonl", os.path.join(EXAMPLES,
                                                     "examples.jsonl")],
             ["output_0.wav"])):
        runs.append((name, *infer(name, *flags), want))
    codec_out = os.path.join(root, "codec_roundtrip")
    runs.append(("codec_roundtrip",
                 [sys.executable, "-m", "moss_ttsd_torch.cli.codec_roundtrip",
                  "--tiny", "--input_dir", EXAMPLES, "--output_dir",
                  codec_out, "--metrics",
                  os.path.join(codec_out, "metrics.json")], codec_out,
                 ["voice_both_recon.wav", "voice_s1_recon.wav",
                  "voice_s2_recon.wav"]))
    pod_out = os.path.join(root, "podcast")
    os.makedirs(pod_out)
    with open(os.path.join(pod_out, "notes.txt"), "w") as f:
        f.write(PODCAST_SOURCE)
    runs.append(("podcast",
                 [sys.executable, "-m", "moss_ttsd_torch.serve.podcast",
                  "--tiny", "--input", os.path.join(pod_out, "notes.txt"),
                  "--output", os.path.join(pod_out, "podcast.wav")],
                 pod_out, ["podcast.wav"]))
    for (name, cmd, out_dir, want), proc, seconds in _run_all(runs):
        kernel_events = None
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        wavs = [f for f in files if f.endswith(".wav")]
        ok = proc.returncode == 0 and wavs == want
        if name == "codec_roundtrip":
            ok = ok and "metrics.json" in files
        if name == "podcast":
            try:
                info = json.loads(proc.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                info = {}
            ok = ok and sorted(info) == ["duration_s", "language", "output"]
        if name == "text_profile_dir":
            trace_dir = os.path.join(out_dir, "trace")
            traces = (os.listdir(trace_dir) if os.path.isdir(trace_dir)
                      else [])
            # the trace must exist and parse; its kernel events are
            # reported, not checked (the card's profiler may drop a short
            # capture's device events)
            kernel_events = (_trace_kernel_events(
                os.path.join(trace_dir, traces[0])) if len(traces) == 1
                else None)
            ok = ok and kernel_events is not None
        emit({"phase": "cli", "run": name, "flags": cmd[3:],
              "rc": proc.returncode, "wavs": wavs,
              "seconds_since_start": seconds, "ok": ok,
              **({"trace_kernel_events": kernel_events}
                 if name == "text_profile_dir" else {}),
              "tail": proc.stdout.strip().splitlines()[-2:]})
        if not ok:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"tiny CLI run {name} failed")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: mesh — tensor-parallel serving, data-parallel finetuning
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")
MESH_STEPS = {"fp32": 32, "bf16": 64, "int8": 64}
MESH_POOL = {"slots": 8, "base": 512, "max_steps": 2048, "steps": 32}
# the DP LoRA step against one process: the loss and grad norm within one
# bf16 ulp (2^-8) relative; the ranks run their row alone, so the bf16
# GEMMs see other shapes and round elsewhere, and the loss averages those
# roundings over ~4000 supervised tokens
MESH_TRAIN_REL = 2.0 ** -8


def mesh_cfg(dtype: str):
    """LMConfig() at the main path's whole-vocab speech range, fp32
    parameters, ``dtype`` compute."""
    from moss_ttsd_torch.core.config import LMConfig
    cfg = LMConfig()
    return LMConfig.from_dict({**cfg.to_dict(),
                               "speech_token_range": [0, cfg.vocab_size],
                               "dtype": dtype, "param_dtype": "float32"})


def mesh_prompts(cfg):
    """The main path's two text items as a left-padded (B, L, C) batch (the
    pipeline's prompt assembly with the mock tokenizer), and the shifted
    prompts."""
    import types
    from moss_ttsd_torch.pipeline import prompt as pp
    from moss_ttsd_torch.pipeline.batch import SYSTEM_PROMPT, TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    host = types.SimpleNamespace(tokenizer=MockTokenizer(), lm_cfg=cfg)
    shifted = [TTSPipeline._assemble(
        host, TTSPipeline._prepare_text(host, it, False)[0], None,
        SYSTEM_PROMPT) for it in load_items()]
    batch, mask = pp.left_pad_batch(shifted, host.tokenizer.pad_token_id,
                                    cfg.speech_pad_token)
    return batch, mask, shifted


def mesh_engine(state, mode, mesh=None):
    """The greedy engine of ``mode``: "fp32", "bf16", or "int8" (w8a16
    weights and the int8 KV cache)."""
    from moss_ttsd_torch.decode.engine import GenerationEngine
    cfg = mesh_cfg("float32" if mode == "fp32" else "bfloat16")
    kw = dict(quant="int8", kv_quant="int8") if mode == "int8" else {}
    return GenerationEngine(cfg, state, _greedy(cfg.channels, 64),
                            bucket=128, device="cuda", mesh=mesh, **kw)


def mesh_run(eng, batch, mask, steps, mesh=None):
    """The first step's logits (the prefill's last hidden through the tied
    heads), then one counted generate: tokens, launches, the host clock
    a decode step and, on a mesh, its collectives a step."""
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    ids, m, base = eng._bucket_prompt(batch, mask)
    st = eng.prefill(torch.as_tensor(ids, device="cuda"),
                     torch.as_tensor(m, device="cuda"), base, 8)
    t, s = eng.model.logits_all(st.hidden_last)
    logits = (t[:, 0].cpu(), s[:, 0].cpu())
    del st
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    c0 = 0 if mesh is None else mesh.collectives
    res = eng.generate(batch, mask, max_new_tokens=steps, seed=0)
    torch.cuda.synchronize()
    stats = eng.last_stats
    out = {"tokens": res.tokens, "steps": res.steps, "logits": logits,
           "launches": fa.launch_counts(), "base": stats["base"],
           "buf_steps": stats["buf_steps"], "left_pad": stats["left_pad"],
           "prefill_s": stats["prefill_s"],
           "decode_s_per_step": stats["decode_s"] / max(res.steps, 1)}
    if mesh is not None:
        out["collectives_per_step"] = ((mesh.collectives - c0)
                                       / max(res.steps, 1))
    return out


def mesh_pool_run(state, mesh):
    """The TP pool at the server's default geometry (8 slots, base 512,
    2048 steps, the int8 KV cache), one LoRA voice registered: a burst of
    8 joins (every other one on the voice), then 32 pool steps."""
    import torch
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    from moss_ttsd_torch.ops import flash_attention as fa
    cfg = mesh_cfg("bfloat16")
    P = MESH_POOL
    cb = ContinuousBatcher(cfg, state, _greedy(cfg.channels), slots=P["slots"],
                           base=P["base"], max_steps=P["max_steps"],
                           device="cuda", kv_quant="int8", mesh=mesh)
    cb.register_adapter("voice", pool_adapter(cfg, 3), alpha=32.0)
    shifted = mesh_prompts(cfg)[2]
    reqs = [(shifted[j % len(shifted)], 64, j, "voice" if j % 2 else None)
            for j in range(P["slots"])]
    fa.reset_launch_counts()
    c0 = mesh.collectives
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = cb.submit_many(reqs)
    ran = cb.run(steps=P["steps"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    toks = cb.state.tokens[:, P["base"]:P["base"] + ran].cpu().numpy()
    return {"joins": len(slots), "steps": ran, "seconds": secs,
            "launches": fa.launch_counts(), "tokens": toks,
            "collectives_per_step": (mesh.collectives - c0) / max(ran, 1),
            "finite": bool(torch.isfinite(cb.state.hidden_last.float()
                                          ).all())}


def mesh_lora_setup(group=None, mesh=None):
    """The full-width layerwise LoRA step (rank 16, alpha 32, rslora, the
    seven projections; fp32 masters, bf16 compute, remat) of the train
    phase, at a constant 1e-4, accumulation 1; under ``mesh`` over its
    data group."""
    import dataclasses
    import torch
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.train.lora import (graft_lora_params,
                                            init_lora_state,
                                            make_layerwise_lora_step)
    from moss_ttsd_torch.train.step import make_optimizer, shard_train_step
    cfg = mesh_cfg("bfloat16")
    lcfg = dataclasses.replace(cfg, lora_rank=16, lora_alpha=32.0,
                               lora_rslora=True)
    model = AsteroidLM.init_random(cfg, seed=0, device="cuda",
                                   dtype=torch.float32)
    model = graft_lora_params(model, lcfg, seed=1)
    opt = make_optimizer(learning_rate=1e-4, total_steps=100,
                         lr_scheduler_type="constant")
    state = init_lora_state(model, opt)
    kw = dict(remat=True, ce_chunks=8)
    step = (make_layerwise_lora_step(lcfg, opt, **kw) if mesh is None else
            shard_train_step(make_layerwise_lora_step, mesh, lcfg, opt, **kw))
    return state, step


def mesh_train_batch(rows=slice(None)):
    """The train phase's batch of two T 2048 rows as one micro batch
    (accumulation 1), or its ``rows``."""
    batch, _ = train_batch(0)
    return {k: v.reshape((2,) + v.shape[2:])[rows] for k, v in batch.items()}


def mesh_refs(path):
    """The unsharded references, in this process on the same seeded
    weights: each mode's first-step logits and tokens, and 3 LoRA steps of
    one process on the whole batch."""
    import torch
    from moss_ttsd_torch.models.lm import AsteroidLM
    state = AsteroidLM.init_random(mesh_cfg("float32"), seed=0,
                                   device="cuda",
                                   dtype=torch.float32).state_dict()
    batch, mask, _ = mesh_prompts(mesh_cfg("float32"))
    refs = {}
    for mode, steps in MESH_STEPS.items():
        eng = mesh_engine(state, mode)
        r = mesh_run(eng, batch, mask, steps)
        refs[mode] = {k: r[k] for k in ("tokens", "steps", "logits",
                                        "decode_s_per_step")}
        del eng
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    st, step = mesh_lora_setup()
    b = mesh_train_batch()
    st, losses, norms, times = _train_steps(st, step, b, 3)
    refs["lora"] = {"loss": losses, "grad_norm": norms, "s_per_step": times}
    del st, step
    _release()
    torch.save(refs, path)


def _rank_init(rank, world, init, backend):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    initialize_multihost(init, world, rank, device="cuda", backend=backend,
                         timeout_s=600)


def mesh_tp_rank(rank, world, init, out):
    """One of two ranks sharing the card over gloo: the (1, 2) engine in
    fp32, bf16 and int8 + int8 KV, the TP pool, then the (2, 1) DP LoRA
    step on this rank's row. Saves what it measured to ``out``."""
    import torch
    import torch.distributed as dist
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.parallel.mesh import make_mesh
    _rank_init(rank, world, init, "gloo")
    res = {}
    mesh = make_mesh(1, 2, device_type="cuda")
    state = AsteroidLM.init_random(mesh_cfg("float32"), seed=0,
                                   device="cuda",
                                   dtype=torch.float32).state_dict()
    batch, mask, _ = mesh_prompts(mesh_cfg("float32"))
    for mode, steps in MESH_STEPS.items():
        eng = mesh_engine(state, mode, mesh)
        torch.cuda.reset_peak_memory_stats()
        res[mode] = mesh_run(eng, batch, mask, steps, mesh)
        res[mode]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del eng
        torch.cuda.empty_cache()
    res["pool"] = mesh_pool_run(state, mesh)
    del state
    torch.cuda.empty_cache()
    dp = make_mesh(2, 1, device_type="cuda")
    st, step = mesh_lora_setup(mesh=dp)
    b = mesh_train_batch(slice(rank, rank + 1))
    st, losses, norms, times = _train_steps(st, step, b, 3)
    res["lora"] = {"loss": losses, "grad_norm": norms, "s_per_step": times}
    torch.save(res, out)
    dist.destroy_process_group()


def mesh_nccl_rank(rank, world, init, out):
    """World size 1 over NCCL: ``--mesh 1x1`` through
    ``TTSPipeline.process_batch`` at the full width (bf16, greedy, B 2,
    64 steps) against the unsharded engine on the same weights; then 2
    full-finetuning steps over the mesh's data group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from moss_ttsd_torch.decode.engine import GenerationEngine
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.parallel.mesh import parse_mesh_arg
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step,
                                            shard_train_step)
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    _rank_init(rank, world, init, "nccl")
    res = {"backend": dist.get_backend()}
    mesh = parse_mesh_arg("1x1", device_type="cuda")
    cfg, model, spt, _ = full_width_parts()
    sampling = _greedy(cfg.channels, 64)
    pipe = TTSPipeline(MockTokenizer(), cfg, model, spt, sampling,
                       bucket=128, device="cuda", mesh=mesh)
    seen = []
    real = pipe.engine.generate
    pipe.engine.generate = lambda *a, **k: seen.append(real(*a, **k)) or \
        seen[-1]
    items = load_items()
    texts, audio = pipe.process_batch(items, max_new_tokens=64, seed=0)
    problems, _, _ = audio_problems(texts, audio, seen[-1].steps, 8)
    _, batch, mask = decode_inputs(pipe, items)
    ref = GenerationEngine(cfg, model, sampling, bucket=128,
                           device="cuda").generate(batch, mask, 64, seed=0)
    res["pipeline"] = {"steps": seen[-1].steps, "ref_steps": ref.steps,
                       "tokens_equal": bool(np.array_equal(
                           seen[-1].tokens, ref.tokens)),
                       "audio_problems": problems}
    del pipe, model, spt, real, seen
    _release()
    fcfg = mesh_cfg("bfloat16")
    opt = make_optimizer(learning_rate=1e-4, total_steps=100,
                         lr_scheduler_type="constant")
    state = init_train_state(fcfg, opt, seed=0, device="cuda")
    step = shard_train_step(make_train_step, mesh, fcfg, opt, remat=True,
                            ce_chunks=8)
    state, losses, norms, times = _train_steps(state, step,
                                               mesh_train_batch(), 2)
    res["full"] = {"loss": losses, "grad_norm": norms, "s_per_step": times,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    torch.save(res, out)
    dist.destroy_process_group()


def _spawn_ranks(fn, world, tag):
    """``fn`` in ``world`` spawned processes on this card; a rank that
    exits non-zero or outlives its time fails the phase. Returns their
    saved results."""
    import multiprocessing
    import torch
    from moss_ttsd_torch.parallel.distributed import local_init_method
    ctx = multiprocessing.get_context("spawn")
    init = local_init_method()
    outs = [os.path.join(MESH_DIR, f"{tag}_rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=fn, args=(r, world, init, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    if codes != [0] * world:
        raise SystemExit(f"mesh: {tag} ranks exited {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def _rel_rms(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def mesh_phase(smi_line: str):
    """The references in this process, then the (1, 2) TP ranks and the
    (2, 1) DP LoRA step over gloo (two processes on this card), then the
    NCCL world of one. Every check of every rank must hold."""
    import numpy as np
    import torch
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    ref_path = os.path.join(MESH_DIR, "refs.pt")
    mesh_refs(ref_path)
    refs = torch.load(ref_path, weights_only=False)
    t_refs = time.perf_counter() - t0
    tp = _spawn_ranks(mesh_tp_rank, 2, "tp")
    t_tp = time.perf_counter() - t0 - t_refs
    nccl, = _spawn_ranks(mesh_nccl_rank, 1, "nccl")
    problems = []
    L = 28
    # the bf16 error scale: the unsharded bf16 logits against fp32's
    e_bf16 = max(_rel_rms(refs["bf16"]["logits"][i],
                          refs["fp32"]["logits"][i]) for i in (0, 1))
    line = {"phase": "mesh", "nvidia_smi": smi_line,
            "mesh": {"tp": [1, 2], "dp_train": [2, 1], "nccl": [1, 1]},
            "backend": {"tp": "gloo (two processes, one card)",
                        "nccl": nccl["backend"]},
            "bf16_error_scale": e_bf16,
            "logit_tolerance": "rel RMS <= 2 x bf16_error_scale (the "
                               "unsharded bf16 logits against fp32)",
            "ranks": []}
    for r, res in enumerate(tp):
        rank = {"rank": r}
        for mode, steps in MESH_STEPS.items():
            got, ref = res[mode], refs[mode]
            agree = float((got["tokens"] == ref["tokens"]).mean()) \
                if got["tokens"].shape == ref["tokens"].shape else 0.0
            entry = {"steps": got["steps"], "agreement": agree,
                     "launches": got["launches"],
                     "collectives_per_step": got["collectives_per_step"],
                     "host_ms_per_step": 1e3 * got["decode_s_per_step"],
                     "unsharded_host_ms_per_step":
                         1e3 * ref["decode_s_per_step"],
                     "prefill_s": got["prefill_s"],
                     "peak_gib": got["peak_gib"]}
            dec = ("flash_decode_int8_hs" if mode == "int8"
                   else "flash_decode_hs")
            want = {"flash_prefill": L, dec: L * got["steps"]}
            if {k: got["launches"][k] for k in want} != want:
                problems.append(f"rank {r} {mode}: launches "
                                f"{got['launches']}, want {want}")
            if mode == "fp32":
                if agree != 1.0 or got["steps"] != ref["steps"]:
                    problems.append(f"rank {r} fp32 greedy tokens differ "
                                    f"from the unsharded engine's "
                                    f"(agreement {agree})")
            else:
                rel = [_rel_rms(got["logits"][i], ref["logits"][i])
                       for i in (0, 1)]
                entry["logits_rel_rms"] = {"text": rel[0], "speech": rel[1]}
                entry["logits_max_abs"] = [
                    float((got["logits"][i] - ref["logits"][i]).abs().max())
                    for i in (0, 1)]
                if max(rel) > 2 * e_bf16:
                    problems.append(f"rank {r} {mode}: first-step logits "
                                    f"rel RMS {rel} > 2 x {e_bf16}")
            rank[mode] = entry
        pool = res["pool"]
        rank["pool"] = {k: pool[k] for k in ("joins", "steps", "seconds",
                                             "launches", "finite",
                                             "collectives_per_step")}
        want = {"flash_decode_int8_hs": L * pool["steps"]}
        if (pool["joins"] != MESH_POOL["slots"]
                or pool["steps"] != MESH_POOL["steps"] or not pool["finite"]
                or pool["launches"]["flash_decode_int8_hs"]
                != want["flash_decode_int8_hs"]
                or pool["launches"]["flash_prefill"] < L):
            problems.append(f"rank {r} pool: {rank['pool']}")
        lora = res["lora"]
        rank["lora_dp"] = lora
        for k in ("loss", "grad_norm"):
            rel = max(abs(a - b) / abs(b) for a, b in zip(lora[k],
                                                          refs["lora"][k]))
            rank["lora_dp"][k + "_rel"] = rel
            if not rel <= MESH_TRAIN_REL:
                problems.append(f"rank {r} DP LoRA {k} rel {rel}")
        line["ranks"].append(rank)
    if not all(np.array_equal(tp[0]["pool"]["tokens"], t["pool"]["tokens"])
               for t in tp[1:]):
        problems.append("the ranks' pool tokens differ")
    line["lora_one_process"] = refs["lora"]
    line["nccl"] = nccl
    if not (nccl["pipeline"]["tokens_equal"]
            and nccl["pipeline"]["steps"] == nccl["pipeline"]["ref_steps"]
            and not nccl["pipeline"]["audio_problems"]):
        problems.append(f"NCCL 1x1 pipeline: {nccl['pipeline']}")
    if not all(np.isfinite(nccl["full"]["loss"])):
        problems.append(f"NCCL full finetuning: {nccl['full']}")
    line["memory_estimate"] = ("utils/memory.serving_memory has no tensor-"
                               "parallel argument; per-rank peaks only")
    line["seconds"] = {"refs": t_refs, "tp_ranks": t_tp,
                       "nccl": time.perf_counter() - t0 - t_refs - t_tp}
    line["problems"] = problems
    emit(line)
    if problems:
        raise SystemExit(f"mesh phase failed: {problems}")
    r0 = tp[0]
    return {"bf16": r0["bf16"], "int8": r0["int8"], "pool": r0["pool"],
            "launches": {m: r0[m]["launches"] for m in MESH_STEPS}}


def mesh_kernel_rows(mesh, checks_ok, SETS):
    """Each kernel at the tensor-parallel rank's shapes (tp 2: H 8, Hkv 4)
    of the mesh phase's main-path runs and of the pool's (8, 2560), and one
    G 1 case (tp 16: H 1, Hkv 1, the KV head replicated), each against
    its plain version, timed with its plan, bound and library call."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9)
    D = 128
    bf = torch.bfloat16
    out = {"flash_prefill": {}, "flash_decode_hs": {},
           "flash_decode_int8_hs": {}}
    m = mesh["bf16"]
    B, base, pads = 2, m["base"], m["left_pad"]
    S = base + m["buf_steps"]
    ext = base + (m["steps"] + 1) // 2
    for tag, H, Hkv in (("tp2", 8, 4), ("g1", 1, 1)):
        t = prefill_times(gen, B, base, pads, H, Hkv, D, SETS)
        chk = prefill_case(gen, f"{tag}_main", B, base, H, Hkv, D, bf, pads)
        # G 1 is a check case: the tp-2 runs launch G 2
        n = lambda k: m["launches"][k] if tag == "tp2" else 0  # noqa: E731
        out["flash_prefill"][f"{tag}_main"] = {
            "shape": [B, base, H, Hkv, D], "left_pad": pads,
            "launches": n("flash_prefill"),
            "max_abs_err": chk["max_abs_err"], "pass": chk["ok"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bytes": t["bytes"],
            "flops": t["flops"]}
        checks_ok.append(chk["ok"])
        spans = [(p, ext) for p in pads]
        d = decode_times(gen, B, S, ext, pads, H, Hkv, D, SETS)
        chk = decode_case(gen, f"{tag}_main", B, S, H, Hkv, D, bf, spans, ext)
        out["flash_decode_hs"][f"{tag}_main"] = {
            "launches": n("flash_decode_hs"),
            "max_abs_err": chk["max_abs_err"], "pass": chk["ok"],
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "library_ms": d["library_ms"], **_bound(d["bytes"], d["flops"]),
            "bytes": d["bytes"], "flops": d["flops"], **d["extra"]}
        checks_ok.append(chk["ok"])
        valid = _valid_spans(B, S, spans)
        e = torch.full((B,), ext, dtype=torch.int32, device="cuda")
        r = pool_decode_times(gen, valid, e, "int8", SETS, H, Hkv)
        chk = int8_decode_case(gen, f"{tag}_main", B, S, H, Hkv, D, bf,
                               spans, ext)
        r.update(launches=(mesh["int8"]["launches"]["flash_decode_int8_hs"]
                           if tag == "tp2" else 0),
                 check_vs_split_plain=chk["ok"])
        out["flash_decode_int8_hs"][f"{tag}_main"] = r
        checks_ok += [r["pass"], chk["ok"]]
    # the TP pool's shapes: a burst's (8, 512) prefill, (8, 2560) decodes
    P = MESH_POOL
    pl = mesh["pool"]["launches"]
    pads8 = [0] * P["slots"]
    t = prefill_times(gen, P["slots"], P["base"], pads8, 8, 4, D, SETS)
    chk = prefill_case(gen, "tp2_pool", P["slots"], P["base"], 8, 4, D, bf,
                       pads8)
    out["flash_prefill"]["tp2_pool_B8_T512"] = {
        "shape": [P["slots"], P["base"], 8, 4, D],
        "launches": pl["flash_prefill"], "max_abs_err": chk["max_abs_err"],
        "pass": chk["ok"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bytes": t["bytes"], "flops": t["flops"]}
    checks_ok.append(chk["ok"])
    Sp = P["base"] + P["max_steps"]
    valid = torch.ones((P["slots"], Sp), dtype=torch.bool, device="cuda")
    e = torch.full((P["slots"],), Sp, dtype=torch.int32, device="cuda")
    for kind, name in (("bf16", "flash_decode_hs"),
                       ("int8", "flash_decode_int8_hs")):
        r = pool_decode_times(gen, valid, e, kind, SETS, 8, 4)
        r["launches"] = pl.get(name, 0)
        out[name][f"tp2_pool_B8_S{Sp}_full"] = r
        checks_ok.append(r["pass"])
    return out


# ---------------------------------------------------------------------------
# kernels line: times at the main path's shapes, bounds, launches
# ---------------------------------------------------------------------------

def prefill_times(gen, B, base, pads, H, Hkv, D, SETS):
    """flash_prefill at (B, base, H, Hkv, D) bf16 with the run's left
    padding: kernel, plain and SDPA ms over SETS rotated input sets, and
    the bound. The left-padded query rows are 0 by contract and their keys
    are masked, so the bound counts the valid rows and causal pairs only."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    scale = D ** -0.5
    ps = [tuple(_rand(gen, (B, base, n, D), bf) for n in (H, Hkv, Hkv))
          for _ in range(SETS)]
    valid = _left_pad_valid(B, base, pads)
    nv = int(valid.sum())
    pairs = sum((base - p) * (base - p + 1) // 2 for p in pads)
    nbytes = 2 * (B * base * H * D + nv * H * D + 2 * nv * Hkv * D) \
        + valid.numel()
    flops = 4 * D * H * pairs
    mask = (torch.tril(torch.ones(base, base, dtype=torch.bool,
                                  device="cuda"))[None] & valid[:, None, :])
    psh = [tuple(x.transpose(1, 2) for x in t) for t in ps]
    lib = lambda i: F.scaled_dot_product_attention(
        *psh[i % SETS], attn_mask=mask[:, None], scale=scale,
        enable_gqa=True)
    return {"ms": cuda_ms(lambda i: fa.flash_prefill(*ps[i % SETS], valid,
                                                     scale), 2 * SETS),
            "plain_ms": cuda_ms(lambda i: fa.flash_prefill_plain(
                *ps[i % SETS], valid, scale), SETS),
            "library_ms": cuda_ms(lib, 2 * SETS),
            **_bound(nbytes, flops), "bytes": nbytes, "flops": flops}


def kernel_table(main, longform, checks, clone=None, stream=None,
                 sweep=False, pool=None, load=None, mesh=None):
    """Times at the shapes of the runs that launch each kernel: the main
    path's for flash_prefill and flash_decode_hs (and the clone run's,
    when it ran), the long-form run's for flash_decode_int8_hs. Each
    timing rotates over ``SETS`` distinct input sets (one per layer, as the
    decode step reads 28 layer caches in turn), ~90-170 MB in all, so
    inputs come from HBM, not L2. Bounds count only what the function must
    move and compute: the rows and slots that are valid in the run's
    padding, below the extent. ``sweep``: the decode also at other splits
    than its plan (``split_sweep_ms``), and flash_decode_hs so at
    SWEEP_SHAPES and the stream run's cache (``shape_sweep``). ``pool``:
    each kernel also at the continuous pool's shapes (``pool`` entries,
    ``pool_kernel_rows``). ``load``: each kernel's launches in the load
    phase's runs (``load_launches``). ``mesh``: each kernel also at a
    tensor-parallel rank's shapes (``tp`` entries, ``mesh_kernel_rows``)."""
    import torch
    B, base, steps = main["batch"], main["base"], main["steps"]
    H, Hkv, D, L = 16, 8, 128, main["layers"]
    SETS = L
    gen = torch.Generator(device="cuda").manual_seed(5)
    if load is not None:
        # each kernel's launches in the load phase's runs on loaded weights
        # (counts reset before each run, read after it)
        load_launches = {n: {run: c[n] for run, c in load["launches"].items()}
                         for n in ("flash_prefill", "flash_decode_hs",
                                   "flash_decode_int8_hs")}
    pads = main["left_pad"]
    rows = []

    pt = prefill_times(gen, B, base, pads, H, Hkv, D, SETS)
    extra = {"shape": [B, base, H, Hkv, D], "dtype": "bfloat16",
             "left_pad": pads, "input_sets": SETS,
             "in_path_ms": main["prefill_in_path_ms"]["median"],
             "design": "wgmma m64n64k16 tensor-core tiles (S = Q K^T from "
                       "shared memory, O += P V with bf16 P from registers), "
                       "cp.async double-buffered K/V, one warpgroup per "
                       "(64-query tile, q-head, row)",
             "blocks": -(-base // 64) * H * B}
    if clone is not None:
        ct = prefill_times(gen, clone["batch"], clone["base"],
                           clone["left_pad"], H, Hkv, D, SETS)
        extra["clone"] = {
            "shape": [clone["batch"], clone["base"], H, Hkv, D],
            "left_pad": clone["left_pad"],
            "launches": clone["launches"]["flash_prefill"],
            "max_abs_err": checks["flash_prefill:clone_B3_T505"][
                "max_abs_err"],
            "in_path_ms": clone["prefill_in_path_ms"]["median"],
            "blocks": -(-clone["base"] // 64) * H * clone["batch"], **ct}
    rows.append(_row(
        "flash_prefill", "moss_ttsd_torch/csrc/flash_prefill.cu",
        "moss_ttsd_tpu/ops/pallas_attention.py:426 (flash_prefill / "
        "_prefill_kernel)", main["launches"]["flash_prefill"],
        checks["flash_prefill:main"], pt["ms"], pt["plain_ms"],
        pt["library_ms"], pt["bytes"], pt["flops"], extra))

    dt = decode_times(gen, B, base + main["buf_steps"],
                      base + (steps + 1) // 2, pads, H, Hkv, D, SETS, sweep)
    if clone is not None:
        ct = decode_times(gen, clone["batch"],
                          clone["base"] + clone["buf_steps"],
                          clone["base"] + (clone["steps"] + 1) // 2,
                          clone["left_pad"], H, Hkv, D, SETS, sweep)
        dt["extra"]["clone"] = {
            "launches": clone["launches"]["flash_decode_hs"],
            "max_abs_err": checks["flash_decode_hs:clone"]["max_abs_err"],
            "ms": ct["ms"], "plain_ms": ct["plain_ms"],
            "library_ms": ct["library_ms"], **_bound(ct["bytes"], ct["flops"]),
            "bytes": ct["bytes"], "flops": ct["flops"], **ct["extra"]}
    if sweep:
        # caches the split plan was decided on: the JAX headline batch, longer
        # caches at B 1, 3 and 8, and the stream's own capacity
        shapes = list(SWEEP_SHAPES)
        if stream is not None:
            S = stream["base"] + stream["buf_steps"]
            shapes.append(("stream", 1, S, stream["base"] + (
                stream["steps"] + 1) // 2, stream["left_pad"]))
        dt["extra"]["shape_sweep"] = []
        for name, b, S, ext, pd in shapes:
            t = decode_times(gen, b, S, ext, pd, H, Hkv, D, SETS, True)
            dt["extra"]["shape_sweep"].append({
                "name": name, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "library_ms": t["library_ms"], **_bound(t["bytes"], t["flops"]),
                **t["extra"]})
            torch.cuda.empty_cache()
    rows.append(_row(
        "flash_decode_hs", "moss_ttsd_torch/csrc/flash_decode.cu",
        "moss_ttsd_tpu/ops/pallas_attention.py:203 (flash_decode_hs / "
        "_decode_kernel)", main["launches"]["flash_decode_hs"],
        checks["flash_decode_hs:main"], dt["ms"], dt["plain_ms"],
        dt["library_ms"], dt["bytes"], dt["flops"],
        {**dt["extra"], "design":
         "split-K: the capacity cut into n_split chunks of whole 64-slot "
         "tiles (decode_split_plan), one block per (chunk, kv-head, row), "
         "cp.async "
         "double-buffered tiles, the last block of each (kv-head, row) "
         "merges the fp32 partials in the same launch"}))
    if longform is not None:
        rows.append(int8_decode_row(longform, checks, SETS, sweep))
    if pool is not None:
        oks = []
        _add_entries(rows, pool_kernel_rows(pool, oks, SETS), "pool")
        if not all(oks):
            emit({"kernels": rows})
            raise SystemExit("a kernel disagrees with its plain version at "
                             "the pool's shapes")
    if mesh is not None:
        oks = []
        _add_entries(rows, mesh_kernel_rows(mesh, oks, SETS), "tp")
        if not all(oks):
            emit({"kernels": rows})
            raise SystemExit("a kernel disagrees with its plain version at "
                             "a tensor-parallel rank's shapes")
    if load is not None:
        for r in rows:
            r["load_launches"] = load_launches[r["name"]]
    emit({"kernels": rows})
    return rows


def _add_entries(rows, extra, key):
    """``extra`` {kernel: {entry: ...}} under ``key`` of each kernel's row;
    a kernel without a row (B3 when the int8 phase did not run) gets one
    from its first entry."""
    by_name = {r["name"]: r for r in rows}
    for name, entries in extra.items():
        if name in by_name:
            by_name[name][key] = entries
            continue
        e = next(iter(entries.values()))
        rows.append(_row(
            name, "moss_ttsd_torch/csrc/flash_decode_int8.cu",
            "moss_ttsd_tpu/ops/pallas_attention.py:311 "
            "(flash_decode_int8_hs / _decode_int8_kernel)",
            e["launches"], {"max_abs_err": e["max_abs_err"],
                            "tolerance": e["tolerance"], "ok": e["pass"]},
            e["ms"], e["plain_ms"], None, e["bytes"], e["flops"],
            {key: entries}))


def decode_times(gen, B, S, ext, pads, H, Hkv, D, SETS, sweep=False):
    """flash_decode_hs at a run's shapes: a cache of capacity S, the extent
    ``ext``, the run's left padding; kernel, plain and SDPA ms over SETS
    rotated input sets, the bytes and flops of the valid slots below the
    extent (all the function must read), and the kernel's plan
    (decode_split_plan). ``sweep``: also at other splits
    (``split_sweep_ms``)."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    scale = D ** -0.5
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    qd = _rand(gen, (B, 1, H, D), bf)
    ds = [(_rand(gen, (B, Hkv, S, D), bf), _rand(gen, (B, Hkv, S, D), bf))
          for _ in range(SETS)]
    vd = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        vd[b, p:ext] = True
    nvd = int(vd.sum())
    qdh = qd.transpose(1, 2)
    lib = lambda i: F.scaled_dot_product_attention(
        qdh, ds[i % SETS][0][:, :, :ext], ds[i % SETS][1][:, :, :ext],
        attn_mask=vd[:, None, None, :ext], scale=scale, enable_gqa=True)
    decode = lambda split: lambda i: fa.flash_decode_hs(
        qd, *ds[i % SETS], vd, scale, extent=ext, split=split)
    extra = {"shape": [B, S, H, Hkv, D], "dtype": "bfloat16", "extent": ext,
             "left_pad": list(pads), "input_sets": SETS, "n_split": n_split,
             "chunk": chunk, "blocks": B * Hkv * n_split}
    if sweep:
        extra["split_sweep_ms"] = {"%dx%d" % split: cuda_ms(decode(split),
                                                            2 * SETS)
                                   for split in _split_sweep(S)}
    return {"ms": cuda_ms(decode(None), 2 * SETS),
            "plain_ms": cuda_ms(lambda i: fa.flash_decode_hs_plain(
                qd, *ds[i % SETS], vd, scale, extent=ext, p_dtype=bf), SETS),
            "library_ms": cuda_ms(lib, 2 * SETS),
            "bytes": 2 * (2 * qd.numel() + 2 * Hkv * D * nvd) + B * ext,
            "flops": 4 * D * H * nvd, "extra": extra}


# (name, B, capacity, extent, left pads) of flash_decode_hs's shape sweep
SWEEP_SHAPES = (("B8_main", 8, 633, 505, [92, 177] * 4),
                ("B3_S1024", 3, 1024, 900, [0, 54, 140]),
                ("B3_S1557", 3, 1557, 1400, [0, 54, 140]),
                ("B3_S2048", 3, 2048, 1900, [0, 54, 140]),
                ("B8_S1557", 8, 1557, 1400, [0, 92] * 4),
                ("B1_S2560", 1, 2560, 2400, [0]),
                ("B1_S3072", 1, 3072, 2900, [0]),
                ("B1_S4096", 1, 4096, 4000, [0]))


def _split_sweep(S):
    """The splits of the sweep ("n_split x chunk"): one chunk, two, chunks
    of two tiles, chunks of one tile."""
    tiles = -(-S // 64)
    return [(-(-tiles // per), 64 * per) for per in
            sorted({tiles, -(-tiles // 2), 2, 1}, reverse=True)]


def int8_decode_row(lf, checks, SETS, sweep=False):
    """flash_decode_int8_hs at the long-form run's shapes: B 1, the
    full-capacity cache S = base + buf_steps, the mid-run extent, layer
    views of one (L, ...) int8 stack (L = SETS distinct layers). No single
    PyTorch call attends over an int8 cache, so library_ms is null;
    dequant_sdpa_ms (a cast-and-scale to bf16 of the slots below the
    extent, then SDPA over them) is a reference point, not a library port.
    ``sweep``: also at other splits than its plan (``split_sweep_ms``)."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.ops import flash_attention as fa
    B, H, Hkv, D = lf["batch"], 16, 8, 128
    S = lf["base"] + lf["buf_steps"]
    ext = lf["base"] + (lf["steps"] + 1) // 2
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    scale = D ** -0.5
    q = _rand(gen, (B, 1, H, D), bf)
    kq, ks = _int8_kv(gen, (SETS, B, Hkv, S, D))
    vq, vs = _int8_kv(gen, (SETS, B, Hkv, S, D))
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    valid[:, :ext] = True              # the long-form prompt has no padding
    nv = int(valid.sum())
    nbytes = (2 * Hkv * nv * D            # int8 K and V rows
              + 2 * Hkv * nv * 4          # fp32 k and v scales
              + 2 * 2 * q.numel()         # bf16 q in, out
              + B * ext)                  # key_valid below the extent
    flops = 4 * D * H * nv
    qh = q.transpose(1, 2)

    def dequant_sdpa(i):
        l = i % SETS
        k = kq[l][:, :, :ext].to(bf) * ks[l][:, :, :ext, None].to(bf)
        v = vq[l][:, :, :ext].to(bf) * vs[l][:, :, :ext, None].to(bf)
        return F.scaled_dot_product_attention(
            qh, k, v, attn_mask=valid[:, None, None, :ext], scale=scale,
            enable_gqa=True)
    decode = lambda split: lambda i: fa.flash_decode_int8_hs(
        q, kq, ks, vq, vs, valid, scale, extent=ext, layer=i % SETS,
        split=split)
    n_split, chunk = fa.decode_split_plan(B, Hkv, S,
                                          fa.sm_count(torch.device("cuda")))
    extra = {"shape": [B, S, H, Hkv, D], "dtype": "bfloat16 q, int8 cache",
             "extent": ext, "input_sets": SETS,
             "design": "split-K as flash_decode_hs (the same template over "
                       "an int8 cache): one block per (chunk, kv-head, "
                       "row), cp.async double-buffered int8 tiles with "
                       "their k/v scales, scores (q.kq)*(ks*scale), "
                       "bf16(p*vs) into P.V, the last block of each "
                       "(kv-head, row) merges the fp32 partials in the same "
                       "launch",
             "n_split": n_split, "chunk": chunk, "blocks": B * Hkv * n_split,
             "dequant_sdpa_ms": cuda_ms(dequant_sdpa, 2 * SETS)}
    if sweep:
        extra["split_sweep_ms"] = {"%dx%d" % split: cuda_ms(decode(split),
                                                            2 * SETS)
                                   for split in _split_sweep(S)}
        # the same call over views of capacity ext rounded up to a tile, so
        # that the plan has no chunk past the extent: what the empty chunks
        # and their partials in the merge cost
        Se = -(-ext // 64) * 64
        extra["capacity_at_extent_ms"] = cuda_ms(
            lambda i: fa.flash_decode_int8_hs(
                q, kq[..., :Se, :], ks[..., :Se], vq[..., :Se, :],
                vs[..., :Se], valid[:, :Se], scale, extent=ext,
                layer=i % SETS), 2 * SETS)
    return _row(
        "flash_decode_int8_hs", "moss_ttsd_torch/csrc/flash_decode_int8.cu",
        "moss_ttsd_tpu/ops/pallas_attention.py:311 (flash_decode_int8_hs / "
        "_decode_int8_kernel)", lf["launches"]["flash_decode_int8_hs"],
        checks["flash_decode_int8_hs:longform"],
        cuda_ms(decode(None), 2 * SETS),
        cuda_ms(lambda i: fa.flash_decode_int8_hs_plain(
            q, kq, ks, vq, vs, valid, scale, extent=ext, layer=i % SETS,
            p_dtype=bf), SETS),
        None, nbytes, flops, extra)


def _bound(nbytes, flops):
    """bound_ms and bound_by of a function that must move ``nbytes`` and do
    ``flops`` bf16 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _row(name, source, replaces, launches, check, ms, plain_ms, library_ms,
         nbytes, flops, extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": check["max_abs_err"],
            "tolerance": check["tolerance"], "pass": check["ok"],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            **_bound(nbytes, flops),
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            **extra}


# ---------------------------------------------------------------------------

def _release() -> None:
    """Free what the phase before left: its spies leave bound methods on its
    pipeline (a reference cycle), which only a collection frees, so that
    the next phase's peak memory counts its own pipeline alone."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of kernels,reference,main,logits,"
                         "stream,overlap,podcast,server,pool,clone,int8,"
                         "mesh,load,train,codec_train,cli,profile,sweep "
                         "(default all = every phase but profile and sweep)")
    ap.add_argument("--rss_probe", metavar="DIR",
                    help="only load the HF-format LM directory DIR to the "
                         "card and print its host peak RSS (the load "
                         "phase runs this in a fresh process)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 1
    if args.rss_probe:
        return rss_probe(args.rss_probe)
    from moss_ttsd_torch.ops import flash_attention as fa
    phases = ({"kernels", "reference", "main", "logits", "stream",
               "overlap", "podcast", "server", "pool", "clone", "int8",
               "mesh", "load", "train", "codec_train", "cli"}
              if args.phases == "all" else set(args.phases.split(",")))
    # fp32 comparisons are held in true fp32; the serving path runs the LM
    # and codec in bf16, where the TF32 flags do not apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(smi_line, flush=True)
    emit({"phase": "device", "nvidia_smi": smi_line,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    fa.build_kernels()
    ptxas = {n: [l.strip()[:160] for l in log.splitlines()
                 if any(w in l for w in ("registers", "spill", "entry",
                                         "warning", "wgmma"))]
             for n, log in fa.build_info.get("ptxas", {}).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": fa.build_info.get("compiled"), "ptxas": ptxas})

    checks = kernel_checks() if "kernels" in phases else {}
    if "reference" in phases:
        reference_check()
    main_line = longform = clone_line = stream_line = pool_line = None
    load_line = pipe = None
    if "main" in phases:
        pipe, main_line = main_path()
        if "logits" in phases:
            logits_check(pipe)
        if "profile" in phases:
            profile_decode("main_path", *decode_state(pipe, load_items()))
    # streaming, the overlap, the podcast, the servers and the pool run the
    # main path's pipeline
    if phases & {"stream", "overlap", "podcast", "server", "pool", "load"}:
        if pipe is None:
            pipe = build_full_pipeline()[0]
        if "stream" in phases:
            stream_line = stream_phase(pipe)
        if "overlap" in phases:
            overlap_phase(pipe)
        if "podcast" in phases:
            podcast_phase(pipe)
        if "server" in phases:
            server_phase(pipe)
            continuous_server_part(pipe)
        if "pool" in phases:
            pool_line = pool_phase(pipe)
        if "load" in phases:
            _release()
            load_line = load_phase(pipe, smi_line)
    del pipe
    _release()
    if "clone" in phases:
        clone_line = clone_phase("profile" in phases)
        _release()
    if "int8" in phases:
        longform = int8_phase("profile" in phases)[-1]
        torch.cuda.empty_cache()
    mesh_line = None
    if "mesh" in phases:
        # the ranks share the card: this process holds nothing of before
        _release()
        mesh_line = mesh_phase(smi_line)
        _release()
    if "kernels" in phases and main_line is not None:
        kernel_table(main_line, longform, checks, clone_line, stream_line,
                     "sweep" in phases, pool_line, load_line, mesh_line)
        torch.cuda.empty_cache()
    else:
        # --phases pool or mesh without main: their kernel entries on a
        # line of their own
        for line, rows_of, name in ((pool_line, pool_kernel_rows, "pool"),
                                    (mesh_line, mesh_kernel_rows, "mesh")):
            if line is None:
                continue
            extra = rows_of(line, oks := [], 28)
            emit({f"{name}_kernels": extra})
            if not all(oks):
                raise SystemExit("a kernel disagrees with its plain version "
                                 f"at the {name} phase's shapes")
    if "train" in phases:
        train_phase(smi_line, "profile" in phases)
        _release()
    if "codec_train" in phases:
        codec_train_phase(smi_line)
        _release()
    if "cli" in phases:
        cli_check()
        train_cli_check()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
