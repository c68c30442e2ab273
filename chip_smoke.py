#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (moss_ttsd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line:
  1. device   — the card (nvidia-smi name + power limit), torch / CUDA versions;
  2. build    — nvcc builds of the kernels from csrc/ (seconds, ptxas report);
  3. kernels vs plain — every kernel of the main path against its plain
     PyTorch version on the same inputs: the main path's shapes, the edge
     cases (left padding, fully masked rows, ragged T and S, per-row extents,
     extent 1, layer views) and the --tiny shapes (fp32, head_dim 16);
     reference — small fp32 models on the card vs the same on the CPU (LM
     hidden states, greedy tokens, codec wav);
  4. main path — TTSPipeline.process_batch at the full MOSS-TTSD-v0.5 width
     (LMConfig(), CodecConfig(), random weights from a seeded generator,
     bf16 LM and codec) over examples/examples_only_text.jsonl with
     max_new_tokens=256; launch counts must be 28 x prefills and 28 x steps;
  5. logits   — fp32-output vs bf16-rounded tied-head logits (time, error);
  6. cli      — the --tiny CLI on the card writes wavs;
then the ``kernels`` line (times, bounds, launches) and, last, the result
line {"ok": true, "device": {...}}. Any failing phase exits non-zero with no
result line. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
JSONL = os.path.join(ROOT, "examples", "examples_only_text.jsonl")
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


def decode_case(gen, name, B, S, H, Hkv, D, dtype, valid_spans, extent,
                layers=None, layer=None):
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa
    q = _rand(gen, (B, 1, H, D), dtype)
    shape = (B, Hkv, S, D) if layers is None else (layers, B, Hkv, S, D)
    kt = _rand(gen, shape, dtype)
    vt = _rand(gen, shape, dtype)
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, (lo, hi) in enumerate(valid_spans):
        valid[b, lo:hi] = True
    ext = extent
    if isinstance(extent, list):
        ext = torch.tensor(extent, dtype=torch.int32, device="cuda")
    out = fa.flash_decode_hs(q, kt, vt, valid, D ** -0.5, extent=ext,
                             layer=layer)
    torch.cuda.synchronize()
    ref = fa.flash_decode_hs_plain(q, kt, vt, valid, D ** -0.5, extent=ext,
                                   layer=layer, out_dtype=torch.float32)
    return {"kernel": "flash_decode_hs", "case": name,
            "shape": [B, S, H, Hkv, D], "extent": extent, "layer": layer,
            **compare(out, ref)}


def kernel_checks():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        # the main path's own shapes: bf16, 16/8 heads, D=128, T = base 377,
        # the two example items left-padded by 92 and 177 slots
        prefill_case(gen, "main", 2, 377, 16, 8, 128, bf, (92, 177)),
        prefill_case(gen, "main_fp32", 2, 377, 16, 8, 128, f32, (92, 177)),
        # ragged T (never a tile multiple), left padding, fully masked rows
        prefill_case(gen, "T1", 2, 1, 16, 8, 128, bf, (0, 1)),
        prefill_case(gen, "T7", 2, 7, 16, 8, 128, bf, (0, 3)),
        prefill_case(gen, "T121", 3, 121, 16, 8, 128, bf, (0, 40, 121)),
        prefill_case(gen, "D64", 2, 70, 8, 2, 64, f32, (5, 0)),
        prefill_case(gen, "D32", 2, 33, 4, 4, 32, f32, (0, 2)),
        # --tiny shapes: fp32, 4/2 heads, D=16
        prefill_case(gen, "tiny", 2, 57, 4, 2, 16, f32, (0, 9)),
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

def build_full_pipeline():
    import torch
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             CodecConfig, LMConfig,
                                             SamplingConfig)
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer

    cfg = LMConfig()
    # the whole vocab counts as speech, so random weights never trigger the
    # EOS flush and the decode runs its whole budget (as bench.py does)
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
        max_new_tokens=256)
    return TTSPipeline(MockTokenizer(), cfg, model, spt, sampling,
                       bucket=128, device="cuda"), cfg


def decode_state(pipe, items):
    """A prefilled decode state of the main path's batch (for the
    measurements that drive the engine's step loop directly)."""
    import torch
    from moss_ttsd_torch.pipeline import prompt as pp
    from moss_ttsd_torch.pipeline.batch import SYSTEM_PROMPT
    eng = pipe.engine
    shifted = [pipe._assemble(pipe._prepare_text(it, False)[0], None,
                              SYSTEM_PROMPT) for it in items]
    batch, mask = pp.left_pad_batch(shifted, pipe.tokenizer.pad_token_id,
                                    pipe.lm_cfg.speech_pad_token)
    ids, m, base = eng._bucket_prompt(batch, mask)
    st = eng.prefill(torch.as_tensor(ids, device="cuda"),
                     torch.as_tensor(m, device="cuda"), base, 256)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    return eng, st, base, gen


def count_syncs_per_step(pipe, items, steps: int = 16) -> float:
    """Host syncs of the decode step, counted by torch's sync debug mode
    over ``steps`` steps past the teacher-forcing window (C - 1 steps),
    i.e. the step that runs for all but the first C - 1 of the budget."""
    import torch
    eng, st, base, gen = decode_state(pipe, items)
    eng.run(st, base, pipe.lm_cfg.channels - 1, gen)
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


def profile_decode(pipe, steps: int = 16):
    """torch.profiler over ``steps`` decode steps of the main path: device
    busy time per step (sum of kernel times; one stream, so kernels do not
    overlap), the idle share of the window, launches per step and the
    kernels that take the most device time. Profiler overhead inflates the
    window's host time, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with open(JSONL) as f:
        items = [json.loads(line) for line in f if line.strip()]
    eng, st, base, gen = decode_state(pipe, items)
    warm = pipe.lm_cfg.channels                     # past the TF window
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
    emit({"phase": "profile", "steps": steps,
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
    toks = [GenerationEngine(cfg, m, greedy, bucket=32, device=dev)
            .generate(prompt, mask, 12).tokens
            for m, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    tok_match = float(np.mean(toks[0] == toks[1])) \
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
    ok = lm_err <= 1e-4 and codec_err <= 1e-4
    emit({"phase": "reference", "lm_hidden_max_abs_err": lm_err,
          "lm_tol": 1e-4, "greedy_token_match": tok_match,
          "codec_wav_max_abs_err": codec_err, "codec_tol": 1e-4, "ok": ok})
    if not ok:
        raise SystemExit("card vs CPU reference check failed")


def main_path():
    import numpy as np
    import torch
    from moss_ttsd_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    pipe, cfg = build_full_pipeline()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with open(JSONL) as f:
        items = [json.loads(line) for line in f if line.strip()]

    # warm-up: cuBLAS/cuDNN handles and autotuning, allocator growth
    pipe.process_batch(items, max_new_tokens=16, seed=1)
    torch.cuda.synchronize()
    pipe.timings.__init__()

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    texts, audio = pipe.process_batch(items, max_new_tokens=256, seed=0)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = dict(pipe.engine.last_stats)
    L = cfg.num_hidden_layers

    problems = []
    if any("error" in t for t in texts):
        problems.append(f"item errors: {texts}")
    wav_lens, audio_s = [], 0.0
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
        if n == 0 or n % 1920 or n > (st["steps"] - (cfg.channels - 1)) * 1920:
            problems.append(f"wav length {n} for {st['steps']} steps")
    if counts["flash_prefill"] != L * 1:
        problems.append(f"prefill launches {counts['flash_prefill']} != {L}")
    if counts["flash_decode_hs"] != L * st["steps"]:
        problems.append(f"decode launches {counts['flash_decode_hs']} != "
                        f"{L} x {st['steps']}")
    if st["steps"] != 256:
        problems.append(f"decode ran {st['steps']} of 256 steps")

    syncs = count_syncs_per_step(pipe, items)
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
            "host_syncs_per_step": syncs, "launches": counts,
            "ok": not problems, "problems": problems}
    emit(line)
    if problems:
        raise SystemExit(f"main path failed: {problems}")
    return pipe, line


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
# phase 6: the --tiny CLI on the card
# ---------------------------------------------------------------------------

def cli_check():
    out_dir = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "moss_ttsd_torch.cli.inference",
         "--jsonl", JSONL, "--tiny", "--max_new_tokens", "32",
         "--output_dir", out_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wavs = sorted(f for f in os.listdir(out_dir) if f.endswith(".wav")) \
        if os.path.isdir(out_dir) else []
    ok = proc.returncode == 0 and len(wavs) == 2
    emit({"phase": "cli", "rc": proc.returncode, "wavs": wavs,
          "seconds": time.perf_counter() - t0, "ok": ok,
          "tail": proc.stdout.strip().splitlines()[-2:]})
    shutil.rmtree(out_dir, ignore_errors=True)
    if not ok:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit("tiny CLI failed")


# ---------------------------------------------------------------------------
# kernels line: times at the main path's shapes, bounds, launches
# ---------------------------------------------------------------------------

def kernel_table(main, checks):
    """Times at the main path's shapes. Each timing rotates over ``SETS``
    distinct input sets (one per layer, as the main path reads 28 layer
    caches in turn), ~145-170 MB in all, so inputs come from HBM, not L2.
    Bounds count only what the function must move and compute: the rows
    and slots that are valid in this run's padding."""
    import torch
    import torch.nn.functional as F
    from moss_ttsd_torch.ops import flash_attention as fa
    B, base, steps = main["batch"], main["base"], main["steps"]
    S = base + main["buf_steps"]
    H, Hkv, D, L = 16, 8, 128, main["layers"]
    SETS = L
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = D ** -0.5
    pads = main["left_pad"]
    rows = []

    # prefill at (B, base, 16, 8, 128) with the run's left padding; the
    # left-padded query rows are 0 by contract and their keys are masked
    ps = [tuple(_rand(gen, (B, base, n, D), bf) for n in (H, Hkv, Hkv))
          for _ in range(SETS)]
    valid = _left_pad_valid(B, base, pads)
    nv = int(valid.sum())
    pairs = sum((base - p) * (base - p + 1) // 2 for p in pads)
    p_bytes = 2 * (B * base * H * D + nv * H * D + 2 * nv * Hkv * D) \
        + valid.numel()
    p_flops = 4 * D * H * pairs
    mask = (torch.tril(torch.ones(base, base, dtype=torch.bool,
                                  device="cuda"))[None] & valid[:, None, :])
    psh = [tuple(x.transpose(1, 2) for x in t) for t in ps]
    lib = lambda i: F.scaled_dot_product_attention(
        *psh[i % SETS], attn_mask=mask[:, None], scale=scale,
        enable_gqa=True)
    rows.append(_row(
        "flash_prefill", "moss_ttsd_torch/csrc/flash_prefill.cu",
        "moss_ttsd_tpu/ops/pallas_attention.py:426 (flash_prefill / "
        "_prefill_kernel)", main["launches"]["flash_prefill"],
        checks["flash_prefill:main"],
        cuda_ms(lambda i: fa.flash_prefill(*ps[i % SETS], valid, scale),
                2 * SETS),
        cuda_ms(lambda i: fa.flash_prefill_plain(*ps[i % SETS], valid,
                                                 scale), SETS),
        cuda_ms(lib, 2 * SETS), p_bytes, p_flops,
        {"shape": [B, base, H, Hkv, D], "dtype": "bfloat16",
         "left_pad": pads, "input_sets": SETS}))
    del ps, psh

    # decode at the mid-run extent over the full-capacity cache; only the
    # valid slots below the extent are read by contract
    ext = base + (steps + 1) // 2
    qd = _rand(gen, (B, 1, H, D), bf)
    ds = [(_rand(gen, (B, Hkv, S, D), bf), _rand(gen, (B, Hkv, S, D), bf))
          for _ in range(SETS)]
    vd = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        vd[b, p:ext] = True
    nvd = int(vd.sum())
    d_bytes = 2 * (2 * qd.numel() + 2 * Hkv * D * nvd) + B * ext
    d_flops = 4 * D * H * nvd
    qdh = qd.transpose(1, 2)
    lib_d = lambda i: F.scaled_dot_product_attention(
        qdh, ds[i % SETS][0][:, :, :ext], ds[i % SETS][1][:, :, :ext],
        attn_mask=vd[:, None, None, :ext], scale=scale, enable_gqa=True)
    rows.append(_row(
        "flash_decode_hs", "moss_ttsd_torch/csrc/flash_decode.cu",
        "moss_ttsd_tpu/ops/pallas_attention.py:203 (flash_decode_hs / "
        "_decode_kernel)", main["launches"]["flash_decode_hs"],
        checks["flash_decode_hs:main"],
        cuda_ms(lambda i: fa.flash_decode_hs(qd, *ds[i % SETS], vd, scale,
                                             extent=ext), 2 * SETS),
        cuda_ms(lambda i: fa.flash_decode_hs_plain(qd, *ds[i % SETS], vd,
                                                   scale, extent=ext), SETS),
        cuda_ms(lib_d, 2 * SETS), d_bytes, d_flops,
        {"shape": [B, S, H, Hkv, D], "dtype": "bfloat16", "extent": ext,
         "input_sets": SETS}))
    emit({"kernels": rows})
    return rows


def _row(name, source, replaces, launches, check, ms, plain_ms, library_ms,
         nbytes, flops, extra):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": check["max_abs_err"],
            "tolerance": check["tolerance"], "pass": check["ok"],
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            **extra}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of kernels,reference,main,logits,cli,"
                         "profile "
                         "(default all = every phase but profile)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 1
    from moss_ttsd_torch.ops import flash_attention as fa
    phases = ({"kernels", "reference", "main", "logits", "cli"}
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
    ptxas = {n: [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]
             for n, log in fa.build_info.get("ptxas", {}).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": fa.build_info.get("compiled"), "ptxas": ptxas})

    checks = kernel_checks() if "kernels" in phases else {}
    if "reference" in phases:
        reference_check()
    main_line = None
    if "main" in phases:
        pipe, main_line = main_path()
        if "logits" in phases:
            logits_check(pipe)
        if "profile" in phases:
            profile_decode(pipe)
        if "kernels" in phases:
            kernel_table(main_line, checks)
        del pipe
        torch.cuda.empty_cache()
    if "cli" in phases:
        cli_check()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
