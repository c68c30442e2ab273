"""The comparison that decides ``correct``: the served tokens and audio of
every row a batch window served (of a sample of a server window's
finished requests), judged by the plain reference once the program's
state is freed.

Numbers compared, each against the cell's limit (``limits/<cell>.json``):

* ``prompt_mismatch``: tokens of the prompt and of the teacher-forced
  first channels-1 steps that differ from the reference's own prompt
  assembly (exact: limit 0);
* ``lm_gap_max``: over every sampled (position, channel), the reference's
  best allowed logit minus its logit of the token served there, the
  widest such gap; ``lm_gap_mean``, the same gaps' mean;
* ``lm_gap_rel``: ``lm_gap_mean`` over the mean gap, at the same positions,
  of the tokens that a plain computation of the same model in bf16 (the
  configuration's weights, bf16 arithmetic) puts first. The raw mean is
  set by how often the seed's random model nearly ties its best logits,
  and swings 10x between seeds; the ratio divides that out;
* ``codec_err``: the served PCM against the reference decoder's PCM of the
  served codes, as the norm of the difference over the norm of the
  reference (both int16, the whole sampled audio); a length that differs
  reads 1.

A cell compares the numbers its limits file names. The reference is the
configuration's architecture's (``arch/<name>.py``), and is handed nothing
the program made: the prompts are built again from the scripts, the
weights made again from the seed, the int8 weights or cache quantized
again where the configuration states them.
A control replaces the tokens the program served by the tokens a
lower-precision reference puts first at each position (``lm``), or the
audio by a lower-precision decoder's (``codec``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import arch, weights
from .reference import codec as rcodec
from .reference import lm as rlm
from .reference.prompt import shifted_prompt

NUMBERS = ("prompt_mismatch", "lm_gap_max", "lm_gap_mean", "lm_gap_rel",
           "codec_err")


def pool_int8_kv(pool: dict) -> bool:
    """Whether the pool's KV cache is int8: ``pool_kv_quant`` "int8", or
    "auto" with base + max_steps at 512 or more (the server's stated
    rule)."""
    mode = pool["pool_kv_quant"]
    return mode == "int8" or (mode == "auto" and pool["pool_base"]
                              + pool["pool_max_steps"] >= 512)


def _strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _voices(cfg: dict, seed: int, samples: List[dict], device):
    names = sorted({s["voice"] for s in samples if s.get("voice")})
    if not names:
        return {}
    n = max(int(v[len("voice"):]) for v in names) + 1
    scale = rlm.lora_scale(weights.LORA_RANK, weights.LORA_ALPHA)
    targets = arch.of(cfg).lora_targets(cfg)
    out = {}
    for i, v in enumerate(weights.voices(cfg, seed, n, device)):
        out[f"voice{i}"] = {t: (v[f"{t}.a"], v[f"{t}.b"] * scale)
                            for t in targets}
    return out


def _row(cfg: dict, s: dict, pool_base: Optional[int]):
    """One served row -> (reference input ids (T + steps, C), prompt length
    T, served decode rows (steps, C), teacher-forcing mismatches)."""
    C, pad = cfg["channels"], cfg["speech_pad_token"]
    sp = shifted_prompt(s["script"], C, pad)
    T = sp.shape[0] - (C - 1)
    tok = np.asarray(s["tokens"])
    base = s["base"] if s["base"] is not None else pool_base
    gen = tok[base:]
    steps = gen.shape[0]
    mism = int((tok[base - T:base] != sp[:T]).sum())
    for k in range(min(steps, C - 1)):
        mism += int((gen[k, k + 1:] != sp[T + k, k + 1:]).sum())
    return np.concatenate([sp[:T], gen]), T, gen, mism


def _judged(gen: np.ndarray, cfg: dict) -> torch.Tensor:
    """The sampled (step, channel) entries, up to and including the first
    end-of-speech on channel 0 (what follows is the flush's fill)."""
    steps, C = gen.shape
    m = rlm.sampled_mask(steps, C)
    eos = np.nonzero(gen[:, 0] == cfg["eos_token_id"])[0]
    if eos.size:
        m[int(eos[0]) + 1:] = False
    return m


def judge(cfg: dict, kind: str, samples: List[dict], seed: int, device,
          pool: Optional[dict] = None, control: Optional[str] = None
          ) -> Dict[str, float]:
    """The numbers of ``NUMBERS`` for the samples. ``kind`` "batch" or
    "server"; ``pool`` the traffic file of a server cell (base, segment
    steps, int8 cache). ``control`` "lm:<fmt>" or "codec:<fmt>" reads a
    lower-precision reference's tokens or audio in place of the served
    ones (fmt "int8", "int4", "fp8")."""
    _strict_fp32()
    out = {"prompt_mismatch": 0.0, "lm_gap_max": 0.0, "lm_gap_mean": 0.0,
           "lm_gap_rel": 0.0, "codec_err": 1.0}
    if not samples:
        return out
    pool_base = pool["pool_base"] if pool else None
    kv_bits = 8 if pool and pool_int8_kv(pool) else None
    fmt = "int8" if cfg["quant"] == "int8" else None
    lm_arch = arch.of(cfg)
    W = weights.make(lm_arch.lm_spec(cfg), lm_arch.lm_rule, seed,
                     weights.GROUPS["lm"], device, torch.bfloat16)
    ref = lm_arch.reference(cfg, W, fmt)
    plain = lm_arch.reference(cfg, W, fmt, dtype=torch.bfloat16)
    ctl = None
    if control and control.startswith("lm:"):
        ctl = lm_arch.reference(cfg, W, control[3:], dtype=torch.bfloat16)
    del W
    voices = _voices(cfg, seed, samples, device)
    all_gaps, plain_gaps, mism, codes = [], [], 0, []
    for s in samples:
        ids, T, gen, m = _row(cfg, s, pool_base)
        mism += m
        ids_t = torch.as_tensor(ids, device=device)
        voice = voices.get(s.get("voice"))
        with torch.no_grad():
            hid = ref.hidden(ids_t, T, kv_bits, voice)[T - 1:-1]
            steps = torch.arange(gen.shape[0], device=device)
            served = torch.as_tensor(gen, device=device)
            if ctl is not None:
                hc = ctl.hidden(ids_t, T, kv_bits, voice)[T - 1:-1]
                served = rlm.argmax_tokens(ctl, hc, steps)
                del hc
            judged = _judged(gen, cfg).to(device)
            g = rlm.gaps(ref, hid, served, steps, judged)
            hp = plain.hidden(ids_t, T, kv_bits, voice)[T - 1:-1]
            gp = rlm.gaps(ref, hid, rlm.argmax_tokens(plain, hp, steps),
                          steps, judged)
            del hp
        all_gaps.append(g.float().cpu())
        plain_gaps.append(gp.float().cpu())
        codes.append(rcodec.unshift(
            np.asarray(s["tokens"]),
            s["base"] if s["base"] is not None else pool_base,
            cfg["channels"], cfg["speech_token_range"][0],
            cfg["speech_pad_token"], cfg["codec"]["quantizer"]["codebook_size"]))
    del ref, plain, ctl
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    gaps = torch.cat(all_gaps)
    out["prompt_mismatch"] = float(mism)
    out["lm_gap_max"] = float(gaps.max()) if gaps.numel() else 0.0
    out["lm_gap_mean"] = float(gaps.mean()) if gaps.numel() else 0.0
    plain_mean = float(torch.cat(plain_gaps).mean()) if gaps.numel() else 0.0
    out["lm_gap_rel"] = (out["lm_gap_mean"] / max(plain_mean, 1e-12)
                         if out["lm_gap_mean"] else 0.0)
    # not compared: the readings' look at how often a served token is not
    # the reference's best
    out["lm_flips"] = float((gaps > 0).float().mean()) if gaps.numel() else 0.0
    out["codec_err"] = _codec(cfg, kind, samples, codes, seed, device, pool,
                              control)
    return out


def _codec(cfg, kind, samples, codes, seed, device, pool, control) -> float:
    c = cfg["codec"]
    W = weights.make(rcodec.decoder_spec(c),
                     weights.codec_rule(c["vocos"]["num_layers"]), seed,
                     weights.GROUPS["codec_decoder"], device, torch.float32)
    ref = rcodec.RefCodec(c, W)
    ctl = None
    if control and control.startswith("codec:"):
        ctl = rcodec.RefCodec(c, W, weight_format=control[6:],
                              dtype=torch.bfloat16)
    del W
    window = 30 * c["input_sample_rate"] // c["encoder_downsample_rate"]
    diff = norm = 0.0
    for s, cd in zip(samples, codes):
        if kind == "batch":
            r = rcodec.batch_audio(ref, cd, window, device=device)
            p = (None if s["audio"] is None else
                 torch.as_tensor(np.rint(s["audio"] * 32768.0)
                                 .astype(np.int16), device=device))
            if ctl is not None:
                p = rcodec.batch_audio(ctl, cd, window, device=device)
        else:
            steps = np.asarray(s["tokens"]).shape[0] - pool["pool_base"]
            r = rcodec.stream_audio(ref, cd, steps, pool["segment_steps"],
                                    window, device=device)
            p = torch.as_tensor(np.frombuffer(s["pcm"], "<i2").copy(),
                                device=device)
            if ctl is not None:
                p = rcodec.stream_audio(ctl, cd, steps,
                                        pool["segment_steps"], window,
                                        device=device)
        if p is None or p.numel() != r.numel():
            return 1.0
        diff += float(((p.float() - r.float()) ** 2).sum())
        norm += float((r.float() ** 2).sum())
    return (diff / norm) ** 0.5 if norm > 0 else 1.0
