"""The plain MOSS-TTSD language model (AsteroidTTS on a Qwen3 backbone), for
judging served tokens.

A full causal forward of one row (no cache, no kernels, no batching):
eight embedding tables summed (channel 0 over the text vocab, channels 1-7
over the speech vocab), Qwen3 blocks (RMSNorm, grouped-query attention with
per-head q/k RMSNorm and rotate-half RoPE, SwiGLU), the final RMSNorm, and
the eight heads tied to their tables: the ``asteroid-qwen3`` architecture
(``ttsd_bench/arch/asteroid-qwen3.py`` lists its tensors). Weights carry the
port's state-dict names, so ``ttsd_bench/weights.py`` gives both sides the
same values. The masks, gaps and quantizers below do not depend on the
architecture, and every architecture's check shares them.

Precisions: the reference computes in float32 with TF32 off, over the
configuration's weights (int8 weights, per output row, quantized here from
the bf16 weights where the configuration says int8). ``kv_bits`` stores the
keys and values of positions past the prompt as the configuration's int8
cache does (per head and token, scale amax/127). A control passes a lower
``weight_format`` and ``dtype=torch.bfloat16``: the same model in a lower
precision.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


def fake_quant(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Weights stored in ``fmt`` with one scale per row (over the last
    axis), returned dequantized in float32. "int8" / "int4": symmetric,
    scale max(amax, 1e-8) / qmax, round half to even, clipped to +-qmax;
    "fp8": float8 e4m3 with the row's amax at 448."""
    w = w.float()
    amax = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    if fmt == "fp8":
        scale = amax / 448.0
        return (w / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = {"int8": 127, "int4": 7}[fmt]
    scale = amax / qmax
    return torch.round(w / scale).clamp(-qmax, qmax) * scale


def quantize_kv(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per head and token over the last axis, dequantized: scale
    max(amax / qmax, 1e-8), round half up, clipped to +-qmax."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-8)
    return torch.floor(xf / s + 0.5).clamp(-qmax, qmax) * s


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * w.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) rotated by its positions (T,), rotate-half."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = pos.float()[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)[:, None, :]
    xf = x.float()
    rot = torch.cat([-xf[..., D // 2:], xf[..., :D // 2]], -1)
    return (xf * torch.cos(ang) + rot * torch.sin(ang)).to(x.dtype)


class RefLM:
    """The model over a {name: tensor} weight dict (float32 or bf16
    values), with ``weight_format`` (None, "int8", "int4", "fp8") applied
    to the seven projections and the embedding tables, and ``dtype`` the
    compute dtype (float32 for the reference, bf16 for a control)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 weight_format: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.w: Dict[str, torch.Tensor] = {}
        for name, t in weights.items():
            quant = weight_format is not None and (
                name.startswith("embed_")
                or name.rsplit(".", 2)[-2] in PROJ)
            t = fake_quant(t, weight_format) if quant else t.float()
            self.w[name] = t.to(dtype)

    def hidden(self, ids: torch.Tensor, prompt_len: int,
               kv_bits: Optional[int] = None,
               voice: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]
               = None) -> torch.Tensor:
        """ids (T, C) of one row, unpadded -> (T, hidden) after the final
        norm. Positions from ``prompt_len`` on attend over keys and values
        stored at ``kv_bits`` (None: exact); earlier positions are the
        prefill's and attend exactly. ``voice``: {target: (a (L, in, r), b
        (L, r, out) with the LoRA scale folded in)}."""
        c, w, dt = self.cfg, self.w, self.dtype
        T, C = ids.shape
        H, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        g = H // Hkv
        eps = c["rms_norm_eps"]
        text = ids[:, 0].clamp(0, c["vocab_size"] - 1)
        x = F.embedding(text, w["embed_text"])
        for i in range(1, C):
            sp = ids[:, i].clamp(0, c["speech_vocab_size"] - 1)
            x = x + F.embedding(sp, w["embed_speech"][i - 1])
        pos = torch.arange(T, device=ids.device)
        causal = torch.ones(T, T, dtype=torch.bool,
                            device=ids.device).tril()

        def proj(li, name, h):
            y = h @ w[f"layers.{li}.{name}.weight"].t()
            if voice is not None and name in voice:
                a, b = voice[name]
                y = y + (h @ a[li].to(dt)) @ b[li].to(dt)
            return y

        def attend(q, k, v):
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
            s = torch.einsum("thd,shd->hts", q, k).float() * D ** -0.5
            s = s.masked_fill(~causal[None], float("-inf"))
            p = torch.softmax(s, -1).to(dt)
            return torch.einsum("hts,shd->thd", p, v)

        for li in range(c["num_hidden_layers"]):
            p = f"layers.{li}."
            h = rms_norm(x, w[p + "input_ln.weight"], eps)
            q = proj(li, "q_proj", h).view(T, H, D)
            k = proj(li, "k_proj", h).view(T, Hkv, D)
            v = proj(li, "v_proj", h).view(T, Hkv, D)
            q = rope(rms_norm(q, w[p + "q_norm.weight"], eps), pos,
                     c["rope_theta"])
            k = rope(rms_norm(k, w[p + "k_norm.weight"], eps), pos,
                     c["rope_theta"])
            a = attend(q, k, v)
            if kv_bits is not None and prompt_len < T:
                kq = quantize_kv(k, kv_bits).to(dt)
                vq = quantize_kv(v, kv_bits).to(dt)
                a[prompt_len:] = attend(q, kq, vq)[prompt_len:]
            x = x + proj(li, "o_proj", a.reshape(T, H * D))
            h = rms_norm(x, w[p + "post_ln.weight"], eps)
            act = F.silu(proj(li, "gate_proj", h)) * proj(li, "up_proj", h)
            x = x + proj(li, "down_proj", act)
        return rms_norm(x, w["final_norm.weight"], eps)

    def logits(self, hidden: torch.Tensor, channel: int) -> torch.Tensor:
        """(N, hidden) -> float32 logits of one channel's tied head."""
        table = (self.w["embed_text"] if channel == 0
                 else self.w["embed_speech"][channel - 1])
        return (hidden.to(self.dtype) @ table.t()).float()


def sampled_mask(steps: int, channels: int) -> torch.Tensor:
    """(steps, channels) True where decode step s samples channel c: the
    first channels-1 steps take channel c > s from the prompt's tail."""
    s = torch.arange(steps)[:, None]
    c = torch.arange(channels)[None, :]
    return (s >= channels - 1) | (c <= s)


def masked_for_step(logits: torch.Tensor, channel: int, steps: torch.Tensor,
                    cfg: dict) -> torch.Tensor:
    """The hard masks of the decode loop on (N, V) logits at decode steps
    ``steps`` (N,): end-of-speech is barred on channel 0 inside the first
    channels-1 steps, the speech pad on channel c >= 1 once step >= c."""
    out = logits.clone()
    C = cfg["channels"]
    if channel == 0:
        out[steps < C - 1, cfg["eos_token_id"]] = float("-inf")
    else:
        out[steps >= channel, cfg["speech_pad_token"]] = float("-inf")
    return out


def gaps(model: RefLM, hidden: torch.Tensor, tokens: torch.Tensor,
         steps: torch.Tensor, judged: torch.Tensor, block: int = 256
         ) -> torch.Tensor:
    """For each judged (position, channel): the reference's best allowed
    logit minus its logit of the served token. hidden (N, H) are the
    states that predict the N served rows ``tokens`` (N, C) at decode steps
    ``steps`` (N,); ``judged`` (N, C) bool. Returns the gaps, flat."""
    out = []
    C = tokens.shape[1]
    for c in range(C):
        for b0 in range(0, hidden.shape[0], block):
            sl = slice(b0, b0 + block)
            sel = judged[sl, c]
            if not bool(sel.any()):
                continue
            lg = masked_for_step(model.logits(hidden[sl], c), c, steps[sl],
                                 model.cfg)
            best = lg.amax(-1)
            got = lg.gather(-1, tokens[sl, c:c + 1])[:, 0]
            out.append((best - got)[sel])
    return torch.cat(out) if out else torch.zeros(0)


def argmax_tokens(model: RefLM, hidden: torch.Tensor, steps: torch.Tensor,
                  block: int = 256) -> torch.Tensor:
    """(N, C) the tokens this model puts first at each position, under the
    decode loop's hard masks (a control's served tokens)."""
    cols = []
    for c in range(model.cfg["channels"]):
        parts = []
        for b0 in range(0, hidden.shape[0], block):
            sl = slice(b0, b0 + block)
            lg = masked_for_step(model.logits(hidden[sl], c), c, steps[sl],
                                 model.cfg)
            parts.append(lg.argmax(-1))
        cols.append(torch.cat(parts))
    return torch.stack(cols, -1)


def lora_scale(rank: int, alpha: float) -> float:
    """rsLoRA: alpha / sqrt(rank)."""
    return alpha / math.sqrt(rank)
