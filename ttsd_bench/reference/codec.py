"""The plain XY-Tokenizer decoder (codes -> 24 kHz audio), for judging the
audio the port served from its own codes.

One window of codes (nq, L) with its valid length n: the RVQ codebook sum
and output projection, the post-RVQ adapter transformer, the x4 transposed
convolution, the acoustic decoder transformer and its two transposed
convolutions, and the Vocos ConvNeXt backbone with the "same"-padded ISTFT
head; padding past n is masked as the reference masks it (attention keys,
the ConvNeXt inputs, the ISTFT frames). Weights carry the port's state-dict
names (``ttsd_bench/weights.py``).

The windowing is the reference's chunking contract: 30 s windows (375
codes) every 20 s, the first 20 s of each kept, a partial window padded to
a quarter-window bucket; a stream re-runs a sliding window with 25 codes of
left context and emits the new frames. PCM is quantized as served:
clip to [-1, 1], times 32767, truncated to int16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], 1)
                            .astype(np.float32))


def decoder_spec(c: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor the decoder reads."""
    q, pa, dec, vc = (c["quantizer"], c["post_rvq_adapter"],
                      c["acoustic_decoder"], c["vocos"])
    spec = [("quantizer.codebook", (q["num_quantizers"], q["codebook_size"],
                                    q["codebook_dim"])),
            ("quantizer.output_proj.weight", (q["output_dim"], q["rvq_dim"])),
            ("quantizer.output_proj.bias", (q["output_dim"],))]

    def stack(prefix, layers, d, ffn):
        out = []
        for i in range(layers):
            p = f"{prefix}.layers.{i}."
            out += [(p + "attn_ln.weight", (d,)), (p + "attn_ln.bias", (d,)),
                    (p + "ffn_ln.weight", (d,)), (p + "ffn_ln.bias", (d,)),
                    (p + "fc1.weight", (ffn, d)), (p + "fc1.bias", (ffn,)),
                    (p + "fc2.weight", (d, ffn)), (p + "fc2.bias", (d,))]
            out += [(p + f"attn.{n}", (d, d)) for n in ("q_w", "k_w", "v_w",
                                                         "o_w")]
            out += [(p + f"attn.{n}", (d,)) for n in ("q_b", "v_b", "o_b")]
        return out + [(f"{prefix}.final_ln.weight", (d,)),
                      (f"{prefix}.final_ln.bias", (d,))]

    d = pa["d_model"]
    spec += stack("post_rvq_adapter", pa["encoder_layers"], d,
                  pa["encoder_ffn_dim"])
    spec += [("post_rvq_adapter.in_proj.weight", (d, pa["input_dim"])),
             ("post_rvq_adapter.in_proj.bias", (d,)),
             ("post_rvq_adapter.out_proj.weight", (pa["output_dim"], d)),
             ("post_rvq_adapter.out_proj.bias", (pa["output_dim"],))]
    ud, us = c["upsample_d_model"], c["upsample_stride"]
    spec += [("upsample.up_conv.weight", (ud * us, ud, us))]
    dd = dec["d_model"]
    spec += stack("acoustic_decoder", dec["decoder_layers"], dd,
                  dec["decoder_ffn_dim"])
    k = dec["kernel_size"]
    spec += [("acoustic_decoder.deconv1.weight", (dd, dd, k)),
             ("acoustic_decoder.deconv1.bias", (dd,)),
             ("acoustic_decoder.deconv2.weight", (dd, dec["num_mel_bins"], k)),
             ("acoustic_decoder.deconv2.bias", (dec["num_mel_bins"],))]
    vd, vi = vc["dim"], vc["intermediate_dim"]
    spec += [("vocos.backbone.embed.weight", (vd, vc["input_channels"], 7)),
             ("vocos.backbone.embed.bias", (vd,)),
             ("vocos.backbone.norm.weight", (vd,)),
             ("vocos.backbone.norm.bias", (vd,)),
             ("vocos.backbone.final_ln.weight", (vd,)),
             ("vocos.backbone.final_ln.bias", (vd,)),
             ("vocos.head.out.weight", (vc["n_fft"] + 2, vd)),
             ("vocos.head.out.bias", (vc["n_fft"] + 2,))]
    for i in range(vc["num_layers"]):
        p = f"vocos.backbone.blocks.{i}."
        spec += [(p + "dwconv.weight", (vd, 1, 7)), (p + "dwconv.bias", (vd,)),
                 (p + "norm.weight", (vd,)), (p + "norm.bias", (vd,)),
                 (p + "pwconv1.weight", (vi, vd)), (p + "pwconv1.bias", (vi,)),
                 (p + "pwconv2.weight", (vd, vi)), (p + "pwconv2.bias", (vd,)),
                 (p + "gamma", (vd,))]
    return spec


def _ln(x, w, p):
    return F.layer_norm(x, x.shape[-1:], w[p + ".weight"].to(x.dtype),
                        w[p + ".bias"].to(x.dtype), LN_EPS)


def _lin(x, w, p):
    return F.linear(x, w[p + ".weight"].to(x.dtype), w[p + ".bias"].to(x.dtype))


class RefCodec:
    """The decoder over a {name: tensor} dict; ``dtype`` the compute dtype
    (float32 for the reference, lower for a control, whose matrices and
    convolutions may also be stored in a lower ``weight_format``, one
    scale per output row); the RVQ sum, the position adds, the softmax and
    the ISTFT stay float32."""

    def __init__(self, codec_cfg: dict, weights: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32,
                 weight_format: Optional[str] = None):
        from .lm import fake_quant
        self.c = codec_cfg
        self.dtype = dtype
        self.w = {}
        for n, t in weights.items():
            if n.startswith("quantizer."):
                self.w[n] = t.float()
                continue
            if weight_format is not None and t.dim() >= 2:
                t = fake_quant(t.reshape(t.shape[0], -1), weight_format
                               ).reshape(t.shape)
            self.w[n] = t.to(dtype)
        dev = next(iter(weights.values())).device
        self.pos = {k: sinusoids(self.c[k]["max_source_positions"]
                                 if k == "post_rvq_adapter" else
                                 (self.c[k]["max_audio_seconds"]
                                  * self.c[k]["sampling_rate"]
                                  // self.c[k]["hop_length"])
                                 // self.c[k]["stride_size"],
                                 self.c[k]["d_model"]).to(dev)
                    for k in ("post_rvq_adapter", "acoustic_decoder")}

    def _stack(self, x, lengths, prefix, layers, heads):
        w = self.w
        T = x.shape[1]
        x = (x.float() + self.pos[prefix][:T]).to(x.dtype)
        mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        for i in range(layers):
            p = f"{prefix}.layers.{i}."
            h = _ln(x, w, p + "attn_ln")
            B, _, D = h.shape
            hd = D // heads
            q = ((h @ w[p + "attn.q_w"] + w[p + "attn.q_b"]) * hd ** -0.5)
            k = h @ w[p + "attn.k_w"]
            v = h @ w[p + "attn.v_w"] + w[p + "attn.v_b"]
            q, k, v = (t.view(B, T, heads, hd).transpose(1, 2)
                       for t in (q, k, v))
            s = (q @ k.transpose(-1, -2)).float()
            s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
            a = (torch.softmax(s, -1).to(v.dtype) @ v).transpose(1, 2)
            x = x + (a.reshape(B, T, D) @ w[p + "attn.o_w"] + w[p + "attn.o_b"])
            h = _ln(x, w, p + "ffn_ln")
            x = x + _lin(F.gelu(_lin(h, w, p + "fc1")), w, p + "fc2")
        x = _ln(x, w, f"{prefix}.final_ln")
        return torch.where(mask[:, :, None], x, torch.zeros_like(x))

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        """codes (nq, B, L), lengths (B,) -> float32 audio (B, L * 1920);
        samples past a row's length are 0."""
        c, w, dt = self.c, self.w, self.dtype
        cb = w["quantizer.codebook"]
        emb = sum(cb[i][codes[i].long()] for i in range(codes.shape[0]))
        z = _lin(emb, w, "quantizer.output_proj").to(dt)
        pa = c["post_rvq_adapter"]
        h = _lin(z, w, "post_rvq_adapter.in_proj")
        h = self._stack(h, lengths, "post_rvq_adapter", pa["encoder_layers"],
                        pa["encoder_attention_heads"])
        h = _lin(h, w, "post_rvq_adapter.out_proj")
        st = c["upsample_stride"]
        h = F.conv_transpose1d(h.transpose(1, 2), w["upsample.up_conv.weight"],
                               stride=st).transpose(1, 2)
        lengths = lengths * st
        dec = c["acoustic_decoder"]
        T = h.shape[1]
        h = self._stack(h, lengths, "acoustic_decoder", dec["decoder_layers"],
                        dec["decoder_attention_heads"])
        h = F.gelu(F.conv_transpose1d(
            h.transpose(1, 2), w["acoustic_decoder.deconv1.weight"],
            w["acoustic_decoder.deconv1.bias"], stride=dec["stride_size"]))
        h = F.gelu(F.conv_transpose1d(
            h, w["acoustic_decoder.deconv2.weight"],
            w["acoustic_decoder.deconv2.bias"], stride=1))
        h = h.transpose(1, 2)[:, :T * dec["stride_size"]]
        lengths = lengths * dec["stride_size"]
        return self._vocos(h, lengths)

    def _vocos(self, x, lengths):
        vc, w = self.c["vocos"], self.w
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths[:, None])[..., None]

        def conv(x, p, groups=1):
            return F.conv1d(x.transpose(1, 2), w[p + ".weight"],
                            w[p + ".bias"], padding=3,
                            groups=groups).transpose(1, 2)

        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = _ln(conv(torch.where(mask, x, zero), "vocos.backbone.embed"), w,
                "vocos.backbone.norm")
        for i in range(vc["num_layers"]):
            p = f"vocos.backbone.blocks.{i}."
            x = torch.where(mask, x, zero)
            r = x
            h = _ln(conv(x, p + "dwconv", groups=x.shape[-1]), w, p + "norm")
            h = _lin(F.gelu(_lin(h, w, p + "pwconv1")), w, p + "pwconv2")
            x = r + w[p + "gamma"] * h
        x = _ln(x, w, "vocos.backbone.final_ln")
        h = _lin(x, w, "vocos.head.out").transpose(1, 2)
        n_fft, hop = vc["n_fft"], vc["hop_size"]
        nb = n_fft // 2 + 1
        mag = torch.clamp(torch.exp(h[:, :nb].float()), max=1e2)
        ph = h[:, nb:].float()
        return istft_same(mag * torch.cos(ph), mag * torch.sin(ph), n_fft,
                          hop, lengths)


def istft_same(re, im, n_fft: int, hop: int, frames: torch.Tensor):
    """"same"-padded inverse STFT of (B, bins, T), periodic Hann window,
    frames past each row's count dropped from the sum and the envelope."""
    B, _, T = re.shape
    x = torch.fft.irfft(torch.complex(re, im).transpose(1, 2), n=n_fft,
                        dim=-1)                                # (B, T, n)
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                            device=re.device).float()
    valid = (torch.arange(T, device=re.device)[None, :]
             < frames[:, None]).float()
    x = x * win * valid[..., None]
    out_len = (T - 1) * hop + n_fft
    y = torch.zeros(B, out_len, device=re.device)
    env = torch.zeros(B, out_len, device=re.device)
    idx = (torch.arange(T, device=re.device)[:, None] * hop
           + torch.arange(n_fft, device=re.device)[None, :]).reshape(-1)
    y.index_add_(1, idx, x.reshape(B, -1))
    env.index_add_(1, idx, ((win ** 2)[None, None, :] * valid[..., None])
                   .reshape(B, -1))
    y = torch.where(env > 1e-11, y / env.clamp_min(1e-11), 0.0)
    pad = (n_fft - hop) // 2
    return y[:, pad:out_len - pad]


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """As served: clip to [-1, 1], times 32767, truncated to int16."""
    return (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def buckets(window: int) -> List[int]:
    return sorted({-(-window * q // 4) for q in (1, 2, 3, 4)})


def run_window(codec: RefCodec, codes: np.ndarray, start: int, n: int,
               window: int, device) -> torch.Tensor:
    """Codes [start, start + n) of one row (nq, T) in the smallest bucket
    that holds n -> float32 audio of the n frames."""
    L = next(b for b in buckets(window) if b >= n)
    buf = np.zeros((codes.shape[0], 1, L), np.int64)
    seg = codes[:, start:start + n]
    buf[:, 0, :seg.shape[1]] = seg
    wav = codec.decode(torch.as_tensor(buf, device=device),
                       torch.tensor([n], device=device))
    return wav[0, :n * 1920]


def batch_audio(codec: RefCodec, codes: np.ndarray, window: int = 375,
                stride: int = 250, device="cuda") -> torch.Tensor:
    """One row's whole audio as the batch path decodes it: a window at
    every ``stride`` codes, the first ``stride`` codes' audio of each kept,
    int16 PCM."""
    T = codes.shape[1]
    parts = []
    for start in range(0, T, stride):
        n = min(window, T - start)
        wav = run_window(codec, codes, start, n, window, device)
        parts.append(pcm16(wav[:min(n, stride) * 1920]))
    return torch.cat(parts)


def stream_windows(budget: int, segment: int = 25, channels: int = 8,
                   context: int = 25, window: int = 375) -> List[tuple]:
    """The stream vocoder's windows for a request of ``budget`` decode
    steps in a pool that services its streams every ``segment`` steps: a
    feed at every service before the request finishes (frames valid: steps
    - channels + 1), then the drain. Returns [(start, end, emit_from)]:
    the codes the window runs and the first frame it emits."""
    ends = [k * segment - channels + 1 for k in range(1, budget)
            if k * segment < budget]
    final = budget - channels + 1
    out, emitted = [], 0
    for end in ends:
        if end > emitted:
            start = max(0, emitted - context)
            end_c = min(end, start + window)
            out.append((start, end_c, emitted))
            emitted = end_c
    while final > emitted:
        start = max(0, emitted - context)
        end_c = min(final, start + window)
        out.append((start, end_c, emitted))
        emitted = end_c
    return out


def stream_audio(codec: RefCodec, codes: np.ndarray, budget: int,
                 segment: int = 25, window: int = 375, device="cuda"
                 ) -> torch.Tensor:
    """A stream's whole PCM as served: each window's new frames, int16
    twice over (the stream vocoder's int16 read back as a float, then the
    server's)."""
    parts = []
    for start, end, emit_from in stream_windows(budget, segment,
                                                window=window):
        wav = run_window(codec, codes, start, end - start, window, device)
        first = pcm16(wav[(emit_from - start) * 1920:]).float() / 32768.0
        parts.append(pcm16(first))
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int16)


def unshift(tokens: np.ndarray, base: int, channels: int, offset: int,
            pad: int, codebook: int) -> np.ndarray:
    """Served token rows (rows, C) from ``base`` on -> codec codes (nq, T):
    the delay pattern undone, channel 0 less ``offset``, cut after the
    last frame whose channel 1 is not the speech pad, clipped into the
    codebook."""
    gen = tokens[base:]
    T = gen.shape[0] - channels + 1
    if T <= 0:
        return np.zeros((channels, 0), np.int64)
    ids = np.stack([gen[j:T + j, j] for j in range(channels)], -1)
    ids[:, 0] -= offset
    valid = np.nonzero(ids[:, 1] != pad)[0]
    n = int(valid[-1]) + 1 if valid.size else 0
    return np.clip(ids[:n].T, 0, codebook - 1)
