"""Codec transformer stack: PyTorch port of
``moss_ttsd_tpu/models/codec/transformer.py`` (sinusoid positions, masked
self-attention, the pre-LN layer, ``AudioEncoder``, ``AdapterTransformer``,
``GatedDownsample``, ``Upsample`` and ``AudioDecoder``).

(B, T, D) layout end to end, as in the JAX package; the convolutions
transpose to torch's (B, C, T) around each call. LayerNorm eps is 1e-6
(flax's default, not torch's 1e-5); GELU is the exact erf form. fp32 islands
in bf16 mode: the positional-embedding add, the softmax and the LayerNorm
statistics.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import (AdapterTransformerConfig, AudioDecoderConfig,
                            AudioEncoderConfig)

LN_EPS = 1e-6


def sinusoid_table(length: int, channels: int,
                   max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper sinusoidal positions: [sin | cos]."""
    assert channels % 2 == 0
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def add_positions(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x + sinusoid positions, added in fp32 and cast back."""
    T = x.shape[1]
    return (x.to(torch.float32) + table[:T]).to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class SelfAttention(nn.Module):
    """Projections for ``masked_attention``; weights stored (in, out) as in
    the JAX tree. k has no bias, q/v/o do (the reference's VarLenAttention)."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for n in ("q_w", "k_w", "v_w", "o_w"):
            setattr(self, n, nn.Parameter(torch.empty(d, d)))
        for n in ("q_b", "v_b", "o_b"):
            setattr(self, n, nn.Parameter(torch.zeros(d)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return masked_attention(x, mask, self.q_w, self.q_b, self.k_w,
                                self.v_w, self.v_b, self.o_w, self.o_b,
                                self.num_heads)


def masked_attention(x, mask, q_w, q_b, k_w, v_w, v_b, o_w, o_b,
                     num_heads: int) -> torch.Tensor:
    """Dense variable-length self-attention. x (B, T, D); mask (B, T) key
    validity. Plain matmuls in the working dtype, fp32 softmax."""
    B, T, D = x.shape
    hd = D // num_heads
    scale = hd ** -0.5
    q = ((x @ q_w + q_b) * scale).reshape(B, T, num_heads, hd).transpose(1, 2)
    k = (x @ k_w).reshape(B, T, num_heads, hd).transpose(1, 2)
    v = (x @ v_w + v_b).reshape(B, T, num_heads, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~mask[:, None, None, :], neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
    return out @ o_w + o_b


class TransformerLayer(nn.Module):
    """Pre-LN attention + GELU FFN block."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = SelfAttention(d, num_heads)
        self.ffn_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.attn_ln), mask)
        h = self.fc2(F.gelu(self.fc1(layer_norm(x, self.ffn_ln))))
        x = x + h
        if x.dtype in (torch.float16, torch.bfloat16):
            # the reference's NaN/Inf guard
            clamp = float(torch.finfo(x.dtype).max) - 1000.0
            x = torch.clamp(x, -clamp, clamp)
        return x


class _Stack(nn.Module):
    """N transformer layers + final LN + zeroed padding, with positions."""

    def __init__(self, num_layers, d, heads, ffn, max_pos):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer(d, heads, ffn)
                                    for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.register_buffer("pos", torch.from_numpy(
            sinusoid_table(max_pos, d)), persistent=False)

    def run(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = add_positions(x, self.pos)
        mask = length_mask(lengths, x.shape[1])
        for layer in self.layers:
            x = layer(x, mask)
        x = layer_norm(x, self.final_ln)
        return torch.where(mask[:, :, None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class AudioEncoder(_Stack):
    """Mel -> hidden states at half rate: conv(k3, p1) + GELU, conv(k3, s2,
    p1) + GELU, positions (fp32 add), N layers, final LN, zeroed padding.
    Input (B, T_mel, n_mels) -> (B, T_mel // 2, d_model), lengths // 2."""

    def __init__(self, cfg: AudioEncoderConfig):
        super().__init__(cfg.encoder_layers, cfg.d_model,
                         cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
                         cfg.max_source_positions)
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model,
                               cfg.kernel_size, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, cfg.kernel_size,
                               stride=cfg.stride_size, padding=1)

    def forward(self, mel: torch.Tensor, lengths: torch.Tensor):
        x = F.gelu(self.conv1(mel.transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        out_lengths = lengths // self.cfg.stride_size
        return self.run(x, out_lengths), out_lengths


class AdapterTransformer(_Stack):
    """Projection + transformer adapter (reference Transformer)."""

    def __init__(self, cfg: AdapterTransformerConfig):
        super().__init__(cfg.encoder_layers, cfg.d_model,
                         cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
                         cfg.max_source_positions)
        self.cfg = cfg
        if cfg.input_dim != cfg.d_model:
            self.in_proj = nn.Linear(cfg.input_dim, cfg.d_model)
        if cfg.output_dim != cfg.d_model:
            self.out_proj = nn.Linear(cfg.d_model, cfg.output_dim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        if self.cfg.input_dim != self.cfg.d_model:
            x = self.in_proj(x)
        x = self.run(x, lengths)
        if self.cfg.output_dim != self.cfg.d_model:
            x = self.out_proj(x)
        return x, lengths


class AudioDecoder(_Stack):
    """Hidden states -> double-rate features: positions, N layers, LN, mask,
    deconv(k3, s2) + GELU, deconv(k3, s1) + GELU, trim to T * stride.
    Input (B, T, d_model) -> (B, T * stride, num_mel_bins)."""

    def __init__(self, cfg: AudioDecoderConfig):
        super().__init__(cfg.decoder_layers, cfg.d_model,
                         cfg.decoder_attention_heads, cfg.decoder_ffn_dim,
                         cfg.max_source_positions)
        self.cfg = cfg
        self.deconv1 = nn.ConvTranspose1d(cfg.d_model, cfg.d_model,
                                          cfg.kernel_size, cfg.stride_size)
        self.deconv2 = nn.ConvTranspose1d(cfg.d_model, cfg.num_mel_bins,
                                          cfg.kernel_size, 1)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        c = self.cfg
        T = x.shape[1]
        x = self.run(x, lengths)
        x = F.gelu(self.deconv1(x.transpose(1, 2)))          # (B, D, 2T+1)
        x = F.gelu(self.deconv2(x))                          # (B, M, 2T+3)
        x = x.transpose(1, 2)[:, :T * c.stride_size]
        return x, lengths * c.stride_size


class GatedDownsample(nn.Module):
    """x factor gated downsample: T right-padded to a multiple of r, then
    LN(down_proj(silu(gate_proj(x)) * up_proj(x)) + x reshaped), the two
    projections convs with kernel = stride = r, no biases.
    (B, T, d_model) -> (B, T // r, d_model * r), lengths // r."""

    def __init__(self, d_model: int, factor: int = 4):
        super().__init__()
        self.factor = factor
        inter = d_model * factor
        self.gate_proj = nn.Conv1d(d_model, inter, factor, factor, bias=False)
        self.up_proj = nn.Conv1d(d_model, inter, factor, factor, bias=False)
        self.down_proj = nn.Linear(inter, inter, bias=False)
        self.ln = nn.LayerNorm(inter, eps=LN_EPS)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        r = self.factor
        B, T, D = x.shape
        if T % r:
            x = F.pad(x, (0, 0, 0, r - T % r))
            T = x.shape[1]
        xc = x.transpose(1, 2)
        g = self.gate_proj(xc).transpose(1, 2)
        u = self.up_proj(xc).transpose(1, 2)
        # the residual regroups r consecutive frames in (B, T, D) layout
        res = x.reshape(B, T // r, D * r)
        out = layer_norm(self.down_proj(F.silu(g) * u) + res, self.ln)
        return out, lengths // r


class Upsample(nn.Module):
    """x stride upsample: ConvTranspose(k = s = stride), no bias.
    (B, T, d_model * stride) -> (B, T * stride, d_model)."""

    def __init__(self, d_model: int, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.up_conv = nn.ConvTranspose1d(d_model * stride, d_model, stride,
                                          stride, bias=False)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        return (self.up_conv(x.transpose(1, 2)).transpose(1, 2),
                lengths * self.stride)
