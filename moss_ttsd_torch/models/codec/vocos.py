"""Vocos vocoder family, PyTorch port of
``moss_ttsd_tpu/models/codec/vocos.py``: the ConvNeXt backbone (its
LayerNorms plain or AdaLayerNorm), the ResNet backbone, and the ISTFT,
IMDCT-symexp and IMDCT-cos heads, selected by ``VocosConfig``. The
shipped configuration is ConvNeXt + ISTFT; the ISTFT head takes
``padding="same"`` only, as in the JAX package.

(B, T, C) layout at the module boundary; convs run channels-first inside.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import VocosConfig
from ...ops.dsp import imdct, istft_same_masked
from .transformer import layer_norm

LN_EPS = 1e-6


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d over (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) (exp(|x|) - 1) (reference modules.py:661-662)."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class AdaLayerNorm(nn.Module):
    """LayerNorm with per-class scale / shift tables (reference
    modules.py:1157-1184): rows ``cond_id`` of ``scale`` and ``shift``,
    broadcast against x as the JAX ``take`` is."""

    def __init__(self, num_embeddings: int, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_embeddings, dim))
        self.shift = nn.Parameter(torch.zeros(num_embeddings, dim))

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return x * self.scale[cond_id] + self.shift[cond_id]


def _norm(dim: int, adanorm_num_embeddings: Optional[int]) -> nn.Module:
    if adanorm_num_embeddings is not None:
        return AdaLayerNorm(adanorm_num_embeddings, dim)
    return nn.LayerNorm(dim, eps=LN_EPS)


def _apply_norm(norm: nn.Module, x: torch.Tensor,
                cond_id: Optional[torch.Tensor]) -> torch.Tensor:
    if isinstance(norm, AdaLayerNorm):
        if cond_id is None:
            raise ValueError("adanorm needs a cond_id")
        return norm(x, cond_id)
    return layer_norm(x, norm)


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv, LN (plain or adaptive), pointwise expand + GELU +
    project, layer-scale gamma, residual. ``mask`` zeroes the conv input
    past each row's length (the reference runs unpadded, so its zero
    padding starts at the valid end)."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init: float,
                 adanorm_num_embeddings: Optional[int] = None):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = _norm(dim, adanorm_num_embeddings)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                cond_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _masked(x, mask)
        residual = x
        x = _apply_norm(self.norm, _conv(self.dwconv, x), cond_id)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return residual + self.gamma * x


class VocosBackbone(nn.Module):
    """Embed conv k7, LN (plain or adaptive), N ConvNeXt blocks, LN."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        ada = cfg.adanorm_num_embeddings
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = _norm(cfg.dim, ada)
        scale = 1.0 / cfg.num_layers
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, scale, ada)
            for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                cond_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _apply_norm(self.norm, _conv(self.embed, _masked(x, mask)),
                        cond_id)
        for blk in self.blocks:
            x = blk(x, mask, cond_id)
        return layer_norm(x, self.final_ln)


class ResBlock1(nn.Module):
    """HiFi-GAN V1 ResBlock without upsampling (reference
    modules.py:1187-1327): three residual pairs (leaky ReLU -> dilated conv
    -> leaky ReLU -> conv -> layer-scale gamma), dilations 1, 3, 5; the
    weight norms are folded at conversion. Every conv input is masked past
    the row's length."""

    def __init__(self, dim: int, layer_scale_init: float,
                 kernel_size: int = 3, dilation=(1, 3, 5),
                 lrelu_slope: float = 0.1):
        super().__init__()
        k = kernel_size
        self.lrelu_slope = lrelu_slope
        self.convs1 = nn.ModuleList(
            nn.Conv1d(dim, dim, k, dilation=d, padding=(k * d - d) // 2)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(dim, dim, k, padding=(k - 1) // 2) for _ in dilation)
        self.gamma = nn.ParameterList(
            nn.Parameter(torch.full((dim,), float(layer_scale_init)))
            for _ in dilation)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        slope = self.lrelu_slope
        for c1, c2, gamma in zip(self.convs1, self.convs2, self.gamma):
            xt = F.leaky_relu(_masked(x, mask), slope)
            xt = F.leaky_relu(_conv(c1, _masked(xt, mask)), slope)
            xt = _conv(c2, _masked(xt, mask))
            x = gamma * xt + x
        return x


class VocosResNetBackbone(nn.Module):
    """Weight-normed embed conv k3 + ``num_blocks`` ResBlock1 (layer scale
    1 / num_blocks / 3) (reference modules.py:1413-1449)."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 3, padding=1)
        scale = 1.0 / cfg.num_blocks / 3.0
        self.resnet = nn.ModuleList(ResBlock1(cfg.dim, scale)
                                    for _ in range(cfg.num_blocks))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                cond_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _conv(self.embed, _masked(x, mask))
        for blk in self.resnet:
            x = blk(x, mask)
        return x


class ISTFTHead(nn.Module):
    """linear -> (log-magnitude | phase) -> complex spectrogram ->
    same-padding ISTFT over the ragged batch; the spectral math runs in
    fp32."""

    def __init__(self, dim: int, n_fft: int, hop: int):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        n_bins = self.n_fft // 2 + 1
        h = self.out(x).transpose(1, 2)                   # (B, 2*n_bins, T)
        mag, p = h[:, :n_bins], h[:, n_bins:]
        mag = torch.clamp(torch.exp(mag.to(torch.float32)), max=1e2)
        p = p.to(torch.float32)
        return istft_same_masked(mag * torch.cos(p), mag * torch.sin(p),
                                 self.n_fft, self.hop, lengths)


def mel_scale(sample_rate: int, out_dim: int) -> np.ndarray:
    """IMDCTSymExpHead's perceptual init (reference modules.py:1018-1026,
    htk mel scale): column k of the output layer is scaled by
    1 - f_k / f_max."""
    m_max = 2595.0 * np.log10(1.0 + (sample_rate // 2) / 700.0)
    m_pts = np.linspace(0, m_max, out_dim)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    return (1.0 - f_pts / f_pts.max()).astype(np.float32)


def _frame_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = x.shape[1]
    return (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None])[..., None]


class IMDCTSymExpHead(nn.Module):
    """linear -> symexp -> clip +-1e2 -> IMDCT (reference
    modules.py:991-1048). ``clip_audio`` clips the audio to [-1, 1];
    ``clip_coeffs`` with it returns the clipped coefficients instead,
    flattened (the reference's clip branch, kept for audits)."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 sample_rate: Optional[int] = None, clip_audio: bool = False,
                 clip_coeffs: bool = False):
        super().__init__()
        self.frame_len, self.padding = mdct_frame_len, padding
        self.clip_audio, self.clip_coeffs = clip_audio, clip_coeffs
        self.out = nn.Linear(dim, mdct_frame_len // 2)
        if sample_rate is not None:
            with torch.no_grad():
                self.out.weight.mul_(torch.as_tensor(
                    mel_scale(sample_rate, mdct_frame_len // 2))[:, None])

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = self.out(x).to(torch.float32)
        x = torch.clamp(symexp(x), -1e2, 1e2)
        x = torch.where(_frame_mask(x, lengths), x, 0.0)
        if self.clip_audio and self.clip_coeffs:
            return torch.clamp(x, -1.0, 1.0).reshape(x.shape[0], -1)
        audio = imdct(x, self.frame_len, self.padding)
        return torch.clamp(audio, -1.0, 1.0) if self.clip_audio else audio


class IMDCTCosHead(nn.Module):
    """linear -> exp(m) cos(p), m clipped at exp 1e2 -> IMDCT (reference
    modules.py:1051-1093). ``clip_audio`` clips the audio; ``clip_coeffs``
    with it returns the clipped raw linear output, flattened (the
    reference's clip branch)."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 clip_audio: bool = False, clip_coeffs: bool = False):
        super().__init__()
        self.frame_len, self.padding = mdct_frame_len, padding
        self.clip_audio, self.clip_coeffs = clip_audio, clip_coeffs
        self.out = nn.Linear(dim, mdct_frame_len)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = self.out(x).to(torch.float32)
        valid = _frame_mask(x, lengths)
        if self.clip_audio and self.clip_coeffs:
            return torch.clamp(torch.where(valid, x, 0.0),
                               -1.0, 1.0).reshape(x.shape[0], -1)
        m, p = x.chunk(2, dim=-1)
        coeffs = torch.clamp(torch.exp(m), max=1e2) * torch.cos(p)
        coeffs = torch.where(valid, coeffs, 0.0)
        audio = imdct(coeffs, self.frame_len, self.padding)
        return torch.clamp(audio, -1.0, 1.0) if self.clip_audio else audio


class Vocos(nn.Module):
    """Backbone + head as ``cfg`` selects: x (B, T, input_channels) at
    100 Hz -> wav (B, T * up), lengths * up, where up is the ISTFT hop or
    half the MDCT frame (the whole frame for the cos head's coefficient
    audit output)."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        if c.backbone == "convnext":
            self.backbone = VocosBackbone(c)
        elif c.backbone == "resnet":
            self.backbone = VocosResNetBackbone(c)
        else:
            raise ValueError(f"unknown backbone {c.backbone!r}")
        if c.head == "istft":
            if c.padding != "same":
                # istft_same_masked implements same-padding only; 'same'
                # semantics for padding='center' would misalign the wave
                raise NotImplementedError(
                    f"ISTFT head supports padding='same' only, got "
                    f"{c.padding!r} (the IMDCT heads honor both)")
            self.head = ISTFTHead(c.dim, c.n_fft, c.hop_size)
            self.up = c.hop_size
        elif c.head == "imdct_symexp":
            self.head = IMDCTSymExpHead(c.dim, c.mdct_frame_len, c.padding,
                                        c.head_sample_rate, c.clip_audio,
                                        c.clip_coeffs)
            self.up = c.mdct_frame_len // 2
        elif c.head == "imdct_cos":
            self.head = IMDCTCosHead(c.dim, c.mdct_frame_len, c.padding,
                                     c.clip_audio, c.clip_coeffs)
            self.up = (c.mdct_frame_len if c.clip_audio and c.clip_coeffs
                       else c.mdct_frame_len // 2)
        else:
            raise ValueError(f"unknown head {c.head!r}")

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                cond_id: Optional[torch.Tensor] = None):
        h = self.backbone(x, _frame_mask(x, lengths), cond_id)
        return self.head(h, lengths), lengths * self.up
