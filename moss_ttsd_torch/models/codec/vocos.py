"""Vocos vocoder, PyTorch port of ``moss_ttsd_tpu/models/codec/vocos.py``
for the shipped configuration: the ConvNeXt backbone and the ISTFT head.
The other backbones and heads of the JAX package (ResNet, AdaLayerNorm,
IMDCT heads) are not yet ported and raise.

(B, T, C) layout at the module boundary; convs run channels-first inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import VocosConfig
from ...ops.dsp import istft_same_masked
from .transformer import layer_norm

LN_EPS = 1e-6


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv, LN, pointwise expand + GELU + project, layer-scale
    gamma, residual. ``mask`` zeroes the conv input past each row's length
    (the reference runs unpadded, so its zero padding starts at the valid
    end)."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        residual = x
        x = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        x = layer_norm(x, self.norm)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return residual + self.gamma * x


class VocosBackbone(nn.Module):
    """Embed conv k7, LN, N ConvNeXt blocks, LN."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        if cfg.adanorm_num_embeddings is not None:
            raise NotImplementedError(
                "Vocos AdaLayerNorm conditioning is not yet ported")
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        scale = 1.0 / cfg.num_layers
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, scale)
            for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        x = self.embed(x.transpose(1, 2)).transpose(1, 2)
        x = layer_norm(x, self.norm)
        for blk in self.blocks:
            x = blk(x, mask)
        return layer_norm(x, self.final_ln)


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


class Vocos(nn.Module):
    """Backbone + head: x (B, T, input_channels) at 100 Hz -> wav
    (B, T * hop), lengths * hop."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone != "convnext":
            raise NotImplementedError(
                f"Vocos backbone {cfg.backbone!r} is not yet ported")
        if cfg.head != "istft":
            raise NotImplementedError(
                f"Vocos head {cfg.head!r} is not yet ported")
        if cfg.padding != "same":
            # istft_same_masked implements same-padding only; computing
            # 'same' semantics for padding='center' would misalign the wave
            raise NotImplementedError(
                f"ISTFT head supports padding='same' only, got "
                f"{cfg.padding!r}")
        self.backbone = VocosBackbone(cfg)
        self.head = ISTFTHead(cfg.dim, cfg.n_fft, cfg.hop_size)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths[:, None])[..., None]
        h = self.backbone(x, mask)
        return self.head(h, lengths), lengths * self.cfg.hop_size
