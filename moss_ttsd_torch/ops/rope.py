"""Rotary position embeddings (Qwen3/NEOX-style rotate-half), fp32 tables.

Port of ``moss_ttsd_tpu/ops/rope.py``.
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 1_000_000.0):
    """positions (..., T) int -> (cos, sin) each (..., T, head_dim) fp32.

    HF convention: inv_freq over even indices, each table duplicated across
    the two rotate-half halves."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.to(torch.float32)[..., None] * inv_freq      # (..., T, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)                        # (..., T, D)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); cos/sin (B, T, D) -> rotated x, original dtype."""
    xf = x.to(torch.float32)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return (xf * c + rotate_half(xf) * s).to(x.dtype)
