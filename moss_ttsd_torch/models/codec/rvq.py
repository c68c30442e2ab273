"""Residual vector quantizer, decode side: PyTorch port of
``ResidualVQ.decode`` and its output projection
(``moss_ttsd_tpu/models/codec/rvq.py``). All in fp32: the quantizer subtree
keeps fp32 weights even when the rest of the codec runs in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.config import RVQConfig


class ResidualVQ(nn.Module):
    """Codebooks (nq, K, D) + the folded WNConv1d(k=1) output projection."""

    def __init__(self, cfg: RVQConfig):
        super().__init__()
        self.cfg = cfg
        self.codebook = nn.Parameter(
            torch.empty(cfg.num_quantizers, cfg.codebook_size,
                        cfg.codebook_dim))
        if cfg.rvq_dim != cfg.output_dim:
            self.output_proj = nn.Linear(cfg.rvq_dim, cfg.output_dim)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (nq, B, T) -> embeddings (B, T, output_dim), fp32: the sum
        of the stages' codebook rows, then the output projection."""
        emb = torch.zeros(codes.shape[1:] + (self.cfg.codebook_dim,),
                          dtype=torch.float32, device=codes.device)
        for i in range(codes.shape[0]):
            emb = emb + self.codebook[i][codes[i].long()]
        if self.cfg.rvq_dim != self.cfg.output_dim:
            emb = self.output_proj(emb)
        return emb
