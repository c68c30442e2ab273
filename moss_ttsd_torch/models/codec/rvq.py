"""Residual vector quantizer, inference side: PyTorch port of
``moss_ttsd_tpu/models/codec/rvq.py`` (``nearest_codes``, the inference
``ResidualVQ.__call__`` and ``ResidualVQ.decode``, with the folded input and
output projections).

All in fp32: the quantizer subtree keeps fp32 weights even when the rest of
the codec runs in bf16. The codebook distances are a matmul whose argmin
picks the code, so a near tie flips with the matmul's precision: on the card
it must run in true fp32, which is PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False); a caller that turns TF32
on changes the codes.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.config import RVQConfig


def nearest_codes(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """L2-nearest codebook index of each vector: z_e (..., D), codebook
    (K, D) -> (...,) int64. ||z||^2 is constant per row and dropped; ties
    go to the first index, as jnp.argmin."""
    z = z_e.to(torch.float32)
    cb = codebook.to(torch.float32)
    dist = -2.0 * (z @ cb.T) + torch.sum(cb * cb, dim=-1)[None, :]
    return torch.argmin(dist.reshape(-1, cb.shape[0]), dim=-1).reshape(
        z_e.shape[:-1])


class ResidualVQ(nn.Module):
    """Codebooks (nq, K, D) + the folded WNConv1d(k=1) input and output
    projections."""

    def __init__(self, cfg: RVQConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.input_dim != cfg.rvq_dim:
            self.input_proj = nn.Linear(cfg.input_dim, cfg.rvq_dim)
        if cfg.rvq_dim != cfg.output_dim:
            self.output_proj = nn.Linear(cfg.rvq_dim, cfg.output_dim)
        self.codebook = nn.Parameter(
            torch.empty(cfg.num_quantizers, cfg.codebook_size,
                        cfg.codebook_dim))

    def _project_in(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.input_dim != self.cfg.rvq_dim:
            z = self.input_proj(z)
        return z.to(torch.float32)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        if self.cfg.rvq_dim != self.cfg.output_dim:
            out = self.output_proj(out)
        return out

    def forward(self, z: torch.Tensor, lengths: torch.Tensor):
        """Inference quantize of z (B, T, input_dim) -> (zq (B, T,
        output_dim), codes (nq, B, T), lengths). Each stage quantizes the
        masked residual (padding frames are 0) and subtracts its pick; the
        straight-through sum ``r + (q - r)`` of the JAX code is kept as
        written, since its rounding feeds the next stage's residual."""
        z = self._project_in(z)
        T = z.shape[1]
        mask = (torch.arange(T, device=z.device)[None, :]
                < lengths[:, None])[..., None]                  # (B, T, 1)
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        quantized = torch.zeros_like(z)
        residual = z
        codes = []
        for cb in self.codebook:
            masked = torch.where(mask, residual, zero)
            idx = nearest_codes(masked, cb)
            z_q = masked + (cb[idx] - masked)
            z_q = torch.where(mask, z_q, zero)
            quantized = quantized + z_q
            residual = residual - z_q
            codes.append(idx)
        return self._project_out(quantized), torch.stack(codes), lengths

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (nq, B, T) -> embeddings (B, T, output_dim), fp32: the sum
        of the stages' codebook rows, then the output projection."""
        emb = torch.zeros(codes.shape[1:] + (self.cfg.codebook_dim,),
                          dtype=torch.float32, device=codes.device)
        for i in range(codes.shape[0]):
            emb = emb + self.codebook[i][codes[i].long()]
        return self._project_out(emb)
