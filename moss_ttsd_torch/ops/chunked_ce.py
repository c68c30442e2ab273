"""Memory-light multi-channel cross-entropy, PyTorch port of
``moss_ttsd_tpu/ops/chunked_ce.py``.

The (B*T) rows are cut into chunks and each chunk's fp32 logits are
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant), so
at most one (chunk, V) logits block is live in the forward and in the
backward: the (B*T, 152704) fp32 logits of the text head are never held.
Logits are fp32 products of the fp32 hidden rows and the fp32 tied table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def _chunk_ce(h_chunk: torch.Tensor, labels_chunk: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """h (chunk, D), labels (chunk,), weight (V, D) -> per-row nll (chunk,),
    0 where the label is -100."""
    logits = h_chunk.to(torch.float32) @ weight.to(torch.float32).t()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels_chunk.clamp_min(0)
    tgt = torch.gather(logits, 1, safe[:, None])[:, 0]
    nll = lse - tgt
    return torch.where(labels_chunk == IGNORE_INDEX,
                       torch.zeros((), dtype=nll.dtype, device=nll.device),
                       nll)


def chunked_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                          head_weight: torch.Tensor, num_chunks: int = 8,
                          denom: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Causal-LM CE over one channel without the full logits.

    hidden (B, T, D); labels (B, T), already shifted, -100 = ignore;
    head_weight (V, D), the tied table. Returns the summed NLL over
    ``denom`` (default: this call's valid-label count), at least 1. Gradient
    accumulation passes the whole superbatch's count as ``denom`` so that
    summed micro-batch gradients equal the big-batch gradient."""
    B, T, D = hidden.shape
    n = B * T
    h = hidden.reshape(n, D)
    y = labels.reshape(n)
    pad = (-n) % num_chunks
    if pad:
        h = torch.cat([h, h.new_zeros((pad, D))])
        y = torch.cat([y, y.new_full((pad,), IGNORE_INDEX)])
    chunk = (n + pad) // num_chunks
    total = None
    for i in range(num_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        nll = checkpoint(_chunk_ce, h[rows], y[rows], head_weight,
                         use_reentrant=False).sum()
        total = nll if total is None else total + nll
    valid = (y != IGNORE_INDEX).sum() if denom is None else denom
    return total / valid.clamp_min(1)


def shift_for_causal(labels: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T): position t holds label t + 1; the last is -100."""
    return torch.cat([labels[:, 1:],
                      torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """(..., T, C) -> (..., T, C): ``shift_for_causal`` of every channel
    on the time axis."""
    return torch.cat([labels[..., 1:, :],
                      torch.full_like(labels[..., :1, :], IGNORE_INDEX)],
                     dim=-2)


def valid_label_counts(labels: torch.Tensor) -> torch.Tensor:
    """Per-channel valid (not -100) shifted label counts of (..., T, C)
    labels, over every leading axis -> (C,) int64. The shared CE
    denominators of exact gradient accumulation."""
    shifted = labels[..., 1:, :]
    return (shifted != IGNORE_INDEX).reshape(-1, shifted.shape[-1]).sum(0)


def asteroid_loss(hidden: torch.Tensor, labels: torch.Tensor,
                  embed_text: torch.Tensor, embed_speech: torch.Tensor,
                  weights: Sequence[float], num_chunks: int = 8,
                  counts: Optional[torch.Tensor] = None,
                  shifted: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted multi-channel loss: channel 0 against the text table in
    ``num_chunks`` chunks, each speech channel against its table in one
    chunk; per-channel weights normalised by their sum. ``counts`` (C,)
    overrides each channel's denominator (gradient accumulation).
    ``shifted``: ``labels`` are already shifted (``shift_labels``), as a
    sequence-parallel rank's window of a row is: its last label comes
    from the next rank's window. Returns (total, per-channel losses
    (C,))."""
    C = labels.shape[-1]
    if not shifted:
        labels = shift_labels(labels)
    losses = [chunked_cross_entropy(
        hidden, labels[..., 0], embed_text, num_chunks,
        denom=None if counts is None else counts[0])]
    for i in range(1, C):
        losses.append(chunked_cross_entropy(
            hidden, labels[..., i], embed_speech[i - 1],
            num_chunks=1, denom=None if counts is None else counts[i]))
    per = torch.stack(losses)
    w = torch.as_tensor(weights, dtype=torch.float32, device=per.device)
    w = w / w.sum()
    return torch.sum(w * per), per
