"""Per-channel logits processing + sampling, PyTorch port of
``moss_ttsd_tpu/ops/sampling.py``.

HF semantics, as the reference builds them per channel (RepetitionPenalty ->
Temperature -> TopK -> TopP, then multinomial/argmax):

  * repetition penalty: each id present in the channel's history is
    penalized once (score > 0 -> / p, else * p);
  * top-k: the K largest logits (exact ``torch.topk``; the JAX package's
    ``approx_topk`` is a TPU recall approximation with no meaning here and
    maps to the same exact top-k);
  * top-p: keep token i (descending order) iff the probability mass strictly
    above it is < p; top-1 always kept.

Random draws come from an explicit ``torch.Generator`` (or one per row):
categorical sampling is the Gumbel-max trick ``argmax(logits + Gumbel
noise)``, the same construction as ``jax.random.categorical`` (the bits
differ).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .attention import NEG_INF


class ChannelParams(NamedTuple):
    """Static per-channel sampling params (None -> neutral)."""

    do_sample: bool
    temperature: float
    top_k: int           # 0 = disabled
    top_p: float         # 1.0 = disabled
    repetition_penalty: float  # 1.0 = disabled
    exact_top_p: bool = False

    @classmethod
    def from_config(cls, c, exact_top_p: bool = False) -> "ChannelParams":
        return cls(
            do_sample=bool(c.do_sample),
            temperature=float(c.temperature) if c.temperature else 1.0,
            top_k=int(c.top_k) if c.top_k else 0,
            top_p=float(c.top_p) if c.top_p is not None else 1.0,
            repetition_penalty=(float(c.repetition_penalty)
                                if c.repetition_penalty else 1.0),
            exact_top_p=bool(exact_top_p),
        )


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (..., V); presence (..., V) bool."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def top_p_mask_sorted(sorted_logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep-mask over descending-sorted logits (..., K)."""
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < top_p
    keep[..., 0] = True
    return keep


def exact_top_p_mask(logits: torch.Tensor, top_p: float,
                     iters: int = 50) -> torch.Tensor:
    """Exact full-vocab nucleus keep-mask (..., V) by a fixed-trip bisection
    on the probability threshold (no sort); same contract as
    ``top_p_mask_sorted``. See the JAX docstring for the derivation."""
    probs = torch.softmax(logits, dim=-1)
    hi = probs.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        s = torch.where(probs > mid, probs, 0.0).sum(dim=-1, keepdim=True)
        above = s >= top_p
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return probs > lo


def _exact_top_p_logits(logits: torch.Tensor, p: ChannelParams) -> torch.Tensor:
    if p.temperature != 1.0:
        logits = logits / p.temperature
    return torch.where(exact_top_p_mask(logits, p.top_p), logits, NEG_INF)


def _use_exact_top_p(p: ChannelParams) -> bool:
    return p.exact_top_p and p.do_sample and p.top_p < 1.0 and p.top_k <= 0


def categorical(gen, logits: torch.Tensor) -> torch.Tensor:
    """Draw one index per row of (B, K) logits: argmax(logits + Gumbel).

    ``gen``: one ``torch.Generator`` (or None) for the whole batch, or a
    sequence of B generators, one per row (the continuous pool's per-request
    streams): row b then draws exactly the (1, K) noise that a batch-1 call
    with ``gen[b]`` draws. Each per-row draw is a launch of its own; they
    are counted in ``categorical.row_draws``."""
    if isinstance(gen, (list, tuple)):
        if len(gen) != logits.shape[0]:
            raise ValueError(f"{len(gen)} generators for {logits.shape[0]} "
                             "rows")
        e = torch.cat([torch.empty((1,) + logits.shape[1:],
                                   dtype=torch.float32,
                                   device=logits.device).exponential_(
                                       generator=g) for g in gen])
        categorical.row_draws += len(gen)
    else:
        e = torch.empty_like(logits, dtype=torch.float32).exponential_(
            generator=gen)
    return torch.argmax(logits - torch.log(e), dim=-1)


categorical.row_draws = 0


def _prefilter(logits: torch.Tensor, p: ChannelParams, prefilter_k: int):
    """top-K prefilter -> temperature -> top-p over the (B, K) slice."""
    V = logits.shape[-1]
    K = min(p.top_k if p.top_k > 0 else prefilter_k, V)
    vals, idx = torch.topk(logits, K, dim=-1)          # descending (B, K)
    if p.temperature != 1.0:
        vals = vals / p.temperature
    if p.top_p < 1.0:
        vals = torch.where(top_p_mask_sorted(vals, p.top_p), vals, NEG_INF)
    return vals, idx


def sample_from_channel(gen, logits: torch.Tensor,
                        p: ChannelParams, prefilter_k: int = 128,
                        approx_topk: bool = False) -> torch.Tensor:
    """One channel's sampling step. logits (B, V) fp32 -> token ids (B,).
    ``gen`` as in ``categorical``.

    The caller applies repetition penalty and any hard masks first.
    ``approx_topk`` is accepted for signature parity and ignored (exact)."""
    if _use_exact_top_p(p):
        return categorical(gen, _exact_top_p_logits(logits, p))
    vals, idx = _prefilter(logits, p, prefilter_k)
    if p.do_sample:
        choice = categorical(gen, vals)
    else:
        choice = torch.argmax(vals, dim=-1)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


def processed_logits(logits: torch.Tensor, presence: torch.Tensor,
                     p: ChannelParams, prefilter_k: int = 128,
                     approx_topk: bool = False) -> torch.Tensor:
    """Dense (B, V) post-processor logits — exactly the distribution
    ``sample_from_channel`` draws from, scattered back to the full vocab
    with NEG_INF at filtered entries."""
    logits = apply_repetition_penalty(logits, presence, p.repetition_penalty)
    if _use_exact_top_p(p):
        return _exact_top_p_logits(logits, p)
    vals, idx = _prefilter(logits, p, prefilter_k)
    out = torch.full_like(logits, NEG_INF)
    return out.scatter(-1, idx, vals)


def scatter_presence(presence: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark tokens (...,) present in presence (..., V), in place (one token
    per row). Out-of-range ids are dropped."""
    V = presence.shape[-1]
    flat_p = presence.reshape(-1, V)
    flat_t = tokens.reshape(-1, 1).to(torch.int64)
    ok = (flat_t >= 0) & (flat_t < V)
    idx = flat_t.clamp(0, V - 1)
    flat_p.scatter_(1, idx, torch.gather(flat_p, 1, idx) | ok)
    return presence


def presence_from_history(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """tokens (B, T) -> (B, V) bool presence (padding ids included, as the
    reference penalizes the raw row; out-of-range ids dropped)."""
    B = tokens.shape[0]
    t = tokens.to(torch.int64)
    t = torch.where((t >= 0) & (t < vocab), t, vocab)   # spill column
    presence = torch.zeros((B, vocab + 1), dtype=torch.bool,
                           device=tokens.device)
    presence.scatter_(1, t, True)
    return presence[:, :vocab].contiguous()
