"""Plain LLM attention (the cache-free forward and the parity oracle).

Port of ``moss_ttsd_tpu/ops/attention.py``. The serving path attends
through the kernels of ``ops/flash_attention.py``; these dense functions
serve the cache-free ``AsteroidLM.forward`` and the tests.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30  # large-negative instead of finfo.min: survives bf16 softmax math


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, T, H, D); k/v: (B, S, Hkv, D); mask: (B, T, S) bool (True =
    attend). Returns (B, T, H, D) in q.dtype. Softmax in fp32."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).to(torch.float32) * scale
    # a scalar fill: a device tensor made from a host scalar would be a
    # pageable host-to-device copy, which syncs the stream every call
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(B, T, H, D)


def gqa_attention_hs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped-query attention over head-major caches.

    q: (B, T, H, D); k/v: (B, Hkv, S, D); mask: (B, T, S) bool.
    Returns (B, T, H, D) in q.dtype. Softmax in fp32."""
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, D)
    scores = torch.einsum("bthgd,bhsd->bhgts", qg, k).to(torch.float32) * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bhsd->bthgd", probs, v)
    return out.reshape(B, T, H, D)


def causal_mask(cache_pos: Union[int, torch.Tensor], q_len: int, kv_len: int,
                key_valid: Optional[torch.Tensor] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Causal + validity mask (B, q_len, kv_len).

    cache_pos: absolute position of the first query token — an int, or a
    (B,) tensor when rows sit at different cache depths. key_valid: (B,
    kv_len) validity of cache slots; None means all valid."""
    if device is None:
        device = key_valid.device if key_valid is not None else None
    kpos = torch.arange(kv_len, device=device)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1:
        qpos = cache_pos[:, None] + torch.arange(q_len, device=device)
        causal = kpos[None, None, :] <= qpos[:, :, None]            # (B, q, k)
    else:
        qpos = int(cache_pos) + torch.arange(q_len, device=device)
        causal = (kpos[None, :] <= qpos[:, None])[None]              # (1, q, k)
    if key_valid is None:
        return causal.expand(causal.shape[0], q_len, kv_len)
    return causal & key_valid[:, None, :]
