"""AsteroidLM — the 8-channel Qwen3-style decoder, PyTorch port of
``moss_ttsd_tpu/models/lm.py`` (bf16/fp32 path: no int8 weights, no LoRA).

  * 8 embedding tables summed into one hidden stream (``embed``);
  * Qwen3 blocks: RMSNorm, GQA attention with per-head q/k RMSNorm + RoPE,
    SwiGLU MLP; ``attention_bias`` puts a bias on q/k/v and o_proj;
  * 8 LM heads tied to their embedding tables, fp32 logits (``logits_all``);
  * a static head-major KV cache (L, B, Hkv, S, D) written in place.

Attention: prefill (T > 1 with a cache) goes through ``flash_prefill`` and
single-token decode through the extent-clamped ``flash_decode_hs`` — the
port's one decode attention; the cache-free forward uses the plain
``gqa_attention``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LMConfig
from ..core.device import torch_dtype
from ..ops.attention import causal_mask, gqa_attention
from ..ops.flash_attention import flash_decode_hs, flash_prefill
from ..ops.rope import apply_rope, rope_cos_sin


def rms_norm_fn(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, cast back to the input dtype before the
    weight multiply (as the JAX ``rms_norm_fn``)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * w.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm_fn(x, self.weight, self.eps)


class Qwen3Block(nn.Module):
    """One decoder layer (JAX ``Qwen3Block``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        hid, bias = c.hidden_size, c.attention_bias
        self.input_ln = RMSNorm(hid, c.rms_norm_eps)
        self.q_proj = nn.Linear(hid, H * D, bias=bias)
        self.k_proj = nn.Linear(hid, Hkv * D, bias=bias)
        self.v_proj = nn.Linear(hid, Hkv * D, bias=bias)
        self.o_proj = nn.Linear(H * D, hid, bias=bias)   # HF Qwen3: o_proj too
        self.q_norm = RMSNorm(D, c.rms_norm_eps)
        self.k_norm = RMSNorm(D, c.rms_norm_eps)
        self.post_ln = RMSNorm(hid, c.rms_norm_eps)
        self.gate_proj = nn.Linear(hid, c.intermediate_size, bias=False)
        self.up_proj = nn.Linear(hid, c.intermediate_size, bias=False)
        self.down_proj = nn.Linear(c.intermediate_size, hid, bias=False)

    def forward(self, x, cos, sin, layer_idx: int, cache: Optional[dict],
                cache_pos: int, key_valid: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        c = self.cfg
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        B, T, _ = x.shape
        h = self.input_ln(x)
        q = self.q_proj(h).reshape(B, T, H, D)
        k = self.k_proj(h).reshape(B, T, Hkv, D)
        v = self.v_proj(h).reshape(B, T, Hkv, D)
        q = apply_rope(self.q_norm(q), cos, sin)
        k = apply_rope(self.k_norm(k), cos, sin)
        scale = D ** -0.5

        if cache is not None:
            # head-major cache (L, B, Hkv, S, D): only the new (B, T, Hkv, D)
            # slice is transposed. The write at the scalar cache_pos is an
            # in-place copy_ into the slot — the counterpart of XLA's in-place
            # dynamic_update_slice on the loop carry; no cache copy is made.
            ck, cv = cache["k"][layer_idx], cache["v"][layer_idx]
            ck[:, :, cache_pos:cache_pos + T].copy_(k.transpose(1, 2))
            cv[:, :, cache_pos:cache_pos + T].copy_(v.transpose(1, 2))
            if T > 1:
                if cache_pos != 0:
                    raise NotImplementedError(
                        "multi-token segments are prefill-only (cache_pos 0)")
                # prefill: queries see only keys < T, i.e. the current k/v
                attn = flash_prefill(q, k, v, key_valid[:, :T], scale)
            else:
                # decode: read only the slots up to the one just written
                attn = flash_decode_hs(q, ck, cv, key_valid, scale,
                                       extent=cache_pos + 1)
        else:
            attn = gqa_attention(q, k, v, mask, scale)
        x = x + self.o_proj(attn.reshape(B, T, H * D))
        h = self.post_ln(x)
        down = self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x + down


class AsteroidLM(nn.Module):
    """8-channel LM. Channel 0 = text+speech vocab; channels 1-7 speech-only."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.embed_text = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size))
        self.embed_speech = nn.Parameter(
            torch.empty(c.channels - 1, c.speech_vocab_size, c.hidden_size))
        self.layers = nn.ModuleList(Qwen3Block(c)
                                    for _ in range(c.num_hidden_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    @classmethod
    def init_random(cls, cfg: LMConfig, seed: int = 0, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> "AsteroidLM":
        """Random weights made on ``device`` from a seeded generator:
        embeddings N(0, 0.02), projections N(0, 1/fan_in), norms 1, biases 0
        (the JAX init's scales; the draws differ)."""
        dtype = dtype or torch_dtype(cfg.param_dtype)
        with torch.device(device):
            model = cls(cfg).to(dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("embed_"):
                    p.normal_(0.0, 0.02, generator=gen)
                elif name.endswith("norm.weight") or name.endswith("ln.weight"):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        return model.eval().requires_grad_(False)

    # -- embeddings ----------------------------------------------------------

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, T, C) -> summed embeddings (B, T, hidden). Ids are
        clamped into each table (the JAX ``take(mode="clip")``)."""
        c = self.cfg
        x = F.embedding(input_ids[..., 0].clamp(0, c.vocab_size - 1),
                        self.embed_text)
        for i in range(1, c.channels):
            x = x + F.embedding(
                input_ids[..., i].clamp(0, c.speech_vocab_size - 1),
                self.embed_speech[i - 1])
        return x.to(torch_dtype(c.dtype))

    # -- backbone ------------------------------------------------------------

    def backbone(self, input_ids: torch.Tensor, positions: torch.Tensor,
                 key_valid: torch.Tensor, cache: Optional[dict],
                 cache_pos: int = 0
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run the decoder stack.

        input_ids (B, T, C); positions (B, T) absolute RoPE positions;
        key_valid (B, S) cache-slot validity, or (B, T) without a cache;
        cache {"k","v": (L, B, Hkv, S, D)} updated in place, or None;
        cache_pos: the scalar write slot of this segment; a one-token
        segment reads the cache up to extent cache_pos + 1.
        Returns (hidden (B, T, hidden) after the final norm, cache)."""
        c = self.cfg
        x = self.embed(input_ids)
        B, T, _ = x.shape
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        mask = None if cache is not None else causal_mask(0, T, T, key_valid)
        for li, layer in enumerate(self.layers):
            x = layer(x, cos, sin, li, cache, cache_pos, key_valid, mask)
        return self.final_norm(x), cache

    # -- tied heads ----------------------------------------------------------

    def logits_all(self, hidden: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """hidden (..., hidden) -> (text_logits (..., vocab), speech_logits
        (..., C-1, speech_vocab)), both fp32.

        The products run on the tables' own dtype with fp32 accumulation
        and fp32 output (``matmul_f32_out``): no fp32 copy of the 152704 x
        2048 table is ever made."""
        w_t, w_s = self.embed_text, self.embed_speech
        lead = hidden.shape[:-1]
        h = hidden.to(w_t.dtype).reshape(-1, hidden.shape[-1])
        t = matmul_f32_out(h, w_t.t())
        Cm1, Vs, Hd = w_s.shape
        s = matmul_f32_out(h, w_s.reshape(Cm1 * Vs, Hd).t())
        return t.reshape(*lead, -1), s.reshape(*lead, Cm1, Vs)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """Cache-free forward -> full logits. Positions follow the HF
        left-padding convention: cumsum(mask) - 1, clipped at 0."""
        B, T, _ = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int64,
                                        device=input_ids.device)
        positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)
        hidden, _ = self.backbone(input_ids, positions,
                                  attention_mask.to(torch.bool), None, 0)
        return self.logits_all(hidden)


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation AND fp32 output.

    On the card a bf16 product goes through ``torch.mm(..., out_dtype=
    torch.float32)`` (cuBLAS writes the fp32 accumulator, no bf16 rounding
    of the logits); fp32 operands and the CPU take a plain fp32 product."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Static KV cache, head-major (L, B, Hkv, S, D): the decode kernel reads
    it directly with no per-step transpose."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
