"""AsteroidLM — the 8-channel Qwen3-style decoder, PyTorch port of
``moss_ttsd_tpu/models/lm.py`` (bf16/fp32 and int8 weights, per-row LoRA
adapters for serving, the training forward).

  * 8 embedding tables summed into one hidden stream (``embed``);
  * Qwen3 blocks: RMSNorm, GQA attention with per-head q/k RMSNorm + RoPE,
    SwiGLU MLP; ``attention_bias`` puts a bias on q/k/v and o_proj;
  * 8 LM heads tied to their embedding tables, fp32 logits (``logits_all``),
    optionally over the restricted text-head window only;
  * a static head-major KV cache (L, B, Hkv, S, D) written in place, in the
    compute dtype or int8 with per-head-per-token fp32 scales.

``cfg.quantized`` (w8a16): the seven projections are ``QLinear`` and the
embedding tables int8 with per-row scales (``ops/quantize.py``).

Multi-LoRA serving: ``backbone(adapters=...)`` takes per-row factors
(``select_adapters`` of a ``decode/lora_registry`` stack by adapter id),
and each of the seven projections adds ``bmm(bmm(h, a), b)`` to its base
output (the scale is folded into ``b``; id 0 is the zero adapter). The
continuous pool writes the cache ring-addressed: every row writes the one
scalar slot, ``write_gate`` keeps the old k/v (and scales) of gated-off
rows, and ``read_extent`` gives each row its own decode extent.

Training (the cache-free ``backbone``): the weights may be fp32 masters
under a bf16 ``cfg.dtype``; every weight is cast to the compute dtype where
it is used, as flax casts (``Dense``, ``RMSNorm``, the embedding sum), so no
``torch.autocast`` op list is involved. ``remat`` (default
``cfg.remat_layers``) recomputes each decoder block in the backward
(``torch.utils.checkpoint``, non-reentrant: the counterpart of
``nn.remat(nothing_saveable)``). ``cfg.lora_rank > 0`` gives the
``cfg.lora_targets`` projections trainable ``lora_a`` (in, r) / ``lora_b``
(r, out) factors (JAX ``LoRADense``).

Attention: prefill (T > 1 with a cache) goes through ``flash_prefill`` on
the exact k/v; single-token decode through the extent-clamped
``flash_decode_hs``, or ``flash_decode_int8_hs`` over an int8 cache — the
port's decode attentions; the cache-free forward uses the plain
``gqa_attention``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LMConfig
from ..core.device import DeviceLike, resolve_device, torch_dtype
from ..ops.attention import causal_mask, gqa_attention
from ..ops.flash_attention import (flash_decode_hs, flash_decode_int8_hs,
                                   flash_prefill)
from ..ops.quantize import quantize_kv
from ..ops.rope import apply_rope, rope_cos_sin
from ..utils.convert_lora import lora_scale


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


def _int8(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.int8),
                        requires_grad=False)


class QLinear(nn.Module):
    """Weight-only int8 linear (w8a16, JAX ``QDense``): an int8 (out, in)
    weight, an fp32 (out, 1) per-output-row scale and an optional float
    bias. The scale is cast to the compute dtype before the product, as the
    JAX layer does; activations stay in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False):
        super().__init__()
        self.weight_q = _int8(out_features, in_features)
        self.weight_s = nn.Parameter(torch.ones(out_features, 1),
                                     requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, add_bias: bool = True
                ) -> torch.Tensor:
        w = self.weight_q.to(x.dtype) * self.weight_s.to(x.dtype)
        b = (None if self.bias is None or not add_bias
             else self.bias.to(x.dtype))
        return F.linear(x, w, b)


class Dense(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype at
    use (flax ``nn.Dense(dtype=...)``): fp32 master weights run a bf16
    forward, and weights already in the compute dtype are used as they are.

    ``rank`` > 0 is the JAX ``LoRADense``: y = x W + ((x A) B) * scale
    (+ bias), with A (in, r) and B (r, out) beside the base weight; the
    scale is held at the compute dtype's precision, as JAX's weakly typed
    Python scale is. ``add_bias=False`` leaves the bias to the caller (a
    rowwise tensor-parallel projection adds it after the reduction)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, rank: int = 0, scale: float = 1.0):
        super().__init__(in_features, out_features, bias=bias)
        self.scale = scale
        self.lora_a = self.lora_b = None
        if rank:
            self.lora_a = nn.Parameter(torch.zeros(in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(rank, out_features))

    def forward(self, x: torch.Tensor, add_bias: bool = True
                ) -> torch.Tensor:
        dt = x.dtype
        w, bias = self.weight, (self.bias if add_bias else None)
        if w.dtype != dt:                  # the serving path casts nothing
            w = w.to(dt)
        if bias is not None and bias.dtype != dt:
            bias = bias.to(dt)
        if self.lora_a is None:
            return F.linear(x, w, bias)
        y = F.linear(x, w)
        y = y + ((x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)) * self.scale
        return y if bias is None else y + bias


class Qwen3Block(nn.Module):
    """One decoder layer (JAX ``Qwen3Block``). Under tensor parallelism
    (``tp``, ``parallel/mesh.TensorParallel``) it holds the rank's query
    heads, the KV heads they read and its slice of the MLP: q/k/v/gate/up
    give the rank's outputs, o/down a partial product that one all-reduce
    sums before their bias is added."""

    def __init__(self, cfg: LMConfig, tp=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.tp = tp
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        ffn = c.intermediate_size
        if tp is not None:
            H, Hkv, ffn = tp.heads, len(tp.kv_heads), tp.ffn
        self.heads, self.kv_heads = H, Hkv
        hid, bias = c.hidden_size, c.attention_bias

        def dense(fan_in, fan_out, bias, name):
            if c.quantized:
                return QLinear(fan_in, fan_out, bias=bias)
            if c.lora_rank and name in c.lora_targets:
                scale = lora_scale(c.lora_rank, c.lora_alpha, c.lora_rslora)
                # JAX multiplies by the scale as a weakly typed constant,
                # i.e. rounded to the compute dtype
                scale = float(torch.tensor(scale).to(torch_dtype(c.dtype)))
                return Dense(fan_in, fan_out, bias, c.lora_rank, scale)
            return Dense(fan_in, fan_out, bias)

        self.input_ln = RMSNorm(hid, c.rms_norm_eps)
        self.q_proj = dense(hid, H * D, bias, "q_proj")
        self.k_proj = dense(hid, Hkv * D, bias, "k_proj")
        self.v_proj = dense(hid, Hkv * D, bias, "v_proj")
        self.o_proj = dense(H * D, hid, bias, "o_proj")  # HF Qwen3: o_proj too
        self.q_norm = RMSNorm(D, c.rms_norm_eps)
        self.k_norm = RMSNorm(D, c.rms_norm_eps)
        self.post_ln = RMSNorm(hid, c.rms_norm_eps)
        self.gate_proj = dense(hid, ffn, False, "gate_proj")
        self.up_proj = dense(hid, ffn, False, "up_proj")
        self.down_proj = dense(ffn, hid, False, "down_proj")

    def _proj(self, name: str, h: torch.Tensor,
              adapters: Optional[dict]) -> torch.Tensor:
        """The projection ``name`` of h (B, T, in), plus the rows' LoRA
        delta when ``adapters`` holds this target: (a (B, in, r), b (B, r,
        out)) of this layer, the scale folded into b. A rowwise
        tensor-parallel projection sums the ranks' partial products (the
        delta's too) and then adds its bias once."""
        layer = getattr(self, name)
        partial = self.tp is not None and self.tp.is_rowwise(name)
        y = layer(h, add_bias=not partial)
        if adapters is not None and name in adapters:
            a, b = adapters[name]
            y = y + torch.bmm(torch.bmm(h, a), b)
        if partial:
            y = self.tp.reduce(y)
            if layer.bias is not None:
                y = y + layer.bias.to(y.dtype)
        return y

    def forward(self, x, cos, sin, layer_idx: int, cache: Optional[dict],
                cache_pos: int, key_valid: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                write_gate: Optional[torch.Tensor] = None,
                read_extent: Optional[torch.Tensor] = None,
                adapters: Optional[dict] = None):
        H, Hkv, D = self.heads, self.kv_heads, self.cfg.head_dim
        B, T, _ = x.shape
        h = self.input_ln(x)
        q = self._proj("q_proj", h, adapters).reshape(B, T, H, D)
        k = self._proj("k_proj", h, adapters).reshape(B, T, Hkv, D)
        v = self._proj("v_proj", h, adapters).reshape(B, T, Hkv, D)
        q = apply_rope(self.q_norm(q), cos, sin)
        k = apply_rope(self.k_norm(k), cos, sin)
        scale = D ** -0.5

        if cache is not None:
            # head-major cache (L, B, Hkv, S, D): only the new (B, T, Hkv, D)
            # slice is transposed. The write at the scalar cache_pos is an
            # in-place copy_ into the slot — the counterpart of XLA's in-place
            # dynamic_update_slice on the loop carry; no cache copy is made.
            # An int8 cache ("k_s" present) stores the quantized slice and
            # its per-head-per-token scales. write_gate (B,) bool: rows
            # gated off keep their old sliver (a (B, Hkv, T[, D]) read).
            kv8 = "k_s" in cache
            slot = slice(cache_pos, cache_pos + T)
            for name, new in (("k", k), ("v", v)):
                new = new.transpose(1, 2)
                if kv8:
                    new, sc = quantize_kv(new)
                    _write(cache[name + "_s"][layer_idx][:, :, slot], sc,
                           write_gate)
                _write(cache[name][layer_idx][:, :, slot], new, write_gate)
            if T > 1:
                if cache_pos != 0:
                    raise NotImplementedError(
                        "multi-token segments are prefill-only (cache_pos 0)")
                # prefill: queries see only keys < T, i.e. the current k/v
                # (exact even over an int8 cache: only later steps read it)
                attn = flash_prefill(q, k, v, key_valid[:, :T], scale)
            else:
                # decode: read only the slots up to the one just written,
                # or each row up to its own (B,) int32 extent
                ext = cache_pos + 1 if read_extent is None else read_extent
                if kv8:
                    attn = flash_decode_int8_hs(
                        q, cache["k"], cache["k_s"], cache["v"],
                        cache["v_s"], key_valid, scale, extent=ext,
                        layer=layer_idx)
                else:
                    attn = flash_decode_hs(q, cache["k"], cache["v"],
                                           key_valid, scale, extent=ext,
                                           layer=layer_idx)
        else:
            attn = gqa_attention(q, k, v, mask, scale)
        x = x + self._proj("o_proj", attn.reshape(B, T, H * D), adapters)
        h = self.post_ln(x)
        act = (F.silu(self._proj("gate_proj", h, adapters))
               * self._proj("up_proj", h, adapters))
        return x + self._proj("down_proj", act, adapters)


def _write(dst: torch.Tensor, new: torch.Tensor,
           gate: Optional[torch.Tensor]) -> None:
    """In-place cache write of one sliver (B, Hkv, T[, D]); rows with a
    False ``gate`` keep what ``dst`` holds."""
    if gate is not None:
        new = torch.where(gate.view((-1,) + (1,) * (dst.dim() - 1)),
                          new.to(dst.dtype), dst)
    dst.copy_(new)


def select_adapters(stacks: Dict[str, tuple], ids: torch.Tensor
                    ) -> Dict[str, tuple]:
    """Per-row LoRA factors: each registry stack (a (L, N, in, r), b (L, N,
    r, out)) gathered by the (B,) adapter ids -> (a (L, B, in, r), b (L, B,
    r, out)). The ids change only when a row changes its request, so
    callers gather once per batch (or pool segment), not per step."""
    return {t: (a.index_select(1, ids), b.index_select(1, ids))
            for t, (a, b) in stacks.items()}


class AsteroidLM(nn.Module):
    """8-channel LM. Channel 0 = text+speech vocab; channels 1-7 speech-only.

    ``tp`` (``parallel/mesh.TensorParallel``): the module holds one model
    rank's shard (``parallel/mesh.shard_params``): its heads and MLP slice
    in every block, its rows of the text table (a masked lookup summed over
    the ranks; the tied head's logits gathered to the full fp32 row).
    ``kv_heads`` is the cache's head count either way."""

    def __init__(self, cfg: LMConfig, tp=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.tp = tp
        v0, v1 = (0, c.vocab_size) if tp is None else tp.vocab
        text = (v1 - v0, c.hidden_size)
        speech = (c.channels - 1, c.speech_vocab_size, c.hidden_size)
        if c.quantized:
            # int8 tables + fp32 per-row scales (ops/quantize.py)
            self.embed_text_q = _int8(*text)
            self.embed_text_s = nn.Parameter(torch.ones(text[0], 1),
                                             requires_grad=False)
            self.embed_speech_q = _int8(*speech)
            self.embed_speech_s = nn.Parameter(torch.ones(*speech[:2], 1),
                                               requires_grad=False)
        else:
            self.embed_text = nn.Parameter(torch.empty(text))
            self.embed_speech = nn.Parameter(torch.empty(speech))
        self.layers = nn.ModuleList(Qwen3Block(c, tp)
                                    for _ in range(c.num_hidden_layers))
        self.kv_heads = self.layers[0].kv_heads if self.layers else 0
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    @classmethod
    def init_random(cls, cfg: LMConfig, seed: int = 0,
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> "AsteroidLM":
        """Random weights made on ``device`` (the card unless the caller
        asks for the CPU; no card raises) from a seeded generator:
        embeddings N(0, 0.02), projections N(0, 1/fan_in), norms 1, biases 0,
        LoRA factors ``lora_a`` N(0, 0.02) and ``lora_b`` 0 (the JAX init's
        scales; the draws differ). Float weights: an int8 model is quantized
        from them (``GenerationEngine(quant="int8")``)."""
        device = resolve_device(device)
        dtype = dtype or torch_dtype(cfg.param_dtype)
        with torch.device(device):
            model = cls(cfg).to(dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("embed_") or name.endswith(".lora_a"):
                    p.normal_(0.0, 0.02, generator=gen)
                elif name.endswith("norm.weight") or name.endswith("ln.weight"):
                    p.fill_(1.0)
                elif name.endswith(".bias") or name.endswith(".lora_b"):
                    p.zero_()
                else:
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        return model.eval().requires_grad_(False)

    # -- embeddings ----------------------------------------------------------

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, T, C) -> summed embeddings (B, T, hidden). Ids are
        clamped into each table (the JAX ``take(mode="clip")``). int8
        tables: the gathered rows and their scales are dequantized in the
        compute dtype and summed in it."""
        c = self.cfg
        dtype = torch_dtype(c.dtype)
        ids = [input_ids[..., 0].clamp(0, c.vocab_size - 1)] + [
            input_ids[..., i].clamp(0, c.speech_vocab_size - 1)
            for i in range(1, c.channels)]
        if c.quantized:
            rows = [self._text_rows(ids[0], lambda i: (
                self.embed_text_q[i].to(dtype)
                * self.embed_text_s[i].to(dtype)))]
            rows += [self.embed_speech_q[i - 1][ids[i]].to(dtype)
                     * self.embed_speech_s[i - 1][ids[i]].to(dtype)
                     for i in range(1, c.channels)]
            x = rows[0]
            for r in rows[1:]:
                x = x + r
            return x
        x = self._text_rows(ids[0], lambda i: F.embedding(i, self.embed_text))
        for i in range(1, c.channels):
            x = x + F.embedding(ids[i], self.embed_speech[i - 1])
        return x.to(dtype)

    def _text_rows(self, ids: torch.Tensor, lookup) -> torch.Tensor:
        """``lookup`` of the clamped text ids; vocab-parallel: each rank
        looks up the ids of its rows (the others give 0) and the sum over
        the ranks is the full lookup (exact: one rank adds a non-zero)."""
        tp = self.tp
        if tp is None or not tp.vocab_split:
            return lookup(ids)
        v0, v1 = tp.vocab
        mine = (ids >= v0) & (ids < v1)
        rows = lookup(torch.where(mine, ids - v0, 0))
        rows = torch.where(mine[..., None], rows, 0)
        return tp.reduce(rows)

    # -- backbone ------------------------------------------------------------

    def backbone(self, input_ids: torch.Tensor, positions: torch.Tensor,
                 key_valid: torch.Tensor, cache: Optional[dict],
                 cache_pos: int = 0,
                 write_gate: Optional[torch.Tensor] = None,
                 read_extent: Optional[torch.Tensor] = None,
                 adapters: Optional[Dict[str, tuple]] = None,
                 remat: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run the decoder stack.

        input_ids (B, T, C); positions (B, T) absolute RoPE positions;
        key_valid (B, S) cache-slot validity, or (B, T) without a cache;
        cache {"k","v": (L, B, Hkv, S, D)} updated in place, or None;
        cache_pos: the scalar write slot of this segment; a one-token
        segment reads the cache up to extent cache_pos + 1;
        write_gate (B,) bool: ring-addressed decode (the continuous pool),
        rows gated off keep their old cache sliver; slot order is not time
        order there, and key_valid alone carries causality;
        read_extent (B,) int32: each row's decode extent, in place of
        cache_pos + 1;
        adapters: per-row LoRA factors from ``select_adapters``;
        remat: recompute each block in the backward (the cache-free
        training forward; default ``cfg.remat_layers``).
        Returns (hidden (B, T, hidden) after the final norm, cache)."""
        c = self.cfg
        x = self.embed(input_ids)
        B, T, _ = x.shape
        if write_gate is not None and T != 1:
            raise ValueError("ring-addressed writes are decode-only (T 1)")
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        mask = None if cache is not None else causal_mask(0, T, T, key_valid)
        remat = c.remat_layers if remat is None else remat
        if remat and cache is not None:
            raise ValueError("remat is for the cache-free training forward")
        for li, layer in enumerate(self.layers):
            ad = (None if adapters is None else
                  {t: (a[li], b[li]) for t, (a, b) in adapters.items()})
            args = (x, cos, sin, li, cache, cache_pos, key_valid, mask,
                    write_gate, read_extent, ad)
            # non-reentrant: frozen inputs (a LoRA step) still give the
            # factors inside the block their gradients
            x = (checkpoint(layer, *args, use_reentrant=False) if remat
                 else layer(*args))
        return self.final_norm(x), cache

    # -- tied heads ----------------------------------------------------------

    def logits_all(self, hidden: torch.Tensor, restricted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """hidden (..., hidden) -> (text_logits (..., vocab), speech_logits
        (..., C-1, speech_vocab)), both fp32.

        The products run on the tables' own dtype (int8 tables cast to the
        compute dtype) with fp32 accumulation and fp32 output
        (``matmul_f32_out``): no fp32 copy of the 152704 x 2048 table is
        ever made. int8 per-row scales multiply the fp32 product, output
        side. ``restricted``: text logits over the ``cfg.text_head_window()``
        rows only (index i means vocab id lo + i)."""
        c = self.cfg
        lo, hi = c.text_head_window() if restricted else (0, c.vocab_size)
        t = self._text_head(hidden, lo, hi)
        lead = hidden.shape[:-1]
        h = self._head_input(hidden)
        Cm1, Vs, Hd = c.channels - 1, c.speech_vocab_size, c.hidden_size
        if c.quantized:
            w = self.embed_speech_q.reshape(Cm1 * Vs, Hd).to(h.dtype)
            s = (matmul_f32_out(h, w.t())
                 * self.embed_speech_s.reshape(Cm1 * Vs).float())
        else:
            s = matmul_f32_out(h, self.embed_speech.reshape(Cm1 * Vs, Hd).t())
        return t, s.reshape(*lead, Cm1, Vs)

    def _head_input(self, hidden: torch.Tensor) -> torch.Tensor:
        dtype = (torch_dtype(self.cfg.dtype) if self.cfg.quantized
                 else self.embed_text.dtype)
        return hidden.to(dtype).reshape(-1, hidden.shape[-1])

    def _text_head(self, hidden: torch.Tensor, lo: int, hi: int
                   ) -> torch.Tensor:
        """Text logits over table rows [lo, hi): (..., hi - lo) fp32.
        Vocab-parallel: each rank's rows inside the window, gathered."""
        h = self._head_input(hidden)
        t = self._head_rows(h, lo, hi)
        if self.tp is not None:
            t = self.tp.gather_vocab(t, lo, hi)
        return t.reshape(*hidden.shape[:-1], hi - lo)

    def _head_rows(self, h: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """(N, rows) fp32 logits of this module's table rows inside
        [lo, hi) (all of them without tensor parallelism)."""
        v0 = 0
        if self.tp is not None:
            v0 = self.tp.vocab[0]
            lo, hi = self.tp.window(lo, hi)
            hi = max(lo, hi)
        a, b = lo - v0, hi - v0
        if self.cfg.quantized:
            w = self.embed_text_q[a:b].to(h.dtype)
            return matmul_f32_out(h, w.t()) * self.embed_text_s[a:b, 0].float()
        return matmul_f32_out(h, self.embed_text[a:b].t())

    def text_logits_outside_max(self, hidden: torch.Tensor) -> torch.Tensor:
        """Max channel-0 logit outside the restricted-head window — the
        audit probe of ``cfg.restricted_audit_every``: one full-table head
        product that asks whether the full head would have preferred an
        ordinary text token. hidden (B, 1, H) -> (B,) fp32. Vocab-parallel:
        each rank's max over its rows, then the max over the ranks."""
        lo, hi = self.cfg.text_head_window()
        v0, v1 = (0, self.cfg.vocab_size) if self.tp is None else \
            self.tp.window(0, self.cfg.vocab_size)
        t = self._head_rows(self._head_input(hidden), 0, self.cfg.vocab_size)
        t[:, max(lo, v0) - v0:max(min(hi, v1), v0) - v0] = float("-inf")
        m = t.amax(dim=-1)
        return m if self.tp is None else self.tp.max(m)

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
               device: DeviceLike = "cuda",
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Static KV cache, head-major (L, B, Hkv, S, D), on ``device`` (the
    card unless the caller asks for the CPU; no card raises): the decode
    kernels read it directly with no per-step transpose. With
    ``cfg.kv_quant == "int8"`` k/v are int8 and "k_s"/"v_s" hold fp32
    (L, B, Hkv, S) scales. ``kv_heads``: a tensor-parallel rank's local
    head count (``AsteroidLM.kv_heads``) in place of the config's."""
    device = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch,
             kv_heads or cfg.num_key_value_heads, max_len, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], device=device),
                "v_s": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
