"""AsteroidLM — the 8-channel Qwen3-style decoder, PyTorch port of
``moss_ttsd_tpu/models/lm.py`` (bf16/fp32 and int8 weights, per-row LoRA
adapters for serving, the training forward).

  * 8 embedding tables summed into one hidden stream (``embed``);
  * Qwen3 blocks: RMSNorm, GQA attention with per-head q/k RMSNorm + RoPE,
    SwiGLU MLP; ``attention_bias`` puts a bias on q/k/v and o_proj;
  * 8 LM heads tied to their embedding tables (or untied), fp32 logits
    (``logits_all``),
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

Attention: both blocks attend over the cache through ``attend_cached``
(the write, then ``flash_prefill`` for a prefill, the extent-clamped
``flash_decode_hs`` for a single-token decode, or ``flash_decode_int8_hs``
over an int8 cache — the port's decode attentions — with the layer's
window); the cache-free forward uses the plain ``gqa_attention``.
``cfg.attn_impl == "xla"`` (the JAX package's dense backend) attends with
the dense einsums of ``ops/attention.py`` instead (``attend_dense``), over
the cache slots just written (an int8 cache dequantized first); the pool's
per-row extents keep the decode kernels under every backend, as in JAX.

The elementwise glue between the projections (RMSNorm with the residual
adds around it, the per-head q/k RMSNorm with RoPE, silu(gate) * up) goes
through ``ops/fused_norm`` (``block_glue``): in a cached forward one kernel
launch each on the card; the cache-free forward runs its plain versions,
the chains of ops they fuse, which autograd differentiates. The norm
modules (``RMSNorm``) only hold their weights.

Bench-only stubs (``bench_full.py`` reads them in JAX; ``chip_smoke.py``
on the card): ``cfg.ablate_norms`` makes every RMSNorm ``x * w``,
``cfg.ablate_rope`` skips the q/k rotations, ``cfg.ablate_attention`` sets
the cached forward's attention output to q (the cache writes stay). Under
``ablate_norms`` or ``ablate_rope`` the glue runs its plain ops.

``cfg.block_type == "afmoe"`` (the port only; arcee-ai's Trinity) builds
every layer as an ``AFMoEBlock``: gated attention with sandwich norms,
RoPE and a window (``cfg.layer_window``) in the sliding layers only, and a
dense SwiGLU in the first ``cfg.num_dense_layers`` or else a ``MoE`` of the
experts held here (``ops/moe.py``: routed on the device, one grouped
kernel a decode call); ``cfg.mup_enabled`` scales the summed embeddings by
sqrt(hidden); ``cfg.tie_word_embeddings`` False gives the eight heads
tables of their own (``head_text``, ``head_speech``). The expert block
serves through the static engine only (``GenerationEngine``); the paths
that do not run it refuse it (``LMConfig.refuse_afmoe``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import LMConfig
from ..core.device import DeviceLike, resolve_device, torch_dtype
from ..ops.attention import causal_mask, gqa_attention, gqa_attention_hs
from ..ops.flash_attention import (flash_decode_hs, flash_decode_int8_hs,
                                   flash_prefill)
from ..ops.fused_norm import (qk_norm_rope, qk_norm_rope_plain,
                              residual_rms_norm, residual_rms_norm_plain,
                              silu_mul, silu_mul_plain)
from ..ops.moe import moe_experts, route
from ..ops.quantize import quantize_kv
from ..ops.rope import rope_cos_sin
from ..ops.w8a16 import matmul_f32_out, w8a16_product, w8a16_products
from ..utils.convert_lora import lora_scale
from ..utils.profiling import label


def block_glue(cache: Optional[dict], cfg: LMConfig):
    """The elementwise glue of a block forward (``ops/fused_norm``):
    (residual_rms_norm, qk_norm_rope, silu_mul). A cached forward takes the
    fused wrappers (a kernel each on the card, the plain version on the
    CPU). The cache-free forward, which autograd runs through, and the
    bench-only ``ablate_norms`` / ``ablate_rope`` stubs take the plain
    versions, with ``ablate_norms`` bound."""
    if cache is not None and not (cfg.ablate_norms or cfg.ablate_rope):
        return residual_rms_norm, qk_norm_rope, silu_mul
    if not cfg.ablate_norms:
        return residual_rms_norm_plain, qk_norm_rope_plain, silu_mul_plain
    return (partial(residual_rms_norm_plain, ablate=True),
            partial(qk_norm_rope_plain, ablate=True), silu_mul_plain)


class RMSNorm(nn.Module):
    """The weight of one RMSNorm; the blocks apply it through their glue
    (``block_glue``) with ``cfg.rms_norm_eps``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


def _int8(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.int8),
                        requires_grad=False)


class QLinear(nn.Module):
    """Weight-only int8 linear (w8a16, JAX ``QDense``): an int8 (out, in)
    weight, an fp32 (out, 1) per-output-row scale and an optional float
    bias. The scale is cast to the compute dtype before the product, as the
    JAX layer does; activations stay in the compute dtype. The product is
    ``ops/w8a16.w8a16_product``: on the card a kernel that reads the int8
    weight as it is."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False):
        super().__init__()
        self.weight_q = _int8(out_features, in_features)
        self.weight_s = nn.Parameter(torch.ones(out_features, 1),
                                     requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, add_bias: bool = True
                ) -> torch.Tensor:
        b = None if self.bias is None or not add_bias else self.bias
        return w8a16_product(x, self.weight_q, self.weight_s, b)


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
    sums before their bias is added. With a cache it attends through
    ``attend_cached`` (no window); without one through ``gqa_attention``
    under the backbone's mask."""

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
                scale = float(torch.tensor(scale, device="cpu").to(
                    torch_dtype(c.dtype)))
                return Dense(fan_in, fan_out, bias, c.lora_rank, scale)
            return Dense(fan_in, fan_out, bias)

        self.input_ln = RMSNorm(hid)
        self.q_proj = dense(hid, H * D, bias, "q_proj")
        self.k_proj = dense(hid, Hkv * D, bias, "k_proj")
        self.v_proj = dense(hid, Hkv * D, bias, "v_proj")
        self.o_proj = dense(H * D, hid, bias, "o_proj")  # HF Qwen3: o_proj too
        self.q_norm = RMSNorm(D)
        self.k_norm = RMSNorm(D)
        self.post_ln = RMSNorm(hid)
        self.gate_proj = dense(hid, ffn, False, "gate_proj")
        self.up_proj = dense(hid, ffn, False, "up_proj")
        self.down_proj = dense(ffn, hid, False, "down_proj")

    def _proj(self, name: str, h: torch.Tensor,
              adapters: Optional[dict],
              y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The projection ``name`` of h (B, T, in), plus the rows' LoRA
        delta when ``adapters`` holds this target: (a (B, in, r), b (B, r,
        out)) of this layer, the scale folded into b. A rowwise
        tensor-parallel projection sums the ranks' partial products (the
        delta's too) and then adds its bias once. ``y``: the base product,
        already computed (``_projs``)."""
        layer = getattr(self, name)
        partial = self.tp is not None and self.tp.is_rowwise(name)
        if y is None:
            y = layer(h, add_bias=not partial)
        if adapters is not None and name in adapters:
            a, b = adapters[name]
            y = y + torch.bmm(torch.bmm(h, a), b)
        if partial:
            y = self.tp.reduce(y)
            if layer.bias is not None:
                y = y + layer.bias.to(y.dtype)
        return y

    def _projs(self, names: Tuple[str, ...], h: torch.Tensor,
               adapters: Optional[dict]) -> list:
        """``_proj`` of each of ``names`` over the same h (q/k/v, gate/up:
        column-wise on a tensor-parallel mesh, so whole outputs). int8
        weights share one ``w8a16_products`` call: one kernel launch on
        the card."""
        layers = [getattr(self, n) for n in names]
        if not isinstance(layers[0], QLinear):
            return [self._proj(n, h, adapters) for n in names]
        ys = w8a16_products(h, [(m.weight_q, m.weight_s, m.bias)
                                for m in layers])
        return [self._proj(n, h, adapters, y) for n, y in zip(names, ys)]

    def forward(self, x, cos, sin, layer_idx: int, cache: Optional[dict],
                cache_pos: Union[int, torch.Tensor], key_valid: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                write_gate: Optional[torch.Tensor] = None,
                read_extent: Optional[torch.Tensor] = None,
                adapters: Optional[dict] = None, seq=None):
        c = self.cfg
        H, Hkv, D = self.heads, self.kv_heads, c.head_dim
        B, T, _ = x.shape
        eps = c.rms_norm_eps
        res_norm, qk_norm, glu = block_glue(cache, c)
        _, h = res_norm(x, None, self.input_ln.weight, eps)
        q, k, v = self._projs(("q_proj", "k_proj", "v_proj"), h, adapters)
        q, k = qk_norm(q.reshape(B, T, H, D), k.reshape(B, T, Hkv, D),
                       self.q_norm.weight, self.k_norm.weight, eps, cos, sin,
                       rope=not c.ablate_rope)     # the bench-only rope stub
        v = v.reshape(B, T, Hkv, D)
        if cache is not None:
            attn = attend_cached(q, k, v, cache, layer_idx, cache_pos,
                                 key_valid, mask=mask, write_gate=write_gate,
                                 read_extent=read_extent,
                                 ablate=c.ablate_attention)
        else:
            if seq is not None:
                # sequence parallelism: this rank's queries against every
                # rank's keys (gathered after RoPE; the backward sums the
                # ranks' cotangents and keeps this rank's window)
                k, v = seq.gather(k), seq.gather(v)
            attn = gqa_attention(q, k, v, mask, D ** -0.5)
        o = self._proj("o_proj", attn.reshape(B, T, H * D), adapters)
        x, h = res_norm(x, o, self.post_ln.weight, eps)
        gate, up = self._projs(("gate_proj", "up_proj"), h, adapters)
        return x + self._proj("down_proj", glu(gate, up), adapters)


class MoE(nn.Module):
    """The AFMoE block's expert MLP: a shared SwiGLU of ``num_shared_experts``
    x ``moe_intermediate_size`` that every token runs, plus the routed
    experts held here, ``cfg.num_experts`` of the router's
    ``cfg.router_width`` from ``cfg.expert_offset``, stored as the grouped
    kernel reads them: ``gate_proj`` / ``up_proj`` (E, I, H) and
    ``down_proj`` (E, H, I). The router (``router``, ``expert_bias``)
    routes over all of them; pairs routed to experts held elsewhere are
    dropped (on one chip the exchange that would add them is left out).
    ``counts``, set by the model, gains each decode call's pairs, experts
    read and call (``ops/moe.py``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        c = cfg
        hid, I, E = c.hidden_size, c.moe_intermediate_size, c.num_experts
        self.cfg = cfg
        self.router = Dense(hid, c.router_width)
        self.expert_bias = nn.Parameter(torch.zeros(c.router_width))
        self.gate_proj = nn.Parameter(torch.empty(E, I, hid))
        self.up_proj = nn.Parameter(torch.empty(E, I, hid))
        self.down_proj = nn.Parameter(torch.empty(E, hid, I))
        width = c.num_shared_experts * I
        self.shared = (SwiGLU(hid, width) if width else None)
        self.counts: Optional[torch.Tensor] = None

    def forward(self, h: torch.Tensor, glu=silu_mul) -> torch.Tensor:
        c = self.cfg
        B, T, H = h.shape
        x = h.reshape(B * T, H)
        with label("lm.moe.route"):
            idx, w = route(x, self.router.weight, self.expert_bias,
                           c.num_experts_per_tok, c.route_scale, c.route_norm)
        with label("lm.moe.experts"):
            y = moe_experts(x, idx, w, self.gate_proj, self.up_proj,
                            self.down_proj, c.expert_offset,
                            self.counts if T == 1 else None)
        y = y.reshape(B, T, H)
        return y if self.shared is None else self.shared(h, glu) + y


class SwiGLU(nn.Module):
    """down(silu(gate h) * up h), the dense MLP of the AFMoE block."""

    def __init__(self, hid: int, width: int):
        super().__init__()
        self.gate_proj = Dense(hid, width)
        self.up_proj = Dense(hid, width)
        self.down_proj = Dense(width, hid)

    def forward(self, h: torch.Tensor, glu=silu_mul) -> torch.Tensor:
        """``glu``: the block's silu(gate) * up (``block_glue``)."""
        return self.down_proj(glu(self.gate_proj(h), self.up_proj(h)))


class AFMoEBlock(nn.Module):
    """One AFMoE decoder layer (arcee-ai's Trinity, HF ``afmoe``):

        h = input_ln(x); q, k, v = proj(h), q and k RMSNormed per head, RoPE
        in a sliding layer only (a full layer has no position encoding);
        x += post_attn_ln(o_proj(attn(q, k, v) * sigmoid(g_proj(h))));
        x += post_mlp_ln(mlp(pre_mlp_ln(x)))

    with the attention over keys in (p - window, p] in a sliding layer
    (``cfg.layer_window``), and ``mlp`` a ``SwiGLU`` of intermediate_size
    in the first ``num_dense_layers`` layers, a ``MoE`` after them. It
    attends through ``attend_cached`` with the layer's window, and runs
    only over the static engine's contiguous cache (slot order is time
    order, so a window over slots is exact); the cache-free (training)
    forward refuses it."""

    def __init__(self, cfg: LMConfig, layer: int):
        super().__init__()
        c = cfg
        self.cfg = cfg
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.heads, self.kv_heads = H, Hkv
        self.window = c.layer_window(layer)
        hid = c.hidden_size

        self.input_ln = RMSNorm(hid)
        self.q_proj = Dense(hid, H * D, c.attention_bias)
        self.k_proj = Dense(hid, Hkv * D, c.attention_bias)
        self.v_proj = Dense(hid, Hkv * D, c.attention_bias)
        self.g_proj = Dense(hid, H * D)
        self.o_proj = Dense(H * D, hid, c.attention_bias)
        self.q_norm = RMSNorm(D)
        self.k_norm = RMSNorm(D)
        self.post_attn_ln = RMSNorm(hid)
        self.pre_mlp_ln = RMSNorm(hid)
        self.post_mlp_ln = RMSNorm(hid)
        self.mlp = (MoE(c) if c.is_moe_layer(layer)
                    else SwiGLU(hid, c.intermediate_size))

    def forward(self, x, cos, sin, layer_idx: int, cache: Optional[dict],
                cache_pos: Union[int, torch.Tensor], key_valid: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                write_gate: Optional[torch.Tensor] = None,
                read_extent: Optional[torch.Tensor] = None,
                adapters: Optional[dict] = None, seq=None):
        if cache is None:
            self.cfg.refuse_afmoe("the cache-free forward")
        c = self.cfg
        H, Hkv, D = self.heads, self.kv_heads, c.head_dim
        B, T, _ = x.shape
        W = self.window
        eps = c.rms_norm_eps
        res_norm, qk_norm, glu = block_glue(cache, c)
        _, h = res_norm(x, None, self.input_ln.weight, eps)
        q, k = qk_norm(self.q_proj(h).reshape(B, T, H, D),
                       self.k_proj(h).reshape(B, T, Hkv, D),
                       self.q_norm.weight, self.k_norm.weight, eps, cos, sin,
                       rope=bool(W) and not c.ablate_rope)
        v = self.v_proj(h).reshape(B, T, Hkv, D)
        attn = attend_cached(q, k, v, cache, layer_idx, cache_pos, key_valid,
                             window=W, mask=mask,
                             write_gate=write_gate, read_extent=read_extent,
                             ablate=c.ablate_attention)
        gated = attn.reshape(B, T, H * D) * torch.sigmoid(self.g_proj(h))
        x, h = res_norm(x, self.o_proj(gated), self.pre_mlp_ln.weight, eps,
                        w_y=self.post_attn_ln.weight)
        x, _ = res_norm(x, self.mlp(h, glu), None, eps,
                        w_y=self.post_mlp_ln.weight)
        return x


def attend_cached(q, k, v, cache: dict, layer_idx: int,
                  cache_pos: Union[int, torch.Tensor],
                  key_valid: torch.Tensor, *, window: int = 0,
                  mask: Optional[torch.Tensor] = None,
                  write_gate: Optional[torch.Tensor] = None,
                  read_extent: Optional[torch.Tensor] = None,
                  ablate: bool = False) -> torch.Tensor:
    """The cached attention of both decoder blocks: k/v (B, T, Hkv, D)
    written into layer ``layer_idx`` of the cache in place (only the new
    slice transposed; into an int8 cache quantized, with its scales) at a
    host ``cache_pos``, rows with a False ``write_gate`` keeping their old
    sliver, or at a () int64 device slot (one ungated token) through
    ``index_copy_``; then q (B, T, H, D) attends: the ``ablate`` stub
    (``cfg.ablate_attention``) returns q; a dense ``mask`` (the backbone's,
    ``attn_impl="xla"``) selects ``attend_dense``; a prefill (T > 1) runs
    ``flash_prefill`` on the exact k/v (only later steps read the cache);
    a decode reads up to ``read_extent`` (B,) int32, else the slot just
    written, through ``flash_decode_int8_hs`` (int8 cache) or
    ``flash_decode_hs``. ``window`` > 0 (an AFMoE sliding layer): each
    query sees its last ``window`` keys only."""
    B, T = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    kv8 = "k_s" in cache
    dev_pos = isinstance(cache_pos, torch.Tensor)
    if dev_pos and (T != 1 or write_gate is not None):
        raise ValueError("a tensor cache_pos is one ungated token")
    if T > 1 and cache_pos != 0:
        raise NotImplementedError(
            "multi-token segments are prefill-only (cache_pos 0)")
    for name, new in (("k", k), ("v", v)):
        new = new.transpose(1, 2)
        parts = [(name, new)]
        if kv8:
            new, sc = quantize_kv(new)
            parts = [(name + "_s", sc), (name, new)]
        for key, val in parts:
            dst = cache[key][layer_idx]
            if dev_pos:
                dst.index_copy_(2, cache_pos.reshape(1), val.to(dst.dtype))
            else:
                _write(dst[:, :, cache_pos:cache_pos + T], val, write_gate)
    if ablate:
        return q
    if mask is not None:
        return attend_dense(q, cache, layer_idx, mask, scale)
    if T > 1:
        return flash_prefill(q, k, v, key_valid[:, :T], scale, window=window)
    ext = read_extent
    if ext is None:
        ext = slot_extent(cache_pos, B) if dev_pos else cache_pos + 1
    if kv8:
        return flash_decode_int8_hs(q, cache["k"], cache["k_s"], cache["v"],
                                    cache["v_s"], key_valid, scale,
                                    extent=ext, layer=layer_idx)
    return flash_decode_hs(q, cache["k"], cache["v"], key_valid, scale,
                           extent=ext, layer=layer_idx, window=window)


def attend_dense(q, cache: dict, layer_idx: int, mask: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """The dense attention of ``attn_impl="xla"`` (JAX ``xla_attend``)
    over this layer's first ``mask.shape[-1]`` cache slots, just written:
    a prefill's own keys, a decode's written prefix. An int8 cache is
    dequantized in the compute dtype first, so a prefill over it reads the
    quantized k/v, as JAX's dense prefill does."""
    Sp, dt = mask.shape[-1], q.dtype
    kv = [cache[n][layer_idx][:, :, :Sp].to(dt) for n in ("k", "v")]
    if "k_s" in cache:
        kv = [t * cache[n][layer_idx][:, :, :Sp, None].to(dt)
              for t, n in zip(kv, ("k_s", "v_s"))]
    return gqa_attention_hs(q, kv[0], kv[1], mask, scale)


def _write(dst: torch.Tensor, new: torch.Tensor,
           gate: Optional[torch.Tensor]) -> None:
    """In-place cache write of one sliver (B, Hkv, T[, D]); rows with a
    False ``gate`` keep what ``dst`` holds."""
    if gate is not None:
        new = torch.where(gate.view((-1,) + (1,) * (dst.dim() - 1)),
                          new.to(dst.dtype), dst)
    dst.copy_(new)


def slot_extent(cache_pos: torch.Tensor, batch: int) -> torch.Tensor:
    """The (B,) int32 decode extent ``cache_pos + 1`` of a device write
    slot, the form the decode kernels take per row."""
    return (cache_pos + 1).to(torch.int32).reshape(1).repeat(batch)


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
        if tp is not None:
            c.refuse_afmoe("a tensor-parallel mesh")
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
        if not c.tie_word_embeddings:
            if c.quantized or tp is not None:
                raise ValueError("untied heads are served unquantized on one "
                                 "model rank")
            self.head_text = nn.Parameter(torch.empty(text))
            self.head_speech = nn.Parameter(torch.empty(speech))
        if c.afmoe:
            self.layers = nn.ModuleList(AFMoEBlock(c, i)
                                        for i in range(c.num_hidden_layers))
        else:
            self.layers = nn.ModuleList(Qwen3Block(c, tp)
                                        for _ in range(c.num_hidden_layers))
        self.kv_heads = self.layers[0].kv_heads if self.layers else 0
        self.moe_counts: Optional[torch.Tensor] = None
        self.final_norm = RMSNorm(c.hidden_size)

    @classmethod
    def init_random(cls, cfg: LMConfig, seed: int = 0,
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> "AsteroidLM":
        """Random weights made on ``device`` (the card unless the caller
        asks for the CPU; no card raises) from a seeded generator:
        embeddings N(0, 0.02), projections N(0, 1/fan_in), norms 1, biases 0,
        LoRA factors ``lora_a`` N(0, 0.02) and ``lora_b`` 0 (the JAX init's
        scales; the draws differ); the AFMoE block's untied heads and
        experts N(0, 1/fan_in) too, its ``expert_bias`` N(0, 0.05) (so that
        the bias moves some choices). Float weights: an int8 model is
        quantized from them (``GenerationEngine(quant="int8")``)."""
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
                elif name.endswith(".expert_bias"):
                    p.normal_(0.0, 0.05, generator=gen)
                else:       # (out, in), or an expert stack (E, out, in)
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]),
                              generator=gen)
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
        x = x.to(dtype)
        if c.mup_enabled:                   # the muP input scale
            x = x * math.sqrt(c.hidden_size)
        return x

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
                 cache_pos: Union[int, torch.Tensor] = 0,
                 write_gate: Optional[torch.Tensor] = None,
                 read_extent: Optional[torch.Tensor] = None,
                 adapters: Optional[Dict[str, tuple]] = None,
                 remat: Optional[bool] = None, seq=None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run the decoder stack.

        input_ids (B, T, C); positions (B, T) absolute RoPE positions;
        key_valid (B, S) cache-slot validity, or (B, T) without a cache;
        cache {"k","v": (L, B, Hkv, S, D)} updated in place, or None;
        cache_pos: the scalar write slot of this segment; a one-token
        segment reads the cache up to extent cache_pos + 1; or a () int64
        tensor on the device (one ungated token, not the dense backend),
        written through ``index_copy_`` and read up to the same extent;
        write_gate (B,) bool: ring-addressed decode (the continuous pool),
        rows gated off keep their old cache sliver; slot order is not time
        order there, and key_valid alone carries causality;
        read_extent (B,) int32: each row's decode extent, in place of
        cache_pos + 1;
        adapters: per-row LoRA factors from ``select_adapters``;
        remat: recompute each block in the backward (the cache-free
        training forward; default ``cfg.remat_layers``, which a cached
        forward ignores);
        seq (``parallel/mesh.SequenceParallel``, cache-free only): the
        rows hold this seq rank's window of the time axis, ``positions``
        are the window's, ``key_valid`` is the whole (B, T) row's, and
        each block attends over every rank's keys.
        Returns (hidden (B, T, hidden) after the final norm, cache)."""
        c = self.cfg
        x = self.embed(input_ids)
        B, T, _ = x.shape
        if write_gate is not None and T != 1:
            raise ValueError("ring-addressed writes are decode-only (T 1)")
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        mask = None
        if c.afmoe and c.num_experts:
            self._attach_counts(x.device)
        if cache is None:
            # each query's global position against all of the row's keys
            S = key_valid.shape[1]
            q0 = 0 if seq is None else seq.window(S).start
            mask = causal_mask(q0, T, S, key_valid)
        elif seq is not None:
            raise ValueError("sequence parallelism is cache-free")
        elif isinstance(cache_pos, torch.Tensor):
            if c.attn_impl == "xla" and not c.ablate_attention:
                raise ValueError("the dense backend reads a host cache_pos")
            if read_extent is None:         # once for every layer
                read_extent = slot_extent(cache_pos, B)
        elif c.attn_impl == "xla" and not c.ablate_attention:
            # the dense backend's mask (None selects the kernels): a
            # prefill's causal one over its own keys; a sequential decode
            # reads the slots up to the one it writes, a ring-addressed
            # decode without extents (the pool's len_aware=False) the whole
            # cache. The pool's per-row extents keep the decode kernels, as
            # the JAX extent branch does under every backend.
            if T > 1:
                mask = causal_mask(0, T, T, key_valid[:, :T])
            elif read_extent is None:
                Sp = (key_valid.shape[1] if write_gate is not None
                      else cache_pos + 1)
                mask = key_valid[:, None, :Sp]
        if remat is None:
            # cfg.remat_layers has no effect on a serving forward (no
            # backward), as in the JAX package
            remat = c.remat_layers and cache is None
        elif remat and cache is not None:
            raise ValueError("remat is for the cache-free training forward")
        for li, layer in enumerate(self.layers):
            ad = (None if adapters is None else
                  {t: (a[li], b[li]) for t, (a, b) in adapters.items()})
            args = (x, cos, sin, li, cache, cache_pos, key_valid, mask,
                    write_gate, read_extent, ad, seq)
            # non-reentrant: frozen inputs (a LoRA step) still give the
            # factors inside the block their gradients
            with label("lm.layer"):
                x = (checkpoint(layer, *args, use_reentrant=False) if remat
                     else layer(*args))
        _, h = block_glue(cache, c)[0](x, None, self.final_norm.weight,
                                       c.rms_norm_eps)
        return h, cache

    def _attach_counts(self, device: torch.device) -> None:
        """The expert layers' device counters ``moe_counts`` (held pairs,
        experts read, calls; ``ops/moe.py``), made on the first forward on
        ``device`` (eager: a capture finds them made) and shared by every
        ``MoE`` layer."""
        if self.moe_counts is not None and self.moe_counts.device == device:
            return
        self.moe_counts = torch.zeros(3, dtype=torch.int64, device=device)
        for layer in self.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.counts = self.moe_counts

    # -- heads (tied to the tables, or their own) ----------------------------

    def logits_all(self, hidden: torch.Tensor, restricted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """hidden (..., hidden) -> (text_logits (..., vocab), speech_logits
        (..., C-1, speech_vocab)), both fp32.

        The products run on the tables' own dtype with fp32 accumulation
        and fp32 output (``matmul_f32_out``): no fp32 copy of the 152704 x
        2048 table is ever made. int8 tables go through
        ``ops/w8a16.w8a16_product`` (on the card a kernel, no copy; on
        the CPU the table cast to the compute dtype), their per-row scales
        multiplying the fp32 product, output side.
        ``restricted``: text logits over the ``cfg.text_head_window()``
        rows only (index i means vocab id lo + i)."""
        c = self.cfg
        lo, hi = c.text_head_window() if restricted else (0, c.vocab_size)
        t = self._text_head(hidden, lo, hi)
        lead = hidden.shape[:-1]
        h = self._head_input(hidden)
        Cm1, Vs, Hd = c.channels - 1, c.speech_vocab_size, c.hidden_size
        if c.quantized:
            s = w8a16_product(h, self.embed_speech_q.reshape(Cm1 * Vs, Hd),
                              self.embed_speech_s.reshape(Cm1 * Vs),
                              head=True)
        else:
            table = (self.embed_speech if c.tie_word_embeddings
                     else self.head_speech)
            s = matmul_f32_out(h, table.reshape(Cm1 * Vs, Hd).t())
        return t, s.reshape(*lead, Cm1, Vs)

    def _text_table(self) -> torch.Tensor:
        return (self.embed_text if self.cfg.tie_word_embeddings
                else self.head_text)

    def _head_input(self, hidden: torch.Tensor) -> torch.Tensor:
        dtype = (torch_dtype(self.cfg.dtype) if self.cfg.quantized
                 else self._text_table().dtype)
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
            return w8a16_product(h, self.embed_text_q[a:b],
                                 self.embed_text_s[a:b, 0], head=True)
        return matmul_f32_out(h, self._text_table()[a:b].t())

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
