"""The plain AFMoE language model under MOSS-TTSD's eight channels
(``asteroid-afmoe``, ``ttsd_bench/arch/asteroid-afmoe.py`` lists its
tensors), for judging served tokens.

A full causal forward of one row (no cache, no kernels, no batching) of the
layer equations that the configuration stands for (PERF.md section 4;
arcee-ai's public ``afmoe`` modeling code):

  x = sqrt(hidden) * sum_c E_c[id_c]                  (mup_enabled)
  h = input_ln(x); q, k, v projections of h, q and k RMSNormed per head,
      rotate-half RoPE on q, k in sliding layers only (full layers have no
      position encoding)
  x += post_attn_ln(o_proj(attn(q, k, v) * sigmoid(g_proj(h))))
      over keys j <= i, and j > i - sliding_window in a sliding layer
  h = pre_mlp_ln(x)
  x += post_mlp_ln(mlp(h)): SwiGLU of intermediate_size in the first
      num_dense_layers layers, else the shared expert plus, over the
      num_experts_per_tok experts chosen by the top-k of s + expert_bias
      (s = sigmoid(router(h)) in float32) and held here, route_scale *
      s_e / (sum of the chosen s) times the expert's SwiGLU
  logits_c = final_ln(x) head_c^T, heads untied from the tables

The experts held are the configuration's ``expert_offset`` and
``num_experts`` of the router's ``router_experts``: the weights carry only
those, and a token's choices of the others add nothing (one chip's share of
expert parallelism; the program drops them alike). Departures from the
published description: the eight summed channel embeddings and the eight
heads are MOSS-TTSD's; the absent experts' share is left out, as above.

To fit beside its own weights on the card, the model keeps the tensors it
is handed (bf16, as ``weights.make`` gives them) and casts each where it is
used: to float32 for the reference, which is exact since the values are
bf16. Attention is computed in blocks of queries over the keys each block
can see. ``weight_format`` (a control: "int8", "int4", "fp8") quantizes
each matrix per row where it is used (``lm.fake_quant``), the router and
the heads included; norms and the expert bias stay as they are.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .lm import fake_quant

QUERY_BLOCK = 512


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * w.to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) rotated by positions 0 .. T - 1, rotate-half."""
    T, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None]
    ang = torch.cat([ang, ang], -1)[:, None, :]
    xf = x.float()
    rot = torch.cat([-xf[..., D // 2:], xf[..., :D // 2]], -1)
    return (xf * torch.cos(ang) + rot * torch.sin(ang)).to(x.dtype)


class RefAFMoE:
    """The model over a {name: tensor} weight dict (kept as given), with
    ``dtype`` the compute dtype (float32 for the reference, bf16 for a
    plain or control computation) and ``weight_format`` as the module
    docstring says. ``hidden`` and ``logits`` as ``reference/lm.RefLM``'s;
    ``kv_bits`` and ``voice`` are not taken (the block is served with
    neither)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 weight_format: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.fmt = weight_format
        self.w = weights
        self._heads: Dict[str, torch.Tensor] = {}

    def _t(self, name: str, index: Optional[int] = None) -> torch.Tensor:
        """Weight ``name`` (one expert of a stack with ``index``) in the
        compute dtype, quantized per row by ``weight_format`` if a
        matrix."""
        t = self.w[name]
        if index is not None:
            t = t[index]
        if self.fmt is not None and t.dim() >= 2:
            t = fake_quant(t, self.fmt)
        return t.to(self.dtype)

    def _window(self, li: int) -> int:
        c = self.cfg
        return (c["sliding_window"]
                if c["layer_types"][li] == "sliding_attention" else 0)

    def _attend(self, q, k, v, W: int) -> torch.Tensor:
        """Causal attention of (T, H, D) queries over (T, Hkv, D) keys and
        values, a window W > 0 narrowing each query's keys, in blocks of
        queries; softmax in float32, P in the compute dtype."""
        T, H, D = q.shape
        g = H // k.shape[1]
        out = torch.empty_like(q)
        for q0 in range(0, T, QUERY_BLOCK):
            q1 = min(T, q0 + QUERY_BLOCK)
            k0 = max(0, q0 - W + 1) if W else 0
            kb = k[k0:q1].repeat_interleave(g, dim=1)
            vb = v[k0:q1].repeat_interleave(g, dim=1)
            s = torch.einsum("thd,shd->hts", q[q0:q1], kb).float() * D ** -0.5
            qi = torch.arange(q0, q1, device=q.device)[:, None]
            kj = torch.arange(k0, q1, device=q.device)[None, :]
            see = kj <= qi
            if W:
                see = see & (kj > qi - W)
            p = torch.softmax(s.masked_fill(~see[None], float("-inf")), -1)
            out[q0:q1] = torch.einsum("hts,shd->thd", p.to(self.dtype), vb)
        return out

    def _swiglu(self, h, gate, up, down) -> torch.Tensor:
        return (F.silu(h @ gate.t()) * (h @ up.t())) @ down.t()

    def _experts(self, li: int, h: torch.Tensor) -> torch.Tensor:
        """The routed experts held here, weighted, plus the shared one."""
        c = self.cfg
        p = f"layers.{li}.mlp."
        s = torch.sigmoid((h @ self._t(p + "router.weight").t()).float())
        chosen = torch.topk(s + self.w[p + "expert_bias"].float(),
                            c["num_experts_per_tok"], dim=-1).indices
        sel = s.gather(-1, chosen)
        if c["route_norm"]:
            sel = sel / sel.sum(-1, keepdim=True)
        wts = sel * c["route_scale"]
        out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        local = chosen - c["expert_offset"]
        for e in range(c["num_experts"]):
            rows, slot = torch.nonzero(local == e, as_tuple=True)
            if rows.numel():
                y = self._swiglu(h[rows], *(self._t(p + n, e) for n in (
                    "gate_proj", "up_proj", "down_proj")))
                out.index_add_(0, rows, y.float() * wts[rows, slot, None])
        shared = self._swiglu(h, *(self._t(f"{p}shared.{n}.weight") for n in (
            "gate_proj", "up_proj", "down_proj")))
        return shared + out.to(self.dtype)

    def hidden(self, ids: torch.Tensor, prompt_len: int,
               kv_bits: Optional[int] = None, voice=None) -> torch.Tensor:
        """ids (T, C) of one row, unpadded -> (T, hidden) after the final
        norm."""
        if kv_bits is not None or voice is not None:
            raise ValueError("the AFMoE reference takes no int8 cache and "
                             "no voice")
        c, dt = self.cfg, self.dtype
        T, C = ids.shape
        H, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        eps = c["rms_norm_eps"]
        x = F.embedding(ids[:, 0].clamp(0, c["vocab_size"] - 1),
                        self._t("embed_text"))
        speech = self._t("embed_speech")
        for i in range(1, C):
            x = x + F.embedding(ids[:, i].clamp(0, c["speech_vocab_size"] - 1),
                                speech[i - 1])
        del speech
        if c.get("mup_enabled"):
            x = x * math.sqrt(c["hidden_size"])
        for li in range(c["num_hidden_layers"]):
            p = f"layers.{li}."
            W = self._window(li)
            h = rms_norm(x, self.w[p + "input_ln.weight"], eps)
            q = (h @ self._t(p + "q_proj.weight").t()).view(T, H, D)
            k = (h @ self._t(p + "k_proj.weight").t()).view(T, Hkv, D)
            v = (h @ self._t(p + "v_proj.weight").t()).view(T, Hkv, D)
            q = rms_norm(q, self.w[p + "q_norm.weight"], eps)
            k = rms_norm(k, self.w[p + "k_norm.weight"], eps)
            if W:
                q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
            a = self._attend(q, k, v, W).reshape(T, H * D)
            a = a * torch.sigmoid(h @ self._t(p + "g_proj.weight").t())
            x = x + rms_norm(a @ self._t(p + "o_proj.weight").t(),
                             self.w[p + "post_attn_ln.weight"], eps)
            h = rms_norm(x, self.w[p + "pre_mlp_ln.weight"], eps)
            if li < c["num_dense_layers"]:
                m = self._swiglu(h, *(self._t(f"{p}mlp.{n}.weight") for n in (
                    "gate_proj", "up_proj", "down_proj")))
            else:
                m = self._experts(li, h)
            x = x + rms_norm(m, self.w[p + "post_mlp_ln.weight"], eps)
        return rms_norm(x, self.w["final_norm.weight"], eps)

    def logits(self, hidden: torch.Tensor, channel: int) -> torch.Tensor:
        """(N, hidden) -> float32 logits of one channel's head."""
        name = "head_text" if channel == 0 else "head_speech"
        if name not in self._heads:       # cast (or quantized) once
            self._heads[name] = self._t(name)
        table = self._heads[name]
        if channel:
            table = table[channel - 1]
        return (hidden.to(self.dtype) @ table.t()).float()
