"""A plain AFMoE language model under the eight TTSD channels, for the CPU
tests of the port's AFMoE block (``tests/test_torch_afmoe.py``).

Plain ``torch`` in float32 (TF32 off), one unpadded row at a time, no cache,
no batching, and nothing of the JAX package or of the port's kernels: the
full causal forward that prefill-then-decode through the port's cache must
agree with. It follows the layer equations that the configuration
``trinity-mini-ep2-bf16`` stands for (PERF.md; arcee-ai's public ``afmoe``
modeling code, which the installed ``transformers`` does not have):

  x = sqrt(H) * sum_c E_c[id_c]                       (mup_enabled)
  h = input_ln(x); q, k, v = h Wq, h Wk, h Wv; q, k RMSNormed per head;
      RoPE (rotate-half) on q, k in sliding layers only
  x += post_attn_ln((attn(q, k, v) * sigmoid(h Wg)) Wo)
      attention over keys j <= i, and j > i - window in a sliding layer
  h = pre_mlp_ln(x)
  x += post_mlp_ln(mlp(h)): SwiGLU in the first num_dense_layers, else
      shared(h) + sum over the chosen experts held here of w_e expert_e(h):
      s = sigmoid(h Wr) (fp32); chosen = top-k of s + expert_bias;
      w = route_scale * s_e / sum of the chosen s
  logits_c = final_ln(x) head_c^T (heads untied)

The experts a layer holds are ``share`` = (offset, count) of the router's
width, sliced from the weights' full stacks (those of the shares a test
compares) or given as they are (the port's own held stacks).
Departures from the published description: the eight summed channel
embeddings and the eight heads are MOSS-TTSD's, not the text model's one of
each.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) rotated by positions 0 .. T - 1, rotate-half."""
    T, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    ang = torch.arange(T, dtype=torch.float32)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)[:, None, :]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def route(cfg, h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chosen (T, k) expert ids, their weights (T, k))."""
    s = torch.sigmoid(h @ router.t())
    chosen = torch.topk(s + bias, cfg.num_experts_per_tok, dim=-1).indices
    sel = s.gather(-1, chosen)
    if cfg.route_norm:
        sel = sel / sel.sum(-1, keepdim=True)
    return chosen, sel * cfg.route_scale


def swiglu(h, gate, up, down):
    return (F.silu(h @ gate.t()) * (h @ up.t())) @ down.t()


def routed(cfg, h: torch.Tensor, chosen: torch.Tensor, w: torch.Tensor,
           gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           offset: int) -> torch.Tensor:
    """The chosen experts' weighted sum over those of the stacks (E, ...)
    held from ``offset``; the others give nothing."""
    out = torch.zeros_like(h)
    for e in range(gate.shape[0]):
        rows, slot = torch.nonzero(chosen == offset + e, as_tuple=True)
        if rows.numel():
            y = swiglu(h[rows], gate[e], up[e], down[e])
            out.index_add_(0, rows, y * w[rows, slot, None])
    return out


class AFMoERef:
    """The model over a {port state-dict name: tensor} dict (cast to
    float32) and the port's ``LMConfig``. ``share`` (offset, count): the
    routed experts held, as a slice of the weights' stacks when they hold
    the router's whole width, else the stacks as given from
    ``cfg.expert_offset``."""

    def __init__(self, cfg, weights: Dict[str, torch.Tensor],
                 share: Optional[Tuple[int, int]] = None):
        self.cfg = cfg
        self.w = {n: t.detach().float().cpu() for n, t in weights.items()}
        self.share = share or (cfg.expert_offset, cfg.num_experts)
        self.chosen: List[torch.Tensor] = []     # per MoE layer, last row

    def experts(self, li: int):
        """(gate, up, down, offset) of layer li's held experts."""
        p = f"layers.{li}.mlp."
        g, u, d = (self.w[p + n] for n in ("gate_proj", "up_proj",
                                           "down_proj"))
        off, n = self.share
        if g.shape[0] == self.cfg.router_width:
            return g[off:off + n], u[off:off + n], d[off:off + n], off
        return g, u, d, self.cfg.expert_offset

    def mlp(self, li: int, h: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """(routed part of the held experts, shared expert) of layer li."""
        c, p = self.cfg, f"layers.{li}.mlp."
        chosen, w = route(c, h, self.w[p + "router.weight"],
                          self.w[p + "expert_bias"])
        self.chosen.append(chosen)
        g, u, d, off = self.experts(li)
        part = routed(c, h, chosen, w, g, u, d, off)
        shared = swiglu(h, *(self.w[f"{p}shared.{n}.weight"] for n in (
            "gate_proj", "up_proj", "down_proj")))
        return part, shared

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (T, C) of one row -> (T, hidden) after the final norm."""
        c, w = self.cfg, self.w
        T, C = ids.shape
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        eps = c.rms_norm_eps
        x = F.embedding(ids[:, 0].clamp(0, c.vocab_size - 1), w["embed_text"])
        for i in range(1, C):
            x = x + F.embedding(ids[:, i].clamp(0, c.speech_vocab_size - 1),
                                w["embed_speech"][i - 1])
        if c.mup_enabled:
            x = x * math.sqrt(c.hidden_size)
        pos = torch.arange(T)
        self.chosen = []
        for li in range(c.num_hidden_layers):
            p = f"layers.{li}."
            W = c.layer_window(li)
            h = rms_norm(x, w[p + "input_ln.weight"], eps)
            q = (h @ w[p + "q_proj.weight"].t()).view(T, H, D)
            k = (h @ w[p + "k_proj.weight"].t()).view(T, Hkv, D)
            v = (h @ w[p + "v_proj.weight"].t()).view(T, Hkv, D)
            q = rms_norm(q, w[p + "q_norm.weight"], eps)
            k = rms_norm(k, w[p + "k_norm.weight"], eps)
            if W:
                q, k = rope(q, c.rope_theta), rope(k, c.rope_theta)
            k = k.repeat_interleave(H // Hkv, dim=1)
            v = v.repeat_interleave(H // Hkv, dim=1)
            s = torch.einsum("thd,shd->hts", q, k) * D ** -0.5
            see = pos[None, :] <= pos[:, None]
            if W:
                see = see & (pos[None, :] > pos[:, None] - W)
            a = torch.einsum("hts,shd->thd",
                             torch.softmax(s.masked_fill(~see, -math.inf), -1),
                             v).reshape(T, H * D)
            a = a * torch.sigmoid(h @ w[p + "g_proj.weight"].t())
            x = x + rms_norm(a @ w[p + "o_proj.weight"].t(),
                             w[p + "post_attn_ln.weight"], eps)
            h = rms_norm(x, w[p + "pre_mlp_ln.weight"], eps)
            if c.is_moe_layer(li):
                part, shared = self.mlp(li, h)
                m = part + shared
            else:
                m = swiglu(h, *(w[f"{p}mlp.{n}.weight"] for n in (
                    "gate_proj", "up_proj", "down_proj")))
            x = x + rms_norm(m, w[p + "post_mlp_ln.weight"], eps)
        return rms_norm(x, w["final_norm.weight"], eps)

    def logits(self, hidden: torch.Tensor, channel: int) -> torch.Tensor:
        table = (self.w["head_text"] if channel == 0
                 else self.w["head_speech"][channel - 1])
        return hidden @ table.t()
