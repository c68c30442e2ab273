"""asteroid-afmoe: MOSS-TTSD's eight channels on an AFMoE backbone
(arcee-ai's Trinity, HF ``afmoe``).

Eight embedding tables summed and scaled by sqrt(hidden) (muP); each layer
an AFMoE block: gated attention with sandwich norms, RoPE and a window in
the sliding layers only, a dense SwiGLU in the first ``num_dense_layers``
and then routed experts (sigmoid scores, top-k of score + bias, weights
normalised over the chosen and scaled) beside a shared expert; eight heads
of their own. The configuration holds ``num_experts`` of the router's
``router_experts`` (from ``expert_offset``): one chip's share of expert
parallelism. The plain forward is ``reference/afmoe.py``'s ``RefAFMoE``.

Init (the port's own scales): embeddings N(0, 0.02), every matrix and
expert N(0, 1/fan_in), norms 1, ``expert_bias`` N(0, 0.05) so that the
bias moves some choices. No LoRA voice adapts the block (the port refuses
one).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

from ttsd_bench.reference import afmoe as rafmoe

port_model = "moss_ttsd_torch.models.lm.AsteroidLM"


def _attention(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """The attention's projections of a layer: {name: (in, out)}."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    hid = cfg["hidden_size"]
    return {"q_proj": (hid, H * D), "k_proj": (hid, Hkv * D),
            "v_proj": (hid, Hkv * D), "g_proj": (hid, H * D),
            "o_proj": (H * D, hid)}


def _swiglu(prefix: str, hid: int, width: int) -> list:
    return [(prefix + "gate_proj.weight", (width, hid)),
            (prefix + "up_proj.weight", (width, hid)),
            (prefix + "down_proj.weight", (hid, width))]


def _is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["num_dense_layers"]


def lm_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    hid, D = cfg["hidden_size"], cfg["head_dim"]
    E, I = cfg["num_experts"], cfg["moe_intermediate_size"]
    text = (cfg["vocab_size"], hid)
    speech = (cfg["channels"] - 1, cfg["speech_vocab_size"], hid)
    spec = [("embed_text", text), ("embed_speech", speech),
            ("head_text", text), ("head_speech", speech),
            ("final_norm.weight", (hid,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [(p + n + ".weight", (hid,)) for n in (
            "input_ln", "post_attn_ln", "pre_mlp_ln", "post_mlp_ln")]
        spec += [(p + "q_norm.weight", (D,)), (p + "k_norm.weight", (D,))]
        spec += [(p + n + ".weight", (o, i_)) for n, (i_, o) in
                 _attention(cfg).items()]
        if not _is_moe(cfg, i):
            spec += _swiglu(p + "mlp.", hid, cfg["intermediate_size"])
            continue
        m = p + "mlp."
        spec += [(m + "router.weight", (cfg["router_experts"], hid)),
                 (m + "expert_bias", (cfg["router_experts"],)),
                 (m + "gate_proj", (E, I, hid)), (m + "up_proj", (E, I, hid)),
                 (m + "down_proj", (E, hid, I))]
        spec += _swiglu(m + "shared.", hid, cfg["num_shared_experts"] * I)
    return spec


def lm_rule(name: str, shape) -> Tuple[str, float]:
    if name.startswith("embed_"):
        return "normal", 0.02
    if name.endswith(("norm.weight", "ln.weight")):
        return "const", 1.0
    if name.endswith("expert_bias"):
        return "normal", 0.05
    return "normal", 1.0 / math.sqrt(shape[-1])


def lora_targets(cfg: dict) -> Dict[str, Tuple[int, int]]:
    return {}


def reference(cfg: dict, weights: Dict[str, torch.Tensor],
              weight_format=None,
              dtype: torch.dtype = torch.float32) -> rafmoe.RefAFMoE:
    return rafmoe.RefAFMoE(cfg, weights, weight_format, dtype)


# -- the work a call needs (counts.py's rules) --------------------------------

def _windows(cfg: dict) -> List[int]:
    """Each layer's window; 0 = every earlier key."""
    return [cfg["sliding_window"] if t == "sliding_attention" else 0
            for t in cfg["layer_types"]]


def expert_params(cfg: dict) -> int:
    """One routed expert's weights (gate, up, down)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def lm_params(cfg: dict) -> Dict[str, float]:
    """Weights a token passes through: every layer's attention, the dense
    layers' SwiGLU, each expert layer's router, shared expert and the
    expected held share of its routed experts (top-k times the share of
    the router's experts held here), and the eight heads."""
    hid, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    dense = cfg["num_dense_layers"]
    attn = sum(i * o for i, o in _attention(cfg).values())
    held = cfg["num_experts_per_tok"] * cfg["num_experts"] \
        / cfg["router_experts"]
    moe = (cfg["router_experts"] * hid
           + cfg["num_shared_experts"] * expert_params(cfg)
           + held * expert_params(cfg))
    backbone = (L * attn + dense * 3 * hid * cfg["intermediate_size"]
                + (L - dense) * moe)
    heads = (cfg["vocab_size"] + (cfg["channels"] - 1)
             * cfg["speech_vocab_size"]) * hid
    return {"backbone": backbone, "heads": heads}


def attention_flops(cfg: dict, queries: int, keys: int) -> float:
    """QK^T and PV of one row in one layer."""
    return 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * queries * keys


def _pairs(n: int, window: int) -> float:
    """(query, key) pairs of a causal prefill of n tokens (half the square,
    as ``asteroid-qwen3`` counts), each query's keys clipped to a window."""
    if not window or n <= window:
        return n * n / 2.0
    return window * window / 2.0 + (n - window) * window


def decode_flops(cfg: dict, keys: Iterable[int]) -> float:
    """One decode step of rows that attend over ``keys`` each: two FLOPs a
    weight and a row (the experts by their expected held share), and
    attention in every layer over the keys inside its window."""
    p = lm_params(cfg)
    per_row = 2.0 * (p["backbone"] + p["heads"])
    wins = _windows(cfg)
    return sum(per_row + sum(attention_flops(cfg, 1, min(n, w) if w else n)
                             for w in wins) for n in keys)


def b1_work(cfg: dict, valid: Iterable[int]) -> Dict[str, float]:
    """One prefill attention call over rows of ``valid`` prompt tokens, its
    mean over the layers (sliding and full): causal FLOPs over each
    layer's window; q, k, v read and the output written over the valid
    tokens, bf16, and the validity bytes (the same in every layer)."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    valid = list(valid)
    wins = _windows(cfg)
    flops = sum(4.0 * H * D * _pairs(n, w) for w in wins
                for n in valid) / len(wins)
    tokens = sum(valid)
    nbytes = tokens * (2 * H * D + 2 * Hkv * D) * 2 + tokens
    return {"flops": flops, "bytes": float(nbytes)}


def decode_attention_work(cfg: dict, keys: Iterable[int], rows: int,
                          kv_bytes: int) -> Dict[str, float]:
    """One decode attention call, its mean over the layers: every row's
    query read and output written (bf16), each row's keys and values
    inside the layer's window read once (``kv_bytes`` an element), and
    their validity bytes."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    keys = list(keys)
    wins = _windows(cfg)
    slot = 2 * Hkv * D * kv_bytes + 1
    read = [sum(min(n, w) if w else n for n in keys) for w in wins]
    nbytes = rows * 2 * H * D * 2 + sum(read) / len(wins) * slot
    flops = sum(attention_flops(cfg, 1, r) for r in read) / len(wins)
    return {"flops": flops, "bytes": float(nbytes)}


def moe_work(cfg: dict, pairs: float, experts_read: float
             ) -> Dict[str, float]:
    """One call of the grouped expert product (a decode step's expert
    layer): ``pairs`` (token, held expert) pairs over ``experts_read``
    distinct held experts. FLOPs: the gate, up and down products of each
    pair, two a weight; bytes: each expert read once (bf16), and per pair
    its token's hidden row read and its weighted product written (bf16)."""
    hid = cfg["hidden_size"]
    return {"flops": 2.0 * expert_params(cfg) * pairs,
            "bytes": float(experts_read * expert_params(cfg) * 2
                           + pairs * 2 * hid * 2)}
