"""asteroid-qwen3: AsteroidTTS, MOSS-TTSD's LM, on a dense Qwen3 backbone.

Eight embedding tables summed (channel 0 over the text vocab, channels 1-7
over the speech vocab), every layer alike (RMSNorm, grouped-query attention
with per-head q/k RMSNorm and RoPE, SwiGLU), and eight heads tied to the
tables. The plain forward is ``reference/lm.py``'s ``RefLM``.

Init (the port's own scales): embeddings N(0, 0.02), projections N(0,
1/fan_in), norms 1, biases 0. LoRA voices adapt the seven projections.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ttsd_bench.reference import lm as rlm

port_model = "moss_ttsd_torch.models.lm.AsteroidLM"


def _widths(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """The seven projections of a layer: {name: (in, out)}."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    hid, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    return {"q_proj": (hid, H * D), "k_proj": (hid, Hkv * D),
            "v_proj": (hid, Hkv * D), "o_proj": (H * D, hid),
            "gate_proj": (hid, ffn), "up_proj": (hid, ffn),
            "down_proj": (ffn, hid)}


def lm_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    hid, D = cfg["hidden_size"], cfg["head_dim"]
    spec = [("embed_text", (cfg["vocab_size"], hid)),
            ("embed_speech", (cfg["channels"] - 1, cfg["speech_vocab_size"],
                              hid)),
            ("final_norm.weight", (hid,))]
    shapes = {n: (o, i) for n, (i, o) in _widths(cfg).items()}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [(p + "input_ln.weight", (hid,)),
                 (p + "post_ln.weight", (hid,)),
                 (p + "q_norm.weight", (D,)), (p + "k_norm.weight", (D,))]
        spec += [(p + n + ".weight", s) for n, s in shapes.items()]
    return spec


def lm_rule(name: str, shape) -> Tuple[str, float]:
    if name.startswith("embed_"):
        return "normal", 0.02
    if name.endswith(("norm.weight", "ln.weight")):
        return "const", 1.0
    if name.endswith(".bias"):
        return "const", 0.0
    return "normal", 1.0 / math.sqrt(shape[1])


def lora_targets(cfg: dict) -> Dict[str, Tuple[int, int]]:
    return _widths(cfg)


def reference(cfg: dict, weights: Dict[str, torch.Tensor],
              weight_format: Optional[str] = None,
              dtype: torch.dtype = torch.float32) -> rlm.RefLM:
    return rlm.RefLM(cfg, weights, weight_format, dtype)


# -- the work a call needs (counts.py's rules) --------------------------------

def lm_params(cfg: dict) -> Dict[str, int]:
    """Weights a token passes through: every layer's seven projections and
    the eight tied heads (the whole text vocabulary and the seven speech
    tables)."""
    block = sum(i * o for i, o in _widths(cfg).values())
    heads = (cfg["vocab_size"] + (cfg["channels"] - 1)
             * cfg["speech_vocab_size"]) * cfg["hidden_size"]
    return {"backbone": cfg["num_hidden_layers"] * block, "heads": heads}


def attention_flops(cfg: dict, queries: int, keys: int) -> float:
    """QK^T and PV of one row in one layer."""
    return 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * queries * keys


def decode_flops(cfg: dict, keys: Iterable[int]) -> float:
    """One decode step of rows that attend over ``keys`` each: two FLOPs a
    weight and a row, and attention in every layer."""
    p = lm_params(cfg)
    per_row = 2.0 * (p["backbone"] + p["heads"])
    L = cfg["num_hidden_layers"]
    return sum(per_row + L * attention_flops(cfg, 1, n) for n in keys)


def b1_work(cfg: dict, valid: Iterable[int]) -> Dict[str, float]:
    """One prefill attention call (one layer) over rows of ``valid``
    prompt tokens: causal FLOPs; q, k, v read and the output written over
    the valid tokens, bf16, and the validity bytes."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    valid = list(valid)
    flops = sum(attention_flops(cfg, n, n) / 2.0 for n in valid)
    tokens = sum(valid)
    nbytes = tokens * (2 * H * D + 2 * Hkv * D) * 2 + tokens
    return {"flops": flops, "bytes": float(nbytes)}


def decode_attention_work(cfg: dict, keys: Iterable[int], rows: int,
                          kv_bytes: int) -> Dict[str, float]:
    """One decode attention call (one layer): every row's query read and
    output written (bf16), each row's valid keys and values read once
    (``kv_bytes`` an element: 2 for bf16, 1 for int8 plus a float32 scale
    per head and slot), and their validity bytes."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    keys = list(keys)
    slot = 2 * Hkv * D * kv_bytes + (2 * Hkv * 4 if kv_bytes == 1 else 0) + 1
    nbytes = rows * 2 * H * D * 2 + sum(keys) * slot
    flops = sum(attention_flops(cfg, 1, n) for n in keys)
    return {"flops": flops, "bytes": float(nbytes)}
