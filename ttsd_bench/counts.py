"""The work a call needs, counted from its shapes and valid extents, and
the chip's published peaks.

Counts are of the mathematics, whatever implements it: each input byte
read once and each output byte written once, attention over the keys a
row really has (not the padded capacity), the model's FLOPs as two per
weight per token plus attention. A later kernel or fused step that does
less work does not make these numbers stale.
"""

from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def lm_params(cfg: dict) -> Dict[str, int]:
    """Weights a token passes through: the 28 blocks' seven projections
    and the eight tied heads (the whole text vocabulary and the seven
    speech tables)."""
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    hid, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    block = hid * H * D * 2 + hid * Hkv * D * 2 + 3 * hid * ffn
    heads = (cfg["vocab_size"] + (cfg["channels"] - 1)
             * cfg["speech_vocab_size"]) * hid
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


def roofline_percent(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the chip could take (the larger of FLOPs over the
    bf16 peak and bytes over HBM bandwidth), as a percentage of
    ``seconds``."""
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
