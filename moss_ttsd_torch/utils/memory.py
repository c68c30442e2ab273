"""Serving-memory estimate, port of ``moss_ttsd_tpu/utils/memory.py``: the
device memory one decode engine needs (weights, KV cache, host-visible
buffers) for a batch and an audio length, so a deployment can size its
cache before it starts. Pure arithmetic over ``LMConfig``; it counts
neither the codec nor activations.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.config import LMConfig

FRAME_RATE = 12.5       # codec frames (LM steps) per second of audio


@dataclass
class MemoryEstimate:
    weights_gb: float
    kv_cache_gb: float
    buffers_gb: float

    @property
    def total_gb(self) -> float:
        return self.weights_gb + self.kv_cache_gb + self.buffers_gb


def lm_param_count(cfg: LMConfig) -> int:
    H, D = cfg.num_attention_heads, cfg.head_dim
    Hkv = cfg.num_key_value_heads
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    per_layer = h * (H * D) + 2 * h * (Hkv * D) + (H * D) * h + 3 * h * f \
        + 2 * h + 2 * D
    embeds = cfg.vocab_size * h + (cfg.channels - 1) * cfg.speech_vocab_size * h
    return L * per_layer + embeds + h


def serving_memory(cfg: LMConfig, batch: int, max_audio_seconds: float,
                   prompt_len: int = 64, quant: str | None = None,
                   cache_bytes: int = 2) -> MemoryEstimate:
    """Device-memory estimate for one decode engine instance (GB = 1e9
    bytes).

    quant="int8" stores projection/embedding weights int8 (+fp32
    per-channel scales, ~1%); cache_bytes=2 for the bf16 KV cache, 1 for
    the int8 one.
    """
    params = lm_param_count(cfg)
    wbytes = params * (1.01 if quant == "int8" else 2.0)
    S = prompt_len + int(max_audio_seconds * FRAME_RATE) + cfg.channels
    kv = (cfg.num_hidden_layers * batch * cfg.num_key_value_heads * S
          * cfg.head_dim * 2 * cache_bytes)
    # token buffer + presence masks + logits workspace (fp32 text vocab row)
    buffers = batch * S * cfg.channels * 4 \
        + batch * cfg.vocab_size * (1 + 4) \
        + batch * (cfg.channels - 1) * cfg.speech_vocab_size
    return MemoryEstimate(weights_gb=wbytes / 1e9, kv_cache_gb=kv / 1e9,
                          buffers_gb=buffers / 1e9)
