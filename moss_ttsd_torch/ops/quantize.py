"""int8 weights (w8a16) and the int8 KV cache, PyTorch port of
``moss_ttsd_tpu/ops/quantize.py`` and of ``quantize_kv``
(``moss_ttsd_tpu/ops/pallas_attention.py``).

Weights: symmetric per-channel int8 over the port's state-dict names.
  * projections ``layers.{l}.{proj}.weight`` (out, in) become ``weight_q``
    int8 (out, in) and ``weight_s`` fp32 (out, 1): one scale per output row
    (the JAX (in, out) kernel is quantized over its contraction axis, the
    same rows);
  * embeddings ``embed_text`` (V, H) / ``embed_speech`` (C-1, V, H) become
    ``embed_*_q`` int8 and ``embed_*_s`` fp32 with one scale per row — right
    for the gather and for the tied head, whose scale applies output-side.
Norm weights and biases stay as they are; a projection's ``lora_a`` /
``lora_b`` factors are dropped (int8 serving runs the base weights, as
the JAX package's does). ``scale = max(amax, 1e-8) / 127``
and round half to even (``torch.round`` as ``jnp.round``), so the int8
bytes equal the JAX package's.

KV cache: per-head-per-token int8 with ``s = max(amax / 127, 1e-8)`` and
round half up (``floor(x / s + 0.5)``), clipped to +-127 — the bytes the
JAX engine writes into its int8 cache.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj")
_EMBEDS = ("embed_text", "embed_speech")


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by true division on every device. The divisor is a tensor:
    CUDA computes division by a Python scalar as a product with its
    reciprocal, which can round the scale one ulp away from the CPU's (and
    the JAX package's) quotient."""
    return x / torch.full_like(x, 127.0)


def _quantize(w: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``dim``. Returns (q int8, scale fp32 keepdim)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=dim, keepdim=True)
    scale = _div127(amax.clamp_min(1e-8))
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def is_quantized_tree(state: Mapping[str, torch.Tensor]) -> bool:
    """True if the state dict is already in the int8 layout (``weight_q`` /
    ``embed_*_q`` names): engines skip the cast and re-quantization."""
    return any(k.endswith(".weight_q") or k in ("embed_text_q",
                                                "embed_speech_q")
               for k in state)


def quantize_lm_params(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Float ``AsteroidLM`` state dict -> the state dict of the quantized
    model (``LMConfig.quantized``). Everything else passes through."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        parts = k.rsplit(".", 2)
        if (len(parts) == 3 and parts[1] in _PROJ_NAMES
                and parts[2] == "weight"):
            q, s = _quantize(v, dim=-1)            # one scale per output row
            out[k + "_q"], out[k + "_s"] = q, s
        elif (len(parts) == 3 and parts[1] in _PROJ_NAMES
              and parts[2] in ("lora_a", "lora_b")):
            continue             # int8 projections carry no LoRA factors
        elif k in _EMBEDS:
            q, s = _quantize(v, dim=-1)            # one scale per table row
            out[k + "_q"], out[k + "_s"] = q, s
        else:
            out[k] = v
    return out


def dequantize_lm_params(qstate: Mapping[str, torch.Tensor],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """Inverse mapping (tests, export): quantized state dict -> float."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in qstate.items():
        if k.endswith("_s") and k[:-2] + "_q" in qstate:
            continue
        if k.endswith("_q"):
            out[k[:-2]] = v.to(dtype) * qstate[k[:-2] + "_s"].to(dtype)
        else:
            out[k] = v
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head-per-token int8 quantization of k/v slices.

    x (..., D) -> (x_q int8 (..., D), scales fp32 (...,)) with
    x ~ x_q * scales[..., None]."""
    xf = x.float()
    s = _div127(xf.abs().amax(dim=-1)).clamp_min(1e-8)
    q = torch.floor(xf / s[..., None] + 0.5).clamp(-127, 127).to(torch.int8)
    return q, s
