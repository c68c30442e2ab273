"""HF-format LM checkpoints, PyTorch port of
``moss_ttsd_tpu/utils/convert_lm.py``.

The reference (AsteroidTTSInstruct over a transformers Qwen3Model) names
its weights ``model.embedding_list.{i}.weight``,
``model.language_model.layers.{l}.{self_attn.{q,k,v,o}_proj |
self_attn.{q,k}_norm | input_layernorm | post_attention_layernorm |
mlp.{gate,up,down}_proj}``, ``model.language_model.norm.weight`` and the
tied ``lm_heads.{i}.weight``, in torch's (out, in) layout: the port's own
layout, so export and import only rename (and split or stack the speech
tables).

  * ``export_asteroid_state_dict``: an ``AsteroidLM`` (or its state dict)
    -> the reference's names;
  * ``save_asteroid_checkpoint``: that state dict, LoRA factors merged
    first when given, as ``*.safetensors`` + ``config.json`` (the
    reference's save_pretrained layout), written by the port's own
    safetensors writer, in fp32 unless asked otherwise;
  * ``load_asteroid_checkpoint``: a checkpoint directory (every
    ``*.safetensors``, else ``pytorch_model*.bin``) -> the ``AsteroidLM``
    state dict, read tensor by tensor and cast once to ``dtype``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping, Optional

import torch

from ..core.config import LMConfig
from .convert_jax import _REF_NORM, _REF_PROJ, load_reference_lm_state_dict
from .convert_lora import read_safetensors, write_safetensors


def export_asteroid_state_dict(params, cfg: LMConfig,
                               include_tied_heads: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """An ``AsteroidLM`` or its float state dict -> the reference-format
    state dict, the same tensors renamed (no copy; the speech tables are
    views of ``embed_speech``). The inner Qwen3Model's ``embed_tokens``
    (dead weight in the reference, present in its state dict) is emitted
    as the channel-0 table, and with ``include_tied_heads`` the
    ``lm_heads.{i}.weight`` too, as the JAX exporter does. LoRA leaves are
    not exported: merge them first (``save_asteroid_checkpoint(lora=)``,
    ``train/lora.fold_lora_tree``)."""
    cfg.refuse_afmoe("the reference (Qwen3-named) checkpoint format")
    p = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    if "embed_text" not in p:
        raise ValueError("an int8 (quantized) model has no reference-format "
                         "export; export the float weights")
    sd: Dict[str, torch.Tensor] = {
        "model.embedding_list.0.weight": p["embed_text"]}
    for i in range(1, cfg.channels):
        sd[f"model.embedding_list.{i}.weight"] = p["embed_speech"][i - 1]
    for l in range(cfg.num_hidden_layers):
        src, dst = f"layers.{l}.", f"model.language_model.layers.{l}."
        for n, ref in _REF_NORM.items():
            sd[dst + ref + ".weight"] = p[src + n + ".weight"]
        for n, ref in _REF_PROJ.items():
            sd[dst + ref + ".weight"] = p[src + n + ".weight"]
            if cfg.attention_bias and n in ("q_proj", "k_proj", "v_proj",
                                            "o_proj"):
                sd[dst + ref + ".bias"] = p[src + n + ".bias"]
    sd["model.language_model.norm.weight"] = p["final_norm.weight"]
    sd["model.language_model.embed_tokens.weight"] = p["embed_text"]
    if include_tied_heads:
        for i in range(cfg.channels):
            sd[f"lm_heads.{i}.weight"] = sd[f"model.embedding_list.{i}.weight"]
    return sd


def _shard(names, sd: Mapping[str, torch.Tensor], shards: int):
    """Split ``names`` into ``shards`` contiguous groups of about equal
    bytes."""
    sizes = [sd[n].numel() * sd[n].element_size() for n in names]
    total, groups, acc = sum(sizes), [[] for _ in range(shards)], 0
    for n, size in zip(names, sizes):
        groups[min(shards - 1, acc * shards // max(total, 1))].append(n)
        acc += size
    return [g for g in groups if g]


def save_asteroid_checkpoint(params, cfg: LMConfig, out_dir: str,
                             lora: Optional[dict] = None,
                             lora_rank: int = 16, lora_alpha: float = 32.0,
                             lora_rslora: bool = True,
                             include_tied_heads: bool = True,
                             dtype: torch.dtype = torch.float32,
                             shards: int = 1) -> str:
    """Export (optionally LoRA-merged) weights as an HF-format checkpoint
    directory: ``model.safetensors`` + ``config.json`` with the
    reference's AsteroidTTSConfig fields. Returns the safetensors path.

    ``lora``: merge-based factors, {weight name: {"a": (in, r), "b": (r,
    out)}} (``train/lora.init_lora``), folded in first (the reference's
    merge_and_unload). ``dtype``: the floating type written (fp32, as the
    JAX exporter writes; bf16 halves the files). ``shards`` > 1 splits the
    tensors over ``model-0000i-of-0000n.safetensors`` with an HF
    ``model.safetensors.index.json`` (whose path is then returned);
    ``load_asteroid_checkpoint`` reads every ``*.safetensors``."""
    p = params.state_dict() if isinstance(params, torch.nn.Module) \
        else dict(params)
    if lora is not None:
        from ..train.lora import merge_lora
        p = merge_lora(p, lora, rank=lora_rank, alpha=lora_alpha,
                       use_rslora=lora_rslora)
    sd = export_asteroid_state_dict(p, cfg, include_tied_heads)
    os.makedirs(out_dir, exist_ok=True)
    meta = {"format": "pt"}
    if shards <= 1:
        st_path = os.path.join(out_dir, "model.safetensors")
        write_safetensors(st_path, sd, dtype=dtype, metadata=meta)
    else:
        groups = _shard(list(sd), sd, shards)
        weight_map, total = {}, 0
        for i, names in enumerate(groups):
            fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
            total += write_safetensors(os.path.join(out_dir, fname),
                                       {n: sd[n] for n in names},
                                       dtype=dtype, metadata=meta)
            weight_map.update(dict.fromkeys(names, fname))
        st_path = os.path.join(out_dir, "model.safetensors.index.json")
        with open(st_path, "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    config = cfg.to_dict()
    config.update({"architectures": ["AsteroidTTSInstruct"],
                   "model_type": "asteroid_tts"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return st_path


def _read(name: str) -> bool:
    """Whether the loader needs the reference tensor ``name``: not the tied
    heads, not the inner ``embed_tokens``."""
    return not (name.startswith("lm_heads.")
                or name == "model.language_model.embed_tokens.weight")


def load_asteroid_checkpoint(model_dir: str, cfg: LMConfig,
                             dtype: torch.dtype = torch.float32,
                             device="cpu") -> Dict[str, torch.Tensor]:
    """An HF-format checkpoint directory -> the ``AsteroidLM`` state dict
    in ``dtype`` (fp32 by default, as the JAX loader gives) on ``device``.

    Every ``*.safetensors`` in the directory is read, else every
    ``pytorch_model*.bin`` (``torch.load(weights_only=True)``). Safetensors
    are read tensor by tensor, each cast once and moved to ``device`` as it
    is read; the tied heads and the inner ``embed_tokens`` are not read."""
    cfg.refuse_afmoe("the reference (Qwen3-named) checkpoint format")
    sd: dict = {}
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f, dtype=dtype, device=device,
                                       keep=_read))
    else:
        for f in sorted(glob.glob(os.path.join(model_dir,
                                               "pytorch_model*.bin"))):
            part = torch.load(f, map_location="cpu", weights_only=True)
            sd.update({k: v.to(device=device, dtype=dtype)
                       for k, v in part.items() if _read(k)})
            del part
    if not sd:
        raise FileNotFoundError(f"no checkpoint files in {model_dir}")
    return load_reference_lm_state_dict(sd, cfg, dtype=dtype, device=device)
