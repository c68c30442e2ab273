"""Weight carry-over into the port's ``state_dict`` layouts.

  * ``lm_state_from_jax``: the JAX ``AsteroidLM`` param tree (as numpy:
    stacked scan layers, flax ``(in, out)`` Dense kernels, LoRA leaves
    included) -> ``AsteroidLM``;
    a quantized tree (``kernel_q`` / ``kernel_s``, ``embed_*_q`` / ``_s``)
    -> the int8 layout of ``ops/quantize.py``, bytes unchanged.
  * ``lm_state_to_jax``: the inverse, ``AsteroidLM``'s state dict (or a
    part of it, e.g. the LoRA factors alone) -> the JAX tree as numpy, LoRA
    ``lora_a`` / ``lora_b`` leaves included: what the finetune CLI saves
    (``model.npz``, ``model_merged.npz``, ``lora_factors.npz``), so JAX's
    ``load_pytree``, this port's ``load_pytree`` + ``lm_state_from_jax``
    and ``LoraRegistry`` all read it.
  * ``load_reference_lm_state_dict``: the reference checkpoint's names
    (``model.embedding_list.{i}``, ``model.language_model.layers.{l}.*``;
    the layout of ``utils/convert_lm.py``) -> ``AsteroidLM``, cast once to
    the dtype asked for.
  * ``codec_state_from_jax``: the JAX ``XYTokenizerModule`` tree (encode
    and decode sides, every Vocos backbone and head) ->
    ``XYTokenizerModule``; ``utils/convert_codec.py`` makes that tree from
    a reference checkpoint. Flax ``Conv`` kernels are (k, in, out)
    -> torch (out, in, k); flax ``ConvTranspose`` kernels (k, in, out) are a
    correlation without the kernel flip torch's transposed conv applies, so
    they are flipped along k -> torch (in, out, k).
  * ``codec_state_to_jax``: the inverse, ``XYTokenizerModule``'s state dict
    -> {"params": the JAX tree} of numpy arrays (fp32): a trained codec,
    written by ``core/checkpoint.save_pytree``, is the native npz tree that
    both packages' ``load_from_checkpoint`` read.

Arrays are accepted as numpy (or anything ``np.asarray`` takes); the
results are fp32 (int8 for quantized weights) CPU tensors, ready for
``load_state_dict`` (``load_reference_lm_state_dict``: in the dtype and on
the device asked for).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.checkpoint import to_numpy
from ..core.config import CodecConfig, LMConfig

StateDict = Dict[str, torch.Tensor]

_LM_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj",
            "gate_proj", "up_proj", "down_proj")
_LM_NORM = ("input_ln", "q_norm", "k_norm", "post_ln")
_REF_NORM = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
             "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm"}
_REF_PROJ = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}


def _t(x) -> torch.Tensor:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _i8(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int8, copy=True))


def lm_state_from_jax(params_np: Mapping, cfg: LMConfig) -> StateDict:
    """Float or quantized JAX tree -> the port's state dict. Quantized:
    ``kernel_q`` (L, in, out) is transposed to ``weight_q`` (out, in) and
    ``kernel_s`` (L, 1, out) becomes ``weight_s`` (out, 1) per layer. A
    LoRA model's ``lora_a`` / ``lora_b`` leaves come over as they are."""
    p = params_np["params"] if "params" in params_np else params_np
    block = p["layers"]["block"]
    sd: StateDict = {"final_norm.weight": _t(p["final_norm"]["weight"])}
    for name in ("embed_text", "embed_speech"):
        if name + "_q" in p:
            sd[name + "_q"] = _i8(p[name + "_q"])
            sd[name + "_s"] = _t(p[name + "_s"])
        else:
            sd[name] = _t(p[name])
    for l in range(cfg.num_hidden_layers):
        pre = f"layers.{l}."
        for n in _LM_NORM:
            sd[pre + n + ".weight"] = _t(np.asarray(block[n]["weight"])[l])
        for n in _LM_PROJ:
            if "kernel_q" in block[n]:
                sd[pre + n + ".weight_q"] = _i8(
                    np.asarray(block[n]["kernel_q"])[l].T)
                sd[pre + n + ".weight_s"] = _t(
                    np.asarray(block[n]["kernel_s"])[l].T)
            else:
                sd[pre + n + ".weight"] = _t(
                    np.asarray(block[n]["kernel"])[l].T)
            if "bias" in block[n]:
                sd[pre + n + ".bias"] = _t(np.asarray(block[n]["bias"])[l])
            for f in ("lora_a", "lora_b"):
                if f in block[n]:
                    sd[pre + n + "." + f] = _t(np.asarray(block[n][f])[l])
    return sd


_TO_JAX = {"weight": ("kernel", True), "weight_q": ("kernel_q", True),
           "weight_s": ("kernel_s", True), "bias": ("bias", False),
           "lora_a": ("lora_a", False), "lora_b": ("lora_b", False)}


def lm_state_to_jax(sd: Mapping[str, torch.Tensor], cfg: LMConfig) -> dict:
    """The port's state dict (any subset of it) -> {"params": JAX tree} of
    numpy arrays: the layers stacked (L, ...) under ``layers/block``,
    projection weights (out, in) transposed to flax (in, out) kernels
    (int8 ``weight_q`` / ``weight_s`` to ``kernel_q`` / ``kernel_s``),
    norms as ``weight``, LoRA factors as they are. bf16 goes out as fp32."""
    p: dict = {}
    per_layer: Dict[tuple, dict] = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[0] != "layers":
            if name == "final_norm.weight":
                p.setdefault("final_norm", {})["weight"] = to_numpy(t)
            else:
                p[name] = to_numpy(t)
            continue
        l, mod, leaf = int(parts[1]), parts[2], parts[3]
        if mod in _LM_NORM:
            key, transpose = "weight", False
        else:
            key, transpose = _TO_JAX[leaf]
        a = to_numpy(t)
        per_layer.setdefault((mod, key), {})[l] = a.T if transpose else a
    block: dict = {}
    for (mod, key), layers in per_layer.items():
        if sorted(layers) != list(range(cfg.num_hidden_layers)):
            raise ValueError(f"{mod}.{key}: layers {sorted(layers)} of "
                             f"{cfg.num_hidden_layers}")
        block.setdefault(mod, {})[key] = np.stack(
            [layers[l] for l in range(cfg.num_hidden_layers)])
    if block:
        p["layers"] = {"block": block}
    return {"params": p}


def _as(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor or array -> ``dtype`` on ``device``, cast once (the tensor
    itself when it is already there)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype)


def load_reference_lm_state_dict(sd: Mapping, cfg: LMConfig,
                                 dtype: torch.dtype = torch.float32,
                                 device="cpu") -> StateDict:
    """Reference-format names (torch (out, in) weights) -> ``AsteroidLM``
    state dict in ``dtype`` on ``device``, each tensor cast once. The tied
    ``lm_heads.*`` and the unused inner ``embed_tokens`` are ignored."""
    def get(name):
        return _as(sd[name], dtype, device)

    out: StateDict = {
        "embed_text": get("model.embedding_list.0.weight"),
        "embed_speech": torch.stack(
            [get(f"model.embedding_list.{i}.weight")
             for i in range(1, cfg.channels)]),
        "final_norm.weight": get("model.language_model.norm.weight")}
    for l in range(cfg.num_hidden_layers):
        src, dst = f"model.language_model.layers.{l}.", f"layers.{l}."
        for n, ref in _REF_NORM.items():
            out[dst + n + ".weight"] = get(src + ref + ".weight")
        for n, ref in _REF_PROJ.items():
            out[dst + n + ".weight"] = get(src + ref + ".weight")
            if cfg.attention_bias and n in ("q_proj", "k_proj", "v_proj",
                                            "o_proj"):
                out[dst + n + ".bias"] = get(src + ref + ".bias")
    return out


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def _dense(sd: StateDict, pre: str, tree: Mapping, idx=None) -> None:
    k = np.asarray(tree["kernel"])
    sd[pre + ".weight"] = _t((k if idx is None else k[idx]).T)
    if "bias" in tree:
        b = np.asarray(tree["bias"])
        sd[pre + ".bias"] = _t(b if idx is None else b[idx])


def _ln(sd: StateDict, pre: str, tree: Mapping, idx=None) -> None:
    for src, dst in (("scale", "weight"), ("bias", "bias")):
        a = np.asarray(tree[src])
        sd[f"{pre}.{dst}"] = _t(a if idx is None else a[idx])


def _conv(sd: StateDict, pre: str, tree: Mapping, idx=None) -> None:
    """flax Conv (k, in/groups, out) -> torch Conv1d (out, in/groups, k)."""
    k = np.asarray(tree["kernel"])
    k = k if idx is None else k[idx]
    sd[pre + ".weight"] = _t(np.transpose(k, (2, 1, 0)))
    if "bias" in tree:
        b = np.asarray(tree["bias"])
        sd[pre + ".bias"] = _t(b if idx is None else b[idx])


def _deconv(sd: StateDict, pre: str, tree: Mapping) -> None:
    """flax ConvTranspose (k, in, out), unflipped -> torch ConvTranspose1d
    (in, out, k), flipped along k."""
    k = np.asarray(tree["kernel"])[::-1]
    sd[pre + ".weight"] = _t(np.transpose(k, (1, 2, 0)))
    if "bias" in tree:
        sd[pre + ".bias"] = _t(tree["bias"])


def _stack(sd: StateDict, pre: str, tree: Mapping, num_layers: int) -> None:
    """Scanned ``layers/layer`` stack + ``final_ln`` of a codec transformer."""
    lay = tree["layers"]["layer"]
    for i in range(num_layers):
        p = f"{pre}.layers.{i}"
        _ln(sd, p + ".attn_ln", lay["attn_ln"], i)
        _ln(sd, p + ".ffn_ln", lay["ffn_ln"], i)
        for n in ("q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b"):
            sd[f"{p}.attn.{n}"] = _t(np.asarray(lay["attn"][n])[i])
        _dense(sd, p + ".fc1", lay["fc1"], i)
        _dense(sd, p + ".fc2", lay["fc2"], i)
    _ln(sd, pre + ".final_ln", tree["final_ln"])


def _adapter(sd: StateDict, pre: str, tree: Mapping, num_layers: int) -> None:
    """An ``AdapterTransformer``: its stack and optional in/out projections."""
    _stack(sd, pre, tree, num_layers)
    for n in ("in_proj", "out_proj"):
        if n in tree:
            _dense(sd, f"{pre}.{n}", tree[n])


def codec_state_from_jax(params_np: Mapping, cfg: CodecConfig) -> StateDict:
    p = params_np["params"] if "params" in params_np else params_np
    sd: StateDict = {}
    for name in ("semantic_encoder", "acoustic_encoder"):
        e = p[name]
        _conv(sd, name + ".conv1", e["conv1"])
        _conv(sd, name + ".conv2", e["conv2"])
        _stack(sd, name, e, getattr(cfg, name).encoder_layers)
    for name in ("semantic_encoder_adapter", "pre_rvq_adapter"):
        _adapter(sd, name, p[name], getattr(cfg, name).encoder_layers)
    ds = p["downsample"]
    _conv(sd, "downsample.gate_proj", ds["gate_proj"])
    _conv(sd, "downsample.up_proj", ds["up_proj"])
    _dense(sd, "downsample.down_proj", ds["down_proj"])
    _ln(sd, "downsample.ln", ds["ln"])

    q = p["quantizer"]
    sd["quantizer.codebook"] = _t(q["codebook"])
    for n in ("input_proj", "output_proj"):
        if n in q:
            _dense(sd, f"quantizer.{n}", q[n])

    _adapter(sd, "post_rvq_adapter", p["post_rvq_adapter"],
             cfg.post_rvq_adapter.encoder_layers)
    _deconv(sd, "upsample.up_conv", p["upsample"]["up_conv"])

    d = p["acoustic_decoder"]
    _stack(sd, "acoustic_decoder", d, cfg.acoustic_decoder.decoder_layers)
    _deconv(sd, "acoustic_decoder.deconv1", d["deconv1"])
    _deconv(sd, "acoustic_decoder.deconv2", d["deconv2"])

    _vocos(sd, p["vocos"], cfg.vocos)
    return sd


def _norm(sd: StateDict, pre: str, tree: Mapping, idx=None) -> None:
    """A LayerNorm, or an AdaLayerNorm's ``scale`` / ``shift`` tables."""
    if "shift" not in tree:
        _ln(sd, pre, tree, idx)
        return
    for n in ("scale", "shift"):
        a = np.asarray(tree[n])
        sd[f"{pre}.{n}"] = _t(a if idx is None else a[idx])


def _vocos(sd: StateDict, tree: Mapping, vc) -> None:
    """The Vocos backbone ``vc`` names (ConvNeXt, its norms plain or
    adaptive, or ResNet, whose folded convs and (dim,) gammas come as they
    are) and the head's linear ``out``."""
    bb = tree["backbone"]
    _conv(sd, "vocos.backbone.embed", bb["embed"])
    if vc.backbone == "resnet":
        for i in range(vc.num_blocks):
            blk, pre = bb[f"resblock_{i}"], f"vocos.backbone.resnet.{i}"
            for j in range(3):
                _conv(sd, f"{pre}.convs1.{j}", blk[f"conv1_{j}"])
                _conv(sd, f"{pre}.convs2.{j}", blk[f"conv2_{j}"])
                sd[f"{pre}.gamma.{j}"] = _t(blk[f"gamma_{j}"])
    else:
        _norm(sd, "vocos.backbone.norm", bb["norm"])
        _ln(sd, "vocos.backbone.final_ln", bb["final_ln"])
        blk = bb["blocks"]["block"]
        for i in range(vc.num_layers):
            pre = f"vocos.backbone.blocks.{i}"
            _conv(sd, pre + ".dwconv", blk["dwconv"], i)
            _norm(sd, pre + ".norm", blk["norm"], i)
            _dense(sd, pre + ".pwconv1", blk["pwconv1"], i)
            _dense(sd, pre + ".pwconv2", blk["pwconv2"], i)
            sd[pre + ".gamma"] = _t(np.asarray(blk["gamma"])[i])
    _dense(sd, "vocos.head.out", tree["head"]["out"])


# -- the codec, back to the JAX tree ------------------------------------------

def _np(sd: Mapping, name: str) -> np.ndarray:
    return np.asarray(to_numpy(sd[name]), dtype=np.float32)


def _dense_out(sd: Mapping, pre: str) -> dict:
    out = {"kernel": _np(sd, pre + ".weight").T}
    if pre + ".bias" in sd:
        out["bias"] = _np(sd, pre + ".bias")
    return out


def _ln_out(sd: Mapping, pre: str) -> dict:
    return {"scale": _np(sd, pre + ".weight"), "bias": _np(sd, pre + ".bias")}


def _conv_out(sd: Mapping, pre: str) -> dict:
    """torch Conv1d (out, in/groups, k) -> flax Conv (k, in/groups, out)."""
    out = {"kernel": np.transpose(_np(sd, pre + ".weight"), (2, 1, 0))}
    if pre + ".bias" in sd:
        out["bias"] = _np(sd, pre + ".bias")
    return out


def _deconv_out(sd: Mapping, pre: str) -> dict:
    """torch ConvTranspose1d (in, out, k) -> flax ConvTranspose (k, in,
    out), unflipped."""
    k = np.transpose(_np(sd, pre + ".weight"), (2, 0, 1))[::-1]
    out = {"kernel": np.ascontiguousarray(k)}
    if pre + ".bias" in sd:
        out["bias"] = _np(sd, pre + ".bias")
    return out


def _stacked(per_layer) -> dict:
    """A list of per-layer trees -> one tree of (L, ...) leaves."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in per_layer]) for k in first}
    return np.stack(per_layer)


def _stack_out(sd: Mapping, pre: str, num_layers: int) -> dict:
    layers = []
    for i in range(num_layers):
        p = f"{pre}.layers.{i}"
        layers.append({
            "attn_ln": _ln_out(sd, p + ".attn_ln"),
            "ffn_ln": _ln_out(sd, p + ".ffn_ln"),
            "attn": {n: _np(sd, f"{p}.attn.{n}") for n in (
                "q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b")},
            "fc1": _dense_out(sd, p + ".fc1"),
            "fc2": _dense_out(sd, p + ".fc2")})
    return {"layers": {"layer": _stacked(layers)},
            "final_ln": _ln_out(sd, pre + ".final_ln")}


def _adapter_out(sd: Mapping, pre: str, num_layers: int) -> dict:
    tree = _stack_out(sd, pre, num_layers)
    for n in ("in_proj", "out_proj"):
        if f"{pre}.{n}.weight" in sd:
            tree[n] = _dense_out(sd, f"{pre}.{n}")
    return tree


def _norm_out(sd: Mapping, pre: str) -> dict:
    if pre + ".shift" in sd:
        return {n: _np(sd, f"{pre}.{n}") for n in ("scale", "shift")}
    return _ln_out(sd, pre)


def _vocos_out(sd: Mapping, vc) -> dict:
    bb = {"embed": _conv_out(sd, "vocos.backbone.embed")}
    if vc.backbone == "resnet":
        for i in range(vc.num_blocks):
            pre, blk = f"vocos.backbone.resnet.{i}", {}
            for j in range(3):
                blk[f"conv1_{j}"] = _conv_out(sd, f"{pre}.convs1.{j}")
                blk[f"conv2_{j}"] = _conv_out(sd, f"{pre}.convs2.{j}")
                blk[f"gamma_{j}"] = _np(sd, f"{pre}.gamma.{j}")
            bb[f"resblock_{i}"] = blk
    else:
        bb["norm"] = _norm_out(sd, "vocos.backbone.norm")
        bb["final_ln"] = _ln_out(sd, "vocos.backbone.final_ln")
        blocks = []
        for i in range(vc.num_layers):
            pre = f"vocos.backbone.blocks.{i}"
            blocks.append({"dwconv": _conv_out(sd, pre + ".dwconv"),
                           "norm": _norm_out(sd, pre + ".norm"),
                           "pwconv1": _dense_out(sd, pre + ".pwconv1"),
                           "pwconv2": _dense_out(sd, pre + ".pwconv2"),
                           "gamma": _np(sd, pre + ".gamma")})
        bb["blocks"] = {"block": _stacked(blocks)}
    return {"backbone": bb, "head": {"out": _dense_out(sd, "vocos.head.out")}}


def codec_state_to_jax(sd: Mapping[str, torch.Tensor],
                       cfg: CodecConfig) -> dict:
    """``XYTokenizerModule``'s state dict -> {"params": JAX tree} of fp32
    numpy arrays, the inverse of ``codec_state_from_jax``."""
    p: dict = {}
    for name in ("semantic_encoder", "acoustic_encoder"):
        e = _stack_out(sd, name, getattr(cfg, name).encoder_layers)
        e["conv1"] = _conv_out(sd, name + ".conv1")
        e["conv2"] = _conv_out(sd, name + ".conv2")
        p[name] = e
    for name in ("semantic_encoder_adapter", "pre_rvq_adapter"):
        p[name] = _adapter_out(sd, name, getattr(cfg, name).encoder_layers)
    p["downsample"] = {"gate_proj": _conv_out(sd, "downsample.gate_proj"),
                       "up_proj": _conv_out(sd, "downsample.up_proj"),
                       "down_proj": _dense_out(sd, "downsample.down_proj"),
                       "ln": _ln_out(sd, "downsample.ln")}
    q = {"codebook": _np(sd, "quantizer.codebook")}
    for n in ("input_proj", "output_proj"):
        if f"quantizer.{n}.weight" in sd:
            q[n] = _dense_out(sd, f"quantizer.{n}")
    p["quantizer"] = q
    p["post_rvq_adapter"] = _adapter_out(sd, "post_rvq_adapter",
                                         cfg.post_rvq_adapter.encoder_layers)
    p["upsample"] = {"up_conv": _deconv_out(sd, "upsample.up_conv")}
    d = _stack_out(sd, "acoustic_decoder", cfg.acoustic_decoder.decoder_layers)
    d["deconv1"] = _deconv_out(sd, "acoustic_decoder.deconv1")
    d["deconv2"] = _deconv_out(sd, "acoustic_decoder.deconv2")
    p["acoustic_decoder"] = d
    p["vocos"] = _vocos_out(sd, cfg.vocos)
    return {"params": p}
