"""XY-Tokenizer reference checkpoints -> the port's codec, a numpy copy of
``moss_ttsd_tpu/utils/convert_codec.py``.

The reference state dict (XY_Tokenizer/xy_tokenizer/model.py wiring,
nn/modules.py + nn/quantizer.py parameters) is converted to the JAX
package's param tree (numpy), which ``utils/convert_jax.codec_state_from_jax``
turns into the port's state dict: one name map, shared with the JAX
weights the tests carry over. On the way:
  * torch Conv1d (out, in, k) -> flax Conv kernel (k, in, out);
  * torch ConvTranspose1d (in, out, k) -> flax ConvTranspose kernel
    (k, in, out), flipped along k (flax's transposed conv is a
    correlation);
  * weight norm folded, W = g v / ||v|| (the legacy ``weight_g`` /
    ``weight_v`` and the ``parametrizations.weight.original0/1`` keys);
  * the attention projections (k has no bias) -> ``q_w`` / ``k_w`` / ...;
  * the per-layer transformer and ConvNeXt stacks -> one (L, ...) tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.config import CodecConfig, VocosConfig


def _np(t):
    return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach")
                      else t, np.float32)


class _SD:
    def __init__(self, sd: Dict):
        self.sd = sd

    def __contains__(self, k):
        return k in self.sd

    def get(self, k):
        return _np(self.sd[k])

    def folded_wn(self, prefix: str):
        """Fold a weight-normed conv weight; returns (out, in, k) array."""
        if f"{prefix}.weight_v" in self.sd:
            v = self.get(f"{prefix}.weight_v")
            g = self.get(f"{prefix}.weight_g")
        elif f"{prefix}.parametrizations.weight.original1" in self.sd:
            v = self.get(f"{prefix}.parametrizations.weight.original1")
            g = self.get(f"{prefix}.parametrizations.weight.original0")
        else:
            return self.get(f"{prefix}.weight")
        norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
        return g * v / np.maximum(norm, 1e-12)


def conv_kernel(w):
    """torch Conv1d (out,in,k) -> flax (k,in,out)."""
    return np.transpose(w, (2, 1, 0))


def deconv_kernel(w):
    """torch ConvTranspose1d (in,out,k) -> flax ConvTranspose (k,in,out),
    the spatial axis flipped (torch's transposed conv is the gradient of a
    conv; flax's is a fractionally strided correlation)."""
    return np.transpose(w, (2, 0, 1))[::-1].copy()


def dense(sd: _SD, prefix: str, bias: bool = True):
    out = {"kernel": sd.get(f"{prefix}.weight").T}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd.get(f"{prefix}.bias")
    return out


def wn_dense(sd: _SD, prefix: str):
    """WNConv1d(k=1) folded into a Dense: (out,in,1) -> kernel (in,out)."""
    w = sd.folded_wn(prefix)[:, :, 0]
    out = {"kernel": w.T}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd.get(f"{prefix}.bias")
    return out


def layer_norm(sd: _SD, prefix: str):
    return {"scale": sd.get(f"{prefix}.weight"), "bias": sd.get(f"{prefix}.bias")}


def _attention(sd: _SD, prefix: str):
    return {
        "q_w": sd.get(f"{prefix}.q_proj.weight").T,
        "q_b": sd.get(f"{prefix}.q_proj.bias"),
        "k_w": sd.get(f"{prefix}.k_proj.weight").T,
        "v_w": sd.get(f"{prefix}.v_proj.weight").T,
        "v_b": sd.get(f"{prefix}.v_proj.bias"),
        "o_w": sd.get(f"{prefix}.out_proj.weight").T,
        "o_b": sd.get(f"{prefix}.out_proj.bias"),
    }


def _transformer_layer(sd: _SD, prefix: str):
    return {
        "attn_ln": layer_norm(sd, f"{prefix}.self_attn_layer_norm"),
        "attn": _attention(sd, f"{prefix}.self_attn"),
        "ffn_ln": layer_norm(sd, f"{prefix}.final_layer_norm"),
        "fc1": dense(sd, f"{prefix}.fc1"),
        "fc2": dense(sd, f"{prefix}.fc2"),
    }


def _stack_trees(per_layer):
    """Stack identical per-layer trees (nested dicts of arrays) into one
    (L, ...) tree: the layout of the scanned stacks."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in per_layer]) for k in first}
    return np.stack([np.asarray(t) for t in per_layer])


def restack_legacy_pytree(tree):
    """Upgrade a pre-scan native codec tree to the scanned layout: per-layer
    subtrees ``layer_0..layer_{N-1}`` / ``block_0..block_{N-1}`` become one
    stacked (L, ...) tree under ``layers/layer`` / ``blocks/block``,
    anywhere in the tree. New-format trees pass through unchanged (the
    upgrade needs a contiguous indexed run and no existing group)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: restack_legacy_pytree(v) for k, v in tree.items()}
    for prefix, group, inner in (("layer_", "layers", "layer"),
                                 ("block_", "blocks", "block")):
        idx = sorted(int(k[len(prefix):]) for k in out
                     if k.startswith(prefix) and k[len(prefix):].isdigit())
        if idx and idx == list(range(len(idx))) and group not in out:
            per = [out.pop(f"{prefix}{i}") for i in idx]
            out[group] = {inner: _stack_trees(per)}
    return out


def _transformer_layers(sd: _SD, prefix: str, num_layers: int):
    """Reference per-layer ``layers.{i}.*`` -> the stacked ``layer`` tree."""
    return {"layer": _stack_trees(
        [_transformer_layer(sd, f"{prefix}.layers.{i}")
         for i in range(num_layers)])}


def _audio_encoder(sd: _SD, prefix: str, num_layers: int):
    return {
        "conv1": {"kernel": conv_kernel(sd.get(f"{prefix}.conv1.weight")),
                  "bias": sd.get(f"{prefix}.conv1.bias")},
        "conv2": {"kernel": conv_kernel(sd.get(f"{prefix}.conv2.weight")),
                  "bias": sd.get(f"{prefix}.conv2.bias")},
        "final_ln": layer_norm(sd, f"{prefix}.layer_norm"),
        "layers": _transformer_layers(sd, prefix, num_layers),
    }


def _audio_decoder(sd: _SD, prefix: str, num_layers: int):
    return {
        "deconv1": {"kernel": deconv_kernel(sd.get(f"{prefix}.deconv1.weight")),
                    "bias": sd.get(f"{prefix}.deconv1.bias")},
        "deconv2": {"kernel": deconv_kernel(sd.get(f"{prefix}.deconv2.weight")),
                    "bias": sd.get(f"{prefix}.deconv2.bias")},
        "final_ln": layer_norm(sd, f"{prefix}.layer_norm"),
        "layers": _transformer_layers(sd, prefix, num_layers),
    }


def _adapter(sd: _SD, prefix: str, num_layers: int):
    out = {"final_ln": layer_norm(sd, f"{prefix}.layer_norm"),
           "layers": _transformer_layers(sd, prefix, num_layers)}
    if f"{prefix}.proj.weight" in sd:
        out["in_proj"] = dense(sd, f"{prefix}.proj")
    if f"{prefix}.out_proj.weight" in sd:
        out["out_proj"] = dense(sd, f"{prefix}.out_proj")
    return out


def _ada_layer_norm(sd: _SD, prefix: str):
    """Reference AdaLayerNorm (modules.py:1157-1184): the per-class scale
    and shift embedding tables."""
    return {"scale": sd.get(f"{prefix}.scale.weight"),
            "shift": sd.get(f"{prefix}.shift.weight")}


def _norm(sd: _SD, prefix: str, adanorm: bool):
    return _ada_layer_norm(sd, prefix) if adanorm else layer_norm(sd, prefix)


def _convnext_backbone(sd: _SD, prefix: str, num_layers: int,
                       adanorm: bool = False):
    def block(i):
        p = f"{prefix}.convnext.{i}"
        return {
            "dwconv": {"kernel": conv_kernel(sd.get(f"{p}.dwconv.weight")),
                       "bias": sd.get(f"{p}.dwconv.bias")},
            "norm": _norm(sd, f"{p}.norm", adanorm),
            "pwconv1": dense(sd, f"{p}.pwconv1"),
            "pwconv2": dense(sd, f"{p}.pwconv2"),
            "gamma": sd.get(f"{p}.gamma"),
        }

    return {
        "embed": {"kernel": conv_kernel(sd.get(f"{prefix}.embed.weight")),
                  "bias": sd.get(f"{prefix}.embed.bias")},
        "norm": _norm(sd, f"{prefix}.norm", adanorm),
        "final_ln": layer_norm(sd, f"{prefix}.final_layer_norm"),
        "blocks": {"block": _stack_trees([block(i)
                                          for i in range(num_layers)])},
    }


def _resnet_backbone(sd: _SD, prefix: str, num_blocks: int):
    """Reference VocosResNetBackbone (modules.py:1413-1449): the
    weight-normed embed conv and ResBlock1 stack, weight norms folded and
    the (dim, 1) gammas squeezed to (dim,)."""
    backbone = {
        "embed": {"kernel": conv_kernel(sd.folded_wn(f"{prefix}.embed")),
                  "bias": sd.get(f"{prefix}.embed.bias")},
    }
    for i in range(num_blocks):
        p = f"{prefix}.resnet.{i}"
        blk = {}
        for j in range(3):
            blk[f"conv1_{j}"] = {
                "kernel": conv_kernel(sd.folded_wn(f"{p}.convs1.{j}")),
                "bias": sd.get(f"{p}.convs1.{j}.bias")}
            blk[f"conv2_{j}"] = {
                "kernel": conv_kernel(sd.folded_wn(f"{p}.convs2.{j}")),
                "bias": sd.get(f"{p}.convs2.{j}.bias")}
            if f"{p}.gamma.{j}" in sd:
                blk[f"gamma_{j}"] = sd.get(f"{p}.gamma.{j}")[:, 0]
        backbone[f"resblock_{i}"] = blk
    return backbone


def _vocos(sd: _SD, prefix: str, cfg: VocosConfig):
    """The Vocos generator family: the backbone ``cfg`` names and the head's
    one linear ``out`` (every reference head has one)."""
    adanorm = cfg.adanorm_num_embeddings is not None
    if cfg.backbone == "convnext":
        backbone = _convnext_backbone(sd, f"{prefix}.backbone",
                                      cfg.num_layers, adanorm)
    elif cfg.backbone == "resnet":
        backbone = _resnet_backbone(sd, f"{prefix}.backbone", cfg.num_blocks)
    else:
        raise ValueError(f"unknown backbone {cfg.backbone!r}")
    return {"backbone": backbone, "head": {"out": dense(sd, f"{prefix}.head.out")}}


def convert_codec_state_dict(sd_raw: Dict, cfg: CodecConfig) -> dict:
    """A reference state dict -> {"params": the JAX codec tree (numpy)}."""
    sd = _SD(sd_raw)
    q = cfg.quantizer
    codebooks = np.stack([sd.get(f"quantizer.quantizers.{i}.codebook")
                          for i in range(q.num_quantizers)])
    quantizer = {"codebook": codebooks}
    if q.input_dim != q.rvq_dim:
        quantizer["input_proj"] = wn_dense(sd, "quantizer.input_proj")
    if q.rvq_dim != q.output_dim:
        quantizer["output_proj"] = wn_dense(sd, "quantizer.output_proj")

    params = {
        "semantic_encoder": _audio_encoder(
            sd, "semantic_encoder", cfg.semantic_encoder.encoder_layers),
        "semantic_encoder_adapter": _adapter(
            sd, "semantic_encoder_adapter",
            cfg.semantic_encoder_adapter.encoder_layers),
        "acoustic_encoder": _audio_encoder(
            sd, "acoustic_encoder", cfg.acoustic_encoder.encoder_layers),
        "pre_rvq_adapter": _adapter(
            sd, "pre_rvq_adapter", cfg.pre_rvq_adapter.encoder_layers),
        "downsample": {
            "gate_proj": {"kernel": conv_kernel(sd.get("downsample.gate_proj.weight"))},
            "up_proj": {"kernel": conv_kernel(sd.get("downsample.up_proj.weight"))},
            "down_proj": {"kernel": sd.get("downsample.down_proj.weight").T},
            "ln": layer_norm(sd, "downsample.layer_norm"),
        },
        "quantizer": quantizer,
        "post_rvq_adapter": _adapter(
            sd, "post_rvq_adapter", cfg.post_rvq_adapter.encoder_layers),
        "upsample": {
            "up_conv": {"kernel": deconv_kernel(sd.get("upsample.up_conv.weight"))},
        },
        "acoustic_decoder": _audio_decoder(
            sd, "acoustic_decoder", cfg.acoustic_decoder.decoder_layers),
        "vocos": _vocos(sd, "enhanced_vocos", cfg.vocos),
    }
    return {"params": params}


def convert_codec_checkpoint(cfg: CodecConfig, ckpt_path: str) -> dict:
    """A reference ``.ckpt`` / ``.pt`` / ``.bin`` (the generator's state
    dict, or a training checkpoint holding it under ``"generator"``) ->
    {"params": the JAX codec tree (numpy)}."""
    import torch
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "generator" in ckpt:       # reference model.py:274-277
        ckpt = ckpt["generator"]
    return convert_codec_state_dict(ckpt, cfg)
