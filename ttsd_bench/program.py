"""The system under test: ``moss_ttsd_torch``'s ``TTSPipeline`` built from a
configuration file and the run's seed. The only module of the benchmark
that imports the port.

The weights come from ``ttsd_bench/weights.py`` as state dicts on the card
(bf16 LM, float32 codec masters that the codec casts itself); their names
and shapes are read from the port's modules on the meta device and must
equal the reference's lists (the LM's: its architecture's ``lm_spec``,
``arch/<name>.py``), so both sides are handed the same tensors' values.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from . import arch, weights
from .reference.codec import decoder_spec


def lm_config(cfg: dict):
    from moss_ttsd_torch.core.config import LMConfig
    names = {f.name for f in dataclasses.fields(LMConfig)}
    return LMConfig.from_dict({k: v for k, v in cfg.items() if k in names})


def codec_config(cfg: dict):
    from moss_ttsd_torch.core.config import CodecConfig
    return CodecConfig.from_generator_params({
        "input_sample_rate": cfg["codec"]["input_sample_rate"],
        "output_sample_rate": cfg["codec"]["output_sample_rate"],
        **{f"{k}_kwargs": cfg["codec"][k] for k in (
            "feature_extractor", "semantic_encoder",
            "semantic_encoder_adapter", "acoustic_encoder",
            "pre_rvq_adapter", "quantizer", "post_rvq_adapter",
            "acoustic_decoder", "vocos")},
        "downsample_kwargs": {"d_model": cfg["codec"]["downsample_d_model"],
                              "avg_pooler": cfg["codec"]["downsample_factor"]},
        "upsample_kwargs": {"d_model": cfg["codec"]["upsample_d_model"],
                            "stride": cfg["codec"]["upsample_stride"]},
    })


def _spec(module) -> list:
    return sorted((n, tuple(t.shape)) for n, t in module.state_dict().items())


def lm_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    lm_arch = arch.of(cfg)
    module, _, name = lm_arch.port_model.rpartition(".")
    model = getattr(importlib.import_module(module), name)
    with torch.device("meta"):
        spec = _spec(model(lm_config(cfg)))
    if spec != sorted(lm_arch.lm_spec(cfg)):
        raise RuntimeError("the port's LM tensors differ from the "
                           "reference's list (names or shapes)")
    return weights.make(spec, lm_arch.lm_rule, seed, weights.GROUPS["lm"],
                        device, torch.bfloat16)


def codec_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    from moss_ttsd_torch.models.codec.model import XYTokenizerModule
    with torch.device("meta"):
        spec = _spec(XYTokenizerModule(codec_config(cfg)))
    dec = [s for s in spec if weights.is_codec_decoder(s[0])]
    enc = [s for s in spec if not weights.is_codec_decoder(s[0])]
    if dec != sorted(decoder_spec(cfg["codec"])):
        raise RuntimeError("the port's codec decoder tensors differ from the "
                           "reference's list (names or shapes)")
    rule = weights.codec_rule(cfg["codec"]["vocos"]["num_layers"])
    out = weights.make(dec, rule, seed, weights.GROUPS["codec_decoder"],
                       device, torch.float32)
    out.update(weights.make(enc, rule, seed, weights.GROUPS["codec_encoder"],
                            device, torch.float32))
    return out


def sampling(cfg: dict):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    ch = ChannelSamplingConfig(do_sample=cfg["do_sample"],
                               temperature=cfg["temperature"],
                               top_k=cfg["top_k"], top_p=cfg["top_p"],
                               repetition_penalty=cfg["repetition_penalty"])
    return SamplingConfig(channels=[dataclasses.replace(ch)
                                    for _ in range(cfg["channels"])])


def build(cfg: dict, seed: int, bucket: int, device,
          quant: Optional[str] = "config"):
    """The pipeline the configuration states: the mock byte tokenizer, the
    LM (``quant`` from the configuration unless a control overrides it)
    and the codec in ``codec_dtype``."""
    from moss_ttsd_torch.models.codec.model import XYTokenizer
    from moss_ttsd_torch.pipeline.batch import TTSPipeline
    from moss_ttsd_torch.utils.mock_tokenizer import MockTokenizer
    state = lm_weights(cfg, seed, device)
    spt = XYTokenizer(codec_config(cfg), codec_weights(cfg, seed, device),
                      dtype=cfg["codec_dtype"], device=device)
    pipe = TTSPipeline(MockTokenizer(), lm_config(cfg), state, spt,
                       sampling(cfg), bucket=bucket,
                       quant=cfg["quant"] if quant == "config" else quant,
                       device=device)
    del state
    return pipe


def voice_trees(cfg: dict, seed: int, n: int, device) -> Dict[str, dict]:
    """The LoRA voices as the registry takes them: {name: {"voice/<target>/
    kernel": {"a", "b"}}}."""
    out = {}
    for i, v in enumerate(weights.voices(cfg, seed, n, device)):
        out[f"voice{i}"] = {
            f"voice/{t}/kernel": {"a": v[f"{t}.a"], "b": v[f"{t}.b"]}
            for t in arch.of(cfg).lora_targets(cfg)}
    return out
