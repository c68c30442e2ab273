"""The reference XY-Tokenizer codec's files, written for a ``CodecConfig``:
its yaml (``generator_params`` under the reference's ``*_kwargs`` names)
and a ``.ckpt`` of random weights under the reference generator's
parameter names and torch layouts (weight-norm entries included).

The port has no codec exporter, as the JAX package has none; the CPU and
GPU tests and ``chip_smoke.py``'s ``load`` phase share this writer. It
imports torch and nothing of JAX."""
import dataclasses
import os

import torch


def codec_generator_params(cfg) -> dict:
    """A ``CodecConfig`` laid out as the reference yaml's
    ``generator_params`` (its ``*_kwargs`` names)."""
    def enc(c, layers_key):
        d = dataclasses.asdict(c)
        return {k: d[k] for k in (
            "num_mel_bins", "sampling_rate", "hop_length", "stride_size",
            "kernel_size", "d_model", "scale_embedding", "max_audio_seconds",
            f"{layers_key}_layers", f"{layers_key}_attention_heads",
            f"{layers_key}_ffn_dim", "activation_function")}

    def adapter(c):
        d = dataclasses.asdict(c)
        return {k: d[k] for k in (
            "input_dim", "output_dim", "d_model", "max_source_positions",
            "encoder_layers", "encoder_attention_heads", "encoder_ffn_dim")}

    q, fe = cfg.quantizer, cfg.feature_extractor
    return {
        "input_sample_rate": cfg.input_sample_rate,
        "output_sample_rate": cfg.output_sample_rate,
        "feature_extractor_kwargs": {
            "chunk_length": fe.chunk_length, "feature_size": fe.feature_size,
            "hop_length": fe.hop_length, "n_fft": fe.n_fft,
            "n_samples": fe.n_samples, "nb_max_frames": fe.nb_max_frames,
            "padding_side": "right", "padding_value": fe.padding_value,
            "return_attention_mask": False,
            "sampling_rate": fe.sampling_rate},
        "semantic_encoder_kwargs": enc(cfg.semantic_encoder, "encoder"),
        "semantic_encoder_adapter_kwargs": adapter(
            cfg.semantic_encoder_adapter),
        "acoustic_encoder_kwargs": enc(cfg.acoustic_encoder, "encoder"),
        "pre_rvq_adapter_kwargs": adapter(cfg.pre_rvq_adapter),
        "downsample_kwargs": {"d_model": cfg.downsample_d_model,
                              "avg_pooler": cfg.downsample_factor},
        "quantizer_kwargs": {
            "input_dim": q.input_dim, "rvq_dim": q.rvq_dim,
            "output_dim": q.output_dim, "num_quantizers": q.num_quantizers,
            "codebook_size": q.codebook_size,
            "codebook_dim": q.codebook_dim, "quantizer_dropout": 0.0,
            "commitment": 1, "kmeans_init": False, "skip_rvq_ratio": 0.0},
        "post_rvq_adapter_kwargs": adapter(cfg.post_rvq_adapter),
        "upsample_kwargs": {"d_model": cfg.upsample_d_model,
                            "stride": cfg.upsample_stride},
        "acoustic_decoder_kwargs": enc(cfg.acoustic_decoder, "decoder"),
        "vocos_kwargs": dataclasses.asdict(cfg.vocos),
    }


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, float):
        text = repr(v)
        mant, e, exp = text.partition("e")
        if "." not in mant and mant not in ("inf", "-inf", "nan"):
            mant += ".0"               # YAML 1.1 reads a float by its dot
        return mant + (e + (exp if exp[0] in "+-" else "+" + exp)
                       if e else "")
    return str(v)


def yaml_text(tree: dict, indent: int = 0) -> str:
    """Nested mappings of scalars as block YAML."""
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines.append(f"{' ' * indent}{k}:")
            lines.append(yaml_text(v, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{' ' * indent}{k}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def reference_codec_state_dict(cfg, seed: int = 0) -> dict:
    """Random weights for ``cfg`` under the reference XY_Tokenizer
    generator's parameter names and torch layouts: Conv1d (out, in, k),
    ConvTranspose1d (in, out, k), the quantizer's weight-normed
    projections (legacy ``weight_g`` / ``weight_v`` on the input one,
    ``parametrizations.weight.original0/1`` on the output one, and on the
    ResNet backbone's convs), the Vocos backbone and head ``cfg.vocos``
    names. Matrices N(0, 1/fan_in), norms 1 + N(0, 0.1), biases
    N(0, 0.02), codebooks N(0, 1), layer scales 1/N + N(0, 0.01): small
    enough that the wav stays finite, random enough that codes depend on
    the input."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rnd(*shape, std):
        return torch.randn(*shape, generator=g) * std

    def linear(p, i, o, bias=True):
        sd[p + ".weight"] = rnd(o, i, std=i ** -0.5)
        if bias:
            sd[p + ".bias"] = rnd(o, std=0.02)

    def conv(p, i, o, k, bias=True, groups=1):
        sd[p + ".weight"] = rnd(o, i // groups, k, std=(i // groups * k) ** -0.5)
        if bias:
            sd[p + ".bias"] = rnd(o, std=0.02)

    def deconv(p, i, o, k, bias=True):
        sd[p + ".weight"] = rnd(i, o, k, std=(i * k) ** -0.5)
        if bias:
            sd[p + ".bias"] = rnd(o, std=0.02)

    def wn_conv(p, i, o, k, legacy):
        v = rnd(o, i, k, std=(i * k) ** -0.5)
        gain = v.flatten(1).norm(dim=1)[:, None, None] * (1 + rnd(o, 1, 1,
                                                                  std=0.1))
        names = (("weight_g", "weight_v") if legacy else
                 ("parametrizations.weight.original0",
                  "parametrizations.weight.original1"))
        sd[f"{p}.{names[0]}"], sd[f"{p}.{names[1]}"] = gain, v
        sd[p + ".bias"] = rnd(o, std=0.02)

    def ln(p, d):
        sd[p + ".weight"] = 1 + rnd(d, std=0.1)
        sd[p + ".bias"] = rnd(d, std=0.02)

    def layer(p, d, ffn):
        for n, bias in (("q_proj", True), ("k_proj", False),
                        ("v_proj", True), ("out_proj", True)):
            linear(f"{p}.self_attn.{n}", d, d, bias)
        ln(f"{p}.self_attn_layer_norm", d)
        ln(f"{p}.final_layer_norm", d)
        linear(f"{p}.fc1", d, ffn)
        linear(f"{p}.fc2", ffn, d)

    def encoder(p, c):
        conv(f"{p}.conv1", c.num_mel_bins, c.d_model, 3)
        conv(f"{p}.conv2", c.d_model, c.d_model, 3)
        ln(f"{p}.layer_norm", c.d_model)
        for i in range(c.encoder_layers):
            layer(f"{p}.layers.{i}", c.d_model, c.encoder_ffn_dim)

    def adapter(p, c):
        if c.input_dim != c.d_model:
            linear(f"{p}.proj", c.input_dim, c.d_model)
        if c.output_dim != c.d_model:
            linear(f"{p}.out_proj", c.d_model, c.output_dim)
        ln(f"{p}.layer_norm", c.d_model)
        for i in range(c.encoder_layers):
            layer(f"{p}.layers.{i}", c.d_model, c.encoder_ffn_dim)

    encoder("semantic_encoder", cfg.semantic_encoder)
    adapter("semantic_encoder_adapter", cfg.semantic_encoder_adapter)
    encoder("acoustic_encoder", cfg.acoustic_encoder)
    adapter("pre_rvq_adapter", cfg.pre_rvq_adapter)
    d, r = cfg.downsample_d_model, cfg.downsample_factor
    conv("downsample.gate_proj", d, d * r, r, bias=False)
    conv("downsample.up_proj", d, d * r, r, bias=False)
    linear("downsample.down_proj", d * r, d * r, bias=False)
    ln("downsample.layer_norm", d * r)
    q = cfg.quantizer
    for i in range(q.num_quantizers):
        sd[f"quantizer.quantizers.{i}.codebook"] = rnd(
            q.codebook_size, q.codebook_dim, std=1.0)
    if q.input_dim != q.rvq_dim:
        wn_conv("quantizer.input_proj", q.input_dim, q.rvq_dim, 1, True)
    if q.rvq_dim != q.output_dim:
        wn_conv("quantizer.output_proj", q.rvq_dim, q.output_dim, 1, False)
    adapter("post_rvq_adapter", cfg.post_rvq_adapter)
    deconv("upsample.up_conv", cfg.upsample_d_model * cfg.upsample_stride,
           cfg.upsample_d_model, cfg.upsample_stride, bias=False)
    dec = cfg.acoustic_decoder
    deconv("acoustic_decoder.deconv1", dec.d_model, dec.d_model, 3)
    deconv("acoustic_decoder.deconv2", dec.d_model, dec.num_mel_bins, 3)
    ln("acoustic_decoder.layer_norm", dec.d_model)
    for i in range(dec.decoder_layers):
        layer(f"acoustic_decoder.layers.{i}", dec.d_model,
              dec.decoder_ffn_dim)

    v, p = cfg.vocos, "enhanced_vocos.backbone"
    if v.backbone == "resnet":
        wn_conv(f"{p}.embed", v.input_channels, v.dim, 3, True)
        for i in range(v.num_blocks):
            for j in range(3):
                for n in ("convs1", "convs2"):
                    wn_conv(f"{p}.resnet.{i}.{n}.{j}", v.dim, v.dim, 3,
                            False)
                sd[f"{p}.resnet.{i}.gamma.{j}"] = (
                    1.0 / v.num_blocks / 3 + rnd(v.dim, 1, std=0.01))
    else:
        def norm(q):
            if v.adanorm_num_embeddings is None:
                ln(q, v.dim)
            else:
                n = v.adanorm_num_embeddings
                sd[q + ".scale.weight"] = 1 + rnd(n, v.dim, std=0.1)
                sd[q + ".shift.weight"] = rnd(n, v.dim, std=0.02)

        conv(f"{p}.embed", v.input_channels, v.dim, 7)
        norm(f"{p}.norm")
        ln(f"{p}.final_layer_norm", v.dim)
        for i in range(v.num_layers):
            b = f"{p}.convnext.{i}"
            conv(f"{b}.dwconv", v.dim, v.dim, 7, groups=v.dim)
            norm(f"{b}.norm")
            linear(f"{b}.pwconv1", v.dim, v.intermediate_dim)
            linear(f"{b}.pwconv2", v.intermediate_dim, v.dim)
            sd[f"{b}.gamma"] = 1.0 / v.num_layers + rnd(v.dim, std=0.01)
    out = {"istft": v.n_fft + 2, "imdct_symexp": v.mdct_frame_len // 2,
           "imdct_cos": v.mdct_frame_len}[v.head]
    linear("enhanced_vocos.head.out", v.dim, out)
    return sd


def write_reference_codec(out_dir: str, cfg, seed: int = 0):
    """The reference codec's files for ``cfg``: ``xy_tokenizer_config.yaml``
    (``generator_params``) and ``xy_tokenizer.ckpt`` ({"generator": state
    dict}, as the reference's training checkpoints hold it). Returns
    (yaml path, ckpt path)."""
    os.makedirs(out_dir, exist_ok=True)
    yaml_path = os.path.join(out_dir, "xy_tokenizer_config.yaml")
    with open(yaml_path, "w") as f:
        f.write(yaml_text({"generator_params": codec_generator_params(cfg)}))
    ckpt_path = os.path.join(out_dir, "xy_tokenizer.ckpt")
    torch.save({"generator": reference_codec_state_dict(cfg, seed)},
               ckpt_path)
    return yaml_path, ckpt_path
