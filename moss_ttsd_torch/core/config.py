"""Configuration dataclasses for the moss_ttsd_torch port.

A copy of ``moss_ttsd_tpu/core/config.py`` (the port imports nothing of the
JAX package): the same fields and defaults, so one config dict drives both
packages. Fields that name TPU-only policies are kept for dict
round-trips; the comment on LMConfig's decode-policy fields says which of
them the port's engine implements, refuses or ignores.

These mirror the reference's configuration surface:
  * ``LMConfig``      — AsteroidTTSConfig (reference modeling_asteroid.py:17-28) on
                        top of a Qwen3 backbone config (consumed from the HF
                        checkpoint's config.json in the reference).
  * ``ChannelSamplingConfig`` / ``SamplingConfig`` — the per-channel sampling params
                        the reference reads from generation_config.json
                        (modeling_asteroid.py:95-106: do_samples, layers[i].{
                        repetition_penalty, temperature, top_k, top_p}).
  * ``CodecConfig``   — XY_Tokenizer generator_params (reference
                        XY_Tokenizer/config/xy_tokenizer_config.yaml).

All configs are plain dataclasses; YAML/JSON round-trips go through dicts.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class LMConfig:
    """Qwen3-style decoder backbone + Asteroid 8-channel extensions.

    Backbone defaults follow Qwen3-1.7B (the MOSS-TTSD-v0.5 base); asteroid
    extensions follow reference modeling_asteroid.py:17-28 and the token-space
    contract in generation_utils.py:202 (speech offset 151665).
    """

    # Backbone (Qwen3)
    vocab_size: int = 152704          # text-channel vocab (includes speech range + specials)
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40960
    attention_bias: bool = False
    tie_word_embeddings: bool = True

    # Asteroid extensions (reference modeling_asteroid.py:17-28)
    channels: int = 8
    speech_pad_token: int = 1024
    speech_vocab_size: int = 1025
    speech_token_range: Tuple[int, int] = (151665, 152689)

    # Special token ids (from the reference checkpoint's tokenizer/config.json;
    # 152694 is masked as the speech-end id at modeling_asteroid.py:127-128)
    pad_token_id: int = 151643
    eos_token_id: int = 152694        # <|end_of_speech|>

    # dtype policy
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # parameter storage dtype

    # Decode policies of the JAX package (ops/pallas_attention.py, int8
    # serving, restricted head, LoRA, training, bench ablations). The port
    # keeps every field so one config dict drives both packages.
    # attn_impl: "mixed" and "pallas" attend through the kernels of
    # ops/flash_attention.py, "xla" through the dense einsums of
    # ops/attention.py (models/lm.py). lora_rank > 0 serves and trains the
    # layerwise lora_a / lora_b factors (int8 serving drops them);
    # remat_layers recomputes each block in a training backward and has no
    # effect at serving. ablate_attention, ablate_norms and ablate_rope are
    # bench-only stubs (models/lm.py; the continuous pool's own stubs are
    # ContinuousBatcher's ablate). The TPU performance knobs
    # decode_len_bucket, decode_extent_kernel, decode_block_k,
    # pallas_interpret and fuse_qk_norm_rope change no number and are
    # accepted and ignored.
    attn_impl: str = "mixed"
    pallas_interpret: bool = False
    quantized: bool = False
    kv_quant: str = "none"            # "none" | "int8"
    decode_len_bucket: int = -1
    decode_extent_kernel: bool = False
    decode_block_k: int = 512
    restricted_text_head: bool = False
    restricted_audit_every: int = 0
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_rslora: bool = True
    lora_targets: tuple = ("q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj")
    remat_layers: bool = False
    ablate_attention: bool = False
    ablate_norms: bool = False
    ablate_rope: bool = False
    fuse_qk_norm_rope: bool = False

    # The AFMoE block (arcee-ai's Trinity, HF model_type "afmoe"; the port
    # only: the JAX package has none). block_type "afmoe" builds every
    # layer as models/lm.AFMoEBlock: gated attention, sandwich norms, RoPE
    # only in sliding layers; the first num_dense_layers have a SwiGLU of
    # intermediate_size, the others num_experts routed experts of
    # moe_intermediate_size held here (experts [expert_offset,
    # expert_offset + num_experts) of the router's router_experts; 0 = all
    # of them), num_experts_per_tok chosen per token by score_func (only
    # "sigmoid") over the router plus its expert_bias, weighted by
    # route_scale (normalised over the chosen ones with route_norm), and
    # num_shared_experts always run. layer_types names each layer
    # "sliding_attention" (keys in (p - sliding_window, p]) or
    # "full_attention"; mup_enabled scales the summed embeddings by
    # sqrt(hidden_size). At their defaults these fields leave a config as
    # it was, and to_dict leaves them out.
    block_type: str = "qwen3"         # "qwen3" | "afmoe"
    layer_types: Optional[Tuple[str, ...]] = None
    sliding_window: int = 0
    num_dense_layers: int = 0
    num_experts: int = 0
    router_experts: int = 0
    expert_offset: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    route_scale: float = 1.0
    route_norm: bool = True
    score_func: str = "sigmoid"
    mup_enabled: bool = False

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def afmoe(self) -> bool:
        return self.block_type == "afmoe"

    def refuse_afmoe(self, what: str, why: str = "") -> None:
        """ValueError naming ``what`` when this config's layers are AFMoE
        blocks: the paths that do not run them refuse them here."""
        if self.afmoe:
            raise ValueError(f"{what} does not run the AFMoE block (routed "
                             f"experts, windowed attention)"
                             + (f": {why}" if why else ""))

    def layer_window(self, i: int) -> int:
        """Layer i's attention window: sliding_window for a
        "sliding_attention" layer, 0 (every earlier key) otherwise."""
        if self.layer_types is None:
            return 0
        return (self.sliding_window
                if self.layer_types[i] == "sliding_attention" else 0)

    def is_moe_layer(self, i: int) -> bool:
        return self.afmoe and self.num_experts > 0 and \
            i >= self.num_dense_layers

    @property
    def router_width(self) -> int:
        return self.router_experts or self.num_experts

    def text_head_window(self) -> Tuple[int, int]:
        """(lo, hi) channel-0 head rows computed per decode step.

        The full vocab unless restricted_text_head is set, in which case the
        contiguous window covering the speech tokens and <|end_of_speech|>
        (the only ids the restricted head can emit)."""
        if not self.restricted_text_head:
            return 0, self.vocab_size
        lo = self.speech_token_range[0]
        hi = max(self.speech_token_range[1], self.eos_token_id + 1)
        if not (0 <= lo <= self.eos_token_id < hi <= self.vocab_size):
            raise ValueError(
                f"restricted_text_head needs speech_token_range "
                f"{self.speech_token_range} and eos_token_id "
                f"{self.eos_token_id} to form a window inside the vocab "
                f"({self.vocab_size})")
        return lo, hi

    @classmethod
    def from_dict(cls, d: dict) -> "LMConfig":
        d = dict(d)
        if "speech_token_range" in d and isinstance(d["speech_token_range"], list):
            r = d["speech_token_range"]
            d["speech_token_range"] = tuple(r) if r else (151665, 152689)
        if isinstance(d.get("layer_types"), list):
            d["layer_types"] = tuple(d["layer_types"])
        return _from_dict(cls, d)

    @classmethod
    def from_hf_config_json(cls, path: str) -> "LMConfig":
        """Build from an HF checkpoint's config.json (AsteroidTTSConfig dump)."""
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d)

    def __post_init__(self):
        if self.block_type not in ("qwen3", "afmoe"):
            raise ValueError(f"unknown block_type {self.block_type!r}")
        if self.afmoe:
            self._check_afmoe()
        if self.quantized and self.lora_rank:
            # int8 weights carry no LoRA leaves: a "QLoRA" finetune would
            # silently train nothing (the JAX package's rule, kept)
            raise ValueError(
                "quantized=True with lora_rank>0 is unsupported (no QLoRA "
                "path): train LoRA on the unquantized model, or serve "
                "adapters via GenerationEngine.register_adapter")

    def _check_afmoe(self) -> None:
        L = self.num_hidden_layers
        kinds = ("sliding_attention", "full_attention")
        if self.layer_types is not None and (
                len(self.layer_types) != L
                or any(k not in kinds for k in self.layer_types)):
            raise ValueError(f"layer_types must name {L} layers, each one of "
                             f"{kinds}")
        if self.layer_types is not None and "sliding_attention" in \
                self.layer_types and self.sliding_window < 1:
            raise ValueError("sliding layers need sliding_window >= 1")
        if self.score_func != "sigmoid":
            raise ValueError(f"score_func {self.score_func!r}: only "
                             "'sigmoid' is implemented")
        if self.num_experts and not (
                0 <= self.expert_offset
                and self.expert_offset + self.num_experts <= self.router_width
                and 0 < self.num_experts_per_tok <= self.router_width
                and self.moe_intermediate_size > 0):
            raise ValueError(
                f"experts [{self.expert_offset}, {self.expert_offset} + "
                f"{self.num_experts}) of a {self.router_width}-wide router, "
                f"top {self.num_experts_per_tok}, width "
                f"{self.moe_intermediate_size}: out of range")
        if self.quantized:
            self.refuse_afmoe("int8 serving (quantized)")
        if self.lora_rank:
            self.refuse_afmoe("LoRA (lora_rank > 0)")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["speech_token_range"] = list(self.speech_token_range)
        if d["layer_types"] is not None:
            d["layer_types"] = list(d["layer_types"])
        for f in AFMOE_FIELDS:            # a Qwen3 config's dict as before
            if d[f] == _DEFAULTS[f]:
                del d[f]
        return d

    def tiny(self, **overrides) -> "LMConfig":
        """A tiny config for tests."""
        small = dict(
            vocab_size=160, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, speech_token_range=(100, 140), pad_token_id=0,
            eos_token_id=150, speech_vocab_size=33, speech_pad_token=32,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


AFMOE_FIELDS = ("block_type", "layer_types", "sliding_window",
                "num_dense_layers", "num_experts", "router_experts",
                "expert_offset", "num_experts_per_tok",
                "moe_intermediate_size", "num_shared_experts", "route_scale",
                "route_norm", "score_func", "mup_enabled")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(LMConfig)}


@dataclass
class ChannelSamplingConfig:
    """Per-channel sampling parameters (reference modeling_asteroid.py:95-106)."""

    do_sample: bool = True
    temperature: Optional[float] = 1.0
    top_k: Optional[int] = 50
    top_p: Optional[float] = 1.0
    repetition_penalty: Optional[float] = None


@dataclass
class SamplingConfig:
    """Generation-time config (reference generation_config.json semantics)."""

    channels: List[ChannelSamplingConfig] = field(default_factory=list)
    max_new_tokens: int = 8192
    # Total-length cap (prompt + generated), HF max_length semantics: the
    # reference's MaxLengthCriteria stops at cur_len >= max_length, so the
    # per-request step count is max_length - prompt_len (resolved by the
    # engine at generate time).
    max_length: Optional[int] = None
    # Static pre-filter size used before top-p on the large text-channel vocab;
    # when a channel sets top_k it is used directly.
    topk_prefilter: int = 128
    # approximate top-k on the big text vocab in the JAX package (a TPU
    # recall trade); the port always takes the exact torch.topk
    approx_topk: bool = False
    # Exact full-vocab nucleus for channels that set top_p WITHOUT top_k
    # (ops/sampling.exact_top_p_mask: fixed-trip threshold search, no 152k
    # sort). Off, such channels run the static topk_prefilter truncation
    # (approximate whenever the nucleus exceeds it).
    exact_top_p: bool = False

    @classmethod
    def default(cls, num_channels: int = 8) -> "SamplingConfig":
        return cls(channels=[ChannelSamplingConfig() for _ in range(num_channels)])

    @classmethod
    def from_generation_config_json(cls, path: str, num_channels: int = 8) -> "SamplingConfig":
        """Parse the HF generation_config.json shipped with the reference ckpt.

        Reads `do_samples` and `layers[i].{repetition_penalty, temperature,
        top_k, top_p}` (consumed at reference modeling_asteroid.py:95-106).
        """
        with open(path) as f:
            d = json.load(f)
        do_samples = d.get("do_samples")
        layers = d.get("layers", [])
        chans: List[ChannelSamplingConfig] = []
        for i in range(num_channels):
            layer = layers[i] if i < len(layers) else {}
            chans.append(ChannelSamplingConfig(
                do_sample=(do_samples[i] if do_samples is not None and i < len(do_samples)
                           else bool(d.get("do_sample", True))),
                temperature=layer.get("temperature"),
                top_k=layer.get("top_k"),
                top_p=layer.get("top_p"),
                repetition_penalty=layer.get("repetition_penalty"),
            ))
        cfg = cls(channels=chans)
        if "max_new_tokens" in d:
            cfg.max_new_tokens = int(d["max_new_tokens"])
        if "max_length" in d:
            # HF max_length is a TOTAL length cap (prompt included); keep it
            # as such and let the engine subtract the prompt length per
            # request. max_new_tokens stays an upper bound for buffer sizing.
            cfg.max_length = int(d["max_length"])
            if "max_new_tokens" not in d:
                cfg.max_new_tokens = int(d["max_length"])
        return cfg


# ---------------------------------------------------------------------------
# Codec (XY_Tokenizer equivalent)
# ---------------------------------------------------------------------------

@dataclass
class MelConfig:
    """Whisper-style mel frontend (reference feature_extractor.py:14-50)."""

    feature_size: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    chunk_length: int = 30
    n_fft: int = 400
    padding_value: float = 0.0

    @property
    def n_samples(self) -> int:
        return self.chunk_length * self.sampling_rate

    @property
    def nb_max_frames(self) -> int:
        return self.n_samples // self.hop_length


@dataclass
class AudioEncoderConfig:
    """OmniAudioEncoder (reference modules.py:208-256, config yaml:23-35)."""

    num_mel_bins: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    stride_size: int = 2
    kernel_size: int = 3
    d_model: int = 768
    scale_embedding: bool = False
    max_audio_seconds: int = 30
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    activation_function: str = "gelu"

    @property
    def max_source_positions(self) -> int:
        return (self.max_audio_seconds * self.sampling_rate // self.hop_length) // self.stride_size


@dataclass
class AudioDecoderConfig:
    """OmniAudioDecoder (reference modules.py:329-384, config yaml:101-113)."""

    num_mel_bins: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    stride_size: int = 2
    kernel_size: int = 3
    d_model: int = 768
    scale_embedding: bool = False
    max_audio_seconds: int = 30
    decoder_layers: int = 12
    decoder_attention_heads: int = 12
    decoder_ffn_dim: int = 3072
    activation_function: str = "gelu"

    @property
    def max_source_positions(self) -> int:
        return (self.max_audio_seconds * self.sampling_rate // self.hop_length) // self.stride_size


@dataclass
class AdapterTransformerConfig:
    """Adapter Transformer (reference modules.py:519-567)."""

    input_dim: int = 768
    d_model: int = 768
    output_dim: int = 768
    max_source_positions: int = 1500
    encoder_layers: int = 4
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    activation_function: str = "gelu"


@dataclass
class RVQConfig:
    """ResidualVQ (reference quantizer.py:196-242, config yaml:77-85)."""

    input_dim: int = 3072
    rvq_dim: int = 512
    output_dim: int = 3072
    num_quantizers: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 512
    quantizer_dropout: float = 0.0
    commitment: float = 1.0
    decay: float = 0.99
    epsilon: float = 1e-5
    threshold_ema_dead: float = 2.0
    skip_rvq_ratio: float = 0.0


@dataclass
class VocosConfig:
    """Vocos vocoder (reference modules.py:1451-1479, config yaml:115-122)."""

    input_channels: int = 80
    dim: int = 512
    intermediate_dim: int = 4096
    num_layers: int = 30
    n_fft: int = 960
    hop_size: int = 240
    padding: str = "same"
    # Config-selectable backbone/head family (reference modules.py:795-1449;
    # the shipped checkpoint uses convnext + istft — the other variants are
    # the reference's alternative Vocos generators)
    backbone: str = "convnext"        # "convnext" | "resnet"
    head: str = "istft"               # "istft" | "imdct_symexp" | "imdct_cos"
    adanorm_num_embeddings: Optional[int] = None   # conditional ConvNeXt LN
    num_blocks: int = 3               # ResNet backbone depth
    mdct_frame_len: int = 480         # IMDCT heads (upsample = frame_len // 2)
    head_sample_rate: Optional[int] = None   # mel-scale init of IMDCTSymExpHead
    clip_audio: bool = False
    # Strict-parity audit switch for the IMDCT heads' clip_audio branch: the
    # reference clips (and returns) the pre-IMDCT COEFFICIENT tensor instead
    # of the audio (`audio = torch.clip(x, ...)`, modules.py:1044-1046 and
    # :1091-1093 — a variable-misuse bug). Default False keeps the fixed
    # behavior (clip the audio); True reproduces the reference bit-for-bit
    # for checkpoint-exactness audits.
    clip_coeffs: bool = False


@dataclass
class CodecConfig:
    """XY_Tokenizer generator_params (reference xy_tokenizer_config.yaml)."""

    input_sample_rate: int = 16000
    output_sample_rate: int = 24000
    encoder_downsample_rate: int = 1280   # reference model.py:20
    decoder_upsample_rate: int = 1920     # reference model.py:21

    feature_extractor: MelConfig = field(default_factory=MelConfig)
    semantic_encoder: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    semantic_encoder_adapter: AdapterTransformerConfig = field(default_factory=AdapterTransformerConfig)
    acoustic_encoder: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    pre_rvq_adapter: AdapterTransformerConfig = field(
        default_factory=lambda: AdapterTransformerConfig(input_dim=1536, output_dim=768))
    downsample_d_model: int = 768
    downsample_factor: int = 4
    quantizer: RVQConfig = field(default_factory=RVQConfig)
    post_rvq_adapter: AdapterTransformerConfig = field(
        default_factory=lambda: AdapterTransformerConfig(
            input_dim=3072, output_dim=3072, max_source_positions=375))
    upsample_d_model: int = 768
    upsample_stride: int = 4
    acoustic_decoder: AudioDecoderConfig = field(default_factory=AudioDecoderConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)

    dtype: str = "float32"   # the reference runs the codec fully in fp32

    @property
    def frame_rate(self) -> float:
        return self.input_sample_rate / self.encoder_downsample_rate  # 12.5 Hz

    @classmethod
    def from_yaml(cls, path: str) -> "CodecConfig":
        """Build from the reference codec yaml's ``generator_params``, read
        by the port's YAML-subset reader (no ``pyyaml``)."""
        from ..utils import config_yaml
        return cls.from_generator_params(
            config_yaml.load(path)["generator_params"])

    @classmethod
    def from_generator_params(cls, gp: dict) -> "CodecConfig":
        """Build from a reference-format generator_params dict."""
        def sub(cfg_cls, key):
            return _from_dict(cfg_cls, gp.get(key, {}))
        return cls(
            input_sample_rate=gp.get("input_sample_rate", 16000),
            output_sample_rate=gp.get("output_sample_rate", 24000),
            feature_extractor=sub(MelConfig, "feature_extractor_kwargs"),
            semantic_encoder=sub(AudioEncoderConfig, "semantic_encoder_kwargs"),
            semantic_encoder_adapter=sub(AdapterTransformerConfig, "semantic_encoder_adapter_kwargs"),
            acoustic_encoder=sub(AudioEncoderConfig, "acoustic_encoder_kwargs"),
            pre_rvq_adapter=sub(AdapterTransformerConfig, "pre_rvq_adapter_kwargs"),
            downsample_d_model=gp.get("downsample_kwargs", {}).get("d_model", 768),
            downsample_factor=gp.get("downsample_kwargs", {}).get("avg_pooler", 4),
            quantizer=sub(RVQConfig, "quantizer_kwargs"),
            post_rvq_adapter=sub(AdapterTransformerConfig, "post_rvq_adapter_kwargs"),
            upsample_d_model=gp.get("upsample_kwargs", {}).get("d_model", 768),
            upsample_stride=gp.get("upsample_kwargs", {}).get("stride", 4),
            acoustic_decoder=sub(AudioDecoderConfig, "acoustic_decoder_kwargs"),
            vocos=_from_dict(VocosConfig, {
                **gp.get("vocos_kwargs", {}),
                "hop_size": gp.get("vocos_kwargs", {}).get("hop_size", 240),
            }),
        )

    def tiny(self) -> "CodecConfig":
        """A tiny random-weight config for tests (keeps all rate contracts)."""
        enc = AudioEncoderConfig(d_model=32, encoder_layers=1, encoder_attention_heads=4,
                                 encoder_ffn_dim=64)
        dec = AudioDecoderConfig(d_model=32, decoder_layers=1, decoder_attention_heads=4,
                                 decoder_ffn_dim=64)
        return dataclasses.replace(
            self,
            semantic_encoder=enc, acoustic_encoder=enc,
            semantic_encoder_adapter=AdapterTransformerConfig(
                input_dim=32, d_model=32, output_dim=32, encoder_layers=1,
                encoder_attention_heads=4, encoder_ffn_dim=64),
            pre_rvq_adapter=AdapterTransformerConfig(
                input_dim=64, d_model=32, output_dim=32, encoder_layers=1,
                encoder_attention_heads=4, encoder_ffn_dim=64),
            downsample_d_model=32,
            quantizer=RVQConfig(input_dim=128, rvq_dim=16, output_dim=128,
                                num_quantizers=8, codebook_size=64, codebook_dim=16),
            post_rvq_adapter=AdapterTransformerConfig(
                input_dim=128, d_model=32, output_dim=128, encoder_layers=1,
                encoder_attention_heads=4, encoder_ffn_dim=64,
                max_source_positions=375),
            upsample_d_model=32,
            acoustic_decoder=dec,
            vocos=VocosConfig(input_channels=80, dim=32, intermediate_dim=64, num_layers=2),
        )
