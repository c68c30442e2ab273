"""Seeded weights made on the device in a few large draws.

A group of tensors (the LM, the codec's decoder side, its encoder side, a
LoRA voice) is one flat normal draw from a generator on the device, seeded
from (run seed, group); each tensor is its slice of the draw, in the
order of the sorted names, scaled by the group's rule. The program and the
reference each call ``make`` with their own list of (name, shape), so both
hold the same values and share no tensor.

Rules (the port's own init scales): the LM's is its architecture's
(``arch/<name>.py``'s ``lm_rule``); codec codebooks N(0, 1), matrices and
convolutions N(0, 1/fan_in), norms 1, biases 0, ConvNeXt layer scales
1/num_layers; LoRA ``a`` N(0, 1/in) and ``b`` N(0, LORA_B_STD), so that a
voice moves the projections by about a tenth at the LoRA scale
32/sqrt(16).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from . import arch

Spec = List[Tuple[str, Tuple[int, ...]]]
LORA_RANK = 16
LORA_ALPHA = 32.0
LORA_B_STD = 0.003
GROUPS = {"lm": 1, "codec_decoder": 2, "codec_encoder": 3, "voice": 10}


def group_seed(seed: int, group: int) -> int:
    """A 63-bit generator seed for (run seed, group)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, group])
               .generate_state(1, np.uint64)[0] % 2 ** 63)


def make(spec: Iterable[Tuple[str, Tuple[int, ...]]],
         rule: Callable[[str, Tuple[int, ...]], Tuple[str, float]],
         seed: int, group: int, device, dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``spec``: ``rule(name, shape)`` gives ("normal",
    std) or ("const", value). One draw of every normal tensor's elements."""
    spec = sorted((n, tuple(s)) for n, s in spec)
    rules = [rule(n, s) for n, s in spec]
    total = sum(math.prod(s) for (n, s), (k, _) in zip(spec, rules)
                if k == "normal")
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    flat = torch.empty(total, dtype=dtype, device=device).normal_(
        generator=gen)
    out, off = {}, 0
    for (name, shape), (kind, v) in zip(spec, rules):
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape) * v
            off += n
        else:
            out[name] = torch.full(shape, v, dtype=dtype, device=device)
    del flat
    return out


_CONV_T = ("up_conv.weight", "deconv1.weight", "deconv2.weight")


def codec_rule(num_vocos_layers: int):
    def rule(name: str, shape) -> Tuple[str, float]:
        leaf = name.rsplit(".", 1)[-1]
        if name == "quantizer.codebook":
            return "normal", 1.0
        if leaf == "gamma":
            return "const", 1.0 / num_vocos_layers
        if leaf in ("bias", "q_b", "v_b", "o_b"):
            return "const", 0.0
        if len(shape) == 1:
            return "const", 1.0
        if leaf in ("q_w", "k_w", "v_w", "o_w"):
            fan_in = shape[0]
        elif name.endswith(_CONV_T):
            fan_in = shape[0] * shape[2]
        else:
            fan_in = math.prod(shape[1:])
        return "normal", fan_in ** -0.5
    return rule


def is_codec_decoder(name: str) -> bool:
    """The tensors ``detokenize`` reads: the codebooks and the RVQ output
    projection, the post-RVQ adapter, the upsample, the acoustic decoder
    and the vocoder."""
    return name == "quantizer.codebook" or name.startswith((
        "quantizer.output_proj.", "post_rvq_adapter.", "upsample.",
        "acoustic_decoder.", "vocos."))


def voice_spec(targets: Dict[str, Tuple[int, int]], layers: int) -> Spec:
    """A voice's factors of each target {name: (in, out)}, every layer."""
    spec = []
    for t, (fi, fo) in targets.items():
        spec.append((f"{t}.a", (layers, fi, LORA_RANK)))
        spec.append((f"{t}.b", (layers, LORA_RANK, fo)))
    return spec


def voice_rule(name: str, shape) -> Tuple[str, float]:
    if name.endswith(".a"):
        return "normal", 1.0 / math.sqrt(shape[1])
    return "normal", LORA_B_STD


def voices(cfg: dict, seed: int, n: int, device) -> List[Dict[str, torch.Tensor]]:
    """``n`` rank-16 LoRA voices on the architecture's ``lora_targets`` in
    every layer, fp32, {"<target>.a": (L, in, r), "<target>.b": (L, r,
    out)}."""
    spec = voice_spec(arch.of(cfg).lora_targets(cfg),
                      cfg["num_hidden_layers"])
    return [make(spec, voice_rule, seed, GROUPS["voice"] + i, device,
                 torch.float32) for i in range(n)]
