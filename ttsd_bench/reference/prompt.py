"""Prompt assembly of MOSS-TTSD as the reference's generation_utils.py
defines it (process_inputs, shifting_inputs), over a byte-level tokenizer:
the system prompt and template, ``[S1]``/``[S2]`` as the speaker tokens,
channel i of the delay pattern shifted down by i rows.

The byte-level tokenizer is the one the benchmark's configurations assume
in place of Qwen's BPE (the repository has no tokenizer files): text bytes
map to ids 1..63, the template's special tokens to 80..87, and 0 pads."""

from __future__ import annotations

import re
from typing import List

import numpy as np

SYSTEM_PROMPT = ("You are a speech synthesizer that generates natural, "
                 "realistic, and human-like conversational audio from dialogue "
                 "text.")
TEMPLATE = ("<|begin_of_style|>{prompt}<|end_of_style|>\n"
            "<|begin_of_text|>{text}<|end_of_text|>\n<|begin_of_speech|>")
SPECIALS = ["<|begin_of_style|>", "<|end_of_style|>", "<|begin_of_text|>",
            "<|end_of_text|>", "<|begin_of_speech|>", "<|end_of_speech|>",
            "<speaker1>", "<speaker2>"]
TEXT_PAD_ID = 0
_SPLIT = re.compile("(" + "|".join(re.escape(t) for t in SPECIALS) + ")")


def encode(text: str) -> List[int]:
    ids: List[int] = []
    for part in _SPLIT.split(text):
        if not part:
            continue
        if part in SPECIALS:
            ids.append(80 + SPECIALS.index(part))
        else:
            ids.extend(1 + b % 63 for b in part.encode("utf-8"))
    return ids


def prompt_ids(script: str, channels: int, speech_pad: int) -> np.ndarray:
    """A text-only ``[S1]/[S2]`` script -> (T, channels) ids: the template
    on channel 0, the speech pad on the others."""
    text = script.replace("[S1]", "<speaker1>").replace("[S2]", "<speaker2>")
    ids = np.asarray(encode(TEMPLATE.format(prompt=SYSTEM_PROMPT, text=text)),
                     np.int64)
    out = np.full((len(ids), channels), speech_pad, np.int64)
    out[:, 0] = ids
    return out


def shifted_prompt(script: str, channels: int, speech_pad: int) -> np.ndarray:
    """(T + channels - 1, channels): channel i delayed by i rows, text pad
    on channel 0 and speech pad elsewhere in the new rows."""
    ids = prompt_ids(script, channels, speech_pad)
    T = ids.shape[0]
    out = np.full((T + channels - 1, channels), speech_pad, np.int64)
    out[:, 0] = TEXT_PAD_ID
    for i in range(channels):
        out[i:T + i, i] = ids[:, i]
    return out


def prompt_tokens(script: str) -> int:
    """Tokens of the unshifted prompt, system prompt and template included."""
    return len(prompt_ids(script, 1, 0))


def overhead_tokens() -> int:
    """Tokens of the prompt of an empty script."""
    return prompt_tokens("")
