"""Prompt assembly, delay-pattern shifting, batch padding, un-shifting.

Host-side numpy equivalents of reference generation_utils.py:
  * ``build_prompt_ids``     — process_inputs (:180-208): template + codec codes
                               with the +151665 channel-0 offset (:202).
  * ``shift_delay_pattern``  — shifting_inputs (:211-218).
  * ``left_pad_batch``       — rpadding (:221-237).
  * ``unshift_outputs``      — process_batch un-shift (:416-425).
  * ``find_max_valid_positions`` — (:240-249).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAX_CHANNELS = 8
SPEECH_OFFSET = 151665          # reference generation_utils.py:202
PROMPT_TEMPLATE = ("<|begin_of_style|>{prompt}<|end_of_style|>\n"
                   "<|begin_of_text|>{text}<|end_of_text|>\n<|begin_of_speech|>")


def build_prompt_ids(tokenizer, system_prompt: str, text: str,
                     audio_codes: Optional[np.ndarray] = None,
                     channels: int = MAX_CHANNELS,
                     pad_token: int = 1024,
                     speech_offset: int = SPEECH_OFFSET) -> np.ndarray:
    """Text template + optional codec codes -> (T, channels) int64.

    audio_codes: (T_audio, nq) raw codec codes (unoffset), as produced by
    XYTokenizer.encode (transposed). Channel 0 gets the +151665 offset.
    """
    seq = PROMPT_TEMPLATE.format(prompt=system_prompt, text=text)
    text_ids = np.asarray(tokenizer.encode(seq), np.int64)
    ids = np.full((len(text_ids), channels), pad_token, np.int64)
    ids[:, 0] = text_ids
    if audio_codes is not None:
        codes = np.asarray(audio_codes, np.int64).copy()
        if codes.shape[1] > channels:
            codes = codes[:, :channels]
        elif codes.shape[1] < channels:
            padc = np.full((codes.shape[0], channels), pad_token, np.int64)
            padc[:, :codes.shape[1]] = codes
            codes = padc
        codes[:, 0] += speech_offset
        ids = np.concatenate([ids, codes], axis=0)
    return ids


def shift_delay_pattern(input_ids: np.ndarray, text_pad_id: int,
                        pad_token: int = 1024) -> np.ndarray:
    """(T, C) -> (T + C - 1, C): channel i delayed by i rows
    (reference shifting_inputs, generation_utils.py:211-218)."""
    T, C = input_ids.shape
    out = np.full((T + C - 1, C), pad_token, np.int64)
    out[:, 0] = text_pad_id
    for i in range(C):
        out[i:T + i, i] = input_ids[:, i]
    return out


def left_pad_batch(ids_list: List[np.ndarray], text_pad_id: int,
                   pad_token: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad to the batch max (reference rpadding, :221-237).

    Returns (input_ids (B, L, C), attention_mask (B, L))."""
    C = ids_list[0].shape[1]
    max_len = max(x.shape[0] for x in ids_list)
    B = len(ids_list)
    out = np.zeros((B, max_len, C), np.int64)
    mask = np.zeros((B, max_len), np.int64)
    for b, ids in enumerate(ids_list):
        pad = max_len - ids.shape[0]
        out[b, :pad, :] = pad_token
        out[b, :pad, 0] = text_pad_id
        out[b, pad:] = ids
        mask[b, pad:] = 1
    return out, mask


def unshift_outputs(tokens: np.ndarray, base: int,
                    channels: int = MAX_CHANNELS,
                    speech_offset: int = SPEECH_OFFSET) -> np.ndarray:
    """Undo the delay pattern on generated tokens.

    tokens: (B, total, C) engine output; base: index of first generated row.
    Returns speech_ids (B, seq_len, C) with channel 0 un-offset
    (reference process_batch :416-425: slice from start=L-C+1, then
    speech_ids[..., j] = out[:, j:seq_len+j, j]; ch0 -= 151665).
    """
    gen = tokens[:, base:]
    seq_len = gen.shape[1] - channels + 1
    if seq_len <= 0:
        return np.zeros((tokens.shape[0], 0, channels), np.int64)
    out = np.zeros((tokens.shape[0], seq_len, channels), np.int64)
    for j in range(channels):
        out[..., j] = gen[:, j:seq_len + j, j]
    out[..., 0] -= speech_offset
    return out


def find_max_valid_positions(speech_ids: np.ndarray,
                             invalid_value: int = 1024) -> np.ndarray:
    """Last row where channel 1 != invalid_value, per sample; -1 if none
    (reference generation_utils.py:240-249)."""
    if speech_ids.shape[1] == 0:
        return np.full((speech_ids.shape[0],), -1, np.int64)
    values = speech_ids[:, :, 1]
    mask = values != invalid_value
    has_valid = mask.any(axis=1)
    rev = mask[:, ::-1]
    idx = speech_ids.shape[1] - 1 - np.argmax(rev, axis=1)
    return np.where(has_valid, idx, -1)
