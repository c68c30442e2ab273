"""JSONL item parsing and prompt-audio loading, port of
``moss_ttsd_tpu/pipeline/jsonl.py``.

Supports the three input formats of the reference examples/: full
(text + prompt_audio_speaker1/2 + prompt_text_speaker1/2), single-reference
(text + prompt_audio + prompt_text) and text-only. A prompt voice is a wav
path or a ``(wav (channels, T) or (T,), sample_rate)`` tuple; it is loaded
as mono 16 kHz, and two speakers are concatenated in time.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.audio_io import read_wav, to_mono_16k


def process_jsonl_item(item: dict) -> dict:
    """Normalize a JSONL record -> {text, prompt_text, prompt_audio}."""
    base_path = item.get("base_path", "")
    text = item.get("text", "")
    prompt_audio = None
    prompt_text = ""

    if "prompt_audio" in item and "prompt_text" in item:
        val = item["prompt_audio"]
        if val:
            prompt_audio = val
            prompt_text = item["prompt_text"]
            if isinstance(prompt_audio, str) and base_path:
                prompt_audio = os.path.join(base_path, prompt_audio)
    else:
        a1 = item.get("prompt_audio_speaker1", "")
        t1 = item.get("prompt_text_speaker1", "")
        a2 = item.get("prompt_audio_speaker2", "")
        t2 = item.get("prompt_text_speaker2", "")

        def resolve(a):
            if isinstance(a, str) and a and base_path:
                return os.path.join(base_path, a)
            return a

        has1 = (isinstance(a1, str) and a1) or isinstance(a1, tuple)
        has2 = (isinstance(a2, str) and a2) or isinstance(a2, tuple)
        if has1 or has2:
            prompt_audio = {"speaker1": resolve(a1), "speaker2": resolve(a2)}

        merged = ""
        if t1:
            merged += f"[S1]{t1}"
        if t2:
            merged += f"[S2]{t2}"
        prompt_text = merged.strip()

    return {"text": text, "prompt_text": prompt_text, "prompt_audio": prompt_audio}


def _load_single(audio) -> tuple:
    """Path or (wav (channels, T) float32, sr) tuple -> (wav, sr)."""
    if isinstance(audio, tuple) and len(audio) == 2:
        wav, sr = audio
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None, :]
        return wav, int(sr)
    if isinstance(audio, str):
        return read_wav(audio)
    raise ValueError(f"Unsupported audio input: {type(audio)}")


def load_audio_data(prompt_audio,
                    target_sample_rate: int = 16000) -> Optional[np.ndarray]:
    """Load + resample + mono; a two-speaker dict is concatenated in time
    (the reference's merge_speaker_audios). Returns (T,) float32 or None."""
    if prompt_audio is None:
        return None
    if isinstance(prompt_audio, dict) and "speaker1" in prompt_audio:
        w1, sr1 = _load_single(prompt_audio["speaker1"])
        w2, sr2 = _load_single(prompt_audio["speaker2"])
        m1 = to_mono_16k(w1, sr1, target_sample_rate)
        m2 = to_mono_16k(w2, sr2, target_sample_rate)
        return np.concatenate([m1, m2])
    wav, sr = _load_single(prompt_audio)
    return to_mono_16k(wav, sr, target_sample_rate)
