"""JSONL item parsing, port of ``moss_ttsd_tpu/pipeline/jsonl.py``.

Supports the three input formats of the reference examples/: full
(text + prompt_audio_speaker1/2 + prompt_text_speaker1/2), single-reference
(text + prompt_audio + prompt_text) and text-only. Loading and resampling
prompt audio belongs to the voice-cloning slice: ``load_audio_data`` raises
"not yet ported", which the pipeline's per-item isolation turns into an
``error`` entry.
"""

from __future__ import annotations

import os


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


def load_audio_data(prompt_audio, target_sample_rate: int = 16000):
    """Prompt-audio loading (voice cloning): not yet ported."""
    if prompt_audio is None:
        return None
    raise NotImplementedError(
        "prompt audio (voice cloning) is not yet ported to moss_ttsd_torch")
