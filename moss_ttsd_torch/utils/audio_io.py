"""Wav writing (scipy), port of ``write_wav`` from
``moss_ttsd_tpu/utils/audio_io.py``."""

from __future__ import annotations

import numpy as np


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float32 (T,) or (channels, T) audio as 16-bit PCM."""
    from scipy.io import wavfile
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.T                       # scipy expects (T, channels)
    pcm = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))
