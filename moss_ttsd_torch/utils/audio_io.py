"""Host-side audio file IO, port of ``moss_ttsd_tpu/utils/audio_io.py``:
wav read/write and the mono 16 kHz conversion of prompt audio.

Each function dispatches to the native runtime (``utils/native.py``) when
its library is built and takes the scipy/numpy path otherwise, as the JAX
package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.dsp import resample
from . import native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 (channels, T) in [-1, 1], sample_rate)."""
    nat = native.read_wav(path)
    if nat is not None:
        return nat
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T
    return data, int(sr)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float32 (T,) or (channels, T) audio as 16-bit PCM."""
    if native.write_wav(path, wav, sample_rate):
        return
    from scipy.io import wavfile
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.T                       # scipy expects (T, channels)
    pcm = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))


def to_mono_16k(wav: np.ndarray, sr: int, target_sr: int = 16000) -> np.ndarray:
    """(channels, T) at any rate -> (T',) mono at ``target_sr``: resample,
    then average the channels (the reference's load_audio_data)."""
    if sr != target_sr:
        nat = native.resample(wav, sr, target_sr)
        wav = nat if nat is not None else resample(wav, sr, target_sr)
    if wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    return wav[0]
