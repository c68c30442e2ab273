"""ctypes bindings to the native host audio runtime (``libmossaudio.so``),
the port's copy of ``moss_ttsd_tpu/utils/native.py``.

The library holds the multi-threaded polyphase resampler and the wav codec
of the prompt-audio path. Its sources ship in the package
(``moss_ttsd_torch/native/``); ``make`` builds it at first use into
``build/moss_ttsd_torch/native/`` at the root of the checkout, never into
the package directory. Every entry point degrades gracefully: without a
compiler the library is absent, each function returns None (or False), and
the callers in ``utils/audio_io.py`` take the numpy/scipy paths.

``calls`` counts the successful native calls by function, so a run can
show that it went through the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moss_ttsd_torch" \
    / "native"
LIB_PATH = BUILD_DIR / "libmossaudio.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_info: Dict[str, object] = {}
calls: Dict[str, int] = {"resample": 0, "read_wav": 0, "write_wav": 0}


def _build() -> bool:
    t0 = time.perf_counter()
    try:
        r = subprocess.run(["make", "-C", str(SRC_DIR), f"OUT={BUILD_DIR}"],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_info.update(ok=False, log=str(e))
        return False
    build_info.update(ok=r.returncode == 0 and LIB_PATH.exists(),
                      seconds=time.perf_counter() - t0,
                      log=(r.stdout + r.stderr)[-2000:])
    return bool(build_info["ok"])


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # always run make: it does nothing when the library is newer than
        # its source, and rebuilds a stale one
        if not _build() and not LIB_PATH.exists():
            return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None
        lib.ma_resample_out_len.restype = ctypes.c_int64
        lib.ma_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                            ctypes.c_int32]
        lib.ma_resample.restype = ctypes.c_int32
        lib.ma_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.ma_wav_info.restype = ctypes.c_int32
        lib.ma_wav_info.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.ma_wav_read.restype = ctypes.c_int32
        lib.ma_wav_read.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int64]
        lib.ma_wav_write.restype = ctypes.c_int32
        lib.ma_wav_write.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int32, ctypes.c_int64,
                                     ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> Optional[np.ndarray]:
    """(..., T) float32 -> resampled by torchaudio's default Hann-windowed
    sinc, or None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    lead = x.shape[:-1]
    n_in = x.shape[-1]
    if n_in == 0:                      # reshape(-1, 0) would raise
        return np.zeros(lead + (0,), np.float32)
    xf = np.ascontiguousarray(x, np.float32).reshape(-1, n_in)
    n_out = int(lib.ma_resample_out_len(n_in, sr_in, sr_out))
    out = np.empty((xf.shape[0], n_out), np.float32)
    rc = lib.ma_resample(_fptr(xf), xf.shape[0], n_in, sr_in, sr_out,
                         _fptr(out), n_out)
    if rc != 0:
        return None
    calls["resample"] += 1
    return out.reshape(lead + (n_out,))


def read_wav(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Read a wav -> ((channels, T) float32, sr), or None on any failure."""
    lib = _load()
    if lib is None:
        return None
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    fr = ctypes.c_int64()
    if lib.ma_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(fr)) != 0:
        return None
    out = np.empty((ch.value, fr.value), np.float32)
    if lib.ma_wav_read(path.encode(), _fptr(out), out.size) != 0:
        return None
    calls["read_wav"] += 1
    return out, int(sr.value)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> bool:
    """Write planar (channels, T) or (T,) float32 as 16-bit PCM."""
    lib = _load()
    if lib is None:
        return False
    w = np.asarray(wav, np.float32)
    if w.ndim == 1:
        w = w[None, :]
    w = np.ascontiguousarray(w)
    rc = lib.ma_wav_write(path.encode(), _fptr(w), w.shape[0], w.shape[1],
                          sample_rate)
    if rc != 0:
        return False
    calls["write_wav"] += 1
    return True
