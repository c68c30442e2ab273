"""Audio DSP, synthesis side: PyTorch port of the ISTFT half of
``moss_ttsd_tpu/ops/dsp.py`` (the analysis side — STFT, mel — belongs to the
voice-cloning slice).

The overlap-add keeps the JAX package's formulation: with hop | win the
output is the sum of R = win / hop statically shifted frame streams (a pad +
add, no scatter). The inverse FFT is ``torch.fft.irfft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(win_length: int, periodic: bool = True,
                dtype=np.float32) -> np.ndarray:
    """Hann window; periodic=True matches torch.hann_window's default."""
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return w.astype(dtype)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add frames (..., W, T) -> (..., (T-1)*hop + W). Requires
    hop | W."""
    W, T = frames.shape[-2], frames.shape[-1]
    assert W % hop == 0, f"overlap_add requires hop|win, got win={W} hop={hop}"
    R = W // hop
    out_len = (T - 1) * hop + W
    nseg = T - 1 + R
    lead = frames.shape[:-2]
    y = torch.zeros(lead + (nseg, hop), dtype=frames.dtype,
                    device=frames.device)
    fr = frames.reshape(lead + (R, hop, T))
    for k in range(R):
        y[..., k:k + T, :] += fr[..., k, :, :].transpose(-1, -2)
    return y.reshape(lead + (nseg * hop,))[..., :out_len]


@functools.lru_cache(maxsize=8)
def _window_envelope(n_fft: int, hop: int, win_length: int, T: int) -> np.ndarray:
    """Squared-window overlap-add envelope of length (T-1)*hop + win_length."""
    w = hann_window(win_length, periodic=True).astype(np.float64) ** 2
    out_len = (T - 1) * hop + win_length
    env = np.zeros(out_len)
    for t in range(T):
        env[t * hop: t * hop + win_length] += w
    return env.astype(np.float32)


def _irfft_frames(re: torch.Tensor, im: torch.Tensor, n_fft: int):
    """(..., n_bins, T) spectrogram parts -> windowed frames (..., n_fft, T)."""
    spec = torch.complex(re.to(torch.float32), im.to(torch.float32))
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    window = torch.as_tensor(hann_window(n_fft), device=re.device)
    return frames * window, window


def istft_same_masked(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                      hop: int, num_frames: torch.Tensor) -> torch.Tensor:
    """"same"-padded ISTFT over a ragged batch: only the first
    ``num_frames[b]`` frames of row b exist, and both the overlap-add and
    the squared-window envelope are masked per row.

    re, im: (B, n_bins, T); num_frames: (B,). Returns (B, T * hop); samples
    past num_frames * hop are zero."""
    pad = (n_fft - hop) // 2
    B, T = re.shape[0], re.shape[-1]
    frames, window = _irfft_frames(re, im, n_fft)           # (B, T, n_fft)
    fmask = (torch.arange(T, device=re.device)[None, :]
             < num_frames[:, None]).to(torch.float32)       # (B, T)
    frames = (frames * fmask[..., None]).transpose(-1, -2)  # (B, n_fft, T)
    y = overlap_add(frames, hop)
    env_frames = (window ** 2)[None, :, None].expand(B, n_fft, T) \
        * fmask[:, None, :]
    env = overlap_add(env_frames, hop)
    y = torch.where(env > 1e-11, y / env.clamp_min(1e-11), 0.0)
    # pad == 0 (hop == n_fft, no overlap): y[..., 0:-0] would be empty
    return y[..., pad:y.shape[-1] - pad]


def istft_same(re: torch.Tensor, im: torch.Tensor, n_fft: int,
               hop: int) -> torch.Tensor:
    """ISTFT with "same" padding: re, im (..., n_bins, T) -> (..., T * hop);
    (win - hop) // 2 samples are trimmed from both ends."""
    pad = (n_fft - hop) // 2
    T = re.shape[-1]
    frames, _ = _irfft_frames(re, im, n_fft)
    y = overlap_add(frames.transpose(-1, -2), hop)
    env = torch.as_tensor(_window_envelope(n_fft, hop, n_fft, int(T)),
                          device=re.device)
    # guarded division: at hop == n_fft the periodic-Hann envelope is 0 at
    # sample 0 and the trim keeps that sample
    y = torch.where(env > 1e-11, y / env.clamp_min(1e-11), 0.0)
    return y[..., pad:y.shape[-1] - pad]
