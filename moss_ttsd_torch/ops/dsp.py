"""Audio DSP: PyTorch port of ``moss_ttsd_tpu/ops/dsp.py``.

Analysis side (the codec encode): the power STFT as a matmul of the
windowed frames with a real-DFT basis (the JAX formulation, not
``torch.stft``, so CPU parity with JAX differs only by float
reassociation), the slaney mel filterbank and the Whisper-style log-mel.
Synthesis side (the vocoder): the "same"-padded ISTFT, whose overlap-add
keeps the JAX formulation — with hop | win the output is the sum of
R = win / hop statically shifted frame streams (a pad + add, no scatter);
the inverse FFT is ``torch.fft.irfft``; the MDCT and IMDCT of the Vocos
IMDCT heads are real matmuls. Resampling: the polyphase windowed-sinc
resampler in numpy on the host (prompt audio) and in torch on the input's
device (``resample_torch``, the codec training's 24 kHz target).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True,
                dtype=np.float32) -> np.ndarray:
    """Hann window; periodic=True matches torch.hann_window's default."""
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return w.astype(dtype)


@functools.lru_cache(maxsize=8)
def _rdft_basis(n_fft: int) -> np.ndarray:
    """Real-input DFT basis (n_fft, 2 * (n_fft // 2 + 1)): [cos | -sin], so
    frames @ basis == concat(Re(rfft(frames)), Im(rfft(frames)))."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def stft_magsq(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
               center: bool = True) -> torch.Tensor:
    """|STFT|^2 of ``x`` (..., T) -> (..., n_bins, num_frames), float32:
    the windowed frames (``unfold``, 1 + (T - n_fft) // hop of them) times
    the real-DFT basis. center=True pads n_fft // 2 on both sides by
    reflection (torch.stft's pad_mode='reflect')."""
    x = x.to(torch.float32)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        # reflect padding of the last dim takes a 2-D or 3-D input
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(lead + (x.shape[-1],))
    frames = x.unfold(-1, n_fft, hop) * window.to(torch.float32)
    basis = torch.as_tensor(_rdft_basis(n_fft), device=x.device)
    spec = frames @ basis
    n_bins = n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return (re * re + im * im).transpose(-1, -2)


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int,
                    min_frequency: float, max_frequency: float,
                    sampling_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank:
    (num_frequency_bins, num_mel_filters) float32, as
    transformers.audio_utils.mel_filter_bank(norm='slaney',
    mel_scale='slaney')."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2, num_frequency_bins)
    mel_min = _hz_to_mel_slaney(min_frequency)
    mel_max = _hz_to_mel_slaney(max_frequency)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]          # (bins, mel+2)
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))                   # (bins, mel)

    # slaney area normalization
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


def log_mel_spectrogram(waveform: torch.Tensor, n_fft: int = 400,
                        hop: int = 160, num_mels: int = 80,
                        sampling_rate: int = 16000) -> torch.Tensor:
    """Whisper-style log-mel of (B, n_samples) float32 -> (B, num_mels,
    n_samples // hop): power spectrogram with the last STFT frame dropped
    -> slaney mel -> clamp(1e-10) -> log10 -> per-sample floor at
    (max - 8) -> (x + 4) / 4. The max runs over the whole input, padding
    included, as the reference's fixed 30 s chunk does."""
    window = torch.as_tensor(hann_window(n_fft), device=waveform.device)
    mag2 = stft_magsq(waveform, n_fft, hop, window, center=True)[..., :-1]
    fb = torch.as_tensor(mel_filter_bank(n_fft // 2 + 1, num_mels, 0.0,
                                         sampling_rate / 2, sampling_rate),
                         device=waveform.device)
    mel = torch.einsum("bft,fm->bmt", mag2, fb)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


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


# ---------------------------------------------------------------------------
# MDCT / IMDCT (the Vocos IMDCT heads; reference modules.py:795-937)
# ---------------------------------------------------------------------------

def _cosine_window(M: int) -> np.ndarray:
    """scipy.signal.windows.cosine: w(n) = sin(pi (n + 0.5) / M)."""
    return np.sin(np.pi * (np.arange(M) + 0.5) / M).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _mdct_basis(frame_len: int) -> np.ndarray:
    """Real MDCT basis (frame_len, N): windowed frames @ basis == MDCT (the
    reference's twiddles and FFT folded into one real matmul)."""
    N = frame_len // 2
    n0 = (N + 1) / 2
    n = np.arange(frame_len)[:, None].astype(np.float64)
    k = np.arange(N)[None, :].astype(np.float64)
    pre = np.exp(-1j * np.pi * n / frame_len)
    post = np.exp(-1j * np.pi * n0 * (k + 0.5) / N)
    fourier = np.exp(-2j * np.pi * n * k / frame_len)
    basis = np.real(pre * fourier * post) * np.sqrt(1.0 / N) * np.sqrt(2)
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _imdct_basis(frame_len: int) -> np.ndarray:
    """Real IMDCT basis (N, frame_len): X @ basis == the windowless IMDCT
    frames (the mirrored spectrum [X, -flip(X)], the IFFT and both
    twiddles folded into one real matmul)."""
    N = frame_len // 2
    n0 = (N + 1) / 2
    k = np.arange(2 * N)[:, None].astype(np.float64)
    m = np.arange(2 * N)[None, :].astype(np.float64)
    pre = np.exp(1j * np.pi * n0 * k / N)
    post = np.exp(1j * np.pi * (m + n0) / (2 * N))
    fourier = np.exp(2j * np.pi * k * m / (2 * N)) / (2 * N)
    C = np.real(pre * fourier * post) * np.sqrt(N) * np.sqrt(2)
    D = C[:N] - C[N:][::-1]
    return D.astype(np.float32)


def _mdct_pad(frame_len: int, padding: str) -> int:
    if padding not in ("center", "same"):
        raise ValueError("padding must be 'center' or 'same'")
    return frame_len // 2 if padding == "center" else frame_len // 4


def mdct(audio: torch.Tensor, frame_len: int,
         padding: str = "same") -> torch.Tensor:
    """Modified DCT of (..., T) -> (..., L, frame_len // 2), in fp32: the
    cosine window, a lapped transform with hop frame_len // 2; "same" pads
    frame_len // 4 a side, "center" frame_len // 2."""
    pad = _mdct_pad(frame_len, padding)
    x = F.pad(audio.to(torch.float32), (pad, pad))
    window = torch.as_tensor(_cosine_window(frame_len), device=x.device)
    frames = x.unfold(-1, frame_len, frame_len // 2) * window
    return frames @ torch.as_tensor(_mdct_basis(frame_len), device=x.device)


def imdct(X: torch.Tensor, frame_len: int,
          padding: str = "same") -> torch.Tensor:
    """Inverse MDCT of (..., L, N) -> (..., L * N) ("same") or
    (..., (L - 1) * N) ("center"), in fp32: the mirrored-spectrum inverse,
    the cosine window and a hop-N overlap-add."""
    pad = _mdct_pad(frame_len, padding)
    N = frame_len // 2
    if X.shape[-1] != N:
        raise ValueError(f"expected {N} bins, got {X.shape[-1]}")
    y = X.to(torch.float32) @ torch.as_tensor(_imdct_basis(frame_len),
                                              device=X.device)
    y = y * torch.as_tensor(_cosine_window(frame_len), device=X.device)
    audio = overlap_add(y.transpose(-1, -2), N)         # (..., (L + 1) N)
    return audio[..., pad:audio.shape[-1] - pad]


# ---------------------------------------------------------------------------
# Resampling: numpy on the host (prompt audio), torch on the device
# (the codec training's target)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99):
    """Windowed-sinc polyphase kernel with torchaudio's semantics: the Hann
    window of torchaudio.functional.resample's default, sinc_interp_hann.

    Returns (kernel (new_freq_r, kernel_size), width, orig_freq_r,
    new_freq_r); width is the one-sided support in input samples after the
    gcd reduction."""
    g = math.gcd(orig_freq, new_freq)
    orig_freq_r, new_freq_r = orig_freq // g, new_freq // g
    base_freq = min(orig_freq_r, new_freq_r) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq_r / base_freq)
    idx = np.arange(-width, width + orig_freq_r, dtype=np.float64)[None, :] / orig_freq_r
    t = np.arange(0, -new_freq_r, -1, dtype=np.float64)[:, None] / new_freq_r + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq_r
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * win * scale
    return kernel.astype(np.float32), width, orig_freq_r, new_freq_r


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Polyphase sinc resampling of (..., T), numpy on the host (the
    prompt-audio path; ``utils/native.py`` holds the same in C++)."""
    if orig_freq == new_freq:
        return x
    kernel, width, of_r, nf_r = _resample_kernel(int(orig_freq), int(new_freq))
    length = x.shape[-1]
    lead = x.shape[:-1]
    xf = x.reshape((-1, length)).astype(np.float32)
    xf = np.pad(xf, [(0, 0), (width, width + of_r)])
    num_out_blocks = int(np.ceil(length / of_r))
    # polyphase blocks: each output block reads kernel_size input samples
    ksz = kernel.shape[1]
    idx = np.arange(num_out_blocks)[:, None] * of_r + np.arange(ksz)[None, :]
    frames = xf[:, idx]                                   # (N, blocks, ksz)
    out = np.einsum("nbk,pk->nbp", frames, kernel)        # (N, blocks, nf_r)
    out = out.reshape(xf.shape[0], -1)
    target_len = int(np.ceil(new_freq * length / orig_freq))
    out = out[:, :target_len]
    return out.reshape(lead + (target_len,))


def resample_torch(x: torch.Tensor, orig_freq: int,
                   new_freq: int) -> torch.Tensor:
    """``resample`` in torch on ``x``'s device, fp32: (..., T) ->
    (..., ceil(T * new / orig)); the codec train step's 24 kHz target."""
    if orig_freq == new_freq:
        return x
    kernel, width, of_r, _ = _resample_kernel(int(orig_freq), int(new_freq))
    length = x.shape[-1]
    lead = x.shape[:-1]
    xf = F.pad(x.reshape(-1, length).to(torch.float32),
               (width, width + of_r))
    num_out_blocks = -(-length // of_r)
    frames = xf.unfold(-1, kernel.shape[1], of_r)[:, :num_out_blocks]
    out = frames @ torch.as_tensor(kernel, device=x.device).T
    out = out.reshape(xf.shape[0], -1)
    target_len = -(-new_freq * length // orig_freq)
    return out[:, :target_len].reshape(lead + (target_len,))
