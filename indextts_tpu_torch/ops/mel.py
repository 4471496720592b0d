"""Log-mel front end (counterpart of indextts_tpu/ops/mel.py).

Matches torchaudio ``MelSpectrogram(sample_rate=24000, n_fft=1024,
hop_length=256, win_length=1024, power=1, center=True, n_mels=100)``
followed by ``safe_log`` = log(clamp(x, 1e-7)), the reference extractor
(indextts/utils/feature_extractors.py:26-68):

  * centered frames, reflect padding of n_fft//2 on both sides (or the
    caller's own padding with center=False);
  * periodic Hann window;
  * magnitude spectrum (power 1);
  * HTK mel filterbank without normalisation, built in numpy.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int = 24000, n_fft: int = 1024, n_mels: int = 100,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Triangular HTK filterbank [n_freqs, n_mels], no norm (torchaudio
    melscale_fbanks defaults)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded to n_fft when shorter."""
    n = np.arange(win_length, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """Reflect-pad n_fft//2 on both sides (center=True) and frame:
    [..., T] -> [..., F, n_fft].  With center=False the caller has padded
    already (the batched extractor reflect-pads each clip on the host, so a
    zero-padded batch tail never leaks into a clip's frames)."""
    if center:
        audio = reflect_pad(audio, n_fft // 2)
    return audio.unfold(-1, n_fft, hop_length)


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on both sides, as numpy's (and
    jnp.pad's) "reflect": a pad as long as the signal or longer reflects
    again off each end (the multiscale mel loss frames short training
    crops at n_fft up to 2048), where torch's own reflect pad refuses."""
    T = audio.shape[-1]
    if pad < T:
        lead = audio.shape[:-1]
        x = audio.reshape(-1, 1, T)
        return F.pad(x, (pad, pad), mode="reflect")[:, 0].reshape(*lead, -1)
    idx = np.pad(np.arange(T), (pad, pad), mode="reflect")
    return audio[..., torch.as_tensor(idx, device=audio.device)]


def spectrogram(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                win_length: int = 1024, power: float = 1.0,
                center: bool = True) -> torch.Tensor:
    """Magnitude (power=1) STFT: [..., T] -> [..., n_freqs, frames], fp32."""
    frames = frame_signal(audio.float(), n_fft, hop_length, center)   # [..., F, n_fft]
    window = torch.as_tensor(_hann_window(win_length, n_fft), device=frames.device)
    mag = torch.fft.rfft(frames * window, dim=-1).abs()               # [..., F, n_freqs]
    if power != 1.0:
        mag = mag ** power
    return mag.transpose(-1, -2)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
                    hop_length: int = 256, win_length: int = 1024, n_mels: int = 100,
                    mel_fmin: float = 0.0,
                    mel_fmax: Optional[float] = None) -> torch.Tensor:
    """Log-mel features: [..., T] -> [..., n_mels, frames]."""
    spec = spectrogram(audio, n_fft, hop_length, win_length)
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels, mel_fmin, mel_fmax),
                         device=spec.device)
    return safe_log(torch.einsum("...ft,fm->...mt", spec, fb))


class MelSpectrogramFeatures:
    """Object-style wrapper mirroring the reference class surface."""

    def __init__(self, sample_rate: int = 24000, n_fft: int = 1024, hop_length: int = 256,
                 win_length: Optional[int] = None, n_mels: int = 100,
                 mel_fmin: float = 0.0, mel_fmax: Optional[float] = None):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        self.n_mels = n_mels
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram(audio, self.sample_rate, self.n_fft, self.hop_length,
                               self.win_length, self.n_mels, self.mel_fmin,
                               self.mel_fmax)
