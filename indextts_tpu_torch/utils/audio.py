"""Audio I/O and resampling without torchaudio/soundfile.

Replaces the reference's soundfile + torchaudio.transforms.Resample usage
(indextts/infer.py:606-612, indextts/utils/common.py:11-36).  WAV read/write
goes through scipy; resampling is a windowed-sinc polyphase resampler with
the same design as torchaudio's ``sinc_interp_hann`` kernel
(lowpass_filter_width=6, rolloff=0.99), computed in numpy on the host —
audio ingest is not a device-side hot path.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1] shaped (C, T), sr)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    else:
        audio = audio.T  # (C, T)
    return audio, int(sr)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write int16 PCM WAV (reference writes PCM_16, infer.py:771-772)."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = audio.squeeze()
    if audio.dtype != np.int16:
        audio = np.clip(audio, -32767.0, 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, audio)


def wav_stream_header(sample_rate: int, channels: int = 1,
                      bits: int = 16) -> bytes:
    """RIFF/WAVE header for a stream of unknown length (sizes set to the
    0xFFFFFFFF convention players treat as 'read until EOF') — prepend to
    int16 PCM chunks for chunked-transfer streaming."""
    import struct

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


def to_mono(audio: np.ndarray) -> np.ndarray:
    """(C, T) -> (T,) by channel mean (reference: infer.py:608)."""
    if audio.ndim == 2:
        return audio.mean(axis=0)
    return audio


def _sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    """Polyphase windowed-sinc kernel, shape (new_freq, width*2 + orig_freq)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64) / new_freq)[:, None] + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel *= window * scale
    return kernel.astype(np.float32), width


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Resample the last axis of `audio` from orig_sr to new_sr."""
    if orig_sr == new_sr:
        return np.asarray(audio, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    orig_freq, new_freq = orig_sr // g, new_sr // g
    kernel, width = _sinc_resample_kernel(orig_freq, new_freq)

    x = np.asarray(audio, dtype=np.float32)
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    length = x.shape[-1]
    x = np.pad(x, ((0, 0), (width, width + orig_freq)))
    target_len = int(math.ceil(new_freq * length / orig_freq))

    # Strided polyphase convolution: for each output phase p, output sample n
    # is dot(kernel[p], x[n*orig_freq : n*orig_freq + K]).
    K = kernel.shape[1]
    n_blocks = (x.shape[-1] - K) // orig_freq + 1
    idx = np.arange(n_blocks)[:, None] * orig_freq + np.arange(K)[None, :]
    frames = x[:, idx]  # (B, n_blocks, K)
    out = np.einsum("bnk,pk->bpn", frames, kernel)  # (B, new_freq, n_blocks)
    out = out.transpose(0, 2, 1).reshape(x.shape[0], -1)[:, :target_len]
    return out.reshape(shape[:-1] + (target_len,))


def load_audio(path: str, sample_rate: int) -> np.ndarray:
    """Load, downmix and resample (reference: indextts/utils/common.py:11-36).
    Returns (1, T) float32 clipped to [-1, 1]."""
    audio, sr = read_wav(path)
    if audio.shape[0] > 1:
        audio = audio[:1]
    if sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
    return np.clip(audio, -1.0, 1.0)


def load_prompt_audio(path: str, sample_rate: int = 24000) -> np.ndarray:
    """Prompt ingestion used by the serving engine (reference:
    infer.py:606-611): mono by channel-mean, then resample. (1, T)."""
    audio, sr = read_wav(path)
    mono = to_mono(audio)[None, :]
    if sr != sample_rate:
        mono = resample(mono, sr, sample_rate)
    return mono.astype(np.float32)
