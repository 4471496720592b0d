"""Metrics that judge a fine-tune (counterpart of
indextts_tpu/utils/eval_metrics.py).

Speaker similarity is the cosine of ECAPA-TDNN speaker embeddings (the
encoder BigVGAN conditions on) of two waveforms, e.g. the prompt and the
synthesized audio.  WER and CER are plain text metrics, for transcripts
from any ASR front end (none ships with the package).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from indextts_tpu_torch.models import ecapa
from indextts_tpu_torch.ops.mel import mel_spectrogram


def speaker_embedding(bigvgan_params: Dict[str, Any], wav: np.ndarray,
                      sample_rate: int = 24000) -> np.ndarray:
    """wav [T] float32 (or [C, T], mixed to mono) -> ECAPA embedding [D],
    computed on the device and in the type of the encoder's weights.  The sizes
    (n_mels among them) are read from the weights."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    spk = bigvgan_params.get("speaker_encoder", bigvgan_params)
    w0 = spk["blocks"][0]["conv"]["w"]
    ch0, n_mels = w0.shape[0], w0.shape[1]
    size = ecapa.ECAPASize(input_size=n_mels, lin_neurons=spk["fc"]["w"].shape[0],
                           channels=(ch0, ch0, ch0, ch0, spk["mfa"]["conv"]["w"].shape[0]),
                           attention_channels=spk["asp"]["tdnn"]["conv"]["w"].shape[0],
                           se_channels=spk["blocks"][1]["se"]["conv1"]["w"].shape[0])
    with torch.no_grad():
        audio = torch.from_numpy(wav)[None].to(w0.device)
        mel = mel_spectrogram(audio, sample_rate=sample_rate, n_mels=n_mels)  # [1, n_mels, T']
        emb = ecapa.forward(spk, mel.transpose(1, 2).to(w0.dtype), size)
    return emb[0, 0].float().cpu().numpy()


def speaker_similarity(bigvgan_params: Dict[str, Any], wav_a: np.ndarray,
                       wav_b: np.ndarray, sample_rate: int = 24000) -> float:
    """Cosine similarity of the speaker embeddings of two waveforms."""
    ea = speaker_embedding(bigvgan_params, wav_a, sample_rate)
    eb = speaker_embedding(bigvgan_params, wav_b, sample_rate)
    denom = np.linalg.norm(ea) * np.linalg.norm(eb)
    return float(np.dot(ea, eb) / max(denom, 1e-12))


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (dynamic programming, O(len * len))."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate over whitespace tokens."""
    ref, hyp = reference.split(), hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate over non-space characters (the CJK metric)."""
    ref = [c for c in reference if not c.isspace()]
    hyp = [c for c in hypothesis if not c.isspace()]
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)
