"""BigVGAN's training-side discriminators and GAN losses (counterpart of
indextts_tpu/models/discriminators.py).

The reference classes (indextts/BigVGAN/models.py:280-453) as functions over
parameter trees: the multi-period discriminator (periods 2/3/5/7/11), the
multi-resolution discriminator over |STFT| (resolutions config.yaml:118),
and the feature, discriminator and generator losses, with the multiscale
log-mel L1 of the recipe.  Each sub-discriminator's tree keeps its
structural int (`period`, or the `resolution` triple) beside its weights, as
in JAX; train/vocoder.py splits them off before differentiating.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops import mel as mel_ops

LRELU_SLOPE = 0.1


def _conv2d(x, p, stride=(1, 1), padding=(0, 0)):
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _leaky(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def _conv_p(generator, cin, cout, kh, kw, dtype, device):
    w = torch.randn((cout, cin, kh, kw), generator=generator, device=device)
    return {"w": (w / math.sqrt(cin * kh * kw)).to(dtype),
            "b": torch.zeros(cout, dtype=dtype, device=device)}


def init_period_discriminator(generator: torch.Generator, period: int, d_mult: int = 1,
                              dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """DiscriminatorP (models.py:280-314): 5 strided (k, 1) conv2d stages."""
    chans = [1, 32 * d_mult, 128 * d_mult, 512 * d_mult, 1024 * d_mult, 1024 * d_mult]
    return {
        "period": period,
        "convs": [_conv_p(generator, chans[i], chans[i + 1], 5, 1, dtype, device)
                  for i in range(5)],
        "conv_post": _conv_p(generator, chans[5], 1, 3, 1, dtype, device),
    }


def period_discriminator_forward(params: Dict[str, Any], x: torch.Tensor
                                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: [B, 1, T] -> (score [B, *], feature maps)."""
    period = params["period"]
    B, C, T = x.shape
    if T % period != 0:
        pad = period - T % period
        x = F.pad(x, (0, pad), mode="reflect")
        T = T + pad
    x = x.reshape(B, C, T // period, period)
    fmap = []
    for i, conv in enumerate(params["convs"]):
        x = _leaky(_conv2d(x, conv, (3, 1) if i < 4 else (1, 1), (2, 0)))
        fmap.append(x)
    x = _conv2d(x, params["conv_post"], (1, 1), (1, 0))
    fmap.append(x)
    return x.reshape(B, -1), fmap


def init_resolution_discriminator(generator: torch.Generator, resolution: Sequence[int],
                                  channels: int = 32, dtype=torch.float32,
                                  device="cpu") -> Dict[str, Any]:
    """DiscriminatorR over |STFT| (models.py:341-391): 32 channels
    (config.yaml:121 d_mult=1), (3, 9) convs then (3, 3)."""
    return {
        "resolution": tuple(resolution),   # (n_fft, hop, win)
        "convs": [_conv_p(generator, 1, channels, 3, 9, dtype, device)]
                 + [_conv_p(generator, channels, channels, 3, 9, dtype, device)
                    for _ in range(3)]
                 + [_conv_p(generator, channels, channels, 3, 3, dtype, device)],
        "conv_post": _conv_p(generator, channels, 1, 3, 3, dtype, device),
    }


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """x: [B, T] -> magnitude [B, F, frames]: the reference's torch.stft with
    window=None, i.e. a rectangular ones(win) window zero-padded to n_fft
    and centred, over frames of a (n_fft - hop) // 2 reflect pad."""
    pad = (n_fft - hop) // 2
    if x.shape[-1] <= pad:
        # reflect needs pad < T: short inputs are zero-extended first
        x = F.pad(x, (0, pad + 1 - x.shape[-1]))
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    if x.shape[-1] < n_fft:
        # at least one frame (else the score is a mean over an empty axis)
        x = F.pad(x, (0, n_fft - x.shape[-1]))
    frames = mel_ops.frame_signal(x, n_fft, hop, center=False)     # [B, frames, n_fft]
    window = torch.zeros(n_fft, dtype=frames.dtype, device=frames.device)
    lpad = (n_fft - win) // 2 if win < n_fft else 0
    window[lpad:lpad + min(win, n_fft)] = 1.0
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.abs().transpose(-1, -2)


def resolution_discriminator_forward(params: Dict[str, Any], x: torch.Tensor
                                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: [B, 1, T] -> (score [B, *], feature maps)."""
    n_fft, hop, win = params["resolution"]
    h = _stft_mag(x[:, 0, :], n_fft, hop, win)[:, None]     # [B, 1, F, frames]
    fmap = []
    strides = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
    pads = [(1, 4)] * 4 + [(1, 1)]
    for conv, s, p in zip(params["convs"], strides, pads):
        h = _leaky(_conv2d(h, conv, s, p))
        fmap.append(h)
    h = _conv2d(h, params["conv_post"], (1, 1), (1, 1))
    fmap.append(h)
    return h.reshape(h.shape[0], -1), fmap


def init_discriminators(generator: torch.Generator, periods=(2, 3, 5, 7, 11),
                        resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)),
                        dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    return {
        "mpd": [init_period_discriminator(generator, p, dtype=dtype, device=device)
                for p in periods],
        "mrd": [init_resolution_discriminator(generator, r, dtype=dtype, device=device)
                for r in resolutions],
    }


def discriminators_forward(params: Dict[str, Any], wav: torch.Tensor):
    """wav [B, 1, T] -> (scores, fmaps) over every sub-discriminator."""
    scores, fmaps = [], []
    for p in params["mpd"]:
        s, f = period_discriminator_forward(p, wav)
        scores.append(s)
        fmaps.append(f)
    for p in params["mrd"]:
        s, f = resolution_discriminator_forward(p, wav)
        scores.append(s)
        fmaps.append(f)
    return scores, fmaps


# --- losses (models.py:422-453) -------------------------------------------

def feature_loss(fmap_real, fmap_gen) -> torch.Tensor:
    loss = 0.0
    for fr, fg in zip(fmap_real, fmap_gen):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(real_scores, gen_scores) -> torch.Tensor:
    loss = 0.0
    for r, g in zip(real_scores, gen_scores):
        loss = loss + torch.mean(torch.square(1.0 - r)) + torch.mean(torch.square(g))
    return loss


def generator_loss(gen_scores) -> torch.Tensor:
    loss = 0.0
    for g in gen_scores:
        loss = loss + torch.mean(torch.square(1.0 - g))
    return loss


def multiscale_mel_loss(real: torch.Tensor, gen: torch.Tensor, sample_rate: int = 24000,
                        scales=((512, 128), (1024, 256), (2048, 512))) -> torch.Tensor:
    """Multi-scale log-mel L1 (use_multiscale_melloss, config.yaml:125-126):
    80 mels at each (n_fft, hop), window n_fft."""
    loss = 0.0
    for n_fft, hop in scales:
        mr = mel_ops.mel_spectrogram(real, sample_rate, n_fft, hop, n_fft, 80)
        mg = mel_ops.mel_spectrogram(gen, sample_rate, n_fft, hop, n_fft, 80)
        loss = loss + torch.mean(torch.abs(mr - mg))
    return loss / len(scales)
