"""Kaiser-windowed sinc filters and anti-aliased resampling
(counterpart of indextts_tpu/ops/filters.py).

Behaviour of the reference alias-free-torch ops
(indextts/BigVGAN/alias_free_torch/filter.py:29-95, resample.py:10-48,
act.py:9-28): 2x upsample -> activation -> 2x downsample with 12-tap
kaiser-sinc low-pass filters and replicate padding.

`anti_aliased_activation` is the plain version of the hand-written CUDA
kernel in ops/cuda/anti_alias.py: it computes in fp32 whatever the input
type and returns the input type, as the kernel does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_beta(A: float) -> float:
    if A > 50.0:
        return 0.1102 * (A - 8.7)
    if A >= 21.0:
        return 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    return 0.0


def _kaiser_window(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window, as torch.kaiser_window(periodic=False)."""
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    return np.i0(beta * np.sqrt(1 - ((k - alpha) / alpha) ** 2)) / np.i0(beta)


@functools.lru_cache(maxsize=16)
def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Low-pass prototype, sum-normalised (filter.py:29-58). Shape [K]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    window = _kaiser_window(kernel_size, _kaiser_beta(A))
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _filter(x: torch.Tensor, kernel_size: int, gain: float = 1.0) -> torch.Tensor:
    f = kaiser_sinc_filter1d(0.25, 0.3, kernel_size)
    w = torch.as_tensor(gain * f, dtype=x.dtype, device=x.device)
    return w.view(1, 1, -1).expand(x.shape[1], 1, kernel_size)


def upsample2x(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """[B, C, T] -> [B, C, 2T] anti-aliased upsample (resample.py:10-33)."""
    ratio = 2
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = F.conv_transpose1d(x, _filter(x, kernel_size, ratio), stride=ratio,
                           groups=x.shape[1])
    return y[..., pad_left:-pad_right]


def downsample2x(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """[B, C, 2T] -> [B, C, T] anti-aliased downsample (resample.py:36-48)."""
    even = kernel_size % 2 == 0
    x = F.pad(x, (kernel_size // 2 - int(even), kernel_size // 2), mode="replicate")
    return F.conv1d(x, _filter(x, kernel_size), stride=2, groups=x.shape[1])


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               logscale: bool = True) -> torch.Tensor:
    """SnakeBeta: x + (1/b) sin^2(a x), per channel (activations.py:63-122).
    x: [B, C, T]; alpha/beta: [C]."""
    a = alpha.view(1, -1, 1)
    b = beta.view(1, -1, 1)
    if logscale:
        a = torch.exp(a)
        b = torch.exp(b)
    s = torch.sin(x * a)
    return x + (1.0 / (b + 1e-9)) * s * s


def anti_aliased_activation(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                            logscale: bool = True, kernel_size: int = 12) -> torch.Tensor:
    """Activation1d: upsample2x -> snakebeta -> downsample2x
    (alias_free_torch/act.py:9-28), in fp32, returned in x's type."""
    y = upsample2x(x.float(), kernel_size)
    y = snake_beta(y, alpha.float(), beta.float(), logscale)
    return downsample2x(y, kernel_size).to(x.dtype)
