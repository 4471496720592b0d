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


# The 12-tap 2x up and down filters on their replicate padding in polyphase
# form, as the CUDA kernels compute them (csrc/anti_alias.cu):
#   u_e[n] = 2 sum_j f[2j] xc[n+j-3],  u_o[n] = 2 sum_j f[2j+1] xc[n+j-2]
#   y[t] = sum_k f[k] A[clamp(2t+k-5, 0, 2T-1)],  A[2n] = snake(u_e[n]), A[2n+1] = snake(u_o[n])
# with xc[m] = x[clamp(m, 0, T-1)].


def anti_aliased_activation_backward(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                     grad_y: torch.Tensor, logscale: bool = True):
    """The gradient of `anti_aliased_activation` written out, the plain
    version of the CUDA kernel csrc/anti_alias_backward.cu: for x and
    grad_y [B, C, T] and alpha, beta [C], returns (grad_x [B, C, T] in x's
    type, grad_alpha [C], grad_beta [C] in fp32, or all in fp64 for fp64
    inputs).  The 2x-rate signal is recomputed from x; math in fp32 (fp64
    for fp64 inputs, which gradcheck takes).

    Down^T takes g to the 2x-rate grid (the downsampler's replicate padding
    transposed: the taps that read A below 0 or above 2T-1 accumulate into
    A[0] and A[2T-1]); the snake's derivative gives gu = ga (1 + (a/b')
    sin(2 a u)); Up^T takes gu back to x (the upsampler's clamped columns
    accumulate into x[0] and x[T-1]).  grad_alpha and grad_beta sum
    ga (u/b') sin(2 a u) and -ga sin^2(a u) / b'^2 over B and the 2x-rate
    grid, times a and b under `logscale` (b' = b + 1e-9)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, g = x.to(dt), grad_y.to(dt)
    f = torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, 12), dtype=dt, device=xf.device)
    T = xf.shape[-1]
    a = alpha.to(dt).view(1, -1, 1)
    b = beta.to(dt).view(1, -1, 1)
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    inv_b = 1.0 / (b + 1e-9)

    # Down^T: ga_e[n] = sum_j f[2j+1] g[n+2-j], ga_o[n] = sum_j f[2j] g[n+3-j]
    gz = F.pad(g, (3, 3))                                   # gz[i] = g[i-3], zero outside
    ga_e = sum(f[2 * j + 1] * gz[..., 5 - j:5 - j + T] for j in range(6))
    ga_o = sum(f[2 * j] * gz[..., 6 - j:6 - j + T] for j in range(6))
    ga_e, ga_o = ga_e.clone(), ga_o.clone()
    for s in range(min(3, T)):
        # output t = s reads A below 0 at taps k < 5 - 2s; t = T-1-s above 2T-1 at k > 6 + 2s
        ga_e[..., 0] += f[:5 - 2 * s].sum() * g[..., s]
        ga_o[..., T - 1] += f[7 + 2 * s:].sum() * g[..., T - 1 - s]

    # u recomputed: xr[i] = x[clamp(i-3, 0, T-1)]
    xr = F.pad(xf, (3, 3), mode="replicate")
    u_e = sum(2 * f[2 * j] * xr[..., j:j + T] for j in range(6))
    u_o = sum(2 * f[2 * j + 1] * xr[..., j + 1:j + 1 + T] for j in range(6))

    grad_a = torch.zeros_like(a.view(-1))
    grad_b = torch.zeros_like(b.view(-1))
    gu = []
    for ga, u in ((ga_e, u_e), (ga_o, u_o)):
        s = torch.sin(a * u)
        sin2 = torch.sin(2 * a * u)
        gu.append(ga * (1 + a * inv_b * sin2))
        grad_a = grad_a + (ga * u * inv_b * sin2).sum(dim=(0, 2))
        grad_b = grad_b + (ga * -(s * s) * inv_b * inv_b).sum(dim=(0, 2))
    gu_e, gu_o = gu
    if logscale:
        grad_a = grad_a * a.view(-1)
        grad_b = grad_b * b.view(-1)

    # Up^T: grad_xr[i] = sum_j 2 f[2j] gu_e[i-j] + 2 f[2j+1] gu_o[i-j-1], i in [0, T+6)
    gez = F.pad(gu_e, (5, 6))                               # gez[q] = gu_e[q-5]
    goz = F.pad(gu_o, (6, 5))                               # goz[q] = gu_o[q-6]
    grad_xr = sum(2 * f[2 * j] * gez[..., 5 - j:5 - j + T + 6]
                  + 2 * f[2 * j + 1] * goz[..., 5 - j:5 - j + T + 6] for j in range(6))
    grad_x = grad_xr[..., 3:3 + T].clone()
    grad_x[..., 0] += grad_xr[..., :3].sum(-1)
    grad_x[..., T - 1] += grad_xr[..., 3 + T:].sum(-1)
    return grad_x.to(x.dtype), grad_a, grad_b
