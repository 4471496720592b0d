"""Fused anti-aliased SnakeBeta activation: wrappers of the hand-written CUDA
kernels `csrc/anti_alias.cu` (K1, counterpart of the TPU kernel
indextts_tpu/ops/pallas/anti_alias.py::fused_anti_alias_activation) and
`csrc/anti_alias_backward.cu` (K1b, its backward), joined by an autograd
function.

K1 reads x once and writes y once; the 2x-rate signal stays in registers, a
thread's window of it shared with its neighbours by warp shuffles.  K1b
recomputes that signal from x in shared memory and writes grad_x and the
per-channel grad_alpha, grad_beta (design notes, and what bounds each, in
the sources).  The plain versions are `ops.filters.anti_aliased_activation`
and `ops.filters.anti_aliased_activation_backward`; the wrappers take them
only for tensors on the CPU.  For a CUDA tensor they launch the kernel or
raise.

Where a gradient is needed, `fused_anti_alias_activation` runs K1 inside
the autograd function, which keeps x, alpha and beta (not the 2x-rate
signal) for K1b; otherwise it launches K1 alone and keeps nothing.
"""

from __future__ import annotations

import ctypes

import torch

from indextts_tpu_torch.ops import filters
from indextts_tpu_torch.ops.cuda import _build

_TAPS = (ctypes.c_float * 12)(*filters.kaiser_sinc_filter1d(0.25, 0.3, 12).tolist())


def fused_anti_alias_activation(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                logscale: bool = True) -> torch.Tensor:
    """down2(snakebeta(up2(x))) for x [B, C, T] (bf16 or fp32, contiguous),
    alpha/beta [C].  Any T >= 1.  Math in fp32; returns x's type.
    Differentiable in x, alpha and beta (the backward K1b takes fp32 only)."""
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                    or beta.requires_grad):
        return _Activation.apply(x, alpha, beta, logscale)
    return _forward(x, alpha, beta, logscale)


def _forward(x, alpha, beta, logscale):
    if x.device.type == "cpu":
        return filters.anti_aliased_activation(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_anti_alias_activation: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"expected a [B, C, T] bf16/fp32 tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_anti_alias_activation needs a contiguous x")
    B, C, T = x.shape
    if B == 0 or T == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    alpha = alpha.to(x.dtype).contiguous()
    beta = beta.to(x.dtype).contiguous()
    if alpha.shape != (C,) or beta.shape != (C,) or alpha.device != x.device:
        raise ValueError("alpha/beta must be [C] tensors on x's device")
    y = torch.empty_like(x)
    lib = _build.load()
    rc = lib.anti_alias_activation(
        x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), y.data_ptr(), B, C, T,
        int(x.dtype == torch.bfloat16), int(logscale), _TAPS,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "anti_alias_activation")
    fused_anti_alias_activation.launches += 1
    return y


fused_anti_alias_activation.launches = 0


class _Activation(torch.autograd.Function):
    """K1 forward, K1b backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, alpha, beta, logscale):
        ctx.save_for_backward(x, alpha, beta)
        ctx.logscale = logscale
        return _forward(x, alpha, beta, logscale)

    @staticmethod
    def backward(ctx, grad_y):
        x, alpha, beta = ctx.saved_tensors
        gx, ga, gb = anti_alias_activation_backward(x, alpha, beta, grad_y.contiguous(),
                                                    ctx.logscale)
        return gx, ga.to(alpha.dtype), gb.to(beta.dtype), None


def anti_alias_activation_backward(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                   grad_y: torch.Tensor, logscale: bool = True):
    """The gradient of `fused_anti_alias_activation` for x, grad_y [B, C, T]
    and alpha, beta [C]: (grad_x [B, C, T], grad_alpha [C], grad_beta [C]).
    On a CUDA tensor, fp32 only (K1b); two calls give bit-equal results."""
    if x.device.type == "cpu":
        return filters.anti_aliased_activation_backward(x, alpha, beta, grad_y, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"anti_alias_activation_backward: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or grad_y.dtype != torch.float32:
        raise ValueError(f"anti_alias_activation_backward takes fp32 [B, C, T] x and grad_y, "
                         f"got {tuple(x.shape)} {x.dtype} and {grad_y.dtype}")
    if grad_y.shape != x.shape or grad_y.device != x.device:
        raise ValueError(f"grad_y {tuple(grad_y.shape)} on {grad_y.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and grad_y.is_contiguous()):
        raise ValueError("anti_alias_activation_backward needs contiguous x and grad_y")
    B, C, T = x.shape
    if B == 0 or T == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    alpha = alpha.float().contiguous()
    beta = beta.float().contiguous()
    if alpha.shape != (C,) or beta.shape != (C,) or alpha.device != x.device:
        raise ValueError("alpha/beta must be [C] tensors on x's device")
    lib = _build.load()
    grad_x = torch.empty_like(x)
    grad_alpha = torch.empty(C, dtype=torch.float32, device=x.device)
    grad_beta = torch.empty(C, dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.anti_alias_backward_scratch_floats(B, C, T),
                          dtype=torch.float32, device=x.device)
    rc = lib.anti_alias_activation_backward(
        x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), grad_y.data_ptr(), grad_x.data_ptr(),
        grad_alpha.data_ptr(), grad_beta.data_ptr(), scratch.data_ptr(), B, C, T,
        int(logscale), _TAPS, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "anti_alias_activation_backward")
    anti_alias_activation_backward.launches += 1
    return grad_x, grad_alpha, grad_beta


anti_alias_activation_backward.launches = 0

_PLAN_KEYS = ("vec16", "outputs_per_thread", "threads", "block_step", "steps", "blocks")


def plan(B: int, C: int, T: int, dtype: torch.dtype, aligned: bool = True) -> dict:
    """The launch the kernel makes for a [B, C, T] input of `dtype` on the
    current card (rows 16-byte aligned when `aligned`): whether it takes the
    16-byte path, the outputs per thread, the threads per block, the outputs
    a block covers per step, the steps per block and the blocks.  A block
    covers `block_step * steps` consecutive outputs of one row."""
    lib = _build.load()
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    rc = lib.anti_alias_plan(B, C, T, int(dtype == torch.bfloat16), int(aligned), out)
    _build.check(lib, rc, "anti_alias_plan")
    return dict(zip(_PLAN_KEYS, out))
