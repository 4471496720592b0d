"""Fused anti-aliased SnakeBeta activation: wrapper of the hand-written CUDA
kernel `csrc/anti_alias.cu` (counterpart of the TPU kernel
indextts_tpu/ops/pallas/anti_alias.py::fused_anti_alias_activation).

The kernel reads x once and writes y once; the 2x-rate signal stays in
registers, a thread's window of it shared with its neighbours by warp
shuffles (design notes, and what bounds it, in the source).  The plain version is `ops.filters.anti_aliased_activation`; this
wrapper takes it only for tensors on the CPU.  For a CUDA tensor it launches
the kernel or raises.
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
    alpha/beta [C].  Any T >= 1.  Math in fp32; returns x's type."""
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
