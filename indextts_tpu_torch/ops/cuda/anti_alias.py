"""Fused anti-aliased SnakeBeta activation: wrappers of the hand-written CUDA
kernels `csrc/anti_alias.cu` (K1, counterpart of the TPU kernel
indextts_tpu/ops/pallas/anti_alias.py::fused_anti_alias_activation) and
`csrc/anti_alias_backward.cu` (K1b, its backward), joined by an autograd
function.

K1 reads x once and writes y once; the 2x-rate signal stays in registers, a
thread's window of it shared with its neighbours by warp shuffles.  K1b
recomputes that signal from x the same way and writes grad_x and the
per-channel grad_alpha, grad_beta; its work split (`backward_plan`) is
chosen here and passed to it (design notes, and what bounds each, in the
sources).  The plain versions are `ops.filters.anti_aliased_activation`
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
    return _backward(x, alpha, beta, grad_y, logscale, None)


def _backward(x, alpha, beta, grad_y, logscale, plan):
    """`anti_alias_activation_backward`; a `plan` from `backward_plan`
    replaces the launch chosen for the card (checks of the work split) and
    must match x's shape and alignment."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return filters.anti_aliased_activation_backward(x, alpha, beta, grad_y, logscale)
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
    if alpha.dtype != torch.float32 or not alpha.is_contiguous():
        alpha = alpha.float().contiguous()
    if beta.dtype != torch.float32 or not beta.is_contiguous():
        beta = beta.float().contiguous()
    if alpha.shape != (C,) or beta.shape != (C,) or alpha.device != x.device:
        raise ValueError("alpha/beta must be [C] tensors on x's device")
    lib = _k1b_library()
    grad_x = torch.empty_like(x)
    vec = T % 4 == 0 and (x.data_ptr() | grad_y.data_ptr() | grad_x.data_ptr()) % 16 == 0
    dev = x.get_device()
    if plan is None:
        key = (B, C, T, vec, dev, bool(logscale))
        launch = _K1B_LAUNCHES.get(key)
        if launch is None:
            launch = _K1B_LAUNCHES[key] = _Launch.of(backward_plan(
                B, C, T, vec, lambda *variant: _resident(lib, dev, *variant),
                torch.cuda.get_device_properties(dev).multi_processor_count), logscale)
    else:
        want = backward_plan(B, C, T, plan["vec"], plan["blocks_per_sm"], plan["sms"],
                             steps=plan["steps"], layout=_K1B_LAYOUT)
        if plan["vec"] and not vec or any(plan[k] != want[k] for k in want if k != "vec"):
            raise ValueError(f"plan {plan} does not fit {tuple(x.shape)} (16-byte path: {vec})")
        launch = _Launch.of(plan, logscale)
    # grad_alpha, grad_beta and the kernel's per-(row, piece) partials in one buffer
    partials = 2 * launch.plan["partials"]
    out = x.new_empty(2 * C + partials)
    rc = lib.anti_alias_backward_launch(
        x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), grad_y.data_ptr(), grad_x.data_ptr(),
        out.data_ptr(), launch.address, torch._C._cuda_getCurrentRawStream(dev))
    _build.check(lib, rc, "anti_alias_backward_launch")
    anti_alias_activation_backward.launches += 1
    grad_alpha, grad_beta, _ = out.split_with_sizes([C, C, partials])
    return grad_x, grad_alpha, grad_beta


anti_alias_activation_backward.launches = 0

_K1B_LAUNCHES: dict = {}   # (B, C, T, vec, device, logscale) -> _Launch
_K1B_RESIDENT: dict = {}
_K1B_LIB = None
_K1B_LAYOUT = None         # the library's (columns a thread, threads a block)


class _Launch(ctypes.Structure):
    """One K1b call's shape and plan as the kernel library reads them
    (csrc/anti_alias_backward.cu::BackwardLaunch), built once per shape."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "C", "T", "logscale", "seg_lanes", "vec", "multi_row", "steps", "pieces",
        "segments", "blocks")] + [("taps", ctypes.c_float * 12)]

    @classmethod
    def of(cls, plan: dict, logscale: bool) -> "_Launch":
        launch = cls(plan["B"], plan["C"], plan["T"], int(logscale), plan["seg_lanes"],
                     int(plan["vec"]), int(plan["multi_row"]), plan["steps"], plan["pieces"],
                     plan["segments"], plan["blocks"], _TAPS)
        launch.plan = plan
        launch.address = ctypes.addressof(launch)
        return launch


def chosen_plan(B: int, C: int, T: int, vec: bool = True, device: int = 0,
                logscale: bool = True) -> dict | None:
    """The plan the K1b wrapper chose for such a call (it plans at a shape's
    first call on a device), or None before that call."""
    launch = _K1B_LAUNCHES.get((B, C, T, vec, device, logscale))
    return None if launch is None else launch.plan


def _k1b_library():
    """The kernel library and its K1b layout, read once.  Clearing
    `_K1B_LIB` and `_K1B_LAUNCHES` loads it again."""
    global _K1B_LIB, _K1B_LAYOUT
    if _K1B_LIB is None:
        lib = _build.load()
        out = (ctypes.c_longlong * 2)()
        lib.anti_alias_backward_layout(out)
        _K1B_LIB, _K1B_LAYOUT = lib, tuple(out)
    return _K1B_LIB


def _resident(lib, dev: int, seg_lanes: int, vec: bool, multi_row: bool) -> int:
    key = (id(lib), dev, seg_lanes, vec, multi_row)
    if key not in _K1B_RESIDENT:
        with torch.cuda.device(dev):
            n = lib.anti_alias_backward_resident(seg_lanes, int(vec), int(multi_row))
        if n <= 0:
            _build.check(lib, -n, "anti_alias_backward_resident")
            raise RuntimeError(f"K1b ({seg_lanes} lanes a segment) fits no block on an SM")
        _K1B_RESIDENT[key] = n
    return _K1B_RESIDENT[key]


def backward_plan(B: int, C: int, T: int, vec: bool, resident, sms: int,
                  steps: int | None = None, layout: tuple | None = None) -> dict:
    """K1b's launch for a [B, C, T] input (`vec`: the 16-byte path), on a
    card of `sms` SMs that holds `resident(seg_lanes, vec, multi_row)` blocks
    of that kernel variant per SM (or `resident` blocks, an int).  `layout`:
    the kernel's (columns a thread, threads a block), the library's unless
    given.

    A segment of `seg_lanes` lanes (8, 16 or 32: the fewest from 8 whose
    column slots span a row, else 32) covers `span` = columns x seg_lanes
    consecutive columns of a row a step.  Where a row is one such chunk
    (`multi_row`), a segment takes `steps` consecutive rows; else it takes
    `steps` consecutive chunks of one row (a piece; `pieces` a row).  Unless
    given, `steps` is the fewest that keep the grid within one wave of the
    card's resident segments (all of a row's chunks where none do): on the
    card, long-lived segments in one wave beat more, shorter waves at every
    stage shape of a training step, the first two included.  Each (row,
    piece) writes one of `partials` partials, index row x pieces + piece."""
    if layout is None:
        _k1b_library()
        layout = _K1B_LAYOUT
    cols, threads = layout
    rows = B * C
    lanes = 8
    while lanes < 32 and lanes * cols < T:
        lanes *= 2
    span = lanes * cols
    chunks = -(-T // span)
    multi_row = chunks == 1
    per_block = threads // lanes
    per_sm = resident(lanes, vec, multi_row) if callable(resident) else resident
    cap = max(1, sms * per_sm * per_block)
    units = rows if multi_row else chunks

    def segments(s):
        return -(-rows // s) if multi_row else rows * -(-chunks // s)

    if steps is None:
        steps = -(-rows // cap) if multi_row else 1
        while steps < units and segments(steps) > cap:
            steps += 1
    steps = max(1, min(steps, units))
    n_seg = segments(steps)
    pieces = 1 if multi_row else -(-chunks // steps)
    return {"seg_lanes": lanes, "vec": bool(vec), "multi_row": multi_row, "steps": steps,
            "pieces": pieces, "segments": n_seg, "blocks": -(-n_seg // per_block),
            "span": span, "chunks": chunks, "rows": rows, "B": B, "C": C, "T": T,
            "partials": rows * pieces, "sms": sms, "blocks_per_sm": per_sm,
            "layout": (cols, threads)}


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
