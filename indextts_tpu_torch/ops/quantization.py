"""Weight-only quantization tiers, int8 and packed int4 (counterpart of
indextts_tpu/ops/quantization.py).

The GPT trunk and the text/mel head matrices are quantized per output
channel (reference infer.py:50-182, 317-353).  The leaf forms are the JAX
package's, so trees cross between the packages unchanged:

* int8: ``{"q": int8 [.., K, N], "s": fp32 [.., 1, N]}``;
* int4, fused layout: ``{"q4": int8 [.., K/2, N], "s": fp32 [.., 2G, N]}``.
  K splits into G contiguous chunks; within a chunk, byte row j holds row j
  in its low nibble and row j + chunk/2 in its high nibble, and each
  (chunk, half) has its own scale row 2g + half.  The single-row decode
  kernel (K2) reads this layout, with G = MLP_PROJ_GROUPS for mlp.proj_w;
* int4, shared layout: ``{"q4s": int8 [.., K/2, N], "s": fp32 [.., 1, N]}``,
  rows [0, K/2) in the low nibbles and [K/2, K) in the high ones under one
  scale.  Batched and beam decode read it after `nativize_int4`.

Every product accumulates x @ q in fp32 and then scales the output
((x @ q) * s == x @ (q * s) for per-output-channel scales), as the JAX
package does.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

# K-chunk count of the TPU decode kernel's MLP down-projection stream; the
# int4 packing of mlp.proj_w groups by it, and the port keeps the layout
MLP_PROJ_GROUPS = 4


def quantize_int(w: torch.Tensor, bits: int = 8,
                 reduce_axes: Sequence[int] = (-2,)) -> Dict[str, torch.Tensor]:
    """Symmetric quantization with per-channel scales; `reduce_axes` are the
    contraction dims (absorbed into the scale)."""
    qmax = 2 ** (bits - 1) - 1
    w32 = w.float()
    dims = tuple(a % w.ndim for a in reduce_axes)
    amax = w32.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp_min(1e-12) / qmax
    q = torch.clamp(torch.round(w32 / scale), -qmax - 1, qmax)
    return {"q": q.to(torch.int8), "s": scale}


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 tensors in [-8, 7] -> one int8 byte each: lo | hi << 4."""
    return ((lo.to(torch.int32) & 0x0F) | (hi.to(torch.int32) << 4)).to(torch.int8)


def quantize_int4_packed(w: torch.Tensor, k_axis: int = -2,
                         groups: int = 1) -> Dict[str, torch.Tensor]:
    """Pack w [.., K, N] into {"q4": [.., K/2, N], "s": [.., 2*groups, N]}."""
    if k_axis % w.ndim != w.ndim - 2:
        raise ValueError("pack along the contraction (second-minor) axis")
    K, N = w.shape[-2], w.shape[-1]
    if K % (2 * groups):
        raise ValueError(f"K={K} does not split into {groups} groups of two halves")
    chunk = K // groups
    half = chunk // 2
    lead = tuple(w.shape[:-2])
    wg = w.float().reshape(lead + (groups, 2, half, N))    # (g, half, j) row order
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-12) / 7.0                     # [.., G, 2, 1, N]
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
    packed = _pack_nibbles(q[..., :, 0, :, :], q[..., :, 1, :, :])   # [.., G, half, N]
    return {"q4": packed.reshape(lead + (K // 2, N)),
            "s": scale[..., 0, :].reshape(lead + (2 * groups, N))}


def quantize_int4_shared(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Pack w [.., K, N] into {"q4s": int8 [.., K/2, N], "s": [.., 1, N]}:
    one scale per output channel over the whole K."""
    K = w.shape[-2]
    if K % 2:
        raise ValueError(f"K={K} is odd")
    w32 = w.float()
    scale = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 7.0
    q = torch.clamp(torch.round(w32 / scale), -8, 7).to(torch.int8)
    return {"q4s": _pack_nibbles(q[..., : K // 2, :], q[..., K // 2:, :]), "s": scale}


def unpack_int4(q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., K/2, N] packed -> (lo, hi) int8 halves in [-8, 7], no reorder:
    each nibble sign-extended by two shifts."""
    q32 = q4.to(torch.int32)
    lo = (q32 << 28) >> 28
    hi = (q32 << 24) >> 28
    return lo.to(torch.int8), hi.to(torch.int8)


def nativize_int4(tree):
    """Every {"q4s", "s"} leaf-dict becomes {"q4n": int8 [.., K, N] holding
    [-8, 7], "s"}.  torch has no int4 operand, so the port unpacks once per
    decode call to int8: the same numbers, with the unpack hoisted out of the
    loop as the JAX function hoists it out of its program's loop."""
    if isinstance(tree, dict):
        if "q4s" in tree:
            lo, hi = unpack_int4(tree["q4s"])
            return {"q4n": torch.cat([lo, hi], dim=-2), "s": tree["s"]}
        return {k: nativize_int4(v) for k, v in tree.items()}
    return tree


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] as an fp32 tensor, with the operands in x's type
    (integer grids are exact in bf16 and fp32).  torch sums in fp32 and
    rounds the product to x's type: in bf16 that is one rounding more than
    the JAX package's fp32 result before the scale."""
    return (x @ w.to(x.dtype)).float()


def matmul_quant(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, N] for every weight form the package ships: a plain
    tensor, int8 {"q", "s"}, fused int4 {"q4", "s"}, shared int4 {"q4s", "s"}
    or its unpacked form {"q4n", "s"}.  Returns x's type."""
    if not isinstance(w, dict):
        return x @ w.to(x.dtype)
    s = w["s"].float()
    if "q4n" in w:
        return (_dot(x, w["q4n"]) * s).to(x.dtype)
    if "q4s" in w:
        lo, hi = unpack_int4(w["q4s"])
        return (_dot(x, torch.cat([lo, hi], dim=-2)) * s).to(x.dtype)
    if "q4" in w:
        Kh, N = w["q4"].shape
        G = w["s"].shape[0] // 2
        half = Kh // G
        lo, hi = unpack_int4(w["q4"])                       # [Kh, N], rows (g, j)
        lo, hi = lo.reshape(G, half, N), hi.reshape(G, half, N)
        xg = x.reshape(x.shape[:-1] + (G, 2, half))         # rows (g, half, j)
        s = s.reshape(G, 2, N)
        y = 0.0
        for g in range(G):
            y = y + _dot(xg[..., g, 0, :], lo[g]) * s[g, 0]
            y = y + _dot(xg[..., g, 1, :], hi[g]) * s[g, 1]
        return y.to(x.dtype)
    return (_dot(x, w["q"]) * s).to(x.dtype)


def dequantize(qw: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """The float matrix a quantized leaf stands for, in `dtype`."""
    s = qw["s"].float()
    if "q4n" in qw:
        return (qw["q4n"].float() * s).to(dtype)
    if "q4s" in qw:
        lo, hi = unpack_int4(qw["q4s"])
        return (torch.cat([lo, hi], dim=-2).float() * s).to(dtype)
    if "q4" in qw:
        lo, hi = unpack_int4(qw["q4"])
        Kh, N = qw["q4"].shape[-2], qw["q4"].shape[-1]
        lead = tuple(qw["q4"].shape[:-2])
        G = qw["s"].shape[-2] // 2
        half = Kh // G
        w = torch.stack([lo.reshape(lead + (G, half, N)), hi.reshape(lead + (G, half, N))],
                        dim=-3)
        return (w.float() * s.reshape(lead + (G, 2, 1, N))).reshape(
            lead + (2 * Kh, N)).to(dtype)
    return (qw["q"].float() * s).to(dtype)


def quantize_gpt_params(params: Dict[str, Any], bits: int = 8,
                        int4_layout: str = "fused") -> Dict[str, Any]:
    """Quantize the trunk and head matrices (the reference quantizes the
    `gpt`, `text_head` and `mel_head` Linears, infer.py:324-330).  Trunk
    weights [L, K, N] get int8 scales [L, 1, N] or int4 scales [L, 2G, N];
    heads [K, N] get [1, N] or [2, N].  `int4_layout` (bits=4): "fused" for
    the single-row kernel, "shared" for batched and beam decode.  Returns a
    new tree; the leaves not quantized are shared with `params`."""
    if int4_layout not in ("fused", "shared"):
        raise ValueError(f"unknown int4 layout {int4_layout!r}")
    shared = bits == 4 and int4_layout == "shared"

    def quant(w, groups):
        if shared:
            return quantize_int4_shared(w)
        if bits == 4:
            return quantize_int4_packed(w, groups=groups)
        return quantize_int(w, bits)

    out = dict(params)
    blocks = dict(params["gpt"]["blocks"])
    attn = dict(blocks["attn"])
    mlp = dict(blocks["mlp"])
    attn["qkv_w"] = quant(attn["qkv_w"], 1)
    attn["proj_w"] = quant(attn["proj_w"], 1)
    mlp["fc_w"] = quant(mlp["fc_w"], 1)
    mlp["proj_w"] = quant(mlp["proj_w"], MLP_PROJ_GROUPS)
    out["gpt"] = {**params["gpt"], "blocks": {**blocks, "attn": attn, "mlp": mlp}}
    for head in ("text_head", "mel_head"):
        if head in out:
            out[head] = {**out[head], "kernel": quant(out[head]["kernel"], 1)}
    return out
