"""Legacy conditioning encoders (counterpart of
indextts_tpu/models/legacy_conditioning.py): the reference's
condition_type="perceiver" and its mean-pooled default
(gpt/model.py:221-245,534-545).

ConditioningEncoder = a 1x1 conv (100 -> D) and N AttentionBlocks
(utils/arch_util.py:84-126): GroupNorm -> 1x1 qkv conv with the heads'
q, k, v interleaved head-major (QKVAttentionLegacy) -> scaled-dot attention
-> a zero-initialised 1x1 projection, residual.  The shipped checkpoints use
"conformer_perceiver"; these encoders load older IndexTTS checkpoints.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch


def _group_count(channels: int) -> int:
    """GroupNorm's group count for `channels` (the reference's normalization()
    in utils/arch_util.py)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = groups // 2
    assert groups > 2
    return groups


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """x [B, C, T]: torch GroupNorm's formula in fp32, in x's type."""
    B, C, T = x.shape
    xf = x.float().reshape(B, groups, C // groups, T)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, T)
    return (xf * scale[None, :, None] + bias[None, :, None]).to(x.dtype)


def _pointwise(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A 1x1 conv with weight [out, in]: [B, in, T] -> [B, out, T]."""
    return torch.einsum("bct,oc->bot", x, p["w"]) + p["b"][None, :, None]


def init_attention_block(channels: int, generator: Optional[torch.Generator],
                         dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    r = torch.rand((3 * channels, channels), generator=generator, device=device) * 2 - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "norm": {"scale": torch.ones(channels, dtype=dtype, device=device),
                 "bias": zeros(channels)},
        "qkv": {"w": (r / math.sqrt(channels)).to(dtype), "b": zeros(3 * channels)},
        # proj_out is zero-initialised in the reference (arch_util.py:9-15)
        "proj": {"w": zeros(channels, channels), "b": zeros(channels)},
    }


def attention_block(params: Dict[str, Any], x: torch.Tensor, heads: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T] (arch_util.py:118-126)."""
    B, C, T = x.shape
    h = group_norm(x, params["norm"]["scale"], params["norm"]["bias"], _group_count(C))
    qkv = _pointwise(h, params["qkv"])
    # head-major interleave: per head [q; k; v], ch channels each
    ch = C // heads
    q, k, v = qkv.reshape(B, heads, 3 * ch, T).split(ch, dim=2)   # [B, H, ch, T]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    weight = torch.einsum("bhct,bhcs->bhts", q * scale, k * scale)
    weight = torch.softmax(weight.float(), dim=-1).to(x.dtype)
    if mask is not None:
        weight = weight * mask[:, None, None, :]
    a = torch.einsum("bhts,bhcs->bhct", weight, v).reshape(B, C, T)
    return x + _pointwise(a, params["proj"])


def init_conditioning_encoder(spec_dim: int, embedding_dim: int,
                              generator: Optional[torch.Generator], attn_blocks: int = 6,
                              dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    r = torch.rand((embedding_dim, spec_dim), generator=generator, device=device) * 2 - 1
    return {
        "init": {"w": (r / math.sqrt(spec_dim)).to(dtype),
                 "b": torch.zeros(embedding_dim, dtype=dtype, device=device)},
        "attn": [init_attention_block(embedding_dim, generator, dtype, device)
                 for _ in range(attn_blocks)],
    }


def conditioning_encoder(params: Dict[str, Any], mel: torch.Tensor, heads: int,
                         mean: bool = False) -> torch.Tensor:
    """mel [B, 100, T] -> [B, D, T], or [B, D] mean-pooled over time
    (gpt/model.py:239-245)."""
    h = _pointwise(mel, params["init"])
    for blk in params["attn"]:
        h = attention_block(blk, h, heads)
    return h.mean(dim=2) if mean else h
