"""Perceiver resampler: variable-length conditioning -> 32 latent vectors
(counterpart of indextts_tpu/models/perceiver.py).

The reference PerceiverResampler (indextts/gpt/perceiver.py:219-313):
learned latents, 2 blocks of [cross-attention with the queries prepended to
the context -> GEGLU FF], final RMSNorm; no pre-norms inside the blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch.models.gpt2 import tree_index

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class PerceiverSize:
    dim: int = 1280
    dim_context: int = 512
    depth: int = 2
    num_latents: int = 32
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 2

    @property
    def dim_inner(self) -> int:
        return self.dim_head * self.heads

    @property
    def ff_inner(self) -> int:
        # reference FeedForward: int(dim * mult * 2 / 3) (perceiver.py:206)
        return int(self.dim * self.ff_mult * 2 / 3)


def init_params(size: PerceiverSize, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    D, Dc, Di, Df, L = size.dim, size.dim_context, size.dim_inner, size.ff_inner, size.depth

    def u(shape, fan_in):
        r = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (r / math.sqrt(fan_in)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    latents = torch.randn((size.num_latents, D), generator=generator, device=device) * 0.02
    return {
        "proj_context": {"kernel": u((Dc, D), Dc), "bias": zeros(D)},
        "latents": latents.to(dtype),
        "layers": {
            "attn": {"to_q": u((L, D, Di), D), "to_kv": u((L, D, 2 * Di), D),
                     "to_out": u((L, Di, D), Di)},
            "ff": {"w1": {"kernel": u((L, D, 2 * Df), D), "bias": zeros(L, 2 * Df)},
                   "w2": {"kernel": u((L, Df, D), Df), "bias": zeros(L, D)}},
        },
        "norm": {"gamma": torch.ones(D, dtype=dtype, device=device)},
    }


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Reference RMSNorm (perceiver.py:162-181): l2-normalise * sqrt(dim) * g."""
    x32 = x.float()
    norm = x32.square().sum(dim=-1, keepdim=True).sqrt()
    y = x32 / norm.clamp(min=1e-12) * math.sqrt(x.shape[-1])
    return (y * gamma.float()).to(x.dtype)


def geglu_ff(ff: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = x @ ff["w1"]["kernel"] + ff["w1"]["bias"]
    val, gate = h.chunk(2, dim=-1)  # GEGLU: gelu(gate) * value
    return (F.gelu(gate) * val) @ ff["w2"]["kernel"] + ff["w2"]["bias"]


def _cross_attention(attn: Dict[str, Any], latents: torch.Tensor, context: torch.Tensor,
                     mask: Optional[torch.Tensor], size: PerceiverSize) -> torch.Tensor:
    """latents [B, N, D]; context [B, M, D] (queries prepended); mask [B, M]
    True = attendable, or None."""
    B, N, _ = latents.shape
    H, hd = size.heads, size.dim_head
    q = (latents @ attn["to_q"]).view(B, N, H, hd).transpose(1, 2)
    k, v = (context @ attn["to_kv"]).chunk(2, dim=-1)
    k = k.reshape(B, -1, H, hd).transpose(1, 2)
    v = v.reshape(B, -1, H, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    ctx = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
    ctx = ctx.transpose(1, 2).reshape(B, N, H * hd)
    return ctx @ attn["to_out"]


def forward(params: Dict[str, Any], x: torch.Tensor, mask: Optional[torch.Tensor],
            size: PerceiverSize) -> torch.Tensor:
    """x [B, T, dim_context]; mask [B, num_latents + T] (queries prepended).
    Returns latents [B, num_latents, dim]."""
    B = x.shape[0]
    x = x @ params["proj_context"]["kernel"] + params["proj_context"]["bias"]
    lat = params["latents"][None].expand(B, -1, -1)
    for l in range(size.depth):
        layer = tree_index(params["layers"], l)
        context = torch.cat([lat, x], dim=1)
        lat = _cross_attention(layer["attn"], lat, context, mask, size) + lat
        lat = geglu_ff(layer["ff"], lat) + lat
    return rms_norm(lat, params["norm"]["gamma"])
