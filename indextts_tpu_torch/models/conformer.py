"""Conformer conditioning encoder (counterpart of
indextts_tpu/models/conformer.py).

The reference wenet-style encoder (indextts/gpt/conformer_encoder.py:
389-465): conv2d2 front end (2x time subsampling), blocks of
[relative-position MHA -> conv module (GLU, depthwise k=15, LayerNorm, SiLU)
-> FF] with pre-norm and a final LayerNorm.  Scores are
((q+u) k^T + (q+v) p^T) / sqrt(d) with p the sinusoidal encoding of
positions 0..T-1 (no rel-shift, as the reference computes it).  Blocks are
stacked on a leading axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.models.gpt2 import layer_norm, tree_index

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class ConformerSize:
    input_size: int = 100
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    cnn_kernel: int = 15

    @property
    def head_dim(self) -> int:
        return self.output_size // self.attention_heads


def sinusoidal_pos_encoding(length: int, dim: int) -> np.ndarray:
    """wenet PositionalEncoding table (embedding.py:48-56)."""
    pe = np.zeros((length, dim), dtype=np.float32)
    position = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def init_params(size: ConformerSize, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    D, H, F_, L = size.output_size, size.attention_heads, size.linear_units, size.num_blocks
    fsub = (size.input_size - 1) // 2

    def u(shape, fan_in):
        r = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (r / math.sqrt(fan_in)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def norm():
        return {"scale": torch.ones(L, D, dtype=dtype, device=device), "bias": zeros(L, D)}

    def lin(k, n, fan):
        return {"kernel": u((L, k, n), fan), "bias": zeros(L, n)}

    return {
        "embed": {
            "conv": {"w": u((D, 1, 3, 3), 9), "b": zeros(D)},
            "out": {"kernel": u((D * fsub, D), D * fsub), "bias": zeros(D)},
        },
        "blocks": {
            "norm_mha": norm(),
            "attn": {
                "q": lin(D, D, D), "k": lin(D, D, D), "v": lin(D, D, D),
                "out": lin(D, D, D), "pos": {"kernel": u((L, D, D), D)},
                "pos_bias_u": u((L, H, D // H), D // H),
                "pos_bias_v": u((L, H, D // H), D // H),
            },
            "norm_conv": norm(),
            "conv": {
                "pw1": lin(D, 2 * D, D),
                "dw": {"w": u((L, D, 1, size.cnn_kernel), size.cnn_kernel), "b": zeros(L, D)},
                "norm": norm(),
                "pw2": lin(D, D, D),
            },
            "norm_ff": norm(),
            "ff": {"w1": lin(D, F_, D), "w2": lin(F_, D, F_)},
            "norm_final": norm(),
        },
        "after_norm": {"scale": torch.ones(D, dtype=dtype, device=device), "bias": zeros(D)},
    }


def _subsample(params: Dict[str, Any], x: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv2dSubsampling2 (subsampling.py:111-143): Conv2d(1, D, 3, 2) + ReLU
    over (time, freq), flatten, Linear.  x [B, T, F_in] -> [B, T', D]."""
    h = F.relu(F.conv2d(x[:, None], params["embed"]["conv"]["w"],
                        params["embed"]["conv"]["b"], stride=2))
    B, C, Tp, Fp = h.shape
    h = h.transpose(1, 2).reshape(B, Tp, C * Fp)
    h = h @ params["embed"]["out"]["kernel"] + params["embed"]["out"]["bias"]
    return h, mask[:, 2::2]


def _rel_attention(attn, x, pos_emb, key_mask, heads):
    """x [B, T, D]; pos_emb [T, D]; key_mask [B, T] True = valid."""
    B, T, D = x.shape
    hd = D // heads

    def proj(p, inp):
        return (inp @ p["kernel"] + p["bias"]).view(B, T, heads, hd)

    q, k, v = proj(attn["q"], x), proj(attn["k"], x), proj(attn["v"], x)
    p = (pos_emb @ attn["pos"]["kernel"]).view(T, heads, hd)
    q_u = (q + attn["pos_bias_u"][None, None]).transpose(1, 2)
    q_v = (q + attn["pos_bias_v"][None, None]).transpose(1, 2)
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.transpose(1, 2).float())
    bd = torch.einsum("bhqd,khd->bhqk", q_v.float(), p.float())
    scores = (ac + bd) / math.sqrt(hd)
    mask4 = key_mask[:, None, None, :]
    scores = torch.where(mask4, scores, NEG_INF)
    probs = torch.where(mask4, torch.softmax(scores, dim=-1), 0.0)
    ctx = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))
    ctx = ctx.transpose(1, 2).reshape(B, T, D)
    return ctx @ attn["out"]["kernel"] + attn["out"]["bias"]


def _conv_module(conv, x, key_mask):
    """ConvolutionModule (conformer_encoder.py:56-164).  x [B, T, D]."""
    h = torch.where(key_mask[:, :, None], x, 0.0)
    h = h @ conv["pw1"]["kernel"] + conv["pw1"]["bias"]
    a, b = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(b)
    w = conv["dw"]["w"]                                      # [D, 1, K]
    h = F.conv1d(h.transpose(1, 2), w, conv["dw"]["b"], padding=w.shape[-1] // 2,
                 groups=w.shape[0]).transpose(1, 2)
    h = F.silu(layer_norm(h, conv["norm"]["scale"], conv["norm"]["bias"]))
    h = h @ conv["pw2"]["kernel"] + conv["pw2"]["bias"]
    return torch.where(key_mask[:, :, None], h, 0.0)


def forward(params: Dict[str, Any], mel: torch.Tensor, mel_lengths: torch.Tensor,
            size: ConformerSize) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel [B, T, n_mels] (time-major); mel_lengths [B].
    Returns (encoded [B, T', D], valid mask [B, T'] bool)."""
    B, T, _ = mel.shape
    valid = torch.arange(T, device=mel.device)[None, :] < mel_lengths[:, None]
    x, valid = _subsample(params, mel, valid)
    x = x * math.sqrt(size.output_size)
    pos_emb = torch.as_tensor(sinusoidal_pos_encoding(x.shape[1], size.output_size),
                              dtype=x.dtype, device=x.device)
    for l in range(size.num_blocks):
        blk = tree_index(params["blocks"], l)
        y = layer_norm(x, blk["norm_mha"]["scale"], blk["norm_mha"]["bias"])
        x = x + _rel_attention(blk["attn"], y, pos_emb, valid, size.attention_heads)
        y = layer_norm(x, blk["norm_conv"]["scale"], blk["norm_conv"]["bias"])
        x = x + _conv_module(blk["conv"], y, valid)
        y = layer_norm(x, blk["norm_ff"]["scale"], blk["norm_ff"]["bias"])
        y = F.silu(y @ blk["ff"]["w1"]["kernel"] + blk["ff"]["w1"]["bias"])
        x = x + (y @ blk["ff"]["w2"]["kernel"] + blk["ff"]["w2"]["bias"])
        x = layer_norm(x, blk["norm_final"]["scale"], blk["norm_final"]["bias"])
    x = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    return x, valid
