"""ECAPA-TDNN speaker encoder (counterpart of indextts_tpu/models/ecapa.py).

The reference speaker-embedding model (indextts/BigVGAN/ECAPA_TDNN.py:
429-581): TDNN -> 3 SE-Res2Net blocks -> MFA -> attentive-statistics
pooling -> BatchNorm -> 1x1 conv.  Convs are speechbrain "same" convs:
reflect padding of (k-1)*d/2 each side.  BatchNorm runs off running stats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ECAPASize:
    input_size: int = 100
    lin_neurons: int = 512
    channels: tuple = (512, 512, 512, 512, 1536)
    kernel_sizes: tuple = (5, 3, 3, 3, 1)
    dilations: tuple = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128


def _conv_same(x: torch.Tensor, p: Dict[str, Any], dilation: int = 1) -> torch.Tensor:
    pad = dilation * (p["w"].shape[-1] - 1) // 2
    if pad > 0:
        x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(x, p["w"], p["b"], dilation=dilation)


def _bn(x: torch.Tensor, p: Dict[str, Any], eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm1d over the channel axis of [B, C, T]."""
    view = lambda t: t[None, :, None]  # noqa: E731
    return ((x - view(p["mean"])) * torch.rsqrt(view(p["var"]) + eps) * view(p["scale"])
            + view(p["bias"]))


def _tdnn(x: torch.Tensor, p: Dict[str, Any], dilation: int = 1) -> torch.Tensor:
    """TDNNBlock: conv -> ReLU -> BN (ECAPA_TDNN.py:79-128)."""
    return _bn(F.relu(_conv_same(x, p["conv"], dilation)), p["bn"])


def init_params(generator: torch.Generator, size: ECAPASize = ECAPASize(),
                dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    def conv_p(cin, cout, k):
        r = torch.rand((cout, cin, k), generator=generator, device=device) * 2 - 1
        return {"w": (r / math.sqrt(cin * k)).to(dtype),
                "b": torch.zeros(cout, dtype=dtype, device=device)}

    def bn_p(c):
        one = torch.ones(c, dtype=dtype, device=device)
        zero = torch.zeros(c, dtype=dtype, device=device)
        return {"scale": one, "bias": zero, "mean": zero.clone(), "var": one.clone()}

    def tdnn_p(cin, cout, k):
        return {"conv": conv_p(cin, cout, k), "bn": bn_p(cout)}

    ch, kern = size.channels, size.kernel_sizes
    scale = size.res2net_scale
    blocks: List[Dict[str, Any]] = [tdnn_p(size.input_size, ch[0], kern[0])]
    for i in range(1, len(ch) - 1):
        inner = ch[i] // scale
        blocks.append({
            "tdnn1": tdnn_p(ch[i - 1], ch[i], 1),
            "res2net": [tdnn_p(inner, inner, kern[i]) for _ in range(scale - 1)],
            "tdnn2": tdnn_p(ch[i], ch[i], 1),
            "se": {"conv1": conv_p(ch[i], size.se_channels, 1),
                   "conv2": conv_p(size.se_channels, ch[i], 1)},
        })
    return {
        "blocks": blocks,
        "mfa": tdnn_p(ch[-2] * (len(ch) - 2), ch[-1], kern[-1]),
        "asp": {"tdnn": tdnn_p(ch[-1] * 3, size.attention_channels, 1),
                "conv": conv_p(size.attention_channels, ch[-1], 1)},
        "asp_bn": bn_p(ch[-1] * 2),
        "fc": conv_p(ch[-1] * 2, size.lin_neurons, 1),
    }


def _se_res2net(x: torch.Tensor, p: Dict[str, Any], dilation: int,
                scale: int) -> torch.Tensor:
    """SERes2NetBlock (ECAPA_TDNN.py:341-426)."""
    residual = x
    chunks = _tdnn(x, p["tdnn1"]).chunk(scale, dim=1)
    ys = [chunks[0]]
    y = None
    for i in range(1, scale):
        y = _tdnn(chunks[i] if i == 1 else chunks[i] + y, p["res2net"][i - 1], dilation)
        ys.append(y)
    h = _tdnn(torch.cat(ys, dim=1), p["tdnn2"])
    s = h.mean(dim=2, keepdim=True)
    s = torch.sigmoid(_conv_same(F.relu(_conv_same(s, p["se"]["conv1"])), p["se"]["conv2"]))
    return s * h + residual


def forward(params: Dict[str, Any], mel: torch.Tensor,
            size: ECAPASize = ECAPASize()) -> torch.Tensor:
    """mel [B, T, n_mels] (time-major) -> speaker embedding [B, 1, lin_neurons]."""
    h = _tdnn(mel.transpose(1, 2), params["blocks"][0], size.dilations[0])
    feats = []
    for i, blk in enumerate(params["blocks"][1:], start=1):
        h = _se_res2net(h, blk, size.dilations[i], size.res2net_scale)
        feats.append(h)
    h = _tdnn(torch.cat(feats, dim=1), params["mfa"])

    # attentive statistics pooling with global context (ECAPA_TDNN.py:245-338)
    eps = 1e-12
    mean = h.mean(dim=2, keepdim=True)
    std = (h - mean).square().mean(dim=2, keepdim=True).clamp(min=eps).sqrt()
    attn_in = torch.cat([h, mean.expand_as(h), std.expand_as(h)], dim=1)
    attn = _conv_same(torch.tanh(_tdnn(attn_in, params["asp"]["tdnn"])), params["asp"]["conv"])
    attn = torch.softmax(attn, dim=2)
    amean = (attn * h).sum(dim=2)
    astd = (attn * (h - amean[..., None]).square()).sum(dim=2).clamp(min=eps).sqrt()
    pooled = _bn(torch.cat([amean, astd], dim=1)[..., None], params["asp_bn"])
    return _conv_same(pooled, params["fc"]).transpose(1, 2)
