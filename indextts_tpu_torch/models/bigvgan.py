"""BigVGAN latent-conditioned vocoder (counterpart of
indextts_tpu/models/bigvgan.py).

The reference generator (indextts/BigVGAN/models.py:130-252): GPT latent
(gpt_dim per mel code) -> conv_pre(7) -> transposed-conv upsample stages
[4,4,4,4,2,2] (1024x: mel_length_compression samples per code) -> AMP
resblocks (k 3/7/11, dilations 1/3/5) with anti-aliased SnakeBeta
activations -> conv_post(7) -> tanh.  The ECAPA speaker embedding is added by
1x1 convs at the input and at every upsample stage.  Weight norm is folded
into plain weights.

Every activation goes through ops/cuda/anti_alias.py: the hand-written
kernel for CUDA tensors, its plain version for CPU tensors; where a
gradient is needed (vocoder training), its backward is the hand-written
K1b, or its plain version on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.models import ecapa
from indextts_tpu_torch.ops.cuda import anti_alias


def _conv(x, p, padding=0, dilation=1):
    return F.conv1d(x, p["w"], p["b"], padding=padding, dilation=dilation)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _ecapa_size(cfg: BigVGANConfig) -> ecapa.ECAPASize:
    return ecapa.ECAPASize(input_size=cfg.num_mels, lin_neurons=cfg.speaker_embedding_dim)


def init_params(cfg: BigVGANConfig, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    def conv_p(cin, cout, k, transposed=False, std=0.01):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        w = torch.randn(shape, generator=generator, device=device) * std
        return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=device)}

    def act_p(c):
        return {"alpha": torch.zeros(c, dtype=dtype, device=device),
                "beta": torch.zeros(c, dtype=dtype, device=device)}

    C0 = cfg.upsample_initial_channel
    params: Dict[str, Any] = {
        "conv_pre": conv_p(cfg.gpt_dim, C0, 7),
        "cond_layer": conv_p(cfg.speaker_embedding_dim, C0, 1),
        "speaker_encoder": ecapa.init_params(generator, _ecapa_size(cfg), dtype, device),
        "ups": [], "conds": [], "resblocks": [],
    }
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = C0 // (2 ** i), C0 // (2 ** (i + 1))
        params["ups"].append(conv_p(cin, cout, k, transposed=True))
        params["conds"].append(conv_p(cfg.speaker_embedding_dim, cout, 1))
        for kr, dr in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            params["resblocks"].append({
                "convs1": [conv_p(cout, cout, kr) for _ in dr],
                "convs2": [conv_p(cout, cout, kr) for _ in dr],
                "acts": [act_p(cout) for _ in range(2 * len(dr))],
            })
    ch = C0 // (2 ** len(cfg.upsample_rates))
    params["activation_post"] = act_p(ch)
    params["conv_post"] = conv_p(ch, 1, 7)
    return params


def _activation(x, act, cfg: BigVGANConfig):
    """Anti-aliased SnakeBeta."""
    return anti_alias.fused_anti_alias_activation(
        x, act["alpha"], act["beta"], logscale=cfg.snake_logscale)


def _amp_block(x, blk, kernel: int, dilations, cfg: BigVGANConfig):
    """AMPBlock1 (models.py:20-74)."""
    for c1, c2, d, a1, a2 in zip(blk["convs1"], blk["convs2"], dilations,
                                 blk["acts"][::2], blk["acts"][1::2]):
        xt = _conv(_activation(x, a1, cfg), c1, padding=get_padding(kernel, d), dilation=d)
        xt = _conv(_activation(xt, a2, cfg), c2, padding=get_padding(kernel, 1))
        x = xt + x
    return x


def forward(params: Dict[str, Any], latent: torch.Tensor, mel_ref: torch.Tensor,
            cfg: Optional[BigVGANConfig] = None) -> torch.Tensor:
    """latent [B, T_codes, gpt_dim]; mel_ref [B, T_mel, n_mels] (time-major).
    Returns the waveform [B, 1, T_codes * 1024]."""
    cfg = cfg or BigVGANConfig()
    spk = ecapa.forward(params["speaker_encoder"], mel_ref, _ecapa_size(cfg))
    spk = spk.transpose(1, 2)                                # [B, spk_dim, 1]
    x = latent.transpose(1, 2)                               # [B, gpt_dim, T]
    if cfg.feat_upsample:
        x = F.interpolate(x, scale_factor=4, mode="linear", align_corners=False)
    x = _conv(x, params["conv_pre"], padding=3) + _conv(spk, params["cond_layer"])
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][i]
        x = F.conv_transpose1d(x, up["w"], up["b"], stride=u, padding=(k - u) // 2)
        if cfg.cond_d_vector_in_each_upsampling_layer:
            x = x + _conv(spk, params["conds"][i])
        acc = None
        for j, (kr, dr) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            y = _amp_block(x, params["resblocks"][i * n_kernels + j], kr, dr, cfg)
            acc = y if acc is None else acc + y
        x = acc / n_kernels
    x = _conv(_activation(x, params["activation_post"], cfg), params["conv_post"], padding=3)
    return torch.tanh(x)
