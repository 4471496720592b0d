"""DVAE mel tokenizer: a 1-D conv VQ-VAE over mel spectrograms (counterpart
of indextts_tpu/models/dvae.py).

The reference DiscreteVAE (indextts/vqvae/xtts_dvae.py:54-398) at the
shipped config (config.yaml:76-87): 100 mel channels, 8192 codes, codebook
dim 512, hidden 512, two stride-2 convs (4x time reduction), 3 residual
blocks, a nearest-upsample decoder and an EMA vector quantiser.  One code
covers 4 mel frames, 1024 samples at 24 kHz.

The parameter tree is the JAX package's: torch-layout conv weights
[out, in, k], residual blocks stacked on a leading axis (looped over here
where JAX scans), the codebook as {"embed" [D, N], "cluster_size" [N],
"embed_avg" [D, N]}.  The EMA update and the rebalance return new codebook
state rather than mutating it.

The quantiser's argmin keeps JAX's distance formula, |z|^2 - 2 z.E + |E|^2
in fp32, and its first-index tie order (torch.argmin's too).  The DVAE's
entry points run their convolutions and products under `no_tf32()`: TF32
would move z by about 1e-3 relative on the card and flip codes against the
fp32 reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from indextts_tpu_torch.config import VQVAEConfig
from indextts_tpu_torch.parallel import mesh


@contextlib.contextmanager
def no_tf32():
    """Full fp32 for cuDNN convolutions and cuBLAS products inside the
    block, whatever the global flags; restores them afterwards."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv1d(x, p["w"], p["b"], stride=stride, padding=padding)


def _resblocks(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """Stacked ResBlocks (xtts_dvae.py:177-189): conv3-relu-conv3-relu-conv1
    plus the residual, one per leading index."""
    for i in range(p["c1"]["w"].shape[0]):
        h = F.relu(_conv(x, {k: v[i] for k, v in p["c1"].items()}, padding=1))
        h = F.relu(_conv(h, {k: v[i] for k, v in p["c2"].items()}, padding=1))
        x = _conv(h, {k: v[i] for k, v in p["c3"].items()}) + x
    return x


def init_params(cfg: VQVAEConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Random weights of JAX's init's distributions: conv weights uniform in
    +-1/sqrt(fan_in), zero biases, a normal codebook (embed_avg = embed)."""
    C, H, CB, kn, n = cfg.channels, cfg.hidden_dim, cfg.codebook_dim, cfg.kernel_size, \
        cfg.num_resnet_blocks
    H2 = H * 2   # innermost width: hidden * 2**(num_layers - 1) for num_layers=2

    def conv_p(cin, cout, ksz, lead=()):
        r = torch.rand((*lead, cout, cin, ksz), generator=generator, device=device) * 2 - 1
        return {"w": (r / math.sqrt(cin * ksz)).to(dtype),
                "b": torch.zeros((*lead, cout), dtype=dtype, device=device)}

    def res_p(ch):
        return {"c1": conv_p(ch, ch, kn, (n,)), "c2": conv_p(ch, ch, kn, (n,)),
                "c3": conv_p(ch, ch, 1, (n,))}

    enc_conv0, enc_conv1 = conv_p(C, H, kn), conv_p(H, H2, kn)
    enc_res, enc_out = res_p(H2), conv_p(H2, CB, 1)
    embed = torch.randn((CB, cfg.num_tokens), generator=generator, device=device).to(dtype)
    return {
        "enc_conv0": enc_conv0, "enc_conv1": enc_conv1, "enc_res": enc_res, "enc_out": enc_out,
        "codebook": {"embed": embed,
                     "cluster_size": torch.zeros(cfg.num_tokens, dtype=dtype, device=device),
                     "embed_avg": embed.clone()},
        "dec_in": conv_p(CB, H2, 1), "dec_res": res_p(H2), "dec_up0": conv_p(H2, H2, kn),
        "dec_up1": conv_p(H2, H, kn), "dec_out": conv_p(H, C, 1),
    }


def encode(params: Dict[str, Any], mel: torch.Tensor, cfg: VQVAEConfig) -> torch.Tensor:
    """mel [B, 100, T] -> pre-quantisation vectors [B, T//4, codebook_dim]."""
    pad = (cfg.kernel_size - 1) // 2
    h = F.relu(_conv(mel, params["enc_conv0"], cfg.stride, pad))
    h = F.relu(_conv(h, params["enc_conv1"], cfg.stride, pad))
    h = _conv(_resblocks(h, params["enc_res"]), params["enc_out"])
    return h.transpose(1, 2)


def quantize_indices(codebook: Dict[str, Any], z: torch.Tensor) -> torch.Tensor:
    """Nearest codebook column (xtts_dvae.py:92-97): z [..., D] -> int32
    codes [...], by JAX's fp32 distance formula and its first-index ties."""
    embed = codebook["embed"].float()                        # [D, N]
    z = z.float()
    dist = ((z * z).sum(-1, keepdim=True) - 2.0 * torch.matmul(z, embed)
            + (embed * embed).sum(0))
    return torch.argmin(dist, dim=-1).to(torch.int32)


def embed_code(codebook: Dict[str, Any], codes: torch.Tensor) -> torch.Tensor:
    """codes [...] -> vectors [..., D] (xtts_dvae.py:134-135)."""
    return codebook["embed"].t()[codes.long()]


def get_codebook_indices(params: Dict[str, Any], mel: torch.Tensor,
                         cfg: Optional[VQVAEConfig] = None) -> torch.Tensor:
    """mel [B, 100, T] -> codes [B, T//4] (xtts_dvae.py:328-335), with TF32
    off: the extraction entry point."""
    cfg = cfg or VQVAEConfig()
    with no_tf32():
        return quantize_indices(params["codebook"], encode(params, mel, cfg))


def decode(params: Dict[str, Any], codes: torch.Tensor,
           cfg: Optional[VQVAEConfig] = None) -> torch.Tensor:
    """codes [B, T'] -> mel [B, 100, 4 T'] (xtts_dvae.py:337-356): nearest 2x
    upsampling before each of the two up-convs (UpsampledConv, :192-202)."""
    cfg = cfg or VQVAEConfig()
    pad = (cfg.kernel_size - 1) // 2
    h = _conv(embed_code(params["codebook"], codes).transpose(1, 2), params["dec_in"])
    h = _resblocks(h, params["dec_res"])
    h = F.relu(_conv(h.repeat_interleave(cfg.stride, dim=2), params["dec_up0"], padding=pad))
    h = F.relu(_conv(h.repeat_interleave(cfg.stride, dim=2), params["dec_up1"], padding=pad))
    return _conv(h, params["dec_out"])


def forward_loss(params: Dict[str, Any], mel: torch.Tensor,
                 cfg: Optional[VQVAEConfig] = None) -> Dict[str, torch.Tensor]:
    """Training forward (xtts_dvae.py:364-386): the smooth-L1 (or MSE)
    reconstruction and the commitment loss, with the codes and z.

    As in JAX, the decoder reads the quantised codes through a codebook
    with no gradient, and the straight-through z_q that JAX builds is never
    used, so the encoder learns only from the commitment term."""
    cfg = cfg or VQVAEConfig()
    z = encode(params, mel, cfg)
    codebook = params["codebook"]
    codes = quantize_indices(codebook, z)
    quantised = embed_code(codebook, codes)
    commitment = torch.mean((quantised.detach() - z) ** 2)
    frozen = {k: v.detach() for k, v in codebook.items()}
    recon = decode({**params, "codebook": frozen}, codes, cfg)[..., : mel.shape[-1]]
    diff = recon - mel
    if cfg.smooth_l1_loss:
        absd = diff.abs()
        recon_loss = torch.mean(torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5))
    else:
        recon_loss = torch.mean(diff * diff)
    return {"recon_loss": recon_loss, "commitment_loss": commitment, "codes": codes, "z": z}


def ema_update(codebook: Dict[str, Any], z: torch.Tensor, codes: torch.Tensor,
               decay: float = 0.99, eps: float = 1e-5, group=None) -> Dict[str, torch.Tensor]:
    """EMA codebook update (xtts_dvae.py:109-122).  The statistics are a
    one-hot product, `flat.T @ onehot`, which is deterministic where a float
    scatter-add is not.  With a process `group` (data-parallel training,
    parallel/mesh.py) they are summed over its ranks before the decay, in
    one collective: JAX's `axis_name` psum, the reference's
    dist.all_reduce (xtts_dvae.py:113-115)."""
    n_embed = codebook["embed"].shape[1]
    onehot = F.one_hot(codes.reshape(-1).long(), n_embed).to(z.dtype)
    flat = z.reshape(-1, z.shape[-1])
    onehot_sum = onehot.sum(0)
    embed_sum = flat.t() @ onehot
    onehot_sum, embed_sum = mesh.all_reduce_tree((onehot_sum, embed_sum), group=group)
    cluster_size = codebook["cluster_size"] * decay + onehot_sum * (1 - decay)
    embed_avg = codebook["embed_avg"] * decay + embed_sum * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + n_embed * eps) * n
    return {"embed": embed_avg / smoothed[None], "cluster_size": cluster_size,
            "embed_avg": embed_avg}


def rebalance_codes(codebook: Dict[str, Any], usage: torch.Tensor, hi: float = 0.9,
                    lo: float = 0.01, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Dead- and dominant-code rebalancing (the reference's
    balancing_heuristic, xtts_dvae.py:78-87): the codes whose usage fraction
    is above `hi` or below `lo` get a normal draw as both embed and
    embed_avg, and a zero cluster size.  `noise` [D, N] is that draw (JAX's
    jax.random.normal, in tests); without it one is drawn from `generator`.
    Returns (codebook', int32 number reset)."""
    embed = codebook["embed"]
    mask = (usage > hi) | (usage < lo)                       # [N]
    if noise is None:
        noise = torch.randn(embed.shape, generator=generator, device=embed.device,
                            dtype=embed.dtype)
    keep = ~mask[None, :]
    return ({"embed": torch.where(keep, embed, noise),
             "cluster_size": torch.where(mask, 0.0, codebook["cluster_size"]),
             "embed_avg": torch.where(keep, codebook["embed_avg"], noise)},
            mask.sum().to(torch.int32))


def discretization_loss(x: torch.Tensor, dim: int, expected_variance: float,
                        past_mean: Optional[torch.Tensor] = None,
                        past_count: int = 0) -> torch.Tensor:
    """DiscretizationLoss (xtts_dvae.py:141-174): the per-bin usage of `x`
    (summed over every axis but `dim`, normalised, mean-subtracted) against
    a zero-mean normal of the expected variance.  The reference's running
    `store_past` mean is explicit: `past_mean` over `past_count` windows
    blends as (past_mean (n-1) + current) / n."""
    other = [i for i in range(x.ndim) if i != dim]
    averaged = x.sum(dim=other) / x.sum()
    averaged = averaged - averaged.mean()
    if past_mean is not None and past_count > 0:
        acc = past_count
        averaged = past_mean * (acc - 1) / acc + averaged / acc
    var = expected_variance
    root = torch.sqrt(torch.tensor(2.0 * math.pi, dtype=averaged.dtype, device=averaged.device))
    logp = -0.5 * (averaged / var) ** 2 - torch.log(root * var)
    return torch.sum(-logp)
