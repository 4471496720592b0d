"""The port's parameter trees -> reference-format ``.pth`` files (the port's
own copy of indextts_tpu/io/export.py).

The inverse of `io/checkpoint.py`'s converters, so weights the port holds
can be deployed on the reference stack, or loaded by the JAX package:

  * ``save_gpt_pth`` writes the reference trainer's inference artifact,
    ``{'model': state_dict}`` with optional top-level ``speaker_conditions``
    / ``speakers`` / ``speaker_mels`` (train.py:795-844), which the
    reference loads with ``strict=True`` (train.py:67-75);
  * ``save_bigvgan_pth`` writes ``{'generator': state_dict}`` with the
    weight-norm ``weight_g``/``weight_v`` splits restored (infer.py:392-393);
  * ``save_dvae_pth`` writes the DiscreteVAE state_dict (xtts_dvae.py:258-298).

The input is a float tree of torch tensors on any device (or numpy arrays).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from indextts_tpu_torch.config import (CONFORMER_CONDITION_TYPES, BigVGANConfig, GPTConfig,
                                       VQVAEConfig)

_SAVE_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}


def _np(leaf) -> np.ndarray:
    """A float leaf as fp32 numpy on the host."""
    if isinstance(leaf, dict):
        raise ValueError(f"export takes float weights; got a quantized leaf {sorted(leaf)}")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).cpu().numpy()
    return np.asarray(leaf, dtype=np.float32)


def _to_torch_sd(sd: Dict[str, np.ndarray], save_dtype: str) -> Dict[str, torch.Tensor]:
    if save_dtype not in _SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {sorted(_SAVE_DTYPES)}, "
                         f"got {save_dtype!r}")
    dt = _SAVE_DTYPES[save_dtype]
    out = {}
    for k, v in sd.items():
        # ascontiguousarray makes a 0-d array 1-d: keep the shape (BatchNorm's
        # num_batches_tracked is 0-d, and a strict load checks shapes)
        t = torch.from_numpy(np.ascontiguousarray(v).reshape(np.shape(v)))
        out[k] = t.to(dt) if t.is_floating_point() else t
    return out


# ---------------------------------------------------------------------------
# UnifiedVoice (gpt.pth)
# ---------------------------------------------------------------------------

def export_gpt_state_dict(params: Dict[str, Any], cfg: GPTConfig) -> Dict[str, np.ndarray]:
    """Parameter tree -> reference-named flat dict (fp32 numpy).  HF Conv1D
    trunk weights keep their [in, out] layout; nn.Linear heads are
    transposed back to [out, in] (gpt/model.py:312-392)."""
    sd: Dict[str, np.ndarray] = {}
    blocks = params["gpt"]["blocks"]
    L = cfg.layers

    def unstack(dst_fmt: str, leaf) -> None:
        arr = _np(leaf)
        if arr.shape[0] != L:
            raise ValueError(f"{dst_fmt}: expected leading layer axis {L}, "
                             f"got shape {arr.shape}")
        for i in range(L):
            sd[dst_fmt.format(i)] = arr[i]

    for ln in ("ln_1", "ln_2"):
        unstack(f"gpt.h.{{}}.{ln}.weight", blocks[ln]["scale"])
        unstack(f"gpt.h.{{}}.{ln}.bias", blocks[ln]["bias"])
    unstack("gpt.h.{}.attn.c_attn.weight", blocks["attn"]["qkv_w"])
    unstack("gpt.h.{}.attn.c_attn.bias", blocks["attn"]["qkv_b"])
    unstack("gpt.h.{}.attn.c_proj.weight", blocks["attn"]["proj_w"])
    unstack("gpt.h.{}.attn.c_proj.bias", blocks["attn"]["proj_b"])
    unstack("gpt.h.{}.mlp.c_fc.weight", blocks["mlp"]["fc_w"])
    unstack("gpt.h.{}.mlp.c_fc.bias", blocks["mlp"]["fc_b"])
    unstack("gpt.h.{}.mlp.c_proj.weight", blocks["mlp"]["proj_w"])
    unstack("gpt.h.{}.mlp.c_proj.bias", blocks["mlp"]["proj_b"])
    sd["gpt.ln_f.weight"] = _np(params["gpt"]["ln_f"]["scale"])
    sd["gpt.ln_f.bias"] = _np(params["gpt"]["ln_f"]["bias"])

    # embeddings, position tables, final norm, heads (gpt/model.py:367-385)
    sd["text_embedding.weight"] = _np(params["text_embedding"]["weight"])
    sd["mel_embedding.weight"] = _np(params["mel_embedding"]["weight"])
    sd["mel_pos_embedding.emb.weight"] = _np(params["mel_pos_embedding"]["weight"])
    sd["text_pos_embedding.emb.weight"] = _np(params["text_pos_embedding"]["weight"])
    sd["final_norm.weight"] = _np(params["final_norm"]["scale"])
    sd["final_norm.bias"] = _np(params["final_norm"]["bias"])
    sd["text_head.weight"] = _np(params["text_head"]["kernel"]).T
    sd["text_head.bias"] = _np(params["text_head"]["bias"])
    sd["mel_head.weight"] = _np(params["mel_head"]["kernel"]).T
    sd["mel_head.bias"] = _np(params["mel_head"]["bias"])

    ce = "conditioning_encoder."
    cond = params["conditioning_encoder"]
    if cfg.condition_type in CONFORMER_CONDITION_TYPES:
        _export_conformer(sd, ce, cond, cfg)
        _export_perceiver(sd, params["perceiver_encoder"])
        return sd
    # the legacy AttentionBlock encoder (arch_util.py:84-126): the 1x1 convs
    # regain their trailing length-1 axis
    def pointwise1(key: str, p: Dict[str, Any]) -> None:
        sd[ce + key + ".weight"] = _np(p["w"])[:, :, None]
        sd[ce + key + ".bias"] = _np(p["b"])

    pointwise1("init", cond["init"])
    for i, blk in enumerate(cond["attn"]):
        sd[ce + f"attn.{i}.norm.weight"] = _np(blk["norm"]["scale"])
        sd[ce + f"attn.{i}.norm.bias"] = _np(blk["norm"]["bias"])
        pointwise1(f"attn.{i}.qkv", blk["qkv"])
        pointwise1(f"attn.{i}.proj_out", blk["proj"])
    if params.get("perceiver_encoder"):
        _export_perceiver(sd, params["perceiver_encoder"])
    return sd


def _export_conformer(sd: Dict[str, np.ndarray], ce: str, cond: Dict[str, Any],
                      cfg: GPTConfig) -> None:
    CL = cfg.condition_module.num_blocks
    sd[ce + "embed.conv.0.weight"] = _np(cond["embed"]["conv"]["w"])
    sd[ce + "embed.conv.0.bias"] = _np(cond["embed"]["conv"]["b"])
    sd[ce + "embed.out.0.weight"] = _np(cond["embed"]["out"]["kernel"]).T
    sd[ce + "embed.out.0.bias"] = _np(cond["embed"]["out"]["bias"])
    b = cond["blocks"]

    def unstack(dst_fmt: str, leaf, transpose: bool = False) -> None:
        arr = _np(leaf)
        for i in range(CL):
            sd[ce + dst_fmt.format(i)] = arr[i].T if transpose else arr[i]

    unstack("encoders.{}.norm_mha.weight", b["norm_mha"]["scale"])
    unstack("encoders.{}.norm_mha.bias", b["norm_mha"]["bias"])
    for name in ("q", "k", "v", "out"):
        unstack(f"encoders.{{}}.self_attn.linear_{name}.weight", b["attn"][name]["kernel"],
                transpose=True)
        unstack(f"encoders.{{}}.self_attn.linear_{name}.bias", b["attn"][name]["bias"])
    unstack("encoders.{}.self_attn.linear_pos.weight", b["attn"]["pos"]["kernel"],
            transpose=True)
    unstack("encoders.{}.self_attn.pos_bias_u", b["attn"]["pos_bias_u"])
    unstack("encoders.{}.self_attn.pos_bias_v", b["attn"]["pos_bias_v"])
    unstack("encoders.{}.norm_conv.weight", b["norm_conv"]["scale"])
    unstack("encoders.{}.norm_conv.bias", b["norm_conv"]["bias"])
    pw1 = _np(b["conv"]["pw1"]["kernel"])
    pw2 = _np(b["conv"]["pw2"]["kernel"])
    for i in range(CL):   # kernel [in, out] -> conv1d [out, in, 1]
        sd[ce + f"encoders.{i}.conv_module.pointwise_conv1.weight"] = pw1[i].T[:, :, None]
        sd[ce + f"encoders.{i}.conv_module.pointwise_conv2.weight"] = pw2[i].T[:, :, None]
    unstack("encoders.{}.conv_module.pointwise_conv1.bias", b["conv"]["pw1"]["bias"])
    unstack("encoders.{}.conv_module.pointwise_conv2.bias", b["conv"]["pw2"]["bias"])
    unstack("encoders.{}.conv_module.depthwise_conv.weight", b["conv"]["dw"]["w"])
    unstack("encoders.{}.conv_module.depthwise_conv.bias", b["conv"]["dw"]["b"])
    unstack("encoders.{}.conv_module.norm.weight", b["conv"]["norm"]["scale"])
    unstack("encoders.{}.conv_module.norm.bias", b["conv"]["norm"]["bias"])
    unstack("encoders.{}.norm_ff.weight", b["norm_ff"]["scale"])
    unstack("encoders.{}.norm_ff.bias", b["norm_ff"]["bias"])
    unstack("encoders.{}.feed_forward.w_1.weight", b["ff"]["w1"]["kernel"], transpose=True)
    unstack("encoders.{}.feed_forward.w_1.bias", b["ff"]["w1"]["bias"])
    unstack("encoders.{}.feed_forward.w_2.weight", b["ff"]["w2"]["kernel"], transpose=True)
    unstack("encoders.{}.feed_forward.w_2.bias", b["ff"]["w2"]["bias"])
    unstack("encoders.{}.norm_final.weight", b["norm_final"]["scale"])
    unstack("encoders.{}.norm_final.bias", b["norm_final"]["bias"])
    sd[ce + "after_norm.weight"] = _np(cond["after_norm"]["scale"])
    sd[ce + "after_norm.bias"] = _np(cond["after_norm"]["bias"])


def _export_perceiver(sd: Dict[str, np.ndarray], p: Dict[str, Any]) -> None:
    pe = "perceiver_encoder."
    kernel = _np(p["proj_context"]["kernel"])
    bias = _np(p["proj_context"]["bias"])
    # the converter makes an eye kernel where the reference used nn.Identity
    # (dim_context == dim, perceiver.py:234); omit those keys so the dict
    # matches the reference module's state_dict
    is_identity = (kernel.shape[0] == kernel.shape[1]
                   and np.array_equal(kernel, np.eye(kernel.shape[0], dtype=kernel.dtype))
                   and not bias.any())
    if not is_identity:
        sd[pe + "proj_context.weight"] = kernel.T
        sd[pe + "proj_context.bias"] = bias
    sd[pe + "latents"] = _np(p["latents"])
    attn, ff = p["layers"]["attn"], p["layers"]["ff"]
    to_q, to_kv, to_out = _np(attn["to_q"]), _np(attn["to_kv"]), _np(attn["to_out"])
    w1, b1 = _np(ff["w1"]["kernel"]), _np(ff["w1"]["bias"])
    w2, b2 = _np(ff["w2"]["kernel"]), _np(ff["w2"]["bias"])
    for i in range(to_q.shape[0]):
        sd[pe + f"layers.{i}.0.to_q.weight"] = to_q[i].T
        sd[pe + f"layers.{i}.0.to_kv.weight"] = to_kv[i].T
        sd[pe + f"layers.{i}.0.to_out.weight"] = to_out[i].T
        sd[pe + f"layers.{i}.1.0.weight"] = w1[i].T
        sd[pe + f"layers.{i}.1.0.bias"] = b1[i]
        sd[pe + f"layers.{i}.1.2.weight"] = w2[i].T
        sd[pe + f"layers.{i}.1.2.bias"] = b2[i]
    sd[pe + "norm.gamma"] = _np(p["norm"]["gamma"])


def save_gpt_pth(path: str, params: Dict[str, Any], cfg: GPTConfig,
                 extras: Optional[Dict[str, Any]] = None, save_dtype: str = "fp16") -> str:
    """Write ``{'model': sd}`` (+ top-level speaker extras), loadable by the
    reference's strict load and by `io/checkpoint.load_gpt_checkpoint`.
    save_dtype defaults to fp16 as the reference's (train.py:817)."""
    sd = _to_torch_sd(export_gpt_state_dict(params, cfg), save_dtype)
    ckpt: Dict[str, Any] = {"model": sd}
    extras = extras or {}
    if extras.get("mean_condition") is not None:
        # stored inside the model state_dict (utils/checkpoint.py:70-77)
        sd["mean_condition"] = torch.from_numpy(_np(extras["mean_condition"]))
    if extras.get("speaker_conditions"):
        # the reference loader calls torch.from_numpy on these: they stay
        # numpy (utils/checkpoint.py:53)
        ckpt["speaker_conditions"] = {
            str(k): _np(v).reshape(1, *_np(v).shape[-2:])
            for k, v in extras["speaker_conditions"].items()}
        ckpt["speakers"] = list(extras.get("speakers", sorted(ckpt["speaker_conditions"])))
    elif extras.get("speakers"):
        ckpt["speakers"] = list(extras["speakers"])
    if extras.get("speaker_mels"):
        # per-speaker vocoder mels [n_mels, T] for speaker_id-only synthesis;
        # an extra top-level key the reference loader ignores
        ckpt["speaker_mels"] = {str(k): _np(v) for k, v in extras["speaker_mels"].items()}
    torch.save(ckpt, path)
    return path


def speaker_extras(data_path: str, speakers: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Each speaker's medoid condition and vocoder mel from an extraction
    output directory, as the reference's fine-tuned .pth carries them
    (utils/checkpoint.py:42-62): `save_gpt_pth`'s extras.  `speakers`
    defaults to speaker_info.json's, else the directory's subdirectories."""
    if speakers is None:
        info = os.path.join(data_path, "speaker_info.json")
        if os.path.exists(info):
            with open(info, "r", encoding="utf-8") as f:
                speakers = [it["speaker"] for it in json.load(f) if "speaker" in it]
        else:
            speakers = [d for d in sorted(os.listdir(data_path))
                        if os.path.isdir(os.path.join(data_path, d))]
    extras: Dict[str, Any] = {}
    conds, mels = {}, {}
    for sp in speakers:
        cpath = os.path.join(data_path, sp, "medoid_condition.npy")
        mpath = os.path.join(data_path, sp, "medoid_mel.npy")
        if os.path.exists(cpath):
            conds[sp] = np.load(cpath)
        if os.path.exists(mpath):
            mels[sp] = np.load(mpath)
    if conds:
        extras["speaker_conditions"] = conds
        extras["speakers"] = sorted(conds)
    if mels:
        extras["speaker_mels"] = mels
    return extras


# ---------------------------------------------------------------------------
# BigVGAN generator (bigvgan_generator.pth)
# ---------------------------------------------------------------------------

def _wn(sd: Dict[str, np.ndarray], base: str, p: Dict[str, Any]) -> None:
    """A folded weight -> torch weight_norm(dim=0) pair with ``weight_v = w``
    and ``weight_g = ||w||`` (over dims 1..), whose fold gives back ``w``."""
    w, b = _np(p["w"]), _np(p["b"])
    axes = tuple(range(1, w.ndim))
    sd[base + ".weight_g"] = np.sqrt(np.sum(w * w, axis=axes, keepdims=True)).astype(np.float32)
    sd[base + ".weight_v"] = w
    sd[base + ".bias"] = b


def _plain(sd: Dict[str, np.ndarray], base: str, p: Dict[str, Any]) -> None:
    sd[base + ".weight"] = _np(p["w"])
    sd[base + ".bias"] = _np(p["b"])


def _export_ecapa(sd: Dict[str, np.ndarray], prefix: str, p: Dict[str, Any]) -> None:
    def conv(base: str, c: Dict[str, Any]) -> None:
        sd[base + ".conv.weight"] = _np(c["w"])
        sd[base + ".conv.bias"] = _np(c["b"])

    def bn(base: str, n: Dict[str, Any]) -> None:
        sd[base + ".norm.weight"] = _np(n["scale"])
        sd[base + ".norm.bias"] = _np(n["bias"])
        sd[base + ".norm.running_mean"] = _np(n["mean"])
        sd[base + ".norm.running_var"] = _np(n["var"])
        # the reference's strict BigVGAN load (infer.py:393) needs the BN
        # step counter too
        sd[base + ".norm.num_batches_tracked"] = np.zeros((), np.int64)

    def tdnn(base: str, t: Dict[str, Any]) -> None:
        conv(base + ".conv", t["conv"])
        bn(base + ".norm", t["bn"])

    blocks = p["blocks"]
    tdnn(prefix + "blocks.0", blocks[0])
    for i, blk in enumerate(blocks[1:], start=1):
        tdnn(prefix + f"blocks.{i}.tdnn1", blk["tdnn1"])
        for j, r in enumerate(blk["res2net"]):
            tdnn(prefix + f"blocks.{i}.res2net_block.blocks.{j}", r)
        tdnn(prefix + f"blocks.{i}.tdnn2", blk["tdnn2"])
        conv(prefix + f"blocks.{i}.se_block.conv1", blk["se"]["conv1"])
        conv(prefix + f"blocks.{i}.se_block.conv2", blk["se"]["conv2"])
    tdnn(prefix + "mfa", p["mfa"])
    tdnn(prefix + "asp.tdnn", p["asp"]["tdnn"])
    conv(prefix + "asp.conv", p["asp"]["conv"])
    bn(prefix + "asp_bn", p["asp_bn"])
    conv(prefix + "fc", p["fc"])


def export_bigvgan_state_dict(params: Dict[str, Any],
                              cfg: BigVGANConfig) -> Dict[str, np.ndarray]:
    """Inverse of checkpoint.convert_bigvgan_state_dict.  The modules the
    reference wraps in weight_norm (conv_pre, ups, resblock convs,
    conv_post; models.py:151-186) regain their weight_g/weight_v split; the
    cond layers and ECAPA stay plain."""
    sd: Dict[str, np.ndarray] = {}
    n_up = len(cfg.upsample_rates)
    n_kernels = len(cfg.resblock_kernel_sizes)
    _wn(sd, "conv_pre", params["conv_pre"])
    _plain(sd, "cond_layer", params["cond_layer"])
    _export_ecapa(sd, "speaker_encoder.", params["speaker_encoder"])
    for i in range(n_up):
        _wn(sd, f"ups.{i}.0", params["ups"][i])
        _plain(sd, f"conds.{i}", params["conds"][i])
    for idx in range(n_up * n_kernels):
        blk = params["resblocks"][idx]
        p = f"resblocks.{idx}."
        n_d = len(cfg.resblock_dilation_sizes[idx % n_kernels])
        for j in range(n_d):
            _wn(sd, p + f"convs1.{j}", blk["convs1"][j])
            _wn(sd, p + f"convs2.{j}", blk["convs2"][j])
        for j in range(2 * n_d):
            sd[p + f"activations.{j}.act.alpha"] = _np(blk["acts"][j]["alpha"])
            sd[p + f"activations.{j}.act.beta"] = _np(blk["acts"][j]["beta"])
    sd["activation_post.act.alpha"] = _np(params["activation_post"]["alpha"])
    sd["activation_post.act.beta"] = _np(params["activation_post"]["beta"])
    _wn(sd, "conv_post", params["conv_post"])
    return sd


def save_bigvgan_pth(path: str, params: Dict[str, Any], cfg: Optional[BigVGANConfig] = None,
                     save_dtype: str = "fp32") -> str:
    """Write ``{'generator': state_dict}`` as the reference's
    bigvgan_generator.pth (infer.py:392-393)."""
    cfg = cfg or BigVGANConfig()
    torch.save({"generator": _to_torch_sd(export_bigvgan_state_dict(params, cfg), save_dtype)},
               path)
    return path


# ---------------------------------------------------------------------------
# DVAE (dvae.pth)
# ---------------------------------------------------------------------------

def export_dvae_state_dict(params: Dict[str, Any], cfg: VQVAEConfig) -> Dict[str, np.ndarray]:
    """Inverse of checkpoint.convert_dvae_state_dict (the layer indices of
    xtts_dvae.py:258-298 at the shipped config)."""
    sd: Dict[str, np.ndarray] = {}
    n_res = cfg.num_resnet_blocks

    def conv(key: str, p: Dict[str, Any]) -> None:
        sd[key + ".weight"] = _np(p["w"])
        sd[key + ".bias"] = _np(p["b"])

    def res(prefix: str, first: int, blk: Dict[str, Any]) -> None:
        for name, j in (("c1", 0), ("c2", 2), ("c3", 4)):
            w, b = _np(blk[name]["w"]), _np(blk[name]["b"])
            for n in range(n_res):
                sd[f"{prefix}.{first + n}.net.{j}.weight"] = w[n]
                sd[f"{prefix}.{first + n}.net.{j}.bias"] = b[n]

    conv("encoder.0.0", params["enc_conv0"])
    conv("encoder.1.0", params["enc_conv1"])
    res("encoder", 2, params["enc_res"])
    conv(f"encoder.{2 + n_res}", params["enc_out"])
    for k in ("embed", "cluster_size", "embed_avg"):
        sd[f"codebook.{k}"] = _np(params["codebook"][k])
    conv("decoder.0", params["dec_in"])
    res("decoder", 1, params["dec_res"])
    conv(f"decoder.{1 + n_res}.0.conv", params["dec_up0"])
    conv(f"decoder.{2 + n_res}.0.conv", params["dec_up1"])
    conv(f"decoder.{3 + n_res}", params["dec_out"])
    return sd


def save_dvae_pth(path: str, params: Dict[str, Any], cfg: Optional[VQVAEConfig] = None,
                  save_dtype: str = "fp32") -> str:
    """Write the DiscreteVAE state_dict, flat, as the reference's dvae.pth."""
    cfg = cfg or VQVAEConfig()
    torch.save(_to_torch_sd(export_dvae_state_dict(params, cfg), save_dtype), path)
    return path
