"""Reference ``.pth`` checkpoints -> the port's numpy parameter trees (the
port's own copy of indextts_tpu/io/checkpoint.py).

Three reference formats (utils/checkpoint.py:23-89, infer.py:392-393):

  * ``gpt.pth``: a UnifiedVoice state_dict, flat or nested under "model" or
    "state_dict", optionally with top-level "speaker_conditions",
    "speakers" and "speaker_mels", and "mean_condition" /
    "mean_condition_<id>" inside the state_dict;
  * ``bigvgan_generator.pth``: {"generator": state_dict} with weight-norm
    ``weight_g``/``weight_v`` pairs (or torch's ``parametrizations.weight.
    original0/1``), folded here into plain weights (the reference calls
    remove_weight_norm() at load, models.py:254-262);
  * ``dvae.pth``: a DiscreteVAE state_dict (xtts_dvae.py:258-298), flat or
    nested under "model" or "state_dict".

Every tensor becomes float32 numpy at once (fp16 and bf16 saves go through
torch's fp32 upcast, which numpy cannot do for bf16); `io/from_jax.py` then
checks the tree against the port's layout and copies it to the device.

The port's own checkpoint directories (`save_pytree` / `load_pytree`: the
trainer's resume and merged-weight directories) are an `.npz` of arrays
beside a JSON file of the tree.  The JAX package writes orbax directories
instead, which need JAX to read; weights cross between the packages as
`.pth` files.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import (CONFORMER_CONDITION_TYPES, BigVGANConfig, GPTConfig,
                                       VQVAEConfig)


def _load_torch_state(path: str) -> Any:
    # reference files carry numpy arrays in speaker_conditions, which the
    # weights_only loader of torch >= 2.6 refuses
    return torch.load(path, map_location="cpu", weights_only=False)


class _SDView:
    """State-dict view that raises actionable KeyErrors (the checkpoint
    format and nearby keys, not a bare key) and records the keys a converter
    consumed, so unexpected leftovers are reported, not silently ignored."""

    def __init__(self, sd: Dict[str, Any], what: str):
        self._sd = sd
        self._what = what
        self.consumed: set = set()

    def __getitem__(self, k: str):
        try:
            v = self._sd[k]
        except KeyError:
            close = [s for s in self._sd if s.split(".")[0] == k.split(".")[0]]
            raise KeyError(
                f"checkpoint is missing key '{k}' (expected a {self._what} "
                f"state_dict with {len(self._sd)} keys; nearby keys: "
                f"{sorted(close)[:4] or sorted(self._sd)[:4]} …). "
                "If this is a raw training checkpoint, pass the file that "
                "nests the weights under 'model'/'generator'.") from None
        self.consumed.add(k)
        return v

    def __contains__(self, k: str) -> bool:
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def warn_leftovers(self, ignore_patterns: Tuple[str, ...]) -> None:
        left = [k for k in self._sd if k not in self.consumed
                and not any(re.search(p, k) for p in ignore_patterns)]
        if left:
            warnings.warn(
                f"{self._what} checkpoint carries {len(left)} unexpected "
                f"key(s) not mapped into the model (first few: "
                f"{sorted(left)[:6]}); they were ignored — check the "
                "checkpoint matches the configured architecture",
                RuntimeWarning)


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t)


def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """reference normalize_state_dict_keys (train.py:40-52)."""
    if not any(k.startswith("module.") for k in sd):
        return sd
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _parametrized_weight_norm(sd: Dict[str, Any]) -> Dict[str, Any]:
    """torch.nn.utils.parametrizations.weight_norm names its pair
    `parametrizations.weight.original0` (g) and `.original1` (v)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"(.*)parametrizations\.weight\.original([01])$", k)
        if m:
            k = m.group(1) + ("weight_g" if m.group(2) == "0" else "weight_v")
        out[k] = v
    return out


def fold_weight_norm(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Fold weight_g/weight_v pairs into plain `weight` tensors.

    torch weight_norm(dim=0): w = g * v / ||v|| with the norm over all dims
    except 0."""
    sd = _parametrized_weight_norm(sd)
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            g = _to_np(sd[base + "weight_g"])
            vv = _to_np(v)
            axes = tuple(range(1, vv.ndim))
            norm = np.sqrt(np.sum(vv * vv, axis=axes, keepdims=True))
            out[base + "weight"] = g * vv / np.maximum(norm, 1e-12)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# UnifiedVoice (gpt.pth)
# ---------------------------------------------------------------------------

def convert_gpt_state_dict(sd: Dict[str, Any], cfg: GPTConfig) -> Dict[str, Any]:
    """Reference UnifiedVoice state_dict -> parameter tree (numpy leaves).

    Key families (gpt/model.py:312-392): conditioning_encoder (the conformer,
    or the legacy AttentionBlock encoder), perceiver_encoder, text/mel
    embeddings, per-stream position embeddings, gpt.h.* trunk (HF Conv1D
    [in, out] layout, no transpose), final_norm, text/mel heads (nn.Linear
    [out, in], transposed here)."""
    sd = _SDView({k: v for k, v in _strip_module_prefix(sd).items()
                  if not k.startswith("inference_model.")},
                 "UnifiedVoice (gpt.pth)")
    g = lambda k: _to_np(sd[k])  # noqa: E731
    L = cfg.layers
    # keys a real reference checkpoint carries that are correct to ignore:
    # HF GPT2's unused wte/wpe tables (gpt/model.py:263-286), its causal-mask
    # buffers, and speaker extras the loader takes out
    _IGNORE = (r"^gpt\.wte\.", r"^gpt\.wpe\.",
               r"\.attn\.(bias|masked_bias)$", r"^mean_condition")

    def stack(fmt: str) -> np.ndarray:
        return np.stack([_to_np(sd[fmt.format(i)]) for i in range(L)])

    gpt_params = {
        "blocks": {
            "ln_1": {"scale": stack("gpt.h.{}.ln_1.weight"), "bias": stack("gpt.h.{}.ln_1.bias")},
            "attn": {
                "qkv_w": stack("gpt.h.{}.attn.c_attn.weight"),
                "qkv_b": stack("gpt.h.{}.attn.c_attn.bias"),
                "proj_w": stack("gpt.h.{}.attn.c_proj.weight"),
                "proj_b": stack("gpt.h.{}.attn.c_proj.bias"),
            },
            "ln_2": {"scale": stack("gpt.h.{}.ln_2.weight"), "bias": stack("gpt.h.{}.ln_2.bias")},
            "mlp": {
                "fc_w": stack("gpt.h.{}.mlp.c_fc.weight"),
                "fc_b": stack("gpt.h.{}.mlp.c_fc.bias"),
                "proj_w": stack("gpt.h.{}.mlp.c_proj.weight"),
                "proj_b": stack("gpt.h.{}.mlp.c_proj.bias"),
            },
        },
        "ln_f": {"scale": g("gpt.ln_f.weight"), "bias": g("gpt.ln_f.bias")},
    }

    ce = "conditioning_encoder."
    if cfg.condition_type not in CONFORMER_CONDITION_TYPES:
        # the legacy AttentionBlock encoder of "perceiver" and the mean-pooled
        # default (arch_util.py:84-126); conv1d kernels are [out, in, 1]
        n_attn = len({k.split(".")[2] for k in sd if k.startswith(ce + "attn.")})

        def pointwise1(k):
            return {"w": g(ce + k + ".weight")[:, :, 0], "b": g(ce + k + ".bias")}

        cond_params = {
            "init": pointwise1("init"),
            "attn": [{"norm": {"scale": g(ce + f"attn.{i}.norm.weight"),
                               "bias": g(ce + f"attn.{i}.norm.bias")},
                      "qkv": pointwise1(f"attn.{i}.qkv"),
                      "proj": pointwise1(f"attn.{i}.proj_out")}
                     for i in range(n_attn)],
        }
        out = {
            "conditioning_encoder": cond_params,
            "perceiver_encoder": (_convert_perceiver(sd) if cfg.condition_type == "perceiver"
                                  else {}),
            **_embed_and_heads(g),
            "gpt": gpt_params,
        }
        sd.warn_leftovers(_IGNORE)
        return out
    CL = cfg.condition_module.num_blocks

    def cstack(fmt: str, transpose: bool = False) -> np.ndarray:
        arrs = [_to_np(sd[ce + fmt.format(i)]) for i in range(CL)]
        if transpose:
            arrs = [a.T for a in arrs]
        return np.stack(arrs)

    def pointwise(name: str) -> np.ndarray:   # conv1d [out, in, 1] -> kernel [in, out]
        return np.stack([_to_np(sd[ce + f"encoders.{i}.conv_module.{name}.weight"])[:, :, 0].T
                         for i in range(CL)])

    conformer_params = {
        "embed": {
            "conv": {"w": g(ce + "embed.conv.0.weight"), "b": g(ce + "embed.conv.0.bias")},
            "out": {"kernel": g(ce + "embed.out.0.weight").T, "bias": g(ce + "embed.out.0.bias")},
        },
        "blocks": {
            "norm_mha": {"scale": cstack("encoders.{}.norm_mha.weight"),
                         "bias": cstack("encoders.{}.norm_mha.bias")},
            "attn": {
                "q": {"kernel": cstack("encoders.{}.self_attn.linear_q.weight", True),
                      "bias": cstack("encoders.{}.self_attn.linear_q.bias")},
                "k": {"kernel": cstack("encoders.{}.self_attn.linear_k.weight", True),
                      "bias": cstack("encoders.{}.self_attn.linear_k.bias")},
                "v": {"kernel": cstack("encoders.{}.self_attn.linear_v.weight", True),
                      "bias": cstack("encoders.{}.self_attn.linear_v.bias")},
                "out": {"kernel": cstack("encoders.{}.self_attn.linear_out.weight", True),
                        "bias": cstack("encoders.{}.self_attn.linear_out.bias")},
                "pos": {"kernel": cstack("encoders.{}.self_attn.linear_pos.weight", True)},
                "pos_bias_u": cstack("encoders.{}.self_attn.pos_bias_u"),
                "pos_bias_v": cstack("encoders.{}.self_attn.pos_bias_v"),
            },
            "norm_conv": {"scale": cstack("encoders.{}.norm_conv.weight"),
                          "bias": cstack("encoders.{}.norm_conv.bias")},
            "conv": {
                "pw1": {"kernel": pointwise("pointwise_conv1"),
                        "bias": cstack("encoders.{}.conv_module.pointwise_conv1.bias")},
                "dw": {"w": cstack("encoders.{}.conv_module.depthwise_conv.weight"),
                       "b": cstack("encoders.{}.conv_module.depthwise_conv.bias")},
                "norm": {"scale": cstack("encoders.{}.conv_module.norm.weight"),
                         "bias": cstack("encoders.{}.conv_module.norm.bias")},
                "pw2": {"kernel": pointwise("pointwise_conv2"),
                        "bias": cstack("encoders.{}.conv_module.pointwise_conv2.bias")},
            },
            "norm_ff": {"scale": cstack("encoders.{}.norm_ff.weight"),
                        "bias": cstack("encoders.{}.norm_ff.bias")},
            "ff": {
                "w1": {"kernel": cstack("encoders.{}.feed_forward.w_1.weight", True),
                       "bias": cstack("encoders.{}.feed_forward.w_1.bias")},
                "w2": {"kernel": cstack("encoders.{}.feed_forward.w_2.weight", True),
                       "bias": cstack("encoders.{}.feed_forward.w_2.bias")},
            },
            "norm_final": {"scale": cstack("encoders.{}.norm_final.weight"),
                           "bias": cstack("encoders.{}.norm_final.bias")},
        },
        "after_norm": {"scale": g(ce + "after_norm.weight"), "bias": g(ce + "after_norm.bias")},
    }

    out = {
        "conditioning_encoder": conformer_params,
        "perceiver_encoder": _convert_perceiver(sd),
        **_embed_and_heads(g),
        "gpt": gpt_params,
    }
    sd.warn_leftovers(_IGNORE)
    return out


def _convert_perceiver(sd) -> Dict[str, Any]:
    """perceiver_encoder.* keys -> parameter tree (perceiver.py:219-256,
    depth 2)."""
    g = lambda k: _to_np(sd[k])  # noqa: E731
    pe = "perceiver_encoder."
    PD = 2

    def pstack(fmt: str) -> np.ndarray:   # nn.Linear [out, in] -> kernel [in, out]
        return np.stack([_to_np(sd[pe + fmt.format(i)]).T for i in range(PD)])

    def bstack(fmt: str) -> np.ndarray:
        return np.stack([_to_np(sd[pe + fmt.format(i)]) for i in range(PD)])

    if pe + "proj_context.weight" in sd:
        proj = {"kernel": g(pe + "proj_context.weight").T,
                "bias": g(pe + "proj_context.bias")}
    else:
        # dim_context == dim: the reference uses nn.Identity (perceiver.py:
        # 234); an eye kernel reproduces it through the always-projecting
        # forward
        D = _to_np(sd[pe + "latents"]).shape[1]
        proj = {"kernel": np.eye(D, dtype=np.float32), "bias": np.zeros((D,), np.float32)}
    return {
        "proj_context": proj,
        "latents": g(pe + "latents"),
        "layers": {
            "attn": {"to_q": pstack("layers.{}.0.to_q.weight"),
                     "to_kv": pstack("layers.{}.0.to_kv.weight"),
                     "to_out": pstack("layers.{}.0.to_out.weight")},
            "ff": {"w1": {"kernel": pstack("layers.{}.1.0.weight"),
                          "bias": bstack("layers.{}.1.0.bias")},
                   "w2": {"kernel": pstack("layers.{}.1.2.weight"),
                          "bias": bstack("layers.{}.1.2.bias")}},
        },
        "norm": {"gamma": g(pe + "norm.gamma")},
    }


def _embed_and_heads(g) -> Dict[str, Any]:
    """Embeddings, position tables, final_norm and heads
    (gpt/model.py:367-385)."""
    return {
        "text_embedding": {"weight": g("text_embedding.weight")},
        "mel_embedding": {"weight": g("mel_embedding.weight")},
        "mel_pos_embedding": {"weight": g("mel_pos_embedding.emb.weight")},
        "text_pos_embedding": {"weight": g("text_pos_embedding.emb.weight")},
        "final_norm": {"scale": g("final_norm.weight"), "bias": g("final_norm.bias")},
        "text_head": {"kernel": g("text_head.weight").T, "bias": g("text_head.bias")},
        "mel_head": {"kernel": g("mel_head.weight").T, "bias": g("mel_head.bias")},
    }


def load_gpt_checkpoint(path: str, cfg: GPTConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference gpt checkpoint.  Returns (params, extras); extras may
    hold 'speaker_conditions' {id: [1, 32, D]}, 'speakers', 'speaker_mels'
    {id: [n_mels, T]} and 'mean_condition', all float32 numpy
    (utils/checkpoint.py:42-89)."""
    ckpt = _load_torch_state(path)
    if not isinstance(ckpt, dict):
        raise ValueError(
            f"{path}: expected a dict checkpoint (state_dict or "
            f"{{'model': state_dict}}), got {type(ckpt).__name__}")
    extras: Dict[str, Any] = {}
    if "speaker_conditions" in ckpt:
        extras["speaker_conditions"] = {
            k: _to_np(v).astype(np.float32).reshape(1, *_to_np(v).shape[-2:])
            for k, v in ckpt["speaker_conditions"].items()}
    if "speakers" in ckpt:
        extras["speakers"] = list(ckpt["speakers"])
    if "speaker_mels" in ckpt:
        # per-speaker vocoder reference mels [n_mels, T]: the vocoder's ECAPA
        # conditioning for speaker_id-only synthesis
        extras["speaker_mels"] = {k: _to_np(v).astype(np.float32)
                                  for k, v in ckpt["speaker_mels"].items()}
    sd = next((ckpt[n] for n in ("model", "state_dict") if n in ckpt), ckpt)
    sd = _strip_module_prefix(dict(sd))
    if "mean_condition" in sd:
        extras["mean_condition"] = _to_np(sd.pop("mean_condition"))
    # learnable per-speaker conditions stored flat in the state dict
    for k in list(sd):
        m = re.match(r"mean_condition_(.+)$", k)
        if m:
            extras.setdefault("speaker_conditions", {})[m.group(1)] = _to_np(sd.pop(k))
    return convert_gpt_state_dict(sd, cfg), extras


# ---------------------------------------------------------------------------
# DVAE (dvae.pth)
# ---------------------------------------------------------------------------

def convert_dvae_state_dict(sd: Dict[str, Any], cfg: VQVAEConfig) -> Dict[str, Any]:
    """DiscreteVAE state_dict -> parameter tree (layer indices of
    xtts_dvae.py:258-298 at the shipped config: encoder.0-1 the stride-2
    convs, then the residual blocks and the output conv; decoder.0 the input
    conv, then the residual blocks, two upsampled convs and the output)."""
    sd = _SDView(_strip_module_prefix(dict(sd)), "DiscreteVAE (dvae.pth)")
    g = lambda k: _to_np(sd[k])  # noqa: E731
    n_res = cfg.num_resnet_blocks

    def conv(key: str) -> Dict[str, np.ndarray]:
        return {"w": g(key + ".weight"), "b": g(key + ".bias")}

    def res(prefix: str, first: int) -> Dict[str, Any]:
        idx = range(first, first + n_res)
        return {name: {"w": np.stack([g(f"{prefix}.{i}.net.{j}.weight") for i in idx]),
                       "b": np.stack([g(f"{prefix}.{i}.net.{j}.bias") for i in idx])}
                for name, j in (("c1", 0), ("c2", 2), ("c3", 4))}

    out = {
        "enc_conv0": conv("encoder.0.0"),
        "enc_conv1": conv("encoder.1.0"),
        "enc_res": res("encoder", 2),
        "enc_out": conv(f"encoder.{2 + n_res}"),
        "codebook": {"embed": g("codebook.embed"), "cluster_size": g("codebook.cluster_size"),
                     "embed_avg": g("codebook.embed_avg")},
        "dec_in": conv("decoder.0"),
        "dec_res": res("decoder", 1),
        "dec_up0": conv(f"decoder.{1 + n_res}.0.conv"),
        "dec_up1": conv(f"decoder.{2 + n_res}.0.conv"),
        "dec_out": conv(f"decoder.{3 + n_res}"),
    }
    sd.warn_leftovers((r"\.initted$", r"^codebook\.initted"))
    return out


def load_dvae_checkpoint(path: str, cfg: Optional[VQVAEConfig] = None) -> Dict[str, Any]:
    """A reference dvae.pth -> the DVAE parameter tree (float32 numpy)."""
    cfg = cfg or VQVAEConfig()
    ckpt = _load_torch_state(path)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict checkpoint, got {type(ckpt).__name__}")
    sd = next((ckpt[n] for n in ("model", "state_dict") if n in ckpt), ckpt)
    return convert_dvae_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# BigVGAN generator (bigvgan_generator.pth)
# ---------------------------------------------------------------------------

def _ecapa_convert(sd: _SDView, prefix: str, n_blocks: int = 4) -> Dict[str, Any]:
    g = lambda k: _to_np(sd[prefix + k])  # noqa: E731

    def conv(k):
        return {"w": g(k + ".conv.weight"), "b": g(k + ".conv.bias")}

    def bn(k):
        return {"scale": g(k + ".norm.weight"), "bias": g(k + ".norm.bias"),
                "mean": g(k + ".norm.running_mean"), "var": g(k + ".norm.running_var")}

    def tdnn(k):
        return {"conv": conv(k + ".conv"), "bn": bn(k + ".norm")}

    blocks: List[Dict[str, Any]] = [tdnn("blocks.0")]
    scale = 8
    for i in range(1, n_blocks):
        blocks.append({
            "tdnn1": tdnn(f"blocks.{i}.tdnn1"),
            "res2net": [tdnn(f"blocks.{i}.res2net_block.blocks.{j}") for j in range(scale - 1)],
            "tdnn2": tdnn(f"blocks.{i}.tdnn2"),
            "se": {"conv1": conv(f"blocks.{i}.se_block.conv1"),
                   "conv2": conv(f"blocks.{i}.se_block.conv2")},
        })
    return {"blocks": blocks, "mfa": tdnn("mfa"),
            "asp": {"tdnn": tdnn("asp.tdnn"), "conv": conv("asp.conv")},
            "asp_bn": bn("asp_bn"), "fc": conv("fc")}


def convert_bigvgan_state_dict(sd: Dict[str, Any], cfg: BigVGANConfig) -> Dict[str, Any]:
    sd = _SDView(fold_weight_norm(_strip_module_prefix(dict(sd))),
                 "BigVGAN generator (bigvgan_generator.pth)")
    g = lambda k: _to_np(sd[k])  # noqa: E731
    n_up = len(cfg.upsample_rates)
    n_kernels = len(cfg.resblock_kernel_sizes)

    params: Dict[str, Any] = {
        "conv_pre": {"w": g("conv_pre.weight"), "b": g("conv_pre.bias")},
        "cond_layer": {"w": g("cond_layer.weight"), "b": g("cond_layer.bias")},
        "speaker_encoder": _ecapa_convert(sd, "speaker_encoder."),
        "ups": [{"w": g(f"ups.{i}.0.weight"), "b": g(f"ups.{i}.0.bias")} for i in range(n_up)],
        "conds": [{"w": g(f"conds.{i}.weight"), "b": g(f"conds.{i}.bias")}
                  for i in range(n_up)],
        "resblocks": [],
    }
    for idx in range(n_up * n_kernels):
        p = f"resblocks.{idx}."
        n_d = len(cfg.resblock_dilation_sizes[idx % n_kernels])
        params["resblocks"].append({
            "convs1": [{"w": g(p + f"convs1.{j}.weight"), "b": g(p + f"convs1.{j}.bias")}
                       for j in range(n_d)],
            "convs2": [{"w": g(p + f"convs2.{j}.weight"), "b": g(p + f"convs2.{j}.bias")}
                       for j in range(n_d)],
            "acts": [{"alpha": g(p + f"activations.{j}.act.alpha"),
                      "beta": g(p + f"activations.{j}.act.beta")} for j in range(2 * n_d)],
        })
    params["activation_post"] = {"alpha": g("activation_post.act.alpha"),
                                 "beta": g("activation_post.act.beta")}
    params["conv_post"] = {"w": g("conv_post.weight"), "b": g("conv_post.bias")}
    # BatchNorm bookkeeping buffers in the ECAPA encoder are expected noise
    sd.warn_leftovers((r"num_batches_tracked$",))
    return params


def load_bigvgan_checkpoint(path: str, cfg: Optional[BigVGANConfig] = None) -> Dict[str, Any]:
    cfg = cfg or BigVGANConfig()
    ckpt = _load_torch_state(path)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict checkpoint, got {type(ckpt).__name__}")
    sd = next((ckpt[n] for n in ("generator", "model", "state_dict") if n in ckpt), ckpt)
    return convert_bigvgan_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# native checkpoint directories
# ---------------------------------------------------------------------------

PYTREE_FILE = "pytree.json"
ARRAYS_FILE = "arrays.npz"
_FORMAT = "indextts_tpu_torch.pytree"
# the files an orbax checkpoint directory (the JAX package's format) holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """Write a tree of dicts (string keys), lists and tuples over tensors and
    int / float scalars as a directory: the arrays in `arrays.npz` (bf16 as
    its uint16 bits) and the structure, dtypes and scalars in
    `pytree.json`.  No pickle.  Replaces the directory's files if they
    exist."""
    arrays: Dict[str, np.ndarray] = {}

    def node(x, where):
        if isinstance(x, dict):
            bad = [k for k in x if not isinstance(k, str)]
            if bad:
                raise TypeError(f"{where}: keys must be strings, got {bad!r}")
            return {"dict": {k: node(v, f"{where}.{k}") for k, v in x.items()}}
        if isinstance(x, (list, tuple)):
            kind = "list" if isinstance(x, list) else "tuple"
            return {kind: [node(v, f"{where}[{i}]") for i, v in enumerate(x)]}
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            dtype = str(t.dtype).replace("torch.", "")
            arr = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            key = f"a{len(arrays)}"
            arrays[key] = arr
            return {"array": key, "dtype": dtype, "shape": list(t.shape)}
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            return {"value": x}
        raise TypeError(f"{where}: cannot save a {type(x).__name__}")

    desc = {"format": _FORMAT, "version": 1, "tree": node(tree, "tree")}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, ARRAYS_FILE), **arrays)
    with open(os.path.join(path, PYTREE_FILE), "w", encoding="utf-8") as f:
        json.dump(desc, f)


def load_pytree(path: str, device="cpu") -> Any:
    """Read a directory written by `save_pytree`: tensors on `device`,
    scalars as Python numbers.  The JAX package's orbax directories are
    refused: carry weights across as a `.pth` file instead."""
    desc_path = os.path.join(path, PYTREE_FILE)
    if not os.path.exists(desc_path):
        if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint directory (the JAX package's format), "
                "which this package cannot read; export the weights as a .pth file "
                "(indextts_tpu.io.export.save_gpt_pth, or the gpt_epoch_N.pth / "
                "gpt_finetuned.pth its trainer writes) and load that")
        raise FileNotFoundError(f"{path}: no {PYTREE_FILE}; not a checkpoint directory "
                                "written by io/checkpoint.save_pytree")
    with open(desc_path, encoding="utf-8") as f:
        desc = json.load(f)
    if desc.get("format") != _FORMAT:
        raise ValueError(f"{desc_path}: format {desc.get('format')!r} is not {_FORMAT!r}")
    with np.load(os.path.join(path, ARRAYS_FILE)) as npz:
        def build(n):
            if "dict" in n:
                return {k: build(v) for k, v in n["dict"].items()}
            if "list" in n:
                return [build(v) for v in n["list"]]
            if "tuple" in n:
                return tuple(build(v) for v in n["tuple"])
            if "array" in n:
                t = torch.from_numpy(npz[n["array"]])
                if n["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                return t.reshape(n["shape"]).to(device)
            return n["value"]

        return build(desc["tree"])
