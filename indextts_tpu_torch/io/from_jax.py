"""Carry parameters across from the JAX package.

The port keeps the JAX package's parameter trees (nested dicts and lists,
stacked GPT blocks, torch-layout conv weights), so loading a tree exported
as numpy (``jax.tree.map(np.asarray, params)``, done by the caller) is a
plain copy.  Each loader checks the tree against the port's own layout for
the config before copying.  Quantized GPT leaves (ops/quantization.py:
int8 ``{"q", "s"}``, fused int4 ``{"q4", "s"}``, shared int4 ``{"q4s", "s"}``)
carry across as they are, int8 data and fp32 scales, after the same check.
Leaves may also be torch tensors (a tree from io/checkpoint.load_pytree).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import BigVGANConfig, GPTConfig, LoRAConfig, VQVAEConfig
from indextts_tpu_torch.models import bigvgan, discriminators, dvae, unified_voice
from indextts_tpu_torch.train import lora


def _quantized_leaf(tree: dict, like: torch.Tensor, device, path: str):
    """A quantized leaf standing for the float matrix `like` [.., K, N]."""
    *lead, K, N = like.shape
    forms = {frozenset({"q", "s"}): ("q", K, 1), frozenset({"q4", "s"}): ("q4", K // 2, None),
             frozenset({"q4s", "s"}): ("q4s", K // 2, 1)}
    form = forms.get(frozenset(tree))
    if form is None:
        raise ValueError(f"{path}: keys {sorted(tree)} are no quantized form")
    key, rows, srows = form
    q, s = np.asarray(tree[key]), np.asarray(tree["s"])
    if srows is None:   # fused int4: 2G scale rows, K splitting into G chunks of two halves
        srows = s.shape[-2] if s.ndim == len(lead) + 2 and s.shape[-2] % 2 == 0 else -1
        if srows <= 0 or K % srows:
            raise ValueError(f"{path}.s: shape {s.shape} has no 2G rows dividing K={K}")
    want_q, want_s = tuple(lead) + (rows, N), tuple(lead) + (srows, N)
    if q.dtype != np.int8 or q.shape != want_q or s.shape != want_s:
        raise ValueError(f"{path}: {key} {q.dtype} {q.shape} / s {s.shape}, expected int8 "
                         f"{want_q} / {want_s}")
    return {key: torch.tensor(q).to(device), "s": torch.tensor(s.astype(np.float32)).to(device)}


def _convert(tree, like, dtype, device, path="params"):
    if isinstance(like, (int, tuple)):   # a structural int: a discriminator's period, resolution
        try:
            got = tuple(int(v) for v in tree) if isinstance(like, tuple) else int(tree)
        except (TypeError, ValueError):
            got = tree
        if got != like:
            raise ValueError(f"{path}: {got!r} != expected {like!r}")
        return like
    if isinstance(tree, dict) and isinstance(like, torch.Tensor):
        return _quantized_leaf(tree, like, device, path)
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: keys {got} differ from {sorted(like)}")
        return {k: _convert(tree[k], like[k], dtype, device, f"{path}.{k}") for k in like}
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected a list of {len(like)}")
        return [_convert(t, l, dtype, device, f"{path}[{i}]")
                for i, (t, l) in enumerate(zip(tree, like))]
    if isinstance(tree, torch.Tensor):     # a tree the port loaded itself
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"{path}: shape {tuple(tree.shape)} != expected "
                             f"{tuple(like.shape)}")
        return tree.to(device=device, dtype=dtype or like.dtype).contiguous()
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape} != expected {tuple(like.shape)}")
    # row-major whatever the source's layout (a converter's transposed view
    # would otherwise give a strided tensor, which the products take in
    # another summation order than the engine's own contiguous weights)
    return torch.tensor(np.ascontiguousarray(arr, dtype=np.float32)).to(
        device=device, dtype=dtype or like.dtype)


def _layout(init_fn, *args):
    # the port's own tree for this config, shapes only (no memory)
    return init_fn(*args, None, torch.float32, "meta")


def gpt_params_from_numpy(tree: Any, cfg: GPTConfig, dtype: Optional[torch.dtype] = None,
                          device="cpu"):
    """UnifiedVoice parameters from the JAX package's numpy tree, for every
    condition_type (the legacy trees hold `conditioning_encoder.init`, a
    list `attn`, and an empty `perceiver_encoder` when mean-pooled)."""
    return _convert(tree, _layout(unified_voice.init_params, cfg), dtype, device)


def bigvgan_params_from_numpy(tree: Any, cfg: BigVGANConfig,
                              dtype: Optional[torch.dtype] = None, device="cpu"):
    """BigVGAN parameters from the JAX package's numpy tree."""
    return _convert(tree, _layout(bigvgan.init_params, cfg), dtype, device)


def dvae_params_from_numpy(tree: Any, cfg: VQVAEConfig, dtype: Optional[torch.dtype] = None,
                           device="cpu"):
    """DVAE parameters (models/dvae.py's layout) from a numpy tree: the JAX
    package's, or io/checkpoint.load_dvae_checkpoint's."""
    return _convert(tree, dvae.init_params(cfg, None, torch.float32, "meta"), dtype, device)


def discriminator_params_from_numpy(tree: Any, periods=(2, 3, 5, 7, 11),
                                    resolutions=((1024, 120, 600), (2048, 240, 1200),
                                                 (512, 50, 240)),
                                    dtype: Optional[torch.dtype] = None, device="cpu"):
    """The vocoder's discriminators (models/discriminators.py's layout for
    `periods` and `resolutions`) from the JAX package's numpy tree; the
    structural ints (`period`, `resolution`) are checked and kept."""
    like = discriminators.init_discriminators(None, tuple(periods),
                                              tuple(tuple(r) for r in resolutions),
                                              torch.float32, "meta")
    return _convert(tree, like, dtype, device)


def lora_params_from_numpy(tree: Any, cfg: GPTConfig, lora_cfg: LoRAConfig, device="cpu"):
    """LoRA adapters (train/lora.py's layout: per target `a` [L, in, r] and
    `b` [L, r, out]) from the JAX package's numpy tree, in fp32."""
    L, r = cfg.layers, lora_cfg.r
    dims = lora.target_dims(cfg)
    like = {n: {"a": torch.empty((L, dims[n][0], r), device="meta"),
                "b": torch.empty((L, r, dims[n][1]), device="meta")}
            for n in lora_cfg.target_modules}
    return _convert(tree, like, torch.float32, device)
