"""Carry parameters across from the JAX package.

The port keeps the JAX package's parameter trees (nested dicts and lists,
stacked GPT blocks, torch-layout conv weights), so loading a tree exported
as numpy (``jax.tree.map(np.asarray, params)``, done by the caller) is a
plain copy.  Each loader checks the tree against the port's own layout for
the config before copying.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import BigVGANConfig, GPTConfig
from indextts_tpu_torch.models import bigvgan, unified_voice


def _convert(tree, like, dtype, device, path="params"):
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
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape} != expected {tuple(like.shape)}")
    return torch.tensor(arr.astype(np.float32)).to(
        device=device, dtype=dtype or like.dtype)


def _layout(init_fn, *args):
    # the port's own tree for this config, shapes only (no memory)
    return init_fn(*args, None, torch.float32, "meta")


def gpt_params_from_numpy(tree: Any, cfg: GPTConfig, dtype: Optional[torch.dtype] = None,
                          device="cpu"):
    """UnifiedVoice parameters from the JAX package's numpy tree."""
    return _convert(tree, _layout(unified_voice.init_params, cfg), dtype, device)


def bigvgan_params_from_numpy(tree: Any, cfg: BigVGANConfig,
                              dtype: Optional[torch.dtype] = None, device="cpu"):
    """BigVGAN parameters from the JAX package's numpy tree."""
    return _convert(tree, _layout(bigvgan.init_params, cfg), dtype, device)
