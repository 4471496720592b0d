"""LoRA adapters as fused low-rank deltas on the GPT trunk (counterpart of
indextts_tpu/train/lora.py).

The reference's PEFT setup (train.py:548-605, config.yaml:244-252): rank-4
adapters on attn.c_attn / attn.c_proj / mlp.c_fc / mlp.c_proj, alpha 8,
merged into the base weights for the inference checkpoint
(train.py:795-833).  Adapters are stacked over layers like the trunk: per
target `a` [L, in, r] and `b` [L, r, out], so that delta W = (alpha/r) a @ b.
`materialize` folds the deltas into the base weights on every step, so the
forward is the unmodified base forward and gradients reach the adapters
through the fold.  As in the JAX package, no LoRA dropout is applied,
although `LoRAConfig.lora_dropout` is 0.2.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from indextts_tpu_torch.config import GPTConfig, LoRAConfig

# the port's layout for the reference target_modules (config.yaml:248-252)
TARGETS = {
    "attn.c_attn": ("attn", "qkv_w"),
    "attn.c_proj": ("attn", "proj_w"),
    "mlp.c_fc": ("mlp", "fc_w"),
    "mlp.c_proj": ("mlp", "proj_w"),
}


def target_dims(cfg: GPTConfig) -> Dict[str, tuple]:
    """(in, out) of each target's weight."""
    D = cfg.model_dim
    return {"attn.c_attn": (D, 3 * D), "attn.c_proj": (D, D),
            "mlp.c_fc": (D, 4 * D), "mlp.c_proj": (4 * D, D)}


def tree_map(fn, *trees):
    """`fn` over the leaves of trees of one structure (dicts and lists)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def init_lora_params(generator: torch.Generator, cfg: GPTConfig, lora_cfg: LoRAConfig,
                     device="cpu") -> Dict[str, Any]:
    """PEFT's init, fp32: `a` uniform in +-sqrt(1/in) (kaiming_uniform with
    a=sqrt(5) on A [r, in]), `b` zero."""
    L, r = cfg.layers, lora_cfg.r
    dims = target_dims(cfg)
    params: Dict[str, Any] = {}
    for name in lora_cfg.target_modules:
        din, dout = dims[name]
        bound = math.sqrt(1.0 / din)
        a = torch.rand((L, din, r), generator=generator, device=device) * (2 * bound) - bound
        params[name] = {"a": a, "b": torch.zeros((L, r, dout), device=device)}
    return params


def materialize(base_params: Dict[str, Any], lora_params: Dict[str, Any],
                lora_cfg: LoRAConfig) -> Dict[str, Any]:
    """base + (alpha/r) a @ b, differentiable in the adapters.  The delta is
    formed in fp32 and cast to the base leaf's type before the add."""
    scaling = lora_cfg.lora_alpha / lora_cfg.r
    gpt = dict(base_params["gpt"])
    blocks = {k: dict(v) for k, v in gpt["blocks"].items()}
    for name, ab in lora_params.items():
        group, leaf = TARGETS[name]
        base = blocks[group][leaf]
        delta = torch.matmul(ab["a"].float(), ab["b"].float()) * scaling
        blocks[group][leaf] = base + delta.to(base.dtype)
    gpt["blocks"] = blocks
    return {**base_params, "gpt": gpt}


def merge(base_params: Dict[str, Any], lora_params: Dict[str, Any], lora_cfg: LoRAConfig,
          save_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Merged inference weights in `save_dtype` (PEFT's merge_and_unload,
    train.py:795-833)."""
    with torch.no_grad():
        merged = materialize(base_params, lora_params, lora_cfg)
        return tree_map(lambda x: x.to(save_dtype), merged)


def loraplus_labels(lora_params: Dict[str, Any]) -> Dict[str, Any]:
    """LoRA+ optimizer groups: the B matrices train at lr x ratio
    (create_loraplus_optimizer, train.py:587-605)."""
    return {name: {"a": "a", "b": "b"} for name in lora_params}
