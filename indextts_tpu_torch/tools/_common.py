"""Shared pieces of the port's command-line tools: the device rule, the
card's name and power limit, the kernel wrappers' launch counts, random
weights from a seed, and the one-line JSON result."""

from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict

import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops.cuda import anti_alias, decode_layer, permute, pool_trunk

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VOCAB = os.path.join(REPO, "checkpoints_test", "vocab.txt")

# every hand-written kernel's wrapper, by the name the records give it
KERNELS = {"K1": anti_alias.fused_anti_alias_activation,
           "K1b": anti_alias.anti_alias_activation_backward,
           "K2": decode_layer.fused_decode_trunk_flat,
           "K3": permute.permute_cache_rows,
           "K4": pool_trunk.fused_pool_step}

# `--tiny`, and the verification gate's synthetic model: 2 layers of width
# 128 (head width 64, as the trunk kernels take), a small conditioning
# encoder and a three-stage BigVGAN at 16 channels (1024 samples a code),
# quick on the CPU and running every kernel of its path on the card
TINY_MODEL = {
    "gpt": {"model_dim": 128, "layers": 2, "heads": 2, "max_mel_tokens": 64,
            "max_text_tokens": 120,
            "condition_module": {"output_size": 32, "linear_units": 64, "attention_heads": 4,
                                 "num_blocks": 2}},
    "bigvgan": {"upsample_rates": [8, 8, 16], "upsample_kernel_sizes": [16, 16, 32],
                "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1]], "speaker_embedding_dim": 8, "gpt_dim": 128},
}


def add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU the tool stops unless "
                        "--device cpu is given")


def device_of(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return device


def gpt_config(tiny: bool) -> GPTConfig:
    return GPTConfig.from_dict(TINY_MODEL["gpt"]) if tiny else GPTConfig()


def random_gpt(cfg: GPTConfig, device: torch.device, dtype: torch.dtype, seed: int = 0):
    """UnifiedVoice weights drawn on the device from a torch seed."""
    return uv.init_params(cfg, torch.Generator(device=device).manual_seed(seed), dtype, device)


def card(device: torch.device) -> Dict[str, Any]:
    """The device the numbers were taken on: for a GPU its name (from
    torch) and its power limit in W (from nvidia-smi, None where that
    cannot be read)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    name = torch.cuda.get_device_properties(device).name
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        line = out.stdout.strip().splitlines()[device.index or 0]
        limit = float(line.rsplit(",", 1)[1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        line, limit = None, None
    return {"name": name, "power_limit_w": limit, "nvidia_smi": line}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    return {k: f.launches for k, f in KERNELS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in launches().items()}


def add_launches(total: Dict[str, int], more: Dict[str, int]) -> Dict[str, int]:
    return {k: total.get(k, 0) + more.get(k, 0) for k in KERNELS}


def emit(result: Dict[str, Any]) -> Dict[str, Any]:
    """Print the tool's result as one JSON line and return it."""
    print(json.dumps(result, ensure_ascii=False), flush=True)
    return result
