"""Export a checkpoint directory the port's trainers wrote to a
reference-format .pth (counterpart of tools/export_pth.py).

The inverse of the import converters (io/checkpoint.py): the file loads in
the reference's CUDA stack unchanged, in the port's engine and extractor,
and in the JAX package's loaders.  `gpt` exports the LoRA trainer's merged
weights (`model_epoch_N`, train/run.py) as ``{'model': state_dict}`` with
the speaker extras of `--data-path` (reference train.py:795-844); `dvae`
the DVAE trainer's `dvae_step_N` (train/dvae.py) as a flat DiscreteVAE
state_dict; `vocoder` the vocoder trainer's `vocoder_step_N`
(train/vocoder.py) as ``{'generator': state_dict}`` with the weight-norm
splits restored (infer.py:392-393).  The JAX package's orbax directories
are refused (io/checkpoint.load_pytree's error names the .pth route).

    python -m indextts_tpu_torch.tools.export_pth gpt --ckpt out/run/model_epoch_3 \\
        --config finetune_models/config.yaml --out gpt_finetuned.pth \\
        [--dtype fp16] [--data-path finetune_data/processed_data]
    python -m indextts_tpu_torch.tools.export_pth dvae --ckpt out/dvae_step_1000 --out dvae.pth
    python -m indextts_tpu_torch.tools.export_pth vocoder --ckpt out/vocoder_step_1000 \\
        --out bigvgan_generator.pth [--round-to bf16]

The tree is loaded onto `--device` and checked against the config's layout
there before it is written.
"""

from __future__ import annotations

import argparse
import os

import torch

from indextts_tpu_torch.config import Config
from indextts_tpu_torch.io import checkpoint as ckpt_io
from indextts_tpu_torch.io import export as export_io
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.tools import _common
from indextts_tpu_torch.train.lora import tree_map

_ROUND = {"bf16": torch.bfloat16, "fp16": torch.float16}


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kind", choices=["gpt", "dvae", "vocoder"])
    p.add_argument("--ckpt", required=True,
                   help="the port's checkpoint directory (model_epoch_N / dvae_step_N / "
                        "vocoder_step_N)")
    p.add_argument("--config", default="finetune_models/config.yaml",
                   help="config.yaml of the model (the defaults where it is missing)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--dtype", default=None, choices=["fp16", "bf16", "fp32"],
                   help="save dtype (default: fp16 for gpt, fp32 otherwise)")
    p.add_argument("--data-path", default=None,
                   help="extraction output dir: embeds per-speaker medoid conditions and "
                        "mels into the gpt checkpoint")
    p.add_argument("--round-to", default=None, choices=sorted(_ROUND),
                   help="round the float weights to this type before writing (e.g. the "
                        "engine's bf16 vocoder type, so that the loader's weight-norm fold "
                        "lands on the same weights); no rounding by default")
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args.device)
    cfg = Config.load(args.config) if os.path.exists(args.config) else Config()

    tree = ckpt_io.load_pytree(args.ckpt, device)
    if args.kind == "gpt":
        params = from_jax.gpt_params_from_numpy(tree, cfg.gpt, None, device)
    elif args.kind == "dvae":
        params = from_jax.dvae_params_from_numpy(tree["params"], cfg.vqvae, None, device)
    else:
        params = from_jax.bigvgan_params_from_numpy(tree["gen_params"], cfg.bigvgan, None,
                                                    device)
    del tree
    if args.round_to:
        params = tree_map(lambda t: t.to(_ROUND[args.round_to]).float(), params)
    if args.kind == "gpt":
        extras = export_io.speaker_extras(args.data_path) if args.data_path else None
        export_io.save_gpt_pth(args.out, params, cfg.gpt, extras=extras,
                               save_dtype=args.dtype or "fp16")
    elif args.kind == "dvae":
        export_io.save_dvae_pth(args.out, params, cfg.vqvae, save_dtype=args.dtype or "fp32")
    else:
        export_io.save_bigvgan_pth(args.out, params, cfg.bigvgan,
                                   save_dtype=args.dtype or "fp32")
    print(f"[export] wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
