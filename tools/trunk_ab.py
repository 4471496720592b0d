#!/usr/bin/env python3
"""A/B timing of the decode-trunk kernels' sources on one NVIDIA GPU.

    python3 tools/trunk_ab.py [--k2] base=indextts_tpu_torch/csrc other=path/to/csrc ...

Each NAME=DIR is a copy of `indextts_tpu_torch/csrc/` (for example one
unpacked from another commit with `git archive`).  Every tree is built by
`ops/cuda/_build.load` into its own library under the git-ignored
`indextts_tpu_torch/_build/ab/` (all trees at once), and the port's
wrappers are timed on each in turns (A B ... B A), in one process on one
card: K2 (`fused_decode_trunk_flat`) at the flagship width on bf16,
int8 and int4 weights and bf16 weights over an e4m3 cache, at position 700
of T = 768, and K4 (`fused_pool_step`) on bf16 weights and on int8 weights
over an e4m3 cache at S = 8 and S = 64, as CUDA-graph replays
(chip_smoke.py's `cuda_ms`); with `--k2`, K2 only.  Prints the card, then
one line per (tree, kernel) with its times and K2's max|kernel - plain|.
"""

from __future__ import annotations

import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("trunk_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.ops import quantization
    from indextts_tpu_torch.ops.cuda import _build, decode_layer, pool_trunk

    print(cs.card_line(), flush=True)
    k2_only = "--k2" in argv
    trees = dict(arg.split("=", 1) for arg in argv if arg != "--k2")

    def load(name):
        out = Path(ROOT) / "indextts_tpu_torch" / "_build" / "ab" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(trees[name], out / "csrc")
        return _build.load(out / "csrc", out)

    with ThreadPoolExecutor(len(trees)) as pool:
        libs = dict(zip(trees, pool.map(load, trees)))
    order = list(libs) + list(reversed(list(libs)))
    use = lambda lib: setattr(_build, "load", lambda: lib)  # noqa: E731
    L, D, H, T, pos = 24, 1280, 20, 768, 700
    params, k0, v0, hidden = cs.decode_inputs(torch, gpt2, L, D, H, T, "cuda", torch.bfloat16)
    mask, _ = cs.decode_masks(torch, T, pos, False, "cuda")
    tiers = {"bf16": params,
             "int8": quantization.quantize_gpt_params({"gpt": params}, bits=8)["gpt"],
             "int4": quantization.quantize_gpt_params({"gpt": params}, bits=4)["gpt"]}
    times, errs = {}, {}
    k2 = decode_layer.fused_decode_trunk_flat
    tiers["fp8_cache"] = params
    for name in order:
        use(libs[name])
        for tier, tp in tiers.items():
            kc, vc = ((k0.to(torch.float8_e4m3fn), v0.to(torch.float8_e4m3fn))
                      if tier == "fp8_cache" else (k0.clone(), v0.clone()))
            args = [(tp, hidden, kc, vc, pos, mask, H)]
            got = k2(*args[0])[0]
            ref = decode_layer.decode_trunk_plain(*args[0])[0]
            errs[(name, tier)] = (got.float() - ref.float()).abs().max().item()
            times.setdefault((name, f"K2 {tier}"), []).append(cs.cuda_ms(k2, args, 20))
    del k0, v0
    torch.cuda.empty_cache()
    for S in () if k2_only else (8, 64):
        g = torch.Generator(device="cuda").manual_seed(7)
        kc = (4 * torch.randn(L, S, T, D, generator=g, device="cuda")).to(torch.bfloat16)
        vc = torch.randn(L, S, T, D, generator=g, device="cuda").to(torch.bfloat16)
        hid = (0.5 * torch.randn(S, D, generator=g, device="cuda")).to(torch.bfloat16)
        positions, pmask = cs.pool_inputs(torch, S, T, "cuda")
        kc8, vc8 = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
        for name in order:
            use(libs[name])
            for tier, tp, k_, v_ in (("bf16", params, kc, vc),
                                     ("int8_fp8cache", tiers["int8"], kc8, vc8)):
                args = [(tp, hid, k_, v_, positions, pmask, H)]
                times.setdefault((name, f"K4 {tier} S={S}"), []).append(
                    cs.cuda_ms(pool_trunk.fused_pool_step, args, 10))
        del kc8, vc8
        del kc, vc
        torch.cuda.empty_cache()
    for (name, what), ms in times.items():
        err = errs.get((name, what.split()[1])) if what.startswith("K2") else None
        print(f"{name} {what}: ms {[round(t, 4) for t in ms]}"
              + (f" max_abs_err {err}" if err is not None else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
