#!/usr/bin/env python3
"""How far two implementations of the decode trunk that round alike can
disagree, on one NVIDIA GPU.

    python3 tools/trunk_rounding.py

Runs K2's plain version (`decode_trunk_plain`) at the flagship width, 24
layers, bf16, position 700 of T = 768, on chip_smoke.py's inputs, three ways
and prints max|difference| of the outputs:
- each product's input rounded to bf16 first (as the TPU kernels do), its
  fp32 sums against the same with the products summed in fp64;
- the same two without the rounding (the port's plain version as it is);
- one element of hidden moved by one bf16 ulp, both ways.
The first says how close any kernel that rounds its activations to bf16 can
come to a plain version that rounds the same way; chip_smoke.py's tolerance
for K2 is one bf16 ulp of max|plain| (about 0.098 here).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trunk_rounding: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.ops import quantization
    from indextts_tpu_torch.ops.cuda import decode_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    L, D, H, T, pos = 24, 1280, 20, 768, 700
    params, k0, v0, hidden = cs.decode_inputs(torch, gpt2, L, D, H, T, "cuda", torch.bfloat16)
    mask, _ = cs.decode_masks(torch, T, pos, False, "cuda")
    mm = quantization.matmul_quant

    def run(h, rounding: bool, fp64: bool):
        def product(x, w):
            if rounding:
                x = x.to(torch.bfloat16).float()
            return mm(x.double(), w).float() if fp64 else mm(x, w)

        quantization.matmul_quant = product
        try:
            out, _, _ = decode_layer.decode_trunk_plain(params, h, k0.clone(), v0.clone(), pos,
                                                        mask, H)
        finally:
            quantization.matmul_quant = mm
        return out.float()

    for rounding in (True, False):
        a, b = run(hidden, rounding, False), run(hidden, rounding, True)
        print(f"{'bf16-rounded' if rounding else 'fp32'} product inputs, fp32 vs fp64 sums: "
              f"max|diff| {(a - b).abs().max().item()} (max|out| {a.abs().max().item()})",
              flush=True)
    nudged = hidden.clone()
    nudged.view(-1)[7] = (nudged.view(-1)[7].float() * (1 + 2 ** -7)).to(torch.bfloat16)
    for rounding in (True, False):
        a, b = run(hidden, rounding, False), run(nudged, rounding, False)
        print(f"{'bf16-rounded' if rounding else 'fp32'} product inputs, one hidden element "
              f"moved by one bf16 ulp: max|diff| {(a - b).abs().max().item()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
