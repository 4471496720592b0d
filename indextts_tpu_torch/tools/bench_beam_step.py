"""Per-step cost of the port's beam decode at engine lengths (counterpart of
tools/bench_beam_step.py).

    python -m indextts_tpu_torch.tools.bench_beam_step [--reorders lineage,pallas]
        [--beams 3] [--batch 1] [--text-len 100] [--max-new 600] [--kv fp8]

The reference decodes at num_beams=3 (infer.py:628-635); the per-step cost
of `inference_speech_beam` sets that path's RTF.  This times whole decodes
(random weights rarely emit the stop code, so a decode runs `--max-new`
steps) for each cache-reorder strategy of `unified_voice._reorder_suffix`:
lineage (the default: no physical reorder), pallas (the row-permute kernel,
K3), always / full (plain row gathers), dslice, onehot, and none (a
diagnostic floor: wrong results).  `--warmup` decodes run untimed, then
`--iters` timed ones between `torch.cuda.synchronize()` calls.  Prints ONE
JSON line: ms a step and output tokens/s per strategy, the card, and each
strategy's kernel launches.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.tools import _common


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reorders", default="lineage,none",
                    help="comma list of: " + ", ".join(uv.REORDERS))
    ap.add_argument("--beams", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--text-len", type=int, default=100)
    ap.add_argument("--max-new", type=int, default=600)
    ap.add_argument("--kv", default="fp8", choices=["fp8", "bf16"])
    ap.add_argument("--quant", default="int8", choices=["int8", "int4", "none"])
    ap.add_argument("--warmup", type=int, default=2, help="untimed decodes per strategy")
    ap.add_argument("--iters", type=int, default=3, help="timed decodes per strategy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the tool, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)
    reorders = args.reorders.split(",")
    unknown = [r for r in reorders if r not in uv.REORDERS]
    if unknown:
        ap.error(f"unknown reorder strategies {unknown}; choose from {uv.REORDERS}")

    cfg = _common.gpt_config(args.tiny)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = _common.random_gpt(cfg, device, dtype, args.seed)
    if args.quant != "none":
        # beam rows are batched rows: int4 takes the shared-scale layout
        params = quant.quantize_gpt_params(params, bits=8 if args.quant == "int8" else 4,
                                           int4_layout="shared")
    rng = np.random.default_rng(args.seed)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=dtype, device=device)
    text_len = min(args.text_len, cfg.max_text_tokens)
    max_new = min(args.max_new, cfg.max_mel_tokens)
    texts = [rng.integers(2, cfg.number_text_tokens, (text_len,)) for _ in range(args.batch)]
    prep = uv.prepare_text_prompt(texts, cfg.start_text_token, cfg.stop_text_token)
    tokens = torch.as_tensor(prep.text_tokens, device=device)
    mask = torch.as_tensor(prep.attn_text, device=device)
    kv = torch.float8_e4m3fn if args.kv == "fp8" else None

    results = []
    for reorder in reorders:
        def run(seed: int):
            return uv.inference_speech_beam(
                params, cfg, cond, tokens, mask,
                torch.Generator(device=device).manual_seed(seed), max_new=max_new,
                num_beams=args.beams, temperature=1.0, top_k=30, top_p=0.8,
                repetition_penalty=10.0, do_sample=True, cache_dtype=dtype, kv_dtype=kv,
                reorder=reorder)

        for i in range(args.warmup):
            run(i).lengths.cpu()
        before = _common.launches()
        _common.sync(device)
        t0 = time.perf_counter()
        steps = 0
        for i in range(args.iters):
            steps += run(args.warmup + i).steps
        _common.sync(device)
        dt = time.perf_counter() - t0
        ms = dt / max(steps, 1) * 1e3
        results.append({"reorder": reorder, "ms_per_step": ms, "steps": steps, "s": dt,
                        "out_tok_per_s": steps * args.batch / dt,
                        "launches": _common.launches_since(before)})
        print(f"[beam-step {reorder} kv={args.kv} B={args.batch} nb={args.beams} "
              f"T~{text_len}+{max_new}] {ms:.2f} ms/step  "
              f"{steps * args.batch / dt:.0f} out-tok/s", file=sys.stderr)
    return _common.emit({
        "metric": "beam_step_ms", "results": results, "beams": args.beams,
        "batch": args.batch, "text_len": text_len, "max_new": max_new, "kv": args.kv,
        "quant": args.quant, "warmup": {"decodes_per_strategy": args.warmup},
        "iters": args.iters,
        "timing": "host clock between torch.cuda.synchronize() calls around the timed decodes",
        "device": _common.card(device)})


if __name__ == "__main__":
    main()
