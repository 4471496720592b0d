"""Beam-pool serving throughput of the port at the reference's default decode
(num_beams=3, reference api.py:253) through the continuous beam pool
(serve/beam_pool.py); counterpart of tools/bench_beam_pool.py.

    python -m indextts_tpu_torch.tools.bench_beam_pool [--groups 8] [--reqs 32] [--bits 8]

Mixed traffic: R requests (20-110 text tokens, budgets of 30-100% of
`--max-new`, 60-200 at the default) through G beam groups of 3 beams.  An
untimed pass of min(8, R) requests, then the measured pass between
`torch.cuda.synchronize()` calls.  Reports output tokens/s (the finalized
best hypotheses' tokens, what clients receive) and group steps.  Weights
are random from `--seed`.  Prints ONE JSON line with the card and the
kernel launches over the measured pass.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.serve.beam_pool import BeamPoolBatcher
from indextts_tpu_torch.tools import _common


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--reqs", type=int, default=32)
    ap.add_argument("--steps-per-tick", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8, choices=[4, 8])
    ap.add_argument("--max-new", type=int, default=200,
                    help="the pool's cap; budgets are drawn from 30-100%% of it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model, short budgets: checks the tool, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)

    cfg = _common.gpt_config(args.tiny)
    if args.tiny:
        max_text_width, max_new = 16, min(args.max_new, 24)
        dtype, kv = torch.float32, None
    else:
        max_text_width, max_new = 128, args.max_new
        dtype, kv = torch.bfloat16, torch.float8_e4m3fn
    lo, hi = max(1, 3 * max_new // 10), max_new
    params = _common.random_gpt(cfg, device, dtype, args.seed)
    if not args.tiny:
        params = quant.quantize_gpt_params(params, bits=args.bits,
                                           int4_layout="shared" if args.bits == 4 else "fused")
    rng = np.random.default_rng(args.seed)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=dtype, device=device)

    def make_reqs(n):
        return [(rng.integers(2, cfg.number_text_tokens - 4,
                              (int(rng.integers(5 if args.tiny else 20, max_text_width - 10)),)),
                 int(rng.integers(lo, hi))) for _ in range(n)]

    def run_pass(reqs, label):
        pool = BeamPoolBatcher(params, cfg, cond, num_groups=args.groups, num_beams=3,
                               max_text_width=max_text_width, max_new=max_new, kv_dtype=kv,
                               cache_dtype=dtype, steps_per_tick=args.steps_per_tick,
                               device=device)
        for i, (text, budget) in enumerate(reqs):
            pool.submit(text, max_new=budget, seed=i)
        before = _common.launches()
        _common.sync(device)
        t0 = time.perf_counter()
        results = pool.run()
        _common.sync(device)
        dt = time.perf_counter() - t0
        out_tokens = int(sum(len(v) for v in results.values()))
        print(f"[beam-pool:{label}] {len(results)} reqs, {out_tokens} output tokens, "
              f"{pool.step_count} group-steps in {dt:.2f}s -> {out_tokens / dt:.0f} out-tok/s",
              file=sys.stderr)
        return {"value": out_tokens / dt, "out_tokens": out_tokens, "s": dt,
                "group_steps": pool.step_count,
                "group_slot_steps_per_s": pool.step_count * args.groups / dt,
                "launches": _common.launches_since(before)}

    warm = min(8, args.reqs)
    run_pass(make_reqs(warm), "warm")
    measured = run_pass(make_reqs(args.reqs), "measured")
    return _common.emit({
        "metric": "beam_pool_out_tok_per_sec", "groups": args.groups, "num_beams": 3,
        "bits": None if args.tiny else args.bits, "reqs": args.reqs, "max_new": max_new,
        **measured, "warmup": {"requests": warm},
        "timing": "host clock around BeamPoolBatcher.run(), synchronized",
        "device": _common.card(device)})


if __name__ == "__main__":
    main()
