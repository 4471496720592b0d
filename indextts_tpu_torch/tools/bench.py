"""Benchmark: GPT autoregressive decode throughput of the port on the card
(counterpart of bench.py).

    python -m indextts_tpu_torch.tools.bench [--batch 1] [--max-new 200]

At one row the engine's sampling decode runs the decode-trunk kernel (K2)
for every step; at more rows it runs the eager batched step
(`gpt2.decode_step`).  Each (tier, batch) runs `--warmup` decodes, then
`--iters` timed decodes between `torch.cuda.synchronize()` calls; tokens
count each row's steps up to its stop.  Tiers: bf16 (fp32 on the CPU) and
int8 weights up to 8 rows, int8 over an fp8 KV cache always, fused int4 at
one row (K2's int4 tier) and shared-scale int4 over fp8 at more.  `--batch 0` sweeps 1 and the
batch sizes whose KV cache fits the card.  Weights are random from
`--seed`.  Prints ONE JSON line: the best rate as `value`, each measured
tier, the card, and the kernel launches over the timed decodes.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.tools import _common

SWEEP = (1, 8, 16, 32, 64, 128, 256)
TEXT_LEN = 60


def _cache_bytes(cfg, B: int, max_new: int, itemsize: int) -> int:
    T = cfg.condition_num_latent + TEXT_LEN + 3 + max_new
    return 2 * cfg.layers * B * T * cfg.model_dim * itemsize


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=0,
                    help="decode rows; 0 = measure 1 and the sweep sizes that fit the card")
    ap.add_argument("--max-new", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=2, help="untimed decodes per tier")
    ap.add_argument("--iters", type=int, default=5, help="timed decodes per tier")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the tool, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)

    cfg = _common.gpt_config(args.tiny)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    fp8 = torch.float8_e4m3fn
    params = _common.random_gpt(cfg, device, dtype, args.seed)
    plain = "bf16" if dtype == torch.bfloat16 else "fp32"
    tiers = {plain: params, "int8": quant.quantize_gpt_params(params, bits=8),
             "int4": quant.quantize_gpt_params(params, bits=4),
             "int4shared": quant.quantize_gpt_params(params, bits=4, int4_layout="shared")}
    rng = np.random.default_rng(args.seed)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=dtype, device=device)
    text_len = min(TEXT_LEN, cfg.max_text_tokens)
    max_new = min(args.max_new, cfg.max_mel_tokens)
    timed_launches = {k: 0 for k in _common.KERNELS}

    def measure(tier: str, B: int, kv=None) -> Dict[str, Any]:
        nonlocal timed_launches
        texts = [rng.integers(2, cfg.number_text_tokens, (text_len,)) for _ in range(B)]
        prep = uv.prepare_text_prompt(texts, cfg.start_text_token, cfg.stop_text_token)
        tokens = torch.as_tensor(prep.text_tokens, device=device)
        mask = torch.as_tensor(prep.attn_text, device=device)

        def run(seed: int):
            return uv.inference_speech(
                tiers[tier], cfg, cond, tokens, mask,
                torch.Generator(device=device).manual_seed(seed), max_new=max_new,
                temperature=1.0, top_k=30, top_p=0.8, repetition_penalty=10.0,
                do_sample=True, cache_dtype=dtype, kv_dtype=kv)

        for i in range(args.warmup):
            run(i).lengths.cpu()
        before = _common.launches()
        _common.sync(device)
        t0 = time.perf_counter()
        total = 0
        for i in range(args.iters):
            r = run(args.warmup + i)
            total += int(torch.clamp(r.lengths + 1, max=max_new).sum())
        _common.sync(device)
        dt = time.perf_counter() - t0
        n = _common.launches_since(before)
        timed_launches = _common.add_launches(timed_launches, n)
        label = tier + ("+fp8kv" if kv is not None else "")
        rate = total / dt
        print(f"[bench:{label} B={B}] {total} tokens in {dt:.2f}s -> {rate:.1f} tok/s",
              file=sys.stderr)
        return {"tier": label, "batch": B, "tokens": total, "s": dt, "tokens_per_s": rate,
                "launches": n}

    if args.batch:
        batches: List[int] = [args.batch]
    elif device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        batches = [B for B in SWEEP
                   if B == 1 or _cache_bytes(cfg, B, max_new, 2) <= free // 2]
    else:
        batches = list(SWEEP)
    results = []
    for B in batches:
        if B <= 8:
            results.append(measure(plain, B))
            results.append(measure("int8", B))
        results.append(measure("int8", B, kv=fp8))
        results.append(measure("int4shared" if B > 1 else "int4", B, kv=fp8 if B > 1 else None))
    best = max(r["tokens_per_s"] for r in results)
    return _common.emit({
        "metric": "gpt_decode_tokens_per_sec_per_chip", "value": best, "unit": "tokens/s",
        "results": results, "max_new": max_new, "text_len": text_len,
        "warmup": {"decodes_per_tier": args.warmup}, "iters": args.iters,
        "timing": "host clock between torch.cuda.synchronize() calls around the timed decodes",
        "device": _common.card(device), "launches": timed_launches})


if __name__ == "__main__":
    main()
