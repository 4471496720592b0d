"""The pool-step kernel (K4) against the port's plain pool steps (counterpart
of tools/bench_pool_trunk.py): the measurement that
`serve/scheduler.FUSED_TRUNK_DEFAULT` waits on.

    python -m indextts_tpu_torch.tools.bench_pool_trunk [--slots 64] [--steps 32]
        [--t 768] [--bits 8] [--kv fp8] [--impl all|rows|flat|fused]

Times `--steps` decode steps of S pool rows, each at its own position, for
three implementations at the flagship pool shape:

  rows   gpt2.decode_step_rows over the head-split cache [L, S, H, T, hd]
         (the scheduler's step when FUSED_TRUNK_DEFAULT is False)
  flat   gpt2.decode_step_rows_flat over the flat cache [L, S, T, D]
  fused  pool_trunk.fused_pool_step (K4) over the flat cache, the new K/V
         rows scattered after it (the scheduler's step on K4)

Each implementation runs one untimed call of `--steps` steps, then the best
of 4 timed calls between `torch.cuda.synchronize()` calls, each call going
on from the previous one's cache and positions.  Prints ONE JSON line: ms a
step and slot-tokens/s per implementation, the card, and each
implementation's kernel launches.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.models import gpt2
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.ops.cuda import pool_trunk as pt
from indextts_tpu_torch.tools import _common

TIMED_CALLS = 4


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--t", type=int, default=768,
                    help="cache length (the flagship pool: 763 -> 768)")
    ap.add_argument("--bits", type=int, default=8, choices=[0, 8],
                    help="0 = bf16 weights, 8 = int8 weight-only")
    ap.add_argument("--kv", default="fp8", choices=["fp8", "bf16"])
    ap.add_argument("--impl", default="all", choices=["all", "rows", "flat", "fused"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the tool, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)

    cfg = _common.gpt_config(args.tiny)
    size = uv.trunk_size(cfg)
    S, T, D, L, H = args.slots, args.t, cfg.model_dim, cfg.layers, cfg.heads
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    kv_dtype = torch.float8_e4m3fn if args.kv == "fp8" else dtype
    full = _common.random_gpt(cfg, device, dtype, args.seed)
    if args.bits == 8:
        full = quant.quantize_gpt_params(full, bits=8)
    params = full["gpt"]
    calls = 1 + TIMED_CALLS
    if T < calls * args.steps + 8:
        ap.error(f"--t {T} leaves no room for {calls} calls of {args.steps} steps")

    rng = np.random.default_rng(args.seed)
    # every call advances the positions by `steps`: keep all writes in range
    hi = T - calls * args.steps - 2
    pos0 = torch.as_tensor(rng.integers(max(1, min(200, hi - 1)), hi, (S,)), device=device)
    hid0 = torch.as_tensor(rng.standard_normal((S, D)), dtype=dtype, device=device)
    rows = torch.arange(S, device=device)

    def masks():
        m = (torch.arange(T, device=device)[None] <= pos0[:, None]).to(torch.int32)
        return m.contiguous()

    gen = torch.Generator(device=device).manual_seed(args.seed)

    def cache(shape):     # drawn on the device: the flagship cache is 1.5 G values
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).to(kv_dtype)

    def step_rows(state):
        kv, pos, mask, hid = state
        mask[rows, pos] = 1
        out, kv = gpt2.decode_step_rows(params, hid[:, None], kv, pos, mask, size)
        return kv, pos + 1, mask, out[:, 0].to(dtype)

    def step_flat(state, fused: bool):
        k_all, v_all, pos, mask, hid = state
        mask[rows, pos] = 1
        if fused:
            x, k_rows, v_rows = pt.fused_pool_step(params, hid, k_all, v_all, pos, mask, H)
            k_all[:, rows, pos] = k_rows
            v_all[:, rows, pos] = v_rows
            out = gpt2.layer_norm(x[:, None, :], params["ln_f"]["scale"],
                                  params["ln_f"]["bias"])
        else:
            out, k_all, v_all = gpt2.decode_step_rows_flat(params, hid[:, None], k_all, v_all,
                                                           pos, mask, size)
        return k_all, v_all, pos + 1, mask, out[:, 0].to(dtype)

    def run(label, step, state):
        def call(state):
            for _ in range(args.steps):
                state = step(state)
            return state

        t0 = time.perf_counter()
        state = call(state)
        _common.sync(device)
        first = time.perf_counter() - t0
        before = _common.launches()
        best = float("inf")
        for _ in range(TIMED_CALLS):
            _common.sync(device)
            t0 = time.perf_counter()
            state = call(state)
            _common.sync(device)
            best = min(best, time.perf_counter() - t0)
        ms = best / args.steps * 1e3
        print(f"[pool-trunk] {label}: {ms:.3f} ms/step at S={S} T={T} bits={args.bits} "
              f"kv={args.kv} ({S / ms * 1e3:.0f} slot-tokens/s)", file=sys.stderr)
        return {"impl": label, "ms_per_step": ms, "slot_tokens_per_s": S / ms * 1e3,
                "first_call_s": first, "launches": _common.launches_since(before)}

    results = []
    impls = ["rows", "flat", "fused"] if args.impl == "all" else [args.impl]
    for impl in impls:
        if impl == "rows":
            kv = gpt2.KVCache(cache((L, S, H, T, D // H)), cache((L, S, H, T, D // H)))
            results.append(run("rows", step_rows, (kv, pos0.clone(), masks(), hid0.clone())))
            del kv
        else:
            state = (cache((L, S, T, D)), cache((L, S, T, D)), pos0.clone(), masks(),
                     hid0.clone())
            results.append(run(impl, lambda s, f=impl == "fused": step_flat(s, f), state))
            del state
    return _common.emit({
        "metric": "pool_trunk_ms_per_step", "results": results, "slots": S, "t": T,
        "steps": args.steps, "bits": args.bits, "kv": args.kv,
        "warmup": {"calls": 1}, "timed_calls": TIMED_CALLS,
        "timing": "best of the timed calls, host clock between torch.cuda.synchronize() calls",
        "device": _common.card(device)})


if __name__ == "__main__":
    main()
