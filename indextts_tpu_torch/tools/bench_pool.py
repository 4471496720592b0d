"""Continuous-batching pool throughput of the port under mixed traffic
(counterpart of tools/bench_pool.py).

    python -m indextts_tpu_torch.tools.bench_pool [--slots 8] [--reqs 32]
        [--steps-per-tick 16] [--fused-trunk]

Codes only: `serve/scheduler.ContinuousBatcher`'s output tokens/s with
PARITY.md's traffic mix (requests of 20-110 text tokens and 60-200
max_new, int8 weights over an fp8 KV cache), one untimed run, then the best
of `--iters` runs.  The pool steps through `gpt2.decode_step_rows`, or
through the pool-step kernel (K4) with `--fused-trunk` (the default is the
scheduler's `FUSED_TRUNK_DEFAULT`).

`--e2e` measures whole requests instead: `--clients` threads drive
`engine.pool_infer_stream` against one shared pool and drive thread (the
`--continuous` server without the socket) at the flagship config, every
request paying the latent re-forward, the vocoder and the WAV: requests/s,
audio seconds per wall second, per-request RTF and time to first audio
(p50, p95), and the vocode+latent share of the wall time.

Weights are random from `--seed`.  Prints ONE JSON line with the card and
the kernel launches over the timed runs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.serve import scheduler
from indextts_tpu_torch.tools import _common

# (text tokens lo/hi, max_new lo/hi, the pool's text width and cap)
TRAFFIC = {False: (20, 111, 60, 201, 128, 200), True: (5, 20, 8, 24, 32, 24)}
E2E_TEXTS = [
    "大家好，我現在正在 bilibili 體驗 ai 科技，說實話，來之前我絕對想不到！"
    "AI技術已經發展到這樣匪夷所思的地步了！",
    "The weather is really nice today, perfect for studying at home. "
    "Thank you very much!",
    "親愛的夥伴們，大家好！每一次的努力都是為了更好的未來，"
    "要善於從失敗中汲取經驗，讓我們一起勇敢前行，邁向更加美好的明天！",
    "There is a vehicle arriving in dock number 7. Please stand clear "
    "of the doors while they are closing.",
]
def _fused(flag: bool):
    return True if flag else None     # None: the scheduler's default


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--reqs", type=int, default=32)
    ap.add_argument("--steps-per-tick", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8, choices=[4, 8],
                    help="weight tier: 8 = int8; 4 = shared-scale int4")
    ap.add_argument("--staging", type=int, default=None,
                    help="staging rows for in-pool refill (default: the scheduler's)")
    ap.add_argument("--fused-trunk", action="store_true",
                    help="step the pool through the pool-step kernel (K4); int8 only")
    ap.add_argument("--iters", type=int, default=3, help="timed runs (codes only; the best)")
    ap.add_argument("--e2e", action="store_true",
                    help="measure full requests (pool decode + latent re-forward + vocoder "
                         "+ WAV) under concurrent clients instead of codes only")
    ap.add_argument("--clients", type=int, default=8, help="--e2e: concurrent client threads")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the tool, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)
    if args.e2e:
        return e2e_main(args, device)

    cfg = _common.gpt_config(args.tiny)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = quant.quantize_gpt_params(
        _common.random_gpt(cfg, device, dtype, args.seed), bits=args.bits,
        int4_layout="shared" if args.bits == 4 else "fused")
    rng = np.random.default_rng(args.seed)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=dtype, device=device)
    t_lo, t_hi, n_lo, n_hi, width, cap = TRAFFIC[args.tiny]
    reqs = [(rng.integers(2, cfg.number_text_tokens, (int(rng.integers(t_lo, t_hi)),)),
             int(rng.integers(n_lo, n_hi))) for _ in range(args.reqs)]
    launched = {k: 0 for k in _common.KERNELS}

    def run_once():
        nonlocal launched
        b = scheduler.ContinuousBatcher(
            params, cfg, cond, num_slots=args.slots, max_text_width=width, max_new=cap,
            cache_dtype=dtype, kv_dtype=torch.float8_e4m3fn,
            steps_per_tick=args.steps_per_tick, seed=args.seed, staging_rows=args.staging,
            fused_trunk=_fused(args.fused_trunk), device=device)
        ids = [b.submit(t, max_new=m) for t, m in reqs]
        before = _common.launches()
        _common.sync(device)
        t0 = time.perf_counter()
        results = b.run()
        _common.sync(device)
        dt = time.perf_counter() - t0
        launched = _common.add_launches(launched, _common.launches_since(before))
        total = sum(len(results[i]) + 1 for i in ids)     # +1: the stop token's step
        return {"tokens_per_s": total / dt, "tokens": total, "s": dt,
                "pool_steps": b.step_count, "fused_trunk": b.fused}

    run_once()                                             # warm-up
    launched = {k: 0 for k in _common.KERNELS}
    runs = [run_once() for _ in range(args.iters)]
    best = max(runs, key=lambda r: r["tokens_per_s"])
    print(f"[pool] {args.reqs} reqs, {args.slots} slots, steps_per_tick="
          f"{args.steps_per_tick}: {best['tokens']} tokens in {best['s']:.2f}s -> "
          f"{best['tokens_per_s']:.0f} tok/s", file=sys.stderr)
    return _common.emit({
        "metric": "pool_out_tok_per_sec", "value": best["tokens_per_s"], **best,
        "runs_tokens_per_s": [r["tokens_per_s"] for r in runs], "slots": args.slots,
        "reqs": args.reqs, "steps_per_tick": args.steps_per_tick, "bits": args.bits,
        "warmup": {"runs": 1}, "iters": args.iters,
        "timing": "host clock around ContinuousBatcher.run(), synchronized",
        "device": _common.card(device), "launches": launched})


def e2e_main(args, device: torch.device) -> Dict[str, Any]:
    """Full-request serving benchmark: concurrent clients over one shared
    pool and drive thread.  Every request pays the whole tail."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.tools.bench_e2e import write_tone

    d = tempfile.mkdtemp(prefix="bench_pool_e2e_")
    try:
        cfg = Config.from_dict(_common.TINY_MODEL) if args.tiny else Config()
        cfg.save(os.path.join(d, "config.yaml"))
        shutil.copy(_common.VOCAB, os.path.join(d, "vocab.txt"))
        prompt = write_tone(os.path.join(d, "prompt.wav"))
        prec = {"gpt": "int8" if args.bits == 8 else "int4", "vocoder": "bf16"}
        eng = engine_mod.IndexTTS(cfg_path=os.path.join(d, "config.yaml"), model_dir=d,
                                  precision_config=prec, device=str(device))
        # cross-request vocode micro-batching, as the --continuous server runs
        eng.enable_vocode_batching()
        tail = {"wall": 0.0, "calls": 0, "rows": 0}
        tail_lock = threading.Lock()
        orig_group = eng._codes_to_wav_group

        def timed_group(group):
            t0 = time.perf_counter()
            out = orig_group(group)
            with tail_lock:
                tail["wall"] += time.perf_counter() - t0
                tail["calls"] += 1
                tail["rows"] += sum(j.rows for j in group)
            return out

        eng._codes_to_wav_group = timed_group
        pool = eng.create_batcher(num_slots=args.slots, steps_per_tick=args.steps_per_tick,
                                  staging_rows=args.staging,
                                  fused_trunk=_fused(args.fused_trunk))
        pool.warmup()     # before the drive loop exists
        stop = threading.Event()
        errors = []

        def drive():
            try:
                while not stop.is_set():
                    if pool.step() == 0 and not pool._queue:
                        stop.wait(0.002)
            except BaseException as e:   # noqa: BLE001 — reported by the main thread
                errors.append(e)
                raise

        max_mel = 24 if args.tiny else 200
        reqs = [(E2E_TEXTS[i % len(E2E_TEXTS)], i) for i in range(args.reqs)]
        results = []
        res_lock = threading.Lock()

        def client(worklist):
            try:
                for text, i in worklist:
                    t0 = time.perf_counter()
                    ttfa, audio_s = None, 0.0
                    for csr, chunk in eng.pool_infer_stream(pool, prompt, text, seed=i,
                                                            max_mel_tokens=max_mel):
                        ttfa = ttfa if ttfa is not None else time.perf_counter() - t0
                        audio_s += len(chunk) / csr
                    wall = time.perf_counter() - t0
                    with res_lock:
                        results.append((wall, ttfa or wall, audio_s))
            except BaseException as e:   # noqa: BLE001 — reported by the main thread
                errors.append(e)

        def run_clients(work):
            lists = [work[i::args.clients] for i in range(args.clients)]
            threads = [threading.Thread(target=client, args=(wl,)) for wl in lists if wl]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise errors[0]

        drv = threading.Thread(target=drive, daemon=True)
        drv.start()
        try:
            # warm pass, concurrent like the measured one
            run_clients(reqs[:min(2 * args.clients, len(reqs))])
            results.clear()
            tail.update(wall=0.0, calls=0, rows=0)
            before = _common.launches()
            _common.sync(device)
            t0 = time.perf_counter()
            run_clients(reqs)
            _common.sync(device)
            wall_total = time.perf_counter() - t0
            launched = _common.launches_since(before)
        finally:
            stop.set()
            drv.join(60)
            eng.disable_vocode_batching()
        if errors:
            raise errors[0]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    walls = np.asarray([r[0] for r in results])
    ttfas = np.asarray([r[1] for r in results])
    audio = np.asarray([r[2] for r in results])
    rtf = walls / np.maximum(audio, 1e-9)
    return _common.emit({
        "metric": "e2e_pool_serving", "requests": len(results), "clients": args.clients,
        "slots": args.slots, "fused_trunk": pool.fused,
        "requests_per_sec": len(results) / wall_total,
        "audio_sec_per_sec": float(audio.sum()) / wall_total,
        "rtf_p50": float(np.percentile(rtf, 50)), "rtf_p95": float(np.percentile(rtf, 95)),
        "ttfa_p50_s": float(np.percentile(ttfas, 50)),
        "ttfa_p95_s": float(np.percentile(ttfas, 95)),
        "vocode_latent_share": tail["wall"] / wall_total, "vocode_calls": tail["calls"],
        "vocode_rows": tail["rows"], "wall_s": wall_total,
        "warmup": {"requests": min(2 * args.clients, len(reqs))},
        "timing": "host clock around the measured pass, synchronized",
        "device": _common.card(device), "launches": launched})


if __name__ == "__main__":
    main()
