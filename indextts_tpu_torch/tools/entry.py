"""Entry points of the port (counterpart of __graft_entry__.py): the
single-card teacher-forced UnifiedVoice forward at the flagship config (24
layers, width 1280, 20 heads, bf16, random weights from seed 0), and the
data-parallel dry run across N ranks.

    python -m indextts_tpu_torch.tools.entry [--device cuda]
    python -m indextts_tpu_torch.tools.entry --multichip N [--device cpu]

`entry()` returns ``(fn, args)``: ``fn(*args)`` gives the text and mel
losses of a batch of 2 rows (64 text tokens and 128 codes, the second row
half as long).  Running the module calls ``fn`` once on the device and
prints the losses, whether they are finite, and the seconds the call took
as one JSON line.  `dryrun_multichip(n)` checks the data-parallel and
tensor-parallel paths (see its docstring) and prints one line as JAX's
does; JAX's flagship AOT check lowers XLA programs, which have no
counterpart here.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.tools import _common


def entry(device: Optional[str] = None, cfg: Optional[GPTConfig] = None):
    """(fn, example_args): the teacher-forced forward step on the flagship
    UnifiedVoice model at the shipped config, its inputs on `device` (the
    card by default)."""
    dev = _common.device_of(device or "cuda")
    cfg = cfg or GPTConfig()
    params = _common.random_gpt(cfg, dev, torch.bfloat16, 0)

    B, Tt, Tm = 2, 64, 128
    rng = np.random.default_rng(0)
    cond_latent = torch.as_tensor(
        rng.standard_normal((B, cfg.condition_num_latent, cfg.model_dim)),
        dtype=torch.bfloat16, device=dev)
    text_ids = torch.as_tensor(rng.integers(2, cfg.number_text_tokens, (B, Tt)), device=dev)
    text_lengths = torch.as_tensor([Tt, Tt // 2], device=dev)
    mel_codes = torch.as_tensor(rng.integers(0, cfg.number_mel_codes - 2, (B, Tm)), device=dev)
    codes_lengths = torch.as_tensor([Tm, Tm // 2], device=dev)

    def fn(params, cond_latent, text_ids, text_lengths, mel_codes, codes_lengths):
        out = uv.train_forward(params, cfg, cond_latent, text_ids, text_lengths,
                               mel_codes, codes_lengths)
        return out["loss_text"], out["loss_mel"]

    return fn, (params, cond_latent, text_ids, text_lengths, mel_codes, codes_lengths)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, Any]:
    """The data-parallel dry run over `n_devices` ranks (one card each under
    NCCL, or gloo processes with device="cpu"), self-checking as JAX's:
    - the toy LoRA step's loss over n ranks (`parallel/multihost.launch_check`,
      one OS process a rank, a localhost rendezvous) equals its loss on one
      device over the same global batch;
    - on the card, for n >= 2, the serving pool group that
      `create_batcher(dp=n)` builds (one pool a card, through K4) gives the
      greedy codes of one pool on cuda:0, every pool takes work on its own
      card, and K4 launches once per pool step (`pool_group_check`);
    - for n >= 2, the toy trunk's forward and a greedy decode over 2
      tensor-parallel ranks equal one rank's (`tp_check`): the mean square
      of the forward (`tp_forward_msq`) and the decode's length
      (`tp_decode_codes`), as JAX's line prints them.
    Raises where a check fails; prints one line and returns its values."""
    from indextts_tpu_torch.parallel import multihost

    dev = _common.device_of(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} "
                           "cards visible")
    loss = multihost.run_toy_step(world=n_devices, device=dev)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss in the multichip dry run: {loss}")
    reports = multihost.launch_check(n_devices, dev.type)
    losses = [r["loss"] for r in reports]
    multihost_ok = (sorted(r["rank"] for r in reports) == list(range(n_devices))
                    and all(r["world"] == n_devices for r in reports))
    loss_equal = all(abs(x - loss) < 1e-4 for x in losses)
    if not (multihost_ok and loss_equal):
        raise RuntimeError(f"{n_devices}-rank losses {losses} against the one-device loss "
                           f"{loss:.6f} on the same global batch")
    tp = {"tp_forward_msq": None, "tp_decode_codes": None}
    if n_devices >= 2:
        tp = tp_check(2, dev.type)
        if not tp["tp_ok"]:
            raise RuntimeError(f"dryrun_multichip({n_devices}): 2 tensor-parallel ranks "
                               f"against one: {tp}")
    dp_pool_ok = None
    if dev.type == "cuda" and n_devices >= 2:
        pool = _pool_group_agrees(n_devices)
        dp_pool_ok = pool["ok"]
        if not dp_pool_ok:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the pool group against one "
                               f"pool: {pool}")
    out = {"n": n_devices, "loss": loss, "rank_losses": losses, "loss_equal_1rank": loss_equal,
           "multihost_ok": multihost_ok, "dp_pool_ok": dp_pool_ok, **tp}
    msq = tp["tp_forward_msq"]
    print(f"dryrun_multichip({n_devices}) OK: loss={loss:.4f} loss_equal_1rank={loss_equal} "
          f"multihost_ok={multihost_ok} "
          f"tp_forward_msq={'n/a' if msq is None else f'{msq:.4f}'} "
          f"tp_decode_codes={tp['tp_decode_codes']} dp_pool_ok={dp_pool_ok}", flush=True)
    return out


def _tp_values(device, group=None) -> Dict[str, Any]:
    """The toy trunk's forward (mean square) and a greedy 8-code eager
    decode of the toy UnifiedVoice (its head width is no K2 shape), on this
    rank's shards under `group` (the whole model without one).  The weights come from torch seeds 3 and 0 on the
    CPU and the inputs from numpy seed 0: the same on every rank."""
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.parallel import multihost, tp

    cfg = multihost.toy_config()
    size = gpt2.GPT2Size(cfg.layers, cfg.model_dim, cfg.heads)
    r, n = (group.rank, group.size) if group is not None else (0, 1)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 6, cfg.model_dim)), dtype=torch.float32,
                        device=device)
    trunk = gpt2.init_gpt2_params(size, torch.Generator().manual_seed(3))
    out = gpt2.forward(tp.to_device(tp.shard_gpt_params(trunk, r, n), device), x, None, size,
                       group=group)
    forward_reduces = group.all_reduces if group is not None else 0
    params = tp.to_device(tp.shard_uv_params(
        uv.init_params(cfg, torch.Generator().manual_seed(0)), r, n), device)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=torch.float32, device=device)
    prep = uv.prepare_text_prompt([rng.integers(2, 40, (8,))], cfg.start_text_token,
                                  cfg.stop_text_token)
    res = uv.inference_speech(params, cfg, cond, torch.as_tensor(prep.text_tokens, device=device),
                              torch.as_tensor(prep.attn_text, device=device), None, max_new=8,
                              do_sample=False, repetition_penalty=1.0,
                              cache_dtype=torch.float32, use_fused_trunk=False, group=group)
    return {"msq": float(out.square().mean()), "length": int(res.lengths[0]),
            "codes": res.codes[0].tolist(), "steps": res.steps,
            "forward_all_reduces": forward_reduces,
            "decode_all_reduces": (group.all_reduces - forward_reduces
                                   if group is not None else 0)}


def _tp_rank(device: str) -> Dict[str, Any]:
    from indextts_tpu_torch.parallel import mesh

    return _tp_values(mesh.local_device(device), mesh.TPGroup.from_world(timeout_s=120.0))


def tp_check(n: int = 2, device: str = "cuda") -> Dict[str, Any]:
    """`_tp_values` over `n` tensor-parallel ranks (one process each:
    NCCL on cuda:0..n-1, or gloo on the CPU) against one rank in this
    process: the forward's mean square within 1e-5 relative, the codes
    equal, and two all-reduces a layer for the forward and for the prefill
    and every decode step.  Returns rank 0's values and `tp_ok`."""
    from indextts_tpu_torch.parallel import multihost

    dev = _common.device_of(device)
    ranks = multihost.run_ranks("indextts_tpu_torch.tools.entry:_tp_rank", n, device=dev.type,
                                timeout=300.0)
    one = _tp_values(dev)
    L = multihost.TOY["layers"]
    ok = all(abs(r["msq"] - one["msq"]) <= 1e-5 * abs(one["msq"]) and r["codes"] == one["codes"]
             and r["forward_all_reduces"] == 2 * L
             and r["decode_all_reduces"] == 2 * L * (1 + r["steps"]) for r in ranks)
    return {"tp_forward_msq": ranks[0]["msq"], "tp_decode_codes": ranks[0]["length"],
            "tp_one_rank_msq": one["msq"], "tp_one_rank_codes": one["length"],
            "tp_all_reduces_by_rank": [(r["forward_all_reduces"], r["decode_all_reduces"])
                                       for r in ranks],
            "tp_ok": ok}


def pool_group_check(make, texts, n: int) -> Dict[str, Any]:
    """A serving pool group against one pool, greedy: `make(0)` builds one
    pool on cuda:0 and `make(n)` a group of n pools over cuda:0..n-1 (what
    `create_batcher(dp=n)` builds), both through K4.  The group must give
    one pool's codes for every request in `texts`, every pool must take
    work on its own card (weights and state), and K4 must launch once per
    step of each pool.  Returns what it saw, `ok` whether all of it held."""
    from indextts_tpu_torch.ops.cuda import pool_trunk

    one = make(0)
    ids = [one.submit(t) for t in texts]
    res = one.run()
    want = [res[i].tolist() for i in ids]
    group = make(n)
    pool_trunk.fused_pool_step.launches = 0
    gids = [group.submit(t) for t in texts]
    res = group.run()
    got = [res[g].tolist() for g in gids]
    launches = pool_trunk.fused_pool_step.launches
    steps = [b.step_count for b in group.batchers]
    placed = [(str(b.device), str(b.state.prev_tok.device),
               str(b.params["gpt"]["blocks"]["attn"]["qkv_w"].device)) for b in group.batchers]
    return {"requests": len(texts), "codes_equal": got == want, "pool_steps": steps,
            "K4_launches": launches, "placement": placed,
            "ok": (got == want and launches == sum(steps) and all(s > 0 for s in steps)
                   and placed == [(f"cuda:{i}",) * 3 for i in range(n)])}


def _pool_group_agrees(n: int) -> Dict[str, Any]:
    """`pool_group_check` on the tiny model (head width 64, so the pools
    step through K4), 12 requests of ragged lengths."""
    from indextts_tpu_torch.serve.scheduler import ContinuousBatcher, PoolGroup

    cfg = _common.gpt_config(tiny=True)
    dev = torch.device("cuda", 0)
    params = _common.random_gpt(cfg, dev, torch.float32, 0)
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)),
                           dtype=torch.float32, device=dev)
    texts = [rng.integers(2, 200, (k,)).astype(np.int32) for k in (9, 5, 7, 4) * 3]
    kw = dict(num_slots=4, max_text_width=16, max_new=8, do_sample=False,
              repetition_penalty=1.0, cache_dtype=torch.float32, fused_trunk=True)

    def make(dp):
        if not dp:
            return ContinuousBatcher(params, cfg, cond, device=dev, **kw)
        return PoolGroup.create(params, cfg, cond, [torch.device("cuda", i) for i in range(dp)],
                                **kw)

    return pool_group_check(make, texts, n)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the entry, not the card")
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="run the data-parallel dry run over N ranks instead")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.multichip:
        return _common.emit({"metric": "dryrun_multichip",
                             **dryrun_multichip(args.multichip, args.device)})
    tiny = GPTConfig.from_dict({**_common.TINY_MODEL["gpt"], "max_mel_tokens": 128})
    fn, fargs = entry(args.device, tiny if args.tiny else None)
    device = fargs[1].device
    _common.sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_text, loss_mel = (float(x) for x in fn(*fargs))
    _common.sync(device)
    return _common.emit({"metric": "entry_forward", "loss_text": loss_text,
                         "loss_mel": loss_mel,
                         "finite": math.isfinite(loss_text) and math.isfinite(loss_mel),
                         "s": time.perf_counter() - t0, "device": _common.card(device)})


if __name__ == "__main__":
    main()
