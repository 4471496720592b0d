"""Multi-process data-parallel execution check (counterpart of
indextts_tpu/parallel/multihost.py).

The reference trains across cards with torchrun and an NCCL process group
(train_ddp.py:68-93, run_train.sh:166-186); so does the port
(parallel/mesh.py).  This module makes that path executable anywhere:
`run_ranks` starts N OS processes with torchrun's environment and a
localhost rendezvous on a free port, each joining the group (NCCL on its
own card, or gloo on the CPU) and calling one function; `launch_check` runs
one real LoRA `train_step` of the toy problem that way and returns each
rank's loss, which must equal `run_toy_step`'s on one device over the same
global batch (asserted by tests/test_torch_parallel.py and
`tools/entry.dryrun_multichip`).

    python -m indextts_tpu_torch.parallel.multihost --target MODULE:FUNCTION \\
        --out DIR [--payload FILE] [--device cpu]

is one rank of `run_ranks` (its environment set by the caller).  Every
process has a deadline and every collective a timeout, so a dead rank
fails the run instead of holding it.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from indextts_tpu_torch.parallel import mesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the deterministic toy problem of the JAX package's check
TOY = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=48, max_text_tokens=30,
           number_text_tokens=40, number_mel_codes=50, start_mel_token=46, stop_mel_token=47)


def toy_config():
    from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig

    return GPTConfig(condition_module=ConditionModuleConfig(
        output_size=32, linear_units=64, attention_heads=4, num_blocks=2, perceiver_mult=2),
        **TOY)


def toy_batch(global_batch: int):
    """The full global batch (numpy), drawn alike in every process: the JAX
    package's arrays, value for value."""
    from indextts_tpu_torch.train import trainer

    rng = np.random.default_rng(0)
    return trainer.Batch(
        text_ids=rng.integers(2, 40, (global_batch, 8)).astype(np.int32),
        text_lengths=np.full((global_batch,), 8, np.int32),
        mel_codes=rng.integers(0, 46, (global_batch, 12)).astype(np.int32),
        codes_lengths=np.full((global_batch,), 12, np.int32),
        cond_mel=rng.standard_normal((global_batch, 100, 20)).astype("float32"),
        cond_lengths=np.full((global_batch,), 20, np.int32),
    )


def run_toy_step(world: Optional[int] = None, device="cpu") -> float:
    """One LoRA train step of the toy problem over a global batch of 2 rows a
    rank of `world` (this process's world by default).  In a process group
    each rank takes its own rows and the step reduces over the group;
    without one it is the one-device value of the same global batch.
    Weights come from torch seeds 0 and 1 on `device`'s type, and rank 0's
    reach every rank.  Returns the global batch's loss."""
    from indextts_tpu_torch.config import LoRAConfig, TrainConfig
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.train import trainer

    device = mesh.initialize_distributed(device)
    n = world or mesh.world()
    full = toy_batch(2 * n)
    group = mesh.data_group()
    lo, hi = (2 * mesh.rank(), 2 * mesh.rank() + 2) if group is not None else (0, 2 * n)

    def dev(x):
        x = torch.from_numpy(np.ascontiguousarray(x[lo:hi]))
        return x.to(device, torch.float32 if x.is_floating_point() else torch.int64)

    cfg, lora_cfg = toy_config(), LoRAConfig()
    base = uv.init_params(cfg, torch.Generator(device=device).manual_seed(0), torch.float32,
                          device)
    optimizer = trainer.make_optimizer(TrainConfig(), 100)
    state = trainer.init_train_state(torch.Generator(device=device).manual_seed(1), cfg,
                                     lora_cfg, optimizer, device)
    base, state = mesh.broadcast_tree((base, state))
    _, metrics = trainer.train_step(state, base, trainer.Batch(*(dev(x) for x in full)), cfg,
                                    lora_cfg, optimizer, 0.1, 0.0, group=group)
    return float(metrics["loss"])


def _toy_report(device: str) -> Dict[str, Any]:
    loss = run_toy_step(device=device)
    return {"rank": mesh.rank(), "world": mesh.world(), "device": str(mesh.local_device(device)),
            "loss": loss}


def tree_checksum(tree) -> int:
    """A checksum of a tree's bits: each leaf's bytes as int32 words (int16
    for 2-byte types), weighted by position and leaf, summed in int64 with
    wrap-around and cut to 52 bits (exact in a float64).  Equal trees give
    equal sums on any device; one changed bit changes the sum."""
    leaves, _ = mesh._flatten(tree)
    total = 0
    for i, x in enumerate(leaves):
        x = x.detach().contiguous().reshape(-1)
        words = x.view(torch.int16 if x.element_size() == 2 else torch.int32).long()
        pos = torch.arange(1, words.numel() + 1, device=words.device) % 65521
        total += (i + 1) * int((words * pos).sum()) + int(words.numel())
    return total % (1 << 52)


def worker_main(argv=None) -> None:
    """One rank: join the group the environment names, call the target on
    the payload, write the result where the parent reads it, leave."""
    p = argparse.ArgumentParser()
    p.add_argument("--target", required=True, help="module:function")
    p.add_argument("--out", required=True)
    p.add_argument("--payload", default=None)
    p.add_argument("--device", default="cpu")
    p.add_argument("--timeout", type=float, default=mesh.DEFAULT_TIMEOUT_S)
    args = p.parse_args(argv)
    mesh.initialize_distributed(args.device, timeout_s=args.timeout)
    module, name = args.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    payload = None
    if args.payload:
        with open(args.payload, "rb") as f:
            payload = pickle.load(f)
    result = fn(args.device) if payload is None else fn(args.device, payload)
    with open(os.path.join(args.out, f"rank{mesh.rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    mesh.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, payload: Any = None, device: str = "cpu",
              timeout: float = 120.0, env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Start `world` processes, rank r calling `target(device[, payload])`
    (a "module:function" name) in a process group with its peers, and
    return their results by rank.  On the card rank r runs on cuda:r.  The
    whole run and every collective in it are bounded by `timeout` seconds:
    a rank that fails or outlives it stops every rank, and this raises with
    the failing ranks' last output."""
    port = _free_port()
    work = tempfile.mkdtemp(prefix="ranks_")
    payload_path = None
    if payload is not None:
        payload_path = os.path.join(work, "payload.pkl")
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
    base = dict(os.environ)
    base.update(env or {})
    base["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p])
    if device == "cpu":
        base.setdefault("OMP_NUM_THREADS", "1")   # ranks share the host's cores
    procs, logs = [], []
    for r in range(world):
        e = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        cmd = [sys.executable, "-m", "indextts_tpu_torch.parallel.multihost", "--target", target,
               "--out", work, "--device", device, "--timeout", str(timeout)]
        if payload_path:
            cmd += ["--payload", payload_path]
        log = open(os.path.join(work, f"rank{r}.log"), "w+b")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=e, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed: List[str] = []
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [f"rank {r} rc={c}" for r, c in enumerate(codes) if c not in (None, 0)]
            if not failed and time.monotonic() > deadline:
                failed = [f"rank {r} outlived {timeout} s" for r, c in enumerate(codes)
                          if c is None]
            if failed:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {r} ---\n" + log.read().decode(errors="replace")[-3000:])
        log.close()
    try:
        if failed:
            raise RuntimeError("run_ranks failed: " + "; ".join(failed) + "\n"
                               + "\n".join(tails))
        results = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


def launch_check(num_processes: int = 2, device: str = "cpu",
                 timeout: float = 300.0) -> List[Dict[str, Any]]:
    """The toy step over `num_processes` ranks (gloo on the CPU, NCCL on
    cuda:0..N-1): each rank's report (rank, world, device, loss).  Raises
    on any rank's failure or timeout."""
    return run_ranks("indextts_tpu_torch.parallel.multihost:_toy_report", num_processes,
                     device=device, timeout=timeout)


if __name__ == "__main__":
    worker_main()
