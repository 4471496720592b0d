"""Tensor-parallel serving across cards (counterpart of
indextts_tpu/parallel/tp.py).

The JAX package shards the trunk's matrices over a ("model", N) mesh and
lets GSPMD insert the collectives.  The port holds explicit shards: rank r
of N keeps

  * `qkv_w` / `qkv_b` column-parallel by heads: its H/N heads of q, of k and
    of v, so the block's q/k/v split and head reshape work on the shard as
    they do on the whole (a contiguous third of the fused 3D columns would
    hand rank 0 all of q and half of k);
  * `fc_w` / `fc_b` column-parallel: its 4D/N contiguous columns;
  * both `proj_w` row-parallel: the rows that meet its columns, the partial
    products summed by one all-reduce each (models/gpt2.py), the replicated
    `proj_b` added once after the sum;
  * everything else whole: layer norms, embeddings, the heads, the
    conditioning encoder.

Quantized leaves (ops/quantization.py) shard under the same rule and keep
the unsharded tree's integers and scales: column-parallel scales split with
their columns, row-parallel scales stay whole ((x_r @ q_r) * s summed over r
is (x @ q) * s).  Packed int4 puts two rows of K in one byte, so a K split
unpacks, slices and packs again in the same layout.

The rest of the module runs the ranks of one engine (engine.py, `tp=N`):
the calling process is rank 0 on cuda:0; it starts ranks 1..N-1 itself, one
process each on cuda:r (or all on the CPU over gloo), each loading its own
shard of the weights, and sends them each of its sharded calls, in order,
over a pipe, so a plain command with `--tp N` needs no launcher.

    python -m indextts_tpu_torch.parallel.tp --rank R --world N ...

is one follower (started by `Followers`, never by hand).
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref
from multiprocessing.connection import Connection
from typing import Any, Dict, List, Optional, Tuple

import torch

from indextts_tpu_torch.ops import quantization
from indextts_tpu_torch.parallel import mesh

TIMEOUT_S = 300.0       # every collective's deadline, a follower's for its answer, and a
                        # call's for its next collective (`Followers`, read when one is built)

# how each trunk leaf splits (the counterpart of JAX's `gpt_param_specs`):
# "heads" (column-parallel, per head of q, k and v), "columns", "rows", or
# None (replicated)
GPT_SPLITS = {
    "blocks": {
        "ln_1": {"scale": None, "bias": None},
        "attn": {"qkv_w": "heads", "qkv_b": "heads", "proj_w": "rows", "proj_b": None},
        "ln_2": {"scale": None, "bias": None},
        "mlp": {"fc_w": "columns", "fc_b": "columns", "proj_w": "rows", "proj_b": None},
    },
    "ln_f": {"scale": None, "bias": None},
}


def _columns(x: torch.Tensor, split: str, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s share of x's last axis: its H/N heads of each of q, k
    and v ("heads"), or its contiguous N-th ("columns")."""
    N = x.shape[-1]
    if split == "heads":
        return x.reshape(x.shape[:-1] + (3, n, N // (3 * n)))[..., rank, :].reshape(
            x.shape[:-1] + (N // n,)).contiguous()
    return x.reshape(x.shape[:-1] + (n, N // n))[..., rank, :].contiguous()


def _rows(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    K = x.shape[-2]
    return x[..., rank * K // n:(rank + 1) * K // n, :].contiguous()


def _fused_int4_rows(leaf: Dict[str, torch.Tensor], rank: int, n: int) -> Dict[str, torch.Tensor]:
    """Rows [r K/N, (r+1) K/N) of a fused-layout int4 leaf {"q4", "s"}, packed
    again in that layout with G' = max(1, G / N) groups, each (group, half)
    of the shard under the one scale row its rows had."""
    q4, s = leaf["q4"], leaf["s"]
    lead, (Kh, N) = tuple(q4.shape[:-2]), tuple(q4.shape[-2:])
    K, G = 2 * Kh, s.shape[-2] // 2
    half = Kh // G
    lo, hi = quantization.unpack_int4(q4)
    rows = torch.stack([lo.reshape(lead + (G, half, N)), hi.reshape(lead + (G, half, N))],
                       dim=-3).reshape(lead + (K, N))
    scales = s.reshape(lead + (G, 2, 1, N)).expand(lead + (G, 2, half, N)).reshape(lead + (K, N))
    Kr, Gr = K // n, max(1, G // n)
    if Kr % (2 * Gr):
        raise ValueError(f"int4 rows: K={K} over {n} ranks does not split into {Gr} groups")
    hr = Kr // (2 * Gr)
    rows = _rows(rows, rank, n).reshape(lead + (Gr, 2, hr, N))
    scales = _rows(scales, rank, n).reshape(lead + (Gr, 2, hr, N))
    if not torch.equal(scales, scales[..., :1, :].expand_as(scales)):
        raise ValueError(f"int4 rows: a (group, half) of rank {rank}'s shard spans two scales")
    packed = quantization._pack_nibbles(rows[..., 0, :, :], rows[..., 1, :, :])
    return {"q4": packed.reshape(lead + (Kr // 2, N)),
            "s": scales[..., 0, :].reshape(lead + (2 * Gr, N)).contiguous()}


def _shared_int4_rows(leaf: Dict[str, torch.Tensor], rank: int, n: int) -> Dict[str, torch.Tensor]:
    """Rows [r K/N, (r+1) K/N) of a shared-layout int4 leaf {"q4s", "s"},
    packed again in that layout; the scale stays whole."""
    lo, hi = quantization.unpack_int4(leaf["q4s"])
    rows = _rows(torch.cat([lo, hi], dim=-2), rank, n)
    Kr = rows.shape[-2]
    return {"q4s": quantization._pack_nibbles(rows[..., :Kr // 2, :], rows[..., Kr // 2:, :]),
            "s": leaf["s"]}


def _shard_leaf(leaf, split: Optional[str], rank: int, n: int):
    if split is None:
        return leaf
    if not isinstance(leaf, dict):                  # a plain matrix or bias
        return _rows(leaf, rank, n) if split == "rows" else _columns(leaf, split, rank, n)
    if split != "rows":                             # integers and scales split with columns
        return {k: _columns(v, split, rank, n) for k, v in leaf.items()}
    if "q4" in leaf:
        return _fused_int4_rows(leaf, rank, n)
    if "q4s" in leaf:
        return _shared_int4_rows(leaf, rank, n)
    qkey = "q" if "q" in leaf else "q4n"
    return {qkey: _rows(leaf[qkey], rank, n), "s": leaf["s"]}


def shard_gpt_params(params: Dict[str, Any], rank: int, n: int) -> Dict[str, Any]:
    """Rank `rank` of `n`'s shard of a trunk tree (models/gpt2.py's layout,
    any weight form of ops/quantization.py)."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} of {n}")

    def walk(tree, splits):
        if isinstance(splits, dict):
            return {k: walk(tree[k], splits[k]) for k in splits}
        return _shard_leaf(tree, splits, rank, n)

    return walk(params, GPT_SPLITS)


def shard_uv_params(params: Dict[str, Any], rank: int, n: int) -> Dict[str, Any]:
    """The whole UnifiedVoice tree as rank `rank` of `n` holds it: the trunk
    sharded (`shard_gpt_params`), every other entry as it is."""
    return {k: shard_gpt_params(v, rank, n) if k == "gpt" else v for k, v in params.items()}


def check_heads(heads: int, n: int) -> None:
    if n > 1 and heads % n:
        raise ValueError(f"tp={n} does not divide the trunk's {heads} heads")


def to_device(tree, device):
    """A tree's tensors on `device` (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


# --- the ranks of one engine ------------------------------------------------


class TPBroken(RuntimeError):
    """The tensor-parallel group can take no more calls: a rank failed or
    died.  Close the engine and build a new one."""


def _put(conn: Connection, obj) -> None:
    """Plain pickles over the pipes: tensors by value (multiprocessing's own
    pickler would pass them as shared memory, which a stranger process
    cannot open)."""
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _get(conn: Connection):
    return pickle.loads(conn.recv_bytes())


def call(engine, target: str, args: Tuple):
    """`engine.<target>(*args)`, or `function(engine, *args)` for a target
    "module:function" (parallel/multihost.run_ranks's form)."""
    if ":" in target:
        module, name = target.split(":")
        return getattr(importlib.import_module(module), name)(engine, *args)
    return getattr(engine, target)(*args)


def _log_tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")[-n:]
    except OSError:
        return ""


class Followers:
    """Rank 0's side of an engine's group: ranks 1..N-1 as processes of their
    own, each holding its shards in an engine of its own and running the
    calls rank 0 sends, in the order sent.  `run` sends one call to every
    follower, makes it here, and waits for their answers; one call runs at a
    time (the lock), so two threads of rank 0 never interleave their
    collectives.  A follower that fails, dies, does not answer within the
    deadline, or leaves a call without a collective on this rank for the
    deadline (it hangs) makes `run` raise (and the group takes no more
    calls: `broken` says why); a follower whose rank 0 is gone exits."""

    def __init__(self, n: int, device: torch.device, init_kwargs: Dict[str, Any],
                 timeout_s: Optional[float] = None):
        self.n = n
        self.timeout_s = float(TIMEOUT_S if timeout_s is None else timeout_s)
        self.lock = threading.Lock()
        self.broken: Optional[str] = None
        self._call: Optional[Tuple[str, float]] = None   # (name, start) of the call in flight
        self._closing = threading.Event()
        self._dir = tempfile.mkdtemp(prefix="tp_")
        store = mesh.tp_store(n, self.timeout_s)
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.procs: List[subprocess.Popen] = []
        self.cmds: List[Connection] = []
        self.acks: List[Connection] = []
        self.logs: List[str] = []
        self._finalizer = weakref.finalize(self, _stop, self.procs)
        for r in range(1, n):
            cmd_r, cmd_w = os.pipe()
            ack_r, ack_w = os.pipe()
            log = os.path.join(self._dir, f"rank{r}.log")
            argv = [sys.executable, "-m", "indextts_tpu_torch.parallel.tp", "--rank", str(r),
                    "--world", str(n), "--port", str(store.port), "--device", device.type,
                    "--timeout", str(self.timeout_s), "--threads", str(torch.get_num_threads()),
                    "--cmd-fd", str(cmd_r), "--ack-fd", str(ack_w)]
            with open(log, "wb") as f:
                self.procs.append(subprocess.Popen(argv, env=env, stdout=f,
                                                   stderr=subprocess.STDOUT,
                                                   pass_fds=(cmd_r, ack_w)))
            os.close(cmd_r)
            os.close(ack_w)
            self.cmds.append(Connection(cmd_w, readable=False))
            self.acks.append(Connection(ack_r, writable=False))
            self.logs.append(log)
        try:
            for r in range(1, n):
                self._send(r, init_kwargs)
            for r in range(1, n):
                self._answer(r, "start")           # the follower's imports are done
            self.group = mesh.TPGroup(0, n, device, store, self.timeout_s)
        except BaseException:
            self.close()
            raise
        self._monitor = threading.Thread(target=self._watch, daemon=True, name="tp-watch")
        self._monitor.start()

    def wait_ready(self) -> None:
        """Wait for every follower's engine (its weights loaded and sharded)."""
        for r in range(1, self.n):
            self._answer(r, "the engine's construction")

    # -- plumbing -----------------------------------------------------------

    def _fail(self, why: str) -> TPBroken:
        """Break the group for `why`; the error to raise (naming the first
        cause, when another came before)."""
        if self.broken is None:
            self.broken = why
        first = "" if why == self.broken else f"{self.broken}\nthen: "
        return TPBroken(f"tensor-parallel group: {first}{why}")

    def _dead(self, r: int) -> str:
        code = self.procs[r - 1].poll()
        return (f"rank {r} exited with code {code}\n--- rank {r} log ---\n"
                f"{_log_tail(self.logs[r - 1])}")

    def _send(self, r: int, msg) -> None:
        try:
            _put(self.cmds[r - 1], msg)
        except (BrokenPipeError, OSError) as e:
            raise self._fail(f"rank {r} does not take calls ({e!r}); "
                             + self._dead(r)) from None

    def _answer(self, r: int, what: str):
        """Follower r's answer to the call `what`, within the deadline."""
        conn, proc = self.acks[r - 1], self.procs[r - 1]
        deadline = time.monotonic() + self.timeout_s
        while True:
            if self.broken is not None and self._call is not None:
                raise TPBroken(f"tensor-parallel group: {self.broken}")
            if conn.poll(0.05):
                try:
                    status, payload = _get(conn)
                except (EOFError, OSError):
                    raise self._fail(self._dead(r)) from None
                if status == "error":
                    raise self._fail(f"rank {r} failed in {what}:\n{payload}")
                return payload
            if proc.poll() is not None:
                raise self._fail(self._dead(r))
            if time.monotonic() > deadline:
                raise self._fail(f"rank {r} gave no answer to {what} within {self.timeout_s} s")

    def _watch(self) -> None:
        """Notice a follower's death, between or during calls, and a call in
        which this rank issued no collective for the deadline (a rank hangs:
        on the card this rank then waits in a sync of the card, which no
        deadline of its own reaches).  Either breaks the group and aborts its
        pending collectives, so that the call raises."""
        while not self._closing.wait(0.2):
            why = next((self._dead(r) for r, p in enumerate(self.procs, start=1)
                        if p.poll() is not None), None)
            in_flight = self._call
            if why is None and in_flight is not None:
                name, start = in_flight
                quiet = time.monotonic() - max(start, self.group.last_issued)
                if quiet > self.timeout_s:
                    why = (f"{name} issued no collective on rank 0 for {quiet:.1f} s "
                           f"(deadline {self.timeout_s} s): a rank hangs")
            if why is not None and not self._closing.is_set():
                self._fail(why)
                self.group.abort(why)
                return

    # -- calls --------------------------------------------------------------

    def run(self, engine, name: str, args: Tuple):
        """`call(engine, name, args)` on every rank: sent to the followers
        (their tensors by value), then made here.  Returns (this rank's
        result, [each follower's result])."""
        with self.lock:
            if self.broken is not None:
                raise TPBroken(f"tensor-parallel group: {self.broken}")
            payload = to_device(args, "cpu")
            self._call = (name, time.monotonic())
            try:
                for r in range(1, self.n):
                    self._send(r, (name, payload))
                try:
                    out = call(engine, name, args)
                except BaseException as e:
                    # a failed collective here: the followers' answers say why
                    why = "".join(self._peek(r) for r in range(1, self.n))
                    raise self._fail(f"rank 0 failed in {name}: {e!r}{why}") from e
                return out, [self._answer(r, name) for r in range(1, self.n)]
            finally:
                self._call = None

    def _peek(self, r: int, wait_s: float = 5.0) -> str:
        """What follower r says, or how it ended, within `wait_s`."""
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                if self.acks[r - 1].poll(0.05):
                    status, payload = _get(self.acks[r - 1])
                    return f"\nrank {r}: {status}: {payload}"
            except (EOFError, OSError):
                pass
            if self.procs[r - 1].poll() is not None:
                return "\n" + self._dead(r)
        return f"\nrank {r}: running, no answer within {wait_s} s"

    def close(self, timeout: float = 30.0) -> None:
        """Stop every follower (they exit once told, or once rank 0's pipe
        closes; those of a broken group, which may hang, are killed at once)
        and leave the group.  Idempotent."""
        if self._closing.is_set():
            return
        self._closing.set()
        if self.broken is not None:
            timeout = 0.0
        self.broken = self.broken or "the engine is closed"
        # after the call in flight, if any (its answers end it within the deadline)
        taken = self.lock.acquire(timeout=self.timeout_s)
        for c in self.cmds:
            try:
                _put(c, None)
            except (BrokenPipeError, OSError):
                pass
        group = getattr(self, "group", None)
        if group is not None:
            group.close()
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()) if timeout else 0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in self.cmds + self.acks:
            c.close()
        self._finalizer.detach()
        if taken:
            self.lock.release()
        for log in self.logs:
            try:
                os.remove(log)
            except OSError:
                pass
        try:
            os.rmdir(self._dir)
        except OSError:
            pass


def _stop(procs) -> None:
    """The followers of an engine dropped without close(): killed."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def follower_main(argv=None) -> int:
    """One follower: join the group, build the engine rank 0 describes with
    this rank's shards, then run rank 0's calls in order until told to stop
    or until rank 0's pipe closes.  A failed call is reported and ends the
    process (the group is broken by then).  The process leaves by
    `os._exit`, without tearing its communicator down: rank 0 may already
    have left the group, and a teardown that waited for it would hang."""
    p = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--port", "--cmd-fd", "--ack-fd", "--threads"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=TIMEOUT_S)
    args = p.parse_args(argv)
    cmd = Connection(args.cmd_fd, writable=False)
    ack = Connection(args.ack_fd, readable=False)
    if args.device == "cpu":
        torch.set_num_threads(args.threads)   # rank 0's reductions, bit for bit
    try:
        init_kwargs = _get(cmd)
        _put(ack, ("ok", None))
        device = torch.device("cpu")
        if args.device == "cuda":
            device = torch.device("cuda", args.rank)
            torch.cuda.set_device(device)     # the kernels' launches use the current card
        store = mesh.tp_store(args.world, args.timeout, port=args.port)
        group = mesh.TPGroup(args.rank, args.world, device, store, args.timeout)
        from indextts_tpu_torch.engine import IndexTTS   # while rank 0 loads its weights

        engine = IndexTTS(**init_kwargs, tp=args.world, _tp_member=(args.rank, group))
        _put(ack, ("ok", None))
    except EOFError:
        return 0
    except BaseException:   # noqa: BLE001 — reported to rank 0
        _report(ack)
        return 1
    while True:
        try:
            msg = _get(cmd)
        except EOFError:                      # rank 0 is gone
            break
        if msg is None:
            break
        try:
            name, payload = msg
            out = call(engine, name, to_device(payload, engine.device))
            _put(ack, ("ok", to_device(out, "cpu")))
        except BaseException:   # noqa: BLE001 — reported to rank 0
            _report(ack)
            return 1
    return 0


def _report(ack: Connection) -> None:
    """The exception being handled, to rank 0 if it still listens."""
    try:
        _put(ack, ("error", traceback.format_exc()))
    except OSError:
        traceback.print_exc()


if __name__ == "__main__":
    code = follower_main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
