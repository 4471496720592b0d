"""Process groups for data-parallel training across cards (counterpart of
indextts_tpu/parallel/mesh.py).

The JAX package expresses data parallelism as a `Mesh(('data',))` over the
devices of one controller, and XLA inserts the collectives.  The port runs
one process per card, launched by

    python -m torch.distributed.run --nproc_per_node N -m <module> ...

whose environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
names the world.  `initialize_distributed` joins it, over NCCL on the card
and gloo on the CPU, and the trainers call the collectives themselves:

  * `all_reduce_tree` sums (or averages) a tree of tensors, gradients and
    metrics together, in one collective over one flat fp32 buffer (the
    vocoder's generator alone has 664 leaves);
  * `broadcast_tree` copies rank 0's tree to every rank, bit for bit;
  * `subgroup(n)` is the first n ranks (the vocoder's `n_use`).

A process whose environment names no world starts no group, and every
helper is then the identity: a single-card run computes what it did before
the port trained across cards.  Under the launcher a world of one is a real
group of one.  JAX's `make_mesh`, `data_sharding`, `replicated` and
`ShardingRules` have no torch meaning (a rank holds whole parameters and
its own rows) and are not ported.

`TPGroup` is the group of one tensor-parallel engine (parallel/tp.py): a
process group of its own beside torch.distributed's default world (so an
engine can be built and closed again in any process), over NCCL on the
card and gloo on the CPU, its rendezvous a TCP store on localhost, and each
collective bounded by a deadline.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
NCCL_GRACE_S = 60.0     # a TPGroup's collectives on the card: its deadline plus this


def env_world() -> Optional[int]:
    """The world size the environment names (torchrun's WORLD_SIZE with its
    RANK and MASTER_ADDR), or None where it names none."""
    if not all(os.environ.get(k) for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR")):
        return None
    return int(os.environ["WORLD_SIZE"])


def initialize_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> torch.device:
    """Join the process group the environment names and return this rank's
    device: `cuda:LOCAL_RANK` (made the current device) under NCCL, or the
    CPU under gloo, each collective bounded by `timeout_s`.  Without such an
    environment, or once joined, it starts nothing and returns the device
    (the card this process already uses).  A rank whose LOCAL_RANK names no
    visible card raises: it never falls back to the CPU."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dist.is_available() and dist.is_initialized():
        return local_device(device)
    if env_world() is None:
        return device
    rank_ = int(os.environ["RANK"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank_))
        visible = torch.cuda.device_count()
        if not 0 <= local < visible:
            raise RuntimeError(f"rank {rank_}: LOCAL_RANK {local} names no visible card "
                               f"({visible} visible)")
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return local_device(device)


def local_device(device="cuda") -> torch.device:
    """This process's device of `device`'s type: the current card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def data_group():
    """The whole world's group, or None (no collective) without one."""
    return dist.group.WORLD if is_initialized() else None


def subgroup(n: int):
    """The first `n` ranks' group: the world's when `n` is the world, a new
    one otherwise, which every rank must ask for (torch's new_group is
    collective) and only ranks below `n` may use; None without a world."""
    if not is_initialized():
        return None
    if not 1 <= n <= world():
        raise ValueError(f"a subgroup of {n} ranks in a world of {world()}")
    if n == world():
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def barrier(group=None) -> None:
    """Wait for every rank of `group` (the world by default); nothing
    without a world."""
    if not is_initialized():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if is_initialized():
        dist.destroy_process_group()


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """The tensors of a tree of dicts (sorted keys), lists and tuples
    (NamedTuples too), and a function that rebuilds the tree around new
    ones.  Other leaves are kept as they are."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            parts = [walk(node[k]) for k in keys]
            return lambda it: {k: p(it) for k, p in zip(keys, parts)}
        if isinstance(node, (list, tuple)):
            parts = [walk(x) for x in node]
            make = type(node)
            if hasattr(node, "_fields"):
                return lambda it: make(*(p(it) for p in parts))
            return lambda it: make(p(it) for p in parts)
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return lambda it: next(it)
        return lambda it: node

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def all_reduce_tree(tree, op: str = "sum", group=None):
    """The tree summed (`op="sum"`) or averaged (`"mean"`) over `group`'s
    ranks, each leaf in its own type: the leaves travel in one flat fp32
    buffer through one collective (integer counts are exact below 2**24).
    `group=None` returns the tree as it is."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if group is None:
        return tree
    leaves, rebuild = _flatten(tree)
    if not leaves:
        return tree
    flat = torch.cat([x.detach().reshape(-1).float() for x in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if op == "mean":
        flat /= dist.get_world_size(group)
    parts = flat.split([x.numel() for x in leaves])
    return rebuild([p.view(x.shape).to(x.dtype) for p, x in zip(parts, leaves)])


def broadcast_tree(tree, src: int = 0, group=None):
    """Rank `src`'s tree on every rank of `group`, bit for bit: one
    collective per leaf type over a flat buffer of that type.  Without a
    world the tree is returned as it is."""
    if not is_initialized():
        return tree
    leaves, rebuild = _flatten(tree)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dtype in sorted({x.dtype for x in leaves}, key=str):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=group)
        for i, p in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = p.view(leaves[i].shape)
    return rebuild(out)


def _host_tensor(values, group) -> torch.Tensor:
    """Host numbers as a float64 tensor where `group`'s backend reads it."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return torch.tensor([float(v) for v in values], dtype=torch.float64, device=dev)


def all_reduce_host(values, op: str = "sum", group=None) -> List[float]:
    """Host numbers summed (`op="sum"`) or maximised (`"max"`) over `group`
    in float64 (validation's sum and count, a batch's widths); the values as
    they are without a group.  A host read: it waits for the card."""
    if group is None:
        return [float(v) for v in values]
    t = _host_tensor(values, group)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return t.cpu().tolist()


def all_gather_host(values, group=None) -> List[List[float]]:
    """Every rank's host numbers in float64, by rank (checksums, peak
    memory); the values alone without a group."""
    if group is None:
        return [[float(v) for v in values]]
    t = _host_tensor(values, group)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.cpu().tolist() for o in out]


def tp_store(n: int, timeout_s: float, port: Optional[int] = None):
    """The rendezvous of an engine's `n` ranks on localhost: rank 0's store
    on a free port (`port` None), or a follower's client of it."""
    return dist.TCPStore("127.0.0.1", 0 if port is None else port, n, port is None,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as flat int32 words (1-byte and bool values widened,
    2-byte values widened from int16)."""
    x = x.detach().contiguous().reshape(-1)
    size = x.element_size()
    if size in (4, 8):
        return x.view(torch.int32)
    if size == 2:
        return x.view(torch.int16).to(torch.int32)
    return x.to(torch.int32)


def _from_words(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    size = like.element_size()
    if size == 8:                  # a copy: its words start on an 8-byte boundary
        out = w.clone().view(like.dtype)
    elif size == 4:
        out = w.view(like.dtype)
    elif size == 2:
        out = w.to(torch.int16).view(like.dtype)
    else:
        out = w.to(like.dtype)
    return out.view(like.shape)


class TPGroup:
    """The process group of one tensor-parallel engine: `size` ranks, rank r
    on `device` (cuda:r under NCCL, or the CPU under gloo), built over
    `store` (`tp_store`) and bounded by `timeout_s` a collective (on the card
    `NCCL_GRACE_S` more: the card's watchdog ends the process when a
    collective outlives its timeout, so rank 0's own deadline, parallel/tp.py,
    must come first and abort instead).  It counts what it does:
    `all_reduces` (the trunk's sums, models/gpt2.py) and `agreements` (rank
    0's choices copied to every rank, and the end-of-call checks); and
    `last_issued` is when this rank last issued a collective (monotonic
    seconds), which tells a wait on a rank that hangs from a long call."""

    def __init__(self, rank: int, size: int, device, store, timeout_s: float):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.store = store            # rank 0's store hosts the rendezvous: keep it alive
        timeout = datetime.timedelta(seconds=timeout_s)
        prefixed = dist.PrefixStore("tp", store)
        if self.device.type == "cuda":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout + datetime.timedelta(seconds=NCCL_GRACE_S)
            self.pg = dist.ProcessGroupNCCL(prefixed, rank, size, opts)
            if not callable(getattr(self.pg, "abort", None)):
                raise RuntimeError("tensor-parallel group: this torch's ProcessGroupNCCL has "
                                   "no abort(), so a rank that dies or hangs could not be "
                                   "survived")
        else:
            self.pg = dist.ProcessGroupGloo(prefixed, rank, size, timeout)
        self.all_reduces = 0
        self.agreements = 0
        self.aborted: Optional[str] = None
        self.last_issued = time.monotonic()
        # the first collective: every rank is there, and (on the card) the
        # communicator is made now rather than inside the first call
        hello = torch.ones(1, device=self.device)
        self.pg.allreduce([hello]).wait()
        if int(hello.item()) != size:
            raise RuntimeError(f"tensor-parallel group: {hello.item()} ranks answered, not {size}")

    @classmethod
    def from_world(cls, timeout_s: float = DEFAULT_TIMEOUT_S) -> "TPGroup":
        """A group of every rank of the default world (`initialize_distributed`,
        e.g. under parallel/multihost.run_ranks), on this rank's device: rank
        0's store port reaches the others through the world."""
        port = torch.zeros(1, dtype=torch.int64)
        store = None
        if rank() == 0:
            store = tp_store(world(), timeout_s)
            port[0] = store.port
        dev = local_device("cuda" if dist.get_backend() == "nccl" else "cpu")
        port = broadcast_tree(port.to(dev)).cpu()
        if store is None:
            store = tp_store(world(), timeout_s, port=int(port[0]))
        return cls(rank(), world(), dev, store, timeout_s)

    def _issue(self) -> None:
        if self.aborted is not None:
            raise RuntimeError(f"tensor-parallel group aborted: {self.aborted}")
        self.last_issued = time.monotonic()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, in place (x's type); counted."""
        self._issue()
        self.pg.allreduce([x]).wait()
        self.all_reduces += 1
        return x

    def agree(self, tree):
        """Rank 0's values of a tree of tensors on every rank, bit for bit,
        in one collective (the leaves as int32 words); counted."""
        leaves, rebuild = _flatten(tree)
        flat = torch.cat([_as_words(x) for x in leaves])
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = 0, 0
        self._issue()
        self.pg.broadcast([flat], opts).wait()
        self.agreements += 1
        parts = flat.split([_as_words(x).numel() for x in leaves])
        return rebuild([_from_words(p, x) for p, x in zip(parts, leaves)])

    def check_same(self, x: torch.Tensor, what: str) -> None:
        """Raise on every rank unless every rank holds rank 0's `x`."""
        ref = self.agree(x.clone())
        bad = torch.tensor([0 if torch.equal(ref, x) else self.rank + 1], dtype=torch.int32,
                           device=x.device)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX
        self._issue()
        self.pg.allreduce([bad], opts).wait()
        if int(bad.item()):
            raise RuntimeError(f"tensor-parallel ranks disagree on {what}: rank "
                               f"{int(bad.item()) - 1} differs from rank 0")

    def abort(self, why: str = "aborted") -> None:
        """Take no more collectives (the next one raises `why`) and, on the
        card, end the pending ones: the communicator's abort stops its
        kernels, which would otherwise wait for a peer that is gone or hangs.
        Gloo fails its pending collectives itself, on their deadline or when a
        peer's socket closes."""
        self.aborted = self.aborted or why
        if self.device.type == "cuda":
            self.pg.abort()

    def close(self) -> None:
        """Leave the group without waiting for the other ranks, which may be
        gone already: an abort of the communicator on the card, a shutdown
        of gloo's sockets on the CPU."""
        if self.device.type == "cuda":
            self.abort("the group is closed")
            return
        self.aborted = self.aborted or "the group is closed"
        shutdown = getattr(self.pg, "shutdown", None)
        if shutdown is not None:
            try:
                shutdown()
            except Exception:   # noqa: BLE001 — a group whose peer is gone
                pass


def device_info() -> dict:
    """Inventory of the visible cards and this process's place in the world
    (the counterpart of JAX's device_info): one card per rank."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"platform": "gpu" if n else "cpu", "num_devices": world() if n else 0,
            "num_local_devices": n, "process_index": rank(), "num_processes": world(),
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "backend": dist.get_backend() if is_initialized() else None}
