"""The trainers' optimizers as explicit state: optax chains written out.

`AdamW` is the DVAE trainer's chain (indextts_tpu/train/dvae.py:69-73),
over any nested tree of dicts and lists:

    clip_by_global_norm(max_grad_norm)
    -> adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay_steps),
             weight_decay), decay on every leaf, biases too

and, given a schedule and its b1, b2, the vocoder trainer's
(indextts_tpu/train/vocoder.py:91-95):

    clip_by_global_norm(1000) -> adamw(exponential_decay(lr, 1, rate),
                                       b1=0.8, b2=0.99, weight_decay=0)

`LoRAPlusAdamW` is the LoRA trainer's (indextts_tpu/train/trainer.py:50-81)
on the same core:

    clip_by_global_norm(max_grad_norm)
    -> AdamW per LoRA+ group: `a` at the base rate, `b` at rate x
       loraplus_lr_ratio, each on a warmup-cosine schedule
    wrapped, for gradient_accumulation_steps k > 1, in MultiSteps: a running
    mean of k micro-gradients, applied on every k-th call.

The formulas are optax's, not torch.optim's: the clip has no epsilon
(`g` if |g| < max, else g / |g| * max); weight decay joins the Adam
direction before the -lr scale; the schedule is read at the count before
its increment, so the first update has lr 0 after a warmup; and, as
MultiSteps does, the inner update runs on every call and is kept only on
the k-th.  Everything stays on the device: a step has no host sync.

The state is a plain tree of tensors, so a checkpoint restores it exactly:
    {"count": int32, "mu": tree, "nu": tree}  (+ "mini_step", "acc" for k > 1)
LoRA+'s two groups update in lockstep, so one count serves both.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple, Union

import torch

from indextts_tpu_torch.config import TrainConfig
from indextts_tpu_torch.train.lora import loraplus_labels, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


def tree_leaves(tree):
    """Leaves in sorted-key order, as JAX flattens a dict; lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's sum of squares."""
    leaves = tree_leaves(tree)
    total = torch.sum(leaves[0] * leaves[0])
    for x in leaves[1:]:
        total = total + torch.sum(x * x)
    return torch.sqrt(total)


def warmup_cosine(count: torch.Tensor, peak: float, warmup: int,
                  decay_steps: int) -> torch.Tensor:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, 0)
    at `count`, in fp32: linear from 0 over the warmup, then a cosine to 0
    (no warmup leg when warmup is 0, as optax's join of the two)."""
    W = float(warmup)
    span = float(decay_steps - warmup)
    c = count.float()
    c2 = torch.clamp(c - W, max=span)
    cosine = peak * (0.5 * (1 + torch.cos(math.pi * c2 / span)))
    if warmup <= 0:
        return cosine
    warm = (0.0 - peak) * (1 - c.clamp(0, W) / W) + peak
    return torch.where(c < W, warm, cosine)


def exponential_decay(lr: float, transition_steps: int, rate: float) -> Callable:
    """optax.exponential_decay(lr, transition_steps, rate) as a schedule
    `count -> lr`: lr * rate^(count / transition_steps) in fp32 (no
    staircase, no transition_begin, no end value)."""
    if transition_steps <= 0 or rate == 0:
        raise ValueError("exponential_decay needs transition_steps > 0 and rate != 0")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        return torch.where(c <= 0, torch.full_like(c, lr),
                           lr * torch.pow(rate, c / transition_steps))

    return schedule


class AdamW:
    """`init(params) -> state` and `step(grads, state, params) -> (params,
    state)`: clip by the global norm, then AdamW on one schedule for every
    leaf of a nested tree of fp32 tensors."""

    def __init__(self, lr: Union[float, Callable], warmup_steps: int = 0,
                 decay_steps: int = 1, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, b1: float = B1, b2: float = B2):
        """`lr`: a schedule `count -> lr` (an fp32 tensor, e.g.
        `exponential_decay`), or the peak rate of a warmup-cosine over
        `warmup_steps` and `decay_steps`."""
        self.schedule = lr if callable(lr) else None
        self.lr = None if callable(lr) else float(lr)
        self.warmup = int(warmup_steps)
        self.decay_steps = int(decay_steps)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = float(max_grad_norm)
        self.b1, self.b2 = float(b1), float(b2)

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        if self.schedule is not None:
            return self.schedule(count)
        return warmup_cosine(count, self.lr, self.warmup, self.decay_steps)

    def _rates(self, count: torch.Tensor, params: Dict[str, Any]) -> Dict[str, Any]:
        """Each leaf's learning rate at `count`."""
        lr = self.learning_rate(count)
        return tree_map(lambda _: lr, params)

    def _inner(self, grads, state, params):
        """clip -> AdamW -> (updates, new count, mu, nu)."""
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        grads = tree_map(lambda g: torch.where(keep, g, (g / norm) * self.max_grad_norm),
                         grads)
        count = state["count"]
        count_inc = count + 1
        one = torch.ones((), dtype=torch.float32, device=count.device)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - (one * b1) ** count_inc.float()
        bc2 = 1 - (one * b2) ** count_inc.float()

        def leaf(g, mu, nu, p, lr):
            m = (1 - b1) * g + b1 * mu
            v = (1 - b2) * (g * g) + b2 * nu
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            u = u + self.weight_decay * p
            return m, v, (-lr) * u

        out = tree_map(leaf, grads, state["mu"], state["nu"], params,
                       self._rates(count, params))
        mu, nu, upd = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return upd, count_inc, mu, nu

    def step(self, grads: Dict[str, Any], state: Dict[str, Any],
             params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        upd, count, mu, nu = self._inner(grads, state, params)
        return tree_map(torch.add, params, upd), {"count": count, "mu": mu, "nu": nu}


class LoRAPlusAdamW(AdamW):
    """`init(params) -> state` and `step(grads, state, params) -> (params,
    state)` over a LoRA tree {target: {"a", "b"}} of fp32 tensors."""

    def __init__(self, train_cfg: TrainConfig, total_steps: int):
        """`total_steps` counts optimizer updates, not micro-steps."""
        opt = train_cfg.optimizer
        warmup = max(1, int(total_steps * opt.warmup_ratio))
        super().__init__(opt.learning_rate, warmup, max(total_steps, warmup + 1),
                         opt.weight_decay, train_cfg.max_grad_norm)
        self.k = max(1, int(train_cfg.gradient_accumulation_steps))
        self.peak = {"a": float(opt.learning_rate),
                     "b": float(opt.learning_rate) * float(opt.loraplus_lr_ratio)}

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        state = super().init(params)
        if self.k > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int32,
                                             device=state["count"].device)
            state["acc"] = tree_map(torch.zeros_like, params)
        return state

    def learning_rate(self, count: torch.Tensor, group: str) -> torch.Tensor:
        return warmup_cosine(count, self.peak[group], self.warmup, self.decay_steps)

    def _rates(self, count: torch.Tensor, params: Dict[str, Any]) -> Dict[str, Any]:
        lrs = {g: self.learning_rate(count, g) for g in self.peak}
        return tree_map(lambda label: lrs[label], loraplus_labels(params))

    def step(self, grads: Dict[str, Any], state: Dict[str, Any],
             params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        if self.k == 1:
            return super().step(grads, state, params)
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state["acc"])
        upd, count, mu, nu = self._inner(acc, state, params)
        emit = n == self.k - 1
        pick = lambda a, b: torch.where(emit, a, b)  # noqa: E731
        params = tree_map(lambda p, u: p + u * emit, params, upd)
        return params, {
            "count": pick(count, state["count"]),
            "mu": tree_map(pick, mu, state["mu"]),
            "nu": tree_map(pick, nu, state["nu"]),
            "mini_step": (n + 1) % self.k,
            "acc": tree_map(lambda a: a * ~emit, acc),
        }
