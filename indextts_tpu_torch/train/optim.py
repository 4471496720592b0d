"""The trainer's optimizer as explicit state: the optax chain of the JAX
package's `make_optimizer` (indextts_tpu/train/trainer.py:50-81) written out.

    clip_by_global_norm(max_grad_norm)
    -> AdamW per LoRA+ group: `a` at the base rate, `b` at rate x
       loraplus_lr_ratio, each on a warmup-cosine schedule
    wrapped, for gradient_accumulation_steps k > 1, in MultiSteps: a running
    mean of k micro-gradients, applied on every k-th call.

The formulas are optax's, not torch.optim's: the clip has no epsilon
(`g` if |g| < max, else g / |g| * max); weight decay joins the Adam
direction before the -lr scale; the schedule is read at the group's count
before its increment, so the first update has lr 0; and, as MultiSteps
does, the inner update runs on every call and is kept only on the k-th.
Everything stays on the device: a step has no host sync.

The state is a plain tree of tensors, so a checkpoint restores it exactly:
    {"count": int32, "mu": tree, "nu": tree}  (+ "mini_step", "acc" for k > 1)
The two groups update in lockstep, so one count serves both.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from indextts_tpu_torch.config import TrainConfig
from indextts_tpu_torch.train.lora import loraplus_labels, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


def tree_leaves(tree):
    """Leaves in sorted-key order, as JAX flattens a dict."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's sum of squares."""
    leaves = tree_leaves(tree)
    total = torch.sum(leaves[0] * leaves[0])
    for x in leaves[1:]:
        total = total + torch.sum(x * x)
    return torch.sqrt(total)


class LoRAPlusAdamW:
    """`init(params) -> state` and `step(grads, state, params) -> (params,
    state)` over a LoRA tree {target: {"a", "b"}} of fp32 tensors."""

    def __init__(self, train_cfg: TrainConfig, total_steps: int):
        """`total_steps` counts optimizer updates, not micro-steps."""
        opt = train_cfg.optimizer
        self.max_grad_norm = float(train_cfg.max_grad_norm)
        self.k = max(1, int(train_cfg.gradient_accumulation_steps))
        self.warmup = max(1, int(total_steps * opt.warmup_ratio))
        self.decay_steps = max(total_steps, self.warmup + 1)
        self.peak = {"a": float(opt.learning_rate),
                     "b": float(opt.learning_rate) * float(opt.loraplus_lr_ratio)}
        self.weight_decay = float(opt.weight_decay)

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev),
                 "mu": tree_map(torch.zeros_like, params),
                 "nu": tree_map(torch.zeros_like, params)}
        if self.k > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int32, device=dev)
            state["acc"] = tree_map(torch.zeros_like, params)
        return state

    def learning_rate(self, count: torch.Tensor, group: str) -> torch.Tensor:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, 0)
        at `count`, in fp32: linear from 0 over the warmup, then a cosine to 0."""
        peak, W = self.peak[group], float(self.warmup)
        span = float(self.decay_steps - self.warmup)
        c = count.float()
        warm = (0.0 - peak) * (1 - c.clamp(0, W) / W) + peak
        c2 = torch.clamp(c - W, max=span)
        cosine = peak * (0.5 * (1 + torch.cos(math.pi * c2 / span)))
        return torch.where(c < W, warm, cosine)

    def _inner(self, grads, state, params):
        """clip -> AdamW per group -> (updates, new count, mu, nu)."""
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        grads = tree_map(lambda g: torch.where(keep, g, (g / norm) * self.max_grad_norm),
                         grads)
        count = state["count"]
        count_inc = count + 1
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1 - (one * B1) ** count_inc.float()
        bc2 = 1 - (one * B2) ** count_inc.float()
        lrs = {g: self.learning_rate(count, g) for g in self.peak}
        labels = loraplus_labels(params)
        mu, nu, upd = {}, {}, {}
        for name in params:
            mu[name], nu[name], upd[name] = {}, {}, {}
            for leaf, p in params[name].items():
                g = grads[name][leaf]
                m = (1 - B1) * g + B1 * state["mu"][name][leaf]
                v = (1 - B2) * (g * g) + B2 * state["nu"][name][leaf]
                u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
                u = u + self.weight_decay * p
                mu[name][leaf], nu[name][leaf] = m, v
                upd[name][leaf] = (-lrs[labels[name][leaf]]) * u
        return upd, count_inc, mu, nu

    def step(self, grads: Dict[str, Any], state: Dict[str, Any],
             params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        if self.k == 1:
            upd, count, mu, nu = self._inner(grads, state, params)
            return tree_map(torch.add, params, upd), {"count": count, "mu": mu, "nu": nu}
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
