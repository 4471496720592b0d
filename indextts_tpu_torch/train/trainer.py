"""LoRA fine-tune step (counterpart of indextts_tpu/train/trainer.py), on one
device or data-parallel over a process group (parallel/mesh.py).

The reference recipe (train.py:373-978): frozen conditioning encoder,
LoRA-only gradients, weighted dual CE (text_weight * text + (1 -
text_weight) * mel, train.py:897), LoRA+ two-group AdamW with a warmup-cosine
schedule and gradient clipping (`train/optim.py`), bf16 compute with fp32
adapters and optimizer state, CFG conditioning dropout (train.py:228-231),
a non-finite loss skipping the step (train.py:899-902), and top-1/10/20 mel
accuracy.  A step keeps its metrics on the device and has no host sync.

Over a process group each rank holds its own rows, padded to its own
widths, and the step computes what JAX's step computes over its data mesh:
the global batch's loss and gradient.  The trunk masks the text and code
pads; the condition mels are padded to the group's widest first
(`group_cond_mel`), since the conditioning encoder's subsampling sees the
pad width.  `_masked_ce`
divides by the token count of the batch it sees, so averaging per-rank
gradients (as DDP does) would be wrong whenever ranks hold different
numbers of text or mel tokens.  Instead the ranks first sum their text and
mel token counts; each rank divides its masked sums by the global counts,
and the gradients and metrics (each rank's share) are summed in one
collective.  Every rank then holds the same gradient, takes the same skip
decision and the same update.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from indextts_tpu_torch.config import GPTConfig, LoRAConfig, TrainConfig
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.parallel import mesh
from indextts_tpu_torch.train import lora as lora_lib
from indextts_tpu_torch.train.lora import tree_map
from indextts_tpu_torch.train.optim import LoRAPlusAdamW, global_norm


class Batch(NamedTuple):
    """Device batch (collate_finetune_fn contract, data_utils.py:752-791)."""

    text_ids: torch.Tensor        # [B, Tt] int64, right-padded
    text_lengths: torch.Tensor    # [B]
    mel_codes: torch.Tensor       # [B, Tm] int64, right-padded
    codes_lengths: torch.Tensor   # [B]
    cond_mel: torch.Tensor        # [B, n_mels, Tc] fp32
    cond_lengths: torch.Tensor    # [B]


class TrainState(NamedTuple):
    lora_params: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: torch.Tensor            # int32 micro-steps taken (skips excluded)


def make_optimizer(train_cfg: TrainConfig, total_steps: int) -> LoRAPlusAdamW:
    """LoRA+ AdamW with cosine warmup; `total_steps` counts optimizer
    updates.  With gradient_accumulation_steps k > 1 each call takes one
    micro-batch and every k-th applies the mean update."""
    return LoRAPlusAdamW(train_cfg, total_steps)


def loss_fn(lora_params, base_params, batch: Batch, cfg: GPTConfig, lora_cfg: LoRAConfig,
            text_weight: float, cfg_dropout_ratio: float = 0.0,
            generator: Optional[torch.Generator] = None, remat: bool = True, group=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted dual-CE loss with frozen conditioning (train.py:168-346,897).
    CFG dropout zeroes the whole batch's conditioning on one Bernoulli draw
    from `generator`.  With a process `group` the loss and every metric are
    this rank's share of the group's: its masked sums over the group's token
    counts (one collective of the counts), so that the shares sum to the
    global batch's values."""
    params = lora_lib.materialize(base_params, lora_params, lora_cfg)
    with torch.no_grad():
        cond_latent = uv.get_conditioning(base_params, cfg, group_cond_mel(batch, group),
                                          batch.cond_lengths)
    if cfg_dropout_ratio > 0.0:
        drop = torch.rand((), generator=generator, device=cond_latent.device) < cfg_dropout_ratio
        cond_latent = torch.where(drop, torch.zeros_like(cond_latent), cond_latent)
    # remat: backward recomputes each block (the reference's gradient
    # checkpointing option, gpt/model.py:277-278)
    out = uv.train_forward(params, cfg, cond_latent, batch.text_ids, batch.text_lengths,
                           batch.mel_codes, batch.codes_lengths, remat=remat)
    loss_text, loss_mel = out["loss_text"], out["loss_mel"]
    with torch.no_grad():
        acc = uv.top_k_accuracy(out["mel_logits"], out["mel_targets"], out["mel_mask"])
    if group is not None:
        # each CE is this rank's masked sum over its own count (at least 1):
        # rescale it to the group's count; the accuracies are mel-weighted
        local = torch.stack([out["text_mask"].sum(), out["mel_mask"].sum()]).float()
        share = local.clamp(min=1) / mesh.all_reduce_tree(local, group=group).clamp(min=1)
        loss_text, loss_mel = loss_text * share[0], loss_mel * share[1]
        acc = {k: v * share[1] for k, v in acc.items()}
    loss = text_weight * loss_text + (1.0 - text_weight) * loss_mel
    metrics = {"loss": loss.detach(), "loss_text": loss_text.detach(),
               "loss_mel": loss_mel.detach(), **acc}
    return loss, metrics


def group_cond_mel(batch: Batch, group=None) -> torch.Tensor:
    """The batch's condition mels, zero-padded in time to the widest of the
    group's ranks.  The conditioning encoder's subsampling sees the pad
    width (its frame mask is cut from the padded one, as in the reference),
    so a row's latents depend on it: one width for the group makes every
    row's what it is in the global batch.  Text and codes need no such
    agreement: the trunk masks their pads."""
    cond = batch.cond_mel
    if group is None:
        return cond
    (width,) = mesh.all_reduce_host([cond.shape[-1]], "max", group)
    return torch.nn.functional.pad(cond, (0, int(width) - cond.shape[-1]))


def loss_and_grads(state: TrainState, base_params, batch: Batch, cfg: GPTConfig,
                   lora_cfg: LoRAConfig, text_weight: float = 0.1,
                   cfg_dropout_ratio: float = 0.0,
                   generator: Optional[torch.Generator] = None, group=None):
    """(loss, metrics, grads) of `loss_fn` in the adapters; with a process
    `group`, the group's global batch's, the same on every rank: the ranks'
    shares and gradients summed in one collective."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), state.lora_params)
    loss, metrics = loss_fn(leaves, base_params, batch, cfg, lora_cfg, text_weight,
                            cfg_dropout_ratio, generator, group=group)
    loss.backward()
    grads = tree_map(lambda x: x.grad, leaves)
    if group is not None:
        metrics, grads = mesh.all_reduce_tree((metrics, grads), group=group)
        return metrics["loss"], metrics, grads
    return loss.detach(), metrics, grads


def train_step(state: TrainState, base_params, batch: Batch, cfg: GPTConfig,
               lora_cfg: LoRAConfig, optimizer: LoRAPlusAdamW, text_weight: float = 0.1,
               cfg_dropout_ratio: float = 0.0, generator: Optional[torch.Generator] = None,
               group=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step.  A non-finite loss is a true skip: adapters,
    optimizer state and step all stay as they were (zeroed gradients alone
    would still move the adapters through Adam's momentum and weight decay
    and advance the schedule).  The choice is made on the device.  With a
    process `group` the step is the group's global batch's (the module's
    docstring): the skip is one decision for every rank, and the norm and
    the clip see the reduced gradients.  Every rank's `generator` must be
    seeded alike, so that the CFG-dropout draw is the same on each."""
    loss, metrics, grads = loss_and_grads(state, base_params, batch, cfg, lora_cfg,
                                          text_weight, cfg_dropout_ratio, generator, group)
    with torch.no_grad():
        finite = torch.isfinite(loss)
        grads = tree_map(lambda g: torch.where(finite, g, 0.0), grads)
        lora_params, opt_state = optimizer.step(grads, state.opt_state, state.lora_params)
        keep = lambda new, old: torch.where(finite, new, old)  # noqa: E731
        new_state = TrainState(tree_map(keep, lora_params, state.lora_params),
                               tree_map(keep, opt_state, state.opt_state),
                               torch.where(finite, state.step + 1, state.step))
        metrics["grad_norm"] = global_norm(grads)
        metrics["skipped"] = (~finite).float()
    return new_state, metrics


@torch.no_grad()
def eval_step(lora_params, base_params, batch: Batch, cfg: GPTConfig, lora_cfg: LoRAConfig,
              text_weight: float = 0.1) -> Dict[str, torch.Tensor]:
    _, metrics = loss_fn(lora_params, base_params, batch, cfg, lora_cfg, text_weight,
                         remat=False)
    return metrics


def _per_row_ce(logits, targets, mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = mask.float()
    return (nll * m).sum(dim=-1) / m.sum(dim=-1).clamp(min=1)


@torch.no_grad()
def eval_step_per_sample(lora_params, base_params, batch: Batch, cfg: GPTConfig,
                         lora_cfg: LoRAConfig, text_weight: float = 0.1,
                         group=None) -> torch.Tensor:
    """Per-sample weighted dual CE [B], so validation can drop padding rows
    exactly (the reference's drop_last=True, train_ddp.py:297-309).  With a
    process `group` the condition mels take the group's width
    (`group_cond_mel`); nothing else is reduced."""
    params = lora_lib.materialize(base_params, lora_params, lora_cfg)
    cond_latent = uv.get_conditioning(base_params, cfg, group_cond_mel(batch, group),
                                      batch.cond_lengths)
    out = uv.train_forward(params, cfg, cond_latent, batch.text_ids, batch.text_lengths,
                           batch.mel_codes, batch.codes_lengths)
    lt = _per_row_ce(out["text_logits"], out["text_targets"], out["text_mask"])
    lm = _per_row_ce(out["mel_logits"], out["mel_targets"], out["mel_mask"])
    return text_weight * lt + (1.0 - text_weight) * lm


def init_train_state(generator: torch.Generator, cfg: GPTConfig, lora_cfg: LoRAConfig,
                     optimizer: LoRAPlusAdamW, device="cpu") -> TrainState:
    """Fresh adapters from `generator`, their optimizer state and step 0."""
    lora_params = lora_lib.init_lora_params(generator, cfg, lora_cfg, device)
    return TrainState(lora_params, optimizer.init(lora_params),
                      torch.zeros((), dtype=torch.int32, device=device))
