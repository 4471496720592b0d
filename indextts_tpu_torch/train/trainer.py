"""LoRA fine-tune step (counterpart of indextts_tpu/train/trainer.py), on one
device.

The reference recipe (train.py:373-978): frozen conditioning encoder,
LoRA-only gradients, weighted dual CE (text_weight * text + (1 -
text_weight) * mel, train.py:897), LoRA+ two-group AdamW with a warmup-cosine
schedule and gradient clipping (`train/optim.py`), bf16 compute with fp32
adapters and optimizer state, CFG conditioning dropout (train.py:228-231),
a non-finite loss skipping the step (train.py:899-902), and top-1/10/20 mel
accuracy.  A step keeps its metrics on the device and has no host sync.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from indextts_tpu_torch.config import GPTConfig, LoRAConfig, TrainConfig
from indextts_tpu_torch.models import unified_voice as uv
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
            generator: Optional[torch.Generator] = None, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted dual-CE loss with frozen conditioning (train.py:168-346,897).
    CFG dropout zeroes the whole batch's conditioning on one Bernoulli draw
    from `generator`."""
    params = lora_lib.materialize(base_params, lora_params, lora_cfg)
    with torch.no_grad():
        cond_latent = uv.get_conditioning(base_params, cfg, batch.cond_mel, batch.cond_lengths)
    if cfg_dropout_ratio > 0.0:
        drop = torch.rand((), generator=generator, device=cond_latent.device) < cfg_dropout_ratio
        cond_latent = torch.where(drop, torch.zeros_like(cond_latent), cond_latent)
    # remat: backward recomputes each block (the reference's gradient
    # checkpointing option, gpt/model.py:277-278)
    out = uv.train_forward(params, cfg, cond_latent, batch.text_ids, batch.text_lengths,
                           batch.mel_codes, batch.codes_lengths, remat=remat)
    loss = text_weight * out["loss_text"] + (1.0 - text_weight) * out["loss_mel"]
    with torch.no_grad():
        acc = uv.top_k_accuracy(out["mel_logits"], out["mel_targets"], out["mel_mask"])
    metrics = {"loss": loss.detach(), "loss_text": out["loss_text"].detach(),
               "loss_mel": out["loss_mel"].detach(), **acc}
    return loss, metrics


def loss_and_grads(state: TrainState, base_params, batch: Batch, cfg: GPTConfig,
                   lora_cfg: LoRAConfig, text_weight: float = 0.1,
                   cfg_dropout_ratio: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """(loss, metrics, grads) of `loss_fn` in the adapters."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), state.lora_params)
    loss, metrics = loss_fn(leaves, base_params, batch, cfg, lora_cfg, text_weight,
                            cfg_dropout_ratio, generator)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda x: x.grad, leaves)


def train_step(state: TrainState, base_params, batch: Batch, cfg: GPTConfig,
               lora_cfg: LoRAConfig, optimizer: LoRAPlusAdamW, text_weight: float = 0.1,
               cfg_dropout_ratio: float = 0.0, generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step.  A non-finite loss is a true skip: adapters,
    optimizer state and step all stay as they were (zeroed gradients alone
    would still move the adapters through Adam's momentum and weight decay
    and advance the schedule).  The choice is made on the device."""
    loss, metrics, grads = loss_and_grads(state, base_params, batch, cfg, lora_cfg,
                                          text_weight, cfg_dropout_ratio, generator)
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
                         lora_cfg: LoRAConfig, text_weight: float = 0.1) -> torch.Tensor:
    """Per-sample weighted dual CE [B], so validation can drop padding rows
    exactly (the reference's drop_last=True, train_ddp.py:297-309)."""
    params = lora_lib.materialize(base_params, lora_params, lora_cfg)
    cond_latent = uv.get_conditioning(base_params, cfg, batch.cond_mel, batch.cond_lengths)
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
