"""LoRA fine-tuning entry point, on one device or data-parallel across
cards (counterpart of indextts_tpu/train/run.py).

    python -m indextts_tpu_torch.train.run --config CONFIG --model_dir DIR
    python -m torch.distributed.run --nproc_per_node N \
        -m indextts_tpu_torch.train.run --config CONFIG --model_dir DIR

Under the launcher each rank is one card (NCCL; gloo with `--device cpu`),
as each of JAX's controllers drives its own devices in its multi-process
branch: the micro-batch is a multiple of the world, the loaders are
sharded by rank, every rank pads its rows to its own widths (the step
agrees on the condition mels' width, which the conditioning encoder sees),
and the step reduces over the world (train/trainer.py).
Validation combines each rank's (sum, count) into one mean on every rank.
Only rank 0 writes TensorBoard, checkpoints, the `.pth` exports and
config_finetuned.yaml, and a barrier stands before anything that reads
them; `--resume` loads the same checkpoint on every rank.

The reference trainer's recipe (train.py:846-1025): epochs, micro-batches
of batch_size / gradient_accumulation_steps, per-epoch validation, early
stopping, max_steps_per_epoch, optional TensorBoard scalars
(loss/{text,mel,total}, accuracy/top{1,10,20}, train/grad_norm, val/loss),
and per epoch a resume checkpoint, a merged-LoRA weight directory and
reference-format `.pth` twins carrying the speakers' medoids
(train.py:769-844, 954-967).  The directories are the port's own format
(io/checkpoint.save_pytree); the engine serves either artifact.
"""

from __future__ import annotations

import argparse
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import Config
from indextts_tpu_torch.data.dataset import DataLoader, load_finetune_datasets
from indextts_tpu_torch.io import checkpoint, export, from_jax
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.parallel import mesh
from indextts_tpu_torch.train import lora as lora_lib
from indextts_tpu_torch.train import trainer
from indextts_tpu_torch.train.lora import tree_map

_SAVE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _mean_metrics(ms: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per-key means over a list of device metrics, fetched in one copy."""
    return {k: float(torch.stack([m[k].float() for m in ms]).mean().cpu()) for k in ms[0]}


def _step_seed(seed: int, step: int) -> int:
    # the step's CFG-dropout draw depends on the run's seed and the step
    # alone, as JAX's fold_in(key, step): a resumed run draws as a straight one
    return (seed + 1) * 1_000_003 + step


class Trainer:
    def __init__(self, cfg: Config, model_dir: str, run_name: Optional[str] = None,
                 device: str = "cuda"):
        """Takes a `Config` object (no YAML needed).  The frozen base is
        `model_dir`/`cfg.gpt_checkpoint` (random weights from a fixed seed if
        it is missing); the adapters start from PEFT's init on the train
        seed.  In a process group (parallel/mesh.py) rank 0's weights reach
        every rank."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: CUDA is not available; pass device='cpu' to "
                               "train on the CPU")
        self.device = mesh.initialize_distributed(device)
        self.group = mesh.data_group()
        self.rank, self.world, self.is_main = mesh.rank(), mesh.world(), mesh.is_main()
        self.cfg = cfg
        self.tc = cfg.train
        self.model_dir = model_dir
        run_name = run_name or os.environ.get("RUN_NAME") or time.strftime("%Y%m%d_%H%M%S")
        self.out_dir = os.path.join(self.tc.finetune_model_dir, run_name)
        log_dir = os.environ.get("RUN_LOG_DIR") or os.path.join(self.out_dir, "logs")
        os.makedirs(self.out_dir, exist_ok=True)
        self.writer = None
        try:   # TensorBoard is optional, as in the reference
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            if self.is_main:
                self.writer = SummaryWriter(log_dir)

        # the frozen base model
        gpt_path = os.path.join(model_dir, cfg.gpt_checkpoint)
        if os.path.exists(gpt_path):
            tree, _ = checkpoint.load_gpt_checkpoint(gpt_path, cfg.gpt)
            self.base_params = from_jax.gpt_params_from_numpy(tree, cfg.gpt, torch.float32,
                                                              self.device)
        else:
            warnings.warn(f"{gpt_path} missing: random base weights")
            self.base_params = uv.init_params(
                cfg.gpt, torch.Generator(device=self.device).manual_seed(0), torch.float32,
                self.device)
        # mixed precision (config.yaml:204): "auto" / "bf16" / "fp16" make the
        # base bf16; adapters and optimizer state stay fp32
        mp = str(self.tc.mixed_precision).lower()
        if mp == "fp16":
            warnings.warn("mixed_precision=fp16 trains a bf16 base, as the JAX package does")
        self.compute_dtype = torch.bfloat16 if mp in ("auto", "bf16", "fp16") else torch.float32
        self.base_params = tree_map(lambda x: x.to(self.compute_dtype), self.base_params)

        bpe = os.path.join(model_dir, cfg.dataset.bpe_model)
        self.train_ds, self.valid_ds = load_finetune_datasets(cfg, bpe)
        # gradient accumulation (config.yaml:213): the effective batch is
        # batch_size, reached as k micro-batches of batch_size / k, each a
        # multiple of the world; each rank loads its shard of every one
        self.accum_steps = max(1, int(self.tc.gradient_accumulation_steps))
        per_step_batch = max(self.tc.batch_size // self.accum_steps, self.world)
        per_step_batch -= per_step_batch % self.world
        shards = dict(num_shards=self.world, shard_index=self.rank)
        self.loader = DataLoader(
            self.train_ds, per_step_batch // self.world, seed=self.tc.seed,
            cross_speaker_ratio=self.tc.cross_speaker_ratio,
            text_length_weights=self.tc.text_length_weights, **shards)
        self.valid_loader = DataLoader(
            self.valid_ds, min(self.tc.valid_batch_size, max(1, len(self.valid_ds))),
            seed=self.tc.seed, shuffle=False, drop_last=False, **shards)

        self.steps_per_epoch = min(len(self.loader), self.tc.max_steps_per_epoch)
        # schedules tick per optimizer update, not per micro-step
        total_updates = max(1, self.steps_per_epoch * self.tc.epochs // self.accum_steps)
        self.optimizer = trainer.make_optimizer(self.tc, total_updates)
        self.state = trainer.init_train_state(
            torch.Generator(device=self.device).manual_seed(self.tc.seed), cfg.gpt,
            self.tc.lora, self.optimizer, self.device)
        self.base_params, self.state = mesh.broadcast_tree((self.base_params, self.state))
        self.start_epoch = 0
        self.best_val = float("inf")
        self.patience_left = self.tc.early_stopping_patience
        self._last_merged = None
        self._speaker_extras_cache = None

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, epoch: int, val_loss: float) -> None:
        """The resume directory, the merged directory, the .pth twins and
        config_finetuned.yaml, written by rank 0 while the others wait.
        best_val and patience_left are the running early-stop state, updated
        before this call."""
        if self.is_main:
            self._save_checkpoint(epoch, val_loss)
        mesh.barrier()

    def _save_checkpoint(self, epoch: int, val_loss: float) -> None:
        checkpoint.save_pytree(os.path.join(self.out_dir, f"checkpoint_epoch_{epoch}"), {
            "lora_params": self.state.lora_params,
            "opt_state": self.state.opt_state,
            "step": int(self.state.step),
            "epoch": epoch,
            "val_loss": val_loss,
            "best_val": float(self.best_val),
            "patience_left": int(self.patience_left),
        })
        merged = lora_lib.merge(self.base_params, self.state.lora_params, self.tc.lora,
                                _SAVE_DTYPES.get(self.tc.save_dtype, torch.float32))
        checkpoint.save_pytree(os.path.join(self.out_dir, f"model_epoch_{epoch}"), merged)
        self._last_merged = merged
        self._export_pth(f"gpt_epoch_{epoch + 1}.pth", merged)
        if val_loss <= self.best_val:
            self._export_pth("gpt_best.pth", merged)
        self.cfg.save(os.path.join(self.out_dir, "config_finetuned.yaml"))
        print(f"[ckpt] epoch {epoch} saved (val_loss={val_loss:.4f})")

    def _export_pth(self, name: str, merged) -> None:
        """The reference trainer's inference artifact ({'model': sd} with the
        speaker extras, train.py:795-844)."""
        dtype = self.tc.save_dtype if self.tc.save_dtype in ("fp16", "bf16", "fp32") else "fp16"
        export.save_gpt_pth(os.path.join(self.out_dir, name), merged, self.cfg.gpt,
                            extras=self._speaker_extras(), save_dtype=dtype)

    def _speaker_extras(self) -> Dict[str, Any]:
        """Each speaker's medoid condition and vocoder mel from the extraction
        output, as the reference's finetuned .pth carries them
        (utils/checkpoint.py:42-62)."""
        if self._speaker_extras_cache is None:
            self._speaker_extras_cache = export.speaker_extras(
                self.train_ds.data_path, sorted(self.train_ds.by_speaker))
        return self._speaker_extras_cache

    def try_resume(self) -> None:
        """Resume from the newest checkpoint_epoch_* (run_train.sh:100-123),
        the same one on every rank."""
        if not os.path.isdir(self.out_dir):
            return
        epochs = [int(n.rsplit("_", 1)[1]) for n in os.listdir(self.out_dir)
                  if n.startswith("checkpoint_epoch_") and n.rsplit("_", 1)[1].isdigit()]
        if not epochs:
            return
        latest = max(epochs)
        ckpt = checkpoint.load_pytree(
            os.path.join(self.out_dir, f"checkpoint_epoch_{latest}"), self.device)
        if _structure(ckpt["opt_state"]) != _structure(self.state.opt_state):
            raise ValueError(f"checkpoint_epoch_{latest}: its optimizer state does not fit "
                             "this config (gradient_accumulation_steps or LoRA targets "
                             "changed)")
        self.state = trainer.TrainState(
            ckpt["lora_params"], ckpt["opt_state"],
            torch.tensor(ckpt["step"], dtype=torch.int32, device=self.device))
        self.start_epoch = int(ckpt["epoch"]) + 1
        self.best_val = float(ckpt["best_val"])
        self.patience_left = int(ckpt["patience_left"])
        if self.is_main:
            print(f"[resume] from epoch {latest} (best_val={self.best_val:.4f})")

    # -- loops ------------------------------------------------------------

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> trainer.Batch:
        # clamp padded widths to the model's position-table limits
        text = batch["text_ids"][:, : self.cfg.gpt.max_text_tokens]
        codes = batch["mel_codes"][:, : self.cfg.gpt.max_mel_tokens]

        def dev(x, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device, dtype)

        return trainer.Batch(
            text_ids=dev(text), text_lengths=dev(np.minimum(batch["text_lengths"],
                                                            text.shape[1])),
            mel_codes=dev(codes), codes_lengths=dev(np.minimum(batch["codes_lengths"],
                                                               codes.shape[1])),
            cond_mel=dev(batch["cond_mel"], torch.float32),
            cond_lengths=dev(batch["cond_lengths"]))

    def validate(self) -> float:
        """Mean per-sample weighted CE over every validation sample; in a
        process group over every rank's shard (a rank holds whole rows, so no
        row is repeated to fill a device), the same mean on every rank."""
        losses: List[float] = []
        for batch in self.valid_loader:
            per_sample = trainer.eval_step_per_sample(
                self.state.lora_params, self.base_params, self._device_batch(batch),
                self.cfg.gpt, self.tc.lora, self.tc.text_weight, self.group)
            losses.extend(per_sample.cpu().tolist())
        total, count = mesh.all_reduce_host([np.sum(losses), len(losses)], "sum", self.group)
        return total / count if count else float("inf")

    def train(self) -> None:
        gen = torch.Generator(device=self.device)
        # a host-side step count: reading state.step would wait for the
        # step just queued
        host_step = int(self.state.step)
        for epoch in range(self.start_epoch, self.tc.epochs):
            self.loader.set_epoch(epoch)
            t_epoch = time.perf_counter()
            metrics_buf = []
            for step, batch in enumerate(self.loader):
                if step >= self.tc.max_steps_per_epoch:
                    break
                # the same seed on every rank: one CFG-dropout draw for all
                gen.manual_seed(_step_seed(self.tc.seed, host_step))
                self.state, metrics = trainer.train_step(
                    self.state, self.base_params, self._device_batch(batch), self.cfg.gpt,
                    self.tc.lora, self.optimizer, self.tc.text_weight,
                    self.tc.cfg_dropout_ratio, gen, group=self.group)
                host_step += 1
                metrics_buf.append(metrics)   # fetched at the TB points and epoch end
                if self.writer and step % 10 == 0:
                    m = {k: float(v.cpu()) for k, v in metrics.items()}
                    self.writer.add_scalar("loss/total", m["loss"], host_step)
                    self.writer.add_scalar("loss/text", m["loss_text"], host_step)
                    self.writer.add_scalar("loss/mel", m["loss_mel"], host_step)
                    self.writer.add_scalar("train/grad_norm", m["grad_norm"], host_step)
                    for k in ("acc_1", "acc_10", "acc_20"):
                        self.writer.add_scalar(f"accuracy/top{k[4:]}", m[k], host_step)
            if not metrics_buf:
                print("[warn] empty epoch: no training data")
                break
            mm = _mean_metrics(metrics_buf)
            val_loss = self.validate()
            dt = time.perf_counter() - t_epoch
            if self.is_main:
                print(f"[epoch {epoch}] loss={mm['loss']:.4f} mel={mm['loss_mel']:.4f} "
                      f"text={mm['loss_text']:.4f} acc1={mm['acc_1']:.1f}% "
                      f"val={val_loss:.4f} ({dt:.1f}s, {len(metrics_buf) / dt:.2f} steps/s)")
            if self.writer:
                self.writer.add_scalar("val/loss", val_loss, epoch)
            if val_loss < self.best_val:
                self.best_val = val_loss
                self.patience_left = self.tc.early_stopping_patience
            else:
                self.patience_left -= 1
            self.save_checkpoint(epoch, val_loss)
            if self.patience_left < 0:
                if self.is_main:
                    print(f"[early-stop] no val improvement (best {self.best_val:.4f})")
                break
        if self._last_merged is not None:   # the final inference artifact (train.py:967)
            self._export_pth("gpt_finetuned.pth", self._last_merged)
        mesh.barrier()
        self.close()

    def close(self) -> None:
        """Flush and close the TensorBoard writer.  Idempotent."""
        if self.writer is not None:
            try:
                self.writer.close()
            finally:
                self.writer = None


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return tuple(tree.shape)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="LoRA fine-tune, on one device or one rank of "
                                            "torch.distributed.run")
    p.add_argument("--config", default="finetune_models/config.yaml")
    p.add_argument("--model_dir", default="finetune_models")
    p.add_argument("--run_name", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("-d", "--device", default="cuda")
    args = p.parse_args(argv)
    cfg = Config.load(args.config) if os.path.exists(args.config) else Config()
    t = Trainer(cfg, args.model_dir, args.run_name, device=args.device)
    try:
        if args.resume:
            t.try_resume()
        t.train()
    finally:
        t.close()


if __name__ == "__main__":
    main()
    mesh.shutdown()
