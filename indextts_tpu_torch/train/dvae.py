"""DVAE (mel VQ-VAE) training, on one device or data-parallel across cards
(counterpart of indextts_tpu/train/dvae.py).

    python -m indextts_tpu_torch.train.dvae --mels DIR [--init dvae.pth] [--device cpu]
    python -m torch.distributed.run --nproc_per_node N -m indextts_tpu_torch.train.dvae ...

The reference ships the DiscreteVAE's training pieces (the EMA quantiser,
dead-code rebalancing, DiscretizationLoss; xtts_dvae.py:54-174,364-386) but
no training script; this is the loop the JAX package supplies for them:

  * `train_step`: gradients on the encoder and decoder (AdamW after a
    global-norm clip, train/optim.AdamW), the codebook moved only by the EMA
    of the batch's statistics, a usage histogram kept on the device;
  * dead- and dominant-code rebalancing every `rebalance_every` steps as a
    `torch.where` on the device: a step has no host sync;
  * training samples are random fixed-width mel windows, drawn in numpy
    exactly as the JAX package draws them.

Under the launcher (parallel/mesh.py) every rank draws the global batch of
windows from `tc.seed` and keeps its own rows, which is what JAX's one-host
run over N devices computes; the shards are equal, so averaged gradients
and per-element means are the global batch's.  The EMA's statistics, the
usage histogram and the perplexity's counts are summed over the ranks, and
every rank takes the same rebalance draw (its generator seeded alike).
Rank 0 writes the checkpoints.

The step runs with TF32 off.  The rebalance's normal draw comes from the
caller's generator (JAX's from fold_in(rng, 1)); tests pass JAX's draw as
`noise`.  Data: extracted ``*.npy`` mels ([100, T] or [T, 100]), globbed or
found through an extraction directory's speaker_info.json
(data/extract.py).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import VQVAEConfig
from indextts_tpu_torch.io import checkpoint as ckpt_io
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import dvae
from indextts_tpu_torch.parallel import mesh
from indextts_tpu_torch.train.lora import tree_map
from indextts_tpu_torch.train.optim import AdamW


@dataclasses.dataclass(frozen=True)
class DVAETrainConfig:
    batch_size: int = 32
    mel_width: int = 256          # random-crop window (frames, multiple of 4)
    steps: int = 2000
    lr: float = 3e-4
    warmup_steps: int = 100
    commitment_weight: float = 0.25
    discretization_weight: float = 0.0   # DiscretizationLoss, off by default
    ema_decay: float = 0.99
    rebalance_every: int = 0      # 0 = off (the reference's default)
    rebalance_hi: float = 0.9
    rebalance_lo: float = 0.01
    seed: int = 42
    log_every: int = 50
    checkpoint_every: int = 500


class DVAETrainState(NamedTuple):
    params: Dict[str, Any]
    opt_state: Any
    usage: torch.Tensor           # [n_embed] fp32 code counts since the last rebalance
    step: torch.Tensor            # int32


def make_optimizer(tc: DVAETrainConfig) -> AdamW:
    """clip_by_global_norm(1.0) -> adamw(warmup_cosine(0, lr, warmup,
    max(steps, warmup + 1)), weight_decay=0.01), as JAX's chain."""
    return AdamW(tc.lr, tc.warmup_steps, max(tc.steps, tc.warmup_steps + 1),
                 weight_decay=0.01, max_grad_norm=1.0)


def init_state(cfg: VQVAEConfig, optimizer: AdamW,
               generator: Optional[torch.Generator] = None, params: Any = None,
               device="cpu") -> DVAETrainState:
    """A fresh state: `params` (a numpy tree, e.g. the JAX package's, or
    torch tensors) or random weights from `generator`."""
    if params is None:
        params = dvae.init_params(cfg, generator, torch.float32, device)
    else:
        params = from_jax.dvae_params_from_numpy(params, cfg, torch.float32, device)
    grads_like = {k: v for k, v in params.items() if k != "codebook"}
    return DVAETrainState(params, optimizer.init(grads_like),
                          torch.zeros(cfg.num_tokens, dtype=torch.float32, device=device),
                          torch.zeros((), dtype=torch.int32, device=device))


def _loss(grad_params: Dict[str, Any], codebook: Dict[str, Any], mel: torch.Tensor,
          cfg: VQVAEConfig, tc: DVAETrainConfig):
    out = dvae.forward_loss({**grad_params, "codebook": codebook}, mel, cfg)
    loss = out["recon_loss"] + tc.commitment_weight * out["commitment_loss"]
    if tc.discretization_weight > 0.0:
        onehot = torch.nn.functional.one_hot(out["codes"].long(), cfg.num_tokens).float()
        loss = loss + tc.discretization_weight * dvae.discretization_loss(
            onehot, dim=onehot.ndim - 1, expected_variance=1.0 / cfg.num_tokens)
    return loss, out


def train_step(state: DVAETrainState, mel: torch.Tensor, cfg: VQVAEConfig, optimizer: AdamW,
               tc: DVAETrainConfig, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, group=None
               ) -> Tuple[DVAETrainState, Dict[str, torch.Tensor]]:
    """One step: gradients on the encoder and decoder, the EMA on the
    codebook, the usage histogram, and every `rebalance_every` steps the
    rebalance, chosen on the device.  With rebalancing on, each step takes
    a normal draw [D, N]: `noise` if given, else from `generator`.

    With a process `group` of equal shards the step is the global batch's:
    the gradients and the loss terms averaged and the code counts summed
    (one collective), the EMA's statistics summed (a second), the
    discretization term of the loss from the summed counts."""
    grad_params = {k: v for k, v in state.params.items() if k != "codebook"}
    codebook = state.params["codebook"]
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), grad_params)
    with dvae.no_tf32():
        with torch.enable_grad():
            loss, out = _loss(leaves, codebook, mel, cfg, tc)
            loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        with torch.no_grad():
            codes = out["codes"]
            counts = torch.bincount(codes.reshape(-1).long(), minlength=cfg.num_tokens).float()
            terms = torch.stack([out["recon_loss"].detach(), out["commitment_loss"].detach()])
            if group is not None:
                n = torch.distributed.get_world_size(group)
                grads, terms, counts = mesh.all_reduce_tree((grads, terms, counts), group=group)
                grads = tree_map(lambda g: g / n, grads)
                terms = terms / n
                loss = terms[0] + tc.commitment_weight * terms[1]
                if tc.discretization_weight > 0.0:
                    loss = loss + tc.discretization_weight * dvae.discretization_loss(
                        counts[None], dim=1, expected_variance=1.0 / cfg.num_tokens)
            new_params, opt_state = optimizer.step(grads, state.opt_state,
                                                   tree_map(torch.Tensor.detach, leaves))
            codebook = dvae.ema_update(codebook, out["z"].detach(), codes, decay=tc.ema_decay,
                                       group=group)
            usage = state.usage + counts
            step = state.step + 1
            n_reset = torch.zeros((), dtype=torch.int32, device=usage.device)
            if tc.rebalance_every > 0:
                fire = (step % tc.rebalance_every) == 0
                frac = usage / torch.clamp(usage.sum(), min=1.0)
                cb2, n = dvae.rebalance_codes(codebook, frac, tc.rebalance_hi, tc.rebalance_lo,
                                              noise=noise, generator=generator)
                codebook = {k: torch.where(fire, cb2[k], codebook[k]) for k in codebook}
                usage = torch.where(fire, torch.zeros_like(usage), usage)
                n_reset = torch.where(fire, n, n_reset)
            probs = counts / torch.clamp(counts.sum(), min=1.0)
            plogp = torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs))
            metrics = {"loss": loss.detach(), "recon_loss": terms[0],
                       "commitment_loss": terms[1],
                       "codebook_perplexity": torch.exp(-plogp.sum()),
                       "codes_reset": n_reset.float()}
    return DVAETrainState({**new_params, "codebook": codebook}, opt_state, usage, step), metrics


# ---------------------------------------------------------------------------
# data: random fixed-width windows over extracted mel .npy files
# ---------------------------------------------------------------------------

def discover_mels(source: str) -> List[str]:
    """`source` may be a glob, a directory of .npy files, or an extraction
    output directory holding speaker_info.json (data/extract.py)."""
    if os.path.isfile(os.path.join(source, "speaker_info.json")):
        from indextts_tpu_torch.data.extract import speaker_dirs

        paths: List[str] = []
        for _, d in speaker_dirs(source):
            for split in ("metadata_train.jsonl", "metadata_valid.jsonl"):
                mpath = os.path.join(d, split)
                if not os.path.isfile(mpath):
                    continue
                with open(mpath) as f:
                    for line in f:
                        paths.append(os.path.join(d, json.loads(line)["mels"]))
        return sorted(set(paths))
    if os.path.isdir(source):
        return sorted(globlib.glob(os.path.join(source, "**", "*.npy"), recursive=True))
    return sorted(globlib.glob(source))


def mel_window_batches(paths: List[str], batch: int, width: int, seed: int,
                       keep: Optional[slice] = None) -> Iterator[np.ndarray]:
    """Endless [batch, 100, width] fp32 crops; short clips are tiled.  With
    `keep` (a slice of rows) each batch is drawn whole, as without it, and
    only those rows are read and returned: a rank's share of the global
    batch (the other rows' files are mapped for their shapes alone)."""
    rng = np.random.default_rng(seed)
    assert paths, "no mel files found"
    kept = range(batch)[keep] if keep is not None else range(batch)
    while True:
        rows = []
        for j, i in enumerate(rng.integers(0, len(paths), size=batch)):
            m = np.load(paths[int(i)], mmap_mode=None if j in kept else "r")
            if m.ndim != 2:
                m = m.reshape(m.shape[-2], m.shape[-1])
            if m.shape[0] != 100 and m.shape[1] == 100:
                m = m.T
            T = m.shape[1]
            if T < width:
                T *= -(-width // T)
                if j in kept:
                    m = np.tile(m, (1, T // m.shape[1]))
            t0 = int(rng.integers(0, T - width + 1))
            if j in kept:
                rows.append(m[:, t0:t0 + width])
        yield np.stack(rows).astype(np.float32)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def train_dvae(cfg: VQVAEConfig, tc: DVAETrainConfig, mel_paths: List[str], out_dir: str,
               writer=None, device="cuda", params: Any = None) -> DVAETrainState:
    """`tc.steps` steps of `tc.batch_size` windows from random weights (seed
    `tc.seed`) or from `params` (a numpy tree, as `load_dvae_checkpoint`
    gives); writes `dvae_step_{n}` every `checkpoint_every` steps and at the
    end.  In a process group the global batch is max(batch_size // world,
    1) x world windows (JAX's on a mesh of that many devices), rank r
    training on its r-th share, and rank 0's initial state reaches every
    rank."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_dvae: CUDA is not available; pass device='cpu' to train "
                           "on the CPU")
    device = mesh.initialize_distributed(device)
    group, world, rank = mesh.data_group(), mesh.world(), mesh.rank()
    per_rank = max(tc.batch_size // world, 1) if group is not None else tc.batch_size
    optimizer = make_optimizer(tc)
    state = mesh.broadcast_tree(init_state(
        cfg, optimizer, torch.Generator(device=device).manual_seed(tc.seed), params, device))
    generator = torch.Generator(device=device).manual_seed(tc.seed + 1)
    keep = slice(rank * per_rank, (rank + 1) * per_rank) if group is not None else None
    batches = mel_window_batches(mel_paths, per_rank * world, tc.mel_width, tc.seed, keep)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(tc.steps):
        mel = torch.from_numpy(next(batches)).to(device, non_blocking=True)
        state, metrics = train_step(state, mel, cfg, optimizer, tc, generator, group=group)
        if (i + 1) % tc.log_every == 0 or i + 1 == tc.steps:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (i + 1) * per_rank * world / (time.perf_counter() - t0)
            if mesh.is_main():
                print(f"[dvae {i + 1}/{tc.steps}] loss={m['loss']:.4f} "
                      f"recon={m['recon_loss']:.4f} ppl={m['codebook_perplexity']:.1f} "
                      f"({rate:.1f} windows/s)")
            if writer is not None:
                for k, v in m.items():
                    writer.add_scalar(f"dvae/{k}", v, i + 1)
        if tc.checkpoint_every and (i + 1) % tc.checkpoint_every == 0:
            _save(state, out_dir, i + 1)
    if not (tc.checkpoint_every and tc.steps % tc.checkpoint_every == 0):
        _save(state, out_dir, tc.steps)
    mesh.barrier()
    return state


def _save(state: DVAETrainState, out_dir: str, step: int) -> None:
    if not mesh.is_main():
        return
    path = os.path.join(out_dir, f"dvae_step_{step}")
    ckpt_io.save_pytree(path, {"params": state.params, "step": step})
    print(f"[dvae ckpt] step {step} -> {path}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Train the DVAE mel tokenizer")
    ap.add_argument("--mels", required=True,
                    help="mel .npy glob, directory, or extraction output directory")
    ap.add_argument("--out", default="finetune_models/dvae")
    ap.add_argument("--model_dir", default=None,
                    help="directory with config.yaml (its vqvae section); the default "
                         "config otherwise")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--discretization-weight", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--init", default=None,
                    help="a dvae.pth to fine-tune; random weights from --seed otherwise")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    tc = DVAETrainConfig(batch_size=args.batch, mel_width=args.width, steps=args.steps,
                         lr=args.lr, rebalance_every=args.rebalance_every,
                         discretization_weight=args.discretization_weight, seed=args.seed)
    cfg = VQVAEConfig()
    if args.model_dir:
        from indextts_tpu_torch.config import Config

        cfg_path = os.path.join(args.model_dir, "config.yaml")
        if os.path.exists(cfg_path):
            cfg = Config.load(cfg_path).vqvae
    device = mesh.initialize_distributed(args.device)
    paths = discover_mels(args.mels)
    if mesh.is_main():
        print(f"[dvae] {len(paths)} mel files")
    params = ckpt_io.load_dvae_checkpoint(args.init, cfg) if args.init else None
    train_dvae(cfg, tc, paths, args.out, device=device, params=params)


if __name__ == "__main__":
    main()
    mesh.shutdown()
