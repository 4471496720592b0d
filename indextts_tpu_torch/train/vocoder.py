"""BigVGAN adversarial fine-tuning, on one device or data-parallel across
cards (counterpart of indextts_tpu/train/vocoder.py).

    python -m indextts_tpu_torch.train.vocoder --processed DIR --model_dir DIR
    python -m indextts_tpu_torch.train.vocoder --synthetic [--device cpu]
    python -m torch.distributed.run --nproc_per_node N -m indextts_tpu_torch.train.vocoder ...

The reference ships the discriminators and GAN losses
(indextts/BigVGAN/models.py:317-453) but no vocoder training script; this is
the loop the JAX package supplies for them (the HiFi-GAN/BigVGAN recipe):

  disc step:  L_D = sum (1 - D(y))^2 + D(y_hat)^2
  gen step:   L_G = sum (1 - D(y_hat))^2 + 2 sum |fmap_r - fmap_g|
              + lambda_mel * multiscale log-mel L1

The discriminator updates first, on the generator's output detached; the
generator then updates against the refreshed discriminator.  JAX runs the
generator's forward twice with the same parameters; this runs it once and
detaches it for the discriminator step (the same numbers).  Both optimizers
are optax's clip(1000) -> adamw(b1 0.8, b2 0.99, exponential decay), as
explicit state (train/optim.AdamW).  Every anti-aliased activation of the
generator runs K1 forward and K1b backward on the card
(ops/cuda/anti_alias.py).  Convolutions run in fp32 with TF32 off.

Under the launcher (parallel/mesh.py) the batch of `batch_size` rows runs
on n_use = gcd(batch_size, world) ranks, as JAX's run takes the largest
sub-mesh the batch tiles: each of them draws the global batch and keeps its
own rows; the ranks outside take no rows and join no gradient collective.
A step has two reductions: the discriminators' gradients are averaged
before their update, the generator's after its loss against the updated
discriminators.  K1 and K1b run on every working rank's own card.  Rank 0
writes the checkpoints.

Data: batches of (latent [B, Tc, gpt_dim], mel_ref [B, Tm, 100], wav
[B, 1, Tc * 1024]).  `latent_batches` builds them from an extraction output
directory (data/extract.py) and a GPT; `synthetic_batches` gives random
ones of the right shapes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.io import checkpoint as ckpt_io
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import bigvgan
from indextts_tpu_torch.models import discriminators as disc_lib
from indextts_tpu_torch.models.dvae import no_tf32
from indextts_tpu_torch.parallel import mesh
from indextts_tpu_torch.train.lora import tree_map
from indextts_tpu_torch.train.optim import AdamW, exponential_decay, tree_leaves


@dataclasses.dataclass(frozen=True)
class VocoderTrainConfig:
    batch_size: int = 8
    segment_codes: int = 24       # latent frames per sample (wav = x1024)
    steps: int = 1000
    lr: float = 1e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999       # per-step exponential (HiFi-GAN schedule)
    mel_weight: float = 45.0      # lambda_mel (HiFi-GAN/BigVGAN recipe)
    feature_weight: float = 1.0
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)         # MPD (models.py:317)
    resolutions: Tuple[Tuple[int, int, int], ...] = (   # MRD (config.yaml:118)
        (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
    mel_scales: Tuple[Tuple[int, int], ...] = (         # multiscale mel L1
        (512, 128), (1024, 256), (2048, 512))
    seed: int = 42
    log_every: int = 20
    checkpoint_every: int = 200


class VocoderTrainState(NamedTuple):
    gen_params: Dict[str, Any]
    disc_floats: list            # float leaves only (see split_static)
    gen_opt: Any
    disc_opt: Any
    step: torch.Tensor           # int32


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def split_static(tree) -> Tuple[list, Tuple[Any, list, list]]:
    """Separate the float leaves (trained) from the static ones: the
    discriminators' trees hold their structural ints (`period`,
    `resolution`), which neither the gradient nor the optimizer may see.
    Leaves in JAX's order (dict keys sorted, lists in order)."""
    flat = tree_leaves(tree)
    mask = [_is_float(x) for x in flat]
    floats = [x for x, m in zip(flat, mask) if m]
    consts = [None if m else x for x, m in zip(flat, mask)]
    return floats, (tree_map(lambda _: None, tree), mask, consts)


def _unflatten(skeleton, leaves: list):
    """The tree of `skeleton`'s structure over `leaves`, in tree_leaves'
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        return next(it)

    return build(skeleton)


def merge_static(floats: list, aux) -> Any:
    skeleton, mask, consts = aux
    it = iter(floats)
    return _unflatten(skeleton, [next(it) if m else c for m, c in zip(mask, consts)])


def make_optimizer(tc: VocoderTrainConfig) -> AdamW:
    """clip_by_global_norm(1000) -> adamw(exponential_decay(lr, 1, lr_decay),
    b1, b2, weight_decay=0), as JAX's chain."""
    return AdamW(exponential_decay(tc.lr, 1, tc.lr_decay), weight_decay=0.0,
                 max_grad_norm=1000.0, b1=tc.adam_b1, b2=tc.adam_b2)


def init_state(generator: torch.Generator, cfg: BigVGANConfig, optimizer: AdamW,
               gen_params: Any = None, periods=(2, 3, 5, 7, 11),
               resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)),
               device="cpu") -> Tuple[VocoderTrainState, Any]:
    """The generator from `gen_params` (a loaded bigvgan checkpoint: a numpy
    tree or torch tensors) or fresh from `generator`; the discriminators
    always fresh (the reference releases none).  Returns (state, disc_aux):
    the state carries only the discriminators' float leaves; `disc_aux`
    holds their structure and structural ints."""
    if gen_params is None:
        gen_params = bigvgan.init_params(cfg, generator, torch.float32, device)
    else:
        gen_params = from_jax.bigvgan_params_from_numpy(gen_params, cfg, torch.float32, device)
    d_floats, d_aux = split_static(disc_lib.init_discriminators(
        generator, periods, resolutions, torch.float32, device))
    return VocoderTrainState(gen_params, d_floats, optimizer.init(gen_params),
                             optimizer.init(d_floats),
                             torch.zeros((), dtype=torch.int32, device=device)), d_aux


class VocoderBatch(NamedTuple):
    latent: Any    # [B, Tc, gpt_dim]
    mel_ref: Any   # [B, Tm, n_mels] (time-major)
    wav: Any       # [B, 1, Tc * 1024]


def _grads(loss: torch.Tensor, leaves):
    """d loss / d leaves, zeros for a leaf the loss does not reach (as
    jax.grad gives)."""
    flat = tree_leaves(leaves)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return _unflatten(leaves, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, got)])


def train_step(state: VocoderTrainState, batch: VocoderBatch, d_aux, cfg: BigVGANConfig,
               optimizer: AdamW, tc: VocoderTrainConfig, group=None
               ) -> Tuple[VocoderTrainState, Dict[str, torch.Tensor]]:
    """One alternating GAN step: the discriminators update on the generator's
    output (detached), then the generator against the updated
    discriminators.  `batch` holds tensors on the state's device.  With a
    process `group` of equal shards each network's gradients are averaged
    over it with its loss terms, in one collective each, before its update."""
    with no_tf32(), torch.enable_grad():
        gen = tree_map(lambda p: p.detach().requires_grad_(True), state.gen_params)
        gen_wav = bigvgan.forward(gen, batch.latent, batch.mel_ref, cfg)
        T = min(gen_wav.shape[-1], batch.wav.shape[-1])
        gen_wav = gen_wav[..., :T]
        real = batch.wav[..., :T]

        # --- discriminator update (generator frozen) ---------------------
        d_leaves = [p.detach().requires_grad_(True) for p in state.disc_floats]
        dp = merge_static(d_leaves, d_aux)
        r_scores, _ = disc_lib.discriminators_forward(dp, real)
        g_scores, _ = disc_lib.discriminators_forward(dp, gen_wav.detach())
        ld = disc_lib.discriminator_loss(r_scores, g_scores)
        d_grads = _grads(ld, d_leaves)
        d_grads, ld = mesh.all_reduce_tree((d_grads, ld.detach()), "mean", group)
        with torch.no_grad():
            disc_floats, disc_opt = optimizer.step(d_grads, state.disc_opt,
                                                   [p.detach() for p in d_leaves])
        disc_params = merge_static(disc_floats, d_aux)

        # --- generator update (updated discriminators, frozen) ------------
        with torch.no_grad():
            _, r_fmaps = disc_lib.discriminators_forward(disc_params, real)
        g_scores, g_fmaps = disc_lib.discriminators_forward(disc_params, gen_wav)
        adv = disc_lib.generator_loss(g_scores)
        feat = disc_lib.feature_loss(r_fmaps, g_fmaps)
        mel = disc_lib.multiscale_mel_loss(real[:, 0], gen_wav[:, 0],
                                           sample_rate=cfg.sampling_rate, scales=tc.mel_scales)
        lg = adv + tc.feature_weight * feat + tc.mel_weight * mel
        g_grads = _grads(lg, gen)
        g_grads, parts = mesh.all_reduce_tree(
            (g_grads, torch.stack([lg, adv, feat, mel]).detach()), "mean", group)
        lg, adv, feat, mel = parts.unbind()
        with torch.no_grad():
            gen_params, gen_opt = optimizer.step(g_grads, state.gen_opt,
                                                 tree_map(torch.Tensor.detach, gen))
    metrics = {"disc_loss": ld.detach(), "gen_loss": lg.detach(), "gen_adv": adv.detach(),
               "gen_feat": feat.detach(), "gen_mel": mel.detach()}
    return VocoderTrainState(gen_params, disc_floats, gen_opt, disc_opt,
                             state.step + 1), metrics


# ---------------------------------------------------------------------------
# data: (latent, mel_ref, wav) batches from an extraction output directory
# ---------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def latent_batches(processed_dir: str, gpt_params, gpt_cfg, tokenizer,
                   tc: VocoderTrainConfig, mel_ref_frames: int = 256,
                   sample_rate: int = 24000) -> Iterator[VocoderBatch]:
    """Endless training batches (numpy) from data/extract.py's output.

    Per record: GPT latents from the teacher-forced re-forward over the
    extracted codes (unified_voice.latent_forward, the path inference
    vocodes from), conditioned on the speaker's medoid_condition.npy, at
    bucketed widths, computed once and cached on the host; the medoid
    clip's mel as the vocoder's speaker reference; the source audio at
    24 kHz, cached.  Batches are random `segment_codes`-wide crops with the
    aligned 1024-samples-per-code waveform window, drawn from
    np.random.default_rng(tc.seed) in the JAX package's order, so both give
    the same crops.  The GPT runs on its parameters' device."""
    from indextts_tpu_torch.data.extract import speaker_dirs
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.utils.audio import load_audio

    records, med_cond, med_mel = [], {}, {}
    for name, d in speaker_dirs(processed_dir):
        med_cond[name] = np.load(os.path.join(d, "medoid_condition.npy"))
        mm = np.load(os.path.join(d, "medoid_mel.npy"))   # [100, F]
        if mm.shape[1] < mel_ref_frames:
            mm = np.tile(mm, (1, -(-mel_ref_frames // mm.shape[1])))
        med_mel[name] = mm[:, :mel_ref_frames].T[None]    # [1, F, 100]
        mpath = os.path.join(d, "metadata_train.jsonl")
        if not os.path.isfile(mpath):
            continue
        with open(mpath) as f:
            for line in f:
                records.append((name, d, json.loads(line)))
    assert records, f"no training records under {processed_dir}"

    emb = gpt_params["text_embedding"]["weight"]
    dev, dtype = emb.device, emb.dtype
    latent_cache: Dict[int, np.ndarray] = {}

    def record_latent(idx: int) -> np.ndarray:
        if idx in latent_cache:
            return latent_cache[idx]
        name, d, rec = records[idx]
        codes = np.load(os.path.join(d, rec["codes"])).reshape(-1).astype(np.int64)
        ids = np.asarray(tokenizer.encode(rec["text"]), np.int64)
        Lt = min(_round_up(max(len(ids), 1), 16), gpt_cfg.max_text_tokens)
        Lc = min(_round_up(len(codes), 64), gpt_cfg.max_mel_tokens)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        with torch.no_grad():
            lat = uv.latent_forward(
                gpt_params, gpt_cfg, t(med_cond[name]).to(dtype),
                t(np.pad(ids[:Lt], (0, Lt - min(len(ids), Lt)))[None]),
                t(np.asarray([min(len(ids), Lt)])),
                t(np.pad(codes[:Lc], (0, Lc - min(len(codes), Lc)))[None]),
                t(np.asarray([min(len(codes), Lc)])))
        latent_cache[idx] = lat[0, :len(codes)].float().cpu().numpy()
        return latent_cache[idx]

    rng = np.random.default_rng(tc.seed)
    W = tc.segment_codes
    # mmap for the length scan: no codes array is decoded up front
    usable = [i for i, (_, d, rec) in enumerate(records)
              if np.load(os.path.join(d, rec["codes"]), mmap_mode="r").reshape(-1).shape[0] >= W]
    assert usable, f"no record has >= {W} codes"
    wav_cache: Dict[int, np.ndarray] = {}

    def record_wav(idx: int) -> np.ndarray:
        if idx not in wav_cache:
            _, d, rec = records[idx]
            wav_cache[idx] = load_audio(os.path.join(d, rec["audio"]), sample_rate).reshape(-1)
        return wav_cache[idx]

    while True:
        lats, mels, wavs = [], [], []
        while len(lats) < tc.batch_size:
            idx = usable[int(rng.integers(0, len(usable)))]
            name = records[idx][0]
            lat = record_latent(idx)
            wav = record_wav(idx)
            t0 = int(rng.integers(0, lat.shape[0] - W + 1))
            w = wav[t0 * 1024:(t0 + W) * 1024]
            if w.shape[0] < W * 1024:
                w = np.pad(w, (0, W * 1024 - w.shape[0]))
            lats.append(lat[t0:t0 + W])
            mels.append(med_mel[name][0])
            wavs.append(w[None])
        yield VocoderBatch(latent=np.stack(lats), mel_ref=np.stack(mels), wav=np.stack(wavs))


def synthetic_batches(cfg: BigVGANConfig, tc: VocoderTrainConfig,
                      mel_bins: int = 100) -> Iterator[VocoderBatch]:
    """Random batches (numpy) of the right shapes: the loop's smoke data."""
    rng = np.random.default_rng(tc.seed)
    upsample = int(np.prod(cfg.upsample_rates))
    while True:
        B, W = tc.batch_size, tc.segment_codes
        yield VocoderBatch(
            latent=rng.standard_normal((B, W, cfg.gpt_dim)).astype(np.float32),
            mel_ref=rng.standard_normal((B, 64, mel_bins)).astype(np.float32),
            wav=np.tanh(rng.standard_normal((B, 1, W * upsample))).astype(np.float32))


def to_device(batch: VocoderBatch, batch_size: int, device,
              rows: Optional[slice] = None) -> VocoderBatch:
    """A numpy batch on `device`, tiled (or cut) to `batch_size` rows, and
    of those only `rows` where given (a rank's share)."""
    def fit(x):
        x = np.asarray(x)
        if x.shape[0] != batch_size:
            reps = -(-batch_size // x.shape[0])
            x = np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:batch_size]
        if rows is not None:
            x = x[rows]
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    return VocoderBatch(*(fit(x) for x in batch))


def train_vocoder(cfg: BigVGANConfig, tc: VocoderTrainConfig, batches: Iterator[VocoderBatch],
                  out_dir: str, gen_params: Any = None, writer=None,
                  device="cuda") -> VocoderTrainState:
    """`tc.steps` steps from `gen_params` (a numpy tree, as
    `load_bigvgan_checkpoint` gives) or fresh weights (seed `tc.seed`);
    writes `vocoder_step_{n}` every `checkpoint_every` steps and at the end.
    In a process group `batches` yields the global batch on every rank and
    the first n_use = gcd(batch_size, world) ranks train on their shares
    from rank 0's initial state; a rank outside them returns that state at
    once (waiting for the others could outlast the group's timeout)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_vocoder: CUDA is not available; pass device='cpu' to train "
                           "on the CPU")
    device = mesh.initialize_distributed(device)
    world, rank = mesh.world(), mesh.rank()
    n_use = math.gcd(tc.batch_size, world)
    if n_use < world and mesh.is_main():
        # the batch does not tile the world: the largest group it tiles
        print(f"[vocoder] batch {tc.batch_size} on {n_use}/{world} ranks")
    group = mesh.subgroup(n_use)
    per_rank = tc.batch_size // n_use
    rows = slice(rank * per_rank, (rank + 1) * per_rank) if group is not None else None
    optimizer = make_optimizer(tc)
    state, d_aux = init_state(torch.Generator(device=device).manual_seed(tc.seed), cfg,
                              optimizer, gen_params, tc.periods, tc.resolutions,
                              device=device)
    state = mesh.broadcast_tree(state)
    if rank >= n_use:
        return state
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(tc.steps):
        state, metrics = train_step(state, to_device(next(batches), tc.batch_size, device, rows),
                                    d_aux, cfg, optimizer, tc, group)
        if (i + 1) % tc.log_every == 0 or i + 1 == tc.steps:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (i + 1) * tc.batch_size / (time.perf_counter() - t0)
            if mesh.is_main():
                print(f"[vocoder {i + 1}/{tc.steps}] D={m['disc_loss']:.3f} "
                      f"G={m['gen_loss']:.3f} mel={m['gen_mel']:.3f} "
                      f"({rate:.1f} samples/s)")
            if writer is not None:
                for k, v in m.items():
                    writer.add_scalar(f"vocoder/{k}", v, i + 1)
        if tc.checkpoint_every and (i + 1) % tc.checkpoint_every == 0:
            _save(state, d_aux, out_dir, i + 1)
    if not (tc.checkpoint_every and tc.steps % tc.checkpoint_every == 0):
        _save(state, d_aux, out_dir, tc.steps)
    mesh.barrier(group)
    return state


def _save(state: VocoderTrainState, d_aux, out_dir: str, step: int) -> None:
    if not mesh.is_main():
        return
    path = os.path.join(out_dir, f"vocoder_step_{step}")
    ckpt_io.save_pytree(path, {"gen_params": state.gen_params,
                               "disc_params": merge_static(state.disc_floats, d_aux),
                               "step": step})
    print(f"[vocoder ckpt] step {step} -> {path}")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Adversarial BigVGAN fine-tune")
    ap.add_argument("--processed", default=None,
                    help="extraction output directory (speaker_info.json)")
    ap.add_argument("--model_dir", default="checkpoints",
                    help="directory with config.yaml, the gpt and bigvgan checkpoints, bpe")
    ap.add_argument("--out", default="finetune_models/vocoder")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-codes", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--synthetic", action="store_true",
                    help="random batches of the right shapes (no dataset)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from indextts_tpu_torch.config import Config

    device = mesh.initialize_distributed(args.device)
    cfg_path = os.path.join(args.model_dir, "config.yaml")
    full_cfg = Config.load(cfg_path) if os.path.exists(cfg_path) else Config()
    cfg = full_cfg.bigvgan
    tc = VocoderTrainConfig(batch_size=args.batch, segment_codes=args.segment_codes,
                            steps=args.steps, lr=args.lr, seed=args.seed)
    if args.synthetic:
        train_vocoder(cfg, tc, synthetic_batches(cfg, tc), args.out, device=device)
        return
    if not args.processed:
        raise SystemExit("--processed (extraction output directory) or --synthetic "
                         "is required")
    gen_params = None
    bv_path = os.path.join(args.model_dir, full_cfg.bigvgan_checkpoint)
    if os.path.exists(bv_path):
        gen_params = ckpt_io.load_bigvgan_checkpoint(bv_path, cfg)

    from indextts_tpu_torch.utils.tokenizer import TextTokenizer

    tree, _ = ckpt_io.load_gpt_checkpoint(os.path.join(args.model_dir, full_cfg.gpt_checkpoint),
                                          full_cfg.gpt)
    gpt_params = from_jax.gpt_params_from_numpy(tree, full_cfg.gpt, torch.float32, device)
    tok = TextTokenizer(os.path.join(args.model_dir, full_cfg.dataset.bpe_model))
    batches = latent_batches(args.processed, gpt_params, full_cfg.gpt, tok, tc)
    train_vocoder(cfg, tc, batches, args.out, gen_params, device=device)


if __name__ == "__main__":
    main()
    mesh.shutdown()
