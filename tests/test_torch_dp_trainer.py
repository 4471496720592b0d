"""PyTorch port, the LoRA `Trainer` data-parallel over 2 gloo ranks
(train/run.py with parallel/mesh.py): sharded loaders, the global step,
artifacts written by rank 0 alone, `--resume` on every rank, validation as
one mean over every rank's shard, held against the JAX package's `Trainer`
over its 8 virtual devices on the same manifests, base weights and starting
adapters.  JAX's Trainer is fed the rows the ranks load: its own
DataLoader sharded as JAX's multi-process branch shards it (each shard
draws its own conditioning clips), each step's shards joined.  Tiny model,
fp32, on the CPU; the ranks are OS processes with a deadline
(parallel/multihost.run_ranks)."""

import os

import numpy as np
import pytest
import torch

from indextts_tpu_torch.config import Config
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.parallel import mesh, multihost
from indextts_tpu_torch.train import trainer
from tests.test_torch_lora_train import assert_close

TOL = 1e-5
DEADLINE_S = 120.0
WORLD = 2


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


STEP_METRICS = ("loss", "loss_text", "loss_mel", "grad_norm")


def _recording_steps(module, log):
    """Wrap `module.train_step` so that each step's metrics land in `log`;
    returns the unwrapped function."""
    inner = module.train_step

    def step(*args, **kw):
        state, metrics = inner(*args, **kw)
        log.append({k: float(metrics[k]) for k in STEP_METRICS})
        return state, metrics

    module.train_step = step
    return inner


def _trainer_case(device, p):
    from indextts_tpu_torch.train.run import Trainer

    steps = []
    _recording_steps(trainer, steps)
    cfg = Config.from_dict(p["config"])
    t = Trainer(cfg, p["model_dir"], run_name=f"dp{mesh.world()}", device="cpu")
    adapters = from_jax.lora_params_from_numpy(p["adapters"], cfg.gpt, cfg.train.lora)
    t.state = trainer.TrainState(adapters, t.optimizer.init(adapters),
                                 torch.zeros((), dtype=torch.int32))
    t.train()
    resumed = Trainer(cfg, p["model_dir"], run_name=f"dp{mesh.world()}", device="cpu")
    resumed.try_resume()
    return {"adapters": _np_tree(t.state.lora_params), "step": int(t.state.step),
            "steps": steps,
            "best_val": t.best_val, "patience_left": t.patience_left, "val": t.validate(),
            "valid_rows": len(t.valid_loader._epoch_indices()), "writer": t.writer is not None,
            "files": sorted(os.listdir(t.out_dir)), "checksum": multihost.tree_checksum(t.state),
            "resumed": (resumed.start_epoch, multihost.tree_checksum(resumed.state))}


def _join(parts):
    """One array (or list) from the shards' parts, each array padded on its
    last axis to the parts' widest."""
    if isinstance(parts[0], list):
        return [x for p in parts for x in p]
    if parts[0].ndim == 1:
        return np.concatenate(parts)
    w = max(p.shape[-1] for p in parts)
    return np.concatenate([np.pad(p, [(0, 0)] * (p.ndim - 1) + [(0, w - p.shape[-1])])
                           for p in parts])


class JoinedShards:
    """JAX's DataLoader sharded over WORLD as the ranks' loaders are (JAX's
    multi-process branch: each shard draws its own conditioning clips),
    each step's shards joined into one batch: the rows the ranks load,
    fed to one JAX program."""

    def __init__(self, shards):
        self.shards = shards

    def __len__(self):
        return len(self.shards[0])

    def set_epoch(self, epoch):
        for s in self.shards:
            s.set_epoch(epoch)

    def __iter__(self):
        for parts in zip(*self.shards):
            yield {k: _join([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def trainer_ref(tmp_path_factory):
    """The data and model directory of tests/test_torch_train_run.py (two
    speakers, 10 train and 2 valid clips each, a numpy-seeded fp32
    gpt.pth) and JAX's Trainer over them from its adapters with `b` drawn
    from numpy: 2 epochs of 2 steps of 8 rows on its 8 virtual devices, each
    step's rows those of the ranks' shards (JoinedShards)."""
    import json
    import shutil
    import warnings

    import jax
    import jax.numpy as jnp

    from indextts_tpu import config as jax_config
    from indextts_tpu.data import dataset as jax_dataset
    from indextts_tpu.models import unified_voice as jax_uv
    from indextts_tpu.train import run as jax_run
    from indextts_tpu.train import trainer as jax_trainer
    from indextts_tpu_torch.io import export
    from tests.test_torch_engine import REPO
    from tests.test_torch_gpt import numpy_params
    from tests.test_torch_train_run import MODEL, SENTENCES, SPEAKERS, _starting_adapters, \
        train_dict

    root = tmp_path_factory.mktemp("dp_trainer")
    rng = np.random.default_rng(0)
    data = root / "data"
    for spk in SPEAKERS:
        d = data / spk
        (d / "codes").mkdir(parents=True)
        (d / "mels").mkdir()
        recs = {"train": [], "valid": []}
        for i in range(12):
            n = int(rng.integers(8, 15))
            np.save(d / "codes" / f"c{i}.npy", rng.integers(0, 46, (n,)))
            np.save(d / "mels" / f"c{i}.npy",
                    rng.standard_normal((100, 4 * n)).astype(np.float32))
            recs["train" if i < 10 else "valid"].append({
                "audio": f"{spk}/c{i}.wav", "text": SENTENCES[int(rng.integers(5))],
                "duration": 2.0 + 0.1 * i, "codes": f"codes/c{i}.npy",
                "mels": f"mels/c{i}.npy"})
        for split, rs in recs.items():
            with open(d / f"metadata_{split}.jsonl", "w", encoding="utf-8") as f:
                f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rs)
        np.save(d / "medoid_condition.npy", rng.standard_normal((1, 32, 64)).astype(np.float32))
        np.save(d / "medoid_mel.npy", rng.standard_normal((100, 40)).astype(np.float32))
    with open(data / "speaker_info.json", "w") as f:
        json.dump([{"speaker": s} for s in SPEAKERS], f)
    model_dir = root / "model"
    model_dir.mkdir()
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), model_dir / "vocab.txt")
    d = {**MODEL, "train": train_dict(root)}
    jcfg, cfg = jax_config.Config.from_dict(d), Config.from_dict(d)
    base_np = numpy_params(jax.eval_shape(lambda: jax_uv.init_params(
        jax.random.PRNGKey(0), jcfg.gpt)), 1, lambda s: 1.0 / np.sqrt(s[-2]))
    export.save_gpt_pth(str(model_dir / "gpt.pth"), base_np, cfg.gpt, save_dtype="fp32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_run.Trainer(jcfg, str(model_dir), run_name="jax")
        start = _starting_adapters(jt)
        jt.state = jax_trainer.TrainState(
            *jax_trainer.replicate((jax.tree.map(jnp.asarray, start),
                                    jt.optimizer.init(jax.tree.map(jnp.asarray, start))),
                                   jt.mesh), jnp.int32(0))
        tc = jt.tc
        jt.loader = JoinedShards([jax_dataset.DataLoader(
            jt.train_ds, jt.loader.batch_size // WORLD, seed=tc.seed,
            cross_speaker_ratio=tc.cross_speaker_ratio,
            text_length_weights=tc.text_length_weights, num_shards=WORLD, shard_index=r)
            for r in range(WORLD)])
        steps = []
        inner = _recording_steps(jax_trainer, steps)
        try:
            jt.train()
        finally:
            jax_trainer.train_step = inner
        val = jt.validate()
    shutil.rmtree(jt.out_dir, ignore_errors=True)
    return {"payload": {"config": d, "model_dir": str(model_dir), "adapters": start},
            "jt": jt, "val": val, "n_valid": len(jt.valid_ds), "steps": steps}


@pytest.fixture(scope="module")
def runs(trainer_ref):
    return multihost.run_ranks("tests.test_torch_dp_trainer:_trainer_case", WORLD,
                               trainer_ref["payload"], timeout=DEADLINE_S)


def test_trainer_over_ranks_matches_jax_trainer(runs, trainer_ref):
    """2 epochs of 2 steps: on every rank the adapters within 1e-5 of each
    leaf's largest magnitude of JAX's (the single-device Trainer test's
    tolerance), the same step count, the best validation loss within 1e-5,
    rank 0 alone writing."""
    import jax

    jt = trainer_ref["jt"]
    want = jax.tree.map(np.asarray, jt.state.lora_params)
    outs = runs
    for r, o in enumerate(outs):
        assert_close(o["adapters"], want, what=f"rank {r} adapters after 2 epochs: ")
        assert o["step"] == int(jt.state.step) == 4
        np.testing.assert_allclose(o["best_val"], jt.best_val, rtol=TOL)
        assert o["patience_left"] == jt.patience_left
        assert o["writer"] == (r == 0 and outs[0]["writer"])
        assert o["checksum"] == outs[0]["checksum"]
    assert {"checkpoint_epoch_1", "model_epoch_1", "gpt_finetuned.pth",
            "config_finetuned.yaml"} <= set(outs[0]["files"])


def test_every_step_is_the_global_batchs(runs, trainer_ref):
    """Each of the 4 steps' loss, text and mel losses and gradient norm, as
    reduced over the ranks, within 1e-5 of JAX's over the same 8 rows (the
    single-device Trainer test's tolerance), and the same on every rank: a
    rank that trained on another rank's shard, or counted only its own
    tokens, moves them by more."""
    want = trainer_ref["steps"]
    assert len(want) == 4
    for r, o in enumerate(runs):
        assert len(o["steps"]) == len(want)
        assert o["steps"] == runs[0]["steps"], f"rank {r}"
        for i, (got, ref) in enumerate(zip(o["steps"], want)):
            for k in STEP_METRICS:
                np.testing.assert_allclose(got[k], ref[k], rtol=TOL, err_msg=f"step {i} {k}")


def test_resume_loads_the_same_checkpoint_on_every_rank(runs):
    """A new Trainer on each rank, try_resume: epoch 2 next, and the state
    bit-equal to the trained one (adapters, optimizer state and step)."""
    for o in runs:
        assert o["resumed"] == (2, runs[0]["checksum"])


def test_validation_is_one_mean_over_every_rank(runs, trainer_ref):
    outs = runs
    assert sum(o["valid_rows"] for o in outs) == trainer_ref["n_valid"]
    assert trainer_ref["n_valid"] % 8   # JAX repeats rows to fill its 8 devices
    for o in outs:
        assert o["val"] == outs[0]["val"]
        np.testing.assert_allclose(o["val"], trainer_ref["val"], rtol=TOL)
