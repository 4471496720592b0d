"""PyTorch port, LoRA fine-tuning run (train/run.py): the copied dataset and
loader against the JAX package's (batches equal array for array), the
port's `Trainer` against JAX's `Trainer` on the same manifests, base
weights and starting adapters, resume against a straight run, the artifacts
(resume and merged directories, `.pth` twins with the speakers' medoids,
config_finetuned.yaml), the trained `gpt_finetuned.pth` in both packages'
engines (greedy codes equal), the merged directory in the port's engine and
through the server's /model/reload, the port's directory format, the
refusal of orbax directories, and `Config.save` without PyYAML.  Synthetic
data in the extraction layout, tiny model (2 layers, width 64, 4 heads),
fp32, on the CPU."""

import json
import os
import shutil
import threading
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu import engine as jax_engine
from indextts_tpu.data import dataset as jax_dataset
from indextts_tpu.io import checkpoint as jax_ckpt
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.train import run as jax_run
from indextts_tpu.train import trainer as jax_trainer
from indextts_tpu.utils.textnorm import TextNormalizer as JaxNormalizer
from indextts_tpu.utils.tokenizer import TextTokenizer as JaxTokenizer
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.config import Config
from indextts_tpu_torch.data import dataset
from indextts_tpu_torch.io import checkpoint, export, from_jax
from indextts_tpu_torch.serve import httpd
from indextts_tpu_torch.train import lora
from indextts_tpu_torch.train import trainer as torch_trainer
from indextts_tpu_torch.train.run import Trainer
from indextts_tpu_torch.utils.textnorm import TextNormalizer
from indextts_tpu_torch.utils.tokenizer import TextTokenizer
from tests.test_torch_engine import REPO
from tests.test_torch_gpt import numpy_params
from tests.test_torch_lora_train import _leaves, assert_close
from tests.test_torch_serve import _post

SPEAKERS = ["spk_a", "spk_b"]
SENTENCES = ["你好世界", "今天天氣很好", "我們去散步吧", "這是一個測試", "明天見"]
MODEL = {
    "gpt": {"model_dim": 64, "layers": 2, "heads": 4, "max_mel_tokens": 48,
            "max_text_tokens": 30, "number_text_tokens": 12000, "number_mel_codes": 50,
            "start_mel_token": 46, "stop_mel_token": 47,
            "condition_module": {"output_size": 32, "linear_units": 64, "attention_heads": 4,
                                 "num_blocks": 2, "perceiver_mult": 2}},
    "bigvgan": {"upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "speaker_embedding_dim": 8,
                "gpt_dim": 64},
}


def train_dict(root, **over):
    # fp32 so both packages compute alike; accumulation 1 and batch 8, which
    # JAX's trainer keeps on its 8 virtual CPU devices
    return {"finetune_model_dir": str(root / "out"), "data_path": str(root / "data"),
            "epochs": 2, "batch_size": 8, "valid_batch_size": 4, "max_steps_per_epoch": 2,
            "gradient_accumulation_steps": 1, "mixed_precision": "fp32",
            "early_stopping_patience": 5, "save_dtype": "fp32", "seed": 5,
            "text_length_weights": {4: 2.0, 100: 1.0}, **over}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Two speakers of 12 clips (10 train, 2 valid) in the extraction layout
    with their medoids; a model directory with the vocabulary and a
    numpy-seeded fp32 gpt.pth; both packages' configs."""
    root = tmp_path_factory.mktemp("train_run")
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
    cfg.save(str(model_dir / "config.yaml"))
    return dict(root=root, data=str(data), model_dir=str(model_dir), jcfg=jcfg, cfg=cfg)


def _starting_adapters(jt, seed=3):
    """JAX's trainer's own adapters (PRNGKey init) with `b` drawn from numpy,
    so that both factors train from the first step."""
    tree = jax.tree.map(np.asarray, jt.state.lora_params)
    rng = np.random.default_rng(seed)
    for ab in tree.values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


LOADERS = {
    "plain": dict(),
    "shard 0 of 2": dict(num_shards=2, shard_index=0),
    "shard 1 of 2": dict(num_shards=2, shard_index=1),
    "cross-speaker and text-length weights": dict(cross_speaker_ratio=0.5,
                                                  text_length_weights={4: 3.0, 8: 0.5}),
    "lazy index, no shuffle": dict(shuffle=False, drop_last=False),
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_dataset_and_loader_batches_equal_jax(ws, case):
    kw = dict(LOADERS[case])
    lazy = case.startswith("lazy")
    vocab = os.path.join(ws["model_dir"], "vocab.txt")
    jds = jax_dataset.FinetuneDataset(ws["data"], "train", JaxTokenizer(vocab, JaxNormalizer()),
                                      lazy=lazy)
    tds = dataset.FinetuneDataset(ws["data"], "train", TextTokenizer(vocab, TextNormalizer()),
                                  lazy=lazy)
    assert len(tds) == len(jds) == 20
    jl = jax_dataset.DataLoader(jds, 3, seed=9, **kw)
    tl = dataset.DataLoader(tds, 3, seed=9, **kw)
    assert len(tl) == len(jl) > 0
    for epoch in (0, 1):
        jb, tb = _batches(jl, epoch), _batches(tl, epoch)
        assert len(tb) == len(jb)
        for want, got in zip(jb, tb):
            assert sorted(got) == sorted(want)
            for k in want:
                if k == "speakers":
                    assert got[k] == want[k]
                else:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_trainer_run(ws):
    """JAX's trainer from its own adapters with `b` drawn from numpy."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_run.Trainer(ws["jcfg"], ws["model_dir"], run_name="jax")
        start = _starting_adapters(jt)
        jt.state = jax_trainer.TrainState(
            *jax_trainer.replicate((jax.tree.map(jnp.asarray, start),
                                    jt.optimizer.init(jax.tree.map(jnp.asarray, start))),
                                   jt.mesh), jnp.int32(0))
        jt.train()
    return jt, start


class Interrupted(Exception):
    pass


@pytest.fixture(scope="module")
def runs(ws, jax_trainer_run):
    """The port's trainer on the same data, base and starting adapters as
    JAX's; and the port's run again, interrupted as epoch 1 begins, then a
    new Trainer, try_resume and the rest."""
    jt, start = jax_trainer_run
    adapters = from_jax.lora_params_from_numpy(start, ws["cfg"].gpt, ws["cfg"].train.lora)

    def trainer_from(run_name):
        t = Trainer(ws["cfg"], ws["model_dir"], run_name=run_name, device="cpu")
        t.state = torch_trainer.TrainState(adapters, t.optimizer.init(adapters),
                                           torch.zeros((), dtype=torch.int32))
        return t

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tt = trainer_from("torch")
        tt.train()
        first = trainer_from("resumed")
        set_epoch = first.loader.set_epoch

        def stop_at_epoch_1(epoch):
            if epoch == 1:
                raise Interrupted
            set_epoch(epoch)

        first.loader.set_epoch = stop_at_epoch_1
        with pytest.raises(Interrupted):
            first.train()
        first.close()
        resumed = Trainer(ws["cfg"], ws["model_dir"], run_name="resumed", device="cpu")
        resumed.try_resume()
        resumed.train()
    return dict(jax=jt, torch=tt, first=first, resumed=resumed)


def test_trainer_matches_jax_trainer(runs):
    """2 epochs of 2 steps: adapters within 1e-5 of each leaf's largest
    magnitude of JAX's, the same step count and the same best validation
    loss."""
    jt, tt = runs["jax"], runs["torch"]
    assert_close(tt.state.lora_params, jax.tree.map(np.asarray, jt.state.lora_params),
                 what="adapters after 2 epochs: ")
    assert int(tt.state.step) == int(jt.state.step) == 4
    np.testing.assert_allclose(tt.best_val, jt.best_val, rtol=1e-5)
    assert tt.patience_left == jt.patience_left


def test_resume_equals_the_straight_run(runs):
    tt, first, resumed = runs["torch"], runs["first"], runs["resumed"]
    assert first.start_epoch == 0 and resumed.start_epoch == 1
    for tree_got, tree_want in ((resumed.state.lora_params, tt.state.lora_params),
                                (resumed.state.opt_state, tt.state.opt_state)):
        got, want = dict(_leaves(tree_got)), dict(_leaves(tree_want))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(resumed.state.step) == int(tt.state.step)
    assert (resumed.best_val, resumed.patience_left) == (tt.best_val, tt.patience_left)


def test_the_run_writes_every_artifact(ws, runs):
    tt = runs["torch"]
    names = set(os.listdir(tt.out_dir))
    assert {"checkpoint_epoch_0", "checkpoint_epoch_1", "model_epoch_0", "model_epoch_1",
            "gpt_epoch_1.pth", "gpt_epoch_2.pth", "gpt_best.pth", "gpt_finetuned.pth",
            "config_finetuned.yaml", "logs"} <= names
    assert Config.load(os.path.join(tt.out_dir, "config_finetuned.yaml")) == ws["cfg"]
    tree, extras = checkpoint.load_gpt_checkpoint(
        os.path.join(tt.out_dir, "gpt_finetuned.pth"), ws["cfg"].gpt)
    assert extras["speakers"] == SPEAKERS
    for spk in SPEAKERS:
        d = os.path.join(ws["data"], spk)
        np.testing.assert_array_equal(extras["speaker_conditions"][spk],
                                      np.load(os.path.join(d, "medoid_condition.npy")))
        np.testing.assert_array_equal(extras["speaker_mels"][spk],
                                      np.load(os.path.join(d, "medoid_mel.npy")))
    merged = lora.merge(tt.base_params, tt.state.lora_params, ws["cfg"].train.lora,
                        torch.float32)
    got, want = dict(_leaves(tree)), dict(_leaves(merged))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ckpt = checkpoint.load_pytree(os.path.join(tt.out_dir, "checkpoint_epoch_1"))
    assert (ckpt["epoch"], ckpt["step"], ckpt["best_val"]) == (1, 4, tt.best_val)


@pytest.fixture(scope="module")
def engine_dir(ws):
    """A model directory with the tiny config at fp32 and a numpy-seeded
    bigvgan_generator.pth."""
    d = ws["root"] / "engine"
    d.mkdir()
    shutil.copy(os.path.join(ws["model_dir"], "vocab.txt"), d / "vocab.txt")
    cfg = jax_config.Config.from_dict({**MODEL, "inference": {"gpt": "fp32",
                                                              "vocoder": "fp32"}})
    cfg.save(str(d / "config.yaml"))
    bv_np = numpy_params(jax.eval_shape(lambda: jax_bigvgan.init_params(
        jax.random.PRNGKey(1), cfg.bigvgan)), 2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    export.save_bigvgan_pth(str(d / "bigvgan_generator.pth"), bv_np, ws["cfg"].bigvgan)
    return d


def test_finetuned_pth_serves_in_both_engines(runs, engine_dir):
    """The port's gpt_finetuned.pth in JAX's engine and the port's: the same
    weights and speakers, and equal greedy codes from the same speaker's
    stored condition."""
    pth = os.path.join(runs["torch"].out_dir, "gpt_finetuned.pth")
    cfg_path = str(engine_dir / "config.yaml")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = jax_engine.IndexTTS(cfg_path=cfg_path, model_dir=str(engine_dir), gpt_path=pth)
        teng = torch_engine.IndexTTS(cfg_path=cfg_path, model_dir=str(engine_dir),
                                     device="cpu", gpt_path=pth)
    assert teng.speaker_list == jeng.speaker_list == SPEAKERS
    tcond = teng._conditioning(None, "spk_b")
    jcond = jeng._conditioning(None, "spk_b")
    np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), atol=1e-5, rtol=0)
    ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(
        teng.tokenizer.tokenize(SENTENCES[1])), np.int32)
    gen = dict(num_beams=1, do_sample=False, max_mel_tokens=12)
    jcodes, jlens = jeng._decode_bucket(jcond, [ids], jax.random.PRNGKey(0), dict(gen))
    tcodes, tlens, _ = teng._decode_bucket(tcond, [ids], None, dict(gen))
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(tlens, jlens)


def test_merged_directory_serves_and_reloads(ws, runs, engine_dir):
    """model_epoch_1 as an engine's gpt_path holds the merged weights, and
    /model/reload onto it over a socket builds the next engine from it."""
    tt = runs["torch"]
    merged_dir = os.path.join(tt.out_dir, "model_epoch_1")
    want = dict(_leaves(lora.merge(tt.base_params, tt.state.lora_params,
                                   ws["cfg"].train.lora, torch.float32)))
    cfg_path = str(engine_dir / "config.yaml")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng = torch_engine.IndexTTS(cfg_path=cfg_path, model_dir=str(engine_dir),
                                     device="cpu", gpt_path=merged_dir)
    got = dict(_leaves(teng.gpt_params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    server = httpd.serve(cfg_path, str(engine_dir), host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, _, data = _post(server, "/model/reload", {"gpt_path": merged_dir})
        assert status == 200 and json.loads(data) == {"status": "reloaded",
                                                      "gpt_path": merged_dir}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            served = server.service.engine()
        assert served.gpt_path == merged_dir
        assert torch.equal(served.gpt_params["gpt"]["blocks"]["attn"]["qkv_w"],
                           teng.gpt_params["gpt"]["blocks"]["attn"]["qkv_w"])
    finally:
        server.shutdown()


def test_pytree_directory_round_trip(tmp_path):
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16), "n": torch.tensor(7, dtype=torch.int32),
            "deep": {"x": torch.arange(5.0), "step": 3}, "best": float("inf")}
    checkpoint.save_pytree(str(tmp_path / "t"), tree)
    assert sorted(os.listdir(tmp_path / "t")) == ["arrays.npz", "pytree.json"]
    got = checkpoint.load_pytree(str(tmp_path / "t"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tree["w"])
    assert got["n"].dtype == torch.int32 and int(got["n"]) == 7
    assert torch.equal(got["deep"]["x"], tree["deep"]["x"]) and got["deep"]["step"] == 3
    assert got["best"] == float("inf")
    with pytest.raises(TypeError, match="tree.deep.bad"):
        checkpoint.save_pytree(str(tmp_path / "u"), {"deep": {"bad": "text"}})
    with pytest.raises(FileNotFoundError, match="pytree.json"):
        checkpoint.load_pytree(str(tmp_path))


def test_orbax_directory_is_refused(tmp_path, engine_dir):
    """The JAX package's orbax directory: the loader and the engine refuse it
    and name the .pth route."""
    orbax_dir = str(tmp_path / "orbax")
    jax_ckpt.save_pytree(orbax_dir, {"w": jnp.ones((2, 3))})
    with pytest.raises(ValueError, match=r"orbax.*\.pth"):
        checkpoint.load_pytree(orbax_dir)
    with warnings.catch_warnings(), pytest.raises(ValueError, match=r"\.pth"):
        warnings.simplefilter("ignore")
        torch_engine.IndexTTS(cfg_path=str(engine_dir / "config.yaml"),
                              model_dir=str(engine_dir), device="cpu", gpt_path=orbax_dir)


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


def test_config_save_writes_yaml_without_pyyaml(tmp_path, monkeypatch):
    """Config.save emits YAML itself (the card machine has no PyYAML): with
    `yaml` unimportable it still writes, PyYAML reads the file back as
    to_dict() (tuples as lists), and Config.load gives an equal Config."""
    cfg = Config.from_dict({**MODEL, "train": {
        "text_length_weights": {10: 2.0, 50: 0.5}, "data_path": "a: b/'c\"d'/你好",
        "optimizer": {"learning_rate": 5e-6}, "max_grad_norm": float("inf")}})
    path = str(tmp_path / "c.yaml")
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    cfg.save(path)
    monkeypatch.undo()
    with open(path, encoding="utf-8") as f:
        assert yaml.safe_load(f) == _lists(cfg.to_dict())
    assert Config.load(path) == cfg
