"""PyTorch port, DVAE training (train/dvae.py, train/optim.AdamW): the mel
windows and the mel discovery against the JAX package's, the plain AdamW
against the optax chain on equal gradients, three train steps against
JAX's `train_step` from the same state (JAX's rebalance draws injected),
the written checkpoints, and the device rule.  Small config (100 mel
channels, 32 codes, hidden 16, codebook dim 16, one residual block), fp32,
on the CPU."""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu.config import VQVAEConfig as JaxVQVAEConfig
from indextts_tpu.train import dvae as jax_dtrain
from indextts_tpu_torch.config import VQVAEConfig
from indextts_tpu_torch.io import checkpoint
from indextts_tpu_torch.train import dvae as dtrain
from indextts_tpu_torch.train.optim import AdamW
from tests.test_torch_dvae import dvae_numpy_params

SIZES = dict(num_tokens=32, hidden_dim=16, codebook_dim=16, num_resnet_blocks=1)
CFG, JCFG = VQVAEConfig(**SIZES), JaxVQVAEConfig(**SIZES)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_close(got, want, rel, what=""):
    """Each leaf within `rel` of the leaf's largest magnitude."""
    g, w = dict(jax.tree.leaves_with_path(got)), dict(jax.tree.leaves_with_path(want))
    assert sorted(map(str, g)) == sorted(map(str, w)), what
    for k, ref in w.items():
        ref, out = _np(ref), _np(g[k])
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(out - ref).max())
        assert err <= rel * scale, f"{what}{jax.tree_util.keystr(k)}: {err:.3g} > {rel} x {scale:.3g}"


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    """Mel files in both orientations, one shorter than a window, and an
    extraction layout over them (speaker_info.json, manifests)."""
    root = tmp_path_factory.mktemp("mels")
    rng = np.random.default_rng(0)
    for spk in ("spk_a", "spk_b"):
        d = root / spk
        (d / "mels").mkdir(parents=True)
        recs = []
        for i, T in enumerate((120, 20, 77)):
            m = rng.standard_normal((100, T)).astype(np.float32)
            np.save(d / "mels" / f"c{i}.npy", m.T if i == 2 else m)
            recs.append({"audio": f"{spk}/c{i}.wav", "text": "x", "duration": 1.0,
                         "codes": f"codes/c{i}.npy", "mels": f"mels/c{i}.npy"})
        for split, rs in (("train", recs[:2]), ("valid", recs[2:])):
            with open(d / f"metadata_{split}.jsonl", "w", encoding="utf-8") as f:
                f.writelines(json.dumps(r) + "\n" for r in rs)
    with open(root / "speaker_info.json", "w") as f:
        json.dump([{"speaker": "spk_a"}, {"speaker": "spk_b"}], f)
    return str(root)


def test_discover_mels_matches_jax(mel_dir):
    for source in (mel_dir, os.path.join(mel_dir, "spk_a", "mels"),
                   os.path.join(mel_dir, "*", "mels", "c1.npy")):
        got = dtrain.discover_mels(source)
        assert got == jax_dtrain.discover_mels(source) and got, source
    assert len(dtrain.discover_mels(mel_dir)) == 6


def test_mel_window_batches_match_jax(mel_dir):
    paths = dtrain.discover_mels(mel_dir)
    ours = dtrain.mel_window_batches(paths, 5, 32, seed=3)
    ref = jax_dtrain.mel_window_batches(paths, 5, 32, seed=3)
    for _ in range(4):
        a, b = next(ours), next(ref)
        assert a.shape == (5, 100, 32) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("warmup", [0, 2])
def test_adamw_matches_the_optax_chain(warmup):
    """clip_by_global_norm(1) -> adamw(warmup-cosine, weight_decay=0.01) on
    equal gradients: four updates, the clip firing on the second."""
    rng = np.random.default_rng(6)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, 6), weight_decay=0.01))
    opt = AdamW(1e-2, warmup, 6, weight_decay=0.01, max_grad_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = tx.init(jp), opt.init(tp)
    for i in range(4):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * (5.0 if i == 1 else 0.1)
                                    ).astype(np.float32), params)
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.step(jax.tree.map(torch.from_numpy, g), ts, tp)
        assert_tree_close(tp, jp, 1e-6, f"update {i}")
    assert int(ts["count"]) == 4


def _jax_state(tree, optimizer):
    params = jax.tree.map(jnp.asarray, tree)
    grads_like = {k: v for k, v in params.items() if k != "codebook"}
    return jax_dtrain.DVAETrainState(params, optimizer.init(grads_like),
                                     jnp.zeros((JCFG.num_tokens,), jnp.float32), jnp.int32(0))


@pytest.mark.parametrize("variant", ["rebalance", "discretization"])
def test_three_train_steps_match_jax(variant):
    """From the same weights, the same windows and JAX's rebalance draws
    (jax.random.normal(fold_in(key, 1)), as JAX's step takes them) at a
    small rate: lr 1e-5 keeps Adam's near-zero elements, which it scales to
    about lr whatever their sign, within 2e-5 of the weights' scale."""
    kw = (dict(rebalance_every=2, rebalance_lo=0.02) if variant == "rebalance"
          else dict(discretization_weight=0.1))
    tc_kw = dict(batch_size=4, mel_width=32, steps=3, lr=1e-5, warmup_steps=1, **kw)
    jtc, tc = jax_dtrain.DVAETrainConfig(**tc_kw), dtrain.DVAETrainConfig(**tc_kw)
    tree = dvae_numpy_params(JCFG, 1)
    jopt = jax_dtrain.make_optimizer(jtc)
    jstate = _jax_state(tree, jopt)
    step_fn = jax.jit(jax_dtrain.train_step, static_argnames=("cfg", "optimizer", "tc"))
    opt = dtrain.make_optimizer(tc)
    state = dtrain.init_state(CFG, opt, params=tree)
    rng = np.random.default_rng(8)
    resets = 0
    for i in range(3):
        mel = rng.standard_normal((4, 100, 32)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), (16, 32), jnp.float32))
        jstate, jm = step_fn(jstate, jnp.asarray(mel), key, cfg=JCFG, optimizer=jopt, tc=jtc)
        state, m = dtrain.train_step(state, torch.from_numpy(mel), CFG, opt, tc,
                                     noise=torch.from_numpy(noise))
        for k in jm:
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-6), k
        resets += int(m["codes_reset"])
        assert_tree_close(state.params["codebook"], jstate.params["codebook"], 1e-5,
                          f"step {i} codebook")
        np.testing.assert_array_equal(state.usage.numpy(), np.asarray(jstate.usage))
        assert int(state.step) == int(jstate.step) == i + 1
        grads = {k: v for k, v in state.params.items() if k != "codebook"}
        jgrads = {k: v for k, v in jstate.params.items() if k != "codebook"}
        assert_tree_close(grads, jgrads, 2e-5, f"step {i} params ")
        assert_tree_close(state.opt_state["mu"], jstate.opt_state[1][0].mu, 1e-4, "mu ")
    if variant == "rebalance":
        assert resets > 0             # the rebalance fired and was held
    moved = np.abs(state.params["codebook"]["embed"].numpy() - tree["codebook"]["embed"]).max()
    assert moved > 0


def test_train_dvae_writes_checkpoints(mel_dir, tmp_path):
    tc = dtrain.DVAETrainConfig(batch_size=4, mel_width=32, steps=4, lr=1e-3, warmup_steps=1,
                                log_every=2, checkpoint_every=2, rebalance_every=2)
    state = dtrain.train_dvae(CFG, tc, dtrain.discover_mels(mel_dir), str(tmp_path),
                              device="cpu")
    assert int(state.step) == 4
    assert sorted(os.listdir(tmp_path)) == ["dvae_step_2", "dvae_step_4"]
    back = checkpoint.load_pytree(str(tmp_path / "dvae_step_4"))
    assert back["step"] == 4
    for (p, a), (_, b) in zip(jax.tree.leaves_with_path(back["params"]),
                              jax.tree.leaves_with_path(state.params)):
        assert torch.equal(a, b), jax.tree_util.keystr(p)


def test_train_dvae_defaults_to_cuda_and_raises_without_it(mel_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dtrain.train_dvae(CFG, dtrain.DVAETrainConfig(steps=1), dtrain.discover_mels(mel_dir),
                          str(tmp_path))


def test_cli_init_fine_tunes_a_dvae_pth(mel_dir, tmp_path):
    """`--init dvae.pth` starts from that file's weights: at lr 0 the
    encoder and decoder of the written step equal the file's."""
    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.io import export

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    Config.from_dict({"vqvae": SIZES}).save(str(model_dir / "config.yaml"))
    tree = dvae_numpy_params(JCFG, 3)
    export.save_dvae_pth(str(model_dir / "dvae.pth"), tree, CFG)
    out = tmp_path / "run"
    dtrain.main(["--mels", str(mel_dir), "--out", str(out), "--model_dir", str(model_dir),
                 "--init", str(model_dir / "dvae.pth"), "--steps", "1", "--batch", "2",
                 "--width", "32", "--lr", "0", "--device", "cpu"])
    back = checkpoint.load_pytree(str(out / "dvae_step_1"))["params"]
    want = {k: v for k, v in tree.items() if k != "codebook"}
    got = {k: v for k, v in back.items() if k != "codebook"}
    assert sorted(got) == sorted(want)
    for (p, a), (_, b) in zip(jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=jax.tree_util.keystr(p))
