"""PyTorch port, data-parallel training of LoRA and the DVAE over gloo ranks
(train/trainer.py, train/dvae.py with parallel/mesh.py),
held against the JAX package on the same global batch: one process a rank,
spawned by parallel/multihost.run_ranks, at worlds 2 and 4.

- The LoRA step on a batch whose text and mel lengths are ragged across
  ranks, each rank padding to its own widths: the global loss, metrics,
  reduced gradients and updated adapters against JAX's `train_step` and
  `loss_fn` gradients on the whole batch (1e-5, the single-device step
  tests' tolerance), the same on every rank; and the planted fault, the
  mean of each rank's own-count means as DDP would average, rejected by
  that tolerance.
- Two DVAE steps (a rebalance with JAX's draw, the discretization term)
  against JAX's `train_step` on the whole batch at its tolerances; and
  `train_dvae` at worlds 2 and 4 against one process over the same
  windows.
The Trainer over ranks is tests/test_torch_dp_trainer.py's.
Tiny configs, fp32, on the CPU."""

import os

import numpy as np
import pytest
import torch

from indextts_tpu_torch.config import GPTConfig, LoRAConfig, TrainConfig, VQVAEConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.parallel import mesh, multihost
from indextts_tpu_torch.train import dvae as dtrain
from indextts_tpu_torch.train import trainer

TOL = 1e-5          # fp32 steps: the single-device step tests' tolerance
TEXT_WEIGHT = 0.1
DEADLINE_S = 120.0
GLOBAL_B = 8
DVAE_SIZES = dict(num_tokens=32, hidden_dim=16, codebook_dim=16, num_resnet_blocks=1)
DVAE_TC = dict(batch_size=GLOBAL_B, mel_width=32, steps=2, lr=1e-5, warmup_steps=1,
               rebalance_every=2, rebalance_lo=0.02, discretization_weight=0.1)
LORA_TRAIN = {"gradient_accumulation_steps": 1, "max_grad_norm": 0.05,
              "optimizer": {"learning_rate": 5e-6, "weight_decay": 0.01, "warmup_ratio": 0.0,
                            "loraplus_lr_ratio": 2.0}}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree


def _own_rows(batch, rank, world):
    """This rank's rows of the global batch, cut to its own widths."""
    n = GLOBAL_B // world
    rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    tt, tc, tm = (int(rows[k].max()) for k in ("text_lengths", "codes_lengths",
                                                "cond_lengths"))
    rows.update(text_ids=rows["text_ids"][:, :tt], mel_codes=rows["mel_codes"][:, :tc],
                cond_mel=rows["cond_mel"][..., :tm])
    return trainer.Batch(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if v.dtype == np.float32 else torch.int64) for k, v in rows.items()})


def _lora_case(p):
    r, n = mesh.rank(), mesh.world()
    cfg, lcfg = GPTConfig.from_dict(p["gpt"]), LoRAConfig()
    base = from_jax.gpt_params_from_numpy(p["base"], cfg)
    adapters = from_jax.lora_params_from_numpy(p["adapters"], cfg, lcfg)
    opt = trainer.make_optimizer(TrainConfig.from_dict(LORA_TRAIN), 3)
    state = trainer.TrainState(adapters, opt.init(adapters), torch.zeros((), dtype=torch.int32))
    b = _own_rows(p["batch"], r, n)
    group = mesh.data_group()
    new, m = trainer.train_step(state, base, b, cfg, lcfg, opt, TEXT_WEIGHT, 0.0,
                                torch.Generator().manual_seed(0), group=group)
    _, _, grads = trainer.loss_and_grads(state, base, b, cfg, lcfg, TEXT_WEIGHT, group=group)
    local_loss, _, local_grads = trainer.loss_and_grads(state, base, b, cfg, lcfg, TEXT_WEIGHT)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": _np_tree(grads),
            "adapters": _np_tree(new.lora_params), "step": int(new.step),
            "checksum": multihost.tree_checksum(new), "widths": tuple(b.text_ids.shape[1:])
            + tuple(b.mel_codes.shape[1:]), "local_loss": float(local_loss),
            "local_grads": _np_tree(local_grads)}


def _dvae_case(p):
    r, n = mesh.rank(), mesh.world()
    cfg, tc = VQVAEConfig(**DVAE_SIZES), dtrain.DVAETrainConfig(**DVAE_TC)
    opt = dtrain.make_optimizer(tc)
    state = dtrain.init_state(cfg, opt, params=p["dvae"])
    rows = slice(r * GLOBAL_B // n, (r + 1) * GLOBAL_B // n)
    metrics = []
    for mel, noise in zip(p["mels"], p["noises"]):
        state, m = dtrain.train_step(state, torch.from_numpy(mel[rows]), cfg, opt, tc,
                                     noise=torch.from_numpy(noise), group=mesh.data_group())
        metrics.append({k: float(v) for k, v in m.items()})
    loop_tc = dtrain.DVAETrainConfig(batch_size=GLOBAL_B, mel_width=32, steps=3, lr=1e-3,
                                     warmup_steps=1, log_every=3, checkpoint_every=0)
    out = os.path.join(p["root"], f"dvae_dp{n}")
    loop = dtrain.train_dvae(cfg, loop_tc, p["mel_paths"], out, device="cpu", params=p["dvae"])
    return {"metrics": metrics, "params": _np_tree(state.params), "usage": state.usage.numpy(),
            "step": int(state.step), "loop": _np_tree(loop.params), "loop_files": os.listdir(out),
            "checksum": multihost.tree_checksum(state)}


def _worker(device, p):
    return {"lora": _lora_case(p["lora"]), "dvae": _dvae_case(p["dvae"])}


# -- the JAX package's side and the shared inputs ------------------------------

def _ragged_batch(seed):
    """8 rows at fixed widths (8 text, 12 codes, 40 frames), their lengths
    sorted so that the first rows are short and the last long: every split
    into 2 or 4 ranks gives the ranks different token counts."""
    rng = np.random.default_rng(seed)
    tl = np.sort(rng.integers(1, 9, GLOBAL_B)).astype(np.int32)
    cl = np.sort(rng.integers(2, 13, GLOBAL_B)).astype(np.int32)
    ml = rng.integers(24, 41, GLOBAL_B).astype(np.int32)
    ml[rng.integers(GLOBAL_B)] = 40         # the batch's width, as a loader pads it
    text = np.zeros((GLOBAL_B, 8), np.int32)
    codes = np.zeros((GLOBAL_B, 12), np.int32)
    cond = np.zeros((GLOBAL_B, 100, 40), np.float32)
    for i in range(GLOBAL_B):
        text[i, :tl[i]] = rng.integers(2, 40, tl[i])
        codes[i, :cl[i]] = rng.integers(0, 46, cl[i])
        cond[i, :, :ml[i]] = rng.standard_normal((100, ml[i]))
    return dict(text_ids=text, text_lengths=tl, mel_codes=codes, codes_lengths=cl,
                cond_mel=cond, cond_lengths=ml)


@pytest.fixture(scope="module")
def lora_ref():
    import jax
    import jax.numpy as jnp

    from indextts_tpu import config as jax_config
    from indextts_tpu.train import trainer as jax_trainer
    from tests.test_torch_gpt import TINY, gpt_numpy_params
    from tests.test_torch_lora_train import numpy_lora

    jcfg, jlora = jax_config.GPTConfig.from_dict(TINY), jax_config.LoRAConfig()
    base, adapters = gpt_numpy_params(jcfg), numpy_lora(jcfg, jlora, 3)
    batch = _ragged_batch(4)
    jb = jax_trainer.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    jbase, jadapt = jax.tree.map(jnp.asarray, base), jax.tree.map(jnp.asarray, adapters)
    (_, jm), jg = jax.jit(jax.value_and_grad(jax_trainer.loss_fn, has_aux=True),
                          static_argnames=("cfg", "lora_cfg", "text_weight",
                                           "cfg_dropout_ratio"))(
        jadapt, jbase, jb, jax.random.PRNGKey(0), cfg=jcfg, lora_cfg=jlora,
        text_weight=TEXT_WEIGHT, cfg_dropout_ratio=0.0)
    jopt = jax_trainer.make_optimizer(jax_config.TrainConfig.from_dict(LORA_TRAIN), 3)
    jstate, jsm = jax_trainer.train_step(
        jax_trainer.TrainState(jax.tree.map(jnp.array, jadapt), jopt.init(jadapt),
                               jnp.int32(0)),
        jbase, jb, jax.random.PRNGKey(0), jcfg, jlora, jopt, TEXT_WEIGHT, 0.0)
    return {"payload": {"gpt": TINY, "base": base, "adapters": adapters, "batch": batch},
            "metrics": {k: float(v) for k, v in {**jm, **jsm}.items()},
            "grads": jax.tree.map(np.asarray, jg),
            "adapters": jax.tree.map(np.asarray, jstate.lora_params)}


@pytest.fixture(scope="module")
def dvae_ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from indextts_tpu.config import VQVAEConfig as JaxVQVAEConfig
    from indextts_tpu.train import dvae as jax_dtrain
    from tests.test_torch_dvae import dvae_numpy_params

    jcfg = JaxVQVAEConfig(**DVAE_SIZES)
    jtc = jax_dtrain.DVAETrainConfig(**DVAE_TC)
    tree = dvae_numpy_params(jcfg, 1)
    jopt = jax_dtrain.make_optimizer(jtc)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = jax_dtrain.DVAETrainState(
        params, jopt.init({k: v for k, v in params.items() if k != "codebook"}),
        jnp.zeros((jcfg.num_tokens,), jnp.float32), jnp.int32(0))
    step_fn = jax.jit(jax_dtrain.train_step, static_argnames=("cfg", "optimizer", "tc"))
    rng = np.random.default_rng(8)
    mels, noises, metrics = [], [], []
    for i in range(DVAE_TC["steps"]):
        mel = rng.standard_normal((GLOBAL_B, 100, 32)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        noises.append(np.array(jax.random.normal(jax.random.fold_in(key, 1), (16, 32),
                                                 jnp.float32)))
        jstate, jm = step_fn(jstate, jnp.asarray(mel), key, cfg=jcfg, optimizer=jopt, tc=jtc)
        mels.append(mel)
        metrics.append({k: float(v) for k, v in jm.items()})
    root = tmp_path_factory.mktemp("dp_dvae")
    paths = []
    for i, T in enumerate((120, 20, 77, 64)):
        paths.append(str(root / f"m{i}.npy"))
        np.save(paths[-1], rng.standard_normal((100, T)).astype(np.float32))
    return {"payload": {"dvae": tree, "mels": mels, "noises": noises, "root": str(root),
                        "mel_paths": paths},
            "metrics": metrics, "state": jax.tree.map(np.asarray, jstate)}


@pytest.fixture(scope="module")
def runs(lora_ref, dvae_ref):
    payload = {"lora": lora_ref["payload"], "dvae": dvae_ref["payload"]}
    return {n: multihost.run_ranks("tests.test_torch_dp_train:_worker", n, payload,
                                   timeout=DEADLINE_S) for n in (2, 4)}


def _assert_close(got, want, rel=TOL, what=""):
    """Each leaf within `rel` of the leaf's largest magnitude."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_close(got[k], want[k], rel, f"{what}.{k}")
        return
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


# -- LoRA -----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_lora_step_on_ragged_ranks_matches_jax(runs, lora_ref, world):
    outs = [o["lora"] for o in runs[world]]
    assert len({o["widths"] for o in outs}) == world      # every rank its own widths
    for o in outs:
        for k in ("loss", "loss_text", "loss_mel", "acc_1", "acc_10", "acc_20", "grad_norm"):
            np.testing.assert_allclose(o["metrics"][k], lora_ref["metrics"][k], rtol=TOL,
                                       err_msg=k)
        assert o["metrics"]["grad_norm"] > 10 * LORA_TRAIN["max_grad_norm"]   # the clip fires
        _assert_close(o["grads"], lora_ref["grads"], what="reduced grads")
        _assert_close(o["adapters"], lora_ref["adapters"], what="adapters")
        assert o["step"] == 1 and o["checksum"] == outs[0]["checksum"]


@pytest.mark.parametrize("world", [2, 4])
def test_mean_of_rank_means_is_rejected(runs, lora_ref, world):
    """The planted fault: averaging each rank's own-count loss and
    gradients, as DDP would, misses JAX's global batch by more than the
    tolerance the correct step meets."""
    outs = [o["lora"] for o in runs[world]]
    loss = np.mean([o["local_loss"] for o in outs])
    assert abs(loss - lora_ref["metrics"]["loss"]) > TOL * abs(lora_ref["metrics"]["loss"])
    mean = {k: {kk: np.mean([o["local_grads"][k][kk] for o in outs], axis=0) for kk in v}
            for k, v in lora_ref["grads"].items()}
    with pytest.raises(AssertionError):
        _assert_close(mean, lora_ref["grads"], what="mean of rank means")


# -- DVAE ------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_dvae_steps_match_jax(runs, dvae_ref, world):
    """Metrics 1e-5 relative, codebook 1e-5 and weights 2e-5 of each leaf's
    largest magnitude, usage equal: tests/test_torch_dvae_train.py's
    bounds for the same steps on one device."""
    ref = dvae_ref["state"]
    for o in (x["dvae"] for x in runs[world]):
        for got, want in zip(o["metrics"], dvae_ref["metrics"]):
            for k, v in want.items():
                assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1e-6), k
        assert sum(m["codes_reset"] for m in o["metrics"]) > 0      # the rebalance fired
        _assert_close(o["params"]["codebook"], ref.params["codebook"], 1e-5, "codebook")
        _assert_close({k: v for k, v in o["params"].items() if k != "codebook"},
                      {k: v for k, v in ref.params.items() if k != "codebook"}, 2e-5, "weights")
        np.testing.assert_array_equal(o["usage"], ref.usage)
        assert o["step"] == 2 and o["checksum"] == runs[world][0]["dvae"]["checksum"]


def test_train_dvae_over_ranks_equals_one_process(runs, dvae_ref, tmp_path):
    """train_dvae at worlds 2 and 4 (each rank drawing the global windows
    and keeping its own) against one process over the same 8 windows a
    step: 1e-5 of each leaf's largest magnitude; rank 0 alone wrote."""
    cfg = VQVAEConfig(**DVAE_SIZES)
    tc = dtrain.DVAETrainConfig(batch_size=GLOBAL_B, mel_width=32, steps=3, lr=1e-3,
                                warmup_steps=1, log_every=3, checkpoint_every=0)
    one = dtrain.train_dvae(cfg, tc, dvae_ref["payload"]["mel_paths"], str(tmp_path),
                            device="cpu", params=dvae_ref["payload"]["dvae"])
    for world in (2, 4):
        for o in (x["dvae"] for x in runs[world]):
            _assert_close(o["loop"], _np_tree(one.params), what=f"world {world}")
            assert o["loop_files"] == ["dvae_step_3"]
