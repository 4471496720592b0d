"""PyTorch port, vocoder fine-tuning data-parallel over gloo ranks
(train/vocoder.py with parallel/mesh.py), held against the JAX package's
`train_step` on the same global batch of 2 rows over a world of 4 ranks,
where n_use = gcd(2, 4) = 2 ranks take a row each and reduce over their
group of 2, and the other two take none and join no gradient collective.  One step's
metrics, both networks' reduced gradients (the discriminators' before
their update, the generator's against the updated discriminators) and
updated parameters at the single-device test's bounds
(tests/test_torch_vocoder_train.py, whose JAX program this file compiles
again, so that the persistent compile cache serves both), the same on
every working rank; and `train_vocoder` over 4 ranks against one process
on the same batches.
Its tiny config (upsample [2, 2], 8 channels, period (2,), resolution
(128, 32, 64), mel scale (256, 64)), fp32, on the CPU; the ranks are OS
processes with a deadline (parallel/multihost.run_ranks)."""

import contextlib
import io
import math
import os

import numpy as np
import pytest
import torch

from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.parallel import mesh, multihost
from indextts_tpu_torch.train import optim, vocoder

DEADLINE_S = 120.0
TINY = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=8,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
            speaker_embedding_dim=8, gpt_dim=16)
CFG = BigVGANConfig(**TINY)
SMALL = dict(batch_size=2, segment_codes=16, periods=(2,), resolutions=((128, 32, 64),),
             mel_scales=((256, 64),), lr=1e-5, steps=1, log_every=1, checkpoint_every=0)
TC = vocoder.VocoderTrainConfig(**SMALL)


def _leaves(tree):
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in optim.tree_leaves(tree)]


def _start(p):
    gen = from_jax.bigvgan_params_from_numpy(p["gen"], CFG)
    floats, aux = vocoder.split_static(from_jax.discriminator_params_from_numpy(
        p["disc"], TC.periods, TC.resolutions))
    opt = vocoder.make_optimizer(TC)
    return vocoder.VocoderTrainState(gen, floats, opt.init(gen), opt.init(floats),
                                     torch.zeros((), dtype=torch.int32)), aux, opt


class RecordingOptimizer:
    """An optimizer whose `step` keeps the gradients it is given, in order
    (the step's discriminators', then its generator's)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def step(self, grads, *args):
        self.grads.append(grads)
        return self.opt.step(grads, *args)


def _worker(device, p):
    """The step on this rank's rows, then `train_vocoder`."""
    r, n = mesh.rank(), mesh.world()
    n_use = math.gcd(TC.batch_size, n)
    group = mesh.subgroup(n_use)
    out = {"rank": r, "n_use": n_use}
    if r < n_use:
        state, aux, opt = _start(p)
        per = TC.batch_size // n_use
        batch = vocoder.to_device(vocoder.VocoderBatch(*p["batch"]), TC.batch_size, "cpu",
                                  slice(r * per, (r + 1) * per))
        rec = RecordingOptimizer(opt)
        new, m = vocoder.train_step(state, batch, aux, CFG, rec, TC, group)
        d_grads, g_grads = rec.grads
        out.update(rows=batch.wav.shape[0], metrics={k: float(v) for k, v in m.items()},
                   d_grads=_leaves(d_grads), g_grads=_leaves(g_grads),
                   gen=_leaves(new.gen_params), disc=_leaves(new.disc_floats),
                   checksum=multihost.tree_checksum(new))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        loop = vocoder.train_vocoder(CFG, TC, vocoder.synthetic_batches(CFG, TC),
                                     os.path.join(p["root"], f"dp{n}"), gen_params=p["gen"],
                                     device="cpu")
    out.update(loop_step=int(loop.step), loop_gen=_leaves(loop.gen_params),
               loop_disc=_leaves(loop.disc_floats), log=log.getvalue(),
               files=sorted(os.listdir(os.path.join(p["root"], f"dp{n}")))
               if os.path.isdir(os.path.join(p["root"], f"dp{n}")) else [])
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's train_step at batch 2 and, in the same jitted program, the
    gradients of its two losses, from numpy-filled weights."""
    import jax
    import jax.numpy as jnp

    from indextts_tpu import config as jax_config
    from indextts_tpu.models import bigvgan as jax_bigvgan
    from indextts_tpu.models import discriminators as jax_disc
    from indextts_tpu.train import vocoder as jax_vtrain
    from tests.test_torch_gpt import numpy_params

    jcfg = jax_config.BigVGANConfig(**TINY, use_fused_kernel=False)
    jtc = jax_vtrain.VocoderTrainConfig(**SMALL)
    shapes = jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(0), jcfg))
    gen_np = numpy_params(shapes, 3, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    shapes = jax.eval_shape(lambda: jax_disc.init_discriminators(
        jax.random.PRNGKey(1), periods=TC.periods, resolutions=TC.resolutions))
    disc_np = numpy_params(shapes, 5, lambda s: 1.0 / np.sqrt(np.prod(s[1:])))
    for d, period in zip(disc_np["mpd"], TC.periods):
        d["period"] = period
    for d, res in zip(disc_np["mrd"], TC.resolutions):
        d["resolution"] = tuple(res)
    jd = jax.tree.map(lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, disc_np)
    opt = jax_vtrain.make_optimizer(jtc)
    d_floats, d_aux = jax_vtrain.split_static(jd)

    # tests/test_torch_vocoder_train.py's program, statement for statement,
    # so that the persistent compile cache serves both files
    def run(gen, dfl, batch):
        state = jax_vtrain.VocoderTrainState(gen, dfl, opt.init(gen), opt.init(dfl),
                                             jnp.int32(0))
        new, metrics = jax_vtrain.train_step(state, batch, d_aux, jcfg, opt, jtc)
        gen_wav = jax_bigvgan.forward(gen, batch.latent, batch.mel_ref, jcfg)
        T = min(gen_wav.shape[-1], batch.wav.shape[-1])
        real = batch.wav[..., :T]

        def d_loss(df):
            dp = jax_vtrain.merge_static(df, d_aux)
            rs, _ = jax_disc.discriminators_forward(dp, real)
            gs, _ = jax_disc.discriminators_forward(dp, jax.lax.stop_gradient(gen_wav[..., :T]))
            return jax_disc.discriminator_loss(rs, gs)

        dp_new = jax_vtrain.merge_static(new.disc_floats, d_aux)

        def g_loss(gp):
            wav_g = jax_bigvgan.forward(gp, batch.latent, batch.mel_ref, jcfg)[..., :T]
            _, rf = jax_disc.discriminators_forward(dp_new, real)
            gs, gf = jax_disc.discriminators_forward(dp_new, wav_g)
            mel = jax_disc.multiscale_mel_loss(real[:, 0], wav_g[:, 0], scales=jtc.mel_scales)
            return (jax_disc.generator_loss(gs) + jtc.feature_weight
                    * jax_disc.feature_loss(rf, gf) + jtc.mel_weight * mel)

        return new, metrics, jax.grad(d_loss)(dfl), jax.grad(g_loss)(gen)

    batch = next(jax_vtrain.synthetic_batches(jcfg, jtc))
    new, metrics, dg, gg = jax.jit(run)(jax.tree.map(jnp.asarray, gen_np), d_floats,
                                        jax_vtrain.VocoderBatch(*(jnp.asarray(x)
                                                                  for x in batch)))
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]  # noqa: E731
    return {"payload": {"gen": gen_np, "disc": disc_np, "batch": tuple(batch),
                        "root": str(tmp_path_factory.mktemp("dp_vocoder"))},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "d_grads": leaves(dg), "g_grads": leaves(gg), "gen": leaves(new.gen_params),
            "disc": leaves(new.disc_floats)}


@pytest.fixture(scope="module")
def runs(ref):
    return multihost.run_ranks("tests.test_torch_dp_vocoder:_worker", 4, ref["payload"],
                               timeout=DEADLINE_S)


def test_synthetic_batch_is_the_jax_packages(ref):
    for got, want in zip(next(vocoder.synthetic_batches(CFG, TC)), ref["payload"]["batch"]):
        np.testing.assert_array_equal(got, want)


def test_step_over_ranks_matches_jax(runs, ref):
    """Gradients within 2e-4 of each leaf's largest magnitude plus 1e-8 of
    the tree's largest, metrics within 1e-5 relative, parameters within 2 lr
    (the single-device test's bounds); every working rank the same."""
    working = [o for o in runs if o["rank"] < o["n_use"]]
    assert len(working) == 2 and all(o["rows"] == 1 for o in working)
    for o in working:
        for k, v in ref["metrics"].items():
            assert abs(o["metrics"][k] - v) <= 1e-5 * abs(v), k
        for got, want in ((o["d_grads"], ref["d_grads"]), (o["g_grads"], ref["g_grads"])):
            assert len(got) == len(want)
            top = max(np.abs(w).max() for w in want)
            for a, w in zip(got, want):
                assert np.abs(a - w).max() <= 2e-4 * np.abs(w).max() + 1e-8 * top
        for got, want in ((o["gen"], ref["gen"]), (o["disc"], ref["disc"])):
            for a, w in zip(got, want):
                assert np.abs(a - w).max() <= 2 * TC.lr
        assert o["checksum"] == working[0]["checksum"]


def test_n_use_ranks_alone_train(runs):
    """At world 4 the batch of 2 tiles 2 ranks: the run says so on one line,
    ranks 2 and 3 take no step and return their starting state, and rank 0
    alone writes the checkpoint."""
    four = runs
    assert [o["n_use"] for o in four] == [2] * 4
    assert four[0]["log"].count("[vocoder] batch 2 on 2/4 ranks") == 1
    assert all("[vocoder]" not in o["log"] for o in four[1:])
    assert [o["loop_step"] for o in four] == [1, 1, 0, 0]
    assert all("metrics" not in o for o in four[2:])
    assert four[0]["files"] == ["vocoder_step_1"]


def test_train_vocoder_over_ranks_matches_one_process(runs, ref, tmp_path):
    """One step of train_vocoder (fresh discriminators from the seed, the
    given generator) over 4 ranks, 2 of them working, against one process
    on the same batch: parameters within 2 lr."""
    one = vocoder.train_vocoder(CFG, TC, vocoder.synthetic_batches(CFG, TC), str(tmp_path),
                                gen_params=ref["payload"]["gen"], device="cpu")
    for o in runs[:2]:
        for got, want in ((o["loop_gen"], _leaves(one.gen_params)),
                          (o["loop_disc"], _leaves(one.disc_floats))):
            assert len(got) == len(want)
            for a, w in zip(got, want):
                assert np.abs(a - w).max() <= 2 * TC.lr
