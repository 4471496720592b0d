"""PyTorch port, vocoder fine-tuning (train/vocoder.py, models/discriminators.py,
train/optim.py's schedule and betas, utils/eval_metrics.py) against the
JAX package on the same weights, carried across by io/from_jax: each
discriminator, the STFT magnitude and each loss; one GAN step's gradients,
the optimizer on equal gradients and the whole step against JAX's
`train_step` (one jitted JAX program); `latent_batches`' crops on a tiny
extraction layout; AdamW bit-equal for the LoRA and DVAE trainers after its
generalisation; the loop, its checkpoint and `main` on the CPU.  The tiny
config of tests/test_vocoder_train.py: upsample [2, 2], 8 channels, period
(2,), resolution (128, 32, 64), mel scale (256, 64)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from indextts_tpu import config as jax_config
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import discriminators as jax_disc
from indextts_tpu.train import vocoder as jax_vtrain
from indextts_tpu.utils import eval_metrics as jax_eval
from indextts_tpu_torch.config import BigVGANConfig, Config, GPTConfig
from indextts_tpu_torch.io import checkpoint as ckpt_io
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import bigvgan
from indextts_tpu_torch.models import discriminators as disc
from indextts_tpu_torch.train import optim, vocoder
from indextts_tpu_torch.train.lora import tree_map
from indextts_tpu_torch.utils import eval_metrics
from indextts_tpu_torch.utils.audio import write_wav
from tests.test_torch_gpt import TINY as GPT_TINY, gpt_numpy_params, numpy_params

TINY = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=8,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
            speaker_embedding_dim=8, gpt_dim=16)
CFG = BigVGANConfig(**TINY)
JCFG = jax_config.BigVGANConfig(**TINY, use_fused_kernel=False)
SMALL = dict(batch_size=2, segment_codes=16, periods=(2,), resolutions=((128, 32, 64),),
             mel_scales=((256, 64),), lr=1e-5, steps=2, log_every=1, checkpoint_every=0)
TC = vocoder.VocoderTrainConfig(**SMALL)
JTC = jax_vtrain.VocoderTrainConfig(**SMALL)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ws():
    shapes = jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(0), JCFG))
    gen_np = numpy_params(shapes, 3, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    # JAX's layout filled from numpy (its eager init would compile op by op)
    shapes = jax.eval_shape(lambda: jax_disc.init_discriminators(
        jax.random.PRNGKey(1), periods=TC.periods, resolutions=TC.resolutions))
    disc_np = numpy_params(shapes, 5, lambda s: 1.0 / np.sqrt(np.prod(s[1:])))
    for d, period in zip(disc_np["mpd"], TC.periods):
        d["period"] = period
    for d, res in zip(disc_np["mrd"], TC.resolutions):
        d["resolution"] = tuple(res)
    jd = jax.tree.map(lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, disc_np)
    jbatch = next(jax_vtrain.synthetic_batches(JCFG, JTC))
    batch = next(vocoder.synthetic_batches(CFG, TC))
    return dict(gen_np=gen_np, jd=jd, disc_np=disc_np, jbatch=jbatch, batch=batch,
                tgen=from_jax.bigvgan_params_from_numpy(gen_np, CFG),
                tdisc=from_jax.discriminator_params_from_numpy(disc_np, TC.periods,
                                                               TC.resolutions))


def test_synthetic_batches_equal_jax(ws):
    for got, ref in zip(ws["batch"], ws["jbatch"]):
        np.testing.assert_array_equal(got, ref)


def _wav(T, seed=0):
    return np.tanh(np.random.default_rng(seed).standard_normal((2, 1, T))).astype(np.float32)


@pytest.mark.parametrize("T", [64, 67])
def test_discriminators_match_jax(ws, T):
    """Scores and every feature map of each sub-discriminator; T = 67 takes
    the period's reflect pad.  fp32 convolutions: 1e-5 of each largest
    magnitude."""
    wav = _wav(T)
    ref_s, ref_f = jax_disc.discriminators_forward(ws["jd"], jnp.asarray(wav))
    got_s, got_f = disc.discriminators_forward(ws["tdisc"], torch.from_numpy(wav))
    assert len(got_s) == len(ref_s) == 2
    for gs, rs in zip(got_s, ref_s):
        assert gs.shape == rs.shape and _rel(gs.numpy(), rs) < 1e-5
    for gf, rf in zip(got_f, ref_f):
        assert len(gf) == len(rf) == 6
        for a, b in zip(gf, rf):
            assert a.shape == b.shape and _rel(a.numpy(), b) < 1e-5


@pytest.mark.parametrize("T,res", [(64, (128, 32, 64)), (40, (128, 32, 64)),
                                   (20, (128, 32, 64)), (1000, (512, 50, 240))])
def test_stft_mag_matches_jax(T, res):
    """T = 40 is shorter than n_fft after the pad (one frame, zero-extended);
    T = 20 is no longer than the pad itself (zero-extended before it)."""
    x = _wav(T, T)[:, 0]
    ref = np.asarray(jax_disc._stft_mag(jnp.asarray(x), *res))
    got = disc._stft_mag(torch.from_numpy(x), *res).numpy()
    assert got.shape == ref.shape and ref.shape[-1] >= 1
    assert _rel(got, ref) < 1e-5


def test_losses_match_jax(ws):
    """feature, discriminator and generator losses, and the multiscale mel
    L1 on a 64-sample crop framed at n_fft 256 (the reflect pad is longer
    than the signal) and at the recipe's scales.  fp32: 1e-5 relative."""
    real, gen = _wav(64, 1), _wav(64, 2)
    jr = jax_disc.discriminators_forward(ws["jd"], jnp.asarray(real))
    jg = jax_disc.discriminators_forward(ws["jd"], jnp.asarray(gen))
    tr = disc.discriminators_forward(ws["tdisc"], torch.from_numpy(real))
    tg = disc.discriminators_forward(ws["tdisc"], torch.from_numpy(gen))
    pairs = [(disc.feature_loss(tr[1], tg[1]), jax_disc.feature_loss(jr[1], jg[1])),
             (disc.discriminator_loss(tr[0], tg[0]), jax_disc.discriminator_loss(jr[0], jg[0])),
             (disc.generator_loss(tg[0]), jax_disc.generator_loss(jg[0]))]
    for scales in (((256, 64),), ((512, 128), (1024, 256), (2048, 512))):
        pairs.append((disc.multiscale_mel_loss(torch.from_numpy(real[:, 0]),
                                               torch.from_numpy(gen[:, 0]), scales=scales),
                      jax_disc.multiscale_mel_loss(jnp.asarray(real[:, 0]),
                                                   jnp.asarray(gen[:, 0]), scales=scales)))
    for got, ref in pairs:
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))


def test_discriminator_tree_interop(ws):
    """The structural ints survive the carry and the float split; a tree for
    another period is refused."""
    tdisc = ws["tdisc"]
    assert tdisc["mpd"][0]["period"] == 2 and tdisc["mrd"][0]["resolution"] == (128, 32, 64)
    assert tdisc["mpd"][0]["convs"][0]["w"].is_contiguous()
    floats, aux = vocoder.split_static(tdisc)
    jfloats, _ = jax_vtrain.split_static(ws["jd"])
    assert len(floats) == len(jfloats)
    for a, b in zip(floats, jfloats):
        np.testing.assert_array_equal(a.numpy(), b)
    merged = vocoder.merge_static(floats, aux)
    assert merged["mpd"][0]["period"] == 2 and merged["mrd"][0]["resolution"] == (128, 32, 64)
    with pytest.raises(ValueError, match="period"):
        from_jax.discriminator_params_from_numpy(ws["disc_np"], (3,), TC.resolutions)


@pytest.fixture(scope="module")
def jax_step(ws):
    """JAX's train_step at lr 1e-5 and, in the same jitted program, the
    gradients of its two losses (the discriminator's at the start, the
    generator's against the updated discriminators)."""
    opt = jax_vtrain.make_optimizer(JTC)
    d_floats, d_aux = jax_vtrain.split_static(ws["jd"])
    gen = jax.tree.map(jnp.asarray, ws["gen_np"])

    def run(gen, dfl, batch):
        state = jax_vtrain.VocoderTrainState(gen, dfl, opt.init(gen), opt.init(dfl),
                                             jnp.int32(0))
        new, metrics = jax_vtrain.train_step(state, batch, d_aux, JCFG, opt, JTC)
        gen_wav = jax_bigvgan.forward(gen, batch.latent, batch.mel_ref, JCFG)
        T = min(gen_wav.shape[-1], batch.wav.shape[-1])
        real = batch.wav[..., :T]

        def d_loss(df):
            dp = jax_vtrain.merge_static(df, d_aux)
            rs, _ = jax_disc.discriminators_forward(dp, real)
            gs, _ = jax_disc.discriminators_forward(dp, jax.lax.stop_gradient(gen_wav[..., :T]))
            return jax_disc.discriminator_loss(rs, gs)

        dp_new = jax_vtrain.merge_static(new.disc_floats, d_aux)

        def g_loss(gp):
            wav_g = jax_bigvgan.forward(gp, batch.latent, batch.mel_ref, JCFG)[..., :T]
            _, rf = jax_disc.discriminators_forward(dp_new, real)
            gs, gf = jax_disc.discriminators_forward(dp_new, wav_g)
            mel = jax_disc.multiscale_mel_loss(real[:, 0], wav_g[:, 0], scales=JTC.mel_scales)
            return (jax_disc.generator_loss(gs) + JTC.feature_weight
                    * jax_disc.feature_loss(rf, gf) + JTC.mel_weight * mel)

        return new, metrics, jax.grad(d_loss)(dfl), jax.grad(g_loss)(gen)

    batch = jax_vtrain.VocoderBatch(*(jnp.asarray(x) for x in ws["jbatch"]))
    new, metrics, dg, gg = jax.jit(run)(gen, d_floats, batch)
    return dict(new=_tree_np(new), metrics={k: float(v) for k, v in metrics.items()},
                d_grads=_tree_np(dg), g_grads=_tree_np(gg))


def _leaves(tree):
    return [np.asarray(x) for x in optim.tree_leaves(tree)]


def test_train_step_gradients_match_jax(ws, jax_step):
    """Both losses' gradients, every leaf, the generator's through the
    autograd function of each activation: within 2e-4 of each leaf's
    largest magnitude (fp32 through a GAN, a log-mel and ECAPA's deepest
    res2net branch; most leaves agree to 5e-5), plus 1e-8 of the tree's
    largest gradient for a leaf whose gradient is zero in exact arithmetic
    and rounding noise in both (ECAPA's attention bias, added before a
    softmax over time)."""
    b = vocoder.to_device(ws["batch"], TC.batch_size, "cpu")
    floats, aux = vocoder.split_static(ws["tdisc"])
    gen = tree_map(lambda p: p.clone().requires_grad_(True), ws["tgen"])
    wav_g = bigvgan.forward(gen, b.latent, b.mel_ref, CFG)
    T = min(wav_g.shape[-1], b.wav.shape[-1])
    wav_g, real = wav_g[..., :T], b.wav[..., :T]
    d_leaves = [p.clone().requires_grad_(True) for p in floats]
    dp = vocoder.merge_static(d_leaves, aux)
    ld = disc.discriminator_loss(disc.discriminators_forward(dp, real)[0],
                                 disc.discriminators_forward(dp, wav_g.detach())[0])
    d_grads = vocoder._grads(ld, d_leaves)
    dp_new = vocoder.merge_static([_t(x) for x in jax_step["new"].disc_floats], aux)
    _, rf = disc.discriminators_forward(dp_new, real)
    gs, gf = disc.discriminators_forward(dp_new, wav_g)
    lg = (disc.generator_loss(gs) + TC.feature_weight * disc.feature_loss(rf, gf)
          + TC.mel_weight * disc.multiscale_mel_loss(real[:, 0], wav_g[:, 0],
                                                     scales=TC.mel_scales))
    g_grads = vocoder._grads(lg, gen)
    for got, ref in ((d_grads, jax_step["d_grads"]), (g_grads, jax_step["g_grads"])):
        got, ref = _leaves(got), _leaves(ref)
        assert len(got) == len(ref)
        top = max(np.abs(r).max() for r in ref)
        for a, r in zip(got, ref):
            assert a.shape == r.shape
            assert np.abs(a - r).max() <= 2e-4 * np.abs(r).max() + 1e-8 * top


def test_optimizer_on_equal_gradients_matches_optax(ws, jax_step):
    """JAX's gradients through the port's AdamW (clip 1000, b1 0.8, b2 0.99,
    exponential decay) give JAX's updated parameters: within one fp32 ulp
    of each parameter's magnitude."""
    opt = vocoder.make_optimizer(TC)
    for params, grads, ref in (
            (ws["tgen"], jax_step["g_grads"], jax_step["new"].gen_params),
            (vocoder.split_static(ws["tdisc"])[0], jax_step["d_grads"],
             jax_step["new"].disc_floats)):
        g = _unflatten_like(params, [_t(x) for x in _leaves(grads)])
        new, state = opt.step(g, opt.init(params), params)
        assert int(state["count"]) == 1
        for a, r in zip(_leaves(new), _leaves(ref)):
            assert np.abs(a - r).max() <= 1.2e-7 * max(np.abs(r).max(), 1.0)


def _unflatten_like(tree, leaves):
    return vocoder._unflatten(tree, leaves)


def test_exponential_decay_matches_optax():
    sched = optax.exponential_decay(1e-4, 1, 0.999)
    ours = optim.exponential_decay(1e-4, 1, 0.999)
    for c in (0, 1, 2, 7, 1000, 123456):
        got = float(ours(torch.tensor(c, dtype=torch.int32)))
        ref = float(sched(jnp.int32(c)))
        assert abs(got - ref) <= 2e-7 * ref


def test_train_step_matches_jax(ws, jax_step):
    """The port's whole step against JAX's at lr 1e-5: metrics within 1e-5
    relative; parameters within 2 lr (Adam lifts a near-zero gradient's
    last-bit difference to about lr, so the bound is the rate itself);
    and every leaf of both networks moved."""
    opt = vocoder.make_optimizer(TC)
    floats, aux = vocoder.split_static(ws["tdisc"])
    state = vocoder.VocoderTrainState(ws["tgen"], floats, opt.init(ws["tgen"]),
                                      opt.init(floats), torch.zeros((), dtype=torch.int32))
    new, metrics = vocoder.train_step(state, vocoder.to_device(ws["batch"], 2, "cpu"), aux,
                                      CFG, opt, TC)
    assert int(new.step) == 1
    for k, v in jax_step["metrics"].items():
        assert abs(float(metrics[k]) - v) <= 1e-5 * abs(v), k
    ref = jax_step["new"]
    for got, want, start in ((new.gen_params, ref.gen_params, ws["tgen"]),
                             (new.disc_floats, ref.disc_floats, state.disc_floats)):
        for a, r, s in zip(_leaves(got), _leaves(want), _leaves(start)):
            assert np.abs(a - r).max() <= 2 * TC.lr
            assert np.abs(a - s).max() > 0


def _old_adamw_step(opt, grads, state, params):
    """AdamW's update as written before its b1, b2 and schedule became
    arguments (optax's defaults as module constants, warmup-cosine)."""
    norm = optim.global_norm(grads)
    keep = norm < opt.max_grad_norm
    grads = tree_map(lambda g: torch.where(keep, g, (g / norm) * opt.max_grad_norm), grads)
    count = state["count"]
    count_inc = count + 1
    one = torch.ones((), dtype=torch.float32)
    bc1 = 1 - (one * 0.9) ** count_inc.float()
    bc2 = 1 - (one * 0.999) ** count_inc.float()
    lr = optim.warmup_cosine(count, opt.lr, opt.warmup, opt.decay_steps)

    def leaf(g, mu, nu, p):
        m = (1 - 0.9) * g + 0.9 * mu
        v = (1 - 0.999) * (g * g) + 0.999 * nu
        u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        return p + (-lr) * (u + opt.weight_decay * p)

    return tree_map(leaf, grads, state["mu"], state["nu"], params)


@pytest.mark.parametrize("which", ["dvae", "lora"])
def test_adamw_bit_equal_after_generalisation(which):
    """The DVAE trainer's AdamW and LoRA+'s `a` group update bit for bit as
    before the generalisation, over three steps with the clip firing."""
    from indextts_tpu_torch.config import TrainConfig
    from indextts_tpu_torch.train import dvae as dvae_train

    rng = np.random.default_rng(0)
    params = {"a": _t(rng.standard_normal((3, 4))), "b": _t(rng.standard_normal(5))}
    if which == "dvae":
        opt = dvae_train.make_optimizer(dvae_train.DVAETrainConfig(lr=1e-2, warmup_steps=2,
                                                                   steps=6))
    else:
        opt = optim.LoRAPlusAdamW(TrainConfig(), 6)
        params = {"q": {"a": params["a"], "b": params["b"]}}
    state = opt.init(params)
    for step in range(3):
        grads = tree_map(lambda p: _t(3 * rng.standard_normal(p.shape)), params)
        new, state2 = opt.step(grads, state, params)
        old = _old_adamw_step(opt, grads, state, params)
        if which == "lora":   # the `b` group runs at its own peak rate
            new, old = new["q"]["a"], old["q"]["a"]
        for a, b in zip(optim.tree_leaves(new), optim.tree_leaves(old)):
            assert torch.equal(a, b), step
        params = opt.step(grads, state, params)[0]
        state = state2


def test_train_vocoder_loop_and_checkpoint(tmp_path):
    """Two steps of the loop on the CPU: both networks move and stay finite,
    and the checkpoint directory keeps the structural ints."""
    tc = vocoder.VocoderTrainConfig(**{**SMALL, "lr": 1e-4})
    opt = vocoder.make_optimizer(tc)
    init, _ = vocoder.init_state(torch.Generator().manual_seed(tc.seed), CFG, opt,
                                 periods=tc.periods, resolutions=tc.resolutions)
    state = vocoder.train_vocoder(CFG, tc, vocoder.synthetic_batches(CFG, tc),
                                  str(tmp_path / "out"), device="cpu")
    assert int(state.step) == 2
    for got, start in ((state.gen_params, init.gen_params),
                       (state.disc_floats, init.disc_floats)):
        moved = [float((a - b).abs().max()) for a, b in zip(optim.tree_leaves(got),
                                                            optim.tree_leaves(start))]
        assert max(moved) > 0
        assert all(bool(torch.isfinite(a).all()) for a in optim.tree_leaves(got))
    ck = ckpt_io.load_pytree(str(tmp_path / "out" / "vocoder_step_2"))
    assert ck["step"] == 2
    assert ck["disc_params"]["mpd"][0]["period"] == 2
    assert ck["disc_params"]["mrd"][0]["resolution"] == (128, 32, 64)
    for a, b in zip(optim.tree_leaves(ck["gen_params"]), optim.tree_leaves(state.gen_params)):
        assert torch.equal(a, b)


def test_main_synthetic_on_cpu(tmp_path):
    """`python -m indextts_tpu_torch.train.vocoder --synthetic --device cpu`
    on a tiny config.yaml, at the recipe's discriminators and mel scales."""
    Config.from_dict({"bigvgan": TINY}).save(str(tmp_path / "config.yaml"))
    vocoder.main(["--synthetic", "--device", "cpu", "--model_dir", str(tmp_path),
                  "--steps", "1", "--batch", "1", "--segment-codes", "16",
                  "--out", str(tmp_path / "out")])
    ck = ckpt_io.load_pytree(str(tmp_path / "out" / "vocoder_step_1"))
    assert [d["period"] for d in ck["disc_params"]["mpd"]] == [2, 3, 5, 7, 11]


class _Tokenizer:
    """The two packages' latent_batches take any object with `encode`."""

    def encode(self, text):
        return [1 + ord(c) % 30 for c in text]


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """A tiny extraction layout: 2 speakers, 2 train records each (20-40
    codes, audio at 24 kHz), a medoid conditioning and a medoid mel, the
    second speaker's shorter than the reference window."""
    root = tmp_path_factory.mktemp("processed")
    rng = np.random.default_rng(0)
    info = []
    for s, name in enumerate(("spk_a", "spk_b")):
        d = root / name
        (d / "codes").mkdir(parents=True)
        np.save(d / "medoid_condition.npy",
                rng.standard_normal((1, 32, GPT_TINY["model_dim"])).astype(np.float32))
        np.save(d / "medoid_mel.npy", rng.standard_normal((100, 300 - 200 * s)).astype(np.float32))
        lines = []
        for i, n in enumerate((20 + 7 * s, 33 + s)):
            np.save(d / "codes" / f"c{i}.npy", rng.integers(0, 40, n).astype(np.int32))
            wav = (0.3 * rng.standard_normal(n * 1024 - 300 * i) * 32767).astype(np.int16)
            write_wav(str(d / f"c{i}.wav"), wav, 24000)
            lines.append(json.dumps({"audio": f"c{i}.wav", "codes": f"codes/c{i}.npy",
                                     "text": f"text {s} {i} " * (1 + i)}))
        (d / "metadata_train.jsonl").write_text("\n".join(lines) + "\n")
        info.append({"speaker": name})
    (root / "speaker_info.json").write_text(json.dumps(info))
    return str(root)


def test_latent_batches_match_jax(processed):
    """The same crops in the same order (wav and mel_ref equal), and the
    latents of JAX's re-forward within 1e-5 (fp32 GPT)."""
    gpt_np = gpt_numpy_params(jax_config.GPTConfig.from_dict(GPT_TINY), seed=4)
    jcfg = jax_config.GPTConfig.from_dict(GPT_TINY)
    tcfg = GPTConfig.from_dict(GPT_TINY)
    kw = dict(batch_size=3, segment_codes=8, seed=5)
    ref = jax_vtrain.latent_batches(processed, jax.tree.map(jnp.asarray, gpt_np), jcfg,
                                    _Tokenizer(), jax_vtrain.VocoderTrainConfig(**kw))
    got = vocoder.latent_batches(processed, from_jax.gpt_params_from_numpy(gpt_np, tcfg),
                                 tcfg, _Tokenizer(), vocoder.VocoderTrainConfig(**kw))
    for _ in range(3):
        g, r = next(got), next(ref)
        assert g.latent.shape == r.latent.shape == (3, 8, GPT_TINY["model_dim"])
        np.testing.assert_array_equal(g.wav, r.wav)
        np.testing.assert_array_equal(g.mel_ref, r.mel_ref)
        np.testing.assert_allclose(g.latent, r.latent, atol=1e-5, rtol=0)


def test_eval_metrics_match_jax(ws):
    """Speaker embedding and similarity on the tiny generator's ECAPA
    (fp32: 1e-5 of the embedding's largest magnitude, 1e-5 on the cosine);
    WER and CER exactly."""
    rng = np.random.default_rng(2)
    a = (0.3 * rng.standard_normal(6000)).astype(np.float32)
    b = (0.3 * rng.standard_normal((2, 6000))).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, ws["gen_np"])
    ref = jax_eval.speaker_embedding(jp, a)
    got = eval_metrics.speaker_embedding(ws["tgen"], a)
    assert got.shape == ref.shape == (8,) and _rel(got, ref) < 1e-5
    assert abs(eval_metrics.speaker_similarity(ws["tgen"], a, b)
               - jax_eval.speaker_similarity(jp, a, b)) < 1e-5
    for r, h in (("the cat sat on the mat", "the cat sat mat"), ("", ""), ("", "x"),
                 ("今天 天气", "今天天 汽 好"), ("a b c", "c b a")):
        assert eval_metrics.wer(r, h) == jax_eval.wer(r, h)
        assert eval_metrics.cer(r, h) == jax_eval.cer(r, h)
