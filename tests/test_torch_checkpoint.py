"""PyTorch port, reference `.pth` checkpoints (io/checkpoint.py, io/export.py):
the converters against the JAX package's on reference-format state dicts
from the torch mirrors of tests/test_conditioning.py and tests/test_bigvgan.py,
the awkward files real checkpoints are (fp16/bf16 saves, `module.`
prefixes, nesting, extra and missing keys, speaker extras), both round trips
(JAX's exporter -> the port's loaders, the port's exporter -> JAX's
converters), and engines of both packages built from the same files: greedy
codes equal and wavs within one int16 step for a prompt, for a speaker_id
with no prompt and for the checkpoint's mean_condition.  fp32, tiny
configs, the repository's vocab."""

import dataclasses
import os
import shutil
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from indextts_tpu import engine as jax_engine
from indextts_tpu.config import Config as JaxConfig
from indextts_tpu.io import checkpoint as jax_ckpt
from indextts_tpu.io import export as jax_export
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.config import Config
from indextts_tpu_torch.io import checkpoint, export, from_jax
from tests.test_torch_engine import MODEL, REPO, TEXT
from tests.test_torch_gpt import numpy_params

GEN = dict(num_beams=1, do_sample=False, max_mel_tokens=12, max_text_tokens_per_sentence=20)


def _leaves(tree, path="params"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, (tree.detach().float().numpy() if isinstance(tree, torch.Tensor)
                     else np.asarray(tree))


def _tensor_leaves(tree, path="params"):
    if isinstance(tree, dict):
        for k in tree:
            yield from _tensor_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _tensor_leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def mirrors():
    """Reference-format state dicts from the torch mirrors (which come from
    neither package), with each package's config for them."""
    from tests.test_bigvgan import CFG as BV_CFG, ECAPA_SIZE, TorchBigVGAN
    from tests.test_conditioning import CFG as GPT_CFG, TorchUnifiedVoice

    torch.manual_seed(0)
    gpt_sd = TorchUnifiedVoice(GPT_CFG).eval().reference_state_dict()
    bv = TorchBigVGAN(BV_CFG, ECAPA_SIZE).eval()
    with torch.no_grad():
        for m in bv.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    cfg = Config.from_dict({"gpt": dataclasses.asdict(GPT_CFG),
                            "bigvgan": dataclasses.asdict(BV_CFG)})
    return dict(gpt_sd), dict(bv.state_dict()), GPT_CFG, BV_CFG, cfg.gpt, cfg.bigvgan


@pytest.mark.parametrize("model", ["gpt", "bigvgan"])
def test_converters_match_jax(mirrors, model):
    gpt_sd, bv_sd, jg, jb, tg, tb = mirrors
    if model == "gpt":
        want = jax_ckpt.convert_gpt_state_dict(dict(gpt_sd), jg)
        got = checkpoint.convert_gpt_state_dict(dict(gpt_sd), tg)
    else:
        want = jax_ckpt.convert_bigvgan_state_dict(dict(bv_sd), jb)
        got = checkpoint.convert_bigvgan_state_dict(dict(bv_sd), tb)
    assert_trees_equal(got, want)


def _save(tmp_path, name, obj):
    p = str(tmp_path / name)
    torch.save(obj, p)
    return p


AWKWARD = ["fp16 saves", "bf16 saves", "module. prefix", "nesting", "extra buffers warn",
           "known noise is silent", "missing key named", "raw tensor rejected",
           "speaker extras", "flat mean_condition_<id>", "parametrized weight norm"]


@pytest.mark.parametrize("case", AWKWARD)
def test_awkward_checkpoints(mirrors, case, tmp_path):
    """The variants real checkpoints come in load as JAX loads them (bit for
    bit) or fail with an actionable error, as tests/test_pth_adversarial.py
    holds the JAX package."""
    gpt_sd, bv_sd, jg, jb, tg, tb = mirrors
    base = checkpoint.convert_gpt_state_dict(dict(gpt_sd), tg)
    D = tg.model_dim
    cast = {"fp16 saves": torch.float16, "bf16 saves": torch.bfloat16}
    if case in cast:
        sd = {k: v.to(cast[case]) if v.is_floating_point() else v for k, v in gpt_sd.items()}
        got = checkpoint.convert_gpt_state_dict(sd, tg)
        assert_trees_equal(got, jax_ckpt.convert_gpt_state_dict(sd, jg))
        for (_, a), (_, b) in zip(_leaves(got), _leaves(base)):
            np.testing.assert_allclose(a, b, atol=2e-2, rtol=1e-2)
    elif case == "module. prefix":
        assert_trees_equal(checkpoint.convert_gpt_state_dict(
            {"module." + k: v for k, v in gpt_sd.items()}, tg), base)
    elif case == "nesting":
        for name, ckpt in [("flat.pth", dict(gpt_sd)), ("model.pth", {"model": dict(gpt_sd)}),
                           ("sdict.pth", {"state_dict": dict(gpt_sd)}),
                           ("module.pth", {"model": {"module." + k: v
                                                     for k, v in gpt_sd.items()}})]:
            got, extras = checkpoint.load_gpt_checkpoint(_save(tmp_path, name, ckpt), tg)
            assert_trees_equal(got, base)
            assert extras == {}
    elif case in ("extra buffers warn", "known noise is silent"):
        noisy = dict(gpt_sd)
        if case == "extra buffers warn":
            noisy["totally.unknown.buffer"] = torch.zeros(3)
        else:
            noisy.update({"gpt.wte.weight": torch.zeros(32, D), "gpt.wpe.weight": torch.zeros(8, D),
                          "gpt.h.0.attn.bias": torch.ones(1, 1, 8, 8),
                          "gpt.h.0.attn.masked_bias": torch.tensor(-1e4)})
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = checkpoint.convert_gpt_state_dict(noisy, tg)
        assert_trees_equal(got, base)
        msgs = [str(w.message) for w in rec if "unexpected" in str(w.message)]
        if case == "extra buffers warn":
            assert len(msgs) == 1 and "totally.unknown.buffer" in msgs[0]
        else:
            assert msgs == []
    elif case == "missing key named":
        broken = {k: v for k, v in gpt_sd.items() if k != "gpt.h.1.mlp.c_fc.weight"}
        with pytest.raises(KeyError, match="gpt.h.1.mlp.c_fc.weight") as ei:
            checkpoint.convert_gpt_state_dict(broken, tg)
        assert "UnifiedVoice" in str(ei.value)
    elif case == "raw tensor rejected":
        with pytest.raises(ValueError, match="expected a dict"):
            checkpoint.load_gpt_checkpoint(_save(tmp_path, "t.pth", torch.zeros(4)), tg)
    elif case == "speaker extras":
        p = _save(tmp_path, "spk.pth", {
            "model": dict(gpt_sd), "speakers": ["kaishu"],
            "speaker_conditions": {"kaishu": torch.randn(1, 32, D).bfloat16()},
            "speaker_mels": {"kaishu": np.ones((100, 7), np.float32)}})
        got, extras = checkpoint.load_gpt_checkpoint(p, tg)
        jgot, jextras = jax_ckpt.load_gpt_checkpoint(p, jg)
        assert_trees_equal(got, jgot)
        assert_trees_equal(extras, jextras)
        assert extras["speaker_conditions"]["kaishu"].dtype == np.float32
        assert extras["speaker_conditions"]["kaishu"].shape == (1, 32, D)
        assert extras["speakers"] == ["kaishu"]
        assert extras["speaker_mels"]["kaishu"].shape == (100, 7)
    elif case == "flat mean_condition_<id>":
        noisy = dict(gpt_sd)
        noisy["mean_condition"] = torch.randn(1, 32, D).half()
        noisy["mean_condition_spk1"] = torch.randn(1, 32, D).half()
        p = _save(tmp_path, "mc.pth", {"model": noisy})
        got, extras = checkpoint.load_gpt_checkpoint(p, tg)
        assert_trees_equal(extras, jax_ckpt.load_gpt_checkpoint(p, jg)[1])
        assert extras["mean_condition"].shape == (1, 32, D)
        assert list(extras["speaker_conditions"]) == ["spk1"]
        assert_trees_equal(got, base)
    else:  # torch.nn.utils.parametrizations.weight_norm's names for the pair
        renamed = {k.replace("weight_g", "parametrizations.weight.original0")
                   .replace("weight_v", "parametrizations.weight.original1"): v
                   for k, v in bv_sd.items()}
        assert any("original1" in k for k in renamed)
        assert_trees_equal(checkpoint.convert_bigvgan_state_dict(renamed, tb),
                           checkpoint.convert_bigvgan_state_dict(dict(bv_sd), tb))


@pytest.fixture(scope="module")
def model_trees():
    """The tiny engine's configs in both packages and one numpy-seeded float
    parameter set for each model, with speaker extras."""
    jcfg = JaxConfig.from_dict(MODEL)
    tcfg = Config.from_dict(MODEL)
    gpt_np = numpy_params(
        jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg.gpt)), 1,
        lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = numpy_params(
        jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(1), jcfg.bigvgan)),
        2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    rng = np.random.default_rng(3)
    D = jcfg.gpt.model_dim
    extras = {"speaker_conditions": {"spk": rng.standard_normal((1, 32, D)).astype(np.float32)},
              "speakers": ["spk"],
              "speaker_mels": {"spk": rng.standard_normal((100, 150)).astype(np.float32)},
              "mean_condition": rng.standard_normal((1, 32, D)).astype(np.float32)}
    return jcfg, tcfg, gpt_np, bv_np, extras


@pytest.mark.parametrize("model", ["gpt", "bigvgan"])
def test_jax_export_loads_in_the_port(model_trees, model, tmp_path):
    """JAX's save_gpt_pth / save_bigvgan_pth -> the port's loaders: the same
    trees (and speaker extras) as JAX's loaders give, bit for bit."""
    jcfg, tcfg, gpt_np, bv_np, extras = model_trees
    p = str(tmp_path / f"{model}.pth")
    if model == "gpt":
        jax_export.save_gpt_pth(p, gpt_np, jcfg.gpt, extras=extras, save_dtype="fp32")
        got, gx = checkpoint.load_gpt_checkpoint(p, tcfg.gpt)
        want, wx = jax_ckpt.load_gpt_checkpoint(p, jcfg.gpt)
        assert_trees_equal(gx, wx)
        assert_trees_equal(gx, extras)
    else:
        jax_export.save_bigvgan_pth(p, bv_np, jcfg.bigvgan)
        got = checkpoint.load_bigvgan_checkpoint(p, tcfg.bigvgan)
        want = jax_ckpt.load_bigvgan_checkpoint(p, jcfg.bigvgan)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("model", ["gpt", "bigvgan"])
def test_port_export_loads_in_jax(model_trees, model, tmp_path):
    """The port's exporter, from its own tensors -> JAX's converters: the
    state dict JAX's exporter makes and the tree JAX's own round trip gives,
    bit for bit; the source tree back exactly for the GPT, and within two
    fp32 ulps for BigVGAN, whose weight-norm fold g * v / ||v|| rounds (in
    both packages)."""
    jcfg, tcfg, gpt_np, bv_np, extras = model_trees
    p, q = str(tmp_path / f"{model}.pth"), str(tmp_path / f"{model}_jax.pth")
    if model == "gpt":
        export.save_gpt_pth(p, from_jax.gpt_params_from_numpy(gpt_np, tcfg.gpt), tcfg.gpt,
                            extras=extras, save_dtype="fp32")
        jax_export.save_gpt_pth(q, gpt_np, jcfg.gpt, extras=extras, save_dtype="fp32")
        (got, gx), (want, _) = (jax_ckpt.load_gpt_checkpoint(f, jcfg.gpt) for f in (p, q))
        assert_trees_equal(gx, extras)
        src, ref_sd = gpt_np, jax_export.export_gpt_state_dict(gpt_np, jcfg.gpt)
        sd = torch.load(p, weights_only=False)["model"]
        sd.pop("mean_condition")
    else:
        export.save_bigvgan_pth(p, from_jax.bigvgan_params_from_numpy(bv_np, tcfg.bigvgan),
                                tcfg.bigvgan)
        jax_export.save_bigvgan_pth(q, bv_np, jcfg.bigvgan)
        got, want = (jax_ckpt.load_bigvgan_checkpoint(f, jcfg.bigvgan) for f in (p, q))
        src, ref_sd = bv_np, jax_export.export_bigvgan_state_dict(bv_np, jcfg.bigvgan)
        sd = torch.load(p, weights_only=False)["generator"]
    assert_trees_equal({k: v.numpy() for k, v in sd.items()}, ref_sd)
    assert_trees_equal(got, want)
    rtol = 0 if model == "gpt" else 2.4e-7
    for (k, a), (_, b) in zip(_leaves(got), _leaves(src)):
        np.testing.assert_allclose(a, b, atol=0, rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def engines(model_trees, tmp_path_factory):
    """A model directory whose gpt.pth (with speaker data) and
    bigvgan_generator.pth the JAX exporter wrote, and an engine of each
    package built from it, fp32."""
    jcfg, _, gpt_np, bv_np, extras = model_trees
    d = tmp_path_factory.mktemp("pth_model")
    jcfg.save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    sr = 24000
    t = np.arange(2 * sr) / sr
    wavfile.write(str(d / "prompt.wav"), sr, (0.3 * np.sin(2 * np.pi * 220 * t)
                                              * 32767).astype(np.int16))
    jax_export.save_gpt_pth(str(d / "gpt.pth"), gpt_np, jcfg.gpt, extras=extras,
                            save_dtype="fp32")
    jax_export.save_bigvgan_pth(str(d / "bigvgan_generator.pth"), bv_np, jcfg.bigvgan)
    fp32 = {"gpt": "fp32", "vocoder": "fp32"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = jax_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                   is_fp16=False, precision_config=fp32)
        teng = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                     device="cpu", is_fp16=False, precision_config=fp32)
    return jeng, teng, d


def test_engine_loads_the_checkpoint_and_its_speakers(engines, model_trees):
    jeng, teng, _ = engines
    _, _, gpt_np, _, extras = model_trees
    assert teng.speaker_list == jeng.speaker_list == ["spk"]
    assert_trees_equal(teng.gpt_params, gpt_np)
    # row-major like the engine's own weights: the converters' transposed
    # views would otherwise reach the products as strided tensors
    for tree in (teng.gpt_params, teng.bigvgan_params):
        for path, leaf in _tensor_leaves(tree):
            assert leaf.is_contiguous(), path
    assert_trees_equal({"c": teng.speaker_conditions, "m": teng.speaker_mels,
                        "mean": teng.mean_condition},
                       {"c": extras["speaker_conditions"], "m": extras["speaker_mels"],
                        "mean": extras["mean_condition"]})


@pytest.mark.parametrize("source", ["prompt", "speaker_id", "mean_condition"])
def test_engines_from_the_same_files_agree(engines, source, tmp_path):
    """Greedy codes equal, and wavs within one int16 step (the cast
    truncates), for a prompt, for speaker_id with no prompt (the stored
    condition and mel), and for the checkpoint's mean_condition (the
    conditioning when neither is given; vocoded with the speaker's mel)."""
    jeng, teng, d = engines
    prompt = str(d / "prompt.wav") if source == "prompt" else None
    speaker = "spk" if source == "speaker_id" else None
    mel = teng._prompt_mel(prompt) if prompt else None
    tcond = teng._conditioning(mel, speaker)
    jcond = jeng._conditioning(None if mel is None else jnp.asarray(mel.numpy()), speaker)
    np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), atol=1e-5, rtol=0)
    gen = {k: v for k, v in GEN.items() if k != "max_text_tokens_per_sentence"}
    id_lists = [np.asarray(teng.tokenizer.convert_tokens_to_ids(s), np.int32) for s in
                teng.tokenizer.split_sentences(teng.tokenizer.tokenize(TEXT), 20)]
    for ids in id_lists:
        jcodes, jlens = jeng._decode_bucket(jcond, [ids], jax.random.PRNGKey(0), dict(gen))
        tcodes, tlens, _ = teng._decode_bucket(tcond, [ids], None, dict(gen))
        np.testing.assert_array_equal(tcodes, jcodes)
        np.testing.assert_array_equal(tlens, jlens)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if source == "mean_condition":   # no synthesis entry takes neither prompt nor speaker
            codes, lens, _ = teng._decode_bucket(tcond, id_lists[:1], None, dict(gen))
            got = teng._codes_to_wav(tcond, teng._mel_ref(None, "spk"), id_lists[:1], codes, lens)
            jc, jl = jeng._decode_bucket(jcond, id_lists[:1], jax.random.PRNGKey(0), dict(gen))
            ref = np.asarray(jeng._codes_to_wav(jcond, jeng._mel_ref(None, "spk"), id_lists[:1],
                                                jc, jl))
        else:
            jeng.infer(prompt, TEXT, str(tmp_path / "jax.wav"), speaker_id=speaker, **GEN)
            teng.infer(prompt, TEXT, str(tmp_path / "torch.wav"), speaker_id=speaker, **GEN)
            ref = wavfile.read(str(tmp_path / "jax.wav"))[1]
            got = wavfile.read(str(tmp_path / "torch.wav"))[1]
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_speaker_info_json_names_the_speakers(engines, model_trees, tmp_path):
    """`speaker_info_path`: its speakers are the ones requests may name, and
    a speaker's medoid_mel.npy beside the file becomes its vocoder mel (the
    checkpoint's own speaker_mels win), as in the JAX engine."""
    _, _, d = engines
    mel = np.random.default_rng(5).standard_normal((100, 40)).astype(np.float32)
    (tmp_path / "other").mkdir()
    np.save(tmp_path / "other" / "medoid_mel.npy", mel)
    info = tmp_path / "speaker_info.json"
    info.write_text('[{"speaker": "spk"}, {"speaker": "other"}, {"count": 3}]')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                    device="cpu", speaker_info_path=str(info))
    assert eng.speaker_list == ["spk", "other"]
    np.testing.assert_array_equal(eng.speaker_mels["other"], mel)
    np.testing.assert_array_equal(eng.speaker_mels["spk"],
                                  model_trees[4]["speaker_mels"]["spk"])
    with pytest.raises(ValueError, match="invalid speaker_id"):
        eng.infer(None, "你好。", None, speaker_id="nobody")
