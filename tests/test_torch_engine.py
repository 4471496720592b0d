"""PyTorch port, engine: `IndexTTS.infer` against the JAX engine on the same
weights (greedy, num_beams=1 and the default beam-3), the device rule of the
entry point, and the port's independence from JAX and from the JAX
package."""

import ast
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from indextts_tpu import engine as jax_engine
from indextts_tpu.config import Config as JaxConfig
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu_torch import cli
from indextts_tpu_torch import engine as torch_engine
from tests.test_torch_gpt import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny engine of tests/test_engine.py (2 layers, width 64, 4 heads,
# BigVGAN at 64 channels)
MODEL = {
    "gpt": {"model_dim": 64, "layers": 2, "heads": 4, "max_mel_tokens": 64,
            "max_text_tokens": 120,
            "condition_module": {"output_size": 32, "linear_units": 64,
                                 "attention_heads": 4, "num_blocks": 2, "perceiver_mult": 2}},
    "bigvgan": {"upsample_rates": [4, 4, 4, 4, 2, 2],
                "upsample_kernel_sizes": [8, 8, 4, 4, 4, 4],
                "upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "speaker_embedding_dim": 8,
                "gpt_dim": 64},
}
TEXT = "今天天气很好。我们去散步吧。"
GEN = dict(num_beams=1, do_sample=False, max_mel_tokens=12,
           max_text_tokens_per_sentence=20)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A model directory with the tiny config, the vocabulary and a prompt
    wav, and one numpy-seeded float parameter set for each model."""
    d = tmp_path_factory.mktemp("model")
    cfg = JaxConfig.from_dict(MODEL)
    cfg.save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    sr = 24000
    t = np.arange(2 * sr) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    wavfile.write(str(d / "prompt.wav"), sr,
                  ((0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * noise) * 32767).astype(np.int16))
    gpt_np = numpy_params(
        jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), cfg.gpt)), 1,
        lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = numpy_params(
        jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(1), cfg.bigvgan)),
        2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    return d, gpt_np, bv_np


def build_engines(model, precision):
    """A JAX and a port engine under one precision config, both on the
    model's weights: the JAX engine through its own random-init call, the
    port through load_numpy_params."""
    d, gpt_np, bv_np = model
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(jax_uv, "init_params",
                   lambda key, c, dtype=jnp.float32: jax.tree.map(jnp.asarray, gpt_np))
        mp.setattr(jax_bigvgan, "init_params",
                   lambda key, c, dtype=jnp.float32: jax.tree.map(jnp.asarray, bv_np))
        jeng = jax_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                   is_fp16=False, precision_config=precision)
        teng = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                     device="cpu", is_fp16=False, precision_config=precision)
    teng.load_numpy_params(gpt_np, bv_np)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(model):
    jeng, teng = build_engines(model, {"gpt": "fp32", "vocoder": "fp32"})
    return jeng, teng, model[0]


def test_greedy_codes_match_jax(engines):
    jeng, teng, d = engines
    mel = teng._prompt_mel(str(d / "prompt.wav"))
    cond_np = np.asarray(jeng._conditioning(jnp.asarray(mel.numpy()), None))
    cond = torch.tensor(cond_np)
    gen = {k: v for k, v in GEN.items() if k != "max_text_tokens_per_sentence"}
    for sent in teng.tokenizer.split_sentences(teng.tokenizer.tokenize(TEXT), 20):
        ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(sent), np.int32)
        jcodes, jlens = jeng._decode_bucket(jnp.asarray(cond_np), [ids],
                                            jax.random.PRNGKey(0), dict(gen))
        tcodes, tlens, steps = teng._decode_bucket(cond, [ids], None, dict(gen))
        np.testing.assert_array_equal(tcodes, jcodes)
        np.testing.assert_array_equal(tlens, jlens)


def test_infer_wav_matches_jax(engines, tmp_path):
    jeng, teng, d = engines
    prompt = str(d / "prompt.wav")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng.infer(prompt, TEXT, str(tmp_path / "jax.wav"), **GEN)
        teng.infer(prompt, TEXT, str(tmp_path / "torch.wav"), **GEN)
    _, ref = wavfile.read(str(tmp_path / "jax.wav"))
    _, got = wavfile.read(str(tmp_path / "torch.wav"))
    assert got.dtype == ref.dtype == np.int16
    assert len(teng.last_stats["code_lens"]) == 2          # two sentences
    assert got.shape == ref.shape == (sum(teng.last_stats["code_lens"]) * 1024,)
    # fp32 on both sides; the int16 cast truncates, so a sample a hair from
    # a step boundary may land one step apart
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_default_beam_infer_matches_jax(engines, tmp_path):
    """The reference default, num_beams=3 (greedy here): the beam codes of
    each sentence equal the JAX engine's, and the wavs agree."""
    jeng, teng, d = engines
    mel = teng._prompt_mel(str(d / "prompt.wav"))
    cond_np = np.asarray(jeng._conditioning(jnp.asarray(mel.numpy()), None))
    gen = dict(do_sample=False, max_mel_tokens=12)
    for sent in teng.tokenizer.split_sentences(teng.tokenizer.tokenize(TEXT), 20):
        ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(sent), np.int32)
        jcodes, jlens = jeng._decode_bucket(jnp.asarray(cond_np), [ids],
                                            jax.random.PRNGKey(0), dict(gen))
        tcodes, tlens, steps = teng._decode_bucket(torch.tensor(cond_np), [ids], None,
                                                   dict(gen))
        np.testing.assert_array_equal(tcodes, jcodes)
        np.testing.assert_array_equal(tlens, jlens)
        assert steps >= 1
    prompt = str(d / "prompt.wav")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng.infer(prompt, TEXT, str(tmp_path / "jax.wav"), max_text_tokens_per_sentence=20,
                   **gen)
        teng.infer(prompt, TEXT, str(tmp_path / "torch.wav"), max_text_tokens_per_sentence=20,
                   **gen)
    _, ref = wavfile.read(str(tmp_path / "jax.wav"))
    _, got = wavfile.read(str(tmp_path / "torch.wav"))
    assert got.shape == ref.shape == (sum(teng.last_stats["code_lens"]) * 1024,)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 4


def test_default_infer_returns_a_wav(engines):
    """No generation arguments: beam-3 sampling, the reference default."""
    _, teng, d = engines
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sr, wav = teng.infer(str(d / "prompt.wav"), "你好。", None, seed=1)
    assert sr == 24000 and wav.dtype == np.int16
    assert wav.shape == (teng.last_stats["code_lens"][0] * 1024, 1)
    assert teng.last_stats["decode_steps"] >= 1


@pytest.mark.parametrize("option", ["infer speaker_id", "infer_fast speaker_id",
                                    "infer_stream speaker_id", "gpt_path directory"])
def test_unported_options_raise(engines, option, tmp_path, monkeypatch):
    """The options once refused: speaker_id with no prompt synthesises from
    the checkpoint's speaker data (an id the engine does not hold raises
    ValueError, as in JAX), and a gpt_path that is a directory loads the
    port's own checkpoint directory (tests/test_torch_train_run.py), so a
    directory without one raises, naming the file it lacks."""
    _, teng, d = engines
    if option == "gpt_path directory":
        with pytest.raises(FileNotFoundError, match="pytree.json"):
            torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                  device="cpu", gpt_path=str(tmp_path))
        return
    method = option.split()[0]

    def synthesise():
        if method == "infer_stream":
            return np.concatenate([c for _, c in teng.infer_stream(
                None, "你好。", speaker_id="spk", seed=1, **GEN)])
        return getattr(teng, method)(None, "你好。", None, speaker_id="spk", seed=1, **GEN)[1]

    with pytest.raises(ValueError, match="speaker_id"):
        synthesise()
    rng = np.random.default_rng(0)
    monkeypatch.setattr(teng, "speaker_conditions", {"spk": rng.standard_normal(
        (1, 32, teng.cfg.gpt.model_dim)).astype(np.float32)})
    monkeypatch.setattr(teng, "speaker_mels", {"spk": rng.standard_normal(
        (teng.cfg.bigvgan.num_mels, 120)).astype(np.float32)})
    monkeypatch.setattr(teng, "speaker_list", ["spk"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wav = synthesise()
    assert wav.dtype == np.int16 and wav.size == sum(teng.last_stats["code_lens"]) * 1024 > 0
    with pytest.raises(ValueError, match="invalid speaker_id"):
        if method == "infer_stream":
            teng.infer_stream(None, "你好。", speaker_id="other")
        else:
            getattr(teng, method)(None, "你好。", None, speaker_id="other")


def test_guided_infer_matches_jax(engines, tmp_path):
    """Classifier-free guidance through the engine (num_beams=1, cfg_scale
    2, greedy): two guided rows a sentence step through gpt2.decode_step,
    and the wav equals the JAX engine's within one int16 step."""
    jeng, teng, d = engines
    prompt = str(d / "prompt.wav")
    kw = dict(GEN, cfg_scale=2.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng.infer(prompt, TEXT, str(tmp_path / "jax.wav"), **kw)
        teng.infer(prompt, TEXT, str(tmp_path / "torch.wav"), **kw)
    _, ref = wavfile.read(str(tmp_path / "jax.wav"))
    _, got = wavfile.read(str(tmp_path / "torch.wav"))
    assert len(teng.last_stats["code_lens"]) == 2
    assert got.shape == ref.shape == (sum(teng.last_stats["code_lens"]) * 1024,)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_cli_writes_a_wav(engines, tmp_path):
    _, _, d = engines
    out = tmp_path / "cli.wav"
    args = ["你好。", "-v", str(d / "prompt.wav"), "-o", str(out), "--model_dir", str(d),
            "-d", "cpu", "--num_beams", "1", "--seed", "3"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(args) == 0
    sr, wav = wavfile.read(str(out))
    assert sr == 24000 and wav.dtype == np.int16 and wav.shape[0] % 1024 == 0
    assert cli.main(args) == 1                              # exists, no -f


def test_default_device_is_cuda_and_raises_without_it(engines):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, _, d = engines
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d))


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    """Every module of the port, found by walking the package, imported in a
    fresh interpreter: none of them loads jax, jaxlib or indextts_tpu.  The
    one import allowed to fail is serve.api's, with its ImportError naming
    FastAPI, and only while FastAPI is not installed."""
    code = ("import importlib, importlib.util, json, pkgutil, sys; before = set(sys.modules); "
            "import indextts_tpu_torch as pkg; "
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
            "failed = {}\n"
            "for n in names:\n"
            "    try:\n"
            "        importlib.import_module(n)\n"
            "    except ImportError as e:\n"
            "        failed[n] = str(e)\n"
            "new = set(sys.modules) - before; "
            "print(json.dumps({'walked': names, 'failed': failed, "
            "'fastapi': importlib.util.find_spec('fastapi') is not None, "
            "'leaked': sorted(m for m in new if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'indextts_tpu'))}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    if result["fastapi"]:
        assert result["failed"] == {}
    else:
        assert list(result["failed"]) == ["indextts_tpu_torch.serve.api"]
        assert result["failed"]["indextts_tpu_torch.serve.api"].startswith(
            "fastapi is required for the API server")
    for name in ("engine", "io.checkpoint", "serve.httpd", "train.run", "models.dvae",
                 "data.extract", "train.dvae", "models.legacy_conditioning",
                 "tools.bench_e2e", "verify", "serve.webui", "parallel.mesh",
                 "parallel.multihost", "parallel.tp", "tools.entry"):
        assert f"indextts_tpu_torch.{name}" in result["walked"], name


def _port_files():
    pkg = os.path.join(REPO, "indextts_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_module_imports_jax_or_the_jax_package():
    bad = []
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "indextts_tpu")]
    assert bad == []
