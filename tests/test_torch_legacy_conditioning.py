"""PyTorch port, every conditioning type of the JAX package: the legacy
encoders (models/legacy_conditioning.py: condition_type "perceiver" and the
mean-pooled default) and "conformer_encoder" (the conformer -> perceiver
path, which the port refused before).  For each type: the port's
`init_params` layout against JAX's, `get_conditioning` against JAX's on
the same numpy-seeded weights, the gpt.pth converter on a reference-named
state dict and the exporters in both directions; for "perceiver", an
engine's greedy codes and wav against the JAX engine's.  Tiny config (2
layers, width 64, 4 heads), fp32, on the CPU."""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from indextts_tpu.config import Config as JaxConfig
from indextts_tpu.config import ConditionModuleConfig as JaxCondConfig
from indextts_tpu.config import GPTConfig as JaxGPTConfig
from indextts_tpu.io import checkpoint as jax_ckpt
from indextts_tpu.io import export as jax_export
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
from indextts_tpu_torch.io import checkpoint, export, from_jax
from indextts_tpu_torch.models import unified_voice as uv
from tests.test_torch_engine import GEN, MODEL, TEXT, build_engines
from tests.test_torch_gpt import numpy_params

TYPES = ["perceiver", "default_mean", "conformer_encoder", "conformer_perceiver"]
SIZES = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=48, max_text_tokens=30,
             number_text_tokens=40, number_mel_codes=50, start_mel_token=46, stop_mel_token=47)
COND = dict(output_size=32, linear_units=64, attention_heads=4, num_blocks=2, perceiver_mult=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(condition_type):
    return (JaxGPTConfig(**SIZES, condition_type=condition_type,
                         condition_module=JaxCondConfig(**COND)),
            GPTConfig(**SIZES, condition_type=condition_type,
                      condition_module=ConditionModuleConfig(**COND)))


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


@pytest.fixture(scope="module", params=TYPES)
def model(request):
    jcfg, cfg = configs(request.param)
    shapes = jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg))
    tree = numpy_params(shapes, 3, lambda s: 1.0 / np.sqrt(s[-2]))
    return dict(type=request.param, jcfg=jcfg, cfg=cfg, shapes=shapes, np=tree)


def test_init_params_layout_matches_jax(model):
    got = uv.init_params(model["cfg"], torch.Generator().manual_seed(0))
    assert _shapes(got) == _shapes(model["shapes"])
    assert all(v.dtype == torch.float32 for v in jax.tree.leaves(got))


def test_get_conditioning_matches_jax(model):
    mel = np.random.default_rng(4).standard_normal((2, 100, 37)).astype(np.float32)
    lens = np.array([37, 30], np.int32)
    ref = np.asarray(jax_uv.get_conditioning(jax.tree.map(jnp.asarray, model["np"]),
                                             model["jcfg"], jnp.asarray(mel), jnp.asarray(lens)))
    params = from_jax.gpt_params_from_numpy(model["np"], model["cfg"])
    got = uv.get_conditioning(params, model["cfg"], torch.from_numpy(mel),
                              torch.from_numpy(lens)).numpy()
    latents = 1 if model["type"] == "default_mean" else 32
    assert got.shape == ref.shape == (2, latents, 64)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 1e-5 * scale


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gpt_pth_crosses_bit_equal(model, tmp_path, direction):
    path = str(tmp_path / "gpt.pth")
    if direction == "jax_to_port":
        jax_export.save_gpt_pth(path, model["np"], model["jcfg"], save_dtype="fp32")
        tree, _ = checkpoint.load_gpt_checkpoint(path, model["cfg"])
    else:
        export.save_gpt_pth(path, model["np"], model["cfg"], save_dtype="fp32")
        tree, _ = jax_ckpt.load_gpt_checkpoint(path, model["jcfg"])
    want = jax.tree.leaves_with_path(model["np"])
    got = dict(jax.tree.leaves_with_path(tree))
    assert len(got) == len(want)
    for p, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf, err_msg=jax.tree_util.keystr(p))
    from_jax.gpt_params_from_numpy(tree, model["cfg"])


@pytest.mark.parametrize("condition_type", ["perceiver", "default_mean"])
def test_converter_matches_jax_on_reference_names(condition_type):
    """The reference modules' own conditioning state dict (the torch mirrors
    of tests/test_legacy_conditioning_oracle.py, whose perceiver's context
    projection is nn.Identity, so it has no keys) beside reference-named
    trunk, embedding and head tensors, through both converters."""
    from tests.test_legacy_conditioning_oracle import TorchLegacyCondEncoder, TorchLegacyPerceiver

    jcfg, cfg = configs(condition_type)
    shapes = jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export.export_gpt_state_dict(numpy_params(shapes, 5, lambda s: 0.1), cfg).items()
          if not k.startswith(("conditioning_encoder.", "perceiver_encoder."))}
    torch.manual_seed(0)
    mirrors = {"conditioning_encoder.": TorchLegacyCondEncoder(100, 64, heads=4)}
    if condition_type == "perceiver":
        mirrors["perceiver_encoder."] = TorchLegacyPerceiver(64)
    for prefix, m in mirrors.items():
        sd.update({prefix + k: v for k, v in m.state_dict().items()})
    want = jax_ckpt.convert_gpt_state_dict(sd, jcfg)
    got = checkpoint.convert_gpt_state_dict(sd, cfg)
    assert _shapes(got) == _shapes(want)
    if condition_type == "perceiver":     # nn.Identity became an eye kernel
        np.testing.assert_array_equal(got["perceiver_encoder"]["proj_context"]["kernel"],
                                      np.eye(64, dtype=np.float32))
    for (p, a), (_, b) in zip(jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


@pytest.fixture(scope="module")
def perceiver_engines(tmp_path_factory):
    """The engine test's tiny model with condition_type "perceiver"."""
    d = tmp_path_factory.mktemp("perceiver_model")
    spec = {**MODEL, "gpt": {**MODEL["gpt"], "condition_type": "perceiver"}}
    cfg = JaxConfig.from_dict(spec)
    cfg.save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    sr = 24000
    t = np.arange(2 * sr) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    wavfile.write(str(d / "prompt.wav"), sr,
                  ((0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * noise) * 32767).astype(np.int16))
    gpt_np = numpy_params(jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0),
                                                                    cfg.gpt)),
                          1, lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = numpy_params(jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(1),
                                                                        cfg.bigvgan)),
                         2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    jeng, teng = build_engines((d, gpt_np, bv_np), {"gpt": "fp32", "vocoder": "fp32"})
    return jeng, teng, d


def test_perceiver_engine_greedy_codes_match_jax(perceiver_engines, tmp_path):
    jeng, teng, d = perceiver_engines
    prompt = str(d / "prompt.wav")
    text = TEXT.split("。")[0] + "。"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng.infer(prompt, text, str(tmp_path / "torch.wav"), **GEN)
        jeng.infer(prompt, text, str(tmp_path / "jax.wav"), **GEN)
    mel = teng._prompt_mel(prompt)
    cond = np.asarray(jeng._conditioning(jnp.asarray(mel.numpy()), None))
    assert cond.shape == (1, 32, 64)
    assert np.abs(teng._conditioning(mel, None).numpy() - cond).max() <= 1e-5 * np.abs(cond).max()
    sent = teng.tokenizer.split_sentences(teng.tokenizer.tokenize(text), 20)[0]
    ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(sent), np.int32)
    gen = {k: v for k, v in GEN.items() if k != "max_text_tokens_per_sentence"}
    jcodes, jlens = jeng._decode_bucket(jnp.asarray(cond), [ids], jax.random.PRNGKey(0), gen)
    codes = teng.last_stats["codes"][0]
    np.testing.assert_array_equal(codes, np.asarray(jcodes)[0, : int(jlens[0])])
    _, ref = wavfile.read(str(tmp_path / "jax.wav"))
    _, got = wavfile.read(str(tmp_path / "torch.wav"))
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
