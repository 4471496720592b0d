"""PyTorch port, the WebUI's callbacks (indextts_tpu_torch/serve/webui.py)
without gradio: tests/test_webui.py's stub-engine tests over the port's
module, the guidance rule, and one real tiny engine of each package, built
from the same .pth files, decoding equal greedy codes through each
package's `synthesize` callback; and serve/api.py's import guard."""

import importlib
import json
import os
import shutil
import warnings

import numpy as np
import pytest
from scipy.io import wavfile

from indextts_tpu.serve import webui as jax_webui
from indextts_tpu_torch.config import Config
from indextts_tpu_torch.io import export, from_jax
from indextts_tpu_torch.serve import webui
from indextts_tpu_torch.tools import _common
from tests.test_torch_engine import REPO, TEXT
from tests.test_torch_gpt import numpy_params


def test_module_imports_without_gradio():
    assert webui.discover_models is not None
    if webui.gr is None:
        with pytest.raises(ImportError, match="gradio is required"):
            webui.create_demo("x.yaml", "x")


def test_api_is_guarded_without_fastapi():
    """serve/api.py is glue over serve/httpd.TTSService behind JAX's guard:
    without FastAPI its import raises an ImportError naming it."""
    try:
        import fastapi  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="fastapi is required"):
            importlib.import_module("indextts_tpu_torch.serve.api")
    else:
        pytest.skip("fastapi is installed: the guard does not fire")


def test_discover_models_and_examples(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "gpt.pth").write_bytes(b"x")
    (tmp_path / "sub" / "model_epoch_3.pth").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    assert webui.discover_models(str(tmp_path)) == jax_webui.discover_models(str(tmp_path)) \
        == ["gpt.pth", os.path.join("sub", "model_epoch_3.pth")]
    p = tmp_path / "cases.jsonl"
    p.write_text(json.dumps({"text": "你好。"}) + "\nNOT JSON\n" + json.dumps({"text": ""})
                 + "\n" + json.dumps({"other": 1}) + "\n" + json.dumps({"text": "Second."})
                 + "\n", encoding="utf-8")
    assert webui.parse_examples(str(p)) == jax_webui.parse_examples(str(p)) \
        == [["你好。"], ["Second."]]
    assert webui.parse_examples(None) == [] == webui.parse_examples(str(tmp_path / "none"))


class _StubTokenizer:
    def tokenize(self, text):
        return list(text)

    def split_sentences(self, tokens, max_tokens):
        return [tokens[i:i + max_tokens] for i in range(0, len(tokens), max_tokens)]


class _StubEngine:
    """Records engine construction and synthesis calls."""

    def __init__(self, **kwargs):
        self.ctor = kwargs
        self.calls = []
        self.tokenizer = _StubTokenizer()
        self.gr_progress = None

    def infer_fast(self, prompt, text, out, **kw):
        self.calls.append(("fast", prompt, text, out, kw))
        return out

    def infer(self, prompt, text, out, **kw):
        self.calls.append(("normal", prompt, text, out, kw))
        return out


@pytest.fixture(params=["port", "jax"])
def callbacks(request, tmp_path):
    module = webui if request.param == "port" else jax_webui
    return module.build_callbacks("cfg.yaml", "mdir", engine_factory=_StubEngine,
                                  out_dir=str(tmp_path))


SLIDERS = ("text here", "fast", 100, 4, True, 0.8, 30, 1.0, 10.0, 600)


@pytest.mark.parametrize("extra", [{}, {"num_beams": 1, "cfg_scale": 2.5},
                                   {"num_beams": 3, "cfg_scale": 2.0},
                                   {"num_beams": 3, "cfg_scale": 1.0}])
def test_synthesize_plumbing_matches_jax(extra, tmp_path):
    """The same engine calls from both packages' callbacks, the guidance rule
    included: an active cfg_scale drops the slider's num_beams so that the
    engine's sampling switch applies the guidance."""
    calls = []
    for module in (webui, jax_webui):
        cb = module.build_callbacks("cfg.yaml", "mdir", engine_factory=_StubEngine,
                                    out_dir=str(tmp_path))
        out = cb["synthesize"]("voice.wav", *SLIDERS, **extra)
        assert out == os.path.join(str(tmp_path), "webui_gen.wav")
        calls.append(cb["state"]["tts"].calls)
    assert calls[0] == calls[1]
    _, _, _, _, kw = calls[0][0]
    if extra.get("cfg_scale", 1.0) != 1.0 and extra.get("num_beams") == 3:
        assert "num_beams" not in kw and kw["cfg_scale"] == 2.0
    else:
        assert kw["num_beams"] == extra.get("num_beams", 3)
    assert kw["top_k"] == 30 and isinstance(kw["top_k"], int)


def test_normal_mode_reload_and_preview(callbacks):
    callbacks["synthesize"]("v.wav", "t", "normal", 80, 4, False, 0.9, 50, 0.7, 5.0, 300)
    mode, _, _, _, kw = callbacks["state"]["tts"].calls[0]
    assert mode == "normal" and "sentences_bucket_max_size" not in kw
    assert kw["do_sample"] is False and kw["top_p"] == 0.9
    first = callbacks["state"]["tts"]
    assert "gpt_ft.pth" in callbacks["reload_model"]("finetune/gpt_ft.pth")
    assert callbacks["state"]["tts"] is not first
    assert callbacks["state"]["tts"].ctor["gpt_path"] == "finetune/gpt_ft.pth"
    callbacks["reload_model"]("")
    assert callbacks["state"]["tts"].ctor["gpt_path"] is None
    assert callbacks["preview_split"]("abcdefgh", 3) == [[0, 3, "abc"], [1, 3, "def"],
                                                          [2, 2, "gh"]]


def test_real_engines_decode_equal_codes(tmp_path):
    """One tiny engine of each package, both built by their build_callbacks
    from the same .pth files (numpy-seeded weights through the port's
    exporter): a greedy normal-mode synthesize gives equal codes, sentence by
    sentence, and a wav from each."""
    import jax

    from indextts_tpu.config import Config as JaxConfig
    from indextts_tpu.models import bigvgan as jax_bigvgan
    from indextts_tpu.models import unified_voice as jax_uv

    d = tmp_path / "model"
    d.mkdir()
    # width 64 in 4 heads: JAX's single-row decode runs its Pallas trunk in
    # interpret mode on the CPU, three times slower at the tools' width 128
    model = {"gpt": {**_common.TINY_MODEL["gpt"], "model_dim": 64, "heads": 4},
             "bigvgan": {**_common.TINY_MODEL["bigvgan"], "gpt_dim": 64}}
    cfg, jcfg = Config.from_dict(model), JaxConfig.from_dict(model)
    cfg.save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    gpt_np = numpy_params(
        jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg.gpt)), 1,
        lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = numpy_params(
        jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(1), jcfg.bigvgan)),
        2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    export.save_gpt_pth(str(d / "gpt.pth"), from_jax.gpt_params_from_numpy(gpt_np, cfg.gpt),
                        cfg.gpt, save_dtype="fp32")
    export.save_bigvgan_pth(str(d / "bigvgan_generator.pth"),
                            from_jax.bigvgan_params_from_numpy(bv_np, cfg.bigvgan), cfg.bigvgan)
    sr = 24000
    t = np.arange(sr) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    prompt = str(tmp_path / "prompt.wav")
    wavfile.write(prompt, sr, ((0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * noise)
                               * 32767).astype(np.int16))
    (d / "config_inference.yaml").write_text("inference:\n  gpt: fp32\n  vocoder: fp32\n",
                                             encoding="utf-8")
    codes, wavs = [], []
    for module, kw in ((jax_webui, {}), (webui, {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cb = module.build_callbacks(str(d / "config.yaml"), str(d),
                                        out_dir=str(tmp_path / module.__name__), **kw)
            tts = cb["state"]["tts"]
            seen = []
            inner = tts._decode_bucket

            def capture(*args, inner=inner, seen=seen):
                out = inner(*args)
                seen.append((np.asarray(out[0]), np.asarray(out[1])))
                return out

            tts._decode_bucket = capture
            os.makedirs(tmp_path / module.__name__)
            path = cb["synthesize"](prompt, TEXT, "normal", 20, 4, False, 0.8, 30, 1.0, 1.0,
                                    12, num_beams=1)
        codes.append(seen)
        wavs.append(wavfile.read(path)[1])
    assert len(codes[0]) == len(codes[1]) == 2                 # two sentences
    for (jc, jl), (tc, tl) in zip(*codes):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tl, jl)
    assert wavs[0].shape == wavs[1].shape and wavs[1].dtype == np.int16
    # fp32 on both sides; the int16 cast truncates (as test_torch_engine)
    assert np.abs(wavs[1].astype(np.int32) - wavs[0].astype(np.int32)).max() <= 1
