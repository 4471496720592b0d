"""PyTorch port, front end: log-mel, tokenizer and silence compression held
against the JAX package on the same inputs."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu import engine as jax_engine
from indextts_tpu.ops import mel as jax_mel
from indextts_tpu.utils import textnorm as jax_textnorm
from indextts_tpu.utils import tokenizer as jax_tokenizer
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.ops import mel as torch_mel
from indextts_tpu_torch.utils import textnorm as torch_textnorm
from indextts_tpu_torch.utils import tokenizer as torch_tokenizer

VOCAB = os.path.join(os.path.dirname(__file__), "..", "checkpoints_test", "vocab.txt")
TEXTS = ["你好，欢迎使用语音合成。", "The quick brown fox jumps over the lazy dog.",
         "混合 text 与数字 123 和 3.5 元。", "Dr. Smith's email is a@b.com!"]


@pytest.fixture(scope="module")
def tokenizers():
    def make(tn, tok):
        norm = tn.TextNormalizer()
        norm.load()
        return tok.TextTokenizer(VOCAB, norm)

    return make(jax_textnorm, jax_tokenizer), make(torch_textnorm, torch_tokenizer)


@pytest.mark.parametrize("n_samples", [24000, 30011])
def test_mel_matches_jax(n_samples):
    rng = np.random.default_rng(n_samples)
    t = np.arange(n_samples) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n_samples))
    wav = wav.astype(np.float32)[None]
    ref = np.asarray(jax_mel.MelSpectrogramFeatures()(jnp.asarray(wav)))
    got = torch_mel.MelSpectrogramFeatures()(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (1, 100, n_samples // 256 + 1)
    # fp32 FFTs of two libraries; log-mel values span about [-16, 5]
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_token_ids_match_jax(tokenizers):
    jt, tt = tokenizers
    for text in TEXTS:
        jtok, ttok = jt.tokenize(text), tt.tokenize(text)
        assert ttok == jtok
        assert tt.convert_tokens_to_ids(ttok) == jt.convert_tokens_to_ids(jtok)
        for width in (120, 8):
            assert tt.split_sentences(ttok, width) == jt.split_sentences(jtok, width)


def test_remove_long_silence_matches_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 60, (3, 90)).astype(np.int64)
    codes[0, 10:70] = 52               # one long run: compressed
    codes[1, ::2] = 52                 # many short runs, over the threshold
    codes[2, :20] = 52                 # under the threshold: untouched
    lens = np.asarray([90, 85, 40])
    got = torch_engine.remove_long_silence(codes, lens, stop_token=8193)
    ref = jax_engine.remove_long_silence(codes, lens, stop_token=8193)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert int(got[1][0]) < 90 and int(got[1][2]) == 40
