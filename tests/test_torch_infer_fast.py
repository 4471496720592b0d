"""PyTorch port, bucketed and streamed synthesis: `bucket_sentences`,
batched and guided rows of `inference_speech`, the engine's `infer_fast`
and `infer_stream` against the JAX package on the same weights (greedy),
the engine lock, and the CLI's --fast and --stream.  The tiny engine of
tests/test_torch_engine.py, fp32, with the vocoder's output bias raised by
1.0 so that the wavs compared are loud."""

import copy
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from indextts_tpu import engine as jax_engine
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu_torch import cli
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.models import unified_voice as uv
from tests.test_torch_engine import build_engines, model  # noqa: F401  (fixture)
from tests.test_torch_gpt import setup  # noqa: F401  (fixture)

# five sentences at 14 tokens a sentence: 13, 13, 9, 13 and 11 tokens (one
# text width, 16, for all), which bucket as [2, 4, 0, 1] + [3] at size 4
# and [2, 4], [0, 1], [3] at size 2
FIVE = "今天天气很好。我们去散步吧。明天再见。谢谢你的帮助。请再说一遍。"
GREEDY = dict(do_sample=False, max_mel_tokens=12, max_text_tokens_per_sentence=14)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def engines(model):  # noqa: F811
    d, gpt_np, bv_np = model
    bv_np = copy.deepcopy(bv_np)
    bv_np["conv_post"]["b"] = bv_np["conv_post"]["b"] + np.float32(1.0)
    jeng, teng = build_engines((d, gpt_np, bv_np), {"gpt": "fp32", "vocoder": "fp32"})
    return jeng, teng, str(d / "prompt.wav"), d


# --- (a) bucket_sentences -------------------------------------------------

@pytest.mark.parametrize("seed,size", [(s, k) for s in range(3) for k in (1, 2, 4)]
                         + [(3, 4)])
def test_bucket_sentences_matches_jax(seed, size):
    rng = np.random.default_rng(seed)
    n = 3 if seed == 3 else int(rng.integers(5, 14))    # seed 3: one bucket, no split
    lengths = rng.integers(0 if seed == 2 else 1, 40, n)  # seed 2: empty sentences too
    sentences = [["t"] * int(m) for m in lengths]
    assert torch_engine.bucket_sentences(sentences, size) == \
        jax_engine.bucket_sentences(sentences, size)


# --- (b), (c) batched and guided rows -------------------------------------

def _rows(rng, lengths, width):
    """Left-padded text rows of the given lengths, padded on to `width`."""
    prep = uv.prepare_text_prompt([rng.integers(2, 40, (n,)) for n in lengths], 0, 1)
    pad = width - prep.text_tokens.shape[1]
    return (np.pad(prep.text_tokens, ((0, 0), (pad, 0))),
            np.pad(prep.attn_text, ((0, 0), (pad, 0))))


def _decode_both(setup, cond, tokens, mask, **kw):  # noqa: F811
    jcfg, tcfg, jp, tp = setup
    ref = jax_uv.inference_speech(jp, jcfg, jnp.asarray(cond), jnp.asarray(tokens),
                                  jnp.asarray(mask), jax.random.PRNGKey(0),
                                  cache_dtype=jnp.float32, **kw)
    got = uv.inference_speech(tp, tcfg, torch.from_numpy(cond),
                              torch.from_numpy(tokens).long(), torch.from_numpy(mask), None,
                              cache_dtype=torch.float32, **kw)
    return ref, got


def test_batched_rows_match_jax(setup):  # noqa: F811
    """B = 3 left-padded rows of 3, 9 and 6 text tokens, greedy, penalty 1.5."""
    rng = np.random.default_rng(11)
    tokens, mask = _rows(rng, (3, 9, 6), 16)
    cond = rng.standard_normal((3, 32, 64)).astype(np.float32)
    ref, got = _decode_both(setup, cond, tokens, mask, max_new=12, do_sample=False,
                            repetition_penalty=1.5)
    np.testing.assert_array_equal(_np(got.codes), np.asarray(ref.codes))
    np.testing.assert_array_equal(_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(_np(got.finished), np.asarray(ref.finished))


@pytest.mark.parametrize("B", [1, 2])
def test_guided_rows_match_jax(setup, B):  # noqa: F811
    """Classifier-free guidance at cfg_scale 2: greedy codes equal JAX's."""
    rng = np.random.default_rng(20 + B)
    tokens, mask = _rows(rng, (7, 4)[:B], 16)
    cond = rng.standard_normal((1, 32, 64)).astype(np.float32)
    ref, got = _decode_both(setup, cond, tokens, mask, max_new=12, do_sample=False,
                            repetition_penalty=1.5, cfg_scale=2.0)
    assert tuple(got.codes.shape) == (B, 12)
    np.testing.assert_array_equal(_np(got.codes), np.asarray(ref.codes))
    np.testing.assert_array_equal(_np(got.lengths), np.asarray(ref.lengths))


# --- (d) infer_fast ----------------------------------------------------------

def _recording(mp, eng):
    """Record every bucket's (codes, lengths) from `eng._decode_bucket`."""
    seen = []
    inner = eng._decode_bucket

    def wrapped(*a, **k):
        out = inner(*a, **k)
        seen.append((np.asarray(out[0]), np.asarray(out[1])))
        return out

    mp.setattr(eng, "_decode_bucket", wrapped)
    return seen


@pytest.mark.parametrize("num_beams,size", [(1, 1), (1, 2), (1, 4), (3, 1), (3, 2), (3, 4)])
def test_infer_fast_matches_jax(engines, tmp_path, num_beams, size):
    """Greedy infer_fast of five sentences: each bucket's codes equal the
    JAX engine's, and the wavs agree within 1 int16 step (num_beams=1) or 4
    (beam-3), as in tests/test_torch_engine.py."""
    jeng, teng, prompt, _ = engines
    kw = dict(GREEDY, num_beams=num_beams, sentences_bucket_max_size=size)
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        jseen, tseen = _recording(mp, jeng), _recording(mp, teng)
        jeng.infer_fast(prompt, FIVE, str(tmp_path / "jax.wav"), **kw)
        teng.infer_fast(prompt, FIVE, str(tmp_path / "torch.wav"), **kw)
    s = teng.last_stats
    assert s["buckets"] == {1: [1] * 5, 2: [2, 2, 1], 4: [4, 1]}[size]
    assert len(tseen) == len(jseen) == len(s["buckets"])
    for (tc, tl), (jc, jl) in zip(tseen, jseen):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tl, jl)
    _, ref = wavfile.read(str(tmp_path / "jax.wav"))
    sr, got = wavfile.read(str(tmp_path / "torch.wav"))
    assert sr == 24000 and got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape == (sum(s["code_lens"]) * 1024,)
    assert np.abs(got.astype(np.int32)).max() > 1000
    tol = 1 if num_beams == 1 else 4
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= tol


# --- (e), (f) infer_stream -------------------------------------------------

@pytest.mark.parametrize("num_beams", [1, 3])
def test_infer_stream_concatenates_to_infer(engines, num_beams):
    _, teng, prompt, _ = engines
    kw = dict(GREEDY, num_beams=num_beams, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sr, wav = teng.infer(prompt, FIVE, None, **kw)
        stats = {}
        chunks = list(teng.infer_stream(prompt, FIVE, stats_out=stats, **kw))
    assert len(chunks) == 5 and all(c_sr == sr == 24000 for c_sr, _ in chunks)
    assert np.array_equal(np.concatenate([c for _, c in chunks]), wav[:, 0])
    assert np.abs(wav.astype(np.int32)).max() > 1000
    assert stats["code_lens"] == teng.last_stats["code_lens"]
    assert 0 < stats["time_to_first_audio"] <= stats["total_s"]


def _in_thread(fn, timeout=60.0):
    """fn() on another thread; its result, or its exception raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"no result within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_closed_stream_releases_the_lock(engines):
    """A stream whose next() and close() come from other threads, closed
    after its first chunk: a following infer finishes within 60 s."""
    _, teng, prompt, _ = engines
    kw = dict(GREEDY, num_beams=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stream = teng.infer_stream(prompt, FIVE, **kw)
        sr, chunk = _in_thread(lambda: next(stream))
        assert sr == 24000 and chunk.shape[0] % 1024 == 0
        _in_thread(stream.close)
        sr, wav = _in_thread(lambda: teng.infer(prompt, "你好。", None, **kw))
    assert wav.shape[0] > 0 and not teng._infer_lock.locked()


# --- (g) the engine lock ----------------------------------------------------

def test_concurrent_infer_calls_are_serialised(engines, monkeypatch):
    """Two threads call infer at once.  No decode or vocode of one overlaps
    any of the other's (each phase sleeps a little to widen the window), and
    each call prints its own stats."""
    _, teng, prompt, _ = engines
    active, peak, guard = [0], [0], threading.Lock()

    def phase(inner):
        def run(*a, **k):
            with guard:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            try:
                time.sleep(0.02)
                return inner(*a, **k)
            finally:
                with guard:
                    active[0] -= 1
        return run

    monkeypatch.setattr(teng, "_decode_bucket", phase(teng._decode_bucket))
    monkeypatch.setattr(teng, "_vocode", phase(teng._vocode))
    printed, stats_of = {}, {}
    monkeypatch.setattr(torch_engine, "print", lambda *a, **k: printed.setdefault(
        threading.current_thread().name, []).append(" ".join(map(str, a))), raising=False)
    stream = teng.infer_stream

    def recording_stream(*a, **k):
        stats_of[threading.current_thread().name] = k["stats_out"]
        return stream(*a, **k)

    monkeypatch.setattr(teng, "infer_stream", recording_stream)
    texts = {"call-a": FIVE, "call-b": "你好。明天见。"}
    errors = []

    def call(text):
        try:
            teng.infer(prompt, text, None, **dict(GREEDY, num_beams=1))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            threads = [threading.Thread(target=call, args=(t,), name=n, daemon=True)
                       for n, t in texts.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert peak[0] == 1
    for name in texts:
        s = stats_of[name]
        sentences = teng.tokenizer.split_sentences(teng.tokenizer.tokenize(texts[name]), 14)
        assert len(s["code_lens"]) == len(sentences)
        assert printed[name][0] == f">> total {s['total_s']:.2f}s  (RTF: {s['rtf']:.4f})"


# --- (h) the CLI --------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--fast", "--stream"])
def test_cli_fast_and_stream_write_a_wav(engines, tmp_path, flag):
    _, _, prompt, d = engines
    out = tmp_path / "cli.wav"
    args = ["你好。明天见。", "-v", prompt, "-o", str(out), "--model_dir", str(d), "-d", "cpu",
            "--num_beams", "1", "--seed", "3", flag]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(args) == 0
    sr, wav = wavfile.read(str(out))
    assert sr == 24000 and wav.dtype == np.int16 and wav.shape[0] % 1024 == 0
    assert wav.shape[0] > 0
