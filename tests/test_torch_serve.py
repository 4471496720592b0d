"""PyTorch port, pool serving: `pool_infer` against the JAX engine's on the
same weights, the batched vocode tail against JAX's, `pool_infer_stream`,
the stdlib HTTP server over a socket in continuous mode (the sampling pool,
and the beam pool at num_beams=3) and without it (infer_fast,
infer_stream, /model/reload), and --pool-beam-groups.  The tiny engine of
tests/test_torch_engine.py, fp32."""

import http.client
import json
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
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.io.export import save_gpt_pth
from indextts_tpu_torch.serve import httpd
from tests.test_torch_engine import build_engines, model  # noqa: F401  (fixture)
from tests.test_torch_gpt import numpy_params

TEXT = "今天天气很好。我们去散步吧。"
POOL = dict(num_slots=2, max_text_width=32, max_new=12, do_sample=False,
            repetition_penalty=1.0)


@pytest.fixture(scope="module")
def engines(model):  # noqa: F811
    jeng, teng = build_engines(model, {"gpt": "fp32", "vocoder": "fp32"})
    return jeng, teng, str(model[0] / "prompt.wav"), model[0]


class _DriveLoop:
    """A thread stepping a pool, as the server's drive loop does."""

    def __init__(self, pool):
        self.pool, self.stop = pool, threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            if not self.pool.step():
                time.sleep(0.002)

    def __enter__(self):
        self.thread.start()
        return self.pool

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(30)


def test_pool_infer_wav_matches_jax(engines):
    """Greedy pool synthesis of two sentences: the port's wav equals the JAX
    engine's within one int16 step (fp32; the cast truncates)."""
    jeng, teng, prompt, _ = engines
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _DriveLoop(jeng.create_batcher(**POOL)) as jb:
            jsr, jwav = jeng.pool_infer(jb, prompt, TEXT, max_text_tokens_per_sentence=20)
        with _DriveLoop(teng.create_batcher(**POOL)) as tb:
            tsr, twav = teng.pool_infer(tb, prompt, TEXT, max_text_tokens_per_sentence=20)
    assert tsr == jsr == 24000 and twav.dtype == np.int16
    assert twav.shape == jwav.shape and twav.shape[0] % 1024 == 0 and twav.shape[0] > 1024
    assert np.abs(twav.astype(np.int32) - np.asarray(jwav).astype(np.int32)).max() <= 1


def _jobs(rng, stop, rows_per_job):
    """(ids, codes, lens) of jobs with the given row counts: texts under 16
    tokens and codes under 64, the tail's smallest buckets."""
    jobs = []
    for rows in rows_per_job:
        ids = [rng.integers(2, 40, (int(rng.integers(3, 8)),)).astype(np.int32)
               for _ in range(rows)]
        lens = rng.integers(4, 12, (rows,)).astype(np.int64)
        codes = np.full((rows, int(lens.max())), stop, np.int32)
        for r in range(rows):
            codes[r, : lens[r]] = rng.integers(0, 50, (lens[r],))
        jobs.append((ids, codes, lens))
    return jobs


def test_codes_to_wav_group_matches_jax(engines):
    """A coordinator group of two one-row jobs: the port's batched tail equals
    JAX's.  A group of a one-row and a two-row job (three rows, padded to
    four): each job's wav equals its own direct tail (the batch size changes
    the vocoder's sums, so within one int16 step)."""
    jeng, teng, prompt, _ = engines
    mel = teng._prompt_mel(prompt)
    cond_np = np.asarray(jeng._conditioning(jnp.asarray(mel.numpy()), None))
    cond, mel_ref = torch.tensor(cond_np), teng._mel_ref(mel, None)
    rng = np.random.default_rng(7)
    jobs = _jobs(rng, teng.stop_mel_token, (1, 1))
    mel_np = np.swapaxes(mel.numpy(), 1, 2)
    jwavs = jeng._codes_to_wav_group([jax_engine._VocodeJob(
        jnp.asarray(cond_np), jnp.asarray(mel_np), *j) for j in jobs])
    twavs = teng._codes_to_wav_group([torch_engine._VocodeJob(cond, mel_ref, *j)
                                      for j in jobs])
    for t, j in zip(twavs, jwavs):
        assert t.shape == np.asarray(j).shape and t.dtype == np.int16
        assert np.abs(t.astype(np.int32) - np.asarray(j).astype(np.int32)).max() <= 1
    jobs = _jobs(rng, teng.stop_mel_token, (1, 2))
    twavs = teng._codes_to_wav_group([torch_engine._VocodeJob(cond, mel_ref, *j)
                                      for j in jobs])
    for t, job in zip(twavs, jobs):
        direct = teng._codes_to_wav(cond, mel_ref, *job)
        assert t.shape == direct.shape
        assert np.abs(t.astype(np.int32) - direct.astype(np.int32)).max() <= 1


def test_pool_infer_stream_yields_the_sentences_in_order(engines):
    _, teng, prompt, _ = engines
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _DriveLoop(teng.create_batcher(**POOL)) as b:
            sr, wav = teng.pool_infer(b, prompt, TEXT, max_text_tokens_per_sentence=20)
            chunks = list(teng.pool_infer_stream(b, prompt, TEXT,
                                                 max_text_tokens_per_sentence=20))
    assert len(chunks) == 2 and all(s == sr for s, _ in chunks)
    streamed = np.concatenate([c for _, c in chunks])
    # each chunk is vocoded alone, pool_infer's sentences together: the batch
    # size changes the vocoder's sums, so within one int16 step
    assert streamed.shape == wav.shape
    assert np.abs(streamed.astype(np.int32) - wav.astype(np.int32)).max() <= 1


def test_create_batcher_defaults(engines):
    _, teng, prompt, _ = engines
    b = teng.create_batcher()
    assert b.steps_per_tick == 1 and b.K == 0 and not b.fused    # the CPU's defaults
    assert b.cache_dtype == torch.float32 and b.kv_dtype is None
    b = teng.create_batcher(prompt, num_slots=2, steps_per_tick=4, max_new=8)
    assert b.S == 2 and b.K == 2 and b.max_new == 8
    with pytest.raises(ValueError, match="dp=2"):
        teng.create_batcher(dp=2)
    # a speaker the engine holds no condition for (none: random weights)
    with pytest.raises(ValueError, match="unknown speaker_id"):
        teng.create_batcher(speaker_id="someone")
    b = teng.create_beam_batcher(num_groups=2)
    assert b.steps_per_tick == 1 and b.nb == 3 and b.G == 2 and b.top_k == 30
    assert b.cache_dtype == torch.float32 and b.state.suffix.k.dtype == torch.float32
    assert b.max_new == teng.cfg.gpt.max_mel_tokens


def _server(engine, **kw):
    server = httpd.serve("unused.yaml", "unused", host="127.0.0.1", port=0,
                         engine_instance=engine, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _post(server, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data


def _wav(data):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    import io
    sr, samples = wavfile.read(io.BytesIO(data))
    return sr, samples


def test_http_server_continuous_mode(engines, tmp_path):
    _, teng, prompt, _ = engines
    server = _server(teng, continuous=True,
                     pool_kwargs=dict(num_slots=2, max_text_width=32, max_new=8),
                     beam_pool_kwargs=dict(max_text_width=32, max_new=8))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
        conn.close()
        req = {"text": TEXT, "audio_path": prompt, "seed": 5, "max_mel_tokens": 8,
               "max_text_tokens_per_sentence": 20}
        status, headers, data = _post(server, "/tts", req)
        assert status == 200 and headers["X-Seed"] == "5"
        sr, samples = _wav(data)
        assert sr == 24000 and samples.dtype == np.int16 and samples.shape[0] % 1024 == 0
        again = _post(server, "/tts", req)
        assert again[0] == 200 and again[2] == data          # same seed, same bytes
        other = _post(server, "/tts", {**req, "seed": 6})
        assert other[1]["X-Seed"] == "6"
        status, headers, stream = _post(server, "/tts_stream", req)
        assert status == 200 and headers["Transfer-Encoding"] == "chunked"
        assert stream[:4] == b"RIFF" and len(stream) == 44 + samples.nbytes
        # the same codes (same seed); each sentence vocoded alone, so within
        # one int16 step of /tts's batched tail
        streamed = np.frombuffer(stream[44:], np.int16).astype(np.int32)
        assert np.abs(streamed - samples.astype(np.int32)).max() <= 1
        status, _, body = _post(server, "/tts", {"text": TEXT})
        assert status == 400 and b"audio_path" in body
        # num_beams=3 (the reference client's default) goes to the beam pool:
        # greedy, its wav is the dedicated beam-3's (the pool vocodes the two
        # sentences together, infer one by one: within one int16 step)
        status, headers, data = _post(server, "/tts", {**req, "num_beams": 3,
                                                      "do_sample": False})
        assert status == 200 and "X-Top-K-Effective" not in headers
        _, pooled = _wav(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, want = teng.infer(prompt, TEXT, None, num_beams=3, do_sample=False,
                                 max_mel_tokens=8, repetition_penalty=10.0,
                                 max_text_tokens_per_sentence=20)
        assert pooled.shape == want[:, 0].shape
        assert np.abs(pooled.astype(np.int32) - want[:, 0].astype(np.int32)).max() <= 1
        # sampled beam-3 with another top_k than the pool's: declared
        status, headers, data = _post(server, "/tts", {**req, "num_beams": 3, "top_k": 20})
        assert status == 200 and headers["X-Top-K-Effective"] == "30"
        assert _wav(data)[0] == 24000
        assert set(server.service._beam_pools) == {False, True}
    finally:
        server.shutdown()


def test_http_server_routes_not_ported_yet(engines, tmp_path):
    """Non-continuous: /tts with no mode runs infer_fast (the reference's
    serving default, beam-3), /tts_stream runs infer_stream, and
    mode="normal" runs infer, each answering a 24 kHz int16 wav over the
    socket; /model/reload swaps in another gpt.pth, and the next request
    is the wav of an engine built from that file."""
    _, teng, prompt, d = engines
    server = httpd.serve(str(d / "config.yaml"), str(d), host="127.0.0.1", port=0,
                         engine_instance=teng, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        req = {"text": "你好。明天见。", "audio_path": prompt, "max_mel_tokens": 4, "seed": 1}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            status, headers, data = _post(server, "/tts", req)
            assert status == 200 and headers["X-Seed"] == "1"
            sr, samples = _wav(data)
            assert sr == 24000 and samples.dtype == np.int16
            assert samples.shape[0] == sum(teng.last_stats["code_lens"]) * 1024 > 0
            assert teng.last_stats["buckets"] == [1]           # infer_fast's stats
            status, headers, stream = _post(server, "/tts_stream", req)
            assert status == 200 and headers["Transfer-Encoding"] == "chunked"
            assert stream[:4] == b"RIFF" and (len(stream) - 44) % 2048 == 0 and len(stream) > 44
            status, headers, data = _post(server, "/tts", {**req, "mode": "normal",
                                                           "num_beams": 1})
        assert status == 200 and _wav(data)[0] == 24000
        status, _, data = _post(server, "/model/reload", {"gpt_path": "missing.pth"})
        assert status == 404
        pth = str(tmp_path / "other_gpt.pth")
        other = numpy_params(jax.eval_shape(lambda: jax_uv.init_params(
            jax.random.PRNGKey(0), teng.cfg.gpt)), 7, lambda s: 1.0 / np.sqrt(s[-2]))
        save_gpt_pth(pth, from_jax.gpt_params_from_numpy(other, teng.cfg.gpt), teng.cfg.gpt,
                     save_dtype="fp32")
        status, _, data = _post(server, "/model/reload", {"gpt_path": pth})
        assert status == 200 and json.loads(data) == {"status": "reloaded", "gpt_path": pth}
        normal = {**req, "mode": "normal", "num_beams": 1, "do_sample": False}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            status, _, data = _post(server, "/tts", normal)
            fresh = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                          device="cpu", gpt_path=pth)
            _, want = fresh.infer(prompt, normal["text"], None, num_beams=1, do_sample=False,
                                  max_mel_tokens=4, seed=1, temperature=0.3,
                                  repetition_penalty=10.0, length_penalty=0.0)
        assert server.service._tts is not teng and server.service._tts.gpt_path == pth
        assert status == 200 and np.array_equal(_wav(data)[1], want[:, 0])
    finally:
        server.shutdown()


def test_beam_pool_option_names_its_roadmap_item(engines, monkeypatch):
    """--pool-beam-groups sizes the continuous beam pool: the command line
    starts a server whose beam pool has that many groups of three beams,
    and the service takes the option."""
    _, _, _, d = engines
    seen = {}

    def serve_once(server):   # in place of the blocking loop: build the pool, return
        pool = server.service.beam_pool(True)
        seen.update(groups=pool.G, beams=pool.nb, continuous=server.service.continuous)

    monkeypatch.setattr(httpd.TTSHTTPServer, "serve_forever", serve_once)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        httpd.main(["--continuous", "--pool-beam-groups", "2", "--host", "127.0.0.1",
                    "--port", "0", "--config", str(d / "config.yaml"), "--model_dir", str(d)],
                   device="cpu")
        assert seen == {"groups": 2, "beams": 3, "continuous": True}
        service = httpd.TTSService(str(d / "config.yaml"), str(d), continuous=True,
                                   beam_pool_kwargs={"num_groups": 2}, device="cpu")
        try:
            pool = service.beam_pool(False)
            assert pool.G == 2 and not pool.do_sample and service.beam_pool(False) is pool
        finally:
            service.close()


def test_service_defaults_to_cuda(engines):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, _, _, d = engines
    service = httpd.TTSService(str(d / "config.yaml"), str(d))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service.engine()
