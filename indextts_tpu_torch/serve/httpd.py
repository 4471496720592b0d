"""Dependency-free synthesis server over the stdlib http.server
(counterpart of indextts_tpu/serve/httpd.py; the FastAPI server is ROADMAP
item A12c).  The engine runs on `cuda` unless the caller passes
device="cpu" to `TTSService`, `serve` or `main`.

  GET  /health                     → {"status": "ok", ...}
  GET  /models                     → checkpoint discovery
  POST /model/reload               → {"gpt_path": ...} (JSON or form)
  POST /tts                        → JSON {"text": ..., "audio_path"|
                                     "speaker_id": ..., sampling params,
                                     "seed"} → WAV bytes, X-Seed header
  POST /tts_stream                 → same body → chunked-transfer WAV,
                                     one PCM chunk per sentence (first
                                     audio after one sentence's synthesis)

Accepts JSON, urlencoded, and multipart/form-data bodies — uploads (the
browser form's `audio_file`) land in a temp file and are passed to the
service as `audio_path` (the reference's contract, api.py:199-216).
GET /ui serves the static browser player.

Without --continuous, /tts with mode "fast" (the default) runs
`infer_fast` (sentence buckets of `sentences_bucket_max_size`, default 4),
mode "normal" or a speaker_id `infer`, and /tts_stream `infer_stream`.
With --continuous, requests join the shared sampling pool, or at
num_beams=3 (the reference client's default) the shared beam pool
(serve/beam_pool.py), one per do_sample mode.  The engine loads
`--gpt_path` and `--speaker_info_path` as the reference does, and
/model/reload swaps the GPT checkpoint while serving.  With --tp N the
engine serves across N cards (engine.py); the pools are one-card paths, so
--tp and --continuous exclude each other.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from indextts_tpu_torch.engine import IndexTTS


def discover_models(model_dir: str, current: Optional[str]) -> Dict[str, Any]:
    """Checkpoint discovery, reference response shape (api.py:97-116):
    each entry is {"name", "filename", "type"} and the currently loaded
    checkpoint is echoed as "current_model" (basename); "current" (path)
    is kept for this framework's earlier clients.  Shared by both server
    surfaces so discovery/resolution rules can't drift between them."""
    found = []
    base = os.path.join(model_dir, "gpt.pth")
    if os.path.exists(base):
        found.append({"name": "Default (gpt.pth)", "filename": "gpt.pth",
                      "type": "base"})
    roots = [model_dir, os.path.join(model_dir, ".."),
             os.path.join("finetune_models", "checkpoints")]
    seen = {base}
    for root in roots:
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            full = os.path.join(root, name)
            if full in seen or not (name.endswith(".pth")
                                    or name.startswith("model_epoch_")):
                continue
            seen.add(full)
            found.append({"name": f"Finetuned - {name}", "filename": full,
                          "type": "finetune"})
    return {"models": found, "current": current,
            "current_model": os.path.basename(current) if current else "None"}


class TTSService:
    """Engine holder shared by the handlers (lazy init + hot reload).

    With ``continuous=True`` the service runs one shared continuous-batching
    decode pool: every /tts request's sentences are submitted with that
    request's conditioning and interleave with other callers' sentences in
    the same fixed-slot pool — cross-request batching the reference's
    per-request engine cannot do.  A daemon thread drives the pool."""

    def __init__(self, cfg_path: str, model_dir: str,
                 gpt_path: Optional[str] = None,
                 speaker_info_path: Optional[str] = None,
                 engine_instance: Optional[IndexTTS] = None,
                 continuous: bool = False,
                 pool_kwargs: Optional[Dict[str, Any]] = None,
                 beam_pool_kwargs: Optional[Dict[str, Any]] = None,
                 tp: int = 0,
                 warmup_pool: bool = False,
                 device: Optional[str] = None):
        if continuous and tp and tp > 1:
            raise ValueError("--continuous and --tp are mutually exclusive "
                             "(the decode pool is single-card)")
        self.cfg_path = cfg_path
        self.model_dir = model_dir
        self.gpt_path = gpt_path
        self.speaker_info_path = speaker_info_path
        self.tp = tp
        self.device = device
        self._tts = engine_instance
        self._lock = threading.RLock()
        self.continuous = continuous
        self._pool_kwargs = pool_kwargs or {}
        self._pool = None
        self._beam_pool_kwargs = beam_pool_kwargs or {}
        # beam pools keyed by do_sample (fixed per pool), built at the first
        # num_beams=BEAM_NB request
        self._beam_pools: Dict[bool, Any] = {}
        self.warmup_pool = warmup_pool
        self._closing = threading.Event()
        self._threads: list = []  # every drive thread ever started

    BEAM_NB = 3  # the reference's decode default (api.py:253)

    def pool(self):
        with self._lock:
            if self._closing.is_set():
                raise RuntimeError("TTSService is closed")
            if self._pool is None:
                pool = self.engine().create_batcher(**self._pool_kwargs)
                # concurrent requests' latent+vocode tails batch into one
                # call (engine._VocodeCoordinator)
                self.engine().enable_vocode_batching()
                if self.warmup_pool:
                    # run admission, staging and the step once BEFORE the
                    # drive thread starts (warmup drains inline): the kernel
                    # build and first-use setup stay off the first request
                    pool.warmup()
                self._pool = pool
                self._start_drive(pool)
            return self._pool

    def beam_pool(self, do_sample: bool = True):
        """The shared continuous beam pool for num_beams=BEAM_NB requests of
        this do_sample mode, each with its own drive thread (joined by
        close())."""
        with self._lock:
            if self._closing.is_set():
                raise RuntimeError("TTSService is closed")
            pool = self._beam_pools.get(do_sample)
            if pool is None:
                kw = dict(self._beam_pool_kwargs)
                kw.setdefault("num_groups", 2)
                pool = self.engine().create_beam_batcher(num_beams=self.BEAM_NB,
                                                         do_sample=do_sample, **kw)
                self.engine().enable_vocode_batching()
                if self.warmup_pool:
                    pool.warmup()
                self._beam_pools[do_sample] = pool
                self._start_drive(pool)
            return pool

    def _start_drive(self, pool) -> None:
        t = threading.Thread(target=self._drive_pool, args=(pool,), daemon=True)
        t.start()
        self._threads.append(t)

    def close(self, timeout: float = 60.0) -> None:
        """Stop and JOIN every drive thread, then drop the pool and engine.
        Idempotent.  Without this, the `while True` drive loops outlive
        `httpd.shutdown()` (which stops only the HTTP listener): each dead
        server leaks a daemon thread that keeps waking every 2 ms — across
        a long-lived process (or a test suite) the leaked threads pile up
        and contend with later work."""
        self._closing.set()
        with self._lock:
            threads, self._threads = self._threads, []
            self._pool = None
            self._beam_pools = {}
            tts, self._tts = self._tts, None
        if tts is not None:
            tts.close()  # stop + join the coordinator, and the other ranks under --tp
        for t in threads:
            t.join(timeout)

    def _drive_pool(self, pool) -> None:
        import traceback

        while not self._closing.is_set():
            try:
                live = pool.step()
            except Exception:
                # a transient backend error must not kill the drive thread
                # — a dead drive thread turns every pool request into a silent
                # 600 s timeout while the server keeps accepting traffic
                traceback.print_exc()
                if self._closing.wait(0.25):
                    return
                continue
            idle = live == 0 and not pool._queue
            if idle:
                if self._pool is not pool and pool not in self._beam_pools.values():
                    return  # replaced by reload() and fully drained
                if self._closing.wait(0.002):
                    return

    def engine(self) -> IndexTTS:
        with self._lock:
            if self._tts is not None and self._tts.tp_broken:
                # a rank of the --tp group failed, died or hung: the request
                # that met it failed; this one gets a new engine
                broken, self._tts = self._tts, None
                broken.close()
            if self._tts is None:
                cfg = self.cfg_path if self.cfg_path and os.path.exists(self.cfg_path) \
                    else None
                self._tts = IndexTTS(cfg_path=cfg, model_dir=self.model_dir,
                                     device=self.device, gpt_path=self.gpt_path,
                                     speaker_info_path=self.speaker_info_path, tp=self.tp)
            return self._tts

    def models(self) -> Dict[str, Any]:
        return discover_models(self.model_dir, self.gpt_path)

    def reload(self, gpt_path: str) -> Dict[str, Any]:
        """Swap the GPT checkpoint: the next request builds a new engine from
        it, and new pools over that engine.  The old engine's vocode
        coordinator is joined and both pools are dropped: their drive threads
        finish what they hold, then exit, so no reference to the old
        engine's weights remains."""
        # the reference's resolution order (api.py:126-133): relative to
        # model_dir first, then the path as given, so every "filename" that
        # /models lists resolves here
        candidates = ([gpt_path] if os.path.isabs(gpt_path)
                      else [os.path.join(self.model_dir, gpt_path), gpt_path])
        resolved = next((p for p in candidates if os.path.exists(p)), None)
        if resolved is None:
            raise FileNotFoundError(candidates[0])
        resolved = os.path.abspath(resolved)   # IndexTTS joins relative paths with model_dir
        with self._lock:
            self.gpt_path = resolved
            old_tts, self._tts = self._tts, None
            if old_tts is not None:
                # its vocode coordinator joined, and under --tp its other
                # ranks stopped after the call in flight
                old_tts.close()
            self._pool = None
            self._beam_pools = {}
        return {"status": "reloaded", "gpt_path": resolved}

    @staticmethod
    def parse_request(req: Dict[str, Any]):
        """Shared /tts & /tts_stream contract → (prompt, speaker_id,
        used_seed, gen dict).  Raises ValueError on a bad request."""
        if not req.get("text"):
            raise ValueError("missing 'text'")
        # "prompt_audio_path" is the reference client field name
        # (api.py:181); "audio_path" is this framework's
        prompt = req.get("audio_path") or req.get("prompt_audio_path")
        speaker_id = req.get("speaker_id")
        if not prompt and not speaker_id:
            raise ValueError("need 'audio_path' or 'speaker_id'")
        seed = req.get("seed")
        # seed -1 = "pick one" (reference api.py:205-209)
        if seed is not None and int(seed) == -1:
            seed = None
        used_seed = int(seed) if seed is not None else int(
            time.time_ns() % (2**31))

        def form_bool(v, default):
            # form values arrive as STRINGS — bool("false") is True; match
            # FastAPI's form-bool parsing (api.py do_sample: bool = Form)
            if v is None:
                return default
            if isinstance(v, str):
                return v.strip().lower() not in ("", "0", "false", "no", "off")
            return bool(v)

        gen = dict(
            do_sample=form_bool(req.get("do_sample"), True),
            top_p=float(req.get("top_p", 0.8)),
            top_k=int(req.get("top_k", 30)),
            # the reference API surface defaults temperature to 0.3
            # (api.py:192), lower than the engine-level 1.0 default
            temperature=float(req.get("temperature", 0.3)),
            repetition_penalty=float(req.get("repetition_penalty", 10.0)),
            length_penalty=float(req.get("length_penalty", 0.0)),
            max_mel_tokens=int(req.get("max_mel_tokens", 600)),
        )
        if "num_beams" in req:
            gen["num_beams"] = int(req["num_beams"])
        if "cfg_scale" in req:
            gen["cfg_scale"] = float(req["cfg_scale"])
        return prompt, speaker_id, used_seed, gen

    def _pool_gen(self, gen: Dict[str, Any]):
        """Map a parsed /tts request onto a pool's per-request contract →
        (pool, sampling dict, max_mel_tokens, response headers).  Every
        mapping that is not exact is DECLARED in a response header (a
        requested knob is never ignored silently):

          * num_beams == 3 (the reference API's hardcoded default,
            api.py:253) → the continuous beam pool, with this request's
            temperature / top_p / repetition_penalty / length_penalty /
            seed.  Its top_k is fixed per pool: another top_k is declared
            via X-Top-K-Effective.
          * other num_beams > 1 values → the sampling pool, declared via
            X-Num-Beams-Effective: 1 (the pool has one beam width; 3 is
            the only value reference clients send).
          * sampling requests: top_k ≤ 0 (HF "disabled") or > the pool's
            static shortlist bound → clamped to max_top_k; declared via
            X-Top-K-Effective.
          * cfg_scale is this framework's own extension and unsupported in
            pool mode → ValueError (400)."""
        headers: Dict[str, str] = {}
        if float(gen.get("cfg_scale", 1.0)) != 1.0:
            raise ValueError(
                "cfg_scale is not supported in --continuous mode; use a "
                "non-continuous server for classifier-free guidance")
        max_mel = int(gen.get("max_mel_tokens", 600))
        nb = int(gen.get("num_beams", 1))
        do_sample = bool(gen["do_sample"])
        if nb == self.BEAM_NB:
            pool = self.beam_pool(do_sample)
            sampling = dict(temperature=float(gen["temperature"]), top_p=float(gen["top_p"]),
                            repetition_penalty=float(gen["repetition_penalty"]),
                            length_penalty=float(gen.get("length_penalty", 0.0)))
            if do_sample and int(gen["top_k"]) != pool.top_k:
                headers["X-Top-K-Effective"] = str(pool.top_k)
            return pool, sampling, max_mel, headers
        if nb > 1:
            headers["X-Num-Beams-Effective"] = "1"
        sampling = dict(
            temperature=float(gen["temperature"]),
            top_k=int(gen["top_k"]), top_p=float(gen["top_p"]),
            repetition_penalty=float(gen["repetition_penalty"]),
            do_sample=do_sample)
        pool = self.pool()
        max_top_k = pool.max_top_k
        if sampling["do_sample"] and not 1 <= sampling["top_k"] <= max_top_k:
            sampling["top_k"] = max_top_k
            headers["X-Top-K-Effective"] = str(max_top_k)
        return pool, sampling, max_mel, headers

    def tts(self, req: Dict[str, Any]) -> Tuple[bytes, int, Dict[str, str]]:
        """Returns (wav bytes, seed used, extra response headers).  The seed
        is per-call — reading it back through shared service state raced
        with concurrent requests overwriting it (X-Seed carried another
        caller's seed)."""
        prompt, speaker_id, used_seed, gen = self.parse_request(req)
        if self.continuous:
            data, headers = self._pool_tts(req, prompt, speaker_id,
                                           used_seed, gen)
            return data, used_seed, headers
        eng = self.engine()
        text = req["text"]
        out = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
        out.close()
        try:
            # "infer_mode" is the reference client field name (api.py:182)
            mode = req.get("mode") or req.get("infer_mode") or "fast"
            mtps = int(req.get("max_text_tokens_per_sentence", 120))
            if mode == "fast" and not speaker_id:
                eng.infer_fast(prompt, text, out.name, seed=used_seed,
                               max_text_tokens_per_sentence=mtps,
                               sentences_bucket_max_size=int(
                                   req.get("sentences_bucket_max_size", 4)),
                               **gen)
            else:
                eng.infer(prompt, text, out.name, speaker_id=speaker_id,
                          seed=used_seed,
                          max_text_tokens_per_sentence=mtps, **gen)
            with open(out.name, "rb") as f:
                data = f.read()
        finally:
            os.unlink(out.name)
        self.last_seed = used_seed
        return data, used_seed, {}

    def tts_stream(self, req: Dict[str, Any]):
        """Validate the request, then return (seed, generator of
        (sample_rate, int16 chunk), extra headers) — engine.infer_stream,
        one chunk per sentence, first audio after the first sentence's
        synthesis.  Validation (bad speaker_id, unreadable prompt) happens
        HERE, before any response bytes, because infer_stream analyses the
        prompt eagerly."""
        prompt, speaker_id, used_seed, gen = self.parse_request(req)
        self.last_seed = used_seed
        mtps = int(req.get("max_text_tokens_per_sentence", 120))
        if self.continuous:
            # sentences join the shared pool and chunks stream out in order
            # as each sentence's codes finish — with THIS request's sampling
            # params and seed (per-slot traced vectors in the step kernel)
            pool, sampling, max_mel, headers = self._pool_gen(gen)
            return used_seed, self.engine().pool_infer_stream(
                pool, prompt, req["text"], speaker_id=speaker_id,
                max_text_tokens_per_sentence=mtps, seed=used_seed,
                sampling=sampling, max_mel_tokens=max_mel), headers
        return used_seed, self.engine().infer_stream(
            prompt, req["text"], speaker_id=speaker_id, seed=used_seed,
            max_text_tokens_per_sentence=mtps, **gen), {}

    def _pool_tts(self, req: Dict[str, Any], prompt, speaker_id,
                  used_seed: int, gen: Dict[str, Any]):
        """Continuous mode: sentences join the shared pool with THIS
        request's sampling params and seed (reference api.py:177-299
        per-request contract).  X-Seed is honest: with the returned seed,
        identical params and text, the output reproduces bit-exactly even
        under concurrent traffic (token i of sentence s samples from a pure
        function of the request seed)."""
        import tempfile as _tf

        from indextts_tpu_torch.utils import audio as audio_io

        eng = self.engine()
        pool, sampling, max_mel, headers = self._pool_gen(gen)
        sr, wav = eng.pool_infer(
            pool, prompt, req["text"], speaker_id=speaker_id,
            max_text_tokens_per_sentence=int(
                req.get("max_text_tokens_per_sentence", 120)),
            seed=used_seed, sampling=sampling, max_mel_tokens=max_mel)
        out = _tf.NamedTemporaryFile(suffix=".wav", delete=False)
        out.close()
        try:
            audio_io.write_wav(out.name, wav, sr)
            with open(out.name, "rb") as f:
                data = f.read()
        finally:
            os.unlink(out.name)
        self.last_seed = used_seed
        return data, headers


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (/tts_stream) requires HTTP/1.1 — under the
        # default HTTP/1.0 spec-conforming clients would not de-chunk
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            """→ (request dict, uploaded-temp-file path or None).  The temp
            path stays a HANDLER-LOCAL value: a cleanup key inside the
            request dict would be client-controlled (arbitrary unlink)."""
            n = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(n) if n else b""
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype == "application/json":
                return json.loads(raw.decode("utf-8") or "{}"), None
            if ctype == "multipart/form-data":
                # browser-form + file-upload support (the FastAPI server's
                # multipart contract, api.py:199-216) via the stdlib email
                # parser; uploaded audio lands in a temp file exposed to the
                # service as audio_path
                import email.parser

                hdr = (f"Content-Type: {self.headers['Content-Type']}\r\n"
                       "\r\n").encode()
                msg = email.parser.BytesParser().parsebytes(hdr + raw)
                out: Dict[str, Any] = {}
                tmp_path = None
                for part in msg.get_payload():
                    name = part.get_param("name",
                                          header="content-disposition")
                    if not name:
                        continue
                    filename = part.get_param("filename",
                                              header="content-disposition")
                    payload = part.get_payload(decode=True) or b""
                    if filename:
                        suffix = os.path.splitext(filename)[1] or ".wav"
                        tmp = tempfile.NamedTemporaryFile(
                            suffix=suffix, delete=False)
                        tmp.write(payload)
                        tmp.close()
                        out["audio_path"] = tmp.name
                        tmp_path = tmp.name
                    else:
                        out[name] = payload.decode("utf-8")
                return out, tmp_path
            pairs = urllib.parse.parse_qsl(raw.decode("utf-8"))
            return dict(pairs), None

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/health":
                self._json(200, {"status": "ok",
                                 "model_loaded": service._tts is not None})
            elif path == "/models":
                self._json(200, service.models())
            elif path == "/ui" or path == "/ui/" or path == "/":
                # browser UI (FastAPI mounts static/; same page here)
                static = os.path.join(os.path.dirname(__file__), "..", "..",
                                      "static", "index.html")
                if not os.path.isfile(static):
                    self._json(404, {"error": "static UI not found"})
                    return
                with open(static, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            try:
                req, tmp_upload = self._read_body()
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": f"bad body: {e}"})
                return
            try:
                self._dispatch_post(path, req)
            finally:
                if tmp_upload and os.path.exists(tmp_upload):
                    os.unlink(tmp_upload)

        def _dispatch_post(self, path: str, req: Dict[str, Any]) -> None:
            if path == "/model/reload":
                # "model_filename" is the reference's request field
                # (api.py ModelReloadRequest); "gpt_path" is ours
                gpt_path = req.get("gpt_path") or req.get("model_filename")
                if not gpt_path:
                    self._json(400, {"error": "missing gpt_path"})
                    return
                try:
                    self._json(200, service.reload(gpt_path))
                except FileNotFoundError as e:
                    self._json(404, {"error": f"checkpoint not found: {e}"})
                except NotImplementedError as e:
                    self._json(500, {"error": str(e)})
            elif path == "/tts":
                try:
                    data, used_seed, extra = service.tts(req)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:  # unreadable prompt file, etc. —
                    # a dropped connection (no HTTP response at all) is
                    # strictly worse than a 500
                    self._json(500, {"error": f"synthesis failed: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Seed", str(used_seed))
                for k, v in extra.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)
            elif path == "/tts_stream":
                # chunked-transfer WAV: header + one PCM chunk per sentence,
                # first bytes on the wire after ONE sentence's synthesis
                from indextts_tpu_torch.utils.audio import wav_stream_header

                try:
                    seed, chunks, extra = service.tts_stream(req)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:
                    self._json(500, {"error": f"synthesis failed: {e}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Seed", str(seed))
                for k, v in extra.items():
                    self.send_header(k, v)
                self.end_headers()

                def emit(payload: bytes) -> None:
                    if not payload:
                        # a zero-length chunk IS the chunked-transfer
                        # terminator — emitting one for an empty sentence
                        # truncates the stream and corrupts keep-alive
                        return
                    self.wfile.write(f"{len(payload):X}\r\n".encode())
                    self.wfile.write(payload)
                    self.wfile.write(b"\r\n")

                sent_header = False
                for sr, chunk in chunks:
                    if not sent_header:
                        emit(wav_stream_header(sr))
                        sent_header = True
                    emit(chunk.tobytes())
                if not sent_header:
                    emit(wav_stream_header(24000))
                self.wfile.write(b"0\r\n\r\n")
            else:
                self._json(404, {"error": f"unknown path {path}"})

    return Handler


def add_pool_args(p) -> None:
    """`--pool-*` decode-pool tuning flags, shared by both server CLIs."""
    p.add_argument("--pool-slots", type=int, default=None,
                   help="decode-pool slots (--continuous; default 8)")
    p.add_argument("--pool-steps-per-tick", type=int, default=None,
                   help="decode steps per pool dispatch (--continuous; "
                        "default: 16 on CUDA, 1 on CPU)")
    p.add_argument("--pool-staging", type=int, default=None,
                   help="staging rows for in-kernel slot refill "
                        "(--continuous; default: min(slots, max(8, 3*slots/8)) when "
                        "steps-per-tick > 1, else 0)")
    p.add_argument("--pool-dp", type=int, default=None,
                   help="data-parallel pools: one decode pool per card "
                        "over the first N local devices (--continuous)")
    p.add_argument("--pool-beam-groups", type=int, default=None,
                   help="beam-pool groups for concurrent num_beams=3 requests "
                        "(--continuous; default 2)")


def pool_kwargs_from_args(args) -> Optional[Dict[str, Any]]:
    kw = {k: v for k, v in [
        ("num_slots", args.pool_slots),
        ("steps_per_tick", args.pool_steps_per_tick),
        ("staging_rows", args.pool_staging),
        ("dp", args.pool_dp)] if v is not None}
    return kw or None


class TTSHTTPServer(ThreadingHTTPServer):
    """HTTP server whose shutdown() also closes the service: stops and
    joins the continuous-mode drive threads and drops the engine.  Callers
    (tests, operators) that stop the listener must not be able to leak the
    drive loop — shutdown IS teardown."""

    service: TTSService

    def shutdown(self) -> None:
        super().shutdown()
        self.service.close()
        self.server_close()


def serve(cfg_path: str = "checkpoints/config.yaml",
          model_dir: str = "checkpoints", host: str = "0.0.0.0",
          port: int = 7859, **kwargs) -> TTSHTTPServer:
    service = TTSService(cfg_path, model_dir, **kwargs)
    httpd = TTSHTTPServer((host, port), make_handler(service))
    httpd.service = service
    return httpd


def main(argv=None, device: Optional[str] = None) -> None:
    """The server's command line; `device` ("cpu" or "cuda", default cuda)
    is for callers that run it from Python."""
    import argparse

    p = argparse.ArgumentParser(description="IndexTTS stdlib HTTP server")
    p.add_argument("--config", default="checkpoints/config.yaml")
    p.add_argument("--model_dir", default="checkpoints")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7859)
    p.add_argument("--gpt_path", default=None,
                   help="GPT checkpoint (.pth), absolute or relative to --model_dir "
                        "(default: the config's gpt_checkpoint there)")
    p.add_argument("--speaker_info_path", default=None,
                   help="speaker_info.json of the speakers that speaker_id may name")
    p.add_argument("--continuous", action="store_true",
                   help="cross-request continuous-batching decode pool")
    add_pool_args(p)
    p.add_argument("--warmup", action="store_true",
                   help="run the decode pool once before accepting "
                        "traffic (--continuous)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel inference over N cards (the trunk's products "
                        "split over cuda:0..N-1, one process a card; not with --continuous)")
    args = p.parse_args(argv)
    httpd = serve(args.config, args.model_dir, args.host, args.port,
                  gpt_path=args.gpt_path, speaker_info_path=args.speaker_info_path,
                  continuous=args.continuous, tp=args.tp,
                  pool_kwargs=pool_kwargs_from_args(args),
                  beam_pool_kwargs=(
                      {"num_groups": args.pool_beam_groups}
                      if args.pool_beam_groups else None),
                  warmup_pool=args.warmup, device=device)
    if args.continuous and args.warmup:
        httpd.service.pool()  # build and warm the pool before serving
    print(f"serving on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.service.close()


if __name__ == "__main__":
    main()
