"""FastAPI synthesis server of the PyTorch port (counterpart of
indextts_tpu/serve/api.py; reference surface: api.py:38-319).

Endpoints:
  POST /tts           multipart (audio upload or server-side path) → WAV
  POST /tts_stream    chunked WAV, one PCM chunk per sentence
  GET  /models        checkpoint discovery
  POST /model/reload  hot-swap GPT weights
  GET  /health

This module is framework GLUE only: every piece of request-contract logic
(field aliases, seed draw, sampling-param validation, reload resolution,
pool routing, per-request pool sampling) lives in `serve/httpd.TTSService`,
which the stdlib server's real-socket tests exercise end to end — the two
surfaces cannot drift.  FastAPI/uvicorn are optional extras; importing this
module without them raises a clear error (the rest of the package stays
importable).  The engine runs on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

try:
    from fastapi import FastAPI, File, Form, HTTPException, Request, UploadFile
    from fastapi.concurrency import run_in_threadpool
    from fastapi.responses import Response
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "fastapi is required for the API server: pip install fastapi uvicorn"
    ) from e

from indextts_tpu_torch.engine import IndexTTS  # noqa: E402
from indextts_tpu_torch.serve.httpd import TTSService  # noqa: E402


def create_app(
    cfg_path: str = "checkpoints/config.yaml",
    model_dir: str = "checkpoints",
    gpt_path: Optional[str] = None,
    speaker_info_path: Optional[str] = None,
    engine_instance: Optional[IndexTTS] = None,
    continuous: bool = False,
    tp: int = 0,
    pool_kwargs: Optional[Dict[str, Any]] = None,
    beam_pool_kwargs: Optional[Dict[str, Any]] = None,
    warmup_pool: bool = False,
    device: Optional[str] = None,
) -> "FastAPI":
    app = FastAPI(title="IndexTTS")
    service = TTSService(cfg_path, model_dir, gpt_path=gpt_path,
                         speaker_info_path=speaker_info_path,
                         engine_instance=engine_instance,
                         continuous=continuous, pool_kwargs=pool_kwargs,
                         beam_pool_kwargs=beam_pool_kwargs,
                         tp=tp, warmup_pool=warmup_pool, device=device)
    app.state.service = service
    if continuous and warmup_pool:
        service.pool()  # build + precompile before serving

    @app.on_event("shutdown")
    def _shutdown() -> None:
        # stop + join the continuous-mode drive threads (TTSService.close)
        service.close()

    async def _save_upload(audio_file) -> Optional[str]:
        """Uploaded prompt → temp file path (shared by /tts, /tts_stream)."""
        if audio_file is None:
            return None
        suffix = os.path.splitext(audio_file.filename or "prompt.wav")[1] or ".wav"
        tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        tmp.write(await audio_file.read())
        tmp.close()
        return tmp.name

    @app.get("/health")
    def health():
        return {"status": "ok", "model_loaded": service._tts is not None}

    # static browser UI (reference api.py:90-95 mounts static/index.html)
    static_dir = os.path.join(os.path.dirname(__file__), "..", "..", "static")
    if os.path.isdir(static_dir):
        from fastapi.staticfiles import StaticFiles

        app.mount("/ui", StaticFiles(directory=static_dir, html=True), name="ui")

    @app.get("/models")
    def models():
        return service.models()

    @app.post("/model/reload")
    async def reload_model(request: "Request"):
        """Hot-swap GPT weights (api.py:118-175).  Accepts the reference's
        JSON body {"model_filename": ...} or our form/JSON {"gpt_path": ...}."""
        ctype = request.headers.get("content-type", "")
        if ctype.startswith("application/json"):
            body = await request.json()
        else:
            body = dict(await request.form())
        gpt_path = body.get("gpt_path") or body.get("model_filename")
        if not gpt_path:
            raise HTTPException(422, "need 'gpt_path' or 'model_filename'")
        try:
            # OFF the event loop: reload takes the service lock, which a
            # concurrent first request may hold while the engine builds —
            # acquiring it inline would freeze every in-flight response
            out = await run_in_threadpool(service.reload, gpt_path)
        except FileNotFoundError as e:
            raise HTTPException(404, f"checkpoint not found: {e}")
        return {**out, "message": f"switched to {os.path.basename(out['gpt_path'])}"}

    def _req_dict(text, speaker_id, prompt, fields: Dict[str, Any]) -> Dict[str, Any]:
        """Assemble the TTSService request dict (its parse_request applies
        aliases, defaults, seed draw and validation — the socket-tested
        contract).  None-valued fields are omitted so service defaults
        apply."""
        req: Dict[str, Any] = {"text": text}
        if prompt:
            req["audio_path"] = prompt
        if speaker_id:
            req["speaker_id"] = speaker_id
        req.update({k: v for k, v in fields.items() if v is not None})
        return req

    @app.post("/tts")
    async def tts(
        text: str = Form(...),
        audio_file: Optional[UploadFile] = File(None),
        audio_path: Optional[str] = Form(None),
        # reference client field names (api.py:180-182) — full aliases
        prompt_audio: Optional[UploadFile] = File(None),
        prompt_audio_path: Optional[str] = Form(None),
        infer_mode: Optional[str] = Form(None),
        mode: Optional[str] = Form(None),
        speaker_id: Optional[str] = Form(None),
        do_sample: Optional[bool] = Form(None),
        top_p: Optional[float] = Form(None),
        top_k: Optional[int] = Form(None),
        temperature: Optional[float] = Form(None),
        repetition_penalty: Optional[float] = Form(None),
        length_penalty: Optional[float] = Form(None),
        max_mel_tokens: Optional[int] = Form(None),
        max_text_tokens_per_sentence: Optional[int] = Form(None),
        sentences_bucket_max_size: Optional[int] = Form(None),
        seed: Optional[int] = Form(None),
        num_beams: Optional[int] = Form(None),
        cfg_scale: Optional[float] = Form(None),
    ):
        """Synthesis (api.py:177-299).  Returns WAV bytes; the seed used is
        echoed in the X-Seed header."""
        audio_file = audio_file if audio_file is not None else prompt_audio
        prompt = audio_path or prompt_audio_path
        tmp = await _save_upload(audio_file)
        prompt = tmp or prompt
        req = _req_dict(text, speaker_id, prompt, dict(
            mode=infer_mode or mode, do_sample=do_sample, top_p=top_p,
            top_k=top_k, temperature=temperature,
            repetition_penalty=repetition_penalty,
            length_penalty=length_penalty, max_mel_tokens=max_mel_tokens,
            max_text_tokens_per_sentence=max_text_tokens_per_sentence,
            sentences_bucket_max_size=sentences_bucket_max_size,
            seed=seed, num_beams=num_beams, cfg_scale=cfg_scale))
        try:
            # blocking synthesis OFF the event loop: an `async def`
            # endpoint is not threadpooled by FastAPI, so a long decode
            # run inline would freeze every concurrent request, /health
            # included
            data, used_seed, extra = await run_in_threadpool(service.tts, req)
        except ValueError as e:  # bad params / unknown speaker → 4xx
            raise HTTPException(400, str(e))
        finally:
            if tmp is not None:
                import contextlib

                with contextlib.suppress(FileNotFoundError):
                    os.unlink(tmp)
        return Response(content=data, media_type="audio/wav",
                        headers={"X-Seed": str(used_seed), **extra})

    @app.post("/tts_stream")
    async def tts_stream(
        text: str = Form(...),
        audio_file: Optional[UploadFile] = File(None),
        audio_path: Optional[str] = Form(None),
        prompt_audio: Optional[UploadFile] = File(None),
        prompt_audio_path: Optional[str] = Form(None),
        speaker_id: Optional[str] = Form(None),
        do_sample: Optional[bool] = Form(None),
        top_p: Optional[float] = Form(None),
        top_k: Optional[int] = Form(None),
        temperature: Optional[float] = Form(None),
        repetition_penalty: Optional[float] = Form(None),
        length_penalty: Optional[float] = Form(None),
        max_mel_tokens: Optional[int] = Form(None),
        max_text_tokens_per_sentence: Optional[int] = Form(None),
        seed: Optional[int] = Form(None),
        num_beams: Optional[int] = Form(None),
        cfg_scale: Optional[float] = Form(None),
    ):
        """Streaming synthesis: chunked WAV, one PCM chunk per sentence —
        first audio after one sentence's synthesis instead of the whole
        text's."""
        from fastapi.responses import StreamingResponse

        from indextts_tpu_torch.utils.audio import wav_stream_header

        audio_file = audio_file if audio_file is not None else prompt_audio
        prompt = audio_path or prompt_audio_path
        tmp = await _save_upload(audio_file)
        prompt = tmp or prompt
        req = _req_dict(text, speaker_id, prompt, dict(
            do_sample=do_sample, top_p=top_p, top_k=top_k,
            temperature=temperature, repetition_penalty=repetition_penalty,
            length_penalty=length_penalty, max_mel_tokens=max_mel_tokens,
            max_text_tokens_per_sentence=max_text_tokens_per_sentence,
            seed=seed, num_beams=num_beams, cfg_scale=cfg_scale))

        def cleanup_tmp():
            # idempotent: runs both from the generator's finally and from
            # the response BackgroundTask (which also fires when the client
            # disconnects before the generator is first iterated)
            if tmp is not None:
                import contextlib

                with contextlib.suppress(FileNotFoundError):
                    os.unlink(tmp)

        try:
            # service.tts_stream validates and analyses the prompt EAGERLY,
            # so a bad speaker_id / unreadable prompt is a clean 4xx here
            # rather than a broken 200 mid-stream; run it off the event
            # loop like the chunks themselves (Starlette iterates the sync
            # generator via its own threadpool)
            used_seed, chunks, extra = await run_in_threadpool(
                service.tts_stream, req)
        except ValueError as e:
            cleanup_tmp()
            raise HTTPException(400, str(e))
        except Exception as e:
            cleanup_tmp()
            raise HTTPException(
                400, f"could not prepare synthesis (bad prompt audio?): {e}")

        def body():
            sent_header = False
            try:
                for sr, chunk in chunks:
                    if not sent_header:
                        yield wav_stream_header(sr)
                        sent_header = True
                    yield chunk.tobytes()
                if not sent_header:
                    yield wav_stream_header(24000)
            finally:
                cleanup_tmp()

        from starlette.background import BackgroundTask

        return StreamingResponse(body(), media_type="audio/wav",
                                 headers={"X-Seed": str(used_seed), **extra},
                                 background=BackgroundTask(cleanup_tmp))

    return app


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="IndexTTS API server (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7859)
    p.add_argument("--config", default="checkpoints/config.yaml")
    p.add_argument("--model_dir", default="checkpoints")
    p.add_argument("--gpt_path", default=None)
    p.add_argument("--speaker_info", default=None)
    p.add_argument("--warmup", action="store_true",
                   help="precompile common decode shapes before serving")
    p.add_argument("--continuous", action="store_true",
                   help="cross-request continuous-batching decode pool")
    from indextts_tpu_torch.serve.httpd import add_pool_args, pool_kwargs_from_args
    add_pool_args(p)
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel inference over N cards (the trunk's products "
                        "split over cuda:0..N-1, one process a card; not with --continuous)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import uvicorn

    eng = None
    if args.warmup:
        eng = IndexTTS(cfg_path=args.config, model_dir=args.model_dir,
                       gpt_path=args.gpt_path,
                       speaker_info_path=args.speaker_info, device=args.device, tp=args.tp)
        eng.warmup(batch_sizes=(1, 4), num_beams=1)
        eng.warmup(batch_sizes=(1, 4), num_beams=3)
    app = create_app(args.config, args.model_dir, args.gpt_path,
                     args.speaker_info, engine_instance=eng,
                     continuous=args.continuous, tp=args.tp,
                     pool_kwargs=pool_kwargs_from_args(args),
                     beam_pool_kwargs=(
                         {"num_groups": args.pool_beam_groups}
                         if args.pool_beam_groups else None),
                     warmup_pool=args.warmup and args.continuous,
                     device=args.device)
    uvicorn.run(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
