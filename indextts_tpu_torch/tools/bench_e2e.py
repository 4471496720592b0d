"""End-to-end engine RTF of the port on the card (counterpart of
tools/bench_e2e.py; random weights, the model directory's config).

    python -m indextts_tpu_torch.tools.bench_e2e [--quant int8|int4|none] [--beams N]
        [--long] [--max-mel-tokens N]

Measures the public `IndexTTS.infer`, `infer_fast` (with `--long`) and
`infer_stream` surfaces: conditioning, decode, latent re-forward, vocoder,
WAV.  Each mode runs once untimed, then once timed between
`torch.cuda.synchronize()` calls; `infer_stream` shares `infer`'s warm-up
(torch compiles nothing per shape, and the two run the same work).  The
numbers characterise pipeline speed, not audio quality.  Prints ONE JSON
line: each mode's RTF, wall and audio seconds and time to first audio, the
card, and each mode's kernel launches.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np

from indextts_tpu_torch.tools import _common

TEXT = "親愛的夥伴們，大家好！每一次的努力都是為了更好的未來。"


def write_tone(path: str, seconds: float = 3.0, sr: int = 24000) -> str:
    """A 220 Hz tone as a 24 kHz int16 prompt wav."""
    from indextts_tpu_torch.utils.audio import write_wav

    t = np.arange(int(sr * seconds)) / sr
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16), sr)
    return path


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quant", default="int8", choices=["none", "int8", "int4"])
    ap.add_argument("--beams", type=int, default=1)
    ap.add_argument("--model_dir", default=os.path.join(_common.REPO, "checkpoints_test"))
    ap.add_argument("--long", action="store_true",
                    help="the text eight times over (several sentences); also measures "
                         "infer_fast")
    ap.add_argument("--prompt", default=None,
                    help="prompt wav (default: a synthesized 3 s tone)")
    ap.add_argument("--max-mel-tokens", type=int, default=None,
                    help="cap each sentence's codes (default: the engine's 600)")
    ap.add_argument("--seed", type=int, default=0)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_of(args.device)

    from indextts_tpu_torch.engine import IndexTTS

    prec = {"gpt": "bf16" if args.quant == "none" else args.quant}
    tts = IndexTTS(cfg_path=os.path.join(args.model_dir, "config.yaml"),
                   model_dir=args.model_dir, precision_config=prec, seed=args.seed,
                   device=str(device))
    text = TEXT * 8 if args.long else TEXT
    kw: Dict[str, Any] = dict(num_beams=args.beams)
    if args.max_mel_tokens:
        kw["max_mel_tokens"] = args.max_mel_tokens
    results: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as tmp:
        prompt = args.prompt or write_tone(os.path.join(tmp, "prompt.wav"))
        out = os.path.join(tmp, "out.wav")

        def timed(mode: str, call) -> None:
            before = _common.launches()
            _common.sync(device)
            t0 = time.perf_counter()
            extra = call()
            _common.sync(device)
            wall = time.perf_counter() - t0
            s = tts.last_stats
            results[mode] = {"rtf": s["rtf"], "wall_s": wall, "audio_s": s["wav_seconds"],
                             "ttfa_s": s.get("time_to_first_audio"),
                             **(extra if isinstance(extra, dict) else {}),
                             "launches": _common.launches_since(before)}

        tts.infer(prompt, text, out, **kw)                       # warm-up
        timed("infer", lambda: tts.infer(prompt, text, out, **kw))
        if args.long:
            tts.infer_fast(prompt, text, out, **kw)              # warm-up
            timed("infer_fast", lambda: tts.infer_fast(prompt, text, out, **kw))

        def stream():
            t0 = time.perf_counter()
            first, chunks = None, 0
            for _ in tts.infer_stream(prompt, text, **kw):
                first = first if first is not None else time.perf_counter() - t0
                chunks += 1
            return {"chunks": chunks, "first_chunk_s": first}

        timed("infer_stream", stream)
    for mode, r in results.items():
        print(f"[e2e {args.quant} beams={args.beams}] {mode} RTF {r['rtf']:.4f} "
              f"({r['wall_s']:.2f}s wall, {r['audio_s']:.2f}s audio)", file=sys.stderr)
    return _common.emit({
        "metric": "e2e_rtf", "quant": args.quant, "beams": args.beams, "long": args.long,
        "sentences": len(tts.last_stats.get("code_lens", [])), "modes": results,
        "max_mel_tokens": kw.get("max_mel_tokens", 600),
        "warmup": "one untimed call of infer and of infer_fast; infer_stream shares "
                  "infer's",
        "timing": "host clock between torch.cuda.synchronize() calls",
        "device": _common.card(device)})


if __name__ == "__main__":
    main()
