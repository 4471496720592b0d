"""Command-line synthesis with the PyTorch port (reference surface:
indextts/cli.py:7-59).

    python -m indextts_tpu_torch.cli "text" -v prompt.wav -o out.wav \
        --model_dir checkpoints_test
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="indextts", description="IndexTTS synthesis (PyTorch)")
    p.add_argument("text", help="text to synthesize")
    p.add_argument("-v", "--voice", required=True, help="prompt/reference WAV")
    p.add_argument("-o", "--output_path", default="gen.wav")
    p.add_argument("-c", "--config", default=None, help="config.yaml path")
    p.add_argument("--model_dir", default="checkpoints")
    p.add_argument("-d", "--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--fp16", action="store_true", default=True)
    p.add_argument("--no-fp16", dest="fp16", action="store_false")
    p.add_argument("-f", "--force", action="store_true", help="overwrite output")
    p.add_argument("--fast", action="store_true", help="use infer_fast")
    p.add_argument("--stream", action="store_true",
                   help="sentence-streaming synthesis: the output is rewritten after each "
                        "chunk; prints the time to first audio")
    p.add_argument("--speaker_id", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num_beams", type=int, default=None,
                   help="beams of the decode (default 3, the reference's; 1 samples "
                        "one row)")
    p.add_argument("--cfg_scale", type=float, default=None,
                   help="classifier-free guidance scale (sampling mode; 1.0 = off)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel inference over N cards (the trunk's products "
                        "split over cuda:0..N-1, one process a card; with -d cpu, N gloo "
                        "processes)")
    args = p.parse_args(argv)

    if os.path.exists(args.output_path) and not args.force:
        print(f"error: {args.output_path} exists (use -f to overwrite)", file=sys.stderr)
        return 1
    if not os.path.exists(args.voice):
        print(f"error: voice file {args.voice} not found", file=sys.stderr)
        return 1
    cfg_path = args.config or os.path.join(args.model_dir, "config.yaml")

    from indextts_tpu_torch.engine import IndexTTS

    tts = IndexTTS(cfg_path=cfg_path, model_dir=args.model_dir, is_fp16=args.fp16,
                   device=args.device, seed=args.seed, tp=args.tp)
    try:
        return _synthesise(tts, args)
    finally:
        tts.close()


def _synthesise(tts, args) -> int:
    gen = {}
    if args.num_beams is not None:
        gen["num_beams"] = args.num_beams
    if args.cfg_scale is not None:
        gen["cfg_scale"] = args.cfg_scale
    if args.stream:
        import numpy as np

        from indextts_tpu_torch.utils.audio import write_wav

        chunks, sr = [], 24000
        stats = {}
        for sr, chunk in tts.infer_stream(args.voice, args.text, verbose=True,
                                          speaker_id=args.speaker_id, stats_out=stats, **gen):
            chunks.append(chunk)
            # progressive output: a player tailing the file hears audio
            # before the synthesis ends
            write_wav(args.output_path, np.concatenate(chunks), sr)
        if not chunks:
            print("error: no audio produced (empty text?)", file=sys.stderr)
            return 1
        ttfa = stats.get("time_to_first_audio")
        print(f">> saved: {args.output_path} (TTFA {-1.0 if ttfa is None else ttfa:.2f}s)")
        return 0
    infer = tts.infer_fast if args.fast else tts.infer
    infer(args.voice, args.text, args.output_path, speaker_id=args.speaker_id, **gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
