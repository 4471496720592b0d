"""Fine-tune quality evaluation with the port (counterpart of
tools/eval_quality.py; BASELINE config 3: speaker similarity / WER over
validation clips).

For each ``audio_path<TAB>transcript`` line of ``--audio_list`` (the format
extraction reads), this synthesizes the transcript on the card with the clip
as the zero-shot prompt and reports:

  * **speaker_sim**: cosine similarity between the ECAPA speaker embeddings
    of the prompt clip and of the synthesized audio (utils/eval_metrics.py);
  * **wer/cer**: only when ``--asr-cmd`` supplies an external ASR (none ships
    with the package): the command template receives ``{wav}`` and prints
    the transcript, e.g. ``--asr-cmd "whisper-cli --output - {wav}"``.

Prints one JSON line with the mean metrics.  ``--self-test`` runs the metric
pipeline on a synthetic waveform pair and random weights, on the device
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.tools import _common


def _asr_transcribe(asr_cmd: str, wav_path: str) -> str:
    cmd = [p.format(wav=wav_path) for p in shlex.split(asr_cmd)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"ASR command failed ({out.returncode}): "
                           f"{out.stderr[-500:]}")
    return out.stdout.strip()


def self_test(device: str = "cuda") -> Dict[str, Any]:
    """Metric-pipeline check with random weights and audio on `device`: the
    speaker similarity of a waveform with itself must be 1 within 1e-4, and
    the WER/CER arithmetic exact."""
    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.models import bigvgan as bigvgan_model
    from indextts_tpu_torch.utils.eval_metrics import cer, speaker_similarity, wer

    dev = _common.device_of(device)
    cfg = BigVGANConfig(upsample_rates=[2], upsample_kernel_sizes=[4],
                        upsample_initial_channel=16, resblock_kernel_sizes=[3],
                        resblock_dilation_sizes=[[1]], speaker_embedding_dim=8, gpt_dim=64)
    params = bigvgan_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                       torch.float32, dev)
    rng = np.random.default_rng(0)
    wav = rng.standard_normal(24000).astype(np.float32) * 0.1
    sim = speaker_similarity(params, wav, wav)
    ok = abs(sim - 1.0) < 1e-4 and wer("a b", "a b") == 0.0 \
        and abs(cer("你好世界", "你好地球") - 0.5) < 1e-9
    return {"metric": "quality_selftest", "speaker_sim_self": sim, "ok": bool(ok),
            "device": _common.card(dev)}


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--audio_list", help="audio_path<TAB>transcript lines")
    p.add_argument("--config", default="checkpoints/config.yaml")
    p.add_argument("--model_dir", default="checkpoints")
    p.add_argument("--gpt_path", default=None)
    p.add_argument("--asr-cmd", default=None,
                   help="external ASR command template with {wav}; enables WER/CER")
    p.add_argument("--max_clips", type=int, default=0)
    p.add_argument("--self-test", action="store_true",
                   help="run the metric pipeline on synthetic data")
    _common.add_device_arg(p)
    args = p.parse_args(argv)

    if args.self_test:
        return _common.emit(self_test(args.device))
    if not args.audio_list:
        p.error("--audio_list is required (or use --self-test)")

    from indextts_tpu_torch.engine import IndexTTS
    from indextts_tpu_torch.train.lora import tree_map
    from indextts_tpu_torch.utils import audio as audio_io
    from indextts_tpu_torch.utils.eval_metrics import cer, speaker_similarity, wer

    eng = IndexTTS(cfg_path=args.config, model_dir=args.model_dir, gpt_path=args.gpt_path,
                   device=args.device)
    bigvgan_fp32 = tree_map(lambda t: t.float(), eng.bigvgan_params)
    sims, wers, cers = [], [], []
    with open(args.audio_list, encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    if args.max_clips:
        lines = lines[: args.max_clips]
    for i, (clip, text) in enumerate(lines):
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "synth.wav")
            eng.infer(clip, text, out, verbose=False)
            # read_wav returns float32 in [-1, 1] shaped (C, T);
            # speaker_similarity mixes multi-channel input to mono itself
            synth, sr = audio_io.read_wav(out)
            prompt = audio_io.load_prompt_audio(clip, sr)
            sims.append(speaker_similarity(bigvgan_fp32, prompt, synth, sr))
            if args.asr_cmd:
                hyp = _asr_transcribe(args.asr_cmd, out)
                wers.append(wer(text, hyp))
                cers.append(cer(text, hyp))
        print(f"[{i + 1}/{len(lines)}] sim={sims[-1]:.4f}", file=sys.stderr)

    result: Dict[str, Any] = {"metric": "finetune_quality", "clips": len(sims),
                              "speaker_sim_mean": round(float(np.mean(sims)), 4)}
    if wers:
        result["wer_mean"] = round(float(np.mean(wers)), 4)
        result["cer_mean"] = round(float(np.mean(cers)), 4)
    else:
        result["wer"] = "requires --asr-cmd (no ASR ships with the package)"
    result["device"] = _common.card(eng.device)
    return _common.emit(result)


if __name__ == "__main__":
    main()
