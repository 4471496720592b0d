"""Real-weight verification gate of the PyTorch port (counterpart of
indextts_tpu/verify.py): convert, run the battery, score quality.

The one-command check to run when real reference checkpoints are at hand:
build the port's engine from a model directory (which strict-converts the
``.pth`` files through io/checkpoint.py), push the reference's 11-case
regression battery (reference tests/regression_test.py:4-42) through
``infer``/``infer_fast`` on the card, and score every clip with the
quality metrics of utils/eval_metrics.py (speaker similarity always,
WER/CER when an external ``--asr-cmd`` is supplied).

    python -m indextts_tpu_torch.tools.verify_weights <model_dir> --prompt p.wav
    python -m indextts_tpu_torch.tools.verify_weights --dry-run --prompt p.wav

``--dry-run`` exercises the whole gate on freshly exported synthetic
checkpoints (random weights through io/export.py, the repository's
``checkpoints_test/vocab.txt``), so the command stays verified without real
weights.  The engine runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

# The reference's regression battery (tests/regression_test.py:4-42):
# (text, mode) where mode picks the reference's ``tts.infer`` or
# ``tts.infer_fast`` call, exactly as the upstream script does.
REGRESSION_BATTERY = [
    ("暈 XUAN4 是 一 種 GAN3 覺", "infer"),
    ("大家好，我現在正在bilibili 體驗 ai 科技，說實話，來之前我絕對想不到！"
     "AI技術已經發展到這樣匪夷所思的地步了！", "infer"),
    ("There is a vehicle arriving in dock number 7?", "infer"),
    ("“我愛你！”的英語是“I love you!”", "infer"),
    ("Joseph Gordon-Levitt is an American actor", "infer"),
    ("約瑟夫·高登-萊維特是美國演員", "infer"),
    ("蒂莫西·唐納德·庫克（英文名：Timothy Donald Cook），通稱蒂姆·庫克"
     "（Tim Cook），現任蘋果公司執行長。", "infer"),
    ("親愛的夥伴們，大家好！每一次的努力都是為了更好的未來，要善於從失敗中汲取經驗，"
     "讓我們一起勇敢前行,邁向更加美好的明天！", "infer_fast"),
    ("The weather is really nice today, perfect for studying at home."
     "Thank you!", "infer_fast"),
    ("葉遠隨口答應一聲，一定幫忙云云。"
     "教授看葉遠的樣子也知道，這事情多半是黃了。"
     "誰得到這樣的東西也不會輕易貢獻出來，這是很大的一筆財富。"
     "葉遠回來後，又自己做了幾次試驗，發現空間湖水對一些外傷也有很大的幫助。"
     "找來一隻斷了腿的兔子，喝下空間湖水，一天時間，兔子就完全好了。"
     "還想多做幾次試驗，可是身邊沒有試驗的物件，就先放到一邊，"
     "瞭解空間湖水可以飲用，而且對人有利，這些就足夠了。"
     "感謝您的收聽，下期再見！", "infer_fast"),
    ("《盜夢空間》是由美國華納兄弟影片公司出品的電影，由克里斯托弗·諾蘭執導並編劇，"
     "萊昂納多·迪卡普里奧、瑪麗昂·歌迪亞、約瑟夫·高登-萊維特、艾利奧特·佩吉、"
     "湯姆·哈迪等聯袂主演，2010年7月16日在美國上映，2010年9月1日在中國內地上映，"
     "2020年8月28日在中國內地重映。影片劇情遊走於夢境與現實之間，"
     "被定義為“發生在意識結構內的當代動作科幻片”，"
     "講述了由萊昂納多·迪卡普里奧扮演的造夢師，帶領特工團隊進入他人夢境，"
     "從他人的潛意識中盜取機密，並重塑他人夢境的故事。", "infer_fast"),
]

def _asr_transcribe(asr_cmd: str, wav_path: str) -> str:
    """Run the external ASR hook: a shell template receiving ``{wav}`` that
    prints the transcript to stdout (the contract of tools/eval_quality.py)."""
    import shlex
    import subprocess

    cmd = [p.format(wav=wav_path) for p in shlex.split(asr_cmd)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"ASR command failed ({out.returncode}): "
                           f"{out.stderr[-500:]}")
    return out.stdout.strip()


def run_battery(engine, prompt_wav: str, out_dir: str,
                asr_cmd: Optional[str] = None,
                decode_kw: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """Push all 11 battery cases through the engine; return per-case records.

    Each record: text head, mode, wav path, sample count, rtf, speaker-sim
    vs the prompt, and (with ``asr_cmd``) wer/cer vs the input text.
    Raises on any structural failure (bad sr, empty/non-finite audio) —
    that IS the gate.
    """
    from indextts_tpu_torch.utils.audio import read_wav, resample
    from indextts_tpu_torch.utils.eval_metrics import cer, speaker_similarity, wer

    os.makedirs(out_dir, exist_ok=True)
    # read_wav returns float32 in [-1, 1] shaped (C, T); bring the prompt to
    # the engine's 24 kHz so speaker embeddings see matched mels
    prompt, prompt_sr = read_wav(prompt_wav)
    if prompt_sr != 24000:
        prompt = resample(prompt, prompt_sr, 24000)
    kw = dict(decode_kw or {})
    records: List[Dict[str, Any]] = []
    for i, (text, mode) in enumerate(REGRESSION_BATTERY):
        out = os.path.join(out_dir, f"case{i:02d}.wav")
        fn = engine.infer if mode == "infer" else engine.infer_fast
        t0 = time.time()
        path = fn(prompt_wav, text, out, **kw)
        wall = time.time() - t0
        if path != out:
            raise RuntimeError(f"case {i}: engine returned {path!r}, not {out!r}")
        wav, sr = read_wav(out)
        if sr != 24000:
            raise RuntimeError(f"case {i}: sample rate {sr} != 24000")
        if wav.shape[-1] < 1024:
            raise RuntimeError(f"case {i}: only {wav.shape[-1]} samples")
        if not np.isfinite(wav).all():
            raise RuntimeError(f"case {i}: non-finite audio")
        rec: Dict[str, Any] = {
            "case": i, "mode": mode, "text": text[:32], "wav": out,
            "samples": int(wav.shape[-1]),
            "seconds": round(wav.shape[-1] / 24000.0, 3),
            "wall_s": round(wall, 3),
            "rtf": round(float(engine.last_stats.get("rtf", 0.0)), 4),
            "speaker_sim": round(speaker_similarity(
                engine.bigvgan_params, wav, prompt), 4),
        }
        if asr_cmd:
            hyp = _asr_transcribe(asr_cmd, out)
            rec["asr"] = hyp[:64]
            rec["wer"] = round(wer(text, hyp), 4)
            rec["cer"] = round(cer(text, hyp), 4)
        records.append(rec)
    return records


def verify_model_dir(model_dir: str,
                     cfg_path: Optional[str] = None,
                     prompt_wav: Optional[str] = None,
                     out_dir: Optional[str] = None,
                     asr_cmd: Optional[str] = None,
                     min_speaker_sim: Optional[float] = None,
                     allow_random: bool = False,
                     decode_kw: Optional[Dict[str, Any]] = None,
                     precision_config: Optional[Dict[str, str]] = None,
                     device: Optional[str] = None) -> Dict[str, Any]:
    """Full gate: checkpoint presence → strict conversion (engine build on
    `device`, the card by default) → 11-case battery → quality metrics.
    Returns the report dict; raises on any hard failure so shell callers
    get a non-zero exit."""
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.config import Config

    cfg_path = cfg_path or os.path.join(model_dir, "config.yaml")
    cfg = Config.load(cfg_path)
    report: Dict[str, Any] = {"model_dir": model_dir, "config": cfg_path}

    gpt_path = os.path.join(model_dir, cfg.gpt_checkpoint)
    bv_path = os.path.join(model_dir, cfg.bigvgan_checkpoint)
    missing = [p for p in (gpt_path, bv_path) if not os.path.exists(p)]
    report["checkpoints"] = {"gpt": gpt_path, "bigvgan": bv_path,
                             "missing": missing}
    if missing and not allow_random:
        raise FileNotFoundError(
            "verify-weights needs real checkpoints; missing: "
            + ", ".join(missing)
            + " (use --allow-random only to exercise the gate itself)")
    if not prompt_wav or not os.path.exists(prompt_wav):
        raise FileNotFoundError(f"prompt wav {prompt_wav} not found (pass --prompt)")

    t0 = time.time()
    engine = engine_mod.IndexTTS(
        cfg_path=cfg_path, model_dir=model_dir, is_fp16=False, device=device,
        precision_config=precision_config or {"gpt": "fp32", "vocoder": "fp32"})
    report["build_s"] = round(time.time() - t0, 1)
    report["device"] = str(engine.device)

    out_dir = out_dir or os.path.join(model_dir, "verify_out")
    records = run_battery(engine, prompt_wav, out_dir,
                          asr_cmd=asr_cmd, decode_kw=decode_kw)
    report["cases"] = records
    sims = [r["speaker_sim"] for r in records]
    report["speaker_sim_mean"] = round(float(np.mean(sims)), 4)
    report["speaker_sim_min"] = round(float(np.min(sims)), 4)
    if asr_cmd:
        report["wer_mean"] = round(float(np.mean([r["wer"] for r in records])), 4)
        report["cer_mean"] = round(float(np.mean([r["cer"] for r in records])), 4)
    report["battery_ok"] = True
    if min_speaker_sim is not None:
        report["speaker_sim_ok"] = report["speaker_sim_mean"] >= min_speaker_sim
        if not report["speaker_sim_ok"]:
            raise RuntimeError(
                f"speaker-sim gate failed: mean {report['speaker_sim_mean']} "
                f"< {min_speaker_sim}")
    return report


def make_synthetic_model_dir(d: str, vocab_src: Optional[str] = None) -> str:
    """Build a small model dir (tools/_common.TINY_MODEL) with freshly
    EXPORTED ``.pth`` checkpoints (random weights from torch seeds 0 and 1
    through io/export.py), so ``--dry-run`` exercises the exact
    convert-and-load path real weights will take."""
    import shutil

    import torch

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.io import export as export_io
    from indextts_tpu_torch.models import bigvgan as bigvgan_model
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.tools._common import TINY_MODEL, VOCAB

    os.makedirs(d, exist_ok=True)
    cfg = Config.from_dict(TINY_MODEL)
    cfg.save(os.path.join(d, "config.yaml"))
    shutil.copy(vocab_src or VOCAB, os.path.join(d, "vocab.txt"))
    gpt_params = uv.init_params(cfg.gpt, torch.Generator().manual_seed(0))
    export_io.save_gpt_pth(os.path.join(d, cfg.gpt_checkpoint),
                           gpt_params, cfg.gpt, save_dtype="fp32")
    bv_params = bigvgan_model.init_params(cfg.bigvgan, torch.Generator().manual_seed(1))
    export_io.save_bigvgan_pth(os.path.join(d, cfg.bigvgan_checkpoint),
                               bv_params, cfg.bigvgan)
    return d


def main(argv=None) -> Dict[str, Any]:
    import argparse

    p = argparse.ArgumentParser(
        description="Verify real checkpoints: convert, run the 11-case "
                    "battery, score quality (reference tests/regression_test.py)")
    p.add_argument("model_dir", nargs="?", default="finetune_models")
    p.add_argument("--config", default=None, help="config.yaml "
                   "(default: <model_dir>/config.yaml)")
    p.add_argument("--prompt", required=True,
                   help="zero-shot prompt wav for the battery")
    p.add_argument("--out-dir", default=None,
                   help="where battery WAVs go (default <model_dir>/verify_out)")
    p.add_argument("--report", default=None, help="write the JSON report here")
    p.add_argument("--asr-cmd", default=None,
                   help="external ASR template, receives {wav}, prints the "
                        "transcript (enables WER/CER)")
    p.add_argument("--min-speaker-sim", type=float, default=None,
                   help="fail if mean speaker-sim is below this")
    p.add_argument("--max-mel-tokens", type=int, default=None,
                   help="cap decode length (quick structural runs)")
    p.add_argument("--allow-random", action="store_true",
                   help="proceed with random init where checkpoints are "
                        "missing (gate rehearsal only)")
    p.add_argument("--dry-run", action="store_true",
                   help="export synthetic small checkpoints to a temp dir and "
                        "verify those: proves the gate end to end without weights")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)

    decode_kw: Dict[str, Any] = {}
    if a.max_mel_tokens:
        decode_kw["max_mel_tokens"] = a.max_mel_tokens

    if a.dry_run:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="verify_dry_") as tmp:
            d = make_synthetic_model_dir(os.path.join(tmp, "model"))
            decode_kw.setdefault("max_mel_tokens", 8)
            decode_kw.setdefault("do_sample", False)
            decode_kw.setdefault("repetition_penalty", 1.0)
            decode_kw.setdefault("num_beams", 1)
            report = verify_model_dir(
                d, prompt_wav=a.prompt, asr_cmd=a.asr_cmd,
                min_speaker_sim=a.min_speaker_sim, decode_kw=decode_kw,
                out_dir=os.path.join(tmp, "out"), device=a.device)
            report["dry_run"] = True
    else:
        report = verify_model_dir(
            a.model_dir, cfg_path=a.config, prompt_wav=a.prompt,
            out_dir=a.out_dir, asr_cmd=a.asr_cmd,
            min_speaker_sim=a.min_speaker_sim, allow_random=a.allow_random,
            decode_kw=decode_kw, device=a.device)

    line = json.dumps(report, ensure_ascii=False)
    print(line)
    if a.report:
        with open(a.report, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
