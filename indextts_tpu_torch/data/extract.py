"""Codec extraction: audio -> DVAE mel codes, mels and conditioning
(counterpart of indextts_tpu/data/extract.py).

    python -m indextts_tpu_torch.data.extract --audio_list LIST \\
        --model_dir DIR --output_dir OUT [--extract_condition] [--device cpu]

The reference's missing ``tools/extract_codec.py``, rebuilt from its data
contract (run_extract_code.sh:3, scripts/run_extract.sh:17-37; consumers
data_utils.py:300-353,863-885):

  input   audio_list file, lines ``audio_path<TAB>transcript``
  output  per clip:    {speaker}/codes/{stem}.npy   (int32 DVAE codes)
                       {speaker}/mels/{stem}.npy    (float32 [100, F] log-mel)
          per speaker: metadata_train.jsonl / metadata_valid.jsonl with
                       {audio, text, duration, codes, mels}
                       medoid_condition.npy  (1, 32, D)
                       medoid_mel.npy        (100, F): the medoid clip's mel
          global:      speaker_info.json

The files equal the JAX package's, byte for byte where they are text.
Clips are sorted by length and grouped into ``batch_size`` batches padded
to a ladder of mel-frame widths (FRAME_BUCKETS), the JAX package's buckets:
the bucket width decides what the encoder sees past a shorter clip's end,
so the same buckets give the same batched codes.

Exactness under padding:
  * mel: exact.  Each clip is reflect-padded n_fft//2 on the host and the
    batch STFT runs center=False, so zero-padded batch tails never leak into
    a clip's frames.
  * conditioning: exact for the conformer types, which mask by length.
  * DVAE codes: exact for the longest clip of each batch; a shorter clip's
    last ~(receptive field)/4 codes may differ from a per-clip run, because
    the encoder sees silence frames where its own zero padding would be (the
    reference's batch-16 extraction has the same property).  ``--exact``
    runs clip by clip.

Batches are not padded to ``batch_size`` rows (eager torch compiles no
fixed shape; rows are independent).  Each batch is read back before the
next is queued: the JAX package's one-batch-deep overlap gained nothing on
an H100, where the host's decode, padding and writes bind the wall.  The
mel, the DVAE and the conditioning run with TF32 off.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import Config
from indextts_tpu_torch.ops.mel import mel_filterbank, mel_spectrogram, safe_log, spectrogram
from indextts_tpu_torch.utils import audio as audio_io

# mel-frame bucket ladder: 1-20 s at ~93.75 frames/s -> 94..1875 frames
FRAME_BUCKETS = (256, 512, 768, 1024, 1280, 1536, 2048)


def parse_audio_list(path: str) -> List[Tuple[str, str]]:
    """Lines of ``audio_path<TAB>transcript`` (reference README.md:16)."""
    entries = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or "\t" not in line:
                continue
            audio_path, text = line.split("\t", 1)
            entries.append((audio_path, text))
    return entries


def speaker_of(audio_path: str, list_path: Optional[str] = None) -> str:
    """Speaker id = the clip's parent directory (prepare_audio_list.py
    groups one speaker per directory)."""
    return os.path.basename(os.path.dirname(os.path.abspath(audio_path))) or "speaker"


def speaker_dirs(processed_dir: str) -> List[Tuple[str, str]]:
    """speaker_info.json (a LIST of per-speaker stats dicts keyed by
    "speaker"; a speaker's data lives in processed_dir/<name>) ->
    [(name, dir)].  A dict form {name: {...}} is accepted too."""
    with open(os.path.join(processed_dir, "speaker_info.json")) as f:
        speakers = json.load(f)
    names = (list(speakers.keys()) if isinstance(speakers, dict)
             else [s["speaker"] for s in speakers])
    return [(n, os.path.join(processed_dir, n)) for n in names]


def medoid_index(latents: np.ndarray, chunk_size: int = 2048) -> int:
    """Index of the latent with the least summed distance to all others: the
    per-speaker representative conditioning (config.yaml:31-36).
    latents: [N, ...], flattened per clip."""
    flat = latents.reshape(latents.shape[0], -1).astype(np.float32)
    n = flat.shape[0]
    sq = np.sum(flat * flat, axis=1)
    totals = np.zeros(n, dtype=np.float64)
    for i in range(0, n, chunk_size):
        block = flat[i: i + chunk_size]
        d2 = sq[i: i + chunk_size, None] - 2.0 * block @ flat.T + sq[None, :]
        totals[i: i + chunk_size] = np.sqrt(np.maximum(d2, 0.0)).sum(axis=1)
    return int(np.argmin(totals))


def frames_for(n_samples: int, hop: int = 256) -> int:
    """torchaudio's center=True frame count."""
    return n_samples // hop + 1


def bucket_frames(f: int) -> int:
    for b in FRAME_BUCKETS:
        if f <= b:
            return b
    return -(-f // FRAME_BUCKETS[0]) * FRAME_BUCKETS[0]


class CodecExtractor:
    """Batched mel + DVAE-code + conditioning extraction on one device.

    Weights come from `model_dir`: cfg.dvae_checkpoint (dvae.pth) and
    cfg.gpt_checkpoint (gpt.pth).  Where a file is missing the port draws
    random weights from torch.Generator seeds 0 (DVAE) and 1 (GPT); the JAX
    package draws from PRNGKey(0) and (1), which torch cannot reproduce, so
    only `.pth` weights give both packages the same codes."""

    def __init__(self, cfg: Config, model_dir: str, batch_size: int = 16, device="cuda"):
        from indextts_tpu_torch.io import checkpoint as ckpt_io
        from indextts_tpu_torch.io import from_jax
        from indextts_tpu_torch.models import dvae as dvae_model
        from indextts_tpu_torch.models import unified_voice as uv

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CodecExtractor: CUDA is not available; pass device='cpu' to "
                               "extract on the CPU")
        self.cfg = cfg
        self.batch_size = max(1, batch_size)
        self._uv = uv
        self._dvae = dvae_model

        dvae_path = os.path.join(model_dir, cfg.dvae_checkpoint)
        if os.path.exists(dvae_path):
            self.dvae_params = from_jax.dvae_params_from_numpy(
                ckpt_io.load_dvae_checkpoint(dvae_path, cfg.vqvae), cfg.vqvae,
                torch.float32, self.device)
        else:
            self.dvae_params = dvae_model.init_params(
                cfg.vqvae, torch.Generator(device=self.device).manual_seed(0), torch.float32,
                self.device)
        gpt_path = os.path.join(model_dir, cfg.gpt_checkpoint)
        if os.path.exists(gpt_path):
            tree, _ = ckpt_io.load_gpt_checkpoint(gpt_path, cfg.gpt)
            self.gpt_params = from_jax.gpt_params_from_numpy(tree, cfg.gpt, torch.float32,
                                                             self.device)
        else:
            self.gpt_params = uv.init_params(
                cfg.gpt, torch.Generator(device=self.device).manual_seed(1), torch.float32,
                self.device)

        mel = cfg.dataset.mel
        self._mel_cfg = mel
        self._hop = mel.hop_length
        self._n_fft = mel.n_fft
        self._fb = torch.as_tensor(mel_filterbank(mel.sample_rate, mel.n_fft, mel.n_mels),
                                   device=self.device)

    # -- stages ------------------------------------------------------------

    @torch.no_grad()
    def mel_uncentered(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, L] host-padded audio -> [B, n_mels, F] log-mel (center=False),
        TF32 off."""
        m = self._mel_cfg
        spec = spectrogram(wav, m.n_fft, m.hop_length, m.win_length, power=1.0, center=False)
        with self._dvae.no_tf32():
            return safe_log(torch.einsum("...ft,fm->...mt", spec, self._fb))

    @torch.no_grad()
    def codes(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, 100, F] -> int32 [B, F//4], TF32 off."""
        return self._dvae.get_codebook_indices(self.dvae_params, mel, self.cfg.vqvae)

    @torch.no_grad()
    def conditioning(self, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[B, 100, F] -> [B, 32, D] (mean-pooled types [B, 1, D]), TF32 off."""
        with self._dvae.no_tf32():
            return self._uv.get_conditioning(self.gpt_params, self.cfg.gpt, mel, lengths)

    # -- batched path ------------------------------------------------------

    def dispatch_batch(self, wavs: Sequence[np.ndarray], extract_condition: bool):
        """Queue one bucket-batch on the device; returns an opaque handle for
        `fetch_batch`."""
        hop, n_fft = self._hop, self._n_fft
        frames = [frames_for(w.shape[-1], hop) for w in wavs]
        Fb = bucket_frames(max(frames))
        Lw = (Fb - 1) * hop + n_fft

        host = np.zeros((len(wavs), Lw), np.float32)
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32).reshape(-1)
            # per-clip reflect pad (center=True semantics), then the zero
            # tail.  A bucket-saturating clip that is not hop-aligned pads up
            # to hop-1 samples past Lw; the clamp drops reflect-pad tail of
            # the last frame only (the JAX package clamps alike)
            padded = np.pad(w, (n_fft // 2, n_fft // 2), mode="reflect")[:Lw]
            host[i, : padded.shape[0]] = padded

        mels = self.mel_uncentered(torch.from_numpy(host).to(self.device))   # [B, 100, Fb]
        out = {"mels": mels, "codes": self.codes(mels)}                      # [B, Fb//4]
        if extract_condition:
            lens = torch.tensor(frames, dtype=torch.int32).to(self.device)
            out["cond"] = self.conditioning(mels, lens)                      # [B, 32, D]
        return frames, out

    @staticmethod
    def fetch_batch(handle) -> List[Dict[str, np.ndarray]]:
        """A dispatched batch -> per-clip dicts {mel [100, F], codes [F4//4],
        cond (1, 32, D)?}."""
        frames, out = handle
        arrays = {k: v.cpu().numpy() for k, v in out.items()}
        recs = []
        for i, F in enumerate(frames):
            F4 = F - F % 4
            rec = {"mel": arrays["mels"][i, :, :F], "codes": arrays["codes"][i, : F4 // 4]}
            if "cond" in arrays:
                rec["cond"] = arrays["cond"][i: i + 1]
            recs.append(rec)
        return recs

    def extract_batch(self, wavs: Sequence[np.ndarray], extract_condition: bool
                      ) -> List[Dict[str, np.ndarray]]:
        return self.fetch_batch(self.dispatch_batch(wavs, extract_condition))

    # -- per-clip path (exact; --exact and small jobs) ---------------------

    @torch.no_grad()
    def extract_clip_features(self, wav: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """wav [1, T] -> (mel [100, F], codes [F//4])."""
        with self._dvae.no_tf32():
            mel = mel_spectrogram(torch.as_tensor(np.asarray(wav, np.float32),
                                                  device=self.device))
        # the DVAE reduces time 4x; trim so codes align with whole frames
        F = mel.shape[-1] - (mel.shape[-1] % 4)
        codes = self.codes(mel[..., :F])
        return mel[0].cpu().numpy(), codes[0].cpu().numpy()

    def conditioning_latent(self, mel: np.ndarray) -> np.ndarray:
        """mel [100, F] -> (1, 32, D)."""
        m = torch.as_tensor(mel, device=self.device)[None]
        lens = torch.tensor([mel.shape[-1]], dtype=torch.int32, device=self.device)
        return self.conditioning(m, lens).cpu().numpy()


def _iter_batches(entries, extractor, sr, num_workers, exact):
    """(batch entries, wavs), the audio decoded on threads, batches grouped
    by length."""
    pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def load(e):
        try:
            wav = audio_io.load_prompt_audio(e[0], sr)
            return e, np.asarray(wav, np.float32).reshape(-1)
        except Exception as exc:  # noqa: BLE001 (skip undecodable clips)
            print(f"[skip] {e[0]}: {exc}")
            return e, None

    loaded = [r for r in pool.map(load, entries) if r[1] is not None]
    pool.shutdown()
    if exact:
        for e, w in loaded:
            yield [e], [w]
        return
    loaded.sort(key=lambda r: r[1].shape[-1])
    bs = extractor.batch_size
    for i in range(0, len(loaded), bs):
        chunk = loaded[i: i + bs]
        yield [e for e, _ in chunk], [w for _, w in chunk]


def extract_audio_list(
    list_path: str,
    output_dir: str,
    cfg: Config,
    model_dir: str,
    valid_ratio: float = 0.1,
    extract_condition: bool = True,
    batch_size: int = 16,
    num_workers: int = 8,
    seed: int = 0,
    exact: bool = False,
    device="cuda",
) -> Dict[str, Dict]:
    """One audio list -> the processed-data layout under `output_dir`.
    Returns the per-speaker stats merged into speaker_info.json."""
    entries = parse_audio_list(list_path)
    extractor = CodecExtractor(cfg, model_dir, batch_size, device)
    sr = cfg.dataset.sample_rate

    per_speaker: Dict[str, List[Dict]] = {}
    latents: Dict[str, List[np.ndarray]] = {}
    mel_paths: Dict[str, List[str]] = {}
    used_stems: Dict[Tuple[str, str], str] = {}
    for batch_entries, wavs in _iter_batches(entries, extractor, sr, num_workers, exact):
        if exact:
            feats = []
            for w in wavs:
                mel, codes = extractor.extract_clip_features(w[None])
                rec = {"mel": mel, "codes": codes}
                if extract_condition:
                    rec["cond"] = extractor.conditioning_latent(mel)
                feats.append(rec)
        else:
            feats = extractor.extract_batch(wavs, extract_condition)
        for (audio_path, text), wav, feat in zip(batch_entries, wavs, feats):
            speaker = speaker_of(audio_path, list_path)
            stem = os.path.splitext(os.path.basename(audio_path))[0]
            # two clips of one speaker may share a basename under different
            # parents: disambiguate rather than overwrite the first's arrays
            key = (speaker, stem)
            if key in used_stems and used_stems[key] != audio_path:
                stem = f"{stem}-{hashlib.sha1(audio_path.encode()).hexdigest()[:8]}"
                key = (speaker, stem)
            used_stems[key] = audio_path
            spk_dir = os.path.join(output_dir, speaker)
            os.makedirs(os.path.join(spk_dir, "codes"), exist_ok=True)
            os.makedirs(os.path.join(spk_dir, "mels"), exist_ok=True)
            codes_rel = os.path.join("codes", f"{stem}.npy")
            mels_rel = os.path.join("mels", f"{stem}.npy")
            np.save(os.path.join(spk_dir, codes_rel), feat["codes"])
            np.save(os.path.join(spk_dir, mels_rel), feat["mel"])
            per_speaker.setdefault(speaker, []).append({
                "audio": audio_path, "text": text,
                "duration": round(wav.shape[-1] / sr, 3),
                "codes": codes_rel, "mels": mels_rel,
            })
            if extract_condition:
                latents.setdefault(speaker, []).append(feat["cond"])
                mel_paths.setdefault(speaker, []).append(os.path.join(spk_dir, mels_rel))

    rng = np.random.default_rng(seed)
    info: Dict[str, Dict] = {}
    for speaker, records in per_speaker.items():
        spk_dir = os.path.join(output_dir, speaker)
        order = rng.permutation(len(records))
        n_valid = max(1, int(round(len(records) * valid_ratio))) if len(records) > 1 else 0
        valid_idx = set(order[:n_valid].tolist())
        splits = {"train": [], "valid": []}
        for i, rec in enumerate(records):
            splits["valid" if i in valid_idx else "train"].append(rec)
        for split, recs in splits.items():
            with open(os.path.join(spk_dir, f"metadata_{split}.jsonl"), "w",
                      encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        stats = {
            "speaker": speaker,
            "num_clips": len(records),
            "num_train": len(splits["train"]),
            "num_valid": len(splits["valid"]),
            "total_duration": round(sum(r["duration"] for r in records), 2),
        }
        if extract_condition and latents.get(speaker):
            lat = np.concatenate(latents[speaker], axis=0)   # [N, 32, D]
            med = medoid_index(lat)
            np.save(os.path.join(spk_dir, "medoid_condition.npy"), lat[med: med + 1])
            # the medoid clip's mel is the vocoder-side speaker reference
            np.save(os.path.join(spk_dir, "medoid_mel.npy"), np.load(mel_paths[speaker][med]))
            stats["medoid_clip"] = records[med]["audio"]
        info[speaker] = stats

    # merge into the global speaker_info.json
    info_path = os.path.join(output_dir, "speaker_info.json")
    existing: List[Dict] = []
    if os.path.exists(info_path):
        with open(info_path, "r", encoding="utf-8") as f:
            existing = json.load(f)
    merged = {it["speaker"]: it for it in existing if "speaker" in it}
    merged.update(info)
    with open(info_path, "w", encoding="utf-8") as f:
        json.dump(list(merged.values()), f, ensure_ascii=False, indent=2)
    return info


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="DVAE codec extraction (extract_codec)")
    p.add_argument("--audio_list", required=True)
    p.add_argument("--config", default="finetune_models/config.yaml")
    p.add_argument("--model_dir", default="finetune_models")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--extract_condition", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=8, help="audio-decode threads")
    p.add_argument("--valid_ratio", type=float, default=0.1)
    p.add_argument("--exact", action="store_true",
                   help="per-clip (unbatched) extraction: exact codes at every clip tail")
    args = p.parse_args(argv)

    cfg = Config.load(args.config) if os.path.exists(args.config) else Config()
    out = args.output_dir or cfg.workflow.paths.processed_data_dir
    info = extract_audio_list(args.audio_list, out, cfg, args.model_dir,
                              valid_ratio=args.valid_ratio,
                              extract_condition=args.extract_condition,
                              batch_size=args.batch_size, num_workers=args.num_workers,
                              exact=args.exact, device=args.device)
    for sp, st in info.items():
        print(f"{sp}: {st['num_clips']} clips ({st['total_duration']}s), "
              f"{st['num_train']} train / {st['num_valid']} valid")


if __name__ == "__main__":
    main()
