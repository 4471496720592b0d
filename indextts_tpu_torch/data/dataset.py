"""Fine-tune data pipeline (the port's copy of indextts_tpu/data/dataset.py;
all numpy, so its batches equal the JAX package's for the same manifests
and seed).

Rebuild of the reference data layer (indextts/data_utils.py:18-909):
multi-speaker jsonl manifests over pre-extracted codes/mels `.npy` files,
lazy byte-offset indexing with an on-disk cache, duration/text-length
filters, same-speaker conditioning sampling with an optional cross-speaker
ratio, text-length weighted sampling, and right-padded batch collation.

No torch DataLoader or worker processes: batches are assembled in numpy by
a light prefetch thread, and sharding is deterministic index striding by
shard index instead of the reference's rank-0 scan + dist.broadcast
(data_utils.py:574-601).
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from indextts_tpu_torch.config import TrainConfig
from indextts_tpu_torch.utils.tokenizer import TextTokenizer


@dataclass
class Sample:
    speaker: str
    duration: float
    text_len: int
    # eager mode: resolved fields
    text: Optional[str] = None
    codes_path: Optional[str] = None
    mels_path: Optional[str] = None
    # lazy mode: byte-offset reference into the manifest
    manifest: Optional[str] = None
    offset: int = 0
    length: int = 0


class FinetuneDataset:
    """One split (train/valid) over all speakers.

    Manifest layout (produced by the extraction pipeline, reference
    README.md:19-35): `speaker_info.json` lists speakers; each speaker dir
    holds `metadata_train.jsonl` / `metadata_valid.jsonl` with per-clip
    records {audio, text, duration, codes, mels}.
    """

    def __init__(
        self,
        data_path: str,
        split: str,
        tokenizer: TextTokenizer,
        min_duration: float = 1.0,
        max_duration: float = 20.0,
        min_text_length: int = 0,
        max_text_length: int = 0,
        use_index_cache: bool = True,
        lazy: bool = False,
    ):
        self.data_path = data_path
        self.split = split
        self.tokenizer = tokenizer
        self.samples: List[Sample] = []
        self.by_speaker: Dict[str, List[int]] = {}

        info_path = os.path.join(data_path, "speaker_info.json")
        if os.path.exists(info_path):
            with open(info_path, "r", encoding="utf-8") as f:
                info = json.load(f)
            speakers = [it["speaker"] for it in info if "speaker" in it]
        else:
            speakers = [d for d in sorted(os.listdir(data_path))
                        if os.path.isdir(os.path.join(data_path, d))]

        # a file of its own: the JAX package caches its own Sample class
        cache_path = os.path.join(data_path, f"{split}_index.torch.pkl")
        # manifest identity (mtime, size) is part of the key: re-running
        # extraction rewrites the jsonl files, and a stale cache would
        # silently keep the old sample list — or worse, in lazy mode the
        # cached byte offsets would slice mid-line into the new file.
        # `lazy` is keyed too: the modes build different
        # Sample records.
        manifest_stat = tuple(
            (spk, int(os.path.getmtime(mp) * 1e6), os.path.getsize(mp))
            for spk in speakers
            for mp in (os.path.join(data_path, spk, f"metadata_{split}.jsonl"),)
            if os.path.exists(mp))
        cache_key = (tuple(speakers), manifest_stat, lazy, min_duration,
                     max_duration, min_text_length, max_text_length)
        if use_index_cache and os.path.exists(cache_path):
            try:
                with open(cache_path, "rb") as f:
                    cached = pickle.load(f)
                if cached.get("key") == cache_key:
                    self.samples = cached["samples"]
                    self.by_speaker = cached["by_speaker"]
                    return
            except Exception:
                pass

        for speaker in speakers:
            manifest = os.path.join(data_path, speaker, f"metadata_{split}.jsonl")
            if not os.path.exists(manifest):
                continue
            if lazy:
                # byte-offset index mode: native C++ scan extracts the
                # filter fields; records load on demand (data_utils.py:
                # 475-603 lazy mode, without the broadcast machinery)
                from indextts_tpu_torch.data.native_index import index_manifest

                mi = index_manifest(manifest)
                for off, ln, dur, tlen in zip(mi.offsets, mi.lengths,
                                               mi.durations, mi.text_lens):
                    if not (min_duration <= dur <= max_duration):
                        continue
                    if min_text_length and 0 <= tlen < min_text_length:
                        continue
                    if max_text_length and tlen > max_text_length:
                        continue
                    idx = len(self.samples)
                    self.samples.append(Sample(
                        speaker=speaker, duration=float(dur),
                        text_len=int(tlen), manifest=manifest,
                        offset=int(off), length=int(ln)))
                    self.by_speaker.setdefault(speaker, []).append(idx)
                continue
            with open(manifest, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    dur = float(rec.get("duration", 0.0))
                    # duration filter [1, 20]s (data_utils.py:96-105)
                    if not (min_duration <= dur <= max_duration):
                        continue
                    text = rec["text"]
                    tlen = len(text)
                    if min_text_length and tlen < min_text_length:
                        continue
                    if max_text_length and tlen > max_text_length:
                        continue
                    idx = len(self.samples)
                    self.samples.append(Sample(
                        speaker=speaker, text=text,
                        codes_path=self._resolve(speaker, rec["codes"]),
                        mels_path=self._resolve(speaker, rec["mels"]),
                        duration=dur, text_len=tlen))
                    self.by_speaker.setdefault(speaker, []).append(idx)

        if use_index_cache:
            try:
                with open(cache_path, "wb") as f:
                    pickle.dump({"key": cache_key, "samples": self.samples,
                                  "by_speaker": self.by_speaker}, f)
            except OSError:
                pass

    def _resolve(self, speaker: str, path: str) -> str:
        if os.path.isabs(path):
            return path
        cand = os.path.join(self.data_path, speaker, path)
        if os.path.exists(cand):
            return cand
        return os.path.join(self.data_path, path)

    def __len__(self) -> int:
        return len(self.samples)

    def sample_weights(self, text_length_weights: Dict[int, float]) -> np.ndarray:
        """Text-length weighted sampling (data_utils.py:211-243)."""
        if not text_length_weights:
            return np.ones(len(self.samples))
        thresholds = sorted(text_length_weights)
        w = np.ones(len(self.samples))
        for i, s in enumerate(self.samples):
            for t in thresholds:
                if s.text_len <= t:
                    w[i] = text_length_weights[t]
                    break
        return w

    def _resolved(self, idx: int) -> Sample:
        """Materialise a lazy sample's fields from its manifest byte range."""
        s = self.samples[idx]
        if s.codes_path is None and s.manifest is not None:
            from indextts_tpu_torch.data.native_index import read_record

            rec = read_record(s.manifest, s.offset, s.length)
            s.text = rec["text"]
            s.codes_path = self._resolve(s.speaker, rec["codes"])
            s.mels_path = self._resolve(s.speaker, rec["mels"])
        return s

    def get_item(self, idx: int, rng: np.random.Generator,
                 cross_speaker_ratio: float = 0.0,
                 load_mel: bool = False) -> Dict[str, Any]:
        """Load one training example.  Conditioning is a *different* clip of
        the same speaker (zero-shot strategy, data_utils.py:357-403), or a
        clip from another speaker with probability cross_speaker_ratio
        (data_utils.py:405-458).  The clip's own mel is only loaded on
        request (training consumes codes + conditioning mel only)."""
        s = self._resolved(idx)
        codes = np.load(s.codes_path).reshape(-1).astype(np.int32)
        mel = None
        if load_mel:
            mel = np.load(s.mels_path)
            if mel.ndim == 3:
                mel = mel[0]
        text_ids = np.asarray(self.tokenizer.encode(s.text), dtype=np.int32)

        cond_idx = idx
        speakers = list(self.by_speaker)
        if (cross_speaker_ratio > 0.0 and len(speakers) > 1
                and rng.random() < cross_speaker_ratio):
            other = speakers[rng.integers(len(speakers))]
            while other == s.speaker and len(speakers) > 1:
                other = speakers[rng.integers(len(speakers))]
            cond_idx = int(rng.choice(self.by_speaker[other]))
        else:
            pool = self.by_speaker.get(s.speaker, [idx])
            if len(pool) > 1:
                cond_idx = idx
                while cond_idx == idx:
                    cond_idx = int(rng.choice(pool))
        cond_mel = np.load(self._resolved(cond_idx).mels_path)
        if cond_mel.ndim == 3:
            cond_mel = cond_mel[0]
        return {
            "speaker": s.speaker,
            "text_ids": text_ids,
            "mel_codes": codes,
            "mel": mel.astype(np.float32) if mel is not None else None,
            "cond_mel": cond_mel.astype(np.float32),
        }


def collate(items: Sequence[Dict[str, Any]],
            pad_text_to: Optional[int] = None,
            pad_codes_to: Optional[int] = None,
            pad_cond_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Right-pad into dense arrays (collate_finetune_fn contract,
    data_utils.py:752-791), with optional bucket widths so batch shapes hit
    a small set of compiled programs."""
    B = len(items)
    tl = np.asarray([len(it["text_ids"]) for it in items], np.int32)
    cl = np.asarray([len(it["mel_codes"]) for it in items], np.int32)
    ml = np.asarray([it["cond_mel"].shape[-1] for it in items], np.int32)
    Tt = pad_text_to or int(tl.max())
    Tc = pad_codes_to or int(cl.max())
    Tm = pad_cond_to or int(ml.max())
    n_mels = items[0]["cond_mel"].shape[0]

    text = np.zeros((B, Tt), np.int32)
    codes = np.zeros((B, Tc), np.int32)
    cond = np.zeros((B, n_mels, Tm), np.float32)
    for i, it in enumerate(items):
        text[i, : tl[i]] = it["text_ids"][:Tt]
        codes[i, : cl[i]] = it["mel_codes"][:Tc]
        cond[i, :, : ml[i]] = it["cond_mel"][:, :Tm]
    return {
        "text_ids": text, "text_lengths": np.minimum(tl, Tt),
        "mel_codes": codes, "codes_lengths": np.minimum(cl, Tc),
        "cond_mel": cond, "cond_lengths": np.minimum(ml, Tm),
        "speakers": [it["speaker"] for it in items],
    }


class DataLoader:
    """Shuffled, optionally weighted, host-sharded batch iterator with a
    background prefetch thread (replaces torch DataLoader + samplers,
    data_utils.py:18-79)."""

    def __init__(
        self,
        dataset: FinetuneDataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        cross_speaker_ratio: float = 0.0,
        text_length_weights: Optional[Dict[int, float]] = None,
        num_shards: int = 1,
        shard_index: int = 0,
        pad_multiple: int = 32,
        prefetch: int = 2,
        fixed_widths: Optional[Tuple[int, int, int]] = None,
    ):
        """`fixed_widths` = (text, codes, cond_mel) static pad targets —
        required for multi-host SPMD where every process must produce
        identically-shaped local shards."""
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.cross_speaker_ratio = cross_speaker_ratio
        self.weights = dataset.sample_weights(text_length_weights or {})
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.pad_multiple = pad_multiple
        self.prefetch = prefetch
        self.fixed_widths = fixed_widths
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        n = len(self.ds)
        if self.shuffle:
            if (self.weights != 1.0).any():
                p = self.weights / self.weights.sum()
                order = rng.choice(n, size=n, replace=True, p=p)
            else:
                order = rng.permutation(n)
        else:
            order = np.arange(n)
        # deterministic host sharding (replaces DistributedSampler).  Every
        # shard must see the SAME number of samples — a ragged tail would
        # give hosts different batch counts and hang the training
        # collectives on the last step (reference drop_last=True serves the
        # same purpose, train_ddp.py:297)
        if self.num_shards > 1:
            order = order[: len(order) - len(order) % self.num_shards]
        return order[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self._epoch_indices()
        rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        n_batches = len(self)
        # consumers may stop early (max_steps_per_epoch); without a stop
        # signal the producer would block forever on q.put, leaking a
        # thread + ~prefetch collated batches per epoch
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for b in range(n_batches):
                chunk = idxs[b * self.batch_size : (b + 1) * self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    break
                items = [self.ds.get_item(int(i), rng, self.cross_speaker_ratio)
                         for i in chunk]
                if self.fixed_widths is not None:
                    pad_t, pad_c, pad_m = self.fixed_widths
                else:
                    pm = self.pad_multiple
                    pad_t = -(-max(len(it["text_ids"]) for it in items) // pm) * pm
                    pad_c = -(-max(len(it["mel_codes"]) for it in items) // pm) * pm
                    pad_m = -(-max(it["cond_mel"].shape[-1] for it in items) // pm) * pm
                if not put(collate(items, pad_t, pad_c, pad_m)):
                    return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
            try:  # unblock a producer mid-put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)


def load_finetune_datasets(config, bpe_path: str,
                           tokenizer: Optional[TextTokenizer] = None
                           ) -> Tuple[FinetuneDataset, FinetuneDataset]:
    """(train, valid) datasets (reference load_finetune_datasets,
    data_utils.py:794-886)."""
    from indextts_tpu_torch.utils.textnorm import TextNormalizer

    tok = tokenizer or TextTokenizer(bpe_path, TextNormalizer())
    tc: TrainConfig = config.train
    train = FinetuneDataset(tc.data_path, "train", tok,
                            min_text_length=tc.min_text_length,
                            max_text_length=tc.max_text_length)
    valid = FinetuneDataset(tc.data_path, "valid", tok)
    return train, valid
