"""IndexTTS engine: the public inference surface of the port (counterpart of
indextts_tpu/engine.py).

Single-utterance synthesis, sentence by sentence (reference infer.py:
779-917): prompt mel -> conditioning latents -> beam or sampling decode of
mel codes -> long-silence compression -> teacher-forced latent re-forward ->
BigVGAN with ECAPA speaker conditioning -> int16 PCM.  `infer` is a drained
`infer_stream` (one chunk per sentence); `infer_fast` decodes length buckets
of sentences as batched rows (reference infer.py:595-777), one vocoder call
per bucket.  One engine lock serialises the syntheses' device phases.  Pool
serving (`create_batcher`, `pool_infer`, `pool_infer_stream`) decodes
sentences of many requests in one continuous-batching pool
(serve/scheduler.py), or at beam-3 in groups of a beam pool
(`create_beam_batcher`, serve/beam_pool.py), and an optional coordinator
vocodes sentences that finish together as one batch.  Weights come from
the reference's `.pth` checkpoints (io/checkpoint.py), with their speaker
conditions for `speaker_id` requests.  The GPT weights may
be quantized to int8 or int4 with an fp8 KV cache (precision keys as in the
JAX engine).  Runs on `cuda` unless the caller passes `device="cpu"`; with
no GPU and no explicit CPU it raises.

`tp=N` serves one model across N cards by tensor parallelism
(parallel/tp.py): this process is rank 0 on cuda:0 and starts ranks
1..N-1, one process each on cuda:r (gloo processes on the CPU with
`device="cpu"`).  Every rank reads the weights on the CPU and keeps its
shard of the trunk (and the rest whole); the decodes, the latent
re-forward and `load_numpy_params` run on every rank, one call at a time (the infer_fast and infer_stream workers wait for the re-forward
rather than interleave their collectives with it).  Conditioning and the
vocoder run on rank 0 alone, whose conditioning latents travel with each
call.  The decode-trunk kernel (K2) and the pools are one-card paths and
are off or refused under TP, as in the JAX engine.  `close()` stops the
other ranks.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import queue as queue_mod
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import Config, read_yaml
from indextts_tpu_torch.io import checkpoint, from_jax
from indextts_tpu_torch.models import bigvgan as bigvgan_model
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops import quantization
from indextts_tpu_torch.ops.mel import MelSpectrogramFeatures
from indextts_tpu_torch.ops.sampling import mix_seed
from indextts_tpu_torch.parallel import tp as tp_mod
from indextts_tpu_torch.serve.beam_pool import BeamPoolBatcher
from indextts_tpu_torch.serve.scheduler import ContinuousBatcher, PoolGroup
from indextts_tpu_torch.utils import audio as audio_io
from indextts_tpu_torch.utils.textnorm import TextNormalizer
from indextts_tpu_torch.utils.tokenizer import TextTokenizer


def _resolve_dtype(name: str) -> torch.dtype:
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("fp16", "float16"):
        return torch.float16
    if name in ("fp8", "int8", "int4"):
        # the quantized weight tiers compute in bf16 (the quantization itself
        # is applied separately), as in the JAX engine
        return torch.bfloat16
    return torch.float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def remove_long_silence(codes: np.ndarray, code_lens: np.ndarray,
                        silent_token: int = 52, max_consecutive: int = 30,
                        keep: int = 10, stop_token: int = 8193
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Post-decode silence compression (infer.py:446-497): if a sequence has
    more than `max_consecutive` silent tokens overall, runs of silence are
    clipped to `keep` frames."""
    out_list: List[np.ndarray] = []
    for i in range(codes.shape[0]):
        code = codes[i, : int(code_lens[i])]
        if np.sum(code == silent_token) > max_consecutive:
            kept: List[int] = []
            run = 0
            for tok in code:
                if tok != silent_token:
                    kept.append(tok)
                    run = 0
                elif run < keep:
                    kept.append(tok)
                    run += 1
            out_list.append(np.asarray(kept, dtype=codes.dtype))
        else:
            out_list.append(code)
    new_lens = np.asarray([len(c) for c in out_list], dtype=np.int64)
    max_len = max(1, int(new_lens.max()))
    out = np.full((codes.shape[0], max_len), stop_token, dtype=codes.dtype)
    for i, c in enumerate(out_list):
        out[i, : len(c)] = c
    return out, new_lens


def bucket_sentences(sentences: Sequence[Sequence[str]],
                     bucket_max_size: int = 4) -> List[List[Dict[str, Any]]]:
    """Length bucketing for batched decode (infer.py:499-550)."""
    outputs = [{"idx": i, "sent": s, "len": len(s)} for i, s in enumerate(sentences)]
    if len(outputs) <= bucket_max_size:
        return [outputs] if outputs else []
    buckets: List[List[Dict[str, Any]]] = []
    factor = 1.5
    last_bucket: Optional[List[Dict[str, Any]]] = None
    last_median = 0
    for sent in sorted(outputs, key=lambda x: x["len"]):
        if sent["len"] == 0:
            continue
        if (last_bucket is None or sent["len"] >= int(last_median * factor)
                or len(last_bucket) >= bucket_max_size):
            buckets.append([sent])
            last_bucket = buckets[-1]
            last_median = sent["len"]
        else:
            last_bucket.append(sent)
            last_median = last_bucket[len(last_bucket) // 2]["len"]
    # merge singleton buckets into under-filled ones (infer.py:532-549)
    out_buckets = [b for b in buckets if len(b) > 1]
    only_ones = [b[0] for b in buckets if len(b) == 1]
    if only_ones:
        for b in out_buckets:
            if len(b) < bucket_max_size:
                b.append(only_ones.pop(0))
                if not only_ones:
                    break
        if only_ones:
            out_buckets.extend(
                only_ones[i : i + bucket_max_size]
                for i in range(0, len(only_ones), bucket_max_size))
    return out_buckets


class _VocodeJob:
    """One codes-to-wav job waiting for the coordinator (a small future)."""

    __slots__ = ("cond", "mel", "id_lists", "codes", "lens", "_done", "_wav", "_exc")

    def __init__(self, cond, mel, id_lists, codes, lens):
        self.cond = cond            # [1, 32, D] on the device (per request)
        self.mel = mel              # [1, T_mel, n_mels] on the device
        self.id_lists = id_lists
        self.codes = codes          # [B_j, W] np
        self.lens = lens            # [B_j] np
        self._done = threading.Event()
        self._wav: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    @property
    def rows(self) -> int:
        return len(self.id_lists)

    def key(self):
        return (tuple(self.mel.shape), str(self.mel.dtype))

    def fulfill(self, wav: np.ndarray) -> None:
        self._wav = wav
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("vocode job timed out")
        if self._exc is not None:
            raise self._exc
        return self._wav


class _VocodeCoordinator:
    """Batches the codes-to-wav tail across requests.  Under pool serving the
    decode batches across requests, but each sentence's latent re-forward and
    vocoder would run alone.  The coordinator queues finished sentences for
    up to `max_wait_s` and runs jobs with the same prompt-mel shape as one
    batched re-forward and vocoder call (the vocoder takes per-row speaker
    mels).  Groups are padded to a power-of-two row count, as in the JAX
    package.  Its group key is the JAX package's (the mel shape)."""

    def __init__(self, eng: "IndexTTS", max_rows: int = 8, max_wait_s: float = 0.025):
        self.eng = eng
        self.max_rows = int(max_rows)
        self.max_wait_s = float(max_wait_s)
        self._q: List[_VocodeJob] = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="vocode-coordinator")
        self._thread.start()

    def submit(self, cond, mel, id_lists, codes, lens) -> _VocodeJob:
        job = _VocodeJob(cond, mel, id_lists, codes, lens)
        with self._cv:
            if self._stop:
                raise RuntimeError("vocode coordinator is closed")
            self._q.append(job)
            self._cv.notify()
        return job

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def _pop_first(self) -> Optional[_VocodeJob]:
        with self._cv:
            while not self._q and not self._stop:
                self._cv.wait()
            return self._q.pop(0) if self._q else None  # None: stopped and drained

    def _pop_compatible(self, key, max_rows: int, deadline: float) -> Optional[_VocodeJob]:
        """The next queued job with the same mel shape that fits in
        `max_rows`, waiting until `deadline` only while the queue is empty."""
        with self._cv:
            while True:
                for i, j in enumerate(self._q):
                    if j.key() == key and j.rows <= max_rows:
                        return self._q.pop(i)
                if self._q or self._stop:
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def _worker(self) -> None:
        while True:
            job = self._pop_first()
            if job is None:
                return
            group, rows = [job], job.rows
            deadline = time.perf_counter() + self.max_wait_s
            while rows < self.max_rows:
                nxt = self._pop_compatible(job.key(), self.max_rows - rows, deadline)
                if nxt is None:
                    break
                group.append(nxt)
                rows += nxt.rows
            try:
                for j, w in zip(group, self.eng._codes_to_wav_group(group)):
                    j.fulfill(w)
            except BaseException as e:  # noqa: BLE001 — to every waiter
                for j in group:
                    j.fail(e)


class IndexTTS:
    """Zero-shot TTS engine (reference surface: indextts/infer.py:184)."""

    def __init__(self, cfg_path: Optional[str] = "checkpoints/config.yaml",
                 model_dir: str = "checkpoints", is_fp16: bool = True,
                 device: Optional[str] = None,
                 precision_config: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None, config: Optional[Config] = None,
                 gpt_path: Optional[str] = None, speaker_info_path: Optional[str] = None,
                 tp: int = 0, _tp_member=None):
        """`config` takes the place of `cfg_path` (no YAML needed); with
        neither, the dataclass defaults (the flagship) apply.  The GPT
        checkpoint is `gpt_path` (absolute, or relative to `model_dir`; a
        `.pth` file, or a merged-weight directory the port's trainer wrote),
        else the config's `gpt_checkpoint` in `model_dir`; the vocoder's is the
        config's `bigvgan_checkpoint` there.  A missing file leaves random
        weights from a fixed seed.  `speaker_info_path` names the
        speaker_info.json whose speakers (and their medoid_mel.npy files
        beside it) `speaker_id` requests may use.  `tp` > 1: tensor
        parallelism over that many cards (see the module's docstring), each
        collective and each rank's answer bounded by parallel/tp.TIMEOUT_S;
        fewer visible cards raise before any weights load.  (`_tp_member` is a
        follower's (rank, group), set by parallel/tp.py.)"""
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IndexTTS: CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.tp = int(tp) if tp and int(tp) > 1 else 1
        self.tp_rank, self.tp_group = _tp_member or (0, None)
        self._tp: Optional[tp_mod.Followers] = None
        if self.tp > 1 and self.device.type == "cuda":
            visible = torch.cuda.device_count()
            if visible < self.tp:
                raise ValueError(f"tp={self.tp} requires {self.tp} devices; only {visible} "
                                 "visible")
            self.device = torch.device("cuda", self.tp_rank)
        if config is None:
            config = (Config.load(cfg_path) if cfg_path and os.path.exists(cfg_path)
                      else Config())
        self.cfg = config
        tp_mod.check_heads(self.cfg.gpt.heads, self.tp)
        self.model_dir = model_dir
        self.model_version = self.cfg.version

        # precision precedence, PER KEY: runtime args > config_inference.yaml
        # > config.yaml [inference] > legacy is_fp16 (infer.py:213-306)
        file_cfg: Dict[str, Any] = {}
        inf_path = os.path.join(model_dir, "config_inference.yaml")
        if os.path.exists(inf_path):
            file_cfg = (read_yaml(inf_path) or {}).get("inference") or {}
        base = {"gpt": self.cfg.inference.gpt, "vocoder": self.cfg.inference.vocoder,
                "cfg_scale": self.cfg.inference.cfg_scale,
                "kv_cache": self.cfg.inference.kv_cache,
                "quantization": {"enabled": self.cfg.inference.quantization.enabled}}
        runtime = dict(precision_config) if precision_config else {}

        def pick(key, default=None):
            for src in (runtime, file_cfg, base):
                if src.get(key) is not None:
                    return src[key]
            return default

        legacy = "bf16" if is_fp16 else "fp32"
        gpt_prec = str(pick("gpt", legacy))
        voc_prec = str(pick("vocoder", legacy))
        quant = pick("quantization", {}) or {}
        self.use_quantization = bool(quant.get("enabled", False)) or gpt_prec in ("int8",
                                                                                "int4")
        # weight type: an explicit quantization.weight_dtype (runtime or
        # config_inference.yaml) wins, then a quantized gpt precision, then
        # the base config's default (which must not shadow gpt="int4")
        explicit_wd = next((src["quantization"]["weight_dtype"] for src in (runtime, file_cfg)
                            if (src.get("quantization") or {}).get("weight_dtype")), None)
        self.quant_weight_dtype = explicit_wd or (
            gpt_prec if gpt_prec in ("int8", "int4") else quant.get("weight_dtype", "int8"))
        self.gpt_dtype = _resolve_dtype(gpt_prec)
        self.vocoder_dtype = _resolve_dtype(voc_prec)
        # fp8 KV cache: on with weight quantization unless kv_cache says
        # otherwise ("bf16"), or asked for with kv_cache="fp8"
        kv_pref = str(pick("kv_cache", "auto"))
        if kv_pref == "fp8" or (kv_pref == "auto" and self.use_quantization):
            self.kv_cache_dtype: Optional[torch.dtype] = torch.float8_e4m3fn
        else:
            self.kv_cache_dtype = None
        self.cfg_scale = float(pick("cfg_scale", 1.0))
        self.stop_mel_token = self.cfg.gpt.stop_mel_token
        self._rng_seed = seed if seed is not None else 0
        if self.tp > 1 and self.tp_group is None:
            # the followers load their shards while this rank loads its own
            self._tp = tp_mod.Followers(self.tp, self.device, dict(
                cfg_path=None, config=self.cfg, model_dir=model_dir, is_fp16=is_fp16,
                device=self.device.type, precision_config=precision_config, gpt_path=gpt_path))
            self.tp_group = self._tp.group
        try:
            self._load(model_dir, gpt_path, speaker_info_path)
            if self._tp is not None:
                self._tp.wait_ready()
        except BaseException:
            self.close()
            raise

    def _load(self, model_dir: str, gpt_path: Optional[str],
              speaker_info_path: Optional[str]) -> None:
        """Weights, text front end, speakers and the engine's locks.  Under TP
        every rank reads the GPT tree on the CPU and only its shard reaches
        its card; a follower holds no vocoder and no front end (rank 0 runs
        both)."""
        # --- models: reference checkpoints, else random weights --------
        gen = lambda s: torch.Generator(device=self.device).manual_seed(s)  # noqa: E731
        load_dev = torch.device("cpu") if self.tp > 1 else self.device
        self.gpt_path = (gpt_path if gpt_path and os.path.isabs(gpt_path)
                         else os.path.join(model_dir, gpt_path) if gpt_path
                         else os.path.join(model_dir, self.cfg.gpt_checkpoint))
        self.speaker_conditions: Dict[str, np.ndarray] = {}
        self.speaker_mels: Dict[str, np.ndarray] = {}
        self.mean_condition: Optional[np.ndarray] = None
        if os.path.isdir(self.gpt_path):
            # the port's own directory: the merged weights the trainer writes
            # (train/run.py, model_epoch_N)
            self._set_gpt_params(from_jax.gpt_params_from_numpy(
                checkpoint.load_pytree(self.gpt_path), self.cfg.gpt, self.gpt_dtype,
                load_dev))
        elif os.path.exists(self.gpt_path):
            # the numpy tree goes to the device in gpt_dtype, and is quantized
            # from that master as the precision keys say
            tree, extras = checkpoint.load_gpt_checkpoint(self.gpt_path, self.cfg.gpt)
            self._set_gpt_params(from_jax.gpt_params_from_numpy(
                tree, self.cfg.gpt, self.gpt_dtype, load_dev))
            del tree
            self.speaker_conditions = extras.get("speaker_conditions", {})
            self.speaker_mels = extras.get("speaker_mels", {})
            self.mean_condition = extras.get("mean_condition")
        else:
            if self.tp_rank == 0:
                warnings.warn(f"gpt checkpoint {self.gpt_path} not found; random weights")
            self._set_gpt_params(uv.init_params(
                self.cfg.gpt, torch.Generator(device=load_dev).manual_seed(0), self.gpt_dtype,
                load_dev))
        # one device, one synthesis at a time: infer, infer_stream and
        # infer_fast take it around their device phases (pool serving does
        # not).  A plain Lock, not an RLock: a stream's next() and close()
        # may come from other threads than the one that started it, and
        # Lock.release() is thread-agnostic.
        self._infer_lock = threading.Lock()
        self._vocode_coord: Optional[_VocodeCoordinator] = None
        self.last_stats: Dict[str, Any] = {}
        if self.tp_rank > 0:
            return
        bv_path = os.path.join(model_dir, self.cfg.bigvgan_checkpoint)
        if os.path.exists(bv_path):
            self.bigvgan_params = from_jax.bigvgan_params_from_numpy(
                checkpoint.load_bigvgan_checkpoint(bv_path, self.cfg.bigvgan), self.cfg.bigvgan,
                self.vocoder_dtype, self.device)
        else:
            warnings.warn(f"bigvgan checkpoint {bv_path} not found; random weights")
            self.bigvgan_params = bigvgan_model.init_params(
                self.cfg.bigvgan, gen(1), self.vocoder_dtype, self.device)

        # --- text front end ---------------------------------------------
        self.normalizer = TextNormalizer()
        self.normalizer.load()
        self.tokenizer = TextTokenizer(os.path.join(model_dir, self.cfg.dataset.bpe_model),
                                       self.normalizer)

        self.speaker_list: List[str] = []
        if speaker_info_path and os.path.exists(speaker_info_path):
            with open(speaker_info_path, "r", encoding="utf-8") as f:
                info = json.load(f)
            self.speaker_list = [it["speaker"] for it in info if "speaker" in it]
            # per-speaker vocoder mels written by extraction, beside the file
            data_dir = os.path.dirname(os.path.abspath(speaker_info_path))
            for sp in self.speaker_list:
                mel_path = os.path.join(data_dir, sp, "medoid_mel.npy")
                if sp not in self.speaker_mels and os.path.exists(mel_path):
                    self.speaker_mels[sp] = np.load(mel_path)
        elif self.speaker_conditions:
            self.speaker_list = list(self.speaker_conditions)

        self.cache_audio_prompt: Optional[str] = None
        self.cache_cond_mel: Optional[torch.Tensor] = None
        self._prompt_cache_lock = threading.Lock()   # pool requests come from many threads
        mel = self.cfg.dataset.mel
        self._mel_extractor = MelSpectrogramFeatures(
            sample_rate=mel.sample_rate, n_fft=mel.n_fft, hop_length=mel.hop_length,
            win_length=mel.win_length, n_mels=mel.n_mels)

    def _set_gpt_params(self, master: Dict[str, Any]) -> None:
        """The GPT trees from float weights in gpt_dtype: `gpt_params` for the
        single-row kernel and `gpt_params_batched` for beam decode and the
        re-forward.  They differ only under int4: the fused layout, and the
        shared-scale layout.  Under TP both are this rank's shard of the
        batched tree, quantized whole (row-parallel scales span all of K) and
        then cut, and only the shard goes to the card."""
        if self.tp > 1:
            tree = master
            if self.use_quantization:
                bits = 4 if self.quant_weight_dtype == "int4" else 8
                tree = quantization.quantize_gpt_params(master, bits=bits, int4_layout="shared")
            self.gpt_params = self.gpt_params_batched = tp_mod.to_device(
                tp_mod.shard_uv_params(tree, self.tp_rank, self.tp), self.device)
            return
        self.gpt_params = master
        self.gpt_params_batched = master
        if self.use_quantization:
            bits = 4 if self.quant_weight_dtype == "int4" else 8
            self.gpt_params = quantization.quantize_gpt_params(master, bits=bits)
            self.gpt_params_batched = (
                quantization.quantize_gpt_params(master, bits=4, int4_layout="shared")
                if bits == 4 else self.gpt_params)

    def load_numpy_params(self, gpt_tree: Any, bigvgan_tree: Any) -> None:
        """Take the JAX package's float parameter trees, as numpy arrays, for
        both models (cast to this engine's precisions, then quantized as its
        precision keys say).  Under TP every rank takes its GPT shard."""
        self._on_ranks("_load_gpt_numpy", gpt_tree)
        self.bigvgan_params = from_jax.bigvgan_params_from_numpy(
            bigvgan_tree, self.cfg.bigvgan, self.vocoder_dtype, self.device)

    def _load_gpt_numpy(self, gpt_tree: Any) -> None:
        self._set_gpt_params(from_jax.gpt_params_from_numpy(
            gpt_tree, self.cfg.gpt, self.gpt_dtype,
            torch.device("cpu") if self.tp > 1 else self.device))

    # -- tensor parallelism -------------------------------------------------

    def _on_ranks(self, target: str, *args) -> List[Any]:
        """`target` on every rank of the tensor-parallel group (here alone
        without one), each rank's result by rank: a method's name, or
        "module:function" called as function(engine, *args)
        (parallel/tp.call)."""
        if self._tp is None:
            return [tp_mod.call(self, target, args)]
        own, rest = self._tp.run(self, target, args)
        return [own] + rest

    @property
    def tp_broken(self) -> Optional[str]:
        """Why the tensor-parallel group takes no more calls (a rank failed,
        died or hung, or the engine is closed), else None."""
        return None if self._tp is None else self._tp.broken

    def close(self) -> None:
        """Stop the vocode coordinator and, under TP, the other ranks (after
        the call in flight).  The engine takes no sharded call after this.
        Idempotent; nothing else to release on one card."""
        if getattr(self, "_vocode_coord", None) is not None:
            self.disable_vocode_batching()
        if self._tp is not None:
            self._tp.close()

    # -- helpers ----------------------------------------------------------

    def _prompt_mel(self, audio_prompt: str) -> torch.Tensor:
        with self._prompt_cache_lock:
            if self.cache_cond_mel is None or self.cache_audio_prompt != audio_prompt:
                wav = audio_io.load_prompt_audio(audio_prompt, self.cfg.dataset.sample_rate)
                self.cache_cond_mel = self._mel_extractor(
                    torch.as_tensor(wav, device=self.device))
                self.cache_audio_prompt = audio_prompt
            return self.cache_cond_mel

    def _conditioning(self, cond_mel: Optional[torch.Tensor],
                      speaker_id: Optional[str] = None) -> torch.Tensor:
        """Conditioning latents [1, 32, D]: the checkpoint's stored condition
        of `speaker_id`, else the prompt mel's, else the checkpoint's
        mean_condition (reference get_conditioning, gpt/model.py:490-517)."""
        if speaker_id is not None:
            if speaker_id not in self.speaker_conditions:
                raise ValueError(f"unknown speaker_id: {speaker_id}")
            return torch.as_tensor(self.speaker_conditions[speaker_id]).to(
                self.device, self.gpt_dtype)
        if cond_mel is None:
            if self.mean_condition is not None:
                return torch.as_tensor(self.mean_condition).to(self.device, self.gpt_dtype)
            raise ValueError("no audio prompt, no speaker_id, and the checkpoint carries no "
                             "mean_condition: cannot derive speaker conditioning")
        lengths = torch.full((cond_mel.shape[0],), cond_mel.shape[-1], device=self.device)
        return uv.get_conditioning(self.gpt_params, self.cfg.gpt,
                                   cond_mel.to(self.gpt_dtype), lengths)

    def _mel_ref(self, cond_mel: Optional[torch.Tensor],
                 speaker_id: Optional[str]) -> torch.Tensor:
        """The vocoder's speaker mel [1, T_mel, n_mels]: the prompt's, else
        the speaker's stored medoid mel (never a zeros mel, which would be
        the ECAPA embedding of silence)."""
        if cond_mel is not None:
            return cond_mel.transpose(1, 2)
        if speaker_id is not None and speaker_id in self.speaker_mels:
            mel = np.asarray(self.speaker_mels[speaker_id], np.float32)   # [n_mels, T]
            return torch.as_tensor(mel.T[None], device=self.device)
        raise ValueError("no audio prompt and no stored speaker mel for the vocoder's ECAPA "
                         "conditioning: provide an audio prompt, or a speaker with a "
                         "medoid_mel.npy")

    def _text_inputs(self, token_lists) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode text tokens and mask [B, width] on the device: start/stop
        added, left-padded to a multiple of 16."""
        prep = uv.prepare_text_prompt(token_lists, self.cfg.gpt.start_text_token,
                                      self.cfg.gpt.stop_text_token)
        pad = _round_up(prep.text_tokens.shape[1], 16) - prep.text_tokens.shape[1]
        tokens = np.pad(prep.text_tokens, ((0, 0), (pad, 0)))
        mask = np.pad(prep.attn_text, ((0, 0), (pad, 0)))
        return (torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(mask, device=self.device))

    def _device_scope(self):
        """The engine's CUDA device as the current one: a worker thread
        starts on device 0."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _decode_bucket(self, cond_latent, token_lists, generator,
                       generation: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray, int]:
        """Batched decode of one bucket of sentences, text left-padded to a
        multiple of 16.  Returns (codes [B, max_new], lengths [B], decode
        steps).  Under TP every rank decodes, from `generator`'s seed (the
        decode itself checks that every rank's codes are rank 0's)."""
        beam, kwargs = self._decode_options(len(token_lists), generation)
        if self._tp is None:
            return self._decode_rows(cond_latent, token_lists, generator, beam, kwargs)
        seed = None if generator is None else generator.initial_seed()
        return self._on_ranks("_decode_rows", cond_latent, token_lists, seed, beam, kwargs)[0]

    def _decode_rows(self, cond_latent, token_lists, generator, beam: bool,
                     kwargs: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray, int]:
        """`_decode_bucket` after its options: `generator` a torch.Generator,
        a seed or None."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(generator)
        tokens_t, mask_t = self._text_inputs(token_lists)
        if beam:
            result = uv.inference_speech_beam(
                self.gpt_params_batched, self.cfg.gpt, cond_latent, tokens_t, mask_t,
                generator, group=self.tp_group, **kwargs)
        else:
            kwargs = dict(kwargs)
            use_fused = kwargs.pop("use_fused_trunk")
            result = uv.inference_speech(
                self.gpt_params if use_fused else self.gpt_params_batched, self.cfg.gpt,
                cond_latent, tokens_t, mask_t, generator, use_fused_trunk=use_fused,
                group=self.tp_group, **kwargs)
        return result.codes.cpu().numpy(), result.lengths.cpu().numpy(), result.steps

    def _decode_options(self, rows: int, generation: Dict[str, Any]
                        ) -> Tuple[bool, Dict[str, Any]]:
        """(beam decode?, its keyword arguments) from a request's generation
        options; warns where the request asks for what the mode ignores."""
        # reference decode default: num_beams=3 (infer.py:633); a cfg_scale
        # without an explicit num_beams switches to sampling
        cfg_scale = float(generation.get("cfg_scale", self.cfg_scale))
        if cfg_scale != 1.0 and "num_beams" not in generation:
            num_beams = 1
        else:
            num_beams = int(generation.get("num_beams", 3))
        kwargs = dict(
            # the mel position table caps the generation budget
            max_new=min(int(generation.get("max_mel_tokens", 600)),
                        self.cfg.gpt.max_mel_tokens),
            temperature=float(generation.get("temperature", 1.0)),
            top_k=int(generation.get("top_k", 30)),
            top_p=float(generation.get("top_p", 0.8)),
            repetition_penalty=float(generation.get("repetition_penalty", 10.0)),
            do_sample=bool(generation.get("do_sample", True)),
            typical_sampling=bool(generation.get("typical_sampling", False)),
            typical_mass=float(generation.get("typical_mass", 0.9)),
            cache_dtype=self.gpt_dtype,
            kv_dtype=generation.get("kv_dtype", self.kv_cache_dtype))
        if num_beams > 1:
            if cfg_scale != 1.0:
                warnings.warn("cfg_scale is a sampling-mode feature; beam decode ignores "
                              "it (set num_beams=1 to use guidance)", RuntimeWarning)
            kwargs.update(num_beams=num_beams,
                          length_penalty=float(generation.get("length_penalty", 0.0)))
            return True, kwargs
        # the decode-trunk kernel (K2) takes one unguided row: one sentence at
        # cfg_scale 1, unless the caller opts out, and never under TP (a
        # one-card kernel, as in the JAX engine).  It keeps the cache in the
        # compute type unless kv_dtype is asked for, as the JAX engine does
        # for its fused trunk; guided and batched rows keep the engine's KV
        # tier
        use_fused = bool(generation.get("use_fused_trunk", rows == 1 and cfg_scale == 1.0)) \
            and self.tp == 1
        if use_fused and generation.get("kv_dtype") is None:
            kwargs["kv_dtype"] = None
        kwargs.update(use_fused_trunk=use_fused, cfg_scale=cfg_scale)
        return False, kwargs

    def _latents(self, cond_latent, text_tokens: np.ndarray, text_len: int,
                 codes: np.ndarray, code_len: int) -> torch.Tensor:
        """Teacher-forced re-forward for one sentence (infer.py:864-875), with
        text padded to 16 and codes to 64; the latent keeps the padded length
        (the pad bleeds into the tail, PARITY.md) and the caller trims the
        wav to code_len * 1024 samples."""
        code_len = min(code_len, self.cfg.gpt.max_mel_tokens)
        width = min(_round_up(max(1, code_len), 64), self.cfg.gpt.max_mel_tokens)
        twidth = max(min(_round_up(max(1, text_len), 16), self.cfg.gpt.max_text_tokens),
                     text_len)
        codes_p = np.full((1, width), self.stop_mel_token, dtype=np.int64)
        codes_p[0, :code_len] = codes[:code_len]
        text_p = np.zeros((1, twidth), dtype=np.int64)
        text_p[0, :text_len] = text_tokens[:text_len]
        lat = self._on_ranks("_latent_forward", cond_latent, text_p, np.asarray([text_len]),
                             codes_p, np.asarray([code_len]))[0]
        return lat[0]  # [width, D], valid prefix = code_len

    def _latent_forward(self, cond_latent, text_p: np.ndarray, text_lens: np.ndarray,
                        codes_p: np.ndarray, code_lens: np.ndarray) -> Optional[torch.Tensor]:
        """uv.latent_forward of padded host inputs on this rank; the latents
        [B, width, D] on rank 0, None on a follower (rank 0 vocodes)."""
        dev = self.device
        lat = uv.latent_forward(
            self.gpt_params_batched, self.cfg.gpt, cond_latent,
            torch.as_tensor(text_p, device=dev), torch.as_tensor(text_lens, device=dev),
            torch.as_tensor(codes_p, device=dev), torch.as_tensor(code_lens, device=dev),
            group=self.tp_group)
        return lat if self.tp_rank == 0 else None

    def _latents_batch_dev(self, cond_latent, id_lists, codes: np.ndarray,
                           lens: np.ndarray) -> torch.Tensor:
        """Batched teacher-forced re-forward of B sentences -> [B, width, D]
        on the device: text padded to 16, codes to 64, both capped by the
        position tables."""
        B = len(id_lists)
        lens = np.minimum(lens, self.cfg.gpt.max_mel_tokens)
        tlens = np.asarray([len(ids) for ids in id_lists], np.int64)
        twidth = max(min(_round_up(int(tlens.max()), 16), self.cfg.gpt.max_text_tokens),
                     int(tlens.max()))
        width = max(min(_round_up(max(1, int(lens.max())), 64), self.cfg.gpt.max_mel_tokens),
                    int(lens.max()))
        text_p = np.zeros((B, twidth), np.int64)
        codes_p = np.full((B, width), self.stop_mel_token, np.int64)
        for i, ids in enumerate(id_lists):
            text_p[i, : tlens[i]] = ids
            codes_p[i, : int(lens[i])] = codes[i, : int(lens[i])]
        if cond_latent.shape[0] == 1 and B > 1:
            cond_latent = cond_latent.expand(B, -1, -1)
        return self._on_ranks("_latent_forward", cond_latent, text_p, tlens, codes_p,
                              lens.astype(np.int64))[0]

    def _vocode(self, latent: torch.Tensor, mel_ref: torch.Tensor) -> torch.Tensor:
        """BigVGAN then int16 PCM on the device: scale in fp32, clip, and
        truncate toward zero on the cast."""
        wav = bigvgan_model.forward(self.bigvgan_params, latent.to(self.vocoder_dtype),
                                    mel_ref.to(self.vocoder_dtype), self.cfg.bigvgan)
        return torch.clamp(32767.0 * wav.float(), -32767.0, 32767.0).to(torch.int16)

    def _codes_to_wav(self, cond_latent, mel_ref, id_lists, codes: np.ndarray,
                      lens: np.ndarray) -> np.ndarray:
        """Codes -> waveform: silence compression, batched latent re-forward,
        one vocoder call, each sentence trimmed, concatenated."""
        codes, lens = remove_long_silence(codes, lens, stop_token=self.stop_mel_token)
        latents = self._latents_batch_dev(cond_latent, id_lists, codes, lens)
        wav = self._vocode(latents, mel_ref).cpu().numpy()
        wavs = [wav[i, 0][: max(1, min(int(lens[i]), latents.shape[1]))
                          * self.cfg.gpt.mel_length_compression]
                for i in range(len(id_lists))]
        return np.concatenate(wavs) if wavs else np.zeros(1, np.int16)

    def enable_vocode_batching(self, max_rows: int = 8, max_wait_ms: float = 25.0) -> None:
        """Start the vocode coordinator: the tails of `pool_infer` and
        `pool_infer_stream` then batch across requests that finish together."""
        if self._vocode_coord is None:
            self._vocode_coord = _VocodeCoordinator(self, max_rows=max_rows,
                                                    max_wait_s=max_wait_ms / 1e3)

    def disable_vocode_batching(self) -> None:
        coord, self._vocode_coord = self._vocode_coord, None
        if coord is not None:
            coord.close()

    def _vocode_tail(self, cond_latent, mel_ref, id_lists, codes: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
        """The pool path's codes-to-wav: through the coordinator when it runs,
        else the request's own tail."""
        coord = self._vocode_coord
        if coord is None:
            return self._codes_to_wav(cond_latent, mel_ref, id_lists, codes, lens)
        return coord.submit(cond_latent, mel_ref, id_lists, codes, lens).result()

    def _codes_to_wav_group(self, group) -> List[np.ndarray]:
        """The tail of a coordinator group: every job's rows in one latent
        re-forward and one vocoder call with per-row conditioning, padded to
        a power-of-two row count (pad rows repeat row 0 and are dropped).
        Returns one concatenated wav per job."""
        if len(group) == 1 and (group[0].rows & (group[0].rows - 1)) == 0:
            j = group[0]
            return [self._codes_to_wav(j.cond, j.mel, j.id_lists, j.codes, j.lens)]
        id_lists = [ids for j in group for ids in j.id_lists]
        rows = len(id_lists)
        padded = 1
        while padded < rows:
            padded *= 2
        width = max(1, max(int(j.codes.shape[1]) for j in group))
        codes = np.full((padded, width), self.stop_mel_token, np.int64)
        lens = np.ones((padded,), np.int64)
        conds, mels = [], []
        r = 0
        for j in group:
            codes[r: r + j.rows, : j.codes.shape[1]] = j.codes
            lens[r: r + j.rows] = j.lens
            conds.append(j.cond.expand(j.rows, -1, -1))
            mels.append(j.mel.expand(j.rows, -1, -1))
            r += j.rows
        for p in range(rows, padded):  # pad rows: row 0's codes, length 1
            codes[p, : group[0].codes.shape[1]] = group[0].codes[0]
        if padded > rows:
            conds.append(group[0].cond.expand(padded - rows, -1, -1))
            mels.append(group[0].mel.expand(padded - rows, -1, -1))
            id_lists = id_lists + [group[0].id_lists[0]] * (padded - rows)
        codes, lens = remove_long_silence(codes, lens, stop_token=self.stop_mel_token)
        latents = self._latents_batch_dev(torch.cat(conds), id_lists, codes, lens)
        wav = self._vocode(latents, torch.cat(mels)).cpu().numpy()
        row_wavs = [wav[i, 0][: max(1, min(int(lens[i]), latents.shape[1]))
                              * self.cfg.gpt.mel_length_compression]
                    for i in range(rows)]
        out, r = [], 0
        for j in group:
            out.append(np.concatenate(row_wavs[r: r + j.rows]))
            r += j.rows
        return out

    @staticmethod
    def _sentence_seed(seed: Optional[int], si: int) -> Optional[int]:
        """Sentence si's seed from a request seed (ops/sampling.mix_seed)."""
        return None if seed is None else mix_seed(int(seed), si)

    # -- public API -------------------------------------------------------

    def _check_request(self, speaker_id: Optional[str]) -> None:
        if speaker_id is not None and self.speaker_list and speaker_id not in self.speaker_list:
            raise ValueError(f"invalid speaker_id: {speaker_id}")

    def _generation_cap(self, gen: Dict[str, Any]) -> int:
        """The effective max_mel_tokens: the mel position table caps it."""
        requested_cap = int(gen.get("max_mel_tokens", 600))
        if requested_cap > self.cfg.gpt.max_mel_tokens:
            warnings.warn(f"max_mel_tokens={requested_cap} exceeds the model's position "
                          f"table ({self.cfg.gpt.max_mel_tokens}); generation is capped "
                          "there", RuntimeWarning)
        return min(requested_cap, self.cfg.gpt.max_mel_tokens)

    def _emit(self, wav: np.ndarray, output_path: Optional[str], sr: int):
        if output_path:
            audio_io.write_wav(output_path, wav, sr)
            print(f">> saved: {output_path}")
            return output_path
        return sr, wav.astype(np.int16)[None, :].T

    def infer(self, audio_prompt: str, text: str, output_path: Optional[str],
              verbose: bool = False, max_text_tokens_per_sentence: int = 120,
              speaker_id: Optional[str] = None, seed: Optional[int] = None,
              **generation_kwargs):
        """Per-sentence synthesis (reference: infer.py:779-917): a drained
        `infer_stream`.  Sentence i samples from a generator seeded with
        mix_seed(seed, i)."""
        stats: Dict[str, Any] = {}
        chunks = list(self.infer_stream(
            audio_prompt, text, verbose=verbose,
            max_text_tokens_per_sentence=max_text_tokens_per_sentence,
            speaker_id=speaker_id, seed=seed, stats_out=stats, **generation_kwargs))
        sampling_rate = chunks[0][0] if chunks else self.cfg.dataset.sample_rate
        wav = np.concatenate([c for _, c in chunks]) if chunks else np.zeros(1, np.int16)
        # this run's stats, not self.last_stats, which a concurrent call may
        # have written since
        print(f">> total {stats['total_s']:.2f}s  (RTF: {stats['rtf']:.4f})")
        print(f"   gpt_gen {stats['gpt_gen_time']:.2f}s  "
              f"gpt_fwd {stats['gpt_forward_time']:.2f}s  "
              f"vocoder {stats['bigvgan_time']:.2f}s")
        return self._emit(wav, output_path, sampling_rate)

    def infer_stream(self, audio_prompt: str, text: str, verbose: bool = False,
                     max_text_tokens_per_sentence: int = 120,
                     speaker_id: Optional[str] = None, seed: Optional[int] = None,
                     stats_out: Optional[Dict[str, Any]] = None, stream_ahead: int = 8,
                     **generation_kwargs):
        """Streaming synthesis: returns a generator of (sample_rate, int16
        chunk), one chunk per sentence, which concatenate to `infer`'s wav.
        The prompt is analysed here, under the engine lock, so a bad prompt
        raises before any chunk.  A worker decodes sentence i+1 while
        sentence i is re-forwarded and vocoded; each takes the lock around
        its device work only, never across the hand-off of a chunk, so a
        stalled consumer does not block other syntheses (at most
        `stream_ahead` chunks wait in the queue).  Stats go to `stats_out`
        and `last_stats`, with `time_to_first_audio`."""
        self._check_request(speaker_id)
        with self._infer_lock:
            cond_mel = self._prompt_mel(audio_prompt) if audio_prompt else None
            cond_latent = self._conditioning(cond_mel, speaker_id)
            mel_ref = self._mel_ref(cond_mel, speaker_id)
        sentences = self.tokenizer.split_sentences(self.tokenizer.tokenize(text),
                                                   max_text_tokens_per_sentence)
        base_seed = self._rng_seed if seed is None else seed
        return self._stream_chunks(sentences, cond_latent, mel_ref, base_seed,
                                   dict(generation_kwargs), verbose, stats_out, stream_ahead)

    def _stream_chunks(self, sentences, cond_latent, mel_ref, base_seed: int,
                       gen: Dict[str, Any], verbose: bool,
                       stats_out: Optional[Dict[str, Any]], stream_ahead: int):
        start_time = time.perf_counter()
        sampling_rate = self.cfg.dataset.sample_rate
        phase = {"gpt_gen_time": 0.0, "gpt_forward_time": 0.0, "bigvgan_time": 0.0}
        effective_cap = self._generation_cap(gen)

        def decode_sentence(si, sent):
            ids = np.asarray(self.tokenizer.convert_tokens_to_ids(sent), np.int32)
            # the worker takes the lock itself: the producer does not hold it
            # while it waits for this decode
            with self._device_scope(), self._infer_lock:
                t0 = time.perf_counter()
                generator = torch.Generator(device=self.device).manual_seed(
                    mix_seed(base_seed, si))
                codes, lens, steps = self._decode_bucket(cond_latent, [ids], generator, gen)
                codes, lens = remove_long_silence(codes, lens, stop_token=self.stop_mel_token)
                phase["gpt_gen_time"] += time.perf_counter() - t0
            return ids, codes, lens, steps

        out_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, stream_ahead))
        stop = threading.Event()
        done = object()

        def hand_off(item) -> bool:
            """A blocking put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            first_chunk_time = None
            decode_steps = 0
            code_lens: List[int] = []
            sentence_codes: List[np.ndarray] = []
            total_samples = 0
            has_warned = False
            try:
                with self._device_scope(), \
                        concurrent.futures.ThreadPoolExecutor(1) as pool:
                    fut = pool.submit(decode_sentence, 0, sentences[0]) if sentences else None
                    for si in range(len(sentences)):
                        if stop.is_set():
                            return
                        ids, codes, lens, steps = fut.result()
                        if si + 1 < len(sentences):
                            fut = pool.submit(decode_sentence, si + 1, sentences[si + 1])
                        code_len = int(lens[0])
                        if not has_warned and code_len >= effective_cap:
                            warnings.warn("generation reached max_mel_tokens; consider "
                                          "shorter sentences", RuntimeWarning)
                            has_warned = True
                        decode_steps += steps
                        code_lens.append(code_len)
                        sentence_codes.append(codes[0, :code_len])
                        with self._infer_lock:
                            t0 = time.perf_counter()
                            latent = self._latents(cond_latent, ids, len(ids), codes[0],
                                                   code_len)
                            if self.device.type == "cuda":  # the re-forward, not its enqueue
                                torch.cuda.synchronize(self.device)
                            phase["gpt_forward_time"] += time.perf_counter() - t0
                            t0 = time.perf_counter()
                            wav = self._vocode(latent[None], mel_ref)
                            n_samples = code_len * self.cfg.gpt.mel_length_compression
                            chunk = wav[0, 0, :n_samples].cpu().numpy()
                            phase["bigvgan_time"] += time.perf_counter() - t0
                        if first_chunk_time is None:
                            first_chunk_time = time.perf_counter() - start_time
                        total_samples += len(chunk)
                        if not hand_off((sampling_rate, chunk)):
                            return
                total = time.perf_counter() - start_time
                wav_seconds = total_samples / sampling_rate
                stats = {"rtf": total / max(wav_seconds, 1e-9), "total_s": total,
                         "time_to_first_audio": first_chunk_time, "wav_seconds": wav_seconds,
                         "decode_steps": decode_steps, "code_lens": code_lens,
                         "codes": sentence_codes, **phase}
                with self._infer_lock:   # no other synthesis writes between
                    if stats_out is not None:
                        stats_out.update(stats)
                    self.last_stats = stats
                if verbose:
                    ttfa = -1.0 if first_chunk_time is None else first_chunk_time
                    print(f">> {len(sentences)} sentences, {decode_steps} decode steps; "
                          f"stream total {total:.2f}s  TTFA {ttfa:.2f}s "
                          f"(RTF {stats['rtf']:.4f})")
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                hand_off(e)
            finally:
                hand_off(done)

        threading.Thread(target=produce, daemon=True, name="infer-stream").start()
        try:
            while True:
                item = out_q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer is gone (close, exception, end): release the
            # producer, which checks `stop` between sentences and in hand_off
            stop.set()
            while True:
                try:
                    out_q.get_nowait()
                except queue_mod.Empty:
                    break

    def infer_fast(self, audio_prompt: str, text: str, output_path: Optional[str],
                   verbose: bool = False, max_text_tokens_per_sentence: int = 100,
                   sentences_bucket_max_size: int = 4, speaker_id: Optional[str] = None,
                   seed: Optional[int] = None, **generation_kwargs):
        """Batched long-text synthesis (reference: infer.py:595-777): the
        sentences are bucketed by length (`bucket_sentences`) and each bucket
        decodes as one batch of rows; bucket i samples from a generator
        seeded with mix_seed(seed, i).  Holds the engine lock throughout."""
        self._check_request(speaker_id)
        with self._infer_lock:
            return self._infer_fast_locked(audio_prompt, text, output_path, verbose,
                                           max_text_tokens_per_sentence,
                                           sentences_bucket_max_size, speaker_id, seed,
                                           dict(generation_kwargs))

    def _infer_fast_locked(self, audio_prompt, text, output_path, verbose,
                           max_text_tokens_per_sentence, sentences_bucket_max_size,
                           speaker_id, seed, gen: Dict[str, Any]):
        start_time = time.perf_counter()
        cond_mel = self._prompt_mel(audio_prompt) if audio_prompt else None
        cond_latent = self._conditioning(cond_mel, speaker_id)
        mel_ref = self._mel_ref(cond_mel, speaker_id)       # vocoder's [1, T, n_mels]
        sentences = self.tokenizer.split_sentences(self.tokenizer.tokenize(text),
                                                   max_text_tokens_per_sentence)
        sampling_rate = self.cfg.dataset.sample_rate
        buckets = bucket_sentences(sentences, sentences_bucket_max_size)
        base_seed = self._rng_seed if seed is None else seed
        effective_cap = self._generation_cap(gen)
        has_warned = False

        def decode_bucket(bi, bucket):
            id_lists = [np.asarray(self.tokenizer.convert_tokens_to_ids(item["sent"]), np.int32)
                        for item in bucket]
            with self._device_scope():
                generator = torch.Generator(device=self.device).manual_seed(
                    mix_seed(base_seed, bi))
                codes, lens, steps = self._decode_bucket(cond_latent, id_lists, generator, gen)
            codes, lens = remove_long_silence(codes, lens, stop_token=self.stop_mel_token)
            return id_lists, codes, lens, steps

        # one-deep pipeline: bucket i+1 decodes on a worker while bucket i's
        # re-forward and vocoder are enqueued here (both threads on the
        # default stream, so the device work stays in order); nothing is
        # fetched until every bucket is queued
        gpt_gen_time = gpt_forward_time = bigvgan_time = 0.0
        bucket_wavs = []
        bucket_steps: List[int] = []
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(decode_bucket, 0, buckets[0]) if buckets else None
            for bi, bucket in enumerate(buckets):
                t0 = time.perf_counter()
                id_lists, codes, lens, steps = fut.result()
                gpt_gen_time += time.perf_counter() - t0
                if bi + 1 < len(buckets):
                    fut = pool.submit(decode_bucket, bi + 1, buckets[bi + 1])
                if not has_warned and (lens >= effective_cap).any():
                    warnings.warn("generation reached max_mel_tokens", RuntimeWarning)
                    has_warned = True
                bucket_steps.append(steps)
                t0 = time.perf_counter()
                latents = self._latents_batch_dev(cond_latent, id_lists, codes, lens)
                gpt_forward_time += time.perf_counter() - t0   # enqueue time
                t0 = time.perf_counter()
                wav = self._vocode(latents, mel_ref)
                bucket_wavs.append((bucket, wav, codes, lens))
                bigvgan_time += time.perf_counter() - t0       # enqueue time

        # one fetch of every bucket's wav, the only wait on the device; then
        # each row is trimmed to code_len * 1024 samples, in sentence order
        t0 = time.perf_counter()
        fetched = [w.cpu().numpy() for _, w, _, _ in bucket_wavs]
        fetch_time = time.perf_counter() - t0
        parts: Dict[int, Tuple[np.ndarray, int, np.ndarray]] = {}
        for (bucket, _, codes, lens), wav_host in zip(bucket_wavs, fetched):
            for i, item in enumerate(bucket):
                n = int(lens[i])
                parts[item["idx"]] = (wav_host[i, 0][: n * self.cfg.gpt.mel_length_compression],
                                      n, codes[i, :n])
        order = sorted(parts)
        wav = (np.concatenate([parts[i][0] for i in order]) if parts
               else np.zeros(1, np.int16))
        total = time.perf_counter() - start_time
        wav_seconds = len(wav) / sampling_rate
        rtf = total / max(wav_seconds, 1e-9)
        print(f">> total {total:.2f}s  (RTF: {rtf:.4f})")
        print(f"   gpt_gen {gpt_gen_time:.2f}s  "
              f"gpt_fwd+vocoder enqueue {gpt_forward_time + bigvgan_time:.2f}s  "
              f"deferred fetch {fetch_time:.2f}s")
        if verbose:
            print(f">> {len(sentences)} sentences in {len(buckets)} buckets, "
                  f"{sum(bucket_steps)} decode steps")
        self.last_stats = {
            "rtf": rtf, "total_s": total, "wav_seconds": wav_seconds,
            "gpt_gen_time": gpt_gen_time, "gpt_forward_time": gpt_forward_time,
            "bigvgan_time": bigvgan_time, "fetch_time": fetch_time,
            "decode_steps": sum(bucket_steps), "bucket_steps": bucket_steps,
            "buckets": [len(b) for b in buckets],
            "code_lens": [parts[i][1] for i in order], "codes": [parts[i][2] for i in order]}
        return self._emit(wav, output_path, sampling_rate)

    def _pool_sentences(self, audio_prompt, text, speaker_id, max_text_tokens_per_sentence):
        """Conditioning, vocoder mel and sentence token ids of a pool request."""
        cond_mel = self._prompt_mel(audio_prompt) if audio_prompt else None
        cond = self._conditioning(cond_mel, speaker_id)
        mel_ref = self._mel_ref(cond_mel, speaker_id)
        sentences = self.tokenizer.split_sentences(self.tokenizer.tokenize(text),
                                                   max_text_tokens_per_sentence)
        id_lists = [np.asarray(self.tokenizer.convert_tokens_to_ids(s), np.int32)
                    for s in sentences]
        return cond, mel_ref, id_lists

    def _pool_submit(self, batcher, cond, id_lists, done_cb, seed, sampling,
                     max_mel_tokens) -> List[int]:
        """Submit a request's sentences; sentence si takes seed mix(seed, si)."""
        return [batcher.submit(ids, done_cb=done_cb, cond=cond, max_new=max_mel_tokens,
                               sampling=sampling, seed=self._sentence_seed(seed, si))
                for si, ids in enumerate(id_lists)]

    def pool_infer(self, batcher, audio_prompt: Optional[str], text: str,
                   speaker_id: Optional[str] = None, max_text_tokens_per_sentence: int = 100,
                   timeout: float = 600.0, seed: Optional[int] = None,
                   sampling: Optional[Dict[str, Any]] = None,
                   max_mel_tokens: Optional[int] = None) -> Tuple[int, np.ndarray]:
        """Synthesis through a shared continuous-batching pool: the sentences
        join the pool with this call's conditioning, `sampling` and `seed`
        (with a fixed seed the output does not depend on other traffic), and
        the finished codes run the latent and vocoder tail.  Thread-safe; the
        pool must be driven elsewhere (a step() loop: serve/httpd.py
        --continuous runs one).  Returns (sr, int16 wav)."""
        cond, mel_ref, id_lists = self._pool_sentences(audio_prompt, text, speaker_id,
                                                       max_text_tokens_per_sentence)
        results: Dict[int, np.ndarray] = {}
        done = threading.Event()

        def cb(rid, codes):
            results[rid] = codes
            if len(results) == len(id_lists):
                done.set()

        rids = self._pool_submit(batcher, cond, id_lists, cb, seed, sampling, max_mel_tokens)
        if not rids:
            return self.cfg.dataset.sample_rate, np.zeros(1, np.int16)
        if not done.wait(timeout):
            for rid in rids:  # reclaim the stuck sentences' decode budget
                batcher.cancel(rid)
            raise TimeoutError(f"pool synthesis timed out after {timeout}s")
        code_lists = [results[r] for r in rids]
        width = max(1, max(len(c) for c in code_lists))
        codes = np.full((len(code_lists), width), self.stop_mel_token, np.int64)
        lens = np.asarray([len(c) for c in code_lists], np.int64)
        for i, c in enumerate(code_lists):
            codes[i, : len(c)] = c
        wav = self._vocode_tail(cond, mel_ref, id_lists, codes, lens)
        return self.cfg.dataset.sample_rate, wav

    def pool_infer_stream(self, batcher, audio_prompt: Optional[str], text: str,
                          speaker_id: Optional[str] = None,
                          max_text_tokens_per_sentence: int = 100, timeout: float = 600.0,
                          seed: Optional[int] = None,
                          sampling: Optional[Dict[str, Any]] = None,
                          max_mel_tokens: Optional[int] = None):
        """Streaming synthesis through a shared pool: every sentence is
        submitted at once (here, before the first chunk is pulled, so setup
        errors raise here), and a generator yields (sr, int16 chunk) per
        sentence in order as each one's codes finish.  Sentences still
        decoding when the consumer stops (disconnect or timeout) are
        cancelled."""
        cond, mel_ref, id_lists = self._pool_sentences(audio_prompt, text, speaker_id,
                                                       max_text_tokens_per_sentence)
        sr = self.cfg.dataset.sample_rate
        results: Dict[int, np.ndarray] = {}
        arrived = threading.Condition()

        def cb(rid, codes):
            with arrived:
                results[rid] = codes
                arrived.notify_all()

        rids = self._pool_submit(batcher, cond, id_lists, cb, seed, sampling, max_mel_tokens)
        deadline = time.perf_counter() + timeout

        def chunks():
            emitted = 0
            try:
                for si, (rid, ids) in enumerate(zip(rids, id_lists)):
                    with arrived:
                        while rid not in results:
                            remaining = deadline - time.perf_counter()
                            if remaining <= 0 or not arrived.wait(remaining):
                                raise TimeoutError(
                                    f"pool stream timed out after {timeout}s "
                                    f"(sentence {si + 1}/{len(rids)})")
                        sent = results.pop(rid)
                    n = len(sent)
                    codes = np.full((1, max(1, n)), self.stop_mel_token, np.int64)
                    codes[0, :n] = sent
                    wav = self._vocode_tail(cond, mel_ref, [ids], codes,
                                            np.asarray([n], np.int64))
                    emitted = si + 1
                    yield sr, wav.astype(np.int16)
            finally:
                with arrived:
                    pending = [r for r in rids[emitted:] if r not in results]
                for rid in pending:
                    batcher.cancel(rid)

        return chunks()

    def _pool_conditioning(self, audio_prompt: Optional[str],
                           speaker_id: Optional[str]) -> torch.Tensor:
        """A pool's base conditioning: the prompt's or the speaker's, else the
        checkpoint's mean_condition, else zeros (each request may bring its
        own)."""
        if audio_prompt is None and speaker_id is None and self.mean_condition is None:
            return torch.zeros(1, self.cfg.gpt.condition_num_latent, self.cfg.gpt.model_dim,
                               dtype=self.gpt_dtype, device=self.device)
        cond_mel = self._prompt_mel(audio_prompt) if audio_prompt else None
        return self._conditioning(cond_mel, speaker_id)

    def _pool_defaults(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        kwargs.setdefault("cache_dtype", self.gpt_dtype)
        kwargs.setdefault("kv_dtype", self.kv_cache_dtype)
        kwargs.setdefault("max_new", min(600, self.cfg.gpt.max_mel_tokens))
        # multi-step ticks on the card; single steps on the CPU, where each
        # step is slow anyway
        kwargs.setdefault("steps_per_tick", 16 if self.device.type == "cuda" else 1)
        return kwargs

    def warmup(self, batch_sizes: Sequence[int] = (1,), text_widths: Sequence[int] = (64, 128),
               max_mel_tokens: int = 600, **generation_kwargs) -> None:
        """Run `_decode_bucket` once for each (batch size, text width) at the
        real `max_mel_tokens`, so the first request does not pay for the
        kernel build, cuDNN's and cuBLAS's first use or the caching
        allocator's growth."""
        rng = np.random.default_rng(0)
        cond = torch.zeros(1, self.cfg.gpt.condition_num_latent, self.cfg.gpt.model_dim,
                           dtype=self.gpt_dtype, device=self.device)
        gen = {**generation_kwargs, "max_mel_tokens": max_mel_tokens}
        with self._device_scope(), self._infer_lock:
            for B in batch_sizes:
                for width in text_widths:
                    ids = [rng.integers(2, 100, (width - 2,)).astype(np.int32)
                           for _ in range(B)]
                    self._decode_bucket(cond, ids, torch.Generator(device=self.device)
                                        .manual_seed(0), gen)

    def create_beam_batcher(self, audio_prompt: Optional[str] = None,
                            speaker_id: Optional[str] = None, **kwargs) -> BeamPoolBatcher:
        """Continuous beam decode pool (serve/beam_pool.py): the reference's
        default num_beams=3 requests on the throughput path.  submit / step
        / run / cancel as `create_batcher`'s pools, so `pool_infer`,
        `pool_infer_stream` and the server's drive loop take it as it is."""
        if self.tp > 1:
            raise ValueError("continuous beam batching is not supported with tp>1")
        return BeamPoolBatcher(self.gpt_params_batched, self.cfg.gpt,
                               self._pool_conditioning(audio_prompt, speaker_id),
                               device=self.device, **self._pool_defaults(kwargs))

    def create_batcher(self, audio_prompt: Optional[str] = None,
                       speaker_id: Optional[str] = None, dp: int = 0, **kwargs):
        """Continuous-batching decode pool (serve/scheduler.py) over this
        engine's weights, on its device: submit tokenised sentences, drain
        codes as they finish.  `dp` > 1 returns a `PoolGroup`, one pool per
        card over cuda:0 .. cuda:dp-1.  Refused under TP (a one-card pool, as in
        the JAX engine)."""
        if self.tp > 1:
            raise ValueError(
                "continuous batching (--continuous) is not supported with tensor-parallel "
                "inference (tp>1); run the pool on one card or use "
                "infer/infer_fast/infer_stream under TP")
        cond = self._pool_conditioning(audio_prompt, speaker_id)
        kwargs = self._pool_defaults(kwargs)
        if dp and dp > 1:
            if self.device.type != "cuda" or dp > torch.cuda.device_count():
                raise ValueError(f"dp={dp} needs {dp} CUDA devices; "
                                 f"{torch.cuda.device_count()} available")
            return PoolGroup.create(self.gpt_params_batched, self.cfg.gpt, cond,
                                    [torch.device("cuda", i) for i in range(dp)], **kwargs)
        return ContinuousBatcher(self.gpt_params_batched, self.cfg.gpt, cond,
                                 device=self.device, **kwargs)
