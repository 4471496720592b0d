"""Continuous-batching beam decode pool (counterpart of
indextts_tpu/serve/beam_pool.py).

The reference decodes with beam search (num_beams=3 on every API request,
reference api.py:253, infer.py:628-635).  The sampling pool
(serve/scheduler.py) cannot host it: beams need per-request multi-row state
and a selection across rows each step.  This pool holds G beam GROUPS, each
one request's nb beams, so reference-default clients get beam semantics on
the throughput path, interleaved with other requests' groups in one step.

It mirrors the dedicated `unified_voice.inference_speech_beam`, so a group's
codes equal the dedicated decode's for the same (seed, parameters, text):

  * split KV cache: the prompt prefix [cond | text | start] is prefilled once
    per request, alone (B = 1, text left-padded to a multiple of 16 as the
    engine pads the dedicated decode's), and stored once per group ([L, G,
    H, Pc, hd]); only the generated suffix lives per beam ([L, G*nb, H, Sc,
    hd]);
  * lineage-masked attention, no physical reorder: each row keeps the K/V it
    generated and carries an ancestry map (gpt2.decode_step_lineage_rows,
    the dedicated step's attention with a write position per row; frozen
    groups write nothing);
  * per-group knobs as tensors: temperature, top_p, repetition_penalty,
    length_penalty, seed and budget vary per request; num_beams, top_k and
    do_sample shape the step and are fixed per pool (submit raises on a
    mismatch; the server declares its fallback);
  * per-group noise: select i of group g draws its Gumbel noise [nb * V]
    from `select_noise(seed_g, i)`, a counter hash on the device (JAX folds
    0xBEA3 and i into the group's key), so a request's codes are a pure
    function of (seed, parameters, text) whatever the traffic.  The
    dedicated decode takes the same draws through its `gumbel` argument.

Host discipline is the sampling pool's: one tick runs `steps_per_tick`
steps and packs one int32 report, read a tick late through pinned memory
and an event; groups are admitted directly between ticks (no staging:
groups turn over hundreds of times slower than tokens).  State lives on the
pool's device in preallocated tensors; every update of a group that may be
frozen is a `torch.where` blend, since torch indexing has no drop mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import gpt2
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.models.gpt2 import KVCache
from indextts_tpu_torch.ops import beam as beam_lib
from indextts_tpu_torch.ops import quantization, sampling
from indextts_tpu_torch.ops.sampling import mix_seed
from indextts_tpu_torch.serve.scheduler import (_EMPTY_SEQ, _first_tensor, _Report, _Request,
                                                _tree_to)

SAMP_COLS = 4       # temperature, top_p, repetition_penalty, length_penalty
BEAM_STREAM = 0xBEA3


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def select_noise(seeds: torch.Tensor, counters: torch.Tensor, width: int) -> torch.Tensor:
    """Gumbel draws [G, width] for select `counters[g]` of the group seeded
    `seeds[g]`: `sampling.row_gumbel` on the seed mixed with 0xBEA3, one
    launch for every group."""
    return sampling.row_gumbel(seeds.to(torch.int64) ^ BEAM_STREAM, counters, width)


@dataclasses.dataclass
class BeamPoolState:
    """The pool's device state; admission and the step update it in place."""

    prefix: KVCache            # [L, G, H, Pc, hd] shared by a group's beams
    pmask: torch.Tensor        # [G, Pc] int32 prefix attention mask
    suffix: KVCache            # [L, G*nb, H, Sc, hd] per beam
    anc: torch.Tensor          # [G, nb, Sc] ancestry map
    seqs: torch.Tensor         # [G, nb, max_new] running sequences
    scores: torch.Tensor       # [G, nb] cumulative log-probs
    fin_scores: torch.Tensor   # [G, nb] hypothesis bank
    fin_seqs: torch.Tensor     # [G, nb, max_new]
    fin_lens: torch.Tensor     # [G, nb]
    presence: torch.Tensor     # [G*nb, V] repetition-penalty table
    prev_tok: torch.Tensor     # [G, nb] last selected token per beam
    n_gen: torch.Tensor        # [G] selects done (tokens in seqs)
    done: torch.Tensor         # [G] HF done latch
    active: torch.Tensor       # [G] occupied and still decoding
    budget: torch.Tensor       # [G] per-request max_new
    seed: torch.Tensor         # [G] per-request seed
    samp: torch.Tensor         # [G, SAMP_COLS]
    group_seq: torch.Tensor    # [G] request seq (-1 = free)
    out_codes: torch.Tensor    # [G, max_new] finalized best hypothesis
    out_len: torch.Tensor      # [G]


def _select(cfg: GPTConfig, nb: int, top_k: int, do_sample: bool, logits, presence,
            bstate: beam_lib.BeamState, seqs, step, done, samp, seeds):
    """One beam select over B groups, the dedicated decode's select with
    per-group step, knobs and noise: flat_scores -> beam_step -> done latch
    -> presence reordered by parent.  Returns (beam state, parent, token,
    seqs, presence, done); the caller freezes groups that do not run."""
    temp, top_p, rep = (samp[:, i].repeat_interleave(nb) for i in range(3))
    lp = samp[:, 3]
    flat = beam_lib.flat_scores(logits, presence, bstate.scores, nb, temperature=temp,
                                top_k=top_k, top_p=top_p, repetition_penalty=rep,
                                do_sample=do_sample)
    noise = select_noise(seeds, step, flat.shape[1]) if do_sample else None
    bstate, parent, token, seqs, best_cand = beam_lib.beam_step(
        flat, nb, bstate, seqs, step, cfg.stop_mel_token, do_sample, length_penalty=lp,
        done=done, gumbel=noise)
    # latch HF's _done after the step's banking (beam_search.py:300-306)
    done = done | beam_lib.batch_done(bstate, step, best_cand, lp)
    G = parent.shape[0]
    rows = (torch.arange(G, device=parent.device)[:, None] * nb + parent).reshape(-1)
    presence = presence[rows]
    presence[torch.arange(G * nb, device=parent.device), token.reshape(-1).long()] = True
    return bstate, parent, token, seqs, presence, done


def _admit_groups(params, cfg: GPTConfig, st: BeamPoolState, conds, text_tokens, text_mask,
                  groups, budgets, seqs_ids, samp, seeds, nb: int, top_k: int,
                  do_sample: bool, cache_dtype) -> None:
    """Prefill B requests, each alone (a request's numbers must not depend on
    the burst it arrived in), run their first select together and write them
    into the free groups `groups` [B]."""
    size = uv.trunk_size(cfg)
    B = text_tokens.shape[0]
    Pc = st.pmask.shape[1]
    V = cfg.number_mel_codes
    max_new = st.seqs.shape[2]
    dev = text_tokens.device
    ks, vs, masks, logits = [], [], [], []
    for b in range(B):
        emb, m = uv._prefill_inputs(params, cfg, conds[b], text_tokens[b: b + 1],
                                    text_mask[b: b + 1])
        hidden, cache = gpt2.prefill(params["gpt"], emb.to(cache_dtype), m, size, Pc,
                                     kv_dtype=st.prefix.k.dtype)
        ks.append(cache.k)
        vs.append(cache.v)
        masks.append(F.pad(m, (0, Pc - m.shape[1])))
        logits.append(uv._lm_head(params, hidden[:, -1]).repeat_interleave(nb, dim=0))
    presence0 = sampling.init_penalty_presence(V, B * nb, prompt_token_ids=(1,),
                                               start_token=cfg.start_mel_token, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    bstate, _, token, seqs_new, presence, done0 = _select(
        cfg, nb, top_k, do_sample, torch.cat(logits), presence0,
        beam_lib.init_beam_state(B, nb, max_new, dev),
        torch.zeros(B, nb, max_new, dtype=torch.int32, device=dev), zero,
        torch.zeros(B, dtype=torch.bool, device=dev), samp, seeds)
    beam_rows = (groups[:, None] * nb + torch.arange(nb, device=dev)[None, :]).reshape(-1)
    st.prefix.k[:, groups] = torch.cat(ks, dim=1)
    st.prefix.v[:, groups] = torch.cat(vs, dim=1)
    st.pmask[groups] = torch.cat(masks)
    st.suffix.k[:, beam_rows] = 0
    st.suffix.v[:, beam_rows] = 0
    st.anc[groups] = 0
    st.seqs[groups] = seqs_new
    st.scores[groups] = bstate.scores
    st.fin_scores[groups] = bstate.fin_scores
    st.fin_seqs[groups] = bstate.fin_seqs
    st.fin_lens[groups] = bstate.fin_lens
    st.presence[beam_rows] = presence
    st.prev_tok[groups] = token
    st.n_gen[groups] = 1
    st.done[groups] = done0
    st.active[groups] = True
    st.budget[groups] = budgets
    st.seed[groups] = seeds
    st.samp[groups] = samp
    st.group_seq[groups] = seqs_ids
    st.out_codes[groups] = 0
    st.out_len[groups] = 0


def _finalize_groups(cfg: GPTConfig, st: BeamPoolState, finish: torch.Tensor) -> None:
    """HF finalize for the groups whose exit fired (done latch or budget):
    the best hypothesis goes to out_codes/out_len and the group
    deactivates.  `finish` [G] bool."""
    best_seq, best_len, finished = beam_lib.finalize(
        beam_lib.BeamState(st.scores, st.fin_scores, st.fin_seqs, st.fin_lens), st.seqs,
        st.n_gen, length_penalty=st.samp[:, 3], done=st.done)
    max_new = st.seqs.shape[2]
    # banked winners carry the stop at len-1; running beams n_gen tokens
    lengths = torch.where(finished, best_len - 1, best_len).clamp(0, max_new)
    codes = torch.where(torch.arange(max_new, device=finish.device)[None, :] < lengths[:, None],
                        best_seq, cfg.stop_mel_token)
    st.out_codes = torch.where(finish[:, None], codes, st.out_codes)
    st.out_len = torch.where(finish, lengths.to(st.out_len.dtype), st.out_len)
    st.active = st.active & ~finish


def _exit_pass(cfg: GPTConfig, st: BeamPoolState) -> None:
    # the dedicated loop tests its exit before each trunk step
    _finalize_groups(cfg, st, st.active & (st.done | (st.n_gen >= st.budget)))


def _step_core(params, cfg: GPTConfig, st: BeamPoolState, nb: int, top_k: int,
               do_sample: bool, cache_dtype) -> None:
    """One decode step for every running group (the dedicated loop's body),
    after finalizing the groups whose exit fired."""
    size = uv.trunk_size(cfg)
    G = st.n_gen.shape[0]
    Sc = st.anc.shape[2]
    dev = st.n_gen.device
    _exit_pass(cfg, st)
    run = st.active
    step = st.n_gen
    beam_ids = torch.arange(nb, dtype=torch.int32, device=dev)
    mel_pos = (step + 1).clamp(0, cfg.max_mel_seq_len - 1).long().repeat_interleave(nb)
    emb = (params["mel_embedding"]["weight"][st.prev_tok.reshape(-1).long()]
           + params["mel_pos_embedding"]["weight"][mel_pos])[:, None, :]
    # each row owns the slot it writes this step
    slot = (step - 1).clamp(0, Sc - 1).long()
    anc = st.anc.clone()
    anc[torch.arange(G, device=dev), :, slot] = beam_ids
    anc = torch.where(run[:, None, None], anc, st.anc)
    valid = torch.arange(Sc, device=dev)[None, None, None, :] < step[:, None, None, None]
    owns = anc[:, :, None, :] == beam_ids[None, None, :, None]
    suffix_bias = torch.where(owns & valid, 0.0, gpt2.NEG_INF).float()
    prefix_bias = torch.where(st.pmask.bool(), 0.0, gpt2.NEG_INF).float()[:, None, None, :]
    # frozen groups park their write position at Sc: they write nothing
    pos = torch.where(run, slot, Sc).repeat_interleave(nb)
    hidden, _ = gpt2.decode_step_lineage_rows(
        params["gpt"], emb.to(cache_dtype), st.prefix, prefix_bias, st.suffix, suffix_bias,
        pos, size, nb)
    logits = uv._lm_head(params, hidden[:, 0])
    bstate, parent, token, seqs, presence, done = _select(
        cfg, nb, top_k, do_sample, logits, st.presence,
        beam_lib.BeamState(st.scores, st.fin_scores, st.fin_seqs, st.fin_lens), st.seqs,
        step, st.done, st.samp, st.seed)
    anc = torch.gather(anc, 1, parent[:, :, None].expand(G, nb, Sc).long())
    r1, r2 = run[:, None], run[:, None, None]
    st.anc = torch.where(r2, anc, st.anc)
    st.seqs = torch.where(r2, seqs, st.seqs)
    st.scores = torch.where(r1, bstate.scores, st.scores)
    st.fin_scores = torch.where(r1, bstate.fin_scores, st.fin_scores)
    st.fin_seqs = torch.where(r2, bstate.fin_seqs, st.fin_seqs)
    st.fin_lens = torch.where(r1, bstate.fin_lens, st.fin_lens)
    st.presence = torch.where(run.repeat_interleave(nb)[:, None], presence, st.presence)
    st.prev_tok = torch.where(r1, token, st.prev_tok)
    st.n_gen = st.n_gen + run.to(st.n_gen.dtype)
    st.done = torch.where(run, done, st.done)


def _step_kernel(params, cfg: GPTConfig, st: BeamPoolState, nb: int, top_k: int,
                 do_sample: bool, cache_dtype, steps: int = 1) -> torch.Tensor:
    """`steps` beam steps, then one packed int32 report on the device: row g
    = (active, out_len, group_seq, out_codes row)."""
    for _ in range(steps):
        _step_core(params, cfg, st, nb, top_k, do_sample, cache_dtype)
    # groups whose exit fired on the last step finalize here, so a report
    # never shows an inactive group with stale out fields
    _exit_pass(cfg, st)
    i32 = lambda t: t.to(torch.int32)[:, None]  # noqa: E731
    return torch.cat([i32(st.active), i32(st.out_len), i32(st.group_seq),
                      st.out_codes.to(torch.int32)], dim=1)


def _cancel_kernel(st: BeamPoolState, seqs: torch.Tensor) -> None:
    st.active = st.active & ~(st.group_seq[:, None] == seqs[None, :]).any(dim=1)


class BeamPoolBatcher:
    """Fixed-pool continuous beam decoding over one UnifiedVoice model, on
    one device (`device`, default: the device of `params`).

    submit / step / run / cancel / flush as `ContinuousBatcher`, so
    `engine.pool_infer`, `pool_infer_stream` and the server's drive loop
    take it as it is.  Per-request `sampling` overrides: temperature, top_p,
    repetition_penalty and length_penalty; num_beams, top_k and do_sample
    are fixed per pool, and submit raises ValueError on another value."""

    def __init__(self, params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                 num_groups: int = 2, num_beams: int = 3, max_text_width: int = 128,
                 max_new: int = 600, temperature: float = 1.0, top_k: int = 30,
                 top_p: float = 0.8, repetition_penalty: float = 10.0,
                 length_penalty: float = 0.0, do_sample: bool = True,
                 cache_dtype=torch.bfloat16, kv_dtype=None, seed: int = 0,
                 steps_per_tick: int = 1, device=None):
        self.device = torch.device(device) if device is not None \
            else _first_tensor(params).device
        # shared-scale int4 weights unpack once here (ops/quantization.py)
        self.params = quantization.nativize_int4(_tree_to(params, self.device))
        self.cfg = cfg
        self.cond = cond_latent.to(self.device)
        self.G = int(num_groups)
        self.nb = int(num_beams)
        self.top_k = int(top_k)
        self.do_sample = bool(do_sample)
        self.max_new = int(max_new)
        self.max_text_width = int(max_text_width)
        # [cond | text (start and stop added, left-padded to 16) | start mel]
        self.prefix_len = cfg.condition_num_latent + _round16(self.max_text_width + 2) + 1
        self.cache_dtype = cache_dtype
        self.defaults = dict(temperature=float(temperature), top_p=float(top_p),
                             repetition_penalty=float(repetition_penalty),
                             length_penalty=float(length_penalty))
        self.seed_base = int(seed)
        self.steps_per_tick = max(1, int(steps_per_tick))
        size = uv.trunk_size(cfg)
        kv = kv_dtype or cache_dtype
        G, nb, V, dev = self.G, self.nb, cfg.number_mel_codes, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = BeamPoolState(
            prefix=KVCache.zeros(size, G, self.prefix_len, kv, dev),
            pmask=zeros(G, self.prefix_len),
            suffix=KVCache.zeros(size, G * nb, self.max_new, kv, dev),
            anc=zeros(G, nb, self.max_new), seqs=zeros(G, nb, self.max_new),
            scores=zeros(G, nb, dtype=torch.float32),
            fin_scores=torch.full((G, nb), beam_lib.BANK_EMPTY, device=dev),
            fin_seqs=zeros(G, nb, self.max_new), fin_lens=zeros(G, nb),
            presence=zeros(G * nb, V, dtype=torch.bool),
            prev_tok=torch.full((G, nb), cfg.stop_mel_token, dtype=torch.int32, device=dev),
            n_gen=zeros(G), done=zeros(G, dtype=torch.bool), active=zeros(G, dtype=torch.bool),
            budget=zeros(G), seed=zeros(G, dtype=torch.int64),
            samp=zeros(G, SAMP_COLS, dtype=torch.float32),
            group_seq=torch.full((G,), _EMPTY_SEQ, dtype=torch.int32, device=dev),
            out_codes=zeros(G, self.max_new), out_len=zeros(G))
        self._live: Dict[int, _Request] = {}
        self._group_busy = [False] * G
        self._group_admit_step = [0] * G
        self._next_seq = 0
        self._queue: List[_Request] = []
        self._next_id = 0
        self._submit_lock = threading.Lock()
        self._cancelled: set = set()
        self._pending_report: Optional[Tuple[int, _Report]] = None
        self.step_count = 0
        self.max_top_k = self.top_k   # the sampling pool's attribute, for the server

    # -- host-side scheduling --------------------------------------------

    def _on_device(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    def _pack_sampling(self, s: Dict[str, Any]) -> np.ndarray:
        """Validate and pack one request's knobs (defaults from the pool's).
        Raises ValueError on values the pool cannot honour, including another
        num_beams, top_k or do_sample than the pool's."""
        d = self.defaults
        temperature = float(s.get("temperature", d["temperature"]))
        top_p = float(s.get("top_p", d["top_p"]))
        rep = float(s.get("repetition_penalty", d["repetition_penalty"]))
        lp = float(s.get("length_penalty", d["length_penalty"]))
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        if not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if rep <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {rep}")
        if "top_k" in s and int(s["top_k"]) != self.top_k:
            raise ValueError(f"beam pool decodes with top_k={self.top_k}; got {s['top_k']}")
        if "do_sample" in s and bool(s["do_sample"]) != self.do_sample:
            raise ValueError(f"beam pool decodes with do_sample={self.do_sample}")
        if "num_beams" in s and int(s["num_beams"]) != self.nb:
            raise ValueError(f"beam pool decodes with num_beams={self.nb}; "
                             f"got {s['num_beams']}")
        return np.asarray([temperature, top_p, rep, lp], np.float32)

    def submit(self, text_ids: np.ndarray, max_new: Optional[int] = None, done_cb=None,
               cond=None, sampling: Optional[Dict[str, Any]] = None,
               seed: Optional[int] = None) -> int:
        """Queue a request; thread-safe.  `cond` overrides the pool's
        conditioning ([1, 32, D]); `seed` pins its noise.  Raises ValueError,
        before queueing, for a prompt wider than max_text_width or knobs the
        pool cannot honour."""
        text_ids = np.asarray(text_ids, np.int32)
        if text_ids.shape[-1] > self.max_text_width:
            raise ValueError(f"prompt of {text_ids.shape[-1]} text tokens exceeds the "
                             f"pool's max_text_width={self.max_text_width}")
        samp = self._pack_sampling(sampling or {})
        budget = self.max_new if max_new is None else max(1, min(max_new, self.max_new))
        with self._submit_lock:
            rid = self._next_id
            req = _Request(rid, text_ids, budget, done_cb=done_cb, cond=cond, samp=samp,
                           seed=(mix_seed(self.seed_base, rid) if seed is None
                                 else int(seed) & 0x7FFFFFFF))
            self._next_id += 1
            self._queue.append(req)
        return req.req_id

    def cancel(self, req_id: int) -> None:
        """Best-effort cancellation, as the sampling pool's: safe from any
        thread; the request's done_cb never fires after it."""
        with self._submit_lock:
            self._cancelled.add(req_id)

    def _apply_cancellations(self) -> None:
        with self._submit_lock:
            if not self._cancelled:
                return
            cancelled, self._cancelled = self._cancelled, set()
            self._queue[:] = [r for r in self._queue if r.req_id not in cancelled]
        seqs = [seq for seq, r in self._live.items() if r.req_id in cancelled]
        for seq in seqs:
            self._live.pop(seq, None)
        if seqs:
            _cancel_kernel(self.state, torch.tensor(seqs, dtype=torch.int32,
                                                    device=self.device))

    def _admit(self) -> None:
        free = [g for g in range(self.G) if not self._group_busy[g]]
        take = min(len(free), len(self._queue))
        if not take:
            return
        groups, reqs = free[:take], self._queue[:take]
        prep = uv.prepare_text_prompt([r.text_ids for r in reqs], self.cfg.start_text_token,
                                      self.cfg.stop_text_token)
        prep_w = prep.text_tokens.shape[1]
        width = _round16(prep_w)
        dev = self.device
        tokens = torch.as_tensor(np.pad(prep.text_tokens, ((0, 0), (width - prep_w, 0))),
                                 device=dev)
        mask = torch.as_tensor(np.pad(prep.attn_text, ((0, 0), (width - prep_w, 0))),
                               device=dev)
        conds = [self.cond if r.cond is None
                 else torch.as_tensor(r.cond).to(dev, self.cond.dtype) for r in reqs]
        del self._queue[:take]
        seqs = list(range(self._next_seq, self._next_seq + take))
        self._next_seq += take
        as_t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                                         device=dev)
        _admit_groups(self.params, self.cfg, self.state, conds, tokens, mask,
               as_t(groups, torch.int64), as_t([r.max_new for r in reqs]), as_t(seqs),
               as_t(np.stack([r.samp for r in reqs]), torch.float32),
               as_t([r.seed for r in reqs], torch.int64), self.nb, self.top_k,
               self.do_sample, self.cache_dtype)
        for g, req, seq in zip(groups, reqs, seqs):
            self._group_busy[g] = True
            self._group_admit_step[g] = self.step_count
            self._live[seq] = req

    def _finish_seq(self, seq: int, n: int, codes_row: np.ndarray) -> None:
        req = self._live.pop(seq, None)
        if req is None:
            return
        if req.done_cb:
            try:
                req.done_cb(req.req_id, codes_row[: min(n, req.max_new)])
            except Exception:  # noqa: BLE001 — one failing callback must not
                traceback.print_exc()  # stop the report's other groups

    def _process_report(self, report: np.ndarray, at_step: int) -> None:
        active = report[:, 0].astype(bool)
        for g in range(self.G):
            if self._group_admit_step[g] >= at_step:
                continue   # admitted after this snapshot
            if not active[g]:
                seq = int(report[g, 2])
                if seq >= 0:
                    self._finish_seq(seq, int(report[g, 1]), report[g, 3:])
                self._group_busy[g] = False
            else:
                self._group_busy[g] = True

    def step(self) -> int:
        """One tick: admit into free groups, launch `steps_per_tick` steps,
        read the previous tick's report.  Returns the unfinished requests on
        the device."""
        early = self._pending_report
        if early is not None and self._queue and early[1].is_ready():
            self._pending_report = None
            self._process_report(early[1].numpy(), early[0])
        with self._on_device():
            self._apply_cancellations()
            self._admit()
            # with requests queued but none live (every occupant cancelled),
            # the tick still runs: its report frees the groups for them
            if not self._live and not self._queue:
                self.flush()
                return 0
            report = _step_kernel(self.params, self.cfg, self.state, self.nb, self.top_k,
                                  self.do_sample, self.cache_dtype, steps=self.steps_per_tick)
            self.step_count += self.steps_per_tick
            prev = self._pending_report
            self._pending_report = (self.step_count, _Report(report))
        if prev is not None:
            self._process_report(prev[1].numpy(), prev[0])
        return len(self._live)

    def flush(self) -> None:
        """Read the report of the final tick."""
        if self._pending_report is not None:
            at_step, handle = self._pending_report
            self._pending_report = None
            self._process_report(handle.numpy(), at_step)

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {req_id: codes}."""
        results: Dict[int, np.ndarray] = {}
        out_cb = lambda rid, codes: results.__setitem__(rid, codes)  # noqa: E731
        for req in list(self._live.values()) + self._queue:
            if req.done_cb is None:
                req.done_cb = out_cb
        while self._queue or self._live:
            self.step()
        self.flush()
        return results

    def warmup(self) -> None:
        """Drain throwaway requests through admission and the step (every
        group, then one more) before real traffic.  Call before starting an
        external drive loop."""
        text = np.ones((min(30, self.max_text_width),), np.int32)
        for _ in range(self.G + 1):
            self.submit(text, max_new=2)
        self.run()

