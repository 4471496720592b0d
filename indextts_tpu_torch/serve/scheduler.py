"""Continuous-batching decode pool (counterpart of
indextts_tpu/serve/scheduler.py).

The decode loop runs over a fixed pool of S slots: every slot holds an
independent request at its own cache offset, one step advances all of them,
and finished slots refill from the queue without stopping the pool, so the
card's weight bandwidth is shared by whatever traffic exists.

State lives on the pool's device in preallocated tensors that each step
updates in place (the JAX package donates its state tree instead).  The
cache is head-split [L, S, H, cache_len, hd] for `gpt2.decode_step_rows`, or
flat [L, S, cache_len, D] under `fused_trunk`, where each step runs the
pool-step kernel (K4, ops/cuda/pool_trunk.py).  Host and device:
  * a tick runs `steps_per_tick` steps and packs one int32 report, copied to
    pinned host memory without blocking; the host reads it a tick late
    (`step` never waits on the tick it just launched);
  * generated tokens accumulate on the device; a slot deactivates on the
    device (stop token or its token budget); each slot samples with its own
    request's parameters and noise (token i of a request draws from
    `sampling.row_gumbel(seed, i)`), so outputs do not depend on traffic;
  * admission prefills each request alone (the cuBLAS kernel for a product
    depends on its shape, so a request's numbers must not depend on the burst
    it arrived in) and writes the slots the host knows are free.

Staged refill: with `staging_rows` K > 0 the pool also holds K staging rows,
prefilled and first-sampled.  After each step, the oldest ready staged
request moves into the first free slot, on the device, and the slot's
finished request goes to an outbox row of the tick's report.  The decision
stays on the device: every update is a `torch.where` blend (the JAX package
scatters with out-of-range indices in drop mode, which torch has no form of),
and the outbox has one spare row that takes the write when no refill fires.
The host reconciles through per-request sequence numbers in the report, and
admits directly into slots only while no staged request is pending.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import gpt2
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.models.gpt2 import KVCache
from indextts_tpu_torch.ops import quantization, sampling
from indextts_tpu_torch.ops.cuda import pool_trunk

# report/outbox row tags: seq >= 0 is a live request id; _EMPTY_SEQ marks a
# never-occupied slot; _PAD_SEQ marks an unused outbox row
_EMPTY_SEQ = -1
_PAD_SEQ = -2

# the reference's default for the fused pool step (`fused_trunk`): off
FUSED_TRUNK_DEFAULT = False


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _first_tensor(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


@dataclasses.dataclass
class PoolState:
    """The pool's device state; the step and the refill update it in place."""

    cache: KVCache                  # [L, S, H, T, hd], or flat [L, S, T, D]
    prev_tok: torch.Tensor          # [S] last sampled token per slot
    n_gen: torch.Tensor             # [S] tokens generated so far (incl. prev)
    base: torch.Tensor              # [S] prefill length (first decode write slot)
    full_mask: torch.Tensor         # [S, T]
    presence: torch.Tensor          # [S, V] repetition-penalty table
    codes: torch.Tensor             # [S, max_new] generated tokens
    active: torch.Tensor            # [S] bool, self-deactivating
    budget: torch.Tensor            # [S] per-slot max_new
    slot_seq: torch.Tensor          # [S] request seq occupying each slot (-1 none)
    samp: torch.Tensor              # [S, SAMP_COLS] per-request sampling params
    seed: torch.Tensor              # [S] per-request seed
    # --- staging rows (K may be 0: staged refill off) -----------------------
    stage_cache: KVCache            # [L, K, H, stage_len, hd] (or flat)
    stage_ready: torch.Tensor       # [K] bool, consumable by the step
    stage_seq: torch.Tensor         # [K] request seq (consumed lowest first)
    stage_prev_tok: torch.Tensor    # [K] first sampled token
    stage_base: torch.Tensor        # [K] prefill length
    stage_mask: torch.Tensor        # [K, stage_len]
    stage_presence: torch.Tensor    # [K, V]
    stage_budget: torch.Tensor      # [K]
    stage_active: torch.Tensor      # [K] bool (first token not stop, budget > 1)
    stage_samp: torch.Tensor        # [K, SAMP_COLS]
    stage_seed: torch.Tensor        # [K]


def _prefill_first_sample(params, cfg: GPTConfig, cond, text_tokens, text_mask, samp, seeds,
                          cache_dtype, shortlist_k: int, flat: bool):
    """Prefill of [cond | text | start_mel] and the first token's sample for a
    burst of B requests.  Each request's prefill and head run alone (B=1), so
    its numbers do not depend on the burst; the sampling is row-wise.
    Returns (cache [L, B, H, P, hd] or flat [L, B, P, D] in cache_dtype,
    prefix mask [B, P], first token [B], presence [B, V])."""
    size = uv.trunk_size(cfg)
    B = text_tokens.shape[0]
    ks, vs, logits, pmask = [], [], [], None
    for b in range(B):
        emb, m = uv._prefill_inputs(params, cfg, cond[b: b + 1] if cond.shape[0] > 1 else cond,
                                    text_tokens[b: b + 1], text_mask[b: b + 1])
        hidden, cache = gpt2.prefill(params["gpt"], emb.to(cache_dtype), m, size, emb.shape[1])
        if flat:
            cache = KVCache(*gpt2.flatten_rows_cache(cache))
        ks.append(cache.k)
        vs.append(cache.v)
        logits.append(uv._lm_head(params, hidden[:, -1]))
        pmask = m if pmask is None else torch.cat([pmask, m])
    dev = text_tokens.device
    presence0 = sampling.init_penalty_presence(cfg.number_mel_codes, B, prompt_token_ids=(1,),
                                               start_token=cfg.start_mel_token, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    tok, presence, _ = sampling.sample_step_rows(
        torch.cat(logits), presence0, torch.zeros(B, dtype=torch.bool, device=dev), samp,
        seeds, zeros, stop_token=cfg.stop_mel_token, shortlist_k=shortlist_k)
    return KVCache(torch.cat(ks, dim=1), torch.cat(vs, dim=1)), pmask, tok, presence


def _write_rows(cache: KVCache, dst: torch.Tensor, src: KVCache, P: int) -> None:
    """cache rows `dst` [:P] <- src rows, in the cache's type (either layout)."""
    if cache.k.ndim == 4:
        cache.k[:, dst, :P] = src.k.to(cache.k.dtype)
        cache.v[:, dst, :P] = src.v.to(cache.v.dtype)
    else:
        cache.k[:, dst, :, :P] = src.k.to(cache.k.dtype)
        cache.v[:, dst, :, :P] = src.v.to(cache.v.dtype)


def _admit_insert(params, cfg: GPTConfig, state: PoolState, cond, text_tokens, text_mask,
                  slots, budgets, seqs, samp, seeds, cache_dtype, shortlist_k: int) -> None:
    """Prefill B requests, sample their first tokens and write them into the
    free slots `slots` [B].  A first-token stop or a budget <= 1 leaves the
    slot inactive on the device, so admission needs no host read."""
    cache, pmask, tok, presence = _prefill_first_sample(
        params, cfg, cond, text_tokens, text_mask, samp, seeds, cache_dtype, shortlist_k,
        flat=state.cache.k.ndim == 4)
    P = pmask.shape[1]
    _write_rows(state.cache, slots, cache, P)
    state.prev_tok[slots] = tok
    state.n_gen[slots] = 1
    state.base[slots] = P
    state.full_mask[slots] = F.pad(pmask, (0, state.full_mask.shape[1] - P))
    state.presence[slots] = presence
    codes = torch.zeros(slots.shape[0], state.codes.shape[1], dtype=state.codes.dtype,
                        device=tok.device)
    codes[:, 0] = tok
    state.codes[slots] = codes
    state.active[slots] = (tok != cfg.stop_mel_token) & (budgets > 1)
    state.budget[slots] = budgets
    state.slot_seq[slots] = seqs
    state.samp[slots] = samp
    state.seed[slots] = seeds


def _stage(params, cfg: GPTConfig, state: PoolState, cond, text_tokens, text_mask, rows,
           budgets, seqs, samp, seeds, cache_dtype, shortlist_k: int) -> None:
    """Prefill and first-sample B requests into the staging rows `rows`; the
    step swaps them into slots as slots free."""
    cache, pmask, tok, presence = _prefill_first_sample(
        params, cfg, cond, text_tokens, text_mask, samp, seeds, cache_dtype, shortlist_k,
        flat=state.cache.k.ndim == 4)
    P = pmask.shape[1]
    _write_rows(state.stage_cache, rows, cache, P)
    state.stage_ready[rows] = True
    state.stage_seq[rows] = seqs
    state.stage_prev_tok[rows] = tok
    state.stage_base[rows] = P
    state.stage_mask[rows] = F.pad(pmask, (0, state.stage_mask.shape[1] - P))
    state.stage_presence[rows] = presence
    state.stage_budget[rows] = budgets
    state.stage_active[rows] = (tok != cfg.stop_mel_token) & (budgets > 1)
    state.stage_samp[rows] = samp
    state.stage_seed[rows] = seeds


def _step_core(params, cfg: GPTConfig, state: PoolState, cache_dtype, shortlist_k: int) -> None:
    """Advance every active slot one token (self-deactivating).  Each slot
    samples with its own request's parameters and noise: token n of a request
    always draws from row_gumbel(seed, n).  A flat cache (`fused_trunk`) runs
    the trunk through the pool-step kernel (K4), a head-split one through
    `gpt2.decode_step_rows`."""
    size = uv.trunk_size(cfg)
    S = state.prev_tok.shape[0]
    T = state.full_mask.shape[1]
    max_new = state.codes.shape[1]
    active = state.active
    rows = torch.arange(S, device=active.device)
    # reference position numbering: generated token n -> mel position n+1
    mel_pos = (state.n_gen + 1).clamp(0, cfg.max_mel_seq_len - 1)
    emb = (params["mel_embedding"]["weight"][state.prev_tok.long()]
           + params["mel_pos_embedding"]["weight"][mel_pos.long()])
    write_pos = (state.base + state.n_gen - 1).clamp(0, T - 1).long()
    state.full_mask[rows, write_pos] = torch.maximum(active.to(state.full_mask.dtype),
                                                     state.full_mask[rows, write_pos])
    if state.cache.k.ndim == 4:
        x, k_rows, v_rows = pool_trunk.fused_pool_step(
            params["gpt"], emb.to(cache_dtype), state.cache.k, state.cache.v, write_pos,
            state.full_mask, size.heads)
        state.cache.k[:, rows, write_pos] = k_rows
        state.cache.v[:, rows, write_pos] = v_rows
        ln_f = params["gpt"]["ln_f"]
        hidden = gpt2.layer_norm(x[:, None, :], ln_f["scale"], ln_f["bias"])
    else:
        hidden, _ = gpt2.decode_step_rows(params["gpt"], emb[:, None].to(cache_dtype),
                                          state.cache, write_pos, state.full_mask, size)
    logits = uv._lm_head(params, hidden[:, 0])
    tok, state.presence, _ = sampling.sample_step_rows(
        logits, state.presence, ~active, state.samp, state.seed, state.n_gen,
        stop_token=cfg.stop_mel_token, shortlist_k=shortlist_k)
    slot_idx = state.n_gen.clamp(0, max_new - 1).long()
    state.codes[rows, slot_idx] = torch.where(active, tok.to(state.codes.dtype),
                                              state.codes[rows, slot_idx])
    n_gen = state.n_gen + active.to(state.n_gen.dtype)
    # self-deactivate: stop token sampled, or the slot's budget used up
    done = active & ((tok == cfg.stop_mel_token) | (n_gen >= state.budget))
    state.prev_tok = tok.to(state.prev_tok.dtype)
    state.n_gen = n_gen
    state.active = active & ~done


def _refill_one(state: PoolState, outbox: torch.Tensor, out_n: torch.Tensor) -> torch.Tensor:
    """Move the oldest ready staged request into the first free slot, at most
    one a step, all on the device.  The slot's previous occupant (seq, n_gen,
    codes) goes to outbox row out_n so the host can finish it; with no refill
    the write lands in the outbox's spare last row and every blend keeps the
    old values.  Returns out_n'."""
    S = state.prev_tok.shape[0]
    K = state.stage_ready.shape[0]
    dev = state.active.device
    free = ~state.active
    ready = state.stage_ready
    do = free.any() & ready.any()                                        # 0-d
    slot = torch.argmax(free.to(torch.int32)).view(1)                    # first free slot
    big = torch.iinfo(state.stage_seq.dtype).max
    srow = torch.argmin(torch.where(ready, state.stage_seq, big)).view(1)  # FIFO order

    # evacuate the slot's occupant (a finished request, or _EMPTY_SEQ)
    head = torch.stack([torch.zeros_like(state.n_gen[slot]), state.n_gen[slot],
                        torch.where(do, state.slot_seq[slot], _PAD_SEQ)], dim=1)
    out_row = torch.cat([head.to(outbox.dtype), state.codes[slot].to(outbox.dtype)], dim=1)
    out_idx = torch.where(do, out_n, outbox.shape[0] - 1).view(1)
    outbox[out_idx] = out_row

    stage_len = state.stage_mask.shape[1]
    for name in ("k", "v"):
        pool, staged = getattr(state.cache, name), getattr(state.stage_cache, name)
        if pool.ndim == 4:
            pool[:, slot, :stage_len] = torch.where(do, staged[:, srow], pool[:, slot, :stage_len])
        else:
            pool[:, slot, :, :stage_len] = torch.where(do, staged[:, srow],
                                                       pool[:, slot, :, :stage_len])
    sel = (torch.arange(S, device=dev) == slot) & do                     # [S]
    col = sel[:, None]

    def take(table, staged):  # row `slot` of table <- staged row srow, where sel
        return torch.where(col if table.ndim == 2 else sel, staged[srow], table)

    fm = F.pad(state.stage_mask[srow], (0, state.full_mask.shape[1] - stage_len))
    first = state.stage_prev_tok[srow]
    codes_row = torch.zeros(1, state.codes.shape[1], dtype=state.codes.dtype, device=dev)
    codes_row[:, 0] = first.to(state.codes.dtype)
    state.prev_tok = torch.where(sel, first, state.prev_tok)
    state.n_gen = torch.where(sel, torch.ones_like(state.n_gen), state.n_gen)
    state.base = take(state.base, state.stage_base)
    state.full_mask = torch.where(col, fm, state.full_mask)
    state.presence = take(state.presence, state.stage_presence)
    state.codes = torch.where(col, codes_row, state.codes)
    state.active = take(state.active, state.stage_active)
    state.budget = take(state.budget, state.stage_budget)
    state.slot_seq = take(state.slot_seq, state.stage_seq)
    state.samp = take(state.samp, state.stage_samp)
    state.seed = take(state.seed, state.stage_seed)
    state.stage_ready = ready & ~((torch.arange(K, device=dev) == srow) & do)
    return out_n + do.to(out_n.dtype)


def _step_kernel(params, cfg: GPTConfig, state: PoolState, cache_dtype, shortlist_k: int,
                 steps: int = 1) -> torch.Tensor:
    """`steps` decode steps, each followed by a staged refill, then one packed
    int32 report on the device:

        rows [0, S)        : (active, n_gen, slot_seq, codes row) per slot
        rows [S, S+steps)  : outbox, (0, n_gen, seq, codes row) per refill
                             evacuation this tick; unused rows seq=_PAD_SEQ
    """
    K = state.stage_ready.shape[0]
    max_new = state.codes.shape[1]
    dev = state.active.device
    n_out = steps if K else 0
    outbox = torch.full((n_out + 1, 3 + max_new), _PAD_SEQ, dtype=torch.int32, device=dev)
    out_n = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(steps):
        _step_core(params, cfg, state, cache_dtype, shortlist_k)
        if K:
            out_n = _refill_one(state, outbox, out_n)
    i32 = lambda t: t.to(torch.int32)[:, None]  # noqa: E731
    report = torch.cat([i32(state.active), i32(state.n_gen), i32(state.slot_seq),
                        state.codes.to(torch.int32)], dim=1)
    return torch.cat([report, outbox[:n_out]], dim=0)


def _cancel_kernel(state: PoolState, seqs: torch.Tensor) -> None:
    """Deactivate every slot / staging row occupied by one of `seqs`.  A
    cancelled staged request keeps its FIFO position (the kernel's seq-ordered
    consumption and the host's FIFO recycling stay aligned) but swaps in
    inactive."""
    hit_slot = (state.slot_seq[:, None] == seqs[None, :]).any(dim=1)
    hit_stage = (state.stage_seq[:, None] == seqs[None, :]).any(dim=1)
    state.active = state.active & ~hit_slot
    state.stage_active = state.stage_active & ~hit_stage


class _Report:
    """A tick's report on its way to the host: on CUDA, copied into pinned
    memory without blocking, with an event to poll or wait on."""

    def __init__(self, report: torch.Tensor):
        self._event = None
        if report.is_cuda:
            host = torch.empty(report.shape, dtype=report.dtype, pin_memory=True)
            stream = torch.cuda.current_stream(report.device)
            host.copy_(report, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
            report = host
        self._host = report

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _Request:
    req_id: int
    text_ids: np.ndarray
    max_new: int
    done_cb: Optional[Callable[[int, np.ndarray], None]] = None
    cond: Optional[Any] = None          # per-request [1, 32, D] conditioning
    samp: Optional[np.ndarray] = None   # packed [SAMP_COLS] sampling params
    seed: int = 0                       # per-request seed


class ContinuousBatcher:
    """Fixed-slot continuous decode pool over one UnifiedVoice model, on one
    device (`device`, default: the device of `params`)."""

    def __init__(self, params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                 num_slots: int = 8, max_text_width: int = 128, max_new: int = 600,
                 temperature: float = 1.0, top_k: int = 30, top_p: float = 0.8,
                 repetition_penalty: float = 10.0, do_sample: bool = True,
                 max_top_k: int = 64, cache_dtype=torch.bfloat16, kv_dtype=None,
                 seed: int = 0, steps_per_tick: int = 1, adaptive_ticks: bool = False,
                 staging_rows: Optional[int] = None, fused_trunk: Optional[bool] = None,
                 device=None):
        self.device = torch.device(device) if device is not None \
            else _first_tensor(params).device
        # shared-scale int4 weights unpack once here (ops/quantization.py)
        params = quantization.nativize_int4(_tree_to(params, self.device))
        self.params = params
        self.cfg = cfg
        self.cond = cond_latent.to(self.device)
        self.S = num_slots
        self.max_new = max_new
        self.max_text_width = max_text_width
        self.cache_len = cfg.condition_num_latent + max_text_width + 2 + 1 + max_new
        self.size = uv.trunk_size(cfg)
        if fused_trunk is None:
            fused_trunk = FUSED_TRUNK_DEFAULT and self.device.type == "cuda" and \
                pool_trunk.supported(num_slots, -(-self.cache_len // 8) * 8, cfg.model_dim,
                                     cfg.heads, params["gpt"])
        self.fused = bool(fused_trunk)
        if self.fused:  # the kernel's cache length is a multiple of 8
            self.cache_len = -(-self.cache_len // 8) * 8
            if not pool_trunk.supported(num_slots, self.cache_len, cfg.model_dim, cfg.heads,
                                        params["gpt"]):
                raise ValueError("fused_trunk=True: the pool-step kernel takes plain or int8 "
                                 "weights, a width that is a multiple of 128 and whole "
                                 f"8-slot tiles (num_slots={num_slots}, "
                                 f"width={cfg.model_dim})")
            if self.device.type == "cuda" and cfg.model_dim // cfg.heads != 64:
                raise ValueError("fused_trunk=True on CUDA needs a head width of 64")
        self.stage_len = self.cache_len - max_new
        # pool-level sampling defaults; each request may override them.
        # max_top_k bounds the shortlist: requests keep top_k in [1, max_top_k]
        self.max_top_k = int(max_top_k)
        self.default_sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                                     repetition_penalty=repetition_penalty,
                                     do_sample=do_sample)
        self.default_samp = self._pack_sampling(self.default_sampling)
        self.cache_dtype = cache_dtype
        self.kv_dtype = kv_dtype
        # staged refill: on for multi-step ticks (a finished slot would
        # otherwise sit dead for the rest of its tick and the report lag),
        # with K scaled to the pool (a staged row turns around in two ticks)
        if staging_rows is None:
            staging_rows = (0 if adaptive_ticks else
                            min(num_slots, max(8, (3 * num_slots) // 8))
                            if steps_per_tick > 1 else 0)
        if adaptive_ticks and staging_rows:
            raise ValueError(
                "adaptive_ticks and staged refill are mutually exclusive "
                "(adaptive tick sizing needs host-side slot occupancy, "
                "which in-kernel refill makes stale); pass staging_rows=0")
        self.K = int(staging_rows)
        # `seed` seeds the default per-request seeds only (a hash of the pool
        # seed and the request id); explicit seeds are the caller's
        self.seed_base = int(seed)
        self.step_count = 0
        self.steps_per_tick = max(1, steps_per_tick)
        self.adaptive_ticks = adaptive_ticks

        kv = kv_dtype or cache_dtype
        dev = self.device

        def kv_zeros(n: int, ln: int) -> KVCache:
            if self.fused:
                shape = (self.size.layers, n, ln, cfg.model_dim)
                return KVCache(torch.zeros(shape, dtype=kv, device=dev),
                               torch.zeros(shape, dtype=kv, device=dev))
            return KVCache.zeros(self.size, n, ln, kv, dev)

        def full(n, value, dtype=torch.int32):
            return torch.full((n,), value, dtype=dtype, device=dev)

        V = cfg.number_mel_codes
        samp = torch.as_tensor(self.default_samp, device=dev)
        self.state = PoolState(
            cache=kv_zeros(self.S, self.cache_len),
            prev_tok=full(self.S, cfg.stop_mel_token), n_gen=full(self.S, 0),
            base=full(self.S, 0),
            full_mask=torch.zeros(self.S, self.cache_len, dtype=torch.int32, device=dev),
            presence=torch.zeros(self.S, V, dtype=torch.bool, device=dev),
            codes=torch.zeros(self.S, max_new, dtype=torch.int32, device=dev),
            active=full(self.S, False, torch.bool), budget=full(self.S, 0),
            slot_seq=full(self.S, _EMPTY_SEQ), samp=samp.expand(self.S, -1).clone(),
            seed=full(self.S, 0, torch.int64),
            stage_cache=kv_zeros(self.K, self.stage_len),
            stage_ready=full(self.K, False, torch.bool), stage_seq=full(self.K, _EMPTY_SEQ),
            stage_prev_tok=full(self.K, 0), stage_base=full(self.K, 0),
            stage_mask=torch.zeros(self.K, self.stage_len, dtype=torch.int32, device=dev),
            stage_presence=torch.zeros(self.K, V, dtype=torch.bool, device=dev),
            stage_budget=full(self.K, 0), stage_active=full(self.K, False, torch.bool),
            stage_samp=samp.expand(self.K, -1).clone(), stage_seed=full(self.K, 0, torch.int64))
        # host bookkeeping, keyed by per-request seq (assigned at admission or
        # staging); slots are reconciled from report rows
        self._live: Dict[int, _Request] = {}      # admitted or staged, unfinished
        self._next_seq = 0
        self._slot_req: List[Optional[_Request]] = [None] * self.S  # direct admits
        self._slot_busy = [False] * self.S
        self._slot_admit_step = [0] * self.S   # step_count at direct admission
        self._staged_fifo: List[Tuple[int, int]] = []   # (seq, staging row)
        self._stage_free_rows: List[int] = list(range(self.K))
        self._queue: List[_Request] = []
        self._next_id = 0
        self._submit_lock = threading.Lock()
        # req_ids cancelled by callers (HTTP handler threads); the drive
        # thread applies them at its next tick: only the drive thread touches
        # device state
        self._cancelled: set = set()
        # one-tick-lagged report: (step_count at dispatch end, report)
        self._pending_report: Optional[Tuple[int, _Report]] = None

    # -- host-side scheduling --------------------------------------------

    def _on_device(self):
        """The pool's card as the current device, for its kernel launches."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    def _pack_sampling(self, s: Dict[str, Any]) -> np.ndarray:
        """Validate and pack one request's sampling parameters (defaults from
        the pool's).  Raises ValueError on parameters the pool cannot honour."""
        temperature = float(s.get("temperature", self.default_sampling["temperature"]))
        top_k = int(s.get("top_k", self.default_sampling["top_k"]))
        top_p = float(s.get("top_p", self.default_sampling["top_p"]))
        rep = float(s.get("repetition_penalty", self.default_sampling["repetition_penalty"]))
        do_sample = bool(s.get("do_sample", self.default_sampling["do_sample"]))
        if do_sample:
            if temperature <= 0:
                raise ValueError(f"temperature must be > 0, got {temperature}")
            if not 1 <= top_k <= self.max_top_k:
                raise ValueError(
                    f"pool top_k must be in [1, {self.max_top_k}] (the "
                    f"pool's static shortlist bound, max_top_k), got {top_k}")
            if not 0 < top_p <= 1:
                raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if rep <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {rep}")
        return sampling.pack_sampling(temperature, top_k, top_p, rep, 1.0 if do_sample else 0.0)

    def _default_seed(self, req_id: int) -> int:
        """Default per-request seed: a hash of the pool seed and the request
        id (ops/sampling.mix_seed, shared with the engine)."""
        return sampling.mix_seed(self.seed_base, req_id)

    def submit(self, text_ids: np.ndarray, max_new: Optional[int] = None, done_cb=None,
               cond=None, sampling: Optional[Dict[str, Any]] = None,
               seed: Optional[int] = None) -> int:
        """Queue a request; thread-safe.  `cond` overrides the pool's
        conditioning for this request ([1, 32, D]); `sampling` overrides the
        pool's defaults (temperature / top_k / top_p / repetition_penalty /
        do_sample); `seed` pins its noise, so (seed, sampling, text) fix its
        codes whatever the traffic.  Raises ValueError, before queueing, for a
        prompt wider than max_text_width or parameters the pool cannot
        honour."""
        text_ids = np.asarray(text_ids, np.int32)
        if text_ids.shape[-1] > self.max_text_width:
            raise ValueError(
                f"prompt of {text_ids.shape[-1]} text tokens exceeds the "
                f"pool's max_text_width={self.max_text_width}")
        samp = self.default_samp if sampling is None else self._pack_sampling(sampling)
        # max_new=0 is a real budget (finish after the admission sample)
        budget = self.max_new if max_new is None else max(0, min(max_new, self.max_new))
        with self._submit_lock:
            rid = self._next_id
            req = _Request(rid, text_ids, budget, done_cb=done_cb, cond=cond, samp=samp,
                           seed=(self._default_seed(rid) if seed is None
                                 else int(seed) & 0x7FFFFFFF))
            self._next_id += 1
            self._queue.append(req)
        return req.req_id

    def cancel(self, req_id: int) -> None:
        """Best-effort cancellation, safe from any thread and idempotent:
        queued requests are dropped, admitted or staged ones deactivated on
        the device at the drive loop's next tick.  The request's done_cb
        never fires after cancel(); unknown or finished ids are ignored."""
        with self._submit_lock:
            self._cancelled.add(req_id)

    def _apply_cancellations(self) -> None:
        with self._submit_lock:
            if not self._cancelled:
                return
            cancelled, self._cancelled = self._cancelled, set()
            # in-place filter: submit() appends to this same list object
            self._queue[:] = [r for r in self._queue if r.req_id not in cancelled]
        seqs = [seq for seq, r in self._live.items() if r.req_id in cancelled]
        for seq in seqs:
            self._live.pop(seq, None)
        if seqs:
            _cancel_kernel(self.state, torch.tensor(seqs, dtype=torch.int32,
                                                    device=self.device))

    def _prep_burst(self, reqs: List[_Request]):
        """Text tokens and masks of a burst, left-padded to a 32-multiple
        width, and its conditioning, budgets, sampling rows and seeds, as
        device tensors."""
        prep = uv.prepare_text_prompt([r.text_ids for r in reqs], self.cfg.start_text_token,
                                      self.cfg.stop_text_token)
        prep_w = prep.text_tokens.shape[1]
        if prep_w > self.max_text_width + 2:  # submit() validates; raise before mutating
            raise ValueError(
                f"prompt of {prep_w - 2} text tokens exceeds the pool's "
                f"max_text_width={self.max_text_width}")
        width = min(max(32, -(-prep_w // 32) * 32), self.max_text_width + 2)
        pad = width - prep_w
        dev = self.device
        tokens = torch.as_tensor(np.pad(prep.text_tokens, ((0, 0), (pad, 0))), device=dev)
        mask = torch.as_tensor(np.pad(prep.attn_text, ((0, 0), (pad, 0))), device=dev)
        if any(r.cond is not None for r in reqs):
            cond = torch.cat([torch.as_tensor(r.cond).to(dev, self.cond.dtype)
                              if r.cond is not None else self.cond for r in reqs])
        else:
            cond = self.cond
        samp = np.stack([self.default_samp if r.samp is None else r.samp for r in reqs])
        as_t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                                         device=dev)
        return (tokens, mask, cond, as_t([r.max_new for r in reqs]), as_t(samp, torch.float32),
                as_t([r.seed for r in reqs], torch.int64))

    def _assign_seqs(self, n: int) -> List[int]:
        seqs = list(range(self._next_seq, self._next_seq + n))
        self._next_seq += n
        return seqs

    def _admit(self) -> None:
        """Move queued requests onto the device: into slots the host knows
        are free (only while no staged request is pending), then into free
        staging rows."""
        if not self._queue:
            return
        dev = self.device
        if not self._staged_fifo:
            free = [s for s in range(self.S) if not self._slot_busy[s]]
            take = min(len(free), len(self._queue))
            if take:
                slots, reqs = free[:take], self._queue[:take]
                tokens, mask, cond, budgets, samp, seeds = self._prep_burst(reqs)
                del self._queue[:take]
                seqs = self._assign_seqs(take)
                _admit_insert(self.params, self.cfg, self.state, cond, tokens, mask,
                              torch.tensor(slots, device=dev), budgets,
                              torch.tensor(seqs, dtype=torch.int32, device=dev), samp, seeds,
                              self.cache_dtype, self.max_top_k)
                for slot, req, seq in zip(slots, reqs, seqs):
                    self._slot_req[slot] = req
                    self._slot_busy[slot] = True
                    self._slot_admit_step[slot] = self.step_count
                    self._live[seq] = req
        if self.K and self._queue and self._stage_free_rows:
            take = min(len(self._stage_free_rows), len(self._queue))
            rows, reqs = self._stage_free_rows[:take], self._queue[:take]
            # _prep_burst may raise: consume rows and queue only after it
            tokens, mask, cond, budgets, samp, seeds = self._prep_burst(reqs)
            del self._stage_free_rows[:take]
            del self._queue[:take]
            seqs = self._assign_seqs(take)
            _stage(self.params, self.cfg, self.state, cond, tokens, mask,
                   torch.tensor(rows, device=dev), budgets,
                   torch.tensor(seqs, dtype=torch.int32, device=dev), samp, seeds,
                   self.cache_dtype, self.max_top_k)
            for row, req, seq in zip(rows, reqs, seqs):
                self._staged_fifo.append((seq, row))
                self._live[seq] = req

    def _finish_seq(self, seq: int, n_gen: int, codes_row: np.ndarray) -> None:
        """Complete a request (idempotent: later rows naming a finished seq are
        skipped)."""
        req = self._live.pop(seq, None)
        if req is None:
            return
        codes = codes_row[: min(n_gen, req.max_new)]
        if len(codes) and codes[-1] == self.cfg.stop_mel_token:
            codes = codes[:-1]
        if req.done_cb:
            try:
                req.done_cb(req.req_id, codes)
            except Exception:  # noqa: BLE001 — a failing callback (client gone,
                # handler bug) must not stop this report's other rows, which
                # carry one-shot outbox evacuations and staging recycles
                traceback.print_exc()

    def _process_report(self, report: np.ndarray, at_step: int) -> None:
        """Reconcile host state from a report (see _step_kernel): outbox
        evacuations first, then slot rows.  One staging row is recycled per
        evacuation: the step consumes staged requests in seq (FIFO) order."""
        slot_rows, out_rows = report[: self.S], report[self.S:]
        for row in out_rows:
            seq = int(row[2])
            if seq >= 0:
                self._finish_seq(seq, int(row[1]), row[3:])
        consumed = int((out_rows[:, 2] != _PAD_SEQ).sum()) if len(out_rows) else 0
        for _ in range(consumed):
            if self._staged_fifo:
                _, srow = self._staged_fifo.pop(0)
                self._stage_free_rows.append(srow)
        active = slot_rows[:, 0].astype(bool)
        for s in range(self.S):
            if self._slot_admit_step[s] >= at_step:
                continue  # direct-admitted after this snapshot
            if not active[s]:
                seq = int(slot_rows[s, 2])
                if seq >= 0:
                    self._finish_seq(seq, int(slot_rows[s, 1]), slot_rows[s, 3:])
                self._slot_busy[s] = False
                self._slot_req[s] = None
            else:
                self._slot_busy[s] = True
                # after an in-kernel refill the occupant is a staged request
                self._slot_req[s] = self._live.get(int(slot_rows[s, 2]))

    def _tick_steps(self) -> int:
        """Steps for this tick: `steps_per_tick`, or with `adaptive_ticks` and
        requests queued, the largest power of two within the smallest
        remaining per-slot budget (a slot that finishes early in a long tick
        sits dead for the rest of it).  Each request's noise follows its own
        token index, so results do not depend on how steps split into
        ticks."""
        if not self.adaptive_ticks or not self._queue:
            return self.steps_per_tick
        live = [(s, r) for s, r in enumerate(self._slot_req) if r is not None]
        if not live:
            return 1
        rem = min(max(1, r.max_new - (self.step_count - self._slot_admit_step[s]) - 1)
                  for s, r in live)
        steps = 1
        while steps * 2 <= min(rem, self.steps_per_tick):
            steps *= 2
        return steps

    def step(self) -> int:
        """One tick: admit and stage, launch up to `steps_per_tick` steps (with
        refills), read the previous tick's report.  Returns the number of
        unfinished requests on the device."""
        # a report already on the host (no stall) is read before admitting,
        # so the slots it frees refill this tick
        early = self._pending_report
        if early is not None and self._queue and early[1].is_ready():
            self._pending_report = None
            self._process_report(early[1].numpy(), early[0])
        with self._on_device():
            self._apply_cancellations()
            self._admit()
            # with requests queued but none live (every occupant cancelled),
            # the tick still runs: its report frees the slots for them
            if not self._live and not self._queue:
                self.flush()
                return 0
            steps = self._tick_steps()
            report = _step_kernel(self.params, self.cfg, self.state, self.cache_dtype,
                                  self.max_top_k, steps=steps)
            self.step_count += steps
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
        """Drain throwaway requests through admission, staging and the step
        before real traffic, so the kernel library is built and the cuBLAS
        handles exist.  torch compiles nothing per shape, so one width
        serves every bucket.  Call before starting an external drive loop
        (run() drains inline)."""
        text = np.ones((min(30, self.max_text_width),), np.int32)
        for _ in range(self.S):
            self.submit(text, max_new=2)
        for _ in range(self.K + 1):
            self.submit(text, max_new=0)
        self.run()


class PoolGroup:
    """Data-parallel serving: one `ContinuousBatcher` per card.

    Each pool's weights and state live on its own device, so one host thread
    driving `step()` round-robin keeps every card busy: launches return at
    once, and each pool's report is read a tick late.  Requests go to the
    pool with the fewest outstanding requests (queued + live), ties to the
    lowest index.  Request ids are global across the group."""

    def __init__(self, batchers: List[ContinuousBatcher]):
        if not batchers:
            raise ValueError("PoolGroup needs at least one batcher")
        self.batchers = list(batchers)
        self._next_id = 0
        self._submit_lock = threading.Lock()
        # codes of requests submitted without a callback, until run()
        self._unclaimed: Dict[int, np.ndarray] = {}
        # group id -> (batcher, pool-local id), for cancel()
        self._routes: Dict[int, Tuple[ContinuousBatcher, int]] = {}

    @classmethod
    def create(cls, params, cfg: GPTConfig, cond_latent, devices, **kwargs) -> "PoolGroup":
        """One pool per device, identical configuration."""
        return cls([ContinuousBatcher(params, cfg, cond_latent, device=d, **kwargs)
                    for d in devices])

    def _load(self, b: ContinuousBatcher) -> int:
        return len(b._queue) + len(b._live)

    @property
    def max_top_k(self) -> int:
        """The pools' shortlist bound (identical across the group)."""
        return self.batchers[0].max_top_k

    def submit(self, text_ids, max_new: Optional[int] = None, done_cb=None, cond=None,
               sampling=None, seed: Optional[int] = None) -> int:
        # id, routing and enqueue are one atomic section: concurrent callers
        # must neither share an id nor pick a pool from a stale load
        with self._submit_lock:
            gid = self._next_id
            self._next_id += 1
            b = min(self.batchers, key=self._load)

            def cb(_lrid, codes, _g=gid, _cb=done_cb):
                self._routes.pop(_g, None)
                if _cb is not None:
                    _cb(_g, codes)
                else:
                    self._unclaimed[_g] = codes

            lrid = b.submit(text_ids, max_new=max_new, done_cb=cb, cond=cond,
                            sampling=sampling, seed=seed)
            self._routes[gid] = (b, lrid)
        return gid

    def cancel(self, req_id: int) -> None:
        """Best-effort cancellation by group id; unknown ids are ignored."""
        route = self._routes.pop(req_id, None)
        if route is not None:
            route[0].cancel(route[1])

    def step(self) -> int:
        """One tick on every pool; returns the unfinished requests."""
        return sum(b.step() for b in self.batchers)

    def flush(self) -> None:
        for b in self.batchers:
            b.flush()

    @property
    def _queue(self) -> List[_Request]:
        """Combined backlog (drive loops test its truthiness)."""
        return [r for b in self.batchers for r in b._queue]

    def run(self) -> Dict[int, np.ndarray]:
        """Drain all pools; returns {group id: codes} for requests submitted
        without a callback."""
        while any(b._queue or b._live for b in self.batchers):
            self.step()
        self.flush()
        out, self._unclaimed = self._unclaimed, {}
        return out

    def warmup(self) -> None:
        for b in self.batchers:
            b.warmup()
