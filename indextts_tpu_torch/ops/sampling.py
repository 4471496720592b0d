"""Sampling ops for the autoregressive decode loop (counterpart of
indextts_tpu/ops/sampling.py).

Semantics of HF `generate`'s logits processors and warpers, as the reference
uses them (indextts/gpt/model.py:703-715, infer.py:628-635):

  * repetition penalty over every token already present (score/p if
    score > 0 else score*p), including the prompt ids HF sees;
  * warper order: temperature -> top-k -> top-p; top-p keeps the smallest
    set whose cumulative probability exceeds top_p, always the most probable;
  * the draw is the argmax of the filtered logits plus Gumbel noise, which is
    how `jax.random.categorical` samples; `sample_token` takes that noise as
    an optional tensor so tests can feed both packages the same draws.

The continuous pool samples each row with its own request's parameters
(`pack_sampling`, `sample_step_rows`) and its own noise: token i of a request
draws from a counter-based hash of (seed, i, column) computed on the device
(`row_gumbel`), so a request's codes are a pure function of (seed, params,
text), whatever its slot, tick or neighbours.  torch has no threefry, so the
bits differ from JAX's `fold_in(PRNGKey(seed), i)`; the tests feed JAX's
draws through the `gumbel` argument instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = torch.finfo(torch.float32).min


def init_penalty_presence(vocab_size: int, batch: int, prompt_token_ids=(1,),
                          start_token: Optional[int] = None,
                          device="cpu") -> torch.Tensor:
    """Presence table [B, V] bool for the repetition penalty.  The reference's
    decode prompt is all-ones with a trailing start token (gpt/model.py:
    658-667), so id 1 and the start token are penalised from step 0."""
    presence = torch.zeros(batch, vocab_size, dtype=torch.bool, device=device)
    for t in prompt_token_ids:
        presence[:, t] = True
    if start_token is not None:
        presence[:, start_token] = True
    return presence


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def _top_p_mask(sorted_logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep-mask over descending-sorted logits [B, K] (HF: drop tokens whose
    cumulative probability before them already exceeds top_p)."""
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    return ~(cum - probs > top_p)


def apply_typical_filter(logits: torch.Tensor, mass: float = 0.9,
                         min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Typical sampling filter (reference utils/typical_sampling.py:4-30)."""
    norm = torch.log_softmax(logits.float(), dim=-1)
    p = norm.exp()
    ent = -torch.where(p > 0, norm * p, 0.0).sum(dim=-1, keepdim=True)
    shifted = (-norm - ent).abs()
    sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(p, -1, order), dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True).clamp(min=min_tokens_to_keep - 1)
    threshold = torch.gather(sorted_shifted, -1, last_ind)
    return torch.where(shifted > threshold, NEG_INF, logits)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, descending,
    the lower index first among equals (`jax.lax.top_k`'s order; `torch.topk`
    promises no order among ties, which bf16 logits have often)."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(tiny, 1.0)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, *, temperature: float = 1.0, top_k: int = 30,
                 top_p: float = 0.8, do_sample: bool = True,
                 generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next token ids [B] from logits [B, V].  `gumbel` [B, k] (k = the
    shortlist width) replaces the noise drawn from `generator`."""
    logits = logits.float()
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    V = logits.shape[-1]
    k = top_k if 0 < top_k < V else V  # top_k <= 0 disables the k-filter
    shortlist, idx = _top_k(logits, k)
    shortlist = torch.where(_top_p_mask(shortlist, top_p), shortlist, NEG_INF)
    if gumbel is None:
        gumbel = gumbel_noise(shortlist.shape, generator, shortlist.device)
    choice = torch.argmax(shortlist + gumbel, dim=-1)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)


def sample_step(logits: torch.Tensor, presence: torch.Tensor, finished: torch.Tensor, *,
                stop_token: int, temperature: float = 1.0, top_k: int = 30,
                top_p: float = 0.8, repetition_penalty: float = 10.0,
                do_sample: bool = True, typical_sampling: bool = False,
                typical_mass: float = 0.9, generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Penalty -> (typical) -> warp -> sample -> stop.  Returns (token [B],
    presence', finished'); finished rows emit `stop_token`.  `presence` is
    updated in place."""
    logits = apply_repetition_penalty(logits.float(), presence, repetition_penalty)
    if typical_sampling:
        logits = apply_typical_filter(logits, typical_mass)
    token = sample_token(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                         do_sample=do_sample, generator=generator, gumbel=gumbel)
    token = torch.where(finished, torch.full_like(token, stop_token), token)
    presence[torch.arange(token.shape[0], device=token.device), token.long()] = True
    finished = finished | (token == stop_token)
    return token, presence, finished


def mix_seed(base: int, n: int) -> int:
    """Deterministic 31-bit seed for stream `n` derived from `base`
    (splitmix-style finalizer), as the JAX package derives per-stream seeds."""
    m = 0xFFFFFFFF
    x = (int(base) + 0x9E3779B9 * (n + 1)) & m
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    return x & 0x7FFFFFFF


# --- per-row sampling (continuous-batching pool) ---------------------------

SAMP_COLS = 5  # packed per-row parameters: temperature, top_k, top_p, penalty, do_sample
_M32 = 0xFFFFFFFF


def pack_sampling(temperature, top_k, top_p, repetition_penalty, do_sample):
    """Per-row sampling parameters packed into one float32 row [SAMP_COLS] (or
    [B, SAMP_COLS]), the layout `sample_step_rows` unpacks.  Host-side numpy:
    it runs once per request."""
    import numpy as np

    return np.stack([np.asarray(temperature, np.float32), np.asarray(top_k, np.float32),
                     np.asarray(top_p, np.float32),
                     np.asarray(repetition_penalty, np.float32),
                     np.asarray(do_sample, np.float32)], axis=-1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), without int64 overflow: the
    product is split at 16 bits, so CPU and CUDA give the same bits."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_gumbel(seeds: torch.Tensor, counters: torch.Tensor, k: int) -> torch.Tensor:
    """Gumbel draws [B, k] for token `counters[b]` of the request seeded
    `seeds[b]`: a hash of (seed, counter, column) on the device, turned into
    a uniform in (0, 1) from its top 24 bits and then into -log(-log(u))."""
    seed = _mix32(seeds.to(torch.int64) & _M32)
    row = _mix32((seed ^ (counters.to(torch.int64) & _M32)) & _M32)
    cols = _mul32(torch.arange(1, k + 1, device=seeds.device, dtype=torch.int64), 0x9E3779B9)
    bits = _mix32(row[:, None] ^ cols[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_step_rows(logits: torch.Tensor, presence: torch.Tensor, finished: torch.Tensor,
                     samp: torch.Tensor, seeds: Optional[torch.Tensor] = None,
                     counters: Optional[torch.Tensor] = None, *, stop_token: int,
                     shortlist_k: int = 64, gumbel: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row `sample_step`: penalty -> temperature -> top-k -> top-p ->
    sample, every parameter a per-row vector (`samp` [B, SAMP_COLS], see
    `pack_sampling`).  The noise is `gumbel` [B, k] when given, else
    `row_gumbel(seeds, counters, k)`.  `shortlist_k` bounds the per-row top_k
    (the pool rejects requests outside [1, shortlist_k]).  Greedy rows
    (do_sample=0) take the shortlist's top-1, ties to the lower index as
    `jax.lax.top_k` breaks them.  Returns (token [B] int32, presence',
    finished'); `presence` is updated in place."""
    temperature, top_p, rep_pen = samp[:, 0], samp[:, 2], samp[:, 3]
    top_k = samp[:, 1].to(torch.int64)
    do_sample = samp[:, 4] > 0.5
    logits = apply_repetition_penalty(logits.float(), presence, rep_pen[:, None])
    B, V = logits.shape
    k = min(shortlist_k, V)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    shortlist, idx = _top_k(scaled, k)                        # [B, k] descending
    greedy = idx[:, 0].to(torch.int32)
    keep = torch.arange(k, device=logits.device)[None, :] < top_k.clamp(1, k)[:, None]
    shortlist = torch.where(keep, shortlist, NEG_INF)
    shortlist = torch.where(_top_p_mask(shortlist, top_p[:, None]), shortlist, NEG_INF)
    if gumbel is None:
        gumbel = row_gumbel(seeds, counters, k)
    choice = torch.argmax(shortlist + gumbel, dim=-1)
    sampled = torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
    token = torch.where(do_sample, sampled, greedy)
    token = torch.where(finished, torch.full_like(token, stop_token), token)
    presence[torch.arange(B, device=logits.device), token.long()] = True
    return token, presence, finished | (token == stop_token)
