"""Beam decode helpers over fixed shapes (counterpart of
indextts_tpu/ops/beam.py).

The reference decodes with HF `generate(num_beams=3, do_sample=True)`
(infer.py:628-635), "beam sample": each step sums beam log-probs with
warped token log-probs over the flattened [beams x vocab] space, draws 2*nb
candidates (sampled, or the top 2*nb when do_sample=False), banks the
finished ones as hypotheses and keeps the best nb that continue.  The loop
lives in models/unified_voice.inference_speech_beam; length_penalty=0 (the
reference default) scores by raw cumulative log-prob.

Every selection breaks ties toward the lower index, as `jax.lax.top_k` and
the stable `jnp.argsort` of the JAX package do: dead beams start at -1e9
with identical logits, and filtered tokens all sit at float32 min, so exact
ties are common and `torch.topk` (which promises no order) would pick other
parents and tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from indextts_tpu_torch.ops import sampling
from indextts_tpu_torch.ops.sampling import NEG_INF as FILTER_NEG
from indextts_tpu_torch.ops.sampling import _top_k

# Beam-score sentinel: HF's -1e9 for dead beams at init and for stop
# candidates in the continuing ranking.  Token filtering uses the lower
# FILTER_NEG (float32 min), so a filtered token never outranks a dead beam's
# real candidate (-1e9 + logprob).
NEG_INF = -1e9
# Empty-bank sentinel: loses to any real length-penalised score, which with a
# negative length_penalty can fall below -1e9.  Only compared, never used in
# arithmetic; a full bank is one whose last score is finite.
BANK_EMPTY = float("-inf")

Scalar = Union[float, torch.Tensor]


def _col(v: Scalar, like: torch.Tensor) -> Scalar:
    """A per-row [R] parameter as a column [R, 1]; a scalar stays one."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.to(device=like.device, dtype=torch.float32)[:, None]
    return v


def flat_scores(logits: torch.Tensor, presence: torch.Tensor, beam_scores: torch.Tensor,
                num_beams: int, *, temperature: Scalar = 1.0, top_k: int = 30,
                top_p: Scalar = 0.8, repetition_penalty: Scalar = 10.0,
                typical_sampling: bool = False, typical_mass: float = 0.9,
                do_sample: bool = True) -> torch.Tensor:
    """Candidate totals [B, nb*V] in HF 4.44 beam_sample order: log_softmax
    -> processors on the log-probs (repetition penalty, typical filter) ->
    + beam scores -> warpers per beam row (temperature, top-k, top-p, with
    min_tokens_to_keep=2) -> flatten.  Warpers run only when sampling.

    logits, presence [B*nb, V]; beam_scores [B, nb]; temperature, top_p and
    repetition_penalty may be scalars or per-row [B*nb] tensors."""
    temperature = _col(temperature, logits)
    top_p = _col(top_p, logits)
    repetition_penalty = _col(repetition_penalty, logits)
    Bnb, V = logits.shape
    B = Bnb // num_beams
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp = sampling.apply_repetition_penalty(lp, presence, repetition_penalty)
    if typical_sampling:
        lp = sampling.apply_typical_filter(lp, typical_mass, min_tokens_to_keep=2)
    sc = lp + beam_scores.reshape(-1)[:, None]
    if do_sample:
        min_keep = 2
        sc = sc / temperature
        if 0 < top_k < V:
            # after the top-k filter only kk values survive, so the nucleus
            # threshold is found on the kk-shortlist
            kk = max(top_k, min_keep)
            shortlist = torch.topk(sc, kk, dim=-1).values         # values: no tie order
            probs = torch.softmax(shortlist, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs <= top_p) | (torch.arange(kk, device=sc.device) < min_keep)
            last = keep.sum(dim=-1, keepdim=True) - 1
            thresh = torch.gather(shortlist, -1, last)
            sc = torch.where(sc < thresh, FILTER_NEG, sc)
        else:
            ssc, order = torch.sort(sc, dim=-1, descending=True, stable=True)
            probs = torch.softmax(ssc, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            remove_sorted = (cum - probs > top_p) & (torch.arange(V, device=sc.device)
                                                     >= min_keep)
            remove = torch.zeros_like(remove_sorted).scatter_(-1, order, remove_sorted)
            sc = torch.where(remove, FILTER_NEG, sc)
    return sc.reshape(B, num_beams * V)


class BeamState(NamedTuple):
    scores: torch.Tensor       # [B, nb] cumulative log-probs of the live beams
    # hypothesis bank: the best finished sequences per batch row
    fin_scores: torch.Tensor   # [B, nb]
    fin_seqs: torch.Tensor     # [B, nb, max_len] int32
    fin_lens: torch.Tensor     # [B, nb] int32


def init_beam_state(batch: int, num_beams: int, max_len: int, device="cpu") -> BeamState:
    scores = torch.full((batch, num_beams), NEG_INF, device=device)
    scores[:, 0] = 0.0
    return BeamState(scores=scores,
                     fin_scores=torch.full((batch, num_beams), BANK_EMPTY, device=device),
                     fin_seqs=torch.zeros(batch, num_beams, max_len, dtype=torch.int32,
                                          device=device),
                     fin_lens=torch.zeros(batch, num_beams, dtype=torch.int32, device=device))


def _per_batch(v, B: int, dtype, device) -> torch.Tensor:
    """A scalar or [B] value as a [B] tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(B)


def length_denom(generated_len: torch.Tensor, length_penalty: Scalar) -> torch.Tensor:
    """HF's hypothesis-score denominator generated_len ** length_penalty;
    exactly 1 when length_penalty is 0 (generated_len >= 1 always)."""
    lp = torch.as_tensor(length_penalty, dtype=torch.float32, device=generated_len.device)
    gl = generated_len.clamp_min(1).float()
    return torch.where(lp == 0.0, torch.ones_like(gl), torch.pow(gl, lp))


def beam_step(flat: torch.Tensor, num_beams: int, state: BeamState, seqs: torch.Tensor,
              step, stop_token: int, do_sample: bool, length_penalty: Scalar = 0.0,
              done: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None
              ) -> Tuple[BeamState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam(-sample) step over the candidate totals of `flat_scores`.

    Returns (state', beam_parent [B, nb], next_token [B, nb], seqs'
    [B, nb, max_len], best_cand [B]).  best_cand is the step's largest
    candidate total over all 2*nb candidates, stop candidates included (HF's
    `next_scores.max()`, which its done test reads).  Candidates ending in
    `stop_token` at rank < nb are banked with the score
    sum_logprobs / (step + 1) ** length_penalty; the nb best non-stop
    candidates continue on raw cumulative scores.  `done` [B] rows are
    frozen: their bank, scores and sequences keep their values and their
    parents are the identity.

    `step` and `length_penalty` are scalars or per-batch [B].  When
    sampling, the 2*nb candidates are the top of flat + Gumbel noise:
    `gumbel` [B, nb*V] if given, else drawn from `generator`."""
    B = flat.shape[0]
    nb = num_beams
    V = flat.shape[1] // nb
    cand = 2 * nb
    dev = flat.device
    if done is None:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    step = _per_batch(step, B, torch.int32, dev)
    lp_col = _per_batch(length_penalty, B, torch.float32, dev)

    if do_sample:
        if gumbel is None:
            gumbel = sampling.gumbel_noise(flat.shape, generator, dev)
        _, idx = _top_k(flat + gumbel.to(dev), cand)
        sc = torch.gather(flat, 1, idx)
        sc, order = torch.sort(sc, dim=1, descending=True, stable=True)
        idx = torch.gather(idx, 1, order)
    else:
        sc, idx = _top_k(flat, cand)

    parent = idx // V                                           # [B, cand]
    token = (idx % V).to(torch.int32)
    is_stop = token == stop_token

    # bank finished candidates: parent's prefix + the stop token; keep the
    # nb best of the old bank and the new ones
    L = seqs.shape[2]
    cand_seqs = torch.gather(seqs, 1, parent[:, :, None].expand(B, cand, L))
    at = step.clamp(max=L - 1).long()[:, None, None].expand(B, cand, 1)
    written = cand_seqs.scatter(2, at, token[:, :, None])
    cand_seqs = torch.where((step < L)[:, None, None], written, cand_seqs)
    # HF drops (does not bank) stop candidates ranked >= num_beams
    bankable = is_stop & (torch.arange(cand, device=dev) < nb)[None, :] & ~done[:, None]
    fin_cand = torch.where(
        bankable,
        torch.clamp_min(sc / length_denom(step + 1, lp_col)[:, None],
                        torch.finfo(torch.float32).min),
        BANK_EMPTY)
    all_scores = torch.cat([state.fin_scores, fin_cand], dim=1)
    all_seqs = torch.cat([state.fin_seqs, cand_seqs], dim=1)
    all_lens = torch.cat([state.fin_lens, (step + 1)[:, None].expand(B, cand)], dim=1)
    top_sc, top_ix = _top_k(all_scores, nb)
    fin_seqs = torch.gather(all_seqs, 1, top_ix[:, :, None].expand(B, nb, L))
    fin_lens = torch.gather(all_lens, 1, top_ix)

    # the nb continuing (non-stop) candidates
    cont = torch.where(is_stop, NEG_INF, sc)
    new_scores, keep = _top_k(cont, nb)
    new_parent = torch.gather(parent, 1, keep)
    new_token = torch.gather(token, 1, keep)
    new_seqs = torch.gather(cand_seqs, 1, keep[:, :, None].expand(B, nb, L))

    d1 = done[:, None]
    state = BeamState(torch.where(d1, state.scores, new_scores),
                      torch.where(d1, state.fin_scores, top_sc),
                      torch.where(d1[:, :, None], state.fin_seqs, fin_seqs),
                      torch.where(d1, state.fin_lens, fin_lens))
    new_parent = torch.where(d1, torch.arange(nb, device=dev)[None, :], new_parent)
    new_seqs = torch.where(d1[:, :, None], seqs, new_seqs)
    return state, new_parent, new_token, new_seqs, sc[:, 0]


def batch_done(state: BeamState, step, best_cand: torch.Tensor,
               length_penalty: Scalar = 0.0) -> torch.Tensor:
    """HF early_stopping=False done test (BeamHypotheses.is_done): the bank
    is full and its worst score beats this step's best candidate's
    attainable score best_cand / (step + 1) ** length_penalty.  Call after
    the step's banking, then latch with `|`."""
    B = best_cand.shape[0]
    step = _per_batch(step, B, torch.int32, best_cand.device)
    worst = state.fin_scores[:, -1]
    attainable = best_cand / length_denom(step + 1, length_penalty)
    return torch.isfinite(worst) & (worst >= attainable)


def finalize(state: BeamState, seqs: torch.Tensor, step, length_penalty: Scalar = 0.0,
             done: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best hypothesis per batch row (HF BeamSearchScorer.finalize): rows not
    done let their running beams compete with the bank, at length-penalised
    scores; done rows take the bank alone.  Returns (sequences [B, max_len],
    lengths [B], from_bank [B]: whether the winner carries a stop token)."""
    B, nb, L = seqs.shape
    dev = seqs.device
    if done is None:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    step = _per_batch(step, B, torch.int32, dev)
    lp_col = _per_batch(length_penalty, B, torch.float32, dev)
    run_pen = torch.clamp_min(state.scores / length_denom(step, lp_col)[:, None],
                              torch.finfo(torch.float32).min)
    run_pen = torch.where(done[:, None], BANK_EMPTY, run_pen)
    all_scores = torch.cat([state.fin_scores, run_pen], dim=1)
    best_ix = torch.argmax(all_scores, dim=1)          # the first of equal maxima
    from_bank = best_ix < nb
    bank_ix = best_ix.clamp(0, nb - 1)
    run_ix = (best_ix - nb).clamp(0, nb - 1)
    rows = torch.arange(B, device=dev)
    out_seq = torch.where(from_bank[:, None], state.fin_seqs[rows, bank_ix], seqs[rows, run_ix])
    out_len = torch.where(from_bank, state.fin_lens[rows, bank_ix], step)
    return out_seq, out_len, from_bank
