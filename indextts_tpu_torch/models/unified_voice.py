"""UnifiedVoice: the autoregressive text + mel-code acoustic model
(counterpart of indextts_tpu/models/unified_voice.py).

A GPT-2 trunk with learned per-stream position embeddings, a conformer ->
perceiver conditioning encoder producing 32 latents, and a mel head.  The
single-row unguided decode runs the trunk through ops/cuda/decode_layer.py
(K2); batched and guided rows step through gpt2.decode_step, and
beam decode under reorder="pallas" reorders its cache through
ops/cuda/permute.py (K3): the hand-written kernels for CUDA tensors, their
plain versions on the CPU.  Trunk and head matrices may be quantized
(ops/quantization.py).

Under tensor parallelism (`group`, parallel/mesh.TPGroup) the decodes and
the re-forward run one rank's shard of the trunk (parallel/tp.py); the
embeddings, `final_norm` and the heads are whole on every rank.  What
steers a decode is rank 0's on every rank: the sampled tokens (and from
them the stop flags), and a beam step's outcome (scores, bank, parents,
tokens, sequences, done flags), each copied in one small collective a step;
every call ends by checking that each rank's codes are rank 0's.  K2 is a
one-card kernel and is not used under a group.

Reference quirk kept on purpose: the n-th generated mel token sits at mel
position n+1 (HF's position bookkeeping, gpt/model.py:164-167); checkpoints
are trained against this numbering.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import CONFORMER_CONDITION_TYPES, GPTConfig
from indextts_tpu_torch.models import conformer, gpt2, perceiver
from indextts_tpu_torch.models import legacy_conditioning as legacy
from indextts_tpu_torch.models.gpt2 import GPT2Size, layer_norm
from indextts_tpu_torch.ops import beam as beam_lib
from indextts_tpu_torch.ops import quantization, sampling
from indextts_tpu_torch.ops.cuda.decode_layer import flatten_cache, fused_decode_trunk_flat
from indextts_tpu_torch.ops.cuda.permute import (as_bits, permute_cache_rows,
                                                  permute_cache_rows_plain)


def trunk_size(cfg: GPTConfig) -> GPT2Size:
    return GPT2Size(layers=cfg.layers, dim=cfg.model_dim, heads=cfg.heads)


def conformer_size(cfg: GPTConfig) -> conformer.ConformerSize:
    cm = cfg.condition_module
    return conformer.ConformerSize(input_size=100, output_size=cm.output_size,
                                   attention_heads=cm.attention_heads,
                                   linear_units=cm.linear_units, num_blocks=cm.num_blocks)


def perceiver_size(cfg: GPTConfig) -> perceiver.PerceiverSize:
    cm = cfg.condition_module
    return perceiver.PerceiverSize(dim=cfg.model_dim, dim_context=cm.output_size,
                                   heads=cm.attention_heads, ff_mult=cm.perceiver_mult,
                                   num_latents=cfg.condition_num_latent)


def legacy_perceiver_size(cfg: GPTConfig) -> perceiver.PerceiverSize:
    """The condition_type="perceiver" resampler: context width D, ff_mult 4,
    8 heads (gpt/model.py:221-245)."""
    return dataclasses.replace(perceiver_size(cfg), dim_context=cfg.model_dim, ff_mult=4,
                               heads=8)


def init_conditioning_params(cfg: GPTConfig, generator, dtype=torch.float32, device="cpu"):
    """(conditioning_encoder, perceiver_encoder) for the config's
    condition_type: the conformer and perceiver for both conformer types,
    the legacy encoder and a perceiver over D for "perceiver", and the
    legacy encoder alone (an empty perceiver) for the mean-pooled rest."""
    if cfg.condition_type in CONFORMER_CONDITION_TYPES:
        return (conformer.init_params(conformer_size(cfg), generator, dtype, device),
                perceiver.init_params(perceiver_size(cfg), generator, dtype, device))
    cond = legacy.init_conditioning_encoder(100, cfg.model_dim, generator, 6, dtype, device)
    if cfg.condition_type == "perceiver":
        return cond, perceiver.init_params(legacy_perceiver_size(cfg), generator, dtype, device)
    return cond, {}


def init_params(cfg: GPTConfig, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    D = cfg.model_dim
    n_text = cfg.number_text_tokens * cfg.types + 1

    def nrm(shape, std=0.02):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    cond, perc = init_conditioning_params(cfg, generator, dtype, device)
    return {
        "conditioning_encoder": cond,
        "perceiver_encoder": perc,
        "text_embedding": {"weight": nrm((n_text, D))},
        "mel_embedding": {"weight": nrm((cfg.number_mel_codes, D))},
        "mel_pos_embedding": {"weight": nrm((cfg.max_mel_seq_len, D))},
        "text_pos_embedding": {"weight": nrm((cfg.max_text_seq_len, D))},
        "gpt": gpt2.init_gpt2_params(trunk_size(cfg), generator, dtype, device),
        "final_norm": {"scale": torch.ones(D, dtype=dtype, device=device), "bias": zeros(D)},
        "text_head": {"kernel": nrm((D, n_text)), "bias": zeros(n_text)},
        "mel_head": {"kernel": nrm((D, cfg.number_mel_codes)),
                     "bias": zeros(cfg.number_mel_codes)},
    }


def get_conditioning(params: Dict[str, Any], cfg: GPTConfig, cond_mel: torch.Tensor,
                     cond_mel_lengths: torch.Tensor) -> torch.Tensor:
    """cond_mel [B, n_mels, T] -> conditioning latents (reference
    gpt/model.py:487-546), in the parameters' type: [B, 32, D] for the
    conformer and perceiver types, [B, 1, D] for the mean-pooled default.
    The legacy encoders see every frame, as in JAX (no length mask)."""
    B = cond_mel.shape[0]
    enc_params = params["conditioning_encoder"]
    wdtype = (enc_params["init"]["w"] if "init" in enc_params
              else enc_params["embed"]["conv"]["w"]).dtype
    cond_mel = cond_mel.to(wdtype)
    if cfg.condition_type in CONFORMER_CONDITION_TYPES:
        enc, valid = conformer.forward(params["conditioning_encoder"], cond_mel.transpose(1, 2),
                                       cond_mel_lengths, conformer_size(cfg))
        # queries prepended to the context mask (gpt/model.py:346,528)
        mask = torch.cat([torch.ones(B, cfg.condition_num_latent, dtype=torch.bool,
                                     device=valid.device), valid], dim=1)
        return perceiver.forward(params["perceiver_encoder"], enc, mask, perceiver_size(cfg))
    if cfg.condition_type == "perceiver":
        enc = legacy.conditioning_encoder(params["conditioning_encoder"], cond_mel, cfg.heads)
        return perceiver.forward(params["perceiver_encoder"], enc.transpose(1, 2), None,
                                 legacy_perceiver_size(cfg))
    # mean-pooled default (gpt/model.py:534-545)
    pooled = legacy.conditioning_encoder(params["conditioning_encoder"], cond_mel, cfg.heads,
                                         mean=True)
    return pooled[:, None, :]


# the heads take every weight form the trunk does
_head_mm = quantization.matmul_quant


def _lm_head(params, hidden):
    """final_norm + mel head (reference lm_head, gpt/model.py:56)."""
    h = layer_norm(hidden, params["final_norm"]["scale"], params["final_norm"]["bias"])
    return _head_mm(h, params["mel_head"]["kernel"]) + params["mel_head"]["bias"]


def build_io_tokens(ids: torch.Tensor, lengths: torch.Tensor, start: int,
                    stop: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T] right-padded ids -> ([B, T+2] inputs [start, ids[:L], stop, 0...],
    [B, T+1] targets = inputs[:, 1:], [B, T+1] mask over the first L+1
    targets) (train.py:233-255,302-312)."""
    B, T = ids.shape
    pos = torch.arange(T + 2, device=ids.device)[None]
    L = lengths[:, None]
    shifted = torch.nn.functional.pad(ids, (1, 1))   # ids at positions 1..T
    inputs = torch.where(pos == 0, start,
                         torch.where(pos <= L, shifted, torch.where(pos == L + 1, stop, 0)))
    tmask = torch.arange(T + 1, device=ids.device)[None] < (L + 1)
    return inputs, inputs[:, 1:], tmask


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the masked positions, log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1)


def train_forward(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                  text_ids: torch.Tensor, text_lengths: torch.Tensor,
                  mel_codes: torch.Tensor, codes_lengths: torch.Tensor,
                  remat: bool = False) -> Dict[str, torch.Tensor]:
    """Teacher-forced dual-CE forward (train.py:168-346).  cond_latent
    [B, 32, D]; ids right-padded with their lengths.  Returns loss_text,
    loss_mel and the logits, targets and masks of both streams."""
    size = trunk_size(cfg)
    B = text_ids.shape[0]
    dev = text_ids.device
    cond_len = cond_latent.shape[1]
    text_in, text_tgt, text_mask = build_io_tokens(
        text_ids, text_lengths, cfg.start_text_token, cfg.stop_text_token)
    mel_in, mel_tgt, mel_mask = build_io_tokens(
        mel_codes, codes_lengths, cfg.start_mel_token, cfg.stop_mel_token)
    Tt2, Tm2 = text_in.shape[1], mel_in.shape[1]
    if Tt2 > cfg.max_text_seq_len or Tm2 > cfg.max_mel_seq_len:
        raise ValueError(f"text width {Tt2 - 2} / mel width {Tm2 - 2} exceed "
                         f"max_text_tokens {cfg.max_text_tokens} / max_mel_tokens "
                         f"{cfg.max_mel_tokens}")
    text_emb = (params["text_embedding"]["weight"][text_in]
                + params["text_pos_embedding"]["weight"][:Tt2][None])
    mel_emb = (params["mel_embedding"]["weight"][mel_in]
               + params["mel_pos_embedding"]["weight"][:Tm2][None])
    emb = torch.cat([cond_latent.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    attn = torch.cat([
        torch.ones(B, cond_len, dtype=torch.int32, device=dev),
        (torch.arange(Tt2, device=dev)[None] < (text_lengths[:, None] + 2)).int(),
        (torch.arange(Tm2, device=dev)[None] < (codes_lengths[:, None] + 2)).int(),
    ], dim=1)
    hidden = gpt2.forward(params["gpt"], emb, attn, size, remat=remat)
    latent = layer_norm(hidden[:, cond_len:], params["final_norm"]["scale"],
                        params["final_norm"]["bias"])
    # each stream drops its final position (train.py:297-298)
    text_logits = (_head_mm(latent[:, :Tt2], params["text_head"]["kernel"])
                   + params["text_head"]["bias"])[:, :-1]
    mel_logits = (_head_mm(latent[:, Tt2:], params["mel_head"]["kernel"])
                  + params["mel_head"]["bias"])[:, :-1]
    return {
        "loss_text": _masked_ce(text_logits, text_tgt, text_mask),
        "loss_mel": _masked_ce(mel_logits, mel_tgt, mel_mask),
        "mel_logits": mel_logits, "mel_targets": mel_tgt, "mel_mask": mel_mask,
        "text_logits": text_logits, "text_targets": text_tgt, "text_mask": text_mask,
    }


def top_k_accuracy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                   ks=(1, 10, 20)) -> Dict[str, torch.Tensor]:
    """Masked top-k accuracy in percent (train.py:348-371).  The shortlist
    takes `jax.lax.top_k`'s order among equal logits (the lower index
    first), which bf16 logits have often."""
    _, top = sampling._top_k(logits.float(), max(ks))
    hit = top == targets[..., None]
    denom = mask.sum().clamp(min=1)
    return {f"acc_{k}": (hit[..., :k].any(dim=-1) & mask).sum() / denom * 100.0 for k in ks}


def latent_forward(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                   text_ids: torch.Tensor, text_lengths: torch.Tensor,
                   mel_codes: torch.Tensor, codes_lengths: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Teacher-forced re-forward giving per-code latents [B, Lc, D] for the
    vocoder (infer.py:864-875).  Positions past codes_lengths carry stop-token
    latents (set_mel_padding, gpt/model.py:439-447)."""
    size = trunk_size(cfg)
    B, Lt = text_ids.shape
    Lc = mel_codes.shape[1]
    dev = text_ids.device
    cond_len = cond_latent.shape[1]
    tpos = torch.arange(Lt, device=dev)[None]
    text_ids = torch.where(tpos < text_lengths[:, None], text_ids, cfg.stop_text_token)
    mpos = torch.arange(Lc, device=dev)[None]
    mel_codes = torch.where(mpos < codes_lengths[:, None], mel_codes, cfg.stop_mel_token)

    def wrap(ids, start, stop):  # start + ids + stop (gpt/model.py:576-588)
        col = lambda v: torch.full((B, 1), v, dtype=ids.dtype, device=dev)  # noqa: E731
        return torch.cat([col(start), ids, col(stop)], dim=1)

    text_in = wrap(text_ids, cfg.start_text_token, cfg.stop_text_token)
    mel_in = wrap(mel_codes, cfg.start_mel_token, cfg.stop_mel_token)
    text_emb = (params["text_embedding"]["weight"][text_in]
                + params["text_pos_embedding"]["weight"][: Lt + 2][None])
    mel_emb = (params["mel_embedding"]["weight"][mel_in]
               + params["mel_pos_embedding"]["weight"][: Lc + 2][None])
    emb = torch.cat([cond_latent.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    # the padded tails are masked, so right-padded buckets equal exact-length runs
    attn = torch.cat([
        torch.ones(B, cond_len, dtype=torch.int32, device=dev),
        (torch.arange(Lt + 2, device=dev)[None] < (text_lengths[:, None] + 2)).int(),
        (torch.arange(Lc + 2, device=dev)[None] < (codes_lengths[:, None] + 2)).int(),
    ], dim=1)
    hidden = gpt2.forward(params["gpt"], emb, attn, size, group=group)
    latent = layer_norm(hidden[:, cond_len:], params["final_norm"]["scale"],
                        params["final_norm"]["bias"])
    return latent[:, Lt + 2:][:, :-2]  # (gpt/model.py:591-593)


class PreparedPrompt(NamedTuple):
    text_tokens: np.ndarray    # [B, L+2] left-padded, start/stop added
    attn_text: np.ndarray      # [B, L+2] 1 = valid


def prepare_text_prompt(text_ids_list, start_token: int, stop_token: int) -> PreparedPrompt:
    """Host-side prepare_gpt_inputs (gpt/model.py:606-667): strip start/stop
    tokens, re-add them, left-pad to a common length."""
    cleaned = []
    for ids in text_ids_list:
        ids = np.asarray(ids).reshape(-1)
        ids = ids[(ids != start_token) & (ids != stop_token)]
        cleaned.append(np.concatenate([[start_token], ids, [stop_token]]))
    L = max(len(c) for c in cleaned)
    B = len(cleaned)
    tokens = np.zeros((B, L), dtype=np.int32)
    mask = np.zeros((B, L), dtype=np.int32)
    for i, c in enumerate(cleaned):
        tokens[i, L - len(c):] = c
        mask[i, L - len(c):] = 1
    return PreparedPrompt(tokens, mask)


def _sample_agreed(logits, presence, finished, group, **samp):
    """`sampling.sample_step`, with rank 0's tokens on every rank of `group`:
    each rank draws (so the generators stay in step), rank 0's draw is
    copied, and the presence and stop flags follow the copied tokens."""
    if group is None:
        return sampling.sample_step(logits, presence, finished, **samp)
    own, _, _ = sampling.sample_step(logits, presence.clone(), finished, **samp)
    tok = group.agree(own)
    presence[torch.arange(tok.shape[0], device=tok.device), tok.long()] = True
    return tok, presence, finished | (tok == samp["stop_token"])


class DecodeResult(NamedTuple):
    codes: torch.Tensor     # [B, max_new] generated mel codes, stop-padded
    lengths: torch.Tensor   # [B] generated length excluding the stop token
    finished: torch.Tensor  # [B] whether stop was emitted
    steps: int              # trunk decode steps run after the prefill


def _prefill_inputs(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                    text_tokens: torch.Tensor, text_mask: torch.Tensor):
    """Prefill embeddings [B, P, D] of [cond | text | start_mel] and their
    mask [B, P]; text positions count from each row's first valid slot."""
    B = text_tokens.shape[0]
    dev = cond_latent.device
    if cond_latent.shape[0] == 1 and B > 1:
        cond_latent = cond_latent.expand(B, -1, -1)
    tpos = (torch.cumsum(text_mask, dim=1) - 1).clamp(0, cfg.max_text_seq_len - 1)
    text_emb = (params["text_embedding"]["weight"][text_tokens]
                + params["text_pos_embedding"]["weight"][tpos])
    text_emb = text_emb * text_mask[..., None].to(text_emb.dtype)
    start_emb = (params["mel_embedding"]["weight"][cfg.start_mel_token]
                 + params["mel_pos_embedding"]["weight"][0])
    emb = torch.cat([cond_latent.to(text_emb.dtype), text_emb,
                     start_emb.expand(B, 1, cfg.model_dim)], dim=1)
    mask = torch.cat([torch.ones(B, cond_latent.shape[1], dtype=torch.int32, device=dev),
                      text_mask.to(torch.int32),
                      torch.ones(B, 1, dtype=torch.int32, device=dev)], dim=1)
    return emb, mask


def inference_speech(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                     text_tokens: torch.Tensor, text_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None, max_new: int = 600,
                     temperature: float = 1.0, top_k: int = 30, top_p: float = 0.8,
                     repetition_penalty: float = 10.0, do_sample: bool = True,
                     typical_sampling: bool = False, typical_mass: float = 0.9,
                     cache_dtype=None, use_fused_trunk: bool = True, kv_dtype=None,
                     cfg_scale: float = 1.0, group=None) -> DecodeResult:
    """Autoregressive mel-code generation (replaces HF generate,
    gpt/model.py:669-720): prefill of [cond | text | start_mel], then one
    trunk step per token until every row stopped or `max_new` codes exist.
    text_tokens/text_mask [B, L+2] from prepare_text_prompt, left-padded;
    cond_latent [1 or B, 32, D].

    cfg_scale != 1: classifier-free guidance.  Rows [B, 2B) decode the same
    text with zeroed conditioning latents (the trained null), each step
    samples from `uncond + cfg_scale * (cond - uncond)`, and both halves
    take the sampled token.

    use_fused_trunk: when the trunk has one physical row (B = 1, unguided),
    each step runs the decode-trunk kernel (K2) over a flat cache, which
    takes plain, int8 and fused-int4 weights.  Otherwise, as in the JAX
    package, each step is gpt2.decode_step over the 5-D cache (any weight
    form, the shared int4 layout included).  kv_dtype: the cache's storage
    type (default cache_dtype), e.g. torch.float8_e4m3fn.  group: this
    rank's tensor-parallel group, `params` its shard (no K2)."""
    params = quantization.nativize_int4(params)
    size = trunk_size(cfg)
    dev = cond_latent.device
    cache_dtype = cache_dtype or params["gpt"]["ln_f"]["scale"].dtype
    B = text_tokens.shape[0]
    if cond_latent.shape[0] == 1 and B > 1:
        cond_latent = cond_latent.expand(B, -1, -1)
    guided = float(cfg_scale) != 1.0
    R = 2 * B if guided else B                 # physical trunk rows
    if guided:
        cond_latent = torch.cat([cond_latent, torch.zeros_like(cond_latent)])
        text_tokens = text_tokens.repeat(2, 1)
        text_mask = text_mask.repeat(2, 1)

    def mix(logits):
        """[R, V] per-row logits -> [B, V] guided logits."""
        if not guided:
            return logits
        lc, lu = logits[:B], logits[B:]
        # the difference in the head's type, the mix in fp32, as in JAX
        # (cfg_scale there is an fp32 scalar)
        return lu.float() + float(cfg_scale) * (lc - lu).float()

    prefill_emb, prefill_mask = _prefill_inputs(params, cfg, cond_latent, text_tokens,
                                                text_mask)
    P = prefill_emb.shape[1]
    cache_len = -(-(P + max_new) // 8) * 8
    hidden, cache = gpt2.prefill(params["gpt"], prefill_emb.to(cache_dtype), prefill_mask,
                                 size, cache_len, kv_dtype=kv_dtype, group=group)
    logits = mix(_lm_head(params, hidden[:, -1]))

    full_mask = torch.zeros(R, cache_len, dtype=torch.int32, device=dev)
    full_mask[:, :P] = prefill_mask
    presence = sampling.init_penalty_presence(cfg.number_mel_codes, B, prompt_token_ids=(1,),
                                              start_token=cfg.start_mel_token, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    samp = dict(stop_token=cfg.stop_mel_token, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty, do_sample=do_sample,
                typical_sampling=typical_sampling, typical_mass=typical_mass,
                generator=generator)
    tok, presence, finished = _sample_agreed(logits, presence, finished, group, **samp)
    codes = torch.full((B, max_new), cfg.stop_mel_token, dtype=torch.int32, device=dev)
    codes[:, 0] = tok

    fused = use_fused_trunk and R == 1 and group is None
    if fused:
        k_flat, v_flat = flatten_cache(cache)
        del cache
    ln_f = params["gpt"]["ln_f"]
    step = 1
    while step < max_new and not bool(finished.all()):
        # token generated at step-1 sits at mel position step+1
        mel_pos = min(step + 1, cfg.max_mel_seq_len - 1)
        rows = tok.repeat(2) if guided else tok   # both halves follow one sequence
        emb = (params["mel_embedding"]["weight"][rows.long()]
               + params["mel_pos_embedding"]["weight"][mel_pos])[:, None, :]
        slot = P + step - 1
        full_mask[:, slot] = 1
        if fused:
            pre, k_flat, v_flat = fused_decode_trunk_flat(
                params["gpt"], emb.to(cache_dtype), k_flat, v_flat, slot, full_mask,
                cfg.heads)
            hidden = layer_norm(pre, ln_f["scale"], ln_f["bias"])
        else:
            hidden, cache = gpt2.decode_step(params["gpt"], emb.to(cache_dtype), cache, slot,
                                             full_mask, size, group=group)
        logits = mix(_lm_head(params, hidden[:, 0]))
        tok, presence, finished = _sample_agreed(logits, presence, finished, group, **samp)
        codes[:, step] = tok
        step += 1
    if group is not None:
        group.check_same(codes, "inference_speech codes")

    is_stop = codes == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop, max_new)
    return DecodeResult(codes, lengths, finished, step - 1)


# beam decode (reference default: generate(num_beams=3, do_sample=True),
# infer.py:628-635, HF beam_sample)
REORDERS = ("lineage", "dslice", "pallas", "always", "onehot", "full", "none")


def _reorder_suffix(reorder: str, suffix: gpt2.KVCache, rows: torch.Tensor,
                    spare: Optional[gpt2.KVCache]) -> Tuple[gpt2.KVCache, Optional[gpt2.KVCache]]:
    """The suffix cache with its rows taken from `rows` (absolute [B*nb]),
    under a physical reorder strategy.  Returns (suffix', spare')."""
    if reorder == "dslice":        # one single-row slice per row, concatenated
        def pick(x):
            b = as_bits(x)
            return torch.cat([b.index_select(1, rows[n:n + 1]) for n in range(rows.shape[0])],
                             dim=1).view(x.dtype)
        return gpt2.KVCache(pick(suffix.k), pick(suffix.v)), spare
    if reorder == "pallas":        # K3, out of place into the spare pair, then swap
        k2, v2 = permute_cache_rows(suffix.k, suffix.v, rows, spare.k, spare.v)
        return gpt2.KVCache(k2, v2), suffix
    if reorder in ("always", "full"):  # plain row gathers
        return gpt2.KVCache(*permute_cache_rows_plain(suffix.k, suffix.v, rows)), spare
    if reorder == "onehot":        # the permutation as a matmul over rows
        W = torch.nn.functional.one_hot(rows, rows.shape[0]).float()
        perm = lambda x: torch.einsum("nb,lbhtd->lnhtd", W, x.float()).to(x.dtype)  # noqa: E731
        return gpt2.KVCache(perm(suffix.k), perm(suffix.v)), spare
    raise ValueError(f"unknown reorder strategy: {reorder!r}")


def inference_speech_beam(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                          text_tokens: torch.Tensor, text_mask: torch.Tensor,
                          generator: Optional[torch.Generator] = None, max_new: int = 600,
                          num_beams: int = 3, temperature: float = 1.0, top_k: int = 30,
                          top_p: float = 0.8, repetition_penalty: float = 10.0,
                          do_sample: bool = True, typical_sampling: bool = False,
                          typical_mass: float = 0.9, cache_dtype=None,
                          reorder: str = "lineage", kv_dtype=None,
                          length_penalty: float = 0.0, gumbel=None,
                          group=None) -> DecodeResult:
    """Beam(-sample) mel-code generation with HF 4.44 semantics (ops/beam.py
    flat_scores): log_softmax -> processors -> + beam scores -> per-beam
    warpers -> draw 2*nb candidates -> bank the finished, continue the best
    nb.  Any B >= 1 rows of left-padded text, nb >= 1 beams each.

    Split KV cache: the prompt prefix [cond | text | start] is the same for a
    row's nb beams, so it is prefilled once per row ([L, B, H, Pc, hd],
    Pc = P rounded up to 64); only the generated suffix lives per beam
    ([L, B*nb, H, Sc, hd], Sc = max_new rounded up to 64), and each step is
    gpt2.decode_step_lineage.  `reorder` picks how a step follows the beam
    parents, under the JAX package's names:
      lineage  no physical reorder: an ancestry map anc[b, i, s] (the suffix
               row owning slot s in beam i's lineage) masks attention over
               all rows' suffixes (the default);
      pallas   the hand-written row-permute kernel (K3, ops/cuda/permute.py)
               into a second pair of suffix buffers, swapped each step;
      always, full   plain index_select row gathers;
      dslice   one single-row slice per row, concatenated;
      onehot   the permutation as a one-hot matmul over rows;
      none     no reorder at all: a diagnostic, wrong results.
    The physical strategies attend with an identity owner map.

    generator: the sampling noise's source.  gumbel: indexable by step, each
    entry [B, nb*V], replacing the noise of that step (the tests feed the
    JAX package's draws).  group: this rank's tensor-parallel group,
    `params` its shard; each rank's caches hold its heads, and K3 reorders
    them under "pallas".  Returns codes, lengths and whether the winning
    hypothesis stopped; `steps` counts the trunk steps after the prefill."""
    if reorder not in REORDERS:
        raise ValueError(f"unknown reorder strategy: {reorder!r}")
    params = quantization.nativize_int4(params)
    size = trunk_size(cfg)
    B = text_tokens.shape[0]
    nb = num_beams
    V = cfg.number_mel_codes
    dev = cond_latent.device
    cache_dtype = cache_dtype or params["gpt"]["ln_f"]["scale"].dtype
    store = kv_dtype or cache_dtype

    prefill_emb, prefill_mask = _prefill_inputs(params, cfg, cond_latent, text_tokens,
                                                text_mask)
    P = prefill_emb.shape[1]
    # 64-aligned as in the JAX package; slots past P and step are never unmasked
    prefix_len = -(-P // 64) * 64
    suffix_len = -(-max_new // 64) * 64
    # the prefill runs on B rows, not B*nb: the beams share it
    hidden, prefix = gpt2.prefill(params["gpt"], prefill_emb.to(cache_dtype), prefill_mask,
                                  size, prefix_len, kv_dtype=kv_dtype, group=group)
    logits0 = _lm_head(params, hidden[:, -1]).repeat_interleave(nb, dim=0)   # [B*nb, V]

    pmask = torch.zeros(B, prefix_len, dtype=torch.bool, device=dev)
    pmask[:, :P] = prefill_mask.bool()
    prefix_bias = torch.where(pmask, 0.0, gpt2.NEG_INF).float()[:, None, None, :]
    rank_size = gpt2.local_size(size, group)
    suffix = gpt2.KVCache.zeros(rank_size, B * nb, suffix_len, store, dev)
    spare = (gpt2.KVCache.zeros(rank_size, B * nb, suffix_len, store, dev)
             if reorder == "pallas" else None)
    presence = sampling.init_penalty_presence(V, B * nb, prompt_token_ids=(1,),
                                              start_token=cfg.start_mel_token, device=dev)
    state = beam_lib.init_beam_state(B, nb, max_new, dev)
    seqs = torch.zeros(B, nb, max_new, dtype=torch.int32, device=dev)
    beam_ids = torch.arange(nb, dtype=torch.int32, device=dev)
    anc = torch.zeros(B, nb, suffix_len, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    batch_rows = torch.arange(B, device=dev)[:, None] * nb

    def select(logits, step, has_cache):
        nonlocal state, seqs, presence, suffix, spare, anc, done
        flat = beam_lib.flat_scores(logits, presence, state.scores, nb,
                                    temperature=temperature, top_k=top_k, top_p=top_p,
                                    repetition_penalty=repetition_penalty,
                                    typical_sampling=typical_sampling,
                                    typical_mass=typical_mass, do_sample=do_sample)
        state, parent, token, seqs, best_cand = beam_lib.beam_step(
            flat, nb, state, seqs, step, cfg.stop_mel_token, do_sample,
            length_penalty=length_penalty, done=done, generator=generator,
            gumbel=None if gumbel is None else gumbel[step])
        # latch HF's _done after the step's banking (beam_search.py:300-306)
        done = done | beam_lib.batch_done(state, step, best_cand, length_penalty)
        if group is not None:               # rank 0's step on every rank
            state, parent, token, seqs, done = group.agree((state, parent, token, seqs, done))
        rows = (batch_rows + parent).reshape(-1)                  # absolute [B*nb]
        if reorder == "lineage":
            if has_cache:
                anc = torch.gather(anc, 1, parent[:, :, None].expand(B, nb, suffix_len))
        elif reorder != "none" and has_cache:   # the first select has no suffix yet
            suffix, spare = _reorder_suffix(reorder, suffix, rows, spare)
        tok = token.reshape(-1)
        presence = presence[rows]
        presence[torch.arange(B * nb, device=dev), tok.long()] = True
        return tok

    tok = select(logits0, 0, has_cache=False)
    step = 1
    valid_slots = torch.arange(suffix_len, device=dev)
    while step < max_new and not bool(done.all()):
        mel_pos = min(step + 1, cfg.max_mel_seq_len - 1)
        emb = (params["mel_embedding"]["weight"][tok.long()]
               + params["mel_pos_embedding"]["weight"][mel_pos])[:, None, :]
        if reorder == "lineage":
            anc[:, :, step - 1] = beam_ids          # each row owns the slot it writes
            owner = anc
        else:                                       # each beam's history is in its row
            owner = beam_ids[None, :, None].expand(B, nb, suffix_len)
        owns = owner[:, :, None, :] == beam_ids[None, None, :, None]
        suffix_bias = torch.where(owns & (valid_slots < step), 0.0, gpt2.NEG_INF).float()
        hidden, suffix = gpt2.decode_step_lineage(
            params["gpt"], emb.to(cache_dtype), prefix, prefix_bias, suffix, suffix_bias,
            step, size, nb, group=group)
        logits = _lm_head(params, hidden[:, 0])
        tok = select(logits, step, has_cache=True)
        step += 1

    best_seq, best_len, finished = beam_lib.finalize(state, seqs, step,
                                                     length_penalty=length_penalty, done=done)
    # banked sequences carry the stop at position len-1; running beams carry
    # `step` valid tokens and no stop
    lengths = torch.where(finished, best_len - 1, best_len).clamp(0, max_new)
    codes = torch.where(torch.arange(max_new, device=dev)[None, :] < lengths[:, None],
                        best_seq, cfg.stop_mel_token)
    if group is not None:
        group.check_same(codes, "inference_speech_beam codes")
    return DecodeResult(codes, lengths, finished, step - 1)
