"""UnifiedVoice: the autoregressive text + mel-code acoustic model
(counterpart of indextts_tpu/models/unified_voice.py).

A GPT-2 trunk with learned per-stream position embeddings, a conformer ->
perceiver conditioning encoder producing 32 latents, and a mel head.  The
single-row decode runs the trunk through ops/cuda/decode_layer.py: the
hand-written kernels for CUDA tensors, their plain version on the CPU.

Reference quirk kept on purpose: the n-th generated mel token sits at mel
position n+1 (HF's position bookkeeping, gpt/model.py:164-167); checkpoints
are trained against this numbering.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import conformer, gpt2, perceiver
from indextts_tpu_torch.models.gpt2 import GPT2Size, layer_norm
from indextts_tpu_torch.ops import sampling
from indextts_tpu_torch.ops.cuda.decode_layer import flatten_cache, fused_decode_trunk_flat


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


def _check_condition_type(cfg: GPTConfig) -> None:
    if cfg.condition_type != "conformer_perceiver":
        raise NotImplementedError(
            f"condition_type={cfg.condition_type!r}: only 'conformer_perceiver' is "
            "ported; the legacy encoders are ROADMAP item A5b")


def init_params(cfg: GPTConfig, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    _check_condition_type(cfg)
    D = cfg.model_dim
    n_text = cfg.number_text_tokens * cfg.types + 1

    def nrm(shape, std=0.02):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    return {
        "conditioning_encoder": conformer.init_params(conformer_size(cfg), generator, dtype,
                                                      device),
        "perceiver_encoder": perceiver.init_params(perceiver_size(cfg), generator, dtype,
                                                   device),
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
    """cond_mel [B, n_mels, T] -> conditioning latents [B, 32, D]
    (reference gpt/model.py:487-546), in the parameters' type."""
    _check_condition_type(cfg)
    B = cond_mel.shape[0]
    wdtype = params["conditioning_encoder"]["embed"]["conv"]["w"].dtype
    enc, valid = conformer.forward(params["conditioning_encoder"],
                                   cond_mel.to(wdtype).transpose(1, 2), cond_mel_lengths,
                                   conformer_size(cfg))
    # queries prepended to the context mask (gpt/model.py:346,528)
    mask = torch.cat([torch.ones(B, cfg.condition_num_latent, dtype=torch.bool,
                                 device=valid.device), valid], dim=1)
    return perceiver.forward(params["perceiver_encoder"], enc, mask, perceiver_size(cfg))


def _lm_head(params, hidden):
    """final_norm + mel head (reference lm_head, gpt/model.py:56)."""
    h = layer_norm(hidden, params["final_norm"]["scale"], params["final_norm"]["bias"])
    return h @ params["mel_head"]["kernel"] + params["mel_head"]["bias"]


def latent_forward(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                   text_ids: torch.Tensor, text_lengths: torch.Tensor,
                   mel_codes: torch.Tensor, codes_lengths: torch.Tensor) -> torch.Tensor:
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
    hidden = gpt2.forward(params["gpt"], emb, attn, size)
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


class DecodeResult(NamedTuple):
    codes: torch.Tensor     # [B, max_new] generated mel codes, stop-padded
    lengths: torch.Tensor   # [B] generated length excluding the stop token
    finished: torch.Tensor  # [B] whether stop was emitted
    steps: int              # trunk decode steps run after the prefill


def inference_speech(params: Dict[str, Any], cfg: GPTConfig, cond_latent: torch.Tensor,
                     text_tokens: torch.Tensor, text_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None, max_new: int = 600,
                     temperature: float = 1.0, top_k: int = 30, top_p: float = 0.8,
                     repetition_penalty: float = 10.0, do_sample: bool = True,
                     typical_sampling: bool = False, typical_mass: float = 0.9,
                     cache_dtype=None, cfg_scale: float = 1.0) -> DecodeResult:
    """Autoregressive mel-code generation for one row (replaces HF generate,
    gpt/model.py:669-720): prefill of [cond | text | start_mel], then one
    trunk step per token until every row stopped or `max_new` codes exist.
    text_tokens/text_mask [1, L+2] from prepare_text_prompt."""
    if float(cfg_scale) != 1.0:
        raise NotImplementedError("classifier-free guidance (cfg_scale != 1) is "
                                  "ROADMAP item A11")
    B, Ltot = text_tokens.shape
    if B != 1 or cond_latent.shape[0] != 1:
        raise NotImplementedError("batched decode (more than one row) is ROADMAP item A11")
    size = trunk_size(cfg)
    dev = cond_latent.device
    cache_dtype = cache_dtype or params["gpt"]["blocks"]["attn"]["qkv_w"].dtype
    cond_len = cond_latent.shape[1]

    # prefill embeddings; text positions count from the first valid slot
    tpos = (torch.cumsum(text_mask, dim=1) - 1).clamp(0, cfg.max_text_seq_len - 1)
    text_emb = (params["text_embedding"]["weight"][text_tokens]
                + params["text_pos_embedding"]["weight"][tpos])
    text_emb = text_emb * text_mask[..., None].to(text_emb.dtype)
    start_emb = (params["mel_embedding"]["weight"][cfg.start_mel_token]
                 + params["mel_pos_embedding"]["weight"][0])
    prefill_emb = torch.cat([cond_latent.to(text_emb.dtype), text_emb,
                             start_emb.expand(B, 1, cfg.model_dim)], dim=1)
    P = cond_len + Ltot + 1
    cache_len = -(-(P + max_new) // 8) * 8
    prefill_mask = torch.cat([torch.ones(B, cond_len, dtype=torch.int32, device=dev),
                              text_mask.to(torch.int32),
                              torch.ones(B, 1, dtype=torch.int32, device=dev)], dim=1)
    hidden, cache = gpt2.prefill(params["gpt"], prefill_emb.to(cache_dtype), prefill_mask,
                                 size, cache_len)
    logits = _lm_head(params, hidden[:, -1])

    full_mask = torch.zeros(B, cache_len, dtype=torch.int32, device=dev)
    full_mask[:, :P] = prefill_mask
    presence = sampling.init_penalty_presence(cfg.number_mel_codes, B, prompt_token_ids=(1,),
                                              start_token=cfg.start_mel_token, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    samp = dict(stop_token=cfg.stop_mel_token, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty, do_sample=do_sample,
                typical_sampling=typical_sampling, typical_mass=typical_mass,
                generator=generator)
    tok, presence, finished = sampling.sample_step(logits, presence, finished, **samp)
    codes = torch.full((B, max_new), cfg.stop_mel_token, dtype=torch.int32, device=dev)
    codes[:, 0] = tok

    k_flat, v_flat = flatten_cache(cache)
    del cache
    ln_f = params["gpt"]["ln_f"]
    step = 1
    while step < max_new and not bool(finished.all()):
        # token generated at step-1 sits at mel position step+1
        mel_pos = min(step + 1, cfg.max_mel_seq_len - 1)
        emb = (params["mel_embedding"]["weight"][tok.long()]
               + params["mel_pos_embedding"]["weight"][mel_pos])[:, None, :]
        slot = P + step - 1
        full_mask[:, slot] = 1
        pre, k_flat, v_flat = fused_decode_trunk_flat(
            params["gpt"], emb.to(cache_dtype), k_flat, v_flat, slot, full_mask, cfg.heads)
        hidden = layer_norm(pre, ln_f["scale"], ln_f["bias"])
        logits = _lm_head(params, hidden[:, 0])
        tok, presence, finished = sampling.sample_step(logits, presence, finished, **samp)
        codes[:, step] = tok
        step += 1

    is_stop = codes == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop, max_new)
    return DecodeResult(codes, lengths, finished, step - 1)
