"""GPT-2 trunk as plain functions over tensors (counterpart of
indextts_tpu/models/gpt2.py).

Numerically the HF ``GPT2Model`` the reference builds (indextts/gpt/
model.py:263-286: wpe nulled, wte external, gelu_new, LayerNorm eps 1e-5).
Parameters keep the JAX package's stacked layout: every block tensor has
the layers on a leading axis, and matrices are K-major, e.g.
``blocks.attn.qkv_w`` is [L, D, 3D].  The single-row decode kernel reads one
contiguous per-layer slab of each, and weights carry across as a plain copy.

Tensor parallelism (parallel/tp.py): with a `group` (parallel/mesh.TPGroup)
the step functions run on one rank's shard of the trunk, its H/N heads and
4D/N MLP columns, and sum the two row-parallel products of each block over
the ranks (two all-reduces a layer, and nowhere else); the K/V cache holds
the rank's heads.  Without a group they compute what they did before.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from indextts_tpu_torch.ops import quantization

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Size:
    layers: int
    dim: int
    heads: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF "gelu_new" (tanh approximation)."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * torch.pow(x, 3.0))))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 whatever the input type; returns x's type."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def local_size(size: GPT2Size, group=None) -> GPT2Size:
    """The trunk size one rank of `group` computes: its H/N heads, D/N of the
    attention width (the whole size without a group)."""
    n = 1 if group is None else group.size
    if n == 1:
        return size
    if size.heads % n:
        raise ValueError(f"{n} ranks do not divide the trunk's {size.heads} heads")
    return GPT2Size(layers=size.layers, dim=size.dim // n, heads=size.heads // n)


def tree_index(tree, i: int):
    """Layer i of a tree of stacked tensors."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_unstack(tree):
    """Every layer's tree of a tree of stacked tensors, by one `unbind` a
    leaf: its backward is one stack, where indexing each layer would form
    a full-size gradient for every layer."""
    if isinstance(tree, dict):
        parts = {k: tree_unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def init_gpt2_params(size: GPT2Size, generator: torch.Generator,
                     dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """GPT-2's random init (normal 0.02, zero biases, residual projections
    scaled by 1/sqrt(2L))."""
    L, D = size.layers, size.dim
    std = 0.02
    proj_std = std / math.sqrt(2 * L)

    def nrm(shape, s):
        return (torch.randn(shape, generator=generator, device=device) * s).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "blocks": {
            "ln_1": {"scale": ones(L, D), "bias": zeros(L, D)},
            "attn": {"qkv_w": nrm((L, D, 3 * D), std), "qkv_b": zeros(L, 3 * D),
                     "proj_w": nrm((L, D, D), proj_std), "proj_b": zeros(L, D)},
            "ln_2": {"scale": ones(L, D), "bias": zeros(L, D)},
            "mlp": {"fc_w": nrm((L, D, 4 * D), std), "fc_b": zeros(L, 4 * D),
                    "proj_w": nrm((L, 4 * D, D), proj_std), "proj_b": zeros(L, D)},
        },
        "ln_f": {"scale": ones(D), "bias": zeros(D)},
    }


class KVCache(NamedTuple):
    """Static-shape KV cache: k/v are [L, B, H, T_max, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, size: GPT2Size, batch: int, max_len: int, dtype=torch.bfloat16,
              device="cpu") -> "KVCache":
        shape = (size.layers, batch, size.heads, max_len, size.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, H, T, hd]; bias additive, broadcastable to [B, H, Tq, Tk].
    Scores and softmax in fp32; the context in q's type.  A cache stored
    narrower than q (the fp8 tier) is upcast to q's type at the read."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1]) + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


# x [..., K] @ w [K, N] for plain, int8 and both int4 weight forms: one
# implementation for the trunk, the heads and dequantize
_mm = quantization.matmul_quant


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, heads, D // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def _block(hidden: torch.Tensor, blk: Dict[str, Any], heads: int, attend,
           group=None) -> torch.Tensor:
    """One transformer block; `attend` maps (q, k, v) -> context.  With a
    `group`, `blk` is one rank's shard (`heads` its own) and the two
    row-parallel products are summed over the ranks before their bias."""
    x = layer_norm(hidden, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
    qkv = _mm(x, blk["attn"]["qkv_w"]) + blk["attn"]["qkv_b"].to(x.dtype)
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    ctx = attend(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads))
    proj = _mm(_merge_heads(ctx), blk["attn"]["proj_w"])
    if group is not None:
        proj = group.all_reduce(proj)
    hidden = hidden + proj + blk["attn"]["proj_b"].to(x.dtype)
    x = layer_norm(hidden, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    h = gelu_new(_mm(x, blk["mlp"]["fc_w"]) + blk["mlp"]["fc_b"].to(x.dtype))
    out = _mm(h, blk["mlp"]["proj_w"])
    if group is not None:
        out = group.all_reduce(out)
    return hidden + out + blk["mlp"]["proj_b"].to(x.dtype)


def _causal_bias(attention_mask: Optional[torch.Tensor], T: int,
                 device) -> torch.Tensor:
    allow = torch.ones(T, T, dtype=torch.bool, device=device).tril()[None, None]
    if attention_mask is not None:
        allow = allow & attention_mask[:, None, None, :].bool()
    return torch.where(allow, 0.0, NEG_INF).float()


def forward(params: Dict[str, Any], hidden: torch.Tensor,
            attention_mask: Optional[torch.Tensor], size: GPT2Size,
            remat: bool = False, group=None) -> torch.Tensor:
    """Teacher-forced forward.  hidden [B, T, D]; attention_mask [B, T]
    (1 = valid) or None.  Returns ln_f(hidden) [B, T, D].  With `remat`,
    backward recomputes each block from its input instead of keeping its
    activations (the fp32 attention scores above all), as JAX's
    `jax.checkpoint` of the layer scan does."""
    size = local_size(size, group)
    bias = _causal_bias(attention_mask, hidden.shape[1], hidden.device)
    attend = lambda q, k, v: _attention(q, k, v, bias)  # noqa: E731
    for blk in tree_unstack(params["blocks"]):
        if remat:
            hidden = torch.utils.checkpoint.checkpoint(
                _block, hidden, blk, size.heads, attend, group, use_reentrant=False)
        else:
            hidden = _block(hidden, blk, size.heads, attend, group)
    return layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])


def prefill(params: Dict[str, Any], hidden: torch.Tensor, attention_mask: torch.Tensor,
            size: GPT2Size, cache_len: int, kv_dtype=None,
            group=None) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt and build the KV cache, allocated at `cache_len` with
    the first T slots filled, stored as `kv_dtype` (default: hidden's type).
    Returns (ln_f output [B, T, D], cache)."""
    size = local_size(size, group)
    B, T, _ = hidden.shape
    bias = _causal_bias(attention_mask, T, hidden.device)
    cache = KVCache.zeros(size, B, cache_len, kv_dtype or hidden.dtype, hidden.device)
    for l in range(size.layers):
        def attend(q, k, v, l=l):
            cache.k[l, :, :, :T] = k.to(cache.k.dtype)
            cache.v[l, :, :, :T] = v.to(cache.v.dtype)
            return _attention(q, k, v, bias)

        hidden = _block(hidden, tree_index(params["blocks"], l), size.heads, attend, group)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, cache


def decode_step(params: Dict[str, Any], hidden: torch.Tensor, cache: KVCache,
                position: int, attention_mask: torch.Tensor,
                size: GPT2Size, group=None) -> Tuple[torch.Tensor, KVCache]:
    """Single-token incremental forward.  hidden [B, 1, D]; position: the slot
    of this token's K/V (written into `cache` in place, in the cache's type);
    attention_mask [B, cache_len] with 1 on every valid slot including
    `position`.  Returns (ln_f output [B, 1, D], cache)."""
    size = local_size(size, group)
    bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF).float()
    for l in range(size.layers):
        def attend(q, k, v, l=l):
            cache.k[l, :, :, position] = k[:, :, 0].to(cache.k.dtype)
            cache.v[l, :, :, position] = v[:, :, 0].to(cache.v.dtype)
            return _attention(q, cache.k[l], cache.v[l], bias)

        hidden = _block(hidden, tree_index(params["blocks"], l), size.heads, attend, group)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, cache


def decode_step_rows(params: Dict[str, Any], hidden: torch.Tensor, cache: KVCache,
                     positions: torch.Tensor, attention_mask: torch.Tensor,
                     size: GPT2Size, group=None) -> Tuple[torch.Tensor, KVCache]:
    """Single-token forward with a cache position per row, the continuous
    pool's step: every slot sits at its own offset.  hidden [B, 1, D];
    positions [B] the write slots (row b's K/V is written at positions[b] in
    place, in the cache's type); attention_mask [B, cache_len] including
    `positions`.  Returns (ln_f output [B, 1, D], cache)."""
    size = local_size(size, group)
    bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF).float()
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    pos = positions.long()
    for l in range(size.layers):
        def attend(q, k, v, l=l):
            cache.k[l][rows, :, pos] = k[:, :, 0].to(cache.k.dtype)
            cache.v[l][rows, :, pos] = v[:, :, 0].to(cache.v.dtype)
            return _attention(q, cache.k[l], cache.v[l], bias)

        hidden = _block(hidden, tree_index(params["blocks"], l), size.heads, attend, group)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, cache


def decode_step_rows_flat(params: Dict[str, Any], hidden: torch.Tensor, k_all: torch.Tensor,
                          v_all: torch.Tensor, positions: torch.Tensor,
                          attention_mask: torch.Tensor, size: GPT2Size
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`decode_step_rows` over the flat pool cache [L, S, T, D] (D = H * hd,
    head-major), the layout of the pool-step kernel (ops/cuda/pool_trunk.py).
    Unlike the kernel and its plain version (`pool_step_plain`), the new rows
    are written first and read back in the cache's type, as the reference's
    XLA step does; the tests hold both against that step.  hidden [S, 1, D];
    positions [S]; attention_mask
    [S, T] including `positions`.  Returns (ln_f output, k_all, v_all), the
    cache written in place."""
    S = hidden.shape[0]
    T = k_all.shape[2]
    H, hd = size.heads, size.head_dim
    rows = torch.arange(S, device=hidden.device)
    pos = positions.long()
    bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF).float()
    for l in range(size.layers):
        blk = tree_index(params["blocks"], l)
        x = layer_norm(hidden, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
        qkv = _mm(x, blk["attn"]["qkv_w"]) + blk["attn"]["qkv_b"].to(x.dtype)
        q, k, v = qkv[:, 0].split(qkv.shape[-1] // 3, dim=-1)          # [S, D] each
        k_all[l, rows, pos] = k.to(k_all.dtype)
        v_all[l, rows, pos] = v.to(v_all.dtype)
        kr = k_all[l].view(S, T, H, hd).transpose(1, 2)
        vr = v_all[l].view(S, T, H, hd).transpose(1, 2)
        ctx = _merge_heads(_attention(q.reshape(S, H, 1, hd), kr, vr, bias))
        hidden = hidden + _mm(ctx.to(x.dtype), blk["attn"]["proj_w"]) \
            + blk["attn"]["proj_b"].to(x.dtype)
        x = layer_norm(hidden, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
        m = gelu_new(_mm(x, blk["mlp"]["fc_w"]) + blk["mlp"]["fc_b"].to(x.dtype))
        hidden = hidden + _mm(m, blk["mlp"]["proj_w"]) + blk["mlp"]["proj_b"].to(x.dtype)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, k_all, v_all


def flatten_rows_cache(cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, B, H, T, hd] -> flat [L, B, T, H * hd] (head-major per position)."""
    L, B, H, T, hd = cache.k.shape
    k = cache.k.transpose(2, 3).reshape(L, B, T, H * hd)
    v = cache.v.transpose(2, 3).reshape(L, B, T, H * hd)
    return k, v


def _lineage_context(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, ks: torch.Tensor,
                     vs: torch.Tensor, prefix_bias: torch.Tensor, sb: torch.Tensor,
                     nb: int) -> torch.Tensor:
    """Lineage attention of one layer: q [B*nb, H, 1, hd] over the prefix
    kp, vp [B, H, Pc, hd] and all nb suffix rows of each request ks, vs
    [B*nb, H, Sc, hd], under prefix_bias [B, 1, 1, Pc] and the lineage mask
    sb [B, nb_q, nb_kv, 1, Sc].  Prefix and suffix scores join one fp32
    softmax, prefix first.  Returns the context [B*nb, H, 1, hd] in q's type."""
    Bnb, H, _, hd = q.shape
    B = Bnb // nb
    Sc = ks.shape[2]
    cd = q.dtype
    kp, vp = kp.to(cd).float(), vp.to(cd).float()
    ks = ks.to(cd).float().view(B, nb, H, Sc, hd)
    vs = vs.to(cd).float().view(B, nb, H, Sc, hd)
    qh = q[:, :, 0, :].float().view(B, nb, H, hd)
    scale = 1.0 / math.sqrt(hd)
    sp = torch.einsum("bnhd,bhpd->bnhp", qh, kp) * scale + prefix_bias
    ss = torch.einsum("bnhd,bmhsd->bnmhs", qh, ks) * scale + sb
    Pc = sp.shape[-1]
    flat = torch.cat([sp, ss.permute(0, 1, 3, 2, 4).reshape(B, nb, H, nb * Sc)], dim=-1)
    probs = torch.softmax(flat, dim=-1)
    pp = probs[..., :Pc].to(cd).float()
    ps = probs[..., Pc:].to(cd).float().view(B, nb, H, nb, Sc)
    ctx = (torch.einsum("bnhp,bhpd->bnhd", pp, vp)
           + torch.einsum("bnhms,bmhsd->bnhd", ps, vs))
    return ctx.reshape(Bnb, H, 1, hd).to(cd)


def decode_step_lineage(params: Dict[str, Any], hidden: torch.Tensor, prefix: KVCache,
                        prefix_bias: torch.Tensor, suffix: KVCache, suffix_bias: torch.Tensor,
                        step: int, size: GPT2Size, nb: int,
                        group=None) -> Tuple[torch.Tensor, KVCache]:
    """Beam decode step with no physical cache reorder.

    The prompt prefix is cached once per request row (prefix [L, B, H, Pc,
    hd]); each of the B*nb beams keeps the K/V it generated in its own suffix
    row (suffix [L, B*nb, H, Sc, hd]).  Attention runs over the prefix and
    over ALL nb suffix rows of the request, under the additive `suffix_bias`
    [B, nb_q, nb_kv, Sc] that admits slot s of row m for beam n only where
    row m owns slot s in beam n's lineage and s < step.  Prefix and suffix
    scores join one fp32 softmax, prefix first.

    hidden [B*nb, 1, D]; prefix_bias [B, 1, 1, Pc]; this token's K/V is
    written at suffix slot step-1 of each row's own suffix, in place.
    Returns (ln_f output [B*nb, 1, D], suffix)."""
    size = local_size(size, group)
    sb = suffix_bias[:, :, :, None, :]              # [B, nbq, nbk, 1, Sc] (over H)
    for l in range(size.layers):
        def attend(q, k, v, l=l):
            # q, k, v [B*nb, H, 1, hd]
            suffix.k[l, :, :, step - 1] = k[:, :, 0].to(suffix.k.dtype)
            suffix.v[l, :, :, step - 1] = v[:, :, 0].to(suffix.v.dtype)
            return _lineage_context(q, prefix.k[l], prefix.v[l], suffix.k[l], suffix.v[l],
                                    prefix_bias, sb, nb)

        hidden = _block(hidden, tree_index(params["blocks"], l), size.heads, attend, group)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, suffix


def decode_step_lineage_rows(params: Dict[str, Any], hidden: torch.Tensor, prefix: KVCache,
                             prefix_bias: torch.Tensor, suffix: KVCache,
                             suffix_bias: torch.Tensor, positions: torch.Tensor,
                             size: GPT2Size, nb: int) -> Tuple[torch.Tensor, KVCache]:
    """`decode_step_lineage` with a suffix write position per row: the beam
    pool's step (serve/beam_pool.py), where each beam group sits at its own
    offset.  The attention is `decode_step_lineage`'s, op for op, so a pool
    group's step equals the dedicated decode's.

    hidden [B*nb, 1, D]; positions [B*nb]: row b's K/V is written at suffix
    slot positions[b], in place.  A row whose position is Sc or more
    (a frozen group parked at Sc) writes nothing: its slot keeps its value,
    as the JAX package's drop-mode scatter leaves it.  Returns (ln_f output
    [B*nb, 1, D], suffix)."""
    Sc = suffix.k.shape[3]
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    keep = (positions < Sc)[:, None, None]
    pos = positions.clamp(max=Sc - 1).long()
    sb = suffix_bias[:, :, :, None, :]
    for l in range(size.layers):
        def attend(q, k, v, l=l):
            for cache, new in ((suffix.k[l], k), (suffix.v[l], v)):
                cache[rows, :, pos] = torch.where(keep, new[:, :, 0].to(cache.dtype),
                                                  cache[rows, :, pos])
            return _lineage_context(q, prefix.k[l], prefix.v[l], suffix.k[l], suffix.v[l],
                                    prefix_bias, sb, nb)

        hidden = _block(hidden, tree_index(params["blocks"], l), size.heads, attend)
    out = layer_norm(hidden, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return out, suffix
