"""Single-row decode step through the whole GPT-2 trunk: wrapper of the
hand-written CUDA kernels in `csrc/decode_layer.cu` (counterpart of the TPU
kernel indextts_tpu/ops/pallas/decode_layer.py::fused_decode_trunk_flat).

It serves every tier of the TPU kernel: weights in the activation type
(bf16 or fp32), int8 `{"q", "s"}` or fused-layout packed int4 `{"q4", "s"}`
(ops/quantization.py), and a cache in the activation type or fp8 e4m3.
Device memory bandwidth bounds the step: it reads every trunk weight once
(943.7 MB in bf16 at the flagship width, about half in int8, a quarter in
int4) plus the live cache.  The kernels are the S = 1 case of the product
core K2 shares with K4 (`csrc/trunk_products.cuh`: tensor-core products at
fp32 accuracy over streamed weights, 5 L + 2 chained launches a step;
design notes in the sources).  The plain version, `decode_trunk_plain`, is
a per-layer torch loop with the same arithmetic; the wrapper takes it only
for tensors on the CPU.  For CUDA tensors it launches the kernels or raises.
`fused_decode_trunk` is the head-split wrapper: [L, 1, H, T, hd] cache in,
the same cache layout out.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from indextts_tpu_torch.models.gpt2 import NEG_INF, KVCache, gelu_new, layer_norm, tree_index
from indextts_tpu_torch.ops import quantization
from indextts_tpu_torch.ops.cuda import _build

_NORMS = (("ln_1", "scale"), ("ln_1", "bias"), ("ln_2", "scale"), ("ln_2", "bias"))
_MATRICES = (("attn", "qkv_w"), ("attn", "proj_w"), ("mlp", "fc_w"), ("mlp", "proj_w"))
_BIASES = (("attn", "qkv_b"), ("attn", "proj_b"), ("mlp", "fc_b"), ("mlp", "proj_b"))
# weight forms, as the C entry point numbers them
_PLAIN, _INT8, _INT4 = 0, 1, 2


def flatten_cache(cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, 1, H, T, hd] -> flat [L, T, H*hd] (head-major), contiguous."""
    L, B, H, T, hd = cache.k.shape
    if B != 1:
        raise ValueError(f"flatten_cache takes one row, got {B}")
    k = cache.k[:, 0].transpose(1, 2).reshape(L, T, H * hd).contiguous()
    v = cache.v[:, 0].transpose(1, 2).reshape(L, T, H * hd).contiguous()
    return k, v


def unflatten_cache(k_flat: torch.Tensor, v_flat: torch.Tensor, heads: int) -> KVCache:
    """Flat [L, T, H*hd] (head-major) -> [L, 1, H, T, hd], the inverse of
    flatten_cache."""
    L, T, D = k_flat.shape
    hd = D // heads
    k = k_flat.reshape(L, T, heads, hd).transpose(1, 2)[:, None]
    v = v_flat.reshape(L, T, heads, hd).transpose(1, 2)[:, None]
    return KVCache(k, v)


def decode_trunk_plain(params: Dict[str, Any], hidden: torch.Tensor, k_flat: torch.Tensor,
                       v_flat: torch.Tensor, position: int, attention_mask: torch.Tensor,
                       heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the residual stream, LayerNorm, softmax and
    every product in fp32 (quantized weights through matmul_quant: the sum
    in fp32, then the output scaled); the new K/V rows are written into
    k_flat/v_flat at `position` in place, in the cache's type.  Attends over
    slots [0, position] under the additive mask, the cache upcast to fp32;
    the token's own slot takes its K/V rounded to hidden's type, as the TPU
    kernel merges its fp32 row (cast to the compute type) into its chunk
    (with a cache in hidden's type that is the stored row)."""
    blocks = params["blocks"]
    L, T, D = k_flat.shape
    hd = D // heads
    pos = int(position)
    x = hidden.reshape(1, D).float()
    bias = torch.where(attention_mask.reshape(T)[: pos + 1] != 0, 0.0, NEG_INF).float()
    f = lambda t: t.float()  # noqa: E731
    mm = quantization.matmul_quant
    for l in range(L):
        blk = tree_index(blocks, l)
        h = layer_norm(x, f(blk["ln_1"]["scale"]), f(blk["ln_1"]["bias"]))
        qkv = mm(h, blk["attn"]["qkv_w"]) + f(blk["attn"]["qkv_b"])
        q, k, v = qkv.split(D, dim=-1)
        k_flat[l, pos] = k[0].to(k_flat.dtype)
        v_flat[l, pos] = v[0].to(v_flat.dtype)
        kk = torch.cat([k_flat[l, :pos].float(), k.to(hidden.dtype).float()]).view(
            pos + 1, heads, hd)
        vv = torch.cat([v_flat[l, :pos].float(), v.to(hidden.dtype).float()]).view(
            pos + 1, heads, hd)
        scores = torch.einsum("hd,thd->ht", q.view(heads, hd), kk) / math.sqrt(hd) + bias
        ctx = torch.einsum("ht,thd->hd", torch.softmax(scores, dim=-1), vv).reshape(1, D)
        x = x + mm(ctx, blk["attn"]["proj_w"]) + f(blk["attn"]["proj_b"])
        h = layer_norm(x, f(blk["ln_2"]["scale"]), f(blk["ln_2"]["bias"]))
        m = gelu_new(mm(h, blk["mlp"]["fc_w"]) + f(blk["mlp"]["fc_b"]))
        x = x + mm(m, blk["mlp"]["proj_w"]) + f(blk["mlp"]["proj_b"])
    return x.to(hidden.dtype).view(1, 1, D), k_flat, v_flat


def _weight_form(w, dtype: torch.dtype, K: int, N: int, L: int):
    """(form, data tensor, scale tensor or None, groups) of one stacked
    matrix [L, K, N], or raise for what the kernel does not take."""
    if isinstance(w, torch.Tensor):
        if w.dtype != dtype or tuple(w.shape) != (L, K, N):
            raise ValueError(f"plain weight {tuple(w.shape)} {w.dtype}: expected "
                             f"{(L, K, N)} {dtype}")
        return _PLAIN, w, None, 1
    if set(w) == {"q", "s"}:
        q, s = w["q"], w["s"]
        if (q.dtype != torch.int8 or tuple(q.shape) != (L, K, N)
                or s.dtype != torch.float32 or tuple(s.shape) != (L, 1, N)):
            raise ValueError(f"int8 weight {tuple(q.shape)}/{tuple(s.shape)}: expected "
                             f"int8 {(L, K, N)} with fp32 scales {(L, 1, N)}")
        return _INT8, q, s, 1
    if set(w) == {"q4", "s"}:
        q, s = w["q4"], w["s"]
        G = s.shape[1] // 2 if s.ndim == 3 else 0
        if (q.dtype != torch.int8 or tuple(q.shape) != (L, K // 2, N)
                or s.dtype != torch.float32 or G < 1 or tuple(s.shape) != (L, 2 * G, N)
                or K % (2 * G)):
            raise ValueError(f"int4 weight {tuple(q.shape)}/{tuple(s.shape)}: expected "
                             f"int8 {(L, K // 2, N)} with fp32 scales [L, 2G, N], 2G | K")
        if (K // (2 * G)) % 64:
            raise ValueError(f"int4 weight with {G} groups over K={K}: the kernel takes "
                             "halves of a multiple of 64 rows")
        return _INT4, q, s, G
    raise ValueError(f"weight form {sorted(w)} is not served by the kernel "
                     "(the shared int4 layout is for batched decode)")


def fused_decode_trunk_flat(params: Dict[str, Any], hidden: torch.Tensor,
                            k_flat: torch.Tensor, v_flat: torch.Tensor, position: int,
                            attention_mask: torch.Tensor, heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of one row over the flat cache.

    hidden [1, 1, D]; k_flat, v_flat [L, T, D]; position: the slot of this
    token (0 <= position < T, any T >= 1); attention_mask [1, T] with 1 on
    every valid slot including `position`.  Returns (trunk hidden before
    ln_f [1, 1, D], k_flat, v_flat): the new K/V rows are written into the
    given cache tensors IN PLACE.  On CUDA: hidden, LayerNorm parameters and
    biases in one type (bf16 or fp32); the four matrices all plain in that
    type, all int8 or all fused int4; the cache in hidden's type or
    float8_e4m3fn; head_dim 64; D a multiple of 128; int4 halves
    (K / 2G rows) a multiple of 64."""
    if hidden.device.type == "cpu":
        return decode_trunk_plain(params, hidden, k_flat, v_flat, position,
                                  attention_mask, heads)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_decode_trunk_flat: unsupported device {hidden.device}")
    blocks = params["blocks"]
    L, T, D = k_flat.shape
    dtype = hidden.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_decode_trunk_flat: unsupported type {dtype}")
    if k_flat.dtype != v_flat.dtype or k_flat.dtype not in (dtype, torch.float8_e4m3fn):
        raise ValueError(f"cache {k_flat.dtype}/{v_flat.dtype} with hidden {dtype}: the "
                         "cache must be in hidden's type or float8_e4m3fn")
    vectors = [blocks[a][b] for a, b in _NORMS + _BIASES]
    if any(t.dtype != dtype for t in vectors):
        raise ValueError("LayerNorm parameters and biases must be in hidden's type")
    shapes = ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D))
    mats = [_weight_form(blocks[a][b], dtype, K, N, L)
            for (a, b), (K, N) in zip(_MATRICES, shapes)]
    form = mats[0][0]
    if any(m[0] != form for m in mats):
        raise ValueError("the four trunk matrices must share one weight form")
    mask = attention_mask.reshape(T).to(torch.int32).contiguous()
    tensors = [hidden, k_flat, v_flat, mask, *vectors]
    tensors += [t for m in mats for t in m[1:3] if t is not None]
    if any(t.device != hidden.device or not t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous and on hidden's device")
    if D // heads != 64 or D % 128 or hidden.numel() != D or not 0 <= int(position) < T:
        raise ValueError(f"unsupported shape: D={D} heads={heads} T={T} "
                         f"position={int(position)}")
    lib = _build.load()
    out = torch.empty_like(hidden)
    scratch = torch.empty(lib.decode_trunk_scratch_floats(D, heads, T),
                          dtype=torch.float32, device=hidden.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ln1_s, ln1_b, ln2_s, ln2_b, qkv_b, proj_b, fc_b, mproj_b = (t.data_ptr() for t in vectors)
    per_matrix = [(m[1].data_ptr(), ptr(m[2]), m[3]) for m in mats]
    rc = lib.decode_trunk_step(
        int(dtype == torch.bfloat16), form, int(k_flat.dtype == torch.float8_e4m3fn),
        hidden.data_ptr(), out.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
        mask.data_ptr(), int(position), L, D, heads, T,
        ln1_s, ln1_b, *per_matrix[0], qkv_b, *per_matrix[1], proj_b,
        ln2_s, ln2_b, *per_matrix[2], fc_b, *per_matrix[3], mproj_b,
        scratch.data_ptr(), torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check(lib, rc, "decode_trunk_step")
    fused_decode_trunk_flat.launches += 1
    return out, k_flat, v_flat


fused_decode_trunk_flat.launches = 0


def fused_decode_trunk(params: Dict[str, Any], hidden: torch.Tensor, cache: KVCache,
                       position: int, attention_mask: torch.Tensor, heads: int
                       ) -> Tuple[torch.Tensor, KVCache]:
    """The head-split wrapper (counterpart of the TPU package's
    fused_decode_trunk): the cache [L, 1, H, T, hd] is flattened, stepped by
    fused_decode_trunk_flat and returned in its own layout.  A loop that keeps
    the flat layout should call fused_decode_trunk_flat: the transposes here
    cost a pass over the cache each step."""
    k_flat, v_flat = flatten_cache(cache)
    x, k_flat, v_flat = fused_decode_trunk_flat(params, hidden, k_flat, v_flat, position,
                                                attention_mask, heads)
    return x, unflatten_cache(k_flat, v_flat, heads)
