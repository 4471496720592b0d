"""One decode step of the S rows of the continuous-batching pool through the
whole GPT-2 trunk: wrapper of the hand-written CUDA kernels in
`csrc/pool_trunk.cu` (counterpart of the TPU kernel
indextts_tpu/ops/pallas/pool_trunk.py::fused_pool_step).

Each row sits at its own cache position over the flat pool cache
[L, S, T, D].  The step takes plain weights (bf16 or fp32) or int8 `{"q",
"s"}` weights, and a cache in the activation type or fp8 e4m3, as the TPU
kernel does (`supported`).  It returns the trunk hidden before ln_f and the
new K/V rows; the caller scatters the rows into the cache.  At S <= 64 it
reads every weight once a step, on the product core it shares with K2
(`csrc/trunk_products.cuh`: tensor-core products at fp32 accuracy over
streamed weights, 5 L + 2 chained launches; design notes in the sources).
The plain version, `pool_step_plain`, repeats the kernel's arithmetic in
torch; the wrapper takes it only for tensors on the CPU.  For CUDA tensors
it launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from indextts_tpu_torch.models.gpt2 import NEG_INF, gelu_new, layer_norm, tree_index
from indextts_tpu_torch.ops import quantization
from indextts_tpu_torch.ops.cuda import _build

SLOT_BLOCK = 8  # the TPU kernel's slot tile; `supported` keeps its rule

_NORMS = (("ln_1", "scale"), ("ln_1", "bias"), ("ln_2", "scale"), ("ln_2", "bias"))
_MATRICES = (("attn", "qkv_w"), ("attn", "proj_w"), ("mlp", "fc_w"), ("mlp", "proj_w"))
_BIASES = (("attn", "qkv_b"), ("attn", "proj_b"), ("mlp", "fc_b"), ("mlp", "proj_b"))
_PLAIN, _INT8 = 0, 1  # weight forms, as the C entry point numbers them


def supported(S: int, T: int, D: int, heads: int, params: Dict[str, Any]) -> bool:
    """Shapes and weight tiers the TPU kernel handles (plain or int8 weights,
    lane-aligned D, whole slot tiles); the pool takes K4 only where this
    holds.  The CUDA kernel also needs a head width of 64 (the wrapper
    raises otherwise)."""
    aw = params["blocks"]["attn"]["qkv_w"]
    quant_ok = not isinstance(aw, dict) or set(aw) == {"q", "s"}
    return (quant_ok and D % 128 == 0 and D % heads == 0 and T % 8 == 0
            and (S % SLOT_BLOCK == 0 or S <= SLOT_BLOCK))


def pool_step_plain(params: Dict[str, Any], hidden: torch.Tensor, k_all: torch.Tensor,
                    v_all: torch.Tensor, positions: torch.Tensor,
                    attention_mask: torch.Tensor, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the residual stream, LayerNorm, softmax and
    every product in fp32 (int8 weights through matmul_quant: the sum in
    fp32, then the output scaled).  Row s attends slots [0, positions[s]]
    under the additive mask, the cache upcast to fp32; its own slot takes the
    new K/V row rounded to hidden's type, as the kernel merges it.  The cache
    is not written.  Returns (x before ln_f [S, D] in hidden's type, k_rows,
    v_rows [L, S, D] in the cache's type)."""
    blocks = params["blocks"]
    L, S, T, D = k_all.shape
    hd = D // heads
    dev = hidden.device
    rows = torch.arange(S, device=dev)
    pos = positions.to(device=dev, dtype=torch.long).clamp(0, T - 1)
    slots = torch.arange(T, device=dev)
    # [S, 1, T]: the mask's additive bias on [0, pos], and no weight past pos
    bias = torch.where(attention_mask.to(dev) != 0, 0.0, NEG_INF).float()
    bias = torch.where(slots[None, :] <= pos[:, None], bias, float("-inf"))[:, None, :]
    x = hidden.reshape(S, D).float()
    f = lambda t: t.float()  # noqa: E731
    mm = quantization.matmul_quant
    k_rows = torch.empty(L, S, D, dtype=k_all.dtype, device=dev)
    v_rows = torch.empty_like(k_rows)
    for l in range(L):
        blk = tree_index(blocks, l)
        h = layer_norm(x, f(blk["ln_1"]["scale"]), f(blk["ln_1"]["bias"]))
        qkv = mm(h, blk["attn"]["qkv_w"]) + f(blk["attn"]["qkv_b"])
        q, k, v = qkv.split(D, dim=-1)
        k_rows[l], v_rows[l] = k.to(k_all.dtype), v.to(v_all.dtype)
        kk = k_all[l].to(torch.float32, copy=True)             # [S, T, D]
        vv = v_all[l].to(torch.float32, copy=True)
        kk[rows, pos] = k.to(hidden.dtype).float()
        vv[rows, pos] = v.to(hidden.dtype).float()
        scores = torch.einsum("shd,sthd->sht", q.view(S, heads, hd),
                              kk.view(S, T, heads, hd)) / math.sqrt(hd) + bias
        ctx = torch.einsum("sht,sthd->shd", torch.softmax(scores, dim=-1),
                           vv.view(S, T, heads, hd)).reshape(S, D)
        x = x + mm(ctx, blk["attn"]["proj_w"]) + f(blk["attn"]["proj_b"])
        h = layer_norm(x, f(blk["ln_2"]["scale"]), f(blk["ln_2"]["bias"]))
        m = gelu_new(mm(h, blk["mlp"]["fc_w"]) + f(blk["mlp"]["fc_b"]))
        x = x + mm(m, blk["mlp"]["proj_w"]) + f(blk["mlp"]["proj_b"])
    return x.to(hidden.dtype), k_rows, v_rows


def _weight_form(w, dtype: torch.dtype, K: int, N: int, L: int):
    """(form, data tensor, scale tensor or None) of one stacked matrix
    [L, K, N], or raise for what the kernel does not take."""
    if isinstance(w, torch.Tensor):
        if w.dtype != dtype or tuple(w.shape) != (L, K, N):
            raise ValueError(f"plain weight {tuple(w.shape)} {w.dtype}: expected "
                             f"{(L, K, N)} {dtype}")
        return _PLAIN, w, None
    if set(w) == {"q", "s"}:
        q, s = w["q"], w["s"]
        if (q.dtype != torch.int8 or tuple(q.shape) != (L, K, N)
                or s.dtype != torch.float32 or tuple(s.shape) != (L, 1, N)):
            raise ValueError(f"int8 weight {tuple(q.shape)}/{tuple(s.shape)}: expected "
                             f"int8 {(L, K, N)} with fp32 scales {(L, 1, N)}")
        return _INT8, q, s
    raise ValueError(f"weight form {sorted(w)} is not served by the pool-step kernel "
                     "(plain or int8 {q, s} only)")


def fused_pool_step(params: Dict[str, Any], hidden: torch.Tensor, k_all: torch.Tensor,
                    v_all: torch.Tensor, positions: torch.Tensor,
                    attention_mask: torch.Tensor, heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode step for all S pool rows.

    hidden [S, D] this step's embeddings; k_all, v_all [L, S, T, D] the flat
    pool cache (read, not written); positions [S] the write slot of each
    row's current token, in [0, T); attention_mask [S, T] with 1 on every
    valid slot including positions[s] and 0 past it.  Returns (trunk hidden
    before ln_f [S, D], k_rows [L, S, D], v_rows [L, S, D]): the caller
    scatters the rows into the cache at `positions`.  On CUDA: hidden,
    LayerNorm parameters and biases in one type (bf16 or fp32); the four
    matrices all plain in that type or all int8; the cache in hidden's type
    or float8_e4m3fn; head width 64."""
    forms = [sorted(w) for w in (params["blocks"][a][b] for a, b in _MATRICES)
             if isinstance(w, dict) and set(w) != {"q", "s"}]
    if forms:
        raise ValueError(f"weight form {forms[0]} is not served by the pool-step kernel "
                         "(plain or int8 {q, s} only)")
    if hidden.device.type == "cpu":
        return pool_step_plain(params, hidden, k_all, v_all, positions, attention_mask,
                               heads)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_pool_step: unsupported device {hidden.device}")
    blocks = params["blocks"]
    L, S, T, D = k_all.shape
    dtype = hidden.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_pool_step: unsupported type {dtype}")
    if k_all.dtype != v_all.dtype or k_all.dtype not in (dtype, torch.float8_e4m3fn):
        raise ValueError(f"cache {k_all.dtype}/{v_all.dtype} with hidden {dtype}: the "
                         "cache must be in hidden's type or float8_e4m3fn")
    if tuple(hidden.shape) != (S, D) or tuple(attention_mask.shape) != (S, T) \
            or tuple(positions.shape) != (S,) or v_all.shape != k_all.shape:
        raise ValueError(f"shapes: hidden {tuple(hidden.shape)}, cache {tuple(k_all.shape)}, "
                         f"positions {tuple(positions.shape)}, mask "
                         f"{tuple(attention_mask.shape)}")
    if D % heads or D // heads != 64 or D % 128:
        raise ValueError(f"unsupported width: D={D} heads={heads} (head width 64, D a "
                         "multiple of 128)")
    vectors = [blocks[a][b] for a, b in _NORMS + _BIASES]
    if any(t.dtype != dtype for t in vectors):
        raise ValueError("LayerNorm parameters and biases must be in hidden's type")
    shapes = ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D))
    mats = [_weight_form(blocks[a][b], dtype, K, N, L)
            for (a, b), (K, N) in zip(_MATRICES, shapes)]
    form = mats[0][0]
    if any(m[0] != form for m in mats):
        raise ValueError("the four trunk matrices must share one weight form")
    pos = positions.to(torch.int32).contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    tensors = [hidden, k_all, v_all, pos, mask, *vectors]
    tensors += [t for m in mats for t in m[1:] if t is not None]
    if any(t.device != hidden.device or not t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous and on hidden's device")
    lib = _build.load()
    out = torch.empty_like(hidden)
    k_rows = torch.empty(L, S, D, dtype=k_all.dtype, device=hidden.device)
    v_rows = torch.empty_like(k_rows)
    scratch = torch.empty(lib.pool_trunk_scratch_floats(S, D, heads, T),
                          dtype=torch.float32, device=hidden.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ln1_s, ln1_b, ln2_s, ln2_b, qkv_b, proj_b, fc_b, mproj_b = (t.data_ptr() for t in vectors)
    (qkv_w, qkv_s), (proj_w, proj_s), (fc_w, fc_s), (mproj_w, mproj_s) = (
        (m[1].data_ptr(), ptr(m[2])) for m in mats)
    rc = lib.pool_trunk_step(
        int(dtype == torch.bfloat16), form, int(k_all.dtype == torch.float8_e4m3fn),
        hidden.data_ptr(), out.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
        k_rows.data_ptr(), v_rows.data_ptr(), pos.data_ptr(), mask.data_ptr(),
        S, L, D, heads, T, ln1_s, ln1_b, qkv_w, qkv_s, qkv_b, proj_w, proj_s, proj_b,
        ln2_s, ln2_b, fc_w, fc_s, fc_b, mproj_w, mproj_s, mproj_b,
        scratch.data_ptr(), torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check(lib, rc, "pool_trunk_step")
    fused_pool_step.launches += 1
    return out, k_rows, v_rows


fused_pool_step.launches = 0
