"""Single-row decode step through the whole GPT-2 trunk: wrapper of the
hand-written CUDA kernels in `csrc/decode_layer.cu` (counterpart of the TPU
kernel indextts_tpu/ops/pallas/decode_layer.py::fused_decode_trunk_flat,
plain-weight tier).

Device memory bandwidth bounds the step: it reads every trunk weight once
(943.7 MB in bf16 at the flagship width) plus the live cache (design notes
in the source).  The plain version, `decode_trunk_plain`, is a per-layer
torch loop with the same arithmetic; the wrapper takes it only for tensors
on the CPU.  For CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from indextts_tpu_torch.models.gpt2 import NEG_INF, KVCache, gelu_new, layer_norm
from indextts_tpu_torch.ops.cuda import _build

_WEIGHTS = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "qkv_w"), ("attn", "qkv_b"),
            ("attn", "proj_w"), ("attn", "proj_b"), ("ln_2", "scale"), ("ln_2", "bias"),
            ("mlp", "fc_w"), ("mlp", "fc_b"), ("mlp", "proj_w"), ("mlp", "proj_b"))


def flatten_cache(cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, 1, H, T, hd] -> flat [L, T, H*hd] (head-major), contiguous."""
    L, B, H, T, hd = cache.k.shape
    if B != 1:
        raise ValueError(f"flatten_cache takes one row, got {B}")
    k = cache.k[:, 0].transpose(1, 2).reshape(L, T, H * hd).contiguous()
    v = cache.v[:, 0].transpose(1, 2).reshape(L, T, H * hd).contiguous()
    return k, v


def decode_trunk_plain(params: Dict[str, Any], hidden: torch.Tensor, k_flat: torch.Tensor,
                       v_flat: torch.Tensor, position: int, attention_mask: torch.Tensor,
                       heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the residual stream, LayerNorm, softmax and
    every product in fp32 from the stored weights; the new K/V rows are
    written into k_flat/v_flat at `position` in place.  Attends over slots
    [0, position] under the additive mask, as gpt2.decode_step does over the
    whole cache (slots past `position` are masked there)."""
    blocks = params["blocks"]
    L, T, D = k_flat.shape
    hd = D // heads
    pos = int(position)
    x = hidden.reshape(1, D).float()
    bias = torch.where(attention_mask.reshape(T)[: pos + 1] != 0, 0.0, NEG_INF).float()
    f = lambda t, l: t[l].float()  # noqa: E731
    for l in range(L):
        h = layer_norm(x, f(blocks["ln_1"]["scale"], l), f(blocks["ln_1"]["bias"], l))
        qkv = h @ f(blocks["attn"]["qkv_w"], l) + f(blocks["attn"]["qkv_b"], l)
        q, k, v = qkv.split(D, dim=-1)
        k_flat[l, pos] = k[0].to(k_flat.dtype)
        v_flat[l, pos] = v[0].to(v_flat.dtype)
        kk = k_flat[l, : pos + 1].float().view(pos + 1, heads, hd)
        vv = v_flat[l, : pos + 1].float().view(pos + 1, heads, hd)
        scores = torch.einsum("hd,thd->ht", q.view(heads, hd), kk) / math.sqrt(hd) + bias
        ctx = torch.einsum("ht,thd->hd", torch.softmax(scores, dim=-1), vv).reshape(1, D)
        x = x + ctx @ f(blocks["attn"]["proj_w"], l) + f(blocks["attn"]["proj_b"], l)
        h = layer_norm(x, f(blocks["ln_2"]["scale"], l), f(blocks["ln_2"]["bias"], l))
        m = gelu_new(h @ f(blocks["mlp"]["fc_w"], l) + f(blocks["mlp"]["fc_b"], l))
        x = x + m @ f(blocks["mlp"]["proj_w"], l) + f(blocks["mlp"]["proj_b"], l)
    return x.to(hidden.dtype).view(1, 1, D), k_flat, v_flat


def fused_decode_trunk_flat(params: Dict[str, Any], hidden: torch.Tensor,
                            k_flat: torch.Tensor, v_flat: torch.Tensor, position: int,
                            attention_mask: torch.Tensor, heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of one row over the flat cache.

    hidden [1, 1, D]; k_flat, v_flat [L, T, D]; position: the slot of this
    token (0 <= position < T, any T >= 1); attention_mask [1, T] with 1 on
    every valid slot including `position`.  Returns (trunk hidden before
    ln_f [1, 1, D], k_flat, v_flat): the new K/V rows are written into the
    given cache tensors IN PLACE.  On CUDA: bf16 or fp32, one type for
    weights, cache and hidden; head_dim 64; D a multiple of 16."""
    if hidden.device.type == "cpu":
        return decode_trunk_plain(params, hidden, k_flat, v_flat, position,
                                  attention_mask, heads)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_decode_trunk_flat: unsupported device {hidden.device}")
    blocks = params["blocks"]
    L, T, D = k_flat.shape
    dtype = hidden.dtype
    weights = [blocks[a][b] for a, b in _WEIGHTS]
    mask = attention_mask.reshape(T).to(torch.int32).contiguous()
    tensors = [hidden, k_flat, v_flat, mask, *weights]
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_decode_trunk_flat: unsupported type {dtype}")
    if any(t.dtype != dtype for t in [k_flat, v_flat, *weights]):
        raise ValueError("weights, cache and hidden must share one type")
    if any(t.device != hidden.device or not t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous and on hidden's device")
    if D // heads != 64 or D % 16 or hidden.numel() != D or not 0 <= int(position) < T:
        raise ValueError(f"unsupported shape: D={D} heads={heads} T={T} "
                         f"position={int(position)}")
    lib = _build.load()
    out = torch.empty_like(hidden)
    scratch = torch.empty(lib.decode_trunk_scratch_floats(D, heads, T),
                          dtype=torch.float32, device=hidden.device)
    rc = lib.decode_trunk_step(
        int(dtype == torch.bfloat16), hidden.data_ptr(), out.data_ptr(), k_flat.data_ptr(),
        v_flat.data_ptr(), mask.data_ptr(), int(position), L, D, heads, T,
        *[w.data_ptr() for w in weights], scratch.data_ptr(),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check(lib, rc, "decode_trunk_step")
    fused_decode_trunk_flat.launches += 1
    return out, k_flat, v_flat


fused_decode_trunk_flat.launches = 0
