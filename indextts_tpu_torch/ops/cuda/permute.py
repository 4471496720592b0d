"""Beam-parent reorder of the suffix KV cache: wrapper of the hand-written
CUDA kernel in `csrc/permute.cu` (counterpart of the TPU kernel
indextts_tpu/ops/pallas/permute.py::permute_cache_rows).

out[l, n] = in[l, rows[n]] for K and V [L, N, H, T, hd] in one launch, a
copy bound by device memory bandwidth.  Beam decode runs it once per step
under `reorder="pallas"` (models/unified_voice.inference_speech_beam).  The
plain version, `permute_cache_rows_plain`, is `index_select` on dim 1; the
wrapper takes it only for tensors on the CPU.  For CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from indextts_tpu_torch.ops.cuda import _build


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """A one-byte (fp8) tensor viewed as uint8, which every torch op takes;
    other types as they are."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def permute_cache_rows_plain(k: torch.Tensor, v: torch.Tensor, rows: torch.Tensor,
                             out_k: Optional[torch.Tensor] = None,
                             out_v: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k[:, rows], v[:, rows]), into out_k/out_v when given: index_select on
    dim 1 (an fp8 cache through its uint8 view)."""
    rows = rows.long()
    if out_k is None:
        return (as_bits(k).index_select(1, rows).view(k.dtype),
                as_bits(v).index_select(1, rows).view(v.dtype))
    torch.index_select(as_bits(k), 1, rows, out=as_bits(out_k))
    torch.index_select(as_bits(v), 1, rows, out=as_bits(out_v))
    return out_k, out_v


def permute_cache_rows(k: torch.Tensor, v: torch.Tensor, rows: torch.Tensor,
                       out_k: Optional[torch.Tensor] = None,
                       out_v: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k[:, rows], v[:, rows]) for k, v [L, N, H, T, hd] and rows [N] on the
    cache's device, each in [0, N) (not checked: that needs a host sync).

    The result goes into out_k/out_v when given (new tensors otherwise),
    which must not overlap k and v: rows need not be a permutation.  On
    CUDA: k, v and the outputs contiguous and of one shape and type, with
    H * hd * itemsize a multiple of 16 bytes."""
    if k.device.type == "cpu":
        return permute_cache_rows_plain(k, v, rows, out_k, out_v)
    if k.device.type != "cuda":
        raise ValueError(f"permute_cache_rows: unsupported device {k.device}")
    if out_k is None:
        out_k, out_v = torch.empty_like(k), torch.empty_like(v)
    L, N, H, T, hd = k.shape
    tensors = (k, v, out_k, out_v)
    if any(t.shape != k.shape or t.dtype != k.dtype or t.device != k.device
           or not t.is_contiguous() for t in tensors):
        raise ValueError("k, v and the outputs must be contiguous, of one shape, type "
                         "and device")
    if (H * hd * k.element_size()) % 16:
        raise ValueError(f"H*hd*itemsize = {H * hd * k.element_size()} bytes is not a "
                         "multiple of 16")
    if len({t.data_ptr() for t in tensors}) != 4:
        raise ValueError("the outputs must be other buffers than k and v")
    if rows.shape != (N,) or rows.device != k.device:
        raise ValueError(f"rows {tuple(rows.shape)} on {rows.device}: expected ({N},) on "
                         f"{k.device}")
    rows = rows.to(torch.int32).contiguous()
    lib = _build.load()
    rc = lib.permute_cache_rows(k.data_ptr(), v.data_ptr(), out_k.data_ptr(),
                                out_v.data_ptr(), rows.data_ptr(), L, N,
                                H * T * hd * k.element_size(),
                                torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(lib, rc, "permute_cache_rows")
    permute_cache_rows.launches += 1
    return out_k, out_v


permute_cache_rows.launches = 0
