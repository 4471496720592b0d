"""Single-card entry of the port (counterpart of __graft_entry__.entry): the
teacher-forced UnifiedVoice forward at the flagship config (24 layers,
width 1280, 20 heads, bf16, random weights from seed 0).

    python -m indextts_tpu_torch.tools.entry [--device cuda]

`entry()` returns ``(fn, args)``: ``fn(*args)`` gives the text and mel
losses of a batch of 2 rows (64 text tokens and 128 codes, the second row
half as long).  Running the module calls ``fn`` once on the device and
prints the losses, whether they are finite, and the seconds the call took
as one JSON line.  The data-parallel dry run (`dryrun_multichip`) waits
for training across cards (ROADMAP A14b).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.tools import _common


def entry(device: Optional[str] = None, cfg: Optional[GPTConfig] = None):
    """(fn, example_args): the teacher-forced forward step on the flagship
    UnifiedVoice model at the shipped config, its inputs on `device` (the
    card by default)."""
    dev = _common.device_of(device or "cuda")
    cfg = cfg or GPTConfig()
    params = _common.random_gpt(cfg, dev, torch.bfloat16, 0)

    B, Tt, Tm = 2, 64, 128
    rng = np.random.default_rng(0)
    cond_latent = torch.as_tensor(
        rng.standard_normal((B, cfg.condition_num_latent, cfg.model_dim)),
        dtype=torch.bfloat16, device=dev)
    text_ids = torch.as_tensor(rng.integers(2, cfg.number_text_tokens, (B, Tt)), device=dev)
    text_lengths = torch.as_tensor([Tt, Tt // 2], device=dev)
    mel_codes = torch.as_tensor(rng.integers(0, cfg.number_mel_codes - 2, (B, Tm)), device=dev)
    codes_lengths = torch.as_tensor([Tm, Tm // 2], device=dev)

    def fn(params, cond_latent, text_ids, text_lengths, mel_codes, codes_lengths):
        out = uv.train_forward(params, cfg, cond_latent, text_ids, text_lengths,
                               mel_codes, codes_lengths)
        return out["loss_text"], out["loss_mel"]

    return fn, (params, cond_latent, text_ids, text_lengths, mel_codes, codes_lengths)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized model: checks the entry, not the card")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    tiny = GPTConfig.from_dict({**_common.TINY_MODEL["gpt"], "max_mel_tokens": 128})
    fn, fargs = entry(args.device, tiny if args.tiny else None)
    device = fargs[1].device
    _common.sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_text, loss_mel = (float(x) for x in fn(*fargs))
    _common.sync(device)
    return _common.emit({"metric": "entry_forward", "loss_text": loss_text,
                         "loss_mel": loss_mel,
                         "finite": math.isfinite(loss_text) and math.isfinite(loss_mel),
                         "s": time.perf_counter() - t0, "device": _common.card(device)})


if __name__ == "__main__":
    main()
