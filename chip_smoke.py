#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the hand-written kernels from the sources in this
   checkout (ops/cuda/_build.py).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both with CUDA events after
   warm-up: the kernel as the replay of a CUDA graph of its launches (device
   time, `ms`) and as eager calls (host launch cost included, `eager_ms`),
   the plain version as eager calls.  fp32 checks run with TF32 off.  The
   decode-trunk check also runs the plain version on planted faults (a mask
   ignored, a cache chunk dropped), which must land beyond its tolerance.
3. Runs the main path on a small fp32 model twice, on the card (kernels)
   and on the CPU (plain versions), and holds the wavs together.
4. Synthesizes three requests through `IndexTTS.infer(..., num_beams=1,
   do_sample=True)` at the full flagship width with random weights from a
   fixed seed, and checks the wavs (int16, code_len * 1024 samples) and that
   the main path launched the kernels (K1 109 times per vocode, K2 once per
   decode step).
5. Prints a `{"kernels": [...]}` line, the card line, and as the last line
   `{"ok": true, "device": {...}}`.  Any failed check exits non-zero before
   that line.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
N_CODES = 256               # a 200-code sentence, bucketed to 64 codes
K1_FLOPS_PER_ELEM = 56      # 24 FMAs (up) + 24 (down) as flops, 8 for the two snakes
SMALL_MODEL = {             # 2 layers, width 128, head width 64; BigVGAN at 64 channels
    "gpt": {"model_dim": 128, "layers": 2, "heads": 2, "max_mel_tokens": 64,
            "max_text_tokens": 120,
            "condition_module": {"output_size": 64, "linear_units": 128,
                                 "attention_heads": 4, "num_blocks": 2}},
    "bigvgan": {"upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "speaker_embedding_dim": 8,
                "gpt_dim": 128},
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, arg_sets, iters: int, graph: bool = True) -> float:
    """Mean ms per call over `iters` calls cycling through `arg_sets`, timed
    with CUDA events after warm-up.  graph=True captures the calls in a CUDA
    graph and times its replay: the device's time, without the host's launch
    cost; graph=False times eager calls, host launch cost included."""
    import torch

    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, err: float, tol: float, **extra) -> None:
    ok = err <= tol
    emit({"check": name, "max_abs_err": err, "tol": tol, "ok": ok, **extra})
    if not ok:
        raise SmokeFailure(f"{name}: max|diff| {err} > tol {tol}")


def kernel_checks_anti_alias(torch, filters, k1):
    """K1 at the six stage shapes of a 200-code sentence, bf16 and fp32, plus
    a ragged T and a T < 16.  Returns its kernels-line entry (bf16 timings
    summed over one vocode: 18 calls per stage plus activation_post)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    C0, rates = 1536, [4, 4, 4, 4, 2, 2]
    stages, T = [], N_CODES
    for i, u in enumerate(rates):
        T *= u
        stages.append((C0 // 2 ** (i + 1), T))
    shapes = stages + [(96, 1003), (24, 7)]
    per_call = {}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for C, T in shapes:
            elt = torch.tensor([], dtype=dtype).element_size()
            nbytes = C * T * elt
            n_sets = max(2, min(64, math.ceil(100e6 / nbytes)))  # rotate past the L2
            sets = []
            for _ in range(n_sets):
                x = torch.randn(1, C, T, generator=g, device="cuda").to(dtype)
                a = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
                b = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
                sets.append((x, a, b))
            x, a, b = sets[0]
            y = k1(x, a, b)
            ref = filters.anti_aliased_activation(x, a, b)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # bf16: one ulp of the largest output (both round an fp32 sum);
            # fp32: summation order only
            tol = scale * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5 * max(1.0, scale)
            iters = max(20, n_sets)
            ms = cuda_ms(k1, sets, iters)
            eager_ms = cuda_ms(k1, sets, iters, graph=False)
            plain_ms = cuda_ms(filters.anti_aliased_activation, sets, max(5, iters // 4),
                               graph=False)
            bytes_moved = 2 * nbytes + 2 * C * elt
            bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
            bound_ops = K1_FLOPS_PER_ELEM * C * T / FP32_FLOPS * 1e3
            check(f"K1 anti_alias {str(dtype)[6:]} C={C} T={T}", err, tol, ms=ms,
                  eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
                  bound_by="bytes" if bound_bytes >= bound_ops else "operations")
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
                per_call[(C, T)] = (ms, plain_ms, bound_bytes, bound_ops, eager_ms)
    # one vocode: 18 activations per stage, plus activation_post at the last shape
    counts = {s: 18 for s in stages}
    counts[stages[-1]] += 1
    total = lambda j: sum(n * per_call[s][j] for s, n in counts.items())  # noqa: E731
    bb, bo = total(2), total(3)
    return {"name": "fused_anti_alias_activation", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/anti_alias.cu",
            "replaces": "indextts_tpu/ops/pallas/anti_alias.py:242",
            "max_abs_err": max_err, "tolerance": "1 bf16 ulp of max|plain| per shape",
            "ms": total(0), "eager_ms": total(4), "plain_ms": total(1),
            "bound_ms": max(bb, bo),
            "bound_by": "bytes" if bb >= bo else "operations", "library_ms": None,
            "per": f"one bf16 vocode of {N_CODES} codes: 109 calls over 6 shapes"}


def decode_inputs(torch, gpt2, L: int, D: int, H: int, T: int, device, dtype):
    """Random trunk weights and cache under which every part of the step
    shows in its output.  GPT-2's init scales the residual projections by
    1/sqrt(2L), so each layer would add ~0.004 to a hidden state of ~0.5 and
    the output would be mostly the input passed through: here they get the
    std 0.02 of the other matrices.  LayerNorms and biases are perturbed, and
    the keys have std 4, so that each head's softmax picks out a few slots
    and a slot read wrongly (or a mask hole ignored) moves the output."""
    g = torch.Generator(device=device).manual_seed(1)
    params = gpt2.init_gpt2_params(gpt2.GPT2Size(L, D, H), g, dtype, device)
    blocks = params["blocks"]
    for grp in blocks.values():
        for key, t in grp.items():
            if key in ("scale", "bias") or key.endswith("_b"):
                t.add_((0.1 * torch.randn(t.shape, generator=g, device=device)).to(dtype))
    for grp in (blocks["attn"], blocks["mlp"]):
        w = grp["proj_w"]
        w.copy_((0.02 * torch.randn(w.shape, generator=g, device=device)).to(dtype))
    k0 = (4 * torch.randn(L, T, D, generator=g, device=device)).to(dtype)
    v0 = torch.randn(L, T, D, generator=g, device=device).to(dtype)
    hidden = (0.5 * torch.randn(1, 1, D, generator=g, device=device)).to(dtype)
    return params, k0, v0, hidden


def decode_masks(torch, T: int, pos: int, holes: bool, device):
    """The step's mask, and planted faults the check must see: the slots of
    the first 64-slot chunk dropped, and (with holes) the holes ignored."""
    mask = torch.zeros(1, T, dtype=torch.int32, device=device)
    mask[0, : pos + 1] = 1
    if holes:  # left padding of the text prompt, and a hole further on
        mask[0, 32:45] = 0
        mask[0, 300:333] = 0
    faults = {"first chunk dropped": mask.clone()}
    faults["first chunk dropped"][0, : min(64, pos)] = 0
    if holes:
        faults["holes ignored"] = mask.clone()
        faults["holes ignored"][0, : pos + 1] = 1
    return mask, faults


def kernel_checks_decode(torch, gpt2, decode_layer):
    """K2 at full width (24 layers, 1280 wide, 20 heads, T = 768) in the
    first 64-slot chunk, a later one, and with mask holes: bf16 weights and
    cache (the working type) at all three, fp32 with mask holes.  Each check
    also runs the plain version on planted faults, which must land beyond
    the tolerance.  Returns its kernels-line entry (bf16, later chunk)."""
    L, D, H, T = 24, 1280, 20, 768
    k2 = decode_layer.fused_decode_trunk_flat
    plain = decode_layer.decode_trunk_plain
    entry, max_err = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        params, k0, v0, hidden = decode_inputs(torch, gpt2, L, D, H, T, "cuda", dtype)
        cases = ((("first chunk", 40, False), ("later chunk", 700, False))
                 if dtype == torch.bfloat16 else ()) + (("mask holes", 500, True),)
        for label, pos, holes in cases:
            mask, faults = decode_masks(torch, T, pos, holes, "cuda")
            out, kk, vv = k2(params, hidden, k0.clone(), v0.clone(), pos, mask, H)
            ref, rk, rv = plain(params, hidden, k0.clone(), v0.clone(), pos, mask, H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            row_err = max((kk[:, pos].float() - rk[:, pos].float()).abs().max().item(),
                          (vv[:, pos].float() - rv[:, pos].float()).abs().max().item())
            row_scale = max(rk[:, pos].float().abs().max().item(),
                            rv[:, pos].float().abs().max().item())
            scale = ref.float().abs().max().item()
            if dtype == torch.bfloat16:
                # both round one fp32 sum to bf16: one ulp of the largest value
                tol, row_tol = scale * 2.0 ** -7, row_scale * 2.0 ** -7
            else:
                # fp32 sums in another order, through 24 layers
                tol, row_tol = 1e-4 * max(1.0, scale), 1e-5 * max(1.0, row_scale)
            fault_err = {}
            for name, fmask in faults.items():
                fref, _, _ = plain(params, hidden, k0.clone(), v0.clone(), pos, fmask, H)
                fault_err[name] = (fref.float() - ref.float()).abs().max().item()
                if fault_err[name] <= tol:
                    raise SmokeFailure(f"K2 {label}: a planted fault ({name}) moves the "
                                       f"output by {fault_err[name]}, within tol {tol}")
            timing = {}
            if dtype == torch.bfloat16:
                kc, vc = k0.clone(), v0.clone()
                args = [(params, hidden, kc, vc, pos, mask, H)]
                timing = {"ms": cuda_ms(k2, args, 20),
                          "eager_ms": cuda_ms(k2, args, 20, graph=False),
                          "plain_ms": cuda_ms(plain, args, 3, graph=False)}
                live = int(mask[0, : pos + 1].sum().item())
                weight_bytes = sum(t.numel() * t.element_size()
                                   for grp in params["blocks"].values() for t in grp.values())
                # weights once, the cache rows in [0, pos] once, mask, hidden
                # in/out, the new K/V rows written
                nbytes = (weight_bytes + 2 * L * (pos + 1) * D * 2 + (pos + 1) * 4 + 4 * D
                          + 4 * L * D)
                flops = 2 * 12 * D * D * L + 4 * live * D * L
                bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound_ops = flops / FP32_FLOPS * 1e3
                timing["bound_ms"] = max(bound_bytes, bound_ops)
                timing["bound_by"] = "bytes" if bound_bytes >= bound_ops else "operations"
                max_err = max(max_err, err)
            name = f"K2 decode_trunk {str(dtype)[6:]} {label} pos={pos}"
            check(name, err, tol, layers_add=(ref.float() - hidden.float()).abs().max().item(),
                  planted_fault_err=fault_err, **timing)
            check(f"K2 new K/V rows {str(dtype)[6:]} {label} pos={pos}", row_err, row_tol)
            for new, old in ((kk, k0), (vv, v0)):  # only slot pos may change
                new[:, pos] = old[:, pos]
                if not torch.equal(new, old):
                    raise SmokeFailure(f"K2 {label}: cache changed outside slot {pos}")
            if dtype == torch.bfloat16 and label == "later chunk":
                entry = {"name": "fused_decode_trunk_flat", "route": "cuda",
                         "source": "indextts_tpu_torch/csrc/decode_layer.cu",
                         "replaces": "indextts_tpu/ops/pallas/decode_layer.py:272",
                         **timing, "library_ms": None,
                         "per": f"one decode step, 24x1280 bf16, T={T}, position {pos}"}
        del params, k0, v0
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max_err
    entry["tolerance"] = "1 bf16 ulp of max|plain| per position"
    return entry


def write_prompt(path: str, seconds: float = 3.0, sr: int = 24000) -> None:
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 330 * t)
    x = x + 0.02 * rng.standard_normal(t.shape)
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def small_agreement(torch, engine_mod, prompt: str, device: str = "cuda") -> None:
    """The main path on `device` (the kernels) against the same path on the
    CPU (the plain versions), in fp32 on a small model with the flagship's
    head width of 64: equal greedy code lengths, and wavs within 4 int16
    steps (sums run in other orders; the int16 cast truncates)."""
    import numpy as np
    from indextts_tpu_torch.config import Config

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_numpy(v) for v in tree]
        return tree.float().cpu().numpy()

    kw = dict(config=Config.from_dict(SMALL_MODEL),
              model_dir=os.path.join(HERE, "checkpoints_test"),
              precision_config={"gpt": "fp32", "vocoder": "fp32"}, seed=0)
    ref = engine_mod.IndexTTS(device="cpu", **kw)
    dut = engine_mod.IndexTTS(device=device, **kw)
    dut.load_numpy_params(to_numpy(ref.gpt_params), to_numpy(ref.bigvgan_params))
    gen = dict(num_beams=1, do_sample=False, max_mel_tokens=24)
    _, want = ref.infer(prompt, "你好，欢迎使用语音合成。", None, **gen)
    _, got = dut.infer(prompt, "你好，欢迎使用语音合成。", None, **gen)
    if ref.last_stats["code_lens"] != dut.last_stats["code_lens"]:
        raise SmokeFailure(f"small model: code lengths {dut.last_stats['code_lens']} on "
                           f"{device}, {ref.last_stats['code_lens']} on the CPU")
    err = float(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    check(f"main path fp32 small model, {device} kernels vs CPU plain", err, 4.0,
          samples=int(got.shape[0]), code_lens=dut.last_stats["code_lens"])


def end_to_end(torch, engine_mod, k1, k2, prompt: str):
    """Three requests through IndexTTS.infer at full width.  Returns the
    launch counts of the run."""
    import numpy as np
    from scipy.io import wavfile

    out_dir = os.path.dirname(prompt)
    t0 = time.perf_counter()
    tts = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                              device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "engine_init", "s": time.perf_counter() - t0,
          "gpt_layers": tts.cfg.gpt.layers, "model_dim": tts.cfg.gpt.model_dim,
          "heads": tts.cfg.gpt.heads,
          "bigvgan_channels": tts.cfg.bigvgan.upsample_initial_channel,
          "gpt_dtype": str(tts.gpt_dtype), "vocoder_dtype": str(tts.vocoder_dtype)})
    requests = [
        ("short", "你好，欢迎使用语音合成。", 120),
        ("long", "The quick brown fox jumps over the lazy dog while the morning sun rises "
                 "slowly above the quiet hills, and the old farmer walks along the river to "
                 "check on his sheep before the long day begins.", 120),
        ("two_sentences", "The quick brown fox jumps over the lazy dog while the morning sun "
                          "rises slowly above the quiet hills. In the afternoon the children "
                          "come home from school and play in the garden until dinner.", 40),
    ]
    k1.launches = 0
    k2.launches = 0
    for i, (name, text, max_tokens) in enumerate(requests):
        before = (k1.launches, k2.launches)
        torch.cuda.reset_peak_memory_stats()
        out = os.path.join(out_dir, f"{name}.wav")
        tts.infer(prompt, text, out, max_text_tokens_per_sentence=max_tokens,
                  num_beams=1, do_sample=True, seed=100 + i)
        s = tts.last_stats
        sr, wav = wavfile.read(out)
        n_sent = len(s["code_lens"])
        expect = sum(s["code_lens"]) * 1024
        d1, d2 = k1.launches - before[0], k2.launches - before[1]
        emit({"request": name, "sentences": n_sent, "code_lens": s["code_lens"],
              "samples": int(wav.shape[0]), "sample_rate": sr, "rtf": s["rtf"],
              "total_s": s["total_s"], "wav_seconds": s["wav_seconds"],
              "decode_steps": s["decode_steps"],
              "decode_tokens_per_s": s["decode_steps"] / s["gpt_gen_time"],
              "gpt_gen_s": s["gpt_gen_time"], "gpt_forward_s": s["gpt_forward_time"],
              "vocoder_s": s["bigvgan_time"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "k1_launches": d1, "k2_launches": d2})
        if wav.dtype != np.int16 or wav.shape[0] != expect or sr != 24000:
            raise SmokeFailure(f"{name}: wav {wav.dtype} {wav.shape} sr {sr}, "
                               f"expected int16 of {expect} samples at 24000")
        if n_sent != (2 if name == "two_sentences" else 1):
            raise SmokeFailure(f"{name}: {n_sent} sentences")
        if d1 != 109 * n_sent or d2 != s["decode_steps"] or d2 == 0:
            raise SmokeFailure(f"{name}: K1 launched {d1} times for {n_sent} vocodes, "
                               f"K2 {d2} times for {s['decode_steps']} decode steps")
    return {"fused_anti_alias_activation": k1.launches,
            "fused_decode_trunk_flat": k2.launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.ops import filters
    from indextts_tpu_torch.ops.cuda import _build, decode_layer
    from indextts_tpu_torch.ops.cuda.anti_alias import fused_anti_alias_activation as k1

    t_start = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "s": time.perf_counter() - t0, "lib": str(_build.LIB_PATH)})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = [kernel_checks_anti_alias(torch, filters, k1),
               kernel_checks_decode(torch, gpt2, decode_layer)]

    out_dir = os.path.join(HERE, "_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    prompt = os.path.join(out_dir, "prompt.wav")
    write_prompt(prompt)
    small_agreement(torch, engine_mod, prompt)
    launches = end_to_end(torch, engine_mod, k1, decode_layer.fused_decode_trunk_flat, prompt)
    for e in entries:
        e["launches"] = launches[e["name"]]
        if e["launches"] == 0:
            raise SmokeFailure(f"{e['name']} was not launched on the main path")
    emit({"phase": "done", "s": time.perf_counter() - t_start})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
