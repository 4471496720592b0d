#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the hand-written kernels from the sources in this
   checkout (ops/cuda/_build.py).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, and times both with CUDA events after
   warm-up: the kernel as the replay of a CUDA graph of its launches (device
   time, `ms`) and as eager calls (host launch cost included, `eager_ms`),
   the plain version as eager calls.  fp32 checks run with TF32 off.
   - K1, the anti-alias activation, at the six vocoder stage shapes (timed,
     with each stage's share of its bound in `per_shape`), at the same six
     shapes for an infer_fast bucket of 4 rows (timed, `per_shape_b4`), and
     at the split
     points of its design (odd T at B > 1, T from 1 to 17, T beside a
     thread's outputs, a block step and a multi-step block run, rows at an
     odd address), with planted faults the tolerance must see (a halo
     dropped, the edge clamp lost).  Then a profile of one flagship bf16
     vocode: K1's device time, the convolutions', the rest, the device's
     idle share and the K1 wrapper's host time per call.
   - K2, the decode trunk, on each tier: bf16 weights, int8, fused int4, and
     bf16 weights over an fp8 cache, with planted faults the tolerance must
     see (mask faults; int4 nibbles swapped; int4 MLP group scales on the
     wrong chunk; int8 scales dropped), and the kernel's fp8 conversion
     against torch's cast, bit for bit, with the attention path's 16-byte
     fp8 decoding on all 256 codes.  Each timed tier also prints its
     per-kernel device breakdown (torch.profiler) and launches per call.
   - K3, the beam-cache row permute, bit-exact against index_select (also
     timed: `library_ms`) at the flagship beam-3 suffix in bf16 and fp8.
   - K4, the continuous pool's step, at S = 64 and S = 8 pool rows (T = 768)
     on bf16 weights over a bf16 cache and int8 weights over an e4m3 cache,
     and fp32 at width 128, with planted faults (a position off by one, two
     masks swapped, int8 scales dropped) and a masked row that must stay
     finite; timed beside the plain torch `decode_step_rows`, with the
     per-kernel breakdown of one step; and the determinism check: one row's
     output and new K/V rows bit-equal alone (S = 1), among 7 others (S = 8)
     and among 63 others (S = 64), in other slots, on both tiers.
   - `sample_token` with its shortlist in JAX's tie order (a stable sort)
     timed against the same call on `torch.topk` and on two exact
     shortlists built on it, at [1, 8194] and [4, 8194] bf16-rounded logits.
3. Greedy beam-3 decode at full width under reorder="pallas" (K3) and
   reorder="full" (index_select): the codes must be equal, and K3 must
   launch once per step.
4. Runs the main paths on a small fp32 model twice, on the card (kernels)
   and on the CPU (plain versions), and holds codes and wavs together:
   sampling and default beam decode, int8 and int4 weights, `infer_fast` at
   bucket size 4 on five sentences (num_beams=1 and beam-3) and one guided
   request (cfg_scale 3); and the continuous pool through K4 with staged refill, whose greedy codes must
   equal the CPU pool's, single-row decode's and the card's pool without K4.
5. Synthesizes requests through `IndexTTS.infer` at the full flagship width
   with random weights from a fixed seed: PR 1's three sampling requests;
   one with no generation arguments (beam-3 sampling, the reference
   default); one with an fp8 KV cache; one guided (cfg_scale 3: two rows,
   no K2); one each on int8 and int4 engines; one default-beam request on
   the int8 engine.  Through `infer_fast` (buckets of 4, 100 tokens a
   sentence) a five-sentence text in buckets of 4 and 1 rows, at the
   defaults (beam-3; its RTF beside default_beam3's) and at num_beams=1
   sampling (K2 exactly for the single-row bucket's steps).  An
   `infer_stream` request whose chunks must be bit-equal to the
   two_sentences request's wav.  Checks the wavs (int16, code_len * 1024
   samples) and each path's kernel launches (K1 109 times per vocode, K2
   once per single-row decode step, none on beam or guided paths).  Then
   `serve()` without --continuous: /tts with no mode (infer_fast, beam-3)
   and /tts_stream, each a 24 kHz int16 wav, K1 109 times a vocoder call.
6. Serves concurrent HTTP requests at the full width through `serve()` with
   the continuous pool on K4 (8 slots), on the bf16 engine and on the int8
   engine (e4m3 cache): every response a 24 kHz int16 wav, K4 once per pool
   step, K1 109 times per vocoder call, and a seeded request's codes the same
   alone and among seven others; a profile of two 16-step ticks of the full
   pool.
7. Reference checkpoints and the beam pool:
   - a full-width engine writes gpt.pth (bf16, with speaker data) and
     bigvgan_generator.pth (fp32) with the port's exporter, and a second
     engine loads that directory: greedy codes equal and wavs bit-equal
     (K2 and K1 counted), and a speaker_id request with no prompt answers
     a wav; file sizes, load seconds and peak device memory printed;
   - the beam pool on the small fp32 model, on the card and on the CPU:
     greedy, sampled (the dedicated decode fed the pool's draws) and
     staggered admission, each group's codes equal to the dedicated beam-3
     decode's, and the card's to the CPU's;
   - `serve(continuous=True)` with a 4-group beam pool at full width: six
     concurrent reference-default beam-3 requests, each a 24 kHz int16 wav
     (K1 109 times a vocoder call, no other kernel); per-request latency,
     pool steps/s and audio seconds per wall second beside default_beam3's;
     a 16-step profile of the pool's step; the full-width greedy agreement
     of a pool group with the dedicated decode (reported, not gated);
   - /model/reload onto that gpt.pth while serving: the next request runs
     on the loaded weights after `IndexTTS.warmup`, and the card's
     allocated memory is within 10% of what one engine held before.
8. The DVAE and extraction slice (`indextts_tpu_torch/data/extract.py`,
   `models/dvae.py`, `train/dvae.py`, every conditioning type), which
   reaches none of the kernels (their counts stay 0 through it):
   - small fp32 models on the card and on the CPU from the same .pth files:
     extraction of 2 speakers x 6 clips (manifests and speaker_info.json
     byte-equal, mels within 1e-4, the medoid conditioning within 1e-4
     relative, codes equal wherever the CPU's two nearest codebook columns
     are more than 1e-4 apart, at most 1% exempt), a planted fault (the most
     used codebook column swapped with the least used) that must part the codes,
     three DVAE train steps (metrics within 1e-5 relative, codebooks within
     1e-5) and get_conditioning of the four condition types (1e-4);
   - at full width, random weights from fixed seeds written as gpt.pth and
     dvae.pth: extraction of 2 speakers x 24 clips of 1-15 s at batch 16
     (clips/s, audio s per wall s, each stage's ms a batch, peak memory,
     distinct codes, decode and .npy-write seconds); 40 DVAE train steps at
     the DVAETrainConfig defaults (step ms, windows/s, peak memory, a
     model-FLOPs share of the fp32 peak, a profile of one step); the trained
     weights through dvae.pth into a second extraction, and the LoRA
     Trainer for 4 micro-steps on the extracted manifests;
     get_conditioning of each type on a 10 s mel (ms a call).
9. Vocoder fine-tuning (`indextts_tpu_torch/train/vocoder.py`,
   `models/discriminators.py`), where every generator activation runs K1
   forward and K1b (`csrc/anti_alias_backward.cu`) backward:
   - K1b against its plain version in fp32 at the six stage shapes of a
     training step (batch 8, 24 codes; timed, graph replay and eager, with
     the plain backward and the plan the wrapper chose) and at each T of
     K1B_EDGE_TS (short, odd and ragged rows) with logscale on and off,
     under the card's plan and two forced ones (3 steps a segment; the
     scalar path); two runs bit-equal; a planted fault (grad_alpha without
     its logscale factor) rejected; a bf16 input refused;
   - one GAN step on the small fp32 generator on the card and on the CPU:
     every gradient leaf before the optimizer, conv_pre's and the latent's
     non-zero and equal (fault C6), then the whole step's metrics and
     parameters;
   - at full width (1536 channels, batch 8, 24 codes, fp32, TF32 off) 20
     steps on synthetic batches (step ms, samples/s, peak memory, K1 and
     K1b launches a step, a model-FLOPs share of the fp32 peak, a profile
     of one step) and 3 steps through the CLI over the extraction output
     of phase 8 with its full-width GPT, under `python -m
     torch.distributed.run --nproc_per_node 1` (an NCCL world of one, K1
     and K1b counted in the rank); the checkpoint loads back equal;
     the CLI's trained generator through bigvgan_generator.pth into an engine:
     one request, K1 109 times a vocode and K1b never, its vocoder output
     bit-equal to the in-memory generator's, the speaker similarity of its
     wav to the prompt.
10. LoRA fine-tuning (`indextts_tpu_torch/train/`):
   - the small fp32 model on the card and on the CPU: three optimizer
     updates at gradient_accumulation_steps=2 with the clip firing, the
     adapters within 1e-5 of each other after every micro-step; a NaN base
     weight leaves adapters, optimizer state and step bit-equal on the card;
     a Trainer's epochs 0 and 1 straight through equal epoch 0, a new
     Trainer, try_resume and epoch 1 (within 1e-6);
   - at full width (bf16 base) a Trainer at the TrainConfig defaults but
     epochs=2 and max_steps_per_epoch=32 over synthetic manifests in the
     extraction layout (two speakers, 256 train and 8 valid clips): every
     loss finite, every artifact written; it prints the micro-step's median
     ms, the optimizer update's ms, target tokens per second, the batch
     widths, peak device memory, a model-FLOPs share and a profile of one
     micro-step (device busy share, device ops, top ops);
   - learning: one micro-batch of 8 with codes from 64 values, lr 1e-3, 20
     updates, the mel loss after at most 0.9 of the first;
   - engines on the trained gpt_finetuned.pth and on the merged directory
     model_epoch_1: equal greedy codes for a 200-code request, qkv_w equal
     to the bf16 merge bit for bit, a speaker_id request with no prompt
     answers a wav; K2 once a decode step and K1 109 times a vocode.
11. The tools and front ends (`indextts_tpu_torch/tools/`, `verify.py`,
   `serve/webui.py`, `serve/api.py`, `utils/profiling.py`), after every
   phase above and over the directories their trainers wrote:
   - fault C7: `Config.load` of checkpoints_test/config.yaml with `import
     yaml` failing, its values checked, and the CLI's documented command
     (`--model_dir checkpoints_test`, `--num_beams 1`) as a subprocess
     writing a wav;
   - every bench tool through its `main(argv)` at full width and short
     settings, each printing its JSON line: `bench` at 1 and 8 rows,
     `bench_e2e` at beam 1 and at beam 3 `--long` (`infer_fast` included),
     `bench_pool` plain and on K4 and `--e2e` on K4, `bench_beam_step`
     (lineage and K3), `bench_beam_pool`, `bench_pool_trunk` (rows, flat
     and K4 at S = 8 and 64); each launching the kernel it exists for;
   - `export_pth` on phase 8's `dvae_step_40`, phase 9's `vocoder_step_3`
     and phase 10's `model_epoch_1`: each file tensor-equal to io/export's
     for the same tree, and the extractor's codes, the served wav and the
     fine-tuned engine's greedy codes bit-equal to the in-memory routes;
   - `verify_weights --dry-run` (the 11-case battery on the card),
     `eval_quality --self-test`, the WebUI's callbacks over a card engine,
     one `infer` under `device_trace` and `annotate` (the trace holds the
     name and K2's kernels), the flagship forward of `tools.entry`, and
     `serve.api` (its ImportError without FastAPI; with it, `create_app`
     answering /health and /tts).
12. Prints a `{"kernels": [...]}` line (K1 with `per_shape`, each stage's
   ms and share of its bound; K1b per training step with `per_shape`; K2
   and K4 one entry per tier, with
   `launches_per_call` and `gbytes_per_s`); before it, on a line of its
   own, the previous design's K2 and K4 times as PERF.md records them
   (quoted, not measured in the run); the card line, and as the last line
   `{"ok": true, "device": {...}}`.  Any failed
   check exits non-zero before that line.  Without CUDA it exits non-zero
   at once.

    python3 chip_smoke.py --dp 4

runs only the multi-card checks on a machine with four cards:
1. `create_batcher(dp=4)`, one pool per card through K4, against one
   pool's greedy codes on a small fp32 model (`tools.entry.pool_group_check`);
2. the three trainers at full width, each rank a process on its own card
   (NCCL; `parallel/multihost.run_ranks` over `dp_rank_report`): one step
   of world 4 against world 1 (rank 0 alone) on the same global batch,
   losses and reduced gradients within DP_TOL (LoRA on an fp32 base with
   ranks of ragged lengths, each padded to its own widths; the mean of the
   ranks' own-count losses, the planted fault, must miss by more); then,
   with the check's tensors released, timed steps at world 4 and at world
   1 on a rank's rows (step ms, samples/s or target tokens/s, the
   all-reduces' ms a step by CUDA events from their launch and from every
   rank's arrival, peak memory a rank), the ranks' parameters bit-equal by
   an all-gathered checksum, and for the vocoder `train_vocoder` at world
   4 with K1 and K1b counted on every rank;
3. the LoRA Trainer's and the DVAE's CLIs unchanged under
   `torch.distributed.run --nproc_per_node 4` on the small model;
4. `tools.entry.dryrun_multichip(4)`: the toy step over 4 NCCL ranks
   against one card, the pool group, and the toy trunk's forward and
   greedy decode over 2 tensor-parallel ranks against one (`tp_check`);
5. tensor-parallel serving (`tensor_parallel`), the flagship on random
   weights drawn on the CPU, rank 0 starting its followers itself:
   - K3 bit-exact against its plain version on the head shards tensor
     parallelism gives it, [24, 3, 10, 640, 64] and [24, 3, 5, 640, 64],
     bf16 and fp8;
   - fp32, TF32 off, at tp = 2 (cards 0-1) and tp = 4 against one card's
     eager decodes on the same weights: greedy 64 codes, equal up to the
     first step whose one-card top-2 logit margin is below TP_EPS, with the
     step-0 logits' max |delta|; and greedy beam-3 under reorder="pallas"
     (K3 once a step on every rank) against one card's lineage decode,
     equal unless one card's decode met a near tie (a gap below TP_EPS
     among a step's 7 best candidates); the rules stated before the run;
   - at tp = 4, bf16, `infer` at the default beam-3, a sampling `infer`
     (its RTF), a guided `infer`, an `infer_fast` of two buckets, an
     `infer_stream` and a beam-3 decode under reorder="pallas" (the
     engine's own options, through its `_on_ranks`), each with every
     rank's counts at 0 just before it and read just after (the counters
     read on each rank by `tp_rank_counts`): 48 all-reduces a decode step
     and a re-forward, K1 109 times a vocode on rank 0 alone, K3 once a
     step on every rank under "pallas", K2 and K4 never, a launches line a
     rank; every rank's codes equal to rank 0's (checked in each call);
     each rank's weights its shard of the same tree by checksum, its trunk
     bytes 1/4 of the whole; peak memory a rank;
   - ms a decode step (one sampling row; beam-3) at tp = 1 (the row also
     through K2), 2 and 4, and the all-reduces' ms a step by CUDA events
     (`tp_rank_time_all_reduces`);
   - `TTSService(tp=4)` answering two concurrent /tts requests over a
     socket, and the CLI with `--tp 2` as a command;
   - in a process of its own, bounded: a tp = 2 engine whose follower is
     stopped mid-decode (it hangs) and then one whose follower is killed,
     rank 0 raising within its deadline each time (`tp_faults`);
then the card line and the last line.  `--dp 4 --only-tp` runs phase 5
alone.  Any failed check, or a rank that
dies or outlives its limit, exits non-zero before that line.
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
BF16_FLOPS = 989e12         # H100 SXM bf16 on the tensor cores, dense
N_CODES = 256               # a 200-code sentence, bucketed to 64 codes
K1_PER_VOCODE = 109         # anti-aliased activations in one flagship vocode
K1_FLOPS_PER_ELEM = 56      # 24 FMAs (up) + 24 (down) as flops, 8 for the two snakes
# the previous design's graph-replay times, quoted from PERF.md on a line of
# their own: no run of this script measures them
EARLIER_MS = {"fused_decode_trunk_flat[bf16]": 1.48, "fused_decode_trunk_flat[int8]": 1.44,
              "fused_decode_trunk_flat[int4]": 2.09, "fused_decode_trunk_flat[fp8_cache]": 1.56,
              "fused_pool_step[bf16] S=8": 4.28, "fused_pool_step[bf16] S=64": 11.38,
              "fused_pool_step[int8_fp8cache] S=8": 4.38,
              "fused_pool_step[int8_fp8cache] S=64": 11.67,
              "anti_alias_activation_backward": 5.804}   # K1b's first design, a training step
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


def kernel_breakdown(torch, label: str, fn, args) -> int:
    """Device time per kernel name over one call of `fn(*args)` under
    torch.profiler, printed on one line with the launches per call.
    Returns the launches per call."""
    from torch.profiler import ProfilerActivity, profile

    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):   # a trace that came back without device events is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if dev(e) > 0]
        if kernels:
            break
    else:
        raise SmokeFailure(f"{label}: three profiles with no device time")
    launches = sum(e.count for e in kernels)
    emit({"phase": f"{label} device breakdown", "launches_per_call": launches,
          "device_ms": sum(dev(e) for e in kernels) / 1e3,
          "per_kernel": {e.key[:90]: {"ms": dev(e) / 1e3, "launches": e.count}
                         for e in sorted(kernels, key=dev, reverse=True)}})
    return launches


def peak_flops(torch, dtype) -> float:
    """The card's peak rate for products whose operands are `dtype`, the
    type the TPU kernel multiplies in: bf16 on the tensor cores, fp32
    outside them."""
    return BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS


def kernel_events(torch, events) -> list:
    """The device kernels among a profile's averaged events.  A CPU op's
    `self_device_time_total` repeats the time of the kernels it launched,
    so a sum over every event counts each such kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and (e.self_device_time_total or 0) > 0]


def check(name: str, err: float, tol: float, **extra) -> None:
    ok = err <= tol
    emit({"check": name, "max_abs_err": err, "tol": tol, "ok": ok, **extra})
    if not ok:
        raise SmokeFailure(f"{name}: max|diff| {err} > tol {tol}")


def k1_stage_shapes():
    """(C, T) of K1's calls at the six BigVGAN stages of one flagship vocode
    of N_CODES codes."""
    C0, rates = 1536, [4, 4, 4, 4, 2, 2]
    stages, T = [], N_CODES
    for i, u in enumerate(rates):
        T *= u
        stages.append((C0 // 2 ** (i + 1), T))
    return stages


def k1_vocode_calls(stages):
    """K1's calls per stage in one vocode: 18 activations per stage (three
    AMP blocks of six), plus activation_post at the last stage's shape."""
    counts = {s: 18 for s in stages}
    counts[stages[-1]] += 1
    return counts


def k1_input_sets(torch, g, B: int, C: int, T: int, dtype):
    """Input sets (x, alpha, beta) for K1 at [B, C, T], enough of them to
    rotate past the 50 MB L2 when timed."""
    nbytes = B * C * T * torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(max(2, min(64, math.ceil(100e6 / nbytes)))):
        x = torch.randn(B, C, T, generator=g, device="cuda").to(dtype)
        a = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        b = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
        sets.append((x, a, b))
    return sets


def vocode_profile(torch, label: str) -> dict:
    """Where one flagship bf16 vocode of N_CODES codes spends its time
    (random weights from a fixed seed): the eager wall ms of a vocode, the
    device time of K1 (summed over its launches), of the convolutions (every
    kernel that is neither K1 nor PyTorch's own `at::native` kernels) and of
    the other ops under torch.profiler, the device's idle share of the
    profiled vocode, and the K1 wrapper's host µs per eager call (2000 calls
    on a tiny input).  Prints and returns them."""
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.models import bigvgan
    from indextts_tpu_torch.ops.cuda.anti_alias import fused_anti_alias_activation as k1

    cfg = BigVGANConfig()
    g = torch.Generator(device="cuda").manual_seed(5)
    params = bigvgan.init_params(cfg, g, torch.bfloat16, "cuda")
    latent = torch.randn(1, N_CODES, cfg.gpt_dim, generator=g, device="cuda").bfloat16()
    mel = torch.randn(1, 300, cfg.num_mels, generator=g, device="cuda").bfloat16()
    run = lambda: bigvgan.forward(params, latent, mel, cfg)  # noqa: E731
    with torch.no_grad():
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
        for _ in range(3):   # a trace that came back without device events is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages() if dev(e) > 0]
            if kernels:
                break
        else:
            raise SmokeFailure(f"{label}: three profiles with no device time")
        groups = {"K1": [], "convolutions": [], "other": []}
        for e in kernels:
            key = ("K1" if "anti_alias" in e.key else
                   "other" if "at::native" in e.key else "convolutions")
            groups[key].append(e)
        busy = sum(dev(e) for e in kernels) / 1e3
        x = torch.randn(1, 24, 8, generator=g, device="cuda").bfloat16()
        a = torch.zeros(24, device="cuda", dtype=torch.bfloat16)
        k1(x, a, a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            k1(x, a, a)
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    out = {"phase": f"vocode profile {label}", "codes": N_CODES, "samples": N_CODES * 1024,
           "eager_wall_ms": walls, "profiled_wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall,
           "wrapper_host_us_per_eager_call": host_us}
    for key, evs in groups.items():
        out[f"{key}_device_ms"] = sum(dev(e) for e in evs) / 1e3
        out[f"{key}_launches"] = sum(e.count for e in evs)
        out[f"{key}_top"] = {e.key[:80]: dev(e) / 1e3
                             for e in sorted(evs, key=dev, reverse=True)[:4]}
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


def k1_faults(torch, filters, x, a, b, piece: int) -> dict:
    """The plain version with a planted fault, where the shape can show it:
    (i) "halo dropped", each row computed in independent pieces of `piece`
    outputs, each padded by replicate; (ii) "edge clamp lost", the first and
    last three outputs taken from the interior formula over replicate-padded
    x (the padding's own pairs activated, not the clamped activated signal)."""
    import torch.nn.functional as F

    T = x.shape[-1]
    faults = {}
    if T > piece:
        faults["halo dropped"] = torch.cat(
            [filters.anti_aliased_activation(x[..., s:s + piece], a, b)
             for s in range(0, T, piece)], dim=-1)
    if T >= 2:
        xp = F.pad(x.float(), (6, 6), mode="replicate").to(x.dtype)
        faults["edge clamp lost"] = filters.anti_aliased_activation(xp, a, b)[..., 6:-6]
    return faults


def k1_run_shapes(plan, dtype) -> list:
    """[B, C, T] shapes whose T is 1 and 8 below and above twice a block's
    run (block_step x steps, steps >= 2) as the kernel plans that very call:
    the ragged last step of a multi-step block, on the scalar path (odd T)
    and the 16-byte path.  Found by search over C, since the plan follows the
    card's resident blocks."""
    step = plan(1, 16, 1024, dtype)["block_step"]
    for C in range(16, 4096, 8):
        for steps in (2, 3, 4):
            shapes = []
            for d in (-8, -1, 1, 8):
                run = steps * step
                p = plan(1, C, 2 * run + d, dtype)
                if p["steps"] == steps and p["steps"] * p["block_step"] == run:
                    shapes.append((1, C, 2 * run + d))
            if len(shapes) == 4:
                return shapes
    raise SmokeFailure("K1: no shape found whose T is beside twice a multi-step block run")


def kernel_checks_anti_alias(torch, filters, k1, plan):
    """K1 against its plain version, bf16 and fp32: at the six stage shapes of
    a 256-code vocode, a ragged T and a T < 16 (all timed), in bf16 also at
    the six stage shapes of an infer_fast bucket of 4 rows (timed), and at the split
    points of its design (checked only): B = 3 and 2 with odd T, T from 1 to
    17 and at a thread's outputs and one either side, T one below and above
    a block step, T beside twice a multi-step block run, and rows at an odd
    address (the scalar path at an aligned T).  Each planted fault (halo
    dropped, edge clamp lost) must land beyond the tolerance wherever the
    shape can show it (the edge fault in fp32: in bf16 it stays under one
    ulp).  Returns its kernels-line entry: bf16 timings summed over one
    vocode (18 calls per stage plus activation_post), per stage its ms and
    share of the bound, and the same for a 4-row vocode (`per_shape_b4`)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    stages = k1_stage_shapes()
    timed = [(1, C, T) for C, T in stages] + [(1, 96, 1003), (1, 24, 7)]
    bucket = [(4, C, T) for C, T in stages]        # one vocode of a 4-row bucket
    per_call = {}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.tensor([], dtype=dtype).element_size()
        first = plan(1, 24, 1024, dtype)
        V, step = first["outputs_per_thread"], first["block_step"]
        checked = [(3, 24, 1003), (2, 96, 4097)] + [
            (2, 24, T) for T in sorted({1, 2, 3, 5, 8, 9, 15, 17, V - 1, V, V + 1})]
        checked += [(1, 48, step - 1), (1, 48, step + 1)] + k1_run_shapes(plan, dtype)
        checked += [("odd address", 2, 24, 1024)]
        for shape in timed + (bucket if dtype == torch.bfloat16 else []) + checked:
            if shape[0] == "odd address":   # contiguous rows at an odd element offset
                _, B, C, T = shape
                flat = torch.randn(B * C * T + 1, generator=g, device="cuda").to(dtype)
                x = flat[1:].view(B, C, T)
                a = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
                sets = [(x, a, a.flip(0).contiguous())]
            else:
                B, C, T = shape
                sets = k1_input_sets(torch, g, B, C, T, dtype)
            x, a, b = sets[0]
            p = plan(B, C, T, dtype, aligned=x.data_ptr() % 16 == 0)
            y = k1(x, a, b)
            ref = filters.anti_aliased_activation(x, a, b)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # bf16: one ulp of the largest output (both round an fp32 sum);
            # fp32: summation order only
            tol = scale * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5 * max(1.0, scale)
            pieces = [n for n in (p["block_step"] * p["steps"], p["block_step"],
                                  32 * p["outputs_per_thread"]) if n < T]
            fault_err = {}
            for name, fy in k1_faults(torch, filters, x, a, b,
                                      pieces[0] if pieces else T).items():
                fault_err[name] = (fy.float() - ref.float()).abs().max().item()
                # the edge fault moves the first and last three outputs by a
                # few thousandths of the scale, under one bf16 ulp: the fp32
                # run (the same kernel code) must see it, the bf16 run reports it
                must_show = dtype == torch.float32 or name == "halo dropped"
                if must_show and fault_err[name] <= tol:
                    raise SmokeFailure(f"K1 {str(dtype)[6:]} {shape}: a planted fault ({name}) "
                                       f"moves the output by {fault_err[name]}, within tol {tol}")
            timing = {}
            if shape in timed or shape in bucket:
                iters = max(20, len(sets))
                nbytes = B * C * T * elt
                bytes_moved = 2 * nbytes + 2 * C * elt
                bb = bytes_moved / HBM_BYTES_PER_S * 1e3
                bo = K1_FLOPS_PER_ELEM * B * C * T / FP32_FLOPS * 1e3
                timing = {"ms": cuda_ms(k1, sets, iters),
                          "eager_ms": cuda_ms(k1, sets, iters, graph=False),
                          "plain_ms": cuda_ms(filters.anti_aliased_activation, sets,
                                              max(5, iters // 4), graph=False),
                          "bound_ms": max(bb, bo),
                          "bound_by": "bytes" if bb >= bo else "operations"}
                if dtype == torch.bfloat16:
                    per_call[(B, C, T)] = {**timing, "bound_bytes_ms": bb,
                                           "bound_ops_ms": bo, "steps": p["steps"],
                                           "blocks": p["blocks"]}
            check(f"K1 anti_alias {str(dtype)[6:]} B={B} C={C} T={T}"
                  + (" odd address" if shape[0] == "odd address" else ""), err, tol,
                  plan=p, planted_fault_err=fault_err, **timing)
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
            del sets
    counts = k1_vocode_calls(stages)

    def total(key, B=1):
        return sum(n * per_call[(B,) + s][key] for s, n in counts.items())

    def stage_table(B):
        return {f"C={C} T={T}": {
            "ms": per_call[(B, C, T)]["ms"], "bound_us": per_call[(B, C, T)]["bound_ms"] * 1e3,
            "share_of_bound": per_call[(B, C, T)]["bound_ms"] / per_call[(B, C, T)]["ms"],
            "calls_per_vocode": counts[(C, T)], "steps": per_call[(B, C, T)]["steps"],
            "blocks": per_call[(B, C, T)]["blocks"]} for C, T in stages}

    bb, bo = total("bound_bytes_ms"), total("bound_ops_ms")
    bb4, bo4 = total("bound_bytes_ms", 4), total("bound_ops_ms", 4)
    per_shape = stage_table(1)
    per_shape_b4 = {"per_vocode": {"ms": total("ms", 4), "plain_ms": total("plain_ms", 4),
                                   "bound_ms": max(bb4, bo4),
                                   "share_of_bound": max(bb4, bo4) / total("ms", 4)},
                    **stage_table(4)}
    return {"name": "fused_anti_alias_activation", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/anti_alias.cu",
            "replaces": "indextts_tpu/ops/pallas/anti_alias.py:242",
            "max_abs_err": max_err, "tolerance": "1 bf16 ulp of max|plain| per shape",
            "ms": total("ms"), "eager_ms": total("eager_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bb, bo),
            "bound_by": "bytes" if bb >= bo else "operations", "library_ms": None,
            "per": f"one bf16 vocode of {N_CODES} codes: 109 calls over 6 shapes",
            "per_shape": per_shape, "per_shape_b4": per_shape_b4}


def sampling_shortlist_timing(torch, sampling) -> None:
    """The cost of JAX's tie order in sampling.  `sample_token` takes its
    shortlist by a stable descending sort of the row (`sampling._top_k`);
    the same call is timed with three other shortlists: `torch.topk` (no
    order among ties: the cost to beat), and two exact ones built on it,
    `topk_reorder` (the top k + 16, then two small stable sorts into value
    descending, index ascending order; exact while fewer than 17 values tie
    at the k-th, checked on these inputs) and `int64_key` (each float's
    order-preserving int32 in the high word, the reversed index in the low
    word, one `torch.topk`).  At [1, 8194] and [4, 8194] bf16-rounded logits
    with planted ties; eager calls as the decode loop makes them, in turns
    (a b c d d c b a, 500 calls a turn), and each shortlist alone in graph
    replay (device time).  The exact ones must equal the sort."""
    g = torch.Generator(device="cuda").manual_seed(3)
    V, k, pad = 8194, 30, 16
    rev = (V - 1 - torch.arange(V, device="cuda")).to(torch.int64)

    def topk_reorder(x, kk):
        vals, idx = torch.topk(x, kk + pad, dim=-1)
        idx, perm = torch.sort(idx, dim=-1)
        vals, perm = torch.sort(vals.gather(-1, perm), dim=-1, descending=True, stable=True)
        return vals[..., :kk], idx.gather(-1, perm)[..., :kk]

    def int64_key(x, kk):
        b = x.view(torch.int32)
        _, idx = torch.topk(((b ^ ((b >> 31) & 0x7FFFFFFF)).to(torch.int64) << 32) | rev, kk,
                            dim=-1)
        return x.gather(-1, idx), idx

    shipped = sampling._top_k
    variants = {"sort": shipped, "topk": lambda x, kk: torch.topk(x, kk, dim=-1),
                "topk_reorder": topk_reorder, "int64_key": int64_key}
    out = {"phase": "sampling shortlist: sample_token's stable sort vs other shortlists",
           "V": V, "top_k": k}
    for B in (1, 4):
        x = (3 * torch.randn(B, V, generator=g, device="cuda")).bfloat16().float()
        x[:, [5, 4000, 7000]] = x.max(-1, keepdim=True).values      # planted ties
        want = shipped(x, k)
        if not torch.equal(want[0], torch.topk(x, k).values) or \
                int((x >= want[0][:, -1:]).sum(-1).max()) > k + pad:
            raise SmokeFailure(f"sampling shortlist at B={B}: values differ from torch.topk, "
                               "or too many ties at the k-th for topk_reorder")
        for name in ("topk_reorder", "int64_key"):
            got = variants[name](x, k)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise SmokeFailure(f"sampling shortlist {name} differs from the sort at B={B}")
        token = {n: [] for n in variants}
        for name in list(variants) + list(variants)[::-1]:
            sampling._top_k = variants[name]
            try:
                token[name].append(cuda_ms(lambda v: sampling.sample_token(
                    v, top_k=k, top_p=0.8, generator=g), [(x,)], 500, graph=False))
            finally:
                sampling._top_k = shipped
        out[f"B={B}"] = {"sample_token_eager_ms": token,
                         "sort_extra_ms": min(token["sort"]) - min(token["topk"]),
                         "shortlist_graph_ms": {n: cuda_ms(f, [(x, k)], 100)
                                                for n, f in variants.items()}}
    emit(out)


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


def trunk_bytes_flops(params, L: int, D: int, pos: int, live: int, cache_itemsize: int):
    """Bytes a decode step must move (every weight and scale once, the cache
    rows and mask in [0, pos] once, bf16 hidden in/out, the new K/V rows
    written) and its flops (the products, and attention over the live
    slots)."""
    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return t.numel() * t.element_size()

    weight_bytes = nbytes(params["blocks"])
    moved = (weight_bytes + 2 * L * (pos + 1) * D * cache_itemsize + (pos + 1) * 4 + 4 * D
             + 2 * L * D * cache_itemsize)
    flops = 2 * 12 * D * D * L + 4 * live * D * L
    return moved, flops, weight_bytes


def swap_nibbles(torch, q4):
    """Planted fault: each packed int4 byte with its two nibbles swapped."""
    b = q4.to(torch.int32) & 0xFF
    return (((b << 4) | (b >> 4)) & 0xFF).to(torch.uint8).view(torch.int8)


def fp8_conversion_check(torch, _build):
    """K2's fp8 conversion (f32 -> e4m3 -> f32) against torch's cast, bit for
    bit: keys of std 4, and a sweep through the subnormal range."""
    lib = _build.load()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.cat([4 * torch.randn(1 << 20, generator=g, device="cuda"),
                   torch.linspace(-0.03, 0.03, 8193, device="cuda"),
                   torch.tensor([0.0, -0.0, 448.0, -448.0, 2.0 ** -9, 2.0 ** -10],
                                device="cuda")])
    bits = torch.empty(x.numel(), dtype=torch.uint8, device="cuda")
    back = torch.empty_like(x)
    rc = lib.fp8_e4m3_roundtrip(x.data_ptr(), bits.data_ptr(), back.data_ptr(), x.numel(),
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fp8_e4m3_roundtrip")
    ref = x.to(torch.float8_e4m3fn)
    torch.cuda.synchronize()
    mismatched = int((bits != ref.view(torch.uint8)).sum().item())
    back_err = (back - ref.float()).abs().max().item()
    over = torch.tensor([500.0], device="cuda").to(torch.float8_e4m3fn).float().item()
    emit({"check": "K2 fp8 e4m3 conversion vs torch cast", "values": int(x.numel()),
          "max_abs": x.abs().max().item(), "bits_mismatched": mismatched,
          "upcast_max_abs_err": back_err, "ok": mismatched == 0 and back_err == 0.0,
          "torch_cast_of_500": str(over)})
    if mismatched or back_err:
        raise SmokeFailure(f"fp8 conversion: {mismatched} bytes differ from torch's cast, "
                           f"upcast error {back_err}")
    # the attention path decodes 16 codes a 16-byte word: all 256 codes,
    # against torch's upcast value for value (NaN where torch gives NaN)
    codes = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
    got = torch.empty(256, dtype=torch.float32, device="cuda")
    rc = lib.fp8_e4m3_unpack16(codes.data_ptr(), got.data_ptr(), 16,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "fp8_e4m3_unpack16")
    want = codes.view(torch.float8_e4m3fn).float()
    torch.cuda.synchronize()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    differ = int((~same).sum().item())
    emit({"check": "K2/K4 attention fp8 e4m3 decode vs torch cast, all 256 codes",
          "codes": 256, "nan_codes": int(torch.isnan(want).sum().item()),
          "codes_differing": differ, "ok": differ == 0})
    if differ:
        raise SmokeFailure(f"fp8 decode of the attention path: {differ} of 256 codes differ")


def kernel_checks_decode(torch, gpt2, decode_layer, quantization):
    """K2 at full width (24 layers, 1280 wide, 20 heads, T = 768) on each
    tier: bf16 activations with bf16 weights and cache (the working type),
    int8 weights, fused int4 weights, and bf16 weights over an fp8 cache, at
    positions 40 (the first 64-slot chunk), 700 and 500 with mask holes,
    within 1 bf16 ulp of max|plain|; and fp32 with mask holes.  Each check
    also runs the plain version on planted faults, which must land beyond
    the tolerance.  Returns the bf16-activation tiers' kernels-line entries
    (timed at position 700)."""
    L, D, H, T = 24, 1280, 20, 768
    k2 = decode_layer.fused_decode_trunk_flat
    plain = decode_layer.decode_trunk_plain
    entries = []
    for dtype in (torch.bfloat16, torch.float32):
        params, k0, v0, hidden = decode_inputs(torch, gpt2, L, D, H, T, "cuda", dtype)
        if dtype == torch.bfloat16:
            tiers = {
                "bf16": (params, False),
                "int8": (quantization.quantize_gpt_params({"gpt": params}, bits=8)["gpt"],
                         False),
                "int4": (quantization.quantize_gpt_params({"gpt": params}, bits=4)["gpt"],
                         False),
                "fp8_cache": (params, True),
            }
        else:
            tiers = {"fp32": (params, False)}
        entries += decode_tier_checks(torch, k2, plain, quantization, tiers, hidden, k0, v0)
        del params, tiers, k0, v0
        torch.cuda.empty_cache()
    return entries


def decode_tier_checks(torch, k2, plain, quantization, tiers, hidden, k0, v0):
    """K2 against its plain version on each of `tiers` (name -> (trunk
    params, fp8 cache?)) over one hidden state and cache; fp32 only with
    mask holes.  Returns the kernels-line entries of the bf16 tiers."""
    L, T, D = k0.shape
    H = D // 64
    fp32 = hidden.dtype == torch.float32
    entries = []
    for tier, (tp, fp8) in tiers.items():
        kc0 = k0.to(torch.float8_e4m3fn) if fp8 else k0
        vc0 = v0.to(torch.float8_e4m3fn) if fp8 else v0
        blocks = tp["blocks"]
        weight_faults = {}
        if tier == "int8":
            weight_faults["scales dropped"] = {**blocks, "attn": {
                **blocks["attn"], "qkv_w": {"q": blocks["attn"]["qkv_w"]["q"],
                                            "s": torch.ones_like(blocks["attn"]["qkv_w"]["s"])}}}
        if tier == "int4":
            mp = blocks["mlp"]["proj_w"]
            weight_faults["nibbles swapped"] = {**blocks, "mlp": {**blocks["mlp"], "proj_w": {
                "q4": swap_nibbles(torch, mp["q4"]), "s": mp["s"]}}}
            rolled = mp["s"].reshape(L, quantization.MLP_PROJ_GROUPS, 2, D).roll(1, dims=1)
            weight_faults["mlp group scales on the wrong chunk"] = {**blocks, "mlp": {
                **blocks["mlp"], "proj_w": {"q4": mp["q4"], "s": rolled.reshape(mp["s"].shape)
                                            .contiguous()}}}
        max_err = 0.0
        cases = (() if fp32 else (("first chunk", 40, False), ("later chunk", 700, False))) \
            + (("mask holes", 500, True),)
        for label, pos, holes in cases:
            mask, mask_faults = decode_masks(torch, T, pos, holes, "cuda")
            out, kk, vv = k2(tp, hidden, kc0.clone(), vc0.clone(), pos, mask, H)
            ref, rk, rv = plain(tp, hidden, kc0.clone(), vc0.clone(), pos, mask, H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            row_err = max((kk[:, pos].float() - rk[:, pos].float()).abs().max().item(),
                          (vv[:, pos].float() - rv[:, pos].float()).abs().max().item())
            row_scale = max(rk[:, pos].float().abs().max().item(),
                            rv[:, pos].float().abs().max().item())
            if fp32:
                # fp32 sums in another order, through 24 layers
                tol, row_tol = 1e-4 * max(1.0, scale), 1e-5 * max(1.0, row_scale)
            else:
                # both round one fp32 sum to bf16: one ulp of the largest
                # value; the new rows within one step of the cache type
                tol = scale * 2.0 ** -7
                row_tol = row_scale * (2.0 ** -3 if fp8 else 2.0 ** -7)
            fault_err = {}
            faults = [(name, tp, fmask) for name, fmask in mask_faults.items()]
            faults += [(name, {**tp, "blocks": fb}, mask) for name, fb in weight_faults.items()]
            for name, fparams, fmask in faults:
                fref, _, _ = plain(fparams, hidden, kc0.clone(), vc0.clone(), pos, fmask, H)
                fault_err[name] = (fref.float() - ref.float()).abs().max().item()
                if fault_err[name] <= tol:
                    raise SmokeFailure(f"K2 {tier} {label}: a planted fault ({name}) moves the "
                                       f"output by {fault_err[name]}, within tol {tol}")
            timing = {}
            if label == "later chunk":   # bf16 activations only
                args = [(tp, hidden, kc0.clone(), vc0.clone(), pos, mask, H)]
                timing = {"ms": cuda_ms(k2, args, 20),
                          "eager_ms": cuda_ms(k2, args, 20, graph=False),
                          "plain_ms": cuda_ms(plain, args, 3, graph=False)}
                live = int(mask[0, : pos + 1].sum().item())
                moved, flops, wbytes = trunk_bytes_flops(tp, L, D, pos, live,
                                                         kc0.element_size())
                bb = moved / HBM_BYTES_PER_S * 1e3
                bo = flops / peak_flops(torch, hidden.dtype) * 1e3
                timing.update(bound_ms=max(bb, bo), bound_by="bytes" if bb >= bo else
                              "operations", weight_bytes=wbytes, bytes_moved=moved,
                              gbytes_per_s=moved / timing["ms"] / 1e6,
                              launches_per_call=kernel_breakdown(
                                  torch, f"K2 {tier} one step, position {pos}", k2, args[0]))
            max_err = max(max_err, err)
            check(f"K2 decode_trunk {tier} {label} pos={pos}", err, tol,
                  layers_add=(ref.float() - hidden.float()).abs().max().item(),
                  planted_fault_err=fault_err, **timing)
            check(f"K2 new K/V rows {tier} {label} pos={pos}", row_err, row_tol)
            for new, old in ((kk, kc0), (vv, vc0)):  # only slot pos may change
                new[:, pos] = old[:, pos]
                if not torch.equal(new.view(torch.uint8) if fp8 else new,
                                   old.view(torch.uint8) if fp8 else old):
                    raise SmokeFailure(f"K2 {tier} {label}: cache changed outside slot {pos}")
            if timing:
                entry = {
                    "name": f"fused_decode_trunk_flat[{tier}]", "route": "cuda",
                    "source": "indextts_tpu_torch/csrc/decode_layer.cu",
                    "replaces": "indextts_tpu/ops/pallas/decode_layer.py:272",
                    **{k: timing[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                              "bound_by", "gbytes_per_s", "launches_per_call")},
                    "library_ms": None,
                    "per": f"one decode step, 24x1280, {tier}, T={T}, position {pos}"}
        if not fp32:
            entries.append({**entry, "max_abs_err": max_err,
                            "tolerance": "1 bf16 ulp of max|plain| per position"})
        del weight_faults
    return entries


def pool_inputs(torch, S: int, T: int, device):
    """Pool-step positions spread over [T/2, T-1] and their masks: left-pad
    holes of 0-5 slots, a hole further on in every third row, and row 1
    masked everywhere (a slot that never held a request), all zero past each
    position."""
    pos = T // 2 + (torch.arange(S, device=device) * 97) % (T // 2)
    slots = torch.arange(T, device=device)
    mask = (slots[None, :] <= pos[:, None]).to(torch.int32)
    for s in range(S):
        mask[s, 2: 2 + s % 6] = 0
        if s % 3 == 0:
            mask[s, T // 4: T // 4 + 17] = 0
    mask[1] = 0
    return pos.to(torch.int32), mask


def pool_bytes_flops(params, L: int, D: int, positions, mask, cache_itemsize: int,
                     act_itemsize: int):
    """Bytes a pool step must move (every weight and scale once, each row's
    cache slots [0, pos] and mask once, hidden in and out, the new K/V rows
    written) and its flops (the products, and attention over the live slots
    of each row)."""
    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return t.numel() * t.element_size()

    S = positions.shape[0]
    slots = int((positions.long() + 1).sum().item())
    weight_bytes = nbytes(params["blocks"])
    moved = (weight_bytes + 2 * L * slots * D * cache_itemsize + slots * 4
             + 2 * S * D * act_itemsize + 2 * L * S * D * cache_itemsize)
    flops = 2 * 12 * D * D * L * S + 4 * slots * D * L
    return moved, flops, weight_bytes


def kernel_checks_pool(torch, gpt2, pool_trunk, quantization):
    """K4 at full width (24 layers, 1280 wide, 20 heads, T = 768) for S = 64
    and S = 8: bf16 weights over a bf16 cache (the bf16 engine's pool) and
    int8 weights over an e4m3 cache (the int8 engine's pool), within 1 bf16
    ulp of max|plain|; fp32 at width 128.  Planted faults (one row's position
    off by one, two rows' masks swapped, int8 scales dropped) must land
    beyond the tolerance, and the masked row must stay finite.  Each tier is
    timed as graph replay and eager calls, with the plain version and the
    plain torch `decode_step_rows` over a head-split cache beside it.
    Returns the two full-width tiers' kernels-line entries (timed at S = 8,
    the served pool's width)."""
    k4 = pool_trunk.fused_pool_step
    plain = pool_trunk.pool_step_plain
    entries = {}
    cases = [(S, T, dt) for S in (64, 8) for T, dt in ((768, torch.bfloat16),)] \
        + [(16, 264, torch.float32)]
    for S, T, dtype in cases:
        L, D = (24, 1280) if dtype == torch.bfloat16 else (2, 128)
        H = D // 64
        params, k0, v0, _ = decode_inputs(torch, gpt2, L, D, H, 8, "cuda", dtype)
        g = torch.Generator(device="cuda").manual_seed(7)
        k0 = (4 * torch.randn(L, S, T, D, generator=g, device="cuda")).to(dtype)
        v0 = torch.randn(L, S, T, D, generator=g, device="cuda").to(dtype)
        hidden = (0.5 * torch.randn(S, D, generator=g, device="cuda")).to(dtype)
        pos, mask = pool_inputs(torch, S, T, "cuda")
        if dtype == torch.bfloat16:
            tiers = {"bf16": (params, False),
                     "int8_fp8cache": (quantization.quantize_gpt_params(
                         {"gpt": params}, bits=8)["gpt"], True)}
        else:
            tiers = {"fp32": (params, False)}
        for tier, (tp, fp8) in tiers.items():
            kc = k0.to(torch.float8_e4m3fn) if fp8 else k0
            vc = v0.to(torch.float8_e4m3fn) if fp8 else v0
            out, kr, vr = k4(tp, hidden, kc, vc, pos, mask, H)
            ref, rk, rv = plain(tp, hidden, kc, vc, pos, mask, H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            row_err = max((kr.float() - rk.float()).abs().max().item(),
                          (vr.float() - rv.float()).abs().max().item())
            row_scale = max(rk.float().abs().max().item(), rv.float().abs().max().item())
            if dtype == torch.float32:
                tol, row_tol = 1e-4 * max(1.0, scale), 1e-5 * max(1.0, row_scale)
            else:   # one bf16 ulp of the largest value; rows within a step of the cache type
                tol = scale * 2.0 ** -7
                row_tol = row_scale * (2.0 ** -3 if fp8 else 2.0 ** -7)
            masked_finite = bool(torch.isfinite(out[1].float()).all().item())
            faults = {}
            off = pos.clone()
            off[0] -= 1
            faults["row 0 position off by one"] = (tp, off, mask)
            swapped = mask.clone()
            swapped[[0, 2]] = mask[[2, 0]]
            faults["masks of rows 0 and 2 swapped"] = (tp, pos, swapped)
            if tier.startswith("int8"):
                b = tp["blocks"]
                faults["int8 scales dropped"] = ({**tp, "blocks": {**b, "attn": {
                    **b["attn"], "qkv_w": {"q": b["attn"]["qkv_w"]["q"],
                                           "s": torch.ones_like(b["attn"]["qkv_w"]["s"])}}}},
                    pos, mask)
            fault_err = {}
            for name, (fp, fpos, fmask) in faults.items():
                fref, _, _ = plain(fp, hidden, kc, vc, fpos, fmask, H)
                fault_err[name] = (fref.float() - ref.float()).abs().max().item()
                if fault_err[name] <= tol:
                    raise SmokeFailure(f"K4 {tier} S={S}: a planted fault ({name}) moves the "
                                       f"output by {fault_err[name]}, within tol {tol}")
            args = [(tp, hidden, kc, vc, pos, mask, H)]
            timing = {"ms": cuda_ms(k4, args, 10), "eager_ms": cuda_ms(k4, args, 10, graph=False),
                      "plain_ms": cuda_ms(plain, args, 2, graph=False)}
            cache5 = gpt2.KVCache(kc.view(L, S, T, H, 64).transpose(2, 3).contiguous(),
                                  vc.view(L, S, T, H, 64).transpose(2, 3).contiguous())
            size = gpt2.GPT2Size(L, D, H)
            timing["decode_step_rows_ms"] = cuda_ms(
                gpt2.decode_step_rows, [(tp, hidden[:, None], cache5, pos, mask, size)], 2,
                graph=False)
            del cache5
            moved, flops, wbytes = pool_bytes_flops(tp, L, D, pos, mask, kc.element_size(),
                                                    hidden.element_size())
            # the bound takes the products at the peak of the TPU kernel's
            # operand type; fp32 FMA time, what this kernel's CUDA-core
            # products would need at best, is a design note beside it
            bb = moved / HBM_BYTES_PER_S * 1e3
            bo = flops / peak_flops(torch, dtype) * 1e3
            timing.update(bound_ms=max(bb, bo), bound_by="bytes" if bb >= bo else "operations",
                          bytes_moved=moved, weight_bytes=wbytes, flops=flops,
                          bytes_bound_ms=bb, ops_bound_ms=bo,
                          gbytes_per_s=moved / timing["ms"] / 1e6)
            if dtype == torch.float32:
                timing["fp32_fma_ms"] = flops / FP32_FLOPS * 1e3
            else:
                timing["launches_per_call"] = kernel_breakdown(
                    torch, f"K4 {tier} one pool step S={S}", k4, args[0])
            if S == 64:
                determinism_across_traffic(torch, k4, tier, tp, hidden, kc, vc, pos, mask, H)
            check(f"K4 pool_step {tier} S={S} T={T}", err, tol, row_err=row_err,
                  row_tol=row_tol, masked_row_finite=masked_finite,
                  layers_add=(ref.float() - hidden.float()).abs().max().item(),
                  planted_fault_err=fault_err, **timing)
            check(f"K4 new K/V rows {tier} S={S}", row_err, row_tol)
            if not masked_finite:
                raise SmokeFailure(f"K4 {tier} S={S}: the all-masked row is not finite")
            if dtype == torch.bfloat16:
                e = entries.setdefault(tier, {
                    "name": f"fused_pool_step[{tier}]", "route": "cuda",
                    "source": "indextts_tpu_torch/csrc/pool_trunk.cu",
                    "replaces": "indextts_tpu/ops/pallas/pool_trunk.py:296",
                    "max_abs_err": 0.0, "library_ms": None,
                    "tolerance": "1 bf16 ulp of max|plain| per pool width"})
                e["max_abs_err"] = max(e["max_abs_err"], err)
                if S == 8:
                    e.update({k: timing[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                     "bound_by", "gbytes_per_s",
                                                     "launches_per_call")})
                    e["per"] = f"one pool step, 24x1280, {tier}, S=8, T={T}, positions [384, 767]"
                else:
                    e["s64"] = {k: timing[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                       "bound_by", "decode_step_rows_ms",
                                                       "gbytes_per_s", "launches_per_call")}
        del params, tiers, k0, v0, kc, vc
        torch.cuda.empty_cache()
    return [entries["bf16"], entries["int8_fp8cache"]]


def determinism_across_traffic(torch, k4, tier, params, hidden, kc, vc, pos, mask, H) -> None:
    """One row's K4 step must be bit-equal run alone (S = 1), among 7 other
    rows (S = 8, in slot 3) and among 63 others (S = 64, in slot 41): its
    hidden output and its new K/V rows.  The row is row 5 of the 64-row
    inputs; the other rows are drawn from the rest."""
    src = 5
    got = {}
    for S, slot in ((1, 0), (8, 3), (64, 41)):
        others = [r for r in range(64) if r != src]
        rows = (others[:slot] + [src] + others[slot: S - 1]) if S < 64 else \
            others[:slot] + [src] + others[slot:]
        idx = torch.tensor(rows, device="cuda")
        out, kr, vr = k4(params, hidden[idx].contiguous(), kc[:, idx].contiguous(),
                         vc[:, idx].contiguous(), pos[idx].contiguous(),
                         mask[idx].contiguous(), H)
        got[S] = [t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
                  for t in (out[slot], kr[:, slot], vr[:, slot])]
    torch.cuda.synchronize()
    equal = {S: all(torch.equal(a, b) for a, b in zip(got[1], got[S])) for S in (8, 64)}
    emit({"check": f"K4 {tier}: one row bit-equal alone, among 7 and among 63 others",
          "row_slots": {"1": 0, "8": 3, "64": 41}, "equal": {str(k): v for k, v in equal.items()},
          "ok": all(equal.values())})
    if not all(equal.values()):
        raise SmokeFailure(f"K4 {tier}: a row's output depends on its traffic: {equal}")


def kernel_checks_permute(torch, permute):
    """K3 bit-exact against index_select at the flagship beam-3 suffix
    [24, 3, 20, 640, 64] in bf16 and fp8 with rows [2, 0, 0], [0, 1, 2] and
    [1, 2, 0], and on a small fp32 cache.  Returns its kernels-line entry
    (bf16, rows [2, 0, 0])."""
    k3 = permute.permute_cache_rows
    plain = permute.permute_cache_rows_plain
    g = torch.Generator(device="cuda").manual_seed(3)
    entry = None
    for dtype, shape in ((torch.bfloat16, (24, 3, 20, 640, 64)),
                         (torch.float8_e4m3fn, (24, 3, 20, 640, 64)),
                         (torch.float32, (2, 3, 4, 64, 16))):
        k = torch.randn(shape, generator=g, device="cuda").to(dtype)
        v = torch.randn(shape, generator=g, device="cuda").to(dtype)
        ok, ek = torch.empty_like(k), torch.empty_like(v)
        for rows_list in ([2, 0, 0], [0, 1, 2], [1, 2, 0]):
            rows = torch.tensor(rows_list, dtype=torch.int32, device="cuda")
            gk, gv = k3(k, v, rows, ok, ek)
            rk, rv = plain(k, v, rows)
            torch.cuda.synchronize()
            as_bytes = lambda t: t.view(torch.uint8)  # noqa: E731  (bit-exact, fp8 too)
            exact = torch.equal(as_bytes(gk), as_bytes(rk)) and torch.equal(as_bytes(gv),
                                                                             as_bytes(rv))
            timing = {}
            if rows_list == [2, 0, 0] and dtype != torch.float32:
                args = [(k, v, rows, ok, ek)]
                nbytes = 4 * k.numel() * k.element_size() + rows.numel() * 4
                timing = {"ms": cuda_ms(k3, args, 20),
                          "eager_ms": cuda_ms(k3, args, 20, graph=False),
                          "plain_ms": cuda_ms(plain, args, 20, graph=False),
                          # the library call: index_select (fp8 through its uint8 view)
                          "library_ms": cuda_ms(
                              lambda a, b, r: (a.index_select(1, r), b.index_select(1, r)),
                              [(permute.as_bits(k), permute.as_bits(v), rows.long())], 20,
                              graph=False),
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "bytes_moved": nbytes}
            name = f"K3 permute {str(dtype)[6:]} {list(shape)} rows={rows_list}"
            check(name, 0.0 if exact else float("inf"), 0.0, **timing)
            if dtype == torch.bfloat16 and rows_list == [2, 0, 0]:
                entry = {"name": "permute_cache_rows", "route": "cuda",
                         "source": "indextts_tpu_torch/csrc/permute.cu",
                         "replaces": "indextts_tpu/ops/pallas/permute.py:31",
                         "max_abs_err": 0.0, "tolerance": "bit-exact", **timing,
                         "per": "one beam step's reorder of the bf16 beam-3 suffix "
                                "[24, 3, 20, 640, 64]"}
        del k, v, ok, ek
    torch.cuda.empty_cache()
    return entry


def text_inputs(tts, text: str):
    """The decode's text tensors for the first sentence of `text`, as the
    engine makes them."""
    import numpy as np

    sent = tts.tokenizer.split_sentences(tts.tokenizer.tokenize(text), 120)[0]
    return tts._text_inputs([np.asarray(tts.tokenizer.convert_tokens_to_ids(sent), np.int32)])


def profile_beam_steps(torch, uv, tts, cond, tokens, mask, kw, steps: int = 40) -> None:
    """Where a beam step's time goes: `steps` greedy beam-3 steps (lineage)
    under torch.profiler.  Prints the wall time per step, the device's busy
    time per step (the sum of CUDA kernel times) and the ops that take the
    most host and device time."""
    from torch.profiler import ProfilerActivity, profile

    run = lambda: uv.inference_speech_beam(  # noqa: E731
        tts.gpt_params_batched, tts.cfg.gpt, cond, tokens, mask, None,
        **{**kw, "max_new": steps + 1})
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    kernels = kernel_events(torch, events)
    busy_us = sum(dev(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    top_dev = sorted(events, key=dev, reverse=True)[:8]
    n = max(r.steps, 1)
    emit({"phase": "beam3 step profile (lineage, bf16, full width)", "steps": r.steps,
          "wall_ms_per_step": wall * 1e3 / n, "device_busy_ms_per_step": busy_us / 1e3 / n,
          "device_busy_share": busy_us / 1e6 / wall if wall else None,
          "device_ops_per_step": launches / n,
          "top_host_ms_per_step": {e.key: e.self_cpu_time_total / 1e3 / n for e in top_host},
          "top_device_ms_per_step": {e.key: dev(e) / 1e3 / n for e in top_dev}})


def beam_reorder_agreement(torch, uv, permute, tts, prompt: str):
    """Greedy beam-3 at full width, bf16, 600 codes: reorder="pallas" (K3
    each step) and reorder="full" (index_select) must give equal codes, and
    K3 must launch once per step.  Returns K3's launches on this path."""
    cond = tts._conditioning(tts._prompt_mel(prompt))
    tokens, mask = text_inputs(tts, "The quick brown fox jumps over the lazy dog while the "
                                    "morning sun rises slowly above the quiet hills.")
    kw = dict(max_new=600, num_beams=3, do_sample=False, cache_dtype=torch.bfloat16)
    results = {}
    launches = 0
    for reorder in ("pallas", "full"):
        permute.permute_cache_rows.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = uv.inference_speech_beam(tts.gpt_params_batched, tts.cfg.gpt, cond, tokens, mask,
                                     None, reorder=reorder, **kw)
        codes = r.codes.cpu()
        dt = time.perf_counter() - t0
        n = permute.permute_cache_rows.launches
        results[reorder] = (codes, int(r.lengths[0]), r.steps)
        emit({"phase": f"beam3 greedy full width reorder={reorder}", "steps": r.steps,
              "code_len": int(r.lengths[0]), "s": dt, "steps_per_s": r.steps / dt,
              "k3_launches": n})
        if reorder == "pallas":
            launches = n
            if n != r.steps or n == 0:
                raise SmokeFailure(f"K3 launched {n} times over {r.steps} beam steps")
        elif n != 0:
            raise SmokeFailure(f"reorder=full launched K3 {n} times")
    profile_beam_steps(torch, uv, tts, cond, tokens, mask, kw)
    if not torch.equal(results["pallas"][0], results["full"][0]):
        diff = int((results["pallas"][0] != results["full"][0]).sum())
        raise SmokeFailure(f"beam codes differ between reorder=pallas and full at {diff} "
                           "positions")
    check("beam3 greedy codes pallas vs full", 0.0, 0.0, code_len=results["pallas"][1],
          steps=results["pallas"][2])
    return launches


def write_prompt(path: str, seconds: float = 3.0, sr: int = 24000) -> None:
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 330 * t)
    x = x + 0.02 * rng.standard_normal(t.shape)
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def small_agreement(torch, engine_mod, prompt: str, device: str = "cuda") -> None:
    """The main paths on `device` (the kernels) against the same paths on the
    CPU (the plain versions), on a small model with the flagship's head width
    of 64, fp32 compute: sampling decode and the default beam-3 decode
    (greedy), int8 and int4 weights (quantization on, fp32 compute) at
    num_beams=1, `infer_fast` at bucket size 4 on five sentences (buckets of
    4 and 1 rows) at num_beams=1 and beam-3, and one guided request
    (cfg_scale 3, two rows through gpt2.decode_step).  Equal codes, and wavs
    within 4 int16 steps (sums run in other orders; the int16 cast
    truncates)."""
    import numpy as np
    from indextts_tpu_torch.config import Config

    base = dict(config=Config.from_dict(SMALL_MODEL),
                model_dir=os.path.join(HERE, "checkpoints_test"), seed=0)
    fp32 = {"gpt": "fp32", "vocoder": "fp32"}
    master = engine_mod.IndexTTS(device="cpu", precision_config=fp32, **base)
    trees = (_to_numpy(master.gpt_params), _to_numpy(master.bigvgan_params))
    greedy = dict(do_sample=False, max_mel_tokens=24)
    one = "你好，欢迎使用语音合成。"
    cases = [("sampling decode", fp32, dict(greedy, num_beams=1), "infer", one),
             ("default beam-3", fp32, greedy, "infer", one)]
    for bits in ("int8", "int4"):
        cases.append((f"{bits} weights", {**fp32, "quantization": {
            "enabled": True, "weight_dtype": bits}}, dict(greedy, num_beams=1), "infer", one))
    for nb in (1, 3):
        cases.append((f"infer_fast buckets of 4, num_beams={nb}", fp32,
                      dict(greedy, num_beams=nb, max_text_tokens_per_sentence=14,
                           sentences_bucket_max_size=4), "infer_fast", SMALL_FIVE))
    cases.append(("guided cfg_scale=3", fp32, dict(greedy, num_beams=1, cfg_scale=3.0),
                  "infer", one))
    for name, precision, gen, method, text in cases:
        ref = engine_mod.IndexTTS(device="cpu", precision_config=precision, **base)
        dut = engine_mod.IndexTTS(device=device, precision_config=precision, **base)
        ref.load_numpy_params(*trees)
        dut.load_numpy_params(*trees)
        _, want = getattr(ref, method)(prompt, text, None, **gen)
        _, got = getattr(dut, method)(prompt, text, None, **gen)
        if method == "infer_fast" and dut.last_stats["buckets"] != [4, 1]:
            raise SmokeFailure(f"small model, {name}: buckets {dut.last_stats['buckets']}")
        rc, dc = ref.last_stats["codes"], dut.last_stats["codes"]
        if len(rc) != len(dc) or any(not np.array_equal(a, b) for a, b in zip(rc, dc)):
            raise SmokeFailure(f"small model, {name}: codes {[c.tolist() for c in dc]} on "
                               f"{device}, {[c.tolist() for c in rc]} on the CPU")
        err = float(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        check(f"main path small model, {name}, {device} kernels vs CPU plain", err, 4.0,
              samples=int(got.shape[0]), code_lens=dut.last_stats["code_lens"])


# five sentences of 13, 13, 9, 13 and 11 tokens at 14 a sentence: buckets of
# 4 and 1 rows at bucket size 4
SMALL_FIVE = "今天天气很好。我们去散步吧。明天再见。谢谢你的帮助。请再说一遍。"
POOL_TEXTS = ["你好，欢迎使用语音合成。", "今天天气很好。", "我们去散步吧。", "The sun rises.",
              "A small dog barks.", "请再说一遍。", "Good morning to you.", "明天见。",
              "It is raining.", "谢谢你的帮助。"]


def pool_small_agreement(torch, engine_mod, pool_trunk, prompt: str) -> None:
    """The continuous pool on a small fp32 model (head width 64): greedy, K4
    each step (`fused_trunk=True`), 4-step ticks with staged refill, ten
    requests through eight slots.  The card's codes must equal the CPU pool's
    (K4's plain version) and each request's single-row decode on the CPU, and
    the card's pool without K4 must give the same codes.  K4 launches once per
    pool step."""
    import numpy as np
    from indextts_tpu_torch.config import Config

    base = dict(config=Config.from_dict(SMALL_MODEL),
                model_dir=os.path.join(HERE, "checkpoints_test"), seed=0,
                precision_config={"gpt": "fp32", "vocoder": "fp32"})
    ref = engine_mod.IndexTTS(device="cpu", **base)
    dut = engine_mod.IndexTTS(device="cuda", **base)
    dut.load_numpy_params(_to_numpy(ref.gpt_params), _to_numpy(ref.bigvgan_params))
    ids = [np.asarray(ref.tokenizer.encode(t), np.int32) for t in POOL_TEXTS]
    kw = dict(num_slots=8, steps_per_tick=4, max_text_width=32, max_new=24, do_sample=False)
    codes = {}
    for name, eng, fused in (("cpu", ref, True), ("cuda", dut, True), ("cuda unfused", dut, False)):
        pool = eng.create_batcher(prompt, fused_trunk=fused, **kw)
        pool_trunk.fused_pool_step.launches = 0
        rids = [pool.submit(x) for x in ids]
        res = pool.run()
        codes[name] = [res[r].tolist() for r in rids]
        if name == "cuda" and pool_trunk.fused_pool_step.launches != pool.step_count:
            raise SmokeFailure(f"small pool: K4 launched {pool_trunk.fused_pool_step.launches} "
                               f"times over {pool.step_count} steps")
    cond = ref._conditioning(ref._prompt_mel(prompt))
    single = []
    for x in ids:
        c, n, _ = ref._decode_bucket(cond, [x], None, dict(num_beams=1, do_sample=False,
                                                           max_mel_tokens=24))
        single.append(c[0, : int(n[0])].tolist())
    lens = [len(c) for c in codes["cuda"]]
    emit({"check": "pool small model: card K4 vs CPU pool vs single decode vs card unfused",
          "requests": len(ids), "code_lens": lens,
          "ok": codes["cuda"] == codes["cpu"] == single == codes["cuda unfused"]})
    for name in ("cpu", "cuda unfused"):
        if codes["cuda"] != codes[name]:
            raise SmokeFailure(f"small pool: card codes {codes['cuda']} != {name} {codes[name]}")
    if codes["cuda"] != single:
        raise SmokeFailure(f"small pool: card codes {codes['cuda']} != single decode {single}")


def pool_group_agreement(torch, engine_mod, prompt: str, dp: int) -> None:
    """`create_batcher(dp=N)`: a PoolGroup of N pools, one per card, on the
    small fp32 model through K4 (8 slots each, 4-step ticks with staged
    refill), held by `tools.entry.pool_group_check`: thirty greedy requests
    must give the codes of one pool on cuda:0, each pool's weights and
    state must sit on its own card, every pool must take work, and K4 must
    launch once per step of each pool."""
    import numpy as np
    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.tools import entry

    eng = engine_mod.IndexTTS(config=Config.from_dict(SMALL_MODEL), device="cuda", seed=0,
                              model_dir=os.path.join(HERE, "checkpoints_test"),
                              precision_config={"gpt": "fp32", "vocoder": "fp32"})
    ids = [np.asarray(eng.tokenizer.encode(t), np.int32) for t in POOL_TEXTS] * 3
    kw = dict(fused_trunk=True, num_slots=8, steps_per_tick=4, max_text_width=32,
              max_new=24, do_sample=False)
    seen = entry.pool_group_check(lambda n: eng.create_batcher(prompt, dp=n, **kw), ids, dp)
    emit({"check": f"pool group: create_batcher(dp={dp}) vs one pool, greedy codes", **seen})
    if not seen["ok"]:
        raise SmokeFailure(f"pool group dp={dp}: {seen}")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.float().cpu().numpy()


def _http(port: int, path: str, body: dict):
    """POST a JSON body; returns (status, headers, bytes, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data, time.perf_counter() - t0


def profile_pool_steps(torch, pool, ids) -> None:
    """Where a pool step's time goes: eight requests fill the 8-slot pool,
    then two 16-step ticks run under torch.profiler.  Prints the wall time
    per step, the device's busy time per step (the sum of CUDA kernel times),
    and the ops that take the most host and device time."""
    from torch.profiler import ProfilerActivity, profile

    for x in ids:
        pool.submit(x, max_new=120)
    pool.step()                                   # admission and the first tick
    torch.cuda.synchronize()
    n0 = pool.step_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pool.step()
        pool.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = max(pool.step_count - n0, 1)
    pool.run()
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    busy_us = sum(dev(e) for e in kernel_events(torch, events))
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    top_dev = sorted(events, key=dev, reverse=True)[:8]
    emit({"phase": "pool step profile (8 slots, K4, bf16, full width)", "steps": n,
          "wall_ms_per_step": wall * 1e3 / n, "device_busy_ms_per_step": busy_us / 1e3 / n,
          "device_busy_share": busy_us / 1e6 / wall if wall else None,
          "top_host_ms_per_step": {e.key: e.self_cpu_time_total / 1e3 / n for e in top_host},
          "top_device_ms_per_step": {e.key: dev(e) / 1e3 / n for e in top_dev}})


def served(torch, engine_mod, httpd, kernels, prompt: str, tier: str):
    """`serve()` at the full flagship width with the continuous pool through
    K4 (`fused_trunk=True`, 8 slots): five concurrent /tts requests (distinct
    texts and seeds, 160-200 codes each) and one /tts_stream.  Checks each
    wav (RIFF, int16, 24 kHz), K4's launches against the pool's steps and K1's
    against the vocoder calls, then drives a pool directly: a seeded sampled
    request gives the same codes alone and among seven others; on the bf16
    engine, two ticks of the full pool run under the profiler.  Returns K4's
    launches on the served path."""
    import threading

    import numpy as np
    from scipy.io import wavfile
    import io

    precision = {"gpt": "int8"} if tier == "int8_fp8cache" else None
    eng = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                              device="cuda", seed=0, precision_config=precision)
    vocodes = [0]
    vocode = eng._vocode

    def counted(*a):
        vocodes[0] += 1
        return vocode(*a)

    eng._vocode = counted
    srv = httpd.serve(None, os.path.join(HERE, "checkpoints_test"), host="127.0.0.1", port=0,
                      engine_instance=eng, continuous=True,
                      pool_kwargs={"fused_trunk": True, "num_slots": 8})
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    reqs = [("/tts", {"text": t, "audio_path": prompt, "seed": 100 + i, "max_mel_tokens": m})
            for i, (t, m) in enumerate(zip(
                [LONG, "你好，欢迎使用语音合成。今天天气很好。", POOL_TEXTS[3], POOL_TEXTS[6],
                 "我们去散步吧。明天见。"], (200, 180, 160, 200, 170)))]
    reqs.append(("/tts_stream", {"text": "谢谢你的帮助。请再说一遍。", "audio_path": prompt,
                                 "seed": 7, "max_mel_tokens": 160}))
    try:
        srv.service.pool()       # build the pool before the clock starts
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results = [None] * len(reqs)
        t0 = time.perf_counter()

        def call(i):
            results[i] = _http(port, *reqs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        pool = srv.service._pool
        launches = {n: k.launches for n, k in kernels.items()}
        steps = pool.step_count
    finally:
        srv.shutdown()
    audio_s = 0.0
    per_request = []
    for (path, body), res in zip(reqs, results):
        if res is None or res[0] != 200:
            raise SmokeFailure(f"served {tier}: {path} seed {body['seed']} answered "
                               f"{None if res is None else (res[0], res[2][:200])}")
        data = res[2]
        if path == "/tts":
            sr, samples = wavfile.read(io.BytesIO(data))
        else:  # a stream of unknown length: header, then int16 PCM
            sr, samples = 24000, np.frombuffer(data[44:], np.int16)
        if data[:4] != b"RIFF" or sr != 24000 or samples.dtype != np.int16 \
                or samples.shape[0] == 0 or samples.shape[0] % 1024:
            raise SmokeFailure(f"served {tier}: {path} gave {data[:4]} sr {sr} "
                               f"{samples.dtype} {samples.shape}")
        audio_s += samples.shape[0] / 24000
        per_request.append({"path": path, "seed": body["seed"], "s": res[3],
                            "audio_s": samples.shape[0] / 24000})
    codes = sum(int(r["audio_s"] * 24000) // 1024 for r in per_request)
    emit({"phase": f"served {tier}, full width, 8-slot pool through K4", "requests": per_request,
          "wall_s": wall, "pool_steps": steps, "pool_steps_per_s": steps / wall,
          "codes_per_s": codes / wall, "audio_s_per_wall_s": audio_s / wall,
          "vocoder_calls": vocodes[0], "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if launches["K4"] != steps or steps == 0:
        raise SmokeFailure(f"served {tier}: K4 launched {launches['K4']} times over {steps} "
                           "pool steps")
    if launches["K1"] != K1_PER_VOCODE * vocodes[0] or launches["K2"] or launches["K3"]:
        raise SmokeFailure(f"served {tier}: launches {launches} for {vocodes[0]} vocoder calls")

    # seeded determinism, driving a pool directly: codes, not wav bytes
    pool = eng.create_batcher(fused_trunk=True, num_slots=8)
    ids = [np.asarray(eng.tokenizer.encode(t), np.int32) for t in POOL_TEXTS]
    samp = dict(temperature=0.8, top_k=30, top_p=0.8, repetition_penalty=10.0, do_sample=True)
    rid = pool.submit(ids[0], max_new=120, sampling=samp, seed=77)
    alone = pool.run()[rid]
    rids = [pool.submit(x, max_new=120, sampling=samp, seed=500 + i)
            for i, x in enumerate(ids[1:4])]
    rid = pool.submit(ids[0], max_new=120, sampling=samp, seed=77)
    rids += [pool.submit(x, max_new=120, sampling=samp, seed=600 + i)
             for i, x in enumerate(ids[4:8])]
    among = pool.run()[rid]
    emit({"check": f"served {tier}: seeded request alone vs among seven others",
          "code_len": len(alone), "ok": np.array_equal(alone, among)})
    if len(alone) == 0 or not np.array_equal(alone, among):
        raise SmokeFailure(f"seeded codes differ under traffic: {alone.tolist()} vs "
                           f"{among.tolist()}")
    if tier == "bf16":
        profile_pool_steps(torch, pool, ids[:8])
    del eng, pool
    torch.cuda.empty_cache()
    return launches["K4"]


LONG = ("The quick brown fox jumps over the lazy dog while the morning sun rises slowly "
        "above the quiet hills, and the old farmer walks along the river to check on his "
        "sheep before the long day begins.")


def run_request(torch, kernels, tts, name: str, text: str, max_tokens: int, prompt: str,
                **gen):
    """One IndexTTS.infer request with every kernel count set to 0 just
    before it; checks the wav and returns (stats, launches by kernel)."""
    import numpy as np
    from scipy.io import wavfile

    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = os.path.join(os.path.dirname(prompt), f"{name}.wav")
    tts.infer(prompt, text, out, max_text_tokens_per_sentence=max_tokens, **gen)
    launches = {n: k.launches for n, k in kernels.items()}
    s = tts.last_stats
    sr, wav = wavfile.read(out)
    n_sent = len(s["code_lens"])
    expect = sum(s["code_lens"]) * 1024
    emit({"request": name, "sentences": n_sent, "code_lens": s["code_lens"],
          "samples": int(wav.shape[0]), "sample_rate": sr, "rtf": s["rtf"],
          "total_s": s["total_s"], "wav_seconds": s["wav_seconds"],
          "decode_steps": s["decode_steps"],
          "decode_steps_per_s": s["decode_steps"] / s["gpt_gen_time"],
          "gpt_gen_s": s["gpt_gen_time"], "gpt_forward_s": s["gpt_forward_time"],
          "vocoder_s": s["bigvgan_time"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
          "gpt_dtype": str(tts.gpt_dtype), "generation": {k: str(v) for k, v in gen.items()}})
    if wav.dtype != np.int16 or wav.shape[0] != expect or sr != 24000:
        raise SmokeFailure(f"{name}: wav {wav.dtype} {wav.shape} sr {sr}, "
                           f"expected int16 of {expect} samples at 24000")
    if launches["K1"] != K1_PER_VOCODE * n_sent:
        raise SmokeFailure(f"{name}: K1 launched {launches['K1']} times for {n_sent} vocodes")
    return s, launches


# five sentences of 56-75 tokens at 100 a sentence: buckets of 4 and 1 rows
FIVE = ("The quick brown fox jumps over the lazy dog while the morning sun rises slowly above "
        "the quiet hills, the birds begin to sing in the tall trees, and a cold wind comes "
        "down from the mountains to the sleeping village. In the afternoon the children come "
        "home from school, drop their heavy bags by the kitchen door, eat a slice of warm "
        "bread with honey, and play in the garden with the dog until their mother calls them "
        "in for dinner. The old farmer walks along the river every morning to check on his "
        "sheep and his two brown horses, and he counts the young lambs twice before the long "
        "day of hard work in the wide green fields begins again. When the evening comes the "
        "whole family sits together at the long wooden table, shares the soup and the bread, "
        "and talks about everything that happened in the busy town and on the farm since the "
        "early morning. Late at night the little town grows quiet, the last yellow lights in "
        "the windows go out one by one, and only the wind moves through the empty streets, "
        "the dark gardens and the old trees beside the church.")
TWO = ("The quick brown fox jumps over the lazy dog while the morning sun rises slowly above "
       "the quiet hills. In the afternoon the children come home from school and play in the "
       "garden until dinner.")


def run_fast_request(torch, kernels, tts, name: str, text: str, prompt: str, **gen):
    """One IndexTTS.infer_fast request (100 tokens a sentence, buckets of 4)
    with every kernel count set to 0 just before it; checks the wav (int16,
    sum(code_lens) * 1024 samples at 24 kHz), K1 109 times a bucket (one
    vocoder call each) and no K3.  Returns (stats, launches by kernel)."""
    from scipy.io import wavfile
    import numpy as np

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = os.path.join(os.path.dirname(prompt), f"{name}.wav")
    tts.infer_fast(prompt, text, out, max_text_tokens_per_sentence=100, **gen)
    launches = {n: k.launches for n, k in kernels.items()}
    s = tts.last_stats
    sr, wav = wavfile.read(out)
    expect = sum(s["code_lens"]) * 1024
    emit({"request": name, "sentences": len(s["code_lens"]), "buckets": s["buckets"],
          "bucket_steps": s["bucket_steps"], "code_lens": s["code_lens"],
          "samples": int(wav.shape[0]), "sample_rate": sr, "rtf": s["rtf"],
          "total_s": s["total_s"], "wav_seconds": s["wav_seconds"],
          "decode_steps": s["decode_steps"],
          "decode_steps_per_s": s["decode_steps"] / s["gpt_gen_time"],
          "gpt_gen_s": s["gpt_gen_time"], "gpt_forward_enqueue_s": s["gpt_forward_time"],
          "vocoder_enqueue_s": s["bigvgan_time"], "fetch_s": s["fetch_time"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
          "generation": {k: str(v) for k, v in gen.items()}})
    if wav.dtype != np.int16 or wav.shape[0] != expect or sr != 24000:
        raise SmokeFailure(f"{name}: wav {wav.dtype} {wav.shape} sr {sr}, "
                           f"expected int16 of {expect} samples at 24000")
    if sorted(s["buckets"]) != [1, 4]:
        raise SmokeFailure(f"{name}: buckets {s['buckets']}, expected one of 4 rows and one "
                           "of 1")
    if launches["K1"] != K1_PER_VOCODE * len(s["buckets"]) or launches["K3"]:
        raise SmokeFailure(f"{name}: launches {launches} for {len(s['buckets'])} buckets")
    return s, launches


def stream_request(torch, kernels, tts, prompt: str, two_sentences_wav: str) -> int:
    """infer_stream of the two_sentences request's text and seed: the chunks,
    concatenated, must be bit-equal to that request's wav (same seed, same
    device, deterministic K2); K2 once a decode step, K1 109 times a chunk.
    Returns the launches by kernel."""
    import numpy as np
    from scipy.io import wavfile

    for k in kernels.values():
        k.launches = 0
    stats = {}
    chunks = [c for _, c in tts.infer_stream(prompt, TWO, max_text_tokens_per_sentence=40,
                                             num_beams=1, do_sample=True, seed=102,
                                             stats_out=stats)]
    launches = {n: k.launches for n, k in kernels.items()}
    _, ref = wavfile.read(two_sentences_wav)
    wav = np.concatenate(chunks)
    equal = wav.dtype == ref.dtype and np.array_equal(wav, ref)
    emit({"request": "stream", "chunks": len(chunks), "samples": int(wav.shape[0]),
          "bit_equal_to_two_sentences": bool(equal),
          "time_to_first_audio_s": stats["time_to_first_audio"], "total_s": stats["total_s"],
          "rtf": stats["rtf"], "decode_steps": stats["decode_steps"],
          "code_lens": stats["code_lens"], "launches": launches})
    if not equal:
        raise SmokeFailure(f"stream: chunks differ from the two_sentences wav ({wav.shape} "
                           f"against {ref.shape})")
    if launches["K2"] != stats["decode_steps"] or launches["K1"] != K1_PER_VOCODE * len(chunks) \
            or launches["K3"]:
        raise SmokeFailure(f"stream: launches {launches} for {stats['decode_steps']} steps, "
                           f"{len(chunks)} chunks")
    return launches


def served_plain(torch, httpd, kernels, tts, prompt: str) -> int:
    """`serve()` without --continuous at the full width: /tts with no mode
    (infer_fast, beam-3) and /tts_stream (infer_stream, beam-3), each on a
    two-sentence text at 200 codes.  Each answer must be a 24 kHz int16 wav,
    and K1 must launch 109 times a vocoder call.  Returns K1's launches."""
    import io
    import threading

    import numpy as np
    from scipy.io import wavfile

    vocodes = [0]
    vocode = tts._vocode

    def counted(*a):
        vocodes[0] += 1
        return vocode(*a)

    tts._vocode = counted
    srv = httpd.serve(None, os.path.join(HERE, "checkpoints_test"), host="127.0.0.1", port=0,
                      engine_instance=tts)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    body = {"text": TWO, "audio_path": prompt, "seed": 9, "max_mel_tokens": 200,
            "max_text_tokens_per_sentence": 40}
    results = {}
    try:
        for k in kernels.values():
            k.launches = 0
        for path in ("/tts", "/tts_stream"):
            results[path] = _http(srv.server_address[1], path, body)
        launches = {n: k.launches for n, k in kernels.items()}
    finally:
        srv.shutdown()
        del tts._vocode
    lines = {}
    for path, (status, _, data, secs) in results.items():
        if status != 200:
            raise SmokeFailure(f"non-continuous {path} answered {status}: {data[:200]}")
        if path == "/tts":
            sr, samples = wavfile.read(io.BytesIO(data))
        else:  # a stream of unknown length: header, then int16 PCM
            sr, samples = 24000, np.frombuffer(data[44:], np.int16)
        if data[:4] != b"RIFF" or sr != 24000 or samples.dtype != np.int16 \
                or samples.shape[0] == 0 or samples.shape[0] % 1024:
            raise SmokeFailure(f"non-continuous {path}: {data[:4]} sr {sr} {samples.dtype} "
                               f"{samples.shape}")
        lines[path] = {"s": secs, "audio_s": samples.shape[0] / 24000}
    emit({"phase": "served without --continuous (infer_fast and infer_stream, beam-3)",
          "requests": lines, "vocoder_calls": vocodes[0], "launches": launches})
    if launches["K1"] != K1_PER_VOCODE * vocodes[0] or vocodes[0] < 2 or launches["K2"] \
            or launches["K3"]:
        raise SmokeFailure(f"non-continuous server: launches {launches} for {vocodes[0]} "
                           "vocoder calls")
    return launches["K1"]


def end_to_end(torch, engine_mod, httpd, kernels, prompt: str):
    """Requests at full width: through IndexTTS.infer three sampling
    requests ("short", "long", "two_sentences"), the reference default (no generation arguments: beam-3
    sampling), an fp8 KV cache, a guided request and int8 / int4 engines;
    through infer_fast the reference's serving default (five sentences in
    buckets of 4 and 1, beam-3) and the same at num_beams=1 sampling; an
    infer_stream request against two_sentences' wav; and the server without
    --continuous.  Each path is run with the counts at 0 and read after it.
    Returns the launches of each kernels-line entry on its paths, and the
    default_beam3 request's stats."""
    root = os.path.join(HERE, "checkpoints_test")
    t0 = time.perf_counter()
    tts = engine_mod.IndexTTS(cfg_path=None, model_dir=root, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "engine_init", "s": time.perf_counter() - t0,
          "gpt_layers": tts.cfg.gpt.layers, "model_dim": tts.cfg.gpt.model_dim,
          "heads": tts.cfg.gpt.heads,
          "bigvgan_channels": tts.cfg.bigvgan.upsample_initial_channel,
          "gpt_dtype": str(tts.gpt_dtype), "vocoder_dtype": str(tts.vocoder_dtype)})
    totals = {"fused_anti_alias_activation": 0, "fused_decode_trunk_flat[bf16]": 0,
              "fused_decode_trunk_flat[int8]": 0, "fused_decode_trunk_flat[int4]": 0,
              "fused_decode_trunk_flat[fp8_cache]": 0}

    def single_row(name, engine, text, max_tokens, tier, n_sent, **gen):
        s, n = run_request(torch, kernels, engine, name, text, max_tokens, prompt,
                           num_beams=1, **gen)
        if len(s["code_lens"]) != n_sent or n["K2"] != s["decode_steps"] or n["K2"] == 0 \
                or n["K3"]:
            raise SmokeFailure(f"{name}: {len(s['code_lens'])} sentences, K2 {n['K2']} "
                               f"launches for {s['decode_steps']} steps, K3 {n['K3']}")
        totals["fused_anti_alias_activation"] += n["K1"]
        totals[f"fused_decode_trunk_flat[{tier}]"] += n["K2"]

    def beam(name, engine, text, **gen):
        s, n = run_request(torch, kernels, engine, name, text, 120, prompt, **gen)
        if n["K2"] or n["K3"] or s["decode_steps"] == 0:
            raise SmokeFailure(f"{name}: beam decode launched K2 {n['K2']} and K3 {n['K3']} "
                               f"times over {s['decode_steps']} steps")
        totals["fused_anti_alias_activation"] += n["K1"]
        return s

    # PR 1's three sampling requests (bf16 weights and cache)
    single_row("short", tts, "你好，欢迎使用语音合成。", 120, "bf16", 1, do_sample=True,
               seed=100)
    single_row("long", tts, LONG, 120, "bf16", 1, do_sample=True, seed=101)
    single_row("two_sentences", tts, TWO, 40, "bf16", 2, do_sample=True, seed=102)
    # the reference default: no generation arguments (beam-3 sampling)
    beam3 = beam("default_beam3", tts, LONG)
    # infer_fast, the reference's serving default: buckets of 4, beam-3; no K2
    s, n = run_fast_request(torch, kernels, tts, "fast_default", FIVE, prompt)
    emit({"rtf": {"fast_default": s["rtf"], "default_beam3": beam3["rtf"]},
          "audio_s_per_wall_s": {"fast_default": 1 / s["rtf"],
                                 "default_beam3": 1 / beam3["rtf"]}})
    if n["K2"]:
        raise SmokeFailure(f"fast_default: beam buckets launched K2 {n['K2']} times")
    totals["fused_anti_alias_activation"] += n["K1"]
    # at num_beams=1: the 4-row bucket on gpt2.decode_step, the singleton on K2
    s, n = run_fast_request(torch, kernels, tts, "fast_sampling", FIVE, prompt, num_beams=1,
                            do_sample=True, seed=105)
    single = sum(st for rows, st in zip(s["buckets"], s["bucket_steps"]) if rows == 1)
    if n["K2"] != single or single == 0:
        raise SmokeFailure(f"fast_sampling: K2 launched {n['K2']} times; the single-row "
                           f"bucket took {single} steps")
    totals["fused_anti_alias_activation"] += n["K1"]
    totals["fused_decode_trunk_flat[bf16]"] += n["K2"]
    # guidance: two physical rows, so no K2
    s, n = run_request(torch, kernels, tts, "guided", LONG, 120, prompt, num_beams=1,
                       cfg_scale=3.0, seed=106)
    if n["K2"] or n["K3"] or len(s["code_lens"]) != 1:
        raise SmokeFailure(f"guided: launches {n} over {len(s['code_lens'])} sentences")
    totals["fused_anti_alias_activation"] += n["K1"]
    n = stream_request(torch, kernels, tts, prompt,
                       os.path.join(os.path.dirname(prompt), "two_sentences.wav"))
    totals["fused_anti_alias_activation"] += n["K1"]
    totals["fused_decode_trunk_flat[bf16]"] += n["K2"]
    totals["fused_anti_alias_activation"] += served_plain(torch, httpd, kernels, tts, prompt)
    # an explicit fp8 KV cache on the single-row path
    single_row("fp8_kv_cache", tts, LONG, 120, "fp8_cache", 1,
               kv_dtype=torch.float8_e4m3fn, seed=103)
    del tts
    torch.cuda.empty_cache()
    for bits in ("int8", "int4"):
        eng = engine_mod.IndexTTS(cfg_path=None, model_dir=root, device="cuda", seed=0,
                                  precision_config={"gpt": bits})
        if not eng.use_quantization or eng.kv_cache_dtype != torch.float8_e4m3fn:
            raise SmokeFailure(f"gpt={bits}: quantization {eng.use_quantization}, "
                               f"kv cache {eng.kv_cache_dtype}")
        single_row(bits, eng, LONG, 120, bits, 1, seed=104)
        if bits == "int8":  # beam decode over the fp8 KV cache and int8 matmuls
            beam("int8_default_beam3", eng, LONG)
        del eng
        torch.cuda.empty_cache()
    return totals, beam3


def checkpoint_round_trip(torch, engine_mod, export, kernels, prompt: str, out_dir: str):
    """Phase 1 of the checkpoint slice, full width, bf16: engine A (random
    weights, fixed seed) writes gpt.pth (bf16, with speaker_conditions,
    speakers and speaker_mels for "spk") and bigvgan_generator.pth (fp32:
    the weight-norm fold of bf16 weights then lands on them exactly) with
    the port's exporter; engine B loads that directory.  Greedy num_beams=1
    requests of A and B must give equal codes and bit-equal wavs (K2 once a
    step, K1 109 times a vocode), and a speaker_id request with no prompt a
    24 kHz int16 wav.  Returns (gpt.pth path, a checksum of B's GPT
    weights, launches by kernel over B's requests)."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    root = os.path.join(HERE, "checkpoints_test")
    d = os.path.join(out_dir, "pth_model")
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(root, "vocab.txt"), d)
    a = engine_mod.IndexTTS(cfg_path=None, model_dir=root, device="cuda", seed=0)
    mel = a._prompt_mel(prompt)
    cond = a._conditioning(mel).float().cpu().numpy()
    gpt_pth = os.path.join(d, "gpt.pth")
    t0 = time.perf_counter()
    export.save_gpt_pth(gpt_pth, a.gpt_params, a.cfg.gpt, save_dtype="bf16",
                        extras={"speaker_conditions": {"spk": cond}, "speakers": ["spk"],
                                "speaker_mels": {"spk": mel[0].cpu().numpy()}})
    export.save_bigvgan_pth(os.path.join(d, "bigvgan_generator.pth"), a.bigvgan_params,
                            a.cfg.bigvgan, save_dtype="fp32")
    save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = engine_mod.IndexTTS(cfg_path=None, model_dir=d, device="cuda", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if b.speaker_list != ["spk"] or b.mean_condition is not None:
        raise SmokeFailure(f"checkpoint: speakers {b.speaker_list}")
    gen = dict(num_beams=1, do_sample=False, max_mel_tokens=200, max_text_tokens_per_sentence=120)
    out = {}
    launches = {n: 0 for n in kernels}
    for name, eng, spk in (("A", a, None), ("B", b, None), ("B speaker_id", b, "spk")):
        for k in kernels.values():
            k.launches = 0
        path = os.path.join(out_dir, f"ckpt_{name.replace(' ', '_')}.wav")
        eng.infer(None if spk else prompt, LONG, path, speaker_id=spk, **gen)
        n = {k: v.launches for k, v in kernels.items()}
        s = eng.last_stats
        sr, wav = wavfile.read(path)
        out[name] = (s["codes"], wav, n, s)
        if sr != 24000 or wav.dtype != np.int16 or wav.shape[0] != sum(s["code_lens"]) * 1024 \
                or n["K2"] != s["decode_steps"] or n["K1"] != K1_PER_VOCODE * len(s["code_lens"]):
            raise SmokeFailure(f"checkpoint {name}: wav {sr} {wav.dtype} {wav.shape}, "
                               f"launches {n} over {s['decode_steps']} steps")
        if eng is b:
            launches = {k: launches[k] + n[k] for k in n}
    codes_equal = all(np.array_equal(x, y) for x, y in zip(out["A"][0], out["B"][0])) \
        and len(out["A"][0]) == len(out["B"][0])
    wav_equal = np.array_equal(out["A"][1], out["B"][1])
    checksum = float(b.gpt_params["mel_head"]["kernel"].float().sum())
    emit({"phase": "checkpoint round trip, full width, bf16 gpt.pth + fp32 "
                   "bigvgan_generator.pth",
          "gpt_pth_mb": os.path.getsize(gpt_pth) / 2 ** 20,
          "bigvgan_pth_mb": os.path.getsize(os.path.join(d, "bigvgan_generator.pth")) / 2 ** 20,
          "save_s": save_s, "load_s": load_s, "load_peak_mem_gib": load_peak,
          "code_lens": out["B"][3]["code_lens"], "codes_equal": codes_equal,
          "wav_bit_equal": wav_equal,
          "speaker_id_request": {"samples": int(out["B speaker_id"][1].shape[0]),
                                 "code_lens": out["B speaker_id"][3]["code_lens"],
                                 "rtf": out["B speaker_id"][3]["rtf"]},
          "launches_B": launches})
    if not codes_equal or not wav_equal:
        raise SmokeFailure(f"checkpoint round trip: codes equal {codes_equal}, wav bit-equal "
                           f"{wav_equal}")
    del a, b
    torch.cuda.empty_cache()
    return gpt_pth, checksum, launches


def beam_pool_small_agreement(torch, engine_mod, uv, beam_pool, prompt: str) -> None:
    """Phase 2: the beam pool on the small fp32 model, on the card and on the
    CPU.  Greedy (five requests through two groups), sampled (four requests,
    their own seeds and knobs, 4-step ticks) and staggered admission: each
    group's codes must equal the dedicated beam-3 decode's (sampled: fed the
    pool's draws), and the card's codes the CPU's."""
    import numpy as np
    from indextts_tpu_torch.config import Config

    base = dict(config=Config.from_dict(SMALL_MODEL),
                model_dir=os.path.join(HERE, "checkpoints_test"), seed=0,
                precision_config={"gpt": "fp32", "vocoder": "fp32"})
    ref = engine_mod.IndexTTS(device="cpu", **base)
    dut = engine_mod.IndexTTS(device="cuda", **base)
    dut.load_numpy_params(_to_numpy(ref.gpt_params), _to_numpy(ref.bigvgan_params))
    ids = [np.asarray(ref.tokenizer.encode(t), np.int32) for t in POOL_TEXTS[:5]]
    knobs = [dict(temperature=0.9, top_p=0.85, repetition_penalty=4.0),
             dict(temperature=1.3, top_p=0.7, repetition_penalty=1.5),
             dict(temperature=1.0, top_p=0.8, repetition_penalty=10.0),
             dict(temperature=0.7, top_p=0.95, repetition_penalty=2.0)]
    max_new, V = 24, ref.cfg.gpt.number_mel_codes
    results = {}
    for dev, eng in (("cpu", ref), ("cuda", dut)):
        cond = eng._conditioning(eng._prompt_mel(prompt))

        def dedicated(x, seed=None, **kw):
            tokens, mask = eng._text_inputs([x])
            draws = None if seed is None else [
                beam_pool.select_noise(torch.tensor([seed], device=eng.device),
                                       torch.tensor([i], device=eng.device), 3 * V)
                for i in range(max_new)]
            r = uv.inference_speech_beam(eng.gpt_params_batched, eng.cfg.gpt, cond, tokens,
                                         mask, None, max_new=max_new, num_beams=3,
                                         do_sample=seed is not None, gumbel=draws,
                                         cache_dtype=torch.float32, **kw)
            return r.codes[0, : int(r.lengths[0])].cpu().tolist()

        kw = dict(num_groups=2, max_text_width=32, max_new=max_new)
        pool = eng.create_beam_batcher(prompt, do_sample=False, **kw)
        rids = [pool.submit(x) for x in ids]
        res = pool.run()
        greedy = [res[r].tolist() for r in rids]
        pool = eng.create_beam_batcher(prompt, steps_per_tick=4, **kw)
        rids = [pool.submit(x, seed=300 + i, sampling=k)
                for i, (x, k) in enumerate(zip(ids, knobs))]
        res = pool.run()
        sampled = [res[r].tolist() for r in rids]
        pool = eng.create_beam_batcher(prompt, **kw)
        out = {}
        r1 = pool.submit(ids[0], seed=7, done_cb=lambda r, c: out.__setitem__(r, c.tolist()))
        for _ in range(3):
            pool.step()
        r2 = pool.submit(ids[1], seed=8, done_cb=lambda r, c: out.__setitem__(r, c.tolist()))
        while pool._queue or pool._live:
            pool.step()
        pool.flush()
        staggered = [out[r1], out[r2]]
        want = ([dedicated(x) for x in ids],
                [dedicated(x, seed=300 + i, **k) for i, (x, k) in enumerate(zip(ids, knobs))],
                [dedicated(ids[0], seed=7), dedicated(ids[1], seed=8)])
        results[dev] = (greedy, sampled, staggered)
        for name, got, exp in zip(("greedy", "sampled", "staggered"), results[dev], want):
            if got != exp:
                raise SmokeFailure(f"beam pool small model on {dev}, {name}: pool {got} != "
                                   f"dedicated {exp}")
    ok = results["cuda"] == results["cpu"]
    emit({"check": "beam pool small model: pool vs dedicated beam-3 (greedy, sampled with the "
                   "pool's draws, staggered), card vs CPU",
          "code_lens": [[len(c) for c in part] for part in results["cuda"]], "ok": ok})
    if not ok:
        raise SmokeFailure(f"beam pool small model: card {results['cuda']} != CPU "
                           f"{results['cpu']}")


def _profile_ticks(torch, pool, label: str, ticks: int = 1) -> None:
    """Where a pool tick's time goes: `ticks` ticks under torch.profiler.
    Prints ms a step, the device's busy share and device ops a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n0 = pool.step_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            pool.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = max(pool.step_count - n0, 1)
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    kernels = kernel_events(torch, events)
    busy_us = sum(dev(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top_dev = sorted(events, key=dev, reverse=True)[:8]
    emit({"phase": label, "steps": n, "wall_ms_per_step": wall * 1e3 / n,
          "device_busy_ms_per_step": busy_us / 1e3 / n,
          "device_busy_share": busy_us / 1e6 / wall if wall else None,
          "device_ops_per_step": launches / n,
          "top_device_ms_per_step": {e.key: dev(e) / 1e3 / n for e in top_dev}})


def served_beam(torch, engine_mod, httpd, uv, kernels, prompt: str, beam3: dict) -> int:
    """Phase 3: `serve(continuous=True)` with a 4-group beam pool at the full
    width, bf16: six concurrent reference-default requests (num_beams 3,
    do_sample, top_k 30, top_p 0.8, temperature 1.0, repetition_penalty 10,
    max_mel_tokens 200), each a 24 kHz int16 wav; K1 109 times a vocoder
    call and no other kernel.  Prints per-request latency, pool steps/s and
    audio seconds per wall second beside default_beam3's; then a 16-step
    profile of the pool's step and the full-width greedy agreement of a pool
    group with the dedicated decode (first divergent step, share of equal
    codes; bf16 products over 3 and 12 rows may round apart, so not gated).
    Returns K1's launches on the served path."""
    import io
    import threading

    import numpy as np
    from scipy.io import wavfile

    root = os.path.join(HERE, "checkpoints_test")
    eng = engine_mod.IndexTTS(cfg_path=None, model_dir=root, device="cuda", seed=0)
    vocodes = [0]
    vocode = eng._vocode

    def counted(*a):
        vocodes[0] += 1
        return vocode(*a)

    eng._vocode = counted
    srv = httpd.serve(None, root, host="127.0.0.1", port=0, engine_instance=eng,
                      continuous=True, beam_pool_kwargs={"num_groups": 4})
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    texts = [LONG, "你好，欢迎使用语音合成。今天天气很好。", POOL_TEXTS[3], POOL_TEXTS[6],
             "我们去散步吧。明天见。", TWO]
    reqs = [{"text": t, "audio_path": prompt, "seed": 200 + i, "num_beams": 3, "do_sample": True,
             "top_k": 30, "top_p": 0.8, "temperature": 1.0, "repetition_penalty": 10.0,
             "max_mel_tokens": 200, "max_text_tokens_per_sentence": 120}
            for i, t in enumerate(texts)]
    try:
        pool = srv.service.beam_pool(True)      # build the pool before the clock starts
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results = [None] * len(reqs)

        def call(i):
            results[i] = _http(port, "/tts", reqs[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        steps = pool.step_count
    finally:
        srv.shutdown()
    audio_s, per_request = 0.0, []
    for body, res in zip(reqs, results):
        if res is None or res[0] != 200:
            raise SmokeFailure(f"served beam-3: seed {body['seed']} answered "
                               f"{None if res is None else (res[0], res[2][:200])}")
        sr, samples = wavfile.read(io.BytesIO(res[2]))
        if res[2][:4] != b"RIFF" or sr != 24000 or samples.dtype != np.int16 \
                or samples.shape[0] == 0 or samples.shape[0] % 1024:
            raise SmokeFailure(f"served beam-3: sr {sr} {samples.dtype} {samples.shape}")
        audio_s += samples.shape[0] / 24000
        per_request.append({"seed": body["seed"], "s": res[3], "audio_s": samples.shape[0] / 24000})
    emit({"phase": "served beam-3 through --continuous, full width, bf16, 4-group beam pool",
          "requests": per_request, "wall_s": wall, "pool_steps": steps,
          "pool_steps_per_s": steps / wall, "audio_s_per_wall_s": audio_s / wall,
          "default_beam3_audio_s_per_wall_s": 1 / beam3["rtf"],
          "default_beam3_steps_per_s": beam3["decode_steps"] / beam3["gpt_gen_time"],
          "vocoder_calls": vocodes[0], "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if launches["K1"] != K1_PER_VOCODE * vocodes[0] or vocodes[0] == 0 or launches["K2"] \
            or launches["K3"] or launches["K4"]:
        raise SmokeFailure(f"served beam-3: launches {launches} for {vocodes[0]} vocoder calls")

    # a 16-step tick of the full pool under the profiler
    del eng._vocode
    ids = [np.asarray(eng.tokenizer.encode(t), np.int32) for t in texts[:4]]
    pool = eng.create_beam_batcher(prompt, num_groups=4)
    for i, x in enumerate(ids):
        pool.submit(x, max_new=200, seed=i)
    pool.step()                                   # admission and the first tick
    _profile_ticks(torch, pool, "beam pool step profile (4 groups x 3 beams, bf16, "
                                "full width, one 16-step tick)")
    pool.run()
    # greedy: a pool group against the dedicated decode at full width
    pool = eng.create_beam_batcher(prompt, num_groups=4, do_sample=False)
    m = min(200, pool.max_new)
    rid = pool.submit(ids[0], max_new=m)
    got = pool.run()[rid]
    tokens, mask = eng._text_inputs([ids[0]])
    r = uv.inference_speech_beam(eng.gpt_params_batched, eng.cfg.gpt,
                                 eng._conditioning(eng._prompt_mel(prompt)), tokens, mask, None,
                                 max_new=m, num_beams=3, do_sample=False,
                                 cache_dtype=eng.gpt_dtype)
    want = r.codes[0, : int(r.lengths[0])].cpu().numpy()
    n = min(len(got), len(want))
    diverge = next((i for i in range(n) if got[i] != want[i]), None)
    emit({"phase": "beam pool vs dedicated beam-3, greedy, full width, bf16 (reported, not "
                   "gated)", "pool_len": len(got), "dedicated_len": len(want),
          "first_divergent_step": diverge,
          "equal_code_share": float(np.mean(got[:n] == want[:n])) if n else None})
    del eng, pool
    torch.cuda.empty_cache()
    return launches["K1"]


def reload_and_warmup(torch, engine_mod, httpd, kernels, prompt: str, gpt_pth: str,
                      checksum: float) -> dict:
    """Phase 4: a --continuous server (random weights) answers a beam-3
    request; /model/reload onto phase 1's gpt.pth answers {"status":
    "reloaded"}; the new engine (the loaded weights: the same checksum as
    phase 1's engine B) runs `IndexTTS.warmup`, then the next request.  With
    the old drive threads gone and a gc, the card's allocated memory must be
    within 10% of what one engine and its pool held before the reload.
    Returns the launches by kernel over the phase."""
    import gc
    import threading

    root = os.path.join(HERE, "checkpoints_test")
    srv = httpd.serve(None, root, host="127.0.0.1", port=0, continuous=True, device="cuda",
                      beam_pool_kwargs={"num_groups": 2})
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    body = {"text": TWO, "audio_path": prompt, "seed": 11, "num_beams": 3, "max_mel_tokens": 120,
            "max_text_tokens_per_sentence": 120}

    def idle():
        for _ in range(500):
            pools = list(srv.service._beam_pools.values())
            if all(not p._queue and not p._live for p in pools):
                return
            time.sleep(0.01)

    for k in kernels.values():
        k.launches = 0
    try:
        first = _http(port, "/tts", body)
        idle()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        old_threads = list(srv.service._threads)
        status, _, data, reload_s = _http(port, "/model/reload", {"gpt_path": gpt_pth})
        for t in old_threads:
            t.join(30)
        eng = srv.service.engine()
        loaded = float(eng.gpt_params["mel_head"]["kernel"].float().sum())
        t0 = time.perf_counter()
        eng.warmup(text_widths=(64,), max_mel_tokens=120)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        after_req = _http(port, "/tts", body)
        idle()
        launches = {n: k.launches for n, k in kernels.items()}
        del eng
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        alive = sum(t.is_alive() for t in old_threads)
    finally:
        srv.shutdown()
    ratio = after / before
    emit({"phase": "reload and warmup", "first_request": {"status": first[0], "s": first[3]},
          "reload": {"status": status, "answer": json.loads(data), "s": reload_s},
          "loaded_checksum_equal": loaded == checksum, "warmup_s": warmup_s,
          "request_after_warmup": {"status": after_req[0], "s": after_req[3]},
          "allocated_gib_before": before / 2 ** 30, "allocated_gib_after": after / 2 ** 30,
          "after_over_before": ratio, "old_drive_threads_alive": alive, "launches": launches})
    if first[0] != 200 or status != 200 or json.loads(data).get("status") != "reloaded" \
            or after_req[0] != 200 or loaded != checksum:
        raise SmokeFailure(f"reload: first {first[0]}, reload {status} {data[:200]}, after "
                           f"{after_req[0]}, checksum {loaded} vs {checksum}")
    if abs(ratio - 1.0) > 0.10 or alive:
        raise SmokeFailure(f"reload: allocated {after / 2 ** 30:.3f} GiB after against "
                           f"{before / 2 ** 30:.3f} before ({alive} old drive threads alive)")
    if launches["K1"] == 0 or launches["K1"] % K1_PER_VOCODE:
        raise SmokeFailure(f"reload: launches {launches}")
    return launches



# sentences for the synthetic fine-tuning manifests (English and Chinese)
FT_SENTENCES = [
    "The quick brown fox jumps over the lazy dog.", "The morning sun rises slowly.",
    "An old farmer walks along the river to check on his sheep.",
    "Please read the next line aloud and clearly.", "We will meet again tomorrow at noon.",
    "今天天气很好，我们去散步吧。", "谢谢你的帮助。", "请再说一遍。", "明天再见。",
    "欢迎使用语音合成。"]


def write_finetune_data(root: str, tokenizer, rng, *, clips: int, valid: int, codes: tuple,
                        text_tokens: tuple, width: int, speakers=("spk_a", "spk_b")) -> dict:
    """Synthetic fine-tuning data in the extraction layout (what the data
    loader reads): per speaker `clips` train and `valid` valid records in
    metadata_{train,valid}.jsonl over codes/*.npy ([n], n in `codes`) and
    mels/*.npy ([100, 4 n]), texts joined from FT_SENTENCES to a token count
    in `text_tokens`, a medoid_condition.npy [1, 32, width] and a
    medoid_mel.npy; speaker_info.json.  Returns counts."""
    import numpy as np

    n_tokens = []
    for spk in speakers:
        d = os.path.join(root, spk)
        os.makedirs(os.path.join(d, "codes"), exist_ok=True)
        os.makedirs(os.path.join(d, "mels"), exist_ok=True)
        recs = {"train": [], "valid": []}
        for i in range(clips + valid):
            n = int(rng.integers(codes[0], codes[1] + 1))
            np.save(os.path.join(d, "codes", f"c{i}.npy"), rng.integers(0, 8192, n))
            np.save(os.path.join(d, "mels", f"c{i}.npy"),
                    rng.standard_normal((100, 4 * n)).astype(np.float32))
            text, want = "", int(rng.integers(text_tokens[0], text_tokens[1] + 1))
            while len(tokenizer.encode(text)) < want:
                nxt = (text + " " + FT_SENTENCES[int(rng.integers(len(FT_SENTENCES)))]).strip()
                if len(tokenizer.encode(nxt)) > text_tokens[1]:
                    break
                text = nxt
            n_tokens.append(len(tokenizer.encode(text)))
            recs["train" if i < clips else "valid"].append({
                "audio": f"{spk}/c{i}.wav", "text": text, "duration": n / 23.4,
                "codes": f"codes/c{i}.npy", "mels": f"mels/c{i}.npy"})
        for split, rs in recs.items():
            with open(os.path.join(d, f"metadata_{split}.jsonl"), "w", encoding="utf-8") as f:
                f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rs)
        np.save(os.path.join(d, "medoid_condition.npy"),
                rng.standard_normal((1, 32, width)).astype(np.float32))
        np.save(os.path.join(d, "medoid_mel.npy"),
                rng.standard_normal((100, 400)).astype(np.float32))
    with open(os.path.join(root, "speaker_info.json"), "w") as f:
        json.dump([{"speaker": s} for s in speakers], f)
    return {"speakers": len(speakers), "train_clips": clips * len(speakers),
            "valid_clips": valid * len(speakers), "text_tokens": [min(n_tokens), max(n_tokens)]}


def _leaf_rel_err(torch, got, want) -> float:
    """The largest max|diff| / max|want| over the leaves of two trees."""
    if isinstance(want, dict):
        return max(_leaf_rel_err(torch, got[k], want[k]) for k in want)
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def _trees_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_trees_equal(torch, a[k], b[k]) for k in a)
    return torch.equal(a.cpu(), b.cpu())


def lora_small_agreement(torch, Config, TrainConfig, uv, trainer, lora) -> None:
    """LoRA fine-tuning on the small fp32 model, on the card and on the CPU:
    three optimizer updates at gradient_accumulation_steps=2 (six
    micro-steps) with max_grad_norm low enough that the clip fires on every
    one; the card's adapters within 1e-5 of each leaf's largest magnitude of
    the CPU's after every micro-step (the reference learning rate, 5e-6:
    Adam scales each element to about lr, so the rate bounds how far two
    summation orders can part).  Then the true skip on the card: a NaN base
    weight leaves adapters, optimizer state and step bit-equal."""
    import numpy as np

    cfg = Config.from_dict(SMALL_MODEL).gpt
    tc = TrainConfig.from_dict({"gradient_accumulation_steps": 2, "max_grad_norm": 0.05,
                                "optimizer": {"learning_rate": 5e-6}})
    base = uv.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    start = lora.init_lora_params(g, cfg, tc.lora)
    for ab in start.values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=g)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        B, tl, cl, ml = 4, rng.integers(8, 20, 4), rng.integers(16, 40, 4), rng.integers(60, 160, 4)
        text, codes = np.zeros((B, 20), np.int64), np.zeros((B, 40), np.int64)
        for i in range(B):
            text[i, :tl[i]] = rng.integers(2, 12000, tl[i])
            codes[i, :cl[i]] = rng.integers(0, 8192, cl[i])
        batches.append(trainer.Batch(torch.from_numpy(text), torch.from_numpy(tl),
                                     torch.from_numpy(codes), torch.from_numpy(cl),
                                     torch.from_numpy(rng.standard_normal((B, 100, 160))
                                                      .astype(np.float32)),
                                     torch.from_numpy(ml)))
    to = lambda tree, dev: lora.tree_map(lambda x: x.to(dev), tree)  # noqa: E731
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = trainer.make_optimizer(tc, 3)
        adapters = to(start, dev)
        state = trainer.TrainState(adapters, opt.init(adapters),
                                   torch.zeros((), dtype=torch.int32, device=dev))
        b_dev, seen = to(base, dev), []
        for i in range(6):
            state, m = trainer.train_step(state, b_dev, trainer.Batch(
                *(x.to(dev) for x in batches[i % 2])), cfg, tc.lora, opt, tc.text_weight)
            seen.append((to(state.lora_params, "cpu"), float(m["grad_norm"])))
        runs[dev] = (seen, state, b_dev, opt)
    err = max(_leaf_rel_err(torch, c[0], p[0]) for c, p in zip(runs["cuda"][0], runs["cpu"][0]))
    norms = [n for _, n in runs["cuda"][0]]
    check("lora small model, 3 updates at accumulation 2, card vs CPU (relative to each "
          "leaf's largest magnitude)", err, 1e-5, grad_norms=norms,
          max_grad_norm=tc.max_grad_norm)
    if min(norms) <= 10 * tc.max_grad_norm:
        raise SmokeFailure(f"lora small model: the clip did not fire ({norms})")
    _, state, b_dev, opt = runs["cuda"]
    bad = lora.tree_map(lambda x: x.clone(), b_dev)
    bad["gpt"]["blocks"]["mlp"]["fc_w"][0, 3, 5] = float("nan")
    after, m = trainer.train_step(state, bad, trainer.Batch(*(x.cuda() for x in batches[0])),
                                  cfg, tc.lora, opt, tc.text_weight)
    kept = (_trees_equal(torch, after.lora_params, state.lora_params)
            and _trees_equal(torch, after.opt_state, state.opt_state)
            and int(after.step) == int(state.step) and float(m["skipped"]) == 1.0)
    emit({"check": "lora small model, non-finite loss on the card is a true skip",
          "loss": float(m["loss"]), "skipped": float(m["skipped"]), "ok": kept})
    if not kept:
        raise SmokeFailure("lora small model: a non-finite step moved the state")


def lora_small_resume(torch, Config, run_mod, tokenizer, out_dir: str) -> None:
    """The small fp32 model's Trainer on the card over synthetic manifests:
    epochs 0 and 1 straight through against a run interrupted as epoch 1
    begins, a new Trainer, try_resume and epoch 1: adapters within 1e-6."""
    import numpy as np
    import shutil
    import tempfile

    root = tempfile.mkdtemp(dir=out_dir, prefix="lora_small_")
    data = os.path.join(root, "data")
    write_finetune_data(data, tokenizer, np.random.default_rng(3), clips=12, valid=2,
                        codes=(24, 60), text_tokens=(10, 40), width=128)
    cfg = Config.from_dict({**SMALL_MODEL, "train": {
        "finetune_model_dir": os.path.join(root, "out"), "data_path": data, "epochs": 2,
        "batch_size": 8, "gradient_accumulation_steps": 2, "max_steps_per_epoch": 4,
        "mixed_precision": "fp32", "save_dtype": "fp32", "early_stopping_patience": 5,
        "optimizer": {"learning_rate": 1e-4}}})
    model_dir = os.path.join(HERE, "checkpoints_test")
    straight = run_mod.Trainer(cfg, model_dir, run_name="straight", device="cuda")
    straight.train()

    class Interrupted(Exception):
        pass

    def stop_at_epoch_1(epoch):
        if epoch == 1:
            raise Interrupted
        set_epoch(epoch)

    first = run_mod.Trainer(cfg, model_dir, run_name="resumed", device="cuda")
    set_epoch, first.loader.set_epoch = first.loader.set_epoch, stop_at_epoch_1
    try:
        first.train()
        raise SmokeFailure("lora resume: the interrupted run did not stop")
    except Interrupted:
        first.close()
    resumed = run_mod.Trainer(cfg, model_dir, run_name="resumed", device="cuda")
    resumed.try_resume()
    resumed.train()
    err = _leaf_rel_err(torch, resumed.state.lora_params, straight.state.lora_params)
    check("lora small model Trainer on the card: resumed at epoch 1 vs straight (relative)",
          err, 1e-6, step=int(resumed.state.step), start_epoch=resumed.start_epoch)
    if resumed.start_epoch != 1 or int(resumed.state.step) != int(straight.state.step):
        raise SmokeFailure(f"lora resume: start_epoch {resumed.start_epoch}, step "
                           f"{int(resumed.state.step)} vs {int(straight.state.step)}")
    shutil.rmtree(root)


def train_step_flops(B: int, Tt: int, Tm: int, gpt) -> float:
    """Model FLOPs of one micro-step through the frozen trunk: forward plus
    the activation backward of every product (2 x 2 x rows x weights: the
    24 layers' 12 D^2 over every position, the text and mel heads over their
    stream's positions), plus attention over the full T x T square (4 T^2 D
    forward, 8 T^2 D backward, per row and layer).  Excluded: the recomputed
    forward, the frozen weights' gradients that the fold's backward forms,
    and the conditioning encoder (no gradient)."""
    D, L = gpt.model_dim, gpt.layers
    T = gpt.condition_num_latent + (Tt + 2) + (Tm + 2)
    trunk = 2 * 2 * B * T * 12 * L * D * D
    heads = 2 * 2 * B * ((Tt + 2) * D * (gpt.number_text_tokens + 1)
                         + (Tm + 2) * D * gpt.number_mel_codes)
    return trunk + heads + 12 * B * L * T * T * D


def lora_finetune(torch, engine_mod, kernels, prompt: str, out_dir: str) -> dict:
    """LoRA fine-tuning: the small-model checks, then at full width (24
    layers, 1280 wide, 20 heads, a bf16 base) a Trainer over synthetic
    manifests (two speakers, 128 train and 4 valid clips each, 150-450 codes
    and 20-120 text tokens a clip) at the TrainConfig defaults but epochs=2
    and max_steps_per_epoch=32: micro-batches of 8, 16 to an update, so 2
    updates an epoch.  Every loss finite, every artifact written.  Then
    learning (one micro-batch of 8 with codes from 64 values, accumulation 1,
    lr 1e-3: the mel loss after 20 updates at most 0.9 of the first), and
    serving what was trained: engines on gpt_finetuned.pth and on the merged
    directory model_epoch_1 give equal greedy codes for a 200-code request,
    their qkv_w equal to lora.merge in bf16 bit for bit, and a speaker_id
    request with no prompt answers a wav (K2 once a decode step, K1 109
    times a vocode).  Returns the launches by kernel over the served
    requests, and what the tools phase reads: the run's directory (which the
    caller removes), model_epoch_1, the data and that request's codes."""
    import shutil
    import tempfile

    import numpy as np
    from scipy.io import wavfile
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.config import Config, TrainConfig
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.train import lora, run as run_mod, trainer
    from indextts_tpu_torch.utils.textnorm import TextNormalizer
    from indextts_tpu_torch.utils.tokenizer import TextTokenizer

    t_phase = time.perf_counter()
    model_dir = os.path.join(HERE, "checkpoints_test")
    tokenizer = TextTokenizer(os.path.join(model_dir, "vocab.txt"), TextNormalizer())
    lora_small_agreement(torch, Config, TrainConfig, uv, trainer, lora)
    lora_small_resume(torch, Config, run_mod, tokenizer, out_dir)

    root = tempfile.mkdtemp(dir=out_dir, prefix="lora_full_")
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    counts = write_finetune_data(data, tokenizer, np.random.default_rng(4), clips=128,
                                 valid=4, codes=(150, 450), text_tokens=(20, 120), width=1280)
    data_s = time.perf_counter() - t0
    cfg = Config.from_dict({"train": {"epochs": 2, "max_steps_per_epoch": 32,
                                      "finetune_model_dir": os.path.join(root, "out"),
                                      "data_path": data}})
    t = run_mod.Trainer(cfg, model_dir, run_name="full", device="cuda")

    # each micro-step between two CUDA events on the stream (no sync), with
    # its batch's widths and target tokens
    steps = []
    inner = trainer.train_step

    def timed(state, base, batch, *args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(state, base, batch, *args, **kw)
        e1.record()
        steps.append((e0, e1, batch, out[1]))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step = timed
    t0 = time.perf_counter()
    try:
        t.train()
    finally:
        trainer.train_step = inner
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [a.elapsed_time(b) for a, b, _, _ in steps]
    widths = sorted({(tuple(b.text_ids.shape), tuple(b.mel_codes.shape),
                      tuple(b.cond_mel.shape)) for _, _, b, _ in steps})
    targets = sum(int((b.text_lengths + 1).sum() + (b.codes_lengths + 1).sum())
                  for _, _, b, _ in steps)
    flops = sum(train_step_flops(b.text_ids.shape[0], b.text_ids.shape[1],
                                 b.mel_codes.shape[1], cfg.gpt) for _, _, b, _ in steps)
    losses = torch.stack([m["loss"] for *_, m in steps]).cpu()
    skipped = float(torch.stack([m["skipped"] for *_, m in steps]).sum())
    names = set(os.listdir(t.out_dir))
    want_names = {"checkpoint_epoch_0", "checkpoint_epoch_1", "model_epoch_0", "model_epoch_1",
                  "gpt_epoch_1.pth", "gpt_epoch_2.pth", "gpt_best.pth", "gpt_finetuned.pth",
                  "config_finetuned.yaml"}

    # the optimizer update alone, on the run's adapters and state
    grads = lora.tree_map(lambda x: torch.randn_like(x) * 1e-3, t.state.lora_params)
    for _ in range(3):
        t.optimizer.step(grads, t.state.opt_state, t.state.lora_params)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        t.optimizer.step(grads, t.state.opt_state, t.state.lora_params)
    e1.record()
    torch.cuda.synchronize()
    opt_ms = e0.elapsed_time(e1) / 20

    # one micro-step under the profiler (its result is dropped)
    last = steps[-1][2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        trainer.train_step(t.state, t.base_params, last, cfg.gpt, t.tc.lora, t.optimizer,
                           t.tc.text_weight)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    launched = kernel_events(torch, events)
    busy_us = sum(dev(e) for e in launched)
    ops = sum(e.count for e in launched)
    top = sorted((e for e in events if e not in launched), key=dev, reverse=True)[:10]
    step_ms = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
    emit({"phase": "lora fine-tune, full width, bf16 base, Trainer at the TrainConfig defaults "
                   "(epochs=2, max_steps_per_epoch=32)", "card": card_line(),
          "data": counts, "data_s": data_s, "micro_steps": len(steps),
          "updates": int(t.state.opt_state["count"]), "micro_batch": t.loader.batch_size,
          "accumulation": t.accum_steps, "train_s": train_s,
          "micro_step_ms_median": step_ms, "micro_step_ms_first": ms[0],
          "micro_step_ms_min_max": [min(ms), max(ms)],
          "optimizer_update_ms": opt_ms,
          "target_tokens_per_s": targets / (sum(ms) / 1e3),
          "batch_widths_text_codes_cond": [list(w) for w in widths],
          "peak_mem_gib": peak_gib,
          "model_flops_share_bf16_peak": flops / (sum(ms) / 1e3) / BF16_FLOPS,
          "model_tflops": flops / (sum(ms) / 1e3) / 1e12,
          "losses_first_last": [float(losses[0]), float(losses[-1])], "skipped": skipped,
          "best_val": t.best_val, "artifacts": sorted(names & want_names)})
    emit({"phase": "lora fine-tune micro-step profile (full width, one micro-step of 8)",
          "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / wall, "device_ops": ops,
          "top_ops_device_ms": {e.key: dev(e) / 1e3 for e in top},
          "top_kernels_device_ms": {e.key[:80]: dev(e) / 1e3 for e in
                                    sorted(launched, key=dev, reverse=True)[:6]}})
    if not bool(torch.isfinite(losses).all()) or skipped or not want_names <= names \
            or int(t.state.opt_state["count"]) != 4:
        raise SmokeFailure(f"lora full width: losses {losses.tolist()}, skipped {skipped}, "
                           f"missing {sorted(want_names - names)}, updates "
                           f"{int(t.state.opt_state['count'])}")

    # learning: one fixed micro-batch of 8 whose codes come from 64 values
    rng = np.random.default_rng(5)
    vals = rng.choice(8192, 64, replace=False)
    B = 8
    tl, cl, ml = rng.integers(20, 120, B), rng.integers(150, 450, B), rng.integers(600, 1800, B)
    text, codes = np.zeros((B, 128), np.int64), np.zeros((B, 480), np.int64)
    for i in range(B):
        text[i, :tl[i]] = rng.integers(2, 12000, tl[i])
        codes[i, :cl[i]] = rng.choice(vals, cl[i])
    batch = trainer.Batch(*(torch.from_numpy(x).cuda() for x in (
        text, tl, codes, cl, rng.standard_normal((B, 100, 1824)).astype(np.float32), ml)))
    tc = TrainConfig.from_dict({"gradient_accumulation_steps": 1,
                                "optimizer": {"learning_rate": 1e-3}})
    opt = trainer.make_optimizer(tc, 20)
    state = trainer.init_train_state(torch.Generator(device="cuda").manual_seed(1), cfg.gpt,
                                     tc.lora, opt, "cuda")
    mel = []
    for _ in range(20):
        state, m = trainer.train_step(state, t.base_params, batch, cfg.gpt, tc.lora, opt,
                                      tc.text_weight)
        mel.append(m["loss_mel"])
    after = trainer.eval_step(state.lora_params, t.base_params, batch, cfg.gpt, tc.lora,
                              tc.text_weight)["loss_mel"]
    mel = [float(x) for x in mel] + [float(after)]
    ratio = mel[-1] / mel[0]
    emit({"check": "lora learning, full width: mel loss after 20 updates over the first",
          "mel_loss": mel, "ratio": ratio, "limit": 0.9, "ok": ratio <= 0.9})
    if not ratio <= 0.9:
        raise SmokeFailure(f"lora learning: mel loss {mel[0]} -> {mel[-1]} ({ratio:.3f})")
    del state, opt, batch

    # serve what was trained: the .pth twin and the merged directory
    merged_qkv = lora.merge(t.base_params, t.state.lora_params, t.tc.lora,
                            torch.bfloat16)["gpt"]["blocks"]["attn"]["qkv_w"]
    pth = os.path.join(t.out_dir, "gpt_finetuned.pth")
    merged_dir = os.path.join(t.out_dir, "model_epoch_1")
    del t
    torch.cuda.empty_cache()
    gen = dict(num_beams=1, do_sample=False, max_mel_tokens=200, max_text_tokens_per_sentence=120)
    launches = {n: 0 for n in kernels}
    out = {}
    for name, gpt_path, spk in (("gpt_finetuned.pth", pth, None), ("model_epoch_1", merged_dir,
                                                                   None),
                                ("gpt_finetuned.pth speaker_id", pth, "spk_a")):
        eng = engine_mod.IndexTTS(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                                  gpt_path=gpt_path)
        qkv_equal = torch.equal(eng.gpt_params["gpt"]["blocks"]["attn"]["qkv_w"], merged_qkv)
        for k in kernels.values():
            k.launches = 0
        path = os.path.join(root, f"{name.replace(' ', '_')}.wav")
        eng.infer(None if spk else prompt, LONG, path, speaker_id=spk, **gen)
        n = {k: v.launches for k, v in kernels.items()}
        s = eng.last_stats
        sr, wav = wavfile.read(path)
        out[name] = (s["codes"], n, qkv_equal)
        launches = {k: launches[k] + n[k] for k in n}
        if not qkv_equal or sr != 24000 or wav.dtype != np.int16 \
                or wav.shape[0] != sum(s["code_lens"]) * 1024 or n["K2"] != s["decode_steps"] \
                or n["K1"] != K1_PER_VOCODE * len(s["code_lens"]):
            raise SmokeFailure(f"lora served {name}: qkv_w equal {qkv_equal}, wav {sr} "
                               f"{wav.dtype} {wav.shape}, launches {n} over "
                               f"{s['decode_steps']} steps")
        del eng
        torch.cuda.empty_cache()
    a, b = out["gpt_finetuned.pth"][0], out["model_epoch_1"][0]
    codes_equal = len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    emit({"phase": "lora served: gpt_finetuned.pth and the merged directory model_epoch_1",
          "codes_equal": codes_equal, "code_lens": [len(x) for x in a],
          "qkv_w_equal_to_merge_bf16": all(v[2] for v in out.values()),
          "launches": {k: v[1] for k, v in out.items()},
          "phase_s": time.perf_counter() - t_phase})
    if not codes_equal:
        raise SmokeFailure("lora served: the .pth twin and the merged directory decode apart")
    return launches, {"root": root, "merged_dir": merged_dir, "data": data,
                      "lora_codes": b, "lora_gen": gen}


# the DVAE and extraction slice: a small model whose DVAE has 256 codes
EXTRACT_SMALL = {"gpt": SMALL_MODEL["gpt"],
                 "vqvae": {"num_tokens": 256, "hidden_dim": 32, "codebook_dim": 64,
                           "num_resnet_blocks": 2}}
CODE_MARGIN = 1e-4          # codes may part only where the two nearest columns are this close


def write_audio_list(root: str, rng, *, speakers, clips: int, seconds: tuple) -> tuple:
    """Synthetic speech-like clips, int16 WAV at 24 kHz, one directory per
    speaker: a tone with harmonics on a slow vibrato, a chirp and noise
    under a syllable-rate envelope, `seconds` long (uniform), transcripts
    from FT_SENTENCES.  Writes `root`/list.txt; returns (its path, the
    audio seconds)."""
    import numpy as np

    from indextts_tpu_torch.utils.audio import write_wav

    sr, lines, total = 24000, [], 0.0
    for spk in speakers:
        d = os.path.join(root, spk)
        os.makedirs(d, exist_ok=True)
        for i in range(clips):
            n = int(rng.uniform(*seconds) * sr)
            t = np.arange(n) / sr
            f0 = rng.uniform(90, 300) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            x = sum(np.sin(k * phase) / k for k in range(1, 6))
            x = x + 0.3 * np.sin(2 * np.pi * (200 + 400 * t / t[-1]) * t)
            x = x + 0.2 * rng.standard_normal(n)
            x = x * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
            x = 0.5 * x / np.abs(x).max()
            write_wav(os.path.join(d, f"clip{i:02d}.wav"), (x * 32767).astype(np.int16), sr)
            text = FT_SENTENCES[int(rng.integers(len(FT_SENTENCES)))]
            lines.append(f"{os.path.join(d, f'clip{i:02d}.wav')}\t{text}")
            total += n / sr
    path = os.path.join(root, "list.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path, total


def code_margins(torch, dvae, ex, wav, Fb: int):
    """Extractor `ex`'s (second-best - best) / best codebook distance at
    each code position of `wav`, over the Fb-frame row its batch gives the
    DVAE."""
    import numpy as np

    from indextts_tpu_torch.data import extract

    m = ex.cfg.dataset.mel
    F = extract.frames_for(wav.size, m.hop_length)
    Lw = (Fb - 1) * m.hop_length + m.n_fft
    row = np.zeros((1, Lw), np.float32)
    padded = np.pad(wav, (m.n_fft // 2, m.n_fft // 2), mode="reflect")[:Lw]
    row[0, : padded.size] = padded
    with torch.no_grad(), dvae.no_tf32():
        z = dvae.encode(ex.dvae_params, ex.mel_uncentered(torch.from_numpy(row).to(ex.device)),
                        ex.cfg.vqvae)[0]
        e = ex.dvae_params["codebook"]["embed"]
        dist = (z * z).sum(-1, keepdim=True) - 2.0 * z @ e + (e * e).sum(0)
        two = torch.topk(dist, 2, dim=-1, largest=False).values
    return ((two[:, 1] - two[:, 0]) / two[:, 0].abs())[: (F - F % 4) // 4].cpu().numpy()


def compare_extractions(ref_dir: str, got_dir: str, margins: dict) -> dict:
    """Two extraction directories: text files byte-equal, mels' max|diff|,
    the medoid conditioning's max|diff| / max|ref|, and the codes at the
    positions whose margin (`margins`, by codes file) exceeds CODE_MARGIN;
    the exempt positions are counted."""
    import numpy as np

    def files(d, suffix):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs if f.endswith(suffix))

    texts = files(ref_dir, ".jsonl") + ["speaker_info.json"]
    text_equal = texts == files(got_dir, ".jsonl") + ["speaker_info.json"] and all(
        open(os.path.join(ref_dir, r), "rb").read() == open(os.path.join(got_dir, r), "rb").read()
        for r in texts)
    out = {"text_files": len(texts), "text_byte_equal": text_equal, "mel_max_abs_err": 0.0,
           "cond_rel_err": 0.0, "code_positions": 0, "code_mismatches": 0, "exempt": 0,
           "distinct_codes": 0}
    if files(ref_dir, ".npy") != files(got_dir, ".npy"):
        out["text_byte_equal"] = False
        return out
    distinct = set()
    for rel in files(ref_dir, ".npy"):
        ref, got = np.load(os.path.join(ref_dir, rel)), np.load(os.path.join(got_dir, rel))
        if ref.shape != got.shape or ref.dtype != got.dtype:
            out["text_byte_equal"] = False
            continue
        if "/codes/" in rel:
            clear = margins[rel] > CODE_MARGIN
            out["code_positions"] += ref.size
            out["exempt"] += int((~clear).sum())
            out["code_mismatches"] += int((ref[clear] != got[clear]).sum())
            distinct |= set(ref.tolist())
        elif rel.endswith("medoid_condition.npy"):
            out["cond_rel_err"] = max(out["cond_rel_err"],
                                      float(np.abs(got - ref).max() / np.abs(ref).max()))
        else:
            out["mel_max_abs_err"] = max(out["mel_max_abs_err"], float(np.abs(got - ref).max()))
    out["distinct_codes"] = len(distinct)
    return out


def extraction_agrees(c: dict) -> bool:
    return (c["text_byte_equal"] and c["mel_max_abs_err"] <= 1e-4 and c["cond_rel_err"] <= 1e-4
            and c["code_mismatches"] == 0 and c["exempt"] <= 0.01 * c["code_positions"]
            and c["code_positions"] > 0)


def codebook_from_clips(torch, dvae, params, cfg, wav_paths, generator) -> None:
    """Sets a codebook drawn from the data, where a trained one sits: the
    DVAE's z at `cfg.num_tokens` random positions of the clips (with
    replacement when they hold fewer) plus noise at 0.05 of z's spread,
    embed_avg the same, cluster sizes one.  A random normal codebook sends
    every position of random weights to one code."""
    from indextts_tpu_torch.ops.mel import mel_spectrogram
    from indextts_tpu_torch.utils.audio import load_prompt_audio

    device = params["enc_conv0"]["w"].device
    zs = []
    with torch.no_grad(), dvae.no_tf32():
        for p in wav_paths:
            wav = torch.as_tensor(load_prompt_audio(p, 24000), device=device).reshape(1, -1)
            mel = mel_spectrogram(wav)
            zs.append(dvae.encode(params, mel[..., : mel.shape[-1] // 4 * 4], cfg)[0])
        z = torch.cat(zs)
        N = cfg.num_tokens
        idx = (torch.randperm(z.shape[0], generator=generator, device=device)[:N]
               if z.shape[0] >= N else
               torch.randint(z.shape[0], (N,), generator=generator, device=device))
        noise = torch.randn((N, z.shape[1]), generator=generator, device=device)
        embed = (z[idx] + 0.05 * z.std() * noise).t().contiguous()
    params["codebook"] = {"embed": embed, "cluster_size": torch.ones(N, device=device),
                          "embed_avg": embed.clone()}


def extract_small_agreement(torch, out_dir: str) -> None:
    """The card against the port on the CPU on small fp32 models (the small
    GPT, a DVAE of 256 codes of 64 dims, its codebook drawn from the clips'
    z), from the same .pth files:
    - extraction of 2 speakers x 6 clips of 1-4 s (one batch): manifests and
      speaker_info.json byte-equal, mels within 1e-4, the medoid
      conditioning within 1e-4 relative, codes equal wherever the CPU's two
      nearest columns are more than 1e-4 apart (at most 1% exempt); a planted
      fault, a dvae.pth with the most used codebook column swapped with the
      least used, must part the codes;
    - three DVAE train steps (rebalance every 2, lr 1e-5, the same normal
      draws): metrics within 1e-5 relative, codebooks and the encoder's and
      decoder's parameters within 1e-5 of each leaf's largest magnitude;
    - get_conditioning of each condition type within 1e-4 relative.
    The extraction and the train steps run with TF32 on in the global flags
    (for cuDNN and cuBLAS alike), so the checks hold the extractor's and the
    train step's own TF32 guards; the flags are restored afterwards."""
    import shutil

    import numpy as np

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.data import extract
    from indextts_tpu_torch.io import export
    from indextts_tpu_torch.models import dvae
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.train import dvae as dtrain
    from indextts_tpu_torch.train.lora import tree_map
    from indextts_tpu_torch.utils.audio import load_prompt_audio

    root = os.path.join(out_dir, "extract_small")
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir, exist_ok=True)
    cfg = Config.from_dict(EXTRACT_SMALL)
    list_path, _ = write_audio_list(root, np.random.default_rng(13), speakers=("spk_a", "spk_b"),
                                    clips=6, seconds=(1.0, 4.0))
    entries = extract.parse_audio_list(list_path)
    export.save_gpt_pth(os.path.join(model_dir, "gpt.pth"),
                        uv.init_params(cfg.gpt, torch.Generator().manual_seed(11)), cfg.gpt,
                        save_dtype="fp32")
    g = torch.Generator().manual_seed(12)
    params = dvae.init_params(cfg.vqvae, g)
    codebook_from_clips(torch, dvae, params, cfg.vqvae, [p for p, _ in entries], g)
    export.save_dvae_pth(os.path.join(model_dir, "dvae.pth"), params, cfg.vqvae)
    dirs = {dev: os.path.join(root, f"out_{dev}") for dev in ("cuda", "cpu")}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev, d in dirs.items():
            extract.extract_audio_list(list_path, d, cfg, model_dir, num_workers=4, device=dev)
        wavs = {p: np.asarray(load_prompt_audio(p, 24000), np.float32).reshape(-1)
                for p, _ in entries}
        Fb = extract.bucket_frames(max(extract.frames_for(w.size) for w in wavs.values()))
        rel = {p: os.path.join(extract.speaker_of(p), "codes",
                               os.path.splitext(os.path.basename(p))[0] + ".npy") for p in wavs}
        ex_cpu = extract.CodecExtractor(cfg, model_dir, device="cpu")
        margins = {rel[p]: code_margins(torch, dvae, ex_cpu, w, Fb) for p, w in wavs.items()}
        cmp = compare_extractions(dirs["cpu"], dirs["cuda"], margins)

        # planted fault: a dvae.pth with the most used column swapped with the
        # least used, extracted on the card
        used = np.concatenate([np.load(os.path.join(dirs["cpu"], spk, "codes", f))
                               for spk in ("spk_a", "spk_b")
                               for f in os.listdir(os.path.join(dirs["cpu"], spk, "codes"))])
        counts = np.bincount(used, minlength=cfg.vqvae.num_tokens)
        u, v = int(counts.argmax()), int(counts.argmin())      # v unused, or the least used
        fault_model = os.path.join(root, "model_fault")
        os.makedirs(fault_model, exist_ok=True)
        shutil.copy(os.path.join(model_dir, "gpt.pth"), fault_model)
        embed = params["codebook"]["embed"].clone()
        embed[:, [u, v]] = embed[:, [v, u]]
        export.save_dvae_pth(os.path.join(fault_model, "dvae.pth"),
                             {**params, "codebook": {**params["codebook"], "embed": embed}},
                             cfg.vqvae)
        faulty = os.path.join(root, "out_fault")
        extract.extract_audio_list(list_path, faulty, cfg, fault_model, num_workers=4,
                                   device="cuda")
        fault = compare_extractions(dirs["cpu"], faulty, margins)
        caught = fault["code_mismatches"] > 0

        # three DVAE train steps from the same weights and windows
        tc = dtrain.DVAETrainConfig(batch_size=8, mel_width=64, steps=3, lr=1e-5,
                                    warmup_steps=1, rebalance_every=2, rebalance_lo=0.002)
        start = dvae.init_params(cfg.vqvae, torch.Generator().manual_seed(14))
        windows = dtrain.mel_window_batches(dtrain.discover_mels(dirs["cpu"]), 8, 64, seed=15)
        g = torch.Generator().manual_seed(16)
        steps = [(torch.from_numpy(next(windows)),
                  torch.randn((cfg.vqvae.codebook_dim, cfg.vqvae.num_tokens), generator=g))
                 for _ in range(3)]
        runs = {}
        for dev in ("cuda", "cpu"):
            opt = dtrain.make_optimizer(tc)
            state = dtrain.init_state(cfg.vqvae, opt, params=start, device=dev)
            metrics = []
            for mel, noise in steps:
                state, m = dtrain.train_step(state, mel.to(dev), cfg.vqvae, opt, tc,
                                             noise=noise.to(dev))
                metrics.append({k: float(x) for k, x in m.items()})
            runs[dev] = (state, metrics)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                     for a, b in zip(runs["cuda"][1], runs["cpu"][1]) for k in b)
    codebook_err = _leaf_rel_err(torch, runs["cuda"][0].params["codebook"],
                                 runs["cpu"][0].params["codebook"])
    params_err = _leaf_rel_err(torch, {k: v for k, v in runs["cuda"][0].params.items()
                                       if k != "codebook"},
                               {k: v for k, v in runs["cpu"][0].params.items() if k != "codebook"})
    resets = sum(m["codes_reset"] for m in runs["cpu"][1])

    # get_conditioning of every condition type
    mel = torch.from_numpy(np.load(os.path.join(dirs["cpu"], "spk_a", "medoid_mel.npy")))[None]
    cond_err = {}
    for ctype in ("conformer_perceiver", "conformer_encoder", "perceiver", "default_mean"):
        c = Config.from_dict({"gpt": {**EXTRACT_SMALL["gpt"], "condition_type": ctype}}).gpt
        enc, perc = uv.init_conditioning_params(c, torch.Generator().manual_seed(17))
        ref = uv.get_conditioning({"conditioning_encoder": enc, "perceiver_encoder": perc}, c,
                                  mel, torch.tensor([mel.shape[-1]]))
        on_card = tree_map(lambda x: x.cuda(), {"conditioning_encoder": enc,
                                                "perceiver_encoder": perc})
        got = uv.get_conditioning(on_card, c, mel.cuda(), torch.tensor([mel.shape[-1]]).cuda())
        cond_err[ctype] = float((got.cpu() - ref).abs().max() / ref.abs().max())
    emit({"check": "extract and DVAE, small fp32 models: the card against the port on the CPU",
          "extraction": cmp, "planted_fault": {"swapped_columns": [u, v], **fault,
                                               "uses": [int(counts[u]), int(counts[v])],
                                               "caught": caught},
          "train_steps": {"metric_rel_err": metric_err, "codebook_rel_err": codebook_err,
                          "params_rel_err": params_err, "codes_reset": resets},
          "global_tf32_in_extraction_and_steps": True,
          "get_conditioning_rel_err": cond_err,
          "tol": {"mel": 1e-4, "cond": 1e-4, "codes_exempt_share": 0.01, "metrics": 1e-5,
                  "codebook": 1e-5, "params": 1e-5, "get_conditioning": 1e-4}})
    if not extraction_agrees(cmp) or not caught or metric_err > 1e-5 or codebook_err > 1e-5 \
            or params_err > 1e-5 or resets == 0 or max(cond_err.values()) > 1e-4:
        raise SmokeFailure(f"extract small: {cmp}, fault caught {caught}, train metrics "
                           f"{metric_err}, codebook {codebook_err}, params {params_err}, "
                           f"resets {resets}, conditioning {cond_err}")


def dvae_step_flops(cfg, B: int, W: int) -> tuple:
    """Model FLOPs of one DVAE train step from the shapes: per window of W
    frames the forward's products (2 x in x out x k a conv output position:
    the two stride-2 convs at W/2 and W/4, the residual blocks, the output
    conv and the decoder's input conv at W/4, the up-convs at W/2 and W, the
    output conv at W; the quantizer's distances 2 x D x N at W/4), the
    backward twice the convs' forward but for the first conv's input
    gradient, and per step the EMA's one-hot product 2 x (B W/4) x D x N.
    Returns (forward per window, per step)."""
    C, H, D, N, k, n = cfg.channels, cfg.hidden_dim, cfg.codebook_dim, cfg.num_tokens, \
        cfg.kernel_size, cfg.num_resnet_blocks
    H2, q = 2 * H, W // 4
    res = n * 2 * H2 * H2 * (2 * k + 1) * q
    first = 2 * C * H * k * (W // 2)
    convs = (first + 2 * H * H2 * k * q + res + 2 * H2 * D * q          # encoder
             + 2 * D * H2 * q + res + 2 * H2 * H2 * k * (W // 2)         # decoder
             + 2 * H2 * H * k * W + 2 * H * C * W)
    dist = 2 * D * N * q
    per_window = 3 * convs - first + dist
    return convs + dist, B * per_window + 2 * B * q * D * N


def extract_and_dvae(torch, out_dir: str) -> str:
    """The DVAE and extraction slice (extraction, DVAE training, dvae.pth,
    every conditioning type): the small models' card-against-CPU checks,
    then at full width with random weights from fixed seeds (the flagship
    GPT, 24 layers 1280 wide, and the shipped DVAE, 8192 codes of 512 dims,
    its codebook drawn from the clips' z), written as gpt.pth (fp16) and
    dvae.pth with the port's exporters:
    - extraction of 2 speakers x 24 clips of 1-15 s at batch 16 with the
      conditioning: clips/s, audio s per wall s, each stage's ms a batch
      (CUDA events), peak memory, distinct codes, decode and .npy-write s;
    - DVAE training through its CLI, fine-tuning that dvae.pth (`--init`)
      on that output at the DVAETrainConfig defaults (batch 32, width 256)
      for 40 steps: step ms, windows/s, peak memory, a model-FLOPs share of
      the fp32 peak (TF32 off), a profile of one step; every loss finite,
      the codebook moved, the written dvae_step_40 equal to the last state;
    - the trained weights through save_dvae_pth and load_dvae_checkpoint,
      one speaker extracted again with them, and the LoRA Trainer for 4
      micro-steps on the extracted manifests;
    - get_conditioning of each condition type on a 10 s mel, ms a call.
    None of this reaches K1-K4; the phase checks that none launches.
    Returns the directory of its files (the model, the extraction output),
    which the vocoder phase reads and the caller removes."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.data import extract
    from indextts_tpu_torch.io import checkpoint, export, from_jax
    from indextts_tpu_torch.models import dvae
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.ops.cuda import anti_alias, decode_layer, permute, pool_trunk
    from indextts_tpu_torch.train import dvae as dtrain
    from indextts_tpu_torch.train import run as run_mod
    from indextts_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    kernels = [anti_alias.fused_anti_alias_activation, decode_layer.fused_decode_trunk_flat,
               permute.permute_cache_rows, pool_trunk.fused_pool_step]
    for k in kernels:
        k.launches = 0
    extract_small_agreement(torch, out_dir)
    small_s = time.perf_counter() - t_phase

    root = tempfile.mkdtemp(dir=out_dir, prefix="extract_full_")
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    shutil.copy(os.path.join(HERE, "checkpoints_test", "vocab.txt"), model_dir)
    cfg = Config()
    list_path, audio_s = write_audio_list(root, np.random.default_rng(22),
                                          speakers=("spk_a", "spk_b"), clips=24,
                                          seconds=(1.0, 15.0))
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(21)
    export.save_gpt_pth(os.path.join(model_dir, "gpt.pth"),
                        uv.init_params(cfg.gpt, g, torch.float32, "cuda"), cfg.gpt)
    params = dvae.init_params(cfg.vqvae, g, torch.float32, "cuda")
    codebook_from_clips(torch, dvae, params, cfg.vqvae,
                        [p for p, _ in extract.parse_audio_list(list_path)], g)
    export.save_dvae_pth(os.path.join(model_dir, "dvae.pth"), params, cfg.vqvae)
    del params
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0

    # extraction: each stage between CUDA events, the extractor's load,
    # decode and writes on the host's clock (the methods wrapped on the class)
    stages = {"mel": [], "dvae_encode_quantize": [], "conditioning": []}

    def timed(name, fn):
        def run(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            stages[name].append((e0, e1))
            return out
        return run

    host = {"extractor_load": [], "decode": [], "npy_write": []}

    def clocked(name, fn, sync=False):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            host[name].append(time.perf_counter() - t)
            return out
        return run

    Ex = extract.CodecExtractor
    methods = {n: getattr(Ex, n) for n in ("__init__", "mel_uncentered", "codes",
                                            "conditioning")}
    load_audio, save = extract.audio_io.load_prompt_audio, np.save
    out_b = os.path.join(root, "extracted")
    torch.cuda.reset_peak_memory_stats()
    Ex.__init__ = clocked("extractor_load", methods["__init__"], sync=True)
    Ex.mel_uncentered = timed("mel", methods["mel_uncentered"])
    Ex.codes = timed("dvae_encode_quantize", methods["codes"])
    Ex.conditioning = timed("conditioning", methods["conditioning"])
    extract.audio_io.load_prompt_audio = clocked("decode", load_audio)
    np.save = clocked("npy_write", save)
    try:
        t0 = time.perf_counter()
        info = extract.extract_audio_list(list_path, out_b, cfg, model_dir, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        extract.audio_io.load_prompt_audio, np.save = load_audio, save
        for n, f in methods.items():
            setattr(Ex, n, f)
    load_s = sum(host["extractor_load"])
    wall -= load_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stage_ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in stages.items()}
    busy_s = sum(sum(v) for v in stage_ms.values()) / 1e3
    codes = [np.load(os.path.join(out_b, spk, "codes", f)) for spk in ("spk_a", "spk_b")
             for f in sorted(os.listdir(os.path.join(out_b, spk, "codes")))]
    n_clips = sum(st["num_clips"] for st in info.values())
    emit({"phase": "extraction, full width (flagship GPT conditioning, the shipped DVAE), "
                   "batch 16, with the conditioning", "card": card_line(),
          "clips": n_clips, "audio_s": audio_s, "batches": len(stage_ms["mel"]),
          "weights_write_s": write_s, "extractor_load_s": load_s,
          "wall_s": wall, "wall_note": "extract_audio_list's wall less the extractor's load",
          "clips_per_s": n_clips / wall, "audio_s_per_wall_s": audio_s / wall,
          "stage_ms_per_batch": stage_ms, "stage_device_s": busy_s,
          "wall_outside_stage_events_s": wall - busy_s,
          "decode_s_summed_over_threads": sum(host["decode"]),
          "npy_write_s": sum(host["npy_write"]), "peak_mem_gib": peak,
          "codes": sum(c.size for c in codes),
          "distinct_codes": len(set(np.concatenate(codes).tolist())),
          "codes_dtype": str(codes[0].dtype)})
    if n_clips != 48 or codes[0].dtype != np.int32 or \
            not os.path.exists(os.path.join(out_b, "spk_b", "medoid_condition.npy")):
        raise SmokeFailure(f"extraction full width: {n_clips} clips, {codes[0].dtype}")
    torch.cuda.empty_cache()

    # DVAE training on the extracted mels through the CLI, fine-tuning the
    # dvae.pth (the DVAETrainConfig defaults, 40 steps), each step between
    # CUDA events
    tc = dtrain.DVAETrainConfig(steps=40)
    steps, last = [], []
    inner = dtrain.train_step

    def timed_step(state, mel, *args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if not steps:
            steps.append(state.params["codebook"]["embed"].clone())
        e0.record()
        out = inner(state, mel, *args, **kw)
        e1.record()
        steps.append((e0, e1, out[1]["loss"], mel))
        last[:] = [out[0]]
        return out

    mels = dtrain.discover_mels(out_b)
    run_dir = os.path.join(root, "dvae_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dtrain.train_step = timed_step
    t0 = time.perf_counter()
    try:
        dtrain.main(["--mels", out_b, "--out", run_dir, "--steps", str(tc.steps),
                     "--init", os.path.join(model_dir, "dvae.pth"), "--device", "cuda"])
    finally:
        dtrain.train_step = inner
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = last[0]
    trained = checkpoint.load_pytree(os.path.join(run_dir, f"dvae_step_{tc.steps}"),
                                     device="cuda")["params"]
    written = _trees_equal(torch, trained, state.params)
    first_embed, steps = steps[0], steps[1:]
    ms = [a.elapsed_time(b) for a, b, _, _ in steps]
    losses = torch.stack([x for _, _, x, _ in steps]).cpu()
    moved = float((state.params["codebook"]["embed"] - first_embed).abs().max())
    fwd_window, step_flops = dvae_step_flops(cfg.vqvae, tc.batch_size, tc.mel_width)
    step_ms = float(np.median(ms[1:]))
    opt = dtrain.make_optimizer(tc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        inner(state, steps[-1][3], cfg.vqvae, opt, tc)
        torch.cuda.synchronize()
        wall_step = time.perf_counter() - w0
    launched = kernel_events(torch, prof.key_averages())
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    busy_us = sum(dev(e) for e in launched)
    emit({"phase": "DVAE training, the shipped DVAE (8192 codes of 512), DVAETrainConfig "
                   "defaults (batch 32, width 256), 40 steps, fp32 with TF32 off",
          "card": card_line(), "mel_files": len(mels), "train_s": train_s,
          "step_ms_median": step_ms, "step_ms_first": ms[0], "step_ms_min_max": [min(ms),
                                                                                 max(ms)],
          "windows_per_s": tc.batch_size / (step_ms / 1e3), "peak_mem_gib": train_peak,
          "model_gflop_forward_per_window": fwd_window / 1e9,
          "model_gflop_per_step": step_flops / 1e9,
          "model_flops_share_fp32_peak": step_flops / (step_ms / 1e3) / FP32_FLOPS,
          "flops_formula": "per window 3 x convs (forward, activation and weight gradients) "
                           "- the first conv's input gradient + the quantizer distances "
                           "2 D N W/4; per step B x that + the EMA's one-hot product "
                           "2 (B W/4) D N; over 67e12 fp32",
          "losses_first_last": [float(losses[0]), float(losses[-1])],
          "codebook_moved_max_abs": moved, "checkpoint_equals_last_state": written,
          "profile_one_step": {"wall_ms": wall_step * 1e3, "device_busy_ms": busy_us / 1e3,
                               "device_busy_share": busy_us / 1e6 / wall_step,
                               "kernels": sum(e.count for e in launched),
                               "top_kernels_device_ms": {
                                   e.key[:80]: dev(e) / 1e3 for e in
                                   sorted(launched, key=dev, reverse=True)[:6]}},
          "checkpoints": sorted(os.listdir(os.path.join(root, "dvae_run")))})
    if not bool(torch.isfinite(losses).all()) or not moved > 0 or len(ms) != 40 \
            or not written:
        raise SmokeFailure(f"DVAE training: losses {losses.tolist()}, moved {moved}, "
                           f"checkpoint equal {written}")

    # close the loop: trained dvae.pth -> extraction of one speaker -> the LoRA Trainer
    model2 = os.path.join(root, "model_trained")
    os.makedirs(model2)
    for f in ("vocab.txt", "gpt.pth"):
        os.link(os.path.join(model_dir, f), os.path.join(model2, f))
    export.save_dvae_pth(os.path.join(model2, "dvae.pth"), trained, cfg.vqvae)
    back = from_jax.dvae_params_from_numpy(
        checkpoint.load_dvae_checkpoint(os.path.join(model2, "dvae.pth"), cfg.vqvae), cfg.vqvae,
        device="cuda")
    round_trip = _trees_equal(torch, back, trained)
    list_a = os.path.join(root, "list_a.txt")
    with open(list_path, encoding="utf-8") as f, open(list_a, "w", encoding="utf-8") as g2:
        g2.writelines(l for l in f if f"{os.sep}spk_a{os.sep}" in l)
    out_a = os.path.join(root, "extracted_trained")
    extract.extract_audio_list(list_a, out_a, cfg, model2, device="cuda")
    changed = total = 0
    for f in os.listdir(os.path.join(out_a, "spk_a", "codes")):
        a = np.load(os.path.join(out_a, "spk_a", "codes", f))
        b = np.load(os.path.join(out_b, "spk_a", "codes", f))
        changed, total = changed + int((a != b).sum()), total + a.size
    del state, last, trained, back
    torch.cuda.empty_cache()
    tcfg = Config.from_dict({"train": {"epochs": 1, "max_steps_per_epoch": 4,
                                       "finetune_model_dir": os.path.join(root, "ft"),
                                       "data_path": out_b}})
    lora_losses = []
    inner_lora = trainer.train_step

    def lora_step(*args, **kw):
        out = inner_lora(*args, **kw)
        lora_losses.append(out[1]["loss"])
        return out

    trainer.train_step = lora_step
    try:
        t0 = time.perf_counter()
        t = run_mod.Trainer(tcfg, model_dir, run_name="extracted", device="cuda")
        t.train()
        lora_s = time.perf_counter() - t0
    finally:
        trainer.train_step = inner_lora
    lora_losses = torch.stack(lora_losses).float().cpu()
    finetuned = os.path.exists(os.path.join(t.out_dir, "gpt_finetuned.pth"))
    del t
    torch.cuda.empty_cache()
    emit({"phase": "the loop closed: trained dvae.pth, one speaker extracted again, the LoRA "
                   "Trainer at full width on the extracted manifests",
          "dvae_pth_mb": os.path.getsize(os.path.join(model2, "dvae.pth")) / 2 ** 20,
          "dvae_pth_round_trip_bit_equal": round_trip,
          "reextracted_codes": total, "codes_changed_by_training": changed,
          "lora_micro_steps": len(lora_losses), "lora_losses": lora_losses.tolist(),
          "lora_s": lora_s, "gpt_finetuned_pth": finetuned})
    if not round_trip or total == 0 or len(lora_losses) != 4 \
            or not bool(torch.isfinite(lora_losses).all()) or not finetuned:
        raise SmokeFailure(f"the loop: round trip {round_trip}, {total} codes, losses "
                           f"{lora_losses.tolist()}, gpt_finetuned.pth {finetuned}")

    # get_conditioning of each condition type at full width on a 10 s mel
    mel = torch.randn((1, 100, 938), generator=torch.Generator(device="cuda").manual_seed(23),
                      device="cuda")
    lens = torch.tensor([938], device="cuda")
    cond_ms = {}
    for ctype in ("conformer_perceiver", "conformer_encoder", "perceiver", "default_mean"):
        c = Config.from_dict({"gpt": {"condition_type": ctype}}).gpt
        enc, perc = uv.init_conditioning_params(
            c, torch.Generator(device="cuda").manual_seed(24), torch.float32, "cuda")
        params = {"conditioning_encoder": enc, "perceiver_encoder": perc}
        with torch.no_grad():
            out = uv.get_conditioning(params, c, mel, lens)
            cond_ms[ctype] = {"ms": cuda_ms(lambda: uv.get_conditioning(params, c, mel, lens),
                                            [()], 10, graph=False),
                              "shape": list(out.shape),
                              "finite": bool(torch.isfinite(out).all())}
        del params, enc, perc
    launched_k = [k.launches for k in kernels]
    emit({"phase": "get_conditioning, full width (D 1280), fp32, a 10 s mel (938 frames)",
          "card": card_line(), "per_type": cond_ms, "kernel_launches_in_phase": launched_k,
          "phase_s": time.perf_counter() - t_phase, "small_checks_s": small_s})
    if not all(v["finite"] for v in cond_ms.values()) or any(launched_k):
        raise SmokeFailure(f"get_conditioning: {cond_ms}; K1-K4 launches {launched_k}")
    return root


# ---------------------------------------------------------------------------
# vocoder fine-tuning: K1b, the small card-vs-CPU step, full-width training
# ---------------------------------------------------------------------------

VOC_CODES = 24              # VocoderTrainConfig's segment: 24 codes, 24,576 samples
K1B_FLOPS_PER_ELEM = 92     # 36 FMAs (u, Down^T, Up^T) as flops, 20 for the two snakes' derivatives
# T < 6: both edges' clamps overlap; 95, 97, 385, 6143: the scalar path (T % 4 != 0); 95,
# 97, 100: short rows, 8- and 16-lane segments with idle lanes; 385, 772, 6143: rows of
# several 384-column chunks with a ragged final step (1, 4 and 383 columns)
K1B_EDGE_TS = (1, 2, 3, 5, 7, 95, 97, 100, 257, 385, 772, 6143)
K1B_TOL_X = 1e-5            # grad_x: max|diff| / max|plain|, fp32 (tap order, __sincosf)
K1B_TOL_AB = 1e-4           # grad_alpha, grad_beta: sums over B x 2T terms in another order


def vocoder_stage_shapes(B: int, codes: int):
    """[B, C, T] of the activations at the six BigVGAN stages for `codes`
    latent frames, and each shape's calls per generator forward."""
    C0, rates = 1536, [4, 4, 4, 4, 2, 2]
    shapes, T = [], codes
    for i, u in enumerate(rates):
        T *= u
        shapes.append((B, C0 // 2 ** (i + 1), T))
    counts = {s: 18 for s in shapes}
    counts[shapes[-1]] += 1
    return shapes, counts


def k1b_inputs(torch, g, B: int, C: int, T: int, logscale: bool = True):
    x = torch.randn(B, C, T, generator=g, device="cuda")
    gy = torch.randn(B, C, T, generator=g, device="cuda")
    a = 0.3 * torch.randn(C, generator=g, device="cuda")
    b = 0.3 * torch.randn(C, generator=g, device="cuda")
    if not logscale:
        a, b = a.abs() + 0.5, b.abs() + 0.5
    return x, a, b, gy


def k1b_errors(got, ref) -> dict:
    """max|diff| / max|plain| for grad_x, grad_alpha, grad_beta."""
    return {k: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for k, a, b in zip(("grad_x", "grad_alpha", "grad_beta"), got, ref)}


def k1b_within(errs: dict) -> bool:
    return errs["grad_x"] <= K1B_TOL_X and max(errs["grad_alpha"],
                                               errs["grad_beta"]) <= K1B_TOL_AB


def k1b_plan(B: int, C: int, T: int, logscale: bool = True) -> dict:
    """The plan the K1b wrapper chose for a [B, C, T] call on card 0 (rows
    16-byte aligned where T % 4 == 0), after that call."""
    from indextts_tpu_torch.ops.cuda import anti_alias

    plan = anti_alias.chosen_plan(B, C, T, T % 4 == 0, 0, logscale) or {}
    return {k: plan[k] for k in ("seg_lanes", "vec", "multi_row", "steps", "pieces", "blocks")
            if k in plan}


def kernel_checks_anti_alias_backward(torch, filters, anti_alias):
    """K1b against its plain version (ops/filters.anti_aliased_activation_
    backward) in fp32 at the six stage shapes of a vocoder training step
    (batch 8, 24 codes; timed) and at each T of K1B_EDGE_TS (B = 2, C = 3,
    logscale on and off) under the card's plan and two forced ones: 3 steps
    a segment on one SM's worth of segments (long-lived segments, a ragged
    last piece) and the scalar path on an aligned row; two runs bit-equal at
    the largest shape; a planted fault (the plain grad_alpha without its
    logscale factor) that the check must reject; and a bf16 input refused.
    Returns its kernels-line entry: times summed over one training step's
    109 calls."""
    k1b, backward_plan = anti_alias.anti_alias_activation_backward, anti_alias.backward_plan
    g = torch.Generator(device="cuda").manual_seed(31)
    shapes, counts = vocoder_stage_shapes(8, VOC_CODES)
    worst = 0.0
    per_shape = {}
    for B, C, T in shapes:
        x, a, b, gy = k1b_inputs(torch, g, B, C, T)
        errs = k1b_errors(k1b(x, a, b, gy), filters.anti_aliased_activation_backward(x, a, b, gy))
        nbytes = 4 * B * C * T
        n_sets = max(2, min(16, math.ceil(100e6 / (2 * nbytes))))
        sets = [(x, a, b, gy)] + [k1b_inputs(torch, g, B, C, T) for _ in range(n_sets - 1)]
        iters = max(20, len(sets))
        bb = (3 * nbytes + 4 * 4 * C) / HBM_BYTES_PER_S * 1e3
        bo = K1B_FLOPS_PER_ELEM * B * C * T / FP32_FLOPS * 1e3
        t = {"ms": cuda_ms(k1b, sets, iters), "eager_ms": cuda_ms(k1b, sets, iters, graph=False),
             "plain_ms": cuda_ms(filters.anti_aliased_activation_backward, sets[:2], 3,
                                 graph=False),
             "bound_ms": max(bb, bo), "bound_by": "bytes" if bb >= bo else "operations"}
        plan = k1b_plan(B, C, T)
        per_shape[f"B={B} C={C} T={T}"] = {**t, "share_of_bound": t["bound_ms"] / t["ms"],
                                           "calls_per_step": counts[(B, C, T)], "plan": plan}
        worst = max(worst, max(errs.values()))
        emit({"check": f"K1b anti_alias_backward fp32 B={B} C={C} T={T}", **errs,
              "tol_grad_x": K1B_TOL_X, "tol_grad_alpha_beta": K1B_TOL_AB,
              "ok": k1b_within(errs), **t})
        if not k1b_within(errs):
            raise SmokeFailure(f"K1b at {(B, C, T)}: {errs}")
        del sets
    for logscale in (True, False):
        for T in K1B_EDGE_TS:
            x, a, b, gy = k1b_inputs(torch, g, 2, 3, T, logscale)
            ref = filters.anti_aliased_activation_backward(x, a, b, gy, logscale)
            plans = {"card": None,
                     "steps3": backward_plan(2, 3, T, T % 4 == 0, 1, 1, steps=3),
                     "scalar": backward_plan(2, 3, T, False, 1, 1, steps=2)}
            errs = {name: k1b_errors(anti_alias._backward(x, a, b, gy, logscale, plan), ref)
                    for name, plan in plans.items()}
            within = all(k1b_within(e) for e in errs.values())
            worst = max([worst] + [max(e.values()) for e in errs.values()])
            emit({"check": f"K1b anti_alias_backward fp32 B=2 C=3 T={T} logscale={logscale}",
                  **errs["card"], "forced_plans": {n: errs[n] for n in ("steps3", "scalar")},
                  "plan": k1b_plan(2, 3, T, logscale), "ok": within})
            if not within:
                raise SmokeFailure(f"K1b at T={T} logscale={logscale}: {errs}")
    # two runs bit-equal; a planted fault rejected; bf16 refused
    x, a, b, gy = k1b_inputs(torch, g, *shapes[-1])
    first, second = k1b(x, a, b, gy), k1b(x, a, b, gy)
    bit_equal = all(torch.equal(p, q) for p, q in zip(first, second))
    gx, ga, gb = filters.anti_aliased_activation_backward(x, a, b, gy)
    planted = k1b_errors(first, (gx, ga / torch.exp(a), gb))
    try:
        k1b(x.bfloat16(), a, b, gy.bfloat16())
        refused = False
    except ValueError:
        refused = True
    emit({"check": "K1b determinism, planted fault, bf16 refused", "shape": list(shapes[-1]),
          "two_runs_bit_equal": bit_equal, "planted_fault": "grad_alpha without the logscale "
          "factor exp(alpha)", "planted_fault_errs": planted,
          "planted_fault_rejected": not k1b_within(planted), "bf16_refused": refused})
    if not bit_equal or k1b_within(planted) or not refused:
        raise SmokeFailure(f"K1b: bit-equal {bit_equal}, planted fault {planted}, "
                           f"bf16 refused {refused}")

    def total(key):
        return sum(per_shape[f"B={B} C={C} T={T}"][key] * counts[(B, C, T)]
                   for B, C, T in shapes)

    bb = sum(counts[s] * (3 * 4 * s[0] * s[1] * s[2] + 16 * s[1]) for s in shapes) \
        / HBM_BYTES_PER_S * 1e3
    bo = sum(counts[s] * K1B_FLOPS_PER_ELEM * s[0] * s[1] * s[2] for s in shapes) \
        / FP32_FLOPS * 1e3
    return {"name": "anti_alias_activation_backward", "route": "cuda",
            "source": "indextts_tpu_torch/csrc/anti_alias_backward.cu",
            "replaces": "indextts_tpu/ops/pallas/anti_alias.py:242 (its backward: the TPU "
                        "kernel has none, JAX differentiates the XLA composition)",
            "max_abs_err": worst, "tolerance": f"max|diff| / max|plain|: grad_x {K1B_TOL_X}, "
                                               f"grad_alpha and grad_beta {K1B_TOL_AB}",
            "ms": total("ms"), "eager_ms": total("eager_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bb, bo), "bound_by": "bytes" if bb >= bo else "operations",
            "library_ms": None,
            "per": f"one fp32 vocoder training step (batch 8, {VOC_CODES} codes): 109 calls "
                   "over 6 shapes",
            "per_shape": per_shape}


def vocoder_step_flops(cfg, tc) -> dict:
    """Model FLOPs of one vocoder GAN step from the shapes: the generator's
    convolutions (2 x in x out x k an output position; a transposed conv
    counted over its input positions) and K1's work per activation element;
    each sub-discriminator's convolutions.  A step runs the generator
    forward once and its backward (2x), the discriminators forward 4 times
    (real and generated, each side of the update; the update's two with
    weight and input gradients, 2x each; the generator's side with input
    gradients only on the generated half).  ECAPA, the STFTs and the mel
    losses are left out."""
    B, T = tc.batch_size, tc.segment_codes
    C = cfg.upsample_initial_channel
    gen = 2 * cfg.gpt_dim * C * 7 * T
    elems = 0
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        gen += 2 * C * (C // 2) * k * T
        T, C = T * u, C // 2
        for kr, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            gen += len(dils) * 2 * (2 * C * C * kr * T)
            elems += 2 * len(dils) * C * T
    elems += C * T
    gen += 2 * C * 7 * T + K1_FLOPS_PER_ELEM * elems
    dis = 0
    chans = [1, 32, 128, 512, 1024, 1024]
    for p in tc.periods:
        H = -(-T // p)
        for i in range(5):
            H = (H - 1) // (3 if i < 4 else 1) + 1
            dis += 2 * chans[i] * chans[i + 1] * 5 * H * p
        dis += 2 * 1024 * 3 * H * p
    for n_fft, hop, _ in tc.resolutions:
        pad = (n_fft - hop) // 2
        L = max(max(T, pad + 1) + 2 * pad, n_fft)
        F, W = n_fft // 2 + 1, 1 + (L - n_fft) // hop
        rch = [1, 32, 32, 32, 32, 32]
        for i, (kw, s, pw) in enumerate([(9, 1, 4), (9, 2, 4), (9, 2, 4), (9, 2, 4), (3, 1, 1)]):
            W = (W + 2 * pw - kw) // s + 1
            dis += 2 * rch[i] * rch[i + 1] * 3 * kw * F * W
        dis += 2 * 32 * 9 * F * W
    return {"generator_forward_per_sample": gen, "discriminators_forward_per_sample": dis,
            "per_step": B * (3 * gen + 9 * dis)}


def _state_to(torch, state, device):
    from indextts_tpu_torch.train.lora import tree_map

    move = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    return type(state)(move(state.gen_params), move(state.disc_floats), move(state.gen_opt),
                       move(state.disc_opt), state.step.to(device))


def gan_step_grads(torch, state, batch, aux, cfg, opt, tc):
    """The gradients of one GAN step, as train_step takes them: the
    discriminators' at the start, the generator's (and the latent's)
    against the discriminators after their update."""
    from indextts_tpu_torch.models import bigvgan, discriminators as disc
    from indextts_tpu_torch.models.dvae import no_tf32
    from indextts_tpu_torch.train import vocoder
    from indextts_tpu_torch.train.lora import tree_map

    with no_tf32(), torch.enable_grad():
        gen = tree_map(lambda p: p.detach().clone().requires_grad_(True), state.gen_params)
        latent = batch.latent.clone().requires_grad_(True)
        wav = bigvgan.forward(gen, latent, batch.mel_ref, cfg)
        T = min(wav.shape[-1], batch.wav.shape[-1])
        wav, real = wav[..., :T], batch.wav[..., :T]
        d_leaves = [p.detach().clone().requires_grad_(True) for p in state.disc_floats]
        dp = vocoder.merge_static(d_leaves, aux)
        ld = disc.discriminator_loss(disc.discriminators_forward(dp, real)[0],
                                     disc.discriminators_forward(dp, wav.detach())[0])
        d_grads = vocoder._grads(ld, d_leaves)
        with torch.no_grad():
            floats, _ = opt.step(d_grads, state.disc_opt, [p.detach() for p in d_leaves])
        dp = vocoder.merge_static(floats, aux)
        with torch.no_grad():
            _, rf = disc.discriminators_forward(dp, real)
        gs, gf = disc.discriminators_forward(dp, wav)
        lg = (disc.generator_loss(gs) + tc.feature_weight * disc.feature_loss(rf, gf)
              + tc.mel_weight * disc.multiscale_mel_loss(real[:, 0], wav[:, 0],
                                                         scales=tc.mel_scales))
        g_grads = vocoder._grads(lg, {"gen": gen, "latent": latent})
    return d_grads, g_grads


# Card-vs-CPU gradient tolerance, per leaf: (of the leaf's largest
# magnitude, of the tree's largest).  The generator's path runs K1 and K1b
# against their plain versions (fp32, __sinf/__sincosf, other tap orders).
# The discriminators' run only library convolutions: cuDNN's fp32 weight
# gradient of the second period conv sums B x positions products that cancel
# to about 1e-3 of their terms (8.8e-5 off at a largest 0.033 in a tree whose
# largest is 8.25, in the first run of this check).
GRAD_TOL = {"generator": (1e-4, 1e-7), "discriminators": (1e-3, 2e-5)}


def vocoder_small_agreement(torch) -> None:
    """One GAN step on the small fp32 generator (64 channels, the flagship's
    upsampling; weights scaled by fan-in) with two periods, one resolution
    and one mel scale, on the card (K1 forward, K1b backward) and on the
    CPU (their plain versions), from the same weights and batch: every
    gradient leaf before the optimizer, the latent's among them, within
    GRAD_TOL; conv_pre's and the latent's gradients non-zero and within
    1e-3 relative (fault C6); K1 and K1b once per activation on the card;
    then train_step on each at lr 1e-5: metrics within 1e-4, parameters
    within 2 lr (Adam lifts a near-zero gradient's rounding to about lr)."""
    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.ops.cuda import anti_alias
    from indextts_tpu_torch.train import optim, vocoder

    cfg = BigVGANConfig(**SMALL_MODEL["bigvgan"])
    tc = vocoder.VocoderTrainConfig(batch_size=2, segment_codes=8, periods=(2, 3),
                                    resolutions=((512, 50, 240),), mel_scales=((512, 128),),
                                    lr=1e-5)
    opt = vocoder.make_optimizer(tc)
    g = torch.Generator().manual_seed(41)
    cpu, aux = vocoder.init_state(g, cfg, opt, periods=tc.periods, resolutions=tc.resolutions)
    # weights scaled by fan-in (the generator's own init, std 0.01, leaves
    # conv_pre a gradient near 1e-5 of the largest, a sum that cancels) and
    # activations off their zero init
    gp = cpu.gen_params
    convs = [gp["conv_pre"], gp["conv_post"], *gp["ups"]] + [
        c for blk in gp["resblocks"] for c in blk["convs1"] + blk["convs2"]]
    for c in convs:
        w = c["w"]
        w.copy_(0.5 / math.sqrt(w.shape[-2] * w.shape[-1]) * torch.randn(w.shape, generator=g))
    for blk in gp["resblocks"]:
        for act in blk["acts"]:
            for k in ("alpha", "beta"):
                act[k].copy_(0.3 * torch.randn(act[k].shape, generator=g))
    card = _state_to(torch, cpu, "cuda")
    batch = next(vocoder.synthetic_batches(cfg, tc))
    n_acts = len(cfg.upsample_rates) * 2 * len(cfg.resblock_dilation_sizes[0]) + 1
    k1, k1b = anti_alias.fused_anti_alias_activation, anti_alias.anti_alias_activation_backward
    out = {}
    for dev, state in (("cuda", card), ("cpu", cpu)):
        b = vocoder.to_device(batch, tc.batch_size, dev)
        k1.launches = k1b.launches = 0
        grads = gan_step_grads(torch, state, b, aux, cfg, opt, tc)
        if dev == "cuda":
            torch.cuda.synchronize()
        launched = (k1.launches, k1b.launches)
        new, metrics = vocoder.train_step(state, b, aux, cfg, opt, tc)
        out[dev] = (grads, launched, new, {k: float(v) for k, v in metrics.items()})
    (dg_c, gg_c), launched, new_c, m_c = out["cuda"]
    (dg_p, gg_p), _, new_p, m_p = out["cpu"]
    worst, worst_leaf = {}, {}
    for name, a, b in (("discriminators", dg_c, dg_p), ("generator", gg_c, gg_p)):
        la, lb = optim.tree_leaves(a), optim.tree_leaves(b)
        top = max(float(x.abs().max()) for x in lb)
        leaf_tol, tree_tol = GRAD_TOL[name]
        ratios = [float((x.cpu() - y).abs().max() / (leaf_tol * y.abs().max() + tree_tol * top))
                  for x, y in zip(la, lb)]
        i = max(range(len(ratios)), key=ratios.__getitem__)
        worst[name] = ratios[i]
        worst_leaf[name] = {"leaf": i, "of": len(lb), "shape": list(lb[i].shape),
                            "max_abs_cpu": float(lb[i].abs().max()), "tree_max": top,
                            "max_abs_err": float((la[i].cpu() - lb[i]).abs().max())}
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())  # noqa: E731
    c6 = {k: {"max_abs_cpu": float(b.abs().max()), "rel_err": rel(a, b)}
          for k, a, b in (("conv_pre.w", gg_c["gen"]["conv_pre"]["w"],
                           gg_p["gen"]["conv_pre"]["w"]),
                          ("latent", gg_c["latent"], gg_p["latent"]))}
    m_err = max(abs(m_c[k] - m_p[k]) / abs(m_p[k]) for k in m_p)
    p_err = max(float((x.cpu() - y).abs().max()) for x, y in zip(
        optim.tree_leaves([new_c.gen_params, new_c.disc_floats]),
        optim.tree_leaves([new_p.gen_params, new_p.disc_floats])))
    ok = (max(worst.values()) <= 1.0 and all(v["max_abs_cpu"] > 0 and v["rel_err"] <= 1e-3
                                             for v in c6.values())
          and launched == (n_acts, n_acts) and m_err <= 1e-4 and p_err <= 2 * tc.lr)
    emit({"phase": "vocoder GAN step, small fp32 generator, card (K1, K1b) against CPU "
                   "(plain versions)", "activations": n_acts,
          "card_K1_K1b_launches_in_gradients": list(launched),
          "grad_tol_leaf_tree": GRAD_TOL, "grad_err_over_tolerance": worst,
          "worst_leaf": worst_leaf, "c6_gradients": c6,
          "metrics_cuda": m_c, "metrics_rel_err": m_err, "updated_params_max_abs_err": p_err,
          "params_tol": 2 * tc.lr, "ok": ok})
    if not ok:
        raise SmokeFailure(f"vocoder small step: grads {worst}, C6 {c6}, launches {launched}, "
                           f"metrics {m_err}, params {p_err}")


def vocoder_train(torch, engine_mod, kernels, prompt: str, root: str) -> tuple:
    """Vocoder fine-tuning at full width (BigVGAN 1536 channels, batch 8,
    24-code segments, fp32 with TF32 off, the recipe's five periods, three
    resolutions and three mel scales; random weights from seed 42):
    - 20 steps of `train_vocoder` on synthetic batches, each step between
      CUDA events, K1 and K1b launches counted a step: step ms (median, the
      first excluded), samples/s, peak memory, the model-FLOPs share of the
      fp32 peak, a profile of one step; its checkpoint loads back equal;
    - 3 steps through `python -m indextts_tpu_torch.train.vocoder
      --processed` under `python -m torch.distributed.run --nproc_per_node
      1` (an NCCL world of one; the rank reports its steps' CUDA-event ms and
      K1 and K1b launches) over the extraction output of `extract_and_dvae`
      (under `root`) with its full-width GPT, fine-tuning the first run's
      generator; its checkpoint is what the next step serves;
    - the loop closed: the trained generator, rounded to the engine's bf16
      vocoder type (so that the file's weight-norm fold lands on the same
      bf16 weights), through save_bigvgan_pth into an IndexTTS engine with
      that GPT; one greedy request: K1 109 times a vocode, K1b never, its
      vocoder output bit-equal to vocoding the captured latents with the
      in-memory generator, and the speaker similarity of its wav to the
      prompt (random weights: a number, not a quality claim).
    Returns (K1 launches, K1b launches) over these paths."""
    import numpy as np
    from scipy.io import wavfile
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.io import checkpoint, export
    from indextts_tpu_torch.models import bigvgan
    from indextts_tpu_torch.ops.cuda import anti_alias
    from indextts_tpu_torch.train import optim, vocoder
    from indextts_tpu_torch.train.lora import tree_map
    from indextts_tpu_torch.utils import eval_metrics

    k1, k1b = anti_alias.fused_anti_alias_activation, anti_alias.anti_alias_activation_backward
    cfg = BigVGANConfig()
    tc = vocoder.VocoderTrainConfig(steps=20, log_every=20, checkpoint_every=0)
    inner = vocoder.train_step
    steps, last = [], []

    def timed_step(state, batch, *args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n0 = (k1.launches, k1b.launches)
        e0.record()
        out = inner(state, batch, *args, **kw)
        e1.record()
        steps.append((e0, e1, (k1.launches - n0[0], k1b.launches - n0[1]), out[1]))
        last[:] = [out[0], batch, args]
        return out

    def launches_per_step(run):
        return sorted({run_[-2] for run_ in run})

    model_dir = os.path.join(root, "model")
    for k in kernels.values():
        k.launches = 0
    k1b.launches = 0
    run_dir = os.path.join(root, "vocoder_synthetic")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vocoder.train_step = timed_step
    try:
        t0 = time.perf_counter()
        vocoder.train_vocoder(cfg, tc, vocoder.synthetic_batches(cfg, tc), run_dir,
                              device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        synthetic, steps = steps, []
        state, batch, step_args = last
    finally:
        vocoder.train_step = inner
    n_k1, n_k1b = k1.launches, k1b.launches
    # the same loop over the extraction output, through the CLI under
    # torch.distributed.run (an NCCL world of one), from this run's generator
    export.save_bigvgan_pth(os.path.join(model_dir, "bigvgan_generator.pth"),
                            tree_map(lambda p: p.bfloat16().float(), state.gen_params), cfg)
    t0 = time.perf_counter()
    cli = torchrun_ranks(1, "--vocoder-cli-rank", os.path.join(root, "cli_rank"),
                         ["--processed", os.path.join(root, "extracted"), "--model_dir",
                          model_dir, "--out", os.path.join(root, "vocoder_latents"),
                          "--steps", "3", "--device", "cuda"], timeout=300)[0]
    latent_s = time.perf_counter() - t0
    latent_run = [(ms_, tuple(n), m) for ms_, n, m in zip(cli["step_ms"], cli["launches"],
                                                         cli["losses"])]
    n_k1, n_k1b = n_k1 + cli["K1"], n_k1b + cli["K1b"]
    trained = checkpoint.load_pytree(os.path.join(root, "vocoder_latents", "vocoder_step_3"),
                                     "cuda")["gen_params"]

    ms = [a.elapsed_time(b) for a, b, _, _ in synthetic]
    step_ms = float(np.median(ms[1:]))
    losses = [{k: float(v) for k, v in m.items()} for _, _, _, m in synthetic]
    lat_losses = [m for _, _, m in latent_run]
    finite = all(math.isfinite(v) for m in losses + lat_losses for v in m.values())
    ck = checkpoint.load_pytree(os.path.join(run_dir, f"vocoder_step_{tc.steps}"))
    saved = ck["step"] == tc.steps and [d["period"] for d in ck["disc_params"]["mpd"]] == \
        list(tc.periods) and all(torch.equal(a, b.cpu()) for a, b in zip(
            optim.tree_leaves(ck["gen_params"]), optim.tree_leaves(state.gen_params)))
    del ck
    flops = vocoder_step_flops(cfg, tc)
    torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731  (us)
    for _ in range(3):   # a trace that came back without device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            inner(state, batch, *step_args)
            torch.cuda.synchronize()
            wall_step = time.perf_counter() - w0
        launched = kernel_events(torch, prof.key_averages())
        if launched:
            break
    busy_us = sum(dev(e) for e in launched)
    k1b_us = sum(dev(e) for e in launched if "anti_alias_backward" in e.key)
    k1_us = sum(dev(e) for e in launched if "anti_alias_kernel" in e.key)
    del state, batch, step_args
    torch.cuda.empty_cache()
    emit({"phase": "vocoder training, full width (BigVGAN 1536 channels), batch 8, 24 codes, "
                   "fp32 with TF32 off, synthetic batches, 20 steps", "card": card_line(),
          "train_s": train_s, "step_ms_median": step_ms, "step_ms_first": ms[0],
          "step_ms_min_max": [min(ms[1:]), max(ms[1:])],
          "samples_per_s": tc.batch_size / (step_ms / 1e3), "peak_mem_gib": peak,
          "K1_K1b_launches_per_step": launches_per_step(synthetic),
          "model_gflop_per_step": flops["per_step"] / 1e9,
          "generator_gflop_forward_per_sample": flops["generator_forward_per_sample"] / 1e9,
          "discriminators_gflop_forward_per_sample":
              flops["discriminators_forward_per_sample"] / 1e9,
          "model_flops_share_fp32_peak": flops["per_step"] / (step_ms / 1e3) / FP32_FLOPS,
          "flops_formula": "B x (3 x generator forward + 9 x discriminators forward); convs "
                           "2 x in x out x k an output position, K1 56 flops an element; "
                           "ECAPA, STFTs and mel losses left out; over 67e12 fp32",
          "losses_first": losses[0], "losses_last": losses[-1],
          "checkpoint_equals_last_state": saved,
          "profile_one_step": {"wall_ms": wall_step * 1e3, "device_busy_ms": busy_us / 1e3,
                               "device_busy_share": busy_us / 1e6 / wall_step,
                               "K1b_device_ms": k1b_us / 1e3, "K1_device_ms": k1_us / 1e3,
                               "kernels": sum(e.count for e in launched),
                               "top_kernels_device_ms": {
                                   e.key[:80]: dev(e) / 1e3 for e in
                                   sorted(launched, key=dev, reverse=True)[:8]}}})
    emit({"phase": "vocoder training over the extraction output (latent_batches, the "
                   "full-width GPT), through the CLI under torch.distributed.run "
                   "--nproc_per_node 1, 3 steps", "s": latent_s, "world": cli["world"],
          "backend": cli["backend"], "step_ms": cli["step_ms"],
          "K1_K1b_launches_per_step": launches_per_step(latent_run),
          "K1_K1b_launches": [cli["K1"], cli["K1b"]], "losses": lat_losses})
    if not finite or not saved or len(ms) != 20 or len(latent_run) != 3 \
            or (cli["world"], cli["backend"]) != (1, "nccl") \
            or launches_per_step(synthetic + latent_run) != [(K1_PER_VOCODE, K1_PER_VOCODE)]:
        raise SmokeFailure(f"vocoder training: finite {finite}, checkpoint {saved}, launches "
                           f"{launches_per_step(synthetic + latent_run)}")

    # the loop closed: the trained generator served
    serve_dir = os.path.join(root, "served_vocoder")
    os.makedirs(serve_dir)
    for f in ("vocab.txt", "gpt.pth"):
        os.link(os.path.join(model_dir, f), os.path.join(serve_dir, f))
    serving = tree_map(lambda p: p.bfloat16(), trained)
    export.save_bigvgan_pth(os.path.join(serve_dir, "bigvgan_generator.pth"),
                            tree_map(torch.Tensor.float, serving), cfg)
    del trained
    torch.cuda.empty_cache()
    eng = engine_mod.IndexTTS(cfg_path=None, model_dir=serve_dir, device="cuda", seed=0)
    vocode, captured = eng._vocode, []

    def capture(latent, mel_ref):
        wav = vocode(latent, mel_ref)
        captured.append((latent.clone(), mel_ref.clone(), wav.clone()))
        return wav

    eng._vocode = capture
    for k in kernels.values():
        k.launches = 0
    k1b.launches = 0
    path = os.path.join(root, "served_vocoder.wav")
    eng.infer(prompt, FT_SENTENCES[0], path, num_beams=1, do_sample=False, max_mel_tokens=120)
    served = (k1.launches, k1b.launches)
    n_k1 += k1.launches
    with torch.no_grad():
        ref = [torch.clamp(32767.0 * bigvgan.forward(serving, lat.bfloat16(), mel.bfloat16(),
                                                     cfg).float(), -32767.0, 32767.0)
               .to(torch.int16) for lat, mel, _ in captured]
    bit_equal = len(captured) > 0 and all(torch.equal(r, w) for r, (_, _, w) in
                                          zip(ref, captured))
    sr, wav = wavfile.read(path)
    _, pw = wavfile.read(prompt)
    sim = eval_metrics.speaker_similarity(
        tree_map(torch.Tensor.float, serving), wav.astype(np.float32) / 32768.0,
        pw.astype(np.float32) / 32768.0)
    emit({"phase": "the loop closed: the trained generator (bf16) through "
                   "bigvgan_generator.pth into an IndexTTS engine, one greedy request",
          "vocodes": len(captured), "K1_K1b_launches": list(served),
          "vocoder_output_bit_equal_in_memory": bit_equal, "samples": int(wav.shape[0]),
          "sample_rate": sr, "speaker_similarity_to_prompt": sim,
          "note": "random weights: the similarity is a number, not a quality claim"})
    if not bit_equal or served != (K1_PER_VOCODE * len(captured), 0) or sr != 24000:
        raise SmokeFailure(f"served trained vocoder: bit-equal {bit_equal}, launches {served}")
    del eng, serving
    torch.cuda.empty_cache()
    return n_k1, n_k1b


def vocoder_finetune(torch, engine_mod, kernels, prompt: str, root: str) -> tuple:
    """The vocoder slice: K1b's checks, the small card-vs-CPU step, the
    full-width training and the served result.  Returns (the K1b kernels-line
    entry, K1 launches, K1b launches on the path)."""
    from indextts_tpu_torch.ops import filters
    from indextts_tpu_torch.ops.cuda import anti_alias

    t0 = time.perf_counter()
    entry = kernel_checks_anti_alias_backward(torch, filters, anti_alias)
    vocoder_small_agreement(torch)
    n_k1, n_k1b = vocoder_train(torch, engine_mod, kernels, prompt, root)
    emit({"phase": "vocoder fine-tuning slice", "s": time.perf_counter() - t0,
          "K1b_ms_per_step": {k: entry[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                     "bound_by")},
          "K1_launches": n_k1, "K1b_launches": n_k1b})
    return entry, n_k1, n_k1b


# -- the tools and front ends (config reading without PyYAML, the bench,
# export, verification and profiling tools, the entry, the WebUI callbacks)

K2_TIERS = {"bf16": "fused_decode_trunk_flat[bf16]", "int8": "fused_decode_trunk_flat[int8]",
            "int4": "fused_decode_trunk_flat[int4]"}
NAMES = {"K1": "fused_anti_alias_activation", "K1b": "anti_alias_activation_backward",
         "K3": "permute_cache_rows"}


def _entry_launches(counts: dict, k2_tier=None, k4_tier=None) -> dict:
    """A tool's launch counts under the kernels line's entry names: K2 and K4
    under the tier the tool ran (no entry where the line has no such tier)."""
    out = {NAMES[k]: counts.get(k, 0) for k in NAMES}
    if k2_tier in K2_TIERS:
        out[K2_TIERS[k2_tier]] = counts["K2"]
    if k4_tier:
        out[f"fused_pool_step[{k4_tier}]"] = counts["K4"]
    return out


def _sum_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in set(total) | set(more)}


def tools_config_and_cli(torch, prompt: str, out_dir: str) -> None:
    """Fault C7: the port reads its config.yaml with no YAML package (the
    card machine has none), and the documented CLI command with
    --model_dir checkpoints_test, which finds that file, writes a wav."""
    import importlib.util

    import numpy as np
    from scipy.io import wavfile

    from indextts_tpu_torch.config import Config

    path = os.path.join(HERE, "checkpoints_test", "config.yaml")
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None          # an import of it now raises
    try:
        cfg = Config.load(path)
    finally:
        if saved is None:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = saved
    read = {"gpt.layers": cfg.gpt.layers, "gpt.model_dim": cfg.gpt.model_dim,
            "bigvgan.upsample_rates": cfg.bigvgan.upsample_rates,
            "bigvgan.resblock_dilation_sizes": cfg.bigvgan.resblock_dilation_sizes,
            "bigvgan.resblock": cfg.bigvgan.resblock}
    want = {"gpt.layers": 24, "gpt.model_dim": 1280,
            "bigvgan.upsample_rates": [4, 4, 4, 4, 2, 2],
            "bigvgan.resblock_dilation_sizes": [[1, 3, 5]] * 3, "bigvgan.resblock": "1"}
    wav = os.path.join(out_dir, "cli.wav")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.cli", LONG, "-v", prompt,
                           "-o", wav, "--model_dir", "checkpoints_test", "--num_beams", "1",
                           "--seed", "0", "-f"], cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    ok_wav = proc.returncode == 0 and os.path.exists(wav)
    sr, audio = wavfile.read(wav) if ok_wav else (0, np.zeros(0, np.int16))
    emit({"phase": "C7: config.yaml read without PyYAML, and the CLI with --model_dir "
                   "checkpoints_test", "pyyaml_installed": importlib.util.find_spec("yaml")
                   is not None, "read": read, "read_equal": read == want,
          "cli_rc": proc.returncode, "cli_s": cli_s, "cli_wav_samples": int(audio.shape[0]),
          "cli_sample_rate": sr, "cli_stdout_tail": proc.stdout[-300:]})
    if read != want or not ok_wav or sr != 24000 or audio.dtype != np.int16 \
            or audio.shape[0] == 0:
        raise SmokeFailure(f"C7: read {read}; CLI rc {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")


def tools_bench(torch, kernels, prompt: str) -> dict:
    """Every bench tool through its main(argv) at short settings, full width,
    random weights; each prints its JSON line.  Each must launch the kernel
    it exists to drive: K2 at one decode row, K1 at every vocode, K3 under
    reorder "pallas", K4 under impl "fused" and in a pool built on it.
    Returns the launches by kernels-line entry."""
    from indextts_tpu_torch.tools import (bench, bench_beam_pool, bench_beam_step, bench_e2e,
                                          bench_pool, bench_pool_trunk)

    total: dict = {}
    times = {}

    def run(label, main, argv):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    def fail(what, out):
        raise SmokeFailure(f"{what}: {json.dumps(out)[:3000]}")

    # eight eager rows are host-bound (22.5 s at two timed runs on an H100
    # host): one timed run gives back part of the vocoder CLI launcher's time
    for argv in (["--batch", "1", "--max-new", "200", "--warmup", "1", "--iters", "2"],
                 ["--batch", "8", "--max-new", "50", "--warmup", "1", "--iters", "1"]):
        out = run("bench " + " ".join(argv[:2]), bench.main, argv)
        for r in out["results"]:
            k2 = r["launches"]["K2"]
            if (r["batch"] == 1) != (k2 > 0) or r["tokens_per_s"] <= 0:
                fail(f"bench {r['tier']} B={r['batch']}: K2 {k2}", out)
            total = _sum_launches(total, _entry_launches(r["launches"], r["tier"]))
    for argv in (["--beams", "1"], ["--beams", "3", "--long", "--max-mel-tokens", "16"]):
        out = run("bench_e2e " + " ".join(argv), bench_e2e.main, argv + ["--prompt", prompt])
        for mode, r in out["modes"].items():
            n = r["launches"]
            if n["K1"] == 0 or (argv[1] == "1" and mode != "infer_fast" and n["K2"] == 0) \
                    or not r["rtf"] > 0:
                fail(f"bench_e2e {argv} {mode}", out)
            total = _sum_launches(total, _entry_launches(n, "int8"))
    if set(out["modes"]) != {"infer", "infer_fast", "infer_stream"}:
        fail("bench_e2e --long modes", out)
    # 8 requests, one wave of the 8 slots: the host-bound plain pool took
    # 35.7 s at 16 on an H100 host; the vocoder CLI's launcher costs about
    # 38 s, taken back here and in the K4 pool's, bench's and the beam step's
    # depth
    out = run("bench_pool", bench_pool.main, ["--slots", "8", "--reqs", "8", "--iters", "1"])
    if not out["value"] > 0:
        fail("bench_pool", out)
    out = run("bench_pool --fused-trunk", bench_pool.main,
              ["--slots", "8", "--reqs", "8", "--fused-trunk"])
    if not out["fused_trunk"] or out["launches"]["K4"] == 0:
        fail("bench_pool --fused-trunk: K4", out)
    total = _sum_launches(total, _entry_launches(out["launches"], k4_tier="int8_fp8cache"))
    out = run("bench_pool --e2e", bench_pool.main,
              ["--e2e", "--clients", "4", "--reqs", "8", "--fused-trunk"])
    if out["launches"]["K1"] == 0 or out["launches"]["K4"] == 0 or out["requests"] != 8:
        fail("bench_pool --e2e", out)
    total = _sum_launches(total, _entry_launches(out["launches"], k4_tier="int8_fp8cache"))
    out = run("bench_beam_step", bench_beam_step.main,   # host-bound: one timed decode
              ["--reorders", "lineage,pallas", "--max-new", "40", "--iters", "1",
               "--warmup", "1"])
    k3 = {r["reorder"]: r["launches"]["K3"] for r in out["results"]}
    if k3.get("lineage") != 0 or not k3.get("pallas"):
        fail("bench_beam_step: K3 under pallas only", out)
    for r in out["results"]:
        total = _sum_launches(total, _entry_launches(r["launches"]))
    out = run("bench_beam_pool", bench_beam_pool.main,
              ["--groups", "4", "--reqs", "8", "--max-new", "50"])
    if not out["value"] > 0:
        fail("bench_beam_pool", out)
    for slots in ("8", "64"):
        out = run(f"bench_pool_trunk S={slots}", bench_pool_trunk.main,
                  ["--slots", slots, "--steps", "32"])
        k4 = {r["impl"]: r["launches"]["K4"] for r in out["results"]}
        if k4 != {"rows": 0, "flat": 0, "fused": 4 * 32}:
            fail(f"bench_pool_trunk S={slots}: K4 {k4}", out)
        total = _sum_launches(total, _entry_launches(out["results"][2]["launches"],
                                                     k4_tier="int8_fp8cache"))
    emit({"phase": "tools: bench", "s": times, "launches": total})
    return total


def _pth_equal(torch, a: str, b: str) -> bool:
    """Two .pth files hold the same keys and equal tensors (and arrays)."""
    import numpy as np

    def same(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and sorted(x) == sorted(y) and \
                all(same(x[k], y[k]) for k in x)
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, np.ndarray):
            return isinstance(y, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)
        return x == y

    return same(torch.load(a, map_location="cpu", weights_only=False),
                torch.load(b, map_location="cpu", weights_only=False))


def tools_export(torch, engine_mod, kernels, prompt: str, out_dir: str, trained: dict) -> dict:
    """`export_pth` on the directories the earlier phases' trainers wrote:
    the DVAE phase's dvae_step_40, the vocoder phase's vocoder_step_3 (the
    generator that phase served, rounded to the engine's bf16 vocoder type
    with --round-to) and the LoRA phase's merged model_epoch_1 (bf16, with
    the speakers of its data).  Each file equals, tensor for tensor, what io/export's save_*
    writes for the same tree, and loads into the extractor or the engine
    with output bit-equal to the route the earlier phase took in memory:
    the DVAE's codes of extracted mels, the served vocoder request's wav,
    the fine-tuned engine's greedy codes.  Returns the launches by
    kernels-line entry."""
    import glob
    import shutil

    import numpy as np

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.data import extract
    from indextts_tpu_torch.io import checkpoint, export
    from indextts_tpu_torch.models import dvae
    from indextts_tpu_torch.tools import export_pth
    from indextts_tpu_torch.train.lora import tree_map

    t_phase = time.perf_counter()
    root = os.path.join(out_dir, "export")
    os.makedirs(root, exist_ok=True)
    cfg = Config()
    result, total = {}, {}

    # the DVAE
    ckpt = trained["dvae_step"]
    tool = export_pth.main(["dvae", "--ckpt", ckpt, "--out", os.path.join(root, "dvae.pth")])
    params = checkpoint.load_pytree(ckpt, "cuda")["params"]
    export.save_dvae_pth(os.path.join(root, "dvae_ref.pth"), params, cfg.vqvae)
    equal = _pth_equal(torch, tool, os.path.join(root, "dvae_ref.pth"))
    model = os.path.join(root, "dvae_model")
    os.makedirs(model)
    os.link(tool, os.path.join(model, "dvae.pth"))
    ex = extract.CodecExtractor(cfg, model, device="cuda")
    mels = [np.load(p) for p in sorted(glob.glob(os.path.join(trained["extracted"], "*", "mels",
                                                              "*.npy")))[:4]]
    F = min(m.shape[-1] for m in mels) // 4 * 4
    mel = torch.as_tensor(np.stack([m.reshape(m.shape[-2], -1)[:, :F] for m in mels]),
                          device="cuda")
    got, want = ex.codes(mel), dvae.get_codebook_indices(params, mel, cfg.vqvae)
    result["dvae"] = {"tensor_equal": equal, "codes_equal": bool(torch.equal(got, want)),
                      "mels": len(mels), "frames": F}
    del ex, params
    torch.cuda.empty_cache()

    # the vocoder: the generator the vocoder phase served
    ckpt = trained["vocoder_step"]
    serve_dir = os.path.join(root, "vocoder_model")
    os.makedirs(serve_dir)
    for f in ("vocab.txt", "gpt.pth"):
        os.link(os.path.join(trained["model"], f), os.path.join(serve_dir, f))
    tool = export_pth.main(["vocoder", "--ckpt", ckpt, "--round-to", "bf16",
                            "--out", os.path.join(serve_dir, "bigvgan_generator.pth")])
    gen = checkpoint.load_pytree(ckpt, "cuda")["gen_params"]
    export.save_bigvgan_pth(os.path.join(root, "bigvgan_ref.pth"),
                            tree_map(lambda p: p.bfloat16().float(), gen), cfg.bigvgan)
    equal = _pth_equal(torch, tool, os.path.join(root, "bigvgan_ref.pth"))
    del gen
    eng = engine_mod.IndexTTS(cfg_path=None, model_dir=serve_dir, device="cuda", seed=0)
    for k in kernels.values():
        k.launches = 0
    wav = os.path.join(root, "served_vocoder.wav")
    eng.infer(prompt, FT_SENTENCES[0], wav, num_beams=1, do_sample=False,
              max_mel_tokens=120)
    total = _sum_launches(total, {NAMES["K1"]: kernels["K1"].launches,
                                  K2_TIERS["bf16"]: kernels["K2"].launches})
    with open(wav, "rb") as a, open(trained["vocoder_wav"], "rb") as b:
        wav_equal = a.read() == b.read()
    result["vocoder"] = {"tensor_equal": equal, "wav_bit_equal": wav_equal,
                         "K1": kernels["K1"].launches}
    del eng
    torch.cuda.empty_cache()

    # the LoRA trainer's merged weights
    tool = export_pth.main(["gpt", "--ckpt", trained["merged_dir"], "--dtype", "bf16",
                            "--data-path", trained["data"],
                            "--config", os.path.join(HERE, "checkpoints_test", "config.yaml"),
                            "--out", os.path.join(root, "gpt_lora.pth")])
    merged = checkpoint.load_pytree(trained["merged_dir"], "cuda")
    export.save_gpt_pth(os.path.join(root, "gpt_ref.pth"), merged, cfg.gpt,
                        extras=export.speaker_extras(trained["data"]), save_dtype="bf16")
    equal = _pth_equal(torch, tool, os.path.join(root, "gpt_ref.pth"))
    del merged
    eng = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                              device="cuda", seed=0, gpt_path=tool)
    for k in kernels.values():
        k.launches = 0
    eng.infer(prompt, LONG, os.path.join(root, "lora.wav"), **trained["lora_gen"])
    total = _sum_launches(total, {NAMES["K1"]: kernels["K1"].launches,
                                  K2_TIERS["bf16"]: kernels["K2"].launches})
    codes = eng.last_stats["codes"]
    want = trained["lora_codes"]
    codes_equal = len(codes) == len(want) and all(np.array_equal(a, b)
                                                  for a, b in zip(codes, want))
    result["gpt"] = {"tensor_equal": equal, "codes_equal_merged_dir": codes_equal,
                     "speakers": eng.speaker_list, "K2": kernels["K2"].launches}
    del eng
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    emit({"phase": "tools: export_pth on the trainers' directories", **result,
          "s": time.perf_counter() - t_phase})
    if not (result["dvae"]["tensor_equal"] and result["dvae"]["codes_equal"]
            and result["vocoder"]["tensor_equal"] and result["vocoder"]["wav_bit_equal"]
            and result["gpt"]["tensor_equal"] and result["gpt"]["codes_equal_merged_dir"]):
        raise SmokeFailure(f"export_pth: {result}")
    return total


def tools_verify_and_front_ends(torch, kernels, prompt: str, out_dir: str) -> dict:
    """The verification tools, profiling, the entry and the front ends:
    verify_weights --dry-run (the 11-case battery on a synthetic model
    directory, on the card); eval_quality --self-test (self-similarity
    within 1e-4 of 1); the WebUI's callbacks over a full-width card engine
    (preview_split, synthesize in normal and fast modes); one infer under
    device_trace, wrapped in annotate("smoke.infer"), whose Chrome trace
    must hold that name and K2's kernels; the flagship teacher-forced
    forward of tools.entry; and serve.api (`tools_api`).  Returns the
    launches by kernels-line entry."""
    import shutil

    from scipy.io import wavfile

    from indextts_tpu_torch.serve import webui
    from indextts_tpu_torch.tools import entry, eval_quality, verify_weights
    from indextts_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    total: dict = {}
    for k in kernels.values():
        k.launches = 0
    report = verify_weights.main(["--dry-run", "--prompt", prompt])
    n = {k: v.launches for k, v in kernels.items()}
    cases = report["cases"]
    emit({"phase": "tools: verify_weights --dry-run", "cases": len(cases),
          "modes": sorted({c["mode"] for c in cases}), "device": report["device"],
          "speaker_sim_mean": report["speaker_sim_mean"], "launches": n,
          "case_wall_s": [c["wall_s"] for c in cases]})
    if len(cases) != 11 or not report["battery_ok"] or n["K1"] == 0 or n["K2"] == 0:
        raise SmokeFailure(f"verify_weights --dry-run: {json.dumps(report)[:3000]}")
    total = _sum_launches(total, {NAMES["K1"]: n["K1"]})   # K2 at fp32: no such entry

    quality = eval_quality.main(["--self-test"])
    if not quality["ok"] or abs(quality["speaker_sim_self"] - 1.0) >= 1e-4:
        raise SmokeFailure(f"eval_quality --self-test: {quality}")

    cb = webui.build_callbacks(os.path.join(HERE, "checkpoints_test", "config.yaml"),
                               os.path.join(HERE, "checkpoints_test"),
                               out_dir=out_dir, device="cuda")
    rows = cb["preview_split"](FT_SENTENCES[0] + FT_SENTENCES[1], 20)
    ui = {"preview_rows": len(rows)}
    for mode in ("normal", "fast"):
        for k in kernels.values():
            k.launches = 0
        path = cb["synthesize"](prompt, LONG, mode, 100, 4, False, 0.8, 30, 1.0, 10.0, 200,
                                num_beams=1)
        sr, audio = wavfile.read(path)
        n = {k: v.launches for k, v in kernels.items()}
        ui[mode] = {"samples": int(audio.shape[0]), "sample_rate": sr, "launches": n}
        if sr != 24000 or audio.dtype.name != "int16" or audio.shape[0] == 0 or n["K1"] == 0:
            raise SmokeFailure(f"webui synthesize {mode}: {ui}")
        total = _sum_launches(total, _entry_launches(n, "bf16"))
    tts = cb["state"]["tts"]
    for k in kernels.values():
        k.launches = 0
    with profiling.device_trace(os.path.join(out_dir, "trace")) as prof:
        with profiling.annotate("smoke.infer"):
            tts.infer(prompt, FT_SENTENCES[0], os.path.join(out_dir, "traced.wav"),
                      num_beams=1, do_sample=False, max_mel_tokens=100)
    n = {k: v.launches for k, v in kernels.items()}
    total = _sum_launches(total, _entry_launches(n, "bf16"))
    with open(prof.trace_path, encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    trace_mb = os.path.getsize(prof.trace_path) / 2 ** 20
    shutil.rmtree(os.path.dirname(prof.trace_path))
    trace = {"file_mb": trace_mb, "launches": n,
             "annotation": "smoke.infer" in names,
             "k2_kernels": sorted({x.split("<")[0] for x in names
                                   if "trunk_in_kernel" in x or "product_kernel" in x})}
    del cb, tts
    torch.cuda.empty_cache()
    ui["trace"] = trace
    if not trace["annotation"] or not trace["k2_kernels"] or n["K2"] == 0:
        raise SmokeFailure(f"device_trace: {trace}")

    fwd = entry.main([])
    torch.cuda.empty_cache()
    api, n = tools_api(torch, kernels, prompt)
    total = _sum_launches(total, _entry_launches(n, "bf16"))
    emit({"phase": "tools: eval_quality, the WebUI callbacks, device_trace, entry, serve.api",
          "quality_self_similarity": quality["speaker_sim_self"], "webui": ui,
          "entry": {k: fwd[k] for k in ("loss_text", "loss_mel", "finite", "s")},
          "serve_api": api, "s": time.perf_counter() - t_phase})
    if not fwd["finite"] or not api["ok"]:
        raise SmokeFailure(f"entry {fwd}; serve.api: {api}")
    return total


def tools_api(torch, kernels, prompt: str) -> tuple:
    """serve/api.py: where FastAPI is missing, its import raises an
    ImportError naming it; where FastAPI is installed, create_app over a
    card engine answers /health and one /tts request (greedy, num_beams=1)
    with a 24 kHz int16 wav, through starlette's TestClient where that
    imports (and where python-multipart, which form fields need, is
    installed).  Returns (what it found, the launches by kernel)."""
    import importlib
    import io

    from scipy.io import wavfile

    n = {k: 0 for k in kernels}
    try:
        api = importlib.import_module("indextts_tpu_torch.serve.api")
    except ImportError as e:
        return {"fastapi": False, "error": str(e), "ok": "fastapi" in str(e)}, n
    try:
        app = api.create_app(os.path.join(HERE, "checkpoints_test", "config.yaml"),
                             os.path.join(HERE, "checkpoints_test"), device="cuda")
    except RuntimeError as e:    # FastAPI's form fields need python-multipart
        if "multipart" not in str(e):
            raise
        return {"fastapi": True, "error": str(e), "ok": True}, n
    routes = sorted(r.path for r in app.routes if r.path in
                    ("/health", "/models", "/model/reload", "/tts", "/tts_stream"))
    found = {"fastapi": True, "routes": routes}
    try:
        from fastapi.testclient import TestClient
    except ImportError as e:   # starlette's client needs httpx
        app.state.service.close()
        return {**found, "client": str(e), "ok": len(routes) == 5}, n
    for k in kernels.values():
        k.launches = 0
    with TestClient(app) as client:
        health = client.get("/health").json()
        r = client.post("/tts", data={"text": FT_SENTENCES[0], "audio_path": prompt,
                                      "num_beams": "1", "do_sample": "false",
                                      "max_mel_tokens": "100"})
    n = {k: v.launches for k, v in kernels.items()}
    sr, audio = wavfile.read(io.BytesIO(r.content)) if r.status_code == 200 else (0, None)
    found.update(health=health, tts_status=r.status_code, sample_rate=sr,
                 samples=0 if audio is None else int(audio.shape[0]), launches=n)
    found["ok"] = len(routes) == 5 and health.get("status") == "ok" and sr == 24000 \
        and audio is not None and audio.dtype.name == "int16" and n["K1"] > 0
    return found, n


def tools_phase(torch, engine_mod, kernels, prompt: str, out_dir: str, trained: dict) -> dict:
    """The tools and front ends slice, after every earlier phase: C7, the
    bench tools, export_pth on the earlier phases' directories, the
    verification tools, profiling, the entry and the front ends.  Returns the
    launches by kernels-line entry."""
    t0 = time.perf_counter()
    root = os.path.join(out_dir, "tools")
    os.makedirs(root, exist_ok=True)
    tools_config_and_cli(torch, prompt, root)
    total = tools_bench(torch, kernels, prompt)
    total = _sum_launches(total, tools_export(torch, engine_mod, kernels, prompt, root,
                                              trained))
    total = _sum_launches(total, tools_verify_and_front_ends(torch, kernels, prompt, root))
    emit({"phase": "tools and front ends", "s": time.perf_counter() - t0, "launches": total})
    return total


# -- data-parallel training across cards (torch.distributed: one process a
# card, NCCL), driven through torch.distributed.run

DP_STEPS = {"lora": 8, "dvae": 20, "vocoder": 10}   # timed steps a world (the first left out)
# world N against world 1 on the same global batch, fp32, TF32 off: losses
# relative; each gradient leaf against its largest magnitude, or 1e-5 of the
# tree's largest where that is more (a leaf that is zero in exact arithmetic
# holds rounding noise in both; cuDNN's backward is not bit-reproducible)
DP_TOL = {
    "lora": {"loss": 1e-5, "grads": 1e-4},
    "dvae": {"loss": 1e-4, "grads": 1e-3},
    "vocoder": {"loss": 1e-4, "grads": 1e-3},
}
DP_LEAF_FLOOR = 1e-5


def torchrun_ranks(nproc: int, flag: str, out_dir: str, argv=(), timeout: float = 600.0,
                   module=None) -> list:
    """Run `python -m torch.distributed.run --standalone --nproc_per_node
    nproc` over this script's `flag out_dir [argv]` rank entry (or over
    `-m module argv`), in a process session of its own that is killed whole
    on timeout; return the ranks' JSON reports (out_dir/rank{r}.json), or []
    for a module.  A rank that fails fails the run."""
    import signal

    os.makedirs(out_dir, exist_ok=True)
    target = ["-m", module, *argv] if module else [os.path.join(HERE, "chip_smoke.py"), flag,
                                                   out_dir, "--", *argv]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target]
    log_path = os.path.join(out_dir, "torchrun.log")
    with open(log_path, "w+b") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        if rc != 0:
            log.seek(0)
            tail = log.read().decode(errors="replace")[-6000:]
            raise SmokeFailure(f"torch.distributed.run {flag or module} x{nproc}: rc {rc}\n"
                               f"{tail}")
    if module:
        return []
    reports = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def vocoder_cli_rank(out_dir: str, argv) -> None:
    """A rank of the vocoder CLI under torch.distributed.run: the CLI's own
    `main(argv)`, each train step between CUDA events with its K1 and K1b
    launches, the counts at 0 just before; the rank's report as JSON."""
    import torch

    from indextts_tpu_torch.ops.cuda import anti_alias
    from indextts_tpu_torch.parallel import mesh
    from indextts_tpu_torch.train import vocoder

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    k1, k1b = anti_alias.fused_anti_alias_activation, anti_alias.anti_alias_activation_backward
    inner, steps = vocoder.train_step, []
    os.makedirs(out_dir, exist_ok=True)

    def timed(state, batch, *args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n0 = (k1.launches, k1b.launches)
        e0.record()
        out = inner(state, batch, *args, **kw)
        e1.record()
        steps.append((e0, e1, (k1.launches - n0[0], k1b.launches - n0[1]), out[1]))
        return out

    vocoder.train_step = timed
    k1.launches = k1b.launches = 0
    vocoder.main(list(argv))
    torch.cuda.synchronize()
    report = {"rank": mesh.rank(), "world": mesh.world(),
              "backend": torch.distributed.get_backend() if mesh.is_initialized() else None,
              "step_ms": [a.elapsed_time(b) for a, b, _, _ in steps],
              "launches": [list(n) for _, _, n, _ in steps],
              "losses": [{k: float(v) for k, v in m.items()} for *_, m in steps],
              "K1": k1.launches, "K1b": k1b.launches}
    with open(os.path.join(out_dir, f"rank{mesh.rank()}.json"), "w") as f:
        json.dump(report, f)
    mesh.shutdown()


class RecordingOptimizer:
    """An optimizer whose `step` keeps the gradients it is given, in order:
    a step's reduced gradients (the vocoder's discriminators', then its
    generator's)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def step(self, grads, *args):
        self.grads.append(grads)
        return self.opt.step(grads, *args)


class CollectiveTimer:
    """While active, every `torch.distributed.all_reduce` of a tensor on the
    card is timed by CUDA events on the calling stream: from its launch,
    the wait for the slowest rank included, and from the moment every rank
    has arrived to its end.  The arrival is the end of a one-element
    all-reduce over the same group made just before (no rank passes it
    until all have posted it).  `calls` holds each call's three events."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        torch = self.torch
        dist = torch.distributed
        inner = self.inner = dist.all_reduce

        def timed(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
            if async_op or not tensor.is_cuda:
                return inner(tensor, op=op, group=group, async_op=async_op)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            inner(torch.zeros(1, device=tensor.device), group=group)
            events[1].record()
            out = inner(tensor, op=op, group=group)
            events[2].record()
            self.calls.append(events)
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.torch.distributed.all_reduce = self.inner


def _timing_summary(torch, runs) -> dict:
    """Step ms, the collectives' ms a step (from launch, and from every
    rank's arrival) and the peak memory since the last reset, from each
    run's (start, end, collective events); the medians leave out the first
    step."""
    import numpy as np

    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b, _ in runs]
    waited = [sum(e[0].elapsed_time(e[2]) for e in c) for _, _, c in runs]
    moved = [sum(e[1].elapsed_time(e[2]) for e in c) for _, _, c in runs]
    return {"step_ms": ms, "step_ms_median": float(np.median(ms[1:])),
            "collective_ms_median": float(np.median(waited[1:])),
            "allreduce_transfer_ms_median": float(np.median(moved[1:])),
            "collectives_per_step": len(runs[-1][2]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _dp_timed(torch, step, n: int) -> dict:
    """`step()` n times, each between CUDA events, its all-reduces timed by
    CollectiveTimer; the peak memory from a reset just before, so the
    caller must hold on the card nothing but what the steps use."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with CollectiveTimer(torch) as timer:
        for _ in range(n):
            c0 = len(timer.calls)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            step()
            e1.record()
            runs.append((e0, e1, timer.calls[c0:]))
    return _timing_summary(torch, runs)


def _moved(tree, device):
    """A copy of a tree's tensors on `device`."""
    from indextts_tpu_torch.parallel import mesh

    leaves, rebuild = mesh._flatten(tree)
    return rebuild([x.to(device, copy=True) for x in leaves])


def _max_rel(torch, got, want) -> tuple:
    """Over the leaves: max |got - want| over the leaf's largest |want| (or
    DP_LEAF_FLOOR of the tree's largest, where that is more), and the
    leaf where it is reached."""
    from indextts_tpu_torch.parallel import mesh

    g, _ = mesh._flatten(got)
    w, _ = mesh._flatten(want)
    assert len(g) == len(w)
    top = max(float(b.abs().max()) for b in w)
    errs = [float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()),
                                                             DP_LEAF_FLOOR * top, 1e-30)
            for a, b in zip(g, w)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return errs[worst], worst


def _dp_compare(torch, mesh, kind: str, m_n: dict, g_n, run_one) -> dict:
    """Rank 0 runs the one-card step on the global batch (`run_one()` ->
    (metrics, grads)) and holds the world's reduced metrics and gradients
    against it; the others wait.  Returns the errors on rank 0, {} elsewhere."""
    out = {}
    if mesh.is_main():
        m_1, g_1 = run_one()
        err, worst = _max_rel(torch, g_n, g_1)
        out = {"loss_rel_err": max(abs(float(m_n[k]) - float(m_1[k]))
                                   / max(abs(float(m_1[k])), 1e-30)
                                   for k in m_1 if "loss" in k or k.startswith("gen_")),
               "grads_rel_err": err, "grads_worst_leaf": worst,
               "world_1_metrics": {k: float(v) for k, v in m_1.items()},
               "tol": DP_TOL[kind]}
        out["ok"] = out["loss_rel_err"] <= DP_TOL[kind]["loss"] and \
            out["grads_rel_err"] <= DP_TOL[kind]["grads"]
        del g_1
        torch.cuda.empty_cache()
    mesh.barrier()
    return out


def _lora_rows(np, rng, B: int, sort: bool):
    """B rows of a LoRA batch at full width (20-120 text tokens, 150-450
    codes, 600-1800 condition frames), sorted by length when `sort`."""
    tl, cl, ml = rng.integers(20, 121, B), rng.integers(150, 451, B), rng.integers(600, 1801, B)
    if sort:
        tl, cl, ml = np.sort(tl), np.sort(cl), np.sort(ml)
    return {"text_lengths": tl, "codes_lengths": cl, "cond_lengths": ml,
            "text": [rng.integers(2, 12000, n) for n in tl],
            "codes": [rng.integers(0, 8192, n) for n in cl],
            "cond": [rng.standard_normal((100, n)).astype(np.float32) for n in ml]}


def _lora_batch(torch, np, rows: dict, lo: int, hi: int, device):
    """Rows lo..hi collated as the loader does: each width the rows' longest
    rounded up to 32."""
    from indextts_tpu_torch.train import trainer

    up = lambda n: -(-int(n) // 32) * 32  # noqa: E731
    sl = slice(lo, hi)
    Tt, Tc, Tm = (up(rows[k][sl].max()) for k in ("text_lengths", "codes_lengths",
                                                   "cond_lengths"))
    B = hi - lo
    text, codes = np.zeros((B, Tt), np.int64), np.zeros((B, Tc), np.int64)
    cond = np.zeros((B, 100, Tm), np.float32)
    for i in range(B):
        text[i, :len(rows["text"][lo + i])] = rows["text"][lo + i]
        codes[i, :len(rows["codes"][lo + i])] = rows["codes"][lo + i]
        cond[i, :, :rows["cond"][lo + i].shape[1]] = rows["cond"][lo + i]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return trainer.Batch(t(text), t(rows["text_lengths"][sl]), t(codes),
                         t(rows["codes_lengths"][sl]), t(cond), t(rows["cond_lengths"][sl]))


def dp_lora(torch, mesh, device) -> dict:
    """LoRA at full width (24 layers, 1280 wide, 20 heads), 8 rows a rank.
    Correctness on an fp32 base: one step on a global batch of 8 x world
    rows sorted by length, so that each rank holds other token counts and
    pads to its own widths, against the one-card step on all of them (rank
    0); the mean of the ranks' own-count losses (the planted fault) must
    miss.  Throughput on the bf16 base the trainer trains: DP_STEPS
    micro-steps of unsorted rows at world N, then 8 rows on rank 0 alone,
    each from the starting state with the check's tensors released."""
    import numpy as np

    from indextts_tpu_torch.config import GPTConfig, LoRAConfig, TrainConfig
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.train import trainer
    from indextts_tpu_torch.train.lora import tree_map

    r, n, group = mesh.rank(), mesh.world(), mesh.data_group()
    cfg, lcfg = GPTConfig(), LoRAConfig()
    opt = trainer.make_optimizer(TrainConfig(), 100)
    base = uv.init_params(cfg, torch.Generator(device=device).manual_seed(0), torch.float32,
                          device)
    state = trainer.init_train_state(torch.Generator(device=device).manual_seed(1), cfg, lcfg,
                                     opt, device)
    gen = torch.Generator(device=device).manual_seed(2)
    # PEFT's zero `b` moved off zero, so that both factors have gradients
    adapters = tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=gen, device=device,
                                                         dtype=x.dtype), state.lora_params)
    state = trainer.TrainState(adapters, opt.init(adapters), state.step)
    base, state = mesh.broadcast_tree((base, state))
    rows = _lora_rows(np, np.random.default_rng(7), 8 * n, sort=True)
    mine = _lora_batch(torch, np, rows, 8 * r, 8 * r + 8, device)
    rec = RecordingOptimizer(opt)
    _, m_n = trainer.train_step(state, base, mine, cfg, lcfg, rec, 0.1, 0.0, group=group)
    local, _, _ = trainer.loss_and_grads(state, base, mine, cfg, lcfg, 0.1)
    local = mesh.all_gather_host([float(local)], group)
    out = {"widths": mesh.all_gather_host([mine.text_ids.shape[1], mine.mel_codes.shape[1],
                                             mine.cond_mel.shape[2]], group),
           "metrics": {k: float(v) for k, v in m_n.items()}}

    def one():
        full = _lora_batch(torch, np, rows, 0, 8 * n, device)
        rec_1 = RecordingOptimizer(opt)
        _, m_1 = trainer.train_step(state, base, full, cfg, lcfg, rec_1, 0.1, 0.0)
        return m_1, rec_1.grads[0]

    out["check"] = _dp_compare(torch, mesh, "lora", m_n, rec.grads[0], one)
    if mesh.is_main():
        ref = out["check"]["world_1_metrics"]["loss"]
        out["check"]["mean_of_rank_means_rel_err"] = abs(np.mean(local) - ref) / abs(ref)
    # throughput on the bf16 base
    start = _moved(state, "cpu")
    base = tree_map(lambda x: x.bfloat16(), base)
    del rec, m_n, state, mine
    torch.cuda.empty_cache()
    rows = _lora_rows(np, np.random.default_rng(8), 8 * n, sort=False)
    mine = _lora_batch(torch, np, rows, 8 * r, 8 * r + 8, device)
    targets = int((rows["text_lengths"] + 1).sum() + (rows["codes_lengths"] + 1).sum())
    holder = [_moved(start, device)]

    def step_n():
        holder[0] = trainer.train_step(holder[0], base, mine, cfg, lcfg, opt, 0.1, 0.0,
                                       group=group)[0]

    out["world_n"] = _dp_timed(torch, step_n, DP_STEPS["lora"])
    out["world_n"]["target_tokens_per_s"] = targets / (out["world_n"]["step_ms_median"] / 1e3)
    out["checksum"] = mesh.all_gather_host([_checksum(holder[0])], group)
    del holder
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.is_main():
        own = int((rows["text_lengths"][:8] + 1).sum() + (rows["codes_lengths"][:8] + 1).sum())
        holder_1 = [_moved(start, device)]

        def step_1():
            holder_1[0] = trainer.train_step(holder_1[0], base, mine, cfg, lcfg, opt, 0.1,
                                             0.0)[0]

        out["world_1"] = _dp_timed(torch, step_1, DP_STEPS["lora"])
        out["world_1"]["target_tokens_per_s"] = own / (out["world_1"]["step_ms_median"] / 1e3)
        del holder_1
    mesh.barrier()
    del base, mine
    torch.cuda.empty_cache()
    return out


def _checksum(tree) -> float:
    from indextts_tpu_torch.parallel import multihost

    return float(multihost.tree_checksum(tree))


def dp_dvae(torch, mesh, device) -> dict:
    """The DVAE at the shipped config, 32 windows of 256 frames a rank
    (DVAETrainConfig's defaults): one step against the one-card step on all
    the windows (rank 0), then DP_STEPS timed steps at world N and 32
    windows on rank 0 alone, each from the starting state with the check's
    tensors released."""
    import numpy as np

    from indextts_tpu_torch.config import VQVAEConfig
    from indextts_tpu_torch.train import dvae as dtrain

    r, n, group = mesh.rank(), mesh.world(), mesh.data_group()
    cfg, tc = VQVAEConfig(), dtrain.DVAETrainConfig()
    opt = dtrain.make_optimizer(tc)
    state = mesh.broadcast_tree(dtrain.init_state(
        cfg, opt, torch.Generator(device=device).manual_seed(tc.seed), None, device))
    mels = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (32 * n, 100, 256)).astype(np.float32)).to(device)
    mine = mels[32 * r:32 * r + 32].contiguous()
    rec = RecordingOptimizer(opt)
    _, m_n = dtrain.train_step(state, mine, cfg, rec, tc, group=group)
    out = {"metrics": {k: float(v) for k, v in m_n.items()}}

    def one():
        rec_1 = RecordingOptimizer(opt)
        _, m_1 = dtrain.train_step(state, mels, cfg, rec_1, tc)
        return m_1, rec_1.grads[0]

    out["check"] = _dp_compare(torch, mesh, "dvae", m_n, rec.grads[0], one)
    start = _moved(state, "cpu")
    del rec, m_n, state, mels
    torch.cuda.empty_cache()
    holder = [_moved(start, device)]

    def step_n():
        holder[0] = dtrain.train_step(holder[0], mine, cfg, opt, tc, group=group)[0]

    out["world_n"] = _dp_timed(torch, step_n, DP_STEPS["dvae"])
    out["world_n"]["windows_per_s"] = 32 * n / (out["world_n"]["step_ms_median"] / 1e3)
    out["checksum"] = mesh.all_gather_host([_checksum(holder[0])], group)
    del holder
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.is_main():
        holder_1 = [_moved(start, device)]

        def step_1():
            holder_1[0] = dtrain.train_step(holder_1[0], mine, cfg, opt, tc)[0]

        out["world_1"] = _dp_timed(torch, step_1, DP_STEPS["dvae"])
        out["world_1"]["windows_per_s"] = 32 / (out["world_1"]["step_ms_median"] / 1e3)
        del holder_1
    mesh.barrier()
    del mine
    torch.cuda.empty_cache()
    return out


def dp_vocoder(torch, mesh, device, out_dir: str) -> dict:
    """The vocoder at full width (BigVGAN 1536 channels, fp32, 8 rows of 24
    codes a rank): one step against the one-card step on all the rows (rank
    0); then, with the check's tensors released, `train_vocoder` at world N
    over DP_STEPS synthetic global batches (each rank its rows, K1 and K1b
    counted on each rank with the counts at 0 just before), and 8 rows on
    rank 0 alone from the starting state."""
    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.ops.cuda import anti_alias
    from indextts_tpu_torch.train import vocoder

    r, n, group = mesh.rank(), mesh.world(), mesh.data_group()
    k1, k1b = anti_alias.fused_anti_alias_activation, anti_alias.anti_alias_activation_backward
    cfg = BigVGANConfig()
    steps = DP_STEPS["vocoder"]
    tc = vocoder.VocoderTrainConfig(batch_size=8 * n, steps=steps, log_every=steps,
                                    checkpoint_every=0)
    opt = vocoder.make_optimizer(tc)
    state, aux = vocoder.init_state(torch.Generator(device=device).manual_seed(tc.seed), cfg,
                                    opt, None, tc.periods, tc.resolutions, device=device)
    state = mesh.broadcast_tree(state)
    glob = next(vocoder.synthetic_batches(cfg, tc))
    mine = vocoder.to_device(glob, tc.batch_size, device, slice(8 * r, 8 * r + 8))
    rec = RecordingOptimizer(opt)
    _, m_n = vocoder.train_step(state, mine, aux, cfg, rec, tc, group)
    out = {"metrics": {k: float(v) for k, v in m_n.items()}}

    def one():
        rec_1 = RecordingOptimizer(opt)
        _, m_1 = vocoder.train_step(state, vocoder.to_device(glob, tc.batch_size, device), aux,
                                    cfg, rec_1, tc)
        return m_1, rec_1.grads

    out["check"] = _dp_compare(torch, mesh, "vocoder", m_n, rec.grads, one)
    start = _moved(state, "cpu")
    del rec, m_n, state
    torch.cuda.empty_cache()
    # the loop at world N: the counts at 0 just before, read just after
    inner, runs = vocoder.train_step, []

    def timed(*args, **kw):
        c0 = len(timer.calls)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = inner(*args, **kw)
        e1.record()
        runs.append((e0, e1, timer.calls[c0:]))
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1b.launches = 0
    vocoder.train_step = timed
    try:
        with CollectiveTimer(torch) as timer:
            trained = vocoder.train_vocoder(cfg, tc, vocoder.synthetic_batches(cfg, tc),
                                            os.path.join(out_dir, "vocoder_dp"), device=device)
    finally:
        vocoder.train_step = inner
    out["world_n"] = _timing_summary(torch, runs)
    out["world_n"]["samples_per_s"] = tc.batch_size / (out["world_n"]["step_ms_median"] / 1e3)
    out["launches"] = mesh.all_gather_host([k1.launches, k1b.launches], group)
    out["checksum"] = mesh.all_gather_host([_checksum(trained)], group)
    del trained
    torch.cuda.empty_cache()
    mesh.barrier()
    if mesh.is_main():
        holder = [_moved(start, device)]

        def step_1():
            holder[0] = vocoder.train_step(holder[0], mine, aux, cfg, opt, tc)[0]

        out["world_1"] = _dp_timed(torch, step_1, steps)
        out["world_1"]["samples_per_s"] = 8 / (out["world_1"]["step_ms_median"] / 1e3)
        del holder
    mesh.barrier()
    del mine
    torch.cuda.empty_cache()
    return out


def dp_rank_report(device: str, out_dir: str) -> dict:
    """One rank of the data-parallel training check (`--dp N`), started by
    parallel/multihost.run_ranks on its own card under NCCL: the three
    trainers in turn; returns the rank's report."""
    import torch

    from indextts_tpu_torch.parallel import mesh

    dev = mesh.local_device(device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    report = {"rank": mesh.rank(), "world": mesh.world(), "device": str(dev),
              "backend": torch.distributed.get_backend(), "card": torch.cuda.get_device_name()}
    for name, fn in (("lora", dp_lora), ("dvae", dp_dvae),
                     ("vocoder", lambda t, m, d: dp_vocoder(t, m, d, out_dir))):
        t0 = time.perf_counter()
        report[name] = fn(torch, mesh, dev)
        report[name]["s"] = time.perf_counter() - t0
    mesh.barrier()
    return report


def dp_training(torch, dp: int, out_dir: str) -> None:
    """The three trainers across `dp` cards, each rank a process of
    parallel/multihost.run_ranks; then the LoRA Trainer's and the DVAE's
    CLIs unchanged under torch.distributed.run on a small model.  Prints a
    line a trainer (world N and world 1: the check, step ms, throughput,
    the all-reduces' ms a step from launch and from every rank's arrival,
    peak memory a rank) and fails on any check."""
    import shutil

    from indextts_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    reports = multihost.run_ranks("chip_smoke:dp_rank_report", dp, out_dir, device="cuda",
                                  timeout=900)
    head = reports[0]
    failed = []
    for name, unit in (("lora", "target_tokens_per_s"), ("dvae", "windows_per_s"),
                       ("vocoder", "samples_per_s")):
        r0 = head[name]
        sums = [x[0] for x in r0["checksum"]]
        line = {"phase": f"data-parallel {name}, full width, world {dp} against world 1",
                "card": card_line(), "backend": head["backend"], "s": r0["s"],
                "check": r0["check"], "params_bit_equal_across_ranks": len(set(sums)) == 1,
                "world_n": {k: v for k, v in r0["world_n"].items() if k != "step_ms"},
                "world_n_step_ms": r0["world_n"]["step_ms"],
                "world_1": {k: v for k, v in r0["world_1"].items() if k != "step_ms"},
                "scaling": r0["world_n"][unit] / r0["world_1"][unit],
                "peak_gib_by_rank": [x[name]["world_n"]["peak_gib"] for x in reports]}
        if name == "lora":
            line["widths_by_rank_text_codes_cond"] = r0["widths"]
        if name == "vocoder":
            line["K1_K1b_launches_by_rank"] = r0["launches"]
            want = DP_STEPS["vocoder"] * K1_PER_VOCODE
            if any(k1 != want or k1b != want
                   for k1, k1b in r0["launches"]):
                failed.append(f"vocoder launches {r0['launches']}")
        emit(line)
        if not r0["check"]["ok"] or len(set(sums)) != 1:
            failed.append(f"{name}: check {r0['check']}, checksums {sums}")
        if name == "lora" and not (r0["check"]["mean_of_rank_means_rel_err"]
                                   > DP_TOL["lora"]["loss"]):
            failed.append(f"lora: the planted fault passed {r0['check']}")
    emit({"phase": f"data-parallel training across {dp} cards", "s": time.perf_counter() - t0})
    shutil.rmtree(os.path.join(out_dir, "vocoder_dp"), ignore_errors=True)
    if failed:
        raise SmokeFailure("data-parallel training: " + "; ".join(failed))
    dp_clis(torch, dp, out_dir)


def dp_clis(torch, dp: int, out_dir: str) -> None:
    """The LoRA Trainer's CLI and the DVAE's, unchanged under
    `python -m torch.distributed.run --nproc_per_node dp` on the small model
    and small synthetic data: both exit 0, rank 0's artifacts written."""
    import numpy as np

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.utils.textnorm import TextNormalizer
    from indextts_tpu_torch.utils.tokenizer import TextTokenizer

    t0 = time.perf_counter()
    root = os.path.join(out_dir, "dp_clis")
    model_dir = os.path.join(HERE, "checkpoints_test")
    tok = TextTokenizer(os.path.join(model_dir, "vocab.txt"), TextNormalizer())
    write_finetune_data(os.path.join(root, "data"), tok, np.random.default_rng(3), clips=16,
                        valid=2, codes=(20, 60), text_tokens=(5, 30), width=128)
    cfg = Config.from_dict({**SMALL_MODEL, "train": {
        "epochs": 1, "batch_size": 8, "max_steps_per_epoch": 2, "valid_batch_size": 2,
        "finetune_model_dir": os.path.join(root, "out"), "data_path": os.path.join(root, "data"),
        "mixed_precision": "fp32"}})
    cfg_path = os.path.join(root, "config.yaml")
    cfg.save(cfg_path)
    torchrun_ranks(dp, None, root, ["--config", cfg_path, "--model_dir", model_dir,
                                    "--run_name", "dp"], timeout=300,
                   module="indextts_tpu_torch.train.run")
    lora_files = sorted(os.listdir(os.path.join(root, "out", "dp")))
    torchrun_ranks(dp, None, root, ["--mels", os.path.join(root, "data"), "--out",
                                    os.path.join(root, "dvae"), "--steps", "3", "--batch",
                                    str(2 * dp), "--width", "64"], timeout=300,
                   module="indextts_tpu_torch.train.dvae")
    dvae_files = sorted(os.listdir(os.path.join(root, "dvae")))
    ok = {"checkpoint_epoch_0", "gpt_finetuned.pth", "config_finetuned.yaml"} <= \
        set(lora_files) and dvae_files == ["dvae_step_3"]
    emit({"check": f"the LoRA and DVAE CLIs under torch.distributed.run --nproc_per_node {dp}",
          "s": time.perf_counter() - t0, "lora_artifacts": lora_files,
          "dvae_artifacts": dvae_files, "ok": ok})
    if not ok:
        raise SmokeFailure(f"CLIs under torchrun: {lora_files}, {dvae_files}")


TP_EPS = 1e-3               # fp32: codes may part only where one card's margin is below this
TP_STEP_LENS = (16, 64)     # the two decode budgets whose difference gives ms a step
TP_GREEDY = dict(num_beams=1, do_sample=False, repetition_penalty=1.0, max_mel_tokens=64)
TP_BEAM = dict(num_beams=3, do_sample=False, repetition_penalty=1.0, max_mel_tokens=64)
TP_FAULT_DEADLINE_S = 20.0  # parallel/tp.TIMEOUT_S in the fault cases' process
TP_FAULT_LIMIT_S = 240.0    # the fault cases' process, all of it


# -- run on every rank of an engine, through its _on_ranks("chip_smoke:...") --

def tp_rank_counts(engine, reset: bool = False) -> dict:
    """This rank's counts: its group's all-reduces and agreements, the
    launches of K1 to K4, its trunk bytes and its card's peak memory;
    `reset` zeroes the counts and the peak after reading them."""
    import torch

    from indextts_tpu_torch.ops.cuda import anti_alias, decode_layer, permute, pool_trunk
    from indextts_tpu_torch.parallel import mesh

    kernels = {"K1": anti_alias.fused_anti_alias_activation,
               "K2": decode_layer.fused_decode_trunk_flat,
               "K3": permute.permute_cache_rows, "K4": pool_trunk.fused_pool_step}
    g = engine.tp_group
    out = {"rank": engine.tp_rank, "device": str(engine.device),
           "all_reduces": g.all_reduces if g else 0, "agreements": g.agreements if g else 0,
           **{k: f.launches for k, f in kernels.items()},
           "trunk_bytes": sum(t.numel() * t.element_size()
                              for t in mesh._flatten(engine.gpt_params_batched["gpt"])[0]),
           "peak_bytes": torch.cuda.max_memory_allocated(engine.device)}
    if reset:
        for f in kernels.values():
            f.launches = 0
        if g is not None:
            g.all_reduces = g.agreements = 0
        torch.cuda.reset_peak_memory_stats(engine.device)
    return out


def tp_rank_checksum(engine) -> int:
    """This rank's checksum of the trunk shard it holds."""
    from indextts_tpu_torch.parallel.multihost import tree_checksum

    return tree_checksum(engine.gpt_params_batched["gpt"])


def tp_rank_time_all_reduces(engine, on: bool) -> float:
    """Time this rank's trunk all-reduces between CUDA events on its stream,
    from each launch to its end (the wait for the other ranks included):
    `on` wraps its group's `all_reduce` (on the instance, for this smoke
    alone); off takes the wrapper away and returns the timed ms."""
    import torch

    g = engine.tp_group
    if on:
        events, plain = [], g.all_reduce

        def timed(x):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain(x)
            end.record()
            events.append((start, end))
            return x

        g.all_reduce, g.smoke_events = timed, events
        return 0.0
    del g.all_reduce
    events = g.__dict__.pop("smoke_events")
    if events:
        events[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in events)


def _tp_counts(tts, reset: bool = False) -> list:
    """Every rank's `tp_rank_counts`, by rank."""
    return tts._on_ranks("chip_smoke:tp_rank_counts", reset)


# -- the phase ---------------------------------------------------------------

def _tp_engine(engine_mod, n: int, fp32: bool = False):
    """The flagship at tp = n over cuda:0..n-1 (random weights drawn on the
    CPU from torch seed 0, the same on every rank), or on one card at n = 1."""
    prec = {"gpt": "fp32", "vocoder": "fp32"} if fp32 else None
    t0 = time.perf_counter()
    tts = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                              device="cuda", seed=0, precision_config=prec, tp=n)
    return tts, time.perf_counter() - t0


def _tp_ids(tts, text: str):
    import numpy as np

    sent = tts.tokenizer.split_sentences(tts.tokenizer.tokenize(text), 120)[0]
    return [np.asarray(tts.tokenizer.convert_tokens_to_ids(sent), np.int32)]


def _tp_cond(torch, tts):
    import numpy as np

    rng = np.random.default_rng(1)
    g = tts.cfg.gpt
    return torch.as_tensor(0.5 * rng.standard_normal((1, g.condition_num_latent, g.model_dim)),
                           dtype=tts.gpt_dtype, device=tts.device)


def _tp_beam_pallas(tts, cond, ids, gen: dict, generator=None):
    """A beam decode on every rank with the engine's own options for `gen`
    and reorder="pallas" (K3 reorders each rank's head shard of the cache;
    the engine's beam decode itself uses the lineage map)."""
    beam, kw = tts._decode_options(len(ids), dict(gen))
    return tts._on_ranks("_decode_rows", cond, ids, generator, beam,
                         dict(kw, reorder="pallas"))[0]


def _step_ms(torch, tts, cond, ids, **gen) -> dict:
    """Wall ms a decode step: two decodes (budgets TP_STEP_LENS) after a
    warm-up, the difference of their times over the difference of their
    steps; each ends in a host read of the codes."""
    tts._decode_bucket(cond, ids, torch.Generator(device="cuda").manual_seed(0),
                       dict(gen, max_mel_tokens=8))
    runs = []
    for n in TP_STEP_LENS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, steps = tts._decode_bucket(cond, ids, torch.Generator(device="cuda").manual_seed(0),
                                         dict(gen, max_mel_tokens=n))
        runs.append((time.perf_counter() - t0, steps))
    (t_a, s_a), (t_b, s_b) = runs
    return {"ms": (t_b - t_a) / (s_b - s_a) * 1e3 if s_b > s_a else None,
            "steps": [s_a, s_b]}


def tp_permute_checks(torch, permute) -> None:
    """K3 bit-exact against its plain version on the head shards that tensor
    parallelism hands it: the flagship beam-3 suffix [24, 3, H/N, 640, 64]
    at N = 2 (10 heads) and N = 4 (5 heads), bf16 and fp8, rows [2, 0, 0],
    [0, 1, 2] and [1, 2, 0]."""
    g = torch.Generator(device="cuda").manual_seed(5)
    as_bytes = lambda t: t.view(torch.uint8)  # noqa: E731  (bit-exact, fp8 too)
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        for heads in (10, 5):
            shape = (24, 3, heads, 640, 64)
            k = torch.randn(shape, generator=g, device="cuda").to(dtype)
            v = torch.randn(shape, generator=g, device="cuda").to(dtype)
            ok, ek = torch.empty_like(k), torch.empty_like(v)
            for rows_list in ([2, 0, 0], [0, 1, 2], [1, 2, 0]):
                rows = torch.tensor(rows_list, dtype=torch.int32, device="cuda")
                gk, gv = permute.permute_cache_rows(k, v, rows, ok, ek)
                rk, rv = permute.permute_cache_rows_plain(k, v, rows)
                torch.cuda.synchronize()
                exact = (torch.equal(as_bytes(gk), as_bytes(rk))
                         and torch.equal(as_bytes(gv), as_bytes(rv)))
                check(f"K3 permute {str(dtype)[6:]} {list(shape)} rows={rows_list} "
                      f"(the head shard of tp={20 // heads})", 0.0 if exact else float("inf"),
                      0.0, tolerance="bit-exact")
            del k, v, ok, ek
    torch.cuda.empty_cache()


def _codes_rule(want, got, margins) -> dict:
    """Codes against one card's: equal, or parted where one card's margin
    (from `margins`, one a step) fell below TP_EPS at or before the first
    difference."""
    import numpy as np

    diff = np.nonzero(want != got)[0]
    first = int(diff[0]) if diff.size else None
    near_tie = first is not None and float(np.min(margins[:first + 1])) < TP_EPS
    return {"codes_equal": first is None, "first_difference": first,
            "covered_by_near_tie": near_tie, "min_margin": float(np.min(margins)),
            "ok": first is None or near_tie}


def tp_greedy_fp32(torch, engine_mod, n: int, ref: dict) -> dict:
    """fp32 (TF32 off) decodes at full width over n cards against one card's
    eager decodes on the same weights (`tp_reference_fp32`):
      - greedy: codes equal up to and including the first step whose
        one-card top-2 logit margin is below TP_EPS; the step-0 logits'
        max |delta| reported;
      - greedy beam-3 under reorder="pallas" (K3 on every rank, once a
        step) against one card's lineage decode: codes equal, or some step
        of one card's decode had a near tie (a gap below TP_EPS among its
        2*3 + 1 best candidates; a swap there can change the winning
        sequence anywhere, so the rule is not tied to a position)."""
    import numpy as np

    tts, build_s = _tp_engine(engine_mod, n, fp32=True)
    try:
        ids, cond = ref["ids"], ref["cond"]
        codes, lens, steps = tts._decode_bucket(cond, ids, None, dict(TP_GREEDY))
        lat = tts._latents_batch_dev(cond, ids, ref["codes"], ref["lens"])
        head = tts.gpt_params_batched["mel_head"]
        logits = (lat[0].float() @ head["kernel"].float() + head["bias"].float()).cpu()
        _tp_counts(tts, reset=True)
        bcodes, blens, bsteps = _tp_beam_pallas(tts, cond, ids, TP_BEAM)
        bcounts = _tp_counts(tts)
    finally:
        tts.close()
    L = len(ref["codes"][0])
    greedy = _codes_rule(ref["codes"][0], codes[0], ref["margins"][:L])
    bdiff = np.nonzero(ref["beam_codes"][0] != bcodes[0])[0]
    beam_tie = float(np.min(ref["beam_gaps"])) < TP_EPS
    k3 = [c["K3"] for c in bcounts]
    beam = {"codes_equal": bdiff.size == 0, "lengths_equal": bool((ref["beam_lens"] == blens).all()),
            "differences": int(bdiff.size), "near_tie_in_reference": beam_tie,
            "min_gap": float(np.min(ref["beam_gaps"])), "steps": bsteps,
            "K3_by_rank": k3,
            "ok": (bdiff.size == 0 or beam_tie) and k3 == [bsteps] * n and bsteps > 0}
    return {"tp": n, "build_s": build_s, "steps": steps, **greedy,
            "step0_logits_max_abs_delta": float((logits[0] - ref["logits"][0]).abs().max()),
            "logits_max_abs_delta": float((logits[:L] - ref["logits"][:L]).abs().max()),
            "beam3_pallas": beam, "ok": greedy["ok"] and beam["ok"]}


def tp_reference_fp32(torch, engine_mod) -> dict:
    """One card's fp32 eager decodes of the flagship on the TP engines'
    weights (torch seed 0 on the CPU): greedy, with its teacher-forced
    logits and their top-2 margins; and greedy beam-3 (lineage), with each
    step's smallest gap between neighbours among the 2*3 + 1 best flat
    scores (those that decide which beams are banked and which go on)."""
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.ops import beam as beam_lib

    one, _ = _tp_engine(engine_mod, 1, fp32=True)
    params = uv.init_params(one.cfg.gpt, torch.Generator().manual_seed(0), torch.float32, "cpu")
    one.gpt_params = one.gpt_params_batched = _moved(params, one.device)
    del params
    ids, cond = _tp_ids(one, TWO), _tp_cond(torch, one)
    codes, lens, steps = one._decode_bucket(cond, ids, None,
                                            dict(TP_GREEDY, use_fused_trunk=False))
    lat = one._latents_batch_dev(cond, ids, codes, lens)
    head = one.gpt_params_batched["mel_head"]
    logits = (lat[0].float() @ head["kernel"].float() + head["bias"].float()).cpu()
    top2 = logits.topk(2, dim=-1).values
    gaps, plain = [], beam_lib.flat_scores

    def watched(*args, **kwargs):
        flat = plain(*args, **kwargs)
        top = flat.float().topk(2 * TP_BEAM["num_beams"] + 1, dim=-1).values
        gap = top[:, :-1] - top[:, 1:]
        gaps.append(float(gap[torch.isfinite(gap)].min()))
        return flat

    beam_lib.flat_scores = watched
    try:
        bcodes, blens, bsteps = one._decode_bucket(cond, ids, None, dict(TP_BEAM))
    finally:
        beam_lib.flat_scores = plain
    del one, lat
    torch.cuda.empty_cache()
    return {"ids": ids, "cond": cond, "codes": codes, "lens": lens, "steps": steps,
            "logits": logits, "margins": (top2[:, 0] - top2[:, 1]).numpy(),
            "beam_codes": bcodes, "beam_lens": blens, "beam_steps": bsteps, "beam_gaps": gaps}


def _tp_expect(counts, stats, layers: int, sentences: int, buckets=None) -> list:
    """What a path must have done on every rank: two trunk all-reduces a
    layer (48 at 24 layers) a decode step and a re-forward, K1 109 times a
    vocode on rank 0 alone, K2 and K4 never; returns the failures."""
    L2 = 2 * layers
    if buckets is None:
        reduces, vocodes = L2 * (stats["decode_steps"] + 2 * sentences), sentences
    else:
        reduces = L2 * (sum(stats["bucket_steps"]) + 2 * len(buckets))
        vocodes = len(buckets)
    bad = []
    for c in counts:
        if c["all_reduces"] != reduces:
            bad.append(f"rank {c['rank']}: {c['all_reduces']} all-reduces, not {reduces}")
        if c["K2"] or c["K4"]:
            bad.append(f"rank {c['rank']}: K2 {c['K2']} K4 {c['K4']}")
        if c["K1"] != (K1_PER_VOCODE * vocodes if c["rank"] == 0 else 0):
            bad.append(f"rank {c['rank']}: K1 {c['K1']} for {vocodes} vocodes")
        if c["agreements"] != counts[0]["agreements"] or c["K3"] != counts[0]["K3"]:
            bad.append(f"rank {c['rank']}: agreements {c['agreements']} K3 {c['K3']} against "
                       f"rank 0's {counts[0]['agreements']} {counts[0]['K3']}")
    return bad


def _tp_line(name: str, n: int, counts, ok: bool, bad: list, **extra) -> dict:
    line = {"phase": f"tensor parallel tp={n} bf16 {name}", **extra,
            "launches_by_rank": [{k: c[k] for k in ("rank", "K1", "K2", "K3", "K4",
                                                    "all_reduces", "agreements")}
                                 for c in counts],
            "codes_equal_on_every_rank": True, "ok": ok, "failures": bad}
    emit(line)
    return line


def tp_paths_bf16(torch, engine_mod, httpd, prompt: str, n: int) -> dict:
    """Every path at tp = n, bf16, full width: `infer` at the default beam-3,
    a sampling `infer` (its RTF reported), a guided `infer`, an `infer_fast`
    of two buckets, an `infer_stream`, and a beam-3 decode under
    reorder="pallas" (K3 on every rank, once a step), each with the counts at
    0 just before it and read just after on every rank (`_tp_expect`).  Then
    the ranks' checksums against shards cut here from the same weights, the
    trunk bytes a rank, peak memory, the decode-step and all-reduce timings,
    and `TTSService(tp=n)` over this engine (`tp_service`), whose shutdown
    closes it."""
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.parallel import mesh, multihost, tp as tp_mod

    tts, build_s = _tp_engine(engine_mod, n)
    failed, lines = [], []
    try:
        two = dict(max_text_tokens_per_sentence=40)       # TWO as two sentences
        runs = [("infer beam-3", "infer", dict(two, max_mel_tokens=48)),
                ("infer sampling", "infer", dict(two, num_beams=1, max_mel_tokens=96)),
                ("infer guided", "infer", dict(two, num_beams=1, cfg_scale=2.0,
                                               max_mel_tokens=40)),
                ("infer_fast two buckets", "infer_fast",
                 dict(two, num_beams=1, sentences_bucket_max_size=1, max_mel_tokens=40)),
                ("infer_stream", "infer_stream", dict(two, num_beams=1, max_mel_tokens=40))]
        per_rank = [dict.fromkeys(("K1", "K2", "K3", "K4", "all_reduces"), 0) for _ in range(n)]
        peak = [0] * n

        def tally(counts):
            for r, (acc, c) in enumerate(zip(per_rank, counts)):
                for k in acc:
                    acc[k] += c[k]
                peak[r] = max(peak[r], c["peak_bytes"])

        for name, method, gen in runs:
            _tp_counts(tts, reset=True)
            t0 = time.perf_counter()
            if method == "infer_stream":
                wav = [c for _, c in tts.infer_stream(prompt, TWO, seed=3, **gen)]
                samples = sum(len(c) for c in wav)
            else:
                _, wav = getattr(tts, method)(prompt, TWO, None, seed=3, **gen)
                samples = len(wav)
            s = time.perf_counter() - t0
            counts = _tp_counts(tts)
            stats = tts.last_stats
            bad = _tp_expect(counts, stats, tts.cfg.gpt.layers, len(stats["code_lens"]),
                             stats.get("buckets") if method == "infer_fast" else None)
            if len(stats["code_lens"]) != 2:
                bad.append(f"{len(stats['code_lens'])} sentences, not 2")
            ok = not bad and samples > 0
            lines.append(_tp_line(name, n, counts, ok, bad, s=s, rtf=stats.get("rtf"),
                                  code_lens=stats["code_lens"],
                                  decode_steps=stats["decode_steps"]))
            tally(counts)
            if not ok:
                failed.append(f"{name}: {bad}")
        ids, cond = _tp_ids(tts, TWO), _tp_cond(torch, tts)
        _tp_counts(tts, reset=True)
        t0 = time.perf_counter()
        _, lens, steps = _tp_beam_pallas(tts, cond, ids, dict(max_mel_tokens=48),
                                         torch.Generator(device="cuda").manual_seed(3))
        s = time.perf_counter() - t0
        counts = _tp_counts(tts)
        reduces = 2 * tts.cfg.gpt.layers * (steps + 1)
        bad = [f"rank {c['rank']}: all-reduces {c['all_reduces']} (not {reduces}), K3 "
               f"{c['K3']} (not {steps}), K1 {c['K1']} K2 {c['K2']} K4 {c['K4']}"
               for c in counts if (c["all_reduces"], c["K3"], c["K1"], c["K2"], c["K4"])
               != (reduces, steps, 0, 0, 0)]
        ok = not bad and steps > 0
        lines.append(_tp_line("beam-3 decode reorder=pallas", n, counts, ok, bad, s=s,
                              code_lens=[int(x) for x in lens], decode_steps=steps))
        tally(counts)
        if not ok:
            failed.append(f"beam-3 pallas: {bad}")
        for r, acc in enumerate(per_rank):
            emit({"launches": f"tp={n} rank {r} over the six paths", "device": f"cuda:{r}",
                  **acc})
        counts = _tp_counts(tts)
        master = uv.init_params(tts.cfg.gpt, torch.Generator().manual_seed(0), torch.bfloat16,
                                "cpu")["gpt"]
        whole = sum(t.numel() * t.element_size() for t in mesh._flatten(master)[0])
        want = [multihost.tree_checksum(tp_mod.shard_gpt_params(master, r, n)) for r in range(n)]
        del master
        got = tts._on_ranks("chip_smoke:tp_rank_checksum")
        share = [c["trunk_bytes"] / whole for c in counts]
        weights_ok = got == want and all(abs(x - 1 / n) < 0.01 for x in share)
        if not weights_ok:
            failed.append(f"checksums {got} against {want}, trunk shares {share}")
        timing = {"row": _step_ms(torch, tts, cond, ids, num_beams=1),
                  "beam3": _step_ms(torch, tts, cond, ids)}
        tts._on_ranks("chip_smoke:tp_rank_time_all_reduces", True)
        _tp_counts(tts, reset=True)
        _, _, steps = tts._decode_bucket(cond, ids, torch.Generator(device="cuda").manual_seed(0),
                                         dict(num_beams=1, max_mel_tokens=TP_STEP_LENS[1]))
        reduce_ms = tts._on_ranks("chip_smoke:tp_rank_time_all_reduces", False)
        timed = _tp_counts(tts)
        emit({"phase": f"tensor parallel tp={n} bf16 weights and memory", "card": card_line(),
              "build_s": build_s, "checksums_equal_rank0_shards": got == want,
              "trunk_bytes_by_rank": [c["trunk_bytes"] for c in counts],
              "trunk_bytes_whole": whole, "trunk_share_by_rank": share,
              "peak_gib_by_rank_over_the_paths": [p / 2**30 for p in peak]})
        emit({"phase": f"tensor parallel tp={n} bf16 decode step", "card": card_line(),
              "row_ms": timing["row"], "beam3_ms": timing["beam3"],
              "all_reduce_ms_per_step_by_rank": [ms / (steps + 1) for ms in reduce_ms],
              "all_reduces_per_step_by_rank": [c["all_reduces"] / (steps + 1) for c in timed],
              "steps": steps})
        if not all(c["all_reduces"] == 2 * tts.cfg.gpt.layers * (steps + 1) for c in timed):
            failed.append(f"all-reduces a step {[c['all_reduces'] for c in timed]}")
        tp_service(httpd, tts, prompt, n)
    finally:
        tts.close()
    if failed:
        raise SmokeFailure(f"tensor parallel tp={n}: " + "; ".join(failed))
    return {"lines": lines, "timing": timing}


def tp_step_timing(torch, engine_mod, n: int) -> dict:
    """Decode-step ms at tp = n (bf16, full width): one sampling row (at
    n = 1 both eager and through K2) and beam-3."""
    tts, build_s = _tp_engine(engine_mod, n)
    try:
        ids, cond = _tp_ids(tts, TWO), _tp_cond(torch, tts)
        out = {"row": _step_ms(torch, tts, cond, ids, num_beams=1, use_fused_trunk=False),
               "beam3": _step_ms(torch, tts, cond, ids)}
        if n == 1:
            out["row_k2"] = _step_ms(torch, tts, cond, ids, num_beams=1)
        peak = [c["peak_bytes"] / 2**30 for c in _tp_counts(tts)]
    finally:
        tts.close()
    emit({"phase": f"tensor parallel tp={n} bf16 decode step", "card": card_line(),
          "build_s": build_s, **{f"{k}_ms": v for k, v in out.items()},
          "peak_gib_by_rank": peak})
    return out


def tp_service(httpd, tts, prompt: str, n: int) -> None:
    """`TTSService(tp=n)` over the engine `tts` answering two concurrent
    /tts requests over a socket (one `infer`, one `infer_fast`); its
    shutdown closes the engine and stops its followers."""
    import concurrent.futures
    import threading

    t0 = time.perf_counter()
    server = httpd.serve(None, os.path.join(HERE, "checkpoints_test"), host="127.0.0.1",
                         port=0, tp=n, engine_instance=tts)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    followers = list(tts._tp.procs)
    try:
        bodies = [{"text": TWO, "audio_path": prompt, "seed": s, "num_beams": 1,
                   "max_mel_tokens": 60, "mode": mode} for s, mode in ((1, "normal"),
                                                                     (2, "fast"))]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            answers = list(pool.map(lambda b: _http(port, "/tts", b), bodies))
    finally:
        server.shutdown()
    served = [(a[0], a[2][:4] == b"RIFF", len(a[2]), a[3]) for a in answers]
    ok = all(st == 200 and riff for st, riff, _, _ in served)
    stopped = [p.poll() for p in followers]
    emit({"phase": f"tensor parallel TTSService(tp={n}), two concurrent /tts",
          "s": time.perf_counter() - t0, "answers_status_riff_bytes_s": served,
          "followers_exit_codes": stopped, "ok": ok and stopped == [0] * len(followers)})
    if not (ok and stopped == [0] * len(followers)):
        raise SmokeFailure(f"TTSService(tp={n}): {served}, followers {stopped}")


def tp_cli(prompt: str, out_dir: str) -> None:
    """The CLI with `--tp 2` as a command: a wav, exit 0.  Its config is the
    flagship with the mel positions cut to 128, which caps each sentence's
    decode at 128 codes."""
    sys.path.insert(0, HERE)
    import dataclasses

    from indextts_tpu_torch.config import Config

    cfg = Config()
    cfg = dataclasses.replace(cfg, gpt=dataclasses.replace(cfg.gpt, max_mel_tokens=128))
    cfg_path = os.path.join(out_dir, "tp_cli_config.yaml")
    cfg.save(cfg_path)
    out = os.path.join(out_dir, "tp_cli.wav")
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.cli", TWO, "-v", prompt,
                          "-o", out, "-f", "-c", cfg_path,
                          "--model_dir", os.path.join(HERE, "checkpoints_test"),
                          "--tp", "2", "--num_beams", "1", "--seed", "5"], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    ok = cli.returncode == 0 and os.path.exists(out) and os.path.getsize(out) > 44
    emit({"phase": "tensor parallel CLI --tp 2", "s": time.perf_counter() - t0,
          "rc": cli.returncode, "tail": cli.stdout.strip().splitlines()[-3:], "ok": ok})
    if not ok:
        raise SmokeFailure(f"CLI --tp 2: rc {cli.returncode}: {cli.stderr[-2000:]}")


def tp_faults(torch, engine_mod) -> dict:
    """Rank 0 of a tp = 2 engine on cards 0 and 1 (the flagship cut to 2
    layers, to build quickly), its deadline TP_FAULT_DEADLINE_S, decoding
    over and over: half a second after its first decode its follower is
    stopped (SIGSTOP: alive and hung); then, in a new engine on the same
    cards, killed.  Rank 0 must raise TPBroken each time, within the
    deadline and 15 s more for the hang and within 15 s for the death; the
    second engine decoding at all shows the cards serve again after an
    aborted group.
    Runs in a process of its own (`--tp-faults`), which the caller bounds."""
    import dataclasses
    import signal
    import threading

    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.parallel import tp as tp_mod

    tp_mod.TIMEOUT_S = TP_FAULT_DEADLINE_S
    config = Config()
    config = dataclasses.replace(config, gpt=dataclasses.replace(config.gpt, layers=2))
    out = {"deadline_s": TP_FAULT_DEADLINE_S}
    for case, sig, limit in (("hang", signal.SIGSTOP, TP_FAULT_DEADLINE_S + 15.0),
                             ("death", signal.SIGKILL, 15.0)):
        t0 = time.perf_counter()
        tts = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                                  device="cuda", seed=0, config=config, tp=2)
        build_s = time.perf_counter() - t0
        ids, cond = _tp_ids(tts, TWO), _tp_cond(torch, tts)
        follower = tts._tp.procs[0]
        sent = []

        def fault():
            sent.append(time.monotonic())
            os.kill(follower.pid, sig)

        timer = threading.Timer(0.5, fault)     # into the second decode
        decodes, err = 0, None
        try:
            while not sent or time.monotonic() - sent[0] < limit + 30.0:
                tts._decode_bucket(cond, ids, None, dict(num_beams=1, do_sample=False,
                                                         max_mel_tokens=200))
                decodes += 1
                if decodes == 1:
                    timer.start()
        except Exception as e:   # noqa: BLE001 — reported
            err = e
        raised = time.monotonic()
        timer.cancel()
        tts.close()
        took = raised - sent[0] if sent else None
        ok = (isinstance(err, tp_mod.TPBroken) and took is not None and took <= limit
              and follower.poll() is not None)
        out[case] = {"build_s": build_s, "decodes_before_the_fault": decodes,
                     "raised": type(err).__name__ if err else None,
                     "s_from_signal_to_raise": took, "limit_s": limit,
                     "why": str(err)[:400] if err else None,
                     "follower_returncode": follower.poll(), "ok": ok}
    out["ok"] = out["hang"]["ok"] and out["death"]["ok"]
    return out


def tp_fault_cases() -> None:
    """`tp_faults` in a process of its own, bounded by TP_FAULT_LIMIT_S (its
    followers ended with it), so that a fault that hangs fails the check
    rather than the smoke."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--tp-faults"],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TP_FAULT_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise SmokeFailure(f"the tensor-parallel fault cases outlived {TP_FAULT_LIMIT_S} s: "
                           f"{out[-2000:]} {err[-3000:]}") from None
    lines = out.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {"ok": False}
    emit({"phase": "tensor parallel tp=2 a follower hung, then one killed, mid-decode",
          "s": time.perf_counter() - t0, "rc": proc.returncode, **res})
    if proc.returncode != 0 or not res.get("ok"):
        raise SmokeFailure(f"tensor-parallel fault cases: rc {proc.returncode}: {res}: "
                           f"{err[-3000:]}")


def tensor_parallel(torch, engine_mod, httpd, permute, prompt: str, out_dir: str,
                    n: int) -> None:
    """The tensor-parallel phase of `--dp N` (N >= 2; tp = 2 on cards 0-1 and
    tp = N): K3 on the head shards, fp32 greedy and beam-3 against one card,
    every path at bf16 with its per-rank checks and the server, the
    decode-step timings at tp = 1, 2 and N, the CLI, and a follower that
    hangs or dies."""
    t0 = time.perf_counter()
    tp_permute_checks(torch, permute)
    ref = tp_reference_fp32(torch, engine_mod)
    emit({"phase": "tensor parallel fp32 one-card reference", "steps": ref["steps"],
          "min_margin": float(ref["margins"][:64].min()), "beam_steps": ref["beam_steps"],
          "beam_min_gap": float(min(ref["beam_gaps"])), "eps": TP_EPS})
    for k in sorted({2, n}):
        res = tp_greedy_fp32(torch, engine_mod, k, ref)
        emit({"phase": f"tensor parallel tp={k} fp32 greedy and beam-3 against one card",
              "card": card_line(), **res})
        if not res["ok"]:
            raise SmokeFailure(f"tp={k} fp32 codes: {res}")
    tp_paths_bf16(torch, engine_mod, httpd, prompt, n)
    for k in sorted({1, 2} - {n}):
        tp_step_timing(torch, engine_mod, k)
    tp_cli(prompt, out_dir)
    tp_fault_cases()
    emit({"phase": f"tensor parallel across {n} cards", "s": time.perf_counter() - t0})


def main(argv=None) -> int:
    import argparse
    import shutil

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dp", type=int, default=0,
                   help="run only the multi-card checks (data and tensor parallel) over "
                        "this many cards")
    p.add_argument("--only-tp", action="store_true",
                   help="with --dp: run only the tensor-parallel phase")
    p.add_argument("--vocoder-cli-rank", metavar="DIR", help=argparse.SUPPRESS)
    p.add_argument("--tp-faults", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("rest", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.vocoder_cli_rank:   # a rank under torch.distributed.run
        sys.path.insert(0, HERE)
        vocoder_cli_rank(args.vocoder_cli_rank, [a for a in args.rest if a != "--"])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.tp_faults:          # the fault cases' own process (tp_fault_cases)
        sys.path.insert(0, HERE)
        from indextts_tpu_torch import engine as engine_mod

        emit(tp_faults(torch, engine_mod))
        sys.stdout.flush()
        os._exit(0)   # the aborted groups are left to the process's end
    if args.dp and torch.cuda.device_count() < args.dp:
        print(f"chip_smoke: --dp {args.dp} needs {args.dp} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from indextts_tpu_torch import engine as engine_mod
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.models import unified_voice as uv
    from indextts_tpu_torch.ops import filters, quantization, sampling
    from indextts_tpu_torch.ops.cuda import _build, anti_alias, decode_layer, permute, pool_trunk
    from indextts_tpu_torch.ops.cuda.anti_alias import fused_anti_alias_activation as k1
    from indextts_tpu_torch.io import export
    from indextts_tpu_torch.serve import beam_pool, httpd

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
    out_dir = os.path.join(HERE, "_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    prompt = os.path.join(out_dir, "prompt.wav")
    write_prompt(prompt)
    if args.dp:
        from indextts_tpu_torch.tools import entry

        if not args.only_tp:
            pool_group_agreement(torch, engine_mod, prompt, args.dp)
            torch.cuda.empty_cache()
            dp_training(torch, args.dp, out_dir)
            t0 = time.perf_counter()
            dry = entry.dryrun_multichip(args.dp)
            emit({"phase": f"dryrun_multichip({args.dp})", "s": time.perf_counter() - t0,
                  **dry})
            torch.cuda.empty_cache()
        tensor_parallel(torch, engine_mod, httpd, permute, prompt, out_dir, args.dp)
        emit({"phase": "done", "s": time.perf_counter() - t_start})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    fp8_conversion_check(torch, _build)
    entries = [kernel_checks_anti_alias(torch, filters, k1, anti_alias.plan),
               *kernel_checks_decode(torch, gpt2, decode_layer, quantization),
               kernel_checks_permute(torch, permute),
               *kernel_checks_pool(torch, gpt2, pool_trunk, quantization)]

    vocode_profile(torch, "flagship bf16 vocode")
    sampling_shortlist_timing(torch, sampling)
    small_agreement(torch, engine_mod, prompt)
    pool_small_agreement(torch, engine_mod, pool_trunk, prompt)
    kernels = {"K1": k1, "K2": decode_layer.fused_decode_trunk_flat,
               "K3": permute.permute_cache_rows, "K4": pool_trunk.fused_pool_step}
    launches, beam3 = end_to_end(torch, engine_mod, httpd, kernels, prompt)
    # the checkpoint and beam-pool slice: each path with the counts at 0 just
    # before it, read just after
    gpt_pth, checksum, n = checkpoint_round_trip(torch, engine_mod, export, kernels, prompt,
                                                 out_dir)
    launches["fused_anti_alias_activation"] += n["K1"]
    launches["fused_decode_trunk_flat[bf16]"] += n["K2"]
    beam_pool_small_agreement(torch, engine_mod, uv, beam_pool, prompt)
    launches["fused_anti_alias_activation"] += served_beam(torch, engine_mod, httpd, uv,
                                                           kernels, prompt, beam3)
    n = reload_and_warmup(torch, engine_mod, httpd, kernels, prompt, gpt_pth, checksum)
    launches["fused_anti_alias_activation"] += n["K1"]
    # the DVAE and extraction slice: its path reaches no kernel, with the
    # counts at 0 just before it and read just after
    extract_root = extract_and_dvae(torch, out_dir)
    # the vocoder fine-tuning slice over that extraction output: K1 forward
    # and K1b backward, the counts at 0 just before each path, read just after
    k1b_entry, n_k1, n_k1b = vocoder_finetune(torch, engine_mod, kernels, prompt, extract_root)
    entries.insert(1, k1b_entry)
    launches["fused_anti_alias_activation"] += n_k1
    launches["anti_alias_activation_backward"] = n_k1b
    # the LoRA fine-tuning slice: its served requests with the counts at 0
    # just before each, read just after
    n, trained = lora_finetune(torch, engine_mod, kernels, prompt, out_dir)
    launches["fused_anti_alias_activation"] += n["K1"]
    launches["fused_decode_trunk_flat[bf16]"] += n["K2"]
    # the beam-reorder path: counts at 0 just before it, read just after
    tts = engine_mod.IndexTTS(cfg_path=None, model_dir=os.path.join(HERE, "checkpoints_test"),
                              device="cuda", seed=0)
    for k in kernels.values():
        k.launches = 0
    launches["permute_cache_rows"] = beam_reorder_agreement(torch, uv, permute, tts, prompt)
    del tts
    torch.cuda.empty_cache()
    # the served path, once per K4 tier: counts at 0 just before the requests
    for tier in ("bf16", "int8_fp8cache"):
        launches[f"fused_pool_step[{tier}]"] = served(torch, engine_mod, httpd, kernels,
                                                      prompt, tier)
    # the tools and front ends, over the directories the trainers wrote:
    # the counts at 0 just before each tool, read just after
    trained.update(dvae_step=os.path.join(extract_root, "dvae_run", "dvae_step_40"),
                   extracted=os.path.join(extract_root, "extracted"),
                   model=os.path.join(extract_root, "model"),
                   vocoder_step=os.path.join(extract_root, "vocoder_latents", "vocoder_step_3"),
                   vocoder_wav=os.path.join(extract_root, "served_vocoder.wav"))
    for name, n in tools_phase(torch, engine_mod, kernels, prompt, out_dir, trained).items():
        launches[name] = launches.get(name, 0) + n
    shutil.rmtree(extract_root)
    shutil.rmtree(trained["root"])
    for e in entries:
        e["launches"] = launches[e["name"]]
        if e["launches"] == 0:
            raise SmokeFailure(f"{e['name']} was not launched on its path")
    emit({"phase": "done", "s": time.perf_counter() - t_start})
    emit({"earlier_design_ms": EARLIER_MS,
          "note": "the previous design's graph-replay times, quoted from PERF.md; not measured in this run"})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
