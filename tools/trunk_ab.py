#!/usr/bin/env python3
"""A/B timing of the port's kernel sources on one NVIDIA GPU.

    python3 tools/trunk_ab.py [--k2 | --k1 | --k1b] base=indextts_tpu_torch/csrc other=path/to/csrc ...

Each NAME=DIR is a copy of `indextts_tpu_torch/csrc/` (for example one
unpacked from another commit with `git archive`).  Every tree is built by
`ops/cuda/_build.load` into its own library under the git-ignored
`indextts_tpu_torch/_build/ab/` (all trees at once), and the port's
wrappers are timed on each in turns (A B ... B A), in one process on one
card, as CUDA-graph replays (chip_smoke.py's `cuda_ms`).

By default: K2 (`fused_decode_trunk_flat`) at the flagship width on bf16,
int8 and int4 weights and bf16 weights over an e4m3 cache, at position 700
of T = 768, and K4 (`fused_pool_step`) on bf16 weights and on int8 weights
over an e4m3 cache at S = 8 and S = 64; prints one line per (tree, kernel)
with its times and K2's max|kernel - plain|.  With `--k2`, K2 only.

With `--k1`: K1 (`fused_anti_alias_activation`) at the six stage shapes of
one flagship bf16 vocode (chip_smoke.py's `k1_stage_shapes`); prints, per
tree, each shape's ms, the ms per vocode (109 calls), max|kernel - plain|,
the static SASS instruction counts of its kernels by class and their
resource use (`cuobjdump -sass` and `-res-usage` on the tree's library),
a profile of one flagship vocode on that tree (chip_smoke.py's
`vocode_profile`), and the last stage's shape at 1, 4 and 16 rows of batch
with the SM clock read while it runs.

With `--k1b`: K1's backward (`anti_alias_activation_backward`, fp32) at
the six stage shapes of one vocoder training step (batch 8, 24 codes;
chip_smoke.py's `vocoder_stage_shapes`); prints, per tree, each shape's ms
and share of its bound, the ms a step (109 calls) as graph replays and as
eager calls, the largest max|kernel - plain| / max|plain| of grad_x,
grad_alpha and grad_beta, the static SASS counts and resource use of its
kernels, each kernel's device time at each shape (torch.profiler), and,
for a tree with the current interface, each shape's ms under the plan the
wrapper chooses and under other steps a segment.  A tree with K1b's first
interface (`anti_alias_activation_backward` with a scratch buffer) is
called through a copy of that interface's wrapper.
"""


from __future__ import annotations

import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("trunk_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.ops import quantization
    from indextts_tpu_torch.ops.cuda import _build, decode_layer, pool_trunk

    print(cs.card_line(), flush=True)
    k2_only = "--k2" in argv
    trees = dict(arg.split("=", 1) for arg in argv if not arg.startswith("--"))

    def load(name):
        out = Path(ROOT) / "indextts_tpu_torch" / "_build" / "ab" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(trees[name], out / "csrc")
        return _build.load(out / "csrc", out)

    with ThreadPoolExecutor(len(trees)) as pool:
        libs = dict(zip(trees, pool.map(load, trees)))
    order = list(libs) + list(reversed(list(libs)))
    use = lambda lib: setattr(_build, "load", lambda: lib)  # noqa: E731
    if "--k1" in argv:
        return k1_ab(torch, cs, libs, order, use)
    if "--k1b" in argv:
        return k1b_ab(torch, cs, libs, order)
    L, D, H, T, pos = 24, 1280, 20, 768, 700
    params, k0, v0, hidden = cs.decode_inputs(torch, gpt2, L, D, H, T, "cuda", torch.bfloat16)
    mask, _ = cs.decode_masks(torch, T, pos, False, "cuda")
    tiers = {"bf16": params,
             "int8": quantization.quantize_gpt_params({"gpt": params}, bits=8)["gpt"],
             "int4": quantization.quantize_gpt_params({"gpt": params}, bits=4)["gpt"]}
    times, errs = {}, {}
    k2 = decode_layer.fused_decode_trunk_flat
    tiers["fp8_cache"] = params
    for name in order:
        use(libs[name])
        for tier, tp in tiers.items():
            kc, vc = ((k0.to(torch.float8_e4m3fn), v0.to(torch.float8_e4m3fn))
                      if tier == "fp8_cache" else (k0.clone(), v0.clone()))
            args = [(tp, hidden, kc, vc, pos, mask, H)]
            got = k2(*args[0])[0]
            ref = decode_layer.decode_trunk_plain(*args[0])[0]
            errs[(name, tier)] = (got.float() - ref.float()).abs().max().item()
            times.setdefault((name, f"K2 {tier}"), []).append(cs.cuda_ms(k2, args, 20))
    del k0, v0
    torch.cuda.empty_cache()
    for S in () if k2_only else (8, 64):
        g = torch.Generator(device="cuda").manual_seed(7)
        kc = (4 * torch.randn(L, S, T, D, generator=g, device="cuda")).to(torch.bfloat16)
        vc = torch.randn(L, S, T, D, generator=g, device="cuda").to(torch.bfloat16)
        hid = (0.5 * torch.randn(S, D, generator=g, device="cuda")).to(torch.bfloat16)
        positions, pmask = cs.pool_inputs(torch, S, T, "cuda")
        kc8, vc8 = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
        for name in order:
            use(libs[name])
            for tier, tp, k_, v_ in (("bf16", params, kc, vc),
                                     ("int8_fp8cache", tiers["int8"], kc8, vc8)):
                args = [(tp, hid, k_, v_, positions, pmask, H)]
                times.setdefault((name, f"K4 {tier} S={S}"), []).append(
                    cs.cuda_ms(pool_trunk.fused_pool_step, args, 10))
        del kc8, vc8
        del kc, vc
        torch.cuda.empty_cache()
    for (name, what), ms in times.items():
        err = errs.get((name, what.split()[1])) if what.startswith("K2") else None
        print(f"{name} {what}: ms {[round(t, 4) for t in ms]}"
              + (f" max_abs_err {err}" if err is not None else ""), flush=True)
    return 0


CLASSES = {"FFMA": "ffma", "FMUL": "fmul", "FADD": "fadd", "MUFU": "mufu", "SHFL": "shfl",
           "LDS": "lds", "STS": "sts", "LDG": "ldg", "STG": "stg", "LDL": "local",
           "STL": "local", "BAR": "barrier", "CALL": "call", "RET": "call",
           "F2F": "convert", "F2FP": "convert", "F2I": "convert", "I2F": "convert",
           "FRND": "convert", "FSETP": "fp_compare_select", "FSEL": "fp_compare_select",
           "FMNMX": "fp_compare_select", "FCHK": "fp_compare_select", "LDC": "constant",
           "MOV": "move", "PRMT": "move", "S2R": "move", "CS2R": "move", "P2R": "move",
           "R2P": "move", "BRA": "branch", "BSSY": "branch", "BSYNC": "branch",
           "WARPSYNC": "branch", "BREAK": "branch", "BMOV": "branch", "EXIT": "branch"}
INTEGER = ("IMAD", "IADD3", "ISETP", "LOP3", "SHF", "LEA", "IABS", "SEL", "IMNMX", "VIMNMX",
           "IMUL", "POPC", "FLO", "PLOP3", "ISCADD", "SGXT", "BMSK", "IDP", "I2I")


def sass_class(op: str) -> str:
    if op in CLASSES:
        return CLASSES[op]
    if op in INTEGER:
        return "integer"
    return "uniform" if op.startswith("U") else "other"


def sass_counts(lib_path, match: str = "anti_alias") -> dict:
    """Static SASS instruction counts of each kernel whose name holds
    `match` (K1's by default) in a built library, by class, NOPs left out
    (cuobjdump -sass), and the kernels' resource use (-res-usage)."""
    import re
    import subprocess

    cuobjdump = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    res = subprocess.run([cuobjdump, "-res-usage", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1) if match in head.group(1) else None
            if fn:
                counts[fn] = {"total": 0}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and ins and ins.group(1) != "NOP":
            c = counts[fn]
            cls = sass_class(ins.group(1))
            c["total"] += 1
            c[cls] = c.get(cls, 0) + 1
    usage = {}
    lines = res.splitlines()
    for i, line in enumerate(lines):
        if "Function" in line and match in line and i + 1 < len(lines):
            usage[line.split("Function")[1].strip(" :")] = lines[i + 1].strip()
    return {"sass": counts, "res_usage": usage}


def _nvcc_path() -> str:
    from indextts_tpu_torch.ops.cuda import _build

    return _build._nvcc()


def k1_ab(torch, cs, libs, order, use) -> int:
    """K1 of each tree at the six stage shapes of one bf16 vocode, in turns."""
    from indextts_tpu_torch.ops import filters
    from indextts_tpu_torch.ops.cuda.anti_alias import fused_anti_alias_activation as k1

    stages = cs.k1_stage_shapes()
    calls = cs.k1_vocode_calls(stages)
    g = torch.Generator(device="cuda").manual_seed(0)
    sets = {s: cs.k1_input_sets(torch, g, 1, *s, torch.bfloat16) for s in stages}
    refs = {s: filters.anti_aliased_activation(*sets[s][0]) for s in stages}
    times, errs = {}, {}
    for name in order:
        use(libs[name])
        for s in stages:
            got = k1(*sets[s][0])
            errs[name] = max(errs.get(name, 0.0),
                             (got.float() - refs[s].float()).abs().max().item())
            times.setdefault((name, s), []).append(
                cs.cuda_ms(k1, sets[s], max(20, len(sets[s]))))
    del sets, refs
    torch.cuda.empty_cache()
    for name, lib in libs.items():
        per = {f"C={C} T={T}": [round(t, 5) for t in times[(name, (C, T))]]
               for C, T in stages}
        vocode = [sum(n * times[(name, s)][i] for s, n in calls.items())
                  for i in range(len(times[(name, stages[0])]))]
        print(f"{name} K1 per shape ms {per}", flush=True)
        print(f"{name} K1 per vocode ms {[round(t, 4) for t in vocode]} "
              f"max_abs_err {errs[name]}", flush=True)
        print(f"{name} K1 {sass_counts(lib._name)}", flush=True)
    for name in libs:
        use(libs[name])
        cs.vocode_profile(torch, name)
        k1_scaling(torch, cs, k1, name, stages[-1])
    return 0


def scratch_k1b(torch, lib):
    """K1b through a copy of its first design's wrapper, for a tree with that
    interface:
    grad_x, grad_alpha, grad_beta and a scratch buffer allocated a call."""
    import ctypes

    from indextts_tpu_torch.ops.cuda import _build
    from indextts_tpu_torch.ops.cuda.anti_alias import _TAPS

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.anti_alias_activation_backward.argtypes = [P] * 8 + [I] * 4 + [P, P]
    lib.anti_alias_activation_backward.restype = I
    lib.anti_alias_backward_scratch_floats.argtypes = [I, I, I]
    lib.anti_alias_backward_scratch_floats.restype = ctypes.c_longlong

    def k1b(x, alpha, beta, grad_y, logscale=True):
        B, C, T = x.shape
        alpha = alpha.float().contiguous()
        beta = beta.float().contiguous()
        grad_x = torch.empty_like(x)
        grad_alpha = torch.empty(C, dtype=torch.float32, device=x.device)
        grad_beta = torch.empty(C, dtype=torch.float32, device=x.device)
        scratch = torch.empty(lib.anti_alias_backward_scratch_floats(B, C, T),
                              dtype=torch.float32, device=x.device)
        rc = lib.anti_alias_activation_backward(
            x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), grad_y.data_ptr(),
            grad_x.data_ptr(), grad_alpha.data_ptr(), grad_beta.data_ptr(), scratch.data_ptr(),
            B, C, T, int(logscale), _TAPS, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "anti_alias_activation_backward")
        return grad_x, grad_alpha, grad_beta

    return k1b


def k1b_ab(torch, cs, libs, order) -> int:
    """K1b of each tree at the six stage shapes of a vocoder training step,
    in turns, as graph replays and eager calls."""
    from indextts_tpu_torch.ops import filters
    from indextts_tpu_torch.ops.cuda import _build, anti_alias

    def use(lib):
        if hasattr(lib, "anti_alias_backward_launch"):
            _build.load = lambda: lib
            anti_alias._K1B_LIB = None
            anti_alias._K1B_LAUNCHES.clear()
            return anti_alias.anti_alias_activation_backward
        return scratch_k1b(torch, lib)

    shapes, counts = cs.vocoder_stage_shapes(8, cs.VOC_CODES)
    g = torch.Generator(device="cuda").manual_seed(5)
    sets = {}
    for B, C, T in shapes:
        nbytes = 4 * B * C * T
        n_sets = max(2, min(16, -(-int(100e6) // (2 * nbytes))))
        sets[(B, C, T)] = [cs.k1b_inputs(torch, g, B, C, T) for _ in range(n_sets)]
    refs = {s: filters.anti_aliased_activation_backward(*sets[s][0]) for s in shapes}
    times, eager, errs = {}, {}, {}
    for name in order:
        k1b = use(libs[name])
        for s in shapes:
            errs[name] = max([errs.get(name, 0.0)]
                             + list(cs.k1b_errors(k1b(*sets[s][0]), refs[s]).values()))
            iters = max(20, len(sets[s]))
            times.setdefault((name, s), []).append(cs.cuda_ms(k1b, sets[s], iters))
            eager.setdefault((name, s), []).append(cs.cuda_ms(k1b, sets[s], iters, graph=False))
    del sets, refs
    torch.cuda.empty_cache()
    bound = {s: (3 * 4 * s[0] * s[1] * s[2] + 16 * s[1]) / cs.HBM_BYTES_PER_S * 1e3
             for s in shapes}
    for name, lib in libs.items():
        per = {f"B={B} C={C} T={T}": {"ms": [round(t, 5) for t in times[(name, (B, C, T))]],
                                      "share_of_bound": round(bound[(B, C, T)]
                                                              / min(times[(name, (B, C, T))]), 4)}
               for B, C, T in shapes}
        runs = len(times[(name, shapes[0])])
        step = [sum(n * times[(name, s)][i] for s, n in counts.items()) for i in range(runs)]
        step_eager = [sum(n * eager[(name, s)][i] for s, n in counts.items())
                      for i in range(runs)]
        print(f"{name} K1b per shape {per}", flush=True)
        step_bound = sum(n * bound[s] for s, n in counts.items())
        print(f"{name} K1b per training step ms {[round(t, 4) for t in step]} eager ms "
              f"{[round(t, 4) for t in step_eager]} bound ms {step_bound:.4f} "
              f"max_rel_err {errs[name]}", flush=True)
        print(f"{name} K1b {sass_counts(lib._name, 'anti_alias_backward')}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    for name in libs:   # each kernel's device time at each shape, one call under the profiler
        k1b = use(libs[name])
        for B, C, T in shapes:
            args = cs.k1b_inputs(torch, g, B, C, T)
            for _ in range(3):   # a trace that lost one of the call's two kernels is taken again
                if cs.kernel_breakdown(torch, f"{name} K1b B={B} C={C} T={T}", k1b, args) >= 2:
                    break
        if hasattr(libs[name], "anti_alias_backward_launch"):
            k1b_steps(torch, cs, anti_alias, name, shapes, g)
    return 0


def k1b_steps(torch, cs, anti_alias, name: str, shapes, g) -> None:
    """Graph ms of K1b at each stage shape under the plan the wrapper
    chooses and under forced steps a segment around it (the planner's
    check)."""
    k1b = anti_alias.anti_alias_activation_backward
    for B, C, T in shapes:
        nbytes = 4 * B * C * T
        sets = [cs.k1b_inputs(torch, g, B, C, T)
                for _ in range(max(2, min(16, -(-int(100e6) // (2 * nbytes)))))]
        k1b(*sets[0])
        chosen = anti_alias.chosen_plan(B, C, T)
        units = chosen["rows"] if chosen["multi_row"] else chosen["chunks"]
        ms = {}
        for steps in sorted({1, 2, 4, 8, chosen["steps"] - 1, chosen["steps"] + 1}):
            if 1 <= steps <= units:
                plan = anti_alias.backward_plan(B, C, T, True, chosen["blocks_per_sm"],
                                                chosen["sms"], steps=steps)
                ms[steps] = round(cs.cuda_ms(lambda *a, p=plan: anti_alias._backward(*a, True, p),
                                             sets, max(20, len(sets))), 5)
        ms[f"chosen {chosen['steps']}"] = round(cs.cuda_ms(k1b, sets, max(20, len(sets))), 5)
        print(f"{name} K1b B={B} C={C} T={T} ms by steps a segment {ms}", flush=True)
        del sets


def k1_scaling(torch, cs, k1, name: str, shape) -> None:
    """K1 at the last stage's shape with 1, 4 and 16 rows of batch (graph
    replay): the marginal cost of the work apart from a launch's fixed cost;
    and the SM clock, power draw and limit that nvidia-smi reads while that
    shape runs for about a second."""
    import subprocess
    import threading

    C, T = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    ms = {}
    for B in (1, 4, 16):
        sets = cs.k1_input_sets(torch, g, B, C, T, torch.bfloat16)
        ms[B] = cs.cuda_ms(k1, sets, max(20, len(sets)))
        del sets
    sets = cs.k1_input_sets(torch, g, 1, C, T, torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(len(sets)):
            k1(*sets[i])
    samples = []

    def sample():
        for _ in range(4):
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                                  "power.draw,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=30)
            samples.append(out.stdout.strip())

    torch.cuda.synchronize()
    t = threading.Thread(target=sample)
    t0 = time.perf_counter()
    t.start()
    while t.is_alive():
        for _ in range(50):
            graph.replay()
        torch.cuda.synchronize()
    print(f"{name} K1 C={C} T={T} ms by batch {ms} marginal ms per row "
          f"{(ms[16] - ms[4]) / 12} busy {time.perf_counter() - t0:.2f}s "
          f"nvidia-smi {samples}", flush=True)
    del sets, graph
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
