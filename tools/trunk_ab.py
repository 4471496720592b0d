#!/usr/bin/env python3
"""A/B timing of the port's kernel sources on one NVIDIA GPU.

    python3 tools/trunk_ab.py [--k2 | --k1] base=indextts_tpu_torch/csrc other=path/to/csrc ...

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


def sass_counts(lib_path) -> dict:
    """Static SASS instruction counts of each K1 kernel in a built library,
    by class, NOPs left out (cuobjdump -sass), and the kernels' resource use
    (-res-usage)."""
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
            fn = head.group(1) if "anti_alias" in head.group(1) else None
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
        if "Function" in line and "anti_alias" in line and i + 1 < len(lines):
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
