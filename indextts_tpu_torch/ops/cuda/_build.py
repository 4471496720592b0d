"""Builds the package's CUDA kernels at first use and binds them with ctypes.

Each source under `indextts_tpu_torch/csrc/` has a plain C interface (no
PyTorch headers), so `nvcc` takes seconds.  The sources compile in parallel,
one `nvcc` each, into `indextts_tpu_torch/_build/libkernels.so` (listed in
.gitignore).  The build is keyed on a hash of the sources and flags: a
library whose stamp matches is loaded as it is.  The key covers every
`csrc/*.cu` and `csrc/*.cuh` found on disk, so no header can be left out of
it.  A build holds an exclusive lock on `out_dir`, so that of the ranks of
a data-parallel run, which all reach their first kernel together, one
builds and the others wait for it and load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point: pointers and the stream as c_void_p
_SIGNATURES = {
    "anti_alias_activation": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "anti_alias_plan": (_I, [_I, _I, _I, _I, _I, _P]),
    # x, alpha, beta, g, gx, grad_ab (and the partials), the launch's shape and plan, stream
    "anti_alias_backward_launch": (_I, [_P] * 8),
    "anti_alias_backward_resident": (_I, [_I, _I, _I]),
    "anti_alias_backward_layout": (_I, [_P]),
    # forms, hidden, out, k, v, mask, pos, L, D, H, T; ln1; qkv (w, s, groups,
    # bias); proj; ln2; fc; mproj; scratch, stream
    "decode_trunk_step": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                          + [_P, _P] + [_P, _P, _I, _P] * 2 + [_P, _P]
                          + [_P, _P, _I, _P] * 2 + [_P, _P]),
    "decode_trunk_scratch_floats": (ctypes.c_longlong, [_I, _I, _I]),
    # forms, hidden, out, k, v, k_rows, v_rows, positions, mask, S, L, D, H, T;
    # ln1; qkv (w, s, bias); proj; ln2; fc; mproj; scratch, stream
    "pool_trunk_step": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                        + [_P, _P] + [_P, _P, _P] * 2 + [_P, _P] + [_P, _P, _P] * 2
                        + [_P, _P]),
    "pool_trunk_scratch_floats": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "fp8_e4m3_roundtrip": (_I, [_P, _P, _P, _I, _P]),
    "fp8_e4m3_unpack16": (_I, [_P, _P, _I, _P]),
    "permute_cache_rows": (_I, [_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _P]),
    "kernels_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources(csrc: Path = CSRC) -> list:
    """The translation units in `csrc`: every `.cu` file, one `nvcc` each."""
    return sorted(csrc.glob("*.cu"))


def digest(csrc: Path = CSRC) -> str:
    """The build key: the flags and every `.cu` and `.cuh` file in `csrc`,
    names and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources in `csrc` (in parallel) and link libkernels.so in
    `out_dir`, unless the library there was built from the same sources and
    flags.  Other processes building into `out_dir` wait for this one."""
    key = digest(csrc)
    lib_path = out_dir / LIB_PATH.name
    stamp = out_dir / "libkernels.sha256"
    if lib_path.exists() and stamp.exists() and stamp.read_text() == key:
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (lib_path.exists() and stamp.exists() and stamp.read_text() == key):
            _compile(csrc, lib_path, stamp, key)
    return lib_path


def _compile(csrc: Path, lib_path: Path, stamp: Path, key: str) -> None:
    out_dir = lib_path.parent
    units = sources(csrc)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in units]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for src, obj in zip(units, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        for src, p, log in zip(units, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib_tmp = os.path.join(tmp, lib_path.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib_tmp],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, lib_path)
    stamp.write_text(key)


@functools.lru_cache(maxsize=None)
def load(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The kernel library built from `csrc` into `out_dir` if needed, with
    the argtypes of every entry point it exports set (an older source tree
    may lack the newest ones)."""
    lib = ctypes.CDLL(str(build(csrc, out_dir)))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.kernels_error_string(rc).decode()})")
