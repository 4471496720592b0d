"""Builds the package's CUDA kernels at first use and binds them with ctypes.

Each source under `indextts_tpu_torch/csrc/` has a plain C interface (no
PyTorch headers), so `nvcc` takes seconds.  The sources compile in parallel,
one `nvcc` each, into `indextts_tpu_torch/_build/libkernels.so` (listed in
.gitignore).  The build is keyed on a hash of the sources and flags: a
library whose stamp matches is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "anti_alias.cu", _PKG / "csrc" / "decode_layer.cu",
           _PKG / "csrc" / "permute.cu", _PKG / "csrc" / "pool_trunk.cu")
HEADERS = (_PKG / "csrc" / "trunk_common.cuh",)
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point: pointers and the stream as c_void_p
_SIGNATURES = {
    "anti_alias_activation": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources (in parallel) and link libkernels.so, unless the
    library on disk was built from the same sources and flags."""
    digest = _digest()
    stamp = BUILD_DIR / "libkernels.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib_tmp = os.path.join(tmp, LIB_PATH.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib_tmp],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype set."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.kernels_error_string(rc).decode()})")
