"""ctypes bindings for the native JSONL manifest indexer.

The C++ half lives in native/jsonl_index.cpp; it is built on first use with
the in-image toolchain (g++) and cached next to the source.  Falls back to
a pure-Python scan with identical output when a compiler is unavailable.
This powers the data layer's lazy byte-offset index mode
(reference: data_utils.py:475-603).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading
from typing import NamedTuple, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


class ManifestIndex(NamedTuple):
    offsets: np.ndarray    # [N] int64 byte offsets of line starts
    lengths: np.ndarray    # [N] int64 line byte lengths
    durations: np.ndarray  # [N] float64 "duration" field (-1 if absent)
    text_lens: np.ndarray  # [N] int64 codepoints of "text" field (-1 if absent)


def _build_library() -> Optional[ctypes.CDLL]:
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "jsonl_index.cpp"))
    lib_path = os.path.abspath(os.path.join(_NATIVE_DIR, "libjsonl_index.so"))
    if not os.path.exists(lib_path):
        if not os.path.exists(src):
            return None
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                 "-o", lib_path, src],
                check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    lib.jsonl_count.restype = ctypes.c_int64
    lib.jsonl_count.argtypes = [ctypes.c_char_p]
    lib.jsonl_index.restype = ctypes.c_int64
    lib.jsonl_index.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            _LIB = _build_library()
            _LIB_FAILED = _LIB is None
    return _LIB


def _python_index(path: str) -> ManifestIndex:
    offsets, lengths, durations, text_lens = [], [], [], []
    pos = 0
    with open(path, "rb") as f:
        for raw in f:
            stripped = raw.strip()
            if stripped:
                offsets.append(pos)
                lengths.append(len(raw.rstrip(b"\n")))
                try:
                    rec = json.loads(stripped)
                    durations.append(float(rec.get("duration", -1.0)))
                    text_lens.append(len(rec["text"]) if "text" in rec else -1)
                except (json.JSONDecodeError, TypeError, ValueError):
                    durations.append(-1.0)
                    text_lens.append(-1)
            pos += len(raw)
    return ManifestIndex(
        np.asarray(offsets, np.int64), np.asarray(lengths, np.int64),
        np.asarray(durations, np.float64), np.asarray(text_lens, np.int64))


def index_manifest(path: str, prefer_native: bool = True) -> ManifestIndex:
    """Byte-offset index of a jsonl manifest with pre-extracted filter
    fields.  Native C++ scan when available, Python fallback otherwise."""
    lib = _get_lib() if prefer_native else None
    if lib is None:
        return _python_index(path)
    n = lib.jsonl_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    if n == 0:
        z = np.zeros(0, np.int64)
        return ManifestIndex(z, z.copy(), np.zeros(0, np.float64), z.copy())
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int64)
    durations = np.zeros(n, np.float64)
    text_lens = np.zeros(n, np.int64)
    got = lib.jsonl_index(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        durations.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        text_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n)
    if got < 0:
        return _python_index(path)
    return ManifestIndex(offsets[:got], lengths[:got], durations[:got],
                         text_lens[:got])


def read_record(path: str, offset: int, length: int) -> dict:
    """Load one record by byte offset (lazy __getitem__ path,
    data_utils.py:278-312)."""
    with open(path, "rb") as f:
        f.seek(offset)
        return json.loads(f.read(length))
