"""Tracing and profiling helpers (counterpart of indextts_tpu/utils/profiling.py).

Wall-clock phase timers with RTF accounting (reference infer.py:639-641,
764-766), device traces through `torch.profiler` written as Chrome traces
(open them in Perfetto or chrome://tracing), and named ranges that show in
those traces and, on the card, as NVTX ranges.  Tracing is on when a
directory is given or `INDEXTTS_TRACE_DIR` is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch


@dataclass
class PhaseTimer:
    """Accumulating named phase timer; RTF = total / audio seconds."""

    phases: Dict[str, float] = field(default_factory=dict)
    _start: Dict[str, float] = field(default_factory=dict)
    wall_start: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return time.perf_counter() - self.wall_start

    def rtf(self, audio_seconds: float) -> float:
        return self.total() / max(audio_seconds, 1e-9)

    def report(self, audio_seconds: Optional[float] = None) -> str:
        parts = [f"total {self.total():.2f}s"]
        if audio_seconds:
            parts.append(f"RTF {self.rtf(audio_seconds):.4f}")
        parts += [f"{k} {v:.2f}s" for k, v in self.phases.items()]
        return "  ".join(parts)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Trace the host and, when a GPU is present, the card over the block, and
    write it as `trace_<pid>_<ns>.json` (Chrome trace format) into
    `log_dir` or `INDEXTTS_TRACE_DIR`.  Yields the profiler (its
    `key_averages()` sums device time by kernel; after the block its
    `trace_path` names the file), or None when tracing is off."""
    log_dir = log_dir or os.environ.get("INDEXTTS_TRACE_DIR")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in a `device_trace` (`record_function`), and an NVTX
    range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
