"""Profiling: a device trace, its per-op summary, and a step-time meter.

Counterpart of the JAX package's ``utils/profiling.py``, on
``torch.profiler``.  ``trace(log_dir)`` records the host ops and, where
CUDA is available, the card's kernels, and writes a Chrome trace
(Perfetto / ``chrome://tracing``) under ``log_dir``; ``summarize_trace``
sums the newest trace's device time by op name.  ``chip_smoke.py`` keeps its
own timing of single kernels (``device_ms``), which retries windows in
which the profiler dropped the kernel's records.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import Counter
from typing import Optional

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"
# Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): run_steps()``.  Yields
    the ``torch.profiler.profile``; the trace file is written on exit."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}{TRACE_SUFFIX}"))


def summarize_trace(log_dir: str, top: int = 25, long_names: bool = False,
                    host_fallback: bool = True) -> list[tuple[str, float, int]]:
    """(op name, total µs, count) of the newest trace under ``log_dir``, the
    largest first.  The ops are the device's: the card's kernels, copies
    and sets where the trace holds any, else (a trace taken on the CPU) the
    host's operators, unless ``host_fallback`` is off.  With ``long_names``
    a kernel's name is followed by the operator that launched it
    (``name :: aten::mm``), which attributes anonymous kernels to the
    model's ops."""
    files = sorted(glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}")))
    if not files:
        return []
    with gzip.open(files[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    rows = device or ([e for e in events if e.get("cat") == "cpu_op"] if host_fallback else [])
    launcher = {}
    if long_names and device:
        # a kernel and the host operator that launched it share an External id
        for e in events:
            if e.get("cat") == "cpu_op":
                ext = (e.get("args") or {}).get("External id")
                if ext is not None:
                    launcher.setdefault(ext, e["name"])
    tot: Counter = Counter()
    cnt: Counter = Counter()
    for e in rows:
        name = e["name"]
        op = launcher.get((e.get("args") or {}).get("External id"))
        if op and op != name:
            name = f"{name} :: {op}"
        tot[name] += float(e["dur"])
        cnt[name] += 1
    return [(name, float(d), cnt[name]) for name, d in tot.most_common(top)]


class StepTimer:
    """Blocking step-time meter with warm-up discard: ``with timer:`` around
    a step; the card is synchronised at both ends where it is in use."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")
