"""Profiling: the program's spans and counters, a device trace, its per-op
summary, and a step-time meter.

Counterpart of the JAX package's ``utils/profiling.py``, on
``torch.profiler``.  ``trace(log_dir)`` records the host ops and, where
CUDA is available, the card's kernels, and writes a Chrome trace
(Perfetto / ``chrome://tracing``) under ``log_dir``, with the program's
spans on a track of their own; ``summarize_trace`` sums the newest trace's
device time by op name.  ``chip_smoke.py`` keeps its own timing of single
kernels (``device_ms``), which retries windows in which the profiler
dropped the kernel's records.

Spans.  The port's layers open ``span(name)`` around their work (the
names, ``pdr.<layer>.<part>``, are listed in ``PERF.md``).  A span records
only while a ``torch.profiler`` profile records (``trace`` here, or a
benchmark's traced span): then it keeps its name, its start and end on the
host clock kineto stamps its records with (``time.time_ns``), its parent
span and its unit, the sampler call or training step it ran for
(``unit()``).  Otherwise it costs a test of two flags and records nothing.
Spans are not ``record_function`` ranges: the profiler copies those onto
the device timeline as annotations, where they would read as device work.
A span opened inside a span of the same name is folded into it, so the
records of a name are its outermost instances.

Device marks.  ``span(name, device=True)`` also times the device work
enqueued inside it, by timing CUDA events on the current stream at its
start and its end.  Inside a capture of ``utils/graphs.py::CapturedFunction``
the events become event-record nodes of the graph, whatever the tracing,
so every replay times the span; the graph keeps them (``Marks``).  Two
marks with nothing enqueued between them (a span's end and the next
span's start, say) are one node: the capture's frontier, the nodes the
next one will depend on, tells (``_frontier``).  Work between two spans
is timed by neither: it is the parent's own time.  A graph's newest
replay made while tracing is read when the graph is released or the
records are taken (the next replay would overwrite it, and reading it
before that replay keeps the card waiting); it becomes one record for
each of its marks, with no host times, under the host span that was open
at the replay.  Eager pairs are recorded only while tracing, and read
with the records.

Counters (``counters()``) are always on, plain adds: the hand-written
kernels' launches (``launches.<kernel>``, kept by ``ops/kernels.py``) and
the seconds spent capturing graphs (``graphs.capture_s``).
``report()`` sums the records by name and lists the counters.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import gzip
import json
import os
import time
from collections import Counter
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

TRACE_SUFFIX = ".pt.trace.json.gz"
# Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the Chrome trace's process that holds the program's spans
SPAN_TRACK = "program spans"

COUNTERS: Dict[str, float] = {"graphs.capture_s": 0.0}


def counters() -> Dict[str, float]:
    return dict(COUNTERS)


class Record:
    """One span: host start and end in ns (None for a graph's mark), the
    index of its parent record (-1: none), its unit (-1: none) and its
    device seconds (None without marks, or before they are read)."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "device_s")

    def __init__(self, name, parent, unit, start_ns=None, end_ns=None, device_s=None):
        self.name, self.parent, self.unit = name, parent, unit
        self.start_ns, self.end_ns, self.device_s = start_ns, end_ns, device_s

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent}, unit={self.unit}, "
                f"host_ns={self.start_ns}..{self.end_ns}, device_s={self.device_s})")


class _Trace:
    """What the spans recorded since the last ``reset()``."""

    def __init__(self):
        self.records: List[Record] = []
        self.stack: List[int] = []  # indices of the open records, innermost last
        self.unit = -1
        self.units = 0
        self.eager: list = []  # (record, start event, end event) not yet read
        self.replayed: Dict[int, "Marks"] = {}  # by id: graphs with a reading pending


_TRACE = _Trace()
# the Marks of the capture under way, or None
_CAPTURE = None


def tracing() -> bool:
    """True while a ``torch.profiler`` profile records."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span of a program that is not traced: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@functools.lru_cache(maxsize=None)
def _capture_info():
    """The driver's ``cuStreamGetCaptureInfo_v2``, or None where the driver
    library lacks it."""
    try:
        fn = ctypes.CDLL("libcuda.so.1").cuStreamGetCaptureInfo_v2
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)),
                   ctypes.POINTER(ctypes.c_size_t)]
    return fn


def _frontier() -> Optional[tuple]:
    """The nodes the current stream's capture will make its next node
    depend on (None where the driver cannot tell)."""
    fn = _capture_info()
    if fn is None:
        return None
    status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
    rc = fn(torch.cuda.current_stream().cuda_stream, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n))
    return tuple(deps[i] for i in range(n.value)) if rc == 0 else None


class Marks:
    """The device spans captured into one CUDA graph, in the order they
    opened: [name, parent index (-1: none), start event, end event].  The
    events live as long as the graph: replaying an event-record node whose
    event was destroyed is undefined."""

    def __init__(self):
        self.entries: list = []
        self.stack: List[int] = []
        self.last = None  # (the event recorded last, the capture's frontier after it)
        self.pending = None  # (trace, unit, parent) of a replay made while tracing

    def _here(self):
        """An event at the capture's current point: the last one recorded
        if nothing was enqueued after it, else a new one."""
        if self.last is not None and self.last[1] is not None and _frontier() == self.last[1]:
            return self.last[0]
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.last = (ev, _frontier())
        return ev

    def open(self, name: str) -> Optional[int]:
        parent = self.stack[-1] if self.stack else -1
        if parent >= 0 and self.entries[parent][0] == name:
            return None
        self.entries.append([name, parent, self._here(), None])
        self.stack.append(len(self.entries) - 1)
        return self.stack[-1]

    def close(self, i: int) -> None:
        self.stack.pop()
        self.entries[i][3] = self._here()

    def read(self) -> None:
        """The pending replay's marks into its trace's records, once the
        device has passed them."""
        if self.pending is None:
            return
        trace, unit, parent = self.pending
        self.pending = None
        self.last[0].synchronize()
        base = len(trace.records)
        for name, p, start, end in self.entries:
            trace.records.append(Record(name, base + p if p >= 0 else parent, unit,
                                        device_s=start.elapsed_time(end) / 1e3))


class _Span:
    __slots__ = ("name", "device", "index", "mark", "events")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.index = self.mark = self.events = None

    def __enter__(self):
        if _CAPTURE is not None:
            if self.device:
                self.mark = _CAPTURE.open(self.name)
            return None
        if not tracing():
            return None
        tr = _TRACE
        parent = tr.stack[-1] if tr.stack else -1
        if parent >= 0 and tr.records[parent].name == self.name:
            return None
        self.index = len(tr.records)
        tr.records.append(Record(self.name, parent, tr.unit, time.time_ns()))
        tr.stack.append(self.index)
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.events[0].record()
        return None

    def __exit__(self, *exc):
        if self.mark is not None:
            _CAPTURE.close(self.mark)
        elif self.index is not None:
            tr = _TRACE
            rec = tr.records[self.index]
            rec.end_ns = time.time_ns()
            tr.stack.pop()
            if self.events is not None:
                self.events[1].record()
                tr.eager.append((rec, *self.events))
        return False


def span(name: str, device: bool = False):
    """``with span("pdr.net.group", device=True):`` around a layer's work."""
    if _CAPTURE is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spanned(name: str, device: bool = False):
    """A decorator: the function's every call inside ``span(name, device)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _CAPTURE is None and not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, device):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Unit:
    __slots__ = ("outer",)

    def __enter__(self):
        tr = _TRACE
        self.outer = tr.unit
        if tr.unit < 0:
            tr.unit = tr.units
            tr.units += 1
        return None

    def __exit__(self, *exc):
        _TRACE.unit = self.outer
        return False


def unit():
    """``with unit():`` around one sampler call or training step: the spans
    inside carry its id."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Unit()


@contextlib.contextmanager
def capturing():
    """Around a capture: the device spans opened inside become marks of the
    graph (the ``Marks`` this yields)."""
    global _CAPTURE
    marks = _CAPTURE = Marks()
    try:
        yield marks
    finally:
        _CAPTURE = None


def replayed(marks: Marks) -> None:
    """At a replay of the graph of ``marks``: while tracing, this replay's
    reading is the pending one (an earlier one is dropped unread)."""
    if marks.entries and tracing():
        tr = _TRACE
        marks.pending = (tr, tr.unit, tr.stack[-1] if tr.stack else -1)
        tr.replayed[id(marks)] = marks


def _read() -> None:
    tr = _TRACE
    for rec, start, end in tr.eager:
        end.synchronize()
        rec.device_s = start.elapsed_time(end) / 1e3
    tr.eager = []
    for marks in tr.replayed.values():
        if marks.pending is not None and marks.pending[0] is tr:
            marks.read()
    tr.replayed = {}


def records() -> List[Record]:
    """Every record since the last ``reset()``, in the order the spans
    opened (a parent before its children), with every mark read."""
    _read()
    return list(_TRACE.records)


def report() -> dict:
    """{"spans": {name: {"count", "units", "host_s", "device_s"}},
    "counters": counters()}: a name's records, the units they ran for,
    their host seconds and their device seconds (None where none has
    marks)."""
    spans: Dict[str, dict] = {}
    units: Dict[str, set] = {}
    for r in records():
        s = spans.setdefault(r.name, {"count": 0, "units": 0, "host_s": 0.0, "device_s": None})
        s["count"] += 1
        if r.unit >= 0:
            units.setdefault(r.name, set()).add(r.unit)
        if r.end_ns is not None:
            s["host_s"] += (r.end_ns - r.start_ns) / 1e9
        if r.device_s is not None:
            s["device_s"] = (s["device_s"] or 0.0) + r.device_s
    for name, u in units.items():
        spans[name]["units"] = len(u)
    return {"spans": spans, "counters": counters()}


def reset() -> None:
    """Forget the records (the counters stay)."""
    global _TRACE
    _TRACE = _Trace()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): run_steps()``.  Yields
    the ``torch.profiler.profile``; the trace file is written on exit, with
    the spans recorded inside on the track ``SPAN_TRACK``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    reset()
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    _add_spans(path, records())


def _add_spans(path: str, recs: List[Record]) -> None:
    """Append the records' host spans to the Chrome trace at ``path``, on
    the clock of its events (µs after ``baseTimeNanoseconds``)."""
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_TRACK, "tid": 0,
                   "args": {"name": SPAN_TRACK}})
    for r in recs:
        if r.end_ns is None:
            continue
        args = {"unit": r.unit, "parent": recs[r.parent].name if r.parent >= 0 else None}
        if r.device_s is not None:
            args["device_ms"] = r.device_s * 1e3
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": SPAN_TRACK,
                       "tid": 0, "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)


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
