"""The arithmetic of the metrics that read the program's own spans and
counters (``point_diffusion_refinement_tpu_torch/utils/profiling.py``).

The program records spans only while a profile records, so in a run these
are the traced span's: the host spans on the clock of the profiler's
records, and the device marks, each a pair of timing events around a
span's device work (inside a replayed CUDA graph, one reading a replay
that the program read).  A program without them (an earlier commit) gives
nothing to read: every reader then returns None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _profiling():
    from point_diffusion_refinement_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "records") else None


def records(ctx) -> Optional[list]:
    """The traced span's records, read once a run (after the program has
    released its graphs, so every pending reading is in)."""
    if "program_records" not in ctx:
        prof = _profiling()
        ctx["program_records"] = (prof.records() if prof is not None
                                  and ctx.get("trace") is not None else None)
    return ctx["program_records"]


def _inside(recs: list, r, name: str) -> bool:
    p = r.parent
    while p >= 0:
        if recs[p].name == name:
            return True
        p = recs[p].parent
    return False


def device_ms_each(ctx, kind: str, name: str, within: str) -> Optional[float]:
    """Device ms of the ``name`` spans inside one ``within`` span (a reverse
    step's denoise, a training step's forward), the mean over the
    ``within`` spans with device marks."""
    recs = records(ctx) if ctx["kind"] == kind else None
    if not recs:
        return None
    n = sum(1 for r in recs if r.name == within and r.device_s is not None)
    hits = [r.device_s for r in recs
            if r.name == name and r.device_s is not None and _inside(recs, r, within)]
    return 1e3 * sum(hits) / n if n and hits else None


def device_ms(ctx, kind: str, name: str) -> Optional[float]:
    """Device ms of one ``name`` span, the mean over its marked instances."""
    recs = records(ctx) if ctx["kind"] == kind else None
    hits = [r.device_s for r in recs or () if r.name == name and r.device_s is not None]
    return 1e3 * sum(hits) / len(hits) if hits else None


def host_ms(ctx, kind: str, name: str) -> Optional[float]:
    """Host ms of one ``name`` span, the mean over its instances."""
    recs = records(ctx) if ctx["kind"] == kind else None
    hits = [r.end_ns - r.start_ns for r in recs or () if r.name == name and r.end_ns]
    return sum(hits) / len(hits) / 1e6 if hits else None


def _idle(tr) -> List[Tuple[int, int]]:
    """The device's idle intervals inside the traced span."""
    gaps, t = [], tr.start
    for a, b in tr.busy_intervals():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tr.end > t:
        gaps.append((t, tr.end))
    return gaps


def idle_ns_inside(ctx, names: Sequence[str]) -> Optional[Tuple[int, int]]:
    """(device idle ns while the host was inside a span of ``names``, the
    number of those spans), on the clock the profiler and the host spans
    share."""
    recs, tr = records(ctx), ctx.get("trace")
    if not recs or tr is None:
        return None
    spans = sorted((r.start_ns, r.end_ns) for r in recs if r.name in names and r.end_ns)
    total, i, gaps = 0, 0, _idle(tr)
    for a, b in spans:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += max(0, min(b, gaps[j][1]) - max(a, gaps[j][0]))
            j += 1
    return total, len(spans)


def idle_ms_each(ctx, kind: str, name: str) -> Optional[float]:
    """Device idle ms while the host was inside a ``name`` span, a span."""
    got = idle_ns_inside(ctx, (name,)) if ctx["kind"] == kind else None
    return got[0] / got[1] / 1e6 if got and got[1] else None


def counter(name: str) -> Optional[float]:
    prof = _profiling()
    return prof.counters().get(name) if prof is not None else None
