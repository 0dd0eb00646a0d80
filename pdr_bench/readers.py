"""The arithmetic of the metrics, shared by the metric files in
``metrics/``.  Each reader takes the run's context (see ``run.py``) and
returns a number, or None where the run has nothing for it to read."""

from __future__ import annotations

from typing import Optional, Sequence

from . import work


def rate(ctx, kind: str) -> Optional[float]:
    """Units completed in the window over the window's seconds."""
    if ctx["kind"] != kind:
        return None
    w = ctx["window"]
    return w["units"] / w["seconds"]


def mfu(ctx, kind: str) -> Optional[float]:
    """Model FLOPs (counted on the reference) of the window's units over the
    window's seconds, as a share of the bf16 peak, in %."""
    r = rate(ctx, kind)
    flops = (ctx.get("work") or {}).get("flops_per_unit")
    if r is None or not flops:
        return None
    return 100.0 * flops * r / work.BF16_OPS_PER_S


def idle_share(ctx, kind: str) -> Optional[float]:
    tr = ctx.get("trace")
    if ctx["kind"] != kind or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(ctx, kind: str, functions: Optional[Sequence[str]] = None) -> Optional[float]:
    """The least time the counted work of the traced span's units could take
    over the device time of the kernels that did it, in %: the functions
    named, or all the hand-written ones."""
    tr, wk = ctx.get("trace"), ctx.get("work")
    if ctx["kind"] != kind or tr is None or not wk:
        return None
    fns = set(functions) if functions else set(work.KERNELS)
    bound = sum(s for fn, s in wk["tally_per_unit"].seconds.items() if fn in fns)
    bound *= ctx["span"]["units"]
    device, hits = tr.device_seconds(lambda name: work.kernel_of(name) in fns)
    if hits == 0 or device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device


def eltwise_reduce_ms(ctx, kind: str) -> Optional[float]:
    """Device ms a step of PyTorch's own elementwise and reduction kernels."""
    tr = ctx.get("trace")
    if ctx["kind"] != kind or tr is None:
        return None
    s, hits = tr.device_seconds(lambda name: "elementwise_kernel" in name
                                or "reduce_kernel" in name)
    return 1e3 * s / ctx["span"]["steps"] if hits else None


def batch_ms(ctx, kind: str) -> Optional[float]:
    w = ctx["window"]
    if ctx["kind"] != kind or "batch_s" not in w:
        return None
    return 1e3 * w["batch_s"] / w["steps"]
