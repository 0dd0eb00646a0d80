"""The benchmark of the PyTorch port on one H100.

    python3 -m pdr_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One cell of ``BENCHMARK.json``: its
configuration and traffic mix are found by name (``registry.py``), its
driver (``traffic/<kind>.py``) builds the port's entry point with seeded
weights and inputs, warms up every shape and captures the graphs (set-up),
then the window runs whole units (a batch of clouds, a training step) until
``--seconds`` have passed.  With ``--trace 1`` a bounded span after the
window runs under the profiler, and the reference counts the work of a
unit, for the per-layer metrics.  After the window the program's state is
freed and the plain float32 reference (``reference/``) recomputes a sample
of what the window produced; each number compared is printed beside its
limit (``limits/<workload>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Without enough CUDA devices the run
exits with 2 and prints no result; if JAX or the JAX package was loaded,
with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that must not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "point_diffusion_refinement_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout (the
    port's own kernels build into ``build/kernels`` there by themselves)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "cuda_cache")


def run_cell(registry, workload: str, seed: int, seconds: float, traced: bool, device,
             t0: float = T0) -> dict:
    """One run of ``workload``; returns the result object."""
    import torch

    from . import trace as trace_mod

    wl = registry.workload(workload)
    config = registry.config(wl["config"])
    traffic = registry.traffic(wl["traffic"])
    cell = registry.driver(traffic["kind"]).Cell(config, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"

    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    ctx = {"kind": cell.kind, "capture_s": cell.capture_s,
           "setup_s": time.perf_counter() - t0}
    ctx["window"] = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced and cuda:
        span, tr = trace_mod.record(cell.traced_span)
        ctx["trace"], ctx["span"] = tr, span
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = cell.check()
    if traced:
        ctx["work"] = cell.count_work()
    # the numbers the cell's limits name are compared; the others are
    # readings, printed for the record
    limits = registry.limits(workload)
    compared = {name: {"value": checks[name], "limit": limit}
                for name, limit in limits.items() if name in checks}
    correct = (len(compared) == len(limits) > 0 and ctx["window"]["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in compared.values()))
    for name, value in checks.items():
        if name not in limits:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)

    metrics = {}
    for entry, reader in registry.metrics(workload, traced):
        value = reader.read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {"correct": correct, "attempted": ctx["window"]["attempted"],
              "failed": ctx["window"]["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs(ROOT)
    from .registry import Registry

    registry = Registry(ROOT / "BENCHMARK.json")
    chips = int(registry.workload(args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
