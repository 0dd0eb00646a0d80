"""The readings that the correctness limits are set from, on the chip.

    python3 -m pdr_bench.control --workload <name> --seeds <n> [<n> ...] \
        [--controls K] [--seconds S] [--out FILE]

For each seed: one run of the cell's set-up and a short window, then the
numbers the check compares, read three ways against the float32
reference:

- ``program``: the program's outputs (a sound run);
- ``control_fp8`` (the first K seeds): the reference itself in the
  precision below the configuration's (fp8 where it computes in bf16),
  put in the program's place;
- ``witness_bf16`` (training, the first K seeds): the program against the
  reference in the configuration's own precision;
- faults planted in the reference put in the program's place (the first K
  seeds): for training, half of each batch left out (the mean over the
  rest), in every step or only from the second on (the steps the program
  replays), and the state left unchanged, and batches fed without their
  augmentation; for generation, each cloud's answer altered where it is
  produced (its points shifted by one place).

One JSON line a seed goes to ``--out`` and to standard output.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from .run import ROOT, set_cache_dirs


def altered(x0):
    """Each cloud's points shifted by one place (a gather off by one)."""
    return x0.roll(1, dims=1)


def readings(cell, controls: bool) -> dict:
    """The program's numbers and, with ``controls``, the control's and the
    faults', for a cell whose window has run and whose program is
    released."""
    if cell.kind == "gen":
        from pdr_bench.traffic.gen_fastdpm import compare_clouds

        cond, label, x_T, noise, got = cell.reference_inputs()
        want = cell.reference_x0("float32", cond, label, x_T, noise)
        out = {"program": compare_clouds(got, want)}
        if controls:
            out["control_fp8"] = compare_clouds(
                cell.reference_x0("fp8", cond, label, x_T, noise), want)
            out["fault_altered_answer"] = compare_clouds(altered(want), want)
        return out
    from pdr_bench.traffic.train_step import compare_training

    from pdr_bench.traffic.train_step import batch_gap

    r32 = cell.reference_steps("float32")
    program = cell.program_readings()
    out = {"program": {**compare_training(program, r32, cell.initial),
                       "batch_max_gap": batch_gap(cell.recorded, cell.rebuilt)},
           "worst_grad_leaves": worst_leaves(program[1][-1], r32[1][-1])}
    if controls:
        # the reference's own batches: a gap of 0 but where a fault alters them
        def fed(readings, batches=0.0):
            return {**readings, "batch_max_gap": batches}

        out["control_fp8"] = fed(compare_training(cell.reference_steps("fp8"), r32,
                                                  cell.initial))
        # the second witness: the reference in the configuration's own
        # precision against the program
        out["witness_bf16"] = fed(compare_training(program, cell.reference_steps("bfloat16"),
                                                   cell.initial))
        for fault in ("half_batch", "half_batch_replays"):
            out["fault_" + fault] = fed(compare_training(
                cell.reference_steps("float32", fault=fault), r32, cell.initial))
        out["fault_state_unchanged"] = fed(compare_training(
            (r32[0], r32[1], cell.initial), r32, cell.initial))
        plain = cell.reference_batches({})
        out["fault_batch_unaugmented"] = fed(compare_training(
            cell.reference_steps("float32", batches=plain), r32, cell.initial),
            batch_gap(plain, cell.rebuilt))
    return out


def worst_leaves(got: dict, want: dict, n: int = 6) -> list:
    """The leaves of the largest gaps of gradient norms, with the program's
    and the reference's norms and the median leaf's."""
    from pdr_bench.traffic.train_step import _leaf_norms, norm_gaps

    gaps, g, w = norm_gaps(got, want), _leaf_norms(got), _leaf_norms(want)
    median = sorted(w.values())[len(w) // 2]
    return [[k, gaps[k], g[k], w[k], median]
            for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    set_cache_dirs(ROOT)
    import torch

    from .registry import Registry

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT / "BENCHMARK.json")
    wl = registry.workload(args.workload)
    config, traffic = registry.config(wl["config"]), registry.traffic(wl["traffic"])
    driver = registry.driver(traffic["kind"])
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        cell = driver.Cell(config, traffic, seed, "cuda")
        cell.setup()
        setup_s = time.perf_counter() - t
        window = cell.window(args.seconds)
        peak = torch.cuda.max_memory_allocated()
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "setup_s": setup_s,
               "window": window, "memory_peak_bytes": peak,
               **readings(cell, i < args.controls)}
        row["reference_s"] = time.perf_counter() - t
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
