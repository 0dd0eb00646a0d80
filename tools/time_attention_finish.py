"""Device and host times of the fused attention pool (``csrc/attention_pool.cu``)
at the 17 attention sites of one denoise step, with its finishing work split
out, for one checkout of the port.

Run it once on each of two checkouts on one card to compare them, in turns
(A, B, B, A), with ``--repo`` the checkout whose
``point_diffusion_refinement_tpu_torch`` is imported (the helpers come from
this repository's ``chip_smoke.py``)::

    python3 tools/time_attention_finish.py --repo path/to/checkout --tag parent

The model is ``DEFAULT_POINTNET_CONFIG`` in bf16 with seeded weights, at
B=4, 2048 points and a 3072 x 4 condition, as ``chip_smoke.py`` builds it;
the sites are the pools one denoise step with ``fused_attention`` and
``fused_knn`` on calls, on the tensors that step gives them.  Each site
prints the profiler's device ms a pool call of the three sweeps and of the
finishing launches (``chip_smoke.SWEEP_KERNELS``: the query-row pass, or F0
and F1 of the first design) with their launches, the row tiles and rows of
partial sums of sweeps 1 and 2, the pool's device ms (every
kernel of a call) and host ms (CUDA events over back-to-back calls), and
the kernel nodes of a CUDA graph of one call.  Then the sums over the step,
FT0's pool (``dec_map_0``), and one whole denoise step with the variants on,
eager and replayed from a captured graph (``utils/graphs.CapturedFunction``),
host ms a step over STEP_REPS steps, the replay checked against the eager
step.  The last line is one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 10  # pool calls a profiler window
REPS = 20  # pool calls a CUDA-event timing
STEP_REPS = 20  # denoise steps a host-clock timing


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--tag", default="this")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_attention_finish: no CUDA device available", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    # the first design's finishing kernels (F0, F1), so a tree of it is timed too
    cs.SWEEP_KERNELS["attention_finish"] += ("attn_finish_stats", "attn_finish_h")
    import point_diffusion_refinement_tpu_torch as port
    from point_diffusion_refinement_tpu_torch.config import DEFAULT_POINTNET_CONFIG
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.models.attention import AttentionPool
    from point_diffusion_refinement_tpu_torch.ops import attention_pool as ap
    from point_diffusion_refinement_tpu_torch.ops import kernels
    from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{args.tag}] port from {os.path.dirname(port.__file__)}; card {card.strip()}",
          flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"[{args.tag}] build: {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    cfg = dict(DEFAULT_POINTNET_CONFIG)
    cfg["compute_dtype"] = "bfloat16"
    model = PointNet2CloudCondition.from_config(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    B = 4
    cond = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, 3072, 3)),
         rng.integers(0, 2, (B, 3072, 1)) * 2.0 - 1.0], axis=-1).astype(np.float32)).to(dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(B, 2048, 3, generator=gen, device=dev)
    ts = torch.full((B,), 5.0, device=dev)
    on = dict(fused_attention=True, fused_knn=True)
    with torch.no_grad():
        cf = model.encode_condition(cond)

    def denoise(x_, ts_):
        return model.denoise(x_, ts_, label, cf, fused=True, **on)

    calls = cs.capture_calls(model, (AttentionPool,), lambda: denoise(x, ts))
    sites = [(c[0].rsplit(".", 1)[0], *c[1:]) for c in calls]
    kinds = list(cs.SWEEP_KERNELS)
    totals = {k: [0.0, 0.0] for k in kinds}
    pool_device = pool_host = 0.0
    per_site = {}
    for name, pool, (feat, grouped, gfo, counts), _ in sites:
        def run():
            return pool(feat, grouped, gfo, counts, fused=True)

        with torch.no_grad():
            events, launches = cs.trace_device_events(run, CALLS)
            host_ms = cs.time_ms(run, REPS)
            nodes = cs.graph_launches(run)
        split = cs.sweep_split(events, CALLS)
        device_ms = sum(us / 1e3 * -(-n // CALLS) for n, us, _ in events.values())
        for k in kinds:
            totals[k][0] += split[k][0]
            totals[k][1] += split[k][1]
        pool_device += device_ms
        pool_host += host_ms
        _, M, K, Ck = grouped.shape
        w = pool.widths
        key = (grouped.shape[0], M, K, Ck, gfo.shape[-1], w["c2"], w["inter_c"], w["c_out"])
        rows = ap.sweep_row_blocks(*key)
        if hasattr(ap, "sweep_partial_rows"):  # one row of partial sums a cluster
            rows.update({f"{k} partial rows": v for k, v in ap.sweep_partial_rows(*key).items()})
        per_site[name] = dict(row_blocks=rows, M=M, K=K, Ck=Ck,
                              **{k: split[k][0] for k in kinds},
                              launches=launches, graph=nodes, device_ms=device_ms,
                              host_ms=host_ms)
        print(f"[{args.tag}] site {name:<10} ({M}, {K}, {Ck}) "
              + " ".join(f"{k.split('_', 1)[1]}={split[k][0]:.4f}" for k in kinds)
              + f" launches a call={launches} graph={nodes} row blocks={rows}"
              f" pool device_ms={device_ms:.4f}"
              f" host_ms={host_ms:.4f}", flush=True)
    print(f"[{args.tag}] a denoise step ({len(sites)} pools): "
          + " ".join(f"{k.split('_', 1)[1]}: ms={v[0]:.4f} launches={v[1]:g};"
                     for k, v in totals.items())
          + f" pools device_ms={pool_device:.4f} host_ms={pool_host:.4f}", flush=True)

    graphed = CapturedFunction(denoise)
    with torch.no_grad():
        eager = denoise(x, ts)
        graphed(x, ts)  # warm-up
        replay = graphed(x, ts)  # capture and replay
        torch.cuda.synchronize()
        diff = float((replay.float() - eager.float()).abs().max())
        step_ms = {}
        for kind, fn in (("eager", lambda: denoise(x, ts)), ("graphed", lambda: graphed(x, ts)),
                         ("graphed again", lambda: graphed(x, ts)),
                         ("eager again", lambda: denoise(x, ts))):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(STEP_REPS):
                fn()
            torch.cuda.synchronize()
            step_ms[kind] = (time.perf_counter() - t1) * 1e3 / STEP_REPS
    graphed.release()
    print(f"[{args.tag}] denoise step B=4 with the variants on, host ms a step: "
          + " ".join(f"{k}={v:.3f}" for k, v in step_ms.items())
          + f"; graphed vs eager max abs diff={diff:.3g}", flush=True)
    print(json.dumps({"tag": args.tag, "card": card.strip(), "step_totals": totals,
                      "pools_device_ms": pool_device, "pools_host_ms": pool_host,
                      "ft0": per_site.get("dec_map_0"), "step_ms": step_ms,
                      "graphed_vs_eager": diff, "sites": per_site}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
