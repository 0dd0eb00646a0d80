"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (``point_diffusion_refinement_tpu_torch/
   csrc/*.cu``, one ``nvcc`` per source, all in parallel) and prints the
   build time.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path: indices and counts must be equal, other outputs
   within the stated tolerance.  Prints each kernel's time, the plain
   version's time, the time of one PyTorch library call that computes the
   same function where there is one, and the least time the card could take
   (``bound_ms``: the larger of bytes over 3.35 TB/s and float32 operations
   over 67 TFLOP/s, counted for this run's data).
3. Builds ``DEFAULT_POINTNET_CONFIG`` in bfloat16 with seeded random weights
   and runs ``make_coarse_sampler`` end to end at B=4, 2048 points, a
   3072 x 4 condition, over a schedule of STEPS steps, with every launch count
   reset just before and read just after; fails if a kernel of the path was
   never launched or the output is not a finite (4, 2048, 3) cloud.
4. Runs one denoise step through the kernels and through the plain versions
   on the card and checks their relative difference.
5. Traces three denoise steps with ``torch.profiler`` and prints the
   device-busy share of the window and the ops that take the most device
   time.
6. Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and convolutions throughout, so the float32 parts
of the model and of the plain versions run in full float32.  Exits non-zero
on any failure, without a result line; needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# position channels of the fused group are bf16 of float32 values computed
# the same way by both versions: they must agree exactly like the features
DENOISE_REL_TOL = 1e-2  # kernels vs plain versions, one bf16 denoise step
KNN_DIST_TOL = 0.0  # both compute the same separately rounded float32 sums
STEPS = 20  # reverse steps of the main-path run: enough for a steady step time

TPU_KERNELS = {
    "fps_coords": "point_diffusion_refinement_tpu/ops/pallas_fps.py:197",
    "ball_group": "point_diffusion_refinement_tpu/ops/pallas_window.py:853",
    "ball_query": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:88",
    "knn": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:169",
}
LAUNCH_NAMES = {"fps_coords": "fps", "ball_group": "ball_group",
                "ball_query": "ball_query", "knn": "knn"}
SOURCES = {
    "fps_coords": "point_diffusion_refinement_tpu_torch/csrc/fps.cu",
    "ball_group": "point_diffusion_refinement_tpu_torch/csrc/ball_group.cu",
    "ball_query": "point_diffusion_refinement_tpu_torch/csrc/ball_query.cu",
    "knn": "point_diffusion_refinement_tpu_torch/csrc/knn.cu",
}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scanned_pairs(idx: torch.Tensor, counts: torch.Tensor, n: int) -> float:
    """(centre, point) pairs a first-K-in-index-order scan visits: up to the
    K-th hit for a full ball, the whole support otherwise."""
    K = idx.shape[-1]
    last = idx[..., K - 1].to(torch.float64) + 1.0
    full = counts >= K
    return float(torch.where(full, last, torch.full_like(last, float(n))).sum())


def check_kernels(dev, rng):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    from point_diffusion_refinement_tpu_torch.ops import ball_group, ball_group_plain
    from point_diffusion_refinement_tpu_torch.ops import neighbors, sampling

    B = 4
    x_t = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 3072, 3)).astype(np.float32)).to(dev)
    rows = []

    # -- FPS with coordinates: SA level 0 of x_t every step (2048 -> 1024) and
    #    of the condition once (3072 -> 1024)
    worst = 0.0
    for pts in (x_t, cond):
        idx, co = sampling.furthest_point_sample_and_gather(pts, 1024)
        ridx, rco = sampling.furthest_point_sample_and_gather_plain(pts, 1024)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            raise AssertionError(f"fps: indices differ at N={pts.shape[1]}")
        err = float((co - rco).abs().max())
        if err != 0.0:
            raise AssertionError(f"fps: coordinates differ by {err}")
        worst = max(worst, err)
    pts = x_t
    ms = time_ms(lambda: sampling.furthest_point_sample_and_gather(pts, 1024), 10)
    plain_ms = time_ms(lambda: sampling.furthest_point_sample_and_gather_plain(pts, 1024), 2, 1)
    N = pts.shape[1]
    b_ms, b_by = bound(nbytes(pts) + B * 1024 * 16, 10.0 * B * 1023 * N)
    rows.append(dict(name="fps_coords", shape="(4,2048,3)->1024", max_abs_err=worst,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))

    # -- fused ball group: the level-0 feature-transfer pair (two tables,
    #    queries = x_t, support = condition) and the x_t SA level-0 grouping
    _, sa_centres = sampling.furthest_point_sample_and_gather_plain(x_t, 1024)
    t_enc = torch.randn(B, 3072, 4, device=dev).to(torch.bfloat16)
    t_dec = torch.randn(B, 3072, 32, device=dev).to(torch.bfloat16)
    t_sa = torch.randn(B, 2048, 35, device=dev).to(torch.bfloat16)
    cases = [
        ("ft0", cond, [t_enc, t_dec], x_t, "center_zero"),
        ("sa0", x_t, [t_sa], sa_centres, "row0"),
    ]
    worst = 0.0
    for tag, sup, tabs, q, mode in cases:
        outs, cnt = ball_group(sup, tabs, q, 0.1, 32, include_center=True,
                                      empty_mode=mode)
        routs, rcnt = ball_group_plain(sup, tabs, q, 0.1, 32, include_center=True,
                                              empty_mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(cnt, rcnt):
            raise AssertionError(f"ball_group {tag}: counts differ")
        for o, r in zip(outs, routs):
            err = float((o.float() - r.float()).abs().max())
            if err != 0.0:
                raise AssertionError(f"ball_group {tag}: grouped values differ by {err}")
            worst = max(worst, err)
    sup, tabs, q, mode = cond, [t_enc, t_dec], x_t, "center_zero"
    ms = time_ms(lambda: ball_group(sup, tabs, q, 0.1, 32, True, mode), 20)
    plain_ms = time_ms(lambda: ball_group_plain(sup, tabs, q, 0.1, 32, True, mode), 5)
    ridx, rcnt = neighbors.ball_query_plain(sup, q, 0.1, 32)
    outs, _ = ball_group_plain(sup, tabs, q, 0.1, 32, True, mode)
    pairs = scanned_pairs(ridx, rcnt, sup.shape[1])
    b_ms, b_by = bound(nbytes(sup, q, *tabs, *outs, rcnt), 9.0 * pairs)
    rows.append(dict(name="ball_group", shape="FT0 sup (4,3072) q (4,2048) K=32 C=4+32",
                     max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))

    # -- ball query: condition SA level 0 (3072 support, 1024 centres) and the
    #    K > N case of the 16-point level (decoder FT 4: 16 support points)
    _, c_centres = sampling.furthest_point_sample_and_gather_plain(cond, 1024)
    small = c_centres[:, :16].contiguous()
    for sup, q, r in ((cond, c_centres, 0.1), (small, x_t, 1.6)):
        idx, cnt = neighbors.ball_query(sup, q, r, 32)
        ridx, rcnt = neighbors.ball_query_plain(sup, q, r, 32)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(cnt, rcnt)):
            raise AssertionError(f"ball_query: differs at N={sup.shape[1]}, M={q.shape[1]}")
    sup, q = cond, c_centres
    ms = time_ms(lambda: neighbors.ball_query(sup, q, 0.1, 32), 20)
    plain_ms = time_ms(lambda: neighbors.ball_query_plain(sup, q, 0.1, 32), 5)
    ridx, rcnt = neighbors.ball_query_plain(sup, q, 0.1, 32)
    b_ms, b_by = bound(nbytes(sup, q, ridx, rcnt), 9.0 * scanned_pairs(ridx, rcnt, sup.shape[1]))
    rows.append(dict(name="ball_query", shape="sup (4,3072) centres (4,1024) K=32",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))

    # -- kNN: the x_t feature propagation at level 0 (2048 queries, 1024 known)
    unknown, known = x_t, sa_centres
    d, i = neighbors.knn(unknown, known, 8)
    rd, ri = neighbors.knn_plain(unknown, known, 8)
    torch.cuda.synchronize()
    if not torch.equal(i, ri):
        raise AssertionError("knn: indices differ")
    err = float((d - rd).abs().max())
    if err > KNN_DIST_TOL:
        raise AssertionError(f"knn: distances differ by {err}")
    ms = time_ms(lambda: neighbors.knn(unknown, known, 8), 20)
    plain_ms = time_ms(lambda: neighbors.knn_plain(unknown, known, 8), 5)
    lib_ms = time_ms(
        lambda: torch.topk(torch.cdist(unknown, known), 8, dim=-1, largest=False), 20)
    M, N = unknown.shape[1], known.shape[1]
    b_ms, b_by = bound(nbytes(unknown, known, rd, ri), 10.0 * B * M * N)
    rows.append(dict(name="knn", shape="q (4,2048) pts (4,1024) k=8", max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms))
    for r in rows:
        print(f"kernel {r['name']:<11} {r['shape']:<42} max_abs_err={r['max_abs_err']:.3g} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms={r['library_ms']}", flush=True)
    return rows


def profile_denoise(model, x, ts, label, cf, steps: int = 3) -> None:
    """Phase 5: device time by op and the device-busy share of a window of
    ``steps`` denoise calls (one stream, so kernel times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.denoise(x, ts, label, cf, fused=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in avgs
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    table = avgs.table(sort_by="self_device_time_total", row_limit=25)
    busy = dev_us / 1e3 / wall_ms
    print(f"profile: {steps} denoise steps, wall_ms={wall_ms:.2f} (profiled) "
          f"device_ms={dev_us / 1e3:.2f} device_busy={busy:.3f}", flush=True)
    print(table, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import DEFAULT_POINTNET_CONFIG
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.ops import kernels
    from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + ", ".join(f"{k}={v:.1f}s" for k, v in took.items()), flush=True)

    # 2. kernels vs plain versions
    rng = np.random.default_rng(0)
    rows = check_kernels(dev, rng)

    # 3. the main path at full width
    cfg = dict(DEFAULT_POINTNET_CONFIG)
    cfg["compute_dtype"] = "bfloat16"
    model = PointNet2CloudCondition.from_config(cfg, device="cuda", seed=0)
    B = 4
    cond = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, 3072, 3)),
         rng.integers(0, 2, (B, 3072, 1)) * 2.0 - 1.0], axis=-1).astype(np.float32)).to(dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    T = STEPS
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.02)
    sampler = make_coarse_sampler(model, schedule, num_points=2048)
    gen = torch.Generator(device=dev)

    # warm-up (first-use allocations, cuBLAS handles), uncounted
    gen.manual_seed(1)
    with torch.no_grad():
        model.encode_condition(cond)
    short = make_coarse_sampler(model, calc_diffusion_hyperparams(2, 1e-4, 0.02), 2048)
    short(cond, label, generator=gen)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cf = model.encode_condition(cond)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    enc_counts = ops.launch_counts()

    gen.manual_seed(2)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(cond, label, generator=gen)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    step_ms = (total_ms - encode_ms) / T
    per_step = {k: (counts[k] - enc_counts[k]) / T for k in counts}
    print(f"main path: T={T} total_ms={total_ms:.1f} encode_ms={encode_ms:.2f} "
          f"step_ms={step_ms:.2f}", flush=True)
    print(f"launches: run={counts} encode={enc_counts} per_step={per_step}", flush=True)
    finite = bool(torch.isfinite(out).all())
    print(f"output: shape={tuple(out.shape)} finite={finite} "
          f"std={float(out.float().std()):.4f}", flush=True)
    if tuple(out.shape) != (B, 2048, 3) or not finite:
        raise AssertionError("main path output is not a finite (4, 2048, 3) cloud")
    for name, n in counts.items():
        if n <= 0 or per_step[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on every denoise step")

    # 4. one denoise step, kernels vs plain versions on the card
    x = torch.randn(B, 2048, 3, generator=gen, device=dev)
    ts = torch.full((B,), float(T // 2), device=dev)
    with torch.no_grad():
        y_k = model.denoise(x, ts, label, cf, fused=True).float()
        with kernels.plain_ops():
            cf_p = model.encode_condition(cond)
            y_p = model.denoise(x, ts, label, cf_p, fused=True).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    print(f"denoise kernels vs plain: rel_err={rel:.3g} (tol {DENOISE_REL_TOL})", flush=True)
    if not rel <= DENOISE_REL_TOL:
        raise AssertionError("denoise step through the kernels disagrees with the plain path")

    profile_denoise(model, x, ts, label, cf)

    # 6. report
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    kern = []
    for r in rows:
        kern.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": TPU_KERNELS[r["name"]],
            "launches": counts[LAUNCH_NAMES[r["name"]]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
