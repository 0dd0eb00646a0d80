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
   over 67 TFLOP/s, counted for this run's data).  The idx-only FPS is held
   at the mirror-preprocessing shapes (64 clouds of 4096 points, with exact
   duplicates, padding and an all-padding cloud, to 3072 and 2048) and at a
   row beyond shared memory (16384 points), where the coordinates kernel
   runs too.
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
6. Preprocessing: ``generate_mirrored_partials`` over 256 seeded partials of
   2048 points at batch 64 to 3072 points; checks shape, flags and one
   ``fps_idx`` launch a batch, and prints clouds/s.
7. The two-stage completion pipeline at B=4, launch counts reset just
   before and read just after: raw partials -> ``mirror_and_concat`` ->
   FastDPM-50 coarse generation (the ``refine_fast50`` plan: VAR,
   quadratic, kappa 0.5) -> the ``upsample_16384`` refine net (bf16,
   x8, seeded weights) -> CD-p / CD-t / F1 through ``evaluate``; fails unless
   the output is a finite (4, 16384, 3) cloud and every kernel was launched.
8. The ``upsample_16384`` refine forward at B=32: ms a batch,
   completions/s, and one forward through the kernels against one under
   ``plain_ops()`` (relative error of the displacement); then a profile of
   one forward.
9. Evaluation cost: ``calc_cd`` at (32, 16384) against (32, 16384) and
   ``earth_mover_distance`` at (32, 2048) against (32, 2048).
10. Prints the card's name and power limit, a ``{"kernels": [...]}`` line
   (launches from the pipeline run of phase 7), and last
   ``{"ok": true, "device": {...}}``.

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
REFINE_REL_TOL = 1e-2  # kernels vs plain versions, one bf16 refine forward
FAST_STEPS = 50  # FastDPM length of the refine_fast50 experiment

TPU_KERNELS = {
    "fps_coords": "point_diffusion_refinement_tpu/ops/pallas_fps.py:197",
    "fps_idx": "point_diffusion_refinement_tpu/ops/pallas_fps.py:250",
    "ball_group": "point_diffusion_refinement_tpu/ops/pallas_window.py:853",
    "ball_query": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:88",
    "knn": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:169",
}
LAUNCH_NAMES = {"fps_coords": "fps", "fps_idx": "fps_idx", "ball_group": "ball_group",
                "ball_query": "ball_query", "knn": "knn"}
# the kernels of ancestral coarse generation (phase 3); fps_idx serves
# mirror preprocessing
COARSE_PATH_KERNELS = ("fps", "ball_group", "ball_query", "knn")
SOURCES = {
    "fps_coords": "point_diffusion_refinement_tpu_torch/csrc/fps.cu",
    "fps_idx": "point_diffusion_refinement_tpu_torch/csrc/fps.cu",
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
        print_row(r)
    return rows


def mirrored_partials(rng, B: int, n: int) -> np.ndarray:
    """Seeded partials of the MVP kind: some points on z = 0 (their mirror
    images are exact duplicates) and zero padding at the end of each."""
    p = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    p[:, : n // 8, 2] = 0.0
    p[:, n - n // 16:] = 0.0
    return p


def check_fps_idx(dev, rng):
    """Phase 2, idx-only FPS: the mirror-preprocessing shapes and a row
    beyond shared memory, against the plain version."""
    from point_diffusion_refinement_tpu_torch.ops import gather_points, sampling

    def mirrored_xyz(B, n):
        p = mirrored_partials(rng, B, n)
        p[-1] = 0.0  # an all-padding cloud
        return torch.from_numpy(np.concatenate([p, p * np.float32([1, 1, -1])], 1)).to(dev)

    pre = mirrored_xyz(64, 2048)
    big = mirrored_xyz(2, 8192)
    for pts, npoint in ((pre, 3072), (pre, 2048), (big, 2048)):
        idx = sampling.furthest_point_sample(pts, npoint)
        ridx = sampling.furthest_point_sample_plain(pts, npoint)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            raise AssertionError(f"fps_idx: indices differ at {tuple(pts.shape)} -> {npoint}")
    cidx, co = sampling.furthest_point_sample_and_gather(big, 2048)
    torch.cuda.synchronize()
    if not (torch.equal(cidx, ridx) and torch.equal(co, gather_points(big, ridx))):
        raise AssertionError("fps: the coordinates kernel differs at N=16384")
    big_ms = time_ms(lambda: sampling.furthest_point_sample(big, 2048), 3, 1)
    print(f"kernel fps_idx (2,16384)->2048 equal to plain; ms={big_ms:.4f} "
          f"(global-memory rows)", flush=True)
    B, N, npoint = 64, pre.shape[1], 3072
    ms = time_ms(lambda: sampling.furthest_point_sample(pre, npoint), 5)
    plain_ms = time_ms(lambda: sampling.furthest_point_sample_plain(pre, npoint), 1, 1)
    b_ms, b_by = bound(nbytes(pre) + B * npoint * 4, 10.0 * B * (npoint - 1) * N)
    row = dict(name="fps_idx", shape="(64,4096)->3072", max_abs_err=0.0, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print_row(row)
    return row


def print_row(r) -> None:
    print(f"kernel {r['name']:<11} {r['shape']:<42} max_abs_err={r['max_abs_err']:.3g} "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms={r['library_ms']}", flush=True)


def profile_window(what: str, fn, steps: int = 3) -> None:
    """Device time by op and the device-busy share of a window of ``steps``
    calls of ``fn`` (one stream, so kernel times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in avgs
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    table = avgs.table(sort_by="self_device_time_total", row_limit=25)
    busy = dev_us / 1e3 / wall_ms
    print(f"profile: {steps} {what}, wall_ms={wall_ms:.2f} (profiled) "
          f"device_ms={dev_us / 1e3:.2f} device_busy={busy:.3f}", flush=True)
    print(table, flush=True)


def preprocess(rng) -> None:
    """Phase 6: mirror preprocessing at the preprocessing CLI's sizes."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.data import generate_mirrored_partials

    partials = mirrored_partials(rng, 256, 2048)
    generate_mirrored_partials(partials[:64], 3072)  # warm-up, uncounted
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_mirrored_partials(partials, 3072, batch_size=64)
    secs = time.perf_counter() - t0
    n = ops.launch_counts()["fps_idx"]
    flags = np.unique(out[..., 3])
    print(f"preprocess: 256 partials x 2048 -> {out.shape} in {secs * 1e3:.1f} ms, "
          f"{256 / secs:.1f} clouds/s, fps_idx launches={n}, flags={flags.tolist()}",
          flush=True)
    if out.shape != (256, 3072, 4) or n != 4 or set(flags.tolist()) != {-1.0, 1.0}:
        raise AssertionError("preprocessing output or launches are wrong")


def upsample_refiner(seed: int):
    """The ``upsample_16384`` refine net (bf16, include_t=False, x8) with
    seeded weights, and its refiner."""
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.sample import make_refiner

    cfg = EXPERIMENTS["upsample_16384"]()
    pc = cfg["pointnet_config"]
    model = PointNet2CloudCondition.from_config(pc, device="cuda", seed=seed)
    refine = make_refiner(model, int(pc["point_upsample_factor"]),
                          bool(pc["include_displacement_center_to_final_output"]))
    return model, refine, float(cfg["refine_config"]["output_scale_factor"])


def conditions(rng, B: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, 3072, 3)),
         rng.integers(0, 2, (B, 3072, 1)) * 2.0 - 1.0], axis=-1).astype(np.float32)).to(dev)


def pipeline(model, rng, dev):
    """Phase 7: mirror -> FastDPM-50 -> refine x8 -> CD/F1 at B=4, with the
    launch counts of the whole run."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.data import mirror_and_concat
    from point_diffusion_refinement_tpu_torch.diffusion import (
        calc_diffusion_hyperparams,
        make_fast_sampling_plan,
    )
    from point_diffusion_refinement_tpu_torch.sample import evaluate, make_coarse_sampler

    B = 4
    dc = EXPERIMENTS["refine_fast50"]()["diffusion_config"]
    T, b0, bT = int(dc["T"]), float(dc["beta_0"]), float(dc["beta_T"])
    schedule = calc_diffusion_hyperparams(T, b0, bT)
    plan = make_fast_sampling_plan(schedule, T, b0, bT, length=FAST_STEPS,
                                   sampling_method="var", noise_schedule="quadratic",
                                   kappa=0.5)
    sampler = make_coarse_sampler(model, schedule, 2048, fast_plan=plan)
    refiner_model, refine, osf = upsample_refiner(seed=1)
    raw = torch.from_numpy(mirrored_partials(rng, B, 2048)).to(dev)
    gt = rng.uniform(-0.5, 0.5, (B, 16384, 3)).astype(np.float32)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    with torch.no_grad():  # warm-up of the refine net's first-use allocations
        refine(torch.randn(B, 2048, 3, device=dev), conditions(rng, B, dev), label, osf)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cond = mirror_and_concat(raw, 3072)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen.manual_seed(3)
    coarse = sampler(cond, label, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    timing = {}

    def generate(batch):
        t = time.perf_counter()
        out = refine(coarse, cond, label, osf)
        torch.cuda.synchronize()
        timing["refine_ms"] = (time.perf_counter() - t) * 1e3
        return out

    res = evaluate(generate, [{"complete": gt, "label": np.zeros(B)}], compute_emd=False,
                   keep_generated=True, print_every=1)
    counts = ops.launch_counts()
    fast_ms = (t2 - t1) * 1e3
    out = res.generated
    finite = bool(np.isfinite(out).all())
    print(f"pipeline: B={B} mirror_ms={(t1 - t0) * 1e3:.2f} fastdpm{FAST_STEPS}_ms={fast_ms:.1f} "
          f"fastdpm_step_ms={fast_ms / FAST_STEPS:.2f} "
          f"fastdpm_ms_per_completion={fast_ms / B:.1f} refine_ms={timing['refine_ms']:.2f}",
          flush=True)
    print(f"pipeline metrics: cd_p={res.metrics['cd_p'].tolist()} "
          f"cd_t={res.metrics['cd_distance'].tolist()} f1={res.metrics['f1'].tolist()}",
          flush=True)
    print(f"pipeline output: coarse={tuple(coarse.shape)} refined={out.shape} "
          f"finite={finite} launches={counts}", flush=True)
    if out.shape != (B, 16384, 3) or not finite or tuple(coarse.shape) != (B, 2048, 3):
        raise AssertionError("pipeline output is not a finite (4, 16384, 3) cloud")
    if not all(np.isfinite(res.metrics[k]).all() for k in ("cd_p", "cd_distance", "f1")):
        raise AssertionError("pipeline metrics are not finite")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched in the pipeline run")
    del refiner_model
    return counts


def refine_at_batch(rng, dev) -> None:
    """Phase 8: the x8 refine forward at B=32: time, kernels vs plain, and a
    profile of one forward."""
    from point_diffusion_refinement_tpu_torch.ops import kernels

    B = 32
    model, refine, osf = upsample_refiner(seed=2)
    coarse = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 2048, 3)).astype(np.float32)).to(dev)
    cond = conditions(rng, B, dev)
    label = torch.from_numpy(rng.integers(0, 16, (B,))).to(dev)
    refine(coarse, cond, label, osf)  # warm-up
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = refine(coarse, cond, label, osf)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"refine x8: B={B} ms_per_batch={ms:.2f} completions_per_s={B / ms * 1e3:.1f} "
          f"out={tuple(out.shape)} finite={bool(torch.isfinite(out).all())}", flush=True)
    with torch.no_grad():
        y_k = model(coarse, cond, None, label).float()
        with kernels.plain_ops():
            y_p = model(coarse, cond, None, label).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    print(f"refine kernels vs plain: rel_err={rel:.3g} (tol {REFINE_REL_TOL})", flush=True)
    if not rel <= REFINE_REL_TOL:
        raise AssertionError("refine forward through the kernels disagrees with the plain path")
    profile_window("refine forwards at B=32", lambda: model(coarse, cond, None, label), 1)


def evaluation_cost(rng, dev) -> None:
    """Phase 9: chamfer at the x8 output size and EMD at 2048 points."""
    from point_diffusion_refinement_tpu_torch.ops.chamfer import calc_cd
    from point_diffusion_refinement_tpu_torch.ops.emd import earth_mover_distance

    a, b = (torch.from_numpy(rng.uniform(-0.5, 0.5, (32, 16384, 3)).astype(np.float32)).to(dev)
            for _ in range(2))
    cd = calc_cd(a, b, True)
    cd_ms = time_ms(lambda: calc_cd(a, b, True), 2, 1)
    x, y = a[:, :2048].contiguous(), b[:, :2048].contiguous()
    e = earth_mover_distance(x, y)
    emd_ms = time_ms(lambda: earth_mover_distance(x, y), 2, 1)
    finite = all(bool(torch.isfinite(t).all()) for t in (*cd, e))
    print(f"eval cost: calc_cd (32,16384)x(32,16384) ms={cd_ms:.1f}; "
          f"emd (32,2048)x(32,2048) ms={emd_ms:.1f}; finite={finite} "
          f"cd_t_mean={float(cd[1].mean()):.6g} emd_mean={float(e.mean()):.6g}", flush=True)
    if not finite:
        raise AssertionError("evaluation metrics are not finite")


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
    rows.insert(1, check_fps_idx(dev, rng))

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
    for name in COARSE_PATH_KERNELS:
        if counts[name] <= 0 or per_step[name] <= 0:
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

    profile_window("denoise steps", lambda: model.denoise(x, ts, label, cf, fused=True))

    preprocess(rng)
    counts = pipeline(model, rng, dev)
    refine_at_batch(rng, dev)
    evaluation_cost(rng, dev)

    # 10. report
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
