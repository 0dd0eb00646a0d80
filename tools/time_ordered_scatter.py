"""Device times of the port's ordered scatter-add (``ops.group_scatter_add``,
``csrc/group_scatter_ordered.cu``) at the shapes of its callers, and its
share of a compiled B=32 PVD training step, for one checkout of the port.

Run it once on each of two checkouts on one card to compare them, in turns
(A, B, B, A), with ``--repo`` the checkout whose
``point_diffusion_refinement_tpu_torch`` is imported (the helpers come from
this repository's ``chip_smoke.py``)::

    python3 tools/time_ordered_scatter.py --repo path/to/checkout --tag parent

Each shape prints: the profiler's device ms a call (every kernel and memset
it starts) over a window of calls, the launches a call counted in a CUDA
graph of one call, the atomic kernel B's device ms, whether the result
equals the plain version on CPU copies bit for bit, and the SHA-256 of the
result's bytes (equal across checkouts where both sum in the same order, as
at K = 1).  Then one compiled PVD step (``chip_smoke.training_setup``): its
device ms and the ordered scatter-add's kernels' share, over PVD_STEPS
replays, at PyTorch's default TF32 settings (``chip_smoke.py`` turns TF32
off, so its PVD step's Conv3d takes longer; the scatter-add uses no tensor
cores), and the seconds the profiler took to parse that window's trace
beside summing its raw records.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PVD_STEPS = 2


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE,
                                                                             "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def cases(cs, dev, gen):
    """name -> (dg, idx, rows): the ball gathers of a feature transfer at
    level 0, chamfer's re-gather (as ``chip_smoke`` phase 10 makes it), the
    kNN gathers of the feature propagations, and PVD's voxel sums and
    devoxelize gathers."""
    import torch

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.ops.chamfer import nn_sqdist

    def ball(B, N, M, K, C, r):
        sup = torch.rand(B, N, 3, generator=gen, device=dev) - 0.5
        q = torch.randn(B, M, 3, generator=gen, device=dev)
        idx, _ = ops.ball_query(sup, q, r, K)
        return torch.randn(B, M, K, C, generator=gen, device=dev), idx, N

    def knn(B, N, M, K, C, ld):
        pts = torch.rand(B, N, 3, generator=gen, device=dev)
        q = torch.rand(B, M, 3, generator=gen, device=dev)
        _, idx = ops.knn(q, pts, K)
        wide = torch.randn(B, M, K, ld, generator=gen, device=dev).to(torch.bfloat16)
        return wide[..., :C], idx.to(torch.int32).contiguous(), N

    def chamfer():
        arrays = cs.training_arrays(cs.TRAIN_BATCH, 16384, seed=41)
        gt = torch.from_numpy(arrays["complete"]).to(dev)
        refined = torch.from_numpy(arrays["generated"]).to(dev).repeat_interleave(8, dim=1)
        refined = refined + 1e-3 * torch.randn(refined.shape, generator=gen, device=dev)
        _, nn_idx = nn_sqdist(gt, refined)
        dg = torch.randn(cs.TRAIN_BATCH, gt.shape[1], 1, 3, generator=gen, device=dev)
        return dg, nn_idx[:, :, None].to(torch.int32).contiguous(), refined.shape[1]

    def voxels(rows, C, skew):
        dg = torch.randn(32, 5120, 1, C, generator=gen, device=dev)
        at = torch.rand(32, 5120, 1, generator=gen, device=dev).pow(skew) * rows
        return dg, at.to(torch.int32), rows

    return {
        "FT0 B=4 (4,3072,2048,32,35) f32": lambda: ball(4, 3072, 2048, 32, 35, 0.1),
        "FT0 B=32 (32,3072,2048,32,35) f32": lambda: ball(32, 3072, 2048, 32, 35, 0.1),
        "chamfer (32,16384) into 16384, K=1, C=3": chamfer,
        "kNN (32,256,1024,8,320) bf16 ld 331": lambda: knn(32, 256, 1024, 8, 320, 331),
        "kNN (32,1024,2048,8,160) bf16 ld 171": lambda: knn(32, 1024, 2048, 8, 160, 171),
        "kNN (32,1024,3072,8,32) bf16 ld 43": lambda: knn(32, 1024, 3072, 8, 32, 43),
        "voxel sums r=32 (32,32768,5120,1,65)": lambda: voxels(32768, 65, 3.0),
        "devoxelize r=32 (32,32768,5120,1,64)": lambda: voxels(32768, 64, 1.0),
        "devoxelize r=16 (32,4096,5120,1,128)": lambda: voxels(4096, 128, 1.0),
    }


def pvd_share(cs, dev) -> None:
    """Device ms of PVD_STEPS replays of the compiled B=32 PVD step, and of
    the ordered scatter-add's kernels in them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = cs.training_setup("pvd", dev, PVD_STEPS)
    step = s.make(True)
    for i in range(2):  # the warm-up, the capture
        step(s.state, *s.inputs(i))
    torch.cuda.synchronize()
    with torch.enable_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(PVD_STEPS):
            step(s.state, *s.inputs(i))
        torch.cuda.synchronize()
    # the profiler's raw records against its parsed events: the same device
    # time, at a fraction of the parsing's cost
    t0 = time.perf_counter()
    raw = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA) / 1e3
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    parse_s = time.perf_counter() - t0
    keys = cs.PROFILED_KERNELS["group_scatter_ordered"]
    ordered = [e.time_range.elapsed_us() for e in events if any(k in e.name for k in keys)]
    total = sum(e.time_range.elapsed_us() for e in events)
    print(f"pvd compiled step B=32: device_ms a step={total / 1e3 / PVD_STEPS:.2f} "
          f"scatter_ordered_device_ms a step={sum(ordered) / 1e3 / PVD_STEPS:.4f} "
          f"({len(ordered) // PVD_STEPS} kernels a step); the trace parsed in {parse_s:.2f} s, "
          f"its raw records summed in {raw_s:.2f} s to {raw / 1e3 / PVD_STEPS:.2f} ms a step",
          flush=True)
    step.graphs.release()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose port is imported")
    ap.add_argument("--tag", default="", help="label printed on every line")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("time_ordered_scatter: no CUDA card", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.ops import kernels

    print(f"[{args.tag}] port from {os.path.abspath(args.repo)}; build s: "
          f"{max(kernels.build().values()):.1f}; {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, make in cases(cs, dev, gen).items():
        dg, ix, n = make()
        run = lambda: ops.group_scatter_add(dg, ix, n)  # noqa: E731
        out = run()
        equal = torch.equal(out.cpu(), ops.group_scatter_add_plain(dg.cpu(), ix.cpu(), n))
        ms = cs.window_device_ms(run, 20)
        nodes = cs.graph_launches(run)
        atomic = cs.device_ms(lambda: ops.group_scatter_add(dg, ix, n, deterministic=False),
                              "group_scatter_add", iters=10)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"[{args.tag}] {name}: ordered device_ms={ms:.4f} launches a call={nodes} "
              f"atomic_B_device_ms={atomic:.4f} equal to plain on CPU copies={equal} "
              f"sha256={digest}", flush=True)
        del dg, ix, out
    pvd_share(cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
