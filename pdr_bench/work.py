"""The work of the program's hand-written kernels, counted on the frozen
reference, and the least time the card could take for it.

Each function the port serves with a hand-written CUDA kernel has a count
of the bytes it must move and the operations it must do, from its inputs
and outputs alone: each input byte read once, each output byte written
once (the rule of the kernel table in ``PERF.md``).  The bound of a call is
the larger of bytes over HBM's 3.35 TB/s and operations over the peak that
the kernel's arithmetic runs at (float32 67 TFLOP/s, or bf16 989 TFLOP/s
in the tensor cores), the published figures of one H100 SXM.

``spy(tally)`` counts the calls of those functions while the frozen
reference runs, in the configuration's own precision (bf16 tables as the
program holds them), through the same routes the program takes; a
replacement kernel is then held to the same work.  ``KERNELS`` names the
device records of each function in a profiler trace.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
from collections import defaultdict
from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# function -> the substrings of its kernels' names in a trace
KERNELS = {
    "fps": ("fps_reg_kernel<true", "fps_global_kernel<true"),
    "fps_idx": ("fps_reg_kernel<false", "fps_global_kernel<false"),
    "ball_query": ("ball_query_kernel",),
    "ball_group": ("ball_group_kernel",),
    "knn": ("knn_kernel",),
    "knn_group": ("knn_group_kernel",),
    "ball_query_group": ("ball_query_group_kernel",),
    "scatter_ordered": ("scatter_ordered_",),
    "attention_pool": ("attn_stats_kernel", "attn_qn_kernel", "attn_hstats_kernel",
                       "attn_out_kernel"),
}


def kernel_of(name: str):
    """The function whose kernel a trace record ``name`` is, or None."""
    for fn, keys in KERNELS.items():
        if any(k in name for k in keys):
            return fn
    return None


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def f32_bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * 4 for t in ts)


def scanned_pairs(idx: torch.Tensor, counts: torch.Tensor, n: int) -> float:
    """(centre, point) pairs a first-K-in-index-order scan visits: up to the
    K-th hit for a full ball, the whole support otherwise."""
    K = idx.shape[-1]
    last = idx[..., K - 1].to(torch.float64) + 1.0
    full = counts >= K
    return float(torch.where(full, last, torch.full_like(last, float(n))).sum())


class Tally:
    """Bound seconds of the counted calls, by function."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def add(self, fn: str, bytes_moved: float, ops: float, ops_per_s: float) -> None:
        self.seconds[fn] += bound_s(bytes_moved, ops, ops_per_s)
        self.calls[fn] += 1

    def scaled(self, factor: float) -> "Tally":
        out = Tally()
        for k in self.seconds:
            out.seconds[k] = self.seconds[k] * factor
            out.calls[k] = self.calls[k]
        return out


# --- the count of each function, from its arguments and results ----------

def fps(xyz, npoint, out):
    B, N, _ = xyz.shape
    return f32_bytes(xyz) + B * npoint * 16, 10.0 * B * (npoint - 1) * N, FP32_OPS_PER_S


def fps_idx(xyz, npoint, out):
    B, N, _ = xyz.shape
    return f32_bytes(xyz) + B * npoint * 4, 10.0 * B * (npoint - 1) * N, FP32_OPS_PER_S


def ball_query(xyz, new_xyz, radius, nsample, out):
    idx, counts = out
    return (f32_bytes(xyz, new_xyz) + nbytes(idx, counts),
            9.0 * scanned_pairs(idx, counts, xyz.shape[1]), FP32_OPS_PER_S)


def ball_group(support, tables, queries, radius, nsample, include_center, empty_mode,
               return_idx, out):
    """The fused ball query and gather (#2): the tables as bf16, the rows it
    writes, the counts (and idx where asked for); operations as the ball
    query's scan."""
    from .reference.net.ops.neighbors import ball_query_plain

    outs, counts = out[0], out[1]
    idx, cnt = ball_query_plain(support, queries, radius, nsample)
    moved = (f32_bytes(support, queries) + sum(t.numel() * 2 for t in tables)
             + sum(o.numel() * 2 for o in outs) + counts.numel() * 4
             + (idx.numel() * 4 if return_idx else 0))
    return moved, 9.0 * scanned_pairs(idx, cnt, support.shape[1]), FP32_OPS_PER_S


def ball_query_group(xyz, new_xyz, table, radius, nsample, out):
    g, idx, counts = out
    return (f32_bytes(xyz, new_xyz, table, g) + nbytes(idx, counts),
            9.0 * scanned_pairs(idx, counts, xyz.shape[1]), FP32_OPS_PER_S)


def knn(query, points, k, out):
    B, M, _ = query.shape
    return (f32_bytes(query, points) + B * M * k * 8, 10.0 * B * M * points.shape[1],
            FP32_OPS_PER_S)


def knn_group(query, points, table, k, out):
    B, M, _ = query.shape
    C = table.shape[-1]
    return (f32_bytes(query, points) + table.numel() * 2 + B * M * k * (C + 11) * 2,
            10.0 * B * M * points.shape[1], FP32_OPS_PER_S)


def scatter_ordered(points, idx, gathered):
    """The backward of a gather from ``points``: the cotangent (at the
    gathered dtype) and idx read, the float32 rows written; one add a
    cotangent element."""
    return (nbytes(gathered) + idx.numel() * 4 + points.numel() * 4,
            float(gathered.numel()), FP32_OPS_PER_S)


def attention_pool(pool, feat, grouped, gfo):
    """The whole fused pool at one site: the query rows, the grouped keys
    and values as bf16 and the float32 output; the model's products of the
    pool once, in the tensor cores."""
    w = pool.widths
    B, M, K, Ck = grouped.shape
    Cv = gfo.shape[-1]
    ops = 2.0 * B * M * K * (Ck * w["c2"] + w["c2"] * w["inter_c"]
                             + w["inter_c"] * w["c_out"] + Cv * w["c_out"])
    moved = nbytes(feat) + grouped.numel() * 2 + gfo.numel() * 2 + B * M * w["c_out"] * 4
    return moved, ops, BF16_OPS_PER_S


@contextlib.contextmanager
def spy(tally: Tally):
    """Count, into ``tally``, every call of the functions above that the
    frozen reference makes inside the block; the reference's results are
    unchanged."""
    from .reference.net.models import attention
    from .reference.net.ops import ball_group as bg_mod
    from .reference.net.ops import neighbors, sampling

    def counted(name, fn, count):
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            tally.add(name, *count(*bound.arguments.values(), out))
            return out
        return wrapper

    def gather(fn):
        def wrapper(points, idx):
            out = fn(points, idx)
            if points.requires_grad and torch.is_grad_enabled():
                tally.add("scatter_ordered", *scatter_ordered(points, idx, out))
            return out
        return wrapper

    targets = {
        sampling.furthest_point_sample_and_gather: counted("fps", sampling.furthest_point_sample_and_gather, fps),
        sampling.furthest_point_sample: counted("fps_idx", sampling.furthest_point_sample, fps_idx),
        neighbors.ball_query: counted("ball_query", neighbors.ball_query, ball_query),
        neighbors.ball_query_group: counted("ball_query_group", neighbors.ball_query_group,
                                            ball_query_group),
        neighbors.knn: counted("knn", neighbors.knn, knn),
        neighbors.knn_group: counted("knn_group", neighbors.knn_group, knn_group),
        bg_mod.ball_group: counted("ball_group", bg_mod.ball_group, ball_group),
        sampling.gather_points: gather(sampling.gather_points),
        sampling.group_points: gather(sampling.group_points),
    }
    prefix = __name__.rsplit(".", 1)[0] + ".reference.net."
    patched = []
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith(prefix) or mod is None:
            continue
        for attr, value in list(vars(mod).items()):
            if callable(value) and value in targets:
                patched.append((mod, attr, value))
                setattr(mod, attr, targets[value])

    def pool_hook(pool, feat, grouped, gfo):
        tally.add("attention_pool", *attention_pool(pool, feat, grouped, gfo))

    attention.FUSED_POOL_HOOKS.append(pool_hook)
    try:
        yield tally
    finally:
        attention.FUSED_POOL_HOOKS.remove(pool_hook)
        for mod, attr, value in patched:
            setattr(mod, attr, value)


def per_call_bound_ms(fn: str, *args) -> float:
    """The bound in ms of one call of ``fn`` (tests, and the kernel table's
    rows)."""
    count = {"fps": fps, "fps_idx": fps_idx, "ball_query": ball_query,
             "ball_group": ball_group, "ball_query_group": ball_query_group, "knn": knn,
             "knn_group": knn_group, "scatter_ordered": scatter_ordered}[fn]
    return bound_s(*count(*args)) * 1e3
