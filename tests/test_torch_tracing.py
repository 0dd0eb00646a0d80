"""The port's spans and counters (``utils/profiling.py``) on the CPU.

With no profile recording, a span is one shared object that records
nothing.  Under a CPU ``torch.profiler`` profile a tiny FastDPM sampler
and a training step give the span tree the layers open: names, parents
and unit ids, each network group at its outermost instance.  A span's
host stamps and the profiler's own record of a ``record_function`` range
opened inside it lie on one clock.  The launch counts kept among the
counters read as before, and ``trace`` writes the spans on a track of
their own.  The test marked ``cuda`` reads the device marks of a captured
graph after a replay, and holds the work between two spans out of both;
it skips without a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import gzip
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.data import iterate_batches
from point_diffusion_refinement_tpu_torch.diffusion import (
    calc_diffusion_hyperparams,
    make_fast_sampling_plan,
)
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.ops import kernels
from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler
from point_diffusion_refinement_tpu_torch.train.step import (
    create_train_state,
    make_completion_train_step,
)
from point_diffusion_refinement_tpu_torch.utils import profiling
from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction
from torch_threads import one_torch_thread  # noqa: F401

B, N, M, T, S = 2, 64, 96, 10, 3  # batch, points, condition points, steps, FastDPM steps
GROUPS = ("pdr.net.group", "pdr.net.mlp", "pdr.net.attention")


@pytest.fixture(scope="module")
def model():
    return PointNet2CloudCondition.from_config(tiny_pointnet_config(), device="cpu", seed=3)


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    cond = torch.cat([torch.rand(B, M, 3, generator=g) - 0.5, torch.ones(B, M, 1)], -1)
    return cond, torch.tensor([1, 4]), torch.randn(B, N, 3, generator=g)


def _profiled(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.records(), prof


def _ancestors(recs, r):
    out, p = [], r.parent
    while p >= 0:
        out.append(recs[p].name)
        p = recs[p].parent
    return out


def test_spans_off_record_and_allocate_nothing(model):
    assert profiling.span("pdr.net.group", device=True) is profiling.span("pdr.net.mlp")
    assert profiling.unit() is profiling.span("pdr.x")
    profiling.reset()
    cond, label, x = _inputs()
    with torch.no_grad():
        model(x, cond, torch.full((B,), 3.0), label)
    assert profiling.records() == []
    span = profiling.span
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with span("pdr.net.group", device=True):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "filename")
    assert sum(s.size_diff for s in grown) <= 0


def test_sampler_span_tree(model):
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.05)
    plan = make_fast_sampling_plan(schedule, T, 1e-4, 0.05, length=S)
    sampler = make_coarse_sampler(model, schedule, N, fast_plan=plan, segment_size=S)
    cond, label, x = _inputs()
    noise = torch.randn(S, B, N, 3)
    _, recs, _ = _profiled(lambda: [sampler(cond, label, x_T=x, noise=noise) for _ in range(2)])
    names = [r.name for r in recs]
    assert {r.unit for r in recs} == {0, 1}
    for u in (0, 1):
        mine = [r for r in recs if r.unit == u]
        assert [r.name for r in mine].count("pdr.gen.encode") == 1
        steps = [r for r in mine if r.name == "pdr.fastdpm.step"]
        assert len(steps) == S and all(r.parent == -1 for r in steps)
        denoise = [r for r in mine if r.name == "pdr.net.denoise"]
        assert [recs[r.parent].name for r in denoise] == ["pdr.fastdpm.step"] * S
    for r in recs:
        up = _ancestors(recs, r)
        assert r.end_ns >= r.start_ns > 0 and r.device_s is None
        if r.name in GROUPS:
            # a group's spans are its outermost instances, never inside another group
            assert not set(up) & set(GROUPS), (r.name, up)
            assert {"pdr.gen.encode", "pdr.net.denoise"} & set(up), (r.name, up)
    for name in GROUPS:
        assert names.count(name) > 0
    rep = profiling.report()["spans"]
    assert rep["pdr.fastdpm.step"]["count"] == 2 * S and rep["pdr.fastdpm.step"]["units"] == 2
    assert rep["pdr.net.denoise"]["device_s"] is None and rep["pdr.net.denoise"]["host_s"] > 0


def test_train_step_span_tree(model):
    state = create_train_state(model, seed=0)
    step = make_completion_train_step(model, calc_diffusion_hyperparams(T, 1e-4, 0.05),
                                      compiled=True)
    items = [{"complete": np.random.default_rng(i).random((N, 3), dtype=np.float32),
              "partial": _inputs(i)[0][0].numpy(), "label": np.int64(i)} for i in range(4)]

    def two_steps():
        for b in iterate_batches(items, B, shuffle=False):
            step(state, torch.from_numpy(b["complete"]), torch.from_numpy(b["partial"]),
                 torch.from_numpy(b["label"]))

    _, recs, _ = _profiled(two_steps)
    top = [(r.name, r.unit) for r in recs if r.parent == -1]
    assert top == [("pdr.data.batch", -1), ("pdr.train.forward", 0), ("pdr.train.backward", 0),
                   ("pdr.train.optimizer", 0), ("pdr.data.batch", -1),
                   ("pdr.train.forward", 1), ("pdr.train.backward", 1),
                   ("pdr.train.optimizer", 1)]
    fwd = [r for r in recs if r.name == "pdr.net.forward"]
    assert [recs[r.parent].name for r in fwd] == ["pdr.train.forward"] * 2
    for r in recs:
        up = _ancestors(recs, r)
        if r.name in GROUPS:
            assert up[-1] == "pdr.train.forward" and not set(up) & set(GROUPS)
        if r.name == "pdr.net.denoise":
            assert up == ["pdr.net.forward", "pdr.train.forward"]
    assert profiling.report()["spans"]["pdr.train.backward"]["units"] == 2


def test_spans_share_the_profiler_clock():
    """Each program span brackets the profiler's record of a range opened
    inside it; the nearest pair of edges lies within 100 µs."""
    def spans():
        for i in range(10):
            with profiling.span("pdr.test.outer"):
                with record_function(f"inner{i}"):
                    torch.ones(8).sum()

    _, recs, prof = _profiled(spans)
    inner = {e.name(): e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU and e.name().startswith("inner")}
    gaps = []
    for i, r in enumerate(recs):
        e = inner[f"inner{i}"]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert r.start_ns <= start <= end <= r.end_ns, (i, r, start, end)
        gaps.append(max(start - r.start_ns, r.end_ns - end))
    assert min(gaps) < 100_000, gaps


def test_launch_counts_are_counters():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    kernels.add_launches({"fps": 2, "knn": 1})
    counts = kernels.launch_counts()
    assert counts["fps"] == 2 and counts["knn"] == 1 and sum(counts.values()) == 3
    got = profiling.counters()
    assert got["launches.fps"] == 2 and "graphs.capture_s" in got
    assert profiling.report()["counters"]["launches.knn"] == 1
    kernels.reset_launch_counts()
    assert sum(kernels.launch_counts().values()) == 0
    cf = CapturedFunction(lambda a: a + 1)
    assert torch.equal(cf(torch.ones(2)), torch.full((2,), 2.0))
    assert cf.num_graphs == 0 and cf.stats() == []


def test_chrome_trace_holds_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("pdr.test.outer"):
            with profiling.span("pdr.test.inner"):
                torch.ones(4).sum()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("pid") == profiling.SPAN_TRACK and e["ph"] == "X"]
    assert [e["name"] for e in mine] == ["pdr.test.outer", "pdr.test.inner"]
    assert mine[1]["args"]["parent"] == "pdr.test.outer"
    assert mine[0]["ts"] <= mine[1]["ts"] and mine[1]["dur"] <= mine[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["ph"] == "X"]
    assert any(mine[1]["ts"] <= e["ts"] <= mine[1]["ts"] + mine[1]["dur"] for e in ops)
    rows = profiling.summarize_trace(str(tmp_path))
    assert rows and not any(r[0].startswith("pdr.") for r in rows)


@pytest.mark.cuda
def test_graph_marks_read_after_replay():
    """A captured graph's marks are read after a replay made while tracing.
    The work between two spans is the parent's own: the matmul before
    ``inner`` is timed by no child, so ``inner`` holds one of the parent's
    three matmuls.  ``inner`` and ``next``, with nothing enqueued between
    them, share one event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")

    def fn(x):
        with profiling.span("pdr.test.outer", device=True):
            y = x @ a
            with profiling.span("pdr.test.inner", device=True):
                y = y @ a
            with profiling.span("pdr.test.next", device=True):
                y = y.relu()
            return (y @ a).relu()

    cf = CapturedFunction(fn)
    x = torch.randn(2048, 2048, device="cuda")
    cf(x)
    cf(x)  # captured, replayed
    assert cf.num_graphs == 1
    (graph,) = cf._graphs.values()
    (_, _, o0, o1), (_, _, i0, i1), (_, _, n0, n1) = graph.marks.entries
    assert n0 is i1 and len({id(e) for e in (o0, o1, i0, i1, n1)}) == 5
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            cf(x)
        torch.cuda.synchronize()
    cf.release()
    recs = profiling.records()
    outer = [r for r in recs if r.name == "pdr.test.outer"]
    inner = [r for r in recs if r.name == "pdr.test.inner"]
    assert outer and len(outer) == len(inner)
    for o, i in zip(outer, inner):
        assert recs[o.parent].name == "pdr.graphs.replay" and recs[i.parent] is o
        assert 0.2 * o.device_s < i.device_s < 0.5 * o.device_s
    assert profiling.counters()["graphs.capture_s"] > 0
