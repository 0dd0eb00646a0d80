"""The window's arithmetic, the reduction of a trace, and the kernels'
bounds."""

import time

import pytest
import torch

from pdr_bench import readers, work
from pdr_bench.trace import Trace
from pdr_bench.traffic import gen_fastdpm


def _cell(stall_batch=None, batch_s=0.02):
    """A generation cell whose sampler is a stub of known duration."""
    cell = gen_fastdpm.Cell({"npoints": 8, "number_partial_points": 8,
                             "diffusion_config": {}},
                            {"batch_size": 4, "fused_attention": False, "fused_knn": False},
                            1, "cpu")
    cell.S = 5
    calls = []

    def sampler(cond, label, x_T, noise):
        time.sleep(batch_s * (5 if len(calls) == stall_batch else 1))
        calls.append(1)
        return x_T

    cell.sampler = sampler
    cell.inputs = lambda b: (None, None, torch.zeros(4, 8, 3), None)
    return cell


def test_window_ends_on_a_batch_boundary():
    w = _cell().window(0.1)
    assert w["units"] % 4 == 0 and w["seconds"] >= 0.1
    assert w["steps"] == w["units"] // 4 * 5 and w["failed"] == 0
    ctx = {"kind": "gen", "window": w}
    assert readers.rate(ctx, "gen") == pytest.approx(w["units"] / w["seconds"])
    assert readers.rate(ctx, "train") is None


def test_a_stall_lowers_the_rate():
    steady = _cell().window(0.2)
    stalled = _cell(stall_batch=1).window(0.2)
    r = lambda w: w["units"] / w["seconds"]  # noqa: E731
    assert r(stalled) < 0.8 * r(steady)


def test_failed_clouds_are_counted():
    cell = _cell()
    cell.inputs = lambda b: (None, None, torch.full((4, 8, 3), float("nan")), None)
    w = cell.window(0.05)
    assert w["failed"] == w["units"] > 0


def test_idle_share_and_gaps_on_synthetic_events():
    # device: [10, 30) and [50, 60) inside a span [0, 100); [95, 120) is cut
    tr = Trace([("k1", 10, 20), ("k2", 15, 30), ("copy", 50, 60), ("k3", 95, 120)],
               [("bench.batch", 0, 100)], [("aten::op", 0, 40), ("cudaLaunch", 40, 70)], 0, 100)
    assert tr.busy_s == pytest.approx(35e-9) and tr.window_s == pytest.approx(100e-9)
    ctx = {"kind": "train", "trace": tr, "span": {"units": 4, "steps": 2}}
    assert readers.idle_share(ctx, "train") == pytest.approx(65.0)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(65e-9)
    assert gaps["bench.batch / aten::op"] == pytest.approx(10e-9)
    assert gaps["bench.batch / cudaLaunch"] == pytest.approx(20e-9)
    assert tr.top_ops(1) == [["k3", pytest.approx(25e-9)]]


def test_roofline_and_elementwise_readers():
    tally = work.Tally()
    tally.add("knn", 3.35e3, 0.0, work.FP32_OPS_PER_S)  # 1 ns of bound a unit
    tr = Trace([("void knn_kernel<8>", 0, 40), ("elementwise_kernel<add>", 40, 60),
                ("reduce_kernel<sum>", 60, 70)], [], [], 0, 100)
    ctx = {"kind": "gen", "trace": tr, "span": {"units": 4, "steps": 2},
           "work": {"tally_per_unit": tally, "flops_per_unit": 989e3},
           "window": {"units": 10, "seconds": 1e-3}}
    assert readers.roofline(ctx, "gen") == pytest.approx(100.0 * 4e-9 / 40e-9)
    assert readers.roofline(ctx, "gen", ("attention_pool",)) is None
    assert readers.eltwise_reduce_ms(ctx, "gen") == pytest.approx(1e3 * 30e-9 / 2)
    assert readers.mfu(ctx, "gen") == pytest.approx(100.0 * 989e3 * 1e4 / 989e12)


def test_kernel_names():
    assert work.kernel_of("void (anonymous namespace)::knn_group_kernel<8>(Args)") == "knn_group"
    assert work.kernel_of("void knn_kernel<1>(float const*)") == "knn"
    assert work.kernel_of("void ball_query_group_kernel<2>()") == "ball_query_group"
    assert work.kernel_of("void ball_query_kernel()") == "ball_query"
    assert work.kernel_of("void fps_reg_kernel<true, 512>()") == "fps"
    assert work.kernel_of("void fps_reg_kernel<false, 512>()") == "fps_idx"
    assert work.kernel_of("void scatter_ordered_sum<2>()") == "scatter_ordered"
    assert work.kernel_of("void (anonymous namespace)::attn_out_kernel<64>()") == "attention_pool"
    assert work.kernel_of("void at::native::reduce_kernel<128, 4>()") is None


def test_bounds_at_ft0_match_the_kernel_table():
    """PERF.md's kernel table at FT0 (B=4: support 3072, 2048 queries,
    K=32): #2 0.00880 ms, O 0.01178 ms (bytes)."""
    from pdr_bench.reference.net.ops.ball_group import ball_group_plain

    g = torch.Generator().manual_seed(0)
    sup = torch.rand(4, 3072, 3, generator=g) - 0.5
    q = torch.randn(4, 2048, 3, generator=g)
    tabs = [torch.randn(4, 3072, c, generator=g).to(torch.bfloat16) for c in (4, 32)]
    out = ball_group_plain(sup, tabs, q, 0.1, 32, True, "center_zero")
    ms = work.per_call_bound_ms("ball_group", sup, tabs, q, 0.1, 32, True, "center_zero",
                                False, out)
    assert round(ms, 5) == 0.00880
    dg = torch.zeros(4, 2048, 32, 35)
    idx = torch.zeros(4, 2048, 32, dtype=torch.int32)
    assert round(work.per_call_bound_ms("scatter_ordered", torch.zeros(4, 3072, 35), idx, dg),
                 5) == 0.01178
