"""The arithmetic of the metrics that read the program's spans: device ms
of a group inside its step, idle time inside host spans, and nothing read
from a program that has no spans."""

from pathlib import Path

import pytest

from pdr_bench import registry, spans
from pdr_bench.trace import Trace
from point_diffusion_refinement_tpu_torch.utils.profiling import Record


def _ctx(kind, recs, trace=None):
    trace = trace or Trace([], [], [], 0, 1)
    return {"kind": kind, "trace": trace, "program_records": recs}


def _gen_records():
    """An encode (eager marks) and two replays' readings of a step."""
    return [
        Record("pdr.gen.encode", -1, 0, 100, 200, 0.050),
        Record("pdr.net.group", 0, 0, 110, 120, 0.004),  # the encode's: not a step's
        Record("pdr.fastdpm.step", -1, 0, 200, 300),
        Record("pdr.graphs.replay", 2, 0, 210, 290),
        Record("pdr.net.denoise", 3, 0, device_s=0.095),
        Record("pdr.net.group", 4, 0, device_s=0.005),
        Record("pdr.net.mlp", 4, 0, device_s=0.030),
        Record("pdr.net.attention", 4, 0, device_s=0.040),
        Record("pdr.net.group", 4, 0, device_s=0.003),
        Record("pdr.fastdpm.step", -1, 0, 300, 400),
        Record("pdr.graphs.replay", 9, 0, 310, 390),
        Record("pdr.net.denoise", 10, 0, device_s=0.097),
        Record("pdr.net.group", 11, 0, device_s=0.006),
    ]


def test_device_ms_inside_a_step():
    ctx = _ctx("gen", _gen_records())
    # (5 + 3 + 6) ms of groups over two readings of the step
    assert spans.device_ms_each(ctx, "gen", "pdr.net.group", "pdr.net.denoise") == \
        pytest.approx(7.0)
    assert spans.device_ms_each(ctx, "gen", "pdr.net.mlp", "pdr.net.denoise") == \
        pytest.approx(15.0)
    assert spans.device_ms(ctx, "gen", "pdr.gen.encode") == pytest.approx(50.0)
    assert spans.host_ms(ctx, "gen", "pdr.fastdpm.step") == pytest.approx(1e-4)
    assert spans.device_ms_each(ctx, "train", "pdr.net.group", "pdr.net.denoise") is None
    assert spans.device_ms(ctx, "gen", "pdr.train.backward") is None


def test_idle_inside_host_spans():
    # busy 10-20, 30-40 and 60-70 of a span 0-80: idle 0-10, 20-30, 40-60, 70-80
    tr = Trace([("k", 10, 20), ("k", 30, 40), ("k", 60, 70)], [], [], 0, 80)
    recs = [Record("pdr.fastdpm.step", -1, 0, 5, 25), Record("pdr.fastdpm.step", -1, 0, 25, 65),
            Record("pdr.gen.encode", -1, 0, 70, 80)]
    ctx = _ctx("gen", recs, tr)
    # 5 + 5 inside the first, 5 + 20 inside the second
    assert spans.idle_ns_inside(ctx, ("pdr.fastdpm.step",)) == (35, 2)
    assert spans.idle_ns_inside(ctx, ("pdr.fastdpm.step", "pdr.gen.encode")) == (45, 3)
    assert spans.idle_ms_each(ctx, "gen", "pdr.fastdpm.step") == pytest.approx(17.5e-6)
    assert spans.idle_ms_each(ctx, "train", "pdr.fastdpm.step") is None


def test_program_without_spans(monkeypatch):
    """Every reader of the spans gives None where the program has none (an
    earlier commit of it)."""
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    reg = registry.Registry(Path(spans.__file__).resolve().parents[1] / "BENCHMARK.json")
    read = 0
    for wl in ("cgnet.gen.fast50.b32", "cgnet.train.b32", "rfnet_x8.train.b32"):
        ctx = {"kind": "gen" if ".gen." in wl else "train", "trace": Trace([], [], [], 0, 1),
               "window": {}, "span": {"units": 1, "steps": 1}}
        for entry, reader in reg.metrics(wl, True):
            if "spans" in vars(reader):
                assert reader.read(ctx) is None, entry["name"]
                read += 1
    assert read == 6 + 7 + 8  # with graphs.capture_s in each, chamfer in the RFNet cell


def test_capture_counter_reads_the_program():
    assert spans.counter("graphs.capture_s") >= 0.0
