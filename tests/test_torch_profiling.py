"""The port's profiling helpers on the CPU: ``StepTimer`` discards its
warm-up (``tests/test_utils.py``'s test), and ``trace`` + ``summarize_trace``
return the operators of a CPU trace (the CPU is the device of a CPU run)
with the JAX package's row layout, (name, total µs, count)."""

import os

import pytest
import torch

from point_diffusion_refinement_tpu_torch.utils.profiling import (
    StepTimer,
    summarize_trace,
    trace,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=1)
    for _ in range(3):
        with t:
            pass
    assert len(t.times) == 2
    assert t.best <= t.mean
    assert StepTimer().mean != StepTimer().mean  # no step: nan


@pytest.mark.parametrize("long_names", [False, True])
def test_trace_summary_rows(tmp_path, long_names):
    a = torch.randn(64, 64)
    with trace(str(tmp_path)):
        for _ in range(3):
            (a @ a).relu().sum()
    assert any(f.endswith(".pt.trace.json.gz") for f in os.listdir(tmp_path))
    rows = summarize_trace(str(tmp_path), top=10, long_names=long_names)
    assert 0 < len(rows) <= 10
    names = [r[0] for r in rows]
    assert "aten::mm" in names or "aten::matmul" in names
    for name, us, count in rows:
        assert isinstance(name, str) and us >= 0 and count >= 1
    mm = dict((r[0], r[2]) for r in rows).get("aten::mm")
    assert mm is None or mm == 3
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)


def test_summary_of_nothing(tmp_path):
    assert summarize_trace(str(tmp_path)) == []
    with trace(str(tmp_path)):
        torch.ones(4).sum()
    assert summarize_trace(str(tmp_path), host_fallback=False) == []  # no card here
    assert summarize_trace(str(tmp_path))
