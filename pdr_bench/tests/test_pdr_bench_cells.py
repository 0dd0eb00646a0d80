"""Each cell driven end to end at tiny widths on the CPU: the harness's
look for a card is skipped, the rest of a run is as on the chip.  With the
timed path broken underneath, ``correct`` comes out false; the control
(the reference computed below the configuration's precision) reads above
the sound program; a run loads no JAX."""

import ast
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

from pdr_bench import control
from pdr_bench.registry import Registry
from pdr_bench.run import FORBIDDEN, run_cell

CELLS = ["cgnet.gen.fast50.b32", "cgnet.gen.fast50.fused.b32", "cgnet.train.b32",
         "rfnet_x8.train.b32"]
SEED = 3141592653589


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end(tiny_root, workload):
    reg = Registry(tiny_root / "BENCHMARK.json")
    r = run_cell(reg, workload, SEED, 0.3, False, "cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(reg.limits(workload))
    e2e = "completions_per_s" if "gen" in workload else "train_samples_per_s"
    assert set(r["metrics"]) == {e2e, "setup_s"}


def _readings(reg, workload, seed=SEED):
    wl = reg.workload(workload)
    traffic = reg.traffic(wl["traffic"])
    cell = reg.driver(traffic["kind"]).Cell(reg.config(wl["config"]), traffic, seed, "cpu")
    cell.setup()
    cell.window(0.2)
    cell.release()
    return control.readings(cell, True)


@pytest.mark.parametrize("workload", ["cgnet.gen.fast50.b32", "cgnet.train.b32",
                                      "rfnet_x8.train.b32"])
def test_control_reads_above_the_program(tiny_root, workload):
    """On every compared number the cell's own control or a fault reads
    above the sound program, and one of them above the cell's limit."""
    reg = Registry(tiny_root / "BENCHMARK.json")
    r = _readings(reg, workload)
    limits = reg.limits(workload)
    others = [v for k, v in r.items() if k.startswith(("control", "fault"))]
    for name in limits:
        assert max(o[name] for o in others) > r["program"][name], name
    for o in others:
        assert any(o[name] > limit for name, limit in limits.items())


def _break_sampler(monkeypatch):
    """Every answer altered where it is produced: each cloud's points
    shifted by one place."""
    from point_diffusion_refinement_tpu_torch import sample

    make = sample.make_coarse_sampler

    def broken(*a, **k):
        inner = make(*a, **k)

        def sampler(*args, **kwargs):
            return inner(*args, **kwargs).roll(1, dims=1)
        sampler.graphs = inner.graphs
        return sampler
    monkeypatch.setattr(sample, "make_coarse_sampler", broken)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the loss, no update."""
    from point_diffusion_refinement_tpu_torch.train import step

    def make_update(model, loss_fn, record_stats):
        def update(optimizer, *inputs):
            loss = loss_fn(*inputs)
            optimizer.zero_grad(set_to_none=True)
            return loss.detach()
        return update
    monkeypatch.setattr(step, "_make_update", make_update)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from point_diffusion_refinement_tpu_torch.train import step

    for name in ("make_completion_loss", "make_refine_loss"):
        make = getattr(step, name)

        def broken(*a, _make=make, **k):
            loss_fn = _make(*a, **k)

            def half(*inputs):
                h = inputs[0].shape[0] // 2
                return loss_fn(*[t[:h] if torch.is_tensor(t) and t.dim() > 0 else t
                                 for t in inputs])
            return half
        monkeypatch.setattr(step, name, broken)


def _half_batch_in_replays(monkeypatch):
    """Half of the batch left out from the update's second call on: the
    steps the compiled step replays on the card (its first call is an eager
    warm-up), with the first step sound."""
    from point_diffusion_refinement_tpu_torch.train import step

    for name in ("make_completion_loss", "make_refine_loss"):
        make = getattr(step, name)

        def broken(*a, _make=make, **k):
            loss_fn = _make(*a, **k)
            calls = [0]

            def half(*inputs):
                calls[0] += 1
                if calls[0] == 1:
                    return loss_fn(*inputs)
                h = inputs[0].shape[0] // 2
                return loss_fn(*[t[:h] if torch.is_tensor(t) and t.dim() > 0 else t
                                 for t in inputs])
            return half
        monkeypatch.setattr(step, name, broken)


def _augmentation_broken(monkeypatch):
    """The port's augmentation returns its clouds unchanged."""
    from point_diffusion_refinement_tpu_torch.data import augment

    monkeypatch.setattr(augment, "augment_cloud",
                        lambda Ps, args, return_augmentation_params=False, rng=None:
                        [P.copy() for P in Ps])


@pytest.mark.parametrize("workload,fault", [
    ("cgnet.gen.fast50.b32", _break_sampler),
    ("cgnet.gen.fast50.fused.b32", _break_sampler),
    ("cgnet.train.b32", _state_unchanged),
    ("cgnet.train.b32", _half_batch),
    ("cgnet.train.b32", _half_batch_in_replays),
    ("cgnet.train.b32", _augmentation_broken),
    ("rfnet_x8.train.b32", _state_unchanged),
    ("rfnet_x8.train.b32", _half_batch),
    ("rfnet_x8.train.b32", _half_batch_in_replays),
    ("rfnet_x8.train.b32", _augmentation_broken),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    reg = Registry(tiny_root / "BENCHMARK.json")
    sound = run_cell(reg, workload, SEED, 0.2, False, "cpu")["checks"]
    fault(monkeypatch)
    broken = run_cell(reg, workload, SEED, 0.2, False, "cpu")
    assert broken["correct"] is False
    assert any(broken["checks"][k]["value"] > max(sound[k]["value"], broken["checks"][k]["limit"])
               for k in sound)


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys, torch; torch.set_num_threads(1)\n"
            "from pdr_bench.registry import Registry\n"
            "from pdr_bench.run import run_cell, forbidden_modules\n"
            f"reg = Registry({str(tiny_root / 'BENCHMARK.json')!r})\n"
            "for w in ('cgnet.gen.fast50.fused.b32', 'rfnet_x8.train.b32'):\n"
            "    run_cell(reg, w, 1, 0.1, True, 'cpu')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "point_diffusion_refinement_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "pdr_bench.run", "--workload",
                        "cgnet.train.b32", "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""
