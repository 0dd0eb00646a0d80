"""The manifest and the registry: every name BENCHMARK.json gives is found
by name, and a new configuration, mix or metric is taken as new files and
entries, with no code edited."""

import json
import re
import shutil

from conftest import ROOT

from pdr_bench.registry import Registry
from pdr_bench.run import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["pdr_bench"] and m["command"][:2] == ["python3", "-m"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert 0 < e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert e["moves"] in e2e and e["layer"]
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    cells = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [e for e in m["per_layer"] if w["name"] in e.get("workloads", cells)]
        assert reported, w["name"]
    for c in m["configs"]:
        assert c["reduced"] == [] and (ROOT / c["file"]).is_file()


def test_configs_are_the_shipped_experiments():
    from point_diffusion_refinement_tpu_torch.config.exp_configs import EXPERIMENTS

    reg = Registry(ROOT / "BENCHMARK.json")
    for c in reg.manifest["configs"]:
        cfg = reg.config(c["name"])
        exp = EXPERIMENTS[cfg["experiment"]]()
        assert cfg["pointnet_config"] == exp["pointnet_config"]
        assert cfg["diffusion_config"] == exp["diffusion_config"]
        assert cfg["augmentation"] == exp["mvp_dataset_config"]["augmentation"]
        assert cfg["npoints"] == exp["mvp_dataset_config"]["npoints"]


def test_every_named_file_is_found():
    reg = Registry(ROOT / "BENCHMARK.json")
    for w in reg.manifest["workloads"]:
        reg.config(w["config"])
        traffic = reg.traffic(w["traffic"])
        assert hasattr(reg.driver(traffic["kind"]), "Cell")
        assert reg.limits(w["name"]), w["name"]
        for traced in (False, True):
            for entry, reader in reg.metrics(w["name"], traced):
                assert callable(reader.read), entry["name"]


def test_new_files_are_taken_without_an_edit(tiny_root):
    """A new mix, configuration and per-layer metric: new files and entries."""
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    home = tiny_root / "pdr_bench"
    cfg = json.loads((tiny_root / m["configs"][0]["file"]).read_text())
    cfg["name"] = "pdr_cgnet_mvp_copy"
    (home / "configs" / "pdr_cgnet_mvp_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "gen_fast50_b32.json").read_text())
    mix["fast_length"] = 2
    (home / "traffic" / "gen_fast2_b2.json").write_text(json.dumps(mix))
    (home / "metrics" / "window.units_seen.py").write_text(
        "def read(ctx):\n    return ctx['window']['units']\n")
    shutil.copy(home / "limits" / "cgnet.gen.fast50.b32.json",
                home / "limits" / "copy.gen.fast2.b2.json")
    m["configs"].append({"name": "pdr_cgnet_mvp_copy", "source": "x",
                         "file": "pdr_bench/configs/pdr_cgnet_mvp_copy.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "copy.gen.fast2.b2", "config": "pdr_cgnet_mvp_copy",
                           "traffic": "gen_fast2_b2", "chips": 1, "why": "x"})
    m["end_to_end"][0]["workloads"].append("copy.gen.fast2.b2")
    m["per_layer"].append({"name": "window.units_seen", "unit": "clouds", "better": "higher",
                           "source": "host_clock", "layer": "whole step",
                           "moves": "completions_per_s", "workloads": ["copy.gen.fast2.b2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    reg = Registry(tiny_root / "BENCHMARK.json")
    untraced = run_cell(reg, "copy.gen.fast2.b2", 5, 0.2, False, "cpu")
    assert set(untraced["metrics"]) == {"completions_per_s", "setup_s"}
    # a traced run on the CPU reads the metrics that need no device trace
    traced = run_cell(reg, "copy.gen.fast2.b2", 5, 0.2, True, "cpu")
    assert traced["metrics"]["window.units_seen"]["value"] == traced["attempted"] > 0
    assert "x0_point_gap_median" in traced["checks"]
