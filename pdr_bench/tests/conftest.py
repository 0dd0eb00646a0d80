"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files with tiny configurations and mixes, run on the CPU."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TRAFFIC = {
    "gen_fastdpm": {"batch_size": 2, "fast_length": 3, "checked_clouds": 2},
    "train_step": {"batch_size": 4, "items": 12, "traced_steps": 1, "reference_block": 2},
}


def tiny_config(config: dict) -> dict:
    """The configuration at tiny widths and point counts (bf16 compute kept)."""
    from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config

    out = copy.deepcopy(config)
    pc = {**tiny_pointnet_config(), "compute_dtype": "bfloat16"}
    for key in ("include_t", "point_upsample_factor",
                "include_displacement_center_to_final_output",
                "intermediate_refined_X_loss_weight"):
        if key in config["pointnet_config"]:
            pc[key] = config["pointnet_config"][key]
    out["pointnet_config"] = pc
    out["npoints"] = 48 * int(pc.get("point_upsample_factor", 1))
    out["number_partial_points"] = 96
    return out


def make_tiny_root(dst: Path) -> Path:
    """A benchmark root at ``dst``: BENCHMARK.json, and its folder with the
    drivers, metrics and limits as they are and tiny configurations and
    mixes."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = dst / manifest["paths"][0]
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(ROOT / manifest["paths"][0] / sub, home / sub)
    (home / "configs").mkdir(parents=True)
    for c in manifest["configs"]:
        cfg = tiny_config(json.loads((ROOT / c["file"]).read_text()))
        (dst / c["file"]).write_text(json.dumps(cfg))
    for mix in (home / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        t.update(TINY_TRAFFIC[t["kind"]])
        mix.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
