"""The port's config loading against the JAX package's: ``load_config`` on
every shipped experiment file and on a reference-schema refine file with
stringified lists, ``merge_refine_config`` and ``find_config_file``.  Both
packages read the same files; the dicts must be equal."""

import json
import os

import pytest

from point_diffusion_refinement_tpu.config import loader as jloader
from point_diffusion_refinement_tpu_torch.config import (
    EXPERIMENTS,
    find_config_file,
    load_config,
    merge_refine_config,
    restore_string_to_list_in_a_dict,
    write_all,
)
from torch_threads import one_torch_thread  # noqa: F401


def _stringify_lists(tree):
    """The reference's JSON convention: every list stored as its repr."""
    if isinstance(tree, dict):
        return {k: _stringify_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return str(tree)
    return tree


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_load_config_of_every_shipped_file(tmp_path, name):
    paths = {os.path.basename(p): p for p in write_all(str(tmp_path))}
    path = paths[f"config_{name}.json"]
    got = load_config(path)
    assert got == jloader.load_config(path)
    if "refine_config" in got:  # the refine keys were merged in
        rc = got["refine_config"]
        assert got["train_config"]["epochs_per_ckpt"] == rc["epochs_per_ckpt"]
        assert got["mvp_dataset_config"]["num_samples_tested"] == rc["num_samples_tested"]
    else:
        assert got == EXPERIMENTS[name]()


def test_reference_schema_refine_file(tmp_path):
    cfg = _stringify_lists(EXPERIMENTS["upsample_16384"]())
    cfg["refine_config"]["pc_augm_scale_list"] = "[1.0, 1.01]"  # merges nowhere
    cfg["train_config"]["note"] = "[not a list"  # stays a string
    path = tmp_path / "config_refine_ref.json"
    path.write_text(json.dumps(cfg))
    got = load_config(str(path))
    assert got == jloader.load_config(str(path))
    arch = got["pointnet_config"]["architecture"]
    assert arch["npoint"] == [1024, 256, 64, 16] and arch["radius"][0] == 0.1
    assert got["pointnet_config"]["pnet_global_feature_architecture"] == [[4, 128, 256],
                                                                          [512, 1024]]
    assert got["train_config"]["note"] == "[not a list"
    assert got["train_config"]["epochs_per_ckpt"] == 5  # from refine_config
    assert "pc_augm_scale_list" not in got["train_config"]
    assert restore_string_to_list_in_a_dict(cfg) == jloader.restore_string_to_list_in_a_dict(cfg)


def test_merge_refine_config_overrides_existing_keys_only():
    cfg = {"train_config": {"n_epochs": 3, "lr": 1.0},
           "pointnet_config": {"K": 8},
           "mvp_dataset_config": {"num_samples_tested": 5},
           "refine_config": {"n_epochs": 7, "K": 4, "num_samples_tested": 9, "extra": 1}}
    got = merge_refine_config(cfg)
    assert got == jloader.merge_refine_config(cfg)
    assert got["train_config"] == {"n_epochs": 7, "lr": 1.0}
    assert got["pointnet_config"] == {"K": 4}
    assert got["mvp_dataset_config"] == {"num_samples_tested": 9}
    assert cfg["train_config"]["n_epochs"] == 3  # the input is not changed


def test_find_config_file_picks_the_highest_number(tmp_path):
    for name in ("config_3.json", "config_12.json", "config.json", "notes.json",
                 "config_99.txt"):
        (tmp_path / name).write_text("{}")
    for arg in (str(tmp_path), str(tmp_path / "missing.json"), str(tmp_path / "ckpt")):
        got = find_config_file(arg)
        assert got == jloader.find_config_file(arg)
        assert os.path.basename(got) == "config_12.json"
    exact = str(tmp_path / "config_3.json")
    assert find_config_file(exact) == exact
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        find_config_file(str(tmp_path / "empty" / "x.json"))
