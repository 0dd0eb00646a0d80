"""The kernel build cache of the port (``ops/kernels.py``) on the CPU: a
library's name follows every byte it is built from, so a changed header
never loads a stale library."""

import shutil

import pytest

from point_diffusion_refinement_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401

SOURCES = sorted({source for source, _, _ in kernels.KERNELS.values()})


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    return copy


@pytest.mark.parametrize("header", ["common.cuh", "knn_select.cuh", "ball_scan.cuh"])
def test_library_path_changes_with_a_header(csrc, header):
    before = {s: kernels._library_path(s) for s in SOURCES}
    path = csrc / header
    path.write_bytes(path.read_bytes() + b"\n// one more line\n")
    after = {s: kernels._library_path(s) for s in SOURCES}
    assert all(before[s] != after[s] for s in SOURCES)


def test_library_path_changes_with_a_new_header(csrc):
    before = kernels._library_path("knn_group.cu")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels._library_path("knn_group.cu") != before


def test_library_path_is_stable(csrc):
    assert [kernels._library_path(s) for s in SOURCES] == [
        kernels._library_path(s) for s in SOURCES]
    assert len({kernels._library_path(s).stem.split("-")[0] for s in SOURCES}) == len(SOURCES)
