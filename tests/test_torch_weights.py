"""Parameter conversion between the JAX package's Flax tree and the port,
and the port's package rules (no JAX imports, no silent CPU fallback)."""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import (
    DEFAULT_POINTNET_CONFIG,
    tiny_pointnet_config,
)
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu_torch.config import (
    DEFAULT_POINTNET_CONFIG as PORT_DEFAULT,
    tiny_pointnet_config as port_tiny,
)
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "point_diffusion_refinement_tpu_torch"


def _flax_shapes(cfg, n, m):
    model = JaxModel.from_config(cfg)
    f32 = jnp.float32
    p = jax.eval_shape(
        model.init, jax.random.key(0), jax.ShapeDtypeStruct((1, n, 3), f32),
        jax.ShapeDtypeStruct((1, m, 4), f32), jax.ShapeDtypeStruct((1,), f32),
        jax.ShapeDtypeStruct((1,), jnp.int32))
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}


def _port_shapes(model):
    tree = state_dict_to_flax(model.state_dict())
    return {jax.tree_util.keystr(k): tuple(np.shape(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class TestConversion:
    def test_tiny_tree_matches_flax(self):
        model = PointNet2CloudCondition(port_tiny())
        assert _port_shapes(model) == _flax_shapes(tiny_pointnet_config(), 64, 96)

    def test_default_config_parameter_count(self):
        flax = _flax_shapes(dict(DEFAULT_POINTNET_CONFIG), 2048, 3072)
        model = PointNet2CloudCondition(PORT_DEFAULT)
        assert _port_shapes(model) == flax
        count = sum(p.numel() for p in model.parameters())
        assert count == sum(int(np.prod(s)) for s in flax.values()) == 9_758_871

    def test_round_trip(self):
        model = PointNet2CloudCondition.from_config(port_tiny(), device="cpu", seed=3)
        sd = model.state_dict()
        back = flax_to_state_dict(state_dict_to_flax(sd))
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
        other = PointNet2CloudCondition.from_config(port_tiny(), device="cpu", seed=4)
        load_flax_params(other, state_dict_to_flax(sd))
        for k, v in other.state_dict().items():
            assert torch.equal(v, sd[k]), k

    def test_dense_kernels_are_transposed(self):
        model = PointNet2CloudCondition(port_tiny())
        tree = state_dict_to_flax(model.state_dict())["params"]
        w = model.state_dict()["fc_t1.weight"]  # (out, in)
        assert tree["fc_t1"]["kernel"].shape == (w.shape[1], w.shape[0])
        np.testing.assert_array_equal(tree["fc_t1"]["kernel"], w.numpy().T)

    def test_mismatch_raises(self):
        model = PointNet2CloudCondition(port_tiny())
        tree = state_dict_to_flax(model.state_dict())
        del tree["params"]["fc_t1"]
        with pytest.raises(KeyError):
            load_flax_params(model, tree)


FORBIDDEN = re.compile(r"^(jax|flax|jaxlib|point_diffusion_refinement_tpu(?!_torch))(\.|$)")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


class TestPackageRules:
    def test_no_jax_imports(self):
        files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        assert len(files) > 30  # the whole package, every slice's modules
        assert PORT / "data" / "mirror.py" in files and PORT / "ops" / "emd.py" in files
        bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
               if FORBIDDEN.match(m)]
        assert bad == []

    def test_no_environment_knobs(self):
        for f in PORT.rglob("*.py"):
            assert "PDR_" not in f.read_text(), f

    def test_config_is_a_copy(self):
        assert dict(PORT_DEFAULT) == dict(DEFAULT_POINTNET_CONFIG)
        assert port_tiny() == tiny_pointnet_config()

    def test_entry_points_need_cuda_unless_cpu_is_asked(self, monkeypatch):
        from point_diffusion_refinement_tpu_torch.utils.device import resolve_device

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PointNet2CloudCondition.from_config(port_tiny())
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"
