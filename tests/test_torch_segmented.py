"""Compiled generation in the port: the segmented samplers, the captured
refiner's helper and ``ops/emd.py::approx_match``.

On the CPU a captured step runs eagerly, so the segmented samplers must be
bit-equal to the unsegmented ones for every segment size, with t-slices,
with the warm start and for FastDPM, from the same generator.  Against the
JAX package's ``make_coarse_sampler(segment_size=3)`` the port is fed the
JAX noise stream (``tests/test_torch_sampling.py::jax_noise_stream``) and
held to that file's float32 tolerance (the denoiser differs by summation
order only).  ``run_generation`` writes the same clouds and metrics with
any ``segment_size``.  ``approx_match`` equals the JAX package's within
``tests/test_torch_eval.py``'s EMD tolerance.  The tests marked ``cuda``
hold a graphed sampler and refiner against eager ones on the card (equal
outputs, equal launch counts); they skip without a GPU.  The JAX package
is imported inside the fixtures that need it, so on a GPU machine without
JAX the ``cuda`` tests run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_segmented.py
"""

import os
import pickle

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.data import synthetic_dataset
from point_diffusion_refinement_tpu_torch.diffusion import (
    calc_diffusion_hyperparams,
    ddpm,
    fastdpm,
    make_fast_sampling_plan,
)
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.ops.emd import approx_match
from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler, make_refiner
from point_diffusion_refinement_tpu_torch.sample.pipeline import run_generation
from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_torch_sampling.py's: float32 throughout, the denoiser differs
# from the JAX package's by summation order only
F32_TOL = dict(rtol=1e-4, atol=2e-5)
# tests/test_torch_eval.py's: ten auction rounds of float32 contractions
EMD_TOL = dict(rtol=1e-4, atol=1e-7)
B, N, M, T = 2, 64, 96, 5  # batch, generated points, condition points, steps


def _condition(seed, batch=B):
    rng = np.random.default_rng(seed)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (batch, M, 3)), np.ones((batch, M, 1))], -1)
    return torch.from_numpy(cond.astype(np.float32)), torch.tensor([3, 9][:batch])


@pytest.fixture(scope="module")
def model():
    return PointNet2CloudCondition.from_config(tiny_pointnet_config(), device="cpu", seed=5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("mode", ["slices", "warm", "fast"])
@pytest.mark.parametrize("segment", [1, 3, 4, T])
def test_segmented_equals_unsegmented(model, mode, segment):
    """make_coarse_sampler(segment_size=S) and the segmented samplers
    themselves are bit-equal to the unsegmented ones from one generator
    seed (x_T and every step's z drawn in the eager loop's order)."""
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.05)
    cond, label = _condition(1)
    kw, call = {}, {}
    if mode == "slices":
        kw = dict(t_slices=(3, 0))
    elif mode == "warm":
        kw = dict(warm_start_step=3)
        call = dict(XT=torch.from_numpy(
            np.random.default_rng(2).normal(size=(B, N, 3)).astype(np.float32)))
    else:
        kw = dict(fast_plan=make_fast_sampling_plan(schedule, T, 1e-4, 0.05, length=4))
    eager = make_coarse_sampler(model, schedule, N, **kw)
    seg = make_coarse_sampler(model, schedule, N, segment_size=segment, **kw)
    assert eager.graphs is None and isinstance(seg.graphs, CapturedFunction)
    ref, got = eager(cond, label, generator=_gen(7), **call), seg(cond, label, generator=_gen(7),
                                                                  **call)
    if mode == "slices":
        (ref, ref_slices), (got, got_slices) = ref, got
        assert sorted(got_slices) == [0, 3]
        for t in (3, 0):
            assert torch.equal(got_slices[t], ref_slices[t])
    assert got.shape == (B, N, 3) and torch.equal(got, ref)

    # the diffusion-level functions, on a closed-form denoiser
    def denoise_apply(ctx, x, ts):
        return ctx[0] * x + 0.01 * ts[:, None, None]

    ctx = (torch.tensor(0.3),)
    if mode == "fast":
        plan = kw["fast_plan"]
        ref = fastdpm.fast_sampling(lambda x, ts: denoise_apply(ctx, x, ts), (B, N, 3), plan,
                                    device="cpu", generator=_gen(8))
        got = fastdpm.make_segmented_fast_sampler(denoise_apply, plan, segment)(
            ctx, (B, N, 3), device="cpu", generator=_gen(8))
    else:
        seg_kw = dict(kw, XT=call.get("XT"))
        ref = ddpm.sampling(lambda x, ts: denoise_apply(ctx, x, ts), (B, N, 3), schedule,
                            device="cpu", generator=_gen(8), **seg_kw)
        got = ddpm.make_segmented_sampler(denoise_apply, schedule, segment,
                                          t_slices=kw.get("t_slices"))(
            ctx, (B, N, 3), device="cpu", generator=_gen(8), XT=call.get("XT"),
            warm_start_step=kw.get("warm_start_step"))
        if mode == "slices":
            assert all(torch.equal(got[1][t], ref[1][t]) for t in (3, 0))
            ref, got = ref[0], got[0]
    assert torch.equal(got, ref)


def test_segment_size_must_be_positive():
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.05)
    with pytest.raises(ValueError, match="segment_size"):
        ddpm.make_segmented_sampler(lambda c, x, ts: x, schedule, 0)
    with pytest.raises(ValueError, match="segment_size"):
        fastdpm.make_segmented_fast_sampler(
            lambda c, x, ts: x, make_fast_sampling_plan(schedule, T, 1e-4, 0.05, length=3), 0)


@pytest.fixture(scope="module")
def jax_segmented(model):
    """The JAX package's make_coarse_sampler(segment_size=3) on the port's
    weights, run once: its x0, its t-slices and its noise stream."""
    import jax
    import jax.numpy as jnp
    from point_diffusion_refinement_tpu import diffusion as j_diff
    from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
    from point_diffusion_refinement_tpu.sample import generate as j_gen
    from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
    from test_torch_sampling import jax_noise_stream

    jm = JaxModel.from_config(tiny_pointnet_config())
    params = state_dict_to_flax(model.state_dict())
    cond, label = _condition(3)
    key = jax.random.key(11)
    sampler = j_gen.make_coarse_sampler(jm, j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.02), N,
                                        t_slices=(2,), segment_size=3)
    x0, slices = sampler(params, key, jnp.asarray(cond.numpy()), jnp.asarray(label.numpy()))
    x_T, noise = jax_noise_stream(key, (B, N, 3), T)
    return (np.asarray(x0, np.float32), np.asarray(slices[2], np.float32), np.array(x_T),
            np.array(noise))


def test_segmented_matches_jax(model, jax_segmented):
    ref, ref_slice, x_T, noise = jax_segmented
    cond, label = _condition(3)
    sampler = make_coarse_sampler(model, calc_diffusion_hyperparams(T, 1e-4, 0.02), N,
                                  t_slices=(2,), segment_size=3)
    out, slices = sampler(cond, label, x_T=torch.from_numpy(x_T),
                          noise=torch.from_numpy(noise))
    assert out.shape == (B, N, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    np.testing.assert_allclose(slices[2].numpy(), ref_slice, **F32_TOL)


def _generation_config(root):
    pc = {**tiny_pointnet_config(), "model_name": "tiny", "compute_dtype": "float32"}
    return {
        "diffusion_config": {"T": 8, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": pc,
        "train_config": {"task": "completion", "root_directory": str(root)},
        "mvp_dataset_config": {"data_dir": str(root), "npoints": N, "scale": 1,
                               "eval_batch_size": 4},
    }


def _saved(base):
    out = {}
    for dp, _, files in os.walk(base):
        for f in files:
            path = os.path.join(dp, f)
            rel = os.path.relpath(path, base)
            if f.endswith(".pkl"):
                with open(path, "rb") as fh:
                    out[rel] = pickle.load(fh)
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_run_generation_segment_size(model, tmp_path):
    """Ten clouds in batches of 4 (the last batch takes a second graph on
    the card): the same clouds, metrics and files with segments of 3 steps
    as with the whole schedule in one."""
    cfg = _generation_config(tmp_path)
    data = synthetic_dataset(10, npoints=N, partial_points=64, seed=4, mirror_to=M)
    runs = {}
    for seg in (3, None):
        base = tmp_path / f"seg_{seg}"
        (res,) = run_generation(cfg, state_override=model, dataset_override=data,
                                base_save_dir=str(base), segment_size=seg, device="cpu",
                                keep_generated=True, compute_emd=False)
        runs[seg] = (res, _saved(base))
    (a, files_a), (b, files_b) = runs[3], runs[None]
    assert a.generated.shape == (10, N, 3) and np.isfinite(a.generated).all()
    np.testing.assert_array_equal(a.generated, b.generated)
    for k in a.metrics:
        np.testing.assert_array_equal(a.metrics[k], b.metrics[k])
    assert files_a.keys() == files_b.keys() and len(files_a) >= 1
    for k in files_a:
        if k.endswith(".pkl"):
            assert files_a[k]["avg_cd"] == files_b[k]["avg_cd"]
            for m in files_a[k]["metrics"]:
                np.testing.assert_array_equal(files_a[k]["metrics"][m], files_b[k]["metrics"][m])
        else:
            assert files_a[k] == files_b[k]


def test_captured_function_on_cpu_and_other_devices():
    """CPU tensors run the function eagerly and capture nothing; a device
    other than CUDA raises rather than run anywhere else."""
    calls = []

    def fn(x, pair, k):
        calls.append(k)
        return x * pair[0] + pair[1] * k

    cf = CapturedFunction(fn)
    x = torch.arange(4.0)
    for k in (2.0, 3.0):
        assert torch.equal(cf(x, (x, 1.0), k), x * x + k)
    assert calls == [2.0, 3.0] and cf.num_graphs == 0 and cf.stats() == []
    with cf:
        pass
    with pytest.raises(ValueError, match="one CUDA device"):
        cf(torch.empty(2, device="meta"), (x, 1.0), 2.0)


@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 24, 12), (2, 12, 24)])
def test_approx_match_matches_jax(shape):
    import jax.numpy as jnp
    from point_diffusion_refinement_tpu import ops as j_ops

    b, n, m = shape
    rng = np.random.default_rng(n + m)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    y = rng.standard_normal((b, m, 3)).astype(np.float32)
    ref = np.asarray(j_ops.approx_match(jnp.asarray(x), jnp.asarray(y)), np.float32)
    got = approx_match(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (b, m, n)
    np.testing.assert_allclose(got.numpy(), ref, **EMD_TOL)


# ---- on the card ----------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_graphed_sampler_equals_eager_on_card(dev, fast):
    from point_diffusion_refinement_tpu_torch import ops

    net = PointNet2CloudCondition.from_config(tiny_pointnet_config(), device=dev, seed=5)
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.05)
    kw = dict(fast_plan=make_fast_sampling_plan(schedule, T, 1e-4, 0.05, length=4)) if fast \
        else dict(t_slices=(3,))
    cond, label = (t.to(dev) for t in _condition(1))
    runs = {}
    for seg in (None, 2):
        sampler = make_coarse_sampler(net, schedule, N, segment_size=seg, **kw)
        gen = torch.Generator(device=dev).manual_seed(9)
        ops.reset_launch_counts()
        out = sampler(cond, label, generator=gen)
        torch.cuda.synchronize()
        runs[seg] = (out, ops.launch_counts())
    (ref, ref_counts), (got, got_counts) = runs[None], runs[2]
    if not fast:
        assert torch.equal(got[1][3], ref[1][3])
        ref, got = ref[0], got[0]
    assert torch.equal(got, ref)
    assert got_counts == ref_counts and ref_counts["fps"] > 0


@pytest.mark.cuda
def test_graphed_refiner_equals_eager_on_card(dev):
    from point_diffusion_refinement_tpu_torch import ops

    pc = dict(tiny_pointnet_config(include_t=False), point_upsample_factor=2,
              include_displacement_center_to_final_output=False)
    net = PointNet2CloudCondition.from_config(pc, device=dev, seed=6)
    refine = make_refiner(net, 2)
    graphed = CapturedFunction(refine)
    cond, label = (t.to(dev) for t in _condition(2))
    coarse = torch.randn(B, N, 3, generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    ops.reset_launch_counts()
    ref = refine(coarse, cond, label, 0.001)
    ref_counts = ops.launch_counts()
    outs = []
    for _ in range(3):  # warm-up, capture and replay, replay
        ops.reset_launch_counts()
        outs.append(graphed(coarse, cond, label, 0.001))
        assert ops.launch_counts() == ref_counts
    torch.cuda.synchronize()
    assert graphed.num_graphs == 1 and graphed.stats()[0]["capture_ms"] > 0
    assert all(torch.equal(o, ref) for o in outs)
    graphed.release()
    assert graphed.num_graphs == 0
