"""The port's fused attention pool against the JAX package's, on the CPU.

The same numpy-seeded inputs and the same weights (the port's ``state_dict``
converted by ``utils/weights.py``) go through the JAX ``AttentionPool`` on its
fused path (``PDR_FUSED_ATTENTION=1``, the Pallas kernels in interpret mode,
as ``tests/test_pallas_attention.py`` runs them) and through the port's
``AttentionPool(..., fused=True)``, which on CPU tensors runs the plain
version of the three sweeps.  Both sides round at the same places (bf16
products with float32 accumulation, bf16 GroupNorm affines, float32 softmax),
so they differ by float32 summation order and by the bf16 roundings that this
flips: rtol = atol = 2e-2, the JAX test's own tolerance for fused against
unfused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.models import attention as j_att
from point_diffusion_refinement_tpu.ops import pallas_attention as j_pa
from point_diffusion_refinement_tpu_torch.models import attention as t_att
from point_diffusion_refinement_tpu_torch.ops import attention_pool as t_pa
from point_diffusion_refinement_tpu_torch.utils.weights import (
    load_flax_params,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-2, atol=2e-2)

CASES = [
    # name, M, K, Cq, Ck, Cv, c_out, use_counts
    ("ft0", 128, 32, 4, 38, 32, 32, True),
    ("sa0", 64, 32, 35, 44, 32, 64, True),
    ("knnfp", 128, 8, 128, 166, 128, 128, False),
    ("tiny_m", 16, 32, 35, 38, 32, 32, True),
    ("wide_q", 64, 16, 70, 35, 64, 128, True),
    # more slots than a 64-row tile holds: a centre spans two tiles on the card
    ("k96", 12, 96, 35, 41, 32, 32, True),
    ("k96_all", 8, 96, 16, 44, 64, 64, False),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_(noise / max(p.shape[-1], 1) ** 0.5)
    return module.eval()


def _inputs(case, B=2):
    name, M, K, Cq, Ck, Cv, c_out, use_counts = case
    rng = np.random.default_rng(sum(map(ord, name)))
    feat = rng.standard_normal((B, M, Cq)).astype(np.float32)
    grouped = rng.standard_normal((B, M, K, Ck)).astype(np.float32)
    gfo = rng.standard_normal((B, M, K, Cv)).astype(np.float32)
    counts = rng.integers(0, K + 1, (B, M)).astype(np.int32) if use_counts else "all"
    if use_counts:
        counts[0, :2] = (0, K)  # an empty ball and a full one
    return feat, grouped, gfo, counts


def _port_pool(case, seed=3):
    _, M, K, Cq, Ck, Cv, c_out, _ = case
    return _randomize(t_att.AttentionPool(Cq, Ck, Cv, c_out, dtype=torch.bfloat16), seed)


def _port_apply(port, feat, grouped, gfo, counts, **kw):
    cnt = counts if isinstance(counts, str) else torch.from_numpy(counts)
    out = port(torch.from_numpy(feat), torch.from_numpy(grouped).to(torch.bfloat16),
               torch.from_numpy(gfo).to(torch.bfloat16), cnt, **kw)
    return out


def _jax_apply(port, case, feat, grouped, gfo, counts, fused):
    mod = j_att.AttentionPool(case[6], dtype=jnp.bfloat16)
    cnt = counts if isinstance(counts, str) else jnp.asarray(counts)
    out = mod.apply(state_dict_to_flax(port.state_dict()), jnp.asarray(feat),
                    jnp.asarray(grouped).astype(jnp.bfloat16),
                    jnp.asarray(gfo).astype(jnp.bfloat16), cnt, fused=fused)
    return np.asarray(jnp.asarray(out, jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_matches_jax_fused(case, monkeypatch):
    """Port fused (plain sweeps) == JAX fused (Pallas, interpret mode)."""
    monkeypatch.setenv("PDR_FUSED_ATTENTION", "1")
    data = _inputs(case)
    port = _port_pool(case)
    ref = _jax_apply(port, case, *data, fused=True)
    out = _port_apply(port, *data, fused=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.median(np.abs(out.numpy() - ref)) < 5e-3
    assert np.abs(ref).mean() > 1e-2


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_matches_own_unfused(case):
    """The fused path keeps float32 softmax weights where the unfused one
    rounds them to bf16, and returns float32 where it returns bf16."""
    data = _inputs(case)
    port = _port_pool(case)
    fused = _port_apply(port, *data, fused=True)
    unfused = _port_apply(port, *data)
    assert unfused.dtype == torch.bfloat16 and fused.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), unfused.float().numpy(), **TOL)


def test_function_signature_matches_jax(monkeypatch):
    """``fused_attention_pool`` called like the JAX function, with the
    sixteen parameter tensors in the JAX layout (kernels (in, out))."""
    case = CASES[4]
    _, M, K, Cq, Ck, Cv, c_out, _ = case
    feat, grouped, gfo, counts = _inputs(case)
    port = _port_pool(case, seed=5)
    p = state_dict_to_flax(port.state_dict())["params"]
    order = [("Dense_0", "kernel"), ("Dense_0", "bias"), ("Dense_1", "kernel"),
             ("Dense_1", "bias"), ("PartialGroupNorm_0", "scale"), ("PartialGroupNorm_0", "bias"),
             ("Dense_2", "kernel"), ("Dense_2", "bias"), ("PartialGroupNorm_1", "scale"),
             ("PartialGroupNorm_1", "bias"), ("Dense_3", "kernel"), ("Dense_3", "bias"),
             ("Dense_4", "kernel"), ("Dense_4", "bias"), ("PartialGroupNorm_2", "scale"),
             ("PartialGroupNorm_2", "bias")]

    def leaf(mod, name):
        node = p[mod]
        return node["GroupNorm_0"][name] if mod.startswith("Partial") else node[name]

    weights = [leaf(m, n) for m, n in order]
    widths = dict(c1=max(Cq, 32), c2=max(Ck, 32), c_out=c_out, K=K)
    widths["inter_c"] = min(widths["c1"] + widths["c2"], c_out)
    ref = j_pa.fused_attention_pool(
        jnp.asarray(feat), jnp.asarray(grouped).astype(jnp.bfloat16),
        jnp.asarray(gfo).astype(jnp.bfloat16), jnp.asarray(counts),
        *map(jnp.asarray, weights), interpret=True, **widths)
    args = (torch.from_numpy(feat), torch.from_numpy(grouped).to(torch.bfloat16),
            torch.from_numpy(gfo).to(torch.bfloat16), torch.from_numpy(counts))
    tw = [torch.from_numpy(np.asarray(w)) for w in weights]
    out = t_pa.fused_attention_pool(*args, *tw, **widths)
    plain = t_pa.fused_attention_pool_plain(*args, *tw, **widths)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())  # CPU tensors: the plain sweeps
    # and through the module, which keeps its prepared weights
    np.testing.assert_array_equal(_port_apply(port, feat, grouped, gfo, counts,
                                              fused=True).numpy(), out.numpy())


@pytest.mark.parametrize("num_groups,normed,c", [(32, 64, 64), (32, 64, 70), (20, 20, 20)])
def test_groupnorm_glue_matches_jax(num_groups, normed, c):
    rng = np.random.default_rng(normed + c)
    cnt = 4096.0 * (normed // num_groups)
    x = rng.standard_normal((3, 4096, normed)).astype(np.float32) * 2.0 + 0.5
    sum_c, ssq_c = x.sum(1), (x * x).sum(1)
    scale = (1.0 + 0.2 * rng.standard_normal(normed)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(normed)).astype(np.float32)
    ja = [jnp.asarray(a) for a in (sum_c, ssq_c, scale, bias)]
    ta = [torch.from_numpy(a) for a in (sum_c, ssq_c, scale, bias)]
    for got, ref in zip(t_pa._group_mul_add(*ta, cnt, num_groups),
                        j_pa._group_mul_add(*ja, cnt, num_groups)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    for got, ref in zip(t_pa._pgn_mu_s_b(*ta, cnt, num_groups, c),
                        j_pa._pgn_mu_s_b(*ja, cnt, num_groups, c)):
        assert tuple(got.shape) == (3, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


GLUE_SHAPES = [(32, 41, 32), (128, 41, 32), (35, 44, 64), (3, 171, 20)]


def _glue_case(c1, c2, c_out):
    """Numpy-seeded statistics, GroupNorm parameters and a query feature for
    the finishing glue at widths (c1, c2, c_out), and the port's prepared
    weights holding them."""
    B, M, K, Cq, inter_c = 2, 24, 8, 5, 48
    rng = np.random.default_rng(c1 + c2)
    feat = rng.standard_normal((B, M, Cq)).astype(np.float32)
    w0 = (rng.standard_normal((Cq, c1)) / Cq ** 0.5).astype(np.float32)
    b0 = (0.1 * rng.standard_normal(c1)).astype(np.float32)
    rows = M * K

    def stats(c, centre):
        x = rng.standard_normal((B, rows, c)).astype(np.float32) + centre
        return np.stack([x.sum(1), (x * x).sum(1)], 1).astype(np.float32)

    kst, vst, hst = stats(c2, 0.3), stats(c_out, -0.2), stats(inter_c, 0.1)
    ng0 = min(32, c1 + c2)
    normed0 = (c1 + c2) - (c1 + c2) % ng0

    def gn(n):
        return ((1.0 + 0.2 * rng.standard_normal(n)).astype(np.float32),
                (0.1 * rng.standard_normal(n)).astype(np.float32))

    gn0, gn1, gn2 = gn(normed0), gn(inter_c - inter_c % min(32, inter_c)), gn(
        c_out - c_out % min(32, c_out))
    p = t_pa.prepare_attention_weights(
        torch.from_numpy(w0), torch.from_numpy(b0), torch.zeros(4, c2), torch.zeros(c2),
        *map(torch.from_numpy, gn0), torch.zeros(c1 + c2, inter_c), torch.zeros(inter_c),
        *map(torch.from_numpy, gn1), torch.zeros(inter_c, c_out), torch.zeros(c_out),
        torch.zeros(4, c_out), torch.zeros(c_out), *map(torch.from_numpy, gn2), c1=c1)
    return dict(B=B, M=M, K=K, inter_c=inter_c, feat=feat, w0=w0, b0=b0, kst=kst, vst=vst,
                hst=hst, gn0=gn0, gn1=gn1, gn2=gn2, p=p)


def _jax_glue(case, c1, c2, c_out):
    """The JAX package's glue between its sweeps
    (ops/pallas_attention.py::fused_attention_pool) on the case's statistics:
    q's sums, mul_q / add_q, qn, mul_k / add_k, the values' and h's (mu, s,
    b)."""
    B, M, K, inter_c = case["B"], case["M"], case["K"], case["inter_c"]
    kst, vst, hst, gn0, gn1, gn2 = (case[k] for k in ("kst", "vst", "hst", "gn0", "gn1", "gn2"))
    rows = M * K
    ng0 = min(32, c1 + c2)
    normed0 = len(gn0[0])
    bf = jnp.bfloat16
    qd = jnp.maximum(j_pa._dense(jnp.asarray(case["feat"]).astype(bf),
                                 jnp.asarray(case["w0"]).astype(bf),
                                 jnp.asarray(case["b0"]).astype(bf)), 0)
    qf = qd.astype(jnp.float32)
    q_sum, q_ssq = jnp.sum(qf, 1), jnp.sum(qf * qf, 1)
    sum_c = jnp.concatenate([q_sum * float(K), kst[:, 0]], -1)[:, :normed0]
    ssq_c = jnp.concatenate([q_ssq * float(K), kst[:, 1]], -1)[:, :normed0]
    mul0, add0 = j_pa._group_mul_add(sum_c, ssq_c, *gn0, float(rows) * (normed0 // ng0), ng0)
    nq = min(c1, normed0)
    mul_q = jnp.concatenate([mul0[:, :nq], jnp.ones((B, c1 - nq))], -1)
    add_q = jnp.concatenate([add0[:, :nq], jnp.zeros((B, c1 - nq))], -1)
    nk = normed0 - nq
    mul_k = jnp.concatenate([mul0[:, nq:], jnp.ones((B, c2 - nk))], -1)
    add_k = jnp.concatenate([add0[:, nq:], jnp.zeros((B, c2 - nk))], -1)
    qn = (qf * mul_q[:, None, :] + add_q[:, None, :]).astype(bf)
    ng2, normed2 = min(32, c_out), len(gn2[0])
    ref2 = j_pa._pgn_mu_s_b(vst[:, 0, :normed2], vst[:, 1, :normed2], *gn2,
                            float(rows) * (normed2 // ng2), ng2, c_out)
    ng1, normed1 = min(32, inter_c), len(gn1[0])
    ref1 = j_pa._pgn_mu_s_b(hst[:, 0, :normed1], hst[:, 1, :normed1], *gn1,
                            float(rows) * (normed1 // ng1), ng1, inter_c)
    return dict(q_sum=q_sum, q_ssq=q_ssq, mul_q=mul_q, add_q=add_q, mul_k=mul_k, add_k=add_k,
                qn=np.asarray(qn.astype(jnp.float32)), gn2=ref2, gn1=ref1)


GLUE_CLOSE = dict(rtol=1e-5, atol=1e-5)  # float32 sums in another order


def _qn_close(got, ref):
    """bf16 query rows: a float32 multiply-add a few ulp apart may round the
    other way, 2^-8 of a value, in under 1% of them."""
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2, atol=1e-2)
    assert np.mean(got.float().numpy() == ref) > 0.99


@pytest.mark.parametrize("c1,c2,c_out", GLUE_SHAPES)
def test_finishing_glue_matches_jax(c1, c2, c_out):
    """The plain counterparts of the two finishing kernels (the first
    GroupNorm over [q, k] with the query rows, the values' and h's GroupNorm
    vectors) against the JAX package's glue between its sweeps, on the same
    statistics."""
    case = _glue_case(c1, c2, c_out)
    p, K = case["p"], case["K"]
    mm = torch.matmul(torch.from_numpy(case["feat"]).to(torch.bfloat16), p.w0)
    qn, mul_k, add_k, (mu2, s2, bb2) = t_pa._finish_stats_plain(
        mm, torch.from_numpy(case["kst"]), torch.from_numpy(case["vst"]), p, c1, c2, c_out, K)
    mu1, s1, bb1 = t_pa._finish_h_plain(torch.from_numpy(case["hst"]), p, case["inter_c"],
                                        case["M"], K)
    ref = _jax_glue(case, c1, c2, c_out)
    np.testing.assert_allclose(mul_k.numpy(), np.asarray(ref["mul_k"]), **GLUE_CLOSE)
    np.testing.assert_allclose(add_k.numpy(), np.asarray(ref["add_k"]), **GLUE_CLOSE)
    _qn_close(qn, ref["qn"])
    for got, want in zip((mu2, s2, bb2, mu1, s1, bb1), (*ref["gn2"], *ref["gn1"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GLUE_CLOSE)


@pytest.mark.parametrize("c1,c2,c_out", GLUE_SHAPES)
def test_split_finish_matches_jax(c1, c2, c_out):
    """The card's order of the finishing after sweep 1, in plain versions:
    sweep 1's q sums (``attention_qsums_plain``), its finish
    (``_stats_vectors_plain``: q's and k's (mul, add), the values' vectors)
    and the query-row pass (``attention_qn_plain``), against the JAX
    package's ``_group_mul_add`` glue on the same statistics."""
    case = _glue_case(c1, c2, c_out)
    p, M, K = case["p"], case["M"], case["K"]
    mm = torch.matmul(torch.from_numpy(case["feat"]).to(torch.bfloat16), p.w0)
    qst = t_pa.attention_qsums_plain(mm, p.b0)
    mul_q, add_q, mul_k, add_k, gn2 = t_pa._stats_vectors_plain(
        torch.from_numpy(case["kst"]), torch.from_numpy(case["vst"]), qst, p, c1, c2, c_out, M, K)
    qn = t_pa.attention_qn_plain(mm, p.b0, mul_q, add_q)
    ref = _jax_glue(case, c1, c2, c_out)
    assert tuple(qst.shape) == (case["B"], 2, c1) and qn.dtype == torch.bfloat16
    np.testing.assert_allclose(qst[:, 0].numpy(), np.asarray(ref["q_sum"]), **GLUE_CLOSE)
    np.testing.assert_allclose(qst[:, 1].numpy(), np.asarray(ref["q_ssq"]), **GLUE_CLOSE)
    for name, got in (("mul_q", mul_q), ("add_q", add_q), ("mul_k", mul_k), ("add_k", add_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]), **GLUE_CLOSE)
    _qn_close(qn, ref["qn"])
    for got, want in zip(gn2, ref["gn2"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GLUE_CLOSE)


@pytest.mark.parametrize("case", [CASES[i] for i in (0, 2, 4, 5)],
                         ids=[IDS[i] for i in (0, 2, 4, 5)])
def test_kernel_order_matches_plain_pool(case):
    """``_pool_kernels`` on CPU tensors runs each step's plain version in the
    card's order (``feat W0`` first, sweep 1 with its finish, the query-row
    pass, sweep 2 with its finish, sweep 3): bit-equal to ``_pool_plain``,
    the first design's order, since the plain pieces repeat its operations."""
    _, M, K, Cq, Ck, Cv, c_out, _ = case
    feat, grouped, gfo, counts = _inputs(case)
    port = _port_pool(case)
    p, w = port._fused_weights(), port.widths
    args = (torch.from_numpy(feat), torch.from_numpy(grouped).to(torch.bfloat16),
            torch.from_numpy(gfo).to(torch.bfloat16),
            None if isinstance(counts, str) else torch.from_numpy(counts), p,
            w["c1"], w["c2"], w["inter_c"], w["c_out"], K)
    got = t_pa._pool_kernels(*args)
    ref = t_pa._pool_plain(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, M, c_out)
    assert torch.equal(got, ref)


class TestRouting:
    """Which calls reach the fused function."""

    @pytest.fixture
    def calls(self, monkeypatch):
        seen = []
        real = t_att.fused_attention_pool

        def spy(*a, **kw):
            seen.append(kw["K"])
            return real(*a, **kw)

        monkeypatch.setattr(t_att, "fused_attention_pool", spy)
        return seen

    def _pool(self, dtype=torch.bfloat16, **flags):
        return _randomize(t_att.AttentionPool(8, 12, 32, 32, dtype=dtype, **flags), 1)

    def _data(self, dtype):
        rng = np.random.default_rng(0)
        return (torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((2, 16, 8, 12)).astype(np.float32)).to(dtype),
                torch.from_numpy(rng.standard_normal((2, 16, 8, 32)).astype(np.float32)).to(dtype))

    def test_fused_taken(self, calls):
        out = self._pool()(*self._data(torch.bfloat16), "all", fused=True)
        assert calls == [8] and out.dtype == torch.float32

    def test_default_is_unfused(self, calls):
        out = self._pool()(*self._data(torch.bfloat16), "all")
        assert calls == [] and out.dtype == torch.bfloat16

    def test_float32_stays_unfused(self, calls):
        pool = self._pool(dtype=None)
        data = self._data(torch.float32)
        a, b = pool(*data, "all"), pool(*data, "all", fused=True)
        assert calls == [] and torch.equal(a, b)

    @pytest.mark.parametrize("flag", ["attention_bn", "transform_grouped_feat_out",
                                      "last_activation"])
    def test_a_flag_off_stays_unfused(self, calls, flag):
        pool = self._pool(**{flag: False})
        data = self._data(torch.bfloat16)
        a, b = pool(*data, "all"), pool(*data, "all", fused=True)
        assert calls == [] and torch.equal(a, b)

    def test_key_pre_stays_unfused(self, calls):
        pool = self._pool()
        data = self._data(torch.bfloat16)
        key_pre = pool.Dense_1(data[1])
        hk = torch.relu(key_pre).float()
        stats = (hk.sum(dim=(1, 2)), (hk * hk).sum(dim=(1, 2)))
        ref = pool(*data, "all")
        out = pool(*data, "all", fused=True, key_pre=key_pre, key_stats=stats)
        assert calls == [] and out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                                   rtol=2.0 ** -7, atol=1e-2)

    def test_parameters_unchanged(self, calls):
        """Same state_dict keys with and without ``fused``, and the JAX fused
        path's own parameter tree loads through ``utils/weights.py`` as is."""
        pool = self._pool()
        keys = list(pool.state_dict())
        data = self._data(torch.bfloat16)
        pool(*data, "all", fused=True)
        assert list(pool.state_dict()) == keys
        assert keys == list(self._pool().state_dict())
        mod = j_att.AttentionPool(32, dtype=jnp.bfloat16)
        jd = [jnp.asarray(t.float().numpy()) for t in data]
        tree = mod.init(jax.random.key(0), jd[0], jd[1].astype(jnp.bfloat16),
                        jd[2].astype(jnp.bfloat16), "all", fused=True)
        load_flax_params(pool, jax.tree_util.tree_map(np.asarray, tree))

    def test_prepared_weights_follow_updates(self, calls):
        pool = self._pool()
        data = self._data(torch.bfloat16)
        a = pool(*data, "all", fused=True)
        with torch.no_grad():
            pool.Dense_3.weight.mul_(0.5)
        b = pool(*data, "all", fused=True)
        fresh = self._pool()
        with torch.no_grad():
            fresh.Dense_3.weight.mul_(0.5)
        assert not torch.equal(a, b)
        assert torch.equal(b, fresh(*data, "all", fused=True))


def test_kernel_takes_no_cpu_prepared_weights():
    """Weights prepared on the CPU carry no kernel layout."""
    w = t_pa._layer(torch.randn(5, 7), torch.randn(7))
    assert w.wt is None and w.bp is None and w.w.dtype == torch.bfloat16
