"""The port's small dense algebra against the JAX package's, in f64.

Procrustes (three solvers), HALS and ridge solves, column normalisation,
the CP-ALS factor update and the dense CP-ALS reference,
the mode-2 scatter, the SPARTan bucket modes, the staged-kernel oracles and
the constraint bundle: same numpy inputs through both, within 1e-12. The
polar factor is compared at well-conditioned B only (it is not unique at a
singular B_k).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import constraints as j_cst  # noqa: E402
from repro.core import spartan as j_spartan  # noqa: E402
from repro.core import cp as j_cp  # noqa: E402
from repro.core.cp import normalize_columns as j_normalize_columns  # noqa: E402
from repro.core.nnls import hals_nnls as j_hals, ridge_solve as j_ridge  # noqa: E402
from repro.core.procrustes import solve_q as j_solve_q  # noqa: E402
from repro.kernels import common as j_common, ref as j_ref  # noqa: E402
from repro_torch.core import constraints as cst, spartan  # noqa: E402
from repro_torch.core import cp  # noqa: E402
from repro_torch.core.cp import normalize_columns  # noqa: E402
from repro_torch.core.irregular import scatter_order  # noqa: E402
from repro_torch.core.nnls import hals_nnls, ridge_solve  # noqa: E402
from repro_torch.core.procrustes import solve_q  # noqa: E402
from repro_torch.kernels import common, ref  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _close(port, refv, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(refv), **(tol or TOL))


@pytest.mark.parametrize("method", ["gram_eigh", "svd", "newton_schulz"])
def test_solve_q_matches(method):
    B = np.random.default_rng(0).standard_normal((6, 9, 5))
    _close(solve_q(_t(B), method), j_solve_q(_j(B), method))


def test_solve_q_padded_subjects_give_zero():
    B = np.random.default_rng(1).standard_normal((4, 7, 3))
    B[2] = 0.0
    Q = solve_q(_t(B))
    assert torch.isfinite(Q).all() and float(Q[2].abs().max()) == 0.0
    _close(Q, j_solve_q(_j(B)))
    np.testing.assert_allclose((Q[0].T @ Q[0]).numpy(), np.eye(3), atol=1e-12)
    with pytest.raises(ValueError, match="unknown procrustes"):
        solve_q(_t(B), "qr")


@pytest.mark.parametrize("seed", [0, 1])
def test_hals_nnls_matches(seed):
    rng = np.random.default_rng(seed)
    G = rng.random((30, 5))
    T = rng.random((40, 30))
    M, A, X0 = T @ G, G.T @ G, rng.standard_normal((40, 5))
    X0_t = _t(X0)
    got = hals_nnls(_t(M), _t(A), X0_t, sweeps=5)
    _close(got, j_hals(_j(M), _j(A), _j(X0), sweeps=5))
    assert float(got.min()) >= 0.0
    np.testing.assert_array_equal(X0_t.numpy(), X0)        # warm start untouched


def test_ridge_solve_matches_and_degenerate_gram_floor():
    rng = np.random.default_rng(2)
    G = rng.standard_normal((20, 4))
    M, A = rng.standard_normal((7, 4)), G.T @ G
    _close(ridge_solve(_t(M), _t(A)), j_ridge(_j(M), _j(A)))
    # a collapsed Gram gives X == 0, not NaN, in both packages
    Z = np.zeros((4, 4))
    _close(ridge_solve(_t(M), _t(Z)), j_ridge(_j(M), _j(Z)))
    assert torch.isfinite(ridge_solve(_t(M), _t(Z))).all()
    Z32 = torch.zeros((4, 4), dtype=torch.float32)
    assert torch.isfinite(ridge_solve(torch.ones((3, 4)), Z32)).all()


def test_normalize_columns_matches():
    X = np.random.default_rng(3).standard_normal((11, 5))
    X[:, 2] = 0.0
    (a, na), (b, nb) = normalize_columns(_t(X)), j_normalize_columns(_j(X))
    _close(a, b)
    _close(na, nb)


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 4, 1), (9, 16, 6), (64, 40, 3)])
def test_mode2_scatter_matches_and_is_deterministic(shape):
    Kb, C, R = shape
    J = 23
    rng = np.random.default_rng(Kb)
    A = rng.standard_normal(shape)
    cols = rng.integers(0, J, (Kb, C)).astype(np.int32)
    cols_t = torch.tensor(cols)
    got = spartan.mode2_scatter(_t(A), cols_t, J)
    _close(got, j_spartan.mode2_scatter(_j(A), jnp.asarray(cols), J))
    again = spartan.mode2_scatter(_t(A), cols_t, J, order=scatter_order(cols_t, J))
    assert got.numpy().tobytes() == again.numpy().tobytes()
    # padding entries (mask 0, compact rows exactly 0) may be left out
    mask = rng.random((Kb, C)) > 0.4
    A_masked = _t(A * mask[..., None])
    _close(spartan.mode2_scatter(A_masked, cols_t, J,
                                 order=scatter_order(cols_t, J, _t(mask))),
           j_spartan.mode2_scatter(_j(A * mask[..., None]), jnp.asarray(cols), J))
    f32 = spartan.mode2_scatter(torch.tensor(A, dtype=torch.float32), cols_t, J)
    assert f32.dtype == torch.float32


def test_spartan_modes_match():
    rng = np.random.default_rng(4)
    Kb, R, C = 6, 4, 9
    Yc, Vg, Wb = (rng.standard_normal(s) for s in ((Kb, R, C), (Kb, C, R), (Kb, R)))
    H, cm = rng.standard_normal((R, R)), (rng.random((Kb, C)) > 0.3).astype(float)
    sm = np.array([1, 1, 0, 1, 1, 0], float)
    _close(spartan.mode1_bucket(_t(Yc), _t(Vg), _t(Wb), _t(sm)),
           j_spartan.mode1_bucket(_j(Yc), _j(Vg), _j(Wb), _j(sm)))
    _close(spartan.mode2_bucket_compact(_t(Yc), _t(H), _t(Wb), _t(cm), _t(sm)),
           j_spartan.mode2_bucket_compact(_j(Yc), _j(H), _j(Wb), _j(cm), _j(sm)))
    _close(spartan.mode3_bucket(_t(Yc), _t(Vg), _t(H), _t(sm)),
           j_spartan.mode3_bucket(_j(Yc), _j(Vg), _j(H), _j(sm)))


def test_kernel_oracles_match():
    rng = np.random.default_rng(5)
    K, R, C = 5, 3, 8
    Yc, Vg, Wb, H = (rng.standard_normal(s) for s in ((K, R, C), (K, C, R), (K, R), (R, R)))
    YkV = rng.standard_normal((K, R, R))
    for name, args in [("ykv_ref", (Yc, Vg)), ("mode1_ref", (Yc, Vg, Wb)),
                       ("mode1_reuse_ref", (YkV, Wb)), ("mode2_compact_ref", (Yc, H, Wb)),
                       ("mode3_ref", (Yc, Vg, H)), ("mode3_reuse_ref", (YkV, H))]:
        _close(getattr(ref, name)(*map(_t, args)), getattr(j_ref, name)(*map(_j, args)))
    vals = rng.standard_normal((K, 4, 2, 16))
    blk = rng.integers(0, 3, (K, 2)).astype(np.int32)
    V = rng.standard_normal((48, R))
    _close(ref.gather_matmul_ref(_t(vals), torch.tensor(blk), _t(V)),
           j_ref.gather_matmul_ref(_j(vals), jnp.asarray(blk), _j(V)))


def test_accumulation_policy_matches():
    for tdt, jdt in [(torch.float64, jnp.float64), (torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
                     (torch.int32, jnp.int32)]:
        assert str(common.accum_dtype(tdt)).removeprefix("torch.") == \
            str(j_common.accum_dtype(jdt))
    Wb, sm = np.random.default_rng(6).standard_normal((4, 3)), np.array([1, 0, 1, 0.0])
    _close(common.fold_subject_mask(_t(Wb), _t(sm)),
           j_common.fold_subject_mask(_j(Wb), _j(sm)))


def test_default_constraint_bundle():
    specs = {"v": "nonneg", "w": "nonneg"}
    port, refb = cst.bundle(specs), j_cst.bundle(specs)
    for m in cst.MODES:
        assert port[m].spec == refb[m].spec
        assert port[m].solver == refb[m].solver
        assert port[m].nonneg == refb[m].nonneg
        assert port[m].penalized == refb[m].penalized
    assert cst.constraint_summary(specs) == j_cst.constraint_summary(specs)
    assert cst.parse_spec("nonneg+none").spec == j_cst.parse_spec("nonneg+none").spec
    rng = np.random.default_rng(7)
    G = rng.random((12, 3))
    M, A, prev = G.T @ G @ np.eye(3) + 1.0, G.T @ G, rng.random((3, 3))
    for m in ("h", "v"):
        want, _ = refb[m].update(_j(M), _j(A), _j(prev), ())
        got, aux = port[m].update(_t(M), _t(A), _t(prev), ())
        _close(got, want)
        assert aux == ()
    for spec in ("l1:0.1", "smooth", "nonneg_admm", "nonneg+l1:0.1"):
        assert cst.parse_spec(spec).spec == j_cst.parse_spec(spec).spec
        assert cst.parse_spec(spec).admm and j_cst.parse_spec(spec).admm
    with pytest.raises(ValueError, match="unknown constraint"):
        cst.parse_spec("sparsemax")
    with pytest.raises(ValueError, match="mode"):
        cst.bundle({"q": "none"})


@pytest.mark.parametrize("nonneg", [False, True])
def test_factor_update_matches(nonneg):
    rng = np.random.default_rng(11)
    M, prev = rng.standard_normal((9, 4)), np.abs(rng.standard_normal((9, 4)))
    F = rng.standard_normal((12, 4))
    gram = F.T @ F
    np.testing.assert_allclose(
        cp.factor_update(_t(M), _t(gram), _t(prev), nonneg=nonneg).numpy(),
        np.asarray(j_cp.factor_update(_j(M), _j(gram), _j(prev), nonneg=nonneg)), **TOL)


@pytest.mark.parametrize("nonneg", [False, True])
def test_cp_als_dense_matches_with_the_reference_init(nonneg, monkeypatch):
    """The dense CP-ALS reference from the reference's own initial factors
    (``jax.random`` bits, injected through ``init_factors``): every factor
    and the weights within 1e-12 after 6 iterations."""
    import jax

    rng = np.random.default_rng(3)
    X = rng.standard_normal((6, 5, 4))
    X = np.abs(X) if nonneg else X
    rank, seed = 3, 2
    want = j_cp.cp_als_dense(_j(X), rank, iters=6, nonneg=nonneg, seed=seed,
                             dtype=jnp.float64)
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    draw = jax.random.uniform if nonneg else jax.random.normal
    U0, V0 = (np.asarray(draw(k, (n, rank), jnp.float64)) for k, n in ((k0, 6), (k1, 5)))
    monkeypatch.setattr(cp, "init_factors", lambda *a, **kw: (_t(U0), _t(V0)))
    got = cp.cp_als_dense(_t(X), rank, iters=6, nonneg=nonneg, seed=seed, dtype=torch.float64)
    assert isinstance(got, cp.CPState)
    for f in cp.CPState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), **TOL)


def test_init_factors_shapes_and_range():
    U, V = cp.init_factors(6, 5, 3, nonneg=True, seed=0, dtype=torch.float64)
    assert U.shape == (6, 3) and V.shape == (5, 3) and U.dtype == torch.float64
    assert bool((U >= 0).all() and (U < 1).all() and (V >= 0).all())
    assert torch.equal(cp.init_factors(6, 5, 3, nonneg=False, seed=4)[0],
                       cp.init_factors(6, 5, 3, nonneg=False, seed=4)[0])
