"""The port's constraint layer (AO-ADMM, l1, smooth), ridge, bucketed W and
the loose ends of the ported modules against the JAX package, on the CPU
in f64.

Module by module, on the same numpy-made inputs: the spec grammar (canonical
strings and errors equal to the reference's), each prox and ``admm_solve``
within 1e-12 (``prox_smooth``, P2's plain version, within 1e-12 of max |Z|
against ``lax.linalg.tridiagonal_solve``), the whole-tensor MTTKRP helpers,
``reconstruct_uk``, the dense-Y baseline step and ``interpret`` within 1e-12
(relative for the baseline). Then the slice as a whole: choa_like(0.002),
rank 5, 20 iterations from the reference's state0 (duals and bucketed W
carried over by ``convert.state_from_arrays``), the host fit history within
1e-8 of the reference's host engine on the torch, fused, staged and scoo
routes, for ADMM nonneg with global and bucketed W, nonneg+l1 on V with
smooth on W, and the default bundle with a ridge; the port's scan
(check_every 4) and while engines bit for bit its host engine there, the
duals carried. The reference is held at its host engine: its l1
monotone-sparsity claim and its mesh/smooth engine-parity tests do not hold
on this jax, so neither is an oracle here.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        fit as j_fit, init_state as j_init_state,
                        reconstruct_uk as j_reconstruct_uk, w_global as j_w_global)
from repro.core import baseline as j_baseline  # noqa: E402
from repro.core import constraints as j_cst  # noqa: E402
from repro.core import interpret as j_interpret  # noqa: E402
from repro.core.backend import get_backend as j_get_backend  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.launch import decompose as j_decompose  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro_torch.convert import state_from_arrays, state_to_arrays  # noqa: E402
from repro_torch.core import (Parafac2Options, bucketize, fit, init_state,  # noqa: E402
                              reconstruct_uk, w_global)
from repro_torch.core import baseline, engine, interpret  # noqa: E402
from repro_torch.core import constraints as cst  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import tridiag  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

ITERS = 20
F64 = torch.float64
# (constraints, options) of the fits held to the reference
CASES = {
    "admm-global": ({"v": "nonneg_admm", "w": "nonneg_admm"}, {}),
    "admm-bucketed": ({"v": "nonneg_admm", "w": "nonneg_admm"}, {"w_layout": "bucketed"}),
    "l1-smooth": ({"v": "nonneg+l1:0.1", "w": "smooth:0.1"}, {}),
    "ridge": (None, {"ridge": 1e-3}),
}
SPECS = ["", "none", "nonneg", "nonneg_admm", "l1", "l1:0.5", "l1:0", "smooth",
         "smooth:0.25", "smooth:0", "nonneg+l1:0.1", "l1:0.1+nonneg", "none+nonneg",
         "nonneg+none", " nonneg ", "none+none", "nonneg_admm+l1:2"]
BAD_SPECS = ["bogus", "nonneg:0.1", "none:1", "smooth+nonneg", "smooth:0.1+l1",
             "l1:x", "l1:-1"]
# every B_k of full column rank at rank 5, so the polar (and U_k) is unique
WELL_CONDITIONED = dict(n_subjects=24, n_cols=60, max_rows=30, min_rows=12,
                        avg_nnz_per_subject=150, seed=3)


def _arrays(s0) -> dict:
    """A reference state's H, V, W and aux as numpy (a bucketed W as a list)."""
    out = {k: jax.tree_util.tree_map(np.asarray, getattr(s0, k)) for k in ("H", "V", "W", "aux")}
    if isinstance(out["W"], tuple):
        out["W"] = list(out["W"])
    return out


def _state0(arrays):
    return state_from_arrays(arrays, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 buckets of choa_like(0.002), CC and SCOO."""
    j_data, t_data = j_choa_like(scale=0.002, seed=0), choa_like(scale=0.002, seed=0)
    return {fmt: dict(bj=j_bucketize(j_data, dtype=jnp.float64, format=fmt),
                      bt=bucketize(t_data, device="cpu", dtype=F64, format=fmt))
            for fmt in ("cc", "scoo")}


_REFERENCE = {}


def _reference(choa, case, fmt):
    """The reference's state0 and host fit history for ``case`` on the
    ``fmt`` buckets (jnp backend on CC, scoo on SCOO), made once."""
    key = (case, fmt)
    if key not in _REFERENCE:
        specs, kw = CASES[case]
        jopts = JOptions(rank=5, dtype=jnp.float64, constraints=specs,
                         backend="jnp" if fmt == "cc" else "scoo", **kw)
        bj = choa[fmt]["bj"]
        s0 = j_init_state(bj, jopts, seed=0)
        _, hist = j_fit(bj, jopts, max_iters=ITERS, tol=0.0, state=s0)
        _REFERENCE[key] = (_arrays(s0), np.asarray(hist))
    return _REFERENCE[key]


def _opts(case, backend="torch", **extra):
    specs, kw = CASES[case]
    return Parafac2Options(rank=5, dtype=F64, backend=backend, constraints=specs,
                           **kw, **extra)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    items = x.values() if isinstance(x, dict) else x
    return [t for v in items for t in _leaves(v)]


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert cst.available() == j_cst.available()
    assert cst.MODES == j_cst.MODES
    for name in cst.available():
        a, b = cst._REGISTRY[name], j_cst._REGISTRY[name]
        assert (a.kind, a.solver, a.default_lam, a.nonneg) == \
            (b.kind, b.solver, b.default_lam, b.nonneg), name


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    got, want = cst.parse_spec(spec), j_cst.parse_spec(spec)
    assert (got.spec, got.terms) == (want.spec, want.terms)
    for attr in ("solver", "admm", "nonneg", "smooth_lam", "penalized"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        j_cst.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        cst.parse_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arg", ["nonneg_admm", "v=nonneg+l1:0.1,w=smooth:0.1",
                                 "h=none, v = l1:0.3 ,", "w=smooth,nonneg", "",
                                 "V=nonneg_admm"])
def test_constraint_arg_and_summary_match_reference(arg):
    got, want = cst.parse_constraint_arg(arg), j_cst.parse_constraint_arg(arg)
    assert got == want
    assert cst.constraint_summary(got) == j_cst.constraint_summary(want)
    assert {m: c.spec for m, c in cst.bundle(got).items()} == \
        {m: c.spec for m, c in j_cst.bundle(want).items()}


@pytest.mark.parametrize("call", [
    lambda m: m.parse_constraint_arg("x=nonneg"),
    lambda m: m.parse_constraint_arg("v=bogus"),
    lambda m: m.bundle({"q": "nonneg"}),
])
def test_arg_and_bundle_errors_match_reference(call):
    with pytest.raises(ValueError) as want:
        call(j_cst)
    with pytest.raises(ValueError) as got:
        call(cst)
    assert str(got.value) == str(want.value)
    assert "registered constraints" in str(got.value) or "valid modes" in str(got.value)


def test_register_term_reaches_parsed_specs():
    """A registered custom term (its prox a plain callable) parses, routes
    to ADMM and does not compose; an override clears the parse cache."""
    try:
        cst.register_term("halve", cst.TermDef(kind="custom", solver="admm", default_lam=1.0,
                                               prox=lambda Y, rho, lam: Y * 0.5))
        c = cst.parse_spec("halve:2")
        assert (c.spec, c.admm, c.penalized) == ("halve:2", True, True)
        Y = torch.ones(3, 2, dtype=F64)
        assert torch.equal(c.prox(Y, torch.ones((), dtype=F64)), Y * 0.5)
        with pytest.raises(ValueError, match="do not compose"):
            cst.parse_spec("halve+nonneg")
        with pytest.raises(ValueError, match="needs a prox"):
            cst.register_term("broken", cst.TermDef(kind="custom", solver="admm"))
    finally:
        cst._REGISTRY.pop("halve", None)
        cst.parse_spec.cache_clear()
    with pytest.raises(ValueError, match="unknown constraint"):
        cst.parse_spec("halve")


# ---------------------------------------------------------------------------
# prox operators, P2's plain version and admm_solve
# ---------------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("t", [0.0, 0.3, 2.0])
def test_elementwise_prox_match_reference(t):
    Y = _rand((40, 5), 1)
    tt = torch.tensor(t, dtype=F64)
    for got, want in ((cst.prox_nonneg(torch.tensor(Y)), j_cst.prox_nonneg(jnp.asarray(Y))),
                      (cst.prox_l1(torch.tensor(Y), tt), j_cst.prox_l1(jnp.asarray(Y), t)),
                      (cst.prox_nonneg_l1(torch.tensor(Y), tt),
                       j_cst.prox_nonneg_l1(jnp.asarray(Y), t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("N", [1, 2, 3, 930, 4097])
@pytest.mark.parametrize("lam", [0.0, 0.1, 5.0])
def test_prox_smooth_matches_reference(N, lam):
    """P2's plain version through ``prox_smooth`` against the reference's
    ``lax.linalg.tridiagonal_solve``, within 1e-12 of max |Z|; N < 2 returns
    Y itself, as the reference does."""
    Y = _rand((N, 5), N)
    rho = 0.37
    got = cst.prox_smooth(torch.tensor(Y), torch.tensor(rho, dtype=F64), lam)
    want = np.asarray(j_cst.prox_smooth(jnp.asarray(Y), rho, lam))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-12 * np.max(np.abs(want))
    if N < 2:
        Yt = torch.tensor(Y)
        assert cst.prox_smooth(Yt, rho, lam) is Yt


def test_tridiag_plain_is_the_cpu_path_and_checks_its_operands():
    Y = torch.tensor(_rand((70, 3), 0))
    rho = torch.tensor(0.8, dtype=F64)
    tridiag.reset_launches()
    assert torch.equal(tridiag.tridiag_solve(Y, rho, 0.4), tridiag.tridiag_solve_plain(Y, rho, 0.4))
    assert tridiag.LAUNCHES["tridiag_solve"] == 0
    # the solve's residual: (rho I + 2 lam D^T D) Z = rho Y
    Z = tridiag.tridiag_solve_plain(Y, rho, 0.4)
    D = torch.diff(torch.eye(70, dtype=F64), dim=0)
    np.testing.assert_allclose(((0.8 * torch.eye(70, dtype=F64) + 0.8 * D.T @ D) @ Z).numpy(),
                               (0.8 * Y).numpy(), atol=1e-13)
    with pytest.raises(ValueError, match="N >= 2"):
        tridiag.tridiag_solve(Y[:1], rho, 0.4)
    with pytest.raises(TypeError, match="one-element tensor"):
        tridiag.tridiag_solve(Y, 0.8, 0.4)
    assert tridiag.tridiag_solve_plain(Y.float(), rho, 0.4).dtype == torch.float32


def _p2_reduce(a, b, c, d, bounds):
    """Steps 1 and 2 of csrc/tridiag.cu's partition method on each chunk
    (s, e) of ``bounds``: the chunks' reduced rows (a, b, c, d at 2j, 2j +
    1) and f, 1 / g, h of their rows for step 3."""
    n = len(bounds)
    ra, rb, rc, rd = np.zeros(2 * n), np.zeros(2 * n), np.zeros(2 * n), np.zeros((2 * n, d.shape[1]))
    f, gi, h = np.zeros(len(b)), np.zeros(len(b)), np.zeros(d.shape)
    for j, (s, e) in enumerate(bounds):
        fp, gp, hv = a[s + 1], b[s + 1], d[s + 1]
        f[s + 1], gi[s + 1], h[s + 1] = fp, 1 / gp, hv
        for i in range(s + 2, e + 1):
            k = a[i] * gi[i - 1]
            fp, gp, hv = -k * fp, b[i] - k * c[i - 1], d[i] - k * hv
            f[i], gi[i], h[i] = fp, 1 / gp, hv
        ra[2 * j + 1], rb[2 * j + 1], rc[2 * j + 1], rd[2 * j + 1] = fp, gp, c[e], hv
        if e == s + 1:
            beta, gamma, z = b[s], c[s], d[s]
        else:
            u, w, z = f[e - 1], c[e - 1], h[e - 1]
            for i in range(e - 2, s, -1):
                k = c[i] * gi[i + 1]
                u, w, z = f[i] - k * u, -k * w, h[i] - k * z
            k = c[s] * gi[s + 1]
            beta, gamma, z = b[s] - k * u, -k * w, d[s] - k * z
        ra[2 * j], rb[2 * j], rc[2 * j], rd[2 * j] = a[s], beta, gamma, z
    return (ra, rb, rc, rd), (f, gi, h)


def _p2_expand(c, f, gi, h, xr, bounds):
    """Step 3: each chunk's rows from its x_s and x_e (rows 2j, 2j + 1 of xr)."""
    x = np.zeros(h.shape)
    for j, (s, e) in enumerate(bounds):
        x[s], x[e] = xr[2 * j], xr[2 * j + 1]
        for i in range(e - 1, s, -1):
            x[i] = (h[i] - f[i] * x[s] - c[i] * x[i + 1]) * gi[i]
    return x


def _p2_one_launch(Y, rho, lam, ups):
    """The levels of csrc/tridiag.cu's one launch, in f64: level 0 in chunks
    of 32 rows (``chunk_rows``), level 1 in units of 16 chunks' rows, level
    2 in a block's ``ups`` units' rows, then chunks of 32 until at most 64
    rows remain, Thomas there."""
    N = len(Y)
    two_lam = 2 * lam
    a = np.full(N, -two_lam)
    a[0] = 0.0
    c = np.full(N, -two_lam)
    c[-1] = 0.0
    b = rho + two_lam * np.r_[1.0, np.full(N - 2, 2.0), 1.0]
    chunks = lambda n, P: [(j * n // P, (j + 1) * n // P - 1) for j in range(P)]  # noqa: E731
    P0 = -(-N // 32)
    levels = [(a, b, c, rho * Y, chunks(N, P0))]
    U = -(-P0 // 16)
    units = [(32 * u, 2 * min(16 * (u + 1), P0) - 1) for u in range(U)]
    blocks = [(2 * b * ups, 2 * min((b + 1) * ups, U) - 1) for b in range(-(-U // ups))]
    stash = []
    while True:
        a_, b_, c_, d_, bounds = levels[-1]
        if bounds is None:
            break
        sys_, keep = _p2_reduce(a_, b_, c_, d_, bounds)
        stash.append(keep)
        n = len(sys_[1])
        nxt = {1: units, 2: blocks}.get(len(levels), chunks(n, -(-n // 32)) if n > 64 else None)
        levels.append((*sys_, nxt))
    a_, b_, c_, d_, _ = levels[-1]
    x = np.zeros(d_.shape)                 # Thomas with the pivots' reciprocals
    cp, piv = np.zeros(len(b_)), np.zeros(len(b_))
    piv[0] = 1 / b_[0]
    cp[0] = c_[0] * piv[0]
    x[0] = d_[0] * piv[0]
    for i in range(1, len(b_)):
        piv[i] = 1 / (b_[i] - a_[i] * cp[i - 1])
        cp[i] = c_[i] * piv[i]
        x[i] = (d_[i] - a_[i] * x[i - 1]) * piv[i]
    for i in range(len(b_) - 2, -1, -1):
        x[i] = x[i] - cp[i] * x[i + 1]
    for (a_, b_, c_, d_, bounds), (f, gi, h) in zip(levels[-2::-1], stash[::-1]):
        x = _p2_expand(c_, f, gi, h, x, bounds)
    return x


@pytest.mark.parametrize("N,ups", [(65, 1), (1025, 1), (1025, 2), (20000, 1), (20000, 3)])
@pytest.mark.parametrize("lam", [0.1, 70.0])
def test_tridiag_one_launch_order_matches_plain(N, ups, lam):
    """P2's kernel order (csrc/tridiag.cu: level-0 chunks, level-1 units, a
    block's units (one, or several where the units outnumber a grid's
    blocks), level 3 in chunks of 32 past 64 rows (N = 20,000), Thomas,
    every division a multiplication by a reciprocal), emulated in f64,
    solves the system P2's plain version solves, within 1e-12 of max |Z|,
    also at rho / lam = 0.01 (lam 70, rho 0.7)."""
    Y = _rand((N, 3), N)
    want = tridiag.tridiag_solve_plain(torch.tensor(Y), torch.tensor(0.7, dtype=F64), lam).numpy()
    got = _p2_one_launch(Y, 0.7, lam, ups)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("spec", ["nonneg_admm", "l1:0.2", "nonneg+l1:0.1", "smooth:0.3",
                                  "smooth:0"])
@pytest.mark.parametrize("iters", [1, 10])
def test_admm_solve_matches_reference(spec, iters):
    """Same (M, A, aux): the port's admm_solve and the reference's, each with
    its own package's prox, within 1e-12 (X, Z and U)."""
    rng = np.random.default_rng(len(spec) + iters)
    G = rng.standard_normal((30, 5))
    A, M = G.T @ G, rng.standard_normal((50, 5))
    Z0, U0 = rng.standard_normal((50, 5)), 0.1 * rng.standard_normal((50, 5))
    got_x, (got_z, got_u) = cst.admm_solve(torch.tensor(M), torch.tensor(A),
                                           (torch.tensor(Z0), torch.tensor(U0)),
                                           cst.parse_spec(spec).prox, iters=iters)
    want_x, (want_z, want_u) = j_cst.admm_solve(jnp.asarray(M), jnp.asarray(A),
                                                (jnp.asarray(Z0), jnp.asarray(U0)),
                                                j_cst.parse_spec(spec).prox, iters=iters)
    for g, w in ((got_x, want_x), (got_z, want_z), (got_u, want_u)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("spec", ["none", "nonneg", "nonneg_admm", "l1:0.2", "smooth:0.3"])
def test_constraint_update_matches_reference(spec):
    """``Constraint.update`` on every route, with the duals made from the
    warm start where none are carried (the reference's ``init_aux``)."""
    rng = np.random.default_rng(7)
    G = rng.standard_normal((30, 5))
    A, M, prev = G.T @ G, rng.standard_normal((40, 5)), np.abs(rng.standard_normal((40, 5)))
    got, got_aux = cst.parse_spec(spec).update(torch.tensor(M), torch.tensor(A),
                                               torch.tensor(prev), (), admm_iters=4)
    want, want_aux = j_cst.parse_spec(spec).update(jnp.asarray(M), jnp.asarray(A),
                                                   jnp.asarray(prev), (), admm_iters=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert len(got_aux) == len(want_aux) == (2 if cst.parse_spec(spec).admm else 0)
    for g, w in zip(got_aux, want_aux):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_scale_and_empty_aux():
    Z, U = torch.ones(4, 3, dtype=F64), torch.full((4, 3), 2.0, dtype=F64)
    s = torch.tensor([1.0, 2.0, 3.0], dtype=F64)
    assert cst.scale_aux((), s) == ()
    z2, u2 = cst.scale_aux((Z, U), s)
    assert torch.equal(z2, Z * s) and torch.equal(u2, U * s)
    (pair,) = cst.scale_aux([(Z, U)], s)
    assert torch.equal(pair[1], U * s)
    assert cst.empty_aux() == j_cst.empty_aux() == {"h": (), "v": (), "w": ()}


# ---------------------------------------------------------------------------
# options, state and layouts
# ---------------------------------------------------------------------------

def test_option_checks_match_reference(choa):
    with pytest.raises(TypeError, match="constraints="):
        Parafac2Options(rank=5, nonneg=True)
    with pytest.raises(TypeError, match="constraints="):
        JOptions(rank=5, nonneg=True)
    with pytest.raises(ValueError, match="ridge"):
        Parafac2Options(rank=5, ridge=-1.0)
    with pytest.raises(ValueError, match="w_layout"):
        Parafac2Options(rank=5, w_layout="sharded")
    opts = Parafac2Options(rank=5, constraints={"w": "smooth:0.1"}, w_layout="bucketed")
    with pytest.raises(ValueError, match="w_layout='global'"):
        init_state(choa["cc"]["bt"], opts)
    jopts = JOptions(rank=5, constraints={"w": "smooth:0.1"}, w_layout="bucketed")
    with pytest.raises(ValueError, match="w_layout='global'"):
        j_init_state(choa["cc"]["bj"], jopts)
    assert Parafac2Options(rank=5).admm_iters == JOptions(rank=5).admm_iters == 10


def test_default_bundle_has_no_duals(choa):
    bt = choa["cc"]["bt"]
    s = init_state(bt, Parafac2Options(rank=5, dtype=F64, backend="torch"))
    assert s.aux == {"h": (), "v": (), "w": ()}
    s1, _ = fit(bt, Parafac2Options(rank=5, dtype=F64, backend="torch"), max_iters=1)
    assert s1.aux == {"h": (), "v": (), "w": ()}


def test_bucketed_init_state_matches_reference_layout(choa):
    """Per-bucket W, zero on padded slots; a list of per-bucket duals;
    w_global assembles the reference's global W."""
    case = "admm-bucketed"
    arrays, _ = _reference(choa, case, "cc")
    bt = choa["cc"]["bt"]
    own = init_state(bt, _opts(case))
    assert isinstance(own.W, tuple) and len(own.W) == len(bt.buckets)
    assert isinstance(own.aux["w"], list) and len(own.aux["w"]) == len(bt.buckets)
    assert own.aux["h"] == () and len(own.aux["v"]) == 2
    for b, wb, (z, u) in zip(bt.buckets, own.W, own.aux["w"]):
        assert torch.equal(wb, b.subject_mask[:, None].expand(-1, 5).to(F64))
        assert torch.equal(z, wb) and not u.any()
    for wb, want in zip(own.W, arrays["W"]):
        np.testing.assert_array_equal(wb.numpy(), want)
    np.testing.assert_array_equal(w_global(bt, own.W).numpy(),
                                  np.asarray(j_w_global(choa["cc"]["bj"],
                                                        tuple(map(jnp.asarray, arrays["W"])))))


def test_injected_state_without_duals_gets_them(choa):
    arrays, _ = _reference(choa, "admm-global", "cc")
    no_aux = {k: v for k, v in arrays.items() if k != "aux"}
    s = init_state(choa["cc"]["bt"], _opts("admm-global"), state=_state0(no_aux))
    for got, want in zip(_leaves(s.aux), jax.tree_util.tree_leaves(arrays["aux"])):
        np.testing.assert_array_equal(got.numpy(), want)


def test_convert_carries_duals_and_bucketed_w(choa):
    arrays, _ = _reference(choa, "admm-bucketed", "cc")
    s = _state0(arrays)
    assert isinstance(s.W, tuple) and isinstance(s.aux["w"], list)
    back = state_to_arrays(s)
    assert isinstance(back["W"], list) and isinstance(back["aux"]["w"], list)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(
            {**arrays, "fit": np.asarray(-np.inf)})):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "fused", "staged", "scoo"])
@pytest.mark.parametrize("case", list(CASES))
def test_host_fit_matches_reference(choa, case, backend):
    """choa 0.002, rank 5, 20 iterations, f64, from the reference's state0:
    the host fit history within 1e-8 of the reference's host engine (the
    scoo route on SCOO buckets, against the reference's scoo route there)."""
    fmt = "scoo" if backend == "scoo" else "cc"
    arrays, want = _reference(choa, case, fmt)
    decompose.reset_launches()
    state, hist = fit(choa[fmt]["bt"], _opts(case, backend), max_iters=ITERS, tol=0.0,
                      state=_state0(arrays))
    assert len(hist) == ITERS and np.all(np.isfinite(hist))
    assert np.max(np.abs(np.asarray(hist) - want)) <= 1e-8
    assert not any(decompose.kernel_launches().values())
    if CASES[case][0] is not None:
        assert len(_leaves(state.aux)) == len(jax.tree_util.tree_leaves(arrays["aux"])) > 0


@pytest.mark.parametrize("check_every", [4, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_scan_and_while_are_bitwise_the_host_engine(choa, case, check_every):
    """The scan engine (chunks of 4) and its while variant carry the duals
    and a per-bucket W as graph state: history, factors and duals bit for
    bit the port's host engine."""
    arrays, _ = _reference(choa, case, "cc")
    bt = choa["cc"]["bt"]
    host_state, host = fit(bt, _opts(case), max_iters=ITERS, tol=0.0, state=_state0(arrays))
    state, hist = fit(bt, _opts(case, engine="scan", check_every=check_every),
                      max_iters=ITERS, tol=0.0, state=_state0(arrays))
    assert hist == host
    got = _leaves([state.H, state.V, state.W, state.aux])
    want = _leaves([host_state.H, host_state.V, host_state.W, host_state.aux])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_chunk_rejects_a_state_of_another_layout(choa):
    arrays, _ = _reference(choa, "admm-bucketed", "cc")
    bt = choa["cc"]["bt"]
    chunk = engine.make_als_chunk(bt, _opts("admm-bucketed"), 2, state=_state0(arrays))
    with pytest.raises(ValueError, match="W layout or constraint duals"):
        chunk(init_state(bt, Parafac2Options(rank=5, dtype=F64, backend="torch")))


def test_l1_zeros_v_and_stays_near_reference(choa):
    """l1 on V makes exact zeros; the zero pattern is not an oracle (a
    threshold flips with rounding), V is, within 1e-8 of max |V|: a
    penalized V is not normalised and keeps its natural scale (max |V| is
    ~64 here)."""
    case = "l1-smooth"
    arrays, _ = _reference(choa, case, "cc")
    state, _ = fit(choa["cc"]["bt"], _opts(case), max_iters=ITERS, tol=0.0,
                   state=_state0(arrays))
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", constraints=CASES[case][0])
    j_state, _ = j_fit(choa["cc"]["bj"], jopts, max_iters=ITERS, tol=0.0,
                       state=j_init_state(choa["cc"]["bj"], jopts, seed=0))
    assert float((state.V == 0).double().mean()) > 0
    want = np.asarray(j_state.V)
    assert np.max(np.abs(state.V.numpy() - want)) <= 1e-8 * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# the other ported functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def well_conditioned():
    """Both packages' f64 buckets of ``WELL_CONDITIONED`` and the
    reference's state after 3 host iterations (a start the polar resolves)."""
    bj = j_bucketize(j_random_irregular(**WELL_CONDITIONED), dtype=jnp.float64)
    bt = bucketize(random_irregular(**WELL_CONDITIONED), device="cpu", dtype=F64)
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp")
    s3, _ = j_fit(bj, jopts, max_iters=3, tol=0.0, state=j_init_state(bj, jopts, seed=0))
    return dict(bj=bj, bt=bt, jopts=jopts, s3=s3, arrays=_arrays(s3))


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_reconstruct_uk_matches_reference(well_conditioned, backend):
    w = well_conditioned
    got = reconstruct_uk(w["bt"], _state0(w["arrays"]),
                         Parafac2Options(rank=5, dtype=F64, backend=backend))
    want = j_reconstruct_uk(w["bj"], w["s3"], w["jopts"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["torch", "staged"])
@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_mttkrp_helpers_match_reference(choa, backend, fmt):
    """The whole-tensor helpers on the same random Yc, V, H and global W,
    against the reference's jnp backend, within 1e-12 (the staged backend
    through rows 6, 8 and 9's plain versions on the CPU)."""
    bt, bj = choa[fmt]["bt"], choa[fmt]["bj"]
    rng = np.random.default_rng(11)
    J, K, R = bt.n_cols, bt.n_subjects, 5
    V, H, W = (rng.standard_normal(s) for s in ((J, R), (R, R), (K, R)))
    Ycs = [rng.standard_normal((b.kb, R, b.c_pad)) for b in bt.buckets]
    be, jbe = get_backend(backend), j_get_backend("jnp")
    tYc, jYc = [torch.tensor(y) for y in Ycs], [jnp.asarray(y) for y in Ycs]
    T = torch.tensor
    pairs = [(be.mttkrp_mode1(bt.buckets, tYc, T(V), T(W)),
              jbe.mttkrp_mode1(bj.buckets, jYc, jnp.asarray(V), jnp.asarray(W))),
             (be.mttkrp_mode2(bt.buckets, tYc, T(H), T(W), J),
              jbe.mttkrp_mode2(bj.buckets, jYc, jnp.asarray(H), jnp.asarray(W), J)),
             (be.mttkrp_mode3(bt.buckets, tYc, T(V), T(H), K),
              jbe.mttkrp_mode3(bj.buckets, jYc, jnp.asarray(V), jnp.asarray(H), K))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["default", "admm-global", "l1-smooth"])
def test_baseline_als_step_matches_reference(well_conditioned, case):
    w = well_conditioned
    specs = None if case == "default" else CASES[case][0]
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", constraints=specs)
    s0 = j_init_state(w["bj"], jopts, seed=0)
    s0 = s0._replace(H=w["s3"].H, V=w["s3"].V, W=w["s3"].W)
    if case != "default":       # duals from the warm start, on both sides
        s0 = s0._replace(aux={m: j_cst.parse_spec(specs.get(m, "none")).init_aux(
            getattr(s0, m.upper())) for m in "hvw"})
    want = j_baseline.baseline_als_step(w["bj"], s0, jopts)
    got = baseline.baseline_als_step(
        w["bt"], _state0(_arrays(s0)),
        Parafac2Options(rank=5, dtype=F64, backend="torch", constraints=specs))
    for k in ("H", "V", "W", "fit"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0, np.max(np.abs(b))), k
    for g, r in zip(_leaves(got.aux), jax.tree_util.tree_leaves(want.aux)):
        assert np.max(np.abs(g.numpy() - np.asarray(r))) <= 1e-12 * max(1.0, np.max(np.abs(r)))


def test_baseline_pieces_match_reference(well_conditioned):
    rng = np.random.default_rng(5)
    A, B = rng.standard_normal((4, 3)), rng.standard_normal((6, 3))
    np.testing.assert_array_equal(baseline.khatri_rao(torch.tensor(A), torch.tensor(B)).numpy(),
                                  np.asarray(j_baseline.khatri_rao(jnp.asarray(A),
                                                                   jnp.asarray(B))))
    bt, bj = well_conditioned["bt"], well_conditioned["bj"]
    Ycs = [rng.standard_normal((b.kb, 5, b.c_pad)) for b in bt.buckets]
    Y = baseline.dense_y(bt.buckets, [torch.tensor(y) for y in Ycs], bt.n_cols, bt.n_subjects)
    Yj = j_baseline.dense_y(bj.buckets, [jnp.asarray(y) for y in Ycs], bj.n_cols, bj.n_subjects)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), rtol=0, atol=1e-12)
    V, H, W = (rng.standard_normal(s) for s in ((bt.n_cols, 5), (5, 5), (bt.n_subjects, 5)))
    T, J_ = torch.tensor, jnp.asarray
    for got, want in ((baseline.baseline_mode1(Y, T(V), T(W)), j_baseline.baseline_mode1(Yj, J_(V), J_(W))),
                      (baseline.baseline_mode2(Y, T(H), T(W)), j_baseline.baseline_mode2(Yj, J_(H), J_(W))),
                      (baseline.baseline_mode3(Y, T(H), T(V)), j_baseline.baseline_mode3(Yj, J_(H), J_(V)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_interpret_matches_reference(well_conditioned):
    w = well_conditioned
    V, W = np.asarray(w["s3"].V), np.asarray(w["s3"].W)
    names = [f"code_{j}" for j in range(V.shape[0])]
    assert interpret.top_phenotype_features(V, names, top=4) == \
        j_interpret.top_phenotype_features(V, names, top=4)
    assert interpret.top_phenotype_features(-V) == j_interpret.top_phenotype_features(-V)
    for k in (0, 5, 23):
        assert interpret.subject_top_phenotypes(W, k, top=3) == \
            j_interpret.subject_top_phenotypes(W, k, top=3)
    for c in (None, {"v": "nonneg", "w": "nonneg"}, {"v": "l1:0.1", "w": "nonneg"},
              {"v": "nonneg+l1:0.1", "w": "smooth:0.1"}, {"v": "nonneg_admm", "w": "nonneg_admm"}):
        assert interpret.model_is_nonneg(c) == j_interpret.model_is_nonneg(c)
        assert interpret.model_is_nonneg(Parafac2Options(rank=5, constraints=c)) == \
            j_interpret.model_is_nonneg(JOptions(rank=5, constraints=c))
    Uk = np.random.default_rng(2).standard_normal((9, 5))
    for kw in ({}, {"constraints": {"v": "l1:0.1"}}, {"clip_nonneg": False}):
        got = interpret.temporal_signature(Uk, [0, 3], **kw)
        want = j_interpret.temporal_signature(Uk, [0, 3], **kw)
        assert got.keys() == want.keys()
        for r in want:
            np.testing.assert_array_equal(got[r], want[r])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_decompose_constraint_flag_matches_reference(tmp_path, capsys):
    spec = "v=nonneg+l1:0.1,w=smooth:0.1"
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "3",
             "--tol", "0", "--seed", "0", "--constraint", spec]
    capsys.readouterr()
    port = decompose.main(flags + ["--device", "cpu", "--json", str(tmp_path / "p.json")])
    port_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[constraints]")]
    want = j_decompose.main(flags + ["--json", str(tmp_path / "r.json")])
    want_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[constraints]")]
    assert port_line == want_line and len(port_line) == 1
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads(json.dumps(port))
    assert got["constraints"] == want["constraints"] == {
        "h": "none", "v": "nonneg+l1:0.1", "w": "smooth:0.1"}
    assert got["resolved_options"] == want["resolved_options"]
    assert len(got["fit_history"]) == 3 and got["kernel_launches"]["tridiag_solve"] == 0


def test_decompose_bad_constraint_fails_before_any_data(monkeypatch):
    def no_data(*a, **k):
        raise AssertionError("data was built before the spec was checked")

    monkeypatch.setattr(decompose, "load_dataset", no_data)
    with pytest.raises(ValueError) as want:
        j_decompose.main(["--constraint", "v=bogus", "--iters", "1"])
    with pytest.raises(ValueError) as got:
        decompose.main(["--constraint", "v=bogus", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "registered constraints: l1, none, nonneg, nonneg_admm, smooth" in str(got.value)
    # the spec is checked before the device: no GPU here, no --device cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no closed-form joint prox"):
        decompose.main(["--constraint", "smooth+nonneg"])


def test_a_dropped_iteration_is_freed_without_the_garbage_collector(choa):
    """A chunk (and its captured graph on a GPU) that is dropped is freed
    by reference counting: no cycle leaves it to the garbage collector,
    which could destroy a graph while another capture runs and so
    invalidate that capture."""
    import gc
    import weakref
    arrays, _ = _reference(choa, "admm-bucketed", "cc")
    chunk = engine.make_als_chunk(choa["cc"]["bt"], _opts("admm-bucketed"), 2,
                                  state=_state0(arrays))
    it = weakref.ref(chunk._it)
    gc.disable()
    try:
        del chunk
        assert it() is None
    finally:
        gc.enable()
