"""The port's compression stage (``compress="rsvd[:r[:p[:q]]]"``) against the
JAX package, on the CPU in f64.

Module by module, on the same numpy-made data: the spec grammar (canonical
strings, summaries and every error equal to the reference's),
``route_compress``, ``cc_bucket_like`` on CC and SCOO buckets, and the range
finder (sketch, power iteration, ``range_basis``) on CC and SCOO buckets
within 1e-12, the reference's degenerate case (slices thinner than the
sketch, padding subjects) among them; the compression pass's per-bucket
stats and core energy. The port's Ω is the reference's: a test replaces
``repro_torch.kernels.sketch.gaussian_sketch`` (torch cannot reproduce
``jax.random``). Then the slice as a whole: choa_like(0.002), rank 5, 20
iterations, ``rsvd``, from the reference's state0: the history within 1e-8
of the reference's ``fit_compressed`` at every iteration on the torch,
fused, staged and scoo routes (the last entry residual-corrected), and
within the reference's 1e-3 relative of the uncompressed fit; the host,
scan and while engines bit for bit on the cores; pass-through buckets; the
expansion's partial isometry and ``exact_fit``'s norm identity; a bf16
compressed fit within 1e-3 of its f32 one; ``decompose --compress``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        init_state as j_init_state)
from repro.core import compress as j_cmp  # noqa: E402
from repro.core.irregular import cc_bucket_like as j_cc_bucket_like  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.kernels import sketch as j_sketch  # noqa: E402
from repro.sparse import plan_buckets as j_plan_buckets  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro.sparse.bucketing import route_compress as j_route_compress  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import (Parafac2Options, bucketize, cc_bucket_like, fit,  # noqa: E402
                              parse_preprocess_spec, preprocess_summary)
from repro_torch.core import compress as cmp  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import sketch  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import plan_buckets, random_irregular  # noqa: E402
from repro_torch.sparse.bucketing import route_compress  # noqa: E402

F64 = torch.float64
ITERS = 20
SPECS = ["rsvd", " rsvd:12 ", "rsvd:12:4:2", "rsvd:10:6:1", "none+rsvd:12", "rsvd:8+none",
         "none", "", "none+none", "rsvd:0", "rsvd:5:0:0", "rsvd:64:64"]
BAD_SPECS = ["bogus:3", "rsvd:abc", "rsvd:-1", "rsvd:1:2:3:4", "rsvd:8+rsvd:9", "none:1"]
# a small dataset, and the reference's degenerate case for the range finder
# (thin slices and padding subjects at rsvd:10:6:2, S = 16)
DATASETS = {
    "small": dict(n_subjects=24, n_cols=96, max_rows=64, avg_nnz_per_subject=200, seed=3),
    "degenerate": dict(n_subjects=16, n_cols=64, max_rows=48, avg_nnz_per_subject=60, seed=5),
}
# the routes of the parity command: port backend -> format. Every route is
# held to the reference's CC (jnp) fit: its SCOO fit differs from it by
# rounding alone (the same cores a subject), as its own tests hold
ROUTES = {"torch": "cc", "fused": "cc", "staged": "cc", "scoo": "scoo"}


def _reference_omega(seed, n_cols, sketch_dim, dtype=torch.float32, device="cpu"):
    """The reference's Ω for ``seed`` (``compress``'s key), as a tensor."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    omega = j_sketch.gaussian_sketch(key, n_cols, sketch_dim, jdt)
    return torch.tensor(np.asarray(omega), dtype=dtype, device=device)


@contextlib.contextmanager
def reference_omega():
    """The port's compression pass draws the reference's Ω inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sketch, "gaussian_sketch", _reference_omega)
        yield


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if scale is None else scale
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"max |port - reference| {err:.3e} > {tol:.0e} x {scale:.3e}"


def _proj_bound(Y: torch.Tensor) -> torch.Tensor:
    """Per subject, what P P^T may differ by between two f64 solves of the
    same range basis: max(1e-12, S kappa 2^-53), kappa the condition of the
    Gram Y^T Y over the eigenvalues the polar's clamp keeps (a direction of
    eigenvalue lam moves by rounding / lam; the degenerate case's thin
    slices reach kappa 1e8)."""
    lam = torch.linalg.eigvalsh(Y.transpose(1, 2) @ Y)
    top = lam[:, -1:].clamp(min=0.0)
    kept = torch.where(lam > top * 1e-12, lam, torch.full_like(lam, float("inf")))
    kappa = (top[:, 0] / kept.min(1).values).nan_to_num(nan=1.0, posinf=1.0)
    return torch.clamp(Y.shape[2] * kappa * 2.0 ** -53, min=1e-12)


def _pair(ds: str, fmt: str):
    """Both packages' f64 buckets of ``DATASETS[ds]`` on one plan, all in
    ``fmt``."""
    kw = DATASETS[ds]
    jd, td = j_random_irregular(**kw), random_irregular(**kw)
    rc, cc, nnz = jd.row_counts(), jd.col_counts(), jd.nnz_counts()
    jplan = j_plan_buckets(rc, cc, max_buckets=2, nnz_counts=nnz)
    tplan = plan_buckets(rc, cc, max_buckets=2, nnz_counts=nnz)
    return (j_bucketize(jd, plan=jplan, dtype=jnp.float64, formats=[fmt] * jplan.n_buckets),
            bucketize(td, plan=tplan, device="cpu", dtype=F64, formats=[fmt] * tplan.n_buckets))


@pytest.fixture(scope="module")
def choa():
    """choa_like(0.002)'s f64 buckets: both packages' CC, the port's SCOO
    (its history is held to the reference's CC fit), and the reference's
    rank-5 state0."""
    jd, td = j_choa_like(scale=0.002, seed=0), choa_like(scale=0.002, seed=0)
    out = {"cc": (j_bucketize(jd, dtype=jnp.float64, format="cc"),
                  bucketize(td, device="cpu", dtype=F64, format="cc")),
           "scoo": (None, bucketize(td, device="cpu", dtype=F64, format="scoo"))}
    s0 = j_init_state(out["cc"][0], JOptions(rank=5, dtype=jnp.float64), seed=0)
    out["state0"] = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return out


def _state0(choa):
    return state_from_arrays(choa["state0"], device="cpu", dtype=F64)


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert cmp.available() == j_cmp.available()
    for name in cmp.available():
        a, b = cmp._REGISTRY[name], j_cmp._REGISTRY[name]
        assert (a.param_names, a.defaults, a.apply is None) == \
            (b.param_names, b.defaults, b.apply is None)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_and_summary_match_reference(spec):
    got, want = parse_preprocess_spec(spec), j_cmp.parse_preprocess_spec(spec)
    assert (got.spec, got.name, got.params, got.identity) == \
        (want.spec, want.name, want.params, want.identity)
    for rank in (3, 5):
        try:
            s = want.sketch_dim(rank)
        except ValueError as e:
            with pytest.raises(ValueError) as ei:
                got.sketch_dim(rank)
            assert str(ei.value) == str(e)
            continue
        if not want.identity:
            assert got.sketch_dim(rank) == s
            assert preprocess_summary(spec, rank) == j_cmp.preprocess_summary(spec, rank)
    assert preprocess_summary(spec) == j_cmp.preprocess_summary(spec)


@pytest.mark.parametrize("call", [
    *(lambda m, s=s: m.parse_preprocess_spec(s) for s in BAD_SPECS),
    lambda m: m.parse_preprocess_spec("rsvd:3").sketch_dim(5),
    lambda m: m.parse_preprocess_spec("none").apply(None, None),
])
def test_spec_errors_match_reference(call):
    with pytest.raises(ValueError) as want:
        call(j_cmp)
    with pytest.raises(ValueError) as got:
        call(cmp)
    assert str(got.value) == str(want.value)


def test_options_engine_and_registry_errors(choa):
    with pytest.raises(ValueError) as want:
        JOptions(rank=3, compress="bogus")
    with pytest.raises(ValueError) as got:
        Parafac2Options(rank=3, compress="bogus")
    assert str(got.value) == str(want.value)
    assert "registered preprocessors" in str(got.value)
    assert Parafac2Options(rank=3).compress == "none"
    opts = Parafac2Options(rank=3, engine="scan", compress="rsvd", dtype=F64)
    with pytest.raises(ValueError, match="core ALS only"):
        engine.fit_device(choa["cc"][1], opts)
    cmp.register_preprocess("idtest", cmp.PreprocessDef())
    try:
        assert "idtest" in cmp.available()
        assert parse_preprocess_spec("idtest").identity
    finally:
        cmp._REGISTRY.pop("idtest", None)
        parse_preprocess_spec.cache_clear()
    with pytest.raises(ValueError, match="mismatch"):
        cmp.register_preprocess("bad", cmp.PreprocessDef(param_names=("a",)))


@pytest.mark.parametrize("shapes,S", [
    ([(48, 128), (56, 128), (64, 128)], 18), ([(16, 128), (18, 64), (19, 8)], 18),
    ([(8, 128)], 1), ([], 4), ("plan", 12), ([(8, 8)], 0)])
def test_route_compress_matches_reference(shapes, S):
    j_shapes = shapes
    if shapes == "plan":        # each package's own BucketPlan
        data = random_irregular(**DATASETS["small"])
        rc, cc = data.row_counts(), data.col_counts()
        shapes = plan_buckets(rc, cc, max_buckets=3)
        j_shapes = j_plan_buckets(rc, cc, max_buckets=3)
    try:
        want = j_route_compress(j_shapes, S)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            route_compress(shapes, S)
        assert str(ei.value) == str(e)
        return
    assert route_compress(shapes, S) == want


@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_cc_bucket_like_matches_reference(fmt):
    jb, tb = _pair("small", fmt)
    rng = np.random.default_rng(0)
    for bj, bt in zip(jb.buckets, tb.buckets):
        vals = rng.standard_normal((bt.kb, 7, bt.c_pad))
        rows = np.minimum(np.asarray(bj.row_counts), 7)
        want = j_cc_bucket_like(bj, jnp.asarray(vals), row_counts=jnp.asarray(rows))
        got = cc_bucket_like(bt, torch.tensor(vals), row_counts=torch.tensor(rows))
        assert got.format == "cc" and got.i_pad == 7
        for f in ("vals", "cols", "col_mask", "subject_ids", "subject_mask", "row_counts"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert (got.n_real, got.scatter_perm, got.scatter_ends) == \
            (bt.n_real, bt.scatter_perm, bt.scatter_ends)
        assert cc_bucket_like(bt, torch.tensor(vals)).row_counts is bt.row_counts
        bad = torch.zeros((bt.kb, 7, bt.c_pad + 1), dtype=F64)
        with pytest.raises(ValueError) as e_got:
            cc_bucket_like(bt, bad)
        with pytest.raises(ValueError) as e_want:
            j_cc_bucket_like(bj, jnp.zeros(bad.shape))
        assert str(e_got.value) == str(e_want.value)


# ---------------------------------------------------------------------------
# the range finder and the pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_range_finder_matches_reference(fmt):
    """Sketch, power iteration and range basis bucket by bucket on the
    reference's degenerate case, within 1e-12 of max |reference|; P held by
    its projector P P^T, P^T P idempotent and the cores' per-subject
    energies, not by raw P."""
    jb, tb = _pair("degenerate", fmt)
    pp = parse_preprocess_spec("rsvd:10:6:2")
    S, q = pp.sketch_dim(3), pp.param("q")
    omega = _reference_omega(0, tb.n_cols, S, F64)
    j_omega = jnp.asarray(omega.numpy())
    for bj, bt in zip(jb.buckets, tb.buckets):
        Yj = j_sketch.sketch_bucket(bj, j_omega)
        Y = sketch.sketch_bucket(bt, omega)
        _close(Y, Yj, 1e-12)
        _close(sketch.power_iterate(bt, Y, q), j_sketch.power_iterate(bj, Yj, q), 1e-12)
        Pj = np.asarray(j_sketch.range_basis(bj, j_omega, q=q))
        P = sketch.range_basis(bt, omega, q=q)
        assert P.shape == Pj.shape and torch.isfinite(P).all()
        bound = _proj_bound(sketch.power_iterate(bt, Y, q)).numpy()
        err = np.abs((P @ P.transpose(1, 2)).numpy()
                     - np.einsum("kis,kjs->kij", Pj, Pj)).max((1, 2))
        assert (err <= bound).all(), f"projector off by {err.max():.3e}"
        PtP = (P.transpose(1, 2) @ P).numpy()
        # the reference's own allowance: the clamp leaves near-null
        # directions a hair off 0 and 1
        np.testing.assert_allclose(np.einsum("kst,ktu->ksu", PtP, PtP), PtP, atol=1e-4)
        live = bt.subject_mask.numpy() > 0
        tr = np.einsum("kss->k", PtP)
        assert (tr[live] <= bt.row_counts.numpy()[live] + 1e-6).all()
        assert (tr[~live] == 0).all()                 # padding subjects: a zero basis
        # a subject's core energy moves by at most twice its projector's
        # error times ||X_k||^2
        energy = (bt.project(P) ** 2).sum((1, 2)).numpy()
        Gj = np.asarray(bj.project(jnp.asarray(Pj)))
        assert (np.abs(energy - (Gj ** 2).sum((1, 2)))
                <= 2 * bound * np.maximum(bt.sq_norms().numpy(), 1.0)).all()


def test_compress_stats_and_energy_match_reference(choa):
    """The pass on choa 0.002's CC buckets with the reference's Ω: the same
    records a bucket, the captured energies and the core norm within the
    projectors' bounds (1e-12 relative where every Gram is well
    conditioned), the cores' shapes and row counts."""
    want = _reference(choa)["comp"]
    tb = choa["cc"][1]
    with reference_omega():
        got = parse_preprocess_spec("rsvd").apply(tb, Parafac2Options(rank=5, dtype=F64),
                                                  seed=0)
    assert (got.spec, got.sketch_dim) == (want.spec, want.sketch_dim) == ("rsvd", 18)
    assert len(got.stats) == len(want.stats) == len(tb.buckets)
    omega = _reference_omega(0, tb.n_cols, 18, F64)
    slack_total = 0.0
    for b, g, w, cb, wb in zip(tb.buckets, got.stats, want.stats, got.buckets, want.buckets):
        assert {k: g[k] for k in g if k != "energy"} == {k: w[k] for k in w if k != "energy"}
        assert cb.compressed == wb.compressed
        b_sq = float(b.sq_norms().sum())
        slack = 1e-12 * b_sq
        if cb.compressed:
            Y = sketch.power_iterate(b, sketch.sketch_bucket(b, omega), 1)
            slack = max(slack, float((2 * _proj_bound(Y) * b.sq_norms()).sum()))
            assert tuple(cb.core.vals.shape) == tuple(wb.core.vals.shape)
            np.testing.assert_array_equal(cb.core.row_counts.numpy(),
                                          np.asarray(wb.core.row_counts))
        assert abs(g["energy"] - w["energy"]) * b_sq <= slack
        slack_total += slack
    assert abs(got.core_norm_sq - want.core_norm_sq) <= slack_total
    assert got.data.norm_sq == tb.norm_sq and got.core_norm_sq <= tb.norm_sq * (1 + 1e-12)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

_REFERENCE = {}


def _reference(choa):
    """The reference's rsvd pass on the CC buckets and its compressed fit
    from state0 (jnp backend), made once: ``fit_compressed``'s three steps,
    so that the stats test reads the same pass."""
    if not _REFERENCE:
        from repro.core import fit as j_fit

        jb = choa["cc"][0]
        jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp")
        comp = j_cmp.parse_preprocess_spec("rsvd").apply(jb, jopts, seed=0)
        s0 = j_init_state(jb, jopts, seed=0)
        state, hist = j_fit(comp.data, jopts, max_iters=ITERS, tol=0.0, state=s0)
        hist[-1] = float(j_cmp.residual_correct(jb, comp, state, jopts).fit)
        _REFERENCE.update(comp=comp, hist=np.asarray(hist))
    return _REFERENCE


@pytest.fixture(scope="module")
def uncompressed(choa):
    _, hist = fit(choa["cc"][1], Parafac2Options(rank=5, dtype=F64, backend="torch"),
                  max_iters=ITERS, tol=0.0, state=_state0(choa))
    return hist


@pytest.mark.parametrize("backend", list(ROUTES))
def test_compressed_fit_matches_reference(choa, uncompressed, backend):
    """The parity command: choa 0.002, rank 5, 20 iterations, f64, rsvd, the
    reference's Ω and state0: every iteration within 1e-8 of the reference's
    fit_compressed (the last one residual-corrected in both), and the final
    fit within the reference's 1e-3 relative of the uncompressed one."""
    fmt = ROUTES[backend]
    want = _reference(choa)["hist"]
    opts = Parafac2Options(rank=5, dtype=F64, backend=backend, compress="rsvd")
    with reference_omega():
        state, hist = fit(choa[fmt][1], opts, max_iters=ITERS, tol=0.0, state=_state0(choa))
    assert len(hist) == ITERS and hist[-1] == float(state.fit)
    _close(hist, want, 1e-8, scale=1.0)
    rel = abs(hist[-1] - uncompressed[-1]) / abs(uncompressed[-1])
    assert rel < 1e-3, f"compressed fit off by {rel:.2e} relative"
    assert state.V.shape == (choa[fmt][1].n_cols, 5) and state.W.shape == (
        choa[fmt][1].n_subjects, 5)


def test_engines_bit_for_bit_on_cores(choa):
    """host, scan (check_every 4) and while (0) on the cores: the same
    history and V, bit for bit (the reference's rsvd:10:6:1 at rank 4)."""
    base = Parafac2Options(rank=4, dtype=F64, compress="rsvd:10:6:1")
    bt = choa["cc"][1]
    s_host, h_host = fit(bt, base, max_iters=8, tol=0.0, seed=0)
    for check_every in (4, 0):
        o = dataclasses.replace(base, engine="scan", check_every=check_every)
        s, h = fit(bt, o, max_iters=8, tol=0.0, seed=0)
        assert h == h_host, f"scan/ce={check_every} diverged from host on cores"
        assert s.V.numpy().tobytes() == s_host.V.numpy().tobytes()


def test_pass_through_when_sketch_not_smaller():
    """r + p above every bucket's row pad: every bucket passes through (the
    reference's records), and the history is the uncompressed fit's bar its
    residual-corrected last entry (fresh Q: a one-step gain at most)."""
    jb, tb = _pair("small", "cc")
    opts = Parafac2Options(rank=3, dtype=F64)
    comp = parse_preprocess_spec("rsvd:64:64").apply(tb, opts, seed=0)
    want = j_cmp.parse_preprocess_spec("rsvd:64:64").apply(
        jb, JOptions(rank=3, dtype=jnp.float64), seed=0)
    assert not any(cb.compressed for cb in comp.buckets)
    assert all(cb.core is b for cb, b in zip(comp.buckets, tb.buckets))
    assert comp.stats == want.stats and comp.sketch_dim == want.sketch_dim == 128
    assert abs(comp.core_norm_sq - want.core_norm_sq) <= 1e-12 * want.core_norm_sq
    _, h_un = fit(tb, opts, max_iters=6, tol=0.0, seed=0)
    _, h_c = fit(tb, dataclasses.replace(opts, compress="rsvd:64:64"), max_iters=6, tol=0.0,
                 seed=0)
    assert h_c[:-1] == h_un[:-1]
    assert h_c[-1] >= h_un[-1] - 1e-12 and abs(h_c[-1] - h_un[-1]) < 5e-3


def test_expand_q_partial_isometry_and_exact_fit(choa):
    """Q_k = P_k Q̃_k is a partial isometry on live subjects (Q^T Q
    idempotent, its trace at most the rank), and exact_fit at the expanded
    factors on the originals equals exact_fit at the core factors on the
    cores (the norm identity end to end), at least the step-start history
    entry before it."""
    from repro_torch.core import parafac2 as p2
    from repro_torch.core.backend import get_backend

    bt = choa["cc"][1]
    opts = Parafac2Options(rank=4, dtype=F64)
    comp = parse_preprocess_spec("rsvd").apply(bt, opts, seed=0)
    state, hist = fit(comp.data, opts, max_iters=8, tol=0.0, seed=0)
    Qs = cmp.expand_q(comp, state, opts)
    for b, Q in zip(bt.buckets, Qs):
        QtQ = (Q.transpose(1, 2) @ Q).numpy()
        live = b.subject_mask.numpy() > 0
        np.testing.assert_allclose(np.einsum("krl,klm->krm", QtQ[live], QtQ[live]),
                                   QtQ[live], atol=1e-4)
        assert (np.einsum("krr->k", QtQ)[live] <= opts.rank + 1e-4).all()
    be = get_backend(opts.backend, "cpu")
    Qcs = [p2._procrustes_project(cb.core, state.H, state.V, state.W, opts, i, be)[2]
           for i, cb in enumerate(comp.buckets)]
    core_fit = float(cmp.exact_fit(comp.data, state, opts, Qcs))
    exact = float(cmp.exact_fit(bt, state, opts, Qs))
    assert abs(exact - core_fit) < 1e-10
    assert exact >= hist[-2] - 1e-12
    assert float(cmp.residual_correct(bt, comp, state, opts).fit) == exact


def test_bf16_compressed_fit_within_contract(monkeypatch):
    """A bf16 compressed fit within 1e-3 of its f32 one at every iteration;
    the half copy is made of the cores once, never of the originals."""
    from repro_torch.core.irregular import Bucketed

    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu")
    opts = Parafac2Options(rank=5, compress="rsvd")
    _, h32 = fit(bt, opts, max_iters=ITERS, tol=0.0)
    halved, made = [], Bucketed.with_compute_values
    monkeypatch.setattr(Bucketed, "with_compute_values",
                        lambda self, p: halved.append((self, p)) or made(self, p))
    _, h16 = fit(bt, dataclasses.replace(opts, precision="bf16"), max_iters=ITERS, tol=0.0)
    gap = float(np.max(np.abs(np.asarray(h16) - np.asarray(h32))))
    assert 0.0 < gap < 1e-3
    assert len(halved) == 1 and halved[0][1] == "bf16"
    assert {b.i_pad for b in halved[0][0].buckets} == {18}


def test_decompose_compress_flag(tmp_path, capsys):
    """``--compress rsvd:8:4:1 --device cpu``: the [compress] line, the
    summary's compress blocks as the reference's, and a bad spec fails
    before any data."""
    out = decompose.main(["--scale", "0.001", "--iters", "3", "--device", "cpu",
                          "--compress", "rsvd:8:4:1", "--json", str(tmp_path / "s.json")])
    text = capsys.readouterr().out
    assert "[compress] rsvd:8:4:1: sketch_dim=12," in text
    assert out["resolved_options"]["compress"] == \
        j_cmp.preprocess_summary("rsvd:8:4:1", 5) == {
            "spec": "rsvd:8:4:1", "sketch_dim": 12, "power_iters": 1}
    assert out["compress"] == "rsvd:8:4:1" and out["iters"] == 3
    assert np.isfinite(out["fit_history"]).all()
    with pytest.raises(ValueError, match="registered preprocessors: none, rsvd"):
        decompose.main(["--compress", "bogus", "--device", "cpu"])
