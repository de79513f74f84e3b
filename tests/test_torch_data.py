"""The port's host data, bucket plan and CC format against the JAX package's.

The generators, the planner and the CC staging are numpy in both packages,
so for the same seed the arrays must be byte-identical; the bucket
contractions must agree to 1e-12 in f64.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

import repro.data as j_data  # noqa: E402
import repro.sparse as j_sparse  # noqa: E402
from repro.core import bucketize as j_bucketize  # noqa: E402
import repro_torch.data as t_data  # noqa: E402
import repro_torch.sparse as t_sparse  # noqa: E402
from repro_torch.core import bucketize  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _same_coo(a, b):
    assert a.n_cols == b.n_cols and a.n_subjects == b.n_subjects
    for sa, sb in zip(a.subjects, b.subjects):
        assert sa.n_rows == sb.n_rows and sa.n_cols == sb.n_cols
        for f in ("rows", "cols", "vals"):
            x, y = getattr(sa, f), getattr(sb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("make", [
    lambda m: m.choa_like(scale=0.002, seed=0),
    lambda m: m.choa_like(scale=0.001, seed=3, with_phenotypes=True, rank=4),
    lambda m: m.movielens_like(scale=0.002, seed=1),
], ids=["choa", "choa-phenotypes", "movielens"])
def test_ehr_generators_byte_identical(make):
    _same_coo(make(t_data), make(j_data))


def test_random_generators_byte_identical():
    kw = dict(n_subjects=17, n_cols=40, max_rows=11, avg_nnz_per_subject=20, seed=5)
    _same_coo(t_sparse.random_irregular(**kw), j_sparse.random_irregular(**kw))
    kw = dict(n_subjects=9, n_cols=30, max_rows=12, rank=3, density=0.3, seed=2,
              noise=0.1)
    (dt, truth_t), (dj, truth_j) = (t_sparse.random_parafac2(**kw),
                                    j_sparse.random_parafac2(**kw))
    _same_coo(dt, dj)
    for k in ("H", "V", "W"):
        assert truth_t[k].tobytes() == truth_j[k].tobytes()


@pytest.mark.parametrize("kw", [
    dict(), dict(max_buckets=2, col_align=4), dict(max_buckets=3, sort_by="nnz"),
])
def test_plan_buckets_identical(kw):
    data = t_data.choa_like(scale=0.002, seed=0)
    args = (data.row_counts(), data.col_counts())
    nz = data.nnz_counts()
    pt = t_sparse.plan_buckets(*args, nnz_counts=nz, **kw)
    pj = j_sparse.plan_buckets(*args, nnz_counts=nz, **kw)
    assert pt.shapes == pj.shapes and pt.nnz_pads == pj.nnz_pads
    assert all(a.tobytes() == b.tobytes() for a, b in zip(pt.members, pj.members))
    assert pt.stats(*args, nz, formats=["cc"] * pt.n_buckets) == \
        pj.stats(*args, nz, formats=["cc"] * pj.n_buckets)
    assert pt.padding_waste(*args) == pj.padding_waste(*args)


def test_nnz_waste_matches_and_needs_nnz_pads():
    """BucketPlan.nnz_waste equals the reference's on the same plans, and a
    plan built without nnz_counts raises the reference's error in both."""
    data = t_data.choa_like(scale=0.002, seed=0)
    args = (data.row_counts(), data.col_counts())
    nz = data.nnz_counts()
    for kw in (dict(max_buckets=3, sort_by="nnz"), dict(max_buckets=2, col_align=4)):
        pt = t_sparse.plan_buckets(*args, nnz_counts=nz, **kw)
        pj = j_sparse.plan_buckets(*args, nnz_counts=nz, **kw)
        assert 0.0 <= pt.nnz_waste(nz) < 1.0
        assert pt.nnz_waste(nz) == pj.nnz_waste(nz)
    for plan in (t_sparse.plan_buckets(*args), j_sparse.plan_buckets(*args)):
        with pytest.raises(ValueError, match="plan has no nnz_pads"):
            plan.nnz_waste(nz)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
@pytest.mark.parametrize("kw", [dict(col_align=128), dict(col_align=4, subject_align=8)])
def test_bucketize_cc_byte_identical(dtype, jdtype, kw):
    data = t_data.choa_like(scale=0.002, seed=0)
    bt = bucketize(data, device="cpu", dtype=dtype, **kw)
    bj = j_bucketize(j_data.choa_like(scale=0.002, seed=0), dtype=jdtype, **kw)
    assert (bt.n_subjects, bt.n_cols, bt.norm_sq) == (bj.n_subjects, bj.n_cols, bj.norm_sq)
    assert len(bt.buckets) == len(bj.buckets)
    for a, b in zip(bt.buckets, bj.buckets):
        for f in ("vals", "cols", "col_mask", "subject_ids", "subject_mask", "row_counts"):
            x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        assert a.n_real == int(np.asarray(b.subject_mask).sum())


def test_bucket_contractions_match():
    data = t_data.choa_like(scale=0.002, seed=0)
    bt = bucketize(data, device="cpu", dtype=torch.float64, col_align=4)
    bj = j_bucketize(j_data.choa_like(scale=0.002, seed=0), dtype=jnp.float64, col_align=4)
    rng = np.random.default_rng(0)
    V = rng.random((data.n_cols, 5))
    for a, b in zip(bt.buckets, bj.buckets):
        Q = rng.standard_normal((a.kb, a.i_pad, 5))
        pairs = [
            (a.gather_v(torch.tensor(V)), b.gather_v(jnp.asarray(V))),
            (a.xk_times_v(torch.tensor(V)), b.xk_times_v(jnp.asarray(V))),
            (a.project(torch.tensor(Q)), b.project(jnp.asarray(Q))),
            (a.sq_norms(), b.sq_norms()),
        ]
        for x, y in pairs:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12, atol=1e-12)


def test_unported_formats_raise():
    """Every format ``bucketize`` takes is ported ("scoo" and "auto" build
    SCOO buckets at CHOA's density); any other name, "bcc" included (a
    kernel-side conversion, never a Bucketed format), raises."""
    data = t_data.choa_like(scale=0.001, seed=0)
    for fmt in ("scoo", "auto"):
        bt = bucketize(data, device="cpu", format=fmt)
        assert {b.format for b in bt.buckets} == {"scoo"}
    for fmt in ("bcc", "coo"):
        with pytest.raises(ValueError, match="unknown format"):
            bucketize(data, device="cpu", format=fmt)


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port and chip_smoke.py stand alone: no ``jax``,
    no ``repro`` (``repro_torch`` itself is fine)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    assert [bool(pat.search(s)) for s in (
        "import jax", "from jax import numpy", "  from repro.core import fit",
        "import repro.data", "from repro_torch.core import fit")] == [True] * 4 + [False]
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in pat.finditer(f.read_text())]
    assert not bad, bad
