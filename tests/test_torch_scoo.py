"""The SCOO format and the BCC layout of the port against the JAX package's.

Per module, on the same numpy-made inputs: the planner's routing decisions
and ``fixed_plan``; the SCOO host arrays of ``bucketize`` byte for byte; every
function of ``kernels/scoo.py`` against the reference's jnp functions in f64
(1e-12), on the sorted-boundary and the scatter-oracle paths; the two SCOO
kernel wrappers (their plain versions on the CPU) against the reference's
Pallas kernels in interpret mode in f32 (atol 1e-6 of the largest running
sum of |contribution|, since a prefix-sum difference rounds in proportion to
the prefix, not to the segment), explicit zero-valued triplets included; the
BCC conversion byte for byte, with its truncation raise and warning, and
``xk_times_v_bcc`` against the reference's interpret-mode kernel. Then the
slice as a whole: ``SparseBackend``'s bucket stages against the reference's,
``StagedBackend``'s SCOO stages against ``PallasBackend``'s, the stage tally
per route, the choa 0.002 rank-5 f64 fit from the reference's state0 within
1e-8 of the reference's ``scoo`` fit, an f32 staged fit within 1e-4 of the
reference's ``pallas`` fit, and the launcher. The CUDA kernels themselves
are held against these plain versions in ``test_torch_cuda.py``.
"""
import collections
import contextlib
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, als_step as j_als_step,  # noqa: E402
                        bucketize as j_bucketize, fit as j_fit, init_state as j_init_state,
                        to_block_bucket as j_to_block_bucket)
from repro.core.backend import dispatch_tally as j_dispatch_tally  # noqa: E402
from repro.core.backend import get_backend as j_get_backend  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.kernels import scoo as j_scoo  # noqa: E402
from repro.launch import decompose as j_decompose  # noqa: E402
from repro.sparse import IrregularCOO as JIrregularCOO  # noqa: E402
from repro.sparse import SubjectCOO as JSubjectCOO  # noqa: E402
from repro.sparse import fixed_plan as j_fixed_plan  # noqa: E402
from repro.sparse import plan_buckets as j_plan_buckets  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro.sparse import random_parafac2 as j_random_parafac2  # noqa: E402
from repro.sparse import route_formats as j_route_formats  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import (BlockBucket, Parafac2Options, SparseBucket,  # noqa: E402
                              als_step, bucket_format, bucketize, fit, to_block_bucket)
from repro_torch.core.backend import dispatch_tally, get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import fused, gather_matmul, ops, polar, scoo, staged, tridiag  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import (SCOO_DENSITY_THRESHOLD, IrregularCOO, SubjectCOO,  # noqa: E402
                                fixed_plan, plan_buckets, random_irregular,
                                random_parafac2, route_formats)

ITERS = 20
F64 = dict(rtol=1e-12, atol=1e-12)
SCOO_FIELDS = ("vals", "rows", "lcols", "row_ends", "cperm", "col_ends", "cols",
               "col_mask", "subject_ids", "subject_mask", "row_counts", "nnz_counts")


def _edge(n_cols=29):
    """The reference's ``tests/test_scoo.py::_edge_data``: odd geometry with
    an empty subject, a single-nnz subject and a 200-row ultra-sparse one."""
    rng = np.random.default_rng(7)

    def sub(n_rows, nnz):
        cells = rng.choice(n_rows * n_cols, size=nnz, replace=False)
        return ((cells // n_cols).astype(np.int32), (cells % n_cols).astype(np.int32),
                rng.standard_normal(nnz), n_rows)

    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0), 3)
    subs = [sub(9, 25), empty, sub(1, 1), sub(200, 5), sub(13, 40), sub(6, 11)]
    return [(r, c, v, n, n_cols) for r, c, v, n in subs]


def _both_data(name):
    """(port data, reference data) for one of the named datasets."""
    if name == "edge":
        subs = _edge()
        return (IrregularCOO([SubjectCOO(*s) for s in subs], 29),
                JIrregularCOO([JSubjectCOO(*s) for s in subs], 29))
    if name == "choa":
        return choa_like(scale=0.002, seed=0), j_choa_like(scale=0.002, seed=0)
    if name == "planted":      # dense enough that format="auto" keeps CC buckets
        kw = dict(n_subjects=12, n_cols=24, max_rows=16, rank=3, density=0.8, seed=7)
        return random_parafac2(**kw)[0], j_random_parafac2(**kw)[0]
    kw = {"random-odd": dict(n_subjects=13, n_cols=37, max_rows=9, avg_nnz_per_subject=18,
                             seed=0, nonneg=False),
          "random-padded": dict(n_subjects=11, n_cols=50, max_rows=12,
                                avg_nnz_per_subject=25, seed=3)}[name]
    return random_irregular(**kw), j_random_irregular(**kw)


SMALL = ["edge", "random-odd", "random-padded"]     # tests/test_scoo.py's DATASETS


def _pair(name, dtype=torch.float64, *, max_buckets=3, col_align=4, subject_align=1,
          format="scoo"):
    """Both packages' buckets of one dataset, from the same plan."""
    t_data, j_data = _both_data(name)
    kw = dict(max_buckets=max_buckets, col_align=col_align, subject_align=subject_align,
              format=format)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (bucketize(t_data, device="cpu", dtype=dtype, **kw),
            j_bucketize(j_data, dtype=jdt, **kw))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, want, tol=F64, scale=1.0):
    port, want = _np(port), _np(want)
    assert port.shape == want.shape
    np.testing.assert_allclose(port, want, rtol=tol["rtol"], atol=tol["atol"] * scale)


def _prefix_scale(vals, idx, M) -> float:
    """The largest running sum of |vals[n] * M[idx[n], :]| along a subject's
    triplets: the magnitude a prefix-sum difference rounds against."""
    v, i, m = (np.asarray(a, np.float64) for a in (vals, idx, M))
    g = np.take_along_axis(m, i.astype(np.int64)[..., None], axis=1)
    return max(1.0, float(np.cumsum(np.abs(g * v[..., None]), axis=1).max(initial=0.0)))


# ---------------------------------------------------------------------------
# sparse/bucketing.py and SCOO bucketize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMALL + ["choa", "planted"])
def test_route_formats_and_fixed_plan_match_reference(name):
    t_data, j_data = _both_data(name)
    args = (t_data.row_counts(), t_data.col_counts())
    kw = dict(nnz_counts=t_data.nnz_counts(), max_buckets=3, col_align=4)
    plan, j_plan = plan_buckets(*args, **kw), j_plan_buckets(*args, **kw)
    nnz = t_data.nnz_counts()
    for fmt in ("cc", "scoo", "auto"):
        for thr in (SCOO_DENSITY_THRESHOLD, 0.02, 0.5, 1.0):
            assert route_formats(plan, nnz, format=fmt, density_threshold=thr) == \
                j_route_formats(j_plan, nnz, format=fmt, density_threshold=thr)
    assert route_formats(plan, nnz) == j_route_formats(j_plan, nnz)     # default "auto"
    with pytest.raises(ValueError, match="unknown format"):
        route_formats(plan, nnz, format="bcc")
    fp, jfp = fixed_plan(5, 16, 32, nnz_pad=40), j_fixed_plan(5, 16, 32, nnz_pad=40)
    assert fp.shapes == jfp.shapes and fp.nnz_pads == jfp.nnz_pads
    assert np.array_equal(fp.members[0], jfp.members[0])
    assert fp.members[0].dtype == jfp.members[0].dtype
    assert fixed_plan(2, 3, 4).nnz_pads is None
    with pytest.raises(ValueError):
        fixed_plan(0, 8, 8)


@pytest.mark.parametrize("name", SMALL + ["choa", "planted"])
@pytest.mark.parametrize("format", ["scoo", "auto"])
@pytest.mark.parametrize("subject_align", [1, 4])
def test_bucketize_arrays_are_byte_identical(name, format, subject_align):
    """Every host array of every bucket, dtypes and bytes, as the reference
    stages them (SCOO and, under "auto", CC buckets)."""
    bt, bj = _pair(name, format=format, subject_align=subject_align)
    assert [bucket_format(b) for b in bt.buckets] == [b.format for b in bj.buckets]
    for a, b in zip(bt.buckets, bj.buckets):
        fields = (SCOO_FIELDS if b.format == "scoo" else
                  ("vals", "cols", "col_mask", "subject_ids", "subject_mask", "row_counts"))
        for f in fields:
            x, y = _np(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        assert (a.kb, a.i_pad, a.c_pad) == (b.kb, b.i_pad, b.c_pad)
        if b.format == "scoo":
            assert a.n_pad == b.n_pad
            assert np.array_equal(_np(a.nnz_offsets), np.asarray(b.nnz_offsets))
            _close(a.dense_vals(), b.dense_vals(), dict(rtol=0, atol=0))
            _close(a.sq_norms(), b.sq_norms())
    assert bt.norm_sq == bj.norm_sq


def test_bucketize_formats_override_and_stale_plan():
    """``formats=`` overrides the routing (a mixed Bucketed), and a plan whose
    N_pad is too small raises as in the reference."""
    t_data, j_data = _both_data("random-padded")
    plan = plan_buckets(t_data.row_counts(), t_data.col_counts(),
                        nnz_counts=t_data.nnz_counts(), max_buckets=2, col_align=4)
    mixed = bucketize(t_data, device="cpu", plan=plan, formats=["cc", "scoo"])
    assert [bucket_format(b) for b in mixed.buckets] == ["cc", "scoo"]
    with pytest.raises(ValueError, match="entries"):
        bucketize(t_data, device="cpu", plan=plan, formats=["scoo"])
    small = fixed_plan(t_data.n_subjects, 16, 64, nnz_pad=8)
    with pytest.raises(ValueError, match="N_pad") as port_err:
        bucketize(t_data, device="cpu", plan=small, format="scoo")
    with pytest.raises(ValueError, match="N_pad") as ref_err:
        j_bucketize(j_data, plan=small, format="scoo")
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# kernels/scoo.py: the plain torch versions, f64
# ---------------------------------------------------------------------------

def _operands(name, dtype, R=5, seed=1):
    """Per SCOO bucket of the reference, the numpy operands of every SCOO
    function (bucket arrays, Vg, Q, H, Wb), in ``dtype``."""
    _, bj = _pair(name)
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    V = rng.standard_normal((bj.n_cols, R))
    H = rng.standard_normal((R, R))
    for b in bj.buckets:
        op = {f: np.asarray(getattr(b, f)) for f in SCOO_FIELDS}
        op.update(Vg=np.asarray(b.gather_v(jnp.asarray(V))),
                  Q=rng.standard_normal((b.kb, b.i_pad, R)), H=H,
                  Wb=rng.standard_normal((b.kb, R)))
        yield {k: (a.astype(npdt) if a.dtype.kind == "f" else a) for k, a in op.items()}, b


def _tj(op):
    return ({k: torch.from_numpy(np.array(v)) for k, v in op.items()},
            {k: jnp.asarray(v) for k, v in op.items()})


@pytest.mark.parametrize("name", SMALL)
def test_scoo_functions_match_reference_f64(name):
    """Every function of kernels/scoo.py against the reference's jnp, on the
    sorted-boundary path and the scatter-add oracle, within 1e-12."""
    for op, b in _operands(name, torch.float64):
        t, j = _tj(op)
        I, C = b.i_pad, b.c_pad
        for ends in (True, False):
            x = scoo.xk_times_v(t["vals"], t["rows"], t["lcols"], t["Vg"], I,
                                row_ends=t["row_ends"] if ends else None)
            _close(x, j_scoo.xk_times_v(j["vals"], j["rows"], j["lcols"], j["Vg"], I,
                                        row_ends=j["row_ends"] if ends else None))
            pk, jk = ((dict(cperm=t["cperm"], col_ends=t["col_ends"]),
                       dict(cperm=j["cperm"], col_ends=j["col_ends"])) if ends else ({}, {}))
            p = scoo.project(t["vals"], t["rows"], t["lcols"], t["Q"], C, **pk)
            _close(p, j_scoo.project(j["vals"], j["rows"], j["lcols"], j["Q"], C, **jk))
            # X_k V and Yc feed the CUDA kernels, which take no strided operand
            assert x.is_contiguous() and p.is_contiguous()
            _close(scoo.mode2_compact_scoo(t["vals"], t["rows"], t["lcols"], t["Q"], t["H"],
                                           t["Wb"], t["col_mask"], t["subject_mask"], **pk),
                   j_scoo.mode2_compact_scoo(j["vals"], j["rows"], j["lcols"], j["Q"], j["H"],
                                             j["Wb"], j["col_mask"], j["subject_mask"], **jk))
        contrib = t["Vg"][torch.arange(b.kb)[:, None], t["lcols"].long()] * t["vals"][..., None]
        _close(scoo.segment_sum_sorted(contrib, t["row_ends"]),
               j_scoo.segment_sum_sorted(jnp.asarray(contrib.numpy()), j["row_ends"]))
        _close(scoo.ykv_scoo(t["vals"], t["rows"], t["lcols"], t["Q"], t["Vg"]),
               j_scoo.ykv_scoo(j["vals"], j["rows"], j["lcols"], j["Q"], j["Vg"]))
        _close(scoo.mode1_scoo(t["vals"], t["rows"], t["lcols"], t["Q"], t["Vg"], t["Wb"],
                               t["subject_mask"]),
               j_scoo.mode1_scoo(j["vals"], j["rows"], j["lcols"], j["Q"], j["Vg"], j["Wb"],
                                 j["subject_mask"]))
        _close(scoo.mode3_scoo(t["vals"], t["rows"], t["lcols"], t["Q"], t["Vg"], t["H"],
                               t["subject_mask"]),
               j_scoo.mode3_scoo(j["vals"], j["rows"], j["lcols"], j["Q"], j["Vg"], j["H"],
                                 j["subject_mask"]))


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("R", [1, 4, 72])
def test_kernel_wrappers_match_pallas_interpret_f32(name, R):
    """The two wrappers (their plain versions on the CPU) against
    ``xk_times_v_pallas`` / ``project_pallas`` in interpret mode, f32, atol
    1e-6 of the largest running sum, with and without the segment ends."""
    scoo.reset_launches()
    for op, b in _operands(name, torch.float32, R=R):
        t, j = _tj(op)
        want = j_scoo.xk_times_v_pallas(j["vals"], j["rows"], j["lcols"], j["Vg"], b.i_pad,
                                        nnz_counts=j["nnz_counts"], interpret=True)
        scale = _prefix_scale(op["vals"], op["lcols"], op["Vg"])
        for ends in (t["row_ends"], None):
            _close(scoo.scoo_xk_times_v(t["vals"], t["rows"], t["lcols"], t["Vg"], b.i_pad,
                                        row_ends=ends),
                   want, dict(rtol=1e-6, atol=1e-6), scale)
        want = j_scoo.project_pallas(j["vals"], j["rows"], j["lcols"], j["Q"], b.c_pad,
                                     nnz_counts=j["nnz_counts"], interpret=True)
        scale = _prefix_scale(op["vals"], op["rows"], op["Q"])
        for kw in (dict(cperm=t["cperm"], col_ends=t["col_ends"]), {}):
            _close(scoo.scoo_project(t["vals"], t["rows"], t["lcols"], t["Q"], b.c_pad, **kw),
                   want, dict(rtol=1e-6, atol=1e-6), scale)
    assert sum(scoo.LAUNCHES.values()) == 0


def test_explicit_zero_valued_triplets_count():
    """Stored zeros inside a subject's true nnz are real entries: what follows
    them still counts (the reference's ``tests/test_scoo.py:328``)."""
    vals = np.asarray([[0.0, 0.0, 2.0, 3.0]], np.float32)
    rows = np.asarray([[0, 0, 1, 2]], np.int32)
    lcols = np.asarray([[0, 1, 2, 3]], np.int32)
    row_ends = np.asarray([[2, 3, 4, 4]], np.int32)
    cperm = np.asarray([[0, 1, 2, 3]], np.int32)
    col_ends = np.asarray([[1, 2, 3, 4]], np.int32)
    Vg, Q = np.ones((1, 4, 2), np.float32), np.ones((1, 4, 2), np.float32)
    T = {k: torch.from_numpy(v) for k, v in dict(
        vals=vals, rows=rows, lcols=lcols, row_ends=row_ends, cperm=cperm,
        col_ends=col_ends, Vg=Vg, Q=Q).items()}
    nnz = jnp.asarray([4], jnp.int32)
    want_x = j_scoo.xk_times_v_pallas(jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(lcols),
                                      jnp.asarray(Vg), 4, nnz_counts=nnz, interpret=True)
    want_p = j_scoo.project_pallas(jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(lcols),
                                   jnp.asarray(Q), 4, nnz_counts=nnz, interpret=True)
    assert float(jnp.abs(want_x).sum()) > 0
    got_x = scoo.scoo_xk_times_v(T["vals"], T["rows"], T["lcols"], T["Vg"], 4,
                                 row_ends=T["row_ends"])
    got_p = scoo.scoo_project(T["vals"], T["rows"], T["lcols"], T["Q"], 4,
                              cperm=T["cperm"], col_ends=T["col_ends"])
    _close(got_x, want_x, dict(rtol=1e-6, atol=1e-6))
    _close(got_p, want_p, dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empty_bucket_returns_zeros_without_a_launch(dtype):
    """K = 0: zeros of the reference's shapes from the three wrappers, no launch."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    z = dict(dtype=dtype)
    vals, idx = torch.zeros((0, 8), **z), torch.zeros((0, 8), dtype=torch.int32)
    Vg, Q = torch.zeros((0, 6, 3), **z), torch.zeros((0, 5, 3), **z)
    scoo.reset_launches()
    gather_matmul.reset_launches()
    x = scoo.scoo_xk_times_v(vals, idx, idx, Vg, 5, row_ends=torch.zeros((0, 5), dtype=torch.int32))
    p = scoo.scoo_project(vals, idx, idx, Q, 6, cperm=idx,
                          col_ends=torch.zeros((0, 6), dtype=torch.int32))
    g = gather_matmul.gather_matmul(torch.zeros((0, 5, 2, 128), **z),
                                    torch.zeros((0, 2), dtype=torch.int32),
                                    torch.zeros((256, 3), **z))
    jv, ji = jnp.zeros((0, 8), jd), jnp.zeros((0, 8), jnp.int32)
    want = [j_scoo.xk_times_v_pallas(jv, ji, ji, jnp.zeros((0, 6, 3), jd), 5, interpret=True),
            j_scoo.project_pallas(jv, ji, ji, jnp.zeros((0, 5, 3), jd), 6, interpret=True)]
    for got, w in zip((x, p), want):
        assert tuple(got.shape) == tuple(w.shape) and got.dtype == dtype
        assert not got.abs().sum()
    assert tuple(g.shape) == (0, 5, 3) and g.dtype == dtype
    assert sum(scoo.LAUNCHES.values()) + sum(gather_matmul.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# BCC: to_block_bucket and xk_times_v_bcc
# ---------------------------------------------------------------------------

# tests/test_bcc_integration.py's geometries
BCC_GEOMETRIES = [(0, 300, 8), (1, 500, 16), (2, 130, 4)]


def _bcc_pair(seed, J, dtype=torch.float32):
    kw = dict(n_subjects=9, n_cols=J, max_rows=12, avg_nnz_per_subject=40, seed=seed)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (bucketize(random_irregular(**kw), device="cpu", max_buckets=2, dtype=dtype),
            j_bucketize(j_random_irregular(**kw), max_buckets=2, dtype=jdt))


@pytest.mark.parametrize("seed,J,R", BCC_GEOMETRIES)
def test_to_block_bucket_is_byte_identical(seed, J, R):
    bt, bj = _bcc_pair(seed, J)
    for a, b in zip(bt.buckets, bj.buckets):
        for cap in (None, 1):
            kw = dict(max_blocks=cap, allow_truncate=True)
            with _warns_if(cap is not None and _n_blocks(b) > cap):
                got = to_block_bucket(a, J, **kw)
            with _warns_if(cap is not None and _n_blocks(b) > cap):
                want = j_to_block_bucket(b, J, **kw)
            assert isinstance(got, BlockBucket)
            for f in ("vals", "blk_ids", "blk_mask", "subject_ids", "subject_mask"):
                x, y = _np(getattr(got, f)), np.asarray(getattr(want, f))
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            assert (got.kb, got.i_pad, got.n_blocks) == (want.kb, want.i_pad, want.n_blocks)


def _n_blocks(b) -> int:
    cols, cm = np.asarray(b.cols), np.asarray(b.col_mask) > 0
    return max(np.unique(cols[k][cm[k]] // 128).size for k in range(cols.shape[0]))


@contextlib.contextmanager
def _warns_if(truncates: bool):
    """The truncation warning when blocks are dropped, and no warning else."""
    if truncates:
        with pytest.warns(UserWarning, match="truncated"):
            yield
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            yield


def test_to_block_bucket_truncation_raises_then_warns():
    """A cap that drops nonzeros raises with the dropped count; with
    ``allow_truncate`` it warns with the same message as the reference."""
    bt, bj = _bcc_pair(1, 500)
    a, b = bt.buckets[0], bj.buckets[0]
    with pytest.raises(ValueError, match="truncated") as port_err:
        to_block_bucket(a, 500, max_blocks=1)
    with pytest.raises(ValueError, match="truncated") as ref_err:
        j_to_block_bucket(b, 500, max_blocks=1)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.warns(UserWarning, match="truncated"):
        to_block_bucket(a, 500, max_blocks=1, allow_truncate=True)


@pytest.mark.parametrize("seed,J,R", BCC_GEOMETRIES + [(3, 260, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_xk_times_v_bcc_matches_reference(seed, J, R, dtype):
    """``Bucket.xk_times_v_bcc`` (``ops.gather_matmul``, its plain version on
    the CPU) against the reference's interpret-mode kernel (f32, atol 1e-6 of
    the output's largest magnitude) and its CC product (f64, 1e-12)."""
    bt, bj = _bcc_pair(seed, J, dtype)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((J, R)).astype(np.float64 if dtype == torch.float64 else np.float32)
    gather_matmul.reset_launches()
    for a, b in zip(bt.buckets, bj.buckets):
        got = a.xk_times_v_bcc(to_block_bucket(a, J), torch.from_numpy(V))
        if dtype == torch.float32:
            want = b.xk_times_v_bcc(j_to_block_bucket(b, J), jnp.asarray(V))
            _close(got, want, dict(rtol=1e-6, atol=1e-6),
                   max(1.0, float(np.abs(np.asarray(want)).max(initial=0.0))))
        else:
            _close(got, b.xk_times_v(jnp.asarray(V)))
        assert got.dtype == dtype
    assert gather_matmul.LAUNCHES["gather_matmul"] == 0
    with pytest.raises(ValueError, match="multiple"):
        ops.gather_matmul(torch.zeros((1, 2, 1, 128)), torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros((100, 3)))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _stage_inputs(name, dtype, R, seed):
    bt, bj = _pair(name, dtype)
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    H, V, W = (rng.standard_normal(s).astype(npdt)
               for s in ((R, R), (bt.n_cols, R), (bt.n_subjects, R)))
    for a, b in zip(bt.buckets, bj.buckets):
        Q = rng.standard_normal((a.kb, a.i_pad, R)).astype(npdt)
        Wb = W[_np(a.subject_ids)]
        yield a, b, (torch.from_numpy(H), jnp.asarray(H)), (torch.from_numpy(V), jnp.asarray(V)), \
            (torch.from_numpy(Q), jnp.asarray(Q)), (torch.from_numpy(Wb), jnp.asarray(Wb))


@pytest.mark.parametrize("name", SMALL)
def test_sparse_backend_stages_match_reference(name):
    """Every bucket stage of the port's ``scoo`` route against the
    reference's ``SparseBackend``, f64, 1e-12, each from its own upstream."""
    port, ref = get_backend("scoo"), j_get_backend("scoo")
    for a, b, (Ht, Hj), (Vt, Vj), (Qt, Qj), (Wt, Wj) in _stage_inputs(name, torch.float64, 5, 2):
        XkV_t, B_t = port.procrustes_b_bucket(a, Ht, Wt, Vt)
        XkV_j, B_j = ref.procrustes_b_bucket(b, Hj, Wj, Vj)
        _close(XkV_t, XkV_j)
        _close(B_t, B_j)
        pt, pj = port.project_bucket(a, Qt), ref.project_bucket(b, Qj)
        _close(pt, pj)            # both carry Q
        _close(port.mode1_xkv_bucket(a, Qt, XkV_t, Wt), ref.mode1_xkv_bucket(b, Qj, XkV_j, Wj))
        _close(port.mode1_bucket(a, pt, Wt, Vt), ref.mode1_bucket(b, pj, Wj, Vj))
        _close(port.mode2_bucket(a, pt, Ht, Wt), ref.mode2_bucket(b, pj, Hj, Wj))
        G_t, G_j = port.ykv_bucket(a, pt, Vt), ref.ykv_bucket(b, pj, Vj)
        _close(G_t, G_j)
        _close(port.mode3_bucket(a, pt, Ht, YkV=G_t), ref.mode3_bucket(b, pj, Hj, YkV=G_j))
        _close(port.mode3_bucket(a, pt, Ht, Vt), ref.mode3_bucket(b, pj, Hj, Vj))


@pytest.mark.parametrize("name", SMALL)
def test_staged_scoo_stages_match_pallas_backend(name):
    """``StagedBackend`` on SCOO buckets (the two SCOO wrappers, then the
    staged ones on their Yc) against ``PallasBackend``'s, f32."""
    port, ref = get_backend("staged"), j_get_backend("pallas")
    tol = dict(rtol=1e-6, atol=1e-6)
    for a, b, (Ht, Hj), (Vt, Vj), (Qt, Qj), (Wt, Wj) in _stage_inputs(name, torch.float32, 5, 3):
        XkV_t, B_t = port.procrustes_b_bucket(a, Ht, Wt, Vt)
        XkV_j, B_j = ref.procrustes_b_bucket(b, Hj, Wj, Vj)
        s = _prefix_scale(_np(a.vals), _np(a.lcols), _np(a.gather_v(Vt)))
        _close(XkV_t, XkV_j, tol, s)
        Yt, Yj = port.project_bucket(a, Qt), ref.project_bucket(b, Qj)
        _close(Yt, Yj, tol, _prefix_scale(_np(a.vals), _np(a.rows), Qt.numpy()))
        for got, want in ((port.mode1_xkv_bucket(a, Qt, XkV_t, Wt),
                           ref.mode1_xkv_bucket(b, Qj, XkV_j, Wj)),
                          (port.mode2_bucket(a, Yt, Ht, Wt), ref.mode2_bucket(b, Yj, Hj, Wj)),
                          (port.ykv_bucket(a, Yt, Vt), ref.ykv_bucket(b, Yj, Vj)),
                          (port.mode3_bucket(a, Yt, Ht, Vt), ref.mode3_bucket(b, Yj, Hj, Vj))):
            _close(got, want, tol, max(1.0, float(np.abs(np.asarray(want)).max(initial=0.0))))


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 choa_like(0.002) buckets in the SCOO and auto
    formats, the reference's state0 and its 20-iteration ``scoo`` fits."""
    out = {}
    j_data, t_data = j_choa_like(scale=0.002, seed=0), choa_like(scale=0.002, seed=0)
    for fmt in ("scoo", "auto"):
        bj = j_bucketize(j_data, dtype=jnp.float64, format=fmt)
        s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float64, backend="scoo"), seed=0)
        hist = np.asarray(j_fit(bj, JOptions(rank=5, dtype=jnp.float64, backend="scoo"),
                                max_iters=ITERS, tol=0.0, state=s0)[1])
        out[fmt] = dict(bj=bj, s0=s0, hist=hist,
                        bt=bucketize(t_data, device="cpu", dtype=torch.float64, format=fmt),
                        arrays={k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")})
    return out


# port route -> the reference route it counts its stages against
TALLY_PAIRS = [("torch", "jnp"), ("scoo", "scoo"), ("staged", "pallas"), ("fused", "fused")]


@pytest.mark.parametrize("port_route,ref_route", TALLY_PAIRS)
def test_stage_tally_matches_reference(choa, port_route, ref_route):
    """The streaming stage calls of one iteration on SCOO buckets, by name
    and count, as the reference's route counts them."""
    c = choa["scoo"]
    state0 = state_from_arrays(c["arrays"], device="cpu", dtype=torch.float64)
    with dispatch_tally() as tally:
        als_step(c["bt"], state0, Parafac2Options(rank=5, dtype=torch.float64,
                                                  backend=port_route))
    jopts = JOptions(rank=5, dtype=jnp.float64, backend=ref_route)
    with j_dispatch_tally() as j_tally:
        jax.eval_shape(lambda s: j_als_step(c["bj"], s, jopts), c["s0"])
    assert collections.Counter(tally) == collections.Counter(j_tally)
    per_bucket = sum(tally.values()) / len(c["bt"].buckets)
    assert per_bucket == (4.0 if port_route in ("scoo", "fused") else 5.0)


@pytest.mark.parametrize("format", ["scoo", "auto"])
@pytest.mark.parametrize("backend", ["scoo", "staged", "auto", "fused", "torch"])
def test_host_fit_history_matches_reference_scoo_fit(choa, format, backend):
    """choa 0.002, rank 5, 20 iterations, f64, from the reference's state0:
    every route keeps the reference's ``scoo`` fit history to 1e-8 and
    launches nothing on the CPU."""
    c = choa[format]
    state0 = state_from_arrays(c["arrays"], device="cpu", dtype=torch.float64)
    decompose.reset_launches()
    _, hist = fit(c["bt"], Parafac2Options(rank=5, dtype=torch.float64, backend=backend),
                  max_iters=ITERS, tol=0.0, state=state0)
    assert len(hist) == ITERS and np.all(np.isfinite(hist))
    assert np.max(np.abs(np.asarray(hist) - c["hist"])) <= 1e-8
    assert not any(decompose.kernel_launches().values())


def test_f32_staged_scoo_fit_matches_reference_pallas_fit():
    """f32, a small planted geometry in SCOO: the staged route's fit history
    within 1e-4 of the reference's pallas route (interpret mode), same state0."""
    kw = dict(n_subjects=12, n_cols=24, max_rows=16, rank=3, density=0.3, seed=7)
    bkw = dict(max_buckets=2, col_align=4, format="scoo")
    bj = j_bucketize(j_random_parafac2(**kw)[0], dtype=jnp.float32, **bkw)
    bt = bucketize(random_parafac2(**kw)[0], device="cpu", dtype=torch.float32, **bkw)
    assert all(isinstance(b, SparseBucket) for b in bt.buckets)
    jopts = JOptions(rank=3, dtype=jnp.float32, backend="pallas")
    s0 = j_init_state(bj, jopts, seed=0)
    _, want = j_fit(bj, jopts, max_iters=5, tol=0.0, state=s0)
    state0 = state_from_arrays({k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")},
                               device="cpu", dtype=torch.float32)
    _, got = fit(bt, Parafac2Options(rank=3, dtype=torch.float32, backend="staged"),
                 max_iters=5, tol=0.0, state=state0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mixed_format_fit_matches_reference():
    """``format="auto"`` on data with dense and sparse subjects gives a
    mixed Bucketed in both packages; the f64 fits agree to 1e-8."""
    dense = j_random_parafac2(n_subjects=6, n_cols=20, max_rows=10, rank=3, density=0.9,
                              seed=1)[0].subjects
    sparse = j_random_irregular(n_subjects=6, n_cols=20, min_rows=40, max_rows=45,
                                avg_nnz_per_subject=40, seed=2).subjects
    subs = [(s.rows, s.cols, s.vals, s.n_rows, s.n_cols) for s in dense + sparse]
    t_data = IrregularCOO([SubjectCOO(*s) for s in subs], 20)
    j_data = JIrregularCOO([JSubjectCOO(*s) for s in subs], 20)
    bkw = dict(max_buckets=2, col_align=4, format="auto")
    bt = bucketize(t_data, device="cpu", dtype=torch.float64, **bkw)
    bj = j_bucketize(j_data, dtype=jnp.float64, **bkw)
    assert sorted(bucket_format(b) for b in bt.buckets) == ["cc", "scoo"]
    jopts = JOptions(rank=3, dtype=jnp.float64, backend="jnp")
    s0 = j_init_state(bj, jopts, seed=0)
    _, want = j_fit(bj, jopts, max_iters=8, tol=0.0, state=s0)
    state0 = state_from_arrays({k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")},
                               device="cpu", dtype=torch.float64)
    for backend in ("torch", "scoo", "staged", "fused"):
        _, got = fit(bt, Parafac2Options(rank=3, dtype=torch.float64, backend=backend),
                     max_iters=8, tol=0.0, state=state0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_decompose_scoo_cpu_json_matches_reference_keys(tmp_path):
    """``--format scoo --device cpu`` emits the reference's summary keys and
    per-bucket records (format, density, nnz_pad, shapes)."""
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "3",
             "--tol", "1e-7", "--seed", "0", "--format", "scoo", "--backend", "scoo"]
    port = decompose.main(flags + ["--device", "cpu", "--json", str(tmp_path / "p.json")])
    want = j_decompose.main(flags + ["--json", str(tmp_path / "r.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads(json.dumps(port))
    assert not set(want) - set(got)
    assert got["resolved_options"] == want["resolved_options"]
    for k in ("format", "backend", "n_subjects", "n_cols", "nnz", "iters"):
        assert got[k] == want[k], k
    assert [{k: v for k, v in r.items() if k != "device_bytes"} for r in got["buckets"]] == \
        [{k: v for k, v in r.items() if k != "device_bytes"} for r in want["buckets"]]
    assert all(r["format"] == "scoo" for r in got["buckets"])
    assert got["kernel_launches"] == dict.fromkeys(
        fused.KERNELS + staged.KERNELS + scoo.KERNELS + gather_matmul.KERNELS
        + polar.KERNELS + tridiag.KERNELS, 0)
    assert len(got["fit_history"]) == 3 and np.all(np.isfinite(got["fit_history"]))


@pytest.mark.parametrize("format", ["scoo", "auto"])
@pytest.mark.parametrize("backend", ["staged", "scoo", "auto"])
def test_decompose_format_runs_on_cpu_and_raises_without_cuda(monkeypatch, format, backend):
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "2",
             "--format", format, "--backend", backend]
    got = decompose.main(flags + ["--device", "cpu"])
    assert got["format"] == format and len(got["fit_history"]) == 2
    assert all(r["format"] == "scoo" for r in got["buckets"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        decompose.main(flags)


def test_scoo_backend_registered():
    assert get_backend("scoo").name == "scoo"
    assert get_backend("scoo", "cuda").name == "scoo"
    assert get_backend("auto", "cuda").name == "fused"
    assert get_backend("auto", "cpu").name == "torch"


def _scoo_arrays(n_rows, C, N, nnz, seed, one_col=False, one_row=False):
    """SCOO arrays of one bucket, laid out as ``bucketize`` lays them out:
    subject k's nnz[k] triplets sorted by (row, column), pads past them,
    ``row_ends`` the row segments' ends, ``cperm`` the stable column order
    and ``col_ends`` its segment ends. ``one_col``/``one_row`` put every
    triplet of a subject in column 0 / row 0."""
    rng = np.random.default_rng(seed)
    Kb = len(nnz)
    out = dict(vals=np.zeros((Kb, N), np.float64), rows=np.zeros((Kb, N), np.int32),
               lcols=np.zeros((Kb, N), np.int32), row_ends=np.zeros((Kb, n_rows), np.int32),
               cperm=np.tile(np.arange(N, dtype=np.int32), (Kb, 1)),
               col_ends=np.zeros((Kb, C), np.int32), nnz_counts=np.asarray(nnz, np.int32))
    for k, n in enumerate(nnz):
        r = rng.integers(0, n_rows, n)
        c = np.zeros(n, np.int64) if one_col else rng.integers(0, C, n)
        if one_row:
            r[:] = 0
        o = np.lexsort((c, r))
        out["vals"][k, :n] = rng.standard_normal(n)
        out["rows"][k, :n], out["lcols"][k, :n] = r[o], c[o]
        out["row_ends"][k] = np.cumsum(np.bincount(r, minlength=n_rows))
        out["cperm"][k, :n] = np.argsort(c[o], kind="stable")
        out["col_ends"][k] = np.cumsum(np.bincount(c, minlength=C))
    return out


# (I, C, N, nnz per subject, R, one column): the shapes at the edges of row
# 12's CUDA variants (an empty subject; a column segment of length N; N and I
# past the ring's shared-memory stages; R = 72), held here through the plain
# version
PROJECT_EDGES = [(8, 16, 64, (64, 0, 10), 5, True), (40, 128, 3000, (3000, 17, 0), 5, False),
                 (1000, 32, 40, (40, 0, 33), 8, False), (24, 32, 96, (96, 50, 0, 1), 72, False)]


@pytest.mark.parametrize("edge", PROJECT_EDGES, ids=lambda e: "I{}-C{}-N{}-R{}".format(
    e[0], e[1], e[2], e[4]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_project_edges_match_reference(edge, dtype):
    """scoo_project (its plain version on the CPU) at the edge shapes against
    the reference's ``project_pallas`` in interpret mode (f32, atol 1e-6 of
    the largest running sum) or its sorted jnp ``project`` (f64, 1e-12);
    empty segments are exact zeros."""
    n_rows, C, N, nnz, R, one_col = edge
    a = _scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_col=one_col)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a["vals"] = a["vals"].astype(npdt)
    a["Q"] = np.random.default_rng(R).standard_normal((len(nnz), n_rows, R)).astype(npdt)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    got = scoo.scoo_project(t["vals"], t["rows"], t["lcols"], t["Q"], C, cperm=t["cperm"],
                            col_ends=t["col_ends"])
    if dtype == torch.float32:
        want = j_scoo.project_pallas(j["vals"], j["rows"], j["lcols"], j["Q"], C,
                                     nnz_counts=j["nnz_counts"], interpret=True)
        _close(got, want, dict(rtol=1e-6, atol=1e-6), _prefix_scale(a["vals"], a["rows"], a["Q"]))
    else:
        _close(got, j_scoo.project(j["vals"], j["rows"], j["lcols"], j["Q"], C,
                                   cperm=j["cperm"], col_ends=j["col_ends"]))
    starts = np.concatenate([np.zeros((len(nnz), 1), np.int32), a["col_ends"][:, :-1]], 1)
    empty = torch.from_numpy(a["col_ends"] == starts)[:, None, :].expand(-1, R, -1)
    assert torch.all(got[empty] == 0)


def test_project_variant_is_a_question_for_the_card():
    """Row 12's variant is the CUDA launcher's choice: asking it for CPU
    operands raises before any kernel library is built or loaded."""
    idx = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        scoo.scoo_project_variant(torch.rand((3, 8)), idx, idx, torch.rand((3, 4, 5)), 6,
                                  cperm=idx, col_ends=torch.zeros((3, 6), dtype=torch.int32))
    assert scoo.LIB._lib is None


# (I, C, N, nnz per subject, R, one row, offset of vals' start in elements):
# the shapes at the edges of row 11's CUDA variants (the main path's
# geometry; a row segment of length N, empty rows and an empty subject; runs
# not whole 16-byte packs; an unaligned start; N and I past the ring's
# stages; R = 72; more subjects than the persistent grid's walkers), held
# here through the plain version
XKV_EDGES = [(48, 128, 136, (115,) * 30 + (0,), 5, False, 0), (8, 16, 64, (64, 0, 10), 5, True, 0),
             (5, 9, 13, (13, 2, 0, 7, 5), 5, False, 0), (8, 16, 24, (24, 3, 0, 9), 5, False, 1),
             (40, 128, 3000, (3000, 17, 0), 5, False, 0), (1000, 32, 40, (40, 0, 33), 8, False, 0),
             (8, 8, 24, (24, 3, 0, 9), 72, False, 0),
             (8, 16, 24, tuple(range(24)) * 420, 5, False, 0)]


@pytest.mark.parametrize("edge", XKV_EDGES, ids=lambda e: "I{}-C{}-N{}-Kb{}-R{}-off{}".format(
    e[0], e[1], e[2], len(e[3]), e[4], e[6]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_xk_times_v_edges_match_reference(edge, dtype):
    """scoo_xk_times_v (its plain version on the CPU) at the edge shapes
    against the reference's ``xk_times_v_pallas`` in interpret mode (f32,
    atol 1e-6 of the largest running sum) or its sorted jnp ``xk_times_v``
    (f64, 1e-12); empty rows and subjects are exact zeros."""
    n_rows, C, N, nnz, R, one_row, offset = edge
    a = _scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_row=one_row)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a["vals"] = a["vals"].astype(npdt)
    a["Vg"] = np.random.default_rng(R).standard_normal((len(nnz), C, R)).astype(npdt)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    vals = torch.empty(a["vals"].size + offset, dtype=dtype)[offset:].view(a["vals"].shape)
    got = scoo.scoo_xk_times_v(vals.copy_(t["vals"]), t["rows"], t["lcols"], t["Vg"], n_rows,
                               row_ends=t["row_ends"])
    if dtype == torch.float32:
        want = j_scoo.xk_times_v_pallas(j["vals"], j["rows"], j["lcols"], j["Vg"], n_rows,
                                        nnz_counts=j["nnz_counts"], interpret=True)
        _close(got, want, dict(rtol=1e-6, atol=1e-6),
               _prefix_scale(a["vals"], a["lcols"], a["Vg"]))
    else:
        _close(got, j_scoo.xk_times_v(j["vals"], j["rows"], j["lcols"], j["Vg"], n_rows,
                                      row_ends=j["row_ends"]))
    starts = np.concatenate([np.zeros((len(nnz), 1), np.int32), a["row_ends"][:, :-1]], 1)
    empty = torch.from_numpy(a["row_ends"] == starts)[..., None].expand(-1, -1, R)
    assert torch.all(got[empty] == 0)


def test_xk_times_v_variant_is_a_question_for_the_card():
    """Row 11's variant is the CUDA launcher's choice: asking it for CPU
    operands raises before any kernel library is built or loaded."""
    idx = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        scoo.scoo_xk_times_v_variant(torch.rand((3, 8)), idx, idx, torch.rand((3, 6, 5)), 4,
                                     row_ends=torch.zeros((3, 4), dtype=torch.int32))
    assert scoo.LIB._lib is None
