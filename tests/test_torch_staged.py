"""The staged route of the port (``backend="staged"``, the reference's
``pallas``) against the JAX package's.

Per module, the port's staged functions (their plain versions on the CPU)
are held against the reference's Pallas kernels in interpret mode in f32
(atol 1e-6 of the output's largest magnitude: the two frameworks sum in
different orders) and against ``repro.kernels.ref`` in f64 (1e-12), on the
same numpy inputs, over the reference's geometries of
``tests/test_backend.py`` and an empty bucket. Then the slice as a whole:
the backend's bucket stages against ``PallasBackend``'s, the stage tally,
the choa 0.002 rank-5 f64 fit history from the reference's state0 within
1e-8 of its ``jnp`` host fit (``mode1_reuse`` on and off), an f32 fit
against the reference's ``pallas`` fit within 1e-4, and the launcher. The
CUDA kernels themselves are held against these plain versions in
``test_torch_cuda.py``.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, als_step as j_als_step,  # noqa: E402
                        bucketize as j_bucketize, fit as j_fit, init_state as j_init_state)
from repro.core.backend import dispatch_tally as j_dispatch_tally  # noqa: E402
from repro.core.backend import get_backend as j_get_backend  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.mttkrp_mode1 import mode1_pallas, mode1_reuse_pallas  # noqa: E402
from repro.kernels.mttkrp_mode2 import mode2_compact_pallas  # noqa: E402
from repro.kernels.mttkrp_mode3 import mode3_pallas, mode3_reuse_pallas  # noqa: E402
from repro.kernels.ykv import ykv_pallas  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro.sparse import random_parafac2 as j_random_parafac2  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, als_step, bucketize, fit  # noqa: E402
from repro_torch.core.backend import dispatch_tally, get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import fused, gather_matmul, ops, polar, scoo, staged, tridiag  # noqa: E402
from repro_torch.kernels.mttkrp_mode1 import mode1, mode1_reuse  # noqa: E402
from repro_torch.kernels.mttkrp_mode2 import mode2_compact  # noqa: E402
from repro_torch.kernels.mttkrp_mode3 import mode3, mode3_reuse  # noqa: E402
from repro_torch.kernels.ykv import ykv  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import random_irregular, random_parafac2  # noqa: E402

# the geometries of tests/test_backend.py: odd/unaligned (R=5, col_align=4),
# aligned (R=8, col_align=128), rank 1, and subject padding inside buckets
GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
]
TOLS = {torch.float32: dict(rtol=1e-6, atol=1e-6),
        torch.float64: dict(rtol=1e-12, atol=1e-12)}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
ITERS = 20


def _close(port, want, tol):
    """assert_allclose at ``tol``; in f32 the atol scales with the output's
    largest magnitude (sums taken in another order differ by a rounding of
    the largest partial sum), in f64 it is absolute."""
    port, want = port.cpu().numpy(), np.asarray(want)
    assert port.shape == want.shape
    atol = tol["atol"]
    if port.dtype == np.float32:
        atol *= max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(port, want, rtol=tol["rtol"], atol=atol)


def _operands(dtype, *, seed, K, J, R, col_align, subject_align=1):
    """Per bucket, the staged kernels' operands as numpy arrays, built once
    from the reference's buckets: Yc, Vg, Wb, H, YkV and the masks."""
    data = j_random_irregular(n_subjects=K, n_cols=J, max_rows=9,
                              avg_nnz_per_subject=18, seed=seed)
    bt = j_bucketize(data, max_buckets=2, dtype=jnp.float64, col_align=col_align,
                     subject_align=subject_align)
    rng = np.random.default_rng(seed)
    H, V, W = (rng.standard_normal(s) for s in ((R, R), (J, R), (K, R)))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    for b in bt.buckets:
        vals, cols, cm = (np.asarray(x) for x in (b.vals, b.cols, b.col_mask))
        Q = rng.standard_normal((b.kb, b.i_pad, R))
        Vg = V[cols] * cm[..., None]
        Yc = np.einsum("kir,kic->krc", Q, vals)
        yield {k: a.astype(npdt) for k, a in dict(
            Yc=Yc, Vg=Vg, Wb=W[np.asarray(b.subject_ids)], H=H,
            YkV=np.einsum("krc,kcl->krl", Yc, Vg), cm=cm,
            sm=np.asarray(b.subject_mask)).items()}


def _both(op):
    """The port's tensors and the reference's arrays of the same numpy."""
    return ({k: torch.tensor(v) for k, v in op.items()},
            {k: jnp.asarray(v) for k, v in op.items()})


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ykv_matches_reference(geom, dtype):
    for op in _operands(dtype, **geom):
        t, j = _both(op)
        if dtype == torch.float32:
            want = ykv_pallas(j["Yc"], j["Vg"], interpret=True)
        else:
            want = j_ref.ykv_ref(j["Yc"], j["Vg"])
        _close(ykv(t["Yc"], t["Vg"]), want, TOLS[dtype])


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode1_matches_reference(geom, dtype):
    """Both forms, full and YkV-reuse, with the subject mask folded in."""
    for op in _operands(dtype, **geom):
        t, j = _both(op)
        if dtype == torch.float32:
            want = mode1_pallas(j["Yc"], j["Vg"], j["Wb"], j["sm"], interpret=True)
            want_r = mode1_reuse_pallas(j["YkV"], j["Wb"], j["sm"], interpret=True)
        else:
            Wb = j["Wb"] * j["sm"][:, None]
            want = j_ref.mode1_ref(j["Yc"], j["Vg"], Wb)
            want_r = j_ref.mode1_reuse_ref(j["YkV"], Wb)
        _close(mode1(t["Yc"], t["Vg"], t["Wb"], t["sm"]), want, TOLS[dtype])
        _close(mode1_reuse(t["YkV"], t["Wb"], t["sm"]), want_r, TOLS[dtype])


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode2_compact_matches_reference(geom, dtype):
    """Masked columns and masked subjects give exact zeros, as the sorted
    segment scatter needs."""
    for op in _operands(dtype, **geom):
        t, j = _both(op)
        if dtype == torch.float32:
            want = mode2_compact_pallas(j["Yc"], j["H"], j["Wb"], j["cm"], j["sm"],
                                        interpret=True)
        else:
            want = j_ref.mode2_compact_ref(j["Yc"], j["H"], j["Wb"] * j["sm"][:, None])
            want = want * j["cm"][..., None]
        got = mode2_compact(t["Yc"], t["H"], t["Wb"], t["cm"], t["sm"])
        _close(got, want, TOLS[dtype])
        pad = (t["cm"] == 0) | (t["sm"][:, None] == 0)
        assert torch.all(got[pad] == 0)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode3_matches_reference(geom, dtype):
    """Both forms, full and YkV-reuse; rows of padded subjects are 0."""
    for op in _operands(dtype, **geom):
        t, j = _both(op)
        if dtype == torch.float32:
            want = mode3_pallas(j["Yc"], j["Vg"], j["H"], j["sm"], interpret=True)
            want_r = mode3_reuse_pallas(j["YkV"], j["H"], j["sm"], interpret=True)
        else:
            want = j_ref.mode3_ref(j["Yc"], j["Vg"], j["H"]) * j["sm"][:, None]
            want_r = j_ref.mode3_reuse_ref(j["YkV"], j["H"]) * j["sm"][:, None]
        _close(mode3(t["Yc"], t["Vg"], t["H"], t["sm"]), want, TOLS[dtype])
        _close(mode3_reuse(t["YkV"], t["H"], t["sm"]), want_r, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empty_bucket_returns_zeros_without_a_launch(dtype):
    """K = 0: zeros of the reference's shapes and dtypes from every staged
    function, and no launch."""
    R, C = 3, 12
    jd = JDT[dtype]
    Yc, Vg = torch.zeros((0, R, C), dtype=dtype), torch.zeros((0, C, R), dtype=dtype)
    YkV, Wb = torch.zeros((0, R, R), dtype=dtype), torch.zeros((0, R), dtype=dtype)
    H, cm = torch.eye(R, dtype=dtype), torch.zeros((0, C), dtype=dtype)
    sm = torch.zeros(0, dtype=dtype)
    jYc, jVg, jYkV, jWb, jcm, jsm = (jnp.zeros(a.shape, jd) for a in (Yc, Vg, YkV, Wb, cm, sm))
    jH = jnp.eye(R, dtype=jd)
    staged.reset_launches()
    pairs = [
        (ykv(Yc, Vg), ykv_pallas(jYc, jVg, interpret=True)),
        (mode1(Yc, Vg, Wb, sm), mode1_pallas(jYc, jVg, jWb, jsm, interpret=True)),
        (mode1_reuse(YkV, Wb, sm), mode1_reuse_pallas(jYkV, jWb, jsm, interpret=True)),
        (mode2_compact(Yc, H, Wb, cm, sm),
         mode2_compact_pallas(jYc, jH, jWb, jcm, jsm, interpret=True)),
        (mode3(Yc, Vg, H, sm), mode3_pallas(jYc, jVg, jH, jsm, interpret=True)),
        (mode3_reuse(YkV, H, sm), mode3_reuse_pallas(jYkV, jH, jsm, interpret=True)),
    ]
    for port, want in pairs:
        assert tuple(port.shape) == tuple(want.shape) and port.dtype == dtype
        _close(port, want, dict(rtol=0, atol=0))
    assert sum(staged.LAUNCHES.values()) == 0


def test_all_padding_subjects_contribute_nothing():
    """A bucket whose subjects are all padding (mask 0) gives zeros through
    every staged function, as in the reference."""
    op = next(_operands(torch.float32, **GEOMETRIES[0]))
    op["sm"] = np.zeros_like(op["sm"])
    t, _ = _both(op)
    R = t["H"].shape[0]
    for got in (mode1(t["Yc"], t["Vg"], t["Wb"], t["sm"]),
                mode1_reuse(t["YkV"], t["Wb"], t["sm"]),
                mode2_compact(t["Yc"], t["H"], t["Wb"], t["cm"], t["sm"]),
                mode3(t["Yc"], t["Vg"], t["H"], t["sm"]),
                mode3_reuse(t["YkV"], t["H"], t["sm"])):
        assert torch.all(got == 0), got.shape
    assert mode1_reuse(t["YkV"], t["Wb"], t["sm"]).shape == (R, R)


def test_ops_dispatch_between_reuse_and_full_forms():
    """``ops`` takes the reuse form when YkV is given and the full form
    otherwise; both agree, and a missing col_mask keeps every column."""
    op = next(_operands(torch.float64, **GEOMETRIES[1]))
    t, _ = _both(op)
    tol = TOLS[torch.float64]
    YkV = ops.ykv(t["Yc"], t["Vg"])
    _close(ops.mttkrp_mode1(None, None, t["Wb"], subject_mask=t["sm"], YkV=YkV),
           ops.mttkrp_mode1(t["Yc"], t["Vg"], t["Wb"], subject_mask=t["sm"]), tol)
    _close(ops.mttkrp_mode3(None, None, t["H"], subject_mask=t["sm"], YkV=YkV),
           ops.mttkrp_mode3(t["Yc"], t["Vg"], t["H"], subject_mask=t["sm"]), tol)
    _close(ops.mttkrp_mode2_compact(t["Yc"], t["H"], t["Wb"]),
           (t["Yc"].transpose(1, 2) @ t["H"]) * t["Wb"][:, None, :], tol)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

STAGED = get_backend("staged")
J_PALLAS = j_get_backend("pallas")


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_bucket_stages_match_pallas_backend(geom):
    """Every bucket stage of ``StagedBackend`` against ``PallasBackend``'s,
    in f32, each side from its own upstream stage."""
    kw = dict(n_subjects=geom["K"], n_cols=geom["J"], max_rows=9,
              avg_nnz_per_subject=18, seed=geom["seed"])
    bkw = dict(max_buckets=2, col_align=geom["col_align"],
               subject_align=geom.get("subject_align", 1))
    bt_j = j_bucketize(j_random_irregular(**kw), dtype=jnp.float32, **bkw)
    bt_t = bucketize(random_irregular(**kw), device="cpu", dtype=torch.float32, **bkw)
    rng = np.random.default_rng(geom["seed"])
    R = geom["R"]
    H, V, W = (rng.standard_normal(s).astype(np.float32)
               for s in ((R, R), (geom["J"], R), (geom["K"], R)))
    Hj, Vj, Wj = map(jnp.asarray, (H, V, W))
    Ht, Vt, Wt = map(torch.tensor, (H, V, W))
    tol = TOLS[torch.float32]
    for bj, bt in zip(bt_j.buckets, bt_t.buckets):
        Q = rng.standard_normal((bj.kb, bj.i_pad, R)).astype(np.float32)
        Qj, Qt = jnp.asarray(Q), torch.tensor(Q)
        Wbj, Wbt = jnp.take(Wj, bj.subject_ids, 0), Wt[bt.subject_ids.long()]
        XkV_j, B_j = J_PALLAS.procrustes_b_bucket(bj, Hj, Wbj, Vj)
        XkV_t, B_t = STAGED.procrustes_b_bucket(bt, Ht, Wbt, Vt)
        _close(XkV_t, XkV_j, tol)
        _close(B_t, B_j, tol)
        Yc_j, Yc_t = J_PALLAS.project_bucket(bj, Qj), STAGED.project_bucket(bt, Qt)
        _close(Yc_t, Yc_j, tol)
        _close(STAGED.mode1_xkv_bucket(bt, Qt, XkV_t, Wbt),
               J_PALLAS.mode1_xkv_bucket(bj, Qj, XkV_j, Wbj), tol)
        _close(STAGED.mode1_bucket(bt, Yc_t, Wbt, Vt),
               J_PALLAS.mode1_bucket(bj, Yc_j, Wbj, Vj), tol)
        _close(STAGED.mode2_bucket(bt, Yc_t, Ht.T, Wbt),
               J_PALLAS.mode2_bucket(bj, Yc_j, Hj.T, Wbj), tol)
        G_j, G_t = J_PALLAS.ykv_bucket(bj, Yc_j, Vj), STAGED.ykv_bucket(bt, Yc_t, Vt)
        _close(G_t, G_j, tol)
        _close(STAGED.mode3_bucket(bt, Yc_t, Ht.T, YkV=G_t),
               J_PALLAS.mode3_bucket(bj, Yc_j, Hj.T, YkV=G_j), tol)
        _close(STAGED.mode3_bucket(bt, Yc_t, Ht, Vt),
               J_PALLAS.mode3_bucket(bj, Yc_j, Hj, Vj), tol)


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 CC buckets of choa_like(0.002), the reference's
    state0 and its 20-iteration host fit histories with and without
    mode1_reuse."""
    bj = j_bucketize(j_choa_like(scale=0.002, seed=0), dtype=jnp.float64)
    s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float64, backend="jnp"), seed=0)
    hist = {}
    for reuse in (True, False):
        jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", mode1_reuse=reuse)
        hist[reuse] = np.asarray(j_fit(bj, jopts, max_iters=ITERS, tol=0.0, state=s0)[1])
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=torch.float64)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return dict(bj=bj, bt=bt, s0=s0, arrays=arrays, hist=hist)


def test_stage_tally_matches_reference(choa):
    """Five streaming stage calls per bucket, with the reference's stage
    names and counts for backend="pallas"."""
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    with dispatch_tally() as tally:
        als_step(choa["bt"], state0, Parafac2Options(rank=5, dtype=torch.float64,
                                                     backend="staged"))
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="pallas")
    with j_dispatch_tally() as j_tally:
        jax.eval_shape(lambda s: j_als_step(choa["bj"], s, jopts), choa["s0"])
    assert sum(tally.values()) / len(choa["bt"].buckets) == 5.0
    assert collections.Counter(tally) == collections.Counter(j_tally)


@pytest.mark.parametrize("mode1_reuse", [True, False])
def test_host_fit_history_matches_reference(choa, mode1_reuse):
    """choa 0.002, rank 5, 20 iterations, f64, from the reference's state0:
    the staged route keeps the reference's jnp host fit history to 1e-8,
    and launches nothing on the CPU."""
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    staged.reset_launches()
    _, hist = fit(choa["bt"], Parafac2Options(rank=5, dtype=torch.float64,
                                              backend="staged", mode1_reuse=mode1_reuse),
                  max_iters=ITERS, tol=0.0, state=state0)
    assert len(hist) == ITERS and np.all(np.isfinite(hist))
    assert np.max(np.abs(np.asarray(hist) - choa["hist"][mode1_reuse])) <= 1e-8
    assert sum(staged.LAUNCHES.values()) == 0


def test_f32_fit_matches_reference_pallas_fit():
    """f32, a small planted geometry: the staged route's fit history within
    1e-4 of the reference's pallas route (interpret mode), same state0."""
    kw = dict(n_subjects=12, n_cols=24, max_rows=16, rank=3, density=0.8, seed=7)
    bkw = dict(max_buckets=2, col_align=4)
    bj = j_bucketize(j_random_parafac2(**kw)[0], dtype=jnp.float32, **bkw)
    bt = bucketize(random_parafac2(**kw)[0], device="cpu", dtype=torch.float32, **bkw)
    jopts = JOptions(rank=3, dtype=jnp.float32, backend="pallas")
    s0 = j_init_state(bj, jopts, seed=0)
    _, want = j_fit(bj, jopts, max_iters=5, tol=0.0, state=s0)
    state0 = state_from_arrays({k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")},
                               device="cpu", dtype=torch.float32)
    _, got = fit(bt, Parafac2Options(rank=3, dtype=torch.float32, backend="staged"),
                 max_iters=5, tol=0.0, state=state0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_decompose_staged_cpu_summary(tmp_path):
    """``--backend staged --device cpu`` runs; its summary has the auto
    run's keys, reads backend "staged" and counts every kernel (none
    launched on the CPU)."""
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "3",
             "--device", "cpu"]
    got = decompose.main(flags + ["--backend", "staged", "--json", str(tmp_path / "s.json")])
    auto = decompose.main(flags + ["--backend", "auto"])
    assert set(got) == set(auto)
    assert got["backend"] == "staged" and auto["backend"] == "auto"
    assert got["kernel_launches"] == dict.fromkeys(
        fused.KERNELS + staged.KERNELS + scoo.KERNELS + gather_matmul.KERNELS
        + polar.KERNELS + tridiag.KERNELS, 0)
    assert np.max(np.abs(np.asarray(got["fit_history"]) - auto["fit_history"])) <= 1e-5


def test_staged_backend_registered():
    """``get_backend("staged")`` resolves; ``auto`` stays ``fused`` on CUDA."""
    assert get_backend("staged").name == "staged"
    assert get_backend("staged", "cuda").name == "staged"
    assert get_backend("auto", "cuda").name == "fused"
    assert dataclasses.replace(Parafac2Options(rank=2), backend="staged").backend == "staged"


# (K, R, C): the shapes at the edges of row 8's CUDA variants (C not whole
# 16-byte runs, C not a multiple of the 128-wide tile, R = 72 at C = 1024,
# R too wide for the ring's tile), held here through the plain version
MODE2_EDGES = [(5, 5, 17), (4, 5, 1000), (3, 72, 1024), (3, 200, 40)]


@pytest.mark.parametrize("shape", MODE2_EDGES, ids=lambda s: "K{}-R{}-C{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode2_compact_edges_match_reference(shape, dtype):
    """mode2_compact at the edge shapes, a masked subject and masked columns
    included, against the reference's Pallas kernel in interpret mode (f32)
    or its ref (f64); masked entries are exact zeros."""
    K, R, C = shape
    rng = np.random.default_rng(K + R + C)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    op = {k: a.astype(npdt) for k, a in dict(
        Yc=rng.standard_normal((K, R, C)), H=rng.standard_normal((R, R)),
        Wb=rng.standard_normal((K, R)), cm=(rng.random((K, C)) < 0.7) * 1.0,
        sm=np.asarray([0.0] + [1.0] * (K - 1))).items()}
    t, j = _both(op)
    if dtype == torch.float32:
        want = mode2_compact_pallas(j["Yc"], j["H"], j["Wb"], j["cm"], j["sm"], interpret=True)
    else:
        want = j_ref.mode2_compact_ref(j["Yc"], j["H"], j["Wb"] * j["sm"][:, None])
        want = want * j["cm"][..., None]
    got = mode2_compact(t["Yc"], t["H"], t["Wb"], t["cm"], t["sm"])
    _close(got, want, TOLS[dtype])
    pad = (t["cm"] == 0) | (t["sm"][:, None] == 0)
    assert torch.all(got[pad] == 0)


def test_mode2_compact_variant_is_a_question_for_the_card():
    """Row 8's variant is the CUDA launcher's choice: asking it for a CPU Yc
    raises before any kernel library is built or loaded."""
    from repro_torch.kernels import mttkrp_mode2

    with pytest.raises(ValueError, match="CUDA"):
        mttkrp_mode2.mode2_compact_variant(torch.rand((3, 5, 16)), torch.ones((3, 16)))
    assert staged.LIB._lib is None


# (K, R, C, offset of Yc's start in elements): the shapes at the edges of
# row 5's CUDA variants (the main path's C; C not whole 16-byte runs; R = 72
# at C = 1024, too wide for the ring; an unaligned start; more groups than
# the persistent grid; one subject), held here through the plain version
YKV_EDGES = [(7, 5, 128, 0), (5, 5, 17, 0), (3, 72, 1024, 0), (5, 5, 128, 1),
             (3000, 5, 128, 0), (1, 5, 128, 0)]


@pytest.mark.parametrize("shape", YKV_EDGES, ids=lambda s: "K{}-R{}-C{}-off{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ykv_edges_match_reference(shape, dtype):
    """ykv at the edge shapes against the reference's Pallas kernel in
    interpret mode (f32) or its ref (f64)."""
    K, R, C, offset = shape
    rng = np.random.default_rng(K + R + C + offset)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    op = {k: a.astype(npdt) for k, a in dict(
        Yc=rng.standard_normal((K, R, C)), Vg=rng.standard_normal((K, C, R))).items()}
    t, j = _both(op)
    Yc = torch.empty(K * R * C + offset, dtype=dtype)[offset:].view(K, R, C).copy_(t["Yc"])
    if dtype == torch.float32:
        want = ykv_pallas(j["Yc"], j["Vg"], interpret=True)
    else:
        want = j_ref.ykv_ref(j["Yc"], j["Vg"])
    _close(ykv(Yc, t["Vg"]), want, TOLS[dtype])


def test_ykv_variant_is_a_question_for_the_card():
    """Row 5's variant is the CUDA launcher's choice: asking it for CPU
    operands raises before any kernel library is built or loaded."""
    from repro_torch.kernels import ykv as ykv_module

    with pytest.raises(ValueError, match="CUDA"):
        ykv_module.ykv_variant(torch.rand((3, 5, 16)), torch.rand((3, 16, 5)))
    assert staged.LIB._lib is None


# (K, R, C, offset of Yc's and YkV's starts in elements, subject mask): the
# edge shapes of rows 9 and 10's CUDA kernels (the main path's C; C = 17,
# rows not whole 16-byte runs; R = 72 at C = 1024, past row 9's ring; an
# unaligned start; one subject; R = 40, one subject a group; no, some and
# every subject masked), held here through the plain versions
MODE3_EDGES = [(7, 5, 128, 0, "some"), (5, 5, 17, 0, None), (3, 72, 1024, 0, "some"),
               (5, 5, 128, 1, "some"), (1, 5, 128, 0, None), (4, 40, 128, 0, "all")]


def _offset(t, offset):
    """A copy of ``t`` whose data starts ``offset`` elements into its storage."""
    return torch.empty(t.numel() + offset, dtype=t.dtype)[offset:].view(t.shape).copy_(t)


@pytest.mark.parametrize("shape", MODE3_EDGES, ids=lambda s: "K{}-R{}-C{}-off{}-mask{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode3_edges_match_reference(shape, dtype):
    """mode3 and mode3_reuse at the edge shapes against the reference's
    Pallas kernels in interpret mode (f32, to 1e-6 of the largest
    magnitude) or its ref (f64, to 1e-12); every subject masked gives exact
    zeros."""
    K, R, C, offset, mk = shape
    rng = np.random.default_rng(K + R + C + offset)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Yc, Vg, H = (rng.standard_normal(s) for s in ((K, R, C), (K, C, R), (R, R)))
    op = dict(Yc=Yc, Vg=Vg, H=H, YkV=np.einsum("krc,kcl->krl", Yc, Vg))
    if mk is not None:
        op["sm"] = np.ones(K)
        op["sm"][:: 1 if mk == "all" else 3] = 0.0
    t, j = _both({k: a.astype(npdt) for k, a in op.items()})
    sm, jsm = t.get("sm"), j.get("sm")
    if dtype == torch.float32:
        want = mode3_pallas(j["Yc"], j["Vg"], j["H"], jsm, interpret=True)
        want_r = mode3_reuse_pallas(j["YkV"], j["H"], jsm, interpret=True)
    else:
        scale = 1.0 if jsm is None else jsm[:, None]
        want = j_ref.mode3_ref(j["Yc"], j["Vg"], j["H"]) * scale
        want_r = j_ref.mode3_reuse_ref(j["YkV"], j["H"]) * scale
    got = mode3(_offset(t["Yc"], offset), t["Vg"], t["H"], sm)
    got_r = mode3_reuse(_offset(t["YkV"], offset), t["H"], sm)
    _close(got, want, TOLS[dtype])
    _close(got_r, want_r, TOLS[dtype])
    if mk == "all":
        assert not got.any() and not got_r.any()


def test_mode3_variant_is_a_question_for_the_card():
    """Row 9's variant is the CUDA launcher's choice: asking it for CPU
    operands raises before any kernel library is built or loaded."""
    from repro_torch.kernels import mttkrp_mode3

    with pytest.raises(ValueError, match="CUDA"):
        mttkrp_mode3.mode3_variant(torch.rand((3, 5, 16)), torch.rand((3, 16, 5)))
    assert staged.LIB._lib is None


# K below and past the 2048 runs of the mode-1 reduction kernels
# (csrc/staged.cu rows 6 and 7, csrc/fused.cu F2)
REDUCTION_K = [7, 2100]


def _reuse_op(K, R, dtype):
    rng = np.random.default_rng(K + R)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    sm = np.ones(K)
    sm[::3] = 0.0
    return {k: a.astype(npdt) for k, a in dict(
        YkV=rng.standard_normal((K, R, R)), Wb=rng.standard_normal((K, R)), sm=sm).items()}


@pytest.mark.parametrize("K", REDUCTION_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode1_reuse_matches_interpret_kernel_below_and_past_the_runs(K, dtype):
    """mode1_reuse with a subject mask against the reference's Pallas kernel
    in interpret mode, f64 to 1e-12 and f32 to FUSED_TOLS."""
    t, j = _both(_reuse_op(K, 5, dtype))
    want = mode1_reuse_pallas(j["YkV"], j["Wb"], j["sm"], interpret=True)
    got = mode1_reuse(t["YkV"], t["Wb"], t["sm"])
    _close(got, want, TOLS[dtype])


def _emulate_mode1_reuse(YkV, Wb, sm, threads=256, runs=2048, warp=32):
    """The summation order of rows 6 and 7's kernel (csrc/staged.cu), in
    numpy: min(K, runs) runs of ceil(K / runs) contiguous subjects; in a run,
    G = threads // R^2 groups, group g summing subjects g, g + G, ... of the
    run in order, and the run's partial the groups' sums added in order; then
    per entry, lane L of a warp sums runs L, L + 32, ... in order, and a
    butterfly over offsets 16, 8, 4, 2, 1 adds the lanes."""
    K, R, _ = YkV.shape
    RR = R * R
    y = YkV.reshape(K, RR)
    w = np.tile(Wb * sm[:, None], R)              # entry p = (r, l) takes w[l]
    n = min(K, runs)
    per, G = -(-K // n), max(1, threads // RR)
    partials = np.zeros((n, RR))
    for b in range(n):
        k0, k1 = b * per, min(K, b * per + per)
        accs = []
        for g in range(G):
            acc = np.zeros(RR)
            for k in range(k0 + g, k1, G):
                acc = acc + y[k] * w[k]
            accs.append(acc)
        s = accs[0] if G == 1 else np.zeros(RR)
        for a in accs if G > 1 else ():
            s = s + a
        partials[b] = s
    lanes = np.zeros((warp, RR))
    for lane in range(warp):
        for b in range(lane, n, warp):
            lanes[lane] = lanes[lane] + partials[b]
    off = warp // 2
    while off:
        lanes = lanes + lanes[np.arange(warp) ^ off]
        off //= 2
    return lanes[0].reshape(R, R)


@pytest.mark.parametrize("K", REDUCTION_K)
@pytest.mark.parametrize("R", [1, 5, 17])
def test_mode1_reuse_summation_order_matches_plain(K, R):
    """The kernel's order (runs, groups, lane stride, butterfly), emulated in
    f64, equals the plain version within 1e-12."""
    op = _reuse_op(K, R, torch.float64)
    want = mode1_reuse(*(torch.tensor(op[k]) for k in ("YkV", "Wb", "sm")))
    _close(torch.tensor(_emulate_mode1_reuse(op["YkV"], op["Wb"], op["sm"])),
           want.numpy(), TOLS[torch.float64])
