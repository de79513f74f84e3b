"""The port's CUDA kernels on a GPU (marker ``cuda``; each test skips without
a CUDA device, since the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only torch: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``. Each kernel (the four fused, the six staged) is
held against its plain version on the same inputs (f64 to 1e-12; f32 to
1e-6 relative plus 1e-6 of the output's largest magnitude, since the sums
run in another order), the fused and staged routes' fits against the torch
route's, and the kernels and the mode-2 scatter must give the same bits
twice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Parafac2Options, bucketize, fit  # noqa: E402
from repro_torch.core import spartan  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import fused, staged  # noqa: E402
from repro_torch.kernels import mttkrp_mode1 as m1  # noqa: E402
from repro_torch.kernels import mttkrp_mode2 as m2  # noqa: E402
from repro_torch.kernels import mttkrp_mode3 as m3  # noqa: E402
from repro_torch.kernels import ykv as yk  # noqa: E402
from repro_torch.kernels.common import fold_subject_mask  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
    dict(seed=4, K=10, J=90, R=40, col_align=8),      # the reference's widest cell
    dict(seed=5, K=8, J=150, R=72, col_align=8),      # past the 64-wide register tile
    dict(seed=6, K=6, J=120, R=40, col_align=1024),   # C_pad = 1024 (chunked Vg in f64)
    dict(seed=7, K=4, J=60, R=72, col_align=1024, max_rows=700),   # every tile chunked
]
KERNELS = {   # name -> (wrapper, plain version)
    "fused_procrustes_b": (fused.fused_procrustes_b, fused.procrustes_b_plain),
    "fused_mode1_xkv": (fused.fused_mode1_xkv, fused.mode1_xkv_plain),
    "fused_mode2_compact": (fused.fused_mode2_compact, fused.mode2_compact_plain),
    "fused_ykv": (fused.fused_ykv, fused.ykv_plain),
    "ykv": (yk.ykv, yk.ykv_plain),
    "mode1": (m1.mode1, m1.mode1_plain),
    "mode1_reuse": (m1.mode1_reuse, m1.mode1_reuse_plain),
    "mode2_compact": (m2.mode2_compact, m2.mode2_compact_plain),
    "mode3": (m3.mode3, m3.mode3_plain),
    "mode3_reuse": (m3.mode3_reuse, m3.mode3_reuse_plain),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return {**fused.LAUNCHES, **staged.LAUNCHES}


def _buckets_and_args(dtype, dev, *, seed, K, J, R, col_align, subject_align=1,
                      max_rows=9):
    data = random_irregular(n_subjects=K, n_cols=J, max_rows=max_rows,
                            avg_nnz_per_subject=18, seed=seed)
    bt = bucketize(data, max_buckets=2, dtype=dtype, device=dev,
                   col_align=col_align, subject_align=subject_align)
    rng = np.random.default_rng(seed)
    H, V, W = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
               for s in ((R, R), (J, R), (K, R)))
    for b in bt.buckets:
        Q = torch.tensor(rng.standard_normal((b.kb, b.i_pad, R)), dtype=dtype, device=dev)
        Vg = b.gather_v(V)
        Wb = fold_subject_mask(W[b.subject_ids.long()], b.subject_mask)
        Yc = b.project(Q)
        YkV = torch.bmm(Yc, Vg)
        yield {
            "fused_procrustes_b": (b.vals, Vg, Wb, H),
            "fused_mode1_xkv": (Q, b.xk_times_v(V, Vg), Wb),
            "fused_mode2_compact": (b.vals, Q, H, Wb, b.col_mask),
            "fused_ykv": (b.vals, Q, Vg),
            "ykv": (Yc, Vg),
            "mode1": (Yc, Vg, Wb),
            "mode1_reuse": (YkV, Wb),
            "mode2_compact": (Yc, H, Wb, b.col_mask),
            "mode3": (Yc, Vg, H, b.subject_mask),
            "mode3_reuse": (YkV, H, b.subject_mask),
        }


def _assert_matches(got, want, dtype):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = 1.0 if dtype == torch.float64 else max(1.0, float(w.abs().max()))
        tol = 1e-12 if dtype == torch.float64 else 1e-6
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain(dev, geom, dtype):
    for args in _buckets_and_args(dtype, dev, **geom):
        for name, a in args.items():
            wrapper, plain = KERNELS[name]
            before = _launches()[name]
            got = wrapper(*a)
            torch.cuda.synchronize()
            assert _launches()[name] == before + 1, name
            _assert_matches(got, plain(*a), dtype)


@pytest.mark.cuda
def test_kernels_and_scatter_are_deterministic(dev):
    """Two runs of every kernel give the same bits, the cross-subject
    reductions (fused_mode1_xkv, mode1, mode1_reuse) included."""
    for geom in (GEOMETRIES[0], GEOMETRIES[5]):
        args = next(_buckets_and_args(torch.float32, dev, **geom))
        for name, a in args.items():
            first, second = KERNELS[name][0](*a), KERNELS[name][0](*a)
            for x, y in zip(first if isinstance(first, tuple) else (first,),
                            second if isinstance(second, tuple) else (second,)):
                assert torch.equal(x, y), name
    A = torch.randn((300, 40, 5), device=dev)
    cols = torch.randint(0, 97, (300, 40), device=dev, dtype=torch.int32)
    assert torch.equal(spartan.mode2_scatter(A, cols, 97), spartan.mode2_scatter(A, cols, 97))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(dev):
    """A dtype other than f32/f64 and non-contiguous operands raise; a rank
    past the widest register tile (R = 72) is taken and matches the plain
    version."""
    vals = torch.rand((3, 8, 12), device=dev, dtype=torch.float16)
    Vg = torch.rand((3, 12, 4), device=dev, dtype=torch.float16)
    Wb, H = torch.rand((3, 4), device=dev, dtype=torch.float16), torch.eye(4, device=dev)
    with pytest.raises(TypeError):
        fused.fused_procrustes_b(vals, Vg, Wb, H.half())
    with pytest.raises(TypeError):
        yk.ykv(torch.rand((3, 4, 12), device=dev, dtype=torch.float16), Vg)
    v32 = vals.float()
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_ykv(v32, torch.rand((3, 4, 8), device=dev).transpose(1, 2), Vg.float())
    with pytest.raises(ValueError, match="contiguous"):
        m3.mode3_reuse(torch.rand((3, 4, 4), device=dev), torch.rand((4, 4), device=dev).T)
    R = 72
    Q, Vg72 = torch.rand((3, 8, R), device=dev), torch.rand((3, 12, R), device=dev)
    _assert_matches(fused.fused_ykv(v32, Q, Vg72), fused.ykv_plain(v32, Q, Vg72),
                    torch.float32)


@pytest.mark.cuda
def test_fused_fit_matches_torch_route_on_gpu(dev):
    """choa 0.002, rank 5, 20 iterations, f64: the kernels keep the torch
    route's fit history to 1e-8, and each launches buckets x iterations."""
    bt = bucketize(choa_like(scale=0.002, seed=0), dtype=torch.float64, device=dev)
    hists = {}
    for backend in ("auto", "torch"):
        fused.reset_launches()
        _, hists[backend] = fit(bt, Parafac2Options(rank=5, dtype=torch.float64,
                                                    backend=backend),
                                max_iters=20, tol=0.0, seed=0)
        want = len(bt.buckets) * 20 if backend == "auto" else 0
        assert all(n == want for n in fused.LAUNCHES.values()), fused.LAUNCHES
    assert np.max(np.abs(np.asarray(hists["auto"]) - np.asarray(hists["torch"]))) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("mode1_reuse", [True, False])
def test_staged_fit_matches_torch_route_on_gpu(dev, mode1_reuse):
    """The same on the staged route: the fit history within 1e-8 of the torch
    route's, and each staged kernel of the path (mode1_reuse or mode1, with
    mode2_compact, ykv and mode3_reuse) launches buckets x iterations."""
    bt = bucketize(choa_like(scale=0.002, seed=0), dtype=torch.float64, device=dev)
    hists = {}
    for backend in ("staged", "torch"):
        staged.reset_launches()
        _, hists[backend] = fit(bt, Parafac2Options(rank=5, dtype=torch.float64,
                                                    backend=backend,
                                                    mode1_reuse=mode1_reuse),
                                max_iters=20, tol=0.0, seed=0)
        on_path = {"ykv", "mode2_compact", "mode3_reuse",
                   "mode1_reuse" if mode1_reuse else "mode1"} if backend == "staged" else set()
        assert {k for k, n in staged.LAUNCHES.items() if n} == on_path
        assert all(staged.LAUNCHES[k] == len(bt.buckets) * 20 for k in on_path)
    assert np.max(np.abs(np.asarray(hists["staged"]) - np.asarray(hists["torch"]))) <= 1e-8
