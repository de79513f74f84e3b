"""The port's CUDA kernels on a GPU (marker ``cuda``; each test skips without
a CUDA device, since the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has only torch: ``python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``. Each kernel (the four fused, the six staged,
the two SCOO and the BCC gather-matmul) is held against its plain version on
the same inputs (f64 to 1e-12; f32 to 1e-6 relative plus 1e-6 of the
output's largest magnitude, since the sums run in another order; for the
two SCOO kernels, whose plain versions difference running sums, the scale is
the largest running sum of |contribution| instead), the fused and staged
routes' fits against the torch route's, and the kernels and the mode-2
scatter must give the same bits twice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Parafac2Options, bucketize, fit, to_block_bucket  # noqa: E402
from repro_torch.core import spartan  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import fused, gather_matmul, scoo, staged  # noqa: E402
from repro_torch.kernels import mttkrp_mode1 as m1  # noqa: E402
from repro_torch.kernels import mttkrp_mode2 as m2  # noqa: E402
from repro_torch.kernels import mttkrp_mode3 as m3  # noqa: E402
from repro_torch.kernels import ykv as yk  # noqa: E402
from repro_torch.kernels.common import fold_subject_mask  # noqa: E402
from repro_torch.sparse import IrregularCOO, SubjectCOO, random_irregular  # noqa: E402

GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
    dict(seed=4, K=10, J=90, R=40, col_align=8),      # the reference's widest cell
    dict(seed=5, K=8, J=150, R=72, col_align=8),      # past the 64-wide register tile
    dict(seed=6, K=6, J=120, R=40, col_align=1024),   # C_pad = 1024 (chunked Vg in f64)
    dict(seed=7, K=4, J=60, R=72, col_align=1024, max_rows=700),   # every tile chunked
    dict(seed=8, K=1, J=30, R=5, col_align=4),        # one subject
    dict(seed=9, K=9, J=40, R=5, col_align=1),        # C_pad 17: rows not whole 16-byte runs
    dict(seed=10, K=6, J=80, R=64, col_align=8),      # the widest register tile
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


def _offset_tensor(shape, dtype, dev, rng, offset, integers=False):
    """A contiguous tensor whose data starts ``offset`` elements past an
    allocation's (16-byte aligned) start: standard normals, or integers in
    [-2, 2]."""
    n = int(np.prod(shape))
    t = torch.empty(n + offset, dtype=dtype, device=dev)[offset:].view(shape)
    a = rng.integers(-2, 3, shape) if integers else rng.standard_normal(shape)
    t.copy_(torch.tensor(a, dtype=dtype))
    return t


# (K, I, C, R, offset of the slab's start in elements) -> F1 variant in f32
F1_EDGES = {
    (1, 1, 5, 1, 0): "ring-element-copies",      # K = 1, I = 1, C % 4 != 0
    (1000, 3, 16, 5, 0): "ring",                 # K past the persistent grid
    (7, 57, 130, 5, 0): "ring-element-copies",   # I past a row tile, C % 4 != 0
    (5, 9, 36, 8, 1): "ring-element-copies",     # slab start not 16-byte aligned
    (6, 70, 64, 1, 0): "ring",
    (4, 70, 64, 64, 0): "ring",                  # the widest tile, one row a lane
    (3, 9, 20, 72, 0): "row-warp-wide",          # R past the widest tile
    (2, 700, 1024, 40, 0): "row-warp",           # a subject too large for the ring
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F1_EDGES), ids=lambda s: "K{}-I{}-C{}-R{}-off{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_procrustes_b_edges(dev, shape, dtype):
    """F1 at the edges of its variants: the variant the launcher picks (in
    f32), the plain version's result and the same bits twice."""
    K, I, C, R, offset = shape
    rng = np.random.default_rng(K + I + C + R)
    vals = _offset_tensor((K, I, C), dtype, dev, rng, offset)
    Vg, Wb, H = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                 for s in ((K, C, R), (K, R), (R, R)))
    if dtype == torch.float32:
        assert fused.procrustes_b_variant(vals, R) == F1_EDGES[shape]
    before = fused.LAUNCHES["fused_procrustes_b"]
    got = fused.fused_procrustes_b(vals, Vg, Wb, H)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_procrustes_b"] == before + 1
    _assert_matches(got, fused.procrustes_b_plain(vals, Vg, Wb, H), dtype)
    again = fused.fused_procrustes_b(vals, Vg, Wb, H)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# (K, I, C, R, offset of the slab's start in elements) -> F1's variant with
# a half slab and Vg: R 1-8, I below, at and past an m-tile, C below and
# past a k-step, I * R whole 16-byte packs of the outputs or not
F1_HALF_EDGES = {
    (7, 56, 128, 5, 0): "ring-mma",                   # the main path's
    (58112, 56, 128, 5, 0): "ring-mma",               # its largest bucket, past the grid
    (1, 1, 1, 1, 0): "ring-mma-element-copies",       # one subject of one row and column
    (3, 15, 15, 2, 0): "ring-mma-element-copies",     # below an m-tile and a k-step
    (4, 17, 128, 3, 0): "ring-mma",                   # one row past an m-tile
    (6, 18, 128, 4, 0): "ring-mma",                   # the rsvd cores' rows
    (5, 64, 130, 6, 0): "ring-mma-element-copies",    # whole m-tiles; C past a k-step
    (5, 56, 128, 7, 3): "ring-mma-element-copies",    # the slab's start not 16-byte aligned
    (2, 64, 128, 8, 0): "ring-mma",                   # R = 8, the whole n-tile
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F1_HALF_EDGES),
                         ids=lambda s: "K{}-I{}-C{}-R{}-off{}".format(*s))
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_procrustes_b_half_edges(dev, shape, half):
    """F1 at half width at the edges of its tensor-core ring: the variant it
    takes, the plain version's XkV and B within the f32 bound (every third
    subject masked), and the same bits twice."""
    K, I, C, R, offset = shape
    rng = np.random.default_rng(K + I + C + R + offset)
    vals = _offset_tensor((K, I, C), half, dev, rng, offset)
    Vg = torch.tensor(rng.standard_normal((K, C, R)), device=dev).to(half)
    Wb, H = (torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
             for s in ((K, R), (R, R)))
    Wb[::3] = 0
    assert fused.procrustes_b_variant(vals, R) == F1_HALF_EDGES[shape]
    before = fused.LAUNCHES["fused_procrustes_b"]
    got = fused.fused_procrustes_b(vals, Vg, Wb, H)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_procrustes_b"] == before + 1
    _assert_matches(got, fused.procrustes_b_plain(vals, Vg, Wb, H), torch.float32)
    assert not got[1][::3].any()
    again = fused.fused_procrustes_b(vals, Vg, Wb, H)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# (K, I, C, R, offset of the slab's start in elements) -> the (F4, F3)
# variants with a float32, a float64 and a half (bfloat16, float16) slab
_RING2 = ("ring", "ring")
_COPIES2 = ("ring-element-copies",) * 2
_SMALL2 = ("row-warp", "thread-per-column")   # the one-block-a-subject designs
SLAB_EDGES = {
    (7, 56, 128, 5, 0): dict(f32=_RING2, f64=_RING2, half=("ring-mma", "ring")),  # the main path's
    (1000, 40, 16, 5, 0): dict(f32=_RING2, f64=_RING2,
                               half=("ring-mma", "ring")),        # subjects past the grid
    # rows not whole 16-byte runs (f32, half); I past a row tile and an m-tile
    (7, 57, 130, 5, 0): dict(f32=_COPIES2, f64=_RING2,
                             half=("ring-mma-element-copies", "ring-element-copies")),
    (5, 33, 36, 8, 1): dict(f32=_COPIES2, f64=_COPIES2,           # the slab's start not
                            half=("ring-mma-element-copies", "ring-element-copies")),  # aligned
    (1, 1, 5, 1, 0): dict(f32=_SMALL2, f64=_SMALL2,               # one subject of one row
                          half=("ring-mma-element-copies", "thread-per-column")),
    (6, 18, 128, 5, 0): dict(f32=_SMALL2, f64=_SMALL2,            # the rsvd cores' rows:
                             half=("ring-mma", "thread-per-column")),   # below the rings'
    (6, 37, 40, 9, 0): dict(f32=_RING2, f64=_RING2, half=_RING2),  # R past G's register owners
    (5, 33, 40, 9, 1): dict(f32=_COPIES2, f64=_COPIES2, half=_COPIES2),
    (4, 70, 64, 64, 0): dict(f32=_RING2, f64=("row-warp", "ring"), half=_RING2),  # widest tile
    (6, 19, 1024, 8, 0): dict(f32=_SMALL2, f64=_SMALL2,           # C_pad 1024, I not 16k
                              half=("ring-mma", "thread-per-column")),
    (2, 9, 1024, 40, 0): dict(f32=_SMALL2, f64=("row-warp-chunked", "thread-per-column"),
                              half=_SMALL2),
    (3, 120, 1024, 5, 0): dict(f32=_SMALL2, f64=_SMALL2, half=_SMALL2),   # too large a subject
    (2, 900, 16, 64, 0): dict(f32=("row-warp-chunked", "thread-per-column-chunked"),
                              f64=("row-warp-chunked", "thread-per-column-chunked"),
                              half=("row-warp-chunked", "thread-per-column-chunked")),
    (3, 9, 20, 72, 0): dict(f32=("row-warp-wide", "thread-per-column-wide"),   # R past 64
                            f64=("row-warp-wide", "thread-per-column-wide"),
                            half=("row-warp-wide", "thread-per-column-wide")),
    (2, 900, 16, 72, 0): dict(f32=("row-warp-wide-chunked", "thread-per-column-wide-chunked"),
                              f64=("row-warp-wide-chunked", "thread-per-column-wide-chunked"),
                              half=("row-warp-wide-chunked", "thread-per-column-wide-chunked")),
}
SLAB_DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16,
               "f16": torch.float16}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SLAB_EDGES),
                         ids=lambda s: "K{}-I{}-C{}-R{}-off{}".format(*s))
@pytest.mark.parametrize("dt", list(SLAB_DTYPES))
def test_ykv_and_mode2_compact_edges(dev, shape, dt):
    """F4 and F3 at the edges of their variants: the variant each launcher
    picks, the plain version's result (f64 to 1e-12, f32 and half slabs to
    the f32 bound), the same bits twice, and zeros at masked subjects and
    columns (F3)."""
    K, I, C, R, offset = shape
    dtype = SLAB_DTYPES[dt]
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    rng = np.random.default_rng(K + I + C + R + offset)
    vals = _offset_tensor((K, I, C), dtype, dev, rng, offset)
    Vg = torch.tensor(rng.standard_normal((K, C, R)), device=dev).to(dtype)
    Q, H, Wb = (torch.tensor(rng.standard_normal(s), dtype=acc, device=dev)
                for s in ((K, I, R), (R, R), (K, R)))
    Wb[::3] = 0
    cm = torch.tensor(rng.random((K, C)) < 0.7, dtype=acc, device=dev)
    want = SLAB_EDGES[shape]["half" if dt in ("bf16", "f16") else dt]
    assert (fused.ykv_fused_variant(vals, R), fused.mode2_compact_fused_variant(vals, R)) == want
    for name, a in (("fused_ykv", (vals, Q, Vg)), ("fused_mode2_compact", (vals, Q, H, Wb, cm))):
        wrapper, plain = KERNELS[name]
        before = fused.LAUNCHES[name]
        got = wrapper(*a)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[name] == before + 1
        _assert_matches(got, plain(*a), acc)
        assert torch.equal(got, wrapper(*a)), name
    A = fused.fused_mode2_compact(vals, Q, H, Wb, cm)
    assert not A[::3].any() and not A[cm == 0].any()


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(dev):
    """What the kernels still refuse raises: f64 beside a half operand,
    bfloat16 beside float16, a half operand that a kernel does not stream
    (Wb, H; every operand of F2 and rows 7, 10 and 13), F1's slab and Vg in
    two dtypes, and non-contiguous operands; a rank past the widest register
    tile (R = 72) is taken and matches the plain version. The half operands
    the nine kernels do take are held against their plain versions in the
    ``test_half_*`` tests."""
    vals = torch.rand((3, 8, 12), device=dev, dtype=torch.float16)
    Vg = torch.rand((3, 12, 4), device=dev, dtype=torch.float16)
    Wb, H = torch.rand((3, 4), device=dev, dtype=torch.float16), torch.eye(4, device=dev)
    with pytest.raises(TypeError):          # a half Wb and H
        fused.fused_procrustes_b(vals, Vg, Wb, H.half())
    with pytest.raises(TypeError):          # f64 beside half
        fused.fused_procrustes_b(vals, Vg, Wb.double(), H.double())
    with pytest.raises(TypeError):          # F1 takes the slab and Vg in one dtype
        fused.fused_procrustes_b(vals, Vg.float(), Wb.float(), H)
    with pytest.raises(TypeError):          # bfloat16 beside float16
        yk.ykv(torch.rand((3, 4, 12), device=dev, dtype=torch.bfloat16), Vg)
    q, x = (torch.rand((3, 8, 4), device=dev, dtype=torch.float16) for _ in range(2))
    with pytest.raises(TypeError):          # F2 streams no slab
        fused.fused_mode1_xkv(q, x, Wb.float())
    with pytest.raises(TypeError):          # row 7
        m1.mode1_reuse(torch.rand((3, 4, 4), device=dev).half(), Wb.float())
    with pytest.raises(TypeError):          # row 10
        m3.mode3_reuse(torch.rand((3, 4, 4), device=dev).half(), H)
    with pytest.raises(TypeError):          # row 13
        gather_matmul.gather_matmul(torch.rand((3, 8, 2, 128), device=dev).half(),
                                    torch.zeros((3, 2), dtype=torch.int32, device=dev),
                                    torch.rand((256, 4), device=dev).half())
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


# ---------------------------------------------------------------------------
# the SCOO kernels (rows 11, 12) and the BCC gather-matmul (row 13)
# ---------------------------------------------------------------------------

def _edge_data(n_cols=29):
    """An empty subject, a single-nnz one and a 200-row ultra-sparse one
    among ordinary subjects (the reference's ``tests/test_scoo.py`` edge set)."""
    rng = np.random.default_rng(7)

    def sub(n_rows, nnz):
        cells = rng.choice(n_rows * n_cols, size=nnz, replace=False)
        return SubjectCOO(rows=(cells // n_cols).astype(np.int32),
                          cols=(cells % n_cols).astype(np.int32),
                          vals=rng.standard_normal(nnz), n_rows=n_rows, n_cols=n_cols)

    empty = SubjectCOO(rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
                       vals=np.zeros(0), n_rows=3, n_cols=n_cols)
    return IrregularCOO([sub(9, 25), empty, sub(1, 1), sub(200, 5), sub(13, 40),
                         sub(6, 11)], n_cols)


SCOO_DATA = {
    "edge": _edge_data,
    "random-odd": lambda: random_irregular(n_subjects=13, n_cols=37, max_rows=9,
                                           avg_nnz_per_subject=18, seed=0, nonneg=False),
    "random-padded": lambda: random_irregular(n_subjects=11, n_cols=50, max_rows=12,
                                              avg_nnz_per_subject=25, seed=3),
}


def _prefix_scale(vals, idx, M) -> float:
    g = torch.gather(M.double(), 1, idx.long()[..., None].expand(-1, -1, M.shape[-1]))
    run = torch.cumsum((g * vals.double()[..., None]).abs(), 1)
    return max(1.0, float(run.max())) if run.numel() else 1.0


def _scoo_calls(name, dtype, dev, R, half=None):
    """(name, wrapper call, plain call, scale) for rows 11 and 12 on every
    SCOO bucket of one dataset, subject padding included; with ``half``
    (torch.bfloat16 or torch.float16) the values, and row 11's Vg, at that
    width."""
    bt = bucketize(SCOO_DATA[name](), format="scoo", dtype=dtype, device=dev,
                   col_align=4, max_buckets=3, subject_align=4)
    rng = np.random.default_rng(R)
    V = torch.tensor(rng.standard_normal((bt.n_cols, R)), dtype=dtype, device=dev)
    for b in bt.buckets:
        Vg = b.gather_v(V)
        Q = torch.tensor(rng.standard_normal((b.kb, b.i_pad, R)), dtype=dtype, device=dev)
        vals = b.vals if half is None else b.vals.to(half)
        Vg = Vg if half is None else Vg.to(half)
        xa = (vals, b.rows, b.lcols, Vg, b.i_pad)
        pa = (vals, b.rows, b.lcols, Q, b.c_pad)
        xk, pk = dict(row_ends=b.row_ends), dict(cperm=b.cperm, col_ends=b.col_ends)
        yield ("scoo_xk_times_v", lambda: scoo.scoo_xk_times_v(*xa, **xk),
               lambda: scoo.xk_times_v_plain(*xa, **xk), _prefix_scale(vals, b.lcols, Vg))
        yield ("scoo_project", lambda: scoo.scoo_project(*pa, **pk),
               lambda: scoo.project_plain(*pa, **pk), _prefix_scale(vals, b.rows, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCOO_DATA))
@pytest.mark.parametrize("R", [1, 5, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scoo_kernels_match_plain(dev, name, R, dtype):
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for kernel, call, plain, scale in _scoo_calls(name, dtype, dev, R):
        before = scoo.LAUNCHES[kernel]
        got = call()
        torch.cuda.synchronize()
        assert scoo.LAUNCHES[kernel] == before + 1, kernel
        want = plain()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=tol, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,J,R", [(0, 300, 8), (1, 500, 16), (2, 130, 4), (3, 260, 40),
                                      (4, 100, 5), (5, 260, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_matmul_matches_plain(dev, seed, J, R, dtype):
    """Row 13 over the reference's BCC geometries, NB = 1 (J = 100) and
    R = 5, 40 and 72 (R past the 16-wide register tile runs in R chunks),
    against its plain version and the CC product."""
    data = random_irregular(n_subjects=9, n_cols=J, max_rows=12, avg_nnz_per_subject=40,
                            seed=seed)
    bt = bucketize(data, max_buckets=2, dtype=dtype, device=dev)
    V = torch.tensor(np.random.default_rng(seed).standard_normal((J, R)), dtype=dtype,
                     device=dev)
    for b in bt.buckets:
        bcc = to_block_bucket(b, J)
        before = gather_matmul.LAUNCHES["gather_matmul"]
        got = b.xk_times_v_bcc(bcc, V)
        torch.cuda.synchronize()
        assert gather_matmul.LAUNCHES["gather_matmul"] == before + 1
        J_pad = -(-J // 128) * 128
        V_pad = torch.cat([V, V.new_zeros((J_pad - J, R))])
        _assert_matches(got, gather_matmul.gather_matmul_plain(bcc.vals, bcc.blk_ids, V_pad),
                        dtype)
        _assert_matches(got, b.xk_times_v(V), dtype)


# (K, I, NB, L, R, offset of vals' start in elements)
GATHER_EDGES = [
    (5, 7, 1, 128, 5, 0),       # NB = 1
    (6, 4, 3, 128, 1, 0),
    (4, 3, 2, 128, 72, 0),      # R chunks
    (3, 5, 60, 128, 16, 0),     # a row longer than the V stage: E chunks
    (6, 4, 3, 33, 5, 0),        # rows not whole 16-byte runs
    (5, 17, 9, 128, 5, 1),      # vals' start not 16-byte aligned
    (1500, 3, 2, 128, 5, 0),    # K past the persistent grid
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GATHER_EDGES, ids=lambda s: "K{}-I{}-NB{}-L{}-R{}-off{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_matmul_edges(dev, shape, dtype):
    """Row 13 at the edges of its design, with the first subjects' blocks
    all padding (zero values, id 0): the plain version's result and the same
    bits twice. The values are 10% dense, as BCC blocks are mostly zeros:
    f32 sums of thousands of dense terms taken in two orders differ by more
    than 1e-6 of the largest output."""
    K, I, NB, L, R, offset = shape
    rng = np.random.default_rng(K + I + NB + L + R)
    vals = _offset_tensor((K, I, NB, L), dtype, dev, rng, offset)
    vals.mul_(torch.tensor(rng.random((K, I, NB, L)) < 0.1, dtype=dtype, device=dev))
    ids = torch.tensor(rng.integers(0, NB + 3, (K, NB)), dtype=torch.int32, device=dev)
    vals[:2] = 0
    ids[:2] = 0
    V = torch.tensor(rng.standard_normal((L * (NB + 3), R)), dtype=dtype, device=dev)
    before = gather_matmul.LAUNCHES["gather_matmul"]
    got = gather_matmul.gather_matmul(vals, ids, V)
    torch.cuda.synchronize()
    assert gather_matmul.LAUNCHES["gather_matmul"] == before + 1
    _assert_matches(got, gather_matmul.gather_matmul_plain(vals, ids, V), dtype)
    assert torch.equal(got, gather_matmul.gather_matmul(vals, ids, V))


@pytest.mark.cuda
def test_new_kernels_are_deterministic_and_reject_what_they_do_not_take(dev):
    """Two runs give the same bits; a CUDA call without the segment ends,
    f16 values beside an f32 Vg (row 11 takes the two in one dtype) or a
    non-contiguous operand raises."""
    for _, call, _, _ in _scoo_calls("random-odd", torch.float32, dev, 5):
        assert torch.equal(call(), call())
    bt = bucketize(random_irregular(n_subjects=9, n_cols=300, max_rows=12,
                                    avg_nnz_per_subject=40, seed=0), dtype=torch.float32,
                   device=dev, max_buckets=1)
    b = bt.buckets[0]
    bcc, V = to_block_bucket(b, 300), torch.rand((384, 8), device=dev)
    assert torch.equal(gather_matmul.gather_matmul(bcc.vals, bcc.blk_ids, V),
                       gather_matmul.gather_matmul(bcc.vals, bcc.blk_ids, V))
    sb = bucketize(SCOO_DATA["random-odd"](), format="scoo", dtype=torch.float32,
                   device=dev, col_align=4).buckets[0]
    Vg = torch.rand((sb.kb, sb.c_pad, 5), device=dev)
    Q = torch.rand((sb.kb, sb.i_pad, 5), device=dev)
    with pytest.raises(ValueError, match="row_ends"):
        scoo.scoo_xk_times_v(sb.vals, sb.rows, sb.lcols, Vg, sb.i_pad)
    with pytest.raises(ValueError, match="col_ends"):
        scoo.scoo_project(sb.vals, sb.rows, sb.lcols, Q, sb.c_pad)
    with pytest.raises(TypeError):
        scoo.scoo_xk_times_v(sb.vals.half(), sb.rows, sb.lcols, Vg, sb.i_pad,
                             row_ends=sb.row_ends)
    with pytest.raises(ValueError, match="contiguous"):
        scoo.scoo_project(sb.vals, sb.rows, sb.lcols,
                          torch.rand((sb.kb, 5, sb.i_pad), device=dev).transpose(1, 2),
                          sb.c_pad, cperm=sb.cperm, col_ends=sb.col_ends)
    with pytest.raises(TypeError):
        gather_matmul.gather_matmul(bcc.vals, bcc.blk_ids.long(), V)


# (K, R, C, offset of Yc's start in elements) -> row 8's variant in f32
MODE2_EDGES = {
    (7, 5, 128, 0): "ring",                      # the main path's C
    (5, 5, 17, 0): "ring-element-copies",        # rows not whole 16-byte runs
    (4, 5, 1000, 0): "ring",                     # C not a multiple of the tile
    (3, 72, 1024, 0): "ring",                    # R = 72 at C_pad = 1024
    (6, 8, 130, 0): "ring-element-copies",       # odd width, the register tile's R
    (5, 9, 64, 0): "ring",                       # R past the register tile
    (4, 1, 33, 0): "ring-element-copies",
    (5, 5, 128, 1): "ring-element-copies",       # Yc's start not 16-byte aligned
    (3, 200, 40, 0): "thread-per-entry",         # R too wide for the ring's tile
    (1500, 5, 128, 0): "ring",                   # items past the persistent grid
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MODE2_EDGES), ids=lambda s: "K{}-R{}-C{}-off{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode2_compact_edges(dev, shape, dtype):
    """Row 8 at the edges of its variants, with a masked subject and masked
    columns: the variant the launcher picks (in f32), the plain version's
    result, exact zeros where masked and the same bits twice."""
    K, R, C, offset = shape
    rng = np.random.default_rng(K + R + C + offset)
    Yc = _offset_tensor((K, R, C), dtype, dev, rng, offset)
    H, Wb = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev) for s in ((R, R), (K, R)))
    cm = torch.tensor(rng.random((K, C)) < 0.7, dtype=dtype, device=dev)
    sm = torch.ones(K, dtype=dtype, device=dev)
    sm[0] = 0
    if dtype == torch.float32:
        assert m2.mode2_compact_variant(Yc, cm) == MODE2_EDGES[shape]
    before = staged.LAUNCHES["mode2_compact"]
    got = m2.mode2_compact(Yc, H, Wb, cm, sm)
    torch.cuda.synchronize()
    assert staged.LAUNCHES["mode2_compact"] == before + 1
    _assert_matches(got, m2.mode2_compact_plain(Yc, H, Wb, cm, sm), dtype)
    assert torch.all(got[(cm == 0) | (sm[:, None] == 0)] == 0)
    assert torch.equal(got, m2.mode2_compact(Yc, H, Wb, cm, sm))


def _scoo_arrays(n_rows, C, N, nnz, seed, one_col=False, one_row=False):
    """SCOO arrays of one bucket, laid out as ``bucketize`` lays them out:
    subject k's nnz[k] triplets sorted by (row, column), pads past them,
    ``row_ends`` the row segments' ends, ``cperm`` the stable column order
    and ``col_ends`` its segment ends. ``one_col``/``one_row`` put every
    triplet of a subject in column 0 / row 0."""
    rng = np.random.default_rng(seed)
    Kb = len(nnz)
    out = dict(vals=np.zeros((Kb, N)), rows=np.zeros((Kb, N), np.int32),
               lcols=np.zeros((Kb, N), np.int32), row_ends=np.zeros((Kb, n_rows), np.int32),
               cperm=np.tile(np.arange(N, dtype=np.int32), (Kb, 1)),
               col_ends=np.zeros((Kb, C), np.int32))
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


# (I, C, N, nnz per subject, R, one column, offset of vals' start in
# elements) -> row 12's variant in f32
PROJECT_EDGES = {
    (8, 16, 64, (64, 0, 10), 5, True, 0): "ring",         # a segment of length N, an empty subject
    (48, 128, 136, (115,) * 30 + (0,), 5, False, 0): "ring",   # the main path's geometry
    (5, 9, 13, (13, 2, 0, 7, 5), 5, False, 0): "ring-element-copies",   # runs not whole packs
    (8, 16, 24, (24, 3, 0, 9), 5, False, 1): "ring-element-copies",    # vals' start unaligned
    (40, 128, 3000, (3000, 17, 0), 5, False, 0): "thread-per-entry",  # N past the stages
    (1000, 32, 40, (40, 0, 33), 8, False, 0): "thread-per-entry",     # I past the stages
    (24, 32, 96, (96, 50, 0, 1), 72, False, 0): "ring",  # R = 72, in chunks of 32
    (8, 16, 24, tuple(range(24)) * 60, 5, False, 0): "ring",   # subjects past the persistent grid
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(PROJECT_EDGES), ids=lambda e: "I{}-C{}-N{}-Kb{}-R{}-off{}".format(
    e[0], e[1], e[2], len(e[3]), e[4], e[6]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scoo_project_edges(dev, edge, dtype):
    """Row 12 at the edges of its variants: the variant the launcher picks
    (in f32), the plain version's result (atol of the largest running sum),
    exact zeros for empty segments and the same bits twice."""
    n_rows, C, N, nnz, R, one_col, offset = edge
    a = _scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_col=one_col)
    vals = torch.empty(a["vals"].size + offset, dtype=dtype, device=dev)[offset:]
    vals = vals.view(a["vals"].shape).copy_(torch.tensor(a["vals"], dtype=dtype))
    rows, lcols, cperm, ends = (torch.tensor(a[k], device=dev)
                                for k in ("rows", "lcols", "cperm", "col_ends"))
    Q = torch.tensor(np.random.default_rng(R).standard_normal((len(nnz), n_rows, R)),
                     dtype=dtype, device=dev)
    args, kw = (vals, rows, lcols, Q, C), dict(cperm=cperm, col_ends=ends)
    if dtype == torch.float32:
        assert scoo.scoo_project_variant(*args, **kw) == PROJECT_EDGES[edge]
    before = scoo.LAUNCHES["scoo_project"]
    got = scoo.scoo_project(*args, **kw)
    torch.cuda.synchronize()
    assert scoo.LAUNCHES["scoo_project"] == before + 1
    want = scoo.project(*args, **kw)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol,
                               atol=tol * _prefix_scale(vals, rows, Q))
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    assert torch.all(got[(ends == starts)[:, None, :].expand(-1, R, -1)] == 0)
    assert torch.equal(got, scoo.scoo_project(*args, **kw))


# (K, R, C, offset of Yc's start in elements) -> row 5's variant in f32
YKV_EDGES = {
    (7, 5, 128, 0): "ring",                      # the main path's shape
    (5, 5, 17, 0): "ring-element-copies",        # rows not whole 16-byte runs
    (3, 72, 1024, 0): "thread-per-entry",        # R = 72 at C_pad = 1024: past the stages
    (5, 5, 128, 1): "ring-element-copies",       # Yc's start not 16-byte aligned
    (3000, 5, 128, 0): "ring",                   # groups past the persistent grid
    (1, 5, 128, 0): "ring",                      # one subject
    (4, 12, 20, 0): "ring",                      # R*R past one pass of the block
    (4, 40, 128, 0): "ring",                     # the reference's widest R, one subject a group
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(YKV_EDGES), ids=lambda s: "K{}-R{}-C{}-off{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ykv_edges(dev, shape, dtype):
    """Row 5 at the edges of its variants: the variant the launcher picks (in
    f32), one launch a call, the plain version's result and the same bits
    twice."""
    K, R, C, offset = shape
    rng = np.random.default_rng(K + R + C + offset)
    Yc = _offset_tensor((K, R, C), dtype, dev, rng, offset)
    Vg = torch.tensor(rng.standard_normal((K, C, R)), dtype=dtype, device=dev)
    if dtype == torch.float32:
        assert yk.ykv_variant(Yc, Vg) == YKV_EDGES[shape]
    before = staged.LAUNCHES["ykv"]
    got = yk.ykv(Yc, Vg)
    torch.cuda.synchronize()
    assert staged.LAUNCHES["ykv"] == before + 1
    _assert_matches(got, yk.ykv_plain(Yc, Vg), dtype)
    assert torch.equal(got, yk.ykv(Yc, Vg))


# (I, C, N, nnz per subject, R, one row, offset of vals' start in elements)
# -> row 11's variant in f32
XKV_EDGES = {
    (48, 128, 136, (115,) * 30 + (0,), 5, False, 0): "ring",   # the main path's geometry
    (8, 16, 64, (64, 0, 10), 5, True, 0): "ring",     # a row segment of length N, empty rows
                                                       # and an empty subject
    (5, 9, 13, (13, 2, 0, 7, 5), 5, False, 0): "ring-element-copies",   # runs not whole packs
    (8, 16, 24, (24, 3, 0, 9), 5, False, 1): "ring-element-copies",    # vals' start unaligned
    (40, 128, 3000, (3000, 17, 0), 5, False, 0): "thread-per-entry",  # N past the stages
    (1000, 32, 40, (40, 0, 33), 8, False, 0): "thread-per-entry",     # I past the stages
    (8, 8, 24, (24, 3, 0, 9), 72, False, 0): "ring",   # R = 72, in chunks of 32
    (8, 16, 24, tuple(range(24)) * 420, 5, False, 0): "ring",   # subjects past the walkers
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(XKV_EDGES), ids=lambda e: "I{}-C{}-N{}-Kb{}-R{}-off{}".format(
    e[0], e[1], e[2], len(e[3]), e[4], e[6]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scoo_xk_times_v_edges(dev, edge, dtype):
    """Row 11 at the edges of its variants: the variant the launcher picks
    (in f32), one launch a call, the plain version's result (atol of the
    largest running sum), exact zeros for empty rows and subjects and the
    same bits twice."""
    n_rows, C, N, nnz, R, one_row, offset = edge
    a = _scoo_arrays(n_rows, C, N, nnz, seed=N + R, one_row=one_row)
    vals = torch.empty(a["vals"].size + offset, dtype=dtype, device=dev)[offset:]
    vals = vals.view(a["vals"].shape).copy_(torch.tensor(a["vals"], dtype=dtype))
    rows, lcols, ends = (torch.tensor(a[k], device=dev) for k in ("rows", "lcols", "row_ends"))
    Vg = torch.tensor(np.random.default_rng(R).standard_normal((len(nnz), C, R)),
                      dtype=dtype, device=dev)
    args, kw = (vals, rows, lcols, Vg, n_rows), dict(row_ends=ends)
    if dtype == torch.float32:
        assert scoo.scoo_xk_times_v_variant(*args, **kw) == XKV_EDGES[edge]
    before = scoo.LAUNCHES["scoo_xk_times_v"]
    got = scoo.scoo_xk_times_v(*args, **kw)
    torch.cuda.synchronize()
    assert scoo.LAUNCHES["scoo_xk_times_v"] == before + 1
    want = scoo.xk_times_v(*args, **kw)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol,
                               atol=tol * _prefix_scale(vals, lcols, Vg))
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    assert torch.all(got[(ends == starts)[..., None].expand(-1, -1, R)] == 0)
    assert torch.equal(got, scoo.scoo_xk_times_v(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("format", ["scoo", "auto"])
def test_scoo_fits_match_torch_route_on_gpu(dev, format):
    """choa 0.002, rank 5, 20 iterations, f64, SCOO buckets: the staged,
    scoo and auto routes keep the CC torch route's fit history to 1e-8;
    staged launches rows 11, 12, 5, 7, 8 and 10 buckets x iterations times,
    auto F2 alone, scoo nothing."""
    data = choa_like(scale=0.002, seed=0)
    cc = bucketize(data, dtype=torch.float64, device=dev)
    sc = bucketize(data, dtype=torch.float64, device=dev, format=format)
    opts = dict(rank=5, dtype=torch.float64)
    _, want = fit(cc, Parafac2Options(backend="torch", **opts), max_iters=20, tol=0.0, seed=0)
    n = len(sc.buckets) * 20
    on_path = {"staged": {"scoo_xk_times_v", "scoo_project", "ykv", "mode1_reuse",
                          "mode2_compact", "mode3_reuse"},
               "auto": {"fused_mode1_xkv"}, "scoo": set()}
    for backend, kernels in on_path.items():
        libs = (fused, staged, scoo, gather_matmul)
        for lib in libs:
            lib.reset_launches()
        _, hist = fit(sc, Parafac2Options(backend=backend, **opts), max_iters=20, tol=0.0,
                      seed=0)
        counts = {k: v for lib in libs for k, v in lib.LAUNCHES.items()}
        assert {k: v for k, v in counts.items() if v} == dict.fromkeys(kernels, n), backend
        assert np.max(np.abs(np.asarray(hist) - np.asarray(want))) <= 1e-8, backend


# F2 and row 7, the one-launch reductions across subjects, at their edges:
# F2 (K, I, R, offset of Q's start in elements, subject mask) -> the variant
# it takes in f32; row 7 (K, R, subject mask). Masks: None, "some" (the
# first and every third subject masked) or "all". K < 2048 leaves runs
# without a subject beside the first K; K = 2049 puts two subjects in each
# of the first 1025 runs and none in the rest.
F2_EDGES = {
    (58112, 56, 5, 0, "some"): "ring",            # the main path's largest CC bucket
    (7, 56, 5, 0, None): "ring",
    (1, 56, 5, 0, "some"): "ring",
    (2049, 56, 5, 0, "some"): "ring",
    (9, 56, 1, 0, "some"): "ring",                # 128 groups a block
    (9, 20, 11, 0, None): "ring",                 # one group a block
    (11, 56, 5, 1, "some"): "ring-element-copies",   # Q's start unaligned
    (13, 3, 5, 0, None): "ring-element-copies",   # [I, R] tiles not whole packs
    (9, 1, 11, 0, "some"): "ring-element-copies",    # partials read directly
    (9, 30, 72, 0, "some"): "chunked",            # R*R past the block
    (5, 4000, 8, 0, None): "chunked",             # I past the ring, rows in tiles
    (3, 1452, 5, 0, "some"): "ring",              # one group's stages take all 227 KB
    (3, 29055, 1, 0, None): "chunked",            # one tile takes all 227 KB
    (3, 29056, 1, 0, "some"): "chunked",          # row tiles that take all 227 KB
    (9, 56, 5, 0, "all"): "ring",
}
# The three F2 launches that take all 232,448 bytes of shared memory. At
# R = 1 that needs I near 29,000: a sum whose f32 rounding in the kernel's
# order (the parent's) and in cuBLAS's differ by more than the tolerance.
# Their operands are small integers, exact in f32 and f64 in any order, and
# the kernel must equal its plain version exactly.
F2_FULL_SMEM = {(3, 1452, 5, 0, "some"), (3, 29055, 1, 0, None), (3, 29056, 1, 0, "some")}
MODE1_REUSE_EDGES = [(58112, 5, "some"), (7, 5, None), (1, 5, "some"), (2049, 5, "some"),
                     (9, 1, None), (40, 17, "some"), (9, 72, "some"), (9, 5, "all")]


def _mask(K, kind, dtype, dev):
    if kind is None:
        return None
    m = torch.ones(K, dtype=dtype, device=dev)
    m[:: 1 if kind == "all" else 3] = 0
    return m


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _f2_operands(shape, dtype, dev):
    K, I, R, offset, mk = shape
    rng = np.random.default_rng(K + I + R + offset)
    if shape in F2_FULL_SMEM:
        Q = _offset_tensor((K, I, R), dtype, dev, rng, offset, integers=True)
        XkV, Wb = (torch.tensor(rng.integers(-2, 3, s), dtype=dtype, device=dev)
                   for s in ((K, I, R), (K, R)))
        return Q, XkV, Wb, _mask(K, mk, dtype, dev)
    Q = _offset_tensor((K, I, R), dtype, dev, rng, offset)
    XkV, Wb = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
               for s in ((K, I, R), (K, R)))
    return Q, XkV, Wb, _mask(K, mk, dtype, dev)


def _reuse_operands(shape, dtype, dev):
    K, R, mk = shape
    rng = np.random.default_rng(K + R)
    YkV, Wb = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
               for s in ((K, R, R), (K, R)))
    return YkV, Wb, _mask(K, mk, dtype, dev)


def _one_launch_twice(name, wrapper, plain, args, dtype):
    """One launch a call, the plain version's result, and the same bits on
    a second call."""
    before = _launches()[name]
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert _launches()[name] == before + 1
    _assert_matches(got, plain(*args), dtype)
    assert torch.equal(_bits(wrapper(*args)), _bits(got))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F2_EDGES), ids=lambda s: "K{}-I{}-R{}-off{}-mask{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mode1_xkv_edges(dev, shape, dtype):
    """F2 at the edges of its variants, with and without a subject mask,
    against its plain version (the mask folded into Wb); every subject
    masked gives exact zeros, and the launches that take all the shared
    memory equal it exactly on their integer operands."""
    args = _f2_operands(shape, dtype, dev)
    if dtype == torch.float32:
        assert fused.mode1_xkv_variant(*args[:2]) == F2_EDGES[shape]
    got = _one_launch_twice("fused_mode1_xkv", fused.fused_mode1_xkv, fused.mode1_xkv_plain,
                            args, dtype)
    if shape in F2_FULL_SMEM:
        assert torch.equal(got, fused.mode1_xkv_plain(*args))
    if shape[-1] == "all":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MODE1_REUSE_EDGES, ids=lambda s: "K{}-R{}-mask{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode1_reuse_edges(dev, shape, dtype):
    """Row 7 at its edges (K below and past the 2048 runs, R = 1, 17 and 72,
    with and without a subject mask) against its plain version."""
    args = _reuse_operands(shape, dtype, dev)
    got = _one_launch_twice("mode1_reuse", m1.mode1_reuse, m1.mode1_reuse_plain, args, dtype)
    if shape[-1] == "all":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode1_with_mask_matches_plain(dev, dtype):
    """Row 6 shares row 7's kernel and second level: with the mask passed to
    the kernel it matches its plain version, K below and past the runs."""
    for K, R, C in ((7, 5, 17), (2049, 5, 128), (9, 17, 9)):
        rng = np.random.default_rng(K + R + C)
        Yc, Vg, Wb = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                      for s in ((K, R, C), (K, C, R), (K, R)))
        _one_launch_twice("mode1", m1.mode1, m1.mode1_plain,
                          (Yc, Vg, Wb, _mask(K, "some", dtype, dev)), dtype)


@pytest.mark.cuda
def test_reductions_reset_their_counter_between_buckets(dev):
    """Calls on K = 58,112 and K = 7 interleaved on one stream share a
    workspace: each launch must leave its ticket counter at 0, so the large
    bucket's result keeps its bits and the small one's stays right."""
    f2_big = _f2_operands((58112, 56, 5, 0, "some"), torch.float32, dev)
    f2_small = _f2_operands((7, 56, 5, 0, None), torch.float32, dev)
    r7_big = _reuse_operands((58112, 5, "some"), torch.float32, dev)
    r7_small = _reuse_operands((7, 5, None), torch.float32, dev)
    for wrapper, plain, big, small in (
            (fused.fused_mode1_xkv, fused.mode1_xkv_plain, f2_big, f2_small),
            (m1.mode1_reuse, m1.mode1_reuse_plain, r7_big, r7_small)):
        first = wrapper(*big)
        for _ in range(3):
            _assert_matches(wrapper(*small), plain(*small), torch.float32)
            assert torch.equal(_bits(wrapper(*big)), _bits(first))
        _assert_matches(first, plain(*big), torch.float32)


@pytest.mark.cuda
def test_reduction_workspace_is_reused_and_dropped_after_a_failed_launch(dev, monkeypatch):
    """A repeated call of row 7 or F2 allocates its [R, R] result and
    nothing else: the same workspace, no size query; a launch that raises
    drops its workspace, and the next call allocates a fresh one (its
    counter zeroed) and gives the right result."""
    for wrapper, plain, ws, args in (
            (m1.mode1_reuse, m1.mode1_reuse_plain, m1.WORKSPACES,
             _reuse_operands((3000, 5, "some"), torch.float32, dev)),
            (fused.fused_mode1_xkv, fused.mode1_xkv_plain, fused.WORKSPACES,
             _f2_operands((3000, 56, 5, 0, "some"), torch.float32, dev))):
        wrapper(*args)
        torch.cuda.synchronize()
        key = (args[0].device.index, torch.cuda.current_stream().cuda_stream, 0, 5)
        workspace, sizes = ws._ws[key], dict(ws._elems)
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        wrapper(*args)
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 1
        assert ws._ws[key] is workspace and ws._elems == sizes
        with monkeypatch.context() as mp:
            def refuse(*a, **k):
                raise RuntimeError("refused")
            mp.setattr(ws._lib, "launch", refuse)
            with pytest.raises(RuntimeError, match="refused"):
                wrapper(*args)
        assert key not in ws._ws
        _assert_matches(wrapper(*args), plain(*args), torch.float32)


@pytest.mark.cuda
def test_fused_mode1_xkv_variant_answers(dev):
    """F2's variant query: the ring for the main path's [56, 5] tiles in f32
    and f64, element copies for tiles that are not whole packs or an
    unaligned start, chunked past 128 entries or past the ring's stages."""
    def variant(K, I, R, dtype=torch.float32, offset=0):
        Q = torch.zeros(K * I * R + offset, dtype=dtype, device=dev)[offset:].view(K, I, R)
        return fused.mode1_xkv_variant(Q, torch.zeros((K, I, R), dtype=dtype, device=dev))

    assert variant(4, 56, 5) == "ring"
    assert variant(4, 56, 5, torch.float64) == "ring"
    assert variant(4, 3, 5) == "ring-element-copies"
    assert variant(4, 3, 5, torch.float64) == "ring-element-copies"
    assert variant(4, 56, 5, offset=1) == "ring-element-copies"
    assert variant(4, 20, 11) == "ring"
    assert variant(4, 20, 12) == "chunked"
    assert variant(2, 4000, 8) == "chunked"
    with pytest.raises(ValueError, match="CUDA"):
        fused.mode1_xkv_variant(torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4)))


# (K, R, C, offset of Yc's and YkV's starts in elements, subject mask) ->
# row 9's variant in f32 (row 10 has one)
MODE3_EDGES = {
    (7, 5, 128, 0, "some"): "ring",                 # the main path's shape
    (5, 5, 17, 0, None): "ring-element-copies",     # rows not whole 16-byte runs
    (3, 72, 1024, 0, "some"): "thread-per-entry",   # R = 72 at C_pad = 1024
    (5, 5, 128, 1, "some"): "ring-element-copies",  # starts not 16-byte aligned
    (3000, 5, 128, 0, "some"): "ring",              # groups past the persistent grid
    (300000, 5, 4, 0, "some"): "ring",              # row 10's outputs past one wave
    (1, 5, 128, 0, None): "ring",                   # one subject
    (4, 40, 128, 0, "all"): "ring",                 # R = 40, one subject a group
}


def _mode3_operands(shape, dtype, dev):
    """Yc and YkV = ykv(Yc, Vg) starting ``offset`` elements past a 16-byte
    boundary, Vg, H and the subject mask."""
    K, R, C, offset, mk = shape
    rng = np.random.default_rng(K + R + C + offset)
    Yc = _offset_tensor((K, R, C), dtype, dev, rng, offset)
    Vg, H = (torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
             for s in ((K, C, R), (R, R)))
    G = yk.ykv(Yc, Vg)
    YkV = torch.empty(G.numel() + offset, dtype=dtype, device=dev)[offset:].view(G.shape)
    return Yc, Vg, H, YkV.copy_(G), _mask(K, mk, dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MODE3_EDGES), ids=lambda s: "K{}-R{}-C{}-off{}-mask{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode3_edges(dev, shape, dtype):
    """Rows 9 and 10 at the edges of row 9's variants: the variant its
    launcher picks (in f32), one launch a call, the plain versions' results
    and the same bits twice; every subject masked gives exact zeros."""
    Yc, Vg, H, YkV, m = _mode3_operands(shape, dtype, dev)
    if dtype == torch.float32:
        assert m3.mode3_variant(Yc, Vg) == MODE3_EDGES[shape]
    got = (_one_launch_twice("mode3", m3.mode3, m3.mode3_plain, (Yc, Vg, H, m), dtype),
           _one_launch_twice("mode3_reuse", m3.mode3_reuse, m3.mode3_reuse_plain,
                             (YkV, H, m), dtype))
    if shape[-1] == "all":
        assert not any(g.any() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MODE3_EDGES), ids=lambda s: "K{}-R{}-C{}-off{}-mask{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mode3_equals_mode3_reuse_of_ykv(dev, shape, dtype):
    """Rows 5, 9 and 10 sum in one order on every variant, so mode3(Yc, Vg,
    H, m) equals mode3_reuse(ykv(Yc, Vg), H, m) bit for bit."""
    Yc, Vg, H, YkV, m = _mode3_operands(shape, dtype, dev)
    assert torch.equal(_bits(m3.mode3(Yc, Vg, H, m)), _bits(m3.mode3_reuse(YkV, H, m)))


@pytest.mark.cuda
def test_mode3_variant_answers(dev):
    """Row 9's variant query in f32 and f64: the ring for the main path's C,
    element copies for odd C or an unaligned start, thread-per-entry past
    the ring's shared memory; a CPU tensor raises."""
    def variant(K, R, C, dtype=torch.float32, offset=0):
        Yc = torch.zeros(K * R * C + offset, dtype=dtype, device=dev)[offset:].view(K, R, C)
        return m3.mode3_variant(Yc, torch.zeros((K, C, R), dtype=dtype, device=dev))

    for dtype in (torch.float32, torch.float64):
        assert variant(4, 5, 128, dtype) == "ring"
        assert variant(4, 5, 17, dtype) == "ring-element-copies"
        assert variant(4, 5, 128, dtype, offset=1) == "ring-element-copies"
        assert variant(2, 72, 1024, dtype) == "thread-per-entry"
    with pytest.raises(ValueError, match="CUDA"):
        m3.mode3_variant(torch.zeros((2, 3, 4)), torch.zeros((2, 4, 3)))


# P1, the polar's inverse root (csrc/polar.cu), at the ranks and kinds of
# chip_smoke.py's phase 2: K Grams of one kind at rank R.
P1_RANKS = (1, 2, 5, 8, 9, 10, 16, 20, 32, 33, 40, 64, 65, 72, 130)
P1_KINDS = ("zero", "identity", "rankdef", "lowrank", 1.0, 10.0, 100.0, 1e6)
# f32 Grams of condition past 1e2, or of rank deficiency at the rounding
# level, are not determined to the f32 tolerance: f64 only
P1_CASES = [(dtype, kind) for dtype in (torch.float32, torch.float64) for kind in P1_KINDS
            if dtype == torch.float64 or kind not in ("lowrank", 1e6)]


def _p1_grams(R, K, kind, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        G = np.zeros((K, R, R))
    elif kind == "identity":
        G = np.broadcast_to(np.eye(R), (K, R, R)).copy()
    elif kind in ("rankdef", "lowrank"):
        B = rng.standard_normal((K, R + 3 if kind == "rankdef" else max(1, R // 2), R))
        if kind == "rankdef":
            B[:, :, R // 2:] = 0.0              # exactly zero columns
        G = np.swapaxes(B, 1, 2) @ B
    else:
        E = np.linalg.qr(rng.standard_normal((K, R, R)))[0]
        lam = np.geomspace(1.0, 1.0 / kind, R) * rng.uniform(0.5, 4.0, (K, 1))
        G = (E * lam[:, None, :]) @ np.swapaxes(E, 1, 2)
        G = (G + np.swapaxes(G, 1, 2)) / 2
    return torch.tensor(G, dtype=dtype, device=dev)


def _p1_plain(G):
    """The plain version in runs of 16,384 Grams, the most one cuSOLVER
    eigh of 5x5 Grams took on an H100; many Grams past R = 8 on the CPU,
    where cuSOLVER would solve them one at a time."""
    from repro_torch.kernels import polar
    if G.shape[-1] > 8 and G.shape[0] > 1000:
        return polar.gram_inv_sqrt_plain(G.cpu()).to(G.device)
    return torch.cat([polar.gram_inv_sqrt_plain(g) for g in G.split(16384)])


@pytest.mark.cuda
@pytest.mark.parametrize("R", P1_RANKS)
@pytest.mark.parametrize("dtype,kind", P1_CASES, ids=lambda v: str(v).removeprefix("torch."))
def test_gram_inv_sqrt_matches_plain(dev, dtype, kind, R):
    """P1 against its plain version, relative to max |P_inv|: f64 1e-12
    (at condition 1e6 the first-order bound R * condition * 2^-53 of two
    backward-stable eigensolvers); f32 (both solve in f64) 1e-6 up to
    condition 10, 1e-4 at 1e2. Zero Grams give exact zeros; one launch a
    call; the same bits twice."""
    from repro_torch.kernels import polar
    f64 = dtype == torch.float64
    G = _p1_grams(R, 37, kind, dtype, dev, seed=R)
    before = polar.LAUNCHES["gram_inv_sqrt"]
    got = polar.gram_inv_sqrt(G)
    torch.cuda.synchronize()
    assert polar.LAUNCHES["gram_inv_sqrt"] == before + 1
    want = _p1_plain(G)
    assert got.dtype == dtype and got.shape == want.shape
    if kind == "zero":
        assert bool((got == 0).all())
        return
    cond = kind if isinstance(kind, float) else 1.0
    tol = (max(1e-12, R * cond * 2.0 ** -53) if cond > 1e2 else 1e-12) if f64 else \
        (1e-6 if cond <= 10 else 1e-4)
    scale = float(want.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= tol * scale
    assert torch.equal(got, polar.gram_inv_sqrt(G))


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(5, 16385), (5, 58112), (10, 58112), (20, 58112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_inv_sqrt_main_path_sizes(dev, dtype, R, K):
    """K past cuSOLVER's batch limit at R = 5 (a thread a subject) and at the
    main path's K at R = 10 and 20 (a warp a subject), every seventh Gram
    zero (the padded subjects): one launch, zeros where G is zero."""
    from repro_torch.kernels import polar
    G = _p1_grams(R, K, 10.0, dtype, dev, seed=K)
    G[::7] = 0.0
    before = polar.LAUNCHES["gram_inv_sqrt"]
    got = polar.gram_inv_sqrt(G)
    assert polar.LAUNCHES["gram_inv_sqrt"] == before + 1
    want = _p1_plain(G)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert float((got.double() - want.double()).abs().max()) <= tol * float(want.abs().max())
    assert bool((got[::7] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(40, 16385), (72, 1000), (130, 600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_inv_sqrt_block_variants_past_the_grid(dev, dtype, R, K):
    """The wide designs with many subjects: a warp a subject at R = 40 (in
    blocks of four warps, the last block part empty), a block a subject
    with shared memory at 72 and the global workspace at 130, with more
    subjects than blocks, so that a block takes subject after subject,
    reusing its shared memory or workspace slot; every seventh Gram zero."""
    from repro_torch.kernels import polar
    G = _p1_grams(R, K, 10.0, dtype, dev, seed=R)
    G[::7] = 0.0
    got = polar.gram_inv_sqrt(G)
    want = _p1_plain(G)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert float((got.double() - want.double()).abs().max()) <= tol * float(want.abs().max())
    assert bool((got[::7] == 0).all())
    assert torch.equal(got, polar.gram_inv_sqrt(G))


@pytest.mark.cuda
def test_gram_inv_sqrt_variants_and_checks(dev):
    from repro_torch.kernels import polar
    assert [polar.gram_inv_sqrt_variant(R) for R in (1, 8, 9, 64, 65, 119, 120, 130)] == [
        "thread-per-subject", "thread-per-subject", "warp-per-subject", "warp-per-subject",
        "block-shared", "block-shared", "block-workspace", "block-workspace"]
    with pytest.raises(TypeError):
        polar.gram_inv_sqrt(torch.zeros((2, 3, 3), dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="R, R"):
        polar.gram_inv_sqrt(torch.zeros((2, 3, 4), device=dev))


# a tensor whose every B_k has full column rank with room to spare, where
# the svd polar is unique and well determined (tests/test_torch_engine.py)
WELL_CONDITIONED = dict(n_subjects=24, n_cols=60, max_rows=30, min_rows=12,
                        avg_nnz_per_subject=150, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,check_every", [("host", 5), ("scan", 5), ("scan", 0)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method", ["newton_schulz", "svd"])
def test_other_polars_on_gpu(dev, method, dtype, engine, check_every):
    """The svd and Newton-Schulz polars through ``fit`` on the card (auto
    route), 12 iterations from the CPU's start, against the same method on
    the CPU's torch route: f64 within 1e-8, f32 within 1e-4. Newton-Schulz
    on choa_like(0.002); svd on a tensor whose B_k are far from singular
    (at a singular B_k its polar is not unique, and cuSOLVER and LAPACK part
    by 9e-8 on choa_like(0.002) in f64). The scan engine refuses svd on the
    card before any warm-up: torch.linalg.svd reads its error flags back to
    the host, which a CUDA graph cannot capture."""
    from repro_torch.core import init_state
    data = (choa_like(scale=0.002, seed=0) if method == "newton_schulz"
            else random_irregular(**WELL_CONDITIONED))
    bt_cpu = bucketize(data, dtype=dtype, device="cpu")
    opts = dict(rank=5, dtype=dtype, procrustes=method)
    state0 = init_state(bt_cpu, Parafac2Options(**opts), seed=0)
    _, want = fit(bt_cpu, Parafac2Options(**opts, backend="torch"), max_iters=12, tol=0.0,
                  state=state0)
    bt = bucketize(data, dtype=dtype, device=dev)
    gpu = Parafac2Options(**opts, backend="auto", engine=engine, check_every=check_every)
    if method == "svd" and engine == "scan":
        with pytest.raises(ValueError, match="procrustes='svd'"):
            fit(bt, gpu, max_iters=12, tol=0.0, state=state0)
        return
    state, got = fit(bt, gpu, max_iters=12, tol=0.0, state=state0)
    assert len(got) == 12 and got[-1] == float(state.fit)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("check_every", [5, 0])
@pytest.mark.parametrize("backend", ["auto", "staged", "torch"])
def test_scan_engine_matches_host_on_gpu(dev, backend, check_every):
    """choa 0.002, rank 5, f64, 12 iterations: the scan engine's CUDA
    graphs (chunks of 5, 5 and 2, or the while variant) keep the host
    engine's fit history to 1e-8 and the state's fit, and count every
    kernel of the route buckets x iterations times under replay."""
    from repro_torch.kernels import polar
    bt = bucketize(choa_like(scale=0.002, seed=0), dtype=torch.float64, device=dev)
    libs = (fused, staged, scoo, gather_matmul, polar)
    runs = {}
    for engine in ("host", "scan"):
        for lib in libs:
            lib.reset_launches()
        opts = Parafac2Options(rank=5, dtype=torch.float64, backend=backend, engine=engine,
                               check_every=check_every)
        state, hist = fit(bt, opts, max_iters=12, tol=0.0, seed=0)
        counts = {k: v for lib in libs for k, v in lib.LAUNCHES.items() if v}
        runs[engine] = (state, hist, counts)
    (_, host, host_counts), (state, scan, scan_counts) = runs["host"], runs["scan"]
    assert len(scan) == 12 and scan[-1] == float(state.fit)
    assert np.max(np.abs(np.asarray(scan) - np.asarray(host))) <= 1e-8
    assert scan_counts == host_counts
    assert set(host_counts.values()) == {len(bt.buckets) * 12}


# P2 (tridiag_solve) at its edges, as chip_smoke.py holds it: N = 2 and 3,
# one past a chunk of 32 rows and a warp (33), the direct solve's limit and
# one past (64, 65), two and three levels (1,025, 4,097), W's rows at choa
# 0.25 and the full CHOA (116,225, 464,900); R = 1, 5 and 40
P2_N = (2, 3, 33, 64, 65, 1025, 4097, 116225, 464900)


@pytest.mark.cuda
@pytest.mark.parametrize("N", P2_N)
@pytest.mark.parametrize("R", [1, 5, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tridiag_solve_matches_plain(dev, N, R, dtype):
    """P2 against its plain version (cyclic reduction) at lam 0, 0.1, 5 and
    70, rho 0.7 on the device, relative to max |Z|: f64 1e-12; f32 1e-6 times
    the condition bound 1 + 8 lam / rho (two backward-stable solves of one
    system part by about the condition number times the rounding). One
    launch a call, the same bits twice."""
    from repro_torch.kernels import tridiag
    Y = torch.tensor(np.random.default_rng(N + R).standard_normal((N, R)), dtype=dtype,
                     device=dev)
    rho = torch.full((), 0.7, dtype=dtype, device=dev)
    for lam in (0.0, 0.1, 5.0, 70.0):          # 70: rho / lam = 0.01
        before = tridiag.LAUNCHES["tridiag_solve"]
        got = tridiag.tridiag_solve(Y, rho, lam)
        assert tridiag.LAUNCHES["tridiag_solve"] == before + 1
        want = tridiag.tridiag_solve_plain(Y, rho, lam)
        tol = 1e-12 if dtype == torch.float64 else 1e-6 * (1 + 8 * lam / 0.7)
        assert got.dtype == dtype and got.shape == Y.shape
        assert float((got.double() - want.double()).abs().max()) <= tol * float(want.abs().max())
        assert torch.equal(got, tridiag.tridiag_solve(Y, rho, lam))


@pytest.mark.cuda
def test_tridiag_solve_reads_rho_on_the_device_and_checks(dev):
    """A captured call follows rho changed in place on the device (the
    kernel reads it there); a float rho, N < 2, f16 and a strided Y are
    refused."""
    from repro_torch.kernels import tridiag
    Y = torch.randn((4097, 5), dtype=torch.float64, device=dev)
    rho = torch.full((), 0.7, dtype=torch.float64, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tridiag.tridiag_solve(Y, rho, 0.1)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = tridiag.tridiag_solve(Y, rho, 0.1)
    rho.fill_(2.5)
    graph.replay()
    torch.cuda.synchronize()
    want = tridiag.tridiag_solve_plain(Y, rho, 0.1)
    assert float((out - want).abs().max()) <= 1e-12 * float(want.abs().max())
    with pytest.raises(TypeError, match="one-element tensor"):
        tridiag.tridiag_solve(Y, 0.7, 0.1)
    with pytest.raises(ValueError, match="N >= 2"):
        tridiag.tridiag_solve(Y[:1], rho, 0.1)
    with pytest.raises(TypeError):
        tridiag.tridiag_solve(Y.half(), rho.half(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tridiag.tridiag_solve(Y.T.contiguous().T, rho, 0.1)
    assert tridiag.device_kernels(116225) == 1 and tridiag.device_kernels(64) == 1


CONSTRAINED = {"admm": ({"v": "nonneg_admm", "w": "nonneg_admm"}, {}),
               "admm-bucketed": ({"v": "nonneg_admm", "w": "nonneg_admm"},
                                 {"w_layout": "bucketed"}),
               "l1-smooth": ({"v": "nonneg+l1:0.1", "w": "smooth:0.1"}, {}),
               "ridge": (None, {"ridge": 1e-3})}


@pytest.mark.cuda
@pytest.mark.parametrize("backend,format", [("auto", "cc"), ("staged", "scoo"),
                                            ("torch", "cc")])
@pytest.mark.parametrize("case", list(CONSTRAINED))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_constrained_fits_on_gpu(dev, case, backend, format, dtype):
    """choa 0.002, rank 5, 20 iterations: the constrained fit on the card,
    host engine and scan engine (chunks of 10 and the while variant, each
    bit for bit the host engine's, duals carried), against the CPU's torch
    route from the same start: f64 within 1e-8, f32 within 1e-4; P2 once
    per prox of a smooth W (200 launches: the start carries its duals, so
    only the ADMM steps take a prox)."""
    from repro_torch.core import engine, init_state
    from repro_torch.kernels import tridiag
    specs, kw = CONSTRAINED[case]
    data = choa_like(scale=0.002, seed=0)
    bt_cpu = bucketize(data, dtype=dtype, device="cpu", format=format)
    opts = dict(rank=5, dtype=dtype, constraints=specs, **kw)
    state0 = init_state(bt_cpu, Parafac2Options(**opts), seed=0)
    _, want = fit(bt_cpu, Parafac2Options(**opts, backend="torch"), max_iters=20, tol=0.0,
                  state=state0)
    bt = bucketize(data, dtype=dtype, device=dev, format=format)
    tridiag.reset_launches()
    host_state, host = fit(bt, Parafac2Options(**opts, backend=backend), max_iters=20,
                           tol=0.0, state=state0)
    assert tridiag.LAUNCHES["tridiag_solve"] == (200 if case == "l1-smooth" else 0)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    assert np.max(np.abs(np.asarray(host) - np.asarray(want))) <= tol
    for check_every in (10, 0):
        state, scan = fit(bt, Parafac2Options(**opts, backend=backend, engine="scan",
                                              check_every=check_every),
                          max_iters=20, tol=0.0, state=state0)
        assert scan == host
        got, want_leaves = engine._flatten(state), engine._flatten(host_state)
        assert [k for k, _ in got] == [k for k, _ in want_leaves]
        for (k, g), (_, w) in zip(got, want_leaves):      # W and every dual too
            assert torch.equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONSTRAINED))
def test_constrained_iteration_has_no_host_sync(dev, case):
    """One eager ALS step and one replay of a captured chunk with
    ``set_sync_debug_mode("error")``: rho, the l1 threshold and P2's rho
    stay on the device, ``cholesky_ex`` and ``cholesky_solve`` do not read
    back, and a ridge is part of the captured iteration."""
    from repro_torch.core import als_step, engine, init_state
    specs, kw = CONSTRAINED[case]
    bt = bucketize(choa_like(scale=0.002, seed=0), dtype=torch.float32, device=dev)
    opts = Parafac2Options(rank=5, backend="auto", constraints=specs, **kw)
    s = als_step(bt, init_state(bt, opts, seed=0), opts)
    chunk = engine.make_als_chunk(bt, Parafac2Options(rank=5, backend="auto", constraints=specs,
                                                      engine="scan", check_every=4, **kw),
                                  4, state=s)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        als_step(bt, s, opts)
        chunk(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# half precision: the nine kernels that take half-width operands
# ---------------------------------------------------------------------------

HALF_DTYPES = [torch.bfloat16, torch.float16]


def _half_args(args: dict, half) -> dict:
    """The half-width cases of the nine kernels from one bucket's f32
    operands: F1 and F4 with the slab and Vg half, F3 with the slab half,
    rows 5, 6 and 9 with Yc and Vg half and with one of them half, row 8
    with Yc half (H, Wb, Q and the masks stay f32)."""
    vals, Vg, Wb, H = args["fused_procrustes_b"]
    _, Q, _, _, cm = args["fused_mode2_compact"]
    Yc = args["ykv"][0]
    sm = args["mode3"][3]
    vh, gh, yh = vals.to(half), Vg.to(half), Yc.to(half)
    cases = [("fused_procrustes_b", (vh, gh, Wb, H)), ("fused_mode2_compact", (vh, Q, H, Wb, cm)),
             ("fused_ykv", (vh, Q, gh)), ("mode2_compact", (yh, H, Wb, cm))]
    for y, g in ((yh, gh), (Yc, gh), (yh, Vg)):
        cases += [("ykv", (y, g)), ("mode1", (y, g, Wb)), ("mode3", (y, g, H, sm))]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("half", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_kernels_match_plain(dev, geom, half):
    """Each of the seven CC kernels that take half operands launches once,
    returns f32 and matches its plain version on the same half inputs to
    the f32 bound (the products of half values are exact in f32, so only
    the order of the sums differs), over every geometry: the ring, its
    element copies (C_pad 17), the row-warp and wide designs (R = 72) and the
    chunked tiles."""
    for args in _buckets_and_args(torch.float32, dev, **geom):
        for name, a in _half_args(args, half):
            wrapper, plain = KERNELS[name]
            before = _launches()[name]
            got = wrapper(*a)
            torch.cuda.synchronize()
            assert _launches()[name] == before + 1, name
            _assert_matches(got, plain(*a), torch.float32)
            again = wrapper(*a)
            for x, y in zip(got if isinstance(got, tuple) else (got,),
                            again if isinstance(again, tuple) else (again,)):
                assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCOO_DATA))
@pytest.mark.parametrize("R", [1, 5, 72])
@pytest.mark.parametrize("half", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_scoo_kernels_match_plain(dev, name, R, half):
    """Rows 11 (half values and Vg) and 12 (half values, f32 Q) against
    their plain versions (f32 sums, unrounded), at the running-sum scale."""
    for kname, call, plain, scale in _scoo_calls(name, torch.float32, dev, R, half):
        launches = scoo.LAUNCHES[kname]
        got = call()
        torch.cuda.synchronize()
        assert scoo.LAUNCHES[kname] == launches + 1 and got.dtype == torch.float32
        want = plain()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-6,
                                   atol=1e-6 * scale)


# (kernel, K, I, C, R) -> the variant at half width: C % 8 == 0 takes the
# 16-byte ring, C % 8 == 4 (whole packs in f32) the element copies; F1 at
# R <= 8 takes its tensor-core ring
HALF_EDGES = {
    ("fused_procrustes_b", 9, 11, 16, 5): "ring-mma",
    ("fused_procrustes_b", 9, 11, 12, 5): "ring-mma-element-copies",
    ("fused_procrustes_b", 3, 9, 20, 72): "row-warp-wide",
    ("ykv", 9, 1, 16, 5): "ring",
    ("ykv", 9, 1, 12, 5): "ring-element-copies",
    ("ykv", 2, 1, 1024, 72): "thread-per-entry",
    ("mode2_compact", 9, 1, 16, 5): "ring",
    ("mode2_compact", 9, 1, 12, 5): "ring-element-copies",
    ("mode3", 9, 1, 12, 5): "ring-element-copies",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HALF_EDGES), ids=lambda c: "{}-K{}-I{}-C{}-R{}".format(*c))
@pytest.mark.parametrize("half", HALF_DTYPES, ids=["bf16", "f16"])
def test_half_variant_edges(dev, case, half):
    """The variant a half launch takes at the edges of the 16-byte ring
    (eight half values a copy) and past it, and the plain version's result
    there."""
    name, K, I, C, R = case
    rng = np.random.default_rng(K + I + C + R)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)  # noqa: E731
    if name == "fused_procrustes_b":
        a = (t(K, I, C).to(half), t(K, C, R).to(half), t(K, R), t(R, R))
        assert fused.procrustes_b_variant(a[0], R) == HALF_EDGES[case]
    elif name == "mode2_compact":
        a = (t(K, R, C).to(half), t(R, R), t(K, R), torch.ones((K, C), device=dev))
        assert m2.mode2_compact_variant(a[0], a[3]) == HALF_EDGES[case]
    else:
        a = (t(K, R, C).to(half), t(K, C, R).to(half))
        variant = (yk.ykv_variant if name == "ykv" else m3.mode3_variant)(*a)
        assert variant == HALF_EDGES[case]
        if name == "mode3":
            a = a + (t(R, R),)
    wrapper, plain = KERNELS[name]
    _assert_matches(wrapper(*a), plain(*a), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,fmt", [("auto", "cc"), ("staged", "cc"), ("staged", "scoo")])
@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_half_fit_within_contract_on_gpu(dev, backend, fmt, precision):
    """choa 0.002, rank 5, 20 iterations: the half fit on the card is finite,
    within 1e-3 of the same route's f32 fit at every iteration, and the
    half kernels of the route launched (buckets x iterations)."""
    bt = bucketize(choa_like(scale=0.002, seed=0), dtype=torch.float32, device=dev,
                   format=fmt)
    hists = {}
    for prec in ("f32", precision):
        fused.reset_launches()
        staged.reset_launches()
        scoo.reset_launches()
        _, hists[prec] = fit(bt, Parafac2Options(rank=5, backend=backend, precision=prec),
                             max_iters=20, tol=0.0, seed=0)
    half = np.asarray(hists[precision])
    assert np.all(np.isfinite(half))
    assert np.max(np.abs(half - np.asarray(hists["f32"]))) < 1e-3
    n = len(bt.buckets) * 20
    if backend == "auto":
        assert fused.LAUNCHES["fused_procrustes_b"] == fused.LAUNCHES["fused_ykv"] == n
    elif fmt == "scoo":
        assert scoo.LAUNCHES["scoo_project"] == staged.LAUNCHES["mode2_compact"] == n
    else:
        assert staged.LAUNCHES["ykv"] == staged.LAUNCHES["mode2_compact"] == n


# ---------------------------------------------------------------------------
# compression (rsvd): the core ALS on [Kb, S, C_pad] cores, P1 at R = S
# ---------------------------------------------------------------------------

def _compress_launches(backend: str, nb: int, iters: int) -> dict:
    """Every kernel launch of a compressed fit whose ``nb`` buckets all
    compress: the range bases (P1 once a bucket), ``iters`` core iterations,
    then ``expand_q`` (the core Procrustes step once more) and ``exact_fit``
    (Y_k V on the originals: F4 on CC, row 12's projection and row 5 on
    SCOO). The cores are CC buckets, so row 11 never launches."""
    core = nb * iters
    if backend == "auto":
        return {"fused_procrustes_b": core + nb, "fused_mode1_xkv": core,
                "fused_mode2_compact": core, "fused_ykv": core + nb,
                "gram_inv_sqrt": core + 2 * nb}
    return {"ykv": core + nb, "mode1_reuse": core, "mode2_compact": core, "mode3_reuse": core,
            "scoo_project": nb, "gram_inv_sqrt": core + 2 * nb}


def _kappa(G: torch.Tensor) -> torch.Tensor:
    """Per Gram, its condition over the eigenvalues the polar's clamp keeps
    (on the CPU's LAPACK, in f64)."""
    lam = torch.linalg.eigvalsh(G.cpu().double())
    top = lam[:, -1:].clamp(min=0.0)
    kept = torch.where(lam > top * 1e-12, lam, torch.full_like(lam, float("inf")))
    return (top[:, 0] / kept.min(1).values).nan_to_num(nan=1.0, posinf=1.0)


def _solve_bound(G: torch.Tensor, floor: float) -> torch.Tensor:
    """Per Gram G [K, R, R], what two f64 solves of its inverse root or of
    the range basis it orthonormalizes may part by, relative to the
    result's scale: max(floor, R kappa 2^-53) (a direction of eigenvalue
    lam moves by rounding / lam)."""
    return torch.clamp(G.shape[-1] * _kappa(G) * 2.0 ** -53, min=floor)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,fmt", [("auto", "cc"), ("staged", "scoo")])
def test_compressed_fit_on_gpu_matches_cpu(dev, backend, fmt):
    """choa 0.002, rank 5, f64, 20 iterations, ``compress="rsvd"``: the
    card's fit (Ω drawn on the CPU and moved, the same start) within 1e-8 of
    the port's CPU fit at every iteration, its last entry the exact fit, and
    each kernel of the route launched as the pass, the core iterations and
    the expansion need."""
    from repro_torch.launch.decompose import kernel_launches, reset_launches
    data = choa_like(scale=0.002, seed=0)
    opts = dict(rank=5, dtype=torch.float64, compress="rsvd")
    bt_cpu = bucketize(data, dtype=torch.float64, device="cpu", format=fmt)
    _, want = fit(bt_cpu, Parafac2Options(**opts, backend="torch"), max_iters=20, tol=0.0)
    bt = bucketize(data, dtype=torch.float64, device=dev, format=fmt)
    reset_launches()
    state, got = fit(bt, Parafac2Options(**opts, backend=backend), max_iters=20, tol=0.0)
    counts = {k: v for k, v in kernel_launches().items() if v}
    assert len(got) == 20 and got[-1] == float(state.fit)
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= 1e-8
    assert counts == _compress_launches(backend, len(bt.buckets), 20)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,fmt", [("auto", "cc"), ("staged", "cc"), ("staged", "scoo")])
def test_compressed_scan_matches_host_on_gpu(dev, backend, fmt):
    """The scan engine (chunks of 5 and the while variant) on the cores:
    history and V bit for bit the host engine's (f32, rsvd:10:6:1, rank
    4, 12 iterations)."""
    bt = bucketize(choa_like(scale=0.002, seed=0), device=dev, format=fmt)
    base = Parafac2Options(rank=4, backend=backend, compress="rsvd:10:6:1")
    s_host, h_host = fit(bt, base, max_iters=12, tol=0.0)
    for check_every in (5, 0):
        s, h = fit(bt, Parafac2Options(rank=4, backend=backend, compress="rsvd:10:6:1",
                                       engine="scan", check_every=check_every),
                   max_iters=12, tol=0.0)
        assert h == h_host and torch.equal(s.V, s_host.V)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_range_basis_on_gpu_matches_plain(dev, fmt):
    """``range_basis`` on the card (P1 at R = S = 18 on the range finder's
    Grams) against its plain version on the CPU (the same Ω, LAPACK), f64,
    subject by subject by its projector P P^T within max(1e-12, S kappa
    2^-53); P^T P idempotent; padding subjects a zero basis; and P1 on
    those Grams, in f32 and f64, against its plain version, each Gram
    within max(floor, R kappa 2^-53) of its max |P_inv| (thin subjects
    hand it rank-deficient Grams)."""
    from repro_torch.kernels import polar, sketch
    data = choa_like(scale=0.002, seed=0)
    bt = bucketize(data, dtype=torch.float64, device=dev, format=fmt, subject_align=8)
    bt_cpu = bucketize(data, dtype=torch.float64, device="cpu", format=fmt, subject_align=8)
    omega = sketch.gaussian_sketch(0, data.n_cols, 18, torch.float64)
    for b, bc in zip(bt.buckets, bt_cpu.buckets):
        P = sketch.range_basis(b, omega.to(dev))
        Y = sketch.power_iterate(bc, sketch.sketch_bucket(bc, omega), 1)
        G64 = Y.transpose(1, 2) @ Y
        Pc = sketch.range_basis(bc, omega)
        err = ((P @ P.transpose(1, 2)).cpu() - Pc @ Pc.transpose(1, 2)).abs().amax((1, 2))
        assert bool((err <= _solve_bound(G64, 1e-12)).all()), float(err.max())
        PtP = P.transpose(1, 2) @ P
        assert float((PtP @ PtP - PtP).abs().max()) <= 1e-4
        assert bool((P[b.subject_mask == 0] == 0).all())
        for dtype, floor in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
            G = G64.to(dtype)
            got = polar.gram_inv_sqrt(G.to(dev)).double().cpu()
            want = polar.gram_inv_sqrt_plain(G).double()
            bound = _solve_bound(G, floor) * want.abs().amax((1, 2))
            assert bool(((got - want).abs().amax((1, 2)) <= bound).all())
            assert bool((got[bc.subject_mask == 0] == 0).all())


# ---------------------------------------------------------------------------
# serving and robustness: update_subjects, the supervised scan fit, checkpoints
# ---------------------------------------------------------------------------

def _stream_batch(data, members, fmt, dev, dtype):
    """``members`` of ``data`` in an eight-slot batch, as the stream service
    pads a request batch (``fixed_plan``)."""
    import dataclasses
    from repro_torch.sparse import fixed_plan

    sub = IrregularCOO(subjects=[data.subjects[k] for k in members], n_cols=data.n_cols)
    i_pad = 8 * -(-max(s.n_rows for s in sub.subjects) // 8)
    c_pad = 8 * -(-max(s.nonzero_cols().size for s in sub.subjects) // 8)
    n_pad = 32 * -(-max(s.nnz for s in sub.subjects) // 32) if fmt == "scoo" else None
    bt = bucketize(sub, plan=fixed_plan(len(members), i_pad, c_pad, nnz_pad=n_pad),
                   formats=[fmt], subject_align=8, dtype=dtype, device=dev)
    return dataclasses.replace(bt, n_subjects=8)


STREAM_KERNELS = {("auto", "cc"): {"fused_procrustes_b", "fused_ykv", "gram_inv_sqrt"},
                  ("staged", "cc"): {"ykv", "mode3_reuse", "gram_inv_sqrt"},
                  ("staged", "scoo"): {"scoo_xk_times_v", "scoo_project", "ykv",
                                       "mode3_reuse", "gram_inv_sqrt"},
                  ("auto", "scoo"): {"gram_inv_sqrt"}}


# every subject's B_k far from singular (at least 12 rows and ~150 nonzeros
# over 60 columns at rank 5; checked in the test): the polar, and so each W
# row, is then determined to rounding
WELL_CONDITIONED = dict(n_subjects=24, n_cols=60, max_rows=30, min_rows=12,
                        avg_nnz_per_subject=150, seed=3)


def _kept_condition(bt, H, V, W) -> torch.Tensor:
    """Each subject's condition number of its Procrustes Gram B_k^T B_k at
    W, over the spectrum the polar keeps (above 1e-12 of the largest)."""
    from repro_torch.core.backend import get_backend
    out = torch.zeros(bt.n_subjects, dtype=torch.float64)
    for b in bt.buckets:
        _, B = get_backend("torch").procrustes_b_bucket(
            b, H, W[b.subject_ids.long()] * b.subject_mask[:, None], V)
        ev = torch.linalg.eigvalsh(B.transpose(1, 2) @ B)
        kept = torch.where(ev > ev[:, -1:] * 1e-12, ev, torch.full_like(ev, float("inf")))
        out[b.subject_ids[: b.n_real].long()] = (ev[:, -1] / kept.min(1).values)[: b.n_real]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("smooth_lam", [0.0, 0.1])
@pytest.mark.parametrize("backend,fmt", list(STREAM_KERNELS))
@pytest.mark.parametrize("dataset", ["well-conditioned", "choa"])
def test_update_subjects_on_gpu_matches_cpu(dev, dataset, backend, fmt, smooth_lam):
    """``update_subjects`` on an eight-slot request batch (six subjects)
    and over the whole union's buckets (the ``_adopt`` pass), f64, on the
    card against the port's CPU, the route's kernels launched, and the same
    bits twice. On a tensor whose every B_k is far from singular, W rows
    and residuals within 1e-12 (of the output's largest magnitude). On
    choa_like(0.002) most subjects' Grams are ill-conditioned (kept
    condition median ~2e7 at rank 5): there a 1-ulp change of H and V moves
    a W row by up to ~30 kappa 2^-53 (3e-8), so the polar, and each W row,
    is not determined to 1e-12, and the union's summed residual (the
    stream's fit) is held within 1e-12 relative instead."""
    from repro_torch.core import update_subjects
    from repro_torch.launch.decompose import kernel_launches, reset_launches
    well = dataset == "well-conditioned"
    data = random_irregular(**WELL_CONDITIONED) if well else choa_like(scale=0.002, seed=0)
    f64 = torch.float64
    bt_cpu = bucketize(data, dtype=f64, device="cpu", format=fmt)
    state, _ = fit(bt_cpu, Parafac2Options(rank=5, dtype=f64, backend="torch"), max_iters=8)
    if well:
        assert float(_kept_condition(bt_cpu, state.H, state.V, state.W).max()) < 1e4
    members = [0, 3, 7, 11, 15, 20] if well else [3, 17, 42, 101, 250, 600]
    rng = np.random.default_rng(0)
    w_prev = state.W[members + [0, 0]]
    w_init = (w_prev * torch.tensor(1.0 + 0.1 * rng.random((8, 1)))).contiguous()
    pmask = torch.tensor([1, 0, 1, 1, 0, 1, 0, 0], dtype=f64)
    kw = dict(smooth_lam=smooth_lam, inner_iters=2)
    for union in (False, True):
        def run(device, be):
            d = (bucketize(data, dtype=f64, device=device, format=fmt) if union
                 else _stream_batch(data, members, fmt, device, f64))
            opts = Parafac2Options(rank=5, dtype=f64, backend=be)
            if union:
                return update_subjects(d, state.H.to(device), state.V.to(device), opts,
                                       w_init=state.W.to(device))
            return update_subjects(d, state.H.to(device), state.V.to(device), opts,
                                   w_init=w_init.to(device), w_prev=w_prev.to(device),
                                   prev_mask=pmask.to(device), **kw)

        want = run("cpu", backend)
        reset_launches()
        got = run(dev, backend)
        launched = {k for k, v in kernel_launches().items() if v}
        again = run(dev, backend)
        assert launched == STREAM_KERNELS[(backend, fmt)]
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        if well:
            for g, w in zip(got, want):
                scale = max(1.0, float(w.abs().max()))
                assert float((g.cpu() - w).abs().max()) <= 1e-12 * scale
        else:
            r_got, r_want = float(got[1].sum()), float(want[1].sum())
            assert abs(r_got - r_want) <= 1e-12 * abs(r_want)
            assert bool(torch.isfinite(got[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["faultless", "blip", "restore", "rollback", "resume"])
def test_supervised_scan_fit_bit_for_bit_on_gpu(dev, case, tmp_path):
    """The supervised scan fit on the card (CC auto, f32, check_every 5,
    20 iterations), each fault path bit for bit the bare scan fit."""
    from repro_torch.core import engine
    from repro_torch.dist import FaultInjector, SupervisorConfig, supervised_fit
    bt = bucketize(choa_like(scale=0.002, seed=0), device=dev)
    opts = Parafac2Options(rank=5, backend="auto", engine="scan", check_every=5)
    s0, h0 = fit(bt, opts, max_iters=20, tol=0.0)
    cfg = {"faultless": {}, "blip": dict(injector=FaultInjector({1: 1})),
           "restore": dict(injector=FaultInjector({2: 5}), ckpt_dir=str(tmp_path)),
           "rollback": dict(injector=FaultInjector(nan_steps=[2])),
           "resume": dict(ckpt_dir=str(tmp_path), resume=True)}[case]
    if case == "resume":
        supervised_fit(bt, opts, max_iters=10, tol=0.0,
                       config=SupervisorConfig(ckpt_dir=str(tmp_path)))
    s, h, rep = supervised_fit(bt, opts, max_iters=20, tol=0.0, config=SupervisorConfig(**cfg))
    assert h == h0
    la, lb = engine._flatten(s), engine._flatten(s0)
    assert [k for k, _ in la] == [k for k, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert (rep.restores, rep.rollbacks) == {"restore": (1, 0), "rollback": (0, 1)}.get(
        case, (0, 0))


@pytest.mark.cuda
def test_checkpoint_from_card_restores_on_card_and_cpu(dev, tmp_path):
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import init_state
    bt = bucketize(choa_like(scale=0.002, seed=0), device=dev)
    opts = Parafac2Options(rank=5, backend="auto",
                           constraints={"v": "nonneg_admm", "w": "nonneg+l1:0.01"})
    state, _ = fit(bt, opts, max_iters=3)
    ckpt.save(str(tmp_path), 3, state)
    bt_cpu = bucketize(choa_like(scale=0.002, seed=0), device="cpu")
    for template in (init_state(bt, opts), init_state(bt_cpu, opts)):
        back, step, _ = ckpt.restore(str(tmp_path), template)
        assert step == 3 and back.H.device == template.H.device
        for f in ("H", "V", "W", "fit"):
            assert torch.equal(getattr(back, f).cpu(), getattr(state, f).cpu())
        for a, b in zip(back.aux["v"] + back.aux["w"], state.aux["v"] + state.aux["w"]):
            assert torch.equal(a.cpu(), b.cpu())


# ---------------------------------------------------------------------------
# the mesh engine on the card: a world of one over NCCL, and the shard cut
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend,fmt,check_every", [("auto", "cc", 5), ("auto", "cc", 0),
                                                      ("staged", "scoo", 5)])
def test_mesh_world_of_one_is_scan_on_gpu(dev, backend, fmt, check_every):
    """A world of one over NCCL: the mesh engine's fit (its all-reduces
    captured in the graph, 4 an iteration with a global W) is bit for bit
    the scan engine's, history and every state tensor."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.core import engine
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import mesh as lm

    try:
        lm.init_distributed("cuda")
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        bt = bucketize(choa_like(scale=0.002, seed=0), device=dev, dtype=torch.float32,
                       format=fmt)
        opts = Parafac2Options(rank=5, backend=backend, engine="scan", check_every=check_every)
        s_scan, h_scan = fit(bt, opts, max_iters=10, tol=0.0)
        dsh.COLLECTIVES.reset()
        s_mesh, h_mesh = fit(bt, dataclasses.replace(opts, engine="mesh"), max_iters=10,
                             tol=0.0)
        assert dsh.COLLECTIVES.calls == 4 * (engine.WARMUP_ITERS + 1)
        assert h_mesh == h_scan
        for (k, a), (_, b) in zip(engine._flatten(s_mesh), engine._flatten(s_scan)):
            assert torch.equal(a, b), k
    finally:
        lm.shutdown()


def _stage_rows(b, be, H, V, W, J):
    """A bucket's per-subject stage outputs through the route's kernels and
    its partial sums over subjects, at fixed H, V and a global W."""
    from repro_torch.core.procrustes import solve_q

    Wb = W[b.subject_ids.long()] * b.subject_mask[:, None]
    XkV, B = be.procrustes_b_bucket(b, H, Wb, V, b.gather_v(V))
    Q = solve_q(B, "gram_eigh") * b.subject_mask[:, None, None]
    proj = be.project_bucket(b, Q)
    G = be.ykv_bucket(b, proj, V)
    A = be.mode2_bucket(b, proj, H, Wb)
    M3 = torch.zeros_like(W)
    M3[b.subject_ids[: b.n_real].long()] = be.mode3_bucket(b, proj, H, YkV=G)[: b.n_real]
    sums = {"M1": be.mode1_xkv_bucket(b, Q, XkV, Wb), "M3": M3,
            "M2": be.mode2_scatter(A, b.cols, J, order=(b.scatter_perm, b.scatter_ends))}
    return {"XkV": XkV, "B": B, "Q": Q, "G": G, "A": A}, sums


@pytest.mark.cuda
def test_shard_stage_rows_bit_for_bit_on_gpu(dev):
    """choa 0.002's CC plan nnz-balanced for 4 ranks, each shard bucketized
    on its own: F1's XkV and B, P1's Q, F4's G and F3's A of each shard's
    subjects bit for bit the unsharded buckets' rows; the shards' M1, M2
    and M3 partials, summed, within 1e-6 of the largest magnitude."""
    from repro_torch.core.backend import get_backend
    from repro_torch.launch import decompose as dec

    data = choa_like(scale=0.002, seed=0)
    bt, _ = dec.prepare(data, buckets=4, device=dev, dtype=torch.float32)
    plan, _ = dec.plan_data(data, buckets=4, format="cc", n_shards=4)
    shards = [bucketize(data, device=dev, dtype=torch.float32, plan=plan, subject_align=4,
                        shard=(r, 4)) for r in range(4)]
    rng = np.random.default_rng(0)
    H, V, W = (torch.tensor(rng.random(s), dtype=torch.float32, device=dev)
               for s in ((5, 5), (bt.n_cols, 5), (bt.n_subjects, 5)))
    be = get_backend("auto", dev)
    whole, parts = {}, {}
    for i, b in enumerate(bt.buckets):
        rows, sums = _stage_rows(b, be, H, V, W, bt.n_cols)
        for k, v in sums.items():
            whole[k] = whole.get(k, 0) + v
        slot = torch.full((bt.n_subjects,), -1, dtype=torch.long, device=dev)
        slot[b.subject_ids[: b.n_real].long()] = torch.arange(b.n_real, device=dev)
        for r, sh in enumerate(shards):
            sb = sh.buckets[i]
            got, sums = _stage_rows(sb, be, H, V, W, bt.n_cols)
            for k, v in sums.items():
                parts[k] = parts.get(k, 0) + v
            at = slot[sb.subject_ids[: sb.n_real].long()]
            for k, v in got.items():
                assert torch.equal(v[: sb.n_real], rows[k][at]), (r, i, k)
    for k, v in parts.items():
        scale = max(1.0, float(whole[k].abs().max()))
        assert float((v - whole[k]).abs().max()) <= 1e-6 * scale, k


# ---------------------------------------------------------------------------
# the LM testbed's serving path (no hand kernel lies on it): the card
# against the port's own CPU run on the same parameters and inputs
# ---------------------------------------------------------------------------

LM_TOL = 1e-5     # f32 logits, relative to their largest magnitude


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "mamba2-780m", "minicpm-2b",
                                  "phi3.5-moe-42b-a6.6b", "pixtral-12b", "qwen3-0.6b",
                                  "qwen3-8b", "recurrentgemma-9b", "stablelm-3b",
                                  "whisper-medium"])
def test_lm_reduced_on_gpu_matches_cpu(dev, arch):
    from repro_torch.launch.serve import against_cpu

    r = against_cpu(arch, dev, steps=8, tol=LM_TOL)
    assert r["finite"] and r["forward"] <= LM_TOL and r["decode"] <= LM_TOL, r
    assert r["same"] == r["decided"] >= 15, r


@pytest.mark.cuda
@pytest.mark.parametrize("arch,length", [("qwen3-0.6b", 8), ("mamba2-780m", 8),
                                         ("recurrentgemma-9b", 24)])
def test_lm_decode_matches_prefill_on_gpu(dev, arch, length):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build

    cfg = reduced(get_config(arch))
    bundle = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = bundle.init_params(gen)                   # the GPU by default
    tokens = torch.randint(0, cfg.vocab_size, (2, length), generator=gen, device=dev)
    cache = bundle.init_cache(2, length)
    with torch.inference_mode():
        full = bundle.prefill_step(params, {"tokens": tokens})
        for t in range(length):
            logits, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1], t)
            assert _rel(logits[:, 0], full[:, t]) <= 1e-4


@pytest.mark.cuda
def test_lm_serve_on_gpu(dev):
    from repro_torch.launch import serve

    out = serve.main(["--reduce", "--batch", "2", "--prompt-len", "5", "--gen", "6"])
    assert out["generated"].shape == (2, 6) and out["generated"].device.type == "cuda"
    assert out["peak_gib"] > 0 and out["tokens_per_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "mamba2-780m", "minicpm-2b",
                                  "phi3.5-moe-42b-a6.6b", "pixtral-12b", "qwen3-0.6b",
                                  "qwen3-8b", "recurrentgemma-9b", "stablelm-3b",
                                  "whisper-medium"])
def test_lm_train_steps_on_gpu_match_cpu(dev, arch):
    """Three train steps (0-2) of the reduced arch (f32) on the card and on
    the CPU from the same parameters and batch (``launch.train.against_cpu``):
    losses within 1e-5, parameters and moments within ``step_gaps``'s
    bounds, step 0 leaving every parameter unchanged."""
    from repro_torch.launch import train

    r = train.against_cpu(arch, dev)
    assert r["finite"] and r["unmoved"] and r["loss"] <= train.LOSS_TOL, r
    assert r["within"], r


@pytest.mark.cuda
def test_lm_train_driver_on_gpu(dev, tmp_path):
    from repro_torch.launch import train

    out = train.main(["--reduce", "--steps", "12", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--lr", "3e-3",
                      "--log-every", "100"])
    assert out["last_loss"] < out["first_loss"] and out["peak_gib"] > 0
    assert out["params"]["embed"]["tokens"].device.type == "cuda"


# ---------------------------------------------------------------------------
# the LM on a mesh (ROADMAP A8c): a world of one
# ---------------------------------------------------------------------------

@pytest.fixture
def lm_world(dev):
    """A world of one (a ``HashStore``) whose CUDA tensors go through NCCL
    and CPU tensors through gloo, with a ("data", "model") mesh of (1, 1)
    on each device."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as lm

    if dist.is_initialized():
        lm.shutdown()
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield {d: init_device_mesh(d, (1, 1), mesh_dim_names=("data", "model"))
               for d in ("cuda", "cpu")}
    finally:
        dist.destroy_process_group()


def _moe_grads(block, p, x, w):
    from repro_torch.models.common import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(p) + [x]]
    y, aux = block(tree_unflatten(p, leaves[:-1]), leaves[-1])
    grads = torch.autograd.grad((y.float() * w).sum() + aux, leaves)
    return [y.detach(), aux.detach(), *grads]


def _moe_gap(a, b) -> float:
    return max(float((s.double().cpu() - t.double().cpu()).abs().max()
                     / t.double().abs().max().clamp(min=1e-30).cpu()) for s, t in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_mesh_manual_moe_on_gpu(lm_world, dev, dtype):
    """The reduced phi3.5-moe block through ``_moe_block_manual`` on the
    card's (1, 1) mesh: at a no-drop capacity against ``_moe_block_auto`` on
    the card (output, aux and every gradient leaf within 1e-5 of its
    largest magnitude in f32, 1e-3 in bf16); in f32 at the config's
    capacity (drops: the router drawn at std 1/sqrt(d), logits of order
    one, and tokens with a common mean) against the same call on the CPU,
    within 1e-5."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import tree_map
    from repro_torch.models.moe import _moe_block_auto, _moe_block_manual, init_moe

    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    no_drop = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = tree_map(lambda t: t.to(dtype) if t.ndim == 3 else t,
                 init_moe(gen, cfg, torch.float32, dev))
    p["router"]["w"] = torch.randn(cfg.d_model, cfg.n_experts, generator=gen,
                                   device=dev) / cfg.d_model ** 0.5
    x = (torch.randn(4, 32, cfg.d_model, generator=gen, device=dev)
         + torch.randn(cfg.d_model, generator=gen, device=dev)).to(dtype)
    w = torch.randn(4, 32, cfg.d_model, generator=gen, device=dev)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    manual = _moe_grads(lambda p_, x_: _moe_block_manual(p_, x_, no_drop, lm_world["cuda"]),
                        p, x, w)
    auto = _moe_grads(lambda p_, x_: _moe_block_auto(p_, x_, no_drop), p, x, w)
    assert _moe_gap(manual, auto) <= tol
    if dtype == torch.float32:
        card = _moe_grads(lambda p_, x_: _moe_block_manual(p_, x_, cfg, lm_world["cuda"]),
                          p, x, w)
        cpu = _moe_grads(lambda p_, x_: _moe_block_manual(p_, x_, cfg, lm_world["cpu"]),
                         tree_map(lambda t: t.cpu(), p), x.cpu(), w.cpu())
        assert _moe_gap(card, cpu) <= tol
        assert _moe_gap(card, manual) > 1e-3        # the config's capacity drops


@pytest.mark.cuda
def test_lm_mesh_compressed_psum_on_gpu_matches_cpu(lm_world, dev):
    """``compressed_psum`` over the card's mesh: the result and the new
    errors bit for bit the CPU function's on the same tree (leaves at
    scales 0.1 to 10, exact .5 ties among them), the errors each leaf's own
    ``ef_compress_update`` residual."""
    from repro_torch.dist import sharding as dsh
    from repro_torch.optim import compressed_psum, ef_compress_update

    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = {"a": (37, 129), "b": (1000,), "c": (3, 64, 65)}
    grads = {k: torch.randn(s, generator=gen, device=dev) * 10.0 ** (i - 1)
             for i, (k, s) in enumerate(shapes.items())}
    grads["b"][:4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=dev)   # scale 1: ties
    errors = {k: torch.randn(s, generator=gen, device=dev) * 1e-3 for k, s in shapes.items()}
    errors["b"][:4] = 0.0
    with dsh.axis_rules(dsh.LM_RULES, lm_world["cuda"]):
        red, new = compressed_psum(grads, errors, "data")
    with dsh.axis_rules(dsh.LM_RULES, lm_world["cpu"]):
        c_red, c_new = compressed_psum({k: v.cpu() for k, v in grads.items()},
                                       {k: v.cpu() for k, v in errors.items()}, "data")
    for k in shapes:
        assert red[k].device.type == "cuda"
        assert torch.equal(red[k].cpu(), c_red[k]) and torch.equal(new[k].cpu(), c_new[k]), k
        assert torch.equal(new[k], ef_compress_update(grads[k], errors[k])[3]), k
