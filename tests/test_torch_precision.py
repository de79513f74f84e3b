"""Half precision (``precision="bf16"|"f16"``) of the port against the JAX
package's.

Inputs are made with numpy from a seed; the reference runs on the CPU, its
Pallas stages in interpret mode, and the port runs its plain versions (the
CUDA kernels are held against these in ``test_torch_cuda.py``).

- The helpers: ``PRECISIONS``, ``compute_cast`` bit for bit, the option
  errors, ``get_backend``'s cached instances, ``_pc`` the identity at f32,
  the buckets' half copy.
- Each of the nine kernels that take half operands, at bf16 and f16 (row 5
  also with one operand f32), against its reference kernel.
- Every bucket stage of every route against the reference's counterpart
  backend (port ``torch`` <-> ``jnp``, ``staged`` <-> ``pallas``,
  ``fused`` <-> ``fused``, ``scoo`` <-> ``scoo``) on CC and SCOO buckets,
  from the same upstream operands. Outputs that stay f32 agree to f32
  summation order (1e-6 of the output's largest magnitude: products of two
  half values are exact in f32); outputs the reference rounds to half
  within one half ulp of that magnitude (2^-8 bf16, 2^-11 f16).
- The 20-iteration choa 0.001 fit (max_buckets 2, rank 5, tol 0, the
  reference's state0) of every route at bf16 and f16 on CC and SCOO data:
  finite, within 1e-3 of the route's own f32 fit and of the reference's
  half fit on the counterpart backend at every iteration (the reference's
  contract, ``tests/test_backend.py``). ``-s`` prints the gaps.
- The scan engine (chunks and the while variant) bit for bit the host
  engine at bf16 on the CPU, and the launcher's ``--precision``.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import Parafac2Options as JOptions  # noqa: E402
from repro.core import bucketize as j_bucketize  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_state as j_init_state  # noqa: E402
from repro.core.backend import get_backend as j_get_backend  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.kernels import common as j_common  # noqa: E402
from repro.kernels import fused as j_fused  # noqa: E402
from repro.kernels import scoo as j_scoo  # noqa: E402
from repro.kernels.mttkrp_mode1 import mode1_pallas  # noqa: E402
from repro.kernels.mttkrp_mode2 import mode2_compact_pallas  # noqa: E402
from repro.kernels.mttkrp_mode3 import mode3_pallas  # noqa: E402
from repro.kernels.ykv import ykv_pallas  # noqa: E402
from repro.launch import decompose as j_decompose  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, bucketize, fit  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.backend import (BACKENDS, FusedBackend, StagedBackend,  # noqa: E402
                                      TorchBackend, get_backend)
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import common, fused, scoo  # noqa: E402
from repro_torch.kernels.mttkrp_mode1 import mode1  # noqa: E402
from repro_torch.kernels.mttkrp_mode2 import mode2_compact  # noqa: E402
from repro_torch.kernels.mttkrp_mode3 import mode3  # noqa: E402
from repro_torch.kernels.ykv import ykv  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

HALF = ("bf16", "f16")
TDT = {"bf16": torch.bfloat16, "f16": torch.float16}
JDT = {"bf16": jnp.bfloat16, "f16": jnp.float16}
HALF_ULP = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}   # one half ulp, relative
# port route -> the reference's counterpart backend (auto is torch on the CPU)
ROUTES = {"torch": "jnp", "staged": "pallas", "fused": "fused", "scoo": "scoo",
          "auto": "jnp"}
ITERS = 20
FIT_TOL = 1e-3          # the reference's contract: "within 0.1pp"


def _np(x) -> np.ndarray:
    """A port tensor or a reference array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _kind(x) -> str:
    dt = str(x.dtype).removeprefix("torch.")
    return {"bfloat16": "half", "float16": "half"}.get(dt, dt)


def _check(port, want, prec: str) -> None:
    """The port's output has the reference's width (f32 or half). An f32
    output agrees to summation order: 1e-6 relative plus 1e-6 of its largest
    magnitude (at least 1); a half output within one half ulp of its largest
    magnitude."""
    assert _kind(port) == _kind(want), (port.dtype, want.dtype)
    p, w = _np(port), _np(want)
    assert p.shape == w.shape and np.all(np.isfinite(p))
    top = float(np.abs(w).max(initial=0.0))
    if _kind(want) == "half":
        np.testing.assert_allclose(p, w, rtol=0, atol=HALF_ULP[prec] * top)
    else:
        np.testing.assert_allclose(p, w, rtol=1e-6, atol=1e-6 * max(1.0, top))


def _t(x) -> torch.Tensor:
    """A reference array (or numpy) as a port tensor of its own width."""
    a = np.asarray(x)
    dt = {np.dtype(jnp.bfloat16): torch.bfloat16, np.dtype(jnp.float16): torch.float16}
    half = dt.get(a.dtype)
    t = torch.tensor(a.astype(np.float32) if half is not None else a)
    return t.to(half) if half is not None else t


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_precisions_are_the_references():
    assert common.PRECISIONS == j_common.PRECISIONS


@pytest.mark.parametrize("prec", [None, "f32", "bf16", "f16"])
def test_compute_cast_matches_reference_bit_for_bit(prec):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)) * 10.0 ** rng.integers(-3, 3, (5, 7))
    for a in (x.astype(np.float32), x, np.arange(12, dtype=np.int32)):
        got = common.compute_cast(torch.tensor(a), prec)
        want = j_common.compute_cast(jnp.asarray(a), prec)
        assert _kind(got) == _kind(want)
        if _kind(got) == "half":
            bits = got.view(torch.int16).numpy().view(np.uint16)
            assert np.array_equal(bits, np.asarray(want).view(np.uint16))
            assert got.dtype == TDT[prec]
        else:
            assert got.dtype == torch.tensor(a).dtype
            assert np.array_equal(got.numpy(), np.asarray(want))
    assert common.compute_cast(None, prec) is None
    if prec in (None, "f32"):
        t = torch.ones(3, dtype=torch.float64)
        assert common.compute_cast(t, prec) is t


def test_compute_cast_rejects_an_unknown_precision():
    with pytest.raises(ValueError) as got:
        common.compute_cast(torch.ones(2), "f8")
    with pytest.raises(ValueError) as want:
        j_common.compute_cast(jnp.ones(2), "f8")
    assert str(got.value) == str(want.value)


def test_option_errors_match_reference():
    cases = [dict(precision="f8"), dict(precision="bf16", dtype="f64")]
    for case in cases:
        f64 = case.pop("dtype", None) == "f64"
        with pytest.raises(ValueError, match="precision") as got:
            Parafac2Options(rank=3, dtype=torch.float64 if f64 else torch.float32, **case)
        with pytest.raises(ValueError, match="precision") as want:
            JOptions(rank=3, dtype=jnp.float64 if f64 else jnp.float32, **case)
        assert str(got.value) == str(want.value)
    # f64 data keeps its accumulator: precision="f32" is the identity
    Parafac2Options(rank=3, precision="f32", dtype=torch.float64)


def test_get_backend_precision_instances():
    """Configured, cached instances per (name, precision); the f32 default
    stays the shared singleton, as the reference's get_backend."""
    assert get_backend("fused") is BACKENDS["fused"]
    assert get_backend("fused", precision="f32") is BACKENDS["fused"]
    be = get_backend("torch", precision="bf16")
    assert isinstance(be, TorchBackend) and be.precision == "bf16"
    assert get_backend("torch", precision="bf16") is be
    assert get_backend("torch", "cpu", "f32") is BACKENDS["torch"]
    assert get_backend("fused", precision="f16").precision == "f16"
    assert isinstance(get_backend("staged", precision="f16"), StagedBackend)
    # auto resolves from the device, then configures
    assert get_backend("auto", "cpu", "bf16") is be
    assert isinstance(get_backend("auto", "cuda", "bf16"), FusedBackend)
    assert get_backend("auto", "cuda", "bf16") is get_backend("fused", precision="bf16")
    with pytest.raises(ValueError) as got:
        TorchBackend(precision="int8")
    with pytest.raises(ValueError) as want:
        j_get_backend("jnp", "int8")
    assert str(got.value) == str(want.value)


def test_pc_is_the_identity_at_f32():
    x = torch.ones(4, 3)
    for name in ("torch", "scoo", "fused", "staged"):
        be = get_backend(name)
        assert be._pc(x) is x
        assert be._pc(None) is None


def test_the_half_copy_is_pc_of_the_values_made_once():
    """``with_compute_values`` gives each bucket ``vals_half =
    compute_cast(vals)`` (the same bits), keeps the f32 norm, is the data
    itself at f32, and the stages read that very tensor."""
    data = choa_like(scale=0.0005, seed=0)
    for fmt in ("cc", "scoo"):
        bt = bucketize(data, max_buckets=2, device="cpu", dtype=torch.float32, format=fmt)
        assert bt.with_compute_values("f32") is bt
        assert bt.with_compute_values(None) is bt
        for prec in HALF:
            bh = bt.with_compute_values(prec)
            assert bh.norm_sq == bt.norm_sq and bh.n_subjects == bt.n_subjects
            be = get_backend("torch", precision=prec)
            for b, h in zip(bt.buckets, bh.buckets):
                assert h.vals is b.vals and h.vals_half.dtype == TDT[prec]
                assert torch.equal(h.vals_half, common.compute_cast(b.vals, prec))
                assert be._vals(h) is h.vals_half
                assert torch.equal(be._vals(b), h.vals_half)    # cast without the copy
            # a copy made for the other precision is not read
            other = get_backend("torch", precision=HALF[1 - HALF.index(prec)])
            assert other._vals(bh.buckets[0]).dtype != TDT[prec]


def test_dtype_words_round_trip_through_operand_code():
    """The per-operand dtype word of the C entry points: a word of 0 or 1
    is every operand f32 or f64 (the entry points' words before half
    precision), and common.cuh's ``operand_code`` reads each code back."""
    from repro_torch.kernels._launch import pack_codes

    def operand_code(word, j):      # csrc/common.cuh
        first = word & 15
        n = (word >> (4 * j)) & 15
        return first if j == 0 or n == 0 else n - 1

    assert pack_codes([0, 0]) == 0 and pack_codes([1, 1, 1]) == 1
    for codes in ([0, 2], [2, 0], [3, 3], [0, 3], [3, 0], [2], [1, 1]):
        word = pack_codes(codes)
        assert [operand_code(word, j) for j in range(len(codes))] == codes


# ---------------------------------------------------------------------------
# the nine kernels that take half operands
# ---------------------------------------------------------------------------

def _kernel_operands(seed=0, K=9, I=11, C=37, R=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cm = (rng.random((K, C)) > 0.2).astype(np.float32)
    sm = np.ones(K, np.float32)
    sm[-2:] = 0.0
    return dict(vals=f(K, I, C), Vg=f(K, C, R), Wb=f(K, R), H=f(R, R), Q=f(K, I, R),
                Yc=f(K, R, C), cm=cm, sm=sm)


@pytest.mark.parametrize("prec", HALF)
def test_fused_kernels_match_reference(prec):
    """F1 (half slab and Vg), F3 (half slab), F4 (half slab and Vg)."""
    o = _kernel_operands()
    h = {k: common.compute_cast(torch.tensor(v), prec) for k, v in o.items()}
    t = {k: torch.tensor(v) for k, v in o.items()}
    j = {k: jnp.asarray(v) for k, v in o.items()}
    jh = {k: v.astype(JDT[prec]) for k, v in j.items()}
    XkV, B = fused.fused_procrustes_b(h["vals"], h["Vg"], t["Wb"], t["H"])
    want = j_fused.fused_procrustes_b(jh["vals"], jh["Vg"], j["Wb"], j["H"], interpret=True)
    _check(XkV, want[0], prec)
    _check(B, want[1], prec)
    Wm = j["Wb"] * j["sm"][:, None]
    _check(fused.fused_mode2_compact(h["vals"], t["Q"], t["H"], t["Wb"] * t["sm"][:, None],
                                     t["cm"]),
           j_fused.fused_mode2_compact(jh["vals"], j["Q"], j["H"], Wm, j["cm"],
                                       interpret=True), prec)
    _check(fused.fused_ykv(h["vals"], t["Q"], h["Vg"]),
           j_fused.fused_ykv(jh["vals"], j["Q"], jh["Vg"], interpret=True), prec)


@pytest.mark.parametrize("prec", HALF)
@pytest.mark.parametrize("yc_half,vg_half", [(True, True), (False, True), (True, False)])
def test_staged_kernels_match_reference(prec, yc_half, vg_half):
    """Rows 5, 6 and 9 with Yc and Vg each f32 or half, row 8 with a half Yc
    (the rows with one half operand run once per precision)."""
    o = _kernel_operands(seed=1)
    t = {k: torch.tensor(v) for k, v in o.items()}
    j = {k: jnp.asarray(v) for k, v in o.items()}
    cast_t = lambda x, on: common.compute_cast(x, prec) if on else x  # noqa: E731
    cast_j = lambda x, on: x.astype(JDT[prec]) if on else x  # noqa: E731
    Yc, Vg = cast_t(t["Yc"], yc_half), cast_t(t["Vg"], vg_half)
    jYc, jVg = cast_j(j["Yc"], yc_half), cast_j(j["Vg"], vg_half)
    _check(ykv(Yc, Vg), ykv_pallas(jYc, jVg, interpret=True), prec)
    _check(mode1(Yc, Vg, t["Wb"], t["sm"]),
           mode1_pallas(jYc, jVg, j["Wb"], j["sm"], interpret=True), prec)
    _check(mode3(Yc, Vg, t["H"], t["sm"]),
           mode3_pallas(jYc, jVg, j["H"], j["sm"], interpret=True), prec)
    if yc_half and vg_half:
        _check(mode2_compact(Yc, t["H"], t["Wb"], t["cm"], t["sm"]),
               mode2_compact_pallas(jYc, j["H"], j["Wb"], j["cm"], j["sm"], interpret=True),
               prec)


@pytest.mark.parametrize("prec", HALF)
def test_scoo_kernels_match_reference(prec):
    """Rows 11 (half vals and Vg) and 12 (half vals, f32 Q): f32 sums, as
    the Pallas kernels' (not rounded, as their use_pallas wrappers do)."""
    kw = dict(n_subjects=13, n_cols=37, max_rows=9, avg_nnz_per_subject=18, seed=4)
    bj = j_bucketize(j_random_irregular(**kw), max_buckets=2, dtype=jnp.float32,
                     format="scoo")
    bt = bucketize(random_irregular(**kw), max_buckets=2, device="cpu",
                   dtype=torch.float32, format="scoo")
    rng = np.random.default_rng(4)
    for b_j, b_t in zip(bj.buckets, bt.buckets):
        Vg = rng.standard_normal((b_t.kb, b_t.c_pad, 5)).astype(np.float32)
        Q = rng.standard_normal((b_t.kb, b_t.i_pad, 5)).astype(np.float32)
        vals_t = common.compute_cast(b_t.vals, prec)
        vals_j = b_j.vals.astype(JDT[prec])
        got = scoo.scoo_xk_times_v(vals_t, b_t.rows, b_t.lcols,
                                   common.compute_cast(torch.tensor(Vg), prec), b_t.i_pad,
                                   row_ends=b_t.row_ends)
        want = j_scoo.xk_times_v_pallas(vals_j, b_j.rows, b_j.lcols,
                                        jnp.asarray(Vg).astype(JDT[prec]), b_j.i_pad,
                                        nnz_counts=b_j.nnz_counts, interpret=True)
        _check(got, want, prec)
        got = scoo.scoo_project(vals_t, b_t.rows, b_t.lcols, torch.tensor(Q), b_t.c_pad,
                                cperm=b_t.cperm, col_ends=b_t.col_ends)
        want = j_scoo.project_pallas(vals_j, b_j.rows, b_j.lcols, jnp.asarray(Q), b_j.c_pad,
                                     nnz_counts=b_j.nnz_counts, interpret=True)
        _check(got, want, prec)
        # the plain helpers round back to the values' width, as the reference's
        _check(scoo.xk_times_v(vals_t, b_t.rows, b_t.lcols,
                               common.compute_cast(torch.tensor(Vg), prec), b_t.i_pad,
                               row_ends=b_t.row_ends),
               j_scoo.xk_times_v(vals_j, b_j.rows, b_j.lcols,
                                 jnp.asarray(Vg).astype(JDT[prec]), b_j.i_pad,
                                 row_ends=b_j.row_ends), prec)


# ---------------------------------------------------------------------------
# every route's bucket stages against the counterpart backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", HALF)
@pytest.mark.parametrize("fmt", ["cc", "scoo"])
@pytest.mark.parametrize("route", ["torch", "staged", "fused", "scoo"])
def test_bucket_stages_match_counterpart(route, fmt, prec):
    """Each stage from the same upstream operands on both sides: the
    reference's XkV, projected representation and Y_k V, in their widths,
    feed the port's later stages too."""
    kw = dict(n_subjects=13, n_cols=37, max_rows=9, avg_nnz_per_subject=18, seed=0)
    bkw = dict(max_buckets=2, col_align=4, format=fmt)
    bt_j = j_bucketize(j_random_irregular(**kw), dtype=jnp.float32, **bkw)
    bt_t = bucketize(random_irregular(**kw), device="cpu", dtype=torch.float32, **bkw)
    port, ref = get_backend(route, precision=prec), j_get_backend(ROUTES[route], prec)
    R = 5
    rng = np.random.default_rng(0)
    H, V, W = (rng.standard_normal(s).astype(np.float32) for s in ((R, R), (37, R), (13, R)))
    Hj, Vj, Wj = map(jnp.asarray, (H, V, W))
    Ht, Vt, Wt = map(torch.tensor, (H, V, W))
    for bj, bt in zip(bt_j.buckets, bt_t.buckets):
        Q = rng.standard_normal((bj.kb, bj.i_pad, R)).astype(np.float32)
        Qj, Qt = jnp.asarray(Q), torch.tensor(Q)
        Wbj, Wbt = jnp.take(Wj, bj.subject_ids, 0), Wt[bt.subject_ids.long()]
        XkV_j, B_j = ref.procrustes_b_bucket(bj, Hj, Wbj, Vj)
        XkV_t, B_t = port.procrustes_b_bucket(bt, Ht, Wbt, Vt)
        _check(XkV_t, XkV_j, prec)
        _check(B_t, B_j, prec)
        proj_j, proj_t = ref.project_bucket(bj, Qj), port.project_bucket(bt, Qt)
        _check(proj_t, proj_j, prec)
        proj, XkV = _t(proj_j), _t(XkV_j)
        _check(port.mode1_xkv_bucket(bt, Qt, XkV, Wbt),
               ref.mode1_xkv_bucket(bj, Qj, XkV_j, Wbj), prec)
        _check(port.mode1_bucket(bt, proj, Wbt, Vt), ref.mode1_bucket(bj, proj_j, Wbj, Vj),
               prec)
        _check(port.mode2_bucket(bt, proj, Ht.T, Wbt), ref.mode2_bucket(bj, proj_j, Hj.T, Wbj),
               prec)
        G_j = ref.ykv_bucket(bj, proj_j, Vj)
        _check(port.ykv_bucket(bt, proj, Vt), G_j, prec)
        _check(port.mode3_bucket(bt, proj, Ht, YkV=_t(G_j)),
               ref.mode3_bucket(bj, proj_j, Hj, YkV=G_j), prec)
        _check(port.mode3_bucket(bt, proj, Ht, Vt), ref.mode3_bucket(bj, proj_j, Hj, Vj), prec)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def choa():
    """Both packages' f32 buckets of choa_like(0.001) in CC and SCOO
    (max_buckets 2) and the reference's rank-5 state0 for each."""
    out = {}
    j_data, t_data = j_choa_like(scale=0.001, seed=0), choa_like(scale=0.001, seed=0)
    for fmt in ("cc", "scoo"):
        bj = j_bucketize(j_data, max_buckets=2, dtype=jnp.float32, format=fmt)
        bt = bucketize(t_data, max_buckets=2, device="cpu", dtype=torch.float32, format=fmt)
        s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float32, backend="jnp"), seed=0)
        out[fmt] = dict(bj=bj, bt=bt, s0=s0,
                        arrays={k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")})
    return out


@pytest.fixture(scope="module")
def fits(choa):
    """The 20-iteration fits on ``choa``, each run once: ``fits.ref(fmt,
    backend, prec)`` the reference's history, ``fits.port(fmt, route, prec,
    engine, check_every)`` the port's (state, history), both from the
    reference's state0."""
    @functools.lru_cache(maxsize=None)
    def ref(fmt, backend, prec):
        d = choa[fmt]
        opts = JOptions(rank=5, dtype=jnp.float32, backend=backend, precision=prec)
        return np.asarray(j_fit(d["bj"], opts, max_iters=ITERS, tol=0.0, state=d["s0"])[1])

    @functools.lru_cache(maxsize=None)
    def port(fmt, route, prec, engine_name="host", check_every=10):
        d = choa[fmt]
        opts = Parafac2Options(rank=5, dtype=torch.float32, backend=route, precision=prec,
                               engine=engine_name, check_every=check_every)
        state0 = state_from_arrays(d["arrays"], device="cpu", dtype=torch.float32)
        state, hist = fit(d["bt"], opts, max_iters=ITERS, tol=0.0, state=state0)
        return state, np.asarray(hist)

    return types.SimpleNamespace(ref=ref, port=port)


@pytest.mark.parametrize("prec", HALF)
@pytest.mark.parametrize("fmt", ["cc", "scoo"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_half_fit_within_contract(fits, route, fmt, prec):
    """Finite, within 1e-3 of the route's own f32 fit and of the reference's
    half fit on the counterpart backend, at every iteration."""
    _, own = fits.port(fmt, route, "f32")
    _, half = fits.port(fmt, route, prec)
    want = fits.ref(fmt, ROUTES[route], prec)
    assert len(half) == ITERS and np.all(np.isfinite(half))
    gap_own = float(np.max(np.abs(half - own)))
    gap_ref = float(np.max(np.abs(half - want)))
    print(f"[precision] {route:6s} {fmt:4s} {prec}: max |half - own f32| {gap_own:.3e}, "
          f"max |half - reference {ROUTES[route]} {prec}| {gap_ref:.3e}, "
          f"final {half[-1]:.5f} (f32 {own[-1]:.5f})")
    assert gap_own < FIT_TOL
    assert gap_ref < FIT_TOL


@pytest.mark.parametrize("route,fmt", [("auto", "cc"), ("staged", "cc"), ("staged", "scoo")])
def test_scan_and_while_bit_for_bit_host_at_bf16(fits, route, fmt):
    """The scan engine in chunks of 10 and its while variant (check_every 0)
    equal the host engine at bf16, history and every leaf of the state."""
    host_state, host = fits.port(fmt, route, "bf16")
    for check_every in (10, 0):
        state, hist = fits.port(fmt, route, "bf16", "scan", check_every)
        assert np.array_equal(hist, host), check_every
        for (k, a), (k2, b) in zip(engine._flatten(state), engine._flatten(host_state)):
            assert k == k2 and torch.equal(a, b), (check_every, k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_decompose_precision_flag(tmp_path):
    """``--precision bf16 --device cpu`` runs; the summary's precision is
    the flag's, its dtype the factor dtype's, and an f64 dtype below f32
    precision is refused before any data is made."""
    got = decompose.main(["--scale", "0.001", "--iters", "2", "--device", "cpu",
                          "--precision", "bf16", "--json", str(tmp_path / "p.json")])
    assert got["precision"] == "bf16" and got["dtype"] == "float32"
    assert np.all(np.isfinite(got["fit_history"]))
    with pytest.raises(ValueError, match="precision"):
        decompose.main(["--scale", "0.001", "--iters", "1", "--device", "cpu",
                        "--precision", "f16", "--dtype", "float64"])


def test_decompose_summary_precision_matches_reference(tmp_path):
    """The summaries of the port and the reference for the same flags carry
    the same precision (the flag's, not the factor dtype's)."""
    flags = ["--dataset", "choa", "--scale", "0.001", "--rank", "5", "--iters", "2",
             "--seed", "0", "--precision", "f16"]
    port = decompose.main(flags + ["--device", "cpu", "--json", str(tmp_path / "p.json")])
    want = j_decompose.main(flags + ["--json", str(tmp_path / "r.json")])
    assert port["precision"] == want["precision"] == "f16"
    assert port["resolved_options"] == want["resolved_options"]
