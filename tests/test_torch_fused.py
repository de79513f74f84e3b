"""The four fused ALS stages of the port against the JAX package's.

On the CPU the port's wrappers run their kernels' plain torch versions; the
JAX side runs its Pallas kernels in interpret mode, as
``tests/test_backend.py::test_fused_stage_parity`` does. Same data (numpy,
from a seed), same bucket plan, same factors, over the reference's four
geometries and an empty bucket, within the reference's FUSED_TOLS: f32 1e-6,
f64 1e-12. In f32 the atol is taken relative to the output's largest
magnitude (``_close``): the two frameworks sum in different orders, and one
f32 rounding of a partial sum of magnitude 16-32 is 2^-19 = 1.9e-6. The CUDA
kernels themselves are held against these plain versions in
``test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import bucketize as j_bucketize  # noqa: E402
from repro.core.backend import get_backend as j_get_backend  # noqa: E402
from repro.kernels import fused as j_fused  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro_torch.core import bucketize  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

J_FUSED = j_get_backend("fused")
FUSED = get_backend("fused")

# the geometries of tests/test_backend.py: odd/unaligned (R=5, col_align=4),
# aligned (R=8, col_align=128), rank 1, and subject padding inside buckets
GEOMETRIES = [
    dict(seed=0, K=13, J=37, R=5, col_align=4),
    dict(seed=1, K=9, J=200, R=8, col_align=128),
    dict(seed=2, K=7, J=21, R=1, col_align=8),
    dict(seed=3, K=11, J=50, R=6, col_align=4, subject_align=8),
]
FUSED_TOLS = {torch.float32: dict(rtol=1e-6, atol=1e-6),
              torch.float64: dict(rtol=1e-12, atol=1e-12)}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _setup(dtype, *, seed, K, J, R, col_align, subject_align=1, buckets=2,
           max_rows=9):
    """Both packages' buckets of the same data, and numpy factors."""
    kw = dict(n_subjects=K, n_cols=J, max_rows=max_rows,
              avg_nnz_per_subject=18, seed=seed)
    bkw = dict(max_buckets=buckets, col_align=col_align,
               subject_align=subject_align)
    bt_j = j_bucketize(j_random_irregular(**kw), dtype=JDT[dtype], **bkw)
    bt_t = bucketize(random_irregular(**kw), device="cpu", dtype=dtype, **bkw)
    rng = np.random.default_rng(seed)
    H, V, W = (rng.standard_normal(s) for s in ((R, R), (J, R), (K, R)))
    Qs = [rng.standard_normal((b.kb, b.i_pad, R)) for b in bt_j.buckets]
    return bt_j, bt_t, H, V, W, Qs


def _close(port, ref, tol):
    """assert_allclose at ``tol``; in f32 the atol scales with the output's
    largest magnitude (sums taken in another order differ by a rounding of
    the largest partial sum), in f64 it is absolute."""
    port, ref = port.cpu().numpy(), np.asarray(ref)
    atol = tol["atol"]
    if port.dtype == np.float32:
        atol *= max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(port, ref, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_stages_match_reference(geom, dtype):
    bt_j, bt_t, H, V, W, Qs = _setup(dtype, **geom)
    tol = FUSED_TOLS[dtype]
    jd = JDT[dtype]
    Hj, Vj, Wj = (jnp.asarray(a, jd) for a in (H, V, W))
    Ht, Vt, Wt = (torch.tensor(a, dtype=dtype) for a in (H, V, W))
    for bj, bt, Q in zip(bt_j.buckets, bt_t.buckets, Qs):
        Qj, Qt = jnp.asarray(Q, jd), torch.tensor(Q, dtype=dtype)
        Wbj = jnp.take(Wj, bj.subject_ids, 0)
        Wbt = Wt[bt.subject_ids.long()]
        # F1: X_k V and the Procrustes input B in one slab pass
        XkV_j, B_j = J_FUSED.procrustes_b_bucket(bj, Hj, Wbj, Vj)
        XkV_t, B_t = FUSED.procrustes_b_bucket(bt, Ht, Wbt, Vt)
        _close(XkV_t, XkV_j, tol)
        _close(B_t, B_j, tol)
        # F2: Q^T XkV reduced to the M1 partial
        _close(FUSED.mode1_xkv_bucket(bt, Qt, XkV_t, Wbt),
               J_FUSED.mode1_xkv_bucket(bj, Qj, XkV_j, Wbj), tol)
        # F3: mode-2 compact straight from the slab
        _close(FUSED.mode2_bucket(bt, Qt, Ht, Wbt),
               J_FUSED.mode2_bucket(bj, Qj, Hj, Wbj), tol)
        # F4: G = Y_k V, and mode-1/3 from it
        _close(FUSED.ykv_bucket(bt, Qt, Vt), J_FUSED.ykv_bucket(bj, Qj, Vj), tol)
        _close(FUSED.mode1_bucket(bt, Qt, Wbt, Vt),
               J_FUSED.mode1_bucket(bj, Qj, Wbj, Vj), tol)
        _close(FUSED.mode3_bucket(bt, Qt, Ht, Vt),
               J_FUSED.mode3_bucket(bj, Qj, Hj, Vj), tol)


def test_fused_empty_bucket_contributes_nothing():
    """All-padding subjects (mask 0) give zeros through every fused stage,
    as in the reference."""
    bt_j, bt_t, H, V, W, Qs = _setup(torch.float32, seed=4, K=6, J=30, R=4,
                                     col_align=4)
    bj, bt, Q = bt_j.buckets[0], bt_t.buckets[0], Qs[0]
    ej = dataclasses.replace(bj, subject_mask=jnp.zeros_like(bj.subject_mask),
                             col_mask=jnp.zeros_like(bj.col_mask))
    et = dataclasses.replace(bt, subject_mask=torch.zeros_like(bt.subject_mask),
                             col_mask=torch.zeros_like(bt.col_mask))
    Qj, Qt = jnp.asarray(Q, jnp.float32), torch.tensor(Q, dtype=torch.float32)
    Wbj = jnp.take(jnp.asarray(W, jnp.float32), ej.subject_ids, 0)
    Wbt = torch.tensor(W, dtype=torch.float32)[et.subject_ids.long()]
    Hj, Ht = jnp.asarray(H, jnp.float32), torch.tensor(H, dtype=torch.float32)
    Vj, Vt = jnp.asarray(V, jnp.float32), torch.tensor(V, dtype=torch.float32)
    tol = dict(rtol=0, atol=1e-6)
    for port, ref, shape in [
        (FUSED.mode1_xkv_bucket(et, Qt, Qt, Wbt),
         J_FUSED.mode1_xkv_bucket(ej, Qj, Qj, Wbj), (4, 4)),
        (FUSED.mode2_bucket(et, Qt, Ht, Wbt), J_FUSED.mode2_bucket(ej, Qj, Hj, Wbj),
         (et.kb, et.c_pad, 4)),
        (FUSED.mode3_bucket(et, Qt, Ht, Vt), J_FUSED.mode3_bucket(ej, Qj, Hj, Vj),
         (et.kb, 4)),
    ]:
        _close(port, ref, tol)
        _close(port, np.zeros(shape), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_k0_bucket_returns_zeros(dtype):
    """A bucket with no subjects returns zeros of the right shapes without a
    launch, as the reference does."""
    I, C, R = 8, 12, 3
    jd = JDT[dtype]
    vals, Vg = torch.zeros((0, I, C), dtype=dtype), torch.zeros((0, C, R), dtype=dtype)
    Q, Wb = torch.zeros((0, I, R), dtype=dtype), torch.zeros((0, R), dtype=dtype)
    H, cm = torch.eye(R, dtype=dtype), torch.zeros((0, C), dtype=dtype)
    jv, jVg, jQ, jWb = (jnp.zeros(t.shape, jd) for t in (vals, Vg, Q, Wb))
    jH, jcm = jnp.eye(R, dtype=jd), jnp.zeros((0, C), jd)
    fused.reset_launches()
    XkV, B = fused.fused_procrustes_b(vals, Vg, Wb, H)
    XkV_j, B_j = j_fused.fused_procrustes_b(jv, jVg, jWb, jH, interpret=True)
    pairs = [
        (XkV, XkV_j), (B, B_j),
        (fused.fused_mode1_xkv(Q, Q, Wb), j_fused.fused_mode1_xkv(jQ, jQ, jWb, interpret=True)),
        (fused.fused_mode2_compact(vals, Q, H, Wb, cm),
         j_fused.fused_mode2_compact(jv, jQ, jH, jWb, jcm, interpret=True)),
        (fused.fused_ykv(vals, Q, Vg), j_fused.fused_ykv(jv, jQ, jVg, interpret=True)),
    ]
    for port, ref in pairs:
        assert tuple(port.shape) == tuple(ref.shape)
        assert port.dtype == dtype
        _close(port, ref, dict(rtol=0, atol=0))
    assert sum(fused.LAUNCHES.values()) == 0


def test_wrappers_reject_bad_operands():
    """Shape checks raise before anything runs; on the CPU a wrapper takes
    its plain version and counts no launch."""
    vals = torch.rand((3, 8, 12), dtype=torch.float64)
    Vg = torch.rand((3, 12, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        fused.fused_procrustes_b(vals, Vg, torch.rand((3, 5), dtype=torch.float64),
                                 torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        fused.fused_ykv(vals, torch.rand((3, 8, 4), dtype=torch.float64),
                        torch.rand((3, 11, 4), dtype=torch.float64))
    fused.reset_launches()
    fused.fused_ykv(vals, torch.rand((3, 8, 4), dtype=torch.float64), Vg)
    assert sum(fused.LAUNCHES.values()) == 0


def test_procrustes_b_variant_is_a_question_for_the_card():
    """F1's variant is the CUDA launcher's choice: asking it for a CPU slab
    raises before any kernel library is built or loaded."""
    with pytest.raises(ValueError, match="CUDA"):
        fused.procrustes_b_variant(torch.rand((3, 8, 12)), 5)
    assert fused.LIB._lib is None


# K below and past the 2048 runs of F2's kernel (csrc/fused.cu)
REDUCTION_K = [7, 2100]


def _mode1_xkv_op(K, I, R, dtype):
    rng = np.random.default_rng(K + I + R)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    sm = np.ones(K)
    sm[::3] = 0.0
    return {k: a.astype(npdt) for k, a in dict(
        Q=rng.standard_normal((K, I, R)), XkV=rng.standard_normal((K, I, R)),
        Wb=rng.standard_normal((K, R)), sm=sm).items()}


@pytest.mark.parametrize("K", REDUCTION_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mode1_xkv_matches_interpret_kernel_below_and_past_the_runs(K, dtype):
    """fused_mode1_xkv with a subject mask against the reference's kernel in
    interpret mode on the folded Wb, within FUSED_TOLS."""
    op = _mode1_xkv_op(K, 8, 5, dtype)
    t = {k: torch.tensor(v) for k, v in op.items()}
    jd = JDT[dtype]
    want = j_fused.fused_mode1_xkv(jnp.asarray(op["Q"], jd), jnp.asarray(op["XkV"], jd),
                                   jnp.asarray(op["Wb"] * op["sm"][:, None], jd),
                                   interpret=True)
    got = fused.fused_mode1_xkv(t["Q"], t["XkV"], t["Wb"], t["sm"])
    _close(got, want, FUSED_TOLS[dtype])


def _emulate_mode1_xkv(Q, XkV, Wb, sm, runs=2048):
    """The summation order of F2's kernel (csrc/fused.cu), every variant, in
    numpy: min(K, runs) runs of ceil(K / runs) contiguous subjects; in a
    run, subject by subject in order, s = sum_i Q[k, i, r] XkV[k, i, l] with
    i in order, then acc += s * w_k; then per entry the runs' partials added
    in run order."""
    K, I, R = Q.shape
    w = Wb * sm[:, None]
    n = min(K, runs)
    per = -(-K // n)
    out = np.zeros((R, R))
    for b in range(n):
        acc = np.zeros((R, R))
        for k in range(b * per, min(K, b * per + per)):
            s = np.zeros((R, R))
            for i in range(I):
                s = s + np.outer(Q[k, i], XkV[k, i])
            acc = acc + s * w[k][None, :]
        out = out + acc
    return out


@pytest.mark.parametrize("K", REDUCTION_K)
@pytest.mark.parametrize("R", [1, 5, 11])
def test_fused_mode1_xkv_summation_order_matches_plain(K, R):
    """F2's order (runs, subjects and rows in order, partials in run order),
    emulated in f64, equals the plain version within 1e-12."""
    op = _mode1_xkv_op(K, 4, R, torch.float64)
    want = fused.fused_mode1_xkv(*(torch.tensor(op[k]) for k in ("Q", "XkV", "Wb", "sm")))
    _close(torch.tensor(_emulate_mode1_xkv(op["Q"], op["XkV"], op["Wb"], op["sm"])), want,
           FUSED_TOLS[torch.float64])


# ---------------------------------------------------------------------------
# F3 and F4: the summation order of every variant of their kernels
# (csrc/fused.cu), emulated in numpy over all subjects at once
# ---------------------------------------------------------------------------

def _butterfly(parts):
    """The lanes' fixed-order shuffle reduction (xor over the lowest index
    bit first): ((p0 + p1) + (p2 + p3)) + ... over 2^n parts."""
    parts = list(parts)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _ring_xkv(vals, Vg, vec):
    """F1's ring order for X_k Vg_k (F4's FMA ring shares it): eight lane
    groups q sum the 16-byte packs p = q, q + 8, ... of a row, each pack's
    vec values in order, then the groups add in a butterfly."""
    K, I, C = vals.shape
    n_packs = -(-C // vec)
    groups = []
    for q in range(8):
        acc = np.zeros((K, I, Vg.shape[-1]))
        for p in range(q, n_packs, 8):
            for c in range(p * vec, min(C, p * vec + vec)):
                acc = acc + vals[:, :, c, None] * Vg[:, None, c, :]
        groups.append(acc)
    return _butterfly(groups)


def _row_warp_xkv(vals, Vg):
    """The row-warp order: lane L of a warp sums columns L, L + 32, ... in
    order, then the 32 lanes add in a butterfly (xor 16 first)."""
    K, I, C = vals.shape
    lanes = []
    for L in range(32):
        acc = np.zeros((K, I, Vg.shape[-1]))
        for c in range(L, C, 32):
            acc = acc + vals[:, :, c, None] * Vg[:, None, c, :]
        lanes.append(acc)
    for off in (16, 8, 4, 2, 1):         # each lane adds its partner's sum to its own
        lanes = [lanes[L] + lanes[L ^ off] for L in range(32)]
    return lanes[0]


def _mma_xkv(vals, Vg):
    """The tensor-core order: 16-wide k-steps in order, each adding one
    16-term block product (the inner order is the hardware's)."""
    K, I, C = vals.shape
    acc = np.zeros((K, I, Vg.shape[-1]))
    for k0 in range(0, C, 16):
        acc = acc + vals[:, :, k0:k0 + 16] @ Vg[:, k0:k0 + 16, :]
    return acc


def _sequential_g(Q, X, rows):
    g = np.zeros((Q.shape[0], Q.shape[2], X.shape[2]))
    for i in rows:
        g = g + Q[:, i, :, None] * X[:, i, None, :]
    return g


def _emulate_ykv(vals, Q, Vg, variant):
    """G_k = Q_k^T X_k Vg_k in the order of F4's ``variant``."""
    K, I, C = vals.shape
    R = Q.shape[-1]
    if variant.startswith("ring-mma"):
        X = _mma_xkv(vals, Vg)
        MT = -(-I // 16)
        warps = []
        for w in range(4):               # warp w: m-tiles w, w + 4, ...; group g: rows g, g + 8
            groups = []
            for g in range(8):
                rows = [i for mt in range(w, MT, 4) for i in (mt * 16 + g, mt * 16 + g + 8)
                        if i < I]
                groups.append(_sequential_g(Q, X, rows))
            warps.append(_butterfly(groups))
        return sum(warps[1:], warps[0])
    if variant.startswith("ring"):
        X = _ring_xkv(vals, Vg, vec=2)   # f64: two values a 16-byte pack
        if R > 8:                        # the rows through shared memory, in order
            return _sequential_g(Q, X, range(I))
        warps = []                       # owner (warp w, slot s): rows i = w*4 + s mod 32
        for w in range(8):
            warps.append(_butterfly([_sequential_g(Q, X, range(w * 4 + s, I, 32))
                                     for s in range(4)]))
        return sum(warps[1:], warps[0])
    # row-warp (and wide: its 64-wide chunks of l are independent columns)
    return _sequential_g(Q, _row_warp_xkv(vals, Vg), range(I))


def _emulate_procrustes_b(vals, Vg, Wb, H, variant):
    """(XkV, B) in the order of F1's ``variant``: X_k Vg_k as F1's FMA ring
    (``ring``) or the tensor cores' k-steps (``ring-mma``), then B[i, l] =
    sum_r (XkV[i, r] w[r]) H[l, r], r in order, in both."""
    X = _mma_xkv(vals, Vg) if variant == "ring-mma" else _ring_xkv(vals, Vg, vec=2)
    B = np.zeros_like(X)
    for r in range(X.shape[-1]):
        B = B + (X[:, :, r, None] * Wb[:, None, r, None]) * H[None, None, :, r]
    return X, B


def _emulate_mode2(vals, Q, H, Wb, cm, variant):
    """A_k in the order of F3's ``variant``: y[c, r] over i in order, a over
    r in order, then (a * w) * col_mask; wide: per 64-wide chunk of r."""
    K, I, C = vals.shape
    R = Q.shape[-1]
    y = np.zeros((K, C, R))
    for i in range(I):
        y = y + vals[:, i, :, None] * Q[:, i, None, :]
    chunk = 64 if variant.endswith(("wide", "wide-chunked")) else R
    out = None
    for r0 in range(0, R, chunk):
        a = np.zeros((K, C, R))
        for r in range(r0, min(R, r0 + chunk)):
            a = a + y[:, :, r, None] * H[None, None, r, :]
        part = a * Wb[:, None, :] * cm[:, :, None]
        out = part if out is None else out + part
    return out


# (variant, R): F4's variants by rank, F3's by rank
F4_ORDER_CASES = [(v, R) for R in (1, 5, 8) for v in ("ring", "ring-mma", "row-warp")] + [
    ("ring", 9), ("row-warp", 9), ("row-warp-wide", 72)]
F3_ORDER_CASES = [(v, R) for R in (1, 5, 8, 9) for v in ("ring", "thread-per-column")] + [
    ("thread-per-column-wide", 72)]
# K below and past the persistent grid (three ring blocks on each of 132
# SMs); I = 19, not a multiple of 16; C = 40, not a multiple of 16 either
ORDER_K = [3, 500]


def _slab_op(K, I, C, R, seed):
    rng = np.random.default_rng(seed)
    cm = (rng.random((K, C)) < 0.7).astype(float)
    Wb = rng.standard_normal((K, R))
    Wb[::4] = 0.0                        # masked subjects, folded in
    return dict(vals=rng.standard_normal((K, I, C)), Q=rng.standard_normal((K, I, R)),
                Vg=rng.standard_normal((K, C, R)), H=rng.standard_normal((R, R)), Wb=Wb, cm=cm)


# (variant, R): F1's rings; the tensor-core ring takes R <= 8
F1_ORDER_CASES = [(v, R) for R in (1, 5, 8) for v in ("ring", "ring-mma")] + [("ring", 9)]


@pytest.mark.parametrize("K", ORDER_K)
@pytest.mark.parametrize("variant,R", F1_ORDER_CASES)
def test_fused_procrustes_b_summation_order_matches_plain(K, variant, R):
    """Each F1 ring's order (the FMA ring's lane groups and butterfly, the
    tensor cores' k-steps; B from the row's R sums in order), emulated in
    f64, equals the plain version within 1e-12, masked subjects' B zero."""
    op = _slab_op(K, 19, 40, R, seed=K + R + 2)
    want = fused.fused_procrustes_b(*(torch.tensor(op[k]) for k in ("vals", "Vg", "Wb", "H")))
    got = _emulate_procrustes_b(op["vals"], op["Vg"], op["Wb"], op["H"], variant)
    for g, w in zip(got, want):
        _close(torch.tensor(g), w, FUSED_TOLS[torch.float64])
    assert not want[1][::4].any()


@pytest.mark.parametrize("K", ORDER_K)
@pytest.mark.parametrize("variant,R", F4_ORDER_CASES)
def test_fused_ykv_summation_order_matches_plain(K, variant, R):
    """Each F4 variant's order (F1's ring rows and G's register owners, the
    tensor cores' k-steps and row groups, the row-warp lanes), emulated in
    f64, equals the plain version within 1e-12."""
    op = _slab_op(K, 19, 40, R, seed=K + R)
    want = fused.fused_ykv(*(torch.tensor(op[k]) for k in ("vals", "Q", "Vg")))
    _close(torch.tensor(_emulate_ykv(op["vals"], op["Q"], op["Vg"], variant)), want,
           FUSED_TOLS[torch.float64])


@pytest.mark.parametrize("K", ORDER_K)
@pytest.mark.parametrize("variant,R", F3_ORDER_CASES)
def test_fused_mode2_compact_summation_order_matches_plain(K, variant, R):
    """Each F3 variant's order (the ring's and the thread-per-column
    kernel's: rows, then r, then w and the column mask; wide: per 64-wide
    chunk of r), emulated in f64, equals the plain version within 1e-12,
    zeros at masked subjects and columns included."""
    op = _slab_op(K, 19, 40, R, seed=K + R + 1)
    args = [torch.tensor(op[k]) for k in ("vals", "Q", "H", "Wb", "cm")]
    want = fused.fused_mode2_compact(*args)
    got = _emulate_mode2(op["vals"], op["Q"], op["H"], op["Wb"], op["cm"], variant)
    _close(torch.tensor(got), want, FUSED_TOLS[torch.float64])
    assert not want[::4].any() and not want[op["cm"] == 0].any()


@pytest.mark.parametrize("shape", [(5, 19, 40, 5), (4, 7, 17, 9), (3, 33, 130, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_mode2_and_ykv_plain_match_interpret_kernels(shape, dtype):
    """The plain versions that the CUDA F3 and F4 are held to equal the
    reference's Pallas kernels in interpret mode on the same operands,
    within FUSED_TOLS."""
    K, I, C, R = shape
    op = _slab_op(K, I, C, R, seed=sum(shape))
    jd = JDT[dtype]
    j = {k: jnp.asarray(v, jd) for k, v in op.items()}
    t = {k: torch.tensor(v, dtype=dtype) for k, v in op.items()}
    tol = FUSED_TOLS[dtype]
    _close(fused.fused_mode2_compact(t["vals"], t["Q"], t["H"], t["Wb"], t["cm"]),
           j_fused.fused_mode2_compact(j["vals"], j["Q"], j["H"], j["Wb"], j["cm"],
                                       interpret=True), tol)
    _close(fused.fused_ykv(t["vals"], t["Q"], t["Vg"]),
           j_fused.fused_ykv(j["vals"], j["Q"], j["Vg"], interpret=True), tol)


@pytest.mark.parametrize("query", ["ykv_fused_variant", "mode2_compact_fused_variant"])
def test_f3_f4_variants_are_a_question_for_the_card(query):
    """F3's and F4's variants are the CUDA launcher's choice: asking for a
    CPU slab raises before any kernel library is built or loaded."""
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fused, query)(torch.rand((3, 8, 12)), 5)
    assert fused.LIB._lib is None
