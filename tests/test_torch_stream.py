"""The port's serving layer (``repro_torch.launch.stream`` and
``repro_torch.core.parafac2.update_subjects``) against the JAX package, on
the CPU in f64.

``update_subjects`` on padded CC and SCOO request batches (six subjects in
eight slots, the service's ``fixed_plan`` geometry) against the reference's
within 1e-12, with the temporal anchor off and on, one and two inner
iterations, and the W constraints the rows are solved through: HALS
(``nonneg``), ADMM (``nonneg_admm``; ``smooth``, which hands the batch's
rows to P2's plain version), and the ridge route (``none``); with the
anchor on, each row has a Gram of its own (``Constraint.update_rows``, the
reference's ``vmap``). ``synthetic_stream``'s payloads byte for byte the
reference's; ``validate_payload``'s and the constructor's errors the
reference's. A whole service replay against the reference's
``StreamService`` from the same warm factors (the reference's init state
injected by monkeypatching the port's ``init_state``), CC and SCOO, eight
slots, a drift threshold between two batches' drifts: W rows, residuals,
``stream_fit`` and ``drift`` within 1e-8, the same refit points and
``compiled_geometries``. A cold refit bit for bit the port's batch fit over
the union; save, ``from_checkpoint`` and one more batch bit for bit the
uninterrupted service; the CLI's summary keys the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        init_state as j_init_state, update_subjects as j_update_subjects)
from repro.launch import stream as j_stream  # noqa: E402
from repro.sparse import (IrregularCOO as JIrregularCOO, fixed_plan as j_fixed_plan,  # noqa: E402
                          random_parafac2 as j_random_parafac2)
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, bucketize, fit, update_subjects  # noqa: E402
from repro_torch.core import parafac2 as p2  # noqa: E402
from repro_torch.launch import stream  # noqa: E402
from repro_torch.sparse import IrregularCOO, fixed_plan, random_parafac2  # noqa: E402

F64 = torch.float64
RANK = 3
DATA = dict(n_subjects=40, n_cols=36, max_rows=24, rank=RANK, density=0.5, seed=3,
            noise=0.05)
SLOTS = 8


@pytest.fixture(scope="module")
def model():
    """Both packages' copies of one dataset, and a 6-iteration f64 fit of it
    (the fixed factors every batch is solved against)."""
    jd, _ = j_random_parafac2(**DATA)
    td, _ = random_parafac2(**DATA)
    s, _ = fit(bucketize(td, dtype=F64, device="cpu"),
               Parafac2Options(rank=RANK, dtype=F64, backend="torch"), max_iters=6)
    return dict(jd=jd, td=td, H=s.H.numpy(), V=s.V.numpy(), W=s.W.numpy())


def _batches(model, fmt):
    """Six subjects of the dataset in an eight-slot batch, in each package."""
    members = [3, 7, 11, 19, 26, 33]
    geom = dict(i_pad=24, c_pad=40, nnz_pad=960 if fmt == "scoo" else None)
    jb = JIrregularCOO(subjects=[model["jd"].subjects[k] for k in members],
                       n_cols=model["jd"].n_cols)
    tb = IrregularCOO(subjects=[model["td"].subjects[k] for k in members],
                      n_cols=model["td"].n_cols)
    bj = j_bucketize(jb, plan=j_fixed_plan(6, **geom), formats=[fmt], subject_align=SLOTS,
                     dtype=jnp.float64)
    bt = bucketize(tb, plan=fixed_plan(6, **geom), formats=[fmt], subject_align=SLOTS,
                   dtype=F64, device="cpu")
    return (dataclasses.replace(bj, n_subjects=SLOTS) if dataclasses.is_dataclass(bj)
            else bj._replace(n_subjects=SLOTS)), dataclasses.replace(bt, n_subjects=SLOTS)


# (W constraint, smooth_lam, inner_iters): HALS, ADMM and ridge with the
# anchor off and on, one and two inner iterations; smooth's rows through P2
CASES = [(w, lam, it) for w in ("nonneg", "nonneg_admm", "none") for lam in (0.0, 0.1)
         for it in (1, 2)] + [("smooth:0.1", 0.0, 2), ("smooth:0.1", 0.1, 1)]


@pytest.mark.parametrize("w_spec,smooth_lam,inner_iters", CASES)
@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_update_subjects_matches_reference(model, fmt, w_spec, smooth_lam, inner_iters):
    bj, bt = _batches(model, fmt)
    cons = {"v": "nonneg", "w": w_spec}
    rng = np.random.default_rng(0)
    W = model["W"][[3, 7, 11, 19, 26, 33, 0, 0]]
    w_init = np.abs(W + 0.1 * rng.standard_normal(W.shape))
    w_prev = W.copy()
    pmask = np.asarray([1, 0, 1, 1, 0, 1, 0, 0], dtype=np.float64)
    kw = dict(smooth_lam=smooth_lam, inner_iters=inner_iters)
    Wj, rj = j_update_subjects(bj, jnp.asarray(model["H"]), jnp.asarray(model["V"]),
                               JOptions(rank=RANK, dtype=jnp.float64, backend="jnp",
                                        constraints=cons),
                               w_init=jnp.asarray(w_init), w_prev=jnp.asarray(w_prev),
                               prev_mask=jnp.asarray(pmask), **kw)
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    Wt, rt = update_subjects(bt, t(model["H"]), t(model["V"]),
                             Parafac2Options(rank=RANK, dtype=F64, backend="torch",
                                             constraints=cons),
                             w_init=t(w_init), w_prev=t(w_prev), prev_mask=t(pmask), **kw)
    assert np.max(np.abs(Wt.numpy() - np.asarray(Wj))) <= 1e-12
    assert np.max(np.abs(rt.numpy() - np.asarray(rj))) <= 1e-12 * max(1.0, np.abs(rj).max())
    assert not Wt[6:].any() and not rt[6:].any()          # padded slots stay zero


def test_update_subjects_inner_iters_error():
    opts = Parafac2Options(rank=RANK, dtype=F64)
    with pytest.raises(ValueError, match="inner_iters"):
        update_subjects(None, None, None, opts, inner_iters=0)


def test_synthetic_stream_payloads_match_reference(model):
    for kw in (dict(), dict(warm_frac=0.5, touch_frac=0.5, seed=3),
               dict(warm_frac=0.7, touch_frac=1.0, holdout_frac=0.5, seed=6)):
        jw, jp = j_stream.synthetic_stream(model["jd"], **kw)
        tw, tp = stream.synthetic_stream(model["td"], **kw)
        assert json.dumps(tp) == json.dumps(jp)
        assert len(tw.subjects) == len(jw.subjects)
        for a, b in zip(tw.subjects, jw.subjects):
            assert a.n_rows == b.n_rows
            for f in ("rows", "cols", "vals"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_payload_and_constructor_errors_match_reference(model):
    n_cols, n_known = 16, 3
    ok = {"rows": [0, 1], "cols": [2, 3], "vals": [1.0, 2.0]}
    sid, block = stream.validate_payload(dict(ok), n_cols, n_known)
    assert sid is None and block.nnz == 2 and block.n_rows == 2
    bad = [[1, 2, 3], {"rows": [0], "cols": [0]}, {**ok, "vals": [1.0]},
           {"rows": [], "cols": [], "vals": []}, {**ok, "rows": [-1, 0]},
           {**ok, "cols": [0, n_cols]}, {**ok, "vals": [1.0, float("nan")]},
           {**ok, "n_rows": 1}, {**ok, "subject": n_known}, {**ok, "subject": "zero"},
           {**ok, "vals": ["a", "b"]}, {**ok, "rows": [[0, 1]], "cols": [[2, 3]],
                                        "vals": [[1.0, 2.0]]}]
    for payload in bad:
        assert (_message(stream.validate_payload, payload, n_cols, n_known)
                == _message(j_stream.validate_payload, payload, n_cols, n_known))
    td, jd = model["td"], model["jd"]
    K = td.n_subjects
    for kw in (dict(w_layout="bucketed"), dict(refit="lukewarm"), dict(format="csr"),
               dict(batch_slots=0)):
        okw = {k: v for k, v in kw.items() if k == "w_layout"}
        skw = {k: v for k, v in kw.items() if k != "w_layout"}
        got = _message(stream.StreamService, td.subjects, td.n_cols,
                       Parafac2Options(rank=RANK, dtype=F64, **okw), H=np.eye(RANK),
                       V=np.zeros((td.n_cols, RANK)), W=np.ones((K, RANK)), device="cpu",
                       **skw)
        want = _message(j_stream.StreamService, jd.subjects, jd.n_cols,
                        JOptions(rank=RANK, dtype=jnp.float64, **okw), H=np.eye(RANK),
                        V=np.zeros((jd.n_cols, RANK)), W=np.ones((K, RANK)), **skw)
        assert got == want


# ---------------------------------------------------------------------------
# the whole service
# ---------------------------------------------------------------------------

# alignments that hold every batch of the stream in one pinned geometry, so
# that the reference compiles one dispatch a format
SERVICE = dict(batch_slots=SLOTS, refit_iters=8, refit_tol=0.0, max_buckets=1,
               row_align=32, col_align=48, nnz_align=512)
STREAM = dict(warm_frac=0.6, touch_frac=0.5, seed=3)


def _drifting(model):
    """Warm population and payloads (the reference's synthetic stream, then
    unrelated junk slices at 8x scale, so drift grows batch by batch)."""
    tw, tp = stream.synthetic_stream(model["td"], **STREAM)
    jw, _ = j_stream.synthetic_stream(model["jd"], **STREAM)
    rng = np.random.default_rng(5)
    for _ in range(6):
        n = int(rng.integers(6, 20))
        rows = rng.integers(0, n, size=40)
        tp.append({"rows": rows.tolist(), "cols": rng.integers(0, DATA["n_cols"], 40).tolist(),
                   "vals": (8.0 * rng.random(40)).tolist(), "n_rows": n})
    return tw, jw, tp


def _serve(svc, payloads, drifts=None):
    for i in range(0, len(payloads), SLOTS):
        for p in payloads[i:i + SLOTS]:
            svc.submit(p)
        svc.flush()
        if drifts is not None:
            drifts.append(svc.drift)
    return svc


@pytest.fixture(scope="module")
def replay(model):
    """The reference's and the port's services over one stream, from the
    same warm factors, at a drift threshold between two batches' drifts."""
    tw, jw, payloads = _drifting(model)
    jopts = JOptions(rank=RANK, dtype=jnp.float64, backend="jnp")
    opts = Parafac2Options(rank=RANK, dtype=F64, backend="torch")
    s0 = j_init_state(j_bucketize(jw, dtype=jnp.float64), jopts, seed=0)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    orig = p2.init_state

    def injected(data, opts_, seed=0, *, state=None):
        if state is None and data.n_subjects == tw.n_subjects:
            state = state_from_arrays(arrays, device="cpu", dtype=F64)
        return orig(data, opts_, seed, state=state)

    p2.init_state = injected
    try:
        drifts = []
        probe, _ = stream.StreamService.warm_start(tw, opts, iters=6, format="cc",
                                                   drift_threshold=np.inf, device="cpu",
                                                   **SERVICE)
        _serve(probe, payloads, drifts)
        # between the drifts of the last batch but one and the one before
        # it (the drift grows batch by batch): one refit, one batch after it
        assert np.all(np.diff(drifts) > 0)
        thresh = 0.5 * (drifts[-3] + drifts[-2])
        out = {}
        for fmt in ("cc", "scoo"):
            svc, _ = stream.StreamService.warm_start(tw, opts, iters=6, format=fmt,
                                                     drift_threshold=thresh, device="cpu",
                                                     **SERVICE)
            jsvc, _ = j_stream.StreamService.warm_start(jw, jopts, iters=6, format=fmt,
                                                        drift_threshold=thresh, **SERVICE)
            out[fmt] = (_serve(svc, payloads), _serve(jsvc, payloads))
    finally:
        p2.init_state = orig
    return dict(out=out, drifts=drifts, thresh=thresh)


@pytest.mark.parametrize("fmt", ["cc", "scoo"])
def test_service_replay_matches_reference(replay, fmt):
    svc, jsvc = replay["out"][fmt]
    ts, js = svc.stats(), jsvc.stats()
    assert js["refits"] == 1 and ts["refit_at"] == js["refit_at"]
    assert ts["compiled_geometries"] == js["compiled_geometries"]
    assert (ts["appends"], ts["batches"], ts["new"], ts["touched"]) == (
        js["appends"], js["batches"], js["new"], js["touched"])
    assert np.max(np.abs(svc.W - np.asarray(jsvc.W))) <= 1e-8
    assert np.max(np.abs(svc._sub_resid - jsvc._sub_resid)) <= 1e-8
    for k in ("stream_fit", "drift", "baseline_fit", "drift_max"):
        assert abs(ts[k] - js[k]) <= 1e-8, k
    assert np.max(np.abs(svc.H.numpy() - np.asarray(jsvc.H))) <= 1e-8


def test_cold_refit_is_the_batch_fit(model):
    tw, tp = stream.synthetic_stream(model["td"], **STREAM)
    opts = Parafac2Options(rank=RANK, dtype=F64, backend="torch")
    svc, _ = stream.StreamService.warm_start(tw, opts, iters=4, drift_threshold=np.inf,
                                             format="scoo", refit="cold", device="cpu",
                                             **SERVICE)
    _serve(svc, tp)
    info = svc.refit(mode="cold")
    bt = svc._bucketize_union(svc.union_data())
    state, hist = fit(bt, opts, max_iters=SERVICE["refit_iters"], tol=0.0, seed=0)
    W, resid = update_subjects(bt, state.H, state.V, opts, w_init=state.W)
    assert torch.equal(svc.H, state.H) and torch.equal(svc.V, state.V)
    assert info["fit"] == hist[-1] and np.array_equal(svc.W, W.numpy())
    assert np.array_equal(svc._sub_resid, np.maximum(resid.numpy(), 0.0))
    assert svc.refit_at == [len(tp)]


def test_checkpoint_resume_is_the_uninterrupted_service(model, tmp_path):
    tw, tp = stream.synthetic_stream(model["td"], **STREAM)
    opts = Parafac2Options(rank=RANK, dtype=F64, backend="torch")
    svc, _ = stream.StreamService.warm_start(tw, opts, iters=4, drift_threshold=np.inf,
                                             device="cpu", **SERVICE)
    _serve(svc, tp[:16])
    svc.save(str(tmp_path))
    back = stream.StreamService.from_checkpoint(str(tmp_path), svc.union_data(), opts,
                                                drift_threshold=np.inf, device="cpu",
                                                **SERVICE)
    assert back.baseline_fit == svc.baseline_fit and back.n_appends == svc.n_appends
    for s in (svc, back):
        _serve(s, tp[16:24])
    assert np.array_equal(back.W, svc.W) and torch.equal(back.H, svc.H)
    assert np.array_equal(back._sub_resid, svc._sub_resid)
    assert back.stream_fit == svc.stream_fit and back.drift == svc.drift
    with pytest.raises(ValueError, match="subjects"):
        stream.StreamService.from_checkpoint(
            str(tmp_path), IrregularCOO(subjects=svc.subjects[:-1], n_cols=svc.n_cols),
            opts, device="cpu")


def test_cli_summary_keys_match_reference(tmp_path):
    argv = ["--dataset", "choa", "--scale", "0.0005", "--rank", "3", "--warm-iters", "1",
            "--limit", "2", "--batch-slots", "2", "--format", "cc"]
    got = stream.main(argv + ["--device", "cpu", "--json", str(tmp_path / "t.json")])
    want = j_stream.main(argv + ["--backend", "jnp"])
    assert sorted(got) == sorted(want)
    assert sorted(got["resolved_options"]) == sorted(want["resolved_options"])
    assert got["platform"] == "cpu" and got["appends"] == want["appends"] == 2
    assert json.loads((tmp_path / "t.json").read_text())["kind"] == "stream"
    with pytest.raises(NotImplementedError, match="A6"):
        stream.main(argv + ["--device", "cpu", "--engine", "mesh"])
