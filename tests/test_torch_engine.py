"""The port's device-resident engines (``repro_torch.core.engine``) and P1's
plain version against the JAX package, on choa_like(scale=0.002), rank 5,
f64, from the reference's state0.

On the CPU the scan engine runs its chunk and while bodies eagerly (no CUDA
graphs), so its fit histories and states must equal the port's own host
loop bit for bit on every CPU route, and stay within 1e-8 of the
reference's scan and while engines (``backend="jnp"``), the reference's own
cross-engine bound. The while variant must stop after the same iteration as
the host loop; a chunked run overshoots by less than one chunk and ends on
its state's fit, as in ``tests/test_engine.py``.

The other polar solvers, ``svd`` and ``newton_schulz``, are held the same
way. Newton-Schulz is held on choa_like(0.002). The svd polar is not unique
at a singular B_k and changes fast near one, and on choa_like(0.002) the
two packages' LAPACK calls part by 3.1e-8 after a few iterations; so svd is
held to the reference on a synthetic tensor whose B_k are all far from
singular (checked at the start), and to the port's own host loop bit for
bit on choa_like(0.002).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        fit as j_fit, init_state as j_init_state)
from repro.core.procrustes import polar_gram_eigh as j_polar_gram_eigh  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.launch import decompose as j_decompose  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, bucketize, fit  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import _launch, polar  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

ITERS = 12      # check_every 5: chunks of 5, 5 and 2
STATE = ("H", "V", "W", "fit")


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 CC buckets of choa_like(0.002) and the
    reference's state0."""
    bj = j_bucketize(j_choa_like(scale=0.002, seed=0), dtype=jnp.float64)
    s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float64, backend="jnp"), seed=0)
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=torch.float64)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return dict(bj=bj, bt=bt, s0=s0, arrays=arrays)


# a tensor whose every B_k has full column rank with room to spare: at least
# 12 rows and ~150 nonzeros over 60 columns a subject, rank 5
WELL_CONDITIONED = dict(n_subjects=24, n_cols=60, max_rows=30, min_rows=12,
                        avg_nnz_per_subject=150, seed=3)


@pytest.fixture(scope="module")
def well_conditioned():
    """The ``choa`` fixture's dict for ``WELL_CONDITIONED``."""
    bj = j_bucketize(j_random_irregular(**WELL_CONDITIONED), dtype=jnp.float64)
    s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float64, backend="jnp"), seed=0)
    bt = bucketize(random_irregular(**WELL_CONDITIONED), device="cpu", dtype=torch.float64)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return dict(bj=bj, bt=bt, s0=s0, arrays=arrays)


def _fit(choa, *, backend="torch", engine_="host", check_every=10, iters=ITERS, tol=0.0,
         procrustes="gram_eigh"):
    opts = Parafac2Options(rank=5, dtype=torch.float64, backend=backend, engine=engine_,
                           check_every=check_every, procrustes=procrustes)
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    return fit(choa["bt"], opts, max_iters=iters, tol=tol, state=state0)


@pytest.mark.parametrize("check_every", [5, 0])
def test_scan_matches_reference_scan_engine(choa, check_every):
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", engine="scan",
                     check_every=check_every)
    _, want = j_fit(choa["bj"], jopts, max_iters=ITERS, tol=0.0, state=choa["s0"])
    state, got = _fit(choa, engine_="scan", check_every=check_every)
    assert len(got) == len(want) == ITERS
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= 1e-8
    assert got[-1] == float(state.fit)


@pytest.mark.parametrize("check_every", [5, 0])
@pytest.mark.parametrize("method", ["newton_schulz", "svd"])
def test_other_polars_match_reference_scan_engine(request, method, check_every):
    """The port's scan and while engines with the svd and Newton-Schulz
    polars against the reference's, within 1e-8 (svd on the well-conditioned
    tensor, where its polar is unique and well determined)."""
    data = request.getfixturevalue("choa" if method == "newton_schulz" else "well_conditioned")
    if method == "svd":     # every B_k of the start far from singular
        s0 = state_from_arrays(data["arrays"], device="cpu", dtype=torch.float64)
        for b in data["bt"].buckets:
            Wb = s0.W[b.subject_ids.long()] * b.subject_mask[:, None]
            _, B = get_backend("torch").procrustes_b_bucket(b, s0.H, Wb, s0.V)
            sv = torch.linalg.svdvals(B[b.subject_mask > 0])
            assert float((sv[:, -1] / sv[:, 0]).min()) > 1e-3
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", engine="scan",
                     check_every=check_every, procrustes=method)
    _, want = j_fit(data["bj"], jopts, max_iters=ITERS, tol=0.0, state=data["s0"])
    state, got = _fit(data, engine_="scan", check_every=check_every, procrustes=method)
    assert len(got) == len(want) == ITERS
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= 1e-8
    assert got[-1] == float(state.fit)


@pytest.mark.parametrize("check_every", [5, 0])
@pytest.mark.parametrize("method", ["newton_schulz", "svd"])
def test_other_polars_scan_is_bitwise_the_host_loop(choa, method, check_every):
    host_state, host = _fit(choa, procrustes=method)
    state, hist = _fit(choa, engine_="scan", check_every=check_every, procrustes=method)
    assert hist == host
    for f in STATE:
        assert torch.equal(getattr(state, f), getattr(host_state, f)), f


def test_scan_refuses_svd_on_cuda_before_capture():
    """procrustes='svd' cannot be captured on CUDA (torch.linalg.svd reads
    its error flags back to the host): the scan engine raises a ValueError
    that names the method before any warm-up; on the CPU, and for the other
    solvers, nothing is refused."""
    for method in ("svd", "gram_eigh", "newton_schulz"):
        opts = Parafac2Options(rank=5, engine="scan", procrustes=method)
        engine._check_capturable(opts, torch.device("cpu"))
        if method != "svd":
            engine._check_capturable(opts, torch.device("cuda"))
    with pytest.raises(ValueError, match="procrustes='svd'"):
        engine._check_capturable(Parafac2Options(rank=5, procrustes="svd"),
                                 torch.device("cuda", 0))


@pytest.mark.parametrize("check_every", [5, 0])
@pytest.mark.parametrize("backend", ["torch", "fused", "staged"])
def test_scan_is_bitwise_the_host_loop(choa, backend, check_every):
    host_state, host = _fit(choa, backend=backend)
    state, hist = _fit(choa, backend=backend, engine_="scan", check_every=check_every)
    assert hist == host
    for f in STATE:
        assert torch.equal(getattr(state, f), getattr(host_state, f)), f


def _crossing_tol(choa, iters=30):
    """A tol that the host loop's fit changes cross part way, set halfway
    between two of them, so that rounding cannot move the stop."""
    _, hist = _fit(choa, iters=iters)
    d = np.sort(np.abs(np.diff(hist)))
    k = len(d) // 2
    return float((d[k - 1] + d[k]) / 2)


def test_while_variant_stops_like_host(choa):
    tol = _crossing_tol(choa)
    host_state, host = _fit(choa, iters=30, tol=tol)
    state, hist = _fit(choa, engine_="scan", check_every=0, iters=30, tol=tol)
    assert 1 < len(host) < 30, "tol never crossed"
    assert hist == host
    for f in STATE:
        assert torch.equal(getattr(state, f), getattr(host_state, f)), f
    run = engine.make_als_while(choa["bt"], Parafac2Options(rank=5, dtype=torch.float64,
                                                            backend="torch"), 30, tol,
                                state=host_state)
    _, _, n = run(state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64))
    assert int(n) == run.replays == len(host)      # the CPU runs no masked iteration


def test_chunked_scan_overshoots_by_less_than_one_chunk(choa):
    tol = _crossing_tol(choa)
    _, host = _fit(choa, iters=30, tol=tol)
    state, hist = _fit(choa, engine_="scan", check_every=4, iters=30, tol=tol)
    assert len(host) <= len(hist) < len(host) + 4
    assert len(hist) % 4 == 0 or len(hist) == 30
    assert hist[: len(host)] == host
    assert hist[-1] == float(state.fit)


def test_make_als_chunk_donates_its_state(choa):
    """A chunk returns its own tensors: the next call starts from them
    without a copy, and two chunks of 5 equal one fit of 10."""
    opts = Parafac2Options(rank=5, dtype=torch.float64, backend="torch")
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    chunk = engine.make_als_chunk(choa["bt"], opts, 5, state=state0)
    s, f1 = chunk(state0)
    f1 = f1.tolist()
    s2, f2 = chunk(s)
    assert s2.V is s.V and chunk.setup_launches == {}
    _, host = fit(choa["bt"], opts, max_iters=10, tol=0.0, state=state0)
    assert f1 + f2.tolist() == host


def test_chunk_body_and_remainder_match_the_host_loop(choa):
    """``als_chunk_fn``'s body and a chunk's first ``n`` iterations (the
    remainder of a fit) give the host loop's fits bit for bit; a chunk
    runs 1 to ``length`` iterations."""
    opts = Parafac2Options(rank=5, dtype=torch.float64, backend="torch")
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    _, host = fit(choa["bt"], opts, max_iters=3, tol=0.0, state=state0)
    s, fits = engine.als_chunk_fn(opts, 3)(choa["bt"], state0)
    assert fits.tolist() == host and float(s.fit) == host[-1]
    chunk = engine.make_als_chunk(choa["bt"], opts, 5, state=state0)
    s, fits = chunk(state0, 3)
    assert fits.tolist() == host and float(s.fit) == host[-1]
    for n in (0, 6):
        with pytest.raises(ValueError, match="runs 1 to 5"):
            chunk(state0, n)
    with pytest.raises(ValueError, match="at least one"):
        engine.make_als_chunk(choa["bt"], opts, 0, state=state0)


@pytest.mark.parametrize("check_every", [4, 0])
def test_no_iterations_return_the_start(choa, check_every):
    host_state, host = _fit(choa, iters=0)
    state, hist = _fit(choa, engine_="scan", check_every=check_every, iters=0)
    assert hist == host == []
    for f in STATE:
        assert torch.equal(getattr(state, f), getattr(host_state, f)), f


def test_engine_names(choa):
    with pytest.raises(ValueError, match="unknown engine"):
        _fit(choa, engine_="warp")
    assert engine.ENGINES == ("host", "scan", "mesh")


def test_held_launches_move_counts_out_and_back():
    """A capture's counts are taken out of the libraries' and added back
    once per replay."""
    lib = polar.LIB
    polar.reset_launches()
    with _launch.held_launches() as held:
        lib.launches["gram_inv_sqrt"] += 3
    assert held == {("polar", "gram_inv_sqrt"): 3}
    assert polar.LAUNCHES["gram_inv_sqrt"] == 0
    for _ in range(2):
        _launch.add_launches(held)
    assert polar.LAUNCHES["gram_inv_sqrt"] == 6
    assert {lib_.source for lib_ in _launch.LIBRARIES} >= {
        "fused", "staged", "scoo", "gather_matmul", "polar"}
    polar.reset_launches()


@pytest.mark.parametrize("shape", [(7, 9, 5), (3, 12, 8), (4, 40, 17)])
def test_p1_plain_matches_reference_polar(shape):
    """Q = B gram_inv_sqrt_plain(B^T B) against the reference's
    polar_gram_eigh within 1e-12 on well-conditioned B; B = 0 gives Q = 0."""
    B = np.random.default_rng(sum(shape)).standard_normal(shape)
    B[1] = 0.0
    Bt = torch.tensor(B)
    Q = Bt @ polar.gram_inv_sqrt_plain(Bt.transpose(1, 2) @ Bt)
    np.testing.assert_allclose(Q.numpy(), np.asarray(j_polar_gram_eigh(jnp.asarray(B))),
                               rtol=1e-12, atol=1e-12)
    assert float(Q[1].abs().max()) == 0.0
    # the CPU wrapper is the plain version, and an empty batch launches nothing
    G = Bt.transpose(1, 2) @ Bt
    assert torch.equal(polar.gram_inv_sqrt(G), polar.gram_inv_sqrt_plain(G))
    assert polar.gram_inv_sqrt(G[:0]).shape == (0, shape[2], shape[2])
    assert polar.LAUNCHES["gram_inv_sqrt"] == 0


def test_p1_plain_solves_in_f64_and_returns_the_input_dtype():
    B = np.random.default_rng(3).standard_normal((5, 30, 5))
    G = torch.tensor(B).transpose(1, 2) @ torch.tensor(B)
    got = polar.gram_inv_sqrt_plain(G.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, polar.gram_inv_sqrt_plain(G.float().double()).float())
    with pytest.raises(ValueError, match="R, R"):
        polar.gram_inv_sqrt(G[:, :, :4])


def test_decompose_scan_json_matches_reference(tmp_path):
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "6",
             "--tol", "0", "--seed", "0", "--engine", "scan", "--check-every", "4"]
    port = decompose.main(flags + ["--device", "cpu", "--json", str(tmp_path / "p.json")])
    want = j_decompose.main(flags + ["--json", str(tmp_path / "r.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads(json.dumps(port))
    assert not set(want) - set(got)
    for k in ("engine", "check_every", "iters", "tol", "backend", "format"):
        assert got[k] == want[k], k
    assert got["engine"] == "scan" and got["check_every"] == 4
    assert got["resolved_options"] == want["resolved_options"]
    assert len(got["fit_history"]) == 6


# ---------------------------------------------------------------------------
# the chunk kept across fits (engine.CHUNKS)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check_every", [5, 0])
def test_second_scan_fit_reuses_the_kept_chunk(choa, check_every):
    """A second ``fit(engine="scan")`` on the same data and options makes no
    new chunk (no warm-up, no capture on a GPU); both calls' histories and
    states equal the host loop's bit for bit, and the first call's state
    is a copy that the second call does not overwrite."""
    host_state, host = _fit(choa)
    engine.clear_chunk_cache()
    made, reused = engine.CHUNKS.made, engine.CHUNKS.reused
    s1, h1 = _fit(choa, engine_="scan", check_every=check_every)
    kept = {f: getattr(s1, f).clone() for f in STATE}
    s2, h2 = _fit(choa, engine_="scan", check_every=check_every)
    assert (engine.CHUNKS.made, engine.CHUNKS.reused) == (made + 1, reused + 1)
    assert len(engine.CHUNKS) == 1
    assert h1 == h2 == host
    for f in STATE:
        assert torch.equal(getattr(s2, f), getattr(host_state, f)), f
        assert torch.equal(getattr(s1, f), kept[f]), f
        assert getattr(s1, f) is not getattr(s2, f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_changed_options_rank_dtype_or_length_make_a_new_chunk(choa, dtype):
    """Each change of what the capture depends on (the options, the rank,
    the streamed operands' dtype, the chunk length, the while variant's
    iterations) makes a new chunk in place of the data's one entry; going
    back makes one again, and another start does not."""
    bt = choa["bt"] if dtype == torch.float64 else bucketize(
        choa_like(scale=0.002, seed=0), device="cpu", dtype=torch.float32)
    engine.clear_chunk_cache()
    base = dict(rank=5, dtype=dtype, backend="torch", engine="scan", check_every=3)
    changes = [dict(), dict(nnls_sweeps=4), dict(rank=4), dict(check_every=2),
               dict(check_every=0), dict()]
    if dtype == torch.float32:
        changes.insert(1, dict(precision="bf16"))
    for change in changes:
        opts = Parafac2Options(**{**base, **change})
        made = engine.CHUNKS.made
        state, hist = fit(bt, opts, max_iters=3, tol=0.0, seed=0)
        assert engine.CHUNKS.made == made + 1, change
        assert len(engine.CHUNKS) == 1 and len(hist) == 3
    made = engine.CHUNKS.made
    fit(bt, opts, max_iters=3, tol=0.0, seed=1)      # another start: the same chunk
    fit(bt, opts, max_iters=4, tol=0.0, seed=0)      # the chunk serves any length
    assert engine.CHUNKS.made == made
    fit(bt, Parafac2Options(**{**base, "check_every": 0}), max_iters=4, tol=0.0)
    assert engine.CHUNKS.made == made + 1            # the while variant's max_iters
    s64 = engine.p2.init_state(choa["bt"], Parafac2Options(rank=5, dtype=torch.float64), 0)
    s32 = engine.p2.init_state(bt, Parafac2Options(rank=5, dtype=torch.float32), 0)
    assert engine._key("chunk", opts, s64, 3) != engine._key("chunk", opts, s32, 3)


def test_kept_chunk_goes_with_its_data():
    """The entry refers to its data weakly, and its chunk refers to the
    data weakly: dropping the data frees both by reference counting,
    without the garbage collector."""
    import gc
    import weakref
    data = bucketize(random_irregular(n_subjects=6, n_cols=20, max_rows=5,
                                      avg_nnz_per_subject=12, seed=1),
                     device="cpu", dtype=torch.float64)
    opts = Parafac2Options(rank=3, dtype=torch.float64, backend="torch", engine="scan",
                           check_every=2)
    engine.clear_chunk_cache()
    fit(data, opts, max_iters=2, tol=0.0)
    (entry,) = engine.CHUNKS._entries.values()
    run = weakref.ref(entry[2])
    del entry
    gc.disable()
    try:
        del data
        assert run() is None and len(engine.CHUNKS) == 0
    finally:
        gc.enable()


def test_kept_chunk_refuses_once_its_data_is_gone():
    """A chunk taken from the cache and held past its data raises rather
    than replay a graph over freed memory."""
    data = bucketize(random_irregular(n_subjects=6, n_cols=20, max_rows=5,
                                      avg_nnz_per_subject=12, seed=2),
                     device="cpu", dtype=torch.float64)
    opts = Parafac2Options(rank=3, dtype=torch.float64, backend="torch")
    state = engine.p2.init_state(data, opts, 0)
    chunk = engine.cached_chunk(data, opts, 2, state=state)
    assert engine.cached_chunk(data, opts, 2, state=state) is chunk
    del data
    with pytest.raises(RuntimeError, match="gone"):
        chunk(state)
