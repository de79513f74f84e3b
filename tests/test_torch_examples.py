"""The port's PARAFAC2 examples (``repro_torch.examples.quickstart`` and
``repro_torch.examples.phenotyping``) against the reference's scripts
(``examples/quickstart.py``, ``examples/phenotyping.py``) on the CPU.

Each example's ``run`` takes the reference script's data, options,
iteration cap and tolerance, here in f64 and from the reference's own
initial state (``init_state`` draws V with ``jax.random``), and is held
against the same calls of the reference (its ``jnp`` backend: the Pallas
one demotes f64): the fit history within 1e-8 at every iteration, the same
number of iterations, V, W (and quickstart's U_k) within 1e-8 of their
largest magnitude, and the same read-out (quickstart's PARAFAC2
invariant; phenotyping's top features, top phenotypes and temporal
signatures). Neither is capped below its script's
60 and 40 iterations (phenotyping stops at its tolerance first). Then
``main(["--device", "cpu"])`` runs each script to its end, asserts
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)

from repro.core import Parafac2Options as JOptions  # noqa: E402
from repro.core import bucketize as j_bucketize  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_state as j_init_state  # noqa: E402
from repro.core import reconstruct_uk as j_reconstruct_uk  # noqa: E402
from repro.core.interpret import (subject_top_phenotypes as j_top,  # noqa: E402
                                  temporal_signature as j_signature,
                                  top_phenotype_features as j_features)
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.sparse import random_parafac2 as j_random_parafac2  # noqa: E402

from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.examples import phenotyping, quickstart  # noqa: E402

F64, TOL = torch.float64, 1e-8
NONNEG = {"v": "nonneg", "w": "nonneg"}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _reference(data, max_buckets, rank, max_iters, tol):
    """The reference script's calls in f64: (buckets, options, state0 as
    arrays, fitted state, history, U_k)."""
    bj = j_bucketize(data, max_buckets=max_buckets, dtype=jnp.float64)
    opts = JOptions(rank=rank, constraints=NONNEG, dtype=jnp.float64, backend="jnp")
    s0 = j_init_state(bj, opts, seed=0)
    state, hist = j_fit(bj, opts, max_iters=max_iters, tol=tol, state=s0)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return opts, arrays, state, [float(h) for h in hist], j_reconstruct_uk(bj, state, opts)


def _port(example, arrays, **kw):
    s0 = state_from_arrays(arrays, device="cpu", dtype=F64)
    return example.run("cpu", state=s0, dtype=F64, **kw)


def _same_fit(out, state, hist):
    assert len(out["history"]) == len(hist)
    np.testing.assert_allclose(out["history"], hist, rtol=0, atol=TOL)
    _close(out["V"], state.V)
    _close(out["W"], state.W)


@pytest.fixture(scope="module")
def quick():
    data, _ = j_random_parafac2(n_subjects=50, n_cols=60, max_rows=40, rank=4, density=0.8,
                                seed=7)
    _, arrays, state, hist, uks = _reference(data, 3, 4, quickstart.MAX_ITERS, quickstart.TOL)
    return _port(quickstart, arrays), state, hist, uks


@pytest.fixture(scope="module")
def pheno():
    data = j_choa_like(scale=0.001, seed=3, with_phenotypes=True, rank=5)
    opts, arrays, state, hist, uks = _reference(data, 4, 5, phenotyping.MAX_ITERS,
                                                phenotyping.TOL)
    return _port(phenotyping, arrays), opts, state, hist, uks


def test_quickstart_fit_matches_reference(quick):
    out, state, hist, uks = quick
    assert len(hist) == quickstart.MAX_ITERS       # the cap, as the reference's
    _same_fit(out, state, hist)
    assert sorted(out["uks"]) == sorted(uks)
    for k in uks:
        _close(out["uks"][k], uks[k])


def test_quickstart_readout_matches_reference(quick):
    out, _, hist, uks = quick
    want = bool(np.allclose(uks[0].T @ uks[0], uks[1].T @ uks[1], atol=1e-2))
    assert out["readout"]["invariant"] == want is True
    assert hist[-1] > 0.5 and out["history"][-1] > 0.5


def test_phenotyping_fit_matches_reference(pheno):
    """The fit stops at the reference's iteration (tol 1e-6, before the cap
    of 40). The U_k are not held whole here: the nonneg W keeps every
    subject's row at entries below 1e-4 of its largest (a subject belongs
    to few phenotypes), so no B_k has full numerical column rank, and the
    polar factor's columns in its null directions are set by the clamped
    eigenvalues of its Gram, not by the data (ROADMAP Queue C; U_k and even
    U_k^T U_k part by ~5e-7 here). The read-out's columns are held in
    ``test_phenotyping_readout_matches_reference``."""
    out, _, state, hist, uks = pheno
    assert len(hist) < phenotyping.MAX_ITERS
    W = np.asarray(state.W)
    assert all(W[k].min() < 1e-4 * W[k].max() for k in uks)
    assert sorted(out["uks"]) == sorted(uks)
    _same_fit(out, state, hist)


def test_phenotyping_readout_matches_reference(pheno):
    """The phenotype definitions (the top six features of each V column),
    subjects 0 and 1's top two phenotypes and their temporal signatures:
    the same names and indices, weights within 1e-8."""
    out, opts, state, _, uks = pheno
    ro = out["readout"]
    want = j_features(np.asarray(state.V), phenotyping.FEATURES, top=6)
    assert [[n for n, _ in f] for f in ro["features"]] == [[n for n, _ in f] for f in want]
    _close([w for f in ro["features"] for _, w in f], [w for f in want for _, w in f])
    W = np.asarray(state.W)
    for k in (0, 1):
        tops = j_top(W, k, top=2)
        got = ro["subjects"][k]
        assert [r for r, _ in got["top"]] == [r for r, _ in tops]
        _close([w for _, w in got["top"]], [w for _, w in tops])
        sig = j_signature(uks[k], [r for r, _ in tops], constraints=opts)
        assert sorted(got["signatures"]) == sorted(sig)
        for r in sig:
            _close(got["signatures"][r], sig[r])


@pytest.mark.parametrize("example", [quickstart, phenotyping])
def test_example_main_runs_on_the_cpu(example, capsys):
    """``python -m repro_torch.examples.<name> --device cpu``: the script to
    its end (quickstart's asserts hold), its lines printed."""
    out = example.main(["--device", "cpu"])
    assert np.isfinite(out["history"]).all()
    text = capsys.readouterr().out
    assert ("PARAFAC2 invariant" in text) if example is quickstart else ("phenotype 0" in text)


@pytest.mark.parametrize("example", [quickstart, phenotyping])
def test_example_default_device_needs_a_gpu(example):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main([])
