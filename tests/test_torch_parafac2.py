"""The slice end to end: the port's ALS step, host fit and launcher against the
JAX package's, on choa_like(scale=0.002), rank 5, 20 iterations, f64.

Both packages start from the reference's ``init_state`` (carried over with
``convert.state_from_arrays``: torch cannot reproduce ``jax.random``). The
port's ``torch`` and ``fused`` backends (the fused kernels' plain versions on
the CPU) must reproduce the reference's host fit history (``backend="jnp"``)
within 1e-8, the reference's own cross-engine bound.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them (six workers ran these fits 25x slower): one each
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core import (Parafac2Options as JOptions, als_step as j_als_step,  # noqa: E402
                        bucketize as j_bucketize, fit as j_fit, init_state as j_init_state)
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.launch import decompose as j_decompose  # noqa: E402
from repro_torch.convert import state_from_arrays, state_to_arrays  # noqa: E402
from repro_torch.core import (Parafac2Options, als_step, bucketize, fit,  # noqa: E402
                              init_state, w_global)
from repro_torch.core.backend import dispatch_tally, get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.kernels import fused, gather_matmul, polar, scoo, staged, tridiag  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402

ITERS = 20


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 CC buckets of choa_like(0.002), the reference's
    state0 and its 20-iteration host fit history."""
    bj = j_bucketize(j_choa_like(scale=0.002, seed=0), dtype=jnp.float64)
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp")
    s0 = j_init_state(bj, jopts, seed=0)
    _, hist = j_fit(bj, jopts, max_iters=ITERS, tol=0.0, state=s0)
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=torch.float64)
    arrays = {k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")}
    return dict(bj=bj, bt=bt, jopts=jopts, s0=s0, arrays=arrays, hist=np.asarray(hist))


def _opts(backend, **kw):
    return Parafac2Options(rank=5, dtype=torch.float64, backend=backend, **kw)


@pytest.mark.parametrize("backend", ["torch", "fused", "auto"])
def test_als_step_matches_reference(choa, backend):
    s1_ref = j_als_step(choa["bj"], choa["s0"], choa["jopts"])
    s1 = als_step(choa["bt"],
                  state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64),
                  _opts(backend))
    for k in ("H", "V", "W", "fit"):
        np.testing.assert_allclose(getattr(s1, k).numpy(), np.asarray(getattr(s1_ref, k)),
                                   rtol=1e-10, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_host_fit_history_matches_reference(choa, backend):
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    state, hist = fit(choa["bt"], _opts(backend), max_iters=ITERS, tol=0.0, state=state0)
    assert len(hist) == ITERS and np.all(np.isfinite(hist))
    assert np.max(np.abs(np.asarray(hist) - choa["hist"])) <= 1e-8
    assert w_global(choa["bt"], state.W) is state.W


def test_fit_without_mode1_reuse_matches_reference(choa):
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", mode1_reuse=False)
    _, want = j_fit(choa["bj"], jopts, max_iters=5, tol=0.0, state=choa["s0"])
    _, got = fit(choa["bt"], _opts("torch", mode1_reuse=False), max_iters=5, tol=0.0,
                 state=state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("backend,per_bucket", [("torch", 5.0), ("fused", 4.0)])
def test_stage_tally_per_iteration(choa, backend, per_bucket):
    """The fused route takes the torch route's five streaming stage calls
    per bucket down to four: the projection pass is gone (Q is carried)."""
    state0 = state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64)
    with dispatch_tally() as tally:
        als_step(choa["bt"], state0, _opts(backend))
    assert sum(tally.values()) / len(choa["bt"].buckets) == per_bucket
    assert ("project" in tally) == (backend == "torch")


def test_cpu_run_launches_no_kernel(choa):
    """On the CPU the fused route runs the plain versions: no launch."""
    fused.reset_launches()
    fit(choa["bt"], _opts("auto"), max_iters=2, tol=0.0,
        state=state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64))
    assert sum(fused.LAUNCHES.values()) == 0
    assert get_backend("auto", choa["bt"].device).name == "torch"


def test_auto_backend_resolves_from_device():
    """``auto`` is ``fused`` on CUDA at any rank and ``torch`` on the CPU;
    it needs the device to choose."""
    assert get_backend("auto", "cuda").name == "fused"
    assert get_backend("auto", torch.device("cuda", 1)).name == "fused"
    assert get_backend("auto", "cpu").name == "torch"
    with pytest.raises(ValueError, match="device"):
        get_backend("auto")
    with pytest.raises(ValueError, match="unknown"):
        get_backend("jnp", "cpu")


def test_library_entry_points_default_to_gpu(monkeypatch, choa):
    """``bucketize`` and ``state_from_arrays`` place data on the GPU unless
    asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bucketize(choa_like(scale=0.001, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_arrays(choa["arrays"])
    assert state_from_arrays(choa["arrays"], device="cpu").V.device.type == "cpu"


def test_init_state_seeded_and_injected(choa):
    bt = choa["bt"]
    a, b = init_state(bt, _opts("torch"), seed=3), init_state(bt, _opts("torch"), seed=3)
    assert torch.equal(a.V, b.V) and float(a.V.min()) >= 0.0
    assert torch.equal(a.H, torch.eye(5, dtype=torch.float64))
    assert torch.equal(a.W, torch.ones((bt.n_subjects, 5), dtype=torch.float64))
    assert float(a.fit) == -np.inf
    injected = init_state(bt, _opts("torch"), state=state_from_arrays(
        choa["arrays"], device="cpu", dtype=torch.float32))
    assert injected.V.dtype == torch.float64
    np.testing.assert_array_equal(injected.V.numpy(),
                                  choa["arrays"]["V"].astype(np.float32).astype(np.float64))
    back = state_to_arrays(state_from_arrays(choa["arrays"], device="cpu", dtype=torch.float64))
    for k in ("H", "V", "W"):
        assert back[k].tobytes() == choa["arrays"][k].tobytes()


def test_decompose_cpu_json_matches_reference_keys(tmp_path):
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "3",
             "--tol", "1e-7", "--seed", "0"]
    port = decompose.main(flags + ["--device", "cpu", "--json", str(tmp_path / "p.json")])
    want = j_decompose.main(flags + ["--json", str(tmp_path / "r.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads(json.dumps(port))
    missing = set(want) - set(got)
    assert not missing, missing
    assert set(got["resolved_options"]) == set(want["resolved_options"])
    for k in ("schema_version", "kind", "dataset", "scale", "rank", "tol", "seed",
              "backend", "iters", "n_subjects", "n_cols", "nnz", "format", "engine",
              "constraints", "compress"):
        assert got[k] == want[k], k
    assert got["resolved_options"] == want["resolved_options"]
    assert [{k: v for k, v in r.items() if k != "device_bytes"} for r in got["buckets"]] == \
        [{k: v for k, v in r.items() if k != "device_bytes"} for r in want["buckets"]]
    assert got["kernel_launches"] == dict.fromkeys(
        fused.KERNELS + staged.KERNELS + scoo.KERNELS + gather_matmul.KERNELS
        + polar.KERNELS + tridiag.KERNELS, 0)
    assert got["device"] == "cpu" and got["platform"] == "cpu"
    # the reference's values for the same flags: check_every is the option's
    # default (10), which the host engine does not read
    assert got["precision"] == "f32" and got["check_every"] == want["check_every"] == 10


def test_decompose_json_reports_its_precision(tmp_path):
    """``precision`` is ``--precision``'s, as the reference's summary has it;
    the factor dtype (``--dtype``) has its own key."""
    got = decompose.main(["--scale", "0.001", "--iters", "1", "--dtype", "float64",
                          "--device", "cpu", "--json", str(tmp_path / "p.json")])
    assert got["precision"] == "f32" and got["resolved_options"]["dtype"] == "float64"
    assert got["dtype"] == "float64"


def test_decompose_without_cuda_raises(monkeypatch):
    """decompose runs on a GPU by default and never falls back quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        decompose.main(["--scale", "0.001", "--iters", "1"])
