"""The port's robustness layer (``repro_torch.dist.fault``,
``repro_torch.checkpoint`` and ``repro_torch.dist.supervisor``) against the
JAX package, on the CPU in f64.

``fault.py`` behaves as the reference's: the same jittered backoff schedule
for a seed, per-step fault counts, poison and the watchdog's window.
Checkpoints: a round trip of a ``Parafac2State`` with ADMM duals, pruning,
damaged and staging directories skipped, the dtype cast, bf16, a missing
leaf; a checkpoint written by the reference restores in the port and one
written by the port restores in the reference, for a state with ADMM duals
and with the bucketed W. The supervised scan fit on the port's CPU scan
engine (choa_like(0.002), rank 5, f64, check_every 5, 20 iterations) is bit
for bit the bare port scan fit faultless, under a blip, under exhausted
retries (from disk and from memory), under a NaN rollback and under
resume, and within 1e-8 of the reference's supervised fit from the same
state0, the ridge-escalated trajectory (``nan_steps={1: 2}``) included.
Last, ``decompose --engine scan --ckpt-dir --fail-at --nan-at --device cpu``
with the reference's ``supervisor`` block, and the host-engine refusal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        fit as j_fit, init_state as j_init_state)
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.dist import fault as j_fault  # noqa: E402
from repro.dist.supervisor import (SupervisorConfig as JConfig,  # noqa: E402
                                   supervised_fit as j_supervised_fit)
from repro.launch import decompose as j_decompose  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.convert import state_from_arrays, state_to_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, bucketize, fit, init_state  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.dist import fault  # noqa: E402
from repro_torch.dist.supervisor import SupervisorConfig, supervised_fit  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402

F64 = torch.float64
ITERS = 20

# ---------------------------------------------------------------------------
# fault.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,jitter", [(7, 0.1), (3, 0.5), (0, 0.0)])
def test_backoff_schedule_matches_reference(seed, jitter):
    def schedule(mod):
        calls, sleeps = {"n": 0}, []

        def flaky(tag, *, bump=1):
            calls["n"] += bump
            if calls["n"] < 4:
                raise mod.TransientFault(tag)
            return tag

        out = mod.run_with_retries(flaky, "ok", bump=1, max_retries=3, backoff=0.5,
                                   backoff_factor=2.0, jitter=jitter, seed=seed,
                                   sleep=sleeps.append)
        return out, sleeps

    assert schedule(fault) == schedule(j_fault)
    with pytest.raises(fault.TransientFault):
        fault.run_with_retries(lambda: (_ for _ in ()).throw(fault.TransientFault("x")),
                               max_retries=1)


def test_injector_and_watchdog_match_reference():
    def trace(mod):
        inj = mod.FaultInjector({1: 2, 3: 1}, nan_steps={2: 2})
        out = []
        for step in (1, 1, 1, 3, 3, 2, 2, 2, 1, 5):
            try:
                inj.check(step)
                out.append(("ok", step))
            except mod.TransientFault as e:
                out.append(("fault", str(e)))
            out.append(("poison", inj.poison(step)))
        wd = mod.StepWatchdog(factor=3.0, min_history=3, window=50)
        flags = [wd.observe(i, 10.0 if i in (700, 1100) else 1.0) for i in range(1200)]
        return out, flags, wd.flagged, len(wd._times)

    assert trace(fault) == trace(j_fault)
    assert trace(fault)[2] == [700, 1100] and trace(fault)[3] <= 50


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def choa():
    """Both packages' f64 CC buckets of choa_like(0.002) and the reference's
    state0 as arrays."""
    bj = j_bucketize(j_choa_like(scale=0.002, seed=0), dtype=jnp.float64)
    s0 = j_init_state(bj, JOptions(rank=5, dtype=jnp.float64, backend="jnp"), seed=0)
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=F64)
    return dict(bj=bj, bt=bt, s0=s0,
                arrays={k: np.asarray(getattr(s0, k)) for k in ("H", "V", "W")})


ADMM = {"v": "nonneg_admm", "w": "nonneg+l1:0.01"}


def _leaves(state):
    a = state_to_arrays(state)
    out = {"H": a["H"], "V": a["V"], "fit": a["fit"]}
    out.update({f"W{i}": w for i, w in enumerate(a["W"] if isinstance(a["W"], list)
                                                 else [a["W"]])})

    def walk(x, name):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{name}.{i}")
        else:
            out[name] = x

    walk(a["aux"], "aux")
    return out


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


def test_state_roundtrip_prune_and_damage(choa, tmp_path):
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", constraints=ADMM)
    state, _ = fit(choa["bt"], opts, max_iters=3, tol=0.0)
    assert len(_leaves(state)) == 8                       # H, V, W, fit and two pairs
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, state, extra={"fit": float(state.fit)}, keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [2, 3, 4]
    (tmp_path / "step_000000009").mkdir()                 # a save that died: no meta.json
    (tmp_path / "step_000000010.tmp-abc").mkdir()         # a staging directory
    assert ckpt.latest_step(str(tmp_path)) == 4
    back, step, extra = ckpt.restore(str(tmp_path), init_state(choa["bt"], opts))
    assert step == 4 and extra["fit"] == float(state.fit)
    _assert_equal(back, state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def test_dtype_cast_bf16_and_missing_leaf(tmp_path):
    t = {"a": torch.arange(6, dtype=F64).reshape(2, 3),
         "b": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
         "c": np.arange(4, dtype=np.int32)}
    ckpt.save(str(tmp_path), 1, t)
    back, _, _ = ckpt.restore(str(tmp_path), {"a": torch.zeros(2, 3), "b": torch.zeros(
        3, dtype=torch.bfloat16), "c": np.zeros(4, np.int64)})
    assert back["a"].dtype == torch.float32 and torch.equal(back["a"], t["a"].float())
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], t["b"])
    assert back["c"].dtype == np.int64 and np.array_equal(back["c"], t["c"])
    jback, _, _ = j_ckpt.restore(str(tmp_path), {"a": jnp.zeros((2, 3)), "b": jnp.zeros(
        3, jnp.bfloat16), "c": jnp.zeros(4, jnp.int32)})
    assert np.array_equal(np.asarray(jback["b"], dtype=np.float32), [1.5, -2.25, 3.0])
    with pytest.raises(KeyError, match="d"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3), "d": torch.zeros(3)})


@pytest.mark.parametrize("w_layout", ["global", "bucketed"])
def test_checkpoints_cross_between_packages(choa, tmp_path, w_layout):
    """Written by the reference, restored by the port, and back."""
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", constraints=ADMM,
                     w_layout=w_layout)
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", constraints=ADMM,
                           w_layout=w_layout)
    js, _ = j_fit(choa["bj"], jopts, max_iters=2, tol=0.0)
    j_ckpt.save(str(tmp_path / "j"), 2, js, extra={"history": [1.0]})
    back, step, extra = ckpt.restore(str(tmp_path / "j"), init_state(choa["bt"], opts))
    assert step == 2 and extra == {"history": [1.0]}
    want = jax.tree_util.tree_leaves(js)
    got = _leaves(back)
    assert len(got) == len(want) and len(want) >= 6
    jflat = {k: np.asarray(v) for k, v in j_ckpt.ckpt._flatten(js).items()}
    tflat = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in ckpt.ckpt._flatten(back).items()}
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert np.array_equal(jflat[k], tflat[k]), k
    # the port's state back into the reference
    ckpt.save(str(tmp_path / "t"), 3, back)
    jback, step, _ = j_ckpt.restore(str(tmp_path / "t"),
                                    j_init_state(choa["bj"], jopts, seed=0))
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(jback), want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the supervised scan fit
# ---------------------------------------------------------------------------


def _opts(**kw):
    kw = {"engine": "scan", "check_every": 5, **kw}
    return Parafac2Options(rank=5, dtype=F64, backend="torch", **kw)


def _state0(choa):
    return state_from_arrays(choa["arrays"], device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def bare(choa):
    """The port's bare scan fit every supervised path must equal bit for bit."""
    return fit(choa["bt"], _opts(), max_iters=ITERS, tol=0.0, state=_state0(choa))


def _supervised(choa, max_iters=ITERS, **cfg):
    return supervised_fit(choa["bt"], _opts(), max_iters=max_iters, tol=0.0,
                          state=_state0(choa), config=SupervisorConfig(**cfg))


# (config, expected counts (retries, restores, rollbacks)); "disk" gets a
# checkpoint directory
FAULTS = {
    "faultless": (dict(), (0, 0, 0)),
    "blip": (dict(injector=fault.FaultInjector({1: 1})), (1, 0, 0)),
    "restore-disk": (dict(injector=fault.FaultInjector({2: 3}), max_retries=2,
                          ckpt_dir="disk"), (2, 1, 0)),
    "restore-memory": (dict(injector=fault.FaultInjector({1: 3}), max_retries=2), (2, 1, 0)),
    "nan": (dict(injector=fault.FaultInjector(nan_steps=[1])), (0, 0, 1)),
    "mixed": (dict(injector=fault.FaultInjector({1: 1, 2: 4}, nan_steps=[3]),
                   ckpt_dir="disk"), (4, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_supervised_fit_bit_for_bit_the_bare_fit(choa, bare, case, tmp_path):
    cfg, counts = FAULTS[case]
    cfg = dict(cfg, ckpt_dir=str(tmp_path) if cfg.get("ckpt_dir") else None)
    state, hist, rep = _supervised(choa, **cfg)
    assert hist == bare[1]
    _assert_equal(state, bare[0])
    assert (rep.retries, rep.restores, rep.rollbacks) == counts
    assert rep.chunks == ITERS // 5 and rep.ridge_final == 0.0
    if cfg["ckpt_dir"]:
        assert rep.checkpoints_written >= ITERS // 5


def test_resume_bit_for_bit(choa, bare, tmp_path):
    _supervised(choa, max_iters=10, ckpt_dir=str(tmp_path))
    state, hist, rep = _supervised(choa, ckpt_dir=str(tmp_path), resume=True)
    assert rep.resumed_from_step == 10 and hist == bare[1]
    _assert_equal(state, bare[0])


def test_shared_chunk_cache_and_watchdog_rule(choa, bare):
    cache = {}
    for _ in range(2):
        state, hist, _ = _supervised(choa, chunk_cache=cache)
        assert hist == bare[1]
    assert set(cache) == {5} and len({id(c) for c in cache.values()}) == 1
    # chunk 0 runs a length's first call (never observed); chunks 1-2 are
    # under min_history, so even slow ones never flag
    ticks = iter(t for dt in (999.0, 500.0, 1.0, 1.0) for t in (0.0, dt))
    _, _, rep = _supervised(choa, clock=lambda: next(ticks))
    assert rep.stragglers == []


def test_supervised_refusals(choa):
    bt = choa["bt"]
    with pytest.raises(ValueError, match="scan"):
        supervised_fit(bt, _opts(engine="host"), max_iters=4)
    with pytest.raises(ValueError, match="chunk"):
        supervised_fit(bt, _opts(check_every=0), max_iters=4)
    with pytest.raises(ValueError, match="core ALS"):
        supervised_fit(bt, _opts(compress="rsvd"), max_iters=4)
    with pytest.raises(ValueError, match="ckpt_dir"):
        supervised_fit(bt, _opts(), max_iters=4, config=SupervisorConfig(resume=True))
    with pytest.raises(ValueError, match="chunk"):     # the mesh engine's too
        supervised_fit(bt, _opts(engine="mesh", check_every=0), max_iters=4)


@pytest.mark.parametrize("nan_steps", [[1], {1: 2}])
def test_supervised_fit_matches_reference(choa, nan_steps):
    """The faulted fit within 1e-8 of the reference's from the same state0;
    ``{1: 2}`` poisons the first clean replay too, so both escalate to the
    ridged trajectory."""
    jopts = JOptions(rank=5, dtype=jnp.float64, backend="jnp", engine="scan",
                     check_every=5)
    _, want, jrep = j_supervised_fit(
        choa["bj"], jopts, max_iters=ITERS, tol=0.0, state=choa["s0"],
        config=JConfig(injector=j_fault.FaultInjector({2: 1}, nan_steps=nan_steps)))
    _, got, rep = _supervised(choa, injector=fault.FaultInjector({2: 1}, nan_steps=nan_steps))
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= 1e-8
    for k in ("retries", "restores", "rollbacks", "escalations", "ridge_final", "chunks"):
        assert getattr(rep, k) == getattr(jrep, k), k
    assert (rep.escalations > 0) == isinstance(nan_steps, dict)


# ---------------------------------------------------------------------------
# decompose's supervisor flags
# ---------------------------------------------------------------------------

SCAN = ["--dataset", "choa", "--scale", "0.001", "--rank", "5", "--iters", str(ITERS),
        "--engine", "scan", "--check-every", "5", "--tol", "0"]
FAULTED = ["--fail-at", "1,2:4", "--nan-at", "3", "--max-retries", "3"]


def test_decompose_supervisor_block_matches_reference(tmp_path):
    clean = decompose.main(SCAN + ["--device", "cpu"])
    got = decompose.main(SCAN + FAULTED + ["--device", "cpu", "--ckpt-dir",
                                           str(tmp_path / "t"), "--json",
                                           str(tmp_path / "t.json")])
    want = j_decompose.main(SCAN + FAULTED + ["--backend", "jnp", "--ckpt-dir",
                                              str(tmp_path / "j")])
    assert got["fit_history"] == clean["fit_history"] and clean["supervisor"] is None
    sup = json.loads((tmp_path / "t.json").read_text())["supervisor"]
    assert sup.keys() == want["supervisor"].keys()
    for k in sup:
        if k != "stragglers":               # wall-clock driven
            assert sup[k] == want["supervisor"][k], k
    assert (sup["retries"], sup["restores"], sup["rollbacks"]) == (4, 1, 1)
    resumed = decompose.main(SCAN + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t"),
                                     "--resume"])
    assert resumed["supervisor"]["resumed_from_step"] == ITERS
    assert resumed["fit_history"] == clean["fit_history"]


def test_decompose_refusals():
    with pytest.raises(SystemExit, match="engine scan"):
        decompose.main(["--engine", "host", "--fail-at", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ckpt-dir"):
        decompose.main(["--engine", "scan", "--resume", "--device", "cpu"])
    assert decompose.parse_fail_spec("1,3:5") == j_decompose.parse_fail_spec("1,3:5")
    with pytest.raises(ValueError, match="fault spec"):
        decompose.parse_fail_spec("x:y")
