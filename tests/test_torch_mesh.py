"""The port's mesh engine (``engine="mesh"``: ``repro_torch.core.engine``,
``repro_torch.dist.sharding``, ``bucketize(shard=...)``) in gloo worlds of
2 and 4 ranks on the CPU, against the reference's host engine.

The reference's own mesh engine does not run on jax 0.9 (``shard_map(...,
check_rep=False)``), so its host engine is the oracle. Each rank fits its
nnz-balanced shard of choa_like(0.002) in f64 at rank 5 for 10 iterations
(check_every 5) from the reference's state0, on five routes: CC through
``backend="torch"``, SCOO through ``"scoo"``, a bucketed W with
``nonneg_admm`` on V and W (each rank its rows of the reference's bucketed
W and its duals, through ``convert.state_from_arrays(shard=...)``),
``smooth:0.1`` on a global W, and ``compress="rsvd"`` (the reference's Ω).
The history, H and the fit stay within 1e-8 of the reference's (times
max(1, max |reference|) for the state), and so do V and the gathered W on
a well-conditioned tensor, and W on choa's well-conditioned subjects; every
rank's
replicated tensors are bit for bit the others'; the ranks hold every
subject once, each only its own, in 1/n of the whole data's bucket bytes
but for the column sort of its own kept entries and the [J] column ends
each shard keeps whole. A world of one is
bit for bit the port's scan engine. The supervisor under the mesh engine:
faulted against unfaulted within 1e-8, a fault on one rank alone and a NaN
on one rank alone followed by every rank with the same report.

The worlds run in spawned processes (``tests/_mesh_workers.py``), started
before the reference's fits so that both run at once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each (the ranks set the same)
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _mesh_workers as workers  # noqa: E402
from repro.core import (Parafac2Options as JOptions, bucketize as j_bucketize,  # noqa: E402
                        fit as j_fit, init_state as j_init_state)
from repro.core.parafac2 import w_global as j_w_global  # noqa: E402
from repro.data import choa_like as j_choa_like  # noqa: E402
from repro.kernels import sketch as j_sketch  # noqa: E402
from repro.sparse import plan_buckets as j_plan_buckets  # noqa: E402
from repro.sparse import random_irregular as j_random_irregular  # noqa: E402
from repro_torch.convert import state_from_arrays  # noqa: E402
from repro_torch.core import Parafac2Options, bucketize, engine, fit  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.data import choa_like  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.sparse import random_irregular  # noqa: E402

F64 = torch.float64
ITERS = 10
SHARDS = (2, 4)
ADMM = {"v": "nonneg_admm", "w": "nonneg_admm"}
# name -> (format, the port's options, the reference's options); all on
# choa 0.002 but "well", on the well-conditioned tensor
ROUTES = {
    "cc-torch": ("cc", dict(backend="torch", check_every=5), dict(backend="jnp")),
    "well": ("cc", dict(backend="torch", check_every=5), dict(backend="jnp")),
    "cc-torch-while": ("cc", dict(backend="torch", check_every=0), dict(backend="jnp")),
    "scoo": ("scoo", dict(backend="scoo", check_every=5), dict(backend="scoo")),
    "bucketed-admm": ("cc", dict(backend="torch", check_every=5, w_layout="bucketed",
                                 constraints=ADMM),
                      dict(backend="jnp", w_layout="bucketed", constraints=ADMM)),
    "smooth": ("cc", dict(backend="torch", check_every=5,
                          constraints={"v": "nonneg", "w": "smooth:0.1"}),
               dict(backend="jnp", constraints={"v": "nonneg", "w": "smooth:0.1"})),
    "rsvd": ("cc", dict(backend="torch", check_every=5, compress="rsvd"),
             dict(backend="jnp", compress="rsvd")),
}


def _arrays(state) -> dict:
    """A reference state's leaves as numpy (a bucketed W as a list)."""
    W = state.W
    return {"H": np.asarray(state.H), "V": np.asarray(state.V),
            "W": [np.asarray(w) for w in W] if isinstance(W, tuple) else np.asarray(W),
            "aux": jax.tree_util.tree_map(np.asarray, state.aux)}


def _kappa(want: dict) -> np.ndarray:
    """Each choa subject's condition number of its Procrustes Gram B_k^T B_k
    at the reference's final state, over the spectrum the polar keeps: a W
    row moves by about that times 2^-53 under a rounding of H or V."""
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=F64)
    H, V, W = (torch.tensor(want[k]) for k in ("H", "V", "W"))
    out = np.zeros(bt.n_subjects)
    for b in bt.buckets:
        _, B = get_backend("torch").procrustes_b_bucket(
            b, H, W[b.subject_ids.long()] * b.subject_mask[:, None], V)
        ev = torch.linalg.eigvalsh(B.transpose(1, 2) @ B)
        kept = torch.where(ev > ev[:, -1:] * 1e-12, ev, torch.full_like(ev, float("inf")))
        out[b.subject_ids[: b.n_real].long().numpy()] = (
            ev[:, -1] / kept.min(1).values)[: b.n_real].numpy()
    return out


def _j_bucketize(jd, fmt: str, n: int = 1):
    """The reference's buckets of choa 0.002 on its plan, nnz-balanced for
    ``n`` shards (the plan the port's ranks use)."""
    nnz = jd.nnz_counts()
    plan = j_plan_buckets(jd.row_counts(), jd.col_counts(), nnz_counts=nnz,
                          sort_by="nnz" if fmt == "scoo" else "area")
    if n > 1:
        plan = plan.balance_for_shards(nnz, n)
    return j_bucketize(jd, dtype=jnp.float64, plan=plan, subject_align=n,
                       formats=[fmt] * plan.n_buckets)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2- and 4-rank fits and the 2-rank supervisor runs, with the
    reference's host fits from the same state0 computed meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh")
    datasets = {"choa": j_choa_like(scale=0.002, seed=0),
                "well": j_random_irregular(**workers.WELL_CONDITIONED)}
    jd = datasets["choa"]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x5EED)
    omega = np.asarray(j_sketch.gaussian_sketch(key, jd.n_cols, 18, jnp.float64))
    configs, refs = {}, {}
    bjs = {fmt: _j_bucketize(jd, fmt) for fmt in ("cc", "scoo")}
    bjs["well"] = _j_bucketize(datasets["well"], "cc")
    # a global W's state0 does not depend on the plan or the format: one a
    # constraint bundle
    s0 = j_init_state(bjs["cc"], JOptions(rank=5, dtype=jnp.float64), seed=0)
    for name, (fmt, opts, jopts) in ROUTES.items():
        jo = JOptions(rank=5, dtype=jnp.float64, **jopts)
        if name == "well":
            refs[name] = (bjs[name], jo, j_init_state(bjs[name], jo, seed=0))
            state0 = dict.fromkeys(SHARDS, _arrays(refs[name][2]))
        elif jo.w_layout == "global":
            js0 = s0 if "constraints" not in jopts else j_init_state(bjs[fmt], jo, seed=0)
            refs[name] = (bjs[fmt], jo, js0)
            state0 = dict.fromkeys(SHARDS, _arrays(js0))
        else:       # each world's: the reference's on the plan its ranks use
            refs[name] = (bjs[fmt], jo, j_init_state(bjs[fmt], jo, seed=0))
            state0 = {n: _arrays(j_init_state(_j_bucketize(jd, fmt, n), jo, seed=0))
                      for n in SHARDS}
        configs[name] = dict(format=fmt, opts=opts, state0=state0,
                             dataset="well" if name == "well" else "choa")
    worlds = {n: workers.World(n, workers.fits, tmp, configs, omega) for n in SHARDS}
    sup = workers.World(2, workers.supervisor, tmp, _arrays(s0))

    want = {}       # the reference's rsvd fit draws the Ω above itself
    for name, (bj, jo, s0) in refs.items():
        same = next((k for k in want if refs[k][:2] == (bj, jo)), None)   # one fit each
        if same is not None:
            want[name] = want[same]
            continue
        state, hist = j_fit(bj, jo, max_iters=ITERS, tol=0.0, state=s0)
        want[name] = dict(hist=hist, H=np.asarray(state.H), V=np.asarray(state.V),
                          W=np.asarray(j_w_global(bj, state.W)), fit=np.asarray(state.fit))
    return dict(got={n: w.join() for n, w in worlds.items()}, sup=sup.join(), want=want,
                kappa=_kappa(want["cc-torch"]))


def _close(got, want, tol: float, name: str, scale=None) -> None:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if scale is None else scale
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{name}: max |mesh - reference| {err:.3e} > {tol:.0e} x {scale:.3e}"


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_mesh_fit_matches_reference_host(run, route, n):
    """The history, H and the fit within 1e-8 on every route; V and W
    within 1e-8 on the well-conditioned tensor, and on choa W on the
    subjects whose Procrustes Gram has a condition of at most 1e4. Elsewhere
    on choa a V or W entry is determined only to the condition of the
    subjects' Grams (up to 8.5e11 here) times 2^-53: the port's own host
    engine parts from the reference's by 5.8e-9 in V and 8.0e-7 in W there
    (ROADMAP Queue C, conditions)."""
    want = run["want"][route]
    rows = slice(None) if route == "well" else run["kappa"] <= 1e4
    for rank, res in enumerate(run["got"][n]):
        got = res[route]
        assert got["shard"] == (rank, n)
        assert len(got["hist"]) == ITERS
        _close(got["hist"], want["hist"], 1e-8, f"{route} history", scale=1.0)
        for k in ("H", "fit") + (("V",) if route == "well" else ()):
            _close(got[k].numpy(), want[k], 1e-8, f"{route} {k}")
        _close(got["W"].numpy()[rows], want["W"][rows], 1e-8, f"{route} W",
               scale=max(1.0, float(np.abs(want["W"]).max())))


def test_two_dimensional_mesh_sums_over_both_dimensions(run):
    """The CC torch fit on 4 ranks as a (2, 2) ("data", "model") mesh
    installed with axis_rules: the subjects split over both dimensions
    (rank r is shard r, row-major), the sums over the flattened group;
    within 1e-8 of the reference, the replicas the same bits on every
    rank."""
    want = run["want"]["cc-torch"]
    ranks = [res["mesh-2x2"] for res in run["got"][4]]
    for rank, res in enumerate(ranks):
        assert res["shard"] == (rank, 4)
        _close(res["hist"], want["hist"], 1e-8, "2x2 history", scale=1.0)
        assert res["hist"] == ranks[0]["hist"]
        for k, t in ranks[0]["replicas"].items():
            assert torch.equal(res["replicas"][k], t), k


@pytest.mark.parametrize("n", SHARDS)
def test_replicas_bit_for_bit_across_ranks(run, n):
    """H, V, a global W and the fit: every rank the same bits, every
    route (the all-reduce gives every rank the same sum)."""
    ranks = run["got"][n]
    for route in ROUTES:
        first = ranks[0][route]
        for res in ranks[1:]:
            assert res[route]["hist"] == first["hist"], route
            for k, t in first["replicas"].items():
                assert torch.equal(res[route]["replicas"][k], t), (route, k)


@pytest.mark.parametrize("n", SHARDS)
def test_each_rank_holds_only_its_subjects(run, n):
    """The ranks' real subjects are every subject once, each rank's its own
    plan chunk; a rank's bucket bytes are 1/n of the whole data's but for
    the column sort of its own kept entries and the [J] column ends each
    shard keeps whole."""
    datasets = {"choa": choa_like(scale=0.002, seed=0),
                "well": random_irregular(**workers.WELL_CONDITIONED)}
    for route, (fmt, _, _) in ROUTES.items():
        data = datasets["well" if route == "well" else "choa"]
        plan = workers.balanced_plan(data, n, fmt)
        ranks = [res[route] for res in run["got"][n]]
        for bi, members in enumerate(plan.members):
            cs = -(-len(members) // n)
            for rank, res in enumerate(ranks):
                assert np.array_equal(res["subjects"][bi], members[rank * cs:(rank + 1) * cs])
        seen = np.concatenate([s for res in ranks for s in res["subjects"]])
        assert np.array_equal(np.sort(seen), np.arange(data.n_subjects)), route
        # every Kb-leading array: exactly 1/n of the whole's (Kb padded to a
        # multiple of n); the column sort: each rank its kept entries; the
        # [J] column ends: whole on every rank. So a rank holds at most 1/n
        # of the whole, plus the ends, plus its kept entries' excess.
        whole = ranks[0]["whole"]
        fixed = whole["all"] - whole["perm"] - whole["ends"]
        for res in ranks:
            b = res["bytes"]
            assert (b["all"] - b["perm"] - b["ends"]) * n == fixed, route
            assert b["ends"] == whole["ends"], route
        assert sum(res["bytes"]["perm"] for res in ranks) == whole["perm"], route


@pytest.mark.parametrize("check_every", [5, 0])
def test_world_of_one_is_bit_for_bit_scan(check_every):
    """In a world of one the mesh engine's sums are all-reduced over one
    rank: history and every state tensor bit for bit the scan engine's."""
    bt = bucketize(choa_like(scale=0.002, seed=0), device="cpu", dtype=F64)
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", engine="scan",
                           check_every=check_every, w_layout="bucketed", constraints=ADMM)
    try:
        s_scan, h_scan = fit(bt, opts, max_iters=ITERS, tol=0.0)
        s_mesh, h_mesh = fit(bt, dataclasses.replace(opts, engine="mesh"), max_iters=ITERS,
                             tol=0.0)
        assert h_mesh == h_scan
        for (k, a), (_, b) in zip(engine._flatten(s_mesh), engine._flatten(s_scan)):
            assert torch.equal(a, b), k
    finally:
        lm.shutdown()


def test_check_divisible_raises_reference_message():
    """Whole data whose bucket Kb does not divide into the shards raises
    the reference's message, from the engine's check and from the cut."""
    data = choa_like(scale=0.002, seed=0)
    bt = bucketize(data, device="cpu", dtype=F64)
    kb = bt.buckets[0].kb
    n = next(n for n in range(2, 9) if kb % n)
    state = state_from_arrays(
        {"H": np.eye(5), "V": np.ones((data.n_cols, 5)), "W": np.ones((data.n_subjects, 5))},
        device="cpu", dtype=F64)
    msg = (f"engine='mesh' needs every bucket's subject count to divide the {n} subject "
           f"shards, but bucket 0 has Kb={kb}; re-bucketize with "
           f"bucketize(subject_align={n})")
    with pytest.raises(ValueError) as e:
        engine._check_divisible(bt, state, n)
    assert str(e.value) == msg
    with pytest.raises(ValueError) as e:
        bucketize(data, device="cpu", dtype=F64, shard=(0, n))
    assert str(e.value) == msg


def test_supervisor_faulted_matches_unfaulted(run):
    """The same faults on every rank (a blip, an exhausted retry, a NaN):
    the reference's bound, faulted against unfaulted within 1e-8."""
    for res in run["sup"]:
        bare, got = res["bare"], res["everywhere"]
        rep = got["report"]
        assert rep["retries"] >= 1 and rep["restores"] == 1 and rep["rollbacks"] == 1
        _close(got["hist"], bare["hist"], 1e-8, "faulted history", scale=1.0)
        for k, t in bare["replicas"].items():
            _close(got["replicas"][k].numpy(), t.numpy(), 1e-8, f"faulted {k}")


@pytest.mark.parametrize("case,field", [("fault_rank1", "retries"),
                                        ("nan_rank0", "rollbacks")])
def test_one_rank_fault_moves_every_rank(run, case, field):
    """A fault raised on rank 1 alone makes both ranks retry the chunk, and
    a NaN on rank 0 alone rolls both back: equal reports, the same bits,
    and the bare fit's history."""
    a, b = (res[case] for res in run["sup"])
    assert a["report"] == b["report"] and a["report"][field] >= 1
    assert a["hist"] == b["hist"]
    for k, t in a["replicas"].items():
        assert torch.equal(b["replicas"][k], t), k
    _close(a["hist"], run["sup"][0]["bare"]["hist"], 1e-8, case, scale=1.0)
