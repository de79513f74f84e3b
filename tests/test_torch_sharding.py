"""The subject sharding of the port's mesh engine against the reference:
the nnz-balanced shard planner (``BucketPlan.balance_for_shards``,
``shard_nnz``, ``shard_imbalance``) equal to ``repro.sparse.bucketing``'s
on the reference's own cases and on random counts; the rules context and
``psum_subjects`` (``repro_torch.dist.sharding``); checkpoints across
ranks (written under 4 gloo ranks, restored under 2, bit for bit, and the
resumed fit within 1e-8 of the uninterrupted one); and ``decompose
--engine mesh`` under ``torch.distributed.run`` with 2 CPU ranks, whose
``shard_balance`` is the reference's and whose history is within 1e-8 of
``--engine host``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)

import _mesh_workers as workers  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.sparse.bucketing import (fixed_plan as j_fixed_plan,  # noqa: E402
                                    plan_buckets as j_plan_buckets)
from repro_torch.analysis.comm import record_collectives  # noqa: E402
from repro_torch.dist import sharding as dsh  # noqa: E402
from repro_torch.launch import decompose  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.sparse import fixed_plan, plan_buckets  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_plan(a, b) -> None:
    assert a.shapes == b.shapes and a.nnz_pads == b.nnz_pads
    assert len(a.members) == len(b.members)
    for x, y in zip(a.members, b.members):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _both(nnz, n_shards, plans):
    """Each package's balanced plan, per-shard nnz and imbalances."""
    out = []
    for plan in plans:
        bal = plan.balance_for_shards(nnz, n_shards)
        out.append((bal, bal.shard_nnz(nnz, n_shards), bal.shard_imbalance(nnz, n_shards),
                    plan.shard_imbalance(nnz, n_shards)))
    _same_plan(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    return out[0]


# ---------------------------------------------------------------------------
# the shard planner (the reference's cases, tests/test_supervisor.py)
# ---------------------------------------------------------------------------

def test_balance_for_shards_equalizes_nnz_as_reference():
    nnz = np.random.default_rng(0).integers(1, 1000, size=64)
    bal, loads, after, before = _both(nnz, 4, [fixed_plan(64, 8, 128), j_fixed_plan(64, 8, 128)])
    assert sorted(np.concatenate(bal.members).tolist()) == list(range(64))
    assert after <= before and after < 1.05
    assert sum(loads[0]) == int(nnz.sum())


def test_balance_respects_tail_padding_capacities_as_reference():
    nnz = np.arange(1, 11) * 10
    bal, _, after, before = _both(nnz, 4, [fixed_plan(10, 8, 128), j_fixed_plan(10, 8, 128)])
    mem = bal.members[0]
    cs = -(-len(mem) // 4)
    assert [len(mem[s * cs:(s + 1) * cs]) for s in range(4)] == [3, 3, 3, 1]
    assert after <= before


def test_balance_single_shard_is_identity_and_validates():
    plan = fixed_plan(6, i_pad=8, c_pad=128)
    assert plan.balance_for_shards([1] * 6, 1) is plan
    with pytest.raises(ValueError, match="n_shards") as e:
        plan.balance_for_shards([1] * 6, 0)
    with pytest.raises(ValueError) as je:
        j_fixed_plan(6, 8, 128).balance_for_shards([1] * 6, 0)
    assert str(e.value) == str(je.value)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10**6), n_shards=st.integers(1, 8))
def test_balance_property_matches_reference(seed, n_shards):
    """Random subject counts, shapes and skewed nnz over 1-8 shards: the
    quantile plan, the balanced plan, shard_nnz and both imbalances equal
    the reference's (greedy LPT under capacities need not beat the plan's
    own order here), and every shard's chunk holds its share of the nnz."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 120))
    rows, cols = rng.integers(1, 60, size=k), rng.integers(1, 400, size=k)
    nnz = np.maximum(1, (rng.pareto(1.2, size=k) * 50).astype(np.int64))
    kw = dict(max_buckets=int(rng.integers(1, 5)), nnz_counts=nnz,
              sort_by=["area", "nnz"][int(rng.integers(0, 2))])
    plans = [plan_buckets(rows, cols, **kw), j_plan_buckets(rows, cols, **kw)]
    _same_plan(*plans)
    bal, loads, _, _ = _both(nnz, n_shards, plans)
    for mem, per in zip(bal.members, loads):
        cs = -(-len(mem) // n_shards)
        assert sum(per) == int(nnz[mem].sum())
        assert all(len(mem[s * cs:(s + 1) * cs]) <= cs for s in range(n_shards))


# ---------------------------------------------------------------------------
# the rules context and psum_subjects (tests/test_dist_sharding.py)
# ---------------------------------------------------------------------------

def test_context_stack_nests_and_restores():
    mesh, other = object(), object()
    assert dsh.current_rules() is None and dsh.current_mesh() is None
    with dsh.axis_rules(dsh.LM_RULES, mesh):
        assert dsh.current_rules() is dsh.LM_RULES and dsh.current_mesh() is mesh
        with dsh.axis_rules(dsh.SP_RULES, None):
            assert dsh.current_rules() is dsh.SP_RULES and dsh.current_mesh() is None
        with dsh.axis_rules(dsh.SP_RULES, other):
            assert dsh.current_mesh() is other
        assert dsh.current_rules() is dsh.LM_RULES and dsh.current_mesh() is mesh
    assert dsh.current_rules() is None and dsh.current_mesh() is None
    assert dsh.SP_RULES["seq_res"] == "model" and dsh.LM_RULES["seq_res"] is None
    assert dsh.LM_RULES["subjects"] == ("pod", "data", "model")


def test_psum_and_shard_are_identity_outside_collectives():
    x = torch.arange(12.0).reshape(3, 4)
    assert dsh.psum_subjects(x) is x                     # no context at all
    with dsh.axis_rules(dsh.LM_RULES, None):
        assert dsh.psum_subjects(x) is x and dsh.shard(x, ("batch", "embed")) is x
    with dsh.subject_collectives(()):                    # no subject axes
        assert dsh.psum_subjects(x) is x


def test_subject_collectives_sum_over_a_world_of_one():
    """Inside subject_collectives psum_subjects all-reduces over the
    subject dimensions (a world of one: the same values, a new tensor, one
    call counted); the subject axes are the rule's that the mesh has."""
    try:
        mesh = lm.local_mesh("cpu")
        axes = dsh.subject_mesh_axes(mesh)
        assert axes == ("data", "model")
        assert dsh.subject_mesh_axes(mesh, dsh.SP_RULES) == ("data", "model")
        assert dsh.subject_mesh_axes(mesh, {"subjects": None}) == ()
        assert dsh.subject_shard(mesh, axes) == (0, 1)
        x = torch.arange(6.0)
        with record_collectives() as rec, dsh.subject_collectives(axes, mesh):
            y = dsh.psum_subjects(x)
            assert dsh.current_mesh() is None            # shard() off in the body
        assert y is not x and torch.equal(y, x)
        assert (rec.calls["all-reduce"], rec["all-reduce"], rec["total"]) == (1, 24, 24)
        with pytest.raises(ValueError, match="DeviceMesh"):
            with dsh.subject_collectives(axes):
                pass
    finally:
        lm.shutdown()


# ---------------------------------------------------------------------------
# checkpoints across ranks (tests/test_ckpt.py:114, test_sharding_dryrun.py:124)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """A 4-rank world writes the checkpoints and runs the fit through; a
    2-rank world restores them and resumes."""
    tmp = tmp_path_factory.mktemp("elastic")
    wrote = workers.World(4, workers.ckpt_write, tmp, str(tmp)).join()
    read = workers.World(2, workers.ckpt_resume, tmp, str(tmp), 4).join()
    return dict(dir=str(tmp), wrote=wrote, read=read)


def _stored(directory: str, step: int) -> dict:
    """A checkpoint's arrays by flat key, as written."""
    base = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    return {k: np.load(os.path.join(base, v)) for k, v in meta["keys"].items()}


def test_written_under_4_restores_under_2_bit_for_bit(elastic):
    """Rank 0 of 4 wrote the globally unsharded arrays; each of 2 ranks
    restores its half of a Shard(0) leaf and the whole of a Replicate()
    one, bit for bit: the tree, and the fit's bucketed W and its duals."""
    stored = _stored(os.path.join(elastic["dir"], "tree"), 512)
    np.testing.assert_array_equal(stored["W"], np.arange(48.0).reshape(16, 3))
    fit = _stored(os.path.join(elastic["dir"], "fit"), 5)
    for rank, res in enumerate(elastic["read"]):
        assert res["step"] == 512
        assert np.array_equal(res["tree"]["W"].numpy(), stored["W"][rank * 8:(rank + 1) * 8])
        assert np.array_equal(res["tree"]["H"].numpy(), np.eye(3))
        assert any(res["split"].values())
        for key, t in res["restored"].items():
            want = fit[key]
            if res["split"][key]:
                n = want.shape[0] // 2
                want = want[rank * n:(rank + 1) * n]
            assert t.numpy().tobytes() == want.tobytes(), key


def test_resumed_under_2_matches_uninterrupted_under_4(elastic):
    """The bucketed-W ADMM fit written at step 5 under 4 ranks, resumed to
    10 under 2: within 1e-8 of the 4-rank run straight through (the sums
    run over other ranks, in another order)."""
    whole = elastic["wrote"][0]
    for res in elastic["read"]:
        assert res["resumed"] == 5 and len(res["hist"]) == 10
        assert res["hist"][:5] == whole["hist"][:5]
        assert np.max(np.abs(np.asarray(res["hist"]) - whole["hist"])) <= 1e-8
        for k in ("V", "W"):
            scale = max(1.0, float(whole[k].abs().max()))
            assert float((res[k] - whole[k]).abs().max()) <= 1e-8 * scale, k


# ---------------------------------------------------------------------------
# decompose --engine mesh under torch.distributed.run
# ---------------------------------------------------------------------------

def test_decompose_mesh_under_torchrun(tmp_path):
    """Two CPU ranks over gloo, supervised with a blip at chunk 0 and a
    NaN at chunk 1: the summary's shard_balance is the reference's block
    for the same plan (its planner, its keys), its supervisor block counts
    the retry and the rollback, rank 0 alone writes --json, and the fit
    history is within 1e-8 of --engine host's."""
    flags = ["--dataset", "choa", "--scale", "0.002", "--rank", "5", "--iters", "10",
             "--device", "cpu", "--dtype", "float64", "--backend", "torch"]
    out = tmp_path / "mesh.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.decompose", "--engine", "mesh", "--check-every",
         "5", "--fail-at", "0", "--nan-at", "1", "--json", str(out)] + flags,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    host = decompose.main(flags + ["--engine", "host"])       # meanwhile
    stdout, stderr = proc.communicate(timeout=150)
    assert proc.returncode == 0, stderr[-3000:]
    assert stdout.count("[shard-balance]") == 1 and stdout.count("[json] wrote") == 1
    got = json.loads(out.read_text())

    data = decompose.load_dataset("choa", 0.002, 0)
    nnz = data.nnz_counts()
    plan = j_plan_buckets(data.row_counts(), data.col_counts(), max_buckets=4,
                          nnz_counts=nnz)
    bal = plan.balance_for_shards(nnz, 2)
    want = {"n_shards": 2, "shard_nnz": bal.shard_nnz(nnz, 2),
            "imbalance_max_over_mean": bal.shard_imbalance(nnz, 2),
            "imbalance_unbalanced": plan.shard_imbalance(nnz, 2)}
    assert got["shard_balance"] == want
    assert got["engine"] == "mesh" and len(got["shard_device_bytes"]) == 2
    sup = got["supervisor"]
    assert (sup["retries"], sup["rollbacks"], sup["chunks"]) == (1, 1, 2)
    assert sum(got["shard_device_bytes"]) == got["device_bytes"]
    assert len(got["fit_history"]) == len(host["fit_history"]) == 10
    assert np.max(np.abs(np.asarray(got["fit_history"]) - host["fit_history"])) <= 1e-8
