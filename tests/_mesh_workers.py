"""The ranks of the mesh tests' gloo worlds (``tests/test_torch_mesh.py``,
``tests/test_torch_sharding.py``, ``tests/test_torch_lm_mesh.py``,
``tests/test_torch_lm_mesh_four.py``). Each world is N spawned processes,
one thread each, joined over a ``FileStore`` under the test's
``tmp_path``, every collective timing out after 60 s and every join after
``JOIN_TIMEOUT``. A rank's function returns what the test compares; the
parent reads it back from a file. Imports the port only: the reference's
oracles run in the test process, or (the LM on a mesh, :func:`lm_mesh_runs`)
in a subprocess with forced host devices (``tests/_lm_mesh_oracle.py``).
"""
import datetime
import os
import pickle
import subprocess
import sys
import uuid
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 150      # seconds a world may take, start-up included
F64 = torch.float64


def _entry(fn: Callable, rank: int, n: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    args = torch.load(f"{out}.in", weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch import mesh as lm

    try:
        torch.save(fn(rank, n, *args), f"{out}.{rank}")
    finally:
        lm.shutdown()


class World:
    """N ranks running ``fn(rank, n, *args)``, started at once; ``join``
    waits for them and returns each rank's result. ``args`` go through a
    file: a start that pipes them blocks until the child has imported
    torch to read them."""

    def __init__(self, n: int, fn: Callable, tmp_path, *args):
        tag = uuid.uuid4().hex
        self.out = os.path.join(str(tmp_path), f"out-{tag}")
        store = os.path.join(str(tmp_path), f"store-{tag}")
        torch.save(args, f"{self.out}.in")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(fn, r, n, store, self.out))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def join(self) -> List:
        for p in self.procs:
            p.join(JOIN_TIMEOUT)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * len(codes), f"rank exit codes {codes}"
        return [torch.load(f"{self.out}.{r}", weights_only=False)
                for r in range(len(self.procs))]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

# a tensor whose every B_k has full column rank with room to spare
# (tests/test_torch_engine.py's), where V and W are well determined
WELL_CONDITIONED = dict(n_subjects=24, n_cols=60, max_rows=30, min_rows=12,
                        avg_nnz_per_subject=150, seed=3)


def _data(name: str = "choa"):
    from repro_torch.data import choa_like
    from repro_torch.sparse import random_irregular

    if name == "well":
        return random_irregular(**WELL_CONDITIONED)
    return choa_like(scale=0.002, seed=0)


def balanced_plan(data, n: int, fmt: str):
    """choa 0.002's plan as decompose plans it for ``n`` shards."""
    from repro_torch.launch.decompose import plan_data

    return plan_data(data, buckets=4, format=fmt, n_shards=n)[0]


def _shard(data, n: int, rank: int, fmt: str, align: int = 0):
    from repro_torch.core import bucketize

    return bucketize(data, device="cpu", dtype=F64, plan=balanced_plan(data, align or n, fmt),
                     format=fmt, subject_align=align or n, shard=(rank, n))


def _bytes(bt) -> dict:
    """The buckets' device bytes: in all, in the column sort of the kept
    entries (``scatter_perm``, one entry a kept column of a real subject)
    and in its [J] column ends (``scatter_ends``)."""
    def nb(t):
        return t.numel() * t.element_size()

    return dict(all=sum(b.nbytes() for b in bt.buckets),
                perm=sum(nb(b.scatter_perm) for b in bt.buckets),
                ends=sum(nb(b.scatter_ends) for b in bt.buckets))


def _replicas(state) -> dict:
    """The state tensors every rank holds whole."""
    out = {"H": state.H, "V": state.V, "fit": state.fit}
    if not isinstance(state.W, tuple):
        out["W"] = state.W
    return out


def fits(rank: int, n: int, configs: dict, omega: np.ndarray) -> dict:
    """Each config's mesh fit on this rank's shard of its dataset (f64,
    rank 5, 10 iterations) from the reference's state0; with the history, the
    gathered state, the replicated leaves, this rank's subjects and bucket
    bytes, and rank 0 the whole data's bytes."""
    from repro_torch.convert import state_from_arrays
    from repro_torch.core import Parafac2Options, bucketize, fit
    from repro_torch.core.parafac2 import w_global
    from repro_torch.kernels import sketch

    datasets = {name: _data(name) for name in ("choa", "well")}
    sketch.gaussian_sketch = lambda *a, **k: torch.from_numpy(omega).to(F64)
    out = {}
    for name, cfg in configs.items():
        data = datasets[cfg["dataset"]]
        bt = _shard(data, n, rank, cfg["format"])
        opts = Parafac2Options(rank=5, dtype=F64, engine="mesh", **cfg["opts"])
        s0 = state_from_arrays(cfg["state0"][n], device="cpu", dtype=F64, shard=(rank, n))
        state, hist = fit(bt, opts, max_iters=10, tol=0.0, state=s0)
        rec = dict(hist=hist, H=state.H, V=state.V, fit=state.fit,
                   W=w_global(bt, state.W), replicas=_replicas(state),
                   subjects=[b.subject_ids[: b.n_real].numpy() for b in bt.buckets],
                   shard=bt.shard, bytes=_bytes(bt))
        if rank == 0:
            rec["whole"] = _bytes(bucketize(data, device="cpu", dtype=F64,
                                            plan=balanced_plan(data, n, cfg["format"]),
                                            format=cfg["format"], subject_align=n))
        out[name] = rec
    if n == 4:          # the CC torch fit again on a (2, 2) mesh installed by the caller
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.dist import sharding as dsh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = configs["cc-torch"]
        with dsh.axis_rules(dsh.LM_RULES, mesh):
            index, count = dsh.subject_shard(mesh, dsh.subject_mesh_axes(mesh))
            bt = _shard(datasets["choa"], count, index, "cc")
            opts = Parafac2Options(rank=5, dtype=F64, engine="mesh", **cfg["opts"])
            s0 = state_from_arrays(cfg["state0"][n], device="cpu", dtype=F64)
            state, hist = fit(bt, opts, max_iters=10, tol=0.0, state=s0)
        out["mesh-2x2"] = dict(hist=hist, replicas=_replicas(state), shard=(index, count))
    return out


def _supervised(bt, opts, s0, **cfg):
    from repro_torch.dist.supervisor import SupervisorConfig, supervised_fit

    state, hist, rep = supervised_fit(bt, opts, max_iters=10, tol=0.0, state=s0,
                                      config=SupervisorConfig(**cfg))
    return dict(hist=hist, replicas=_replicas(state), report=rep.as_dict())


def supervisor(rank: int, n: int, state0: dict) -> dict:
    """The supervised mesh fit (CC torch, f64, check_every 2, 10
    iterations) bare, under the same faults on every rank, under a fault
    on rank 1 alone and under a NaN on rank 0 alone."""
    from repro_torch.convert import state_from_arrays
    from repro_torch.core import Parafac2Options, fit
    from repro_torch.dist.fault import FaultInjector

    bt = _shard(_data(), n, rank, "cc")
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", engine="mesh", check_every=2)
    s0 = state_from_arrays(state0, device="cpu", dtype=F64)
    state, hist = fit(bt, opts, max_iters=10, tol=0.0, state=s0)
    out = {"bare": dict(hist=hist, replicas=_replicas(state))}
    runs = {"everywhere": FaultInjector({1: 1, 2: 4}, nan_steps=[3]),
            "fault_rank1": FaultInjector({1: 2}) if rank == 1 else None,
            "nan_rank0": FaultInjector({}, nan_steps=[2]) if rank == 0 else None}
    for name, injector in runs.items():
        out[name] = _supervised(bt, opts, s0, injector=injector, max_retries=3)
    return out


def ckpt_write(rank: int, n: int, directory: str) -> dict:
    """Under n ranks: a checkpoint of a bucketed W's rows and a replicated
    leaf, and the supervised bucketed-W ADMM fit (check_every 5) to 5
    iterations with checkpoints in ``directory``/fit and uninterrupted to
    10."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    from repro_torch import checkpoint as ckpt
    from repro_torch.core import Parafac2Options
    from repro_torch.core.parafac2 import w_global
    from repro_torch.dist.supervisor import SupervisorConfig, supervised_fit
    from repro_torch.launch.mesh import local_mesh

    mesh = local_mesh("cpu")
    rows = torch.arange(16 * 3, dtype=F64).reshape(16, 3)
    tree = {"W": rows[rank * 16 // n:(rank + 1) * 16 // n], "H": torch.eye(3, dtype=F64)}
    ckpt.save(os.path.join(directory, "tree"), 512, tree,
              shardings={"W": Shard(0), "H": Replicate()}, mesh=mesh)
    bt = _shard(_data(), n, rank, "cc")
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", engine="mesh", check_every=5,
                           w_layout="bucketed",
                           constraints={"v": "nonneg_admm", "w": "nonneg_admm"})
    supervised_fit(bt, opts, max_iters=5, tol=0.0,
                   config=SupervisorConfig(ckpt_dir=os.path.join(directory, "fit")))
    state, hist, _ = supervised_fit(bt, opts, max_iters=10, tol=0.0)
    return dict(hist=hist, W=w_global(bt, state.W), V=state.V)


def ckpt_resume(rank: int, n: int, directory: str, written_under: int) -> dict:
    """Under n ranks, of a checkpoint written under ``written_under``: the
    tree restored (this rank's rows), and the fit resumed to 10
    iterations on the same plan (``subject_align`` ``written_under``)."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.core import Parafac2Options, engine, init_state
    from repro_torch.core.parafac2 import w_global
    from repro_torch.dist.supervisor import SupervisorConfig, supervised_fit
    from repro_torch.launch.mesh import local_mesh

    mesh = local_mesh("cpu")
    like = {"W": torch.zeros(16 // n, 3, dtype=F64), "H": torch.zeros(3, 3, dtype=F64)}
    tree, step, _ = ckpt.restore(os.path.join(directory, "tree"), like,
                                 shardings={"W": Shard(0), "H": Replicate()}, mesh=mesh)
    bt = _shard(_data(), n, rank, "cc", align=written_under)
    opts = Parafac2Options(rank=5, dtype=F64, backend="torch", engine="mesh", check_every=5,
                           w_layout="bucketed",
                           constraints={"v": "nonneg_admm", "w": "nonneg_admm"})
    template = init_state(bt, opts)
    fit_dir = os.path.join(directory, "fit")
    where = engine.state_placements(template)
    restored, _, _ = ckpt.restore(fit_dir, template, step=5, shardings=where, mesh=mesh)
    state, hist, rep = supervised_fit(bt, opts, max_iters=10, tol=0.0, state=template,
                                      config=SupervisorConfig(ckpt_dir=fit_dir, resume=True))
    return dict(tree=tree, step=step, hist=hist, W=w_global(bt, state.W), V=state.V,
                resumed=rep.resumed_from_step, restored=ckpt_mod._flatten(restored),
                split={k: p.is_shard(0) for k, p in ckpt_mod._flatten(where).items()})


# ---------------------------------------------------------------------------
# the LM on a mesh (tests/test_torch_lm_mesh.py)
# ---------------------------------------------------------------------------

def _cfg(arch: str, capacity_factor=None):
    import dataclasses

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(arch))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _grads(fn, tree, *extra):
    """(fn's outputs, gradients of ``fn(tree, *extra)[0]`` on every leaf of
    ``tree`` and on ``extra``, as numpy in tree_leaves order)."""
    from repro_torch.models.common import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(tree) + list(extra)]
    n = len(leaves) - len(extra)
    out = fn(tree_unflatten(tree, leaves[:n]), *leaves[n:])
    grads = torch.autograd.grad(out[0], leaves)
    return [o.detach() for o in out], [g.numpy() for g in grads]


def _moe(mesh, case):
    from repro_torch.dist import sharding as dsh
    from repro_torch.models.common import tree_unflatten
    from repro_torch.models.moe import init_moe, moe_block

    cfg = _cfg(case["arch"], case["capacity_factor"])
    like = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    p = tree_unflatten(like, [torch.from_numpy(a) for a in case["params"]])
    w = torch.from_numpy(case["w"])

    def loss(p, x):
        y, aux = moe_block(p, x, cfg)
        return (y * w).sum() + aux, y, aux

    with dsh.axis_rules(dsh.LM_RULES, mesh):
        (_, y, aux), grads = _grads(loss, p, torch.from_numpy(case["x"]))
    return dict(y=y.numpy(), aux=float(aux), grads=grads)


def _lm(mesh, case):
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import api, build
    from repro_torch.models.common import tree_leaves, tree_unflatten

    cfg = _cfg(case["arch"])
    like = build(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    params = tree_unflatten(like, [torch.from_numpy(a) for a in case["params"]])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with dsh.axis_rules(dsh.LM_RULES, mesh):
        total, ce, aux, grads = api.loss_and_grads(cfg, params, batch)
    return dict(total=float(total), ce=float(ce), aux=float(aux),
                grads=[g.numpy() for g in tree_leaves(grads)])


def _psum(mesh, case, rank):
    from repro_torch.dist import sharding as dsh
    from repro_torch.optim import compressed_psum

    steps = []
    errors = {k: torch.from_numpy(v[rank]) for k, v in case["errors"].items()}
    with dsh.axis_rules(dsh.LM_RULES, mesh):
        for grads in case["grads"]:
            g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
            red, errors = compressed_psum(g, errors, case["axis"])
            steps.append(({k: v.numpy() for k, v in red.items()},
                          {k: v.numpy() for k, v in errors.items()}))
    return steps


def _layout(mesh, case):
    """Each leaf of the reduced arch's parameters laid out with its
    ``param_shardings`` placements: (spec, local shape, whether the local
    block is the one the spec names for this rank)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import param_shardings
    from repro_torch.models import build

    params = build(_cfg(case["arch"])).init_params(torch.Generator().manual_seed(0),
                                                   device="cpu")
    out = {}

    def visit(path, leaf, sh):
        local = distribute_tensor(leaf, mesh, list(sh.placements)).to_local()
        want = leaf
        for dim, entry in enumerate(sh.spec):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            index, count = 0, 1
            for name in names:
                index = index * mesh[name].size() + mesh.get_local_rank(name)
                count *= mesh[name].size()
            size = leaf.shape[dim] // count
            want = want.narrow(dim, index * size, size)
        out[path] = (sh.spec, tuple(local.shape), torch.equal(local, want))

    def walk(tree, shard, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], shard[k], f"{path}/{k}" if path else str(k))
        elif isinstance(tree, (list, tuple)):
            for i, (t, s) in enumerate(zip(tree, shard)):
                walk(t, s, f"{path}/{i}" if path else str(i))
        else:
            visit(path, tree, shard)

    walk(params, param_shardings(params, mesh), "")
    return out


def lm_mesh(rank: int, n: int, cases: dict) -> dict:
    """Each case on its mesh (a ``DeviceMesh`` of this world's ranks):
    ``moe`` (``moe_block`` under ``axis_rules``: output, aux and the
    gradients of sum(y * w) + aux), ``lm`` (``loss_and_grads`` of the whole
    LM), ``psum`` (``compressed_psum`` steps on this rank's shards) and
    ``layout`` (``param_shardings`` through ``distribute_tensor``)."""
    from torch.distributed.device_mesh import init_device_mesh

    meshes, out = {}, {}
    for name, case in cases.items():
        shape, names = case["mesh"]
        if (shape, names) not in meshes:
            meshes[shape, names] = init_device_mesh("cpu", shape, mesh_dim_names=names)
        mesh = meshes[shape, names]
        kind = case["kind"]
        if kind == "psum":
            out[name] = _psum(mesh, case, rank)
        else:
            out[name] = {"moe": _moe, "lm": _lm, "layout": _layout}[kind](mesh, case)
    return out


def draw_leaves(like, seed: int) -> list:
    """numpy leaves for the port tree ``like`` (tree_leaves order): a
    normal draw scaled as ``dense_init`` scales a weight (1/sqrt(fan in)),
    1-D leaves at 0.1, so that router logits are of order one (no
    near-ties in a top-k)."""
    from repro_torch.models.common import tree_leaves

    rng = np.random.default_rng(seed)
    out = []
    for t in tree_leaves(like):
        std = 0.1 if t.ndim < 2 else 1.0 / np.sqrt(t.shape[-2])
        out.append((rng.standard_normal(tuple(t.shape)) * std).astype(np.float32))
    return out


def lm_mesh_runs(tmp_path, cases: dict, **given):
    """Every case of :func:`lm_mesh` in gloo worlds (one a mesh size, side
    by side) and in the reference's oracle subprocess (4 forced host
    devices), all at once: (the port's results by case, a list a rank;
    the reference's ``.npz`` as a dict). ``given`` goes to the oracle
    beside the cases."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    inp, out = os.path.join(str(tmp_path), "oracle_in.pkl"), os.path.join(str(tmp_path),
                                                                          "oracle_out.npz")
    with open(inp, "wb") as f:
        pickle.dump(dict(cases=cases, **given), f)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(repo, "src")}
    oracle = subprocess.Popen([sys.executable, os.path.join(repo, "tests", "_lm_mesh_oracle.py"),
                               inp, out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)

    def size(case):
        return int(np.prod(case["mesh"][0]))

    sizes = sorted({size(c) for c in cases.values()})
    worlds = {n: World(n, lm_mesh, tmp_path, {k: c for k, c in cases.items() if size(c) == n})
              for n in sizes}
    ranks = {n: w.join() for n, w in worlds.items()}
    log = oracle.communicate(timeout=300)[0]
    assert oracle.returncode == 0, log[-4000:]
    port = {name: [r[name] for r in ranks[size(c)]] for name, c in cases.items()}
    return port, dict(np.load(out))


# ---------------------------------------------------------------------------
# the collective byte count (tests/test_torch_comm.py)
# ---------------------------------------------------------------------------

def comm_counts(rank: int, n: int, iters: int) -> dict:
    """What ``record_collectives`` records on this rank: over ``iters``
    mesh-engine iterations of choa 0.002's shard at rank 4 with the
    bucketed W (and the plan's collective bytes of one), over one forward
    and one backward of the manual MoE (phi3.5 reduced on a (1, n) mesh,
    and the plan's all-to-all bytes of one forward), and over
    ``compressed_psum`` of two leaves over "data" on an (n, 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.comm import record_collectives
    from repro_torch.core import Parafac2Options, fit
    from repro_torch.dist import sharding as dsh
    from repro_torch.launch import dryrun
    from repro_torch.models.moe import init_moe, moe_block
    from repro_torch.optim import compressed_psum

    out = {}
    bt = _shard(_data(), n, rank, "cc")
    opts = Parafac2Options(rank=4, dtype=F64, engine="mesh", w_layout="bucketed",
                           backend="torch")
    with record_collectives() as rec:
        fit(bt, opts, max_iters=iters, tol=0.0)
    out["fit"] = (dict(rec), dict(rec.calls))
    out["fit_plan"] = dryrun.parafac2_collective_bytes(opts, bt.n_cols, bt.n_subjects)

    cfg = _cfg("phi3.5-moe-42b-a6.6b")
    mesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    p = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    with dsh.axis_rules(dsh.LM_RULES, mesh):
        with record_collectives() as fwd:
            y, aux = moe_block(p, x, cfg)
        with record_collectives() as bwd:
            ((y * y).sum() + aux).backward()
    out["moe"] = (dict(fwd), dict(bwd))
    out["moe_plan"] = dryrun.moe_all_to_all_bytes(cfg, 2, 8, mesh, 4)

    mesh = init_device_mesh("cpu", (n, 1), mesh_dim_names=("data", "model"))
    g = {"a": torch.randn(3, 5) * (rank + 1), "b": torch.randn(7)}
    errors = {k: torch.zeros_like(v) for k, v in g.items()}
    with dsh.axis_rules(dsh.LM_RULES, mesh), record_collectives() as rec:
        compressed_psum(g, errors, "data")
    out["psum"] = (dict(rec), dict(rec.calls))
    return out
