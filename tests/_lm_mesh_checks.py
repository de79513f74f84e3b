"""The cases and checks of the LM-on-a-mesh tests, shared by
``tests/test_torch_lm_mesh.py`` (worlds of 2 ranks: meshes (1, 2) and
(1, 1, 2)) and ``tests/test_torch_lm_mesh_four.py`` (4 ranks: (2, 2) and
(2, 1, 2)): one world a file, so that each file stays within a minute on
one core (a rank's start-up alone is ~4 s there).

What is held, in the port against the reference's own mesh runs:
``compressed_psum`` (``repro_torch.optim.compress``), ``param_shardings``
(``repro_torch.dist.sharding``), the manual expert-parallel MoE
(``repro_torch.models.moe._moe_block_manual``, which ``moe_block`` routes
to under a mesh) on the reduced phi3.5-moe (top-2) and llama4 (top-1, a
shared expert), and the whole reduced phi3.5-moe LM's loss and gradients
(``models.api.loss_and_grads``) under ``axis_rules(LM_RULES, mesh)``.

The port runs in gloo worlds (``tests/_mesh_workers.py``, one thread a
rank). The reference runs once a file, in a subprocess
(``tests/_lm_mesh_oracle.py``) with 4 forced host devices and meshes of the
same shapes made with ``axis_types`` Auto on every dimension
(``jax.make_mesh``'s default, Explicit, refuses the reference's
``with_sharding_constraint``), its gradients jitted and ``compressed_psum``
eager under ``jax.vmap`` with an axis name; it writes its arrays to an
``.npz`` under ``tmp_path``. Every input is drawn with numpy from a seed
and handed to both; the world and the reference run side by side. The
MoE's loss is sum(y * w) + aux for a random w.

Bounds: ``compressed_psum`` bit for bit at 2 ranks and within an ulp of the
scale sum at 4 (the f32 sum of the scales may run in another order), its
error feedback bit for bit; ``param_shardings``' specs equal; the MoE's
output within 1e-5 of its largest magnitude, aux within 1e-5 relative,
every gradient leaf (the parameters' and x's) within 1e-5 of its largest
|g|, at the config's capacity factor (per-rank drops) and at a no-drop one,
the top-1 router leaf at ``TOP1_ROUTER_TOL``; the LM's losses within 1e-6
relative and its gradients within 1e-5 of each leaf's largest |g|; every
rank holding the same bits.
"""
import json

import numpy as np
import torch

import _mesh_workers as workers

PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
M11 = ((1, 1), ("data", "model"))
M12 = ((1, 2), ("data", "model"))
M112 = ((1, 1, 2), ("pod", "data", "model"))
M22 = ((2, 2), ("data", "model"))
M212 = ((2, 1, 2), ("pod", "data", "model"))
NO_DROP = 12.0      # 3 x the reduced configs' 4 experts: no rank drops a token
S, TOL = 8, 1e-5    # the MoE cases' sequence length; the f32 bound
LAYOUT_ARCHS = {"qwen3": "qwen3-0.6b", "phi": PHI}
# Under top-1 routing a token's gate is its router probability divided by
# itself, so the router's gradient through the gates is zero in exact
# arithmetic and what both packages compute there is rounding: the port's
# auto path (ported and tested before the mesh) parts from the reference's
# by 2.5e-5 to 1.3e-4 of the router leaf's largest |g| on four draws at
# these shapes. The aux loss's gradient, which is all the leaf holds in
# exact arithmetic, is pinned at this bound (a wrong mean over the ranks
# moves it by a factor).
TOP1_ROUTER_TOL = 1e-3


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def moe_case(arch: str, mesh, B: int, capacity_factor, seed: int, S: int = S) -> dict:
    """``moe_block`` on B x S tokens; ``capacity_factor`` None is the
    config's (1.25)."""
    from repro_torch.models.moe import init_moe

    cfg = workers._cfg(arch, capacity_factor)
    rng = np.random.default_rng(100 + seed)
    like = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "meta")
    return dict(kind="moe", arch=arch, mesh=mesh, capacity_factor=capacity_factor,
                params=workers.draw_leaves(like, seed),
                x=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                w=rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def lm_case(mesh) -> dict:
    """The reduced phi3.5-moe LM on B 2 x S 16 tokens (labels the next
    token, the last ignored)."""
    from repro_torch.models import build

    cfg = workers._cfg(PHI)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    like = build(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    return dict(kind="lm", arch=PHI, mesh=mesh, batch=dict(tokens=tokens, labels=labels),
                params=workers.draw_leaves(like, 7))


def psum_case(mesh, axis, scales) -> dict:
    """Two ``compressed_psum`` steps over ``axis`` of ``mesh``: each rank's
    gradients at its own scale, and its starting errors."""
    n = len(scales)
    rng = np.random.default_rng(n)
    shapes = {"a": (5, 7), "b": (64,), "c": (3, 4, 5)}
    sc = np.asarray(scales, np.float32)

    def draw(scale):
        return {k: (rng.standard_normal((n, *s)) * scale.reshape(-1, *[1] * len(s)))
                .astype(np.float32) for k, s in shapes.items()}

    return dict(kind="psum", mesh=mesh, axis=axis, grads=[draw(sc), draw(sc)],
                errors=draw(np.full(n, 0.01, np.float32)))


def runs(tmp_path, cases: dict, layouts: dict):
    """(cases, the port's results by case and rank, the reference's arrays);
    ``layouts``: the meshes whose ``param_shardings`` specs the reference
    gives, by name."""
    return (cases, *workers.lm_mesh_runs(tmp_path, cases, layouts=layouts,
                                         layout_archs=LAYOUT_ARCHS))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def bits(a):
    return np.asarray(a).view(np.uint32)


class FakeMesh:
    """What ``param_shardings`` and the MoE's routing read of a mesh:
    dimension names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from port_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _leaf_names(case) -> list:
    """The MoE tree's "/"-joined leaf paths in tree_leaves order (dict keys
    sorted)."""
    from repro_torch.models.moe import init_moe

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in walk(tree[k], f"{prefix}{k}/")]
        return [prefix[:-1]]

    cfg = workers._cfg(case["arch"], case["capacity_factor"])
    return walk(init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "meta"), "")


def _params(arch):
    from repro_torch.models import build

    return build(workers._cfg(arch)).init_params(torch.Generator().manual_seed(0), device="cpu")


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_moe(runs, name: str) -> None:
    """``moe_block`` under the mesh against the reference's, which took its
    manual path: output, aux and every gradient leaf."""
    cases, port, ref = runs
    assert bool(ref[f"{name}/manual"])
    got = port[name][0]
    assert rel(got["y"], ref[f"{name}/y"]) <= TOL
    aux = float(ref[f"{name}/aux"])
    assert abs(got["aux"] - aux) <= TOL * abs(aux)
    names = _leaf_names(cases[name]) + ["x"]
    assert len(got["grads"]) == len(names) == len([k for k in ref if k.startswith(f"{name}/g")])
    top1 = workers._cfg(cases[name]["arch"]).experts_per_token == 1
    for i, (leaf, g) in enumerate(zip(names, got["grads"])):
        tol = TOP1_ROUTER_TOL if top1 and leaf == "router/w" else TOL
        assert rel(g, ref[f"{name}/g{i}"]) <= tol, leaf


def check_ranks_agree(runs, name: str) -> None:
    """Every rank returns the same output (or losses), aux and gradients,
    bit for bit."""
    _, port, _ = runs
    first = port[name][0]
    for other in port[name][1:]:
        for key in first:
            if key == "grads":
                for a, b in zip(other[key], first[key]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(other[key], first[key])


def check_drops(runs, prefix: str) -> None:
    """At the config's capacity the per-rank capacity drops tokens: the
    block parts from the no-drop one (what a no-drop oracle alone would not
    pin), in the port as in the reference."""
    _, port, ref = runs
    assert rel(port[f"{prefix}-config"][0]["y"], port[f"{prefix}-nodrop"][0]["y"]) > 1e-3
    assert rel(ref[f"{prefix}-config/y"], ref[f"{prefix}-nodrop/y"]) > 1e-3


def check_psum(runs, name: str) -> None:
    """Both steps' reduced gradients on every rank against the reference's
    (bit for bit at 2 ranks, within an ulp of the scale sum beyond), every
    rank the same bits, and the mean-scale rule pinned: at unequal scales
    the result is not the mean of the ranks' dequantized shards."""
    from repro_torch.optim import ef_compress_update

    cases, port, ref = runs
    n = len(port[name])
    for step in range(2):
        for k in ("a", "b", "c"):
            want = ref[f"{name}/{step}/red/{k}"]
            for rank, steps in enumerate(port[name]):
                got = steps[step][0][k]
                if n == 2:
                    np.testing.assert_array_equal(bits(got), bits(want[rank]))
                else:
                    # (s_sum / n) / n moves by at most an ulp of s_sum, times
                    # the payload sum, plus the products' own rounding
                    assert np.all(np.abs(got - want[rank]) <= np.abs(want[rank]) * 2.0 ** -22)
                np.testing.assert_array_equal(bits(got), bits(port[name][0][step][0][k]))
    g, e = cases[name]["grads"][0]["a"], cases[name]["errors"]["a"]
    mean = np.mean([ef_compress_update(torch.from_numpy(g[r]), torch.from_numpy(e[r]))[2].numpy()
                    for r in range(n)], axis=0)
    assert np.abs(port[name][0][0][0]["a"] - mean).max() > 0.1 * np.abs(mean).max()


def check_psum_errors(runs, name: str) -> None:
    """Each rank's new errors are its own ``ef_compress_update`` residuals,
    bit for bit the reference's for that shard, at both steps."""
    from repro_torch.optim import ef_compress_update

    cases, port, ref = runs
    for rank, steps in enumerate(port[name]):
        err = {k: v[rank] for k, v in cases[name]["errors"].items()}
        for step, grads in enumerate(cases[name]["grads"]):
            for k in ("a", "b", "c"):
                got = steps[step][1][k]
                np.testing.assert_array_equal(bits(got), bits(ref[f"{name}/{step}/err/{k}"][rank]))
                own = ef_compress_update(torch.from_numpy(grads[k][rank]),
                                         torch.from_numpy(np.ascontiguousarray(err[k])))[3]
                np.testing.assert_array_equal(bits(got), bits(own.numpy()))
            err = steps[step][1]


def check_layout_specs(runs, arch: str, mname: str, mesh) -> None:
    """Every leaf of the reduced arch's parameters: the reference's
    ``param_shardings`` spec on a mesh of the same shape."""
    from repro_torch.dist.sharding import param_shardings

    _, _, ref = runs
    want = json.loads(str(ref[f"layout-{arch}-{mname}/specs"]))
    got = dict(port_paths(param_shardings(_params(LAYOUT_ARCHS[arch]), FakeMesh(*mesh))))
    assert sorted(got) == sorted(want)
    for path, sh in got.items():
        assert [list(e) if isinstance(e, tuple) else e for e in sh.spec] == want[path], path
    if np.prod(mesh[0]) > 1:
        assert sum(any(e is not None for e in sh.spec) for sh in got.values()) > 3


def check_layout_placements(runs, arch: str, mname: str, mesh) -> None:
    """``distribute_tensor`` with each leaf's placements gives every rank
    the local shape the spec implies (each dimension over the product of its
    mesh dimensions' sizes) and the block of the whole that the spec names
    for that rank."""
    _, port, _ = runs
    sizes = dict(zip(mesh[1], mesh[0]))
    full = {path: tuple(t.shape) for path, t in port_paths(_params(LAYOUT_ARCHS[arch]))}
    per_rank = port[f"layout-{arch}-{mname}"]
    assert all(sorted(r) == sorted(full) for r in per_rank)
    sharded = 0
    for path, shape in full.items():
        spec = per_rank[0][path][0]
        count = [1 if e is None else
                 int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,))]))
                 for e in spec]
        want = tuple(d // c for d, c in zip(shape, count + [1] * (len(shape) - len(count))))
        for rank in per_rank:
            assert rank[path][0] == spec and rank[path][1] == want and rank[path][2], path
        sharded += want != shape
    assert sharded > 3


def check_lm(runs, name: str) -> None:
    """``loss_and_grads`` of the whole LM under the mesh against the
    reference's ``lm_forward``/``cross_entropy`` under its Auto mesh (whose
    MoE blocks took the manual path)."""
    _, port, ref = runs
    assert int(ref[f"{name}/manual"]) >= 1
    got = port[name][0]
    for key, want in zip(("total", "ce", "aux"), (float(v) for v in ref[f"{name}/loss"])):
        assert abs(got[key] - want) <= 1e-6 * want, key
    assert len(got["grads"]) == len([k for k in ref if k.startswith(f"{name}/g")])
    for i, g in enumerate(got["grads"]):
        assert rel(g, ref[f"{name}/g{i}"]) <= TOL, i
