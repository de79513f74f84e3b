"""The reference's side of ``tests/test_torch_lm_mesh.py``: run as

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/_lm_mesh_oracle.py IN.pkl OUT.npz

with the cases the test drew (numpy inputs, mesh shapes and names). Each
mesh is made with ``axis_types`` Auto on every dimension (``jax.make_mesh``'s
default, Explicit, refuses the reference's ``with_sharding_constraint``);
gradients are jitted, at XLA's lowest backend optimization (the same
operations, less compile time on one core). Imports JAX and the reference,
never torch.
"""
import dataclasses
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

jax.config.update("jax_enable_x64", True)     # as tests/conftest.py sets it

from repro.configs import get_config, reduced  # noqa: E402
from repro.dist import sharding as rsh  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.transformer import lm_forward  # noqa: E402
from repro.optim.compress import compressed_psum  # noqa: E402

FAST = {"xla_backend_optimization_level": 0}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def _mesh(spec):
    shape, names = spec
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:int(np.prod(shape))])


def _tree(fn, leaves):
    """``leaves`` (tree_leaves order) in the tree ``fn`` would make."""
    treedef = jax.tree_util.tree_structure(jax.eval_shape(fn))
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])


class _Manual:
    """Counts the reference's calls of ``_moe_block_manual`` (at trace time)."""

    def __init__(self):
        self.calls = 0
        self.real = ref_moe._moe_block_manual
        ref_moe._moe_block_manual = self

    def __call__(self, *a, **k):
        self.calls += 1
        return self.real(*a, **k)


def _moe_loss(case):
    """(value_and_grad of sum(y * w) + aux over (p, x), p, x)."""
    cfg = reduced(get_config(case["arch"]))
    if case["capacity_factor"] is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=case["capacity_factor"])
    p = _tree(lambda: ref_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32), case["params"])
    w = jnp.asarray(case["w"])

    def loss(p, x):
        y, aux = ref_moe.moe_block(p, x, cfg)
        return (y * w).sum() + aux, (y, aux)

    return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), p, jnp.asarray(case["x"])


def _moe(cases: dict, manual: _Manual, res: dict) -> None:
    """The MoE cases, those of one mesh compiled as one program; each
    case's ``manual`` is whether its block took the manual path."""
    by_mesh = {}
    for name, case in cases.items():
        by_mesh.setdefault(case["mesh"], []).append(name)
    for spec, names in by_mesh.items():
        with rsh.axis_rules(rsh.LM_RULES, _mesh(spec)):
            fns, args = zip(*[(f, (p, x)) for f, p, x in map(_moe_loss, (cases[n] for n in names))])
            manual.calls = 0
            outs = _compiled(lambda args: [f(*a) for f, a in zip(fns, args)], list(args))(list(args))
        for name, ((_, (y, aux)), (gp, gx)) in zip(names, outs):
            res[f"{name}/manual"] = np.asarray(manual.calls == len(names))
            res[f"{name}/y"], res[f"{name}/aux"] = np.asarray(y), np.asarray(aux)
            for i, g in enumerate(jax.tree_util.tree_leaves(gp) + [gx]):
                res[f"{name}/g{i}"] = np.asarray(g)


def _lm(name: str, case: dict, manual: _Manual, res: dict) -> None:
    cfg = reduced(get_config(case["arch"]))
    bundle = ref_build(cfg)
    params = _tree(lambda: bundle.init_params(jax.random.PRNGKey(0)), case["params"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}

    def loss(params, batch):
        logits, aux = lm_forward(params, batch["tokens"], cfg)
        ce = ref_api.cross_entropy(logits, batch["labels"])
        return ce + ref_api.AUX_COEF * aux, (ce, aux)

    manual.calls = 0
    with rsh.axis_rules(rsh.LM_RULES, _mesh(case["mesh"])):
        fn = _compiled(jax.value_and_grad(loss, has_aux=True), params, batch)
        (total, (ce, aux)), grads = fn(params, batch)
    res[f"{name}/manual"] = np.asarray(manual.calls)
    res[f"{name}/loss"] = np.asarray([total, ce, aux])
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        res[f"{name}/g{i}"] = np.asarray(g)


def _psum(name: str, case: dict, res: dict) -> None:
    # eager, as the reference runs it under vmap (a jitted program rounds
    # otherwise: XLA reorders the scale arithmetic)
    fn = jax.vmap(lambda g, e: compressed_psum(g, e, "d"), axis_name="d")
    errors = {k: jnp.asarray(v) for k, v in case["errors"].items()}
    for step, grads in enumerate(case["grads"]):
        red, errors = fn({k: jnp.asarray(v) for k, v in grads.items()}, errors)
        for k in red:
            res[f"{name}/{step}/red/{k}"] = np.asarray(red[k])
            res[f"{name}/{step}/err/{k}"] = np.asarray(errors[k])


def _layouts(layouts: dict, archs: dict, res: dict) -> None:
    """Each arch's ``param_shardings`` specs on each mesh, by "/"-joined path."""
    for mname, spec in layouts.items():
        mesh = _mesh(spec)
        for key, arch in archs.items():
            shapes = jax.eval_shape(ref_build(reduced(get_config(arch))).init_params,
                                    jax.random.PRNGKey(0))
            flat = jax.tree_util.tree_flatten_with_path(rsh.param_shardings(shapes, mesh))[0]
            specs = {"/".join(rsh._key_str(p) for p in path):
                     [list(e) if isinstance(e, tuple) else e for e in sh.spec]
                     for path, sh in flat}
            res[f"layout-{key}-{mname}/specs"] = np.asarray(json.dumps(specs))


def main(inp: str, out: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    with open(inp, "rb") as f:
        given = pickle.load(f)
    cases = given["cases"]
    manual, res = _Manual(), {}
    _moe({k: c for k, c in cases.items() if c["kind"] == "moe"}, manual, res)
    for name, case in cases.items():
        if case["kind"] == "lm":
            _lm(name, case, manual, res)
        elif case["kind"] == "psum":
            _psum(name, case, res)
    _layouts(given.get("layouts", {}), given.get("layout_archs", {}), res)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
