"""The reference's side of ``tests/test_torch_dryrun.py``: run as

    python tests/_dryrun_oracle.py IN.json OUT.json

with the cells the test names in IN.json. It lowers and compiles the
reference's dry-run cells (``repro.launch.dryrun.run_cell`` without the
roofline probes, and ``run_parafac2_cell``) on the 512 host devices that
``repro.launch.dryrun`` forces, on the production meshes' shapes made with
``axis_types`` Auto on every dimension: ``make_production_mesh``'s
default, Explicit, refuses the reference's ``with_sharding_constraint``.
It writes each cell's record, and the shardings and leaves the cell was
lowered with, as JSON. Imports JAX and the reference, never torch.
"""
import json
import os
import sys

import jax
from jax.sharding import AxisType

from repro.launch import dryrun as dr  # noqa: E402  (sets XLA_FLAGS: 512 host devices)
from repro.models import build  # noqa: E402

# XLA's lowest backend optimization: the same buffers and shardings, less
# compile time (read when the backend starts, after the import above)
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"

def _mesh(name):
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if name == "pods2x16x16"
                   else ((16, 16), ("data", "model")))
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _specs(tree):
    """{"/"-joined path: [spec entries]} of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(_key_str(p) for p in path): [_entry(e) for e in sh.spec]
            for path, sh in flat}


def _key_str(entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _leaves(tree):
    """{"/"-joined path: [shape, dtype]} of a tree of ShapeDtypeStructs."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key_str(p) for p in path): [list(x.shape), str(x.dtype)]
            for path, x in flat}


CC_FIELDS = ("vals", "cols", "col_mask", "subject_ids", "subject_mask", "row_counts")
SCOO_FIELDS = ("vals", "rows", "lcols", "row_ends", "cperm", "col_ends", "cols",
               "col_mask", "subject_ids", "subject_mask", "row_counts", "nnz_counts")


def _named(data, tree_of_data):
    """{"buckets/i/field": leaf of ``tree_of_data``} (``data``'s layout),
    the bucket fields by name, as the port's planner names them."""
    out = {}
    for i, (b, t) in enumerate(zip(data.buckets, tree_of_data.buckets)):
        names = SCOO_FIELDS if getattr(b, "format", "cc") == "scoo" else CC_FIELDS
        for name, leaf in zip(names, t.tree_flatten()[0]):
            out[f"buckets/{i}/{name}"] = leaf
    return out


def lm_shardings(arch, shape_name, mesh):
    """The shardings ``dr._lower_compile`` gives the cell's inputs."""
    cfg = dr.get_config(arch)
    bundle = build(cfg)
    kind = dr.SHAPES[shape_name].kind
    params = jax.eval_shape(bundle.init_params, jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    specs = bundle.input_specs(shape_name)
    out = {"params": _specs(dr.param_shardings(params, mesh))}
    if kind == "train":
        opt = jax.eval_shape(bundle.init_opt, params)
        out["opt"] = _specs(dr.param_shardings(opt, mesh))
    if kind in ("train", "prefill"):
        out["batch"] = _specs(dr.batch_shardings(specs["batch"], mesh))
    else:
        out["cache"] = _specs(dr.cache_shardings(specs["cache"], mesh))
        out["cache_leaves"] = _leaves(specs["cache"])
        out["tokens"] = _specs({"t": dr.batch_shardings({"t": specs["tokens"]}, mesh)["t"]})
    return out


def parafac2_leaves(cell, mesh, engine, fmt, constraint, compress, precision):
    """The leaves ``run_parafac2_cell`` lowers, with their shardings."""
    from repro.core import Parafac2Options
    from repro.core.compress import parse_preprocess_spec
    from repro.core.constraints import parse_constraint_arg

    K, J, R, geom = dr.PARAFAC2_CELLS[cell]
    pp = parse_preprocess_spec(compress)
    if not pp.identity:
        S = pp.sketch_dim(R)
        geom = [(kb, min(ip, S), cp, npad) for kb, ip, cp, npad in geom]
        fmt = "cc"
    specs = (parse_constraint_arg(constraint) if constraint
             else {"v": "nonneg", "w": "nonneg"})
    opts = Parafac2Options(rank=R, constraints=specs, w_layout="bucketed",
                           backend="jnp", precision=precision, engine=engine)
    dp = dr._axis_size(mesh, tuple(mesh.axis_names))
    data, state = dr.parafac2_specs(K, J, R, geom, dp, opts, format=fmt)
    d_sh, s_sh = dr.parafac2_shardings(data, state, mesh)
    return {"data": {k: [list(x.shape), str(x.dtype)] for k, x in _named(data, data).items()},
            "state": _leaves(state),
            "data_specs": {k: [_entry(e) for e in sh.spec]
                           for k, sh in _named(data, d_sh).items()},
            "state_specs": _specs(s_sh)}


def main(inp, out):
    """IN.json: {"lm": {key: [arch, shape, mesh name]}, "parafac2": {key:
    {"name", "mesh", "engine", "format", "constraint", "compress",
    "precision"}}}."""
    with open(inp) as f:
        cells = json.load(f)
    res = {"lm": {}, "parafac2": {}}
    for key, (arch, shape_name, mesh_name) in cells["lm"].items():
        mesh = _mesh(mesh_name)
        rec = dr.run_cell(arch, shape_name, mesh, mesh_name, roofline=False)
        rec["shardings"] = lm_shardings(arch, shape_name, mesh)
        res["lm"][key] = rec
    for key, c in cells["parafac2"].items():
        mesh = _mesh(c["mesh"])
        rec = dr.run_parafac2_cell(c["name"], mesh, c["mesh"], engine=c["engine"],
                                   format=c["format"], constraint=c["constraint"],
                                   compress=c["compress"], precision=c["precision"])
        rec["leaves"] = parafac2_leaves(c["name"], mesh, c["engine"], c["format"],
                                        c["constraint"], c["compress"], c["precision"])
        res["parafac2"][key] = rec
    with open(out, "w") as f:
        json.dump(res, f, default=float)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
