"""The port's planner (``repro_torch.launch.dryrun``) against the reference's
own dry-run (``repro.launch.dryrun``).

The reference's side runs in three subprocesses (``tests/_dryrun_oracle.py``):
it lowers and compiles each cell below on the 512 host devices its dry-run
forces, on meshes made with ``axis_types`` Auto (``make_production_mesh``'s
Explicit axes refuse its ``with_sharding_constraint``), and reports XLA's
memory analysis and the shardings it lowered with. The port plans the same
cells from shapes alone while it runs. Wherever a number depends only on
shapes and shardings they must be equal: every batch, cache and parameter
spec entry by entry, ``argument_size_in_bytes``, ``n_chips``, ``params``,
``active_params``, ``padded_nnz`` and the PARAFAC2 model counts. XLA leaves
out of its arguments the inputs the program never reads; the port counts
every input, so its bytes exceed the reference's by exactly those leaves,
which ``PRUNED_*`` names. The temp estimate's ratio to XLA's temp is
printed, not bounded.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LM_CELLS = {f"{a}|{s}|{m}": (a, s, m) for a, s, m in [
    ("qwen3-0.6b", "train_4k", "pod16x16"),
    ("qwen3-0.6b", "prefill_32k", "pod16x16"),
    ("qwen3-0.6b", "decode_32k", "pod16x16"),
    ("mamba2-780m", "decode_32k", "pod16x16"),          # the ssm and conv caches
    ("whisper-medium", "decode_32k", "pod16x16"),       # self and cross kv
    ("recurrentgemma-9b", "decode_32k", "pod16x16"),    # the RG-LRU h, local kv
    ("phi3.5-moe-42b-a6.6b", "train_4k", "pods2x16x16"),
]}

_CHOA, _SYNTH = "parafac2-choa-r40", "parafac2-synth500m-r40"
_ADMM = "v=nonneg_admm,w=nonneg_admm"
PARAFAC2_CELLS = {k: dict(name=n, mesh="pod16x16", engine=e, format=f, constraint=c,
                          compress=z, precision=p)
                  for k, (n, e, f, c, z, p) in {
    "choa|cc|host": (_CHOA, "host", "cc", "", "none", "f32"),
    "choa|scoo|scan": (_CHOA, "scan", "scoo", "", "none", "f32"),
    "choa|cc|host|admm": (_CHOA, "host", "cc", _ADMM, "none", "f32"),
    "choa|cc|host|rsvd": (_CHOA, "host", "cc", "", "rsvd", "f32"),
    "choa|cc|host|bf16": (_CHOA, "host", "cc", "", "none", "bf16"),
    "synth500m|scoo|scan": (_SYNTH, "scan", "scoo", "", "none", "f32"),
}.items()}

# the inputs XLA prunes as unread, by (input, path prefix): a decode step of
# the attention-free mamba2 reads no position, and whisper's decode step
# reads the cached cross kv, neither the encoder nor the cross-attention's
# key and value projections that made it
_CROSS = "layers/groups/p0_attn_cross_mlp/cross/"
PRUNED_LM = {
    "mamba2-780m|decode_32k|pod16x16": [("pos", "")],
    "whisper-medium|decode_32k|pod16x16": [("params", "encoder/"),
                                           ("params", "enc_norm_scale"),
                                           ("params", _CROSS + "wk"),
                                           ("params", _CROSS + "wv")],
}
# an ALS step reads neither the subject ids (the bucketed W lies with its
# rows) nor the row counts; the host step never reads the incoming fit, the
# SCOO route never the nnz counts
_HOST = ["subject_ids", "row_counts", "fit"]
PRUNED_PARAFAC2 = {
    "choa|cc|host": _HOST, "choa|cc|host|admm": _HOST, "choa|cc|host|rsvd": _HOST,
    "choa|cc|host|bf16": _HOST,
    "choa|scoo|scan": ["subject_ids", "row_counts", "nnz_counts"],
    "synth500m|scoo|scan": ["subject_ids", "row_counts", "nnz_counts"],
}
# the record keys the port names otherwise (None: the port has no such key)
RENAMED = {"fits_hbm_16g": "fits_hbm_80g", "lower_s": "plan_s", "compile_s": None,
           "generated_code_size_in_bytes": None}
ADDED = {"temp_estimate", "port_argument_bytes", "meta_s"}


def _mesh(name):
    return make_production_mesh(multi_pod=name == "pods2x16x16")


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """(the reference's records, the port's records): the oracle runs in
    three subprocesses (two halves of the LM cells, the PARAFAC2 cells)
    while the port plans the same cells in three processes."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(REPO, "src")}
    lm = sorted(LM_CELLS)
    groups = [{"lm": {k: LM_CELLS[k] for k in lm[::2]}, "parafac2": {}},
              {"lm": {k: LM_CELLS[k] for k in lm[1::2]}, "parafac2": {}},
              {"lm": {}, "parafac2": PARAFAC2_CELLS}]
    oracles = []
    for i, cells in enumerate(groups):
        inp, out = tmp / f"{i}.in.json", tmp / f"{i}.out.json"
        inp.write_text(json.dumps(cells))
        oracles.append((out, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_dryrun_oracle.py"), str(inp),
             str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    try:
        port = {"lm": {}, "parafac2": {}}
        jobs = [("lm", (a, s, [(m, key)], {"roofline": False}))
                for key, (a, s, m) in LM_CELLS.items()]
        jobs += [("parafac2", (c["name"], c["mesh"], key, {k: c[k] for k in (
            "engine", "format", "constraint", "compress", "precision")}))
            for key, c in PARAFAC2_CELLS.items()]
        for done in dr.run_jobs(jobs, 3):
            for key, rec, err in done:
                assert err is None, err
                if key in LM_CELLS:
                    arch, shape, mesh_name = LM_CELLS[key]
                    port["lm"][key] = (rec, dr.lm_cell(arch, shape, _mesh(mesh_name)))
                else:
                    port["parafac2"][key] = rec
        ref = {"lm": {}, "parafac2": {}}
        for out, proc in oracles:
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, log[-4000:]
            for family, recs in json.loads(out.read_text()).items():
                ref[family].update(recs)
    finally:
        for _, proc in oracles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref, port


def _specs(tree) -> dict:
    """{path: spec entries as JSON gives them} of a tree of ParamShardings."""
    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    return {p: [entry(e) for e in s.spec] for p, s in dr.leaves_with_paths(tree).items()}


def _same_keys(ref: dict, port: dict, extra=()) -> None:
    want = {RENAMED.get(k, k) for k in ref if k not in extra} - {None}
    assert set(port) - ADDED == want


@pytest.mark.parametrize("key", sorted(LM_CELLS))
def test_lm_cell_matches_reference_dryrun(planned, key):
    ref_all, port_all = planned
    ref = ref_all["lm"][key]
    rec, cell = port_all["lm"][key]
    mesh = _mesh(LM_CELLS[key][2])
    sh = ref["shardings"]
    for name in ("params", "opt", "batch", "cache"):
        if name in sh:
            assert _specs(cell.shardings[name]) == sh[name], name
    if "tokens" in sh:
        assert _specs({"t": cell.shardings["tokens"]}) == sh["tokens"]
        assert {p: [list(t.shape), str(t.dtype).replace("torch.", "")]
                for p, t in dr.leaves_with_paths(cell.inputs["cache"]).items()} \
            == sh["cache_leaves"]
    pruned = 0
    for name, prefix in PRUNED_LM.get(key, []):
        leaves = dr.leaves_with_paths({"x": cell.inputs[name]})
        specs = dr.leaves_with_paths({"x": cell.shardings[name]})
        hit = [p for p in leaves if p[2:].startswith(prefix) or (p == "x" and not prefix)]
        assert hit, (name, prefix)
        pruned += sum(math.prod(dr.local_shape(leaves[p].shape, specs[p].spec, mesh))
                      * leaves[p].element_size() for p in hit)
    assert rec["argument_size_in_bytes"] - pruned == ref["argument_size_in_bytes"]
    for k in ("n_chips", "params", "active_params", "kind", "microbatches", "sp"):
        assert rec[k] == ref[k], k
    _same_keys(ref, rec, extra=("shardings",))
    print(f"[dryrun] {key}: temp estimate / XLA temp = "
          f"{rec['temp_size_in_bytes'] / ref['temp_size_in_bytes']:.3f} "
          f"({rec['temp_size_in_bytes']} / {ref['temp_size_in_bytes']})")


@pytest.mark.parametrize("key", sorted(PARAFAC2_CELLS))
def test_parafac2_cell_matches_reference_dryrun(planned, key):
    ref_all, port_all = planned
    ref, rec = ref_all["parafac2"][key], port_all["parafac2"][key]
    c = PARAFAC2_CELLS[key]
    mesh = _mesh(c["mesh"])
    K, J, R, geom, fmt, _ = dr._cell_geometry(c["name"], c["compress"], c["format"])
    _, _, opts = dr.rank_share(c["name"], mesh, format=fmt, constraint=c["constraint"],
                               device="meta")
    data, state = dr.parafac2_specs(K, J, R, geom, mesh.size(), opts, format=fmt)
    d_sh, s_sh = dr.parafac2_shardings(data, state, mesh)

    def leaves(tree):
        return {p: [list(t.shape), str(t.dtype).replace("torch.", "")]
                for p, t in dr.leaves_with_paths(tree).items()}

    assert leaves(data) == ref["leaves"]["data"]
    assert leaves(state) == ref["leaves"]["state"]
    assert _specs(d_sh) == ref["leaves"]["data_specs"]
    assert _specs(s_sh) == ref["leaves"]["state_specs"]
    pruned = {**dr.leaves_with_paths(data), **dr.leaves_with_paths(state)}
    pruned = sum(t.numel() * t.element_size() // (mesh.size() if t.ndim else 1)
                 for p, t in pruned.items() if p.rsplit("/", 1)[-1] in PRUNED_PARAFAC2[key])
    assert rec["argument_size_in_bytes"] - pruned == ref["argument_size_in_bytes"]
    for k in ("n_chips", "params", "active_params", "padded_nnz", "arch", "format",
              "compress", "precision", "constraints", "check_every"):
        assert rec.get(k) == ref.get(k), k
    for k in ("model_flops_per_device", "model_streamed_bytes_per_device",
              "model_arithmetic_intensity"):
        assert (k in rec) == (k in ref), k
        if k in ref:
            assert rec[k] == pytest.approx(ref[k], rel=1e-12, abs=0), k
    _same_keys(ref, rec, extra=("leaves",))
    print(f"[dryrun] {key}: temp estimate / XLA temp = "
          f"{rec['temp_size_in_bytes'] / ref['temp_size_in_bytes']:.3f}; the port's own "
          f"bytes {rec['port_argument_bytes']} against the reference layout's "
          f"{rec['argument_size_in_bytes']}")


def test_dryrun_pod_cell_100m_nnz_under_budget():
    """The synth-500M SCOO geometry (592M padded triplets, well past 100M
    nonzeros) on the mesh engine at 256 cards: its per-device bytes, the
    reference layout's and the port's own, fit an H100's memory."""
    rec = dr.run_parafac2_cell("parafac2-synth500m-r40", make_production_mesh(), "pod16x16",
                               engine="mesh", format="scoo", check_every=2)
    assert rec["n_chips"] == 256
    assert rec["padded_nnz"] == 592_000_000 >= 100_000_000
    assert rec["fits_hbm_80g"], (rec["bytes_per_device"], rec["port_argument_bytes"])
    assert rec["collective_breakdown"]["all-reduce"] == rec["collective_bytes"] > 0


@pytest.mark.parametrize("fmt,precision", [("cc", "f32"), ("scoo", "f32"), ("cc", "bf16")])
def test_rank_share_on_cpu_is_the_planned_share(fmt, precision):
    """A rank's share made on the CPU has the meta share's tensors, so its
    bytes are the planner's ``port_argument_bytes``; its SCOO layout is
    consistent (the segment sums give the dense products) and its subjects
    are the rank's chunk."""
    mesh = AbstractMesh((64, 64), ("data", "model"))   # 29 choa subjects a bucket
    data, state, _ = dr.rank_share(_CHOA, mesh, rank=3, format=fmt, precision=precision,
                                   dtype=torch.float32, device="cpu")
    meta, meta_state, _ = dr.rank_share(_CHOA, mesh, rank=3, format=fmt, precision=precision,
                                        device="meta")
    for b, m in zip(data.buckets, meta.buckets):
        for f in ("vals", "cols", "scatter_perm", "scatter_ends", "subject_ids"):
            assert getattr(b, f).shape == getattr(m, f).shape, f
            assert getattr(b, f).dtype == getattr(m, f).dtype, f
        assert b.subject_ids.tolist() == list(range(3 * b.kb, 4 * b.kb))
    assert dr.port_bytes(data, state) == dr.port_bytes(meta, meta_state)
    if (fmt, precision) == ("cc", "f32"):
        rec = dr.run_parafac2_cell(_CHOA, mesh, "64x64")
        assert rec["port_argument_bytes"] == dr.port_bytes(data, state)
    if fmt == "scoo":
        f64, _, _ = dr.rank_share(_CHOA, mesh, rank=3, format=fmt, dtype=torch.float64,
                                  device="cpu")
        V = torch.rand((data.n_cols, 40), dtype=torch.float64)
        for b in f64.buckets:
            dense = b.dense_vals()
            torch.testing.assert_close(b.xk_times_v(V), torch.bmm(dense, b.gather_v(V)))
            Q = torch.rand((b.kb, b.i_pad, 40), dtype=torch.float64)
            torch.testing.assert_close(b.project(Q), torch.bmm(Q.transpose(1, 2), dense))
            assert int((dense != 0).sum()) == b.kb * b.n_pad


def test_dryrun_main_records_and_skips(tmp_path):
    """``main`` records the cells asked for in ``--out`` with 0 failures
    and skips recorded cells on a rerun."""
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "mamba2-780m", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(out), "--quiet"]
    assert dr.main(argv) == 0
    res = json.loads(out.read_text())
    cells = sorted(k for k in res if not k.startswith("_"))
    assert cells == ["mamba2-780m|decode_32k|pod16x16", "mamba2-780m|decode_32k|pods2x16x16"]
    assert res["_meta"]["kind"] == "dryrun"
    assert res["_meta"]["flops_convention"] == "global/n_chips"
    single = res[cells[0]]
    assert single["fits_hbm_80g"] and single["t_memory"] > 0 and "hlo_flops" in single
    assert "hlo_flops" not in res[cells[1]]              # the roofline is the pod's
    stamp = single["plan_s"]
    assert dr.main(argv) == 0
    assert json.loads(out.read_text())[cells[0]]["plan_s"] == stamp


def test_make_production_mesh_is_abstract():
    """The reference's pod meshes as shapes and names only: what
    ``param_shardings`` and the planner read, and no process group."""
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.shape, single.mesh_dim_names, single.size()) == \
        ((16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.mesh_dim_names, multi.size()) == \
        ((2, 16, 16), ("pod", "data", "model"), 512)
    assert multi.size("pod") == 2 and multi.size(2) == 16
    w = {"layers": {"groups": {"p0_attn_mlp": {"attn": {
        "wo": torch.empty((3, 64, 32), device="meta")}}}}}
    sh = dr.leaves_with_paths(dr.param_shardings(w, multi))
    assert sh["layers/groups/p0_attn_mlp/attn/wo"].spec == (None, "model", "data")
    with pytest.raises(ValueError, match="differ in length"):
        AbstractMesh((2, 2), ("data",))
