"""The port's measurement tools on the CPU: what ``kernel_ab`` holds a
change's outputs to, the phase stamps ``tridiag_trace`` puts into
``csrc/tridiag.cu`` (both time kernels only on a GPU), and ``mesh_time``
in a world of one."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import kernel_ab, tridiag_trace  # noqa: E402

CSRC = _build.CSRC


def test_kernel_ab_tolerance_is_zero_but_for_the_redesigned_orders():
    """0 (the same bits) for every kernel whose order of sums a change
    keeps; the f32 bound for F1 at half width and for P2 at both N."""
    pairs = [(torch.tensor([3.0, -40.0]), torch.tensor([3.0, -40.0]))]
    assert kernel_ab.tolerance("fused_procrustes_b", False, pairs) == 0.0
    assert kernel_ab.tolerance("fused_ykv", True, pairs) == 0.0
    assert kernel_ab.tolerance("gram_inv_sqrt_r5", False, pairs) == 0.0
    assert kernel_ab.tolerance("fused_procrustes_b", True, pairs) == pytest.approx(4e-5)
    small = [(torch.tensor([0.25]), torch.tensor([0.25]))]
    assert kernel_ab.tolerance("fused_procrustes_b", True, small) == pytest.approx(1e-6)
    for name in ("tridiag_solve", "tridiag_solve_n464900"):
        assert kernel_ab.tolerance(name, False, pairs) == pytest.approx(1e-6 * 1.8 * 40)
    assert set(kernel_ab.COMPARED) >= {"tridiag_solve", "tridiag_solve_n464900"}


def test_tridiag_trace_stamps_every_phase_boundary(tmp_path):
    """Every phase boundary the trace stamps is still in csrc/tridiag.cu,
    once, and the stamped copy keeps the source's entry points."""
    out = tridiag_trace.stamped_source(CSRC, tmp_path)
    src = (out / "tridiag.cu").read_text()
    for i in (0, 1, 2, 3, 4, 7, 8, 9, 10, 11):
        assert f"STAMP({i})" in src, i
    for fn in ("spartan_tridiag_solve", "spartan_tridiag_workspace", "spartan_tridiag_kernels",
               "p2_trace_copy"):
        assert fn in src
    assert (out / "common.cuh").read_text() == (CSRC / "common.cuh").read_text()
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "tridiag.cu").write_text("namespace {\n}\n")
    (broken / "common.cuh").write_text("")
    with pytest.raises(RuntimeError, match="phase boundary"):
        tridiag_trace.stamped_source(broken, tmp_path / "out")


def test_kernel_ab_builds_only_what_the_named_kernels_need():
    assert kernel_ab.needed_sources(set()) == kernel_ab.SOURCES
    assert kernel_ab.needed_sources({"tridiag_solve", "tridiag_solve_n464900"}) == ("tridiag",)
    assert kernel_ab.needed_sources({"gram_inv_sqrt"}) == ("polar",)
    assert kernel_ab.needed_sources({"fused_procrustes_b", "fused_ykv"}) == ("fused",)
    assert kernel_ab.needed_sources({"mode1_reuse"}) == ("fused", "staged")
    assert kernel_ab.needed_sources({"scoo_project", "gather_matmul"}) == ("gather_matmul", "scoo")
    for name in kernel_ab.COMPARED:
        assert kernel_ab.source_of(name) in kernel_ab.SOURCES, name


def test_mesh_time_world_of_one_on_the_cpu(capsys):
    """``mesh_time --device cpu`` in a world of one: its line has the
    keys, one rank's bytes, the all-reduced bytes an iteration (M1, M2, M3
    and delta at f32) and the mesh fits' history bit for bit the scan
    engine's; the group is gone afterwards."""
    import json

    import torch.distributed as dist

    from repro_torch.launch import mesh_time

    out = mesh_time.main(["--scale", "0.002", "--iters", "3", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["world"] == 1 and len(out["shard_bytes"]) == 1 and out["imbalance"] is None
    K, J, R = 929, 1328, 5
    assert out["allreduce_bytes_per_iter"] == 4 * (R * R + J * R + K * R + 1)
    assert out["mesh_history"] == out["scan_history"] and len(out["scan_history"]) == 3
    assert not dist.is_initialized()
