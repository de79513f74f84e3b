"""The port's collective byte count (``repro_torch.analysis.comm``) against
the planner's collective bytes (``repro_torch.launch.dryrun``) and counts
made by hand, in spawned gloo worlds of 2 ranks (``tests/_mesh_workers.py``):
a mesh-engine fit's all-reduces, the manual expert-parallel MoE's
all-to-alls and ``compressed_psum``'s int8 all-reduces. Also: the count in
one process, and the mesh entry points' refusal to fall back to the CPU.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import _mesh_workers as workers  # noqa: E402
from repro_torch.analysis.comm import (COLLECTIVE_KINDS, note,  # noqa: E402
                                       record_collectives, shape_bytes)
from repro_torch.launch import mesh as lm  # noqa: E402

ITERS = 2


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """Each rank's records (``workers.comm_counts``) in a world of 2."""
    return workers.World(2, workers.comm_counts, tmp_path_factory.mktemp("comm"),
                         ITERS).join()


def _only(rec: dict, **want) -> None:
    """``rec`` holds ``want``'s bytes by kind, 0 for every other kind, and
    their sum as ``total``."""
    assert {k: rec[k] for k in COLLECTIVE_KINDS} == {k: want.get(k.replace("-", "_"), 0)
                                                     for k in COLLECTIVE_KINDS}
    assert rec["total"] == sum(want.values())


def test_record_collectives_mesh_iteration_matches_plan(counts):
    """A mesh-engine fit of ITERS iterations (the bucketed W, on the CPU
    every iteration issues its all-reduces from Python) records ITERS times
    the planner's bytes of one iteration: M1, W's Gram twice, M2 and the
    fit's residual, five all-reduces."""
    for rank in counts:
        rec, calls = rank["fit"]
        plan = rank["fit_plan"]
        assert plan["total"] == plan["all-reduce"] > 0
        _only(rec, all_reduce=ITERS * plan["all-reduce"])
        assert calls["all-reduce"] == 5 * ITERS


def test_record_collectives_manual_moe_matches_plan(counts):
    """One forward of the manual MoE on a (1, 2) mesh records the planner's
    all-to-all bytes (its send buffer out and the results back), the
    all-gather of the rank's [2, 4, 64] f32 output and the aux loss's
    4-byte mean; its backward the same all-to-alls and the all-reduce of
    the input's [2, 8, 64] f32 cotangent."""
    for rank in counts:
        fwd, bwd = rank["moe"]
        plan = rank["moe_plan"]
        assert plan > 0
        _only(fwd, all_to_all=plan, all_gather=2 * 4 * 64 * 4, all_reduce=4)
        _only(bwd, all_to_all=plan, all_reduce=2 * 8 * 64 * 4)


def test_record_collectives_compressed_psum_hand_count(counts):
    """``compressed_psum`` of a [3, 5] and a [7] leaf: per leaf the int8
    payload widened to int32 and the f32 scale, four all-reduces."""
    for rank in counts:
        rec, calls = rank["psum"]
        _only(rec, all_reduce=(15 * 4 + 4) + (7 * 4 + 4))
        assert calls["all-reduce"] == 4


def test_record_collectives_in_one_process():
    """Records nest and see only what is noted while they are open; an
    unknown kind raises; ``shape_bytes`` is the dtype's size times the
    elements."""
    note("all-reduce", torch.zeros(3))            # no record open: counted nowhere
    with record_collectives() as outer:
        note("all-gather", torch.zeros(2, 3, dtype=torch.float64))
        with record_collectives() as inner:
            note("all-to-all", torch.zeros(5, dtype=torch.bfloat16))
        note("collective-permute", torch.zeros(1, dtype=torch.int8))
    note("all-reduce", torch.zeros(3))
    _only(outer, all_gather=48, all_to_all=10, collective_permute=1)
    _only(inner, all_to_all=10)
    assert outer.calls == {"all-reduce": 0, "all-gather": 1, "reduce-scatter": 0,
                           "all-to-all": 1, "collective-permute": 1}
    with pytest.raises(ValueError, match="unknown collective"):
        note("broadcast", torch.zeros(1))
    assert shape_bytes(torch.bfloat16, (4, 5)) == 40
    assert shape_bytes(torch.int32, ()) == 4
    assert shape_bytes(torch.float64, (2, 0)) == 0


def test_mesh_entry_points_raise_without_cuda():
    """With no device asked for, ``init_distributed``, ``make_local_mesh``
    and ``local_mesh`` mean a GPU: without one they raise, and bring no
    process group up; ``device="cpu"`` stays available."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    for fn in (lm.init_distributed, lm.make_local_mesh, lm.local_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
        assert not dist.is_initialized()
    try:
        assert lm.init_distributed("cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        lm.shutdown()
