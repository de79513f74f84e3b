"""The LM on a mesh, in gloo worlds of 4 ranks (meshes (2, 2) and
(2, 1, 2)), against the reference's own mesh runs: the manual
expert-parallel MoE on the reduced phi3.5-moe (a batch the data ranks cut,
and one they do not, so that each routes the same tokens) and llama4,
``compressed_psum`` over the flattened (data, model) group at scales 1,
10, 0.1 and 1, and ``param_shardings`` on the reduced qwen3 and phi3.5-moe
(the specs, and ``distribute_tensor`` with the placements). The cases,
checks and bounds are ``tests/_lm_mesh_checks.py``'s; 2 ranks are
``tests/test_torch_lm_mesh.py``.
"""
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)

import _lm_mesh_checks as lmc  # noqa: E402
from _lm_mesh_checks import LLAMA4, M22, M212, NO_DROP, PHI  # noqa: E402

# name -> (arch, mesh, batch, capacity factor: None for the config's 1.25);
# "b3": a batch of 3, which the 2 data ranks do not divide
MOE = {"phi-2x2-config": (PHI, M22, 4, None), "phi-2x2-nodrop": (PHI, M22, 4, NO_DROP),
       "phi-2x2-b3-config": (PHI, M22, 3, None),
       "llama4-2x1x2-config": (LLAMA4, M212, 4, None),
       "llama4-2x1x2-nodrop": (LLAMA4, M212, 4, NO_DROP)}
LAYOUTS = {"2x2": M22, "2x1x2": M212}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: lmc.moe_case(*spec, seed=10 + i) for i, (name, spec) in enumerate(MOE.items())}
    cases["psum"] = lmc.psum_case(M22, ("data", "model"), (1.0, 10.0, 0.1, 1.0))
    for arch, full in lmc.LAYOUT_ARCHS.items():
        for mname, mesh in LAYOUTS.items():
            cases[f"layout-{arch}-{mname}"] = dict(kind="layout", arch=full, mesh=mesh)
    return lmc.runs(tmp_path_factory.mktemp("lm_mesh_four"), cases, LAYOUTS)


@pytest.mark.parametrize("name", list(MOE))
def test_manual_moe_matches_reference(runs, name):
    lmc.check_moe(runs, name)


@pytest.mark.parametrize("name", list(MOE))
def test_every_rank_holds_the_same_results(runs, name):
    lmc.check_ranks_agree(runs, name)


def test_compressed_psum_matches_reference(runs):
    """Four ranks at scales 1, 10, 0.1 and 1, within an ulp of the scale
    sum."""
    lmc.check_psum(runs, "psum")


def test_compressed_psum_keeps_error_feedback_local(runs):
    lmc.check_psum_errors(runs, "psum")


@pytest.mark.parametrize("mname", list(LAYOUTS))
@pytest.mark.parametrize("arch", list(lmc.LAYOUT_ARCHS))
def test_param_shardings_match_reference(runs, arch, mname):
    lmc.check_layout_specs(runs, arch, mname, LAYOUTS[mname])


@pytest.mark.parametrize("mname", list(LAYOUTS))
@pytest.mark.parametrize("arch", list(lmc.LAYOUT_ARCHS))
def test_param_shardings_lay_out_through_distribute_tensor(runs, arch, mname):
    lmc.check_layout_placements(runs, arch, mname, LAYOUTS[mname])
