"""The LM on a mesh, in gloo worlds of 2 ranks (meshes (1, 2) and
(1, 1, 2)), against the reference's own mesh runs: the manual
expert-parallel MoE on the reduced phi3.5-moe and llama4, the whole reduced
phi3.5-moe LM's loss and gradients, ``compressed_psum``; and, in this
process, ``moe_block``'s routing, ``compressed_psum`` without a mesh and
``param_shardings`` on the reference test's tree and on (1, 1). The
cases, checks and bounds are ``tests/_lm_mesh_checks.py``'s; 4 ranks are
``tests/test_torch_lm_mesh_four.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# with several pytest-xdist workers on the cores, torch's intra-op threads
# oversubscribe them: one each
torch.set_num_threads(1)

import _lm_mesh_checks as lmc  # noqa: E402
from _lm_mesh_checks import LLAMA4, M11, M12, M112, NO_DROP, PHI  # noqa: E402

# name -> (arch, mesh, batch, capacity factor: None for the config's 1.25[,
# sequence: 8 by default]). "cf1.3": 32 tokens a rank, where the per-rank
# capacity's integer form (round(1.3 * 4) = 5: 20 slots) parts from the
# auto path's formula (21 slots) and from the 8-slot floor
MOE = {"phi-1x2-config": (PHI, M12, 4, None), "phi-1x2-nodrop": (PHI, M12, 4, NO_DROP),
       "phi-1x1x2-config": (PHI, M112, 4, None),
       "phi-1x2-cf1.3": (PHI, M12, 4, 1.3, 16),
       "llama4-1x2-config": (LLAMA4, M12, 4, None),
       "llama4-1x2-nodrop": (LLAMA4, M12, 4, NO_DROP)}
LAYOUTS = {"1x1": M11}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {name: lmc.moe_case(*spec[:4], i, *spec[4:]) for i, (name, spec) in
             enumerate(MOE.items())}
    cases["lm"] = lmc.lm_case(M12)
    cases["psum"] = lmc.psum_case(M12, "model", (1.0, 10.0))
    return lmc.runs(tmp_path_factory.mktemp("lm_mesh"), cases, LAYOUTS)


@pytest.mark.parametrize("name", list(MOE))
def test_manual_moe_matches_reference(runs, name):
    lmc.check_moe(runs, name)


@pytest.mark.parametrize("name", list(MOE) + ["lm"])
def test_every_rank_holds_the_same_results(runs, name):
    lmc.check_ranks_agree(runs, name)


@pytest.mark.parametrize("prefix", ["phi-1x2", "llama4-1x2"])
def test_manual_moe_drops_per_rank(runs, prefix):
    lmc.check_drops(runs, prefix)


def test_lm_on_a_mesh_matches_reference(runs):
    """``loss_and_grads`` of the reduced phi3.5-moe LM (B 2 x S 16) on a
    (1, 2) world."""
    lmc.check_lm(runs, "lm")


def test_compressed_psum_matches_reference(runs):
    """Two ranks at scales 1 and 10, bit for bit."""
    lmc.check_psum(runs, "psum")


def test_compressed_psum_keeps_error_feedback_local(runs):
    lmc.check_psum_errors(runs, "psum")


def test_compressed_psum_needs_a_mesh():
    from repro_torch.optim import compressed_psum

    with pytest.raises(ValueError, match="DeviceMesh"):
        compressed_psum({"g": torch.zeros(2)}, {"g": torch.zeros(2)}, "data")


@pytest.mark.parametrize("arch", list(lmc.LAYOUT_ARCHS))
def test_param_shardings_match_reference_on_one_device(runs, arch):
    lmc.check_layout_specs(runs, arch, "1x1", M11)


def test_param_shardings_small_pytree_matches_reference():
    """The reference test's tree (``test_param_shardings_small_pytree``):
    the reference's specs on a (1, 1) mesh, and placements that follow
    them."""
    import jax
    import jax.numpy as jnp
    from torch.distributed.tensor import Replicate, Shard

    from repro.dist.sharding import param_shardings as ref_param_shardings
    from repro_torch.dist.sharding import param_shardings
    from repro_torch.models.common import tree_leaves

    def tree(leaf):
        return {"embed": {"tokens": leaf(8, 4)},
                "layers": {"groups": {"p0_attn_mlp": {"attn": {"wq": leaf(3, 4, 4)},
                                                      "ln1_scale": leaf(3, 4),
                                                      "mlp": {"w_down": leaf(3, 4, 4)}}}},
                "final_norm_scale": leaf(4)}

    want = ref_param_shardings(tree(lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)),
                               jax.make_mesh((1, 1), ("data", "model")))
    got = param_shardings(tree(lambda *s: torch.empty(s, device="meta")), lmc.FakeMesh(*M11))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(flat) == 5
    for (path, w), g in zip(flat, leaves):
        assert g.spec == tuple(w.spec), jax.tree_util.keystr(path)
    assert got["embed"]["tokens"].placements == (Shard(1), Shard(0))
    grp = got["layers"]["groups"]["p0_attn_mlp"]
    assert grp["attn"]["wq"].placements == (Shard(1), Shard(2))
    assert grp["ln1_scale"].placements == (Replicate(), Replicate())


@pytest.mark.parametrize("shape,names,E,S,manual", [
    ((1, 2), ("data", "model"), 4, 8, True),
    ((2, 1, 2), ("pod", "data", "model"), 4, 8, True),
    ((2, 1), ("data", "model"), 4, 8, False),       # model 1
    ((1, 3), ("data", "model"), 4, 9, False),       # 3 does not divide the experts
    ((1, 2), ("data", "model"), 4, 7, False),       # 2 does not divide the sequence
    ((4,), ("data",), 4, 8, False),                 # no model dimension
])
def test_moe_block_routes_as_reference(monkeypatch, shape, names, E, S, manual):
    """``moe_block`` takes the manual path exactly where the reference's
    does (each package's ``_moe_block_manual`` replaced by a marker)."""
    import dataclasses

    import jax.numpy as jnp
    from repro.dist import sharding as rsh
    from repro.models import moe as ref_moe
    from repro_torch.dist import sharding as dsh
    from repro_torch.models import moe

    class RefMesh:
        axis_names, devices = names, np.empty(shape)

    marker = (torch.zeros(()), torch.zeros(()))
    monkeypatch.setattr(moe, "_moe_block_manual", lambda *a: marker)
    monkeypatch.setattr(ref_moe, "_moe_block_manual", lambda *a: "manual")
    monkeypatch.setattr(ref_moe, "_moe_block_auto", lambda *a: "auto")
    cfg = dataclasses.replace(lmc.workers._cfg(PHI), n_experts=E)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with dsh.axis_rules(dsh.LM_RULES, lmc.FakeMesh(shape, names)):
        took = moe.moe_block(p, x, cfg) is marker
    with rsh.axis_rules(rsh.LM_RULES, RefMesh()):
        ref_took = ref_moe.moe_block(None, jnp.zeros((2, S, 4)), cfg) == "manual"
    assert took == ref_took == manual
