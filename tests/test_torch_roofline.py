"""The port's roofline terms (``repro_torch.analysis.roofline``) and the
planner's counters (``repro_torch.launch.dryrun.meta_costs``): ``model_flops``
against the reference's for every arch and applicable shape,
``roofline_terms`` on counts made by hand, and the flop, byte and live-byte
counts of a meta run against counts made by hand (a product chain, and a
reduced LM's prefill).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis.roofline import model_flops as ref_model_flops  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch.analysis.roofline import (H100_SXM, HW, calibrate_flops_convention,  # noqa: E402
                                           model_flops, roofline_terms)
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,  # noqa: E402
                                 list_archs, reduced)
from repro_torch.launch.dryrun import meta_costs  # noqa: E402
from repro_torch.models import build  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_matches_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in applicable_shapes(cfg):
        for n in (1, 256, 512):
            for per_device in (True, False):
                assert model_flops(cfg, SHAPES[shape], per_device=per_device, n_chips=n) \
                    == ref_model_flops(ref_cfg, REF_SHAPES[shape], per_device=per_device,
                                       n_chips=n), (shape, n, per_device)


def test_roofline_terms_hand_counts():
    hw = HW(name="unit", peak_flops=1e12, hbm_bw=1e11, link_bw=1e10, hbm_bytes=2**30)
    t = roofline_terms({"flops": 3e9, "bytes": 2e8,
                        "collectives": {"all-reduce": 1e7, "all-to-all": 5e6, "total": 1.5e7}},
                       hw=hw)
    assert t["hlo_flops"] == 3e9 and t["hlo_bytes"] == 2e8
    assert t["collective_bytes"] == 1.5e7
    assert t["collective_breakdown"] == {"all-reduce": 1e7, "all-to-all": 5e6}
    assert t["t_compute"] == pytest.approx(3e-3, rel=1e-15)
    assert t["t_memory"] == pytest.approx(2e-3, rel=1e-15)
    assert t["t_collective"] == pytest.approx(1.5e-3, rel=1e-15)
    assert t["bottleneck"] == "t_compute" and t["roofline_fraction_compute"] == 1.0
    t = roofline_terms({"flops": 1e9, "bytes": 4e8, "collectives": {}}, hw=hw)
    assert t["bottleneck"] == "t_memory"
    assert t["roofline_fraction_compute"] == pytest.approx(0.25, rel=1e-15)
    assert t["collective_bytes"] == 0 and t["collective_breakdown"] == {}
    t = roofline_terms({}, hw=hw)
    assert t["roofline_fraction_compute"] == 0.0
    # the H100 row: datasheet peaks, the 80 GB card's memory
    assert H100_SXM.peak_flops == 989e12 and H100_SXM.hbm_bw == 3.35e12
    assert H100_SXM.link_bw == 50e9 and 80 * 10**9 <= H100_SXM.hbm_bytes < 81 * 2**30
    assert calibrate_flops_convention() == "global/n_chips"


def test_meta_costs_of_a_product_chain():
    """relu(a @ b) + c on meta tensors: 2 M K N flops; bytes read and
    written by the three ops; at most two M x N results live at once."""
    M, K, N = 64, 32, 48
    a = torch.empty((M, K), device="meta")
    b = torch.empty((K, N), device="meta")
    c = torch.empty((M, N), device="meta")
    costs = meta_costs(lambda: torch.relu(a @ b) + c)
    mn, f = M * N * 4, 4
    assert costs["flops"] == 2 * M * K * N
    assert costs["bytes"] == (M * K + K * N) * f + mn + (mn + mn) + (mn + mn + mn)
    assert costs["peak"] == 2 * mn
    # a view moves nothing, in place writes into a storage it did not make
    costs = meta_costs(lambda: c.t().mul_(2.0))
    assert costs["flops"] == 0 and costs["peak"] == 0
    assert costs["bytes"] == 2 * mn


def test_meta_costs_of_a_reduced_prefill():
    """The flops of a reduced qwen3's prefill on meta tensors: every product
    counted by hand (projections, the attention's two einsums over a
    1,024-key block, the MLP and the tied head)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    B, S = 1, 8
    bundle = build(cfg)
    params = bundle.init_params(None, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    costs = meta_costs(lambda: bundle.prefill_step(params, batch))
    T, d, H, KV, hd, f = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim, cfg.d_ff
    per_layer = (2 * T * d * H * hd + 2 * (2 * T * d * KV * hd)    # q, k, v
                 + 2 * (2 * B * H * S * 1024 * hd)                 # scores, p @ v
                 + 2 * T * H * hd * d                              # o
                 + 3 * (2 * T * d * f))                            # gate, up, down
    assert costs["flops"] == cfg.n_layers * per_layer + 2 * T * d * cfg.vocab_size
    logits = B * S * cfg.vocab_size * 4
    assert costs["peak"] >= logits and costs["bytes"] > costs["peak"]
