"""The LM testbed's train steps in the port against the reference, on the
CPU: ``train_step`` (AdamW on the WSD schedule), microbatches, remat and
bf16. The module's helpers serve ``test_torch_lm_grads.py`` and
``test_torch_lm_train_driver.py`` too.

Both packages start from the same ``jax.random`` parameters
(``convert.lm_params_from_arrays``) and batches (numpy, from a seed); the
reference is compiled at XLA's lowest optimization (at bf16 also without
excess precision), as in ``test_torch_lm.py``.

Bounds (f32, ``launch.train``'s, which ``chip_smoke.py`` also holds the
card to against the CPU): losses within 1e-5 relative; step 0's first
moments, 0.1 x the clipped gradients, within 1e-5 of each leaf's largest
magnitude; after each later step the moments within 1e-3 of each leaf's
largest magnitude (measured up to 3.7e-5 after 4 steps), every parameter
within 2 lr and all but 1% of the elements within 1e-6
(``launch.train.step_gaps``): AdamW's first steps move an element by about
lr whatever the size of its gradient, so an element whose gradient is at
rounding level may step the other way, 2 lr apart; measured here up to
0.025 lr on a few dozen of 72,752-254,784 elements (on an H100 against the
CPU, llama4's reduced MoE: 0.48 lr, 0.16% of the elements). Step 0 has lr
0 (the WSD warm-up's first value) and leaves every parameter unchanged, bit
for bit, in both packages. bf16: ``test_torch_lm_bf16_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_lm import EXACT_BF16, FAST, _compiled, _jax_params  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api, build  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

LR = train.AGAINST_LR           # reached at step 1 (total_steps 50: warm-up 1)
B, S = 2, 16


def _batch(cfg, B=B, S=S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.is_encdec:
        out["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _cfgs(arch, **kw):
    return ref_reduced(ref_get_config(arch), **kw), configs.reduced(configs.get_config(arch), **kw)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _rel(got, want) -> float:
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

class _RefRuns:
    """The reference's train steps from ``_jax_params``, computed once per
    (arch, options): the losses, aux losses and (params, moments) after
    each step as arrays."""

    def __init__(self):
        self._cache = {}

    def __call__(self, arch, steps=4, dtype="float32", microbatches=1, B=B, **cfg_kw):
        key = (arch, steps, dtype, microbatches, B, tuple(sorted(cfg_kw.items())))
        if key not in self._cache:
            self._cache[key] = self._run(arch, steps, dtype, microbatches, B, cfg_kw)
        return self._cache[key]

    @staticmethod
    def _run(arch, steps, dtype, microbatches, Bsz, cfg_kw):
        rcfg, _ = _cfgs(arch, dtype=dtype, **cfg_kw)
        bundle = ref_build(rcfg, lr=LR, total_steps=50, microbatches=microbatches)
        params = _jax_params(bundle, 0)
        batch = _batch(rcfg, B=Bsz)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        opt = bundle.init_opt(params)
        options = FAST if dtype == "float32" else EXACT_BF16
        step_fn = _compiled(bundle.train_step, params, opt, jbatch, 0, options=options)
        out = {"start": jax.tree_util.tree_map(np.asarray, params), "batch": batch,
               "losses": [], "aux": [], "params": [], "moments": []}
        for i in range(steps):
            params, opt, m = step_fn(params, opt, jbatch, i)
            out["losses"].append(float(m["loss"]))
            out["aux"].append(float(m["aux"]))
            out["params"].append(_leaves(params))
            out["moments"].append(_leaves(opt.m) + _leaves(opt.v))
        return out


@pytest.fixture(scope="module")
def ref_runs():
    return _RefRuns()


def _port_run(ref, arch, steps, dtype="float32", microbatches=1, **cfg_kw):
    _, cfg = _cfgs(arch, dtype=dtype, **cfg_kw)
    bundle = build(cfg, lr=LR, total_steps=50, microbatches=microbatches)
    params = lm_params_from_arrays(ref["start"], device="cpu")
    opt = bundle.init_opt(params)
    batch = _torch_batch(ref["batch"])
    out = {"losses": [], "aux": [], "params": [], "moments": []}
    for i in range(steps):
        params, opt, m = bundle.train_step(params, opt, batch, i)
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux"]))
        out["params"].append(tree_leaves(params))
        out["moments"].append(tree_leaves(opt.m) + tree_leaves(opt.v))
    out["opt"] = opt
    return out


def _assert_steps_match(port, ref):
    """Losses within ``LOSS_TOL``; step 0's first moments (the clipped
    gradients) within ``GRAD_TOL``; each later step within ``step_gaps``."""
    for i, (got, want) in enumerate(zip(port["losses"], ref["losses"])):
        assert abs(got - want) <= train.LOSS_TOL * abs(want), (i, got, want)
    n = len(port["params"][0])
    assert train.grad_gap(port["moments"][0][:n], ref["moments"][0][:n]) <= train.GRAD_TOL
    for i in range(1, len(ref["losses"])):
        gaps = train.step_gaps(port["params"][i], port["moments"][i], ref["params"][i],
                               ref["moments"][i], LR)
        assert gaps["within"], (i, gaps)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_train_steps_match_reference(ref_runs, arch):
    """Steps 0-3 from the same state: losses, aux losses, parameters and
    moments within the module's bounds; step 0 leaves every parameter bit
    for bit unchanged, in the reference and in the port, and the step is
    an int32 that counts 4."""
    ref = ref_runs(arch)
    port = _port_run(ref, arch, 4)
    _assert_steps_match(port, ref)
    for got, want in zip(port["aux"], ref["aux"]):
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30)
    start = _leaves(ref["start"])
    for got, want, s in zip(port["params"][0], ref["params"][0], start):
        np.testing.assert_array_equal(got.numpy(), s)
        np.testing.assert_array_equal(want, s)
    moved = [float(np.abs(got.numpy() - s).max()) for got, s in zip(port["params"][1], start)]
    assert max(moved) > 0.5 * LR       # step 1 moves at the peak lr
    assert port["opt"].step.dtype == torch.int32 and int(port["opt"].step) == 4


def test_microbatches_match_one_batch_and_reference(ref_runs):
    """Four microbatches against one (the reference's own bound: losses
    1e-5 relative, parameters atol 1e-4; moments within 1e-4 of their
    largest magnitude, so the accumulated gradient is held too), and the
    port's four against the reference's four within the module's bounds,
    over steps 0-1 at batch 8."""
    ref4 = ref_runs("qwen3-0.6b", steps=2, microbatches=4, B=8)
    one = _port_run(ref4, "qwen3-0.6b", 2, microbatches=1)
    four = _port_run(ref4, "qwen3-0.6b", 2, microbatches=4)
    for i in range(2):
        assert abs(one["losses"][i] - four["losses"][i]) <= 1e-5 * abs(one["losses"][i])
        for a, b in zip(one["params"][i], four["params"][i]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
        for a, b in zip(one["moments"][i], four["moments"][i]):
            assert _rel(b, a.numpy()) <= 1e-4
    _assert_steps_match(four, ref4)


def test_microbatches_average_the_moe_aux_loss():
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    bundle = build(cfg, microbatches=2)
    params = bundle.init_params(torch.Generator().manual_seed(1), device="cpu")
    _, _, m = bundle.train_step(params, bundle.init_opt(params), _torch_batch(_batch(cfg, B=4)), 0)
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    t, c, a, _ = api.loss_and_grads(cfg, params, _torch_batch(_batch(cfg, B=4)), 2)
    assert abs(float(t) - (float(c) + api.AUX_COEF * float(a))) <= 1e-6 * float(t)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "whisper-medium",
                                  "recurrentgemma-9b"])
def test_remat_changes_no_bit(arch):
    """Three steps with ``remat`` off, on with ``"nothing"`` and on with
    ``"save_block_outputs"``: parameters, moments and losses bit for bit;
    under ``no_grad`` (serving) no group is wrapped."""
    runs = []
    for kw in ({}, {"remat": True}, {"remat": True, "remat_policy": "save_block_outputs"}):
        _, cfg = _cfgs(arch, **kw)
        bundle = build(cfg, lr=LR, total_steps=50)
        params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
        opt = bundle.init_opt(params)
        batch = _torch_batch(_batch(cfg))
        losses = []
        for i in range(3):
            params, opt, m = bundle.train_step(params, opt, batch, i)
            losses.append(float(m["loss"]))
        runs.append((losses, tree_leaves(params) + tree_leaves(opt.m) + tree_leaves(opt.v)))
    for losses, leaves in runs[1:]:
        assert losses == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][1]))


def test_remat_wraps_groups_only_with_gradients(monkeypatch):
    from repro_torch.models import transformer

    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, cfg = _cfgs("qwen3-0.6b", remat=True)
    bundle = build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _torch_batch(_batch(cfg))
    with torch.no_grad():
        bundle.prefill_step(params, batch)
    assert calls == []
    api.loss_and_grads(cfg, params, batch)
    assert len(calls) == cfg.n_layers
    with pytest.raises(ValueError, match="remat_policy"):
        transformer.remat(lambda x: x, "everything")


@pytest.mark.parametrize("policy", ["nothing", "save_block_outputs"])
def test_remat_matches_reference_with_remat(ref_runs, policy):
    """The reference's ``jax.checkpoint`` of each group against the port's
    ``torch.utils.checkpoint``: three steps within the module's bounds."""
    kw = {"remat": True, "remat_policy": policy}
    ref = ref_runs("qwen3-0.6b", steps=3, **kw)
    _assert_steps_match(_port_run(ref, "qwen3-0.6b", 3, **kw), ref)
