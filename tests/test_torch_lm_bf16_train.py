"""The LM's train steps at bf16 in the port against the reference, on the
CPU: reduced qwen3 with bf16 parameters (f32 moments and update) from the
same ``jax.random`` weights, the reference compiled without XLA's excess
precision (helpers of ``test_torch_lm.py`` and ``test_torch_lm_train.py``),
and a bound that sees a step done wrong.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_lm import EXACT_BF16, _compiled, _jax_params  # noqa: E402
from test_torch_lm_train import _batch, _cfgs, _torch_batch  # noqa: E402

from repro.models import build as ref_build  # noqa: E402

from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import api, build  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402


BF16_LR = 1e-2
BF16_FRAC = 0.01        # the share of parameters allowed to differ after step 1
BF16_LOSS = 1e-3


def _bf16_run(update=None, steps=3):
    """Reduced qwen3 at bf16 from the reference's weights: steps 0-2 at
    ``BF16_LR``, each step's loss and parameters; ``update`` in place of the
    port's AdamW."""
    rcfg, cfg = _cfgs("qwen3-0.6b", dtype="bfloat16")
    rbundle = ref_build(rcfg, lr=BF16_LR, total_steps=50)
    params = _jax_params(rbundle, 0)
    batch = _batch(cfg)
    bundle = build(cfg, lr=BF16_LR, total_steps=50)
    p = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    opt = bundle.init_opt(p)
    losses, trees = [], []
    real = api.adamw_update
    if update is not None:
        api.adamw_update = update
    try:
        for i in range(steps):
            p, opt, m = bundle.train_step(p, opt, _torch_batch(batch), i)
            losses.append(float(m["loss"]))
            trees.append(tree_leaves(p))
    finally:
        api.adamw_update = real
    return params, batch, losses, trees


@pytest.fixture(scope="module")
def bf16_reference():
    rcfg, _ = _cfgs("qwen3-0.6b", dtype="bfloat16")
    bundle = ref_build(rcfg, lr=BF16_LR, total_steps=50)
    params = _jax_params(bundle, 0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, _batch(rcfg))
    opt = bundle.init_opt(params)
    step = _compiled(bundle.train_step, params, opt, jbatch, 0, options=EXACT_BF16)
    losses, trees = [], []
    for i in range(3):
        params, opt, m = step(params, opt, jbatch, i)
        losses.append(float(m["loss"]))
        trees.append([np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(params)])
    return losses, trees


def _differ(trees, ref_trees, i) -> float:
    n = sum(x.size for x in ref_trees[i])
    return sum(int((got.float().numpy() != want).sum())
               for got, want in zip(trees[i], ref_trees[i])) / n


def test_bf16_train_steps_match_reference(bf16_reference):
    """bf16 parameters, f32 moments and update, steps 0-2 at lr 1e-2. The
    bf16 gradients of the two packages differ by ~1% of a leaf's largest
    |g| (each op rounded to bf16, sums in another order), and from step 2
    on AdamW turns that into different roundings of ~10% of the
    parameters; step 1's update is the sign of a gradient that is the same
    in both steps 0 and 1, so it moves both packages alike. Bounds: step 0
    bit for bit; after step 1 at most 1% of the parameters differ (measured
    0.23%); every loss within 1e-3 relative (measured 6.8e-5)."""
    ref_losses, ref_trees = bf16_reference
    params, _, losses, trees = _bf16_run()
    assert all(t.dtype == torch.bfloat16 for t in trees[-1])
    assert _differ(trees, ref_trees, 0) == 0.0
    assert _differ(trees, ref_trees, 1) <= BF16_FRAC
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= BF16_LOSS * want


def _update_in_bf16(params, grads, state, *, lr, wd=0.1, b1=0.9, b2=0.95, eps=1e-8,
                    clip_norm=1.0):
    """AdamW done wrong: the moments in f32, the rest of the update in the
    parameters' dtype."""
    from repro_torch.core.constraints import tree_unflatten
    from repro_torch.optim.clip import clip_by_global_norm

    grads, _ = clip_by_global_norm({k: v for k, v in grads.items()}, clip_norm)
    step = state.step + 1
    c1, c2 = 1.0 - torch.pow(b1, step.float()), 1.0 - torch.pow(b2, step.float())
    out = []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        g = g.float()
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * (g * g)
        delta = ((m / c1) / (torch.sqrt(v / c2) + eps)).to(p.dtype) + wd * p
        out.append((p - lr.to(p.dtype) * delta, m, v))
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step, tree_unflatten(params, [o[1] for o in out]),
                       tree_unflatten(params, [o[2] for o in out])))


def _no_weight_decay(params, grads, state, *, lr, wd=0.1, **kw):
    from repro_torch.optim.adamw import adamw_update

    return adamw_update(params, grads, state, lr=lr, wd=0.0, **kw)


@pytest.mark.parametrize("wrong", ["update in bf16", "no weight decay"])
def test_bf16_bound_sees_a_step_done_wrong(bf16_reference, wrong):
    """The bound on step 1 sees each wrong step: more than 1% of the
    parameters differ (measured 3.8% and 17.8%)."""
    _, ref_trees = bf16_reference
    update = {"update in bf16": _update_in_bf16, "no weight decay": _no_weight_decay}[wrong]
    _, _, _, trees = _bf16_run(update, steps=2)
    assert _differ(trees, ref_trees, 1) > BF16_FRAC
