"""The LM's loss and gradients in the port against the reference, on the
CPU: ``cross_entropy`` and ``models.api.loss_and_grads`` on six reduced
architectures, from the same ``jax.random`` parameters and numpy batches
(helpers of ``test_torch_lm_train.py``).

Bound: each gradient leaf within 1e-5 of its largest |g| (measured 9e-7 to
4.6e-6); the losses within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_lm import _compiled, _jax_params  # noqa: E402
from test_torch_lm_train import _batch, _cfgs, _rel, _torch_batch  # noqa: E402

from repro.models import api as ref_api  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

GRAD_ARCHS = ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "mamba2-780m", "recurrentgemma-9b",
              "whisper-medium", "pixtral-12b"]
GRAD_TOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    """Mean CE over the valid labels, rows with every label ignored among
    them; a batch with every label ignored gives 0 in both. The port's
    gather of the gold logit and the reference's masked sum give the same
    bits."""
    rng = np.random.default_rng(0)
    logits = np.asarray(jnp.asarray(rng.standard_normal((3, 5, 37)) * 4, dtype))
    labels = rng.integers(0, 37, (3, 5)).astype(np.int32)
    labels[1, :] = -1
    labels[2, 3] = -1
    got = api.cross_entropy(lm_params_from_arrays(logits, device="cpu"), torch.from_numpy(labels))
    want = float(ref_api.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    none = np.full_like(labels, -1)
    assert float(api.cross_entropy(lm_params_from_arrays(logits, device="cpu"),
                                   torch.from_numpy(none))) == 0.0
    assert float(ref_api.cross_entropy(jnp.asarray(logits), jnp.asarray(none))) == 0.0
    x = torch.from_numpy(np.array(logits, np.float32))
    safe = torch.from_numpy(np.maximum(labels, 0)).long()
    gathered = torch.gather(x, -1, safe[..., None])[..., 0]
    masked = torch.where(torch.arange(37) == safe[..., None], x, 0.0).sum(-1)
    assert torch.equal(gathered, masked)


def _ref_loss(rcfg):
    from repro.models.transformer import lm_forward as ref_lm_forward

    def loss(params, batch):
        extra = {k: batch[k] for k in ("encoder_frames", "prefix_embeds") if k in batch}
        logits, aux = ref_lm_forward(params, batch["tokens"], rcfg, **extra)
        ce = ref_api.cross_entropy(logits, batch["labels"])
        return ce + ref_api.AUX_COEF * aux, (ce, aux)

    return loss


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    """The loss (cross entropy plus the aux loss, whisper's frames and
    pixtral's patches injected from numpy) and its gradient on every leaf,
    within 1e-5 of the leaf's largest |g|; phi3.5-moe's aux loss is > 0."""
    rcfg, cfg = _cfgs(arch)
    params = _jax_params(ref_build(rcfg), 0)
    batch = _batch(cfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    fn = jax.value_and_grad(_ref_loss(rcfg), has_aux=True)
    (total, (ce, aux)), grads = _compiled(fn, params, jbatch)(params, jbatch)
    port = lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    t, c, a, g = api.loss_and_grads(cfg, port, _torch_batch(batch))
    assert abs(float(t) - float(total)) <= 1e-6 * float(total)
    assert abs(float(c) - float(ce)) <= 1e-6 * float(ce)
    assert abs(float(a) - float(aux)) <= 1e-5 * max(float(aux), 1e-30)
    if arch == "phi3.5-moe-42b-a6.6b":
        assert float(a) > 0
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    got = tree_leaves(g)
    assert len(got) == len(flat)
    for (path, want), leaf in zip(flat, got):
        assert leaf.dtype == torch.float32
        assert _rel(leaf, want) <= GRAD_TOL, jax.tree_util.keystr(path)
    # the caller's tree is untouched and needs no gradient
    assert all(not p.requires_grad and p.grad is None for p in tree_leaves(port))
