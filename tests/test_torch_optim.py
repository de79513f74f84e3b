"""The port's optimizer pieces (``repro_torch.optim``) and token stream
(``repro_torch.data.TokenStream``) against the reference's, on the CPU.

Bounds: ``adamw_update`` on random trees (f32 and bf16 parameters, weight
decay and clipping on and off, steps 1-5) within 1e-6 of each leaf's
largest magnitude (parameters and moments); the schedules within one f32
ulp at every step from 0 to total + 5; ``global_norm`` and the clip within
1e-6 relative; ``quantize``, ``dequantize`` and ``ef_compress_update`` bit
for bit, exact .5 ties included; ``TokenStream`` the same bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import TokenStream as RefTokenStream  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import clip as ref_clip  # noqa: E402
from repro.optim import compress as ref_compress  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.convert import (lm_params_from_arrays, opt_state_from_arrays,  # noqa: E402
                                 opt_state_to_arrays)
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

TOL = 1e-6


def _tree(rng, dtype):
    """A random parameter tree shaped like an LM's: nested dicts (keys not
    in sorted order), a list, a stacked leaf and a 1-D one."""
    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree = {"z_head": a(6, 5), "embed": {"tokens": a(11, 6, scale=0.02)},
            "layers": {"groups": {"p0_attn": {"wq": a(2, 6, 8), "ln": a(2, 6, scale=0.1)}},
                       "rem": [{"w": a(6, 6)}]}, "final_norm_scale": a(6, scale=0.1)}
    return jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, dtype)), tree)


def _rel(got, want) -> float:
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,clip_norm", [(0.1, 1.0), (0.0, 0.0), (0.1, 0.0), (0.0, 0.5)])
def test_adamw_update_matches_reference(dtype, wd, clip_norm):
    """Five steps from the same trees and gradients (a fresh random gradient
    each step, large enough that the clip bites), lr from the WSD schedule
    as ``build`` makes it: parameters and moments within 1e-6 of each leaf's
    largest magnitude, the step an int32 counting 1-5."""
    rng = np.random.default_rng(7)
    params = _tree(rng, getattr(jnp, dtype))
    ref_p, ref_s = params, ref_adamw.adamw_init(params)
    port_p = lm_params_from_arrays(params, device="cpu")
    port_s = optim.adamw_init(port_p)
    sched = optim.wsd_schedule(peak=1e-2, warmup=2, total=20)
    ref_sched = ref_schedule.wsd_schedule(peak=1e-2, warmup=2, total=20)
    for step in range(1, 6):
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(jnp.asarray(rng.standard_normal(p.shape) * 3, p.dtype)), params)
        ref_p, ref_s = ref_adamw.adamw_update(ref_p, grads, ref_s, lr=ref_sched(step), wd=wd,
                                              clip_norm=clip_norm)
        port_p, port_s = optim.adamw_update(port_p, lm_params_from_arrays(grads, device="cpu"),
                                            port_s, lr=sched(step), wd=wd, clip_norm=clip_norm)
        assert port_s.step.dtype == torch.int32 and int(port_s.step) == step
        for got, want in zip(tree_leaves(port_p), jax.tree_util.tree_leaves(ref_p)):
            assert got.dtype == getattr(torch, dtype)
            assert _rel(got, want) <= TOL
        for tree, ref_tree in ((port_s.m, ref_s.m), (port_s.v, ref_s.v)):
            for got, want in zip(tree_leaves(tree), jax.tree_util.tree_leaves(ref_tree)):
                assert got.dtype == torch.float32
                assert _rel(got, want) <= TOL


def test_adamw_update_is_pure():
    """The caller's trees are never written: a retried or rewound step
    starts from what it held."""
    params = lm_params_from_arrays(_tree(np.random.default_rng(1), jnp.float32), device="cpu")
    state = optim.adamw_init(params)
    grads = {k: v for k, v in params.items()}
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(state)]
    new_p, new_s = optim.adamw_update(params, grads, state, lr=0.1)
    after = tree_leaves(params) + tree_leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(tree_leaves(new_p)[0], tree_leaves(params)[0])
    assert isinstance(new_s, optim.AdamWState) and int(new_s.step) == 1


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.adamw_init(params)
    for _ in range(200):
        params, state = optim.adamw_update(params, {"w": 2 * params["w"]}, state, lr=0.05,
                                           wd=0.0)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_state_crosses_packages():
    """``convert.opt_state_*``: the reference's state into the port and
    back, leaf for leaf and bit for bit, the step an int32."""
    params = _tree(np.random.default_rng(2), jnp.bfloat16)
    ref_p, ref_s = ref_adamw.adamw_update(params, params, ref_adamw.adamw_init(params), lr=0.1)
    arrays = jax.tree_util.tree_map(np.asarray, ref_s)
    port = opt_state_from_arrays(arrays, device="cpu")
    assert isinstance(port, optim.AdamWState)
    assert port.step.dtype == torch.int32 and port.step.shape == () and int(port.step) == 1
    back = ref_adamw.AdamWState(*opt_state_to_arrays(port))
    flat, treedef = jax.tree_util.tree_flatten(arrays)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,kw", [
    ("wsd", dict(peak=3e-4, warmup=100, total=10_000, decay_frac=0.1)),
    ("wsd", dict(peak=1.0, warmup=10, total=100, decay_frac=0.2)),
    ("wsd", dict(peak=1e-3, warmup=1, total=8, decay_frac=0.1, floor=1e-5)),
    ("cosine", dict(peak=1.0, warmup=5, total=50)),
    ("cosine", dict(peak=3e-3, warmup=0, total=40, floor_frac=0.0)),
    ("cosine", dict(peak=3e-4, warmup=100, total=2_000)),
])
def test_schedules_match_reference(kind, kw):
    """Every step from 0 to total + 5, as an int and as an int32 tensor,
    against the reference run eagerly and under ``jax.jit`` (as its
    ``train_step`` runs it): bit for bit where no transcendental enters (the
    warm-up, WSD's plateau; lr exactly 0 at step 0); elsewhere within 1e-6
    of the peak. XLA's f32 ``exp`` and ``cos`` differ from torch's by one
    ulp on 1-9% of inputs, and the products and the 1 + cos after them
    carry that to up to 5 ulps eagerly (9 under jit, where XLA fuses the
    arithmetic), 5e-7 of the value."""
    ref = getattr(ref_schedule, f"{kind}_schedule")(**kw)
    ref_jit = jax.jit(ref)
    port = getattr(optim, f"{kind}_schedule")(**kw)
    peak, warmup, total = kw["peak"], kw["warmup"], kw["total"]
    stable_end = total - max(1, int(total * kw.get("decay_frac", 0.1)))
    for step in range(0, total + 6):
        got = port(step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert torch.equal(got, port(torch.tensor(step, dtype=torch.int32)))
        want = np.asarray(ref(step), np.float32)
        if step < warmup or (kind == "wsd" and step < stable_end):
            assert got.numpy().tobytes() == want.tobytes(), step
        for w in (want, np.asarray(ref_jit(step), np.float32)):
            assert abs(float(got) - float(w)) <= 1e-6 * peak, (step, float(got), float(w))
    if warmup:
        assert float(port(0)) == 0.0


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    for dtype in (jnp.float32, jnp.bfloat16):
        tree = _tree(rng, dtype)
        port = lm_params_from_arrays(tree, device="cpu")
        want = float(ref_clip.global_norm(tree))
        assert abs(float(optim.global_norm(port)) - want) <= TOL * want
        for max_norm in (0.5, 1e6):
            got, norm = optim.clip_by_global_norm(port, max_norm)
            ref_got, ref_norm = ref_clip.clip_by_global_norm(tree, max_norm)
            assert abs(float(norm) - float(ref_norm)) <= TOL * float(ref_norm)
            for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref_got)):
                assert _rel(g, w) <= TOL
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def _ties(rng):
    """Values whose x / scale lands exactly on .5 (scale = 127 / 127 = 1):
    the rounding mode shows."""
    x = rng.standard_normal(300).astype(np.float32) * 40
    x[:8] = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]
    return x


def _bits(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("case", ["ties", "normal", "zeros", "tiny"])
def test_quantize_and_error_feedback_bit_for_bit(case):
    rng = np.random.default_rng(4)
    x = {"ties": _ties(rng), "normal": rng.standard_normal(1000).astype(np.float32),
         "zeros": np.zeros(16, np.float32),
         "tiny": (rng.standard_normal(64) * 1e-20).astype(np.float32)}[case]
    q, s = optim.quantize(torch.from_numpy(x))
    rq, rs = ref_compress.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    np.testing.assert_array_equal(_bits(s), _bits(rs))
    np.testing.assert_array_equal(_bits(optim.dequantize(q, s)),
                                  _bits(ref_compress.dequantize(rq, rs)))
    if case == "ties":      # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert _bits(q)[2:8].tolist() == [0, 2, 2, 0, -2, 126]
    err = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    for _ in range(3):
        out = optim.ef_compress_update(torch.from_numpy(x), torch.from_numpy(err))
        ref = ref_compress.ef_compress_update(jnp.asarray(x), jnp.asarray(err))
        for got, want in zip(out, ref):
            assert got.dtype == (torch.int8 if want.dtype == jnp.int8 else torch.float32)
            np.testing.assert_array_equal(_bits(got), _bits(want))
        # the error-feedback ledger: decoded + new error = gradient + old error
        np.testing.assert_allclose(_bits(out[2]) + _bits(out[3]), x + err, rtol=1e-5, atol=1e-6)
        err = _bits(out[3])


def test_optim_exports_the_reference_names():
    import repro.optim as ref_optim

    assert sorted(optim.__all__) == sorted(ref_optim.__all__)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(100, 2, 8, 3), (256, 4, 32, 1),
                                                  (151_936, 2, 64, 0)])
def test_tokenstream_same_bytes_and_resumes(vocab, batch, seq, seed):
    ref = RefTokenStream(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed)
    port = TokenStream(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed)
    for step in (0, 1, 5, 1000):
        got, want = port.batch_at(step), ref.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == np.int32
            assert got[key].tobytes() == want[key].tobytes()
    it = iter(port)
    for _ in range(3):
        next(it)
    resumed = TokenStream(vocab_size=vocab, batch=batch, seq_len=seq).restore(port.state())
    assert resumed.state() == {"seed": seed, "step": 3}
    assert next(iter(resumed))["tokens"].tobytes() == ref.batch_at(3)["tokens"].tobytes()
    b = port.batch_at(4)
    assert b["tokens"].min() >= 1 and b["tokens"].max() < vocab
    assert (b["labels"][:, -1] == -1).all()
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
