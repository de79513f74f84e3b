"""The LM testbed's blocks in the port (``repro_torch.models``) against the
reference's (``repro.models``) on the same inputs, in f32 on the CPU.

Every block is held within 1e-6 of the output's largest magnitude
(``_close``): the two frameworks sum the same products in other orders, so
an f32 output differs from the reference's by a few roundings of its
largest partial sums. ``rglru_scan`` runs the reference's associative scan
level by level and is held to the same bound at S <= 32. Parameters are the
reference's ``jax.random`` draws, carried across by
``convert.lm_params_from_arrays``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import attention, common, mlp, moe, rglru, ssm  # noqa: E402

BLOCK_TOL = 1e-6


def _close(got, want, tol=BLOCK_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= tol * scale, f"max |port - reference| {err:.3e} > {tol:g} x {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **overrides):
    """The reduced configuration in both packages, with the same overrides."""
    return (ref_reduced(ref_get_config(arch), **overrides),
            reduced(get_config(arch), **overrides))


def _params(jax_params):
    return lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")


# the reference compiled at XLA's lowest backend optimization: a third less
# compile time on one core, the same operations
FAST = {"xla_backend_optimization_level": 0}


def _jit(fn, *static):
    """The reference's function compiled once as a whole (op by op, each
    jnp call compiles on its own, which costs seconds a block)."""
    jitted = jax.jit(fn, static_argnames=static)

    def run(*args, **kwargs):
        dynamic = {k: v for k, v in kwargs.items() if k not in static}
        return jitted.lower(*args, **kwargs).compile(compiler_options=FAST)(*args, **dynamic)

    return run


def _init(fn, seed, rcfg):
    return _jit(fn, "cfg", "dtype")(jax.random.PRNGKey(seed), cfg=rcfg, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# common: rmsnorm, rope, activations
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(common.rmsnorm(_t(x), _t(scale), 1e-5),
           ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16)).astype(np.float32) + 2
    s, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    _close(common.layernorm(_t(x), _t(s), _t(b)),
           ref_common.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_reference(theta, batched_positions):
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 7, 3, 16
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = (rng.integers(0, 40_000, (B, S)) if batched_positions
           else np.arange(S)[None, :]).astype(np.int32)
    _close(common.apply_rope(_t(x), _t(pos), theta),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("name", ["swiglu", "gelu"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(common.act_fn(name)(_t(x)), ref_common.act_fn(name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["swiglu", "gelu"])
def test_act_fn_bfloat16_matches_reference_bit_for_bit(name):
    """At bf16 the reference's program rounds every op (and its constants) to
    bf16; the port's activations do the same, so they agree bit for bit
    (a fused ``F.silu``/``F.gelu`` rounds once and differs on ~40%)."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    got = common.act_fn(name)(_t(x).to(torch.bfloat16))
    want = _jit(ref_common.act_fn(name))(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_cast_casts_floating_leaves_only():
    tree = {"w": torch.ones(2), "rem": [(torch.zeros(1, dtype=torch.float64),
                                         torch.arange(3))]}
    out = common.cast(tree, torch.bfloat16)
    assert out["w"].dtype == out["rem"][0][0].dtype == torch.bfloat16
    assert out["rem"][0][1].dtype == torch.int64 and isinstance(out["rem"][0], tuple)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, B, Sq, Skv, H, KV, D):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32))


@pytest.mark.parametrize("S,block,window", [(16, 8, 0), (33, 8, 0), (32, 8, 8), (16, 32, 4)])
def test_attend_train_matches_reference(S, block, window):
    q, k, v = _qkv(np.random.default_rng(1), 2, S, S, 4, 2, 8)
    got = attention.attend_train(_t(q), _t(k), _t(v), causal=True, window=window,
                                 block_kv=block)
    want = _jit(ref_attn.attend_train, "causal", "window", "block_kv")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        block_kv=block)
    _close(got, want)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_attend_train_cross_and_offset_match_reference(q_offset):
    q, k, v = _qkv(np.random.default_rng(3), 2, 5, 19, 4, 1, 8)
    kw = dict(block_kv=8)
    _close(attention.attend_train(_t(q), _t(k), _t(v), causal=False, **kw),
           ref_attn.attend_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=False, **kw))
    _close(attention.attend_train(_t(q), _t(k), _t(v), q_offset=q_offset, **kw),
           ref_attn.attend_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_offset=q_offset, **kw))


@pytest.mark.parametrize("window", [0, 5])
def test_attend_decode_matches_reference(window):
    q, k, v = _qkv(np.random.default_rng(2), 3, 1, 12, 4, 2, 8)
    length = np.array([1, 7, 12], np.int32)
    got = attention.attend_decode(_t(q), _t(k), _t(v), length=_t(length), window=window)
    want = ref_attn.attend_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  length=jnp.asarray(length), window=window)
    _close(got, want)


def test_attn_block_decode_writes_cache_as_reference():
    rcfg, cfg = _cfgs("qwen3-0.6b")
    jp = _init(ref_attn.init_attn, 0, rcfg)
    p = _params(jp)
    rng = np.random.default_rng(4)
    B, L = 2, 6
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, L, cfg.n_kv_heads, 16)).astype(np.float32)
              for _ in range(2))
    pos, length = 3, np.full((B,), 4, np.int32)
    want, (wk, wv) = _jit(ref_attn.attn_block, "cfg")(
        jp, jnp.asarray(x), cfg=rcfg, positions=jnp.asarray([[pos]]),
        kv_cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_length=jnp.asarray(length),
        cache_index=jnp.asarray(pos))
    cache = (_t(kc), _t(vc))
    got, (gk, gv) = attention.attn_block(
        p, _t(x), cfg, positions=torch.tensor([[pos]]), kv_cache=cache,
        cache_length=_t(length), cache_index=pos)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    assert gk is cache[0] and gv is cache[1]          # written in place


# ---------------------------------------------------------------------------
# SSD (mamba2)
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B, S, H, P, N, lo=0.7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(lo, 0.999, (B, S, H)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(16, 4), (17, 4), (32, 8), (8, 16)])
def test_ssd_chunked_matches_reference(S, chunk):
    arrs = _ssd_inputs(0, 2, S, 3, 4, 5)
    h0 = np.random.default_rng(9).standard_normal((2, 3, 4, 5)).astype(np.float32)
    for h_init in (None, h0):
        got, g_h = ssm.ssd_chunked(*map(_t, arrs), chunk,
                                   h_init=None if h_init is None else _t(h_init))
        want, w_h = _jit(ref_ssm.ssd_chunked, "chunk")(*map(jnp.asarray, arrs), chunk=chunk,
                                        h_init=None if h_init is None else jnp.asarray(h_init))
        _close(got, want)
        _close(g_h, w_h)


@pytest.mark.parametrize("S,chunk", [(16, 4), (17, 4), (32, 8), (8, 16)])
def test_ssd_reference_matches_reference_and_chunked(S, chunk):
    """The port's oracle equals the reference's; the port's chunked form
    equals its oracle (the duality) at the reference's own 1e-4."""
    arrs = _ssd_inputs(0, 2, S, 3, 4, 5)
    seq = ssm.ssd_reference(*map(_t, arrs))
    _close(seq, jax.jit(ref_ssm.ssd_reference)(*map(jnp.asarray, arrs)))
    got, _ = ssm.ssd_chunked(*map(_t, arrs), chunk)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [1, 8, 21])
def test_mamba_block_matches_reference(S):
    rcfg, cfg = _cfgs("mamba2-780m")
    jp = _init(ref_ssm.init_mamba, 1, rcfg)
    p = _params(jp)
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want_cache = ref_ssm.init_mamba_cache(rcfg, 2)
    rng = np.random.default_rng(6)      # a non-zero carried state for decode
    want_cache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                  for k, v in want_cache.items()}
    cache = {k: _t(v) for k, v in want_cache.items()}
    ref_block = _jit(ref_ssm.mamba_block, "cfg")
    want, want_new = ref_block(jp, jnp.asarray(x), cfg=rcfg, cache=want_cache)
    got, got_new = ssm.mamba_block(p, _t(x), cfg, cache=cache)
    _close(got, want)
    assert got_new is cache
    for name in want_new:
        _close(got_new[name], want_new[name])
    no_cache, none = ssm.mamba_block(p, _t(x), cfg)
    assert none is None
    _close(no_cache, ref_block(jp, jnp.asarray(x), cfg=rcfg)[0])


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 7, 32])
def test_rglru_scan_matches_reference(S):
    rng = np.random.default_rng(3)
    B, W = 2, 5
    a = rng.uniform(0.5, 0.99, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    for h in (None, h0):
        got = rglru.rglru_scan(_t(a), _t(b), None if h is None else _t(h))
        want = jax.jit(ref_rglru.rglru_scan)(jnp.asarray(a), jnp.asarray(b),
                                             None if h is None else jnp.asarray(h))
        _close(got, want)
    # and the sequential recurrence it stands for
    h, seq = h0.astype(np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(rglru.rglru_scan(_t(a), _t(b), _t(h0)).numpy(),
                               np.stack(seq, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1, 9])
def test_rglru_block_matches_reference(S):
    rcfg, cfg = _cfgs("recurrentgemma-9b")
    jp = _init(ref_rglru.init_rglru, 2, rcfg)
    p = _params(jp)
    x = np.random.default_rng(7).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    rng = np.random.default_rng(8)
    want_cache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                  for k, v in ref_rglru.init_rglru_cache(rcfg, 2).items()}
    cache = {k: _t(v) for k, v in want_cache.items()}
    want, want_new = _jit(ref_rglru.rglru_block, "cfg")(jp, jnp.asarray(x), cfg=rcfg,
                                                        cache=want_cache)
    got, got_new = rglru.rglru_block(p, _t(x), cfg, cache=cache)
    _close(got, want)
    for name in want_new:
        _close(got_new[name], want_new[name])


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_mlp_block_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    jp = _init(ref_mlp.init_mlp, 3, rcfg)
    x = np.random.default_rng(9).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(mlp.mlp_block(_params(jp), _t(x), cfg), ref_mlp.mlp_block(jp, jnp.asarray(x), rcfg))


def test_top_k_breaks_ties_toward_lower_index():
    x = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]],
                 np.float32)
    for k in (1, 2, 3):
        gv, gi = moe.top_k(_t(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


MOE_CASES = {
    "phi-random": ("phi3.5-moe-42b-a6.6b", {}, None),
    "phi-drop": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.25}, None),
    "phi-tied": ("phi3.5-moe-42b-a6.6b", {}, "zero-router"),
    "llama4-shared-tied": ("llama4-maverick-400b-a17b", {}, "zero-router"),
    "llama4-shared": ("llama4-maverick-400b-a17b", {}, None),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(case):
    """The auto path: output and aux loss. ``phi-drop`` sends 64
    assignments to 4 experts of capacity 8 and ``*-tied`` zeroes the router
    (every probability 1/E, so ``top_k`` takes experts 0..k-1 for every
    token and all past capacity are dropped): the port must keep and drop
    the same assignments."""
    arch, overrides, router = MOE_CASES[case]
    rcfg, cfg = _cfgs(arch, **overrides)
    jp = _init(ref_moe.init_moe, 4, rcfg)
    if router == "zero-router":
        jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    x = np.random.default_rng(10).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = _jit(ref_moe._moe_block_auto, "cfg")(jp, jnp.asarray(x), cfg=rcfg)
    got, got_aux = moe.moe_block(_params(jp), _t(x), cfg)
    _close(got, want)
    _close(got_aux, want_aux)
    if router == "zero-router":
        # only the first capacity tokens of experts 0..k-1 got through
        T, k = 32, rcfg.experts_per_token
        cap = max(8, int(round(T * k * rcfg.capacity_factor / rcfg.n_experts + 0.5)))
        assert cap < T
        routed = got.reshape(T, -1)
        if "shared" not in jp:
            assert float(routed[cap:].abs().max()) == 0.0
            assert float(routed[:cap].abs().min(dim=-1).values.max()) > 0.0


def test_moe_capacity_sufficient_identity():
    """With capacity >= T*k and identical experts the MoE is one dense MLP,
    as the reference's own test holds it."""
    rcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    jp = _init(ref_moe.init_moe, 1, rcfg)
    p = _params(jp)
    for name in ("w_gate", "w_up", "w_down"):
        p["experts"][name] = p["experts"][name][:1].expand_as(p["experts"][name]).contiguous()
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator().manual_seed(0))
    y, _ = moe.moe_block(p, x, cfg)
    dense = {k: p["experts"][k][0] for k in ("w_gate", "w_up", "w_down")}
    np.testing.assert_allclose(y.numpy(), mlp.mlp_block(dense, x, cfg).numpy(),
                               rtol=1e-5, atol=1e-5)
