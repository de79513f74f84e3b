"""The LM testbed's models and serving path in the port against the
reference, in f32 on the CPU: all ten reduced architectures, from the same
``jax.random`` parameters carried across by ``convert.lm_params_from_arrays``.

Bounds, each relative to the output's largest magnitude: ``lm_forward``'s
logits and each of 8 ``lm_decode`` steps within 1e-5 (two layers of f32
sums in another order); greedy tokens identical wherever the reference's
top-two margin exceeds that bound. The port's decode against its own
prefill (qwen3, mamba2, recurrentgemma's ring buffer past its window) is
held within 1e-4: the two paths are different algorithms (the online
softmax over a cache against the chunked one, the SSD recurrence against
its chunked form, the RG-LRU step against the scan).

At bf16 (qwen3 and mamba2, the two archs the port serves at full width),
the reference is compiled without XLA's excess precision, so that it rounds
every op to bf16 as its program says, as the port's eager ops do. Measured
(one thread, jax's x64 on as ``conftest.py`` sets it): the 8 decode steps
agree bit for bit, the prefill logits within 1.5e-4 (qwen3) and 3.2e-5
(mamba2) of the largest magnitude, a few bf16 roundings flipped by f32 sums
in another order; bound 1e-3. The port run at f32 on the same weights
parts from the reference by 7e-3 to 2.4e-2, so a step done in the wrong
precision exceeds the bound (``test_lm_bfloat16_bound_sees_an_f32_run``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.launch.serve import sample_token as ref_sample_token  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import cast  # noqa: E402

ARCHS = configs.list_archs()
LM_TOL = 1e-5
SELF_TOL = 1e-4
B, S, STEPS = 2, 16, 8


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        out["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


_DRAW = 1 << 21     # more than any reduced arch's parameter count


@jax.jit
def _draw(key):
    return jax.random.truncated_normal(key, -2.0, 2.0, (_DRAW,))


def _jax_params(bundle, seed):
    """``jax.random`` parameters in the reference's tree (from
    ``jax.eval_shape`` of its ``init_params``): one truncated-normal draw,
    cut into the leaves, each scaled as ``dense_init`` scales a weight
    (1/sqrt(fan_in)), 1-D leaves (norm scales, biases, the SSM and RG-LRU
    constants) at 0.1 so that every one of them is exercised. The
    reference's own init compiles for 3-10 s an arch on one core."""
    shapes = jax.eval_shape(bundle.init_params, jax.random.PRNGKey(seed))
    flat, treedef = jax.tree_util.tree_flatten(shapes)
    draw, leaves, at = np.asarray(_draw(jax.random.PRNGKey(seed))), [], 0
    for leaf in flat:
        n = int(np.prod(leaf.shape))
        assert at + n <= _DRAW
        std = 0.1 if len(leaf.shape) < 2 else 1.0 / np.sqrt(leaf.shape[-2])
        leaves.append(jnp.asarray((draw[at:at + n] * std).reshape(leaf.shape), leaf.dtype))
        at += n
    return jax.tree_util.tree_unflatten(treedef, leaves)


# the reference compiled at XLA's lowest backend optimization: a third less
# compile time on one core, the same operations; at bf16 also without excess
# precision (XLA's CPU compiler otherwise drops the roundings to bf16 between
# fused ops that the program asks for)
FAST = {"xla_backend_optimization_level": 0}
EXACT_BF16 = {**FAST, "xla_allow_excess_precision": False}


def _compiled(fn, *args, options=FAST):
    return jax.jit(fn).lower(*args).compile(compiler_options=options)


class _Reference:
    """Per arch, computed once: the parameters (as arrays), the reference's
    prefill logits and 8 greedy decode steps (tokens fed, logits out)."""

    def __init__(self):
        self._cache = {}

    def __call__(self, arch, dtype="float32"):
        if (arch, dtype) not in self._cache:
            self._cache[arch, dtype] = self._run(arch, dtype)
        return self._cache[arch, dtype]

    @staticmethod
    def _run(arch, dtype):
        rcfg = ref_reduced(ref_get_config(arch), dtype=dtype)
        options = FAST if dtype == "float32" else EXACT_BF16
        bundle = ref_build(rcfg)
        params = _jax_params(bundle, 0)
        batch = _batch(rcfg)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        logits = _compiled(bundle.prefill_step, params, jbatch, options=options)(params, jbatch)
        cache = cache0 = bundle.init_cache(B, STEPS)
        tok = jnp.asarray(batch["tokens"][:, :1])
        step = _compiled(bundle.decode_step, params, cache, tok, jnp.asarray(0),
                         options=options)
        fed, dec = [], []
        for t in range(STEPS):
            fed.append(np.array(tok))
            out, cache = step(params, cache, tok, jnp.asarray(t))
            dec.append(np.asarray(out, np.float32))
            tok = jnp.argmax(out[:, -1:], axis=-1).astype(jnp.int32)
        return {"params": jax.tree_util.tree_map(np.asarray, params), "batch": batch,
                "logits": np.asarray(logits, np.float32), "fed": fed, "decode": dec,
                "cache": cache0}


@pytest.fixture(scope="module")
def reference():
    return _Reference()


def _port(arch, dtype="float32"):
    cfg = configs.reduced(configs.get_config(arch), dtype=dtype)
    return cfg, build(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(reference, arch):
    ref = reference(arch)
    cfg, bundle = _port(arch)
    params = lm_params_from_arrays(ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.inference_mode():
        logits = bundle.prefill_step(params, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert _rel_err(logits, ref["logits"]) <= LM_TOL


def _port_decode(arch, ref, dtype="float32", params=None):
    cfg, bundle = _port(arch, dtype)
    if params is None:
        params = lm_params_from_arrays(ref["params"], device="cpu")
    cache = bundle.init_cache(B, STEPS, device="cpu")
    outs = []
    with torch.inference_mode():
        for t, tok in enumerate(ref["fed"]):
            out, cache = bundle.decode_step(params, cache, torch.from_numpy(tok), t)
            outs.append(out)
    return outs


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_matches_reference(reference, arch):
    """8 steps teacher-forced with the reference's greedy tokens: every
    step's logits within 1e-5."""
    ref = reference(arch)
    outs = _port_decode(arch, ref)
    errs = [_rel_err(got, want) for got, want in zip(outs, ref["decode"])]
    assert max(errs) <= LM_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(reference, arch):
    """The port's greedy token equals the reference's at every step and
    row whose top-two margin exceeds the logits' bound (all of them here)."""
    ref = reference(arch)
    outs = _port_decode(arch, ref)
    decided = 0
    for got, want in zip(outs, ref["decode"]):
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        sure = margin > LM_TOL * np.abs(want).max()
        got_tok = got[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(got_tok[sure], want[:, -1].argmax(-1)[sure])
        decided += int(sure.sum())
    assert decided >= B * STEPS - 1


# bf16 bound relative to the largest magnitude (the module's docstring)
BF16_TOL = {"qwen3-0.6b": 1e-3, "mamba2-780m": 1e-3}


def _port_run(arch, ref, dtype):
    """The port's prefill logits and 8 decode steps (teacher-forced with the
    reference's tokens) on the reference's bf16 weights (mamba's SSM
    constants in f32), run at ``dtype`` (at f32, every weight cast up)."""
    cfg, bundle = _port(arch, dtype)
    params = lm_params_from_arrays(ref["params"], device="cpu")
    if dtype == "float32":
        params = cast(params, torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.inference_mode():
        logits = bundle.prefill_step(params, batch)
    return logits, _port_decode(arch, ref, dtype, params)


@pytest.mark.parametrize("arch", list(BF16_TOL))
def test_lm_bfloat16_matches_reference(reference, arch):
    """bf16 logits and 8 decode steps against the reference's, within the
    measured bound; greedy tokens equal wherever the reference's top-two
    margin exceeds twice that bound."""
    ref, tol = reference(arch, "bfloat16"), BF16_TOL[arch]
    _, bundle = _port(arch, "bfloat16")
    assert _struct(bundle.init_cache(B, STEPS, device="cpu")) == _struct(ref["cache"])
    logits, steps = _port_run(arch, ref, "bfloat16")
    assert logits.dtype == torch.bfloat16
    errs = [_rel_err(logits, ref["logits"])]
    errs += [_rel_err(got, want) for got, want in zip(steps, ref["decode"])]
    assert max(errs) <= tol, errs
    decided = 0
    for got, want in zip(steps, ref["decode"]):
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol * np.abs(want).max()
        got_tok = got[:, -1].float().argmax(-1).numpy()
        np.testing.assert_array_equal(got_tok[sure], want[:, -1].argmax(-1)[sure])
        decided += int(sure.sum())
    assert decided >= B * STEPS // 2, decided


@pytest.mark.parametrize("arch", list(BF16_TOL))
def test_lm_bfloat16_bound_sees_an_f32_run(reference, arch):
    """The bf16 bound is tight enough to see a run in the wrong precision:
    the port at f32 on the same weights exceeds it, in the logits and in the
    decode steps."""
    ref, tol = reference(arch, "bfloat16"), BF16_TOL[arch]
    logits, steps = _port_run(arch, ref, "float32")
    assert logits.dtype == torch.float32
    assert _rel_err(logits, ref["logits"]) > tol
    assert max(_rel_err(got, want) for got, want in zip(steps, ref["decode"])) > tol


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_round_trips_bit_for_bit(reference, arch):
    tree = reference(arch)["params"]
    back = lm_params_to_arrays(lm_params_from_arrays(tree, device="cpu"))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_param_tree_round_trips_bfloat16():
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "rem": [{"s": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)}]}
    arrays = jax.tree_util.tree_map(np.asarray, tree)
    port = lm_params_from_arrays(arrays, device="cpu")
    assert port["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["w"].float().numpy(), np.asarray(tree["w"], np.float32))
    back = lm_params_to_arrays(port)
    for a, b in zip(jax.tree_util.tree_leaves(arrays), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def _struct(tree):
    """(shape, dtype name) leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_struct(v) for v in tree]
    dt = tree.dtype
    return (tuple(tree.shape), str(dt).replace("torch.", "") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_is_the_reference_tree(reference, arch):
    """The port's own random initialisation: the reference's tree, leaf for
    leaf (paths, shapes, dtypes), groups stacked on the same layer axis,
    norm scales zero."""
    cfg, bundle = _port(arch)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert _struct(params) == _struct(reference(arch)["params"])
    assert float(params["final_norm_scale"].abs().max()) == 0.0
    again = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["embed"]["tokens"], again["embed"]["tokens"])
    # the truncated normal: |w| <= 2 std, std = 0.02 for the embedding
    assert float(params["embed"]["tokens"].abs().max()) <= 0.04 + 1e-7


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference_on_every_leaf(reference, arch):
    n = 0
    for path, leaf in _paths(reference(arch)["params"]):
        stacked = "groups/" in path
        want = ref_sharding.param_spec(path, leaf.ndim, stacked=stacked)
        assert sharding.param_spec(path, leaf.ndim, stacked=stacked) == tuple(want), path
        n += 1
    assert n > 10


class _FakeMesh:
    """What the two packages read of a mesh: dimension names and sizes (the
    reference's ``axis_names``/``devices.shape``, a ``DeviceMesh``'s
    ``mesh_dim_names``/``shape``)."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.devices = np.empty(shape)
        self.shape = tuple(shape)


MESHES = {"none": None, "data-model": (("data", "model"), (2, 4)),
          "pod-data-model": (("pod", "data", "model"), (2, 3, 2)), "model": (("model",), (8,))}
# every logical annotation the reference's model code makes
LOGICAL = [("batch", "seq", "heads", None), ("batch", "seq_res", "embed"), ("batch", "seq", "mlp"),
           ("batch", "seq", "embed"), ("batch", "seq", "vocab"), ("expert_cap", "embed"),
           ("experts", "batch", "embed"), ("experts", "batch", None), ("tokens", "embed"),
           ("subjects", None), ("unknown", None)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", ["LM", "SP", "none"])
def test_logical_spec_and_enforce_divisible_match_reference(mesh, rules):
    m = MESHES[mesh] and _FakeMesh(*MESHES[mesh])
    ref_rules = {"LM": ref_sharding.LM_RULES, "SP": ref_sharding.SP_RULES}.get(rules)
    port_rules = {"LM": sharding.LM_RULES, "SP": sharding.SP_RULES}.get(rules)
    for axes in LOGICAL:
        if ref_rules is None:
            want, got = ref_sharding.logical_spec(axes, m), sharding.logical_spec(axes, m)
        else:
            with ref_sharding.axis_rules(ref_rules, m), sharding.axis_rules(port_rules, m):
                want, got = ref_sharding.logical_spec(axes), sharding.logical_spec(axes)
        assert got == tuple(want), axes
        if m is not None:
            for shape in [(8, 6, 4, 2)[:len(axes)], (3, 5, 7, 9)[:len(axes)]]:
                assert (sharding.enforce_divisible(got, shape, m)
                        == tuple(ref_sharding.enforce_divisible(want, shape, m))), (axes, shape)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_against_cpu_on_the_cpu_agrees_exactly(arch):
    """``serve.against_cpu`` (the card-against-CPU check of the GPU tests and
    ``chip_smoke.py``) asked for the CPU: the same run twice, no gap, every
    greedy token decided and equal."""
    r = serve.against_cpu(arch, "cpu", steps=4)
    assert r == {"forward": 0.0, "decode": 0.0, "decided": 8, "same": 8, "finite": True}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Meta-device stand-ins with the reference's shapes and dtypes, for
    every assignment shape (the decode cache's whole tree too)."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg, bundle = _port(arch)
    rbundle = ref_build(rcfg)
    for name in REF_SHAPES:
        got = bundle.input_specs(name)
        want = rbundle.input_specs(name)
        assert _struct(got) == _struct(want), name
        for _, leaf in _paths(got):
            assert leaf.device.type == "meta"


def test_build_has_no_training_fields():
    """The bundle has the reference's ``ModelBundle`` fields, in its order:
    the training fields (``init_opt``, ``train_step``) beside serving's."""
    from repro.models.api import ModelBundle as RefModelBundle

    _, bundle = _port("qwen3-0.6b")
    assert ([f.name for f in dataclasses.fields(bundle)]
            == [f.name for f in dataclasses.fields(RefModelBundle)])


# ---------------------------------------------------------------------------
# the port against itself: decode equals prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,length", [("qwen3-0.6b", 8), ("mamba2-780m", 8),
                                         ("recurrentgemma-9b", 24)])
def test_decode_matches_own_prefill(arch, length):
    """Cache correctness: step t's logits equal the prefill's at t (for
    recurrentgemma past its window of 16, where the ring buffer wraps)."""
    cfg, bundle = _port(arch)
    gen = torch.Generator().manual_seed(3)
    params = bundle.init_params(gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, length), generator=gen)
    cache = bundle.init_cache(B, length, device="cpu")
    with torch.inference_mode():
        full = bundle.prefill_step(params, {"tokens": tokens})
        for t in range(length):
            logits, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1], t)
            assert _rel_err(logits[:, 0], full[:, t].numpy()) <= SELF_TOL, t
    if arch == "recurrentgemma-9b":
        assert cache["groups"]["p2_attn_local"]["self"][0].shape[2] == cfg.local_window


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_sample_token_greedy_and_topk():
    logits = torch.tensor([[[0.1, 5.0, 0.2, 0.3]]])
    assert int(serve.sample_token(logits, temperature=0.0)[0, 0]) == 1
    assert int(ref_sample_token(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0))[0, 0]) == 1
    for seed in range(5):     # top-k = 1 always picks the argmax
        g = torch.Generator().manual_seed(seed)
        assert int(serve.sample_token(logits, g, temperature=2.0, top_k=1)[0, 0]) == 1
    seen = {int(serve.sample_token(logits, torch.Generator().manual_seed(s),
                                   temperature=50.0)[0, 0]) for s in range(50)}
    assert len(seen) > 1


def test_sample_token_topk_threshold():
    """Only the top k logits can be drawn (ties at the k-th included, as the
    reference's ``x < kth`` keeps them)."""
    logits = torch.tensor([[[3.0, 1.0, 2.0, 2.0, -1.0]]])
    seen = {int(serve.sample_token(logits, torch.Generator().manual_seed(s),
                                   temperature=10.0, top_k=2)[0, 0]) for s in range(200)}
    assert seen == {0, 2, 3}
    seen = {int(serve.sample_token(logits, torch.Generator().manual_seed(s),
                                   temperature=10.0, top_k=1)[0, 0]) for s in range(20)}
    assert seen == {0}


@pytest.mark.parametrize("arch,extra", [("qwen3-0.6b", []), ("mamba2-780m", []),
                                        ("recurrentgemma-9b", ["--temperature", "0.8",
                                                               "--top-k", "5"])])
def test_serve_main_on_cpu(arch, extra, capsys):
    out = serve.main(["--arch", arch, "--reduce", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen", "6", *extra])
    assert out["generated"].shape == (2, 6)
    assert out["tokens_per_s"] > 0 and out["peak_gib"] is None
    assert int(out["generated"].max()) < configs.reduced(configs.get_config(arch)).vocab_size
    text = capsys.readouterr().out
    assert "[serve]" in text and "ms a step" in text and "tok/s" in text
    again = serve.main(["--arch", arch, "--reduce", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "5", "--gen", "6", *extra])
    assert torch.equal(out["generated"], again["generated"])     # seeded


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduce"])
    _, bundle = _port("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init_params(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_arrays({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init_cache(2, 4)


def test_configs_are_the_reference_configs():
    assert ARCHS == ref_list_archs()
    for arch in ARCHS:
        want = ref_get_config(arch)
        got = configs.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(configs.reduced(got)) == dataclasses.asdict(ref_reduced(want))
        assert got.param_count() == want.param_count()
        assert configs.applicable_shapes(got) == __import__(
            "repro.configs", fromlist=["applicable_shapes"]).applicable_shapes(want)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
