"""The LM's training entry points in the port, on the CPU: ``(params, opt)``
checkpoints across the packages, ``repro_torch.launch.train`` (end to end,
resume, a transient and a persistent fault, the rewound run bit for bit an
uninterrupted one), the bundle's training fields and the
activation-signatures example (helpers of ``test_torch_lm_train.py``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_lm import EXACT_BF16, FAST, _compiled, _jax_params  # noqa: E402
from test_torch_lm_train import _batch, _cfgs  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.optim import AdamWState as RefAdamWState  # noqa: E402
from repro.models import build as ref_build  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_params_to_arrays, opt_state_from_arrays,  # noqa: E402
                                 opt_state_to_arrays)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _flat_keys(directory):
    step = ckpt.latest_step(directory)
    with open(os.path.join(directory, f"step_{step:09d}", "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_opt_checkpoint_crosses_both_ways(tmp_path, dtype):
    """A ``(params, opt)`` checkpoint after one reference step, written by
    the reference and restored by the port, then written by the port and
    restored by the reference: the same flat keys (``1::.step``,
    ``1::.m::...``, ``1::.v::...``), every value bit for bit, ``step`` an
    int32 0-d array."""
    rcfg, cfg = _cfgs("qwen3-0.6b", dtype=dtype)
    rbundle = ref_build(rcfg)
    params = _jax_params(rbundle, 0)
    batch = jax.tree_util.tree_map(jnp.asarray, _batch(rcfg))
    opt = rbundle.init_opt(params)
    params, opt, _ = _compiled(rbundle.train_step, params, opt, batch, 1,
                               options=FAST if dtype == "float32" else EXACT_BF16)(
        params, opt, batch, 1)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 7, (params, opt), extra={"data": {"seed": 0, "step": 7}})

    bundle = build(cfg)
    like_p = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    (got_p, got_o), step, extra = ckpt.restore(ref_dir, (like_p, bundle.init_opt(like_p)))
    assert step == 7 and extra == {"data": {"seed": 0, "step": 7}}
    assert isinstance(got_o, AdamWState)
    assert got_o.step.dtype == torch.int32 and got_o.step.shape == () and int(got_o.step) == 1
    want = jax.tree_util.tree_map(np.asarray, (params, opt))
    got_arrays = (lm_params_to_arrays(got_p), RefAdamWState(*opt_state_to_arrays(got_o)))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got_arrays)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
                                      b.view(np.uint16) if b.dtype.name == "bfloat16" else b)

    ckpt.save(port_dir, 7, (got_p, got_o), extra={"data": {"seed": 0, "step": 7}})
    ref_meta, port_meta = _flat_keys(ref_dir), _flat_keys(port_dir)
    assert set(port_meta["keys"]) == set(ref_meta["keys"])
    assert port_meta["dtypes"] == ref_meta["dtypes"]
    assert {"1::.step", "1::.m::embed::tokens", "1::.v::final_norm_scale"} <= set(ref_meta["keys"])
    (back_p, back_o), step, _ = ref_ckpt.restore(port_dir, (params, opt))
    assert step == 7 and back_o.step.dtype == jnp.int32
    for a, b in zip(jax.tree_util.tree_leaves((params, opt)),
                    jax.tree_util.tree_leaves((back_p, back_o))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    port_opt = opt_state_from_arrays(jax.tree_util.tree_map(np.asarray, opt), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(port_opt), tree_leaves(got_o)))


# ---------------------------------------------------------------------------
# the driver, the bundle and the example
# ---------------------------------------------------------------------------

def _train(*args):
    return train.main(["--arch", "qwen3-0.6b", "--reduce", "--device", "cpu",
                       "--log-every", "100", *map(str, args)])


def test_train_driver_end_to_end(tmp_path):
    out = _train("--steps", 25, "--batch", 4, "--seq", 32, "--ckpt-dir", tmp_path,
                 "--ckpt-every", 10, "--lr", 3e-3)
    assert out["last_loss"] < out["first_loss"]
    assert len(out["losses"]) == 25 and out["peak_gib"] is None
    assert ckpt.all_steps(str(tmp_path)) == [10, 20]


def test_train_driver_resume_and_fault(tmp_path, capsys):
    """The reference's test: a run to step 12, then a resumed run to 20 with
    a transient fault at 15. Then the persistent fault: restored at the
    checkpoint of step 12 and rewound, the run's losses and final
    parameters equal those of an uninterrupted run, bit for bit."""
    common = ("--batch", 4, "--seq", 32, "--ckpt-every", 6)
    _train("--steps", 12, "--ckpt-dir", tmp_path / "a", *common)
    out = _train("--steps", 20, "--ckpt-dir", tmp_path / "a", "--resume", "auto",
                 "--fail-at", 15, *common)
    assert np.isfinite(out["last_loss"]) and len(out["losses"]) == 8
    text = capsys.readouterr().out
    assert "[train] resumed from step 12" in text and "[fault] step 15" in text

    plain = _train("--steps", 20, *common)
    faulted = _train("--steps", 20, "--ckpt-dir", tmp_path / "b", "--fail-at", 15,
                     "--fail-persistent", *common)
    assert "[fault] restored from checkpoint at step 12" in capsys.readouterr().out
    assert faulted["losses"] == plain["losses"] and len(plain["losses"]) == 20
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((faulted["params"], faulted["opt"])),
        tree_leaves((plain["params"], plain["opt"]))))


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b"])
def test_train_driver_draws_the_stubs_from_the_step(arch):
    out = train.main(["--arch", arch, "--reduce", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--log-every", "100"])
    assert all(np.isfinite(out["losses"]))
    cfg = configs.reduced(configs.get_config(arch))
    a = train.stub_inputs(cfg, 2, 0, 5, "cpu")
    assert a.keys() == {"encoder_frames" if cfg.is_encdec else "prefix_embeds"}
    assert all(torch.equal(a[k], train.stub_inputs(cfg, 2, 0, 5, "cpu")[k]) for k in a)
    assert not any(torch.equal(a[k], train.stub_inputs(cfg, 2, 0, 6, "cpu")[k]) for k in a)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_against_cpu_on_the_cpu_agrees_exactly(arch):
    """``train.against_cpu`` (the card-against-CPU check of ``chip_smoke.py``)
    asked for the CPU: the same run twice, no gap, step 0 unmoved."""
    r = train.against_cpu(arch, "cpu")
    assert r["loss"] == 0.0 and r["unmoved"] and r["finite"] and r["within"]
    assert r["param_lr"] == 0.0 and r["moment"] == 0.0 and len(r["losses"]) == 3


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduce", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_state_from_arrays((np.int32(0), {"w": np.zeros(2, np.float32)},
                               {"w": np.zeros(2, np.float32)}))


def test_bundle_training_fields():
    """``init_opt`` gives the f32 zero moments and an int32 step on the
    parameters' device, whatever their dtype."""
    _, cfg = _cfgs("qwen3-0.6b", dtype="bfloat16")
    bundle = build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = bundle.init_opt(params)
    assert isinstance(opt, AdamWState) and opt.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 and not m.any() for m in tree_leaves(opt.m))
    assert [m.shape for m in tree_leaves(opt.v)] == [p.shape for p in tree_leaves(params)]
    assert dataclasses.fields(bundle)[2].name == "init_opt"


def test_activation_signatures_example_on_the_cpu(capsys):
    from repro_torch.examples import lm_activation_signatures as example

    out = example.main(["--device", "cpu"])
    assert [s.shape for s in out["slices"]] == [(n, 64) for n in example.LENGTHS]
    assert np.isfinite(out["loss"]) and 0.5 < out["history"][-1] <= 1.0
    assert tuple(out["state"].V.shape) == (64, 3) and float(out["state"].V.min()) >= 0
    assert sorted(out["uks"]) == list(range(8))
    assert "PARAFAC2 fit on activations" in capsys.readouterr().out
