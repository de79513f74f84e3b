"""End-to-end LM training driver (``repro.launch.train``).

Runs a training loop with checkpoint/restart, fault injection, a straggler
watchdog and the counter-based data pipeline:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 8 --batch 8 --seq 256                      # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduce \\
      --steps 30 --batch 2 --seq 16 --device cpu --ckpt-dir /tmp/ckpt \\
      --ckpt-every 10 --resume auto --fail-at 7 22

The reference's flags, plus ``--device`` (``cuda`` by default, which raises
without a GPU). Weights are the port's own random initialisation from
``--seed``; whisper's frames and pixtral's patch embeddings are drawn from a
``torch.Generator`` seeded by (seed, step) on the device. Each step runs
eagerly. A persistent fault (``--fail-persistent``) exhausts the retries;
the driver then restores the newest checkpoint and re-runs the steps after
it.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ArchConfig, get_config, reduced
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.dist.fault import FaultInjector, StepWatchdog, TransientFault, run_with_retries
from repro_torch.models import build
from repro_torch.models.api import stub_shapes


def stub_inputs(cfg: ArchConfig, batch: int, seed: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    """The modality stubs of ``step``'s batch (whisper's encoder frames,
    pixtral's patch embeddings), standard normal in f32 from a generator on
    ``device`` seeded by (seed, step): a pure function of the step, as the
    token batches are."""
    seed_of_step = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(seed_of_step)
    return {k: torch.randn(shape, generator=gen, device=device)
            for k, shape in stub_shapes(cfg, batch).items()}


# Train steps of two f32 runs of one model from the same state (the port
# against the reference on the CPU, the card against the CPU): the losses
# within LOSS_TOL relative; the first moments after step 0 (0.1 x the
# clipped gradients) within GRAD_TOL of each leaf's largest magnitude; after
# later steps the moments within MOMENT_TOL, every parameter within
# PARAM_LR x lr, and all but a PARAM_FRAC share of them within PARAM_ABS.
# AdamW's early steps move an element by ~lr whatever the size of its
# gradient, so an element whose gradient is at rounding level in the two
# runs may step the other way (2 lr apart), and the next gradients see it;
# the bulk moves alike.
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-3
PARAM_LR, PARAM_ABS, PARAM_FRAC = 2.0, 1e-6, 1e-2
AGAINST_LR = 3e-3       # ``against_cpu``'s peak lr, reached at step 1


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float32).astype(np.float64)


def _leaf_gap(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max() / max(np.abs(_np(b)).max(), 1e-30))


def step_gaps(got_params, got_moments, want_params, want_moments, lr: float) -> dict:
    """How far one run's parameters and moments (leaf lists, tensors or
    arrays, in one order) are from another's after a step past step 0:
    ``param_lr``, the largest parameter gap over ``lr``; ``param_frac``,
    the share of elements past ``PARAM_ABS``; ``moment``, the largest
    moment gap relative to its leaf's largest magnitude; ``within``,
    whether all three are inside the bounds above."""
    gaps = np.concatenate([np.abs(_np(a) - _np(b)).ravel()
                           for a, b in zip(got_params, want_params)])
    moment = max(_leaf_gap(a, b) for a, b in zip(got_moments, want_moments))
    out = {"param_lr": float(gaps.max() / lr), "param_frac": float((gaps > PARAM_ABS).mean()),
           "moment": moment}
    out["within"] = (out["param_lr"] <= PARAM_LR and out["param_frac"] <= PARAM_FRAC
                     and moment <= MOMENT_TOL)
    return out


def grad_gap(got_m, want_m) -> float:
    """The first moments after step 0, leaf by leaf: the largest gap
    relative to the leaf's largest magnitude (held within ``GRAD_TOL``)."""
    return max(_leaf_gap(a, b) for a, b in zip(got_m, want_m))


def against_cpu(arch: str, dev, steps: int = 3) -> dict:
    """Reduced ``arch`` (f32) trained ``steps`` steps (from step 0) on the
    CPU and on ``dev`` from the same parameters (the port's init on the
    CPU, copied over) and batch: ``loss``, the largest relative gap of the
    losses; ``unmoved``, whether step 0 left every parameter bit for bit
    unchanged on ``dev``; ``grad``, :func:`grad_gap` after step 0;
    ``finite``; :func:`step_gaps` of ``dev``'s parameters and moments
    against the CPU's after the last step; ``within``, whether the gradient
    and the step gaps are inside their bounds."""
    from repro_torch.models.common import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    bundle = build(cfg, lr=AGAINST_LR, total_steps=50)
    gen = torch.Generator().manual_seed(0)
    start = bundle.init_params(gen, device="cpu")
    B, S = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels, **stub_inputs(cfg, B, 0, 0, "cpu")}
    runs = {}
    for where, d in (("cpu", torch.device("cpu")), ("dev", torch.device(dev))):
        params = tree_map(lambda t: t.to(d), start)
        opt = bundle.init_opt(params)
        on_d = {k: v.to(d) for k, v in batch.items()}
        losses = []
        for i in range(steps):
            params, opt, m = bundle.train_step(params, opt, on_d, i)
            losses.append(float(m["loss"]))
            if i == 0:
                unmoved = all(torch.equal(a.cpu(), b) for a, b in
                              zip(tree_leaves(params), tree_leaves(start)))
                first_m = tree_leaves(opt.m)
        runs[where] = (losses, params, opt, unmoved, first_m)
    (cpu_l, cpu_p, cpu_o, _, cpu_m), (dev_l, dev_p, dev_o, unmoved, dev_m) = (runs["cpu"],
                                                                             runs["dev"])
    grad = grad_gap(dev_m, cpu_m)
    gaps = step_gaps(tree_leaves(dev_p), tree_leaves(dev_o.m) + tree_leaves(dev_o.v),
                     tree_leaves(cpu_p), tree_leaves(cpu_o.m) + tree_leaves(cpu_o.v),
                     AGAINST_LR)
    leaves = tree_leaves(dev_p) + tree_leaves(dev_o.m) + tree_leaves(dev_o.v)
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(dev_l, cpu_l)),
            "unmoved": unmoved, "losses": dev_l, "grad": grad,
            "finite": all(bool(torch.isfinite(t).all()) for t in leaves),
            **gaps, "within": gaps["within"] and grad <= GRAD_TOL}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="", choices=["", "auto"])
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject transient faults at these steps (FT test)")
    ap.add_argument("--fail-persistent", action="store_true",
                    help="make injected faults persist past retries, forcing "
                         "the checkpoint-restore + rewind path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    bundle = build(cfg, lr=args.lr, total_steps=args.steps)

    params = bundle.init_params(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = bundle.init_opt(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    start = 0
    if args.resume == "auto" and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt), start, extra = ckpt.restore(args.ckpt_dir, (params, opt))
        stream.restore(extra["data"])
        print(f"[train] resumed from step {start}")

    injector = FaultInjector(fail_steps=tuple(args.fail_at),
                             times=4 if args.fail_persistent else 1)
    watchdog = StepWatchdog()
    losses, step_ms = [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def one_step(params, opt, step):
        injector.check(step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch_at(step).items()}
        batch.update(stub_inputs(cfg, args.batch, args.seed, step, dev))
        return bundle.train_step(params, opt, batch, step)

    step = start
    while step < args.steps:
        t0 = time.perf_counter()
        try:
            params, opt, metrics = run_with_retries(
                one_step, params, opt, step,
                on_retry=lambda a, e: print(f"[fault] step {step}: {e}; retry {a + 1}"))
        except TransientFault:
            # persistent failure path: restore newest checkpoint and REWIND —
            # the steps between the checkpoint and the fault re-run against
            # the restored state (a for-loop would silently skip them).
            if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
                (params, opt), step0, extra = ckpt.restore(args.ckpt_dir, (params, opt))
                stream.restore(extra["data"])
                del losses[max(step0 - start, 0):]
                del step_ms[max(step0 - start, 0):]
                step = step0
                print(f"[fault] restored from checkpoint at step {step0}")
                continue
            raise
        loss = float(metrics["loss"])       # ends in a device sync
        dt = time.perf_counter() - t0
        if watchdog.observe(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s (>{watchdog.factor}x median)")
        losses.append(loss)
        step_ms.append(dt * 1e3)
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  ({dt*1e3:.0f} ms)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            stream.step = step + 1
            path = ckpt.save(args.ckpt_dir, step + 1, (params, opt),
                             extra={"data": stream.state()})
            print(f"[ckpt] wrote {path}")
        step += 1

    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        print(f"[train] done: nothing to do (resumed at step {start} of {args.steps})")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "flagged_stragglers": watchdog.flagged,
            "losses": losses, "step_ms": step_ms, "peak_gib": peak, "params": params,
            "opt": opt}


if __name__ == "__main__":
    main()
