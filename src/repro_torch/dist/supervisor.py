"""Fault-tolerant supervisor for the chunked scan-engine fit
(``repro.dist.supervisor``).

``repro_torch.core.engine.fit_device`` runs one chunk of
``opts.check_every`` iterations per host read of the fits. :func:`supervised_fit`
runs the same chunk loop (same chunk lengths, same tol semantics, history
and factors bit for bit the bare ``fit(engine="scan")`` on a faultless run)
with a recovery ladder around every chunk boundary:

1. **retry**: the chunk runs under
   :func:`repro_torch.dist.fault.run_with_retries` (exponential backoff and
   deterministic jitter); a :class:`~repro_torch.dist.fault.TransientFault`
   is retried in place up to ``max_retries`` times.
2. **restore**: exhausted retries escalate to checkpoint-restore: the newest
   ``repro_torch.checkpoint`` checkpoint (written every ``ckpt_every``
   chunks) is loaded, the history rewound to its step, and the chunks
   replayed; without a checkpoint, the last good chunk boundary in memory.
3. **rollback**: a numerical-health sentinel checks each chunk's fits when
   the host reads them: non-finite fits, or a fit below the best seen by
   more than ``regress_tol`` (ALS fit is monotone), roll the state back to
   the last good boundary and replay. After ``health_retries`` consecutive
   failed replays the replay tightens regularization
   (``Parafac2Options.ridge = ridge_escalation``, 10x per further
   escalation), against a chunk made anew for the ridged options; a run
   that still cannot produce finite fits raises.

A :class:`~repro_torch.dist.fault.StepWatchdog` observes each committed
chunk's wall time, except the first call of each chunk length (the
reference's rule: there, its compile); straggler flags are reported, never
retried. On a GPU the chunk is one captured iteration replayed (the capture
happens when the chunk is made, before the timed call); the chunk comes
from the scan engine's cache (``engine.cached_chunk``), so a supervised fit
on data that a fit with the same options already ran replays that fit's
chunk. A chunk donates its state: the state it returns is its own carry,
which its next call overwrites. So the last good boundary is kept as a copy
of the carry, the fit returns that copy, and a checkpoint is read before
the next replay.

Resume: with ``ckpt_dir`` set, checkpoints carry the fit history in their
``extra`` (step = iterations completed); ``resume=True`` continues from the
newest one, bit for bit the uninterrupted run.

Under ``engine="mesh"`` every rank runs this same loop on its own shard.
The reference has one controller; here a fault raised on one rank alone
would leave the others in the chunk's first all-reduce. So each verdict is
all-reduced (a max over the ranks) before any rank acts on it: whether an
injected fault fired (then every rank retries, or restores, together),
whether the chunk was unhealthy (then every rank rolls back), and the
chunk's wall time (the slowest rank's, so every watchdog flags the same
chunks): every rank's report is the same. Checkpoints are written
globally unsharded by rank 0 (a bucketed W gathered first) and restored as
each rank's rows (``repro_torch.checkpoint``), so a fit written under n
ranks resumes under m where m divides the plan's ``subject_align``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.core import engine as _engine
from repro_torch.core import parafac2 as p2
from repro_torch.dist import sharding as dsh
from repro_torch.dist.fault import (FaultInjector, StepWatchdog, TransientFault,
                                    run_with_retries)

__all__ = ["SupervisorConfig", "SupervisorReport", "supervised_fit"]


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs for :func:`supervised_fit` (all on the host)."""

    # --- retry ladder -----------------------------------------------------
    max_retries: int = 3            # in-place retries per chunk
    backoff: float = 0.0            # base backoff seconds (0 = no sleep)
    backoff_factor: float = 2.0     # exponential growth per attempt
    jitter: float = 0.0             # deterministic jitter fraction (seeded)
    retry_seed: int = 0             # seed for the jitter stream
    # --- checkpointing ----------------------------------------------------
    ckpt_dir: Optional[str] = None  # None = in-memory boundaries only
    ckpt_every: int = 1             # write a checkpoint every N chunks
    keep: int = 3                   # checkpoints retained on disk
    resume: bool = False            # continue from ckpt_dir's newest step
    # --- sentinels --------------------------------------------------------
    watchdog_factor: float = 3.0    # straggler threshold vs running median
    regress_tol: float = 1e-3       # fit drop below best-seen => unhealthy
    health_retries: int = 1         # clean replays before ridge escalation
    ridge_escalation: float = 1e-6  # first escalated ridge (10x per repeat)
    max_escalations: int = 3        # give up (raise) past this many
    # --- fault injection / test seams ------------------------------------
    injector: Optional[FaultInjector] = None
    sleep: Callable = time.sleep            # injectable for backoff tests
    clock: Callable = time.perf_counter     # injectable for watchdog tests
    # the chunks a caller saw, shared across supervised_fit calls (a
    # {length: chunk} dict the caller owns, one chunk under every length it
    # has run). Lengths already present count as warm for the watchdog.
    # The chunks themselves come from the scan engine's cache
    # (repro_torch.core.engine.CHUNKS), which keeps a fit's chunk for the
    # next fit on the same data and options, with or without this dict.
    chunk_cache: Optional[Dict[int, Callable]] = None


@dataclasses.dataclass
class SupervisorReport:
    """What happened on the way to convergence (the ``supervisor`` block
    of ``launch/decompose.py``'s summary)."""

    retries: int = 0                # in-place transient-fault retries
    restores: int = 0               # exhausted-retry checkpoint restores
    rollbacks: int = 0              # health-sentinel rollbacks
    stragglers: List[int] = dataclasses.field(default_factory=list)
    checkpoints_written: int = 0
    resumed_from_step: Optional[int] = None
    ridge_final: float = 0.0        # >0 iff regularization was escalated
    escalations: int = 0
    chunks: int = 0                 # committed chunks

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _poison(state: "p2.Parafac2State") -> "p2.Parafac2State":
    """NaN the H factor: every later update and the fit inherit the NaN,
    which is what the health sentinel must catch."""
    return dataclasses.replace(state, H=state.H * float("nan"))


def _healthy(fits: np.ndarray, best: float, regress_tol: float) -> bool:
    if not np.all(np.isfinite(fits)):
        return False
    # ALS fit is monotone: a drop below the best fit seen (beyond tol) means
    # the trajectory diverged even if every value is finite
    return not (np.isfinite(best) and float(fits.min()) < best - regress_tol)


def _agree(mesh, device, *values: float) -> List[float]:
    """Each value's maximum over the mesh's subject ranks (the values
    themselves without a mesh)."""
    if mesh is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dsh.axis_group(*mesh))
    return t.tolist()


def supervised_fit(data, opts: "p2.Parafac2Options", *, max_iters: int = 100,
                   tol: float = 1e-6, seed: int = 0, verbose: bool = False,
                   state: Optional["p2.Parafac2State"] = None,
                   config: Optional[SupervisorConfig] = None
                   ) -> Tuple["p2.Parafac2State", List[float], SupervisorReport]:
    """Fault-tolerant drop-in for ``fit`` on the scan engine's chunks: the
    same ``(state, history)`` plus a :class:`SupervisorReport`. A faultless
    supervised run is bit for bit ``fit(engine="scan")``: the same chunk
    calls (one chunk of ``check_every`` iterations, the remainder as its
    first ``n``), the same tol rule."""
    cfg = config or SupervisorConfig()
    if opts.engine not in ("scan", "mesh"):
        raise ValueError(
            f"supervised_fit wraps the chunked device engines "
            f"(engine='scan'|'mesh'), got engine={opts.engine!r}")
    if opts.check_every <= 0:
        raise ValueError(
            "supervised_fit needs chunked execution (check_every > 0); the "
            "while variant has no chunk boundaries to supervise")
    if opts.compress not in ("", "none"):
        raise ValueError(
            f"supervised_fit runs the core ALS only (compress={opts.compress!r})")
    if cfg.ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {cfg.ckpt_every}")

    state = p2.init_state(data, opts, seed, state=state)
    history: List[float] = []
    report = SupervisorReport()
    # the mesh engine's (DeviceMesh, subject dimensions), and how each state
    # tensor lies across the ranks, for the checkpoints
    mesh = _engine.resolve_mesh(data.device) if opts.engine == "mesh" else None
    where = dict(shardings=_engine.state_placements(state),
                 mesh=None if mesh is None else mesh[0])

    if cfg.resume:
        if cfg.ckpt_dir is None:
            raise ValueError("resume=True needs ckpt_dir")
        step = ckpt.latest_step(cfg.ckpt_dir)
        if step is not None:
            state, step, extra = ckpt.restore(cfg.ckpt_dir, state, step=step, **where)
            history = [float(f) for f in extra.get("history", [])][:step]
            report.resumed_from_step = step
            if verbose:
                print(f"[supervisor] resumed from step {step} "
                      f"(fit={history[-1] if history else float('nan'):.6f})")

    run_opts = opts
    chunks: Dict[int, Callable] = cfg.chunk_cache if cfg.chunk_cache is not None else {}
    warm_lengths: set = set(chunks)    # lengths whose first call already ran
    watchdog = StepWatchdog(factor=cfg.watchdog_factor)
    injector = cfg.injector

    # the last good chunk boundary in memory (a copy once it is a chunk's
    # carry, which the next call overwrites)
    good_state, good_history = state, list(history)
    # newest on-disk step, so the restore path knows whether disk can help
    disk_step = ckpt.latest_step(cfg.ckpt_dir) if cfg.ckpt_dir is not None else None

    def save(st, hist):
        nonlocal disk_step
        if cfg.ckpt_dir is None:
            return
        ckpt.save(cfg.ckpt_dir, len(hist), st, extra={"history": hist}, keep=cfg.keep,
                  **where)
        disk_step = len(hist)
        report.checkpoints_written += 1

    def best_fit(hist):
        return max(hist) if hist else float("-inf")

    def on_retry(attempt, exc):
        report.retries += 1
        if verbose:
            print(f"[supervisor] retry {attempt + 1}/{cfg.max_retries} after {exc}")

    def chunk_for(n: int, st) -> Callable:
        """The chunk that runs ``n`` iterations: one chunk of ``check_every``
        iterations serves every length up to it, as in ``fit_device``."""
        if n not in chunks:
            base = next((c for c in chunks.values() if c.length >= n), None)
            chunks[n] = base or _engine.cached_chunk(
                data, run_opts, max(n, opts.check_every), state=st)
        return chunks[n]

    chunk_idx = len(history) // opts.check_every   # resumes keep chunk ids
    consecutive_bad = 0
    prev = history[-1] if history else -np.inf
    done = False
    while len(history) < max_iters and not done:
        n = min(opts.check_every, max_iters - len(history))
        chunk = chunk_for(n, state)

        dispatch_state = state
        if injector is not None and injector.poison(chunk_idx):
            if verbose:
                print(f"[supervisor] injected NaN poison at chunk {chunk_idx}")
            dispatch_state = _poison(dispatch_state)

        timing = {}

        def attempt_chunk(s):
            fault = None
            if injector is not None:
                try:
                    injector.check(chunk_idx)
                except TransientFault as e:
                    fault = e
            if _agree(mesh, data.device, fault is not None)[0]:   # every rank retries
                raise fault or TransientFault(f"a fault on another rank at chunk {chunk_idx}")
            t0 = cfg.clock()
            s2, fits = chunk(s, n)
            fits = np.asarray(fits.tolist())        # the chunk's one device sync
            timing["dt"] = cfg.clock() - t0
            return s2, fits

        try:
            new_state, fits = run_with_retries(
                attempt_chunk, dispatch_state, max_retries=cfg.max_retries,
                on_retry=on_retry, backoff=cfg.backoff, backoff_factor=cfg.backoff_factor,
                jitter=cfg.jitter, seed=cfg.retry_seed, sleep=cfg.sleep)
        except TransientFault as e:
            # retries exhausted: restore and rewind, from disk when it has a
            # checkpoint, else from the in-memory boundary
            report.restores += 1
            if cfg.ckpt_dir is not None and disk_step is not None:
                state, step, extra = ckpt.restore(cfg.ckpt_dir, good_state, step=disk_step,
                                                  **where)
                history = [float(f) for f in extra.get("history", [])][:step]
            else:
                state, history = good_state, list(good_history)
            good_state, good_history = state, list(history)
            prev = history[-1] if history else -np.inf
            chunk_idx = len(history) // opts.check_every
            consecutive_bad = 0
            if verbose:
                print(f"[supervisor] retries exhausted ({e}); restored to "
                      f"step {len(history)}, replaying")
            continue

        bad, timing["dt"] = _agree(mesh, data.device,
                                   not _healthy(fits, best_fit(history), cfg.regress_tol),
                                   timing.get("dt", 0.0))
        if bad:
            # roll back to the last good boundary; repeated failures of the
            # same replay escalate to a ridged retry
            report.rollbacks += 1
            consecutive_bad += 1
            state, history = good_state, list(good_history)
            prev = history[-1] if history else -np.inf
            chunk_idx = len(history) // opts.check_every
            if consecutive_bad > cfg.health_retries:
                report.escalations += 1
                if report.escalations > cfg.max_escalations:
                    raise RuntimeError(
                        f"supervised_fit: fit stayed non-finite/regressing "
                        f"after {report.escalations - 1} regularization "
                        f"escalations (last ridge={run_opts.ridge:g})")
                new_ridge = cfg.ridge_escalation * (10.0 ** (report.escalations - 1))
                run_opts = dataclasses.replace(opts, ridge=new_ridge)
                report.ridge_final = new_ridge
                # chunks made anew against the ridged step; the unridged one
                # (on a GPU its graph) is freed before the next capture
                # unless the caller's cache holds it
                del chunk, new_state
                chunks = {}
                warm_lengths = set()
                if verbose:
                    print(f"[supervisor] escalating: ridge={new_ridge:g}")
            if verbose:
                print(f"[supervisor] unhealthy chunk {chunk_idx} "
                      f"(finite={bool(np.all(np.isfinite(fits)))}); rolled "
                      f"back to step {len(history)}")
            continue

        # ---- healthy chunk: commit -----------------------------------------
        consecutive_bad = 0
        state = new_state
        if n in warm_lengths:
            # the first call of a length is not observed (the reference's
            # compile call), so it neither flags nor drags the median up
            if watchdog.observe(chunk_idx, timing.get("dt", 0.0)):
                report.stragglers.append(chunk_idx)
                if verbose:
                    print(f"[supervisor] straggler flag on chunk {chunk_idx} "
                          f"({timing['dt']:.3f}s)")
        else:
            warm_lengths.add(n)
        for f in fits.tolist():
            history.append(f)
            if len(history) > 1 and abs(f - prev) < tol:
                done = True                # fit_device's rule: keep the
            prev = f                       # whole chunk
        good_state, good_history = _engine.clone_state(state), list(history)
        report.chunks += 1
        chunk_idx += 1
        if report.chunks % cfg.ckpt_every == 0:
            save(state, history)
        if verbose:
            print(f"[supervisor:{opts.engine}] iter {len(history) - 1:3d}  "
                  f"fit={history[-1]:.6f}")

    if cfg.ckpt_dir is not None and disk_step != len(history):
        save(state, history)               # final boundary, resume-exact
    # the last good boundary is this state's copy: the chunk is kept for
    # the next fit on this data, which overwrites its carry
    return good_state, history, report
