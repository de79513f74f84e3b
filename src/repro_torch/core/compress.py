"""The preprocessing-stage registry and the rsvd compression pass
(``repro.core.compress``).

Compress first, then iterate (DPar2's recipe for irregular PARAFAC2): per
bucket a randomized QB decomposition turns every slice X_k [I_pad, J] into a
small core G_k = P_k^T X_k [S, C_pad] behind an orthonormal basis P_k
[I_pad, S] (S = r + p sketch columns). The unchanged ALS engines and the
whole constraint layer then iterate on the cores, at O(S * C_pad * R) a
subject instead of O(I_pad * C_pad * R), and the fitted factors expand back
to full space exactly at the end:

* **the pass is format-aware and never densifies**: the sketch Y_k = X_k Ω
  and the power iterations go through the bucket contractions
  (:mod:`repro_torch.kernels.sketch`): ``torch.bmm`` on CC buckets, the
  plain segment sums on SCOO buckets; P_k = polar(Y_k) takes P1 at R = S
  on CUDA tensors;
* **the cores are a dataset**: G_k shares X_k's kept-column metadata, so the
  core bucket is an ordinary CC :class:`~repro_torch.core.irregular.Bucket`
  (:func:`~repro_torch.core.irregular.cc_bucket_like`), and the core
  :class:`~repro_torch.core.irregular.Bucketed` runs through ``als_step``,
  the host and scan engines, every backend, precision and constraint with
  no branch;
* **the reported fit is the full-space fit**: for orthonormal P_k,
  ``||X_k - P_k M||^2 = ||G_k - M||^2 + (||X_k||^2 - ||G_k||^2)``, so the
  core dataset carries the ORIGINAL ``norm_sq`` and the engines' fit
  (norm_sq - 2 cross + model) is the full-space residual of the expanded
  model at every iteration;
* **expansion is exact**: polar(P B) = P polar(B) for orthonormal-column P,
  so the full-space Procrustes factor is Q_k = P_k Q̃_k (:func:`expand_q`);
  H, V and W live in full space throughout. :func:`residual_correct`
  evaluates the fit on the original buckets at the expanded Q_k (fresh, not
  one step stale) and replaces the last history entry.

The registry mirrors the constraint layer's: :func:`register_preprocess`,
:func:`available` and the same ``name[:param][+...]`` grammar, parsed
eagerly by :func:`parse_preprocess_spec` (an unknown name raises
``ValueError`` listing the registered preprocessors). Built in:

* ``none``: the identity (the default);
* ``rsvd[:r[:p[:q]]]``: randomized QB with core rank ``r`` (default
  ``2 * rank``), oversampling ``p`` (default 8) and ``q`` power iterations
  (default 1). A bucket whose padded row space is already at most r + p
  passes through uncompressed (:func:`repro_torch.sparse.bucketing.
  route_compress`).

``Parafac2Options(compress=...)`` threads a spec through ``fit``;
``--compress`` is the entry point's twin. The compression pass, the
expansion and the exact fit run at f32 precision whatever
``opts.precision`` (the reference takes its backend without one there): the
core fit makes the cores' half copy, never the originals'. Under
``engine="mesh"`` each rank compresses and fits its own subjects (the
cores are sharded like any bucket); the pass's energies and the exact
fit's residual are summed over the ranks (``psum_subjects``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.irregular import Bucketed, bucket_format, cc_bucket_like
from repro_torch.core.procrustes import polar_gram_eigh
from repro_torch.dist.sharding import psum_subjects
from repro_torch.kernels import sketch as _sketch
from repro_torch.sparse.bucketing import route_compress

__all__ = [
    "CompressedBucket",
    "CompressedData",
    "Preprocess",
    "PreprocessDef",
    "available",
    "compress",
    "exact_fit",
    "expand_q",
    "fit_compressed",
    "parse_preprocess_spec",
    "preprocess_summary",
    "register_preprocess",
    "residual_correct",
]


# ---------------------------------------------------------------------------
# the registry of named preprocessors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreprocessDef:
    """One registered preprocessing stage.

    param_names: the ordered int parameters a spec may carry (``name:a:b:c``)
    defaults:    each parameter's default; 0 means "resolved at apply time"
    apply:       ``apply(pp, data, opts, seed) -> CompressedData``; None
                 marks the identity (``fit`` skips the whole pass)
    """

    param_names: Tuple[str, ...] = ()
    defaults: Tuple[int, ...] = ()
    apply: Optional[Callable] = None


_REGISTRY: Dict[str, PreprocessDef] = {}


def register_preprocess(name: str, d: PreprocessDef) -> None:
    """Register (or override) a named preprocessing stage."""
    if len(d.param_names) != len(d.defaults):
        raise ValueError(f"preprocess {name!r}: param_names/defaults mismatch")
    _REGISTRY[name] = d
    if "parse_preprocess_spec" in globals():   # the built-ins register before it
        parse_preprocess_spec.cache_clear()    # an override must reach later parses


def available() -> Tuple[str, ...]:
    """The registered preprocessor names, sorted (error messages, --help)."""
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# spec parsing -> Preprocess
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Preprocess:
    """A parsed preprocessing spec: the canonical string and the int
    parameters."""

    spec: str
    name: str
    params: Tuple[int, ...]

    @property
    def identity(self) -> bool:
        return _REGISTRY[self.name].apply is None

    def param(self, pname: str) -> int:
        d = _REGISTRY[self.name]
        return self.params[d.param_names.index(pname)]

    def sketch_dim(self, rank: int) -> int:
        """The basis width S = r + p; a bare ``rsvd`` takes r = 2 * rank."""
        r = self.param("r") or 2 * rank
        if r < rank:
            raise ValueError(
                f"compress spec {self.spec!r}: core rank r={r} is below the "
                f"model rank {rank} — the cores cannot carry a rank-{rank} "
                f"model")
        return r + self.param("p")

    def apply(self, data: Bucketed, opts, *, seed: int = 0) -> "CompressedData":
        fn = _REGISTRY[self.name].apply
        if fn is None:
            raise ValueError(f"preprocess {self.spec!r} is the identity — "
                             f"nothing to apply")
        return fn(self, data, opts, seed)


@functools.lru_cache(maxsize=None)
def parse_preprocess_spec(spec: str) -> Preprocess:
    """Parse ``"name[:param][+...]"`` into a :class:`Preprocess`.

    The constraint layer's grammar: ``+`` composes syntactically (``none``
    terms drop out), but no two non-identity stages compose. An unknown name
    raises ``ValueError`` listing the registered preprocessors; a non-integer
    or negative parameter raises too.
    """
    raw = [p.strip() for p in str(spec).split("+") if p.strip()]
    if not raw:
        raw = ["none"]
    parts = []
    for part in raw:
        name, _, rest = part.partition(":")
        name = name.strip()
        if name not in _REGISTRY:
            raise ValueError(
                f"unknown preprocess {name!r} in spec {spec!r}; "
                f"registered preprocessors: {', '.join(available())}")
        d = _REGISTRY[name]
        given = [s.strip() for s in rest.split(":")] if rest else []
        if len(given) > len(d.param_names):
            raise ValueError(
                f"preprocess {name!r} takes at most {len(d.param_names)} "
                f"parameters ({':'.join(d.param_names)}); {part!r} has "
                f"{len(given)}")
        params = list(d.defaults)
        for i, tok in enumerate(given):
            try:
                params[i] = int(tok)
            except ValueError:
                raise ValueError(
                    f"bad {d.param_names[i]}={tok!r} in preprocess {part!r} "
                    f"(integer expected)") from None
            if params[i] < 0:
                raise ValueError(f"negative {d.param_names[i]} in "
                                 f"preprocess {part!r}")
        parts.append((name, tuple(params), len(given)))
    if len(parts) > 1:          # identity terms drop out of a composition
        parts = [t for t in parts if _REGISTRY[t[0]].apply is not None] or parts[:1]
    if len(parts) > 1:
        raise ValueError(
            f"preprocessing stages do not compose: {spec!r} (pick one of "
            f"{', '.join(available())})")
    name, params, n_given = parts[0]
    canon = name + "".join(f":{v}" for v in params[:n_given])
    return Preprocess(spec=canon, name=name, params=params)


def preprocess_summary(spec: str, rank: Optional[int] = None) -> Dict[str, Any]:
    """The canonical compress block of the ``--json`` summaries."""
    pp = parse_preprocess_spec(spec)
    out: Dict[str, Any] = {"spec": pp.spec}
    if not pp.identity and rank is not None:
        out["sketch_dim"] = pp.sketch_dim(rank)
        out["power_iters"] = pp.param("q")
    return out


# ---------------------------------------------------------------------------
# the compressed representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressedBucket:
    """One bucket after the QB pass.

    basis: [Kb, I_pad, S] per-subject orthonormal P_k (zero columns for
           rank-deficient directions and padding subjects), or None for a
           pass-through bucket (i_pad <= S already)
    core:  the CC core bucket (vals = G_k = P_k^T X_k [Kb, S, C_pad], the
           original kept-column metadata), or the original bucket unchanged
           when ``basis`` is None
    """

    basis: Optional[torch.Tensor]
    core: Any

    @property
    def compressed(self) -> bool:
        return self.basis is not None


@dataclasses.dataclass(frozen=True)
class CompressedData:
    """The compressed dataset handed from compress to fit to expand.

    ``data`` is the core :class:`Bucketed` the engines iterate on; its
    ``norm_sq`` is the ORIGINAL ``||X||_F^2``, the constant that makes the
    engines' core-space residual the full-space one. ``core_norm_sq`` is
    the cores' own energy ``sum_k ||G_k||^2`` (the captured fraction is
    ``core_norm_sq / norm_sq``); ``stats`` one record a bucket (format,
    i_pad, compressed, core_rows, energy).
    """

    spec: str
    data: Bucketed
    buckets: List[CompressedBucket]
    sketch_dim: int
    core_norm_sq: float
    stats: List[dict]


# ---------------------------------------------------------------------------
# the rsvd pass
# ---------------------------------------------------------------------------

def compress(data: Bucketed, opts, pp: Preprocess, *, seed: int = 0) -> CompressedData:
    """Per-bucket randomized QB: X_k -> (P_k, G_k); the cores become a
    :class:`Bucketed` on the data's device.

    One Gaussian Ω [J, S] sketches every bucket (so CC and SCOO layouts of
    the same data agree to rounding); the sketch and the power iterations
    go through the bucket contractions (SCOO buckets never densify); the
    Gram-eigh polar orthonormalizes, so that slices with fewer than S
    independent rows get zero basis columns. Buckets with ``i_pad <= S``
    pass through uncompressed.
    """
    S = pp.sketch_dim(opts.rank)
    q = pp.param("q")
    be = get_backend(opts.backend, data.device)
    Omega = _sketch.gaussian_sketch(seed, data.n_cols, S, opts.dtype, data.device)
    route = route_compress([(b.i_pad, b.c_pad) for b in data.buckets], S)
    cbuckets: List[CompressedBucket] = []
    stats: List[dict] = []
    core_sq = 0.0
    for b, do_compress in zip(data.buckets, route):
        b_sq = float(psum_subjects(b.sq_norms().sum()))
        rec = {"format": bucket_format(b), "i_pad": b.i_pad, "compressed": bool(do_compress)}
        if not do_compress:
            cbuckets.append(CompressedBucket(basis=None, core=b))
            core_sq += b_sq
            rec.update(core_rows=b.i_pad, energy=1.0)
        else:
            Y = be.sketch_bucket(b, Omega)                   # [Kb, I_pad, S]
            Y = _sketch.power_iterate(b, Y, q)
            P = polar_gram_eigh(Y) * b.subject_mask[:, None, None]
            del Y
            G = b.project(P)                                 # [Kb, S, C_pad]
            core = cc_bucket_like(b, G.to(opts.dtype),
                                  row_counts=torch.clamp(b.row_counts, max=S))
            cbuckets.append(CompressedBucket(basis=P, core=core))
            g_sq = float(psum_subjects(core.sq_norms().sum()))
            core_sq += g_sq
            rec.update(core_rows=S, energy=g_sq / max(b_sq, 1e-30))
        stats.append(rec)
    core_data = Bucketed(buckets=[cb.core for cb in cbuckets], n_subjects=data.n_subjects,
                         n_cols=data.n_cols,
                         norm_sq=data.norm_sq,   # the ORIGINAL norm: the fit is full-space
                         shard=data.shard)
    return CompressedData(spec=pp.spec, data=core_data, buckets=cbuckets, sketch_dim=S,
                          core_norm_sq=core_sq, stats=stats)


register_preprocess("none", PreprocessDef())
register_preprocess("rsvd", PreprocessDef(
    param_names=("r", "p", "q"), defaults=(0, 8, 1),
    apply=lambda pp, data, opts, seed: compress(data, opts, pp, seed=seed)))


# ---------------------------------------------------------------------------
# expansion and the residual-correction pass
# ---------------------------------------------------------------------------

def expand_q(comp: CompressedData, state, opts) -> List[torch.Tensor]:
    """The full-space Procrustes factors, per bucket: Q_k = P_k Q̃_k, with
    Q̃_k the core-space factor at the fitted state (the Procrustes stage on
    the core bucket; the engines never keep Q). For orthonormal-column P the
    product is the polar factor of the full-space target."""
    from repro_torch.core import parafac2 as p2

    be = get_backend(opts.backend, comp.data.device)
    out: List[torch.Tensor] = []
    for i, cb in enumerate(comp.buckets):
        _, _, Qc = p2._procrustes_project(cb.core, state.H, state.V, state.W, opts, i, be)
        out.append(Qc if cb.basis is None else torch.bmm(cb.basis, Qc))
    return out


def exact_fit(data: Bucketed, state, opts, Qs: List[torch.Tensor]) -> torch.Tensor:
    """The full-space model fit on the ORIGINAL buckets at explicit Q_k: the
    fit stage of ``als_step`` with fresh (not one step stale) Q, one pass
    over the originals through the backend's projection and Y_k V stages."""
    from repro_torch.core import parafac2 as p2

    be = get_backend(opts.backend, data.device)
    dt = opts.dtype
    H, V, W = state.H, state.V, state.W
    VtV = V.T @ V
    Phi = H.T @ H
    delta = torch.zeros((), dtype=dt, device=data.device)
    for i, (b, Q) in enumerate(zip(data.buckets, Qs)):
        proj = be.project_bucket(b, Q)
        G = be.ykv_bucket(b, proj, V)                       # [Kb, R, R]
        Wb = p2._w_rows(W, b, i)
        cross = torch.einsum("rl,krl,kl,k->", H, G.to(dt), Wb, b.subject_mask)
        model = torch.einsum("rl,rl,kr,kl,k->", Phi, VtV, Wb, Wb, b.subject_mask)
        delta = delta - 2.0 * cross + model
    norm_sq = data.norm_sq_tensor(dt)
    resid = norm_sq + psum_subjects(delta)
    return 1.0 - torch.sqrt(torch.clamp(resid, min=0.0)) / torch.sqrt(norm_sq)


def residual_correct(data: Bucketed, comp: CompressedData, state, opts):
    """``state`` with its fit replaced by the exact full-space fit at the
    expanded factors (H, V and W are full-space already; only Q expands)."""
    Qs = expand_q(comp, state, opts)
    return dataclasses.replace(state, fit=exact_fit(data, state, opts, Qs))


def fit_compressed(data: Bucketed, opts, *, max_iters: int = 100, tol: float = 1e-6,
                   seed: int = 0, verbose: bool = False, state=None):
    """compress -> the core ALS (the unchanged engines) -> expand and correct.

    ``repro_torch.core.parafac2.fit`` routes here whenever ``opts.compress``
    names a non-identity stage. Returns the usual ``(state, history)`` with
    full-space factors; the last history entry is the residual-corrected
    exact fit.
    """
    from repro_torch.core import parafac2 as p2

    pp = parse_preprocess_spec(opts.compress)
    core_opts = dataclasses.replace(opts, compress="none")
    if pp.identity:
        return p2.fit(data, core_opts, max_iters=max_iters, tol=tol, seed=seed,
                      verbose=verbose, state=state)
    collectives = contextlib.nullcontext()
    if opts.engine == "mesh":       # each rank's energies and residual are partial sums
        from repro_torch.core import engine as _engine
        collectives = _engine.mesh_collectives(data.device)
    with collectives:
        comp = pp.apply(data, core_opts, seed=seed)
        if verbose:
            frac = comp.core_norm_sq / max(comp.data.norm_sq, 1e-30)
            print(f"[compress] {pp.spec}: sketch_dim={comp.sketch_dim}, "
                  f"{sum(s['compressed'] for s in comp.stats)}/"
                  f"{len(comp.stats)} buckets compressed, "
                  f"captured energy {frac:.4f}")
        state, history = p2.fit(comp.data, core_opts, max_iters=max_iters, tol=tol,
                                seed=seed, verbose=verbose, state=state)
        state = residual_correct(data, comp, state, core_opts)
    if history:
        history[-1] = float(state.fit)
    return state, history
