"""Device-resident ALS engines (``repro.core.engine``): the scan engine in
chunks and its while variant, as CUDA graphs.

The host loop (``parafac2.fit`` with ``engine="host"``) launches every
kernel of an iteration from Python and reads the fit back every iteration.
The reference runs the same algebra as one compiled program a chunk; in
PyTorch the counterpart of a compiled chunk is a captured CUDA graph:

``engine="scan"``, ``opts.check_every > 0``
    One ALS iteration captured once into a CUDA graph and replayed
    ``check_every`` times a chunk (fewer for the remainder): the state, a
    fit buffer and the iteration counter that indexes it are the graph's own
    tensors, so replays chain with no host work and no host sync, and the
    host reads the fits once a chunk for the tol check. Whole chunks run
    past the tol crossing, so ``history[-1]`` is the returned state's fit.

``engine="scan"``, ``opts.check_every = 0`` (the while variant)
    The same captured iteration with the host loop's stopping rule live:
    each replay computes ``stop = (i > 0) & (|f - prev| < tol)`` on the
    device and commits its new state only while not stopped (a
    graph cannot branch on data); in a chunk the rule's tol is -inf, so it
    never fires. The fit history goes to a ``[max_iters]`` device buffer.
    The host replays without waiting for each one: it copies the stop flag
    to pinned memory after each replay and, with two replays in flight,
    waits for the older one's event before it launches another, so that at
    most one masked iteration runs past the stop. State and history equal
    the host loop's.

A fit keeps its chunk (or while variant) for the next fit on the same
data (:data:`CHUNKS`), as the reference's ``jax.jit`` keeps its compiled
program across calls on the same shapes: a second ``fit(engine="scan")`` on
the same ``Bucketed`` object with the same options, state layout, shapes,
dtypes, device and chunk length (max_iters and tol for the while variant)
replays the kept graph with no warm-up and no capture. One entry a data
object, held by a weak reference to the data: the entry, its graph and the
graph's memory go when the data goes, or at :func:`clear_chunk_cache`. A
kept chunk refers to its data weakly too (a strong reference would keep the
data alive through the cache), and ``fit_device`` returns a copy of the
state, since the chunk's carry is overwritten by the next fit.

On the CPU both run the same iteration eagerly (no graphs; the while
variant reads its flag each iteration and runs no masked iteration). On a
GPU ``engine="scan"`` always captures: a capture that fails raises, it never
runs the eager loop instead, and a fit whose iteration cannot be captured
is refused before any warm-up: ``procrustes="svd"`` (``torch.linalg.svd``
on CUDA reads its error flags back to the host, a sync that a capture
refuses) raises a ValueError that names the method. Before the capture, ``WARMUP_ITERS`` iterations
run on a copy of the state, on the stream the capture uses: they load the
kernel libraries and make the cuBLAS and cuSOLVER handles, the kernels'
workspaces (kept per stream, :class:`repro_torch.kernels._launch.Workspaces`)
and the occupancy answers outside any graph. Their launches are set-up,
kept in ``setup_launches``; a replay adds the launches it replays to the
libraries' counts (:func:`repro_torch.kernels._launch.add_launches`). The
graph keeps every workspace it may name alive for as long as it lives.

``engine="mesh"``
    The scan engine's chunk and while variant on one rank's shard of the
    subjects, a process a GPU (the reference's ``shard_map`` over the
    subject axis). Each rank holds its own contiguous chunk of every bucket
    (``bucketize(shard=...)``, made on the host before the upload) and a
    bucketed W's rows for it; H, V, a global W, the fit and the counters
    are the same on every rank. Each iteration runs inside
    :func:`repro_torch.dist.sharding.subject_collectives`, so every sum
    over subjects in ``als_step`` is an ``all_reduce(SUM)`` over the
    subject dimensions of the mesh (:func:`mesh_wrap`); the all-reduce
    gives every rank the same bits, so the replicas stay bit for bit
    equal. On CUDA (NCCL) the iteration is captured as the scan engine's
    is, with the all-reduces inside the graph (the capture in thread-local
    mode, so that NCCL's watchdog thread may query its events meanwhile);
    on the CPU (gloo) it runs eagerly. The mesh is the installed one
    (``axis_rules``), else the world's ranks as a ``("data", "model")``
    mesh (:func:`repro_torch.launch.mesh.local_mesh`, a world of one if no
    process group is up). Each rank's data must be its own shard: whole
    data in a world of more than one raises (the reference's
    divisibility error first, where it applies), since no rank may hold
    another's subjects.

:func:`make_subject_update` is the serving dispatch
(``repro_torch.launch.stream``): the request batch is an argument of each
call, and the call runs eagerly (a CUDA graph a pinned batch geometry is
untried work, ROADMAP A5).

Below f32 ``opts.precision`` the iteration makes the buckets' half values
(:meth:`~repro_torch.core.irregular.Bucketed.with_compute_values`) before
the warm-up, outside any capture, and its body closes over that data: the
graph holds them alive as it holds its workspaces, and every replay reads
them.

The carry holds every tensor of the state under a fixed name, each with a
static buffer: H, V, W (one tensor, or one a bucket in the bucketed layout),
the fit and the constraint layer's ADMM duals (:func:`_flatten`); each is
committed through ``torch.where`` like the others. The default constraint
bundle has no duals, so its iteration launches what it launched before the
duals were carried.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro_torch.core import constraints as cst
from repro_torch.core import parafac2 as p2
from repro_torch.core.irregular import check_shardable
from repro_torch.dist import sharding as dsh
from repro_torch.kernels import _launch

__all__ = ["CHUNKS", "ENGINES", "WARMUP_ITERS", "als_chunk_fn", "cached_chunk",
           "cached_while", "clear_chunk_cache", "clone_state", "fit_device",
           "make_als_chunk", "make_als_while", "make_subject_update", "mesh_collectives",
           "mesh_wrap", "resolve_mesh", "state_placements"]

ENGINES = ("host", "scan", "mesh")
WARMUP_ITERS = 2        # eager iterations on a copy of the state before a capture
Carry = Dict[str, torch.Tensor]
Mesh = Tuple[object, Tuple[str, ...]]    # (DeviceMesh, its subject dimensions)


# ---------------------------------------------------------------------------
# mesh plumbing
# ---------------------------------------------------------------------------

def _check_divisible(data, state, n_shards: int) -> None:
    """The reference's check on whole data: every bucket's Kb (and a
    bucketed W's rows) must divide into ``n_shards`` chunks."""
    for i, b in enumerate(data.buckets):
        check_shardable(i, b.kb, n_shards)
    if isinstance(state.W, tuple):
        for i, wb in enumerate(state.W):
            if wb.shape[0] % n_shards:
                raise ValueError(
                    f"bucketed W shard {i} has Kb={wb.shape[0]}, not divisible "
                    f"by {n_shards} subject shards")


def _check_shard(data, state, mesh, axes: Tuple[str, ...]) -> None:
    """Raise unless ``data`` is this rank's shard of the subjects on
    ``mesh`` and a bucketed W holds this rank's rows of every bucket."""
    index, count = dsh.subject_shard(mesh, axes)
    if tuple(data.shard) != (index, count):
        if tuple(data.shard) == (0, 1):
            _check_divisible(data, state, count)
            raise ValueError(
                f"engine='mesh' runs on each rank's own shard of the subjects, but "
                f"rank {index} of {count} was given the whole data; bucketize it with "
                f"subject_align={count}, shard=({index}, {count})")
        raise ValueError(f"the data is subject shard {tuple(data.shard)}, but this rank "
                         f"is shard ({index}, {count}) of the mesh")
    if isinstance(state.W, tuple):
        for i, (wb, b) in enumerate(zip(state.W, data.buckets)):
            if wb.shape[0] != b.kb:
                raise ValueError(
                    f"bucketed W bucket {i} has {wb.shape[0]} rows, this rank's shard "
                    f"of the bucket {b.kb}: give each rank its own rows "
                    f"(repro_torch.convert.state_from_arrays(..., shard=...))")


def state_placements(state: "p2.Parafac2State") -> "p2.Parafac2State":
    """Each state tensor's placement across the mesh engine's ranks (the
    state half of the reference's ``_mesh_specs``): a bucketed W, and the W
    duals of a bucketed W, ``Shard(0)`` (each rank its subjects' rows);
    H, V, a global W, the fit and every other dual ``Replicate()``."""
    bucketed = isinstance(state.W, tuple)

    def like(x, p):
        return cst.tree_map(lambda _: p, x)

    lead = Shard(0) if bucketed else Replicate()
    aux = state.aux
    if isinstance(aux, dict):
        aux = {k: like(v, lead if k == "w" else Replicate()) for k, v in aux.items()}
    else:
        aux = like(aux, Replicate())
    return p2.Parafac2State(H=Replicate(), V=Replicate(), W=like(state.W, lead),
                            fit=Replicate(), aux=aux)


def resolve_mesh(device) -> Mesh:
    """The installed mesh, else the world's local mesh on ``device``'s kind
    (NCCL for CUDA, gloo for the CPU), with its subject dimensions."""
    mesh = dsh.current_mesh()
    if mesh is None:
        from repro_torch.launch.mesh import local_mesh
        mesh = local_mesh(torch.device(device).type)
    axes = dsh.subject_mesh_axes(mesh)
    if not axes:
        raise ValueError(
            f"engine='mesh': no 'subjects' rule axis present on mesh "
            f"{mesh.mesh_dim_names}; install axis_rules with a subjects entry")
    return mesh, axes


def mesh_collectives(device):
    """``subject_collectives`` over the resolved mesh's subject dimensions
    (for data on ``device``): what the mesh engine enters around an
    iteration, for the sums over subjects that run outside it (the
    compression pass, the exact fit, ``w_global``)."""
    mesh, axes = resolve_mesh(device)
    return dsh.subject_collectives(axes, mesh)


def mesh_wrap(fn: Callable, data, state, mesh=None,
              axes: Optional[Tuple[str, ...]] = None) -> Callable:
    """Wrap a ``(data, state) -> outputs`` ALS body for the mesh engine:
    ``data`` must be this rank's shard (:func:`_check_shard`), and the body
    runs inside ``subject_collectives``, so that every ``psum_subjects`` in
    it is an all-reduce over the subject dimensions of ``mesh``."""
    if mesh is None or axes is None:
        r_mesh, r_axes = resolve_mesh(data.device)
        mesh = mesh if mesh is not None else r_mesh
        axes = axes if axes is not None else dsh.subject_mesh_axes(mesh)
    _check_shard(data, state, mesh, axes)

    def body(d, s):
        with dsh.subject_collectives(axes, mesh):
            return fn(d, s)

    return body


def als_chunk_fn(opts: "p2.Parafac2Options", length: int) -> Callable:
    """The ``(data, state) -> (state, fits[length])`` chunk body: ``length``
    ALS iterations, the fit of each stacked."""

    def chunk(d, s):
        fits = []
        for _ in range(length):
            s = p2.als_step(d, s, opts)
            fits.append(s.fit)
        return s, torch.stack(fits)

    return chunk


_FIELDS = ("H", "V", "W", "fit", "aux")   # the state's fields, in the carry's order


def _walk(x, name: str, leaves: List[Tuple[str, torch.Tensor]]):
    """``x``'s nesting with each tensor replaced by its fixed name, each
    tensor appended to ``leaves`` as ``(name, tensor)``: ``W`` or ``W.0``,
    ``W.1``, ... for a per-bucket W; ``aux.v.0`` and ``aux.v.1`` for V's
    ADMM pair, ``aux.w.<bucket>.<0|1>`` for per-bucket duals."""
    if isinstance(x, torch.Tensor):
        leaves.append((name, x))
        return name
    if isinstance(x, dict):
        return {k: _walk(v, f"{name}.{k}", leaves) for k, v in x.items()}
    parts = [_walk(v, f"{name}.{k}", leaves) for k, v in enumerate(x)]
    return parts if isinstance(x, list) else tuple(parts)


def _split(state: "p2.Parafac2State") -> Tuple[dict, List[Tuple[str, torch.Tensor]]]:
    """(the skeleton of each state field, by field name; every tensor of
    ``state``, H, V, W, fit and then the duals, each under its fixed name)."""
    leaves: List[Tuple[str, torch.Tensor]] = []
    skel = {f: _walk(getattr(state, f), f, leaves) for f in _FIELDS}
    return skel, leaves


def _flatten(state: "p2.Parafac2State") -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of ``state`` under its fixed name, in the carry's order."""
    return _split(state)[1]


def clone_state(state: "p2.Parafac2State") -> "p2.Parafac2State":
    """The state with every tensor cloned (a chunk's returned state is its
    carry, which its next call overwrites)."""
    return p2.Parafac2State(**{f: cst.tree_map(torch.clone, getattr(state, f))
                               for f in _FIELDS})


def _state(skel: dict, c: Carry) -> "p2.Parafac2State":
    """The state held in the carry ``c`` (``skel``: the skeleton of each
    state field, by field name)."""
    return p2.Parafac2State(**{f: cst.tree_map(c.__getitem__, v) for f, v in skel.items()})


def _check_capturable(opts: "p2.Parafac2Options", device: torch.device) -> None:
    """Raise unless one ALS iteration of ``opts`` can be captured into a CUDA
    graph on ``device`` (any iteration runs eagerly on the CPU)."""
    if torch.device(device).type == "cuda" and opts.procrustes == "svd":
        raise ValueError(
            "engine='scan' captures each ALS iteration into a CUDA graph, and "
            "procrustes='svd' cannot be captured: torch.linalg.svd on CUDA reads its "
            "error flags back to the host; use procrustes='gram_eigh' or "
            "'newton_schulz', or engine='host'")


class _Iteration:
    """One ALS iteration on a carry of static tensors, with the host loop's
    stopping rule on the device: ``stop = (n > 0) & (|f - prev| < tol)``,
    the new state committed only while not stopped, the fit
    written to ``hist[n]`` and ``n`` counting the committed iterations
    (``tol = -inf``: never stopped). Run eagerly on the CPU; on CUDA
    captured once, after ``WARMUP_ITERS`` eager runs on a copy of the carry
    on the capture stream, and replayed on the current stream. With
    ``mesh`` (the mesh engine's (DeviceMesh, subject dimensions)) the step
    runs through :func:`mesh_wrap`, its all-reduces captured with it."""

    def __init__(self, data, opts: "p2.Parafac2Options", hist_len: int, tol: float,
                 state: "p2.Parafac2State", weak: bool = False,
                 mesh: Optional[Mesh] = None):
        # the state's structure (W layout, duals) without its tensors; the
        # body must not reference self: a cycle would leave a dropped graph
        # to the garbage collector, which could then destroy it while a new
        # capture runs and so invalidate that capture
        skel, leaves = _split(state)
        get_data = _data_getter(data, opts.precision, weak)   # before any warm-up

        def step(d, s):
            return p2.als_step(d, s, opts)

        if mesh is None and opts.engine == "mesh":
            mesh = resolve_mesh(state.H.device)
        if mesh is not None:
            step = mesh_wrap(step, data, state, *mesh)

        def body(c: Carry) -> None:
            s2 = step(get_data(), _state(skel, c))
            f = s2.fit
            go = ~c["stop"]
            n = c["n"]
            stop_now = (n > 0) & (torch.abs(f - c["prev"]) < tol)
            c["hist"].index_copy_(0, n.clamp(max=hist_len - 1).view(1), f.view(1))
            for k, new in _flatten(s2):
                c[k].copy_(torch.where(go, new, c[k]))
            c["prev"].copy_(torch.where(go, f, c["prev"]))
            c["stop"].logical_or_(go & stop_now)
            n.add_(go.to(n.dtype))

        dt, dev = opts.dtype, state.H.device
        _check_capturable(opts, dev)
        self.body = body
        self._get_data = get_data
        self._skel, self._names = skel, [k for k, _ in leaves]
        self.carry: Carry = {k: t.to(dtype=dt).clone() for k, t in leaves}
        self.carry.update(hist=torch.full((hist_len,), -np.inf, dtype=dt, device=dev),
                          n=torch.zeros((), dtype=torch.int64, device=dev),
                          prev=torch.full((), -np.inf, dtype=dt, device=dev),
                          stop=torch.zeros((), dtype=torch.bool, device=dev))
        self.mesh = mesh        # kept alive with the graph that uses its groups
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[Tuple[str, str], int] = {}        # what a replay launches
        self.setup_launches: Dict[Tuple[str, str], int] = {}  # the warm-up's
        self._workspaces: List[torch.Tensor] = []
        if dev.type != "cuda":
            return
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), _launch.held_launches() as self.setup_launches:
            scratch = {k: v.clone() for k, v in self.carry.items()}
            for _ in range(WARMUP_ITERS):
                body(scratch)
            del scratch
        torch.cuda.current_stream(dev).wait_stream(stream)
        # capture_begin/end rather than the torch.cuda.graph context, which
        # first synchronises the device and empties the allocator's cache (a
        # set-up cost of every capture that the capture does not need). The
        # mesh engine's capture waits for the warm-up's collectives and runs
        # in thread-local mode: NCCL's watchdog thread queries their events
        mode = "global"
        if mesh is not None:
            torch.cuda.synchronize(dev)
            mode = "thread_local"
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), _launch.held_launches() as self.launches:
            self.graph.capture_begin(capture_error_mode=mode)
            try:
                body(self.carry)
            finally:
                self.graph.capture_end()
        self._workspaces = _launch.workspace_tensors()

    def state(self, c: Carry) -> "p2.Parafac2State":
        """The state held in the carry ``c``."""
        return _state(self._skel, c)

    def start(self, state: "p2.Parafac2State") -> None:
        """Load ``state``'s tensors (those that are not the carry's own) and
        reset the history, the counter and the stop."""
        c = self.carry
        if self._get_data() is None:
            raise RuntimeError("the data this chunk was made for is gone: its graph "
                               "would read freed memory")
        leaves = _flatten(state)
        if [k for k, _ in leaves] != self._names:     # empty containers may differ
            raise ValueError("the state's W layout or constraint duals differ from "
                             "those the iteration was made for")
        for k, src in leaves:
            if src is not c[k]:
                c[k].copy_(src)
        c["hist"].fill_(-np.inf)
        c["n"].zero_()
        c["prev"].fill_(-np.inf)
        c["stop"].zero_()

    def run(self) -> None:
        if self.graph is None:
            self.body(self.carry)
            return
        self.graph.replay()
        _launch.add_launches(self.launches)


def _data_getter(data, precision: str, weak: bool) -> Callable:
    """What the iteration's body calls for its data: the data at the compute
    precision (its half values made here, once), held strongly; a kept
    chunk's own data (f32) held weakly, so that the cache's entry, keyed
    weakly by that data, does not keep it alive."""
    data_c = data.with_compute_values(precision)
    if weak and data_c is data:
        return weakref.ref(data)
    return lambda: data_c


class AlsChunk:
    """``state -> (state, fits[length])``: ``length`` ALS iterations, as
    ``length`` replays of one captured iteration on a GPU. The state is
    donated: the returned state and fits are the chunk's own tensors, which
    its next call overwrites. ``chunk(state, n)`` runs the first ``n <=
    length`` (a fit's remainder)."""

    def __init__(self, data, opts: "p2.Parafac2Options", length: int,
                 state: "p2.Parafac2State", weak: bool = False,
                 mesh: Optional[Mesh] = None):
        if length < 1:
            raise ValueError(f"a chunk runs at least one iteration, got length={length}")
        self.length = length
        self._it = _Iteration(data, opts, length, -np.inf, state, weak, mesh)

    @property
    def setup_launches(self) -> Dict[Tuple[str, str], int]:
        return self._it.setup_launches

    def __call__(self, state: "p2.Parafac2State", n: Optional[int] = None):
        n = self.length if n is None else n
        if not 0 < n <= self.length:
            raise ValueError(f"a chunk of {self.length} runs 1 to {self.length} "
                             f"iterations, got {n}")
        self._it.start(state)
        for _ in range(n):
            self._it.run()
        c = self._it.carry
        return self._it.state(c), c["hist"][:n]


def make_als_chunk(data, opts: "p2.Parafac2Options", length: int, *,
                   state: Optional["p2.Parafac2State"] = None) -> AlsChunk:
    """``state -> (state, fits[length])``: ``length`` ALS iterations, on a GPU
    one iteration captured once into a CUDA graph and replayed ``length``
    times at each call. ``state`` gives the shapes, dtypes and device (and
    the warm-up's start); by default ``init_state(data, opts)``."""
    if state is None:
        state = p2.init_state(data, opts)
    return AlsChunk(data, opts, length, state)


class AlsWhile:
    """``state -> (state, hist[max_iters], n)``: the host loop's stopping
    rule on the device (``make_als_while``). ``replays`` is the number of
    iterations the last call ran, masked ones included; ``n`` of them
    committed."""

    LOOKAHEAD = 2       # replays in flight on a GPU

    def __init__(self, data, opts: "p2.Parafac2Options", max_iters: int, tol: float,
                 state: "p2.Parafac2State", weak: bool = False,
                 mesh: Optional[Mesh] = None):
        self.max_iters = max_iters
        self.replays = 0
        self._it = _Iteration(data, opts, max_iters, tol, state, weak, mesh)

    @property
    def setup_launches(self) -> Dict[Tuple[str, str], int]:
        return self._it.setup_launches

    def __call__(self, state: "p2.Parafac2State"):
        it, c = self._it, self._it.carry
        it.start(state)
        self.replays = 0
        if it.graph is None:                       # the CPU: read the flag each time
            while self.replays < self.max_iters and not bool(c["stop"]):
                it.run()
                self.replays += 1
        else:
            flags = torch.zeros(self.max_iters, dtype=torch.bool, pin_memory=True)
            events: List[torch.cuda.Event] = []
            for i in range(self.max_iters):
                j = i - self.LOOKAHEAD
                if j >= 0:
                    events[j].synchronize()        # replay j is done: its flag is here
                    if bool(flags[j]):
                        break
                it.run()
                flags[i].copy_(c["stop"], non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record()
                self.replays += 1
        return it.state(c), c["hist"], c["n"]


def make_als_while(data, opts: "p2.Parafac2Options", max_iters: int, tol: float, *,
                   state: Optional["p2.Parafac2State"] = None) -> AlsWhile:
    """``state -> (state, hist[max_iters], n_iters)``: the whole fit with the
    host loop's stopping rule (stop after the first iteration ``i > 0`` with
    ``|fit_i - fit_{i-1}| < tol``) evaluated on the device; on a GPU one
    captured iteration replayed until the host sees the stop flag."""
    if state is None:
        state = p2.init_state(data, opts)
    return AlsWhile(data, opts, max_iters, tol, state)


class ChunkCache:
    """The chunks and while variants kept across fits, at most one a data
    object: ``id(data) -> (weak reference to data, key, run)``. The key is
    what the capture depends on besides the data: the kind and its length
    (or max_iters and tol), the options, and the name, shape and dtype of
    every state tensor with their device. An entry goes when its data goes
    (the weak reference's callback), when another key is asked for on the
    same data (before the new one is made, so that its graph's memory is
    free for the capture), or at :meth:`clear`. ``made`` and ``reused``
    count the runs made and handed out again."""

    def __init__(self):
        self._entries: Dict[int, tuple] = {}
        self.made = 0
        self.reused = 0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every kept chunk (and its graph)."""
        self._entries.clear()

    def _drop(self, i: int, ref: weakref.ref) -> None:
        entry = self._entries.get(i)
        if entry is not None and entry[0] is ref:
            del self._entries[i]

    def get(self, data, key: tuple, make: Callable[[bool], Callable]) -> Callable:
        """The run kept for ``data`` under ``key``, else ``make(weak=True)``,
        kept in place of the data's old entry. Data that takes no weak
        reference is not kept: ``make(weak=False)``."""
        i = id(data)
        entry = self._entries.get(i)
        if entry is not None and entry[0]() is data and entry[1] == key:
            self.reused += 1
            return entry[2]
        try:
            ref = weakref.ref(data, lambda r, i=i: self._drop(i, r))
        except TypeError:
            self.made += 1
            return make(False)
        self._entries.pop(i, None)
        del entry           # the old run and its graph go before the new capture
        run = make(True)
        self.made += 1
        self._entries[i] = (ref, key, run)
        return run


CHUNKS = ChunkCache()
clear_chunk_cache = CHUNKS.clear


def _mesh_of(opts: "p2.Parafac2Options", device) -> Optional[Mesh]:
    return resolve_mesh(device) if opts.engine == "mesh" else None


def _key(kind: str, opts: "p2.Parafac2Options", state: "p2.Parafac2State", *extra,
         mesh: Optional[Mesh] = None) -> tuple:
    # a kept run holds its mesh, so the mesh's id names it while the entry lives
    mesh_key = None if mesh is None else (id(mesh[0]), mesh[1])
    return (kind, *extra, opts, mesh_key, str(state.H.device),
            tuple((k, tuple(t.shape), t.dtype) for k, t in _flatten(state)))


def cached_chunk(data, opts: "p2.Parafac2Options", length: int, *,
                 state: "p2.Parafac2State") -> AlsChunk:
    """:func:`make_als_chunk`'s chunk, kept in :data:`CHUNKS` for the next
    call on the same data, options, state layout, mesh and length."""
    mesh = _mesh_of(opts, state.H.device)
    return CHUNKS.get(data, _key("chunk", opts, state, length, mesh=mesh),
                      lambda weak: AlsChunk(data, opts, length, state, weak, mesh))


def cached_while(data, opts: "p2.Parafac2Options", max_iters: int, tol: float, *,
                 state: "p2.Parafac2State") -> AlsWhile:
    """:func:`make_als_while`'s run, kept in :data:`CHUNKS` as
    :func:`cached_chunk` keeps a chunk (keyed by max_iters and tol too)."""
    mesh = _mesh_of(opts, state.H.device)
    return CHUNKS.get(data, _key("while", opts, state, max_iters, tol, mesh=mesh),
                      lambda weak: AlsWhile(data, opts, max_iters, tol, state, weak, mesh))


def make_subject_update(opts: "p2.Parafac2Options", *, smooth_lam: float = 0.0,
                        inner_iters: int = 1) -> Callable:
    """``(batch, H, V, w_init, w_prev, prev_mask) -> (W, resid)``: the
    incremental-subject dispatch (:func:`repro_torch.core.parafac2.
    update_subjects`) with the options bound and the request batch an
    argument of each call, as the streaming service dispatches one batch
    after another. The reference compiles one program a batch geometry;
    here each call launches the same kernels eagerly."""

    def update(batch, H, V, w_init, w_prev, prev_mask):
        return p2.update_subjects(batch, H, V, opts, w_init=w_init, w_prev=w_prev,
                                  prev_mask=prev_mask, smooth_lam=smooth_lam,
                                  inner_iters=inner_iters)

    return update


def fit_device(data, opts: "p2.Parafac2Options", *, max_iters: int = 100,
               tol: float = 1e-6, seed: int = 0, verbose: bool = False,
               state: Optional["p2.Parafac2State"] = None
               ) -> Tuple["p2.Parafac2State", List[float]]:
    """The device-resident fitting loop (the ``engine="scan"|"mesh"`` halves
    of :func:`repro_torch.core.parafac2.fit`; same signature and return
    contract). Under ``"mesh"`` every rank calls it on its own shard."""
    if opts.engine not in ENGINES:
        raise ValueError(f"unknown engine {opts.engine!r}; choose from {ENGINES}")
    if opts.engine == "host":
        raise ValueError("fit_device handles the device engines; "
                         "engine='host' is parafac2.fit's own loop")
    if opts.compress not in ("", "none"):
        # the compression pass is preprocessing above the engines:
        # parafac2.fit compresses, then comes back here with compress="none"
        # on the core data
        raise ValueError(
            f"fit_device runs the core ALS only (compress={opts.compress!r}); "
            f"route compressed fits through repro_torch.core.parafac2.fit")
    state = p2.init_state(data, opts, seed, state=state)
    if max_iters <= 0:          # nothing to capture: the host loop's answer
        return state, []

    # the run is kept for the next fit on this data (CHUNKS), which
    # overwrites its carry: the state returned is a copy
    if opts.check_every <= 0:
        run = cached_while(data, opts, max_iters, tol, state=state)
        state, hist, n = run(state)
        n = int(n)
        history = hist[:n].tolist()
        if verbose:
            print(f"[engine:{opts.engine}/while] {n} iters, {run.replays - n} masked, "
                  f"fit={history[-1] if history else float('nan'):.6f}")
        return clone_state(state), history

    # chunks of check_every iterations (the last one shorter), one host read
    # of the fits a chunk
    chunk = cached_chunk(data, opts, min(opts.check_every, max_iters), state=state)
    history: List[float] = []
    prev = -np.inf
    done = False
    while len(history) < max_iters and not done:
        state, fits = chunk(state, min(chunk.length, max_iters - len(history)))
        for f in fits.tolist():                 # one device sync a chunk
            history.append(float(f))
            if len(history) > 1 and abs(f - prev) < tol:
                done = True                     # stop launching; keep the whole
            prev = f                            # chunk so history[-1] == state.fit
        if verbose:
            print(f"[engine:{opts.engine}] iter {len(history) - 1:3d}  "
                  f"fit={history[-1]:.6f}")
    return clone_state(state), history
