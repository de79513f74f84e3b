"""What every kernel wrapper of the port shares: the library of one CUDA
source (built and loaded at first use, with its C signatures and the launch
counts of its wrappers) and the operand checks.

A wrapper takes its kernel's plain torch version only for tensors on the
CPU; for CUDA tensors it checks the operands, calls the C entry point on the
current stream through :meth:`KernelLib.launch`, which raises on a CUDA
error, and counts one launch. The one-launch reductions across subjects (F2,
rows 6 and 7) and P2's levels also take a workspace from
:class:`Workspaces`. Nothing here
builds or loads anything at import time.

At half precision nine kernels take half-width operands (bfloat16 or
float16) where they stream the slab or the projected slices:
:func:`dtype_codes` checks each kernel's combination and packs one dtype
code per streamed operand into the word its C entry point takes; every
other kernel takes one dtype of float32/float64 (:func:`dtype_code`).

A wrapper called while a CUDA graph captures counts its launch once, at
capture; the graph launches the kernel at every replay. The engine
(:mod:`repro_torch.core.engine`) takes the counts of a capture out with
:func:`held_launches` and adds them back once per replay with
:func:`add_launches`, over every library (:data:`LIBRARIES`). A graph bakes
in its workspaces' pointers, so it keeps a reference to every workspace
(:func:`workspace_tensors`) for as long as it lives.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import HALF_DTYPES, accum_dtype

__all__ = ["KernelLib", "Workspaces", "P", "I", "RING_VARIANTS", "LIBRARIES",
           "launch_counts", "add_launches", "held_launches", "workspace_tensors",
           "check_shapes",
           "check_index", "on_cpu", "dtype_code", "dtype_codes", "pack_codes",
           "mask_operand", "DTYPE_CODES"]

P = ctypes.c_void_p     # a pointer or the stream
I = ctypes.c_int        # an int (shape or dtype code)
# the dtype codes of the C entry points (common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
_FULL = (torch.float32, torch.float64)
# what the variant queries of rows 5, 8, 9, 11 and 12 return, by their C
# entry point's code (spartan_ykv_variant, spartan_mode2_compact_variant, ...)
RING_VARIANTS = ("ring", "ring-element-copies", "thread-per-entry")
LIBRARIES: List["KernelLib"] = []   # every KernelLib made, in order
_WORKSPACES: List["Workspaces"] = []  # every Workspaces made


class KernelLib:
    """``csrc/<source>.cu`` as a ctypes library, with ``launches[name]``
    counting each wrapper's kernel launches (plain-version calls on the CPU
    are not counted)."""

    def __init__(self, source: str, kernels: Sequence[str],
                 signatures: Dict[str, list]):
        self.source = source
        self.kernels = tuple(kernels)
        self.launches: Dict[str, int] = dict.fromkeys(self.kernels, 0)
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        LIBRARIES.append(self)

    def reset_launches(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    def lib(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, once per process."""
        if self._lib is None:
            from repro_torch.kernels import _build

            lib = _build.load(self.source)
            for fn, argtypes in self._signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, fn: str, dev: torch.device, *args,
               stream: Optional[int] = None) -> None:
        """Call the C entry point ``fn`` with ``args`` and ``stream`` (by
        default the current stream of ``dev``); raise on a CUDA error, else
        count one launch of ``name``."""
        switch = dev.index not in (None, torch.cuda.current_device())
        with torch.cuda.device(dev) if switch else contextlib.nullcontext():
            if stream is None:
                stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(self.lib(), fn)(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        self.launches[name] += 1


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every library's launch counts, by (source, kernel)."""
    return {(lib.source, k): n for lib in LIBRARIES for k, n in lib.launches.items()}


def add_launches(counts: Dict[Tuple[str, str], int]) -> None:
    """Add ``counts`` (by (source, kernel)) to the libraries' counts."""
    by_source = {lib.source: lib for lib in LIBRARIES}
    for (source, kernel), n in counts.items():
        by_source[source].launches[kernel] += n


@contextlib.contextmanager
def held_launches() -> Iterator[Dict[Tuple[str, str], int]]:
    """The launches counted inside the block, taken out of the libraries'
    counts and handed back in the dict this yields (filled on exit)."""
    before = launch_counts()
    held: Dict[Tuple[str, str], int] = {}
    try:
        yield held
    finally:
        for key, n in launch_counts().items():
            if n != before.get(key, 0):
                held[key] = n - before.get(key, 0)
        add_launches({key: -n for key, n in held.items()})


class Workspaces:
    """The workspaces of one library's reductions across subjects, one per
    (device, stream, accumulation dtype, R): the 32-bit ticket counter that each launch
    leaves at 0 and the first level's partials, in one tensor zeroed once
    when it is allocated. It grows when a larger bucket needs more partials.
    Its size comes from the C query ``query(dtype, K, R)``, asked once per
    (dtype, K, R), so a repeated call on the same shape allocates nothing
    and asks nothing.

    A launch that raises may have left its counter mid-way: :meth:`launch`
    then drops that workspace, and the next call allocates a fresh one."""

    def __init__(self, lib: KernelLib, query: str):
        self._lib = lib
        self._query = query
        self._elems: Dict[Tuple[int, int, int], int] = {}
        self._ws: Dict[tuple, torch.Tensor] = {}
        _WORKSPACES.append(self)

    def launch(self, name: str, fn: str, like: torch.Tensor, code: int, K: int,
               R: int, before: tuple, after: tuple) -> None:
        """``fn(code, *before, workspace, *after, stream)`` through
        :meth:`KernelLib.launch`, on the current stream of ``like``'s device
        and the workspace of that device, that stream, ``like``'s dtype and
        R, for K subjects. ``like`` is an operand of the accumulation dtype
        (float32 or float64; Wb, whose dtype it is also at half precision),
        which keys, sizes and types the workspace; ``code`` is the kernel's
        dtype word."""
        dev = like.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        acc = DTYPE_CODES[like.dtype]
        key = (dev.index, stream, acc, R)
        need = self._elems.get((acc, K, R))
        if need is None:
            need = self._elems[(acc, K, R)] = getattr(self._lib.lib(), self._query)(acc, K, R)
            if need < 0:
                raise ValueError(f"{name}: no workspace for K={K}, R={R}")
        ws = self._ws.get(key)
        if ws is None or ws.numel() < need:
            ws = self._ws[key] = torch.zeros(need, dtype=like.dtype, device=dev)
        try:
            self._lib.launch(name, fn, dev, code, *before, ws.data_ptr(), *after,
                             stream=stream)
        except RuntimeError:
            del self._ws[key]
            raise


def workspace_tensors() -> List[torch.Tensor]:
    """Every workspace tensor that the libraries hold now. A workspace
    that grows is replaced in its library's dict, and a captured graph that
    still names the old one must keep it alive."""
    return [t for w in _WORKSPACES for t in w._ws.values()]


def check_shapes(**shapes_and_want) -> None:
    for name, (t, want) in shapes_and_want.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(want)}")


def check_index(**index_arrays) -> None:
    """Raise unless every index operand is int32 and contiguous, as the C
    entry points read them."""
    for name, t in index_arrays.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the kernels take contiguous tensors ({name} is not)")


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU, or on the meta device (the
    planner's shape-only run, :mod:`repro_torch.launch.dryrun`), where a
    wrapper takes its plain version; raise if they lie on several
    devices."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    return next(iter(devs)).type in ("cpu", "meta")


def _on_card(ts: Sequence[torch.Tensor]) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernels take contiguous tensors")


def dtype_code(*ts: torch.Tensor) -> int:
    """Raise on what the kernels do not take (a non-CUDA tensor, a dtype
    other than one of float32/float64 for all operands, a non-contiguous
    operand); return the dtype code the C entry points take."""
    _on_card(ts)
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or ts[0].dtype not in _FULL:
        raise TypeError(f"the kernels take one dtype of float32/float64, "
                        f"got {sorted(map(str, dtypes))}")
    return DTYPE_CODES[ts[0].dtype]


def pack_codes(codes: Sequence[int]) -> int:
    """The dtypes word of common.cuh's ``operand_code``: the first code in
    bits 0-3, code j in bits 4j to 4j+3 as one more than itself where it
    differs from the first (0 there: the first's)."""
    word = codes[0]
    for j, c in enumerate(codes[1:], 1):
        if c != codes[0]:
            word |= (c + 1) << (4 * j)
    return word


def dtype_codes(streamed: Sequence[torch.Tensor], *others: torch.Tensor,
                paired: bool = True) -> int:
    """Check the operands of a kernel that takes half-width ``streamed``
    operands (the slab, Yc, Vg) beside float ``others``, and return the
    dtypes word its C entry point takes (:func:`pack_codes`).

    Without a half operand every operand has one dtype of float32/float64,
    as :func:`dtype_code` asks. With one, every other operand is float32,
    the half operands share one half dtype, and each streamed operand is
    that dtype or float32; ``paired`` (F1, F4, row 11) asks the streamed
    operands to share one dtype. Anything else raises a TypeError (f64 with
    a half operand, bfloat16 with float16, a half operand the kernel does
    not stream); a non-CUDA or non-contiguous operand a ValueError."""
    ts = (*streamed, *others)
    _on_card(ts)
    halves = {t.dtype for t in streamed if t.dtype in HALF_DTYPES}
    if not halves:
        return dtype_code(*ts)
    full = {t.dtype for t in ts if t.dtype not in HALF_DTYPES}
    stream_dtypes = {t.dtype for t in streamed}
    if (len(halves) != 1 or any(t.dtype in HALF_DTYPES for t in others)
            or not full <= {torch.float32} or (paired and len(stream_dtypes) != 1)):
        want = ("one half dtype (bfloat16 or float16) for the streamed operands "
                + ("together" if paired else "or float32 for each"))
        raise TypeError(f"at half precision the kernel takes {want} and float32 for "
                        f"the others, got streamed {[str(t.dtype) for t in streamed]}, "
                        f"others {[str(t.dtype) for t in others]}")
    return pack_codes([DTYPE_CODES[t.dtype] for t in streamed])


def mask_operand(subject_mask: Optional[torch.Tensor], like: torch.Tensor) -> tuple:
    """A kernel's nullable subject-mask operand: () without a subject mask,
    else (the mask [K] in the accumulation dtype of ``like``,), checked
    against the K of ``like`` (an operand whose first axis is the subjects:
    Wb, Yc, YkV)."""
    if subject_mask is None:
        return ()
    check_shapes(subject_mask=(subject_mask, like.shape[:1]))
    acc = accum_dtype(like)
    return (subject_mask if subject_mask.dtype == acc else subject_mask.to(acc),)
