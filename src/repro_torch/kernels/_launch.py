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

__all__ = ["KernelLib", "Workspaces", "P", "I", "RING_VARIANTS", "LIBRARIES",
           "launch_counts", "add_launches", "held_launches", "workspace_tensors",
           "check_shapes",
           "check_index", "on_cpu", "dtype_code", "mask_operand"]

P = ctypes.c_void_p     # a pointer or the stream
I = ctypes.c_int        # an int (shape or dtype code)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
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
    (device, stream, dtype, R): the 32-bit ticket counter that each launch
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
        R, for K subjects."""
        dev = like.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev.index, stream, code, R)
        need = self._elems.get((code, K, R))
        if need is None:
            need = self._elems[(code, K, R)] = getattr(self._lib.lib(), self._query)(code, K, R)
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
    """True when every operand lies on the CPU; raise if they lie on
    several devices."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    return next(iter(devs)).type == "cpu"


def dtype_code(*ts: torch.Tensor) -> int:
    """Raise on what the kernels do not take (a non-CUDA tensor, a dtype
    other than one of float32/float64 for all operands, a non-contiguous
    operand); return the dtype code the C entry points take."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {dev}")
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or ts[0].dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernels take one dtype of float32/float64, "
                        f"got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernels take contiguous tensors")
    return _DTYPE_CODE[ts[0].dtype]


def mask_operand(subject_mask: Optional[torch.Tensor], like: torch.Tensor) -> tuple:
    """A kernel's nullable subject-mask operand: () without a subject mask,
    else (the mask [K] in the dtype of ``like``,), checked against the K of
    ``like`` (an operand whose first axis is the subjects: Wb, Yc, YkV)."""
    if subject_mask is None:
        return ()
    check_shapes(subject_mask=(subject_mask, like.shape[:1]))
    return (subject_mask if subject_mask.dtype == like.dtype else subject_mask.to(like.dtype),)
