"""The staged route's kernel library: ``csrc/staged.cu`` and the launch
counts of its six wrappers.

The wrappers live in the modules that mirror the reference's
(``ykv.py``, ``mttkrp_mode1.py``, ``mttkrp_mode2.py``, ``mttkrp_mode3.py``);
they work on the projected slices Yc = Q^T X that the caller has formed,
and :mod:`repro_torch.kernels.ops` dispatches between their full and
YkV-reuse forms. ``LAUNCHES[name]`` counts each wrapper's kernel launches;
plain-version calls on the CPU are not counted.
"""
from __future__ import annotations

from repro_torch.kernels._launch import I as _I, P as _P
from repro_torch.kernels._launch import KernelLib

__all__ = ["KERNELS", "LAUNCHES", "LIB", "reset_launches"]

KERNELS = ("ykv", "mode1", "mode1_reuse", "mode2_compact", "mode3", "mode3_reuse")
LIB = KernelLib("staged", KERNELS, {
    "spartan_ykv": [_I, _P, _P, _P, _I, _I, _I, _P],
    "spartan_ykv_variant": [_I, _I, _I, _I],
    "spartan_mode1_one_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "spartan_mode1_reuse_one_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _P],
    "spartan_mode2_compact": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "spartan_mode2_compact_variant": [_I, _I, _I, _I],
    "spartan_mode3": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "spartan_mode3_variant": [_I, _I, _I, _I],
    "spartan_mode3_reuse": [_I, _P, _P, _P, _P, _I, _I, _P],
    "spartan_mode1_workspace": [_I, _I, _I],
})
LAUNCHES = LIB.launches
reset_launches = LIB.reset_launches
