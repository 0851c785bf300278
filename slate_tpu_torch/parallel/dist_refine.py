"""The ``Option.MixedPrecision`` resolve chain of the mesh solvers.

Counterpart of the option half of ``slate_tpu/parallel/dist_refine.py``
(``MIXED_MODES``, ``SLATE_TPU_MIXED``, ``resolve_mixed``, ``use_mixed``),
with ``slate_tpu``'s names, values and order: explicit option >
``use_mixed`` context > ``SLATE_TPU_MIXED`` environment > ``auto``.  The
mixed-precision ladder itself (f32 factor + f64 refinement, GMRES-IR, the
fallback) comes with slice 4; until then ``parallel.drivers.gesv_mesh``
raises on an f64 system under any mode but ``off``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from ..types import Option, Options, get_option

MIXED_MODES = ("off", "ir", "gmres", "auto")
MIXED_ENV = "SLATE_TPU_MIXED"
_MIXED_DEFAULT = [None]


def _check_mode(mode: str) -> str:
    if mode not in MIXED_MODES:
        raise ValueError(
            f"unknown mixed-precision mode {mode!r}; expected one of {MIXED_MODES}"
        )
    return mode


def resolve_mixed(opts: Optional[Options] = None) -> str:
    """Resolved Option.MixedPrecision mode: explicit option >
    ``use_mixed`` context > ``SLATE_TPU_MIXED`` env > ``auto``."""
    mode = get_option(opts, Option.MixedPrecision)
    if mode is None:
        mode = _MIXED_DEFAULT[-1]
    if mode is None:
        mode = os.environ.get(MIXED_ENV) or "auto"
    return _check_mode(str(mode))


@contextlib.contextmanager
def use_mixed(mode: str):
    """Session-default mixed-precision mode for drivers called inside; an
    explicit Option.MixedPrecision still wins."""
    _MIXED_DEFAULT.append(_check_mode(mode))
    try:
        yield
    finally:
        _MIXED_DEFAULT.pop()
