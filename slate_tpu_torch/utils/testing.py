"""Matrix generators and cross-package helpers for tests and smokes.

``generate`` is a copy of ``slate_tpu/utils/testing.py:generate`` (numpy
only, seeded identically), so both packages compute on the same operands.
``from_numpy`` carries numpy operands onto a torch device and
``options_from_names`` carries an ``Options`` mapping given by enum names;
``dist_from_numpy`` rebuilds a mesh matrix from another package's tile
stack (so a test can feed one package's factor to the other's solves).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import types as _types


def generate(
    kind: str,
    m: int,
    n: Optional[int] = None,
    dtype=np.float64,
    seed: int = 0,
    cond: float = 1e3,
) -> np.ndarray:
    """Named matrix kinds: rand, rands, randn, diag, identity, svd, spd,
    hermitian, wilkinson, spd_svd, spd_neardiag, dominant — the same values
    as ``slate_tpu.utils.testing.generate`` for the same arguments."""
    n = m if n is None else n
    rng = np.random.default_rng(seed)
    cplx = np.issubdtype(dtype, np.complexfloating)

    def rnd(shape):
        a = rng.standard_normal(shape)
        if cplx:
            a = a + 1j * rng.standard_normal(shape)
        return a.astype(dtype)

    if kind == "rand":  # uniform [0, 1)
        a = rng.random((m, n))
        if cplx:
            a = a + 1j * rng.random((m, n))
        return a.astype(dtype)
    if kind == "rands":  # uniform [-1, 1)
        a = 2 * rng.random((m, n)) - 1
        if cplx:
            a = a + 1j * (2 * rng.random((m, n)) - 1)
        return a.astype(dtype)
    if kind == "randn":
        return rnd((m, n))
    if kind == "identity":
        return np.eye(m, n, dtype=dtype)
    if kind == "diag":
        a = np.zeros((m, n), dtype=dtype)
        np.fill_diagonal(a, rng.random(min(m, n)))
        return a
    if kind == "svd":  # controlled condition number via geometric spectrum
        k = min(m, n)
        u, _ = np.linalg.qr(rnd((m, k)))
        v, _ = np.linalg.qr(rnd((n, k)))
        s = cond ** (-np.arange(k) / max(k - 1, 1))
        return (u * s) @ v.conj().T
    if kind == "spd":
        a = rnd((m, m))
        a = a @ a.conj().T / m + np.eye(m, dtype=dtype)
        return a.astype(dtype)
    if kind == "hermitian":
        a = rnd((m, m))
        return ((a + a.conj().T) / 2).astype(dtype)
    if kind == "wilkinson":
        a = np.zeros((m, n), dtype=dtype)
        k = min(m, n)
        a[np.arange(k), np.arange(k)] = 1
        a[np.tril_indices(min(m, n), -1)] = -1
        if m > n:
            a[n:, :] = 0
        a[:, -1] = 1
        return a
    if kind == "spd_svd":
        k = min(m, n)
        qm, _ = np.linalg.qr(rnd((m, k)))
        s = cond ** (-np.arange(k) / max(k - 1, 1))
        a = (qm * s) @ qm.conj().T
        return ((a + a.conj().T) / 2).astype(dtype)
    if kind == "spd_neardiag":
        a = np.eye(m, dtype=dtype)
        j = m // 2
        g = rnd((m, m)) * (0.1 / m)
        g = (g + g.conj().T) / 2
        g[j, :] = 0
        g[:, j] = 0
        a = a + g @ g.conj().T
        a[j, j] = 1.0 / cond
        return a.astype(dtype)
    if kind == "dominant":
        a = rnd((m, n))
        k = min(m, n)
        a[np.arange(k), np.arange(k)] += np.abs(a).sum(axis=1)[:k].astype(dtype)
        return a
    raise ValueError(f"unknown matrix kind: {kind}")


def from_numpy(arrays: Iterable[np.ndarray], device="cuda") -> Tuple[torch.Tensor, ...]:
    """Copy numpy operands onto ``device`` (dtype and values unchanged)."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays
    )


def _port_value(value: Any) -> Any:
    """An enum member of the other package -> this package's member of the
    same class name and member name; anything else unchanged."""
    if isinstance(value, str) or not hasattr(value, "name"):
        return value
    cls = getattr(_types, type(value).__name__, None)
    if cls is None or not isinstance(cls, type) or not hasattr(cls, "__members__"):
        return value
    return cls[value.name]


def options_from_names(opts: Optional[Mapping[Any, Any]]) -> dict:
    """An ``Options`` mapping whose keys are ``Option`` members of either
    package or member names (``"Precision"``), and whose enum values are of
    either package, as this package's ``Options``.  Plain values (ints,
    strings) pass through."""
    out = {}
    for key, value in (opts or {}).items():
        name = key if isinstance(key, str) else key.name
        out[_types.Option[name]] = _port_value(value)
    return out


def dist_from_numpy(tiles: np.ndarray, m: int, n: int, nb: int, mesh, diag_pad: bool = True):
    """The port's ``DistMatrix`` over ``mesh`` holding ``tiles``, a cyclic
    tile stack (mt, nt, nb, nb) as numpy -- e.g. ``np.asarray`` of a
    ``slate_tpu`` DistMatrix's ``tiles``, whose storage order is the same.
    A pivot vector carries across as ``torch.from_numpy(np.asarray(perm))``."""
    from ..parallel.dist import DistMatrix

    t = torch.from_numpy(np.ascontiguousarray(tiles)).to(mesh.device)
    if t.dim() != 4 or t.shape[2:] != (nb, nb):
        raise ValueError(f"dist_from_numpy: need (mt, nt, {nb}, {nb}) tiles, got {tuple(t.shape)}")
    return DistMatrix(tiles=t, m=m, n=n, nb=nb, mesh=mesh, diag_pad=diag_pad)
