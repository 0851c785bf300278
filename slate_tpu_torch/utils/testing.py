"""Matrix generators and cross-package helpers for tests and smokes.

``generate`` is a copy of ``slate_tpu/utils/testing.py:generate`` (numpy
only, seeded identically), so both packages compute on the same operands.
``from_numpy`` carries numpy operands onto a torch device and
``options_from_names`` carries an ``Options`` mapping given by enum names;
``dist_from_numpy`` rebuilds a mesh matrix from another package's tile
stack (so a test can feed one package's factor to the other's solves), and
``distqr_from_numpy`` rebuilds CAQR factors the same way (and
``he2hb_factors_from_numpy``, ``hb2st_factors_from_numpy``,
``ge2tb_factors_from_numpy``, ``tb2bd_factors_from_numpy`` and
``disttwostage_from_numpy`` the eig / SVD factors, stage by stage),
``lufactors_from_numpy`` single-chip LU factors, and ``ozaki_split_from_numpy``
an Ozaki digit-plane split (for ``gemm_summa_ozaki(a_split=...)``).
``ft_summa_check`` holds the checksum-carrying SUMMA kernel to its twin,
``matmul_pallas_excess`` the blocked GEMM to its twin (``bf16_planes``
and ``matmul_split6_model`` model its f32 form, ``matmul_split6_reading``
holds it to them), ``tile_stack_at`` / ``tile_special_stack`` build the
tile kernels' stacks at any word offset, with NaN, +-inf, -0.0 and
subnormals placed against their 16-byte vectors, ``tile_bits_equal`` /
``tile_max_equal`` compare their results as words, and
``refine_gate_ok`` a solve to the mixed-precision refinement's gate.
"""

from __future__ import annotations

import math
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


def lufactors_from_numpy(lu: np.ndarray, perm: np.ndarray, info, device="cuda"):
    """The port's ``LUFactors`` from another package's (lu, perm, info) as
    numpy, on ``device``: the same factors for both packages' getrs, getri
    and gecondest."""
    from ..linalg.lu import LUFactors

    return LUFactors(torch.from_numpy(np.array(lu)).to(device),
                     torch.from_numpy(np.array(perm, dtype=np.int64)).to(device),
                     torch.tensor(int(np.asarray(info)), dtype=torch.int32, device=device))


def dist_from_numpy(tiles: np.ndarray, m: int, n: int, nb: int, mesh, diag_pad: bool = True):
    """The port's ``DistMatrix`` over ``mesh`` holding ``tiles``, a cyclic
    tile stack (mt, nt, nb, nb) as numpy -- e.g. ``np.asarray`` of a
    ``slate_tpu`` DistMatrix's ``tiles``, whose storage order is the same.
    A pivot vector carries across as ``torch.from_numpy(np.asarray(perm))``."""
    from ..parallel.dist import DistMatrix

    t = torch.from_numpy(np.array(tiles)).to(mesh.device)  # a writable copy
    if t.dim() != 4 or t.shape[2:] != (nb, nb):
        raise ValueError(f"dist_from_numpy: need (mt, nt, {nb}, {nb}) tiles, got {tuple(t.shape)}")
    return DistMatrix(tiles=t, m=m, n=n, nb=nb, mesh=mesh, diag_pad=diag_pad)


def ozaki_split_from_numpy(qa: np.ndarray, ea: np.ndarray, mesh):
    """The port's ``OzakiSplit`` on ``mesh``'s device from numpy -- e.g.
    ``np.asarray`` of a ``slate_tpu`` OzakiSplit's ``qa`` (S, mt, kt, nb,
    nb) int8 and ``ea`` (mt, nb) f32, whose global layouts are the same."""
    from ..parallel.summa import OzakiSplit

    qa_t = torch.from_numpy(np.array(qa)).to(mesh.device)
    ea_t = torch.from_numpy(np.array(ea)).to(mesh.device)
    if qa_t.dtype != torch.int8 or qa_t.dim() != 5 or ea_t.dtype != torch.float32 \
            or tuple(ea_t.shape) != (qa_t.shape[1], qa_t.shape[3]):
        raise ValueError(f"ozaki_split_from_numpy: need qa (S, mt, kt, nb, nb) int8 and ea "
                         f"(mt, nb) f32, got {qa_t.dtype} {tuple(qa_t.shape)}, "
                         f"{ea_t.dtype} {tuple(ea_t.shape)}")
    return OzakiSplit(qa=qa_t, ea=ea_t)


def distqr_from_numpy(fact_tiles: np.ndarray, tloc: np.ndarray, treev: np.ndarray,
                      treet: np.ndarray, m: int, n: int, nb: int, mesh):
    """The port's ``DistQR`` over ``mesh`` from CAQR factors as numpy -- e.g.
    ``np.asarray`` of a ``slate_tpu`` DistQR's ``fact.tiles``, ``tloc``
    (p * nt, nb, nb), ``treev`` (nt, max(1, p), 2nb, nb) and ``treet``
    (nt, max(1, p), nb, nb), whose layouts are the same -- so that
    ``unmqr_dist`` can be held alone on identical factors."""
    from ..parallel.dist_qr import DistQR

    fact = dist_from_numpy(fact_tiles, m, n, nb, mesh, diag_pad=True)
    nt = fact.nt
    p = mesh.p
    t = [torch.from_numpy(np.array(x)).to(mesh.device) for x in (tloc, treev, treet)]
    if (tuple(t[0].shape) != (p * nt, nb, nb) or t[1].shape[0] != nt or t[2].shape[0] != nt
            or tuple(t[1].shape[2:]) != (2 * nb, nb) or tuple(t[2].shape[2:]) != (nb, nb)):
        raise ValueError(f"distqr_from_numpy: factor shapes {[tuple(x.shape) for x in t]} do not fit "
                         f"nt = {nt}, p = {p}, nb = {nb}")
    return DistQR(fact, *t)




def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def he2hb_factors_from_numpy(band: np.ndarray, v: np.ndarray, t: np.ndarray, nb: int,
                             device="cuda"):
    """The port's ``He2hbFactors`` from another package's he2hb factors as
    numpy (the band (n, n), v (K, np2, nb), t (K, nb, nb); the same
    layouts), so that ``hb2st`` and ``unmtr_he2hb`` can be held alone."""
    from ..linalg.eig import He2hbFactors

    return He2hbFactors(_t(band, device), _t(v, device), _t(t, device), int(nb))


def hb2st_factors_from_numpy(vs: np.ndarray, taus: np.ndarray, w: int, n: int, device="cuda"):
    """The port's ``Hb2stFactors`` (vs (n - 1, max_hops, w), taus
    (n - 1, max_hops)) from numpy."""
    from ..linalg.eig import Hb2stFactors

    return Hb2stFactors(_t(vs, device), _t(taus, device), int(w), int(n))


def ge2tb_factors_from_numpy(band: np.ndarray, vq: np.ndarray, tq: np.ndarray, vl: np.ndarray,
                             tl: np.ndarray, nb: int, device="cuda"):
    """The port's ``Ge2tbFactors`` from numpy (the same layouts: reflectors
    in global coordinates, a dead LQ panel zero)."""
    from ..linalg.svd import Ge2tbFactors

    return Ge2tbFactors(*(_t(x, device) for x in (band, vq, tq, vl, tl)), int(nb))


def tb2bd_factors_from_numpy(lvs: np.ndarray, ltaus: np.ndarray, rvs: np.ndarray,
                             rtaus: np.ndarray, w: int, n: int, device="cuda"):
    """The port's ``Tb2bdFactors`` from numpy."""
    from ..linalg.svd import Tb2bdFactors

    return Tb2bdFactors(*(_t(x, device) for x in (lvs, ltaus, rvs, rtaus)), int(w), int(n))


def disttwostage_from_numpy(band_tiles: np.ndarray, vq: np.ndarray, tq: np.ndarray,
                            vl: np.ndarray, tl: np.ndarray, m: int, n: int, nb: int, mesh):
    """The port's ``DistTwoStage`` over ``mesh`` from another package's
    factors as numpy -- the band's cyclic tile stack, vq (K, p mfl, nb) by
    mesh row, tq, vl (K, q nfl, nb) by mesh column (empty for he2hb) and tl
    -- so that the stage-1 back-transforms can be held alone."""
    from ..parallel.dist_twostage import DistTwoStage

    band = dist_from_numpy(band_tiles, m, n, nb, mesh, diag_pad=False)
    return DistTwoStage(band, *(_t(x, mesh.device) for x in (vq, tq, vl, tl)))

QR_PART_C = 2  # each part's limit: QR_PART_C m eps times that part's own scale


def qr_panel_parts(out, offset: bool, row0: int = 0):
    """(R, V, pivots) of one Householder panel's outputs: the packed VR
    split at the diagonal (unit V pivots), or the offset form's ``r`` and
    ``v`` as they come; ``pivots`` is the (m, w) mask of the entries
    (row0 + j, j)."""
    f = out[0]
    rows = torch.arange(f.shape[0], device=f.device)[:, None]
    cols = torch.arange(f.shape[1], device=f.device)[None, :]
    piv = rows == cols + row0
    if offset:
        return out[0], out[1], piv
    return f.triu(), torch.where(rows > cols, f, piv.to(f.dtype)), piv


def _part_err(got, want, mask, scale_mask):
    """(max |got - want| over ``mask``, max |want| over ``scale_mask``)."""
    zero = torch.zeros((), dtype=want.dtype, device=want.device)
    err = torch.where(mask, (got - want).abs(), zero).max()
    return float(err), float(torch.where(scale_mask, want.abs(), zero).max())


def qr_panel_check(a, got, want, offset: bool, row0: int = 0) -> dict:
    """The kernel's Householder panel (``got``: (VR, tau, T), or the offset
    form's (r, v, tau, T)) against its twin's (``want``) and against A.

    No part is held to another part's scale (R's diagonal is ~sqrt(m) times
    its other entries, V's unit pivots dwarf its entries below them, tau ~1
    dwarfs T's off-diagonal), so each of R's pivot entries, R's other
    entries, V (scaled by its entries strictly below the pivots; a pivot
    entry that differs reads ~1 / limit), tau and T's off-diagonal is held
    within ``QR_PART_C`` m eps of the twin's largest entry of that part.
    Then Q R = A with Q = I - V T V^T, in f64, within m eps max|A|, and the
    compact-WY identity T (V^T V) T^T = T + T^T within m eps max|T|.

    Returns each reading as a ratio to its limit (pass at <= 1), the
    largest absolute difference, and the limits relative to the scales
    they hold (``part_rel_limit``, ``rec_rel_limit``): both must stay below
    1e-2, so that a zeroed part cannot pass."""
    m, w = got[0].shape
    eps = torch.finfo(a.dtype).eps
    r, v, piv = qr_panel_parts(got, offset, row0)
    rp, vp, _ = qr_panel_parts(want, offset, row0)
    tau, t, taup, tp = got[-2], got[-1], want[-2], want[-1]
    rows = torch.arange(m, device=r.device)[:, None]
    below = rows > torch.arange(w, device=r.device)[None, :] + row0
    ones = torch.ones_like(piv)
    tri = torch.ones((w, w), dtype=torch.bool, device=t.device)
    off = tri.triu(1) | tri.tril(-1)
    lim = QR_PART_C * m * eps
    parts = {"R_diag": _part_err(r, rp, piv, piv), "R_off": _part_err(r, rp, ~piv, ~piv),
             "V": _part_err(v, vp, ones, below), "tau": _part_err(tau, taup, tau == tau, tau == tau),
             "T_off": _part_err(t, tp, off, off)}
    out = {k: e / (lim * max(sc, 1e-30)) for k, (e, sc) in parts.items()}
    r64, v64, t64 = r.double(), v.double(), t.double()
    rec = r64 - v64 @ (t64 @ (v64.T @ r64))
    out["QR"] = float((rec - a.double()).abs().max()) / (m * eps * float(a.abs().max()))
    e = t64 @ (v64.T @ v64) @ t64.T - t64 - t64.T
    out["WY"] = float(e.abs().max()) / (m * eps * max(float(t.abs().max()), 1e-30))
    out["max_abs_err"] = max(e for e, _ in parts.values())
    out["part_rel_limit"] = lim
    out["rec_rel_limit"] = m * eps
    return out


QR_READINGS = ("R_diag", "R_off", "V", "tau", "T_off", "QR", "WY")


def qr_panel_ok(c: dict) -> bool:
    """Every reading within its limit, and every limit below 1e-2 of the
    scale it holds."""
    return (all(c[k] <= 1 for k in QR_READINGS) and c["part_rel_limit"] < 1e-2
            and c["rec_rel_limit"] < 1e-2)


def qr_panel_mutants(got, offset: bool, row0: int = 0) -> dict:
    """Wrong factors each check must refuse, by the reading that must fail:
    V zeroed strictly below its pivots, R's off-pivot entries zeroed, T's
    off-diagonal zeroed, and one column of T doubled."""
    f = got[0]
    m, w = f.shape
    rows = torch.arange(m, device=f.device)[:, None]
    below = rows > torch.arange(w, device=f.device)[None, :] + row0
    piv = rows == torch.arange(w, device=f.device)[None, :] + row0
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    t_diag = torch.diag_embed(torch.diagonal(got[-1]))
    t_col = got[-1].clone()
    t_col[:, w // 2] *= 2
    if offset:
        zero_v = (got[0], torch.where(below, zero, got[1])) + tuple(got[2:])
        zero_r = (torch.where(piv, got[0], zero),) + tuple(got[1:])
    else:
        zero_v = (torch.where(below, zero, f),) + tuple(got[1:])
        zero_r = (torch.where(rows < torch.arange(w, device=f.device)[None, :], zero, f),) \
            + tuple(got[1:])
    return {"V": zero_v, "R_off": zero_r, "T_off": tuple(got[:-1]) + (t_diag,),
            "WY": tuple(got[:-1]) + (t_col,)}


# Edge shapes of the Householder panel kernels (csrc/qr_panel.cu: 32-column
# blocks, 32 or more rows a CTA): widths off the block (1, 7, 33, 100) and at
# it (64, 256), m < w, m ragged against the CTA rows, and for the offset form
# row0 at 0, a middle row and m - w (three panels, one launch).  f64 adds a
# single panel whose rows a CTA do not fit in shared memory (the kernel keeps
# them in global memory); a single f32 panel reaches that form only past
# ~121k rows, where qr_panel_check's limits (2 m eps32) would not stay under
# 1e-2 of their scales.  QR_EDGE_OFFSET_GLOBAL reaches it in both dtypes at
# a checkable height: eight offset panels in one launch get 16 CTAs each on
# a 132-SM card, so 1250 rows a CTA (f32 keeps ~946 in shared memory).
QR_EDGE_PLAIN = ((1, 1), (5, 7), (40, 64), (33, 33), (100, 33), (1000, 100), (3001, 7),
                 (2000, 256))
QR_EDGE_PLAIN_F64 = ((70000, 33),)
QR_EDGE_OFFSET = ((640, 1), (700, 7), (1000, 33), (4100, 100), (1024, 256))
QR_EDGE_OFFSET_GLOBAL = (8, 20000, 33)  # (panels, m, w)
QR_EDGE_VARIANTS = ("neg0", "zero_below")


def qr_edge_plain(dtype: torch.dtype) -> tuple:
    """The plain form's edge shapes for a dtype."""
    return QR_EDGE_PLAIN + (QR_EDGE_PLAIN_F64 if dtype == torch.float64 else ())


def qr_edge_row0s(m: int, w: int, n: int = 3) -> list:
    """The offset form's ``n`` pivot-row offsets for an (m, w) panel, spread
    evenly from 0 to m - w (three: 0, the middle row, m - w)."""
    return [(m - w) * i // (n - 1) for i in range(n)]


def qr_edge_zero_col(m: int, w: int, row0: int = 0) -> int:
    """The zero column of a ``neg0`` edge panel: clear of the first column
    (the -0.0 pivot) and of column w // 2 (which ``qr_panel_mutants``
    doubles in T: a dead column's T column is zero)."""
    return max(1, min(m - row0, w) // 3)


def qr_edge_panel(m: int, w: int, variant: str, seed: int, row0: int = 0) -> np.ndarray:
    """A seeded randn (m, w) panel (f64 numpy; rows < row0 zero) with the
    kernel's edge columns.  ``neg0``: the first pivot is -0.0 with weight
    below it (where there are rows below: the sign must read +1, so
    beta = -anorm < 0; copysign would flip it) and column
    ``qr_edge_zero_col`` is zero (a dead column at its step: reflections
    keep it zero).  ``zero_below``: column 0 is zero below
    its pivot but not at it (xnorm2 = 0, tau = 2 for a pivot > 0) and the
    last column is zero only below its pivot row too."""
    a = np.random.default_rng(seed).standard_normal((m, w))
    a[:row0] = 0
    if variant == "neg0":
        if m - row0 > 1:
            a[row0, 0] = -0.0
        if w > 1:
            a[:, qr_edge_zero_col(m, w, row0)] = 0
    elif variant == "zero_below":
        a[row0 + 1:, 0] = 0
        a[row0, 0] = abs(a[row0, 0]) + 0.5
        if w > 1:
            a[row0 + w:, w - 1] = 0
    else:
        raise ValueError(f"qr_edge_panel: unknown variant {variant!r}")
    return a


def gels_omega(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, chunk: int = 2048) -> float:
    """The componentwise residual of the normal equations of min ||A X - B||,
    max |A^T (A X - B)| / (|A^T| (|A| |X| + |B|)) entrywise, in f64 (0/0
    reads 0), accumulated over blocks of ``chunk`` rows of A so that no f64
    copy of the whole A is made.  For a backward-stable real solve on
    Gaussian operands it reads a few eps / sqrt(m); products rounded to
    TF32 or bf16 read hundreds of times more."""
    x64 = x.double()
    ax = x64.abs()
    num = torch.zeros(x64.shape, dtype=torch.float64, device=x.device)
    den = torch.zeros_like(num)
    for i in range(0, a.shape[0], chunk):
        ac, bc = a[i:i + chunk].double(), b[i:i + chunk].double()
        num += ac.T @ (ac @ x64 - bc)
        aa = ac.abs()
        den += aa.T @ (aa @ ax + bc.abs())
    return float(torch.nan_to_num(num.abs() / den, nan=0.0).max())


def gels_omega_gate(m: int, dtype: torch.dtype) -> float:
    """The gate of :func:`gels_omega`: 20 eps / sqrt(m)."""
    return 20 * torch.finfo(dtype).eps / float(np.sqrt(m))


def ft_summa_check(acc0, pan, urow, w1, w2, part0, got, want) -> dict:
    """Readings of one ``ft_summa_update`` step against its twin.  ``acc0`` /
    ``part0`` are the inputs, ``got`` / ``want`` the (acc, part) pairs of
    the kernel and the twin.  acc holds to the tile-update limit of the
    other update kernels: two k-ordered FMA sums of nb products, a few
    sqrt(nb) eps max|pan| max|urow|, plus one rounding each of the final
    add (2 eps max|acc|).  part[s] holds to that product limit scaled by
    sum_i |w_s[i]| (each product enters with its weight), plus the two
    sums over the I tile rows taken in different orders, I eps each of
    max|part| (2 I eps).  A TF32 product (~4e3 f32 eps per product) lies
    far outside both.  Readings are err / limit: <= 1 passes."""
    nb = acc0.shape[-1]
    eps = torch.finfo(acc0.dtype).eps
    prod = 8 * math.sqrt(nb) * eps * float(pan.abs().max()) * float(urow.abs().max())
    out = {}
    amax = max(float(acc0.abs().max()), float(want[0].abs().max()))
    out["acc"] = float((got[0] - want[0]).abs().max()) / (prod + 2 * eps * amax)
    n_i = acc0.shape[2]
    for s, w in enumerate((w1, w2)):
        wsum = float(w.expand(*acc0.shape[:3]).abs().sum(-1).max())
        pmax = max(float(part0[:, :, s].abs().max()), float(want[1][:, :, s].abs().max()))
        lim = wsum * prod + 2 * n_i * eps * pmax
        out[f"part{s}"] = float((got[1][:, :, s] - want[1][:, :, s]).abs().max()) / lim
    return out


MATMUL_LAMBDA = 9.0


def matmul_pallas_excess(a: torch.Tensor, b: torch.Tensor, got: torch.Tensor,
                         want: torch.Tensor, chunk: int = 4096) -> float:
    """The blocked GEMM (``matmul_pallas``) against another f32-accumulated
    product of the same operands: max over entries of |got - want| / tol,
    in f64 over chunks of rows, <= 1 passing.  Both sum the k products in
    f32, in different orders.  By Higham and Mary's probabilistic bound
    (SIAM J. Sci. Comput. 41(5), 2019) each sum lies within
    lambda sqrt(k) u (|A||B|) of the exact product (u = eps32 / 2), failing
    with probability at most about 2 k exp(-lambda^2 / 2) an entry; lambda = 9
    keeps that below 1e-3 over the 32768^2 x 256 product, so the two differ
    by at most lambda sqrt(k) eps32 (|A||B|).  The worst-case bound
    2 k eps32 (|A||B|) would pass a kernel that dropped a whole k-slab at
    k = 8192.  A bf16 or f16 output rounds each once more, which adds one
    ulp of the output dtype: tol = (1 + e) lambda sqrt(k) eps32 (|A||B|) +
    e |want|, e = 0 for an f32 output, the output dtype's eps otherwise."""
    k = a.shape[1]
    e = 0.0 if got.dtype == torch.float32 else torch.finfo(got.dtype).eps
    c32 = MATMUL_LAMBDA * math.sqrt(k) * torch.finfo(torch.float32).eps * (1 + e)
    babs = b.double().abs()
    worst = 0.0
    for r0 in range(0, a.shape[0], chunk):
        ab = a[r0:r0 + chunk].double().abs() @ babs
        w = want[r0:r0 + chunk].double()
        tol = c32 * ab + e * w.abs()
        diff = (got[r0:r0 + chunk].double() - w).abs()
        ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / tol)
        worst = max(worst, float(ratio.max()))
    return worst


# csrc/matmul.cu's f32 form: the plane pairs (A plane, B plane) of a k slab,
# in the order the core sums them (its kPlaneA / kPlaneB), and the slab depth
MATMUL_PLANE_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
MATMUL_SLAB = 64


def bf16_planes(x: torch.Tensor) -> torch.Tensor:
    """The three-plane split of csrc/matmul.cu's pack kernel, in plain
    PyTorch: (3, *x.shape) f32 values, each exact in bf16.  Each plane is the
    leading 16 bits of the f32 word of what the planes before it left (the
    leading 8 significant bits, rounded toward zero), so x0 + x1 + x2 == x
    for finite |x| >= 2^-110, and every plane has x's sign or is zero.  NaN
    and +-inf go whole into plane 0 (NaN as the quiet NaN 0x7fc0), with zero
    planes below.  A testing model, never on a path."""
    x = x.float()
    top = torch.tensor(-65536, dtype=torch.int32)  # 0xffff0000

    def trunc16(v):
        return (v.view(torch.int32) & top).view(torch.float32)

    x0 = trunc16(x)
    r1 = x - x0
    x1 = trunc16(r1)
    x2 = trunc16(r1 - x1)
    bad = ~torch.isfinite(x)
    zero = torch.zeros_like(x)
    x0 = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), torch.where(bad, x, x0))
    return torch.stack([x0, torch.where(bad, zero, x1), torch.where(bad, zero, x2)])


def matmul_split6_model(a: torch.Tensor, b: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """csrc/matmul.cu's f32 product in plain PyTorch: per 64-deep k slab, the
    six plane products of MATMUL_PLANE_PAIRS summed in that order in f32,
    each slab's sum then added to the running f32 sum in k order.  (The
    tensor cores sum a product's 16 terms in their own way, so the card
    differs in rounding, not in what is summed.  The plane products are
    exact in TF32 too, so the TF32 flag does not matter.)  ``dtype`` f64
    gives the same six-product sum without the f32 rounding.  A testing
    model, never on a path."""
    pa, pb = bf16_planes(a).to(dtype), bf16_planes(b).to(dtype)
    m, k = a.shape
    total = torch.zeros((m, b.shape[1]), dtype=dtype, device=a.device)
    for k0 in range(0, k, MATMUL_SLAB):
        sl = slice(k0, k0 + MATMUL_SLAB)
        slab = torch.zeros_like(total)
        for i, j in MATMUL_PLANE_PAIRS:
            slab += pa[i][:, sl] @ pb[j][sl]
        total += slab
    return total


# the f32 form's second-order plane pairs, the smallest terms it sums
MATMUL_SPLIT6_SECOND = tuple((i, j) for i, j in MATMUL_PLANE_PAIRS if i + j == 2)
# The f32 form's limit for matmul_split6_reading.  It must sit between the
# sound kernel's reading and the reading of its C with one second-order
# plane pair dropped, which is near 1 by construction.  On an H100 the
# kernel read 0.005-0.077 (k = 3 to 8192; 0.077 at 8192^3) and its C with a
# pair dropped 0.994-1.295 (PERF.md).
MATMUL_SPLIT6_LIMIT = 0.5


def matmul_split6_reading(a: torch.Tensor, b: torch.Tensor, got: torch.Tensor,
                          rows: int = 4096) -> tuple:
    """How far an f32 product ``got`` of ``a @ b`` lies from the six plane
    products csrc/matmul.cu's f32 form sums (``matmul_split6_model`` in f64),
    in units of the smallest term it must keep: max |got - M| over the least,
    among the second-order plane pairs (x0y2, x1y1, x2y0), of the pair
    product's largest entry.  The elementwise twin tolerance
    (``matmul_pallas_excess``) passes a C that drops such a pair, or a TF32
    product; this reading does not (``MATMUL_SPLIT6_LIMIT``).  Returns
    (reading, {"x{i}y{j}": reading of ``got`` minus that pair's product}),
    the planted faults.  Works through ``rows`` rows of A at a time, in f64
    on ``a``'s device; finite operands with nonzero lower planes."""
    a, b = a.float(), b.float()
    pa, pb = bf16_planes(a).double(), bf16_planes(b).double()
    worst, faults = 0.0, {p: 0.0 for p in MATMUL_SPLIT6_SECOND}
    pair_max = dict(faults)
    for r0 in range(0, a.shape[0], rows):
        r1 = min(r0 + rows, a.shape[0])
        diff = got[r0:r1].double() - matmul_split6_model(a[r0:r1], b, torch.float64)
        worst = max(worst, float(diff.abs().max()))
        for i, j in MATMUL_SPLIT6_SECOND:
            term = pa[i][r0:r1] @ pb[j]
            pair_max[(i, j)] = max(pair_max[(i, j)], float(term.abs().max()))
            faults[(i, j)] = max(faults[(i, j)], float((diff - term).abs().max()))
            del term
        del diff
    scale = min(pair_max.values())
    return worst / scale, {f"x{i}y{j}": v / scale for (i, j), v in faults.items()}


def refine_gate_ok(a, x, b) -> bool:
    """The mixed-precision refinement's convergence gate in f64:
    ||b - A x||inf <= ||x||inf ||A||inf eps sqrt(n) (``linalg.refine.gate_cte``).
    Tensors stay on their device; numpy arrays go to the tensors' device."""
    dev = next((v.device for v in (a, x, b) if isinstance(v, torch.Tensor)), "cpu")
    a, x, b = ((v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))
               .to(device=dev, dtype=torch.float64) for v in (a, x, b))
    rn = (b - a @ x).abs().sum(dim=1).max()
    bound = x.abs().sum(dim=1).max() * a.abs().sum(dim=1).max()
    return bool(rn <= bound * torch.finfo(torch.float64).eps * math.sqrt(a.shape[0]))


def qr_edge_checks(a, got, want, offset: bool, row0: int, variant: str):
    """The edge rules of csrc/qr_panel.cu on one edge panel (``got`` the
    kernel's or a model's outputs, ``want`` the twin's): every reading of
    qr_panel_check within its limit; where the panel has off-diagonal parts
    (w >= 8 and m - row0 >= 8) each of qr_panel_mutants failing the reading
    named for it; in a ``neg0`` panel the dead column's tau 0 with a zero R
    pivot (plain form) or a zero v pivot (offset form), and the -0.0 pivot
    read as sign +1 (R's pivot < 0); in the offset form the rows above row0
    as A has them in r and zero in v.  Returns (the readings, the rules
    broken: an empty list when all hold)."""
    c = qr_panel_check(a, got, want, offset, row0)
    bad = [] if qr_panel_ok(c) else ["a reading over its limit"]
    m, w = a.shape
    if w >= 8 and m - row0 >= 8:
        bad += [f"a wrong factor passed {k}" for k, mut in qr_panel_mutants(got, offset, row0).items()
                if qr_panel_check(a, mut, want, offset, row0)[k] <= 1]
    if variant == "neg0" and w > 1:
        k = qr_edge_zero_col(m, w, row0)
        if float(got[-2][k]) != 0.0:
            bad.append("the dead column's tau is not 0")
        if float(got[1][row0 + k, k] if offset else got[0][k, k]) != 0.0:
            bad.append("the dead column's pivot is not 0")
        if m - row0 > 1 and not float(got[0][row0, 0]) < 0:
            bad.append("the -0.0 pivot read sign -1")
    if offset and not (torch.equal(got[0][:row0], a[:row0]) and not bool(got[1][:row0].any())):
        bad.append("rows above row0 were written")
    return c, bad


def qr_rows_in_global(kernels, dtype: torch.dtype, bsz: int, m: int, w: int) -> bool:
    """Whether csrc/qr_panel.cu keeps a CTA's rows of the block in global
    memory for a (bsz, m, w) launch on the current card: its dynamic shared
    memory (``kernels.qr_panel_smem_bytes``) is then less than one CTA's
    rows x 32 columns.  ``kernels`` is slate_tpu_torch.ops.kernels."""
    nc = kernels._qr_plan(dtype, bsz, m, w, torch.device("cuda", torch.cuda.current_device()))[0]
    rpc = -(-m // nc)
    isz = torch.empty((), dtype=dtype).element_size()
    return kernels.qr_panel_smem_bytes(dtype, bsz, m, w) < rpc * 32 * isz


# csrc/tile_ops.cu's stacks: the integer word of each dtype, and the special
# tiles tile_special_stack plants, in tile order
TILE_WORDS = {torch.float32: (torch.int32, 23), torch.bfloat16: (torch.int16, 7)}
TILE_SPECIAL = ("neg_zero", "nan_last_lane", "nan_tail", "neg_nan_head", "pos_inf", "neg_inf",
                "subnormal", "neg_zero_and_subnormal")


def tile_stack_at(shape, dtype: torch.dtype, offset: int = 0, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """A contiguous (k, mb, nb) stack of N(0, 1) values (numpy, seeded)
    rounded to ``dtype``, starting ``offset`` words into an allocation of its
    own (which torch aligns to 64 bytes or more): ``offset`` 0 is 16-byte
    aligned, ``a[1:]`` of a (k + 1, mb, nb) stack is offset mb nb."""
    n = offset + math.prod(shape)
    vals = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    flat = torch.empty(n, dtype=dtype, device=device)
    flat.copy_(torch.from_numpy(vals))
    return flat[offset:].view(shape)


def _word(value: int, bits: int) -> int:
    return value - (1 << bits) if value >= 1 << (bits - 1) else value


def tile_special_stack(shape, dtype: torch.dtype, offset: int = 0, seed: int = 0,
                       device="cuda") -> torch.Tensor:
    """:func:`tile_stack_at` with ``TILE_SPECIAL``'s values planted in tiles
    0-7 (k >= 8), placed against the 16-byte vectors csrc/tile_ops.cu's max
    reads: a tile of only -0.0; a NaN in the last lane of the tile's last
    whole vector; a NaN as the tile's last word (in its peeled tail when the
    tile ends off 16 bytes); a negative NaN as its first word (in its peeled
    head when it starts off 16 bytes); +inf; -inf; a tile of subnormals of
    random sign; a tile of -0.0 with one negative subnormal at its first
    whole vector."""
    k, mb, nb = shape
    if k < len(TILE_SPECIAL):
        raise ValueError(f"tile_special_stack: need k >= {len(TILE_SPECIAL)}, got {k}")
    a = tile_stack_at(shape, dtype, offset, seed, device)
    itype, mant = TILE_WORDS[dtype]
    bits = 8 * a.element_size()
    sign, qnan = 1 << (bits - 1), (0x7fc1 if bits == 16 else 0x7fc00001)
    inf = 0x7f80 if bits == 16 else 0x7f800000
    w = a.view(itype).view(k, mb * nb)
    t_el, vec = mb * nb, 16 // a.element_size()
    rng = np.random.default_rng(seed + 1)
    for t, kind in enumerate(TILE_SPECIAL):
        e0 = offset + t * t_el
        head = min((-e0) % vec, t_el)
        nv = (t_el - head) // vec
        last_lane = head + nv * vec - 1 if nv else t_el - 1
        row = w[t]
        if kind == "neg_zero":
            row.fill_(_word(sign, bits))
        elif kind == "nan_last_lane":
            row[last_lane] = _word(qnan, bits)
        elif kind == "nan_tail":
            row[t_el - 1] = _word(qnan, bits)
        elif kind == "neg_nan_head":
            row[0] = _word(sign | qnan, bits)
        elif kind == "pos_inf":
            row[t_el // 2] = _word(inf, bits)
        elif kind == "neg_inf":
            row[t_el - 1] = _word(sign | inf, bits)
        elif kind == "subnormal":
            mags = rng.integers(1, 1 << mant, t_el)
            signs = rng.integers(0, 2, t_el) * sign
            words = (mags | signs).astype(np.uint16 if bits == 16 else np.uint32)
            row.copy_(torch.from_numpy(words.view(np.int16 if bits == 16 else np.int32)))
        else:
            row.fill_(_word(sign, bits))
            row[min(head, t_el - 1)] = _word(sign | 1, bits)
    return a


def tile_bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal as words of csrc/tile_ops.cu's dtypes: NaN payloads and -0.0
    included."""
    itype = TILE_WORDS[got.dtype][0]
    return got.shape == want.shape and torch.equal(got.view(itype), want.view(itype))


def tile_max_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Per-tile maxima equal: NaN at the same tiles, every other tile's word
    equal (so -0.0 against +0.0 fails)."""
    nan = torch.isnan(got)
    itype = TILE_WORDS[got.dtype][0]
    return (got.shape == want.shape and torch.equal(nan, torch.isnan(want))
            and torch.equal(got.view(itype)[~nan], want.view(itype)[~nan]))
