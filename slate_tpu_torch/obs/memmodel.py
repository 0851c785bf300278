"""Analytic device-memory model: closed-form peak bytes of the mesh
kernels, per device of a real mesh and for the port's virtual mesh on one
card, plus the single-chip f64 Cholesky residency models behind
``linalg.chol``'s route choice.

Counterpart of ``slate_tpu/obs/memmodel.py``, plain arithmetic (no torch
import at load).  ``MemoryModel`` keeps ``slate_tpu``'s per-device model of
a real mesh:

- **exact terms** (equal to ``slate_tpu``'s, term for term): the local
  tile-stack shards (arguments / outputs), the panel payloads the
  lookahead schedule pins live (``comm.la_live_buffers``), the multi-array
  ops' auxiliary outputs and the bucketed trailing views
  (``comm.bucket_plan``) -- tile counts times ``nb^2 itemsize``.

On one card the port holds all p x q devices' shards at once, and its
broadcasts index the shared stack instead of copying a payload to each
device, so the card's peak is not p q times a device's.  The ``virtual_*``
properties model that card: every shard (``virtual_arg_bytes`` /
``virtual_out_bytes``, exact), plus the transient bytes the port really
makes (``virtual_workspace_bytes``): linear in the tile-count terms the
port's loops allocate, the whole-height column panel ``C = mt tile``, the
whole-width row panel ``R = nt tile``, the whole stack ``S = mt nt tile``
and one tile, with coefficients fitted by least squares to the bytes
``obs.memory.traced_memory`` measures on the CPU (where the tally is the
card's: see that module).  The fit points are recorded below, and
``obs.memwatch`` gates the model within 10% of the measured bytes.

``slate_tpu``'s calibrated per-device terms were fitted to XLA's buffer
assignment and have no counterpart here: the per-device ``workspace_bytes``
is the device's share of the virtual mesh's, ``virtual_workspace_bytes /
(p q)``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

MODEL_OPS = ("summa", "potrf", "getrf_nopiv", "trsm", "geqrf", "he2hb")
_FACTOR_OPS = ("potrf", "getrf_nopiv")
_PANEL_CHAIN_OPS = ("geqrf", "he2hb")

# slate_tpu's output-assignment slots (XLA's): the factor kernels' info
# scalar and the multi-array ops' extra slot -- part of its per-device
# out_bytes, kept for parity
_INFO_SLOT_BYTES = 20
_MULTI_OUT_SLOT = {"geqrf": 32, "he2hb": 24}

# the port's int32 info tensor (one storage of 4 bytes)
_PORT_INFO_BYTES = 4

# slate_tpu's per-device workspace calibration, fitted to XLA's buffer
# assignment on its 8-device CPU mesh (slate_tpu/obs/memmodel.py): the
# index / loop-carry constants, the bucket-view liveness and the trsm /
# geqrf / he2hb least-squares coefficients.  Only ``device_workspace_bytes``
# reads them: the serving admission of a meshless router, which admits
# exactly the sizes slate_tpu's does (serve/router.py).
_XLA_CONST_BYTES = {"summa": 256, "potrf": 1504, "getrf_nopiv": 1808,
                    "trsm": 617, "geqrf": 753, "he2hb": 4059}
_XLA_ENGINE_CONST_BYTES = {"summa": 212, "potrf": 1568, "getrf_nopiv": 2144,
                           "trsm": 512, "geqrf": 384, "he2hb": 128}
_XLA_VIEW_COEF = {"potrf": 0.53, "getrf_nopiv": 0.55}
_XLA_TRSM_COEF = {"stack": 1.996, "pcol": 0.400, "tile": 0.067, "livepay": 0.228}
_XLA_QR_COEF = {"stack": 1.659, "panel": 0.769, "tree": 1.537}
_XLA_HE2HB_COEF = {"stack": 1.542, "gpan": 1.236, "pcol": 0.618, "tree": 1.236}

# ---------------------------------------------------------------------------
# The port's calibration: virtual_workspace_bytes = sum_t coef[t] * term_t
# over the terms of _virtual_terms (C, R, S, T = tile, D = (1 + depth) C,
# const = 1 byte), fitted by least squares (relative residuals) to
# obs.memory.traced_memory's temp_bytes on the CPU, 2 x 4 mesh, f32, every
# BcastImpl (the tally is the same under psum and ring) and depths 0-2
# (the factor loops' tally does not move with depth; trsm's grows one
# column panel per depth).  _FIT_POINTS lists each (n, nb, depth) point
# and the measured temp bytes.  The worst relative residual of each fit
# over its points: potrf 0.51%, getrf_nopiv 0.16%, trsm 0.02%, geqrf
# 0.08%, he2hb 0.28%, summa 0 (exact).
# ---------------------------------------------------------------------------
_VIRTUAL_COEF: Dict[str, Dict[str, float]] = {
    # gemm_summa's payloads are views of the operands' stacks and the
    # update runs in place on the output: no transient bytes at all
    "summa": {},
    "potrf": {"C": 7.914, "T": -0.7835, "const": 471.3471},
    "getrf_nopiv": {"C": 8.0564, "T": 0.3892, "const": 244.1315},
    "trsm": {"S": 3.0017, "D": 0.9999, "T": -0.1666, "const": 151.1668},
    "geqrf": {"S": 1.0061, "C": 19.9862, "T": 15.2675, "const": 504.3742},
    "he2hb": {"S": 1.0232, "C": 18.987, "T": 1.7768, "const": 1367.6726},
}
# (n, nb, depth, measured temp bytes); summa / potrf / getrf_nopiv read the
# same at depths 0, 1 and 2, so one depth is listed
_FIT_POINTS: Dict[str, Tuple[Tuple[int, int, int, int], ...]] = {
    "summa": ((64, 8, 0, 0), (96, 8, 0, 0), (128, 8, 0, 0), (160, 16, 0, 0), (256, 16, 0, 0),
              (384, 32, 0, 0), (96, 16, 0, 0), (192, 8, 0, 0)),
    "potrf": ((64, 8, 0, 16444), (96, 8, 0, 24568), (128, 8, 0, 32724), (160, 16, 0, 96760),
              (256, 16, 0, 128724), (384, 32, 0, 385528), (96, 16, 0, 64828),
              (192, 8, 0, 49132)),
    "getrf_nopiv": ((64, 8, 0, 16828), (96, 8, 0, 25096), (128, 8, 0, 33364),
                    (160, 16, 0, 99592), (256, 16, 0, 132436), (384, 32, 0, 397576),
                    (96, 16, 0, 66748), (192, 8, 0, 49900)),
    "trsm": ((64, 8, 0, 51328), (64, 8, 1, 53376), (64, 8, 2, 55424), (96, 8, 0, 113856),
             (96, 8, 1, 116928), (96, 8, 2, 120000), (128, 8, 0, 200960), (128, 8, 1, 205056),
             (128, 8, 2, 209152), (160, 16, 0, 454848), (160, 16, 1, 467136),
             (160, 16, 2, 479424), (256, 16, 0, 803072), (256, 16, 1, 819456),
             (256, 16, 2, 835840), (384, 32, 0, 1818816), (384, 32, 1, 1867968),
             (384, 32, 2, 1917120), (96, 16, 0, 204928), (96, 16, 1, 213120),
             (96, 16, 2, 221312), (192, 8, 0, 448896), (192, 8, 1, 455040),
             (192, 8, 2, 461184)),
    "geqrf": ((64, 8, 0, 61794), (96, 8, 0, 102946), (128, 8, 0, 152290), (160, 16, 0, 410178),
              (256, 16, 0, 607170), (384, 32, 0, 1637506), (96, 16, 0, 245954),
              (192, 8, 0, 275554)),
    "he2hb": ((64, 8, 0, 57344), (96, 8, 0, 98048), (128, 8, 0, 146944), (160, 16, 0, 387584),
              (256, 16, 0, 581632), (384, 32, 0, 1541120), (96, 16, 0, 226304),
              (192, 8, 0, 269312)),
}


def _he2hb_steps(n: int, nb: int) -> int:
    """linalg.eig._he2hb_panel_count without the torch import: panels
    while the next column block still has rows below the band."""
    k = 0
    while (k + 1) * nb < n - 1:
        k += 1
    return k


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _itemsize(dtype) -> int:
    return int(np.dtype(str(dtype).replace("torch.", "")).itemsize)


class MemoryModel:
    """Closed-form peak bytes of one mesh kernel at (n, nb, mesh grid,
    dtype, lookahead depth, BcastImpl, FT, PanelImpl): per device of a
    real mesh (``peak_bytes = arg_bytes + out_bytes + workspace_bytes``,
    ``slate_tpu``'s decomposition) and for the virtual mesh on one card
    (``virtual_peak_bytes``).  ``ft=True`` grows the tile grid by the
    Huang-Abraham checksum augmentation (two checksum tile rows / columns,
    then the lcm re-pad).  ``bcast_impl`` and ``panel_impl`` do not move
    the port's bytes (its broadcasts are indexing; the kernel wrappers'
    outputs are the twins')."""

    def __init__(self, op: str, n: int, nb: int, grid: Tuple[int, int],
                 dtype="float32", lookahead: int = 1,
                 bcast_impl: str = "auto", ft: bool = False,
                 panel_impl: str = "xla", k: Optional[int] = None):
        if op not in MODEL_OPS:
            raise ValueError(f"unknown model op {op!r}; expected {MODEL_OPS}")
        self.op = op
        self.n = int(n)
        self.nb = int(nb)
        self.p, self.q = int(grid[0]), int(grid[1])
        self.dtype = np.dtype(str(dtype).replace("torch.", ""))
        self.isz = _itemsize(self.dtype)
        self.ft = bool(ft)
        self.bcast_impl = bcast_impl
        self.panel_impl = panel_impl

        lcm = math.lcm(self.p, self.q)
        base = max(1, -(-self.n // self.nb))
        if self.ft:
            base = base + 2
        self.nt = _round_up(base, lcm)
        self.mt = self.nt  # square tile grids throughout the k-loops
        self.mtl = self.mt // self.p
        self.ntl = self.nt // self.q
        self.depth = max(0, min(int(lookahead), self.nt))
        self.kt = self.nt if k is None else int(k)

        tile = self.nb * self.nb * self.isz
        self.tile_bytes = tile
        self.stack_bytes = self.mtl * self.ntl * tile  # one local shard
        self.panel_col_bytes = self.mtl * tile  # (mtl, nb, nb) payload
        self.panel_row_bytes = self.ntl * tile  # (ntl, nb, nb) payload

    # -- exact terms (slate_tpu's, per device) ---------------------------

    @property
    def engine(self) -> bool:
        return self.bcast_impl != "psum"

    @property
    def arg_bytes(self) -> int:
        if self.op in ("summa", "trsm"):
            return 2 * self.stack_bytes  # A and B shards
        return self.stack_bytes

    @property
    def aux_out_bytes(self) -> int:
        """The multi-array ops' per-device auxiliary outputs beyond the
        tile-stack shard: geqrf's T_loc plus its replicated tree V / T
        stacks, he2hb's sharded reflector stack plus its replicated
        compact-WY accumulators."""
        tile = self.tile_bytes
        if self.op == "geqrf":
            nmerge = max(1, self.p)
            return self.nt * tile + self.nt * nmerge * 2 * tile + self.nt * nmerge * tile
        if self.op == "he2hb":
            nsteps = max(1, _he2hb_steps(self.n, self.nb))
            return nsteps * self.mtl * self.nb * self.nb * self.isz + nsteps * tile
        return 0

    @property
    def out_bytes(self) -> int:
        if self.op in _FACTOR_OPS:
            return self.stack_bytes + _INFO_SLOT_BYTES
        if self.op in _PANEL_CHAIN_OPS:
            return self.stack_bytes + self.aux_out_bytes + _MULTI_OUT_SLOT[self.op]
        return self.stack_bytes

    @property
    def live_payloads(self) -> int:
        """Panel payload pairs the lookahead schedule pins live at once
        (``comm.la_live_buffers``)."""
        from ..parallel.comm import la_live_buffers

        return la_live_buffers(self.depth, factor_loop=self.op in _FACTOR_OPS)

    @property
    def payload_bytes(self) -> int:
        """One panel payload pair: the column panel plus the row payload
        every k-step broadcasts (trsm: the A panel and the diagonal
        tile)."""
        if self.op == "trsm":
            return self.panel_col_bytes + self.tile_bytes
        return self.panel_col_bytes + self.panel_row_bytes

    def _bucket_view_bytes(self) -> int:
        """Byte sum of the bucketed factor kernels' trailing views
        (``comm.bucket_plan``'s statically shrinking windows)."""
        from ..parallel.comm import bucket_plan

        total = 0
        for _k0, _k1, s0r, s0c in bucket_plan(self.nt, self.p, self.q):
            total += (self.mtl - s0r) * (self.ntl - s0c) * self.tile_bytes
        return total

    # -- the virtual mesh on one card (the port's) -----------------------

    @property
    def _devices(self) -> int:
        return self.p * self.q

    @property
    def virtual_stack_bytes(self) -> int:
        """The whole tile stack: every device's shard."""
        return self.mt * self.nt * self.tile_bytes

    @property
    def virtual_arg_bytes(self) -> int:
        return (2 if self.op in ("summa", "trsm") else 1) * self.virtual_stack_bytes

    @property
    def virtual_aux_out_bytes(self) -> int:
        """The multi-array ops' auxiliary outputs as the port lays them out:
        geqrf's T_loc per mesh row (p, nt, nb, nb) and ONE copy of the
        replicated tree stacks; he2hb's reflector stack over the whole
        height and one copy of its accumulators."""
        tile = self.tile_bytes
        if self.op == "geqrf":
            nmerge = max(1, self.p)
            return self.p * self.nt * tile + self.nt * nmerge * 3 * tile
        if self.op == "he2hb":
            nsteps = max(1, _he2hb_steps(self.n, self.nb))
            return nsteps * self.mt * self.nb * self.nb * self.isz + nsteps * tile
        return 0

    @property
    def virtual_out_bytes(self) -> int:
        out = self.virtual_stack_bytes + self.virtual_aux_out_bytes
        if self.op in _FACTOR_OPS:
            out += _PORT_INFO_BYTES
        return out

    def _virtual_terms(self) -> Dict[str, float]:
        tile = self.tile_bytes
        col = self.mt * tile
        return {"C": float(col), "R": float(self.nt * tile), "S": float(self.virtual_stack_bytes),
                "T": float(tile), "D": float((1 + self.depth) * col), "const": 1.0}

    @property
    def virtual_workspace_bytes(self) -> float:
        """Transient bytes of the virtual mesh on one card at peak: the
        port's fitted terms (module docstring)."""
        terms = self._virtual_terms()
        return float(sum(c * terms[t] for t, c in _VIRTUAL_COEF[self.op].items()))

    @property
    def virtual_peak_bytes(self) -> float:
        return self.virtual_arg_bytes + self.virtual_out_bytes + self.virtual_workspace_bytes

    # -- per device ---------------------------------------------------------

    @property
    def workspace_bytes(self) -> float:
        """A device's share of the virtual mesh's transient bytes."""
        return self.virtual_workspace_bytes / self._devices

    @property
    def peak_bytes(self) -> float:
        return self.arg_bytes + self.out_bytes + self.workspace_bytes

    # -- slate_tpu's per-device form (XLA's buffer assignment) -------------

    @property
    def device_workspace_bytes(self) -> float:
        """``slate_tpu``'s per-device transient bytes at peak: its closed
        form over the exact payload / stack terms with its XLA-fitted
        coefficients (the ``_XLA_*`` constants), term for term."""
        const = _XLA_CONST_BYTES[self.op]
        if self.engine:
            const += _XLA_ENGINE_CONST_BYTES[self.op]
        tile = self.tile_bytes
        if self.op == "trsm":
            c = _XLA_TRSM_COEF
            return (c["stack"] * self.stack_bytes + c["pcol"] * self.panel_col_bytes
                    + c["tile"] * tile + c["livepay"] * self.live_payloads * self.payload_bytes
                    + const)
        if self.op == "geqrf":
            c = _XLA_QR_COEF
            tops = self.p * self.panel_row_bytes
            return (c["stack"] * self.stack_bytes + c["panel"] * (self.panel_col_bytes + tops)
                    + c["tree"] * self.nt * tile + const)
        if self.op == "he2hb":
            c = _XLA_HE2HB_COEF
            pcol = self.panel_col_bytes
            return (c["stack"] * self.stack_bytes + c["gpan"] * self.p * pcol
                    + c["pcol"] * pcol + c["tree"] * self.nt * tile + const)
        if self.op == "summa":
            return self.stack_bytes + self.live_payloads * self.payload_bytes + const
        return (self.stack_bytes + self.live_payloads * self.payload_bytes
                + _XLA_VIEW_COEF[self.op] * self._bucket_view_bytes() + const)

    @property
    def device_peak_bytes(self) -> float:
        """``slate_tpu``'s per-device peak: the exact arguments and outputs
        plus :attr:`device_workspace_bytes`."""
        return self.arg_bytes + self.out_bytes + self.device_workspace_bytes

    def breakdown(self) -> Dict[str, float]:
        return {
            "arg_bytes": float(self.arg_bytes),
            "out_bytes": float(self.out_bytes),
            "workspace_bytes": float(self.workspace_bytes),
            "peak_bytes": float(self.peak_bytes),
            "payload_bytes": float(self.payload_bytes),
            "live_payloads": float(self.live_payloads),
            "stack_bytes": float(self.stack_bytes),
            "virtual_arg_bytes": float(self.virtual_arg_bytes),
            "virtual_out_bytes": float(self.virtual_out_bytes),
            "virtual_workspace_bytes": float(self.virtual_workspace_bytes),
            "virtual_peak_bytes": float(self.virtual_peak_bytes),
        }


PEAK_FORMS = ("peak_bytes", "virtual_peak_bytes", "device_peak_bytes")


def predict_max_n(budget_bytes: float, op: str = "potrf", nb: int = 256,
                  grid: Tuple[int, int] = (2, 4), dtype="float32",
                  lookahead: int = 1, bcast_impl: str = "auto",
                  ft: bool = False, peak: str = "peak_bytes") -> int:
    """Largest n whose modelled peak fits ``budget_bytes``, searched over
    tile-grid multiples (the model is step-wise constant between them).
    ``peak`` names the :class:`MemoryModel` peak held to the budget: the
    port's per-device share (``peak_bytes``), the whole virtual mesh on one
    card (``virtual_peak_bytes``) or ``slate_tpu``'s per-device form
    (``device_peak_bytes``, which gives ``slate_tpu``'s answer)."""
    if peak not in PEAK_FORMS:
        raise ValueError(f"unknown peak form {peak!r}; expected one of {PEAK_FORMS}")
    step = nb * math.lcm(int(grid[0]), int(grid[1]))

    def fits(n):
        if n <= 0:
            return True
        m = MemoryModel(op, n, nb, grid, dtype, lookahead, bcast_impl, ft)
        return getattr(m, peak) <= budget_bytes

    if not fits(step):
        return 0
    lo, hi = step, step
    while fits(hi * 2):
        hi *= 2
        if hi > (1 << 40):
            break
    lo = hi
    hi = hi * 2
    while lo + step < hi:
        mid = ((lo + hi) // 2) // step * step
        if mid <= lo:
            break
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Single-chip f64 Cholesky residency (linalg/chol.py routing)
# ---------------------------------------------------------------------------

# fraction of device memory the planner budgets for one factorization (the
# rest covers the runtime, caller-held operands and allocator slack)
HBM_SAFETY = 0.90
HBM_ENV = "SLATE_TPU_HBM_BYTES"

# The decision rules' constants are slate_tpu's, so that the port routes as
# it does.  FUSED_LL_COPIES is slate_tpu's measurement of its single-program
# XLA left-looking Cholesky (live copies of the matrix across the unrolled
# panel chain); the port has no such program -- its "fused" and "staged"
# forms are one in-place panel loop, whose peak potrf_staged_peak models.
FUSED_LL_COPIES = 7.2
# one matrix + one panel step's transients: ~3 (n, nb) strips
STAGED_PANEL_STRIPS = 3
# the digit-cached Ozaki form: the S n^2 int8 plane cache beside ~4 full
# f64 buffers (the matrix and the update transients), i.e. 32 n^2 bytes
OZAKI_F64_BUFFERS = 4


def hbm_budget(device=None) -> int:
    """Device-memory budget for routing decisions: the
    ``SLATE_TPU_HBM_BYTES`` override, else the card's ``total_memory``
    (``device``, or the current CUDA device).  A CPU device has no budget
    of its own: pass one explicitly or set the environment variable."""
    env = os.environ.get(HBM_ENV)
    if env:
        return int(float(env))
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    raise ValueError(f"no device-memory budget for {dev or 'the host'}: pass one "
                     f"explicitly or set {HBM_ENV}")


def _ll_nb(n: int) -> int:
    """chol.py's left-looking panel width heuristic."""
    return 4096 if n >= 16384 else 2048


def potrf_fused_ll_peak(n: int, itemsize: int = 8) -> float:
    """slate_tpu's fused left-looking peak: FUSED_LL_COPIES matrices."""
    return FUSED_LL_COPIES * float(n) * n * itemsize


def potrf_staged_peak(n: int, itemsize: int = 8, nb: Optional[int] = None) -> float:
    """The in-place left-looking Cholesky's peak: one matrix plus one panel
    step's transients (~STAGED_PANEL_STRIPS (n, nb) strips)."""
    nbp = _ll_nb(n) if nb is None else nb
    return float(n) * n * itemsize + STAGED_PANEL_STRIPS * float(n) * nbp * itemsize


def potrf_ozaki_cache_peak(n: int, n_slices: Optional[int] = None) -> float:
    """The digit-cached Ozaki f64 Cholesky's peak: the S n^2 int8 plane
    cache beside ~OZAKI_F64_BUFFERS full f64 buffers."""
    s = (10 if n > 8192 else 9) if n_slices is None else int(n_slices)
    return (s + OZAKI_F64_BUFFERS * 8) * float(n) * n


def potrf_fused_fits(n: int, budget: Optional[int] = None, itemsize: int = 8) -> bool:
    b = hbm_budget() if budget is None else budget
    return potrf_fused_ll_peak(n, itemsize) <= HBM_SAFETY * b


def potrf_ozaki_cache_max_n(budget: Optional[int] = None) -> int:
    """The digit cache's ceiling: the largest n whose cache and f64
    working set fit the safety-scaled budget."""
    b = HBM_SAFETY * (hbm_budget() if budget is None else budget)
    n_hi = int(math.sqrt(b / (10 + OZAKI_F64_BUFFERS * 8)))
    if n_hi > 8192:
        return n_hi
    return min(8192, int(math.sqrt(b / (9 + OZAKI_F64_BUFFERS * 8))))


def potrf_f64_form(n: int, concrete: bool, ozaki_dispatch: bool,
                   budget: Optional[int] = None, itemsize: int = 8) -> str:
    """slate_tpu's route for a big f64 / c128 ``potrf_array``:

    - ``"ozaki"``: the digit-cached left-looking form, when the f64 Ozaki
      dispatch is live and cache + matrix fit the budget (f64 only);
    - ``"staged"``: when the fused form would not fit and the call is
      concrete (every port call is);
    - ``"fused"``: otherwise.

    In the port ``staged`` and ``fused`` run the same in-place loop."""
    b = hbm_budget() if budget is None else budget
    if ozaki_dispatch and itemsize == 8 and n <= potrf_ozaki_cache_max_n(b):
        return "ozaki"
    if concrete and not potrf_fused_fits(n, b, itemsize):
        return "staged"
    return "fused"


def mixed_ladder_residency(n: int, nb: int, grid: Tuple[int, int], nrhs: int = 1) -> float:
    """Per-device residency estimate of the mixed-precision IR ladder: the
    f64 A tile stack + its f32 copy (half) + the f32 factor (half) + two
    RHS-shaped f64 stacks (the B carry and the residual).  An estimate
    (slate_tpu's arithmetic, pinned by the tests)."""
    p, q = int(grid[0]), int(grid[1])
    m64 = MemoryModel("potrf", n, nb, grid, "float64")
    rhs_nt = _round_up(max(1, -(-int(nrhs) // nb)), math.lcm(p, q))
    rhs_stack = m64.mtl * (rhs_nt // q) * nb * nb * 8
    return 2.0 * m64.stack_bytes + 2.0 * rhs_stack
