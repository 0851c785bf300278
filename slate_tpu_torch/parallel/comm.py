"""Communication verbs of the mesh drivers, on a virtual (p, q) mesh.

Counterpart of the part of ``slate_tpu/parallel/comm.py`` that the mesh
Cholesky and LU solves and the mesh GEMM use.  In ``slate_tpu`` a shard_map body
runs once per device and the verbs are XLA collectives.  Here every device
of the grid lives on one card, so a body runs ONCE over the whole grid and
a per-device value is a tensor whose two leading dims are the grid,
``(P, Q, *payload)``, where ``P`` is p or 1 and ``Q`` is q or 1 -- a size-1
grid dim means every device along that axis holds the same value (a view
with stride 0 when expanded).  The verbs then become:

- a rooted broadcast along an axis: the owner's slice, size 1 along the
  axis (no copy);
- ``all_gather``: the stack itself, moved into the payload;
- ``psum``: a sum over the grid dim; ``psum_scatter``: a sum and a slice.

``Option.BcastImpl`` keeps ``slate_tpu``'s names, resolve chain and hop
schedules (``psum`` / ``ring`` / ``doubling`` / ``auto``).  On one card
every lowering delivers the owner's exact bytes by indexing, so results
are bitwise the same under every lowering; the lowering decides what the
comm audit records -- the bytes a real p x q mesh would move, per call,
with ``slate_tpu``'s per-device payload sizes and hop sets.  A
``torch.distributed`` backend that moves them between cards is a later
slice.

Lookahead helpers (``prefetch_bcast``, ``pipelined_factor_loop``) keep the
reference's schedules as plain Python loops: eager PyTorch issues step
k + d's panel work before step k's update exactly as written.

Schedule capture (``sched_audit`` / ``phase_tag``, for ``obs.schedule``):
a second audit stream whose records also carry the loop phase (``panel``
/ ``bcast`` / ``bulk``), the step and, for a hop, its (src, dst) pairs.
``slate_tpu`` records at trace time: inside a ``fori_loop`` its step is
None, its multiplicity the trip count and its pairs the root-0 schedule.
The port records every call with its concrete step, multiplicity 1 and
the owner's own pairs, so per-phase totals agree and per-record pairs
agree on the unrolled prologue steps only.

The same phase markers drive the flight recorder (``obs.flight``): while a
flight is recording, each phase of the plain loop becomes one row of its
timeline, fenced on the card and stamped by the host clock.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from .mesh import COL_AXIS, ROW_AXIS

# default trailing-update segmentation of the bucketed factorizations
BUCKETS = 4

_GRID_DIM = {ROW_AXIS: 0, COL_AXIS: 1}


# ---------------------------------------------------------------------------
# Communication-volume audit: every audited verb records (op, per-device
# payload bytes, multiplicity) while a ``comm_audit()`` context is active.
# slate_tpu records at trace time, with the enclosing loop's trip count as
# the multiplicity; the port runs its loops eagerly and records every call
# with multiplicity 1, so per-op totals (bytes x multiplicity) agree.
# ---------------------------------------------------------------------------

_AUDIT: Optional[list] = None
_AUDIT_MULT = [1]

# the schedule channel: (op, payload_bytes, mult, phase, step, pairs)
_SCHED: Optional[list] = None
_PHASE_CTX = [(None, None)]  # (phase, step) of the innermost phase_tag
# the flight recorder's active runs (obs.flight); [-1] is None when no
# flight is recording
_FLIGHT: list = [None]


@contextlib.contextmanager
def comm_audit(propagate: bool = False):
    """Yield a list that fills with (op, payload_bytes, multiplicity)
    records for every audited verb called while active.
    ``propagate=True`` re-appends the records to the enclosing audit."""
    global _AUDIT
    old, _AUDIT = _AUDIT, []
    try:
        yield _AUDIT
    finally:
        records, _AUDIT = _AUDIT, old
        if propagate and old is not None:
            old.extend(records)


@contextlib.contextmanager
def audit_scope(mult):
    """Multiply records inside by ``mult``."""
    _AUDIT_MULT.append(_AUDIT_MULT[-1] * int(mult))
    try:
        yield
    finally:
        _AUDIT_MULT.pop()


@contextlib.contextmanager
def sched_audit(propagate: bool = False):
    """Yield a list that fills with (op, payload_bytes, multiplicity,
    phase, step, pairs) records for every audited verb called while
    active; phase and step come from the innermost ``phase_tag``, pairs
    are a hop's (src, dst) list (None for a collective).
    ``propagate=True`` re-appends the records to the enclosing capture."""
    global _SCHED
    old, _SCHED = _SCHED, []
    try:
        yield _SCHED
    finally:
        records, _SCHED = _SCHED, old
        if propagate and old is not None:
            old.extend(records)


@contextlib.contextmanager
def phase_tag(phase: str, step: Optional[int] = None):
    """Tag the verbs called inside as loop phase ``phase`` of step ``step``
    (the schedule capture's tag alone)."""
    _PHASE_CTX.append((phase, None if step is None else int(step)))
    try:
        yield
    finally:
        _PHASE_CTX.pop()


@contextlib.contextmanager
def flight_row(phase: str, k: int, root_k: Optional[int] = None):
    """One row of the recording flight's timeline, without a schedule tag
    (a no-op when no flight records); ``root_k`` is the step that owns the
    row's broadcasts, when it is not ``k``."""
    run = _FLIGHT[-1]
    if run is None:
        yield
        return
    with run.row(phase, k, root_k):
        yield


@contextlib.contextmanager
def phase_scope(phase: str, step: Optional[int] = None, root_k: Optional[int] = None):
    """``phase_tag`` and, while a flight records, ``flight_row``: the body
    is loop phase ``phase`` of step ``step`` and one row of the timeline."""
    with phase_tag(phase, step), flight_row(phase, step, root_k):
        yield


def flying() -> bool:
    """True while a flight records (the callers skip their flop counts
    otherwise)."""
    return _FLIGHT[-1] is not None


def note_flops(flops: float) -> None:
    """Add closed-form flops to the recording flight's open row."""
    run = _FLIGHT[-1]
    if run is not None:
        run.add_flops(flops)


def _sched(op: str, nbytes: int, pairs) -> None:
    if _SCHED is None and _FLIGHT[-1] is None:
        return
    ph, st = _PHASE_CTX[-1]
    rec = (op, int(nbytes), _AUDIT_MULT[-1], ph, st,
           None if pairs is None else [(int(a), int(b)) for a, b in pairs])
    if _SCHED is not None:
        _SCHED.append(rec)
    if _FLIGHT[-1] is not None:
        _FLIGHT[-1].sched.append(rec)


def _payload_bytes(x: torch.Tensor) -> int:
    numel = 1
    for s in x.shape[2:]:
        numel *= int(s)
    return numel * x.element_size()


def audit(op: str, nbytes: int) -> None:
    """Record one verb by its per-device payload bytes (for a collective
    whose virtual-mesh form is plain indexing, such as the LU row
    exchanges)."""
    if _AUDIT is not None:
        _AUDIT.append((op, int(nbytes), _AUDIT_MULT[-1]))
    _sched(op, nbytes, None)


def _rec(op: str, x: torch.Tensor) -> None:
    audit(op, _payload_bytes(x))


def _rec_hop(op: str, x: torch.Tensor, perm) -> None:
    """A ppermute hop records the bytes crossing links: payload x pairs."""
    if not perm:
        return
    nbytes = _payload_bytes(x) * len(perm)
    if _AUDIT is not None:
        _AUDIT.append((op, nbytes, _AUDIT_MULT[-1]))
    _sched(op, nbytes, perm)


def _full(x: torch.Tensor, axis: str, size: int) -> torch.Tensor:
    """``x`` with its ``axis`` grid dim at full ``size`` (a stride-0 view
    where it was replicated)."""
    d = _GRID_DIM[axis]
    if x.shape[d] == size:
        return x
    shape = list(x.shape)
    shape[d] = size
    return x.expand(shape)


# ---------------------------------------------------------------------------
# plain collectives
# ---------------------------------------------------------------------------


def psum_a(x: torch.Tensor, axis: str, size: int) -> torch.Tensor:
    """Audited all-reduce over ``axis`` (of ``size`` devices): the sum,
    replicated along the axis (size-1 grid dim)."""
    _rec(f"psum[{axis}]", x)
    return _full(x, axis, size).sum(dim=_GRID_DIM[axis], keepdim=True)


def pmax(x: torch.Tensor, axis: str, size: int) -> torch.Tensor:
    """All-reduce max over ``axis``, replicated along it (size-1 grid dim).
    Not audited: ``slate_tpu`` calls ``lax.pmax`` bare, outside its audit."""
    return _full(x, axis, size).amax(dim=_GRID_DIM[axis], keepdim=True)


def all_gather_a(x: torch.Tensor, axis_name: str, size: int, axis: int = 0) -> torch.Tensor:
    """Audited all_gather over ``axis_name``: every device receives the
    stack of the axis' payloads at payload dim ``axis`` (a view)."""
    _rec(f"all_gather[{axis_name}]", x)
    d = _GRID_DIM[axis_name]
    # the axis' grid dim becomes payload dim ``axis`` (index 1 + axis once
    # the grid dim is out), then a size-1 grid dim: the same on every device
    stacked = _full(x, axis_name, size).movedim(d, 1 + axis)
    return stacked.unsqueeze(d)


def psum_scatter_a(x: torch.Tensor, axis_name: str, size: int,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """Audited reduce-scatter (``tiled=False``): device i of the axis
    receives the sum over the axis of payload slice i along
    ``scatter_dimension``."""
    _rec(f"psum_scatter[{axis_name}]", x)
    d = _GRID_DIM[axis_name]
    s = _full(x, axis_name, size).sum(dim=d)  # grid dim d gone
    # payload dim ``scatter_dimension`` (now at 1 + sd) becomes grid dim d
    return s.movedim(1 + scatter_dimension, d)


def ppermute_a(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """Audited ppermute over ``axis``: device ``t`` of the axis receives
    device ``s``'s payload for every pair ``(s, t)`` of ``perm``, and a
    device no pair targets receives zeros (``lax.ppermute``).  ``x`` holds
    every device's payload along the axis.  Records the bytes crossing
    links, payload x pairs, as ``slate_tpu``'s ``ppermute_a`` does."""
    _rec_hop(f"ppermute[{axis}]", x, perm)
    d = _GRID_DIM[axis]
    src = [None] * x.shape[d]
    for s, t in perm:
        src[int(t)] = int(s)
    out = x.index_select(d, torch.tensor([s or 0 for s in src], device=x.device))
    idle = [t for t, s in enumerate(src) if s is None]
    if idle:
        out.index_fill_(d, torch.tensor(idle, device=x.device), 0)
    return out


# ---------------------------------------------------------------------------
# Option.BcastImpl: the rooted-broadcast lowering and its hop schedules
# ---------------------------------------------------------------------------

BCAST_IMPLS = ("psum", "ring", "doubling", "auto")
BCAST_IMPL_ENV = "SLATE_TPU_BCAST_IMPL"

_IMPL_DEFAULT = [None]  # process-wide default (use_bcast_impl)
_IMPL_ACTIVE = ["psum"]  # the lowering a driver runs under (bcast_impl_scope)


def _check_impl(impl: str) -> str:
    if impl not in BCAST_IMPLS:
        raise ValueError(f"unknown bcast impl {impl!r}; expected one of {BCAST_IMPLS}")
    return impl


def resolve_bcast_impl(impl: Optional[str] = None) -> str:
    """explicit argument > ``use_bcast_impl`` context >
    ``SLATE_TPU_BCAST_IMPL`` environment > ``auto``."""
    if impl is None:
        impl = _IMPL_DEFAULT[-1]
    if impl is None:
        impl = os.environ.get(BCAST_IMPL_ENV) or "auto"
    return _check_impl(impl)


@contextlib.contextmanager
def use_bcast_impl(impl: str):
    """Set the default broadcast lowering for drivers called
    inside; an explicit ``bcast_impl=`` argument still wins."""
    _IMPL_DEFAULT.append(_check_impl(impl))
    try:
        yield
    finally:
        _IMPL_DEFAULT.pop()


@contextlib.contextmanager
def bcast_impl_scope(impl: str):
    """Activate a lowering for the broadcast verbs called inside (the
    drivers wrap their loops in it with the resolved impl)."""
    _IMPL_ACTIVE.append(_check_impl(impl))
    try:
        yield
    finally:
        _IMPL_ACTIVE.pop()


def _impl_for(size: int) -> str:
    """Concrete per-axis lowering: auto is doubling on power-of-two axes,
    ring otherwise; doubling on a non-power-of-two axis degrades to ring."""
    impl = _IMPL_ACTIVE[-1]
    if impl == "auto":
        return "doubling" if size & (size - 1) == 0 else "ring"
    if impl == "doubling" and size & (size - 1):
        return "ring"
    return impl


def _bcast_hops(impl: str, size: int, root: int):
    """Static hop schedule of a rooted broadcast: a list of ppermute perms.
    ring: s-1 single-pair hops around the ring; doubling: log2(s) hops, hop
    h multicasting from the 2^h devices that already hold the payload."""
    if impl == "ring":
        return [[((root + h - 1) % size, (root + h) % size)] for h in range(1, size)]
    hops, h = [], 1
    while h < size:
        hops.append([((root + i) % size, (root + i + h) % size) for i in range(h)])
        h *= 2
    return hops


def bcast_hop_schedule(impl: str, size: int, root: int = 0):
    """The rooted-broadcast hop schedule as plain data, with the auto and
    degradation rules; ``psum`` is not a hop lowering and raises."""
    _check_impl(impl)
    if impl == "psum":
        raise ValueError("psum is not a hop lowering; no schedule exists")
    if size <= 1:
        return []
    if impl == "auto":
        impl = "doubling" if size & (size - 1) == 0 else "ring"
    elif impl == "doubling" and size & (size - 1):
        impl = "ring"
    return _bcast_hops(impl, size, root % size)


def _owner_slice(x: torch.Tensor, owner: int, axis: str) -> torch.Tensor:
    d = _GRID_DIM[axis]
    return x if x.shape[d] == 1 else x.narrow(d, int(owner), 1)


def _rooted_bcast(x: torch.Tensor, owner: int, axis: str, size: int) -> torch.Tensor:
    """Deliver the owner's ``x`` to every device on ``axis``: the owner's
    slice, replicated (size-1 grid dim).  ``x`` may hold every device's
    value along the axis or only the owner's (size 1).  Audits the
    lowering's records: one psum, or one hop-set for the whole schedule."""
    impl = _impl_for(size)
    if impl == "psum":
        _rec(f"psum[{axis}]", x)
    elif size > 1:
        for perm in _bcast_hops(impl, size, int(owner) % size):
            _rec_hop(f"ppermute[{axis}]", x, perm)
    return _owner_slice(x, owner, axis)


def _rooted_reduce(x: torch.Tensor, owner: int, axis: str, size: int) -> torch.Tensor:
    """Owner-rooted reduction: the sum of ``x`` over ``axis`` on mesh
    index ``owner``, zeros on every other device of the axis."""
    impl = _impl_for(size)
    d = _GRID_DIM[axis]
    if impl == "psum":
        _rec(f"psum[{axis}]", x)
    elif size > 1:
        # slate_tpu audits one hop-set per rooted verb: the broadcast's
        # schedule, in its order (the reduce runs it backwards)
        for perm in _bcast_hops(impl, size, int(owner) % size):
            _rec_hop(f"ppermute[{axis}]", x, perm)
    full = _full(x, axis, size)
    out = torch.zeros_like(full)
    out.narrow(d, int(owner), 1).copy_(full.sum(dim=d, keepdim=True))
    return out


def bcast_from_col(x: torch.Tensor, owner_col: int, q: int) -> torch.Tensor:
    """Broadcast from mesh column ``owner_col`` to all columns."""
    return _rooted_bcast(x, owner_col, COL_AXIS, q)


def bcast_from_row(x: torch.Tensor, owner_row: int, p: int) -> torch.Tensor:
    return _rooted_bcast(x, owner_row, ROW_AXIS, p)


def reduce_to_col(x: torch.Tensor, owner_col: int, q: int) -> torch.Tensor:
    return _rooted_reduce(x, owner_col, COL_AXIS, q)


def reduce_to_row(x: torch.Tensor, owner_row: int, p: int) -> torch.Tensor:
    return _rooted_reduce(x, owner_row, ROW_AXIS, p)


# ---------------------------------------------------------------------------
# indexing helpers of the drivers
# ---------------------------------------------------------------------------


def local_indices(p: int, q: int, mtl: int, ntl: int, device=None, roff: int = 0, coff: int = 0):
    """(r, c, i_log, j_log) of every grid device: r (p, 1), c (1, q) and
    the logical tile indices of each local stack, i_log (p, 1, mtl - roff)
    and j_log (1, q, ntl - coff), for a view that starts at local slot
    (roff, coff)."""
    r = torch.arange(p, device=device).view(p, 1)
    c = torch.arange(q, device=device).view(1, q)
    i_log = r.view(p, 1, 1) + (roff + torch.arange(mtl - roff, device=device)).view(1, 1, -1) * p
    j_log = c.view(1, q, 1) + (coff + torch.arange(ntl - coff, device=device)).view(1, 1, -1) * q
    return r, c, i_log, j_log


def bcast_diag_tile(t_loc: torch.Tensor, k: int, p: int, q: int, roff: int = 0,
                    coff: int = 0) -> torch.Tensor:
    """Tile (k, k) on every device, (1, 1, nb, nb): a two-hop rooted
    broadcast (along the rows from mesh row k % p, then along the columns
    from mesh column k % q), or the masked double psum of the ``psum``
    lowering.  ``t_loc`` is the local view (p, q, mtl', ntl', nb, nb) of a
    trailing window starting at local slot (roff, coff)."""
    dtile = t_loc[k % p, k % q, k // p - roff, k // q - coff][None, None]
    if _IMPL_ACTIVE[-1] == "psum":
        _rec(f"psum[{ROW_AXIS}]", dtile)
        _rec(f"psum[{COL_AXIS}]", dtile)
        return dtile
    d1 = _rooted_bcast(dtile, k % p, ROW_AXIS, p)
    return _rooted_bcast(d1, k % q, COL_AXIS, q)


def route_to_block_cyclic_rows(part: torch.Tensor, targets: torch.Tensor, p: int,
                               mtl_out: int, extra: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Deliver per-target-row partials to their block-cyclic owners.

    ``part`` is (P, Q, t, q, ntl, nb, nb): on each device slot t carries the
    contribution to logical output row ``targets[..., t]`` for all q column
    shards; ``targets`` is (P|1, Q|1, t).  ``slate_tpu`` scatters the
    partials into per-target-row slots (row g at mesh row g % p, slot
    g // p, out-of-range slots dropped) and psum-scatters the column shards,
    then the row slots; the result is the (p, q, mtl_out, ntl, nb, nb)
    per-device delivery.  Here the slots are one global accumulator filled
    by one indexed add -- the same sums -- and the audit records the two
    psum-scatters with ``slate_tpu``'s payloads.  ``extra``, when given, is
    a (p, Q, mtl_out, q, ntl, nb, nb) contribution that already belongs to
    each device's own mesh row (hemmA's stored part): it joins the row
    slots of its mesh row before the scatters."""
    P, Q, t, q_, ntl, nb, nb2 = part.shape
    routed_payload = (p, mtl_out, q_, ntl, nb, nb2)
    numel = 1
    for s in routed_payload:
        numel *= s
    audit(f"psum_scatter[{COL_AXIS}]", numel * part.element_size())
    audit(f"psum_scatter[{ROW_AXIS}]", numel // q_ * part.element_size())
    if extra is not None:
        out = extra.sum(dim=1)  # (p, mtl_out, q, ntl, nb, nb): summed over the row's devices
    else:
        out = torch.zeros(routed_payload, dtype=part.dtype, device=part.device)
    tg = targets.expand(P, Q, t).reshape(-1)
    keep = (tg >= 0) & (tg // p < mtl_out)  # mode="drop"
    src = part.reshape(P * Q * t, q_, ntl, nb, nb2)
    out.index_put_((tg[keep] % p, tg[keep] // p), src[keep], accumulate=True)
    return out.permute(0, 2, 1, 3, 4, 5)  # (p, q, mtl_out, ntl, nb, nb)


# ---------------------------------------------------------------------------
# Lookahead pipelining (Option.Lookahead)
# ---------------------------------------------------------------------------


def la_depth(lookahead, nt: int) -> int:
    """An Option.Lookahead value as a pipeline depth: None is the option
    default (1), clamped to [0, nt]."""
    if lookahead is None:
        from ..types import Option, get_option

        lookahead = get_option(None, Option.Lookahead)
    return max(0, min(int(lookahead), int(nt)))


def prefetch_bcast(nt: int, depth: int, fetch, consume, state, root_of=None):
    """Software-pipelined k-loop over read-only panel broadcasts:
    ``fetch(k)`` builds step k's panels, ``consume(k, panels, state)``
    applies step k.  Depth d >= 1 fetches panels 0..d-1 first and then
    fetch(k + d) before consume(k); every panel is fetched once.

    Phases as ``slate_tpu`` tags them: fetches ``bcast``, in-loop consumes
    ``bulk``, the drained consumes untagged.  While a flight records, each
    fetch is one row (``root_of(k)``: the step owning fetch k's broadcasts,
    default k); a consume marks its own rows (``flight_row``)."""
    d = max(0, min(int(depth), int(nt)))
    root_of = root_of or (lambda k: k)

    def do_fetch(k):
        with phase_scope("bcast", k, root_k=root_of(k)):
            return fetch(k)

    def do_consume(k, panels, state):
        with phase_tag("bulk", k):
            return consume(k, panels, state)

    if d == 0:
        for k in range(nt):
            state = do_consume(k, do_fetch(k), state)
        return state
    fifo = [do_fetch(k) for k in range(d)]
    for k in range(nt - d):
        fifo.append(do_fetch(k + d))  # issued before the update consumes the head
        state = do_consume(k, fifo.pop(0), state)
    for i in range(d):  # drain
        state = consume(nt - d + i, fifo[i], state)
    return state


def pipelined_factor_loop(k0, k1, depth, panel, narrow, bulk, state, zero_payload, flops=None):
    """Deferred-trailing-update pipelining of a factorization k-loop.

    ``panel(k, state) -> (state, payload)`` factors and broadcasts step k;
    ``narrow(k, state, payload)`` applies the carried step-(k-1) update to
    the slots panel(k) reads; ``bulk(k, state, payload)`` applies it
    everywhere else (``k=None``: everywhere).  Depth 0 is the strict
    schedule; depth >= 1 runs narrow -> panel -> bulk per step, starting
    from ``zero_payload`` and draining the last payload after the loop.
    Every element receives the same arithmetic in the same order at any
    depth.

    Phases: panel(k) is ``panel`` of step k; an update is ``bulk`` of the
    step whose payload it applies (k - 1 for a deferred one; the zero
    payload of a loop's first step stands in for step k0 - 1's, which the
    previous bucket drained).  ``flops(kind, j)`` gives the closed-form
    flops of the panel of step j (kind ``panel``) and of step j's update
    (``narrow``, ``excl``: the rest, ``full``) for a recording flight."""
    if int(k1) - int(k0) <= 0:
        return state
    count = flops is not None and flying()

    def note(kind, j):
        if count:
            note_flops(flops(kind, j))

    if int(depth) <= 0:
        for k in range(k0, k1):
            with phase_scope("panel", k):
                note("panel", k)
                state, pl = panel(k, state)
            with phase_scope("bulk", k):
                note("full", k)
                state = bulk(None, state, pl)
        return state
    pl = zero_payload
    for k in range(k0, k1):
        with phase_scope("bulk", k - 1):
            if k > k0:
                note("narrow", k - 1)
            state = narrow(k, state, pl)
        with phase_scope("panel", k):
            note("panel", k)
            state, pl_new = panel(k, state)
        with phase_scope("bulk", k - 1):
            if k > k0:
                note("excl", k - 1)
            state = bulk(k, state, pl)
        pl = pl_new
    with phase_scope("bulk", k1 - 1):
        note("full", k1 - 1)
        return bulk(None, state, pl)


def bucket_plan(nt: int, p: int, q: int, nbuckets: int = BUCKETS):
    """Static trailing-update segmentation of the bucketed factorizations:
    (k0, k1, s0r, s0c) per bucket, s0r/s0c the local row/col slot cuts
    every device may apply."""
    nbkts = min(nbuckets, nt)
    bounds = [nt * g // nbkts for g in range(nbkts)] + [nt]
    for g in range(nbkts):
        k0, k1 = bounds[g], bounds[g + 1]
        yield k0, k1, max(0, (k0 - p + 1) // p), max(0, (k0 - q + 1) // q)
