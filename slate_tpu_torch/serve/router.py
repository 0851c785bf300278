"""serve.Router: admission -> accuracy class -> cached batched dispatch.

Counterpart of ``slate_tpu/serve/router.py``:

- **Admission** rides the memory model.  A meshless router admits by
  ``slate_tpu``'s per-device closed form at grid (1, 1) (where the device is
  the card), so it admits exactly the sizes ``slate_tpu``'s does.  A mesh
  router admits by ``MemoryModel.virtual_peak_bytes``: on one card the
  virtual mesh holds every one of the p q shards, so a per-device bound
  would admit sizes whose shards need p q times the budget.  The budget is
  ``hbm_budget`` (default: the card's ``total_memory`` under
  ``memmodel.HBM_SAFETY``; on the CPU pass one or set
  ``SLATE_TPU_HBM_BYTES``).
- **Accuracy class** rides the cached condition estimate
  (``numerics.CONDEST_THRESHOLD``): friendly general operators dispatch the
  f32 no-pivot factor with f64 refinement, operators past the threshold
  partial pivoting with GMRES-IR.  The estimate is memoized on the
  operand's storage and version counter, and a hit is checked bitwise, so a
  write in place misses it.
- **Dispatch** goes through the executable cache: same-class requests
  sharing a bin stack into one built program (``serve.batch``'s loop over
  the single verbs).  The stacked programs have no schedule knobs, so tuned
  options are not folded into their keys; the tuned table's consumers are
  the mesh request paths.

Operands: a tensor stays on its device; anything else goes to the card
unless the router was built with ``device="cpu"`` (``operand_device``).  A
mesh router computes on ``mesh.device``.  A traced request (obs on) fences
the card at its dispatch's and its solve's end, so its phase times cover the
work; an untraced request adds no fence.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import obs
from ..core.matrix import DEFAULT_DEVICE, operand_device
from ..types import Norm, Options, SlateError
from . import trace as rtrace
from .batch import DEFAULT_BINS, bin_for, pad_rhs_to_bin, pad_to_bin, record_batch_size
from .cache import ExecutableCache, dtype_name, executable_cache, make_key
from .metrics import serve_count


class _BufferMemo:
    """Small LRU keyed on an operand's contents identity
    (``summa.tensor_key``: storage, layout, dtype, device, version counter)
    plus ``extra``.  It keeps a copy of each key operand and checks a hit
    bitwise, so a write past the version counter (through ``.data`` or a
    numpy alias) misses too.  Capped: serving traffic rotates through a
    handful of stationary operators.  Locked: the service layer classifies
    on its submitters' threads (two threads may both miss and compute)."""

    def __init__(self, cap: int = 16) -> None:
        self._cap = cap
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, arr: torch.Tensor, extra=()) -> Optional[object]:
        from ..parallel.summa import same_bits, tensor_key

        key = (tensor_key(arr),) + tuple(extra)
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            ref, value = hit
            if not same_bits(arr, ref):  # written past the version counter
                del self._entries[key]
                return None
            self._entries.move_to_end(key)
            return value

    def put(self, arr: torch.Tensor, value, extra=()) -> None:
        from ..parallel.summa import tensor_key

        key = (tensor_key(arr),) + tuple(extra)
        ref = arr.clone()
        with self._lock:
            self._entries[key] = (ref, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# Process-wide admission memo: the closed forms are pure in (model op, nb,
# grid, dtype, budget, peak form), so they are evaluated once per key
# however many Routers are built; every evaluation counts
# ``serve.max_n_computes``.
_MAX_N_MEMO: Dict[Tuple, int] = {}

_MODEL_OP = {"posv": "potrf", "potrf": "potrf", "gemm": "summa", "summa": "summa",
             "geqrf": "geqrf", "gels": "geqrf", "heev": "he2hb", "he2hb": "he2hb"}


def _fence(x: torch.Tensor) -> None:
    """Wait for the card's work on ``x`` (nothing on the host)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class Router:
    """Synchronous request router over the batched drivers.

    ``solve_batch`` is the serving entry: a list of (op, a, b) requests is
    admitted, classified, binned into canonical shapes, stacked and
    dispatched through the executable cache."""

    def __init__(self, mesh=None, nb: int = 64, bins: Sequence[int] = DEFAULT_BINS,
                 hbm_budget: Optional[int] = None, cache: Optional[ExecutableCache] = None,
                 opts: Optional[Options] = None, device=None) -> None:
        from ..obs import memmodel

        self.mesh = mesh
        self.nb = nb
        self.bins = tuple(sorted(bins))
        self.cache = cache if cache is not None else executable_cache
        self.opts = dict(opts) if opts else {}
        self._device = None if device is None else torch.device(device)
        home = mesh.device if mesh is not None else (self._device or torch.device(DEFAULT_DEVICE))
        self._budget = hbm_budget if hbm_budget is not None else int(
            memmodel.hbm_budget(home) * memmodel.HBM_SAFETY)
        self._max_n: Dict[str, int] = {}
        self._condest_memo = _BufferMemo()
        # precision-tier entry point per accuracy class (the service
        # controller's escalation knob): empty is the identity, e.g.
        # {"friendly": "hostile"} makes friendly operators enter at the
        # pp + GMRES-IR tier
        self.tier_map: Dict[str, str] = {}

    @property
    def device(self) -> torch.device:
        """Where a non-tensor operand goes: the mesh's device, else the
        router's, else the card."""
        if self.mesh is not None:
            return self.mesh.device
        return self._device or torch.device(DEFAULT_DEVICE)

    def _operand(self, x) -> torch.Tensor:
        """A request operand on its compute device: a tensor where it lies,
        anything else on the router's device (the card by default)."""
        if self.mesh is not None:
            return torch.as_tensor(x, device=self.mesh.device)
        return torch.as_tensor(x, device=operand_device(x, self._device))

    # -- admission ---------------------------------------------------------

    def max_n(self, op: str) -> int:
        """Largest admissible n for ``op`` under the budget: ``slate_tpu``'s
        per-device form at grid (1, 1) without a mesh, the whole virtual
        mesh's peak with one (memoized process-wide, with a per-instance
        first level)."""
        from ..obs import memmodel

        got = self._max_n.get(op)
        if got is None:
            model_op = _MODEL_OP.get(op, "getrf_nopiv")
            if self.mesh is None:
                grid, peak = (1, 1), "device_peak_bytes"
            else:
                grid, peak = (self.mesh.p, self.mesh.q), "virtual_peak_bytes"
            nb = max(self.nb, 8)
            key = (model_op, nb, grid, "float64", self._budget, peak)
            got = _MAX_N_MEMO.get(key)
            if got is None:
                serve_count("max_n_computes")
                got = memmodel.predict_max_n(self._budget, op=model_op, nb=nb, grid=grid,
                                             dtype="float64", peak=peak)
                _MAX_N_MEMO[key] = got
            self._max_n[op] = got
        return got

    def admit(self, op: str, n: int) -> None:
        if n > self.max_n(op):
            serve_count("admission_rejects")
            raise SlateError(
                f"serve admission: {op} n={n} exceeds modeled HBM budget (max admissible "
                f"n={self.max_n(op)}, budget {self._budget / 2**30:.2f} GiB)")

    def admit_batch(self, op: str, m: int, count: int, itemsize: int) -> None:
        """Aggregate residency of one stacked dispatch: the (count, m, m)
        stack, its right-hand sides and solutions and the verbs' transients
        live at once (~3.5 stack copies, ``budget.REQUEST_RESIDENCY_FACTOR``)."""
        from .budget import REQUEST_RESIDENCY_FACTOR

        agg = REQUEST_RESIDENCY_FACTOR * count * m * m * itemsize
        if agg > self._budget:
            serve_count("admission_rejects")
            raise SlateError(
                f"serve admission: batch of {count} x {op} n={m} needs ~{agg / 2**30:.2f} GiB "
                f"aggregate, over the {self._budget / 2**30:.2f} GiB budget -- split the batch")

    # -- accuracy class ----------------------------------------------------

    def classify(self, op: str, a: torch.Tensor) -> str:
        """"friendly" | "hostile" by the cached reciprocal condition
        estimate of an f64 operand (an f32 LU probe and the Hager-Higham
        estimator); any other dtype is friendly (the ladder is the f64
        story)."""
        from ..linalg import norms
        from ..linalg.lu import getrf_array
        from ..obs.numerics import CONDEST_THRESHOLD

        if a.dtype != torch.float64:
            return "friendly"
        cached = self._condest_memo.get(a, (op,))
        if cached is None:
            anorm = a.abs().sum(dim=0).max()  # one-norm
            f = getrf_array(a.to(torch.float32))
            cached = float(norms.gecondest(Norm.One, f, anorm))
            self._condest_memo.put(a, cached, (op,))
        else:
            serve_count("condest_cache_hits")
        cond = (1.0 / cached) if cached > 0 else float("inf")
        hostile = cond > CONDEST_THRESHOLD
        serve_count("class_hostile" if hostile else "class_friendly")
        return "hostile" if hostile else "friendly"

    def effective_class(self, op: str, a) -> str:
        """The class ``solve_batch`` dispatches ``(op, a)`` under: the
        condest class composed with ``tier_map``."""
        if op == "gesv" and not self._mesh_resilient(op):
            klass = self.classify(op, self._operand(a))
        else:
            klass = "friendly"
        return self.tier_map.get(klass, klass)

    # -- dispatch ----------------------------------------------------------

    def _key_for(self, op: str, variant: str, args: Tuple[torch.Tensor, ...], batch: int):
        # the one source of the stacked-program key (the tracer's hit / miss
        # probe agrees with the lookup by construction); no tuned options
        return make_key(f"{op}_{variant}", args, batch=batch, mesh=None)

    def solve_batch(self, requests: Sequence[Tuple[str, object, object]],
                    tenants: Optional[Sequence[Optional[str]]] = None,
                    traces: Optional[List] = None) -> List[torch.Tensor]:
        """Serve a list of (op, a, b) requests (op in {"posv", "gesv"}).
        Returns the solutions in order.  Same-class requests sharing a bin
        run as ONE stacked program (ragged sizes identity-pad to the bin).

        ``tenants`` optionally names each request's tenant (its spans and
        metrics carry the tag while obs is on).  With obs on every request
        carries a ``RequestTrace`` terminated with exactly one outcome: a
        failure anywhere aborts the whole call, and every still-open trace
        then terminates as ``reject_batch_abort`` (the failing request
        carries its own cause).  ``traces`` hands in traces opened earlier
        (None entries get a fresh one)."""
        trs: List[Optional[rtrace.RequestTrace]] = (
            list(traces) if traces is not None else [None] * len(requests))
        try:
            return self._solve_batch_inner(requests, trs, tenants)
        except Exception:
            for tr in trs:
                if tr is not None and tr.outcome is None:
                    tr.finish("reject_batch_abort")
            raise

    def _solve_batch_inner(self, requests, traces, tenants=None):
        groups: Dict[Tuple, List[int]] = {}
        padded: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(requests)
        shapes: List[Tuple[int, int]] = [(0, 0)] * len(requests)
        for i, (op, a, b) in enumerate(requests):
            serve_count("requests")
            a, b = self._operand(a), self._operand(b)
            n = a.shape[0]
            shapes[i] = (n, b.ndim)
            tr = traces[i]
            if tr is None:
                tr = traces[i] = rtrace.new_trace(op, n, self.nb, dtype_name(a),
                                                  tenant=tenants[i] if tenants else None)
            try:
                with rtrace.phase(tr, "admission"):
                    m = bin_for(n, self.bins)
                    if m is None:
                        serve_count("admission_rejects")
                        raise SlateError(f"serve: n={n} exceeds the largest bin {self.bins[-1]}")
                    self.admit(op, m)  # the program runs at the padded bin size
            except SlateError:
                rtrace.finish(tr, "reject_admission")
                raise
            if tr is not None:
                tr.bin = m
            # the resilient mesh path has its own dispatch and never reads
            # the class: skip the condest probe there
            if op == "gesv" and not self._mesh_resilient(op):
                with rtrace.phase(tr, "classify"):
                    klass = self.classify(op, a)
            else:
                klass = "friendly"
            klass = self.tier_map.get(klass, klass)
            if tr is not None:
                tr.klass = klass
            bd = b if b.ndim == 2 else b[:, None]
            padded[i] = (pad_to_bin(a, m), pad_rhs_to_bin(bd, m))
            groups.setdefault((op, klass, m, bd.shape[1], dtype_name(a)), []).append(i)

        out: List[Optional[torch.Tensor]] = [None] * len(requests)
        for (op, klass, m, _nrhs, _dt), idxs in groups.items():
            trs = [traces[i] for i in idxs]
            for tr in trs:
                if tr is not None:
                    tr.batch = len(idxs)
            a_stack = torch.stack([padded[i][0] for i in idxs])
            b_stack = torch.stack([padded[i][1] for i in idxs])
            try:
                self.admit_batch(op, m, len(idxs), a_stack.element_size())
            except SlateError:
                for tr in trs:
                    rtrace.finish(tr, "reject_admission")
                raise
            record_batch_size(op, len(idxs))
            if self._mesh_resilient(op):
                xs, info = self._solve_group_mesh(op, a_stack, b_stack, trs)
            else:
                key = self._key_for(op, klass, (a_stack, b_stack), len(idxs))
                live = any(tr is not None for tr in trs)
                hit = self.cache.contains(key) if live else False
                with rtrace.phase_all(trs, "cache_lookup", result="hit" if hit else "miss"):
                    prog = self.cache.get_or_build(
                        key, lambda op=op, klass=klass: _build_batched(op, klass))
                with rtrace.phase_all(trs, "solve"):
                    with obs.driver_span("serve.dispatch", op=op, klass=klass, batch=len(idxs)):
                        xs, info = prog(a_stack, b_stack)
                        if live:
                            _fence(xs)
            serve_count("batches")
            serve_count("batched_solves", len(idxs))
            infos = [int(v) for v in info.tolist()]
            bad = [idxs[j] for j, v in enumerate(infos) if v != 0]
            if bad:
                for j, i in enumerate(idxs):
                    if infos[j] != 0:
                        rtrace.finish(traces[i], "failed_info")
                raise SlateError(
                    f"serve: {op} batch reported nonzero info for request indices {bad} -- "
                    f"operand(s) not factorizable in the {klass} class")
            for j, i in enumerate(idxs):
                n, bdim = shapes[i]
                xi = xs[j, :n]
                out[i] = xi[:, 0] if bdim == 1 else xi
                rtrace.finish(traces[i])  # the note-attributed served terminal
        return out

    def solve(self, op: str, a, b, tenant: Optional[str] = None) -> torch.Tensor:
        """One request through the full policy (a batch of one)."""
        return self.solve_batch([(op, a, b)], tenants=[tenant] if tenant else None)[0]

    # -- graceful degradation ------------------------------------------------
    #
    # Armed with a resilience policy (Option.FaultTolerance and / or
    # Option.Checkpoint) and a mesh, requests dispatch through the protected
    # mesh drivers, and the router absorbs their failure modes:
    # - a transient FtError retries ONCE under FtPolicy.Recompute
    #   (``serve.retries``);
    # - a Preempted factorization resumes from its checkpoint on the
    #   router's mesh (``serve.resumes``);
    # - a preempted-and-unresumable request (killed before the first
    #   snapshot, or re-killed on resume) is rejected
    #   (``serve.admission_rejects``) with a structured error, never served
    #   NaNs.

    def _ckpt_every(self):
        from ..ft.ckpt import resolve_checkpoint
        from ..types import Option, get_option

        return resolve_checkpoint(get_option(self.opts, Option.Checkpoint, default=None))

    def _mesh_resilient(self, op: str) -> bool:
        if self.mesh is None or op not in ("posv", "gesv"):
            return False
        from ..ft.policy import FtPolicy, resolve_policy

        return resolve_policy(self.opts) != FtPolicy.Off or self._ckpt_every() is not None

    def _solve_group_mesh(self, op: str, a_stack, b_stack, trs=None):
        xs, infos = [], []
        for i in range(a_stack.shape[0]):
            tr = trs[i] if trs is not None else None
            x, info = self._solve_one_mesh(op, a_stack[i], b_stack[i], tr)
            xs.append(x)
            infos.append(torch.as_tensor(info, device=x.device).to(torch.int32))
        return torch.stack(xs), torch.stack(infos)

    def _solve_one_mesh(self, op: str, a, b, tr=None):
        try:
            return self._solve_one_mesh_inner(op, a, b, tr)
        except Exception:
            # an error escaping this request's own dispatch is its failure,
            # not a sibling's: the batch-abort sweep labels only bystanders
            if tr is not None and tr.outcome is None:
                tr.finish("failed_error")
            raise

    def _solve_one_mesh_inner(self, op: str, a, b, tr=None):
        from ..ft import ckpt as _ckpt
        from ..ft.policy import FtError, FtPolicy, resolve_policy
        from ..obs.numerics import GrowthAbort

        pol = resolve_policy(self.opts)
        try:
            return self._guard(op, a, b, *self._factor_solve_mesh(op, a, b, pol, tr), tr=tr)
        except _ckpt.Preempted as e:
            if e.checkpoint is None:
                serve_count("admission_rejects")
                rtrace.finish(tr, "reject_unresumable")
                raise SlateError(
                    f"serve: {op} request preempted at step {e.killed_at} before its first "
                    "checkpoint -- rejected (unresumable), not served NaNs") from e
            serve_count("resumes")
            rtrace.note(tr, "resume")
            try:
                with rtrace.phase(tr, "resume", killed_at=e.killed_at,
                                  from_step=e.checkpoint.step):
                    resumed = self._resume_solve(op, b, e.checkpoint, tr)
                return self._guard(op, a, b, *resumed, tr=tr)
            except _ckpt.Preempted as e2:
                serve_count("admission_rejects")
                rtrace.finish(tr, "reject_unresumable")
                raise SlateError(
                    f"serve: {op} request re-preempted on resume at step {e2.killed_at} -- "
                    "rejected") from e2
            except GrowthAbort:
                # the resumed no-pivot factor kept policing its growth gauge
                # and aborted: one pivoted retry, as uninterrupted
                serve_count("retries")
                rtrace.note(tr, "growth_retry")
                with rtrace.phase(tr, "retry", cause="growth_abort"):
                    retried = self._factor_solve_pp(op, a, b, tr=tr)
                return self._guard(op, a, b, *retried, tr=tr)
        except FtError:
            # transient SDC: one retry under the recompute policy; a second
            # FtError (persistent corruption) surfaces raw
            serve_count("retries")
            rtrace.note(tr, "ft_retry")
            with rtrace.phase(tr, "retry", cause="ft_error"):
                retried = self._factor_solve_mesh(op, a, b, FtPolicy.Recompute, tr)
            return self._guard(op, a, b, *retried, tr=tr)

    def _guard(self, op: str, a, b, x, info, tr=None):
        """The resilient mesh path bypasses the condest-keyed ladder (the
        ABFT LU is no-pivot), so no solution leaves unvalidated: one
        residual check rejects a silently inaccurate solve."""
        if int(info) != 0:
            return x, info  # the caller surfaces nonzero info itself
        n = a.shape[0]
        eps = float(torch.finfo(a.dtype).eps)
        scale = float(a.abs().max()) * max(float(x.abs().max()), 1.0) * n
        resid = float((a @ x - b).abs().max())
        if not resid == resid or resid == float("inf") or resid > 1e6 * n * eps * max(scale, 1.0):
            serve_count("admission_rejects")
            rtrace.finish(tr, "reject_residual")
            raise SlateError(
                f"serve: {op} resilient-path solution failed the residual gate (|Ax-b| max "
                f"{resid:.3g}) -- rejected, not served")
        return x, info

    def _resil_opts(self):
        """The schedule / monitor options the resilient mesh path forwards."""
        from ..types import Option, get_option

        return (get_option(self.opts, Option.Lookahead), get_option(self.opts, Option.BcastImpl),
                get_option(self.opts, Option.PanelImpl), get_option(self.opts, Option.NumMonitor))

    def _factor_solve_mesh(self, op: str, a, b, pol, tr=None):
        from ..ft.ckpt import potrf_ckpt
        from ..ft.policy import FtPolicy
        from ..parallel.dist import from_dense

        every = self._ckpt_every()
        la, bi, pi, nm = self._resil_opts()
        if pol != FtPolicy.Off:
            if every is not None:
                raise SlateError(
                    "serve: Option.FaultTolerance and Option.Checkpoint cannot be combined (the "
                    "ABFT kernels are not checkpointed yet); arm one of them")
            from ..ft import abft

            with rtrace.phase(tr, "factor", method="abft", policy=str(pol)):
                if op == "posv":
                    l, info, _rep = abft.potrf_ft(a, self.mesh, self.nb, policy=pol, lookahead=la,
                                                  bcast_impl=bi, panel_impl=pi)
                else:
                    # the only ABFT LU is no-pivot: _guard validates it
                    l, info, _rep = abft.getrf_nopiv_ft(a, self.mesh, self.nb, policy=pol,
                                                        lookahead=la, bcast_impl=bi, panel_impl=pi)
            return self._trsm_solve(op, l, b, tr=tr), info
        d = from_dense(a, self.mesh, self.nb, diag_pad_one=True)
        if op == "posv":
            with rtrace.phase(tr, "factor", method="potrf_ckpt"):
                l, info = potrf_ckpt(d, every=every, bcast_impl=bi, panel_impl=pi,
                                     num_monitor=nm)
            return self._trsm_solve(op, l, b, tr=tr), info
        # gesv, monitored: the cheap no-pivot factor first (the friendly
        # class), policed by the chain's growth gauge; a GrowthAbort is one
        # retry with partial pivoting.  Unmonitored requests keep partial
        # pivoting outright.
        from ..obs.numerics import GrowthAbort, resolve_num_monitor

        if resolve_num_monitor(nm) == "on":
            from ..ft.ckpt import getrf_nopiv_ckpt

            try:
                with rtrace.phase(tr, "factor", method="nopiv_ckpt"):
                    lu, info = getrf_nopiv_ckpt(d, every=every, bcast_impl=bi, panel_impl=pi,
                                                num_monitor=nm)
                serve_count("class_friendly")
                return self._trsm_solve(op, lu, b, tr=tr), info
            except GrowthAbort:
                serve_count("retries")
                rtrace.note(tr, "growth_retry")
                with rtrace.phase(tr, "retry", cause="growth_abort"):
                    return self._factor_solve_pp(op, b_dense=b, d=d, tr=tr)
        return self._factor_solve_pp(op, b_dense=b, d=d, tr=tr)

    def _factor_solve_pp(self, op: str, a=None, b_dense=None, d=None, tr=None):
        """The pivoted gesv tier (the growth-abort retries: the first
        attempt hands over its DistMatrix, the resumed abort re-encodes from
        the dense operand)."""
        from ..ft.ckpt import getrf_pp_ckpt
        from ..parallel.dist import from_dense

        _la, bi, _pi, nm = self._resil_opts()
        if d is None:
            d = from_dense(a, self.mesh, self.nb, diag_pad_one=True)
        with rtrace.phase(tr, "factor", method="pp_ckpt"):
            lu, perm, info = getrf_pp_ckpt(d, every=self._ckpt_every(), bcast_impl=bi,
                                           num_monitor=nm)
        serve_count("class_hostile")
        return self._trsm_solve(op, lu, b_dense, perm=perm, tr=tr), info

    def _resume_solve(self, op: str, b, checkpoint, tr=None):
        from ..ft import elastic

        _la, bi, pi, _nm = self._resil_opts()
        with rtrace.phase(tr, "factor", method="elastic_resume"):
            out = elastic.resume(checkpoint, self.mesh, bcast_impl=bi, panel_impl=pi)
        if len(out) == 3:  # getrf_pp: (LU, perm, info)
            lu, perm, info = out
            return self._trsm_solve(op, lu, b, perm=perm, tr=tr), info
        l, info = out
        return self._trsm_solve(op, l, b, tr=tr), info

    def _trsm_solve(self, op: str, l, b, perm=None, tr=None):
        from ..parallel.dist import from_dense, to_dense
        from ..parallel.dist_lu import permute_rows_dist
        from ..parallel.dist_trsm import trsm_dist
        from ..types import Diag, Op, Uplo

        la, bi, _pi, _nm = self._resil_opts()
        with rtrace.phase(tr, "solve"):
            bd = from_dense(b, self.mesh, self.nb)
            if perm is not None:
                bd = permute_rows_dist(bd, perm)
            if op == "posv":
                y = trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, lookahead=la, bcast_impl=bi)
                x = trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, lookahead=la, bcast_impl=bi)
            else:
                y = trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.Unit, lookahead=la,
                              bcast_impl=bi)
                x = trsm_dist(l, y, Uplo.Upper, Op.NoTrans, lookahead=la, bcast_impl=bi)
            out = to_dense(x)[: b.shape[0]]
            if tr is not None:
                _fence(out)
        return out

    # -- QR (least-squares) tier -------------------------------------------

    def gels(self, a, b, tenant: Optional[str] = None) -> torch.Tensor:
        """Serve one least-squares request min ||A x - b|| through the mesh
        CAQR tier (a mesh is required; m >= n).  With Option.NumMonitor on,
        a factor whose orthogonality gauge is past
        ``obs.numerics.ORTH_THRESHOLD`` is not served raw: the router
        retries once with a re-orthogonalization pass (a second CAQR of the
        explicitly formed Q, both triangular factors folded into the
        solve), counted as one ``serve.retries`` with the note
        ``orth_retry``.  Unmonitored requests keep the single-pass factor."""
        from ..obs import numerics as _num
        from ..parallel.dist import from_dense, to_dense
        from ..parallel.dist_qr import geqrf_dist, unmqr_dist
        from ..types import Op

        if self.mesh is None:
            raise SlateError("serve: the gels tier requires a mesh")
        serve_count("requests")
        a, b = self._operand(a), self._operand(b)
        m, n = a.shape
        tr = rtrace.new_trace("gels", m, self.nb, dtype_name(a), tenant=tenant)
        try:
            with rtrace.phase(tr, "admission"):
                self.admit("gels", m)
        except SlateError:
            rtrace.finish(tr, "reject_admission")
            raise
        try:
            _la, bi, pi, nm = self._resil_opts()
            monitored = _num.resolve_num_monitor(nm) == "on"
            if monitored:
                _num.clear_last("geqrf")  # police THIS factor's gauge
            bcol = b if b.ndim == 2 else b[:, None]
            with rtrace.phase(tr, "factor", method="geqrf_dist"):
                f1 = geqrf_dist(from_dense(a, self.mesh, self.nb), bcast_impl=bi, panel_impl=pi,
                                num_monitor=nm)
            if monitored and _num.orth_exceeded("geqrf"):
                serve_count("retries")
                rtrace.note(tr, "orth_retry")
                with rtrace.phase(tr, "retry", cause="orth_loss"):
                    # Q1 = Q2 R2 re-orthogonalizes the computed basis, so
                    # A = Q2 (R2 R1): solve R2 z = Q2^H b, then R1 x = z
                    eye = torch.eye(m, n, dtype=a.dtype, device=a.device)
                    q1 = to_dense(unmqr_dist(f1, from_dense(eye, self.mesh, self.nb), Op.NoTrans,
                                             bcast_impl=bi))[:, :n]
                    f2 = geqrf_dist(from_dense(q1, self.mesh, self.nb), bcast_impl=bi,
                                    panel_impl=pi, num_monitor=nm)
                    qb = to_dense(unmqr_dist(f2, from_dense(bcol, self.mesh, self.nb),
                                             Op.ConjTrans, bcast_impl=bi))[:n]
                    z, info2 = self._rsolve(f2, qb, n, bi)
                    x, info1 = self._rsolve(f1, z, n, bi)
                    info = torch.where(info1 != 0, info1, info2)
            else:
                with rtrace.phase(tr, "solve"):
                    qb = to_dense(unmqr_dist(f1, from_dense(bcol, self.mesh, self.nb),
                                             Op.ConjTrans, bcast_impl=bi))[:n]
                    x, info = self._rsolve(f1, qb, n, bi)
            if int(info) != 0:
                rtrace.finish(tr, "failed_info")
                raise SlateError(
                    f"serve: gels factor reported info={int(info)} -- R diagonal exactly zero "
                    "(rank-deficient operand)")
            if tr is not None:
                _fence(x)
            rtrace.finish(tr)
            return x[:, 0] if b.ndim == 1 else x
        except Exception:
            if tr is not None and tr.outcome is None:
                tr.finish("failed_error")
            raise

    def _rsolve(self, f, y, n: int, bi):
        """x = R^-1 y from CAQR factors: R's top square through one dense
        triu round trip (the gels_mesh composition) into an upper trsm
        sweep; info flags an exactly-zero R diagonal."""
        from ..parallel.dist import from_dense, to_dense
        from ..parallel.dist_trsm import trsm_dist
        from ..types import Op, Uplo

        r = torch.triu(to_dense(f.fact)[:n, :n])
        rd = from_dense(r, self.mesh, self.nb, diag_pad_one=True)
        xd = trsm_dist(rd, from_dense(y, self.mesh, self.nb), Uplo.Upper, Op.NoTrans,
                       bcast_impl=bi)
        zero = torch.diagonal(r) == 0
        info = torch.where(zero.any(), zero.to(torch.int8).argmax() + 1, 0).to(torch.int32)
        return to_dense(xd)[:n], info


def _gesv_friendly_one(a1: torch.Tensor, b1: torch.Tensor):
    """The cheap class on one problem: the f32 no-pivot factor, f64
    refinement (30 trips), the full solve when it does not converge.
    Returns (x, info)."""
    from ..linalg.lu import gesv_array, getrf_nopiv_array, getrs_array
    from ..linalg.refine import _fallback, _refine_loop

    f32 = getrf_nopiv_array(a1.to(torch.float32))
    x, iters, done = _refine_loop(a1, b1, lambda r: getrs_array(f32, r.to(torch.float32)), 30)

    def full():
        xf, f = gesv_array(a1, b1)
        return xf, f.info

    x, _iters, info = _fallback(done, x, iters, full)
    return x, info


def _gesv_hostile_one(a1: torch.Tensor, b1: torch.Tensor):
    """pp + GMRES-IR on one problem; GMRES-IR has no LAPACK info, so a
    non-finite solution is the failure signal (info 1)."""
    from ..linalg.refine import gesv_mixed_gmres_array

    x, _resid = gesv_mixed_gmres_array(a1, b1)
    return x, torch.where(torch.isfinite(x).all(), 0, 1).to(torch.int32)


def _build_batched(op: str, variant: str):
    """The stacked solve body for one (op, accuracy class) pair: what the
    executable cache builds and pins."""
    from .batch import posv_batched, solve_rows

    if op == "posv":
        return posv_batched
    if op != "gesv":
        raise ValueError(f"router has no batched driver for {op!r}")
    return functools.partial(solve_rows, _gesv_hostile_one if variant == "hostile"
                             else _gesv_friendly_one)
