"""Per-tenant device-memory budgets for the batch-window queue.

Counterpart of ``slate_tpu/serve/budget.py`` (the queue that consumes the
ledger comes with the service layer).  The default budget is the card's
``obs.memmodel.hbm_budget()`` under ``HBM_SAFETY``; on the CPU pass
``default_budget`` or set ``SLATE_TPU_HBM_BYTES``.

The Router's admission bound (``MemoryModel.predict_max_n`` +
``admit_batch``) protects the DEVICE: no single dispatch may exceed the
modeled HBM budget.  It says nothing about WHO is consuming it — one
tenant's n=16384 burst passes per-request admission and still evicts
everyone else's working set.  The ledger here is the tenant dimension of
that bound: every queued-or-in-flight request holds a modeled-byte
reservation against its tenant's budget, and a submit that would push
the tenant past its budget is refused BEFORE it enters a window
(``reject_budget`` in the RequestTrace taxonomy — the fair-share twin
of ``reject_admission``).

The modeled cost of one request is the same closed form
``Router.admit_batch`` applies to a whole stacked dispatch
(~3.5 copies of the binned operand: operand + factor + solution +
the single verbs' transients), prorated to one problem — the ledger and
the device bound price a request identically, so a stream that is
tenant-admissible is also device-admissible once windows cap at B.

Weights live here too: the ledger is the ONE place the queue's deficit
round-robin reads a tenant's fair share from, so budget and weight are
declared together (``BudgetLedger(budgets=..., weights=...)``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# matches Router.admit_batch's aggregate-residency model: the whole
# stack lives at once, ~3.5 copies per problem
REQUEST_RESIDENCY_FACTOR = 3.5


def request_cost(m: int, itemsize: int) -> int:
    """Modeled HBM residency of ONE bin-padded request inside a stacked
    dispatch (the per-problem share of Router.admit_batch's bound)."""
    return int(REQUEST_RESIDENCY_FACTOR * m * m * itemsize)


class TenantAccount:
    """One tenant's ledger row: budget, fair-share weight, the live
    reservation total, and its high-water mark (the smoke's no-tenant-
    over-budget assertion reads ``peak``)."""

    __slots__ = ("tenant", "budget", "weight", "reserved", "peak")

    def __init__(self, tenant: str, budget: int, weight: float) -> None:
        self.tenant = tenant
        self.budget = int(budget)
        self.weight = float(weight)
        self.reserved = 0
        self.peak = 0

    def headroom(self) -> int:
        return self.budget - self.reserved


class BudgetLedger:
    """Thread-safe per-tenant reservation ledger.

    Tenants not named in ``budgets`` get ``default_budget`` (default:
    the device HBM budget under the memmodel safety factor — one tenant
    alone may use the whole device; the ledger only bites once budgets
    are declared tighter).  ``try_reserve`` is the queue's admission
    probe: False means the submit must be refused as ``reject_budget``
    — the ledger itself never raises and never counts, so policy
    (reject vs backpressure) stays in the queue."""

    def __init__(self, budgets: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 default_budget: Optional[int] = None,
                 default_weight: float = 1.0) -> None:
        from ..obs import memmodel

        self._default_budget = int(
            default_budget if default_budget is not None
            else memmodel.hbm_budget() * memmodel.HBM_SAFETY)
        self._default_weight = float(default_weight)
        self._declared_budgets = dict(budgets or {})
        self._declared_weights = {t: float(v)
                                  for t, v in (weights or {}).items()}
        for t, v in [("<default>", self._default_weight),
                     *self._declared_weights.items()]:
            if not v > 0.0:   # also catches NaN
                raise ValueError(
                    f"budget: DRR weight for tenant {t!r} must be > 0, "
                    f"got {v!r} — a non-positive weight never accrues "
                    "deficit and would stall the dequeue rotation")
        self._accounts: Dict[str, TenantAccount] = {}
        self._lock = threading.Lock()

    def account(self, tenant: str) -> TenantAccount:
        with self._lock:
            acct = self._accounts.get(tenant)
            if acct is None:
                acct = self._accounts[tenant] = TenantAccount(
                    tenant,
                    self._declared_budgets.get(tenant, self._default_budget),
                    self._declared_weights.get(tenant, self._default_weight))
            return acct

    def weight(self, tenant: str) -> float:
        return self.account(tenant).weight

    def headroom(self, tenant: str) -> int:
        return self.account(tenant).headroom()

    def try_reserve(self, tenant: str, cost: int) -> bool:
        """Reserve ``cost`` modeled bytes against ``tenant``'s budget;
        False (nothing reserved) when the tenant would go over."""
        acct = self.account(tenant)
        with self._lock:
            if acct.reserved + cost > acct.budget:
                return False
            acct.reserved += cost
            acct.peak = max(acct.peak, acct.reserved)
            return True

    def release(self, tenant: str, cost: int) -> None:
        acct = self.account(tenant)
        with self._lock:
            acct.reserved = max(0, acct.reserved - cost)

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant ledger view for the ``/queue.json`` scrape and the
        ``serve.queue_budget_headroom_bytes`` gauges."""
        with self._lock:
            return {
                name: {
                    "budget_bytes": acct.budget,
                    "reserved_bytes": acct.reserved,
                    "headroom_bytes": acct.headroom(),
                    "peak_bytes": acct.peak,
                    "weight": acct.weight,
                }
                for name, acct in sorted(self._accounts.items())
            }
