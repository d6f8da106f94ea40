"""Tenant admission control and worker-seconds budget metering.

A *tenant* is whoever is paying for tuning — a serving engine instance, a
CI pipeline, a user.  The daemon multiplexes all of them onto one worker
pool, so two things need policing:

* **admission** — caps on how many tenants the daemon tracks and how much
  work each may have queued/active at once, so one chatty tenant cannot
  monopolize the fleet's submit queue;
* **budgets** — each tenant may carry a worker-seconds allowance
  (``budget_s``).  Spend is metered from the fleet's own ledgers:
  every loop tick the daemon diffs each running job's ``EvalAccount``
  against the snapshot taken at dispatch (``snapshot()``/``diff()``) and
  charges the delta of ``busy`` — which *includes* abandoned/retried
  attempts, so a tenant whose jobs crash lanes still pays for the burned
  worker time.  An exhausted tenant's queued work is parked and new
  submits are rejected; running jobs are allowed to finish (their cost
  was admitted when they started).

Fairness is least-spent-first: when fleet slots free up, queued requests
are admitted from the tenant with the smallest metered spend, so a cold
tenant's burst cannot starve everyone else (gain-priority inside the
fleet then orders the admitted jobs' individual trials).

Store hits bill nothing — answering from the corpus costs zero
worker-seconds, which is exactly the economics the service exists for.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.service.protocol import E_ADMISSION, E_BUDGET


class AdmissionError(Exception):
    """A submit the tenant policy refuses; ``code`` is the wire code."""

    def __init__(self, message: str, code: str = E_ADMISSION):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class TenantState:
    """Ledger for one tenant."""

    name: str
    budget_s: Optional[float] = None   # worker-seconds allowance (None: ∞)
    spent_s: float = 0.0               # metered from EvalAccount diffs
    queued: int = 0                    # requests waiting for a fleet slot
    active: int = 0                    # requests running in the fleet
    submitted: int = 0                 # lifetime accepted submits
    store_hits: int = 0                # answered with zero trials
    rejected: int = 0                  # refused submits (any reason)
    parked: int = 0                    # queued work parked on exhaustion

    @property
    def exhausted(self) -> bool:
        return self.budget_s is not None and self.spent_s >= self.budget_s

    @property
    def remaining_s(self) -> Optional[float]:
        if self.budget_s is None:
            return None
        return max(0.0, self.budget_s - self.spent_s)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "budget_s": self.budget_s,
            "spent_s": round(self.spent_s, 6),
            "remaining_s": (None if self.remaining_s is None
                            else round(self.remaining_s, 6)),
            "exhausted": self.exhausted,
            "queued": self.queued, "active": self.active,
            "submitted": self.submitted, "store_hits": self.store_hits,
            "rejected": self.rejected, "parked": self.parked,
        }


class TenantManager:
    """Admission + budget policy for the daemon's tenant population."""

    def __init__(self, max_tenants: int = 64,
                 max_active_per_tenant: int = 4,
                 max_queued_per_tenant: int = 16,
                 default_budget_s: Optional[float] = None):
        self.max_tenants = max_tenants
        self.max_active_per_tenant = max_active_per_tenant
        self.max_queued_per_tenant = max_queued_per_tenant
        self.default_budget_s = default_budget_s
        self._tenants: Dict[str, TenantState] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def get(self, name: str) -> Optional[TenantState]:
        return self._tenants.get(name)

    def admit(self, name: str,
              budget_s: Optional[float] = None) -> TenantState:
        """Get-or-create the tenant; raise ``AdmissionError`` when full.

        ``budget_s`` declares (or re-declares) the tenant's allowance —
        a tenant may top itself up mid-flight; ``None`` leaves whatever
        is already configured (or the daemon default for new tenants).
        """
        ts = self._tenants.get(name)
        if ts is None:
            if len(self._tenants) >= self.max_tenants:
                raise AdmissionError(
                    f"tenant table full ({self.max_tenants}); "
                    f"refusing new tenant {name!r}")
            ts = TenantState(name=name, budget_s=self.default_budget_s)
            self._tenants[name] = ts
        if budget_s is not None:
            ts.budget_s = float(budget_s)
        return ts

    def check_submit(self, ts: TenantState) -> None:
        """Police one more submit for an admitted tenant."""
        if ts.exhausted:
            ts.rejected += 1
            raise AdmissionError(
                f"tenant {ts.name!r} exhausted its worker-seconds budget "
                f"({ts.spent_s:.3f}s of {ts.budget_s:.3f}s)",
                code=E_BUDGET)
        if ts.queued >= self.max_queued_per_tenant:
            ts.rejected += 1
            raise AdmissionError(
                f"tenant {ts.name!r} has {ts.queued} queued requests "
                f"(limit {self.max_queued_per_tenant})")

    def can_start(self, ts: TenantState) -> bool:
        """May a queued request of this tenant enter the fleet now?"""
        return (not ts.exhausted
                and ts.active < self.max_active_per_tenant)

    def charge(self, ts: TenantState, worker_seconds: float) -> None:
        if worker_seconds > 0:
            ts.spent_s += worker_seconds

    def fairness_order(self, names: List[str]) -> List[str]:
        """Least-spent-first admission order (stable for ties)."""
        return sorted(names,
                      key=lambda n: (self._tenants[n].spent_s
                                     if n in self._tenants else 0.0))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {name: ts.to_dict()
                for name, ts in sorted(self._tenants.items())}
