"""Per-tenant admission plane: priority classes, token-bucket rate
limits, and cumulative token budgets, with TYPED reject reasons.

The plane is pure host-side Python (no jax, no zmq) so it can live
inside the gserver manager's scheduling path, inside an in-process
gateway backend (bench/dryrun), and inside unit tests unchanged.  Every
time-dependent method takes an explicit ``now`` so the refill math is
deterministic under test; production callers pass ``time.monotonic()``.

Reject taxonomy (stable, wire-visible — the gateway maps them onto
HTTP statuses and the manager stamps them into the labeled
``areal_gateway_admission_rejects_total{reason}`` counter):

* ``rate_limited``   — the tenant's token bucket cannot cover the
  request right now; retryable, carries ``retry_after_s`` (HTTP 429 +
  ``Retry-After``).
* ``budget_exhausted`` — the tenant's cumulative token budget is spent;
  TERMINAL until an operator calls :meth:`AdmissionPlane.reset_budget`
  (HTTP 403, no Retry-After).
* ``request_too_large`` — a single request larger than the bucket can
  EVER hold; retrying cannot help (HTTP 403).

An unknown tenant falls back to ``default_policy`` (permissive
interactive by default) instead of rejecting — the plane throttles the
tenants an operator chose to constrain, it is not an auth layer.

The port's copy of ``areal_tpu/gateway/admission.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

#: priority classes the engine's preemption understands: interactive
#: rows survive pool pressure at bulk rows' expense
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BULK = "bulk"

REJECT_RATE_LIMITED = "rate_limited"
REJECT_BUDGET_EXHAUSTED = "budget_exhausted"
REJECT_REQUEST_TOO_LARGE = "request_too_large"

#: reason -> HTTP status the gateway surfaces (structured body, never a
#: generic 500); 429s carry Retry-After
REJECT_HTTP_STATUS = {
    REJECT_RATE_LIMITED: 429,
    REJECT_BUDGET_EXHAUSTED: 403,
    REJECT_REQUEST_TOO_LARGE: 403,
}

#: the tenant rollout traffic is accounted under when it carries no
#: explicit tenant of its own (partial_rollout stamps it)
DEFAULT_BULK_TENANT = "rollout"


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's admission contract (config-layer object: plain
    fields only, carried in ``GserverManagerConfig.tenants``)."""

    name: str
    #: "interactive" rows outlive "bulk" rows under pool pressure
    priority: str = PRIORITY_BULK
    #: sustained token throughput; 0 = unlimited (no bucket)
    rate_tokens_per_s: float = 0.0
    #: bucket capacity (burst allowance); defaults to one second of
    #: sustained rate when left 0 with a rate set
    burst_tokens: float = 0.0
    #: cumulative token cap, terminal until reset; 0 = unlimited
    token_budget: float = 0.0


class TokenBucket:
    """Classic token bucket with explicit-clock refill.

    ``take(tokens, now)`` refills ``rate * dt``, capped at ``burst``,
    then either debits and admits or rejects with the exact wait until
    the deficit refills (the 429's Retry-After)."""

    def __init__(self, rate_tokens_per_s: float, burst_tokens: float = 0.0):
        assert rate_tokens_per_s > 0, "rate must be positive (0 = no bucket)"
        self.rate = float(rate_tokens_per_s)
        self.burst = float(burst_tokens) if burst_tokens > 0 else self.rate
        self.tokens = self.burst  # starts full: burst allowance up front
        self._last = None  # type: Optional[float]

    def _refill(self, now: float):
        if self._last is not None and now > self._last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate
            )
        self._last = now

    def peek(self, now: float) -> float:
        """Current token level at ``now`` (refilled, nothing taken)."""
        self._refill(now)
        return self.tokens

    def take(self, tokens: float, now: float) -> Tuple[bool, float]:
        """(admitted, retry_after_s).  ``retry_after_s`` is 0 on admit
        and the exact refill wait on reject; ``float('inf')`` marks a
        request larger than the bucket can ever hold."""
        self._refill(now)
        if tokens > self.burst:
            return False, float("inf")
        if tokens <= self.tokens:
            self.tokens -= tokens
            return True, 0.0
        return False, (tokens - self.tokens) / self.rate


@dataclasses.dataclass
class AdmissionDecision:
    ok: bool
    tenant: str
    priority: str
    reason: str = ""
    retry_after_s: float = 0.0
    http_status: int = 200

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _TenantState:
    def __init__(self, policy: TenantPolicy):
        self.policy = policy
        self.bucket = (
            TokenBucket(policy.rate_tokens_per_s, policy.burst_tokens)
            if policy.rate_tokens_per_s > 0
            else None
        )
        self.spent_tokens = 0.0  # budget accounting (admit-time estimate)
        self.admitted_total = 0
        self.rejects: Dict[str, int] = {}


class AdmissionPlane:
    """All tenants' admission state behind one lock (the manager serves
    from one thread, but in-process gateway backends admit from HTTP
    handler threads)."""

    def __init__(
        self,
        policies: Iterable[TenantPolicy] = (),
        default_policy: Optional[TenantPolicy] = None,
    ):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {
            p.name: _TenantState(p) for p in policies
        }
        #: unknown tenants run under this (permissive interactive unless
        #: the operator configures otherwise)
        self.default_policy = default_policy or TenantPolicy(
            name="default", priority=PRIORITY_INTERACTIVE
        )

    @classmethod
    def from_config(cls, tenants) -> "AdmissionPlane":
        """Build from ``GserverManagerConfig.tenants`` rows — each row a
        ``TenantPolicy`` or a plain dict of its fields."""
        policies = []
        for t in tenants or ():
            policies.append(
                t if isinstance(t, TenantPolicy) else TenantPolicy(**dict(t))
            )
        return cls(policies)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            # unknown tenant -> default policy, materialized so repeat
            # requests share one bucket/budget line
            st = _TenantState(
                dataclasses.replace(self.default_policy, name=tenant)
            )
            self._tenants[tenant] = st
        return st

    def priority_of(self, tenant: str) -> str:
        with self._lock:
            return self._state(tenant).policy.priority

    def admit(self, tenant: str, tokens: float, now: float) -> AdmissionDecision:
        """One admission check, charging ``tokens`` (the request's
        estimated prompt + new-token footprint) against the tenant's
        bucket and budget on success."""
        with self._lock:
            st = self._state(tenant)
            pol = st.policy

            def reject(reason: str, retry_after: float = 0.0):
                st.rejects[reason] = st.rejects.get(reason, 0) + 1
                return AdmissionDecision(
                    ok=False,
                    tenant=tenant,
                    priority=pol.priority,
                    reason=reason,
                    retry_after_s=retry_after,
                    http_status=REJECT_HTTP_STATUS[reason],
                )

            if pol.token_budget > 0 and (
                st.spent_tokens + tokens > pol.token_budget
            ):
                return reject(REJECT_BUDGET_EXHAUSTED)
            if st.bucket is not None:
                ok, retry_after = st.bucket.take(tokens, now)
                if not ok:
                    if retry_after == float("inf"):
                        return reject(REJECT_REQUEST_TOO_LARGE)
                    return reject(REJECT_RATE_LIMITED, retry_after)
            st.spent_tokens += tokens
            st.admitted_total += 1
            return AdmissionDecision(
                ok=True, tenant=tenant, priority=pol.priority
            )

    def settle(self, tenant: str, reserved: float, used: float):
        """Refund the over-estimate once a request's ACTUAL token usage
        is known (budgets charge estimates at admit; finals true them
        up — never below zero, never above the reservation)."""
        with self._lock:
            st = self._state(tenant)
            refund = max(0.0, reserved - max(0.0, used))
            st.spent_tokens = max(0.0, st.spent_tokens - refund)

    def reset_budget(self, tenant: str):
        """Operator action: a budget-exhausted tenant becomes admissible
        again (budget exhaustion is terminal until THIS)."""
        with self._lock:
            self._state(tenant).spent_tokens = 0.0

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for name, st in self._tenants.items():
                out[name] = {
                    "priority": st.policy.priority,
                    "spent_tokens": st.spent_tokens,
                    "token_budget": st.policy.token_budget,
                    "admitted_total": st.admitted_total,
                    "rejects": dict(st.rejects),
                }
            return out
