"""Structured serving errors — a copy of ``dgraph_tpu/serve/errors.py``.

Every rejection path in the serving stack raises a typed :class:`ServeError`
whose :meth:`~ServeError.record` form is a JSONL-able dict — the same
"structured record over free-text stderr" discipline. Callers (and load generators)
branch on ``.code``, logs get one parseable line per rejection, and nothing
ever queues unboundedly just because raising felt impolite.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base serving error; ``record()`` is the structured JSONL form."""

    code = "error"

    def __init__(self, message: str, **context):
        super().__init__(message)
        self.context = context

    def record(self) -> dict:
        return {
            "kind": "serve_error",
            "error": self.code,
            "detail": str(self),
            **self.context,
        }


class RequestTooLarge(ServeError):
    """Request exceeds the largest shape bucket. Admitting it would run a
    shape no warmup ever ran (the one thing the bucket ladder exists to
    prevent), so it is rejected at submit time; the client should
    split the request or the operator should raise ``max_bucket``."""

    code = "too_large"


class QueueFull(ServeError):
    """Backpressure: the bounded request queue is at capacity. Rejected
    immediately so the client can retry/shed load — queue depth, not queue
    growth, is the knob (an unbounded queue converts overload into
    unbounded latency for everyone)."""

    code = "backpressure"


class RequestTimeout(ServeError):
    """The request aged past its deadline while waiting in the queue; it is
    rejected without running (serving stale work wastes a batch slot the
    client has already given up on)."""

    code = "timeout"


class EngineStopped(ServeError):
    """The batcher/engine was shut down while the request was in flight."""

    code = "stopped"


class QuotaExceeded(ServeError):
    """Per-tenant admission control said no: the tenant's token bucket is
    empty (rate quota) or its share of the bounded queue is full (space
    quota). Rejected at submit so ONE tenant's flood degrades only that
    tenant — every other tenant's requests keep flowing through the same
    batcher."""

    code = "quota"


class TenantDegraded(ServeError):
    """This tenant is shed because its own recent requests kept failing
    (poisoned payloads, systematic bad ids): the per-tenant analog of the
    engine's global degraded mode. Other tenants are unaffected; the
    operator re-admits with ``TenantTable.reset(tenant)``."""

    code = "tenant_degraded"


class SwapRejected(ServeError):
    """A checkpoint hot-swap (``ServeEngine.swap_params``) was refused or rolled back — structural mismatch with the
    warmed executables, non-finite parameters, served!=eval parity failure,
    or a fault mid-validation. The PRIOR params remain installed (the swap
    validates against the staged tree and only flips the live pointer after
    every oracle passes), so serving continues uninterrupted on the old
    checkpoint."""

    code = "swap_rejected"


class WorkerCrashed(ServeError):
    """The micro-batcher's worker thread died on an unexpected exception
    (engine bug, metrics callback, collector fault). Every pending and
    in-flight request fails fast with this error and the batcher marks
    itself stopped — the alternative (a silently dead worker) left every
    queued future hanging until its client timeout."""

    code = "worker_crashed"
