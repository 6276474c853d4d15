"""Retry with exponential backoff and deterministic jitter.

The one retry implementation of the port, for anything a caller wraps:
the WRDS queries (``data.wrds_pull``) and the task graph's retried
actions (``taskgraph.engine``). Policy decisions live in a frozen
:class:`RetryPolicy`; the loop lives in :func:`call_with_retry`. Each
attempt is a ``retry:<label>`` span, each failed attempt a
``retry.attempt`` event and a count in ``fmrp_retry_attempts_total``, each
backoff a ``retry.backoff`` event, and a spent budget a count in
``fmrp_retry_exhausted_total``.

Determinism: jitter comes from a sha256 of ``(seed, label, attempt)`` —
not the global RNG, not the clock — so two runs of the same policy produce
the same delay schedule and a chaos test can assert exact behavior. The
``sleep`` callable is injectable so tests pay zero wall-clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Tuple, Type

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.resilience.errors import RetryExhaustedError

__all__ = ["RetryPolicy", "call_with_retry", "retrying"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How to retry: attempt budget, backoff curve, exception allowlist.

    max_attempts : total tries (1 = no retry).
    backoff_s    : delay before the FIRST retry; grows by ``multiplier``
                   each further retry, capped at ``max_backoff_s``.
    jitter       : ± fraction applied to each delay, deterministically
                   derived from ``(seed, label, attempt)`` — spreads
                   concurrent retriers without wall-clock randomness.
    retry_on     : exception types worth retrying; anything else
                   propagates immediately (a shape error will not fix
                   itself on attempt 3).
    """

    max_attempts: int = 3
    backoff_s: float = 0.1
    multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.1
    retry_on: Tuple[Type[BaseException], ...] = (OSError, ConnectionError, TimeoutError)
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def delay_s(self, attempt: int, label: str = "") -> float:
        """Delay before retry number ``attempt`` (1-based). Pure function
        of (policy, label, attempt)."""
        base = min(
            self.backoff_s * self.multiplier ** (attempt - 1),
            self.max_backoff_s,
        )
        if not self.jitter or not base:
            return base
        digest = hashlib.sha256(
            f"{self.seed}|{label}|{attempt}".encode()
        ).digest()
        frac = int.from_bytes(digest[:8], "big") / 2**64  # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * frac - 1.0))


def call_with_retry(
    fn: Callable[[], object],
    policy: Optional[RetryPolicy] = None,
    *,
    label: str = "",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Run ``fn`` under ``policy``; return its result.

    Retries only exceptions matching ``policy.retry_on``; others propagate
    untouched. When the attempt budget is spent, raises
    :class:`RetryExhaustedError` with the last error as ``__cause__``.
    ``on_retry(attempt, err)`` fires before each backoff sleep (logging,
    counters); ``sleep`` is injectable for zero-wall-clock tests.
    """
    policy = policy or RetryPolicy()
    last_err: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            # each attempt is its own span (telemetry off: shared no-op),
            # so a trace shows attempt 3's wall next to attempts 1-2
            with telemetry.span(
                f"retry:{label}" if label else "retry",
                cat="retry", attempt=attempt,
            ):
                return fn()
        except policy.retry_on as err:
            last_err = err
            telemetry.registry().counter(
                "fmrp_retry_attempts_total",
                help="retryable attempt failures across every layer",
            ).inc()
            telemetry.event(
                "retry.attempt", cat="retry", label=label,
                attempt=attempt, error=repr(err)[:200],
            )
            if attempt == policy.max_attempts:
                break
            if on_retry is not None:
                on_retry(attempt, err)
            delay = policy.delay_s(attempt, label)
            telemetry.event(
                "retry.backoff", cat="retry", label=label,
                attempt=attempt, delay_s=round(delay, 6),
            )
            sleep(delay)
    telemetry.registry().counter(
        "fmrp_retry_exhausted_total",
        help="calls that failed after their full attempt budget",
    ).inc()
    telemetry.event(
        "retry.exhausted", cat="retry", label=label,
        attempts=policy.max_attempts,
    )
    raise RetryExhaustedError(
        f"{label or getattr(fn, '__name__', 'call')} failed "
        f"after {policy.max_attempts} attempts"
    ) from last_err


def retrying(policy: RetryPolicy, **kwargs):
    """Decorator form of :func:`call_with_retry` for fixed call sites."""

    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*a, **kw):
            return call_with_retry(
                lambda: fn(*a, **kw),
                policy,
                label=kwargs.get("label", fn.__name__),
                **{k: v for k, v in kwargs.items() if k != "label"},
            )

        return inner

    return wrap
