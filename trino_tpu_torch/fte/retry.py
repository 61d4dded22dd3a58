"""Task retry policy engine.

Counterpart of ``trino_tpu/fte/retry.py`` (host code).

Reference parity: execution/RetryPolicy.java (NONE | TASK | QUERY; we
carry NONE and TASK — QUERY-level restart is a degenerate TASK retry
when every fragment fails) plus the attempt bookkeeping of
EventDrivenFaultTolerantQueryScheduler: per-task and per-query attempt
budgets (task-retry-attempts-per-task / query-retry-attempts), and
exponential backoff with jitter between attempts
(retry-initial-delay/retry-max-delay).

Determinism: the jitter is seeded from the task token + attempt number,
so a re-run of the same query schedule produces the same delays, and the
replacement worker for attempt N is a pure function of (home worker,
attempt, excluded set, detector liveness) — no RNG in the scheduler.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Optional, Tuple

from ..obs.metrics import METRICS

RETRY_NONE = "NONE"
RETRY_TASK = "TASK"

# the headline FTE counter: one increment per re-dispatched attempt
# (speculative duplicates count separately — speculate.py)
TASK_RETRIES = METRICS.counter(
    "trino_tpu_task_retries_total",
    "Remote task attempts re-dispatched after a failure")

# the root stage has no worker to rotate to — it re-executes on the
# coordinator over the spooled fragment output (exec/remote.py
# _execute_combine)
COMBINE_RETRIES = METRICS.counter(
    "trino_tpu_combine_retries_total",
    "Coordinator combine (root) stage executions retried after a "
    "failure")


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable per-query retry configuration (session-derived)."""

    policy: str = RETRY_NONE
    task_retry_attempts: int = 4      # TOTAL attempts per task (incl. 1st)
    query_retry_attempts: int = 16    # extra attempts across the query
    backoff_initial_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_multiplier: float = 2.0

    @property
    def enabled(self) -> bool:
        return self.policy.upper() == RETRY_TASK

    @classmethod
    def from_session(cls, session) -> "RetryPolicy":
        return cls(
            policy=str(session.get("retry_policy")).upper(),
            task_retry_attempts=int(session.get("task_retry_attempts")),
            query_retry_attempts=int(
                session.get("query_retry_attempts")),
            backoff_initial_s=int(
                session.get("retry_initial_delay_ms")) / 1000.0,
            backoff_max_s=int(
                session.get("retry_max_delay_ms")) / 1000.0,
        )


def backoff_delay(policy: RetryPolicy, failures: int,
                  token: str) -> float:
    """Delay before the attempt following the ``failures``-th failure:
    exponential in the failure count, capped at ``backoff_max_s``, with
    deterministic jitter in [0.5x, 1x) seeded by (token, failures) so
    concurrent retries of different tasks de-correlate without RNG."""
    exp = max(failures - 1, 0)
    base = min(policy.backoff_initial_s
               * policy.backoff_multiplier ** exp,
               policy.backoff_max_s)
    h = int.from_bytes(
        hashlib.blake2b(f"{token}:{failures}".encode(),
                        digest_size=8).digest(), "big")
    return base * (0.5 + (h % 4096) / 8192.0)


def pick_worker(n_workers: int, home: int, attempt: int,
                excluded: FrozenSet[int] = frozenset(),
                is_alive: Optional[Callable[[int], bool]] = None) -> int:
    """Deterministic worker slot for one attempt: rotate from the
    task's home worker by the attempt number (attempt 0 = home), then
    prefer candidates that are neither in the observed-failure
    ``excluded`` set nor reported dead by the failure detector.
    Degrades in order (excluded-but-alive, then anything) so the
    scheduler always has a slot — a wrong guess costs one attempt, an
    empty candidate set would wedge the query."""
    order = [(home + attempt + i) % n_workers for i in range(n_workers)]
    for wi in order:
        if wi not in excluded and (is_alive is None or is_alive(wi)):
            return wi
    if is_alive is not None:
        # excluded-but-alive beats known-dead: one failed task this
        # query is weaker evidence than heartbeats failing right now
        for wi in order:
            if is_alive(wi):
                return wi
    for wi in order:
        if wi not in excluded:
            return wi
    return order[0]


class RetryController:
    """Per-query attempt ledger enforcing both budgets (thread-safe:
    every task's dispatch thread and the speculation monitor share
    it)."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._task_attempts: Dict[Tuple[int, int], int] = {}
        self._query_retries = 0

    def record_failure(self, task_key: Tuple[int, int]) -> bool:
        """Count one failed attempt of ``task_key``; True grants a
        retry (within both budgets), False means the task — and with it
        the query — is out of attempts."""
        with self._lock:
            n = self._task_attempts.get(task_key, 0) + 1
            self._task_attempts[task_key] = n
            if not self.policy.enabled:
                return False
            if n >= self.policy.task_retry_attempts:
                return False
            if self._query_retries >= self.policy.query_retry_attempts:
                return False
            self._query_retries += 1
            return True

    def grant_speculation(self, task_key: Tuple[int, int]) -> bool:
        """A speculative duplicate consumes query budget (it is a real
        extra attempt) but not the task's failure budget. Deliberately
        NOT gated on ``policy.enabled``: speculation is orthogonal to
        failure retries (first-completion-wins needs no retry
        semantics), so ``speculation_enabled`` works under
        retry_policy=NONE too."""
        with self._lock:
            if self._query_retries >= self.policy.query_retry_attempts:
                return False
            self._query_retries += 1
            return True

    def failures(self, task_key: Tuple[int, int]) -> int:
        with self._lock:
            return self._task_attempts.get(task_key, 0)

    @property
    def retries_granted(self) -> int:
        with self._lock:
            return self._query_retries
