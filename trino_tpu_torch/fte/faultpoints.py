"""Deterministic fault-point injection for chaos testing.

Counterpart of ``trino_tpu/fte/faultpoints.py`` (host only). Named
crash sites (``spool.pre_marker`` in the spool's commit protocol, and
the dispatch and worker sites that come with the worker slice) are
single calls to :func:`fault_point`, free when no schedule is armed.

A schedule maps a site name to an action: ``crash`` (``os._exit``, a
SIGKILL'd process), ``raise`` (:class:`FaultInjected`), ``delay`` (sleep
N seconds, then continue) or ``call`` (a test-installed callback, only
through :func:`install`). Schedules come from ``TRINO_TPU_FAULTPOINTS``
(comma-separated ``site=action[:seconds][@skip]`` entries, parsed on the
first :func:`fault_point` call) and from :func:`install`, which wins;
:func:`reset` clears both. Each armed site fires ``count`` times after
``skip`` ignored hits; the bookkeeping is lock-protected.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..obs.metrics import METRICS

FAULTPOINTS_FIRED = METRICS.counter(
    "trino_tpu_fault_points_fired_total",
    "Armed fault points that fired, by site and action.",
    ("site", "action"))

ENV_VAR = "TRINO_TPU_FAULTPOINTS"

_VALID_ACTIONS = ("crash", "raise", "delay", "call")


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action fault point (and by ``call``
    actions whose callback asks for a raise)."""

    def __init__(self, site: str):
        super().__init__(f"fault injected at {site}")
        self.site = site


@dataclass
class _Armed:
    action: str
    seconds: float = 0.0
    skip: int = 0
    count: int = 1
    callback: Optional[Callable[[str], object]] = None
    hits: int = 0
    fired: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)


_LOCK = threading.Lock()
_SCHEDULE: Dict[str, _Armed] = {}
_ENV_LOADED = False


def parse_schedule(spec: str) -> Dict[str, _Armed]:
    """Parse ``site=action[:seconds][@skip]`` comma-list into a
    schedule.  Raises ``ValueError`` on malformed entries so a typo'd
    env var fails loudly at arm time rather than silently never
    firing."""
    out: Dict[str, _Armed] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"fault point entry missing '=': {entry!r}")
        site, rhs = entry.split("=", 1)
        site = site.strip()
        skip = 0
        if "@" in rhs:
            rhs, skip_s = rhs.rsplit("@", 1)
            skip = int(skip_s)
        seconds = 0.0
        if ":" in rhs:
            rhs, sec_s = rhs.split(":", 1)
            seconds = float(sec_s)
        action = rhs.strip()
        if action not in _VALID_ACTIONS or action == "call":
            raise ValueError(
                f"fault point action must be one of crash/raise/delay: "
                f"{entry!r}")
        if not site:
            raise ValueError(f"fault point entry missing site: {entry!r}")
        out[site] = _Armed(action=action, seconds=seconds, skip=skip)
    return out


def _load_env_locked() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return
    for site, armed in parse_schedule(spec).items():
        # Programmatic installs win over the env schedule.
        _SCHEDULE.setdefault(site, armed)


def install(site: str, action: str = "raise", *, seconds: float = 0.0,
            skip: int = 0, count: int = 1,
            callback: Optional[Callable[[str], object]] = None) -> None:
    """Arm ``site`` programmatically (tests).  ``callback`` implies
    action ``call``; it receives the site name and may raise, or
    return ``"raise"`` to have :class:`FaultInjected` raised for
    it after it returns."""
    if callback is not None:
        action = "call"
    if action not in _VALID_ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    with _LOCK:
        _SCHEDULE[site] = _Armed(action=action, seconds=seconds, skip=skip,
                                 count=count, callback=callback)


def reset() -> None:
    """Clear every armed site and forget the env schedule (it is
    re-read on the next :func:`fault_point` call)."""
    global _ENV_LOADED
    with _LOCK:
        _SCHEDULE.clear()
        _ENV_LOADED = False


def armed_sites() -> Dict[str, str]:
    """site -> action for everything currently armed (introspection /
    ``main.py`` startup logging)."""
    with _LOCK:
        _load_env_locked()
        return {site: a.action for site, a in _SCHEDULE.items()}


def fault_point(site: str) -> None:
    """Fire-through marker for a named fault site.  No-op unless the
    site is armed; see module docstring for actions."""
    with _LOCK:
        _load_env_locked()
        armed = _SCHEDULE.get(site)
    if armed is None:
        return
    with armed.lock:
        armed.hits += 1
        if armed.hits <= armed.skip or armed.fired >= armed.count:
            return
        armed.fired += 1
        action = armed.action
    FAULTPOINTS_FIRED.inc(site=site, action=action)
    if action == "delay":
        time.sleep(armed.seconds)
        return
    if action == "crash":
        # os._exit models SIGKILL: no atexit, no finally blocks, no
        # flushing — the process is simply gone.
        os._exit(137)
    if action == "call":
        cb = armed.callback
        want_raise = cb(site) if cb is not None else None
        if want_raise == "raise":
            raise FaultInjected(site)
        return
    raise FaultInjected(site)
