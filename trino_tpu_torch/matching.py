"""Pattern-matching rule engine — lib/trino-matching.

Reference parity: io.trino.matching's Pattern/Captures/Match, the
machinery under every iterative-optimizer rule
(sql/planner/iterative/Rule.java declares `Pattern pattern()`;
IterativeOptimizer matches it before invoking apply). The optimizer
here is whole-tree rewrites, so this engine serves the same role at
the call sites that benefit from declarative shape tests
(planner/optimizer.py's partial-TopN and partial-limit rules declare
their trigger shapes with it; the union half of those rules stays
imperative because the projection-chain walk has no pattern form).

Usage:
    CAP = Capture("union")
    P = (Pattern.type_of(TopNNode)
         .with_prop("step", "SINGLE")
         .with_source(Pattern.type_of(UnionNode).capture_as(CAP)))
    m = P.match(node)
    if m:
        union = m[CAP]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Capture:
    """A named slot filled by ``capture_as`` during a match
    (matching/Capture.java)."""

    def __init__(self, name: str = ""):
        self.name = name

    def __repr__(self):
        return f"Capture({self.name})"


class Match:
    """A successful match: truthy, indexable by Capture
    (matching/Match.java + Captures)."""

    def __init__(self, captures: Dict[Capture, Any]):
        self._captures = captures

    def __bool__(self):
        return True

    def __getitem__(self, cap: Capture):
        return self._captures[cap]


class Pattern:
    """Composable structural pattern (matching/Pattern.java):
    type check + property predicates + per-source sub-patterns +
    captures."""

    def __init__(self, cls: Optional[type] = None):
        self._cls = cls
        self._checks: list = []      # (name, predicate)
        self._sources: Dict[str, "Pattern"] = {}
        self._capture: Optional[Capture] = None

    # -- constructors (each returns a copied pattern: patterns are shared
    # module-level constants, like the reference's) --------------------
    @staticmethod
    def type_of(cls: type) -> "Pattern":
        return Pattern(cls)

    @staticmethod
    def any() -> "Pattern":
        return Pattern(None)

    def _copy(self) -> "Pattern":
        p = Pattern(self._cls)
        p._checks = list(self._checks)
        p._sources = dict(self._sources)
        p._capture = self._capture
        return p

    def with_prop(self, name: str, value) -> "Pattern":
        p = self._copy()
        p._checks.append((name, lambda v, want=value: v == want))
        return p

    def matching(self, name: str,
                 predicate: Callable[[Any], bool]) -> "Pattern":
        p = self._copy()
        p._checks.append((name, predicate))
        return p

    def with_source(self, sub: "Pattern",
                    attr: str = "source") -> "Pattern":
        p = self._copy()
        p._sources[attr] = sub
        return p

    def capture_as(self, cap: Capture) -> "Pattern":
        p = self._copy()
        p._capture = cap
        return p

    # -- matching ------------------------------------------------------
    def match(self, node) -> Optional[Match]:
        caps: Dict[Capture, Any] = {}
        return Match(caps) if self._match_into(node, caps) else None

    def _match_into(self, node, caps: Dict[Capture, Any]) -> bool:
        if self._cls is not None and not isinstance(node, self._cls):
            return False
        for name, pred in self._checks:
            # strict getattr: a typo'd property must raise, not make
            # the pattern silently never match (a disabled optimizer
            # rule with no failing test is the worst outcome)
            if not pred(getattr(node, name)):
                return False
        for attr, sub in self._sources.items():
            child = getattr(node, attr, None)
            if child is None or not sub._match_into(child, caps):
                return False
        if self._capture is not None:
            caps[self._capture] = node
        return True
