"""TupleDomain predicate/domain model + DomainTranslator.

Reference parity: core/trino-spi/.../predicate/ (TupleDomain.java,
Domain.java, ValueSet / SortedRangeSet / EquatableValueSet, Range) and
sql/planner/DomainTranslator.java. This is the currency of predicate
pushdown: the optimizer turns filter conjuncts into a TupleDomain over
connector columns, offers it to the connector (applyFilter —
spi ConnectorMetadata.applyFilter), and connectors prune rows/splits.

TPU-first note: a Domain compiles to a vectorized numpy/jnp mask
(``mask_for``) so connectors prune whole column lanes at generation
time — no per-row interpretation."""

from __future__ import annotations

from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .rex import Call, Const, InputRef, RowExpr, split_conjuncts
from .types import Type


@dataclass(frozen=True)
class Range:
    """One interval of an orderable type (spi/predicate/Range.java).
    ``low``/``high`` of None mean unbounded. For a point value use
    low == high with both bounds inclusive."""
    low: Optional[object] = None
    low_inclusive: bool = False
    high: Optional[object] = None
    high_inclusive: bool = False

    def is_point(self) -> bool:
        return (self.low is not None and self.low == self.high
                and self.low_inclusive and self.high_inclusive)

    def overlaps_or_adjacent(self, other: "Range") -> bool:
        a, b = (self, other) if _le_low(self, other) else (other, self)
        if a.high is None or b.low is None:
            return True
        if a.high > b.low:
            return True
        if a.high == b.low:
            return a.high_inclusive or b.low_inclusive
        return False

    def merge(self, other: "Range") -> "Range":
        lo, li = _min_low(self, other)
        hi, hc = _max_high(self, other)
        return Range(lo, li, hi, hc)

    def intersect(self, other: "Range") -> Optional["Range"]:
        lo, li = _max_low(self, other)
        hi, hc = _min_high(self, other)
        if lo is not None and hi is not None:
            if lo > hi or (lo == hi and not (li and hc)):
                return None
        return Range(lo, li, hi, hc)


def _le_low(a: Range, b: Range) -> bool:
    if a.low is None:
        return True
    if b.low is None:
        return False
    if a.low != b.low:
        return a.low < b.low
    return a.low_inclusive >= b.low_inclusive


def _min_low(a: Range, b: Range):
    if a.low is None or b.low is None:
        return None, False
    if a.low < b.low:
        return a.low, a.low_inclusive
    if b.low < a.low:
        return b.low, b.low_inclusive
    return a.low, a.low_inclusive or b.low_inclusive


def _max_low(a: Range, b: Range):
    if a.low is None:
        return b.low, b.low_inclusive
    if b.low is None:
        return a.low, a.low_inclusive
    if a.low > b.low:
        return a.low, a.low_inclusive
    if b.low > a.low:
        return b.low, b.low_inclusive
    return a.low, a.low_inclusive and b.low_inclusive


def _max_high(a: Range, b: Range):
    if a.high is None or b.high is None:
        return None, False
    if a.high > b.high:
        return a.high, a.high_inclusive
    if b.high > a.high:
        return b.high, b.high_inclusive
    return a.high, a.high_inclusive or b.high_inclusive


def _min_high(a: Range, b: Range):
    if a.high is None:
        return b.high, b.high_inclusive
    if b.high is None:
        return a.high, a.high_inclusive
    if a.high < b.high:
        return a.high, a.high_inclusive
    if b.high < a.high:
        return b.high, b.high_inclusive
    return a.high, a.high_inclusive and b.high_inclusive


@dataclass(frozen=True)
class Domain:
    """Allowed values of one column (spi/predicate/Domain.java):
    a union of disjoint sorted ranges + whether NULL is allowed.
    ``is_all`` short-circuits the unconstrained domain."""
    type: Type
    ranges: Tuple[Range, ...] = ()
    null_allowed: bool = False
    is_all: bool = False

    # --- constructors ----------------------------------------------------
    @staticmethod
    def all(t: Type) -> "Domain":
        return Domain(t, (), True, True)

    @staticmethod
    def none(t: Type) -> "Domain":
        return Domain(t, (), False)

    @staticmethod
    def only_null(t: Type) -> "Domain":
        return Domain(t, (), True)

    @staticmethod
    def not_null(t: Type) -> "Domain":
        return Domain(t, (Range(),), False)

    @staticmethod
    def single(t: Type, value) -> "Domain":
        return Domain(t, (Range(value, True, value, True),), False)

    @staticmethod
    def in_values(t: Type, values: Sequence) -> "Domain":
        rs = tuple(Range(v, True, v, True)
                   for v in sorted(set(values)))
        return Domain(t, rs, False)

    @staticmethod
    def range(t: Type, low, low_inclusive, high,
              high_inclusive) -> "Domain":
        return Domain(t, (Range(low, low_inclusive, high,
                                high_inclusive),), False)

    # --- algebra ---------------------------------------------------------
    def is_none(self) -> bool:
        return not self.is_all and not self.ranges \
            and not self.null_allowed

    def intersect(self, other: "Domain") -> "Domain":
        if self.is_all:
            return other
        if other.is_all:
            return self
        out: List[Range] = []
        for a in self.ranges:
            for b in other.ranges:
                r = a.intersect(b)
                if r is not None:
                    out.append(r)
        return Domain(self.type, _normalize(out),
                      self.null_allowed and other.null_allowed)

    def union(self, other: "Domain") -> "Domain":
        if self.is_all or other.is_all:
            return Domain.all(self.type)
        return Domain(self.type,
                      _normalize(list(self.ranges) + list(other.ranges)),
                      self.null_allowed or other.null_allowed)

    def single_values(self) -> Optional[List[object]]:
        """All-point domain -> its values (connector IN pruning)."""
        if self.is_all or not all(r.is_point() for r in self.ranges):
            return None
        return [r.low for r in self.ranges]

    # --- vectorized evaluation ------------------------------------------
    def mask_for(self, data: np.ndarray,
                 valid: Optional[np.ndarray] = None,
                 decode=None) -> np.ndarray:
        """Boolean keep-mask over a column lane. ``decode`` maps lane
        values to domain-comparable values (dictionary codes ->
        strings); given as an array it is applied by gather."""
        if self.is_all:
            return np.ones(len(data), bool)
        vals = data
        if decode is not None:
            vals = decode(data)
        m = np.zeros(len(data), bool)
        for r in self.ranges:
            rm = np.ones(len(data), bool)
            if r.low is not None:
                rm &= (vals >= r.low) if r.low_inclusive \
                    else (vals > r.low)
            if r.high is not None:
                rm &= (vals <= r.high) if r.high_inclusive \
                    else (vals < r.high)
            m |= rm
        if valid is not None:
            m = np.where(valid, m, self.null_allowed)
        return m


def _normalize(ranges: List[Range]) -> Tuple[Range, ...]:
    """Sort + merge overlapping/adjacent ranges (SortedRangeSet)."""
    if not ranges:
        return ()
    rs = sorted(ranges, key=lambda r: (
        r.low is not None, r.low if r.low is not None else 0,
        not r.low_inclusive))
    out = [rs[0]]
    for r in rs[1:]:
        if out[-1].overlaps_or_adjacent(r):
            out[-1] = out[-1].merge(r)
        else:
            out.append(r)
    return tuple(out)


@dataclass(frozen=True)
class TupleDomain:
    """Conjunction of per-column Domains (spi/predicate/
    TupleDomain.java); ``is_none`` marks a contradiction (scan prunes to
    zero rows)."""
    domains: Tuple[Tuple[str, Domain], ...] = ()
    is_none: bool = False

    @staticmethod
    def all() -> "TupleDomain":
        return TupleDomain(())

    @staticmethod
    def none() -> "TupleDomain":
        return TupleDomain((), True)

    @staticmethod
    def of(domains: Dict[str, Domain]) -> "TupleDomain":
        for d in domains.values():
            if d.is_none():
                return TupleDomain.none()
        return TupleDomain(tuple(sorted(
            (k, v) for k, v in domains.items() if not v.is_all)))

    def as_dict(self) -> Dict[str, Domain]:
        return dict(self.domains)

    def is_all(self) -> bool:
        return not self.is_none and not self.domains

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        if self.is_none or other.is_none:
            return TupleDomain.none()
        out = self.as_dict()
        for col, dom in other.domains:
            out[col] = out[col].intersect(dom) if col in out else dom
        return TupleDomain.of(out)

    def domain(self, col: str) -> Optional[Domain]:
        return self.as_dict().get(col)

    def __str__(self):
        if self.is_none:
            return "NONE"
        if not self.domains:
            return "ALL"
        parts = []
        for col, d in self.domains:
            sv = d.single_values()
            if sv is not None and len(sv) <= 3:
                parts.append(f"{col} IN {sv}")
            else:
                parts.append(f"{col}:{len(d.ranges)} ranges")
        return ", ".join(parts)


def filter_batch_host(batch, constraint: Optional["TupleDomain"],
                      limit: Optional[int] = None):
    """Apply an accepted pushdown to a connector batch host-side:
    vectorized domain masks + row compaction (+ per-split limit). The
    enforcement half of applyFilter — connectors call this from
    read_split."""
    from .columnar import Batch, pad_batch
    from .config import capacity_for
    if constraint is not None and constraint.is_none:
        return Batch(batch.columns, 0)
    n = batch.num_rows_host()
    if constraint is None or constraint.is_all():
        if limit is not None and n > limit:
            return Batch(batch.columns, limit)
        return batch
    mask = np.ones(n, bool)
    for col, dom in constraint.domains:
        if col not in batch.columns:
            continue
        c = batch.columns[col]
        data = c.data[:n].cpu().numpy()
        valid = None if c.valid is None else c.valid[:n].cpu().numpy()
        decode = None
        if c.dictionary is not None:
            vals = c.dictionary.values.astype(str)
            decode = (lambda codes, vals=vals:
                      vals[np.clip(codes.astype(np.int64), 0,
                                   len(vals) - 1)])
        mask &= dom.mask_for(data, valid, decode)
    idx = np.nonzero(mask)[0]
    if limit is not None:
        idx = idx[:limit]
    import torch
    rows = torch.from_numpy(idx.astype(np.int64)).to(batch.device)
    cols = {k: c.gather(rows) for k, c in batch.columns.items()}
    out = Batch(cols, len(idx))
    return pad_batch(out, capacity_for(max(len(idx), 1), minimum=8))


# --------------------------------------------------------------------------
# DomainTranslator: rex conjuncts -> TupleDomain
# --------------------------------------------------------------------------

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _comparable_const(e: RowExpr):
    if isinstance(e, Const) and e.value is not None \
            and not isinstance(e.value, bool):
        return e.value
    return None


def extract_tuple_domain(predicate: Optional[RowExpr],
                         symbol_types: Dict[str, Type]):
    """Split a predicate into (TupleDomain over symbols, residual
    conjuncts that could not be translated) —
    sql/planner/DomainTranslator.fromPredicate."""
    domains: Dict[str, Domain] = {}
    residual: List[RowExpr] = []
    for conj in split_conjuncts(predicate):
        got = _translate_conjunct(conj, symbol_types)
        if got is None:
            residual.append(conj)
        else:
            sym, dom = got
            domains[sym] = domains[sym].intersect(dom) \
                if sym in domains else dom
    return TupleDomain.of(domains), residual


def _translate_conjunct(e: RowExpr, types: Dict[str, Type]):
    if not isinstance(e, Call):
        return None
    if e.fn in ("=", "<", "<=", ">", ">=") and len(e.args) == 2:
        a, b = e.args
        op = e.fn
        if isinstance(b, InputRef) and not isinstance(a, InputRef):
            a, b = b, a
            op = _FLIP.get(op, op)
        if not (isinstance(a, InputRef) and a.name in types):
            return None
        v = _comparable_const(b)
        if v is None:
            return None
        t = types[a.name]
        if op == "=":
            return a.name, Domain.single(t, v)
        if op == "<":
            return a.name, Domain.range(t, None, False, v, False)
        if op == "<=":
            return a.name, Domain.range(t, None, False, v, True)
        if op == ">":
            return a.name, Domain.range(t, v, False, None, False)
        return a.name, Domain.range(t, v, True, None, False)
    if e.fn == "is_null" and len(e.args) == 1 \
            and isinstance(e.args[0], InputRef) \
            and e.args[0].name in types:
        return e.args[0].name, Domain.only_null(types[e.args[0].name])
    if e.fn == "not" and len(e.args) == 1 \
            and isinstance(e.args[0], Call) \
            and e.args[0].fn == "is_null" \
            and isinstance(e.args[0].args[0], InputRef) \
            and e.args[0].args[0].name in types:
        name = e.args[0].args[0].name
        return name, Domain.not_null(types[name])
    if e.fn == "or":
        # OR of same-column translatable conjuncts -> domain union
        sides = []
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, Call) and x.fn == "or":
                stack.extend(x.args)
            else:
                sides.append(x)
        got = [_translate_conjunct(s, types) for s in sides]
        if any(g is None for g in got):
            return None
        syms = {g[0] for g in got}
        if len(syms) != 1:
            return None
        sym = syms.pop()
        dom = got[0][1]
        for _, d in got[1:]:
            dom = dom.union(d)
        return sym, dom
    if e.fn == "in_list" and e.args \
            and isinstance(e.args[0], InputRef) \
            and e.args[0].name in types:
        vals = [_comparable_const(a) for a in e.args[1:]]
        if any(v is None for v in vals):
            return None
        return e.args[0].name, Domain.in_values(
            types[e.args[0].name], vals)
    return None
