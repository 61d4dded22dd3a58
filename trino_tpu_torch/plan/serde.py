"""Plan-fragment wire format: plan/rex/predicate dataclasses <-> JSON.

Counterpart of ``trino_tpu/plan/serde.py``, over this package's plan,
expression, predicate and catalog dataclasses; the plan sanity checker
(analysis/sanity.py) uses it to prove that a fragment round-trips.

Reference parity: the coordinator ships PlanFragments to workers as
JSON (server/remotetask/HttpRemoteTask.java:103 posting a
TaskUpdateRequest whose fragment is Jackson-serialized
sql/planner/PlanFragment.java). Here the engine's plan IR is frozen
dataclasses, so one generic tagged walker covers every node/expression/
domain class — no per-class codecs to drift out of sync.

Encoding:
  dataclass        -> {"$c": "ClassName", "f": {field: enc, ...}}
  Type             -> {"$t": "<type name>"}   (parse_type round-trip)
  dict             -> {"$m": {key: enc}}      (plan dicts are str-keyed)
  tuple            -> {"$u": [enc, ...]}
  Decimal          -> {"$dec": "..."}
  int/float/str/bool/None/list -> native JSON
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Dict

from ..types import Type, parse_type


def _registry() -> Dict[str, type]:
    from .. import catalog, predicate, rex
    from ..planner import logical
    from . import nodes
    # planner.logical contributes the plan nodes born inside the
    # planner (SemiJoinMultiNode) — without it a plan carrying one
    # encodes fine but cannot decode, which the sanity checker's serde
    # round-trip validator (analysis/sanity.py) treats as a broken
    # fragment
    reg: Dict[str, type] = {}
    for mod in (nodes, rex, predicate, catalog, logical):
        for name in dir(mod):
            cls = getattr(mod, name)
            if isinstance(cls, type) and dataclasses.is_dataclass(cls):
                reg[name] = cls
    return reg


_REG: Dict[str, type] = {}


def to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, Type):
        return {"$t": str(obj.name)}
    if isinstance(obj, Decimal):
        return {"$dec": str(obj)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"$c": type(obj).__name__,
                "f": {f.name: to_jsonable(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {"$m": {str(k): to_jsonable(v) for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"$u": [to_jsonable(v) for v in obj]}
    if isinstance(obj, list):
        return [to_jsonable(v) for v in obj]
    # numpy scalars from the planner's constant folding
    try:
        import numpy as np
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
    except ImportError:      # pragma: no cover
        pass
    raise TypeError(
        f"plan serde: unsupported value {type(obj).__name__}: {obj!r}")


def from_jsonable(obj: Any) -> Any:
    global _REG
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [from_jsonable(v) for v in obj]
    if "$t" in obj:
        return parse_type(obj["$t"])
    if "$dec" in obj:
        return Decimal(obj["$dec"])
    if "$m" in obj:
        return {k: from_jsonable(v) for k, v in obj["$m"].items()}
    if "$u" in obj:
        return tuple(from_jsonable(v) for v in obj["$u"])
    if "$c" in obj:
        if not _REG:
            _REG = _registry()
        cls = _REG.get(obj["$c"])
        if cls is None:
            raise TypeError(f"plan serde: unknown class {obj['$c']}")
        return cls(**{k: from_jsonable(v)
                      for k, v in obj["f"].items()})
    raise TypeError(f"plan serde: unrecognized object {obj!r}")
