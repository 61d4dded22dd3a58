"""The plain reference: what each query of a mix should return.

Plain numpy over the frozen generators of ``tpch_gen.py``; it imports
nothing of the program and takes nothing the program made. Each query
template names its reference module here (``tpch_q1`` for
``reference/tpch_q1.py``), found by that name, so a later mix adds a query
by adding a module. A module gives:

- ``COLUMNS``: the lineitem and order lanes it reads (``tpch_gen.lineitem``);
- ``partial(rows, orders, params_list, sf, dt)``: over one block of
  orders, the partial answer of each parameter set of ``params_list``, in
  its order (a module shares the block's work between the sets);
- ``finish(parts, params, dt)``: the ``Answer`` of one parameter set from
  its blocks' partials, in block order.

``answers`` generates lineitem once, in blocks of orders on a few threads
(numpy's loops release the interpreter lock), and hands each block to every
module with the parameter sets asked of it. ``dt`` is the type the doubles
are held and summed in: float64 as the configuration states; the control
runs the same code in float32.
"""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import tpch_gen

DOUBLE_LANES = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


@dataclass
class Answer:
    """The rows a query must return, as the protocol carries them (dates
    as ISO text). ``key``: the columns that name a row; ``doubles``: the
    columns compared by their relative gap, the rest exactly; for a
    ``LIMIT`` query, ``candidates`` are the rows past the limit that a
    tie at the cut could bring in, and ``tie`` the double column whose
    near-equal values may swap places."""
    rows: List[list]
    key: Tuple[int, ...] = ()
    doubles: Tuple[int, ...] = ()
    candidates: List[list] = field(default_factory=list)
    tie: Optional[int] = None


def module(name: str):
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad reference name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def blocks(n_orders: int, block: int) -> List[Tuple[int, int]]:
    return [(lo, min(lo + block, n_orders))
            for lo in range(0, n_orders, block)]


def answers(sf: float, items: Sequence[Tuple[str, dict]],
            dt=np.float64, threads: int = 8,
            block: int = 1 << 18) -> List[Answer]:
    """The answer of every (reference name, parameters) pair at scale
    factor ``sf``."""
    asked: Dict[str, List[dict]] = {}
    for name, params in items:
        asked.setdefault(name, []).append(params)
    mods = {name: module(name) for name in asked}
    columns = sorted({c for m in mods.values() for c in m.COLUMNS})

    def work(bounds):
        rows, orders = tpch_gen.lineitem(bounds[0], bounds[1], sf, columns)
        for c in DOUBLE_LANES:
            if c in rows:
                rows[c] = rows[c].astype(dt)
        return {name: mods[name].partial(rows, orders, plist, sf, dt)
                for name, plist in asked.items()}

    n_orders = tpch_gen.table_rows("orders", sf)
    with ThreadPoolExecutor(max(1, threads)) as ex:
        parts = list(ex.map(work, blocks(n_orders, block)))
    at = {name: 0 for name in asked}
    out = []
    for name, params in items:
        i = at[name]
        at[name] += 1
        out.append(mods[name].finish([p[name][i] for p in parts], params,
                                     dt))
    return out


def group_sums(groups: np.ndarray, n: int, lanes: Sequence[np.ndarray],
               dt) -> np.ndarray:
    """[n, len(lanes)] sums of each lane by group id in [0, n), each a
    numpy pairwise sum in ``dt`` over the group's rows in their order."""
    order = np.argsort(groups, kind="stable")
    ordered_groups = groups[order]
    present, starts = np.unique(ordered_groups, return_index=True)
    ends = np.append(starts[1:], len(order))
    out = np.zeros((n, len(lanes)), dtype=dt)
    for j, lane in enumerate(lanes):
        ordered = lane[order]
        for g, a, b in zip(present, starts, ends):
            out[g, j] = np.sum(ordered[a:b], dtype=dt)
    return out
