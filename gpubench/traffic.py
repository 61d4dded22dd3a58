"""The one traffic generator: a mix file in, query streams out.

A mix (``traffic/<mix>.json``) names its query templates, each with its SQL
text, the reference that answers it, its share of the stream and its
substitution parameters, and how many client streams send it. From
``--seed`` this module draws, as TPC-H's qgen does (v3 cl. 2.1.3, 5.3.4),
each stream's order of templates and every query's substitution parameters
from the template's ranges. The same seed gives the same streams.

Parameters are dealt, not drawn with replacement: each template's whole
parameter space (every combination of its ranges) is shuffled once from
the seed into a deck, and the k-th query of that template that stream s
sends takes the deck's entry s + k * streams. So every parameter set is
sent once before any is sent again, every seed sends the same spread of
selectivities in another order, and how often a pushed constraint repeats
(a scan-cache hit) does not swing with the seed. Set-up takes its queries
from the deck's far end (``setup_params``).

Each stream sends its templates in rounds: a round holds every template
``share`` times, in an order the stream draws anew for each round.

Parameter kinds:

- ``int``: an integer in [lo, hi];
- ``choice``: one of ``values`` (text, substituted as written);
- ``date``: a day in [lo, hi] (ISO dates);
- ``month``: the first day of a month in [lo, hi] (``YYYY-MM``);
- ``distinct``: ``k`` different values of ``values``, in order,
  substituted under ``names``.
"""

from __future__ import annotations

import datetime
import itertools
import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

Params = Dict[str, object]


@dataclass
class Template:
    name: str
    sql: str
    reference: str
    share: int
    params: List[dict]
    # the whole parameter space, in the order the seed dealt it
    deck: List[Params] = field(default_factory=list)


@dataclass
class Mix:
    name: str
    streams: int
    templates: List[Template]
    seed: int

    def stream(self, s: int) -> Iterator[Tuple[int, Params]]:
        """The (template index, parameters) that stream ``s`` sends, in
        order, without end."""
        rng = random.Random(f"gpubench-stream-{self.seed}-{s}")
        sent = [0] * len(self.templates)
        round_items = [t for t, tpl in enumerate(self.templates)
                       for _ in range(tpl.share)]
        while True:
            order = list(round_items)
            rng.shuffle(order)
            for t in order:
                deck = self.templates[t].deck
                yield t, deck[(s + sent[t] * self.streams) % len(deck)]
                sent[t] += 1

    def first(self, s: int, n: int) -> List[Tuple[int, Params]]:
        """The first ``n`` queries of stream ``s``."""
        return list(itertools.islice(self.stream(s), n))

    def setup_params(self, t: int, j: int) -> Params:
        """The ``j``-th parameter set that set-up sends for template ``t``:
        from the deck's end, the last the window's streams reach."""
        deck = self.templates[t].deck
        return deck[len(deck) - 1 - (j % len(deck))]

    def sql(self, t: int, params: Params, tables: Dict[str, str]) -> str:
        return self.templates[t].sql.format(**tables, **params)


def params_key(params: Params) -> tuple:
    """A hashable name of a parameter set."""
    return tuple(sorted(params.items()))


def _values(spec: dict) -> list:
    kind = spec["kind"]
    if kind == "int":
        return list(range(int(spec["lo"]), int(spec["hi"]) + 1))
    if kind == "choice":
        return list(spec["values"])
    if kind == "date":
        lo = datetime.date.fromisoformat(spec["lo"])
        hi = datetime.date.fromisoformat(spec["hi"])
        return [(lo + datetime.timedelta(days=d)).isoformat()
                for d in range((hi - lo).days + 1)]
    if kind == "month":
        y0, m0 = map(int, spec["lo"].split("-"))
        y1, m1 = map(int, spec["hi"].split("-"))
        return [f"{m // 12:04d}-{m % 12 + 1:02d}-01"
                for m in range(y0 * 12 + m0 - 1, y1 * 12 + m1)]
    raise ValueError(f"unknown parameter kind {kind!r}")


def space(params: List[dict]) -> List[Params]:
    """Every parameter set of a template's ranges."""
    axes = []
    for spec in params:
        if spec["kind"] == "distinct":
            axes.append([dict(zip(spec["names"], picks)) for picks in
                         itertools.permutations(spec["values"],
                                                int(spec["k"]))])
        else:
            axes.append([{spec["name"]: v} for v in _values(spec)])
    out = []
    for combo in itertools.product(*axes):
        entry: Params = {}
        for part in combo:
            entry.update(part)
        out.append(entry)
    return out


def load_mix(path: Path, seed: int) -> Mix:
    spec = json.loads(Path(path).read_text())
    templates = [Template(t["name"], t["sql"], t["reference"],
                          int(t.get("share", 1)), t["params"])
                 for t in spec["templates"]]
    for tpl in templates:
        tpl.deck = space(tpl.params)
        random.Random(f"gpubench-deck-{int(seed)}-{tpl.name}").shuffle(
            tpl.deck)
    return Mix(Path(path).stem, int(spec["streams"]), templates, int(seed))
