"""Shared by the port's coordinator tests (tests/test_torch_server*.py,
test_torch_cluster_infra.py, test_torch_query_history.py,
test_torch_governance.py): the JAX coordinator and the port's
coordinator (``device="cpu"``) side by side, the raw statement protocol,
and the comparisons.

Cells compare as the other port tests do: integers, strings, dates,
timestamps and decimals (JSON strings on the wire) exactly, doubles
within rel 1e-9.
"""

import json
import math
import re
import urllib.error
import urllib.request

import pytest

from trino_tpu.server.coordinator import Coordinator as TpuCoordinator
from trino_tpu_torch.server.coordinator import Coordinator


def same_cell(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or math.isclose(a, b, rel_tol=1e-9)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(same_cell, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_cell(a[k], b[k])
                                            for k in a)
    return a == b and type(a) is type(b)


def same_rows(got, want) -> bool:
    return len(got) == len(want) and all(map(same_cell, got, want))


def assert_same_result(got, want):
    """Two client results (``ClientResult``) agree: columns with their
    types, rows, update type and count."""
    assert got.columns == want.columns
    assert same_rows(got.rows, want.rows), (got.rows[:5], want.rows[:5])
    assert (got.update_type, got.update_count) == \
        (want.update_type, want.update_count)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX coordinator, port coordinator on the CPU), each with its own
    history directory, stopped at teardown."""
    jco = TpuCoordinator(
        history_dir=str(tmp_path_factory.mktemp("jax_history"))).start()
    tco = Coordinator(
        device="cpu",
        history_dir=str(tmp_path_factory.mktemp("port_history"))).start()
    yield jco, tco
    tco.stop()
    jco.stop()


def http(method: str, uri: str, body: bytes = None, headers=None):
    """(status, decoded JSON payload) of one request; an HTTP error's
    status and body too."""
    req = urllib.request.Request(uri, data=body, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw else None)
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw) if raw else None
        except ValueError:
            return e.code, raw.decode("utf-8", "replace")


def protocol_pages(base_uri: str, sql: str, headers=None):
    """Every QueryResults payload of one statement: the POST's, then
    each ``nextUri`` page's, with the POST's status."""
    hdrs = {"X-Trino-User": "user", "X-Trino-Catalog": "tpch",
            "X-Trino-Schema": "tiny", **(headers or {})}
    status, page = http("POST", f"{base_uri}/v1/statement",
                        sql.encode(), hdrs)
    pages = [page]
    while isinstance(page, dict) and page.get("nextUri"):
        _, page = http("GET", page["nextUri"], headers=hdrs)
        pages.append(page)
    return status, pages


def payload_shape(pages):
    """What two coordinators must agree on in a statement's pages: the
    columns, the data (concatenated in page order), the final state, the
    update type and count, the error's identity, and which pages carried
    data. Ids, URIs and timings differ by nature."""
    final = pages[-1]
    err = final.get("error")
    return {
        "columns": next((p["columns"] for p in pages if "columns" in p),
                        None),
        "data": [row for p in pages for row in p.get("data", [])],
        "rows_per_page": [len(p["data"]) for p in pages if "data" in p],
        "state": final["stats"]["state"],
        "updateType": final.get("updateType"),
        "updateCount": final.get("updateCount"),
        "error": None if err is None else {
            k: err.get(k) for k in ("message", "errorCode", "errorName",
                                    "errorType")},
        "failureType": None if err is None
        else (err.get("failureInfo") or {}).get("type"),
    }


_STATS_LINE = re.compile(r"^(\w+): [0-9.]+ms(?:, in (\d+) rows)?"
                         r"(?:/\d+B)?, out (\d+) rows")


def analyze_shape(lines):
    """EXPLAIN ANALYZE output without its walls: the plan lines, each
    node's (name, rows in, rows out), and the trace's span names. The
    port's executor spans (``node.<Name>`` a plan node, ``device_wait`` at
    each host read of the card) have no counterpart in the JAX package's
    trace: they are held here to the stats lines, one node span a line,
    and left out of the names."""
    plan, nodes, spans = [], [], []
    section = "plan"
    for line in lines:
        if line == "":
            section = "stats" if section == "plan" else section
            continue
        if line == "Trace:":
            section = "trace"
            continue
        if section == "plan":
            plan.append(line)
        elif section == "stats":
            m = _STATS_LINE.match(line)
            assert m, line
            nodes.append((m.group(1), m.group(2), m.group(3)))
        else:
            spans.append(line.split(":")[0].lstrip(" -"))
    executed = sorted(n[len("node."):] for n in spans
                      if n.startswith("node."))
    if executed:
        assert executed == sorted(n for n, _, _ in nodes), (executed, nodes)
    spans = [n for n in spans
             if not n.startswith("node.") and n != "device_wait"]
    return plan, nodes, spans
