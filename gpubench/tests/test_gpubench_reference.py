"""The reference's answers equal the port's rows at tpch.tiny on the CPU,
for every template and a few parameter sets, through the comparison a
run makes; the float32 control does not pass it."""

import json

import numpy as np
import pytest

import _paths

import compare as cmp
import traffic
from reference import answers, tpch_gen

LIMIT = json.loads((_paths.BENCH / "checks" / "default.json").read_text())[
    "max_rel_gap"]


@pytest.fixture(scope="module")
def runner():
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.session import Session
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                            device="cpu")


def wire(rows):
    """Rows as the statement protocol carries them (dates as text)."""
    import datetime
    return [[v.isoformat() if isinstance(v, datetime.date) else v
             for v in row] for row in rows]


@pytest.mark.parametrize("name", ["scan_agg", "joins"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_equals_the_port_at_tiny(runner, name, seed):
    mix = traffic.load_mix(_paths.BENCH / "traffic" / f"{name}.json", seed)
    items = [item for s in range(mix.streams) for item in mix.first(s, 6)]
    refs = answers(tpch_gen.SCHEMAS["tiny"],
                   [(mix.templates[t].reference, p) for t, p in items],
                   threads=2)
    tables = {"lineitem": "lineitem", "orders": "orders",
              "customer": "customer", "part": "part"}
    for (t, p), ref in zip(items, refs):
        got = wire(runner.execute(mix.sql(t, p, tables)).rows)
        assert got, (mix.templates[t].name, p)
        wrong, gap = cmp.compare(got, ref, LIMIT)
        assert not wrong and gap <= LIMIT, (
            mix.templates[t].name, p, wrong, gap)


def test_generator_equals_the_ports_host_generator():
    from trino_tpu_torch.connectors.tpch import TpchConnector
    conn = TpchConnector(device="cpu")
    sf = tpch_gen.SCHEMAS["tiny"]
    idx = np.arange(1, 2001, dtype=np.int64)
    cols = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate", "l_commitdate",
            "l_receiptdate", "l_returnflag", "l_linestatus", "l_shipmode"]
    port = conn._lineitem(idx, sf, cols)
    rows, orders = tpch_gen.lineitem(0, 2000, sf, cols + [
        "o_orderdate", "o_custkey", "o_orderpriority"])
    n = len(rows["l_shipdate"])
    for c in cols:
        col = port.columns[c]
        lane = col.data[:n].numpy()
        if col.dictionary is not None:
            lane = np.asarray(col.dictionary.values, dtype=object)[lane]
            vocab = {"l_returnflag": tpch_gen.RETURNFLAGS,
                     "l_linestatus": tpch_gen.LINESTATUS,
                     "l_shipmode": tpch_gen.MODES}[c]
            want = np.asarray(vocab, dtype=object)[rows[c]]
        else:
            want = rows[c]
        assert np.array_equal(lane, want), c
    o = conn._orders(idx, sf, ["o_orderdate", "o_custkey",
                               "o_orderpriority"])
    assert np.array_equal(o.columns["o_orderdate"].data[:2000].numpy(),
                          orders["o_orderdate"])
    assert np.array_equal(o.columns["o_custkey"].data[:2000].numpy(),
                          orders["o_custkey"])


@pytest.mark.parametrize("name", ["scan_agg", "joins"])
def test_the_float32_control_fails(name):
    import control
    bench = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
    cell = {"scan_agg": "tpch_sf10_cached.scan_agg",
            "joins": "tpch_sf10_cached.joins"}[name]
    for seed in (5, 6, 2**32 + 1):
        out = control.control(bench, cell, seed, schema="tiny", threads=2)
        assert not out["correct"], out
        assert out["max_rel_gap"] > 100 * LIMIT, out
