"""The pre-warm's session properties in the port against the JAX
package (the prewarm cases of tests/test_session_properties.py):
``prewarm_enabled`` gates a query's hot-shape recording and
``hot_shape_top_k`` caps the new registry entries one query makes, with
the same defaults and parsing in both packages."""

import pytest

from trino_tpu.session import Session as TpuSession

from trino_tpu_torch.exec import hotshapes
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.session import Session

# a query with several row-local chains (over a join, a sort and a limit)
SQL = ("SELECT o_orderpriority, count(*) AS c FROM orders JOIN customer "
       "ON o_custkey = c_custkey WHERE o_totalprice > 100000 "
       "GROUP BY o_orderpriority ORDER BY c DESC LIMIT 3")


def test_prewarm_properties_defaults_and_types():
    for s in (Session(), TpuSession()):
        assert isinstance(s.get("prewarm_enabled"), bool)
        assert int(s.get("hot_shape_top_k")) > 0
        s.set("prewarm_enabled", "false")
        assert s.get("prewarm_enabled") is False
        s.set("hot_shape_top_k", "3")
        assert s.get("hot_shape_top_k") == 3
    assert Session().get("hot_shape_top_k") == \
        TpuSession().get("hot_shape_top_k")


@pytest.fixture()
def registry(monkeypatch):
    reg = hotshapes.HotShapeRegistry(capacity=64)
    monkeypatch.setattr(hotshapes, "HOT_SHAPES", reg)
    return reg


def test_prewarm_enabled_gates_recording(registry):
    s = Session(catalog="tpch", schema="tiny")
    s.set("prewarm_enabled", False)
    r = LocalQueryRunner(s, device="cpu")
    r.execute(SQL)
    assert len(registry) == 0
    s.set("prewarm_enabled", True)
    r.execute(SQL)
    assert len(registry) > 1


def test_hot_shape_top_k_caps_a_querys_new_entries(registry):
    s = Session(catalog="tpch", schema="tiny")
    s.set("hot_shape_top_k", 1)
    r = LocalQueryRunner(s, device="cpu")
    r.execute(SQL)
    assert len(registry) == 1
    hits = sum(e["hits"] for e in registry.top(64))
    r.execute(SQL)      # a new query: one more new entry, hits counted
    assert len(registry) == 2
    assert sum(e["hits"] for e in registry.top(64)) > hits
