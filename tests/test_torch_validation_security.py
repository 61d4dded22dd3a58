"""The PyTorch engine's plan sanity checker and access control against
the JAX engine's, on the CPU.

The plan-validation tests of tests/test_static_analysis.py (all but the
remote dispatch one, which waits for the port's remote execution) and the
two grant tests of tests/test_services.py, run against the port. Every
TPC-H and TPC-DS plan of the port validates clean, and the seeded
invariant breaks are blamed on the same validators as in the reference.
"""

import pytest

from trino_tpu_torch.analysis.sanity import (PlanSanityChecker,
                                             PlanValidationError,
                                             validate_plan)
from trino_tpu_torch.catalog import CatalogManager, TableHandle
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.exec.executor import QueryError
from trino_tpu_torch.obs.metrics import METRICS, PLAN_VALIDATION_FAILURES
from trino_tpu_torch.plan.nodes import (FilterNode, JoinClause, JoinNode,
                                        ProjectNode, TableScanNode,
                                        UnionNode, ValuesNode)
from trino_tpu_torch.rex import BOOLEAN, Call, Const, InputRef
from trino_tpu_torch.runner import LocalQueryRunner
from trino_tpu_torch.security import (AccessDeniedError, AccessRule,
                                      GrantBasedAccessControl,
                                      RuleBasedAccessControl)
from trino_tpu_torch.session import Session
from trino_tpu_torch.types import BIGINT, VARCHAR

CPU = "cpu"


@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner(device=CPU)


def _scan(sym="n0", col="nationkey", typ=BIGINT, table="nation"):
    return TableScanNode(TableHandle("tpch", "tiny", table),
                         {sym: col}, {sym: typ})


# --------------------------------------------------------------------------
# sanity checker: the clean corpus
# --------------------------------------------------------------------------

def test_tier1_tpch_plans_validate_clean(runner):
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    ck = PlanSanityChecker()
    for name, sql in sorted(TPCH_QUERIES.items()):
        plan = runner.plan_sql(sql)
        ck.validate(plan, f"q{name}")
        ck.validate_fragment(plan, f"q{name}")
        # the per-pass debug battery also sees raw logical plans
        ck.validate(runner.plan_sql(sql, optimized=False),
                    f"q{name}-logical")


def test_tier1_tpcds_plans_validate_clean():
    from trino_tpu_torch.benchmarks.tpcds_queries import TPCDS_QUERIES
    r = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"),
                         device=CPU)
    ck = PlanSanityChecker()
    for name, sql in sorted(TPCDS_QUERIES.items()):
        plan = r.plan_sql(sql)
        ck.validate(plan, f"q{name}")
        ck.validate_fragment(plan, f"q{name}")
        ck.validate(r.plan_sql(sql, optimized=False), f"q{name}-logical")


def test_plan_validation_session_property_end_to_end(runner):
    # per-pass validation on: real queries still execute and return
    # the same rows (the battery must be invisible when plans are good)
    runner.session.set("plan_validation", True)
    try:
        res = runner.execute(
            "SELECT r.r_name, count(*) FROM tpch.tiny.nation n "
            "JOIN tpch.tiny.region r ON n.n_regionkey = r.r_regionkey "
            "GROUP BY r.r_name ORDER BY r.r_name")
        assert len(res.rows) == 5
    finally:
        runner.session.reset("plan_validation")


def test_plan_validation_runs_every_tpch_query(runner):
    """Every TPC-H query with the battery after each optimizer pass: the
    same rows as without it, and the battery counted."""
    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.obs.metrics import PLAN_VALIDATIONS
    want = {q: runner.execute(sql).rows for q, sql in TPCH_QUERIES.items()}
    before = PLAN_VALIDATIONS.value()
    runner.session.set("plan_validation", True)
    try:
        for q, sql in TPCH_QUERIES.items():
            assert runner.execute(sql).rows == want[q], q
    finally:
        runner.session.reset("plan_validation")
    assert PLAN_VALIDATIONS.value() > before + len(TPCH_QUERIES)
    assert "trino_tpu_plan_validations_total" in METRICS.render()


# --------------------------------------------------------------------------
# sanity checker: seeded invariant breaks, each blamed on its validator
# --------------------------------------------------------------------------

def test_dangling_inputref_caught_by_dependencies_checker():
    bad = FilterNode(_scan(), Call(
        "=", (InputRef("no_such_symbol", BIGINT), Const(1, BIGINT)),
        BOOLEAN))
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, "push_filters")
    assert ei.value.validator == "ValidateDependenciesChecker"
    assert ei.value.pass_name == "push_filters"
    assert "no_such_symbol" in str(ei.value)
    assert "push_filters" in str(ei.value)


def test_duplicate_node_object_caught():
    scan = _scan()
    bad = UnionNode((scan, scan), {"n0": BIGINT},
                    ({"n0": "n0"}, {"n0": "n0"}))
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, "cleanup_projects")
    assert ei.value.validator == "NoDuplicatePlanNodeIds"


def test_type_mismatched_join_clause_caught():
    left = _scan("n0", "nationkey", BIGINT, "nation")
    right = _scan("r0", "name", VARCHAR, "region")
    bad = JoinNode(left, right, "inner", (JoinClause("n0", "r0"),))
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, "reorder_joins")
    assert ei.value.validator == "JoinCriteriaChecker"
    assert "bigint" in str(ei.value) and "varchar" in str(ei.value)


def test_join_clause_wrong_side_caught():
    left = _scan("n0", "nationkey", BIGINT, "nation")
    right = _scan("r0", "regionkey", BIGINT, "region")
    bad = JoinNode(left, right, "inner", (JoinClause("r0", "r0"),))
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad)
    assert ei.value.validator == "JoinCriteriaChecker"
    assert "left source" in str(ei.value)


def test_inputref_type_drift_caught_by_type_validator():
    bad = ProjectNode(_scan(), {"p0": InputRef("n0", VARCHAR)})
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, "prune_columns")
    assert ei.value.validator == "TypeValidator"


def test_serde_unstable_fragment_caught():
    # an int-keyed dict survives encode->decode only as a str-keyed
    # dict: the fragment a retry would decode is not the fragment the
    # first attempt ran
    bad = ValuesNode({"v0": BIGINT}, (({1: "a"},),))
    validate_plan(bad)          # plan battery alone is fine with it
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, "fragmenter", fragment=True)
    assert ei.value.validator == "SerdeRoundTripChecker"


def test_unserializable_fragment_caught():
    bad = ValuesNode({"v0": BIGINT}, (({"a", "b"},),))   # a set
    with pytest.raises(PlanValidationError) as ei:
        validate_plan(bad, fragment=True)
    assert ei.value.validator == "SerdeRoundTripChecker"
    assert "not serializable" in str(ei.value)


def test_validation_failures_counted():
    before = PLAN_VALIDATION_FAILURES.value(
        validator="ValidateDependenciesChecker")
    bad = FilterNode(_scan(), Call(
        "=", (InputRef("ghost", BIGINT), Const(1, BIGINT)), BOOLEAN))
    with pytest.raises(PlanValidationError):
        validate_plan(bad)
    after = PLAN_VALIDATION_FAILURES.value(
        validator="ValidateDependenciesChecker")
    assert after == before + 1


def test_broken_optimizer_pass_is_blamed(monkeypatch):
    # the debug battery pins a violation on the pass that made it:
    # corrupt prune_columns and the error must say so
    import trino_tpu_torch.planner.optimizer as O
    from dataclasses import replace as dc_replace
    real = O.prune_columns

    def broken(plan):
        out = real(plan)
        dangling = FilterNode(out.source, Call(
            "=", (InputRef("__broken_by_prune", BIGINT),
                  Const(1, BIGINT)), BOOLEAN))
        return dc_replace(out, source=dangling)

    monkeypatch.setattr(O, "prune_columns", broken)
    r = LocalQueryRunner(device=CPU)
    r.session.set("plan_validation", True)
    with pytest.raises(PlanValidationError) as ei:
        r.execute("SELECT n_nationkey FROM tpch.tiny.nation")
    assert ei.value.pass_name == "prune_columns"
    assert ei.value.validator == "ValidateDependenciesChecker"
    # without the debug property the same corruption sails through the
    # optimizer and is caught by nothing until execution
    r2 = LocalQueryRunner(device=CPU)
    with pytest.raises(Exception) as ei2:
        r2.execute("SELECT n_nationkey FROM tpch.tiny.nation")
    assert not isinstance(ei2.value, PlanValidationError)


def test_plan_serde_round_trips_every_tpch_plan(runner):
    """The port's plan wire format against the reference's encoding of
    the same kind of plan: every TPC-H plan encodes, decodes to an equal
    plan and re-encodes to the same JSON."""
    import json

    from trino_tpu_torch.benchmarks.tpch_queries import TPCH_QUERIES
    from trino_tpu_torch.plan.serde import from_jsonable, to_jsonable
    for q, sql in TPCH_QUERIES.items():
        plan = runner.plan_sql(sql)
        enc = to_jsonable(plan)
        back = from_jsonable(json.loads(json.dumps(enc)))
        assert back == plan, q
        assert to_jsonable(back) == enc, q


# --------------------------------------------------------------------------
# tests/test_services.py: GRANT / REVOKE / DENY / SHOW GRANTS
# --------------------------------------------------------------------------

def test_grant_revoke_show_grants():
    r = LocalQueryRunner(device=CPU)
    r.execute("CREATE TABLE memory.default.gr_t AS SELECT 1 AS x")
    r.execute("GRANT SELECT, INSERT ON memory.default.gr_t TO alice")
    rows = r.execute("SHOW GRANTS ON memory.default.gr_t").rows
    assert sorted(x[7] for x in rows) == ["INSERT", "SELECT"]
    assert all(x[2] == "alice" for x in rows)
    r.execute("REVOKE INSERT ON memory.default.gr_t FROM alice")
    rows = r.execute("SHOW GRANTS ON memory.default.gr_t").rows
    assert [x[7] for x in rows] == ["SELECT"]
    r.execute("GRANT ALL PRIVILEGES ON TABLE memory.default.gr_t "
              "TO USER bob WITH GRANT OPTION")
    rows = r.execute("SHOW GRANTS").rows
    bob = [x for x in rows if x[2] == "bob"]
    assert len(bob) == 4 and all(x[8] is True for x in bob)


def test_grant_enforcement():
    cats = CatalogManager()
    cats.register("memory", MemoryConnector(CPU))
    admin = LocalQueryRunner(
        session=Session(catalog="memory", schema="default", user="admin"),
        device=CPU, catalogs=cats)
    admin.execute("CREATE TABLE memory.default.sec_t AS SELECT 1 AS x")
    cats.access_control = GrantBasedAccessControl(cats)
    alice = LocalQueryRunner(
        session=Session(catalog="memory", schema="default", user="alice"),
        device=CPU, catalogs=cats)
    with pytest.raises((QueryError, Exception), match="Access Denied"):
        alice.execute("SELECT * FROM memory.default.sec_t")
    admin.execute("GRANT SELECT ON memory.default.sec_t TO alice")
    assert alice.execute(
        "SELECT * FROM memory.default.sec_t").rows == [[1]]
    admin.execute("DENY SELECT ON memory.default.sec_t TO alice")
    with pytest.raises((QueryError, Exception), match="Access Denied"):
        alice.execute("SELECT * FROM memory.default.sec_t")


@pytest.mark.parametrize("sql, privilege", [
    ("SELECT * FROM memory.default.t", "select"),
    ("INSERT INTO memory.default.t VALUES (2)", "insert"),
    ("DELETE FROM memory.default.t WHERE x = 1", "delete"),
    ("CREATE TABLE memory.default.u (y BIGINT)", "create"),
    ("DROP TABLE memory.default.t", "drop"),
])
def test_rule_based_denials_match_the_jax_engine(sql, privilege):
    """A rule list that allows only reads of tpch: each statement on the
    memory catalog is denied with the reference's message, by the port and
    by the JAX engine alike."""
    from trino_tpu.catalog import CatalogManager as JaxCatalogs
    from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
    from trino_tpu.runner import LocalQueryRunner as JaxRunner
    from trino_tpu.security import (AccessRule as JaxRule,
                                    RuleBasedAccessControl as JaxRules)
    from trino_tpu.session import Session as JaxSession
    messages = []
    for mk_cats, mk_mem, mk_runner, mk_session, rules, rule in (
            (CatalogManager, lambda: MemoryConnector(CPU),
             lambda s, c: LocalQueryRunner(s, CPU, c), Session,
             RuleBasedAccessControl, AccessRule),
            (JaxCatalogs, JaxMemory,
             lambda s, c: JaxRunner(session=s, catalogs=c), JaxSession,
             JaxRules, JaxRule)):
        cats = mk_cats()
        cats.register("memory", mk_mem())
        r = mk_runner(mk_session(catalog="memory", schema="default",
                                 user="eve"), cats)
        r.execute("CREATE TABLE memory.default.t AS SELECT 1 AS x")
        cats.access_control = rules([rule(user="eve",
                                          table=r"tpch\..*",
                                          privileges=("select",))])
        with pytest.raises(Exception, match="Access Denied") as ei:
            r.execute(sql)
        messages.append(str(ei.value))
    assert messages[0] == messages[1]
    assert f"Cannot {privilege}" in messages[0]


def test_access_denied_error_is_the_references():
    e = AccessDeniedError("Cannot select table a.b.c as user u")
    assert str(e) == "Access Denied: Cannot select table a.b.c as user u"
