"""The port's source lint (trino_tpu_torch/analysis/lint.py) against the
JAX package's, and the port's pre-dispatch plan validation.

Counterparts of the lint and metrics-hygiene cases of
tests/test_static_analysis.py: every seeded source string (and every set
of files) goes through both lints, whose findings must be equal, and the
reference test's own expectations are held on the port's. Then the
lint over the port's own tree: no unsuppressed finding, every
suppression with its reason (the CI gate, as the reference's real-tree
case is for its package), and the port's remote scheduler refusing a
corrupt plan before any worker sees it.
"""

import textwrap

import pytest

from trino_tpu.analysis import lint as jax_lint
from trino_tpu_torch.analysis import lint
from trino_tpu_torch.analysis.lint import lint_paths, lint_source, main


def _key(f):
    return (f.path, f.line, f.col, f.rule, f.severity, f.message,
            f.suppressed)


def same_source(src: str, path: str):
    """The port's findings on ``src``, held equal to the JAX lint's."""
    got = lint_source(src, path)
    assert [_key(f) for f in got] == \
        [_key(f) for f in jax_lint.lint_source(src, path)]
    return got


def same_paths(paths, **kw):
    """The port's findings over files, held equal to the JAX lint's."""
    got = lint_paths(paths, **kw)
    assert [_key(f) for f in got] == \
        [_key(f) for f in jax_lint.lint_paths(paths, **kw)]
    return got


# --------------------------------------------------------------------------
# the real tree (the CI gate) and pre-dispatch validation
# --------------------------------------------------------------------------

def test_lint_real_tree_zero_unsuppressed_findings():
    findings = [f for f in lint_paths([lint.default_root()])
                if not f.suppressed]
    assert findings == [], "\n".join(f.render() for f in findings)


def test_lint_default_root_is_the_port_and_cli_exits_zero(capsys):
    """``python -m trino_tpu_torch.analysis.lint`` lints this package
    and exits 0 over it."""
    import os
    import trino_tpu_torch
    assert lint.default_root() == os.path.dirname(
        os.path.abspath(trino_tpu_torch.__file__))
    assert main([]) == 0
    assert "0 error(s)" in capsys.readouterr().out


def test_lint_suppressions_all_carry_reasons():
    findings = lint_paths([lint.default_root()])
    assert not [f for f in findings
                if f.rule == "suppression-without-reason"]
    assert any(f.suppressed for f in findings), \
        "expected the tree's documented suppressions to register"


def test_lint_cross_callees_name_the_ports_modules():
    """Every allowlisted callee pattern names a module or directory of
    this package."""
    import os
    root = lint.default_root()
    for pat in lint._CROSS_CALLEES:
        assert os.path.exists(os.path.join(root, pat.rstrip("/"))), pat


def test_remote_dispatch_always_validates():
    """No plan_validation property needed: a corrupt plan dies at the
    port's scheduler before any worker sees a byte, blamed on the
    pre-dispatch pass, as in the JAX package."""
    from trino_tpu.analysis.sanity import \
        PlanValidationError as TpuValidationError
    from trino_tpu.catalog import TableHandle as TpuHandle
    from trino_tpu.exec.remote import RemoteScheduler as TpuScheduler
    from trino_tpu.plan import nodes as tpu_nodes
    from trino_tpu import rex as tpu_rex
    from trino_tpu.runner import LocalQueryRunner as TpuRunner
    from trino_tpu.session import Session as TpuSession
    from trino_tpu.types import BIGINT as TPU_BIGINT
    from trino_tpu_torch import rex
    from trino_tpu_torch.analysis.sanity import PlanValidationError
    from trino_tpu_torch.catalog import TableHandle
    from trino_tpu_torch.exec.remote import RemoteScheduler
    from trino_tpu_torch.plan.nodes import FilterNode, TableScanNode
    from trino_tpu_torch.runner import LocalQueryRunner
    from trino_tpu_torch.session import Session
    from trino_tpu_torch.types import BIGINT

    def bad_plan(nodes, r, handle, bigint):
        scan = nodes.TableScanNode(handle("tpch", "tiny", "nation"),
                                   {"n0": "nationkey"}, {"n0": bigint})
        return nodes.FilterNode(scan, r.Call(
            "=", (r.InputRef("phantom", bigint), r.Const(1, bigint)),
            r.BOOLEAN))
    from types import SimpleNamespace
    port_nodes = SimpleNamespace(TableScanNode=TableScanNode,
                                 FilterNode=FilterNode)
    sched = RemoteScheduler(["http://127.0.0.1:1"],
                            LocalQueryRunner(device="cpu").catalogs,
                            Session(catalog="tpch", schema="tiny"),
                            device="cpu")
    with pytest.raises(PlanValidationError) as got:
        sched.execute_plan(bad_plan(port_nodes, rex, TableHandle, BIGINT))
    tpu = TpuScheduler(["http://127.0.0.1:1"], TpuRunner().catalogs,
                       TpuSession(catalog="tpch", schema="tiny"))
    with pytest.raises(TpuValidationError) as want:
        tpu.execute_plan(bad_plan(tpu_nodes, tpu_rex, TpuHandle,
                                  TPU_BIGINT))
    assert got.value.pass_name == want.value.pass_name == "pre-dispatch"
    assert got.value.validator == want.value.validator
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# cross-module reachability
# --------------------------------------------------------------------------

_CROSS_CALLER = textwrap.dedent('''
    import threading

    class Dispatcher:
        def start(self, spool):
            self.spool = spool
            threading.Thread(target=self._run).start()

        def _run(self):
            self.spool.commit("q1")
''')

_CROSS_CALLER_LOCKED = textwrap.dedent('''
    import threading

    class Dispatcher:
        def start(self, spool):
            self.spool = spool
            threading.Thread(target=self._run).start()

        def _run(self):
            with self._lock:
                self.spool.commit("q1")
''')

_CROSS_CALLEE = textwrap.dedent('''
    class Spool:
        def commit(self, query):
            self.last = query        # unlocked shared write

    class _Private:
        def commit(self, query):
            self.hidden = query      # module-internal receiver
''')


def _write_cross(tmp_path, caller_src):
    caller = tmp_path / "sched.py"
    callee = tmp_path / "spoolmod.py"
    caller.write_text(caller_src)
    callee.write_text(_CROSS_CALLEE)
    return str(caller), str(callee)


def test_lint_cross_module_follows_thread_to_callee_edges(tmp_path):
    caller, callee = _write_cross(tmp_path, _CROSS_CALLER)
    findings = same_paths([caller, callee], cross_callees=("",))
    hits = [f for f in findings if f.rule == "race-attr-write"]
    assert any(f.path == callee and "self.last" in f.message
               for f in hits), findings
    assert not any("self.hidden" in f.message for f in hits), hits


def test_lint_cross_module_propagates_caller_lock_context(tmp_path):
    caller, callee = _write_cross(tmp_path, _CROSS_CALLER_LOCKED)
    findings = same_paths([caller, callee], cross_callees=("",))
    assert not [f for f in findings if f.rule.startswith("race")]


def test_lint_cross_module_disabled_stays_module_local(tmp_path):
    caller, callee = _write_cross(tmp_path, _CROSS_CALLER)
    findings = same_paths([caller, callee], cross_callees=None)
    assert not [f for f in findings if f.rule.startswith("race")]


def test_lint_cross_module_allowlist_scopes_callees(tmp_path):
    caller, callee = _write_cross(tmp_path, _CROSS_CALLER)
    findings = same_paths([caller, callee],
                          cross_callees=("does-not-match-anything/",))
    assert not [f for f in findings if f.rule.startswith("race")]


# --------------------------------------------------------------------------
# seeded race fixtures
# --------------------------------------------------------------------------

_RACE_FIXTURE = textwrap.dedent('''
    import threading

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self.items = []

        def start(self):
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            self.count += 1
            self.items.append(1)
            with self._lock:
                self.count += 1
            self._helper()
            with self._lock:
                self._locked_helper()

        def _helper(self):
            self.count = 5

        def _locked_helper(self):
            self.count = 9
''')


def test_lint_flags_unguarded_thread_writes():
    findings = same_source(_RACE_FIXTURE, "fixture.py")
    rules = {(f.line, f.rule) for f in findings}
    assert (14, "race-attr-write") in rules
    assert (15, "race-attr-mutate") in rules
    assert any(r == "race-attr-write" and ln == 23 for ln, r in rules)
    assert not any(ln in (17, 26) for ln, _ in rules), findings


def test_lint_lock_context_propagates_through_calls():
    src = textwrap.dedent('''
        import threading

        class Stats:
            def record(self):
                self.weight = 1

        class Detector:
            def __init__(self):
                self._lock = threading.Lock()

            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                with self._lock:
                    Stats().record()
    ''')
    assert [f for f in same_source(src, "d.py")
            if f.rule.startswith("race")] == []


def test_lint_timer_target_and_obj_method_resolution():
    src = textwrap.dedent('''
        import threading

        class Query:
            def cancel(self):
                self.state = "CANCELED"

        def arm(q):
            threading.Timer(5.0, q.cancel).start()
    ''')
    assert any(f.rule == "race-attr-write" and f.line == 6
               for f in same_source(src, "t.py"))


def test_lint_positional_thread_target_resolved():
    src = textwrap.dedent('''
        import threading

        class W:
            def go(self):
                threading.Thread(None, self.body).start()

            def body(self):
                self.x = 1
    ''')
    assert any(f.rule == "race-attr-write" and f.line == 9
               for f in same_source(src, "p.py"))


def test_lint_handler_self_writes_exempt():
    src = textwrap.dedent('''
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.principal = None     # per-request instance: fine
    ''')
    assert [f for f in same_source(src, "h.py")
            if f.rule.startswith("race")] == []


# --------------------------------------------------------------------------
# seeded jit-purity fixtures (the port traces nothing; the rules stay)
# --------------------------------------------------------------------------

_JIT_FIXTURE = textwrap.dedent('''
    import time
    import jax
    import numpy as np

    acc = []

    def make():
        def run(b):
            t0 = time.perf_counter()
            acc.append(b)
            x = np.random.rand(3)
            k = jax.random.PRNGKey(0)
            local = []
            local.append(x)
            return b
        return jax.jit(run)

    @jax.jit
    def decorated(x):
        print(x)
        return x
''')


def test_lint_flags_jit_impurities():
    findings = same_source(_JIT_FIXTURE, "jit.py")
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f.line)
    assert sorted(by_rule.get("jit-impure", [])) == [10, 12, 21]
    assert by_rule.get("jit-closure-mutate") == [11]
    assert not any(f.line in (13, 15) for f in findings)


def test_lint_flags_aot_unsafe_branches():
    src = textwrap.dedent('''
        import jax

        @jax.jit
        def f(x, y):
            if x.item():
                return y
            while int(y) > 0:
                y = y - 1
            if bool(x) and float(y) > 0.5:
                return x
            if int(3) > 2:
                return y          # constant arg: no data dependence
            n = x.shape[0]        # static metadata: fine
            return x + y

        def not_traced(x):
            if x.item():          # outside any traced function
                return 1
            return int(x)
    ''')
    findings = [f for f in same_source(src, "a.py")
                if f.rule == "aot-unsafe"]
    assert sorted(f.line for f in findings) == [6, 8, 10, 10]
    assert all(f.severity == "error" for f in findings)


def test_lint_aot_unsafe_suppressible():
    src = textwrap.dedent('''
        import jax

        @jax.jit
        def f(x):
            if x.item():  # tt-lint: ignore[aot-unsafe] shape-gated constant under static_argnums
                return x
            return x
    ''')
    findings = same_source(src, "a.py")
    assert not [f for f in findings
                if f.rule == "aot-unsafe" and not f.suppressed]
    assert any(f.rule == "aot-unsafe" and f.suppressed for f in findings)


def test_lint_shard_map_and_partial_decorator():
    src = textwrap.dedent('''
        import time
        from functools import partial
        import jax
        from jax import shard_map

        def build(mesh):
            def f(x):
                time.sleep(1)
                return x
            return shard_map(f, mesh=mesh, in_specs=None,
                             out_specs=None)

        @partial(jax.jit, static_argnames=("k",))
        def kernel(x, k):
            import random
            return x + random.random()
    ''')
    assert {f.line for f in same_source(src, "s.py")
            if f.rule == "jit-impure"} == {9, 17}


# --------------------------------------------------------------------------
# suppressions and the CLI severity gate
# --------------------------------------------------------------------------

def test_lint_suppression_and_reason_requirement():
    src = textwrap.dedent('''
        import threading

        class W:
            def go(self):
                threading.Thread(target=self.body).start()

            def body(self):
                self.x = 1  # tt-lint: ignore[race-attr-write] single writer before publication
                self.y = 2  # tt-lint: ignore[race-attr-write]
                self.z = 3
    ''')
    findings = same_source(src, "w.py")
    xs = [f for f in findings if f.line == 9]
    assert xs and all(f.suppressed for f in xs)
    ys = [f for f in findings if f.line == 10]
    assert any(f.suppressed for f in ys)
    assert any(f.rule == "suppression-without-reason" and not f.suppressed
               for f in ys)
    zs = [f for f in findings if f.line == 11]
    assert zs and not any(f.suppressed for f in zs)


def test_lint_cli_fail_on_flag(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent('''
        import threading

        class W:
            def go(self):
                threading.Thread(target=self.body).start()

            def body(self):
                self.x = 1
    '''))
    warn_only = tmp_path / "warn.py"
    warn_only.write_text(textwrap.dedent('''
        import jax

        acc = []

        def f(x):
            acc.append(x)
            return x

        g = jax.jit(f)
    '''))
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    cases = [[str(bad)], [str(bad), "--fail-on", "none"],
             [str(warn_only)], [str(warn_only), "--fail-on", "warning"],
             [str(clean), "--fail-on", "warning"]]
    got = []
    for argv in cases:
        got.append(main(argv))
        port_out = capsys.readouterr().out
        assert jax_lint.main(argv) == got[-1]
        assert capsys.readouterr().out == port_out
    assert got == [1, 0, 0, 1, 0]


# --------------------------------------------------------------------------
# metrics hygiene
# --------------------------------------------------------------------------

def test_metrics_hygiene_flags_missing_help_and_bad_names():
    src = textwrap.dedent('''
        from trino_tpu_torch.obs.metrics import METRICS

        A = METRICS.counter("trino_tpu_good_total", "documented")
        B = METRICS.counter("trino_tpu_nohelp_total")
        C = METRICS.counter("bad_prefix_total", "has help")
        D = METRICS.counter("trino_tpu_not_a_counter", "has help")
        E = METRICS.histogram("trino_tpu_latency", "has help")
        F = METRICS.gauge("trino_tpu_thing", "has help")
        G = METRICS.gauge("trino_tpu_pool_bytes", "has help")
        H = METRICS.counter("trino_tpu_emptyhelp_total", "")
        _HELP = "documented elsewhere"
        I = METRICS.counter("trino_tpu_varhelp_total", _HELP)
    ''')
    findings = [f for f in same_source(src, "m.py")
                if f.rule.startswith("metric")]
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f.message)
    missing = by_rule.get("metric-missing-help", [])
    assert any("trino_tpu_nohelp_total" in m for m in missing)
    assert any("trino_tpu_emptyhelp_total" in m for m in missing)
    assert not any("trino_tpu_varhelp_total" in m for m in missing)
    naming = " ".join(by_rule.get("metric-naming", []))
    assert "bad_prefix_total" in naming
    assert "trino_tpu_not_a_counter" in naming
    assert "trino_tpu_latency" in naming
    assert "'trino_tpu_thing'" in naming
    assert "trino_tpu_good_total" not in naming
    assert "trino_tpu_pool_bytes" not in naming


def test_metrics_hygiene_ignores_local_registries():
    src = textwrap.dedent('''
        from trino_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        c = reg.counter("t2_total", "")
    ''')
    assert [f for f in same_source(src, "r.py")
            if f.rule.startswith("metric")] == []


def test_metrics_hygiene_duplicate_registration_across_files(tmp_path):
    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text(textwrap.dedent('''
        from trino_tpu_torch.obs.metrics import METRICS
        X = METRICS.counter("trino_tpu_dup_total", "first home")
    '''))
    b.write_text(textwrap.dedent('''
        from trino_tpu_torch.obs.metrics import METRICS
        Y = METRICS.counter("trino_tpu_dup_total", "second home")
    '''))
    findings = [f for f in same_paths([str(a), str(b)])
                if f.rule == "metric-duplicate-registration"]
    assert len(findings) == 1
    assert findings[0].path == str(b)
    assert "a.py" in findings[0].message


def test_metrics_hygiene_duplicate_within_one_file():
    src = textwrap.dedent('''
        from trino_tpu_torch.obs.metrics import METRICS
        X = METRICS.counter("trino_tpu_twice_total", "one")
        Y = METRICS.counter("trino_tpu_twice_total", "two")
    ''')
    findings = [f for f in same_source(src, "dup.py")
                if f.rule == "metric-duplicate-registration"]
    assert len(findings) == 1 and findings[0].line == 4
