"""The port's codebase linter and proto drift check against the JAX package's.

Every lint case of ``tests/test_analysis.py`` (``TestLintRules``, the
baseline and CLI cases) runs through both linters on the same source, and
their findings (rule, line, column, scope, message) are equal, and equal to
what the JAX test expects; both linters give the same findings over each
package's tree; the port's tree is lint-clean against the port's (empty)
baseline; the CLIs' exit codes agree. The port's drift check finds all five
protos of ``ballista_tpu_torch/proto`` in step with their ``_pb2`` modules,
and reports a renumbered or added field in a copy of ``ballista.proto`` as
the JAX package's check does.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from ballista_tpu.analysis import lint as JL
from ballista_tpu.analysis import proto_drift as JD
from ballista_tpu_torch.analysis import lint as TL
from ballista_tpu_torch.analysis import proto_drift as TD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PROTO = os.path.join(REPO, "ballista_tpu_torch", "proto")

# (source, the rules tests/test_analysis.py expects, in order)
LINT_CASES = {
    "bl001_blocking_call_under_lock": ("""
        import time

        class S:
            def f(self):
                with self._lock:
                    time.sleep(1)
    """, ["BL001"]),
    "bl001_through_self_call_chain": ("""
        import time

        class S:
            def f(self):
                with self._revive_lock:
                    self._helper()

            def _helper(self):
                self._stub().LaunchTask(x=1)
    """, ["BL001"]),
    "bl001_nested_def_not_flagged": ("""
        import time, threading

        class S:
            def f(self):
                with self._lock:
                    def later():
                        time.sleep(1)
                    threading.Thread(target=later).start()
    """, []),
    "bl002_blocking_in_event_callback": ("""
        import time
        from ballista_tpu.utils.event_loop import EventAction

        class A(EventAction):
            def on_receive(self, event):
                time.sleep(5)
    """, ["BL002"]),
    "bl003_lock_order_inversion": ("""
        class S:
            def f(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def g(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
    """, ["BL003", "BL003"]),
    "bl003_consistent_order_ok": ("""
        class S:
            def f(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def g(self):
                with self._a_lock:
                    with self._b_lock:
                        pass
    """, []),
    "bl101_np_call_inside_jit": ("""
        import jax
        import numpy as np

        @jax.jit
        def traced(x):
            return np.asarray(x)
    """, ["BL101"]),
    "bl101_jitted_by_name": ("""
        import jax

        def run(vals):
            def stage_fn(x):
                print(x)
                return x
            return jax.jit(stage_fn)(vals)
    """, ["BL101"]),
    "bl101_partial_jit": ("""
        import jax
        from functools import partial

        @partial(jax.jit, static_argnums=0)
        def traced(n, x):
            return x.item()
    """, ["BL101"]),
    "bl101_dtype_attrs_allowed": ("""
        import jax
        import numpy as np

        @jax.jit
        def traced(x):
            return x.astype(np.dtype('int32'))
    """, []),
    "bl102_ordered_consumer_not_flagged": ("""
        def cache_key(keys):
            return "|".join(sorted(str(k) for k in set(keys)))
    """, []),
    "bl102_set_iteration_in_hashing_code": ("""
        def fingerprint(parts):
            out = []
            for p in set(parts):
                out.append(p)
            return tuple(out)

        def unrelated(parts):
            for p in set(parts):
                pass
    """, ["BL102"]),
    "inline_suppression": ("""
        import time

        class S:
            def f(self):
                with self._lock:
                    time.sleep(1)  # ballista: lint-ok[BL001]
    """, []),
    "baseline_two_findings": ("""
        import time

        class S:
            def f(self):
                with self._lock:
                    time.sleep(1)
                    time.sleep(2)
    """, ["BL001", "BL001"]),
}


def _tuples(findings):
    return [(f.path, f.line, f.col, f.rule, f.scope, f.message) for f in findings]


def _lint(mod, tmp_path, source):
    p = tmp_path / "sample.py"
    p.write_text(textwrap.dedent(source))
    return mod.lint_paths([str(p)], root=str(tmp_path))


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_case_matches_jax(tmp_path, case):
    source, rules = LINT_CASES[case]
    want = _lint(JL, tmp_path, source)
    got = _lint(TL, tmp_path, source)
    assert _tuples(got) == _tuples(want)
    assert sorted(f.rule for f in got) == sorted(rules)


def test_baseline_absorbs_exact_budget_as_jax(tmp_path):
    source, _ = LINT_CASES["baseline_two_findings"]
    out = []
    for mod in (JL, TL):
        findings = _lint(mod, tmp_path, source)
        fresh = mod.apply_baseline(findings, {findings[0].key(): 1})
        out.append(_tuples(fresh))
    assert len(out[1]) == 1 and out[0] == out[1]  # one absorbed, the second is new debt


@pytest.mark.parametrize("tree", ["ballista_tpu", "ballista_tpu_torch"])
def test_linters_agree_on_each_package(tree):
    path = os.path.join(REPO, tree)
    assert _tuples(TL.lint_paths([path], root=REPO)) == _tuples(JL.lint_paths([path], root=REPO))


def test_port_is_lint_clean_against_its_baseline():
    assert TL.DEFAULT_BASELINE == os.path.join(REPO, "ballista_tpu_torch", "analysis",
                                               "lint_baseline.json")
    assert TL.load_baseline(TL.DEFAULT_BASELINE) == {}  # it starts empty
    findings = TL.lint_paths([os.path.join(REPO, "ballista_tpu_torch")], root=REPO)
    fresh = TL.apply_baseline(findings, TL.load_baseline(TL.DEFAULT_BASELINE))
    assert fresh == [], "new lint findings:\n" + "\n".join(f.render() for f in fresh)


def test_write_baseline_absorbs_findings(tmp_path):
    source, _ = LINT_CASES["bl001_blocking_call_under_lock"]
    findings = _lint(TL, tmp_path, source)
    path = str(tmp_path / "baseline.json")
    TL.write_baseline(findings, path)
    assert TL.apply_baseline(findings, TL.load_baseline(path)) == []


@pytest.mark.parametrize("clean", [False, True], ids=["counterexample", "clean"])
def test_lint_cli_exit_codes_match_jax(tmp_path, clean):
    p = tmp_path / "sample.py"
    body = "pass" if clean else "time.sleep(1)"
    p.write_text("import time\n\nclass S:\n    def f(self):\n"
                 f"        with self._lock:\n            {body}\n")
    codes = []
    for mod in ("ballista_tpu.analysis.lint", "ballista_tpu_torch.analysis.lint"):
        r = subprocess.run([sys.executable, "-m", mod, str(p), "--no-baseline"],
                           capture_output=True, text=True, cwd=REPO, timeout=120)
        codes.append(r.returncode)
        assert ("lint clean" in r.stdout) == clean and ("BL001" in r.stdout) != clean
    assert codes == ([0, 0] if clean else [1, 1])


# ---- proto drift -------------------------------------------------------------------------
def test_all_port_protos_match_their_pb2():
    assert TD.PROTO_DIR == PORT_PROTO
    results = TD.check_all()
    assert set(results) == {"ballista.proto", "etcd.proto", "flight_sql.proto", "keda.proto",
                            "kv.proto"}
    for fname, problems in results.items():
        assert problems == [], f"{fname} drifted: {problems}"


def _tampered(tmp_path, old, new):
    with open(os.path.join(PORT_PROTO, "ballista.proto")) as f:
        proto = f.read()
    tampered = proto.replace(old, new, 1)
    assert tampered != proto
    p = tmp_path / "ballista.proto"
    p.write_text(tampered)
    return str(p)


@pytest.mark.parametrize("old,new,expect", [
    ("string job_id = 1;", "string job_id = 90;", "field number"),
    ("message GetTraceParams { string job_id = 1; }",
     "message GetTraceParams { string job_id = 1; bool flush = 2; }", "not in _pb2"),
], ids=["renumbered", "added"])
def test_tampered_proto_is_drift(tmp_path, old, new, expect):
    from ballista_tpu.proto import ballista_pb2 as jpb
    from ballista_tpu_torch.proto import ballista_pb2 as tpb

    path = _tampered(tmp_path, old, new)
    problems = TD.check_proto_module(path, tpb)
    assert any(expect in x for x in problems), problems
    assert problems == JD.check_proto_module(path, jpb)
    # the CLI over a directory holding the tampered copy reports it and exits 1
    assert TD.main([str(tmp_path)]) == 1


def test_drift_cli_exit_code_clean():
    r = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.analysis.proto_drift"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ok    ") == 5


def test_jobstatus_warnings_field_present():
    from ballista_tpu_torch.proto import ballista_pb2 as pb

    s = pb.JobStatus(warnings=["w"])
    assert list(pb.JobStatus.FromString(s.SerializeToString()).warnings) == ["w"]
