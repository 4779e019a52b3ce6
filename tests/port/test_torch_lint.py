"""The port's linter (photon_ml_tpu_torch/analysis) against the JAX
package's, and on the port itself.

(a) Parity: on every JAX fixture under tests/lint_fixtures/ and on
photon_ml_tpu/ itself (suppressions off, so the annotated sites count
too), the two linters give the same findings (rule, path, line, message)
for the rules whose logic the port keeps, and the same lock-order edges.
The port's PH012 knows torch's syncs instead of JAX's, so the fixture
findings that hang on a JAX call are listed in JAX_CALL_FINDINGS.
(b) Torch fixtures under tests/port/lint_fixtures/: one violation and one
near-miss for each of PH001, PH002, PH003, PH006 and PH012's torch calls,
and each finding's line suppression.
(c) photon_ml_tpu_torch/ lints with no new finding and no stale baseline
entry; its baseline holds PH001 only; the names the port gives
`locktrace.tracked` are the static graph's lock nodes.
(d) The CLI's exit codes and `--json` schema.

Each whole-tree lint runs once per test process (`port_lint`, shared
with the armed lock-order checks of test_torch_fleet.py and
test_torch_health.py).
"""
import functools
import json
import os
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from photon_ml_tpu.analysis import engine as jax_engine
from photon_ml_tpu.analysis.concurrency import lock_order_edges as jax_lock_order_edges
from photon_ml_tpu.analysis.rules import all_rules as jax_all_rules
from photon_ml_tpu_torch.analysis import engine
from photon_ml_tpu_torch.analysis.concurrency import lock_order_edges
from photon_ml_tpu_torch.analysis.lint import DEFAULT_BASELINE, main as lint_main
from photon_ml_tpu_torch.analysis.rules import all_rules

ROOT = Path(__file__).resolve().parents[2]
JAX_FIXTURES = ROOT / "tests" / "lint_fixtures"
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
JAX_PKG = ROOT / "photon_ml_tpu"
PORT_PKG = ROOT / "photon_ml_tpu_torch"
# the rules whose logic and messages the port keeps
PARITY = ["PH004", "PH005", "PH007", "PH008", "PH010-PH014"]
# JAX fixture findings that hang on a JAX call: the port's PH012 blocks on
# torch's host syncs, not on jax.device_get / jax.block_until_ready
JAX_CALL_FINDINGS = {("concurrency/ph012_violation.py", 18),
                     ("concurrency/ph012_violation.py", 19)}
JAX_FIXTURE_FILES = sorted(str(p.relative_to(JAX_FIXTURES))
                           for p in JAX_FIXTURES.rglob("*.py"))


def _key(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


@functools.lru_cache(maxsize=None)
def port_lint():
    """The port's findings and whole-program facts (classes, locks,
    lock-order edges) from one lint of the whole tree, once per test
    process."""
    return engine.lint_program([str(PORT_PKG)])


def port_lock_edges():
    """The port's static lock-acquisition-order graph."""
    return set(port_lint()[1].lock_edges)


# -- (a) parity with the JAX linter ------------------------------------------

@pytest.mark.parametrize("rel", JAX_FIXTURE_FILES)
def test_jax_fixture_parity(rel):
    path = str(JAX_FIXTURES / rel)
    jax = _key(jax_engine.lint_paths([path], select=PARITY))
    port = _key(engine.lint_paths([path], select=PARITY, package="photon_ml_tpu"))
    on_jax_calls = [k for k in jax if (rel, k[2]) in JAX_CALL_FINDINGS]
    assert len(on_jax_calls) == sum(r == rel for r, _ in JAX_CALL_FINDINGS)
    assert port == [k for k in jax if k not in on_jax_calls]
    assert lock_order_edges([path], package="photon_ml_tpu") \
        == jax_lock_order_edges([path])


def test_jax_package_parity(monkeypatch):
    """The JAX package with its suppressions off: both linters report the
    same annotated sites, and derive the same lock-order graph."""
    for mod in (jax_engine, engine):
        monkeypatch.setattr(mod.Suppressions, "suppressed",
                            lambda self, rule, line: False)
    jax = _key(jax_engine.lint_paths([str(JAX_PKG)], select=PARITY))
    port, program = engine.lint_program([str(JAX_PKG)], select=PARITY,
                                        package="photon_ml_tpu")
    assert _key(port) == jax
    assert {k[0] for k in jax} >= {"PH004", "PH008"}
    edges = set(program.lock_edges)
    assert edges == jax_lock_order_edges([str(JAX_PKG)]) and len(edges) >= 20


def test_rule_catalog_matches_the_jax_linter():
    ids = [r.rule_id for r in all_rules()]
    assert ids == [r.rule_id for r in jax_all_rules()]
    assert all(r.summary for r in all_rules())


# -- (b) torch fixtures -------------------------------------------------------

# (rule, violating fixture, compliant near-miss, finding count)
CASES = [
    ("PH001", "hot/ops/ph001_violation.py", "hot/ops/ph001_compliant.py", 10),
    ("PH002", "ph002_violation.py", "ph002_compliant.py", 5),
    ("PH003", "ph003_violation.py", "ph003_compliant.py", 2),
    ("PH006", "ph006_violation.py", "ph006_compliant.py", 3),
    ("PH012", "concurrency/ph012_violation.py",
     "concurrency/ph012_compliant.py", 5),
]
IDS = [c[0] for c in CASES]


def _lint(rel, rule, root=FIXTURES):
    return engine.lint_paths([str(root / rel)], select=[rule])


@pytest.mark.parametrize("rule,violation,compliant,count", CASES, ids=IDS)
def test_rule_fires_on_torch_violation(rule, violation, compliant, count):
    findings = _lint(violation, rule)
    assert [f.rule for f in findings] == [rule] * count
    assert all(f.line > 0 and f.col > 0 and f.text for f in findings)


@pytest.mark.parametrize("rule,violation,compliant,count", CASES, ids=IDS)
def test_rule_quiet_on_torch_near_miss(rule, violation, compliant, count):
    assert _lint(compliant, rule) == []


@pytest.mark.parametrize("rule,violation,compliant,count", CASES, ids=IDS)
def test_line_suppression_silences_each_torch_finding(rule, violation, compliant,
                                                     count, tmp_path):
    src = FIXTURES / violation
    lines = src.read_text().splitlines()
    for f in _lint(violation, rule):
        lines[f.line - 1] += f"  # photonlint: disable={rule}"
    dest = tmp_path / violation          # keeps the hot-path component
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text("\n".join(lines) + "\n")
    assert _lint(violation, rule, root=tmp_path) == []


def test_ph001_is_hot_path_scoped(tmp_path):
    shutil.copy(FIXTURES / "hot/ops/ph001_violation.py", tmp_path / "coldpath.py")
    assert _lint("coldpath.py", "PH001", root=tmp_path) == []


def test_torch_fixtures_are_quiet_to_the_jax_linter():
    """The JAX linter's rules of the same ids see none of torch's hazards:
    what the torch fixtures show is the port's own meaning."""
    for rule, violation, _, _ in CASES:
        assert jax_engine.lint_paths([str(FIXTURES / violation)], select=[rule]) == []


# -- (c) the port lints clean -------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    return port_lint()[0], engine.Baseline.load(DEFAULT_BASELINE)


def test_port_lints_clean_against_its_baseline(port_run):
    findings, baseline = port_run
    new, old, stale = baseline.split(findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == 0 and len(old) == baseline.total


def test_baseline_holds_host_syncs_only():
    entries = json.loads(Path(DEFAULT_BASELINE).read_text())["findings"]
    assert {e["rule"] for e in entries} <= {"PH001"}


def test_tracked_lock_names_are_static_lock_nodes():
    """Every `locktrace.tracked(..., name)` of the port names the lock it
    wraps as the static graph does ("Class._attr"), so observed orders and
    static edges speak of the same locks."""
    import ast
    nodes = {c.lock_node(a) for c in port_lint()[1].classes for a in c.locks}
    names = []
    for path in sorted(PORT_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
            for node in ast.walk(cls):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)):
                    continue
                for call in ast.walk(node.value):
                    if isinstance(call, ast.Call) \
                            and getattr(call.func, "attr", "") == "tracked":
                        name = call.args[1].value
                        assert name == f"{cls.name}.{node.targets[0].attr}", path
                        names.append(name)
    assert len(names) >= 20 and set(names) <= nodes


# -- (d) the command line -----------------------------------------------------

def test_cli_exit_codes_and_json_schema(capsys, tmp_path):
    bad = str(FIXTURES / "hot/ops/ph001_violation.py")
    assert lint_main([bad, "--no-baseline", "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["version"] == 1 and report["counts"] == {
        "new": 10, "baselined": 0, "stale_baseline_entries": 0}
    assert report["baseline"] == {"path": None, "total": 0}
    assert all(set(f) == {"rule", "path", "line", "col", "message", "text",
                          "baselined"} and f["rule"] == "PH001"
               for f in report["findings"])
    evidence = json.loads(_json_of([str(FIXTURES / "concurrency/ph012_violation.py"),
                                    "--no-baseline", "--select", "PH010-PH013",
                                    "--json"], capsys, rc=1))
    assert all(f["evidence"] for f in evidence["findings"])
    assert lint_main([str(FIXTURES / "hot/ops/ph001_compliant.py")]) == 0
    assert lint_main([bad, "--select", "PH01"]) == 0         # a prefix
    assert lint_main([bad, "--select", "PH001-PH002"]) == 1  # a range
    base = str(tmp_path / "baseline.json")
    assert lint_main([bad, "--baseline", base, "--write-baseline"]) == 0
    assert lint_main([bad, "--baseline", base]) == 0
    counts = json.loads(_json_of([str(FIXTURES / "hot/ops/ph001_compliant.py"),
                                  "--baseline", base, "--json"], capsys, rc=0))
    assert counts["counts"]["stale_baseline_entries"] == 10
    assert lint_main([str(tmp_path), "--diff", "HEAD"]) == 2  # not a repository
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == [r.rule_id for r in jax_all_rules()]


def _json_of(argv, capsys, rc):
    capsys.readouterr()
    assert lint_main(argv) == rc
    return capsys.readouterr().out


def test_the_linter_imports_no_torch():
    """The linter is host-only: its CLI starts without importing torch
    (the package root imports torch only where a device is resolved)."""
    code = ("import sys, photon_ml_tpu_torch.analysis.lint; "
            "sys.exit('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0


@pytest.mark.parametrize("module", ["photon_ml_tpu_torch.analysis",
                                    "photon_ml_tpu_torch.analysis.lint"])
def test_cli_module_entry_points(module, capsys, monkeypatch):
    """`python -m` of either module is the linter's CLI; over the port's
    hot-path modules it exits 0 with its baseline."""
    monkeypatch.setattr(sys, "argv", [module, "--json", "--select", "PH001",
                                      str(PORT_PKG / "game")])
    monkeypatch.delitem(sys.modules, module, raising=False)
    with pytest.raises(SystemExit) as stop:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    assert stop.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["new"] == 0 and report["counts"]["baselined"] == 2
