"""Tests for repro_torch.analysis, the port of repro.analysis: every case
of the reference's ``test_static_analysis.py`` against the port (golden
fixtures, catalog, the historical bug classes, suppressions, EDK000,
the CLI, the mypy gate, and the port's own tree clean), then
differentials against the reference on the same inputs:

* every golden fixture under every rule gives the same findings;
* a scope mirror: the same seeded sources laid out once under
  ``src/repro/...`` for the reference and once under
  ``src/repro_torch/...`` for the port give the same findings, so a
  scope string left at the reference's path fails here;
* ``--list-rules`` prints the same catalog once ``repro_torch`` reads
  as ``repro``;
* ``python -m repro_torch.analysis`` runs with torch, numpy, jax and
  the reference made unimportable.
"""
from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import RULES as REF_RULES
from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis import RULES, analyze_paths
from repro_torch.analysis.__main__ import main as port_main

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "lint"
SRC_PORT = REPO / "src" / "repro_torch"
ANALYSIS_SRC = SRC_PORT / "analysis"


def _rule_findings(path, rule):
    return [f for f in analyze_paths([path], select={rule})
            if f.rule == rule]


def _fixture_cases():
    cases = []
    for ruledir in sorted(FIXTURES.iterdir()):
        rule = ruledir.name.upper()
        for f in sorted(ruledir.glob("*.py")):
            cases.append((rule, f, f.name.startswith("tp_")))
    return cases


FIXTURE_CASES = _fixture_cases()


def _as_reference(findings, root=None):
    """Findings as tuples in the reference's words: ``repro_torch`` read
    as ``repro`` in messages and, with ``root`` given, in paths taken
    relative to it."""
    out = []
    for f in findings:
        path = f.path
        if root is not None:
            path = Path(path).relative_to(root).as_posix().replace(
                "repro_torch/", "repro/")
        out.append((f.rule, f.severity, path, f.line, f.col,
                    f.message.replace("repro_torch", "repro")))
    return out


# ------------------------------------------------------------ golden fixtures
@pytest.mark.parametrize(
    "rule,path,positive", FIXTURE_CASES,
    ids=[f"{r}-{p.name}" for r, p, _ in FIXTURE_CASES])
def test_fixture(rule, path, positive):
    hits = _rule_findings(path, rule)
    if positive:
        assert hits, f"{path.name} must trigger {rule}"
        for f in hits:
            assert f.rule == rule
            assert f.path.endswith(path.name)
            assert f.line > 0 and f.message
    else:
        assert not hits, (f"{path.name} must stay clean for {rule}: "
                          f"{[f.format() for f in hits]}")


def test_every_rule_has_tp_and_nm_fixture():
    for rule in RULES:
        ruledir = FIXTURES / rule.lower()
        assert ruledir.is_dir(), f"missing fixture dir for {rule}"
        assert list(ruledir.glob("tp_*.py")), f"{rule} needs a tp_ fixture"
        assert list(ruledir.glob("nm_*.py")), f"{rule} needs an nm_ fixture"


def test_rule_catalog_shape():
    assert set(RULES) == {
        "EDK001", "EDK002", "EDK003", "EDK004",
        "EDK101", "EDK102", "EDK103", "EDK104",
        "EDK201", "EDK202", "EDK203", "EDK301"}
    for rule in RULES.values():
        assert rule.summary
        assert rule.severity in ("error", "warning")


def test_rule_catalog_equals_the_reference():
    assert set(RULES) == set(REF_RULES)
    for rid, rule in RULES.items():
        ref = REF_RULES[rid]
        assert rule.severity == ref.severity, rid
        assert rule.summary.replace("repro_torch", "repro") == ref.summary
        assert not re.search(r"\brepro[./]", rule.summary), rid
        if ref.scopes is None:
            assert rule.scopes is None, rid
        else:
            assert [s.replace("repro_torch/", "repro/")
                    for s in rule.scopes] == list(ref.scopes), rid
            assert all(s.startswith("repro_torch/") for s in rule.scopes)


def test_no_scope_string_names_the_reference_tree():
    for path in sorted(ANALYSIS_SRC.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"\brepro/", text), path


# ------------------------------------------------- the historical bug classes
@pytest.mark.parametrize("rule,fixture,needle", [
    ("EDK001", "tp_pr2_hash_seed.py", "hash()"),
    ("EDK203", "tp_pr5_resurrection.py", "revoke-on-put"),
], ids=["hash_seed_bug", "resurrection_bug"])
def test_historical_bug_fails_lint(rule, fixture, needle):
    """Re-introducing the process-salted arrival seeding, or removing
    the tombstone revoke-on-put, is caught."""
    hits = _rule_findings(FIXTURES / rule.lower() / fixture, rule)
    assert hits and needle in hits[0].message


# ------------------------------------------------------------- repo is clean
def test_src_repro_torch_is_clean():
    """The port's tree has zero findings."""
    findings = analyze_paths([SRC_PORT])
    assert findings == [], "\n".join(f.format() for f in findings)


# -------------------------------------------------------------- suppressions
def _analyze_source(tmp_path, source, select=None):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(source))
    return analyze_paths([f], select=select)


@pytest.mark.parametrize("src,select,expected", [
    ("""\
    def seed(gid):
        return hash(gid)  # lint: ignore[EDK001]
    """, {"EDK001"}, []),
    ("""\
    def seed(gid):
        # lint: ignore[EDK001]
        return hash(gid)
    """, {"EDK001"}, []),
    ("""\
    import random
    def seed(gid):
        return hash(gid) + random.random()  # lint: ignore[EDK001, EDK003]
    def roll():
        return random.random()  # lint: ignore
    """, None, []),
    ("""\
    import random
    def seed(gid):
        return hash(gid) + random.random()  # lint: ignore[EDK001]
    """, None, ["EDK003"]),
], ids=["trailing", "standalone_covers_next_line", "comma_list_and_bare",
        "rule_specific"])
def test_suppression(tmp_path, src, select, expected):
    hits = _analyze_source(tmp_path, src, select)
    assert [f.rule for f in hits] == expected
    ref = ref_analyze_paths([tmp_path / "mod.py"], select=select)
    assert _as_reference(hits) == _as_reference(ref)


def test_unparseable_file_reports_edk000(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def broken(:\n")
    hits = analyze_paths([f])
    assert [f.rule for f in hits] == ["EDK000"]
    assert "does not parse" in hits[0].message
    assert _as_reference(hits) == _as_reference(ref_analyze_paths([f]))


# ----------------------------------------------------------------------- CLI
def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_cli_clean_tree_exits_zero():
    proc = _run_cli("src/repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "repro_torch.analysis: clean"


def test_cli_default_path_is_the_port():
    proc = _run_cli("--select", "EDK301")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.analysis: clean" in proc.stdout


def test_cli_findings_exit_one_with_location():
    tp = "tests/fixtures/lint/edk001/tp_pr2_hash_seed.py"
    proc = _run_cli(tp)
    assert proc.returncode == 1
    assert "EDK001" in proc.stdout and "tp_pr2_hash_seed.py:" in proc.stdout


def test_cli_json_output():
    tp = "tests/fixtures/lint/edk203/tp_pr5_resurrection.py"
    proc = _run_cli(tp, "--json")
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload and payload[0]["rule"] == "EDK203"
    assert set(payload[0]) == {"rule", "severity", "path", "line", "col",
                               "message"}


def test_cli_select_filters_rules():
    tp = "tests/fixtures/lint/edk001/tp_pr2_hash_seed.py"
    proc = _run_cli(tp, "--select", "EDK002")
    assert proc.returncode == 0, proc.stdout


def test_cli_unknown_rule_is_usage_error():
    proc = _run_cli("src/repro_torch", "--select", "EDK999")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_cli_list_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rule in RULES:
        assert rule in proc.stdout


# -------------------------------------------------------------- mypy gate
def test_mypy_gate_layers_are_clean():
    """The type gate (mypy.ini) over repro_torch.core / repro_torch.fault
    / repro_torch.analysis; skips where mypy is not installed."""
    pytest.importorskip("mypy")
    env = dict(os.environ, MYPYPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "mypy", "--config-file", "mypy.ini",
         "-p", "repro_torch.core", "-p", "repro_torch.fault",
         "-p", "repro_torch.analysis"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------- differentials: golden fixtures
@pytest.mark.parametrize(
    "path", [p for _, p, _ in FIXTURE_CASES],
    ids=[f"{r}-{p.name}" for r, p, _ in FIXTURE_CASES])
def test_fixture_findings_equal_the_reference(path):
    """Each rule alone and the whole catalog, on one golden fixture:
    (rule, severity, path, line, col) equal, and the message once
    ``repro_torch`` reads as ``repro``."""
    for select in [{rid} for rid in sorted(RULES)] + [None]:
        got = _as_reference(analyze_paths([path], select=select))
        want = _as_reference(ref_analyze_paths([path], select=select))
        assert got == want, (path.name, select)


def test_fixture_tree_findings_equal_the_reference():
    """The whole fixture tree in one run (the project-wide passes see
    every fixture at once)."""
    got = analyze_paths([FIXTURES])
    assert got
    for f in got:
        assert not re.search(r"\brepro[./]", f.message), f.format()
    assert _as_reference(got) == _as_reference(ref_analyze_paths([FIXTURES]))


# ------------------------------------------------ differentials: scope mirror
def _mirror_sources(seed: int) -> dict:
    """Sources under the package-relative paths the scopes name, drawn
    from ``seed``: set iteration in ``core``/``fault`` (EDK002), wall
    clocks in ``sim``/``fault`` (EDK004 and EDK301), a jit-traced
    closure mutation and an unguarded float64 in ``kernels`` and the
    sweep engine (EDK101, EDK104), a raw clock in ``kernels`` (EDK301)
    and in ``obs`` (exempt), process-salted hashing and the global RNG
    anywhere (EDK001, EDK003), and one file outside every scope."""
    rng = random.Random(seed)
    attr = rng.choice(["_dead", "draining", "votes", "down", "members"])
    clock = rng.choice(["time.time", "time.monotonic", "time.perf_counter",
                        "time.perf_counter_ns"])
    n = rng.randint(1, 3)
    loops = "".join(
        f"        for m in self.{attr}:\n            out.append(m)\n"
        for _ in range(n))
    set_state = (f"class State:\n    def __init__(self):\n"
                 f"        self.{attr} = set()\n\n"
                 f"    def order(self):\n        out = []\n{loops}"
                 f"        return out, list(self.{attr})\n")
    reads = "".join(f"    t{i} = {clock}()\n" for i in range(n))
    wall = f"import time\n\n\ndef stamp():\n{reads}    return t0\n"
    traced = ("import jax\nimport jax.numpy as jnp\n\nLOG = []\n\n\n"
              "@jax.jit\ndef step(x):\n"
              + "".join(f"    LOG.append(x * {i})\n" for i in range(n))
              + "    return x.astype(jnp.float64)\n")
    draw = rng.choice(["random", "seed", "shuffle"])
    salted = ("import random\n\n\ndef seed(gid):\n"
              f"    return hash(gid) + random.{draw}()\n")
    files = {
        "core/state.py": set_state,
        "core/placement.py": salted,
        "fault/detector.py": set_state + "\n\n" + wall,
        "sim/events.py": wall,
        "sim/sweep.py": traced,
        "kernels/scan.py": traced + "\n\n" + wall,
        "obs/clock.py": wall,
        "models/outside.py": set_state + "\n\n" + traced,
    }
    return dict(sorted(files.items(), key=lambda kv: rng.random()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scope_mirror_equals_the_reference(tmp_path, seed):
    files = _mirror_sources(seed)
    for tree, package in (("ref", "repro"), ("port", "repro_torch")):
        for rel, source in files.items():
            f = tmp_path / tree / "src" / package / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(source)
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    want = _as_reference(ref_analyze_paths([ref_root / "src" / "repro"]),
                         root=ref_root)
    got = _as_reference(analyze_paths([port_root / "src" / "repro_torch"]),
                        root=port_root)
    assert got == want
    by_file: dict = {}
    for rule, _, path, *_ in got:
        by_file.setdefault(path.split("/", 2)[2], set()).add(rule)
    assert by_file["core/state.py"] == {"EDK002"}
    assert by_file["core/placement.py"] == {"EDK001", "EDK003"}
    assert by_file["fault/detector.py"] == {"EDK002", "EDK004", "EDK301"}
    assert by_file["sim/events.py"] == {"EDK004", "EDK301"}
    assert by_file["sim/sweep.py"] == {"EDK101", "EDK104"}
    assert by_file["kernels/scan.py"] == {"EDK101", "EDK104", "EDK301"}
    assert "obs/clock.py" not in by_file
    assert "models/outside.py" not in by_file


# --------------------------------------------------- differentials: the CLI
def test_list_rules_equals_the_reference(capsys):
    assert port_main(["--list-rules"]) == 0
    port = capsys.readouterr().out
    assert ref_main(["--list-rules"]) == 0
    ref = capsys.readouterr().out
    assert "repro_torch/core" in port and "EDK301" in port
    assert port.replace("repro_torch", "repro") == ref


@pytest.mark.parametrize("fixture", [
    "edk002/tp_set_iteration.py", "edk203/tp_pr5_resurrection.py",
    "edk301/nm_obs_walltime.py"])
def test_cli_runs_without_tensor_libraries(fixture, monkeypatch):
    """``python -m repro_torch.analysis`` with torch, numpy, jax and the
    reference unimportable gives the reference's findings."""
    monkeypatch.chdir(REPO)
    path = f"tests/fixtures/lint/{fixture}"
    code = ("import runpy, sys\n"
            "for m in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['repro_torch.analysis', {path!r}, '--json']\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    want = ref_analyze_paths([path])
    assert proc.returncode == (1 if want else 0), proc.stderr
    got = [(f["rule"], f["severity"], f["path"], f["line"], f["col"],
            f["message"].replace("repro_torch", "repro"))
           for f in json.loads(proc.stdout)]
    assert got == _as_reference(want)
