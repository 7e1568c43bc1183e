"""The port's ``repro_torch.obs`` tail: the trace CLI (the reference's
``test_cli_*`` cases, and every subcommand's output byte for byte equal
to the reference CLI's on the committed sample trace), and the profiling
wrappers on the CPU, with exactly the CPU's keys."""
import json
from pathlib import Path

import pytest
import torch

from repro.obs.__main__ import main as ref_cli
from repro_torch.obs import (STAGES, TraceCounter, profile_compile,
                             profile_maxplus)
from repro_torch.obs.__main__ import main as obs_cli

SAMPLE_TRACE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "sample_trace.json"
CPU_KEYS = {"compile_s", "traces", "argument_bytes", "output_bytes"}


def test_cli_summarize_committed_sample(capsys):
    assert SAMPLE_TRACE.is_file(), "committed sample trace missing"
    assert obs_cli(["summarize", str(SAMPLE_TRACE)]) == 0
    out = capsys.readouterr().out
    assert "route" in out and "share" in out
    assert "sim.records.count" in out


def test_cli_flamegraph_and_critical_path(capsys):
    assert obs_cli(["flamegraph", str(SAMPLE_TRACE), "--split",
                    "dtype"]) == 0
    out = capsys.readouterr().out
    assert "critical path" in out
    assert "global" in out and "local" in out


def test_cli_diff_self_is_zero(capsys):
    assert obs_cli(["diff", str(SAMPLE_TRACE), str(SAMPLE_TRACE)]) == 0
    out = capsys.readouterr().out
    assert "+0.0000" in out


def test_cli_summarize_json(capsys):
    assert obs_cli(["summarize", str(SAMPLE_TRACE), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc["stages"]["all"]) == set(STAGES)


@pytest.mark.parametrize("argv", [
    ["summarize", "{t}"],
    ["summarize", "{t}", "--json"],
    ["diff", "{t}", "{t}"],
    ["flamegraph", "{t}", "--split", "dtype"],
    ["flamegraph", "{t}", "--split", "none", "--width", "30"],
], ids=lambda a: " ".join(a[:1] + a[2:]))
def test_cli_output_equals_reference(capsys, argv):
    argv = [a.format(t=SAMPLE_TRACE) for a in argv]
    assert ref_cli(argv) == 0
    want = capsys.readouterr().out
    assert obs_cli(argv) == 0
    assert capsys.readouterr().out == want


def test_trace_counter_counts_calls():
    def add(a, b=1):
        return a + b
    c = TraceCounter(add)
    assert c.__name__ == "add" and c.traces == 0
    assert c(1) == 2 and c(1, b=5) == 6
    assert c.traces == 2


def test_profile_compile_cpu_keys():
    x = torch.ones(3, 4, dtype=torch.float64)
    y = torch.ones(4, dtype=torch.float32)
    out = profile_compile(lambda a, b, scale: (a * scale, [b, b]), x, y,
                          static_argnames=("scale",), scale=2.0)
    assert set(out) == CPU_KEYS
    assert out["traces"] == 1.0 and out["compile_s"] >= 0.0
    assert out["argument_bytes"] == 3 * 4 * 8 + 4 * 4
    assert out["output_bytes"] == 3 * 4 * 8 + 2 * 4 * 4


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_profile_maxplus_cpu(backend):
    out = profile_maxplus(n=96, rows=3, backend=backend, device="cpu")
    assert set(out) == CPU_KEYS | {"rows", "n"}
    assert (out["rows"], out["n"]) == (3.0, 96.0)
    assert out["argument_bytes"] == 2 * 3 * 96 * 8
    assert out["output_bytes"] == 3 * 96 * 8


def test_profile_maxplus_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        profile_maxplus(n=8, rows=1)
