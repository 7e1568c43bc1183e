#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
and holds each against its plain PyTorch version on the card, and times
it: the max-plus scans at (1000, 8192), the SSD scan at the serve path's
own scans (mLSTM's numerator and denominator, and a strong decay that
must stay finite; ``y`` and the final state; each stage's time from
torch.profiler, the peak device memory of a call, and one request's
scans too), flash attention at the dense serve path's prefill (causal)
and decode (one query over the cache's valid prefix) shapes, paged
decode attention at stablelm-3b's decode and mixtral-8x7b's GQA shape
(timed; also against flash attention over the same tokens held
contiguously), granite-20b's MQA shape and pages of 16 and 12 tokens.
Then it drives the port's main paths through their entry points.  The
batched sweep engine, ``run_sweep``:

* open loop: the 64-point ``sweep_grid()``, checked <= 1e-9 per column
  against the same grid run by the port on the CPU (plain versions);
* closed loop ``fig_scale``: 100 groups x 100 threads, 100k ops, checked
  <= 1e-9 per column against the port's CPU run of the same point, and
  against the committed ``fig_scale`` rows of ``BENCH_sweep.json``;
* closed loop ``fig_scale_1m``: 1000 groups x 1000 threads = 1M clients,
  5M ops, checked against the committed ``fig_scale_1m`` rows.

The end of that path, ``figures``: the figure runners of
``repro_torch.sim.experiments`` at ``benchmarks/run.py``'s arguments.
``fig13_request_rate`` (two open-loop sweeps, two ``maxplus_chunked``
launches, checked), ``fig_sweep`` (one) and ``fig_scale(engine="sweep")``
(``maxplus_seq`` every round) run on the card, each held <= 1e-9 per
value to the same runner on the CPU and, within ``benchmarks/run.py
--check``'s band (5%), to its committed ``fig13.*``, ``fig_sweep.*`` and
``fig_scale.*`` rows of ``BENCH_sweep.json``.  ``fig_failover``,
``fig_handoff``, ``fig_scenarios`` (each on every engine its file has
rows for), ``fig_rebalance`` and ``fig_trace`` run in virtual time on
the host and are held key by key, in the same band, to the row dicts of
``BENCH_failover.json``, ``BENCH_handoff.json``, ``BENCH_scenarios.json``,
``BENCH_rebalance.json`` and ``BENCH_trace.json``.  Wall times are
printed and never checked.

The LLM serving path, ``repro_torch.launch.serve.serve``:

* ``serve_xlstm``: full-width xlstm-125m (random weights from seed 0,
  drawn on the card), 8 requests of 1024 tokens with a 256-token shared
  prefix, 32 generated tokens each, with the SSD kernel's launches
  checked per prefill, then the split of a warm prefill and decode step
  (per layer kind, and the device's busy share and kernel time by kind
  under torch.profiler);
* ``serve_stablelm``: full-width stablelm-3b (32 layers, 2.8B random
  weights drawn on the card), the same requests, with the flash kernel's
  launches checked (32 per prefill, 32 per decode step) and the same
  split (layers against the LM head, attention against the products);
* ``paged_stablelm``: the EdgeKV page pool's data plane at full width:
  the same stablelm-3b batch through ``prefill`` and 31 decode steps,
  its pages registered as ``serve`` registers them, each layer's KV
  cache scattered through the page tables into a 4096-slot pool (the
  shared prefix stored once), and the paged kernel's 32 launches (one a
  layer) each held against its plain version and flash attention over
  the contiguous copy;
* for each model, the card's serve run against a CPU run handed the
  card's weights, teacher-forced with the card's tokens, logits within
  ``LOGIT_TOL``: xlstm-125m whole at 2 requests x 256 tokens,
  stablelm-3b at full width cut to 2 layers, 2 requests x 128 tokens.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each path and read just after, and a path that never launched its
kernel fails.  The second-to-last line is a JSON object with each
kernel's numbers, the last ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the exit code is non-zero and no result line is
printed.  Without a GPU, or outside a checkout of the repository, it
exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks (NVIDIA data sheets, dense, no sparsity).  Device memory
# bytes/s; float64 and float32 operations/s outside the tensor cores; TF32
# operations/s on the tensor cores (logged beside K4's bound, not used in
# it).
PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, float64=25.6e12, float32=51.2e12,
                      tf32=378e12),
    "H100": dict(bytes=3.35e12, float64=34e12, float32=67e12, tf32=495e12),
}
# committed BENCH_sweep.json rows of the closed-loop paths -> the sweep
# column (and its scale) that reproduces each; walltime rows are host
# times and are not compared
ROW_COLUMNS = {"write_latency_ms": ("update_latency", 1e3),
               "global_write_latency_ms": ("update_global_latency", 1e3),
               "p95_latency_ms": ("p95_latency", 1e3),
               "p99_latency_ms": ("p99_latency", 1e3),
               "throughput_ops": ("throughput", 1.0)}
ROW_TOL = 0.01   # or half a unit of the row's last printed digit, if more
SWEEP_RTOL = 1e-9
# closed-loop paths: (name, groups, threads per group, ops per group,
# page-cache keys or None for the default), as benchmarks/run.py runs them
CLOSED_PATHS = (("fig_scale", 100, 100, 1000, None),
                ("fig_scale_1m", 1000, 1000, 5000, 10_000))
DEVICE = "cuda"
# the SSD kernel against its plain version: max |kernel - plain| <= tol *
# max(1, max |plain|), float32 sums over up to 384 terms in another order
SSD_TOL = 1e-4
# the card's serve logits against the CPU's: max |card - CPU| <= tol *
# max(1, max |CPU|), the bound the port's CPU tests hold it to against the
# reference and the GPU test to the CPU
LOGIT_TOL = 1e-4
# flash attention against its plain version: max |kernel - plain| <= tol
# * max(1, max |plain|), the reference kernel tests' own 2e-5 (float32
# sums over up to 1056 keys in another order)
FLASH_TOL = 2e-5
# the serving paths (full width) and the smaller CPU comparisons; a
# comparison's "layers" cuts the depth, keeping the width
SERVE = dict(arch="xlstm-125m", requests=8, prompt_len=1024,
             shared_prefix_len=256, gen_len=32, seed=0)
SERVE_DENSE = dict(SERVE, arch="stablelm-3b")
SERVE_VS_CPU = dict(arch="xlstm-125m", requests=2, prompt_len=256,
                    shared_prefix_len=64, gen_len=8, seed=0)
SERVE_DENSE_VS_CPU = dict(arch="stablelm-3b", layers=2, requests=2,
                          prompt_len=128, shared_prefix_len=32, gen_len=8,
                          seed=0)
# the paged kernel alone: 8 sequences of 1025 to 1055 tokens whose first
# 256 are a shared prefix, in a pool of 4096 slots (serve's); (case, query
# heads, KV heads, head width, page, timed).  stablelm-3b's decode and
# mixtral-8x7b's GQA attention are timed; granite-20b's MQA and two other
# pages are checked
PAGED_CASES = (("stablelm-3b", 32, 32, 80, 8, True),
               ("mixtral-8x7b GQA", 32, 8, 128, 8, True),
               ("granite-20b MQA", 48, 1, 128, 8, False),
               ("page 16", 32, 8, 128, 16, False),
               ("page 12", 32, 8, 128, 12, False))
PAGED_SLOTS, PAGED_SEQ, PAGED_SHARED = 4096, 1056, 256
# head widths at which the flash phase also times the prefill, beside
# stablelm-3b's 80
FLASH_WIDTHS = (72, 128)
# the figures path: repro_torch.sim.experiments' runners at the arguments
# benchmarks/run.py gives them.  Sweep-backed, on the card: (row family in
# BENCH_sweep.json, runner, arguments, its kernel, that kernel's launches
# or None for at least one)
SWEEP_FIGURES = (
    ("fig13", "fig13_request_rate",
     dict(rates=(100, 200, 400), duration=10.0), "maxplus_chunked", 2),
    ("fig_sweep", "fig_sweep", {}, "maxplus_chunked", 1),
    ("fig_scale", "fig_scale", dict(engine="sweep", ops_per_client=1000),
     "maxplus_seq", None),
)
# host-side virtual time: (runner, arguments, committed rows, the decimals
# run.py rounds their floats to); a runner taking ``engine`` runs once per
# engine the committed file has rows for
HOST_FIGURES = (
    ("fig_failover", dict(ops_per_client=1000), "BENCH_failover.json", 4),
    ("fig_handoff", dict(ops_per_client=1000), "BENCH_handoff.json", 4),
    ("fig_scenarios", dict(ops_per_client=1000), "BENCH_scenarios.json", 4),
    ("fig_rebalance", {}, "BENCH_rebalance.json", 4),
    ("fig_trace", dict(ops_per_client=1000), "BENCH_trace.json", 6),
)
# benchmarks/run.py --check's band: |got - committed| <= max(rtol |committed|,
# 1e-6); keys naming host-dependent numbers are printed, never checked
BENCH_RTOL = 0.05
UNGATED = ("walltime", "speedup", "_us", "per_device_scaling", "roofline",
           "kernel.", "compile")


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def peaks(name: str) -> dict:
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_ms(card: dict, nbytes: int, ops: int, dtype) -> tuple:
    """Least time for the work: bytes over the memory rate or operations
    over the arithmetic rate, whichever is larger."""
    import torch
    t_bytes = nbytes / card["bytes"] * 1e3
    peak = card["float64" if dtype == torch.float64 else "float32"]
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time per call of ``reps``
    back-to-back calls, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        per.append(e0.elapsed_time(e1) / reps)
    return statistics.median(per)


def scan_inputs(R: int, L: int, seed: int, dtype, device):
    """Seeded leader queues at about 80% load: exponential service times
    and sorted uniform arrivals over the span the service needs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    s = rng.exponential(1e-3, (R, L))
    a = np.sort(rng.random((R, L)), axis=1) * (L * 1.25e-3)
    return (torch.from_numpy(a).to(device=device, dtype=dtype),
            torch.from_numpy(s).to(device=device, dtype=dtype))


def rel_err(got, want) -> float:
    import torch
    g, w = got.double(), want.double()
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


def sweep_close(got, want, what: str) -> float:
    """``got`` within ``SWEEP_RTOL`` of ``want`` (relative, absolute below
    1), nan where ``want`` is nan; returns the largest error."""
    import numpy as np
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w)),
          f"{what}: shape or nan pattern differs")
    ok = ~np.isnan(w)
    err = float(np.max(np.abs(g[ok] - w[ok]) / np.maximum(1, np.abs(w[ok])),
                       initial=0.0))
    check(err <= SWEEP_RTOL, f"{what}: rel err {err}")
    return err


def columns_close(got, want, what: str) -> float:
    """Every column of sweep result ``got`` within ``SWEEP_RTOL`` of
    ``want``; returns the largest error."""
    check(set(got.columns) == set(want.columns), f"{what}: column names")
    return max(sweep_close(got.columns[k], w, f"{what} column {k}")
               for k, w in want.columns.items())


def is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def gated(key: str) -> bool:
    return not any(tag in key for tag in UNGATED)


def rows_close(got: list, want: list, what: str) -> float:
    """Figure rows ``got`` against ``want`` key by key: numbers within
    ``SWEEP_RTOL``, anything else equal; ungated keys skipped.  Returns
    the largest error."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(list(g) == list(w), f"{what} row {i}: keys differ")
        for k in filter(gated, w):
            if is_number(w[k]):
                worst = max(worst, sweep_close(g[k], w[k],
                                               f"{what} row {i} {k}"))
            else:
                check(g[k] == w[k], f"{what} row {i} {k}: {g[k]!r} vs "
                      f"{w[k]!r}")
    return worst


def committed_rows(family: str) -> dict:
    """``BENCH_sweep.json``'s rows of ``family`` (the name's first dotted
    part): each row's value under its name, and each ``key=value`` of its
    ``derived`` field under ``name:key``, as text."""
    rows = json.loads((ROOT / "BENCH_sweep.json").read_text())["rows"]
    found = {}
    for r in rows:
        if r["name"].partition(".")[0] != family:
            continue
        found[r["name"]] = r["value"]
        for kv in filter(None, r["derived"].split(";")):
            key, _, text = kv.partition("=")
            found[f"{r['name']}:{key}"] = text
    return found


def closed_path_rows(path: str) -> dict:
    """The committed rows of closed path ``path`` that a sweep column
    gives: metric -> (committed value, tolerance).  The p99 row rides in
    the p95 row's ``derived`` field as ``p99=...``."""
    found = {}
    for name, text in committed_rows(path).items():
        metric = name.partition(".")[2]
        metric = "p99_latency_ms" if metric.endswith(":p99") else metric
        if metric in ROW_COLUMNS:
            decimals = len(text.partition(".")[2])
            found[metric] = (float(text),
                             max(ROW_TOL, 0.5 * 10.0 ** -decimals))
    need = {"write_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "throughput_ops"}
    check(need <= set(found), f"BENCH_sweep.json lacks {path} rows "
          f"{sorted(need - set(found))}")
    return found


def in_band(got, want) -> tuple:
    """(within benchmarks/run.py --check's band, relative deviation)."""
    dev = abs(got - want)
    return (dev <= max(BENCH_RTOL * abs(want), 1e-6),
            dev / max(abs(want), 1e-12))


def sweep_figure_rows(family: str, rows: list) -> dict:
    """A sweep-backed figure's rows named as benchmarks/run.py writes them
    into BENCH_sweep.json (``name`` and ``name:key`` for a number of its
    ``derived`` field), unrounded."""
    out = {}
    if family == "fig13":
        for r in rows:
            n = f"fig13.latency_ms.{r['setting']}.r{r['rate']}"
            out.update({n: r["latency_ms"], f"{n}:p95": r["p95_ms"],
                        f"{n}:p99": r["p99_ms"]})
    elif family == "fig_sweep":
        for r in rows:
            if r["rate"] not in (200.0, 800.0) or r["groups"] != 3 \
                    or r["n_records"] != 10_000:
                continue
            n = (f"fig_sweep.latency_ms.g{int(100 * r['p_global'])}"
                 f".r{int(r['rate'])}")
            out.update({n: 1e3 * r["mean_latency"],
                        f"{n}:p95": 1e3 * r["p95_latency"],
                        f"{n}:p99": 1e3 * r["p99_latency"],
                        f"{n}:tput": r["throughput"]})
    else:
        (r,) = rows
        n = "fig_scale."
        out = {n + "write_latency_ms": r["write_latency_ms"],
               **{f"{n}write_latency_ms:{k}": r[k]
                  for k in ("groups", "clients", "ops", "mean_hops")},
               n + "global_write_latency_ms": r["global_write_latency_ms"],
               n + "p95_latency_ms": r["p95_latency_ms"],
               n + "p95_latency_ms:p99": r["p99_latency_ms"],
               n + "throughput_ops": r["throughput_ops"],
               n + "walltime_s": r["walltime_s"]}
    return out


def band_check(got: dict, committed: dict, what: str) -> tuple:
    """``got`` (name -> number) against ``committed`` (name -> text) in
    benchmarks/run.py --check's band, the same names on both sides;
    returns (gated names, names in band, largest relative deviation)."""
    check(set(got) == set(committed), f"{what}: row names differ from the "
          f"committed ones: {sorted(set(got) ^ set(committed))}")
    names = [n for n in committed if gated(n)]
    bands = {n: in_band(got[n], float(committed[n])) for n in names}
    return (len(names), sum(ok for ok, _ in bands.values()),
            max((d for _, d in bands.values()), default=0.0))


def host_rows_check(got: list, committed: list, decimals: int,
                    what: str) -> tuple:
    """Figure rows against their committed row dicts, key by key minus
    ungated keys, floats rounded as benchmarks/run.py rounds them:
    numbers in the --check band, anything else equal.  Returns (rows,
    rows in band, largest relative deviation)."""
    check(len(got) == len(committed),
          f"{what}: {len(got)} rows, {len(committed)} committed")
    ok_rows, worst = 0, 0.0
    for g, w in zip(got, committed):
        check(set(g) == set(w), f"{what}: row keys {sorted(set(g) ^ set(w))}")
        row_ok = True
        for k in filter(gated, w):
            v = round(g[k], decimals) if isinstance(g[k], float) else g[k]
            if is_number(w[k]):
                ok, dev = in_band(v, w[k])
                worst = max(worst, dev)
            else:
                ok = v == w[k]
            row_ok &= bool(ok)
        ok_rows += row_ok
    return len(committed), ok_rows, worst


def kernel_phase(card: dict, dev) -> dict:
    """Each kernel at (1000, 8192) in float64 and float32, with a ragged
    row length, a per-row init and (sequential kernel) resets: against
    its plain version on the card and a numpy float64 oracle; then timed
    beside its plain version, its bound and the library yardstick."""
    import numpy as np
    import torch
    from repro_torch.kernels.maxplus_scan import (
        maxplus_chunked, maxplus_chunked_ref, maxplus_depart_ref,
        maxplus_seq)
    from repro_torch.kernels.maxplus_scan.ops import _numpy

    R, L = 1000, 8192
    out = {}
    for name in ("maxplus_chunked", "maxplus_seq"):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            tag = str(dtype).replace("torch.", "")
            for case, (r, l) in (("full", (R, L)), ("ragged", (R, L - 37))):
                a, s = scan_inputs(r, l, 7, dtype, dev)
                init = torch.linspace(0.0, 2.0, r, dtype=dtype, device=dev)
                reset = torch.zeros((r, l), dtype=torch.bool, device=dev)
                reset[:, l // 3] = True
                oracle = torch.from_numpy(_numpy(
                    a.double().cpu().numpy(), s.double().cpu().numpy(),
                    None, None))
                variants = [("", {}), ("+init", {"init": init})]
                if name == "maxplus_seq":
                    variants.append(("+reset", {"reset": reset}))
                for suffix, kw in variants:
                    if name == "maxplus_chunked":
                        got = maxplus_chunked(a, s, kw.get("init"))
                        plain = maxplus_chunked_ref(a, s, kw.get("init"))
                        err = rel_err(got, plain)
                        check(err <= tol, f"{name} {tag} {case}{suffix}: "
                              f"rel err {err} > {tol}")
                    else:
                        got = maxplus_seq(a, s, **kw)
                        plain = maxplus_depart_ref(a, s, **kw)
                        err = float((got - plain).abs().max())
                        check(torch.equal(got, plain),
                              f"{name} {tag} {case}{suffix}: not bitwise "
                              f"equal to the plain version ({err})")
                    abs_err = float((got - plain).abs().max())
                    line = (f"{name} {tag} ({r}, {l}){suffix}: "
                            f"max_abs_err vs plain {abs_err:.3e}")
                    if not kw:
                        o_err = rel_err(got.cpu(), oracle)
                        check(o_err <= tol, f"{name} {tag} {case}: rel err "
                              f"vs numpy oracle {o_err} > {tol}")
                        line += f", rel err vs numpy float64 oracle {o_err:.3e}"
                    log(line)
                    if case == "full" and not kw:
                        out[(name, tag)] = dict(a=a, s=s,
                                                max_abs_err=abs_err)
    kernels = {}
    for name, wrapper, plain_fn, replaces in (
            ("maxplus_chunked", maxplus_chunked, maxplus_chunked_ref,
             "src/repro/kernels/maxplus_scan/kernel.py:58"),
            ("maxplus_seq", maxplus_seq, maxplus_depart_ref,
             "src/repro/kernels/maxplus_scan/ref.py:20")):
        for tag in ("float64", "float32"):
            c = out[(name, tag)]
            a, s = c["a"], c["s"]
            nbytes = 3 * a.numel() * a.element_size()
            b_ms, b_by = bound_ms(card, nbytes, 2 * a.numel(), a.dtype)
            ms = time_ms(lambda: wrapper(a, s))
            plain_ms = time_ms(lambda: plain_fn(a, s), reps=1, windows=3)
            lib_ms = None
            if name == "maxplus_chunked":
                # yardstick only (never called by the port): the closed
                # form as torch cumsum + cummax
                def lib():
                    S = torch.cumsum(s, dim=1)
                    return S + torch.cummax(a - (S - s), dim=1).values
                lib_ms = time_ms(lib)
            log(f"{name} {tag} ({R}, {L}): {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; {nbytes / ms / 1e9:.3f} TB/s achieved), plain "
                f"{plain_ms:.3f} ms, library "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            if name == "maxplus_seq":
                # one row alone: its time over L is the dependent chain's
                # cost a step, with no other row's bytes in the way
                a1, s1 = a[:1].contiguous(), s[:1].contiguous()
                check(torch.equal(wrapper(a1, s1), plain_fn(a1, s1)),
                      f"{name} {tag} one row: not bitwise equal")
                one_ms = time_ms(lambda: wrapper(a1, s1))
                log(f"{name} {tag} one row (1, {L}): {one_ms:.4f} ms, "
                    f"{one_ms * 1e6 / L:.3f} ns a chain step; the chain of "
                    f"{L} steps is {one_ms / ms:.1%} of the (1000, {L}) "
                    f"launch, the bytes' bound {b_ms / ms:.1%}")
            if tag == "float64":
                kernels[name] = dict(
                    name=name, route="cuda",
                    source=f"src/repro_torch/kernels/maxplus_scan/csrc/"
                           f"{name}.cu",
                    replaces=replaces, launches=0,
                    max_abs_err=c["max_abs_err"], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return kernels


def ssd_inputs(BH: int, S: int, P: int, N: int, seed: int, dev,
               decay=None):
    """Seeded scan inputs with the reference kernel tests'
    distributions: normal x, log decay -softplus(normal) (or ``decay``),
    sigmoid step, B and C normal / sqrt(N)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P))
    loga = (-np.logaddexp(0.0, rng.standard_normal((BH, S, 1)))
            if decay is None else np.full((BH, S, 1), decay))
    dt = 1.0 / (1.0 + np.exp(-rng.standard_normal((BH, S, 1))))
    Bm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    Cm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    return [torch.from_numpy(a).float().to(dev)
            for a in (x, loga, dt, Bm, Cm)]


def ssd_work(BH: int, S: int, P: int, N: int, Q: int, h0: bool) -> tuple:
    """(bytes, operations) the scan needs: every input read and every
    output written once, and the operations of whichever of the
    function's two forms needs fewer, two operations a multiply-add.
    Chunked, per chunk: the causal triangles (Q (Q + 1) / 2 entries) of
    C B^T (N deep) and of M (x dt) (P wide), C h (Q N P) and B^T (x dt)
    (N Q P).  Recurrent, per token: h a + B (x) (x dt) (3 N P) and C h
    (2 N P).  The numerator (P = N) is cheaper chunked, the denominator
    (P = 1) as the recurrence."""
    floats = BH * S * (2 * P + 2 * N + 2) + BH * N * P * (2 if h0 else 1)
    tri = Q * (Q + 1) // 2
    chunked = 2 * BH * (S // Q) * (tri * N + tri * P + 2 * Q * N * P)
    recurrent = BH * S * 5 * N * P
    return 4 * floats, min(chunked, recurrent)


# the SSD kernel's CUDA kernels, by a fragment of their names, and the
# stage each is
SSD_STAGES = (("ssd_intra", "intra"), ("ssd_states", "states"),
              ("ssd_pass", "pass"), ("ssd_out", "out"),
              ("ssd_vec_states", "vec_states"), ("ssd_vec_out", "vec_out"))


def stage_ms(fn, stages, calls: int = 5) -> dict:
    """Device ms a call of each stage of ``fn``, from torch.profiler over
    ``calls`` calls: ``stages`` maps a fragment of a CUDA kernel's name
    to its stage; kernels that match none are summed under "other"."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        stage = next((s for f, s in stages if f in e.name), "other")
        out[stage] = (out.get(stage, 0.0)
                      + e.time_range.elapsed_us() / 1e3 / calls)
    return out


def call_peak_mb(fn, dev) -> float:
    """Device memory one call of ``fn`` allocates above what is already
    allocated (its inputs), at its peak, in MB."""
    import torch
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    del out
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e6


def ssd_kernel_phase(card: dict, dev) -> dict:
    """The SSD kernel at the serve path's scans, BH = 8 requests x 4
    heads, S = 1024, N = 384, Q = 128: mLSTM's numerator (P = 384, from
    zero and from a random state) and denominator (P = 1), and a strong
    decay (60 nats a token) whose masked exponentials overflow; y and
    h_final against the plain chunked version on the same inputs, then
    timed beside it and its bound (and, for the numerator, whose
    products run in 3xTF32, the tensor cores' figure), with each stage's
    time from torch.profiler and the peak device memory of one call
    above its inputs; the numerator and denominator again at one
    request (BH 4)."""
    import torch
    from repro_torch.kernels.ssm_scan import ssd_chunked_ref, ssm_scan

    S, N, Q = 1024, 384, 128
    out = {}
    for case, BH, P, decay, with_h0 in (
            ("numerator", 32, 384, None, False),
            ("numerator+h0", 32, 384, None, True),
            ("denominator", 32, 1, None, False),
            ("strong-decay", 32, 384, -60.0, False),
            ("numerator, one request", 4, 384, None, False),
            ("denominator, one request", 4, 1, None, False)):
        args = ssd_inputs(BH, S, P, N, 3, dev, decay)
        h0 = (torch.randn((BH, N, P), generator=torch.Generator(
            dev).manual_seed(4), device=dev) if with_h0 else None)
        y, h = ssm_scan(*args, chunk=Q, h0=h0)
        py, ph = ssd_chunked_ref(*args, chunk=Q, h0=h0)
        errs = {}
        for what, got, want in (("y", y, py), ("h_final", h, ph)):
            check(bool(torch.isfinite(got).all()),
                  f"ssd {case}: {what} not finite")
            err = float((got - want).abs().max())
            bound = SSD_TOL * max(1.0, float(want.abs().max()))
            check(err <= bound, f"ssd {case}: {what} max_abs_err {err} > "
                  f"{bound}")
            errs[what] = err
        del y, h, py, ph
        line = (f"ssd_chunked {case} (BH {BH}, S {S}, P {P}, N {N}, Q {Q}):"
                f" max_abs_err vs plain y {errs['y']:.3e}, h_final "
                f"{errs['h_final']:.3e} (tol {SSD_TOL} x max(1, |plain|))")
        if "+h0" not in case and "strong" not in case:
            nbytes, ops = ssd_work(BH, S, P, N, Q, False)
            b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
            ms = time_ms(lambda: ssm_scan(*args, chunk=Q))
            plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=Q),
                               reps=1, windows=3)
            stages = stage_ms(lambda: ssm_scan(*args, chunk=Q), SSD_STAGES)
            peak = call_peak_mb(lambda: ssm_scan(*args, chunk=Q), dev)
            # P > 1 runs its products in 3xTF32: three TF32 passes of the
            # chunked form's operations; P = 1 runs the recurrence on the
            # CUDA cores
            tc_ms = 3 * ops / card["tf32"] * 1e3 if P > 1 else None
            line += (f"; {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                     f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
                     f"{ops / ms / 1e9:.2f} TFLOP/s, "
                     f"{nbytes / ms / 1e9:.3f} TB/s achieved), "
                     + (f"3xTF32 on the tensor cores {tc_ms:.4f} ms (3 x "
                        f"ops at {card['tf32'] / 1e12:.0f} TFLOP/s)"
                        if tc_ms is not None else
                        "the recurrence on the CUDA cores")
                     + f", plain {plain_ms:.3f} ms (kernel / plain "
                     f"{ms / plain_ms:.3f}), library - (no torch call "
                     f"computes the SSD scan); peak device memory of one "
                     f"call {peak:.1f} MB above its inputs; by stage "
                     f"(torch.profiler, ms a call) "
                     + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
            out[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=max(errs.values()),
                             peak_mb=peak, stages_ms=stages)
        log(line)
        del args, h0
    num, den = out["numerator"], out["denominator"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "peak_mb", "stages_ms")
    return dict(
        name="ssd_chunked", route="cuda",
        source="src/repro_torch/kernels/ssm_scan/csrc/ssd_chunked.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:68", launches=0,
        max_abs_err=num["max_abs_err"], ms=num["ms"],
        plain_ms=num["plain_ms"], bound_ms=num["bound_ms"],
        bound_by=num["bound_by"], library_ms=None,
        peak_mb=num["peak_mb"], stages_ms=num["stages_ms"],
        denominator={k: den[k] for k in keys},
        one_request={what: {k: out[f"{what}, one request"][k] for k in keys}
                     for what in ("numerator", "denominator")})


def flash_work(B: int, Sq: int, H: int, K: int, hd: int, kv_len: int,
               causal: bool) -> tuple:
    """(bytes, operations) one attention call needs: q read and o written
    once, the valid K and V (keys below ``kv_len``) read once, and two
    operations a multiply-add for q k^T and p v over the visible (query,
    key) pairs only (the causal triangle when causal)."""
    pairs = (sum(min(i + 1, kv_len) for i in range(Sq)) if causal
             else Sq * kv_len)
    floats = 2 * B * Sq * H * hd + 2 * B * kv_len * K * hd
    return 4 * floats, 4 * B * H * pairs * hd


def flash_kernel_phase(card: dict, dev) -> dict:
    """The flash kernel at the dense serve path's shapes, stablelm-3b's 32
    heads of 80 for 8 requests: prefill (1024 tokens, causal) and decode
    (one query over a 1056-slot cache whose valid length, a device
    int32, is 1025 and 1055); against the plain chunked version and the
    naive oracle on the same inputs, then timed beside the plain version,
    its bound and torch's scaled_dot_product_attention (float32, the
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_chunked_ref, flash_attention_ref, flash_fwd)

    B, S, H, hd, S_max = 8, 1024, 32, 80, 1056
    gen = torch.Generator(dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def fold(t):                     # (B, S, H, hd) -> (B * H, S, hd)
        return t.transpose(1, 2).reshape(B * H, t.shape[1], t.shape[-1])

    q, k, v = randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd)
    q1, kc, vc = randn(B, 1, H, hd), randn(B, S_max, H, hd), randn(
        B, S_max, H, hd)
    cases = {"prefill": (lambda: flash_fwd(q, k, v, causal=True),
                         (q, k, v), dict(causal=True), S, True)}
    for n in (S + 1, S_max - 1):
        n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
        cases[f"decode kv_len {n}"] = (
            lambda n_dev=n_dev: flash_fwd(q1, kc, vc, causal=False,
                                          kv_len=n_dev),
            (q1, kc, vc), dict(causal=False, seq_k=n_dev), n, False)
    out = {}
    for case, (run, (a, b, c), kw, kv_len, causal) in cases.items():
        got = fold(run())
        check(bool(torch.isfinite(got).all()), f"flash {case}: not finite")
        folded = [fold(t) for t in (a, b, c)]
        errs = {}
        for what, plain_fn in (("plain", flash_attention_chunked_ref),
                               ("naive", flash_attention_ref)):
            want = plain_fn(*folded, **kw)
            err = float((got - want).abs().max())
            bound = FLASH_TOL * max(1.0, float(want.abs().max()))
            check(err <= bound, f"flash {case}: max_abs_err vs {what} {err}"
                  f" > {bound}")
            errs[what] = err
        del want, got
        nbytes, ops = flash_work(B, a.shape[1], H, H, hd, kv_len, causal)
        b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: flash_attention_chunked_ref(*folded, **kw),
                           reps=1, windows=3)
        qt = a.transpose(1, 2)
        kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (b, c))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        # the tile configuration's products run in 3xTF32: three TF32
        # passes of the same operations on the tensor cores
        tc_ms = 3 * ops / card["tf32"] * 1e3
        log(f"flash_fwd {case} (B {B}, Sq {a.shape[1]}, Skv {b.shape[1]}, "
            f"H {H}, hd {hd}): max_abs_err vs plain {errs['plain']:.3e}, "
            f"vs naive {errs['naive']:.3e} (tol {FLASH_TOL} x max(1, "
            f"|plain|)); {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"{ops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s "
            f"achieved), 3xTF32 on the tensor cores {tc_ms:.4f} ms "
            f"(3 x ops at {card['tf32'] / 1e12:.0f} TFLOP/s), plain "
            f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms "
            f"(scaled_dot_product_attention, float32); kernel / library "
            f"{ms / lib_ms:.3f}")
        out[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=errs["plain"],
                         library_ms=lib_ms)
    # the prefill at other head widths, outside the main path: 72 is
    # zero-filled to the 80-wide instance, 128 takes 64 queries a CTA
    for w in FLASH_WIDTHS:
        qw, kw, vw = randn(B, S, H, w), randn(B, S, H, w), randn(B, S, H, w)
        got = fold(flash_fwd(qw, kw, vw, causal=True))
        want = flash_attention_chunked_ref(fold(qw), fold(kw), fold(vw),
                                           causal=True)
        err = float((got - want).abs().max())
        bound = FLASH_TOL * max(1.0, float(want.abs().max()))
        check(err <= bound, f"flash prefill hd {w}: max_abs_err {err} > "
              f"{bound}")
        del got, want
        nbytes, ops = flash_work(B, S, H, H, w, S, True)
        b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
        ms = time_ms(lambda: flash_fwd(qw, kw, vw, causal=True))
        qt, kt, vt = (t.transpose(1, 2) for t in (qw, kw, vw))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        log(f"flash_fwd prefill at hd {w} (B {B}, S {S}, H {H}): "
            f"max_abs_err vs plain {err:.3e}; {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), 3xTF32 on the tensor cores "
            f"{3 * ops / card['tf32'] * 1e3:.4f} ms, library {lib_ms:.4f} "
            f"ms; kernel / library {ms / lib_ms:.3f}")
    pre, dec = out["prefill"], out[f"decode kv_len {S + 1}"]
    return dict(
        name="flash_fwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        launches=0, **pre, decode=dec)


def paged_tables(B: int, page: int, rng) -> tuple:
    """Seeded page tables and lengths: (B, P_max) int32 slots of a
    ``PAGED_SLOTS`` pool, the first ``PAGED_SHARED // page`` pages shared
    by every sequence and the rest each sequence's own, lengths in [1025,
    1055]; entries of pages past a length hold no pool slot (-1 or N + 5),
    so a kernel that read one would fault."""
    import numpy as np
    P_max = -(-PAGED_SEQ // page)
    shared = PAGED_SHARED // page
    own = P_max - shared
    slots = rng.permutation(PAGED_SLOTS)
    table = np.empty((B, P_max), np.int32)
    table[:, :shared] = slots[:shared]
    table[:, shared:] = slots[shared:shared + B * own].reshape(B, own)
    lengths = rng.integers(1025, PAGED_SEQ, B).astype(np.int32)
    for b, n in enumerate(-(-lengths // page)):
        table[b, n:] = np.where(np.arange(P_max - n) % 2, -1,
                                PAGED_SLOTS + 5)
    return table, lengths


def paged_work(table, lengths, page: int, H: int, K: int, hd: int) -> tuple:
    """(bytes, operations) one paged decode needs: the K and V of every
    unique pool page that a valid position touches (a shared page counted
    once), q and o, the table and the lengths; two operations a
    multiply-add for q k and p v over the valid positions."""
    import numpy as np
    B = len(lengths)
    used = np.unique(np.concatenate([table[b, :-(-int(n) // page)]
                                     for b, n in enumerate(lengths)]))
    floats = 2 * len(used) * page * hd * K + 2 * B * H * hd
    return (4 * floats + table.nbytes + lengths.nbytes,
            4 * int(lengths.sum()) * H * hd)


def flash_over_pages(q, k_pages, v_pages, table, lengths):
    """K4 in decode over the tokens the table names, gathered into a
    contiguous (B, P_max page, K, hd) cache: one call a sequence (K4
    takes one valid length, a device int32).  Returns a callable that
    runs the calls on the gathered copy and gives (B, K, G, hd)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         safe_table)
    B, K, G, hd = q.shape
    safe = safe_table(table, lengths, k_pages.shape[2], k_pages.shape[1])
    kc, vc = (gather_pages(t, safe).transpose(1, 2).contiguous()
              for t in (k_pages, v_pages))
    q4 = q.reshape(B, 1, K * G, hd)

    def run():
        return torch.cat([flash_fwd(q4[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                    causal=False, kv_len=lengths[b:b + 1])
                          for b in range(B)]).reshape(B, K, G, hd)
    return run


def paged_kernel_phase(card: dict, dev) -> dict:
    """The paged kernel over ``PAGED_CASES``, 8 sequences each: against
    its plain page-by-page version and the gather oracle, and against K4
    over the same tokens gathered contiguously, all within ``FLASH_TOL``
    scaled; the timed cases beside their byte bound, the plain version
    and K4 over the contiguous copy (no torch call reads through a page
    table, so there is no library time)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.kernels.paged_attention import (
        paged_attention_online_ref, paged_attention_ref, paged_decode)

    B = 8
    out = {}
    for case, H, K, hd, page, timed in PAGED_CASES:
        rng = np.random.default_rng(17 + hd + page)
        table, lengths = paged_tables(B, page, rng)
        gen = torch.Generator(dev).manual_seed(hd + page)
        q = torch.randn((B, K, H // K, hd), generator=gen, device=dev)
        kp, vp = (torch.randn((K, PAGED_SLOTS, page, hd), generator=gen,
                              device=dev) for _ in range(2))
        pt = torch.from_numpy(table).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        run = lambda: paged_decode(q, kp, vp, pt, ln)
        got = run()
        check(bool(torch.isfinite(got).all()), f"paged {case}: not finite")
        flash_before = flash_fwd.launches
        k4 = flash_over_pages(q, kp, vp, pt, ln)
        errs = {}
        for what, want in (
                ("plain", paged_attention_online_ref(q, kp, vp, pt, ln)),
                ("oracle", paged_attention_ref(q, kp, vp, pt, ln)),
                ("K4 contiguous", k4())):
            err = float((got - want).abs().max())
            bound = FLASH_TOL * max(1.0, float(want.abs().max()))
            check(err <= bound, f"paged {case}: max_abs_err vs {what} {err} "
                  f"> {bound}")
            errs[what] = err
        line = (f"paged_decode {case} (B {B}, H {H}, K {K}, hd {hd}, page "
                f"{page}, P_max {table.shape[1]}, lengths {lengths.min()}.."
                f"{lengths.max()}, {PAGED_SHARED // page} shared pages): "
                f"max_abs_err vs plain {errs['plain']:.3e}, vs oracle "
                f"{errs['oracle']:.3e}, vs K4 contiguous "
                f"{errs['K4 contiguous']:.3e} (tol {FLASH_TOL} x max(1, "
                f"|plain|))")
        if timed:
            nbytes, ops = paged_work(table, lengths, page, H, K, hd)
            b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
            ms = time_ms(run)
            plain_ms = time_ms(lambda: paged_attention_online_ref(
                q, kp, vp, pt, ln), reps=1, windows=3)
            k4_ms = time_ms(k4)
            line += (f"; {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                     f"{nbytes / 1e6:.1f} MB of unique pages, "
                     f"{ops / 1e9:.3f} GFLOP; {nbytes / ms / 1e9:.3f} TB/s "
                     f"achieved), plain {plain_ms:.3f} ms, K4 over the "
                     f"contiguous copy ({B} calls) {k4_ms:.4f} ms, library "
                     f"- (no torch call reads through a page table)")
            out[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=errs["plain"],
                             k4_contiguous_ms=k4_ms)
        flash_fwd.launches = flash_before   # comparisons are not the path's
        log(line)
        del q, kp, vp, k4
        torch.cuda.empty_cache()
    sl, gqa = out["stablelm-3b"], out["mixtral-8x7b GQA"]
    return dict(
        name="paged_decode", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:70",
        launches=0, library_ms=None, **sl, gqa=gqa)


def paged_stablelm(dev, spec: dict) -> dict:
    """The EdgeKV page pool's data plane at full width: stablelm-3b (seed
    0, drawn on the card) serves ``spec``'s batch through the public
    ``prefill`` and ``decode_step`` as ``serve`` does; the pool registers
    its pages as ``serve`` does (``page_requests``); each layer's KV
    cache is scattered through those tables into (K, 4096, page, hd)
    pools, the shared prefix's pages from request 0 alone, and the paged
    kernel decodes numpy-seeded queries over it with ragged lengths: one
    launch a layer, each held against the plain version and K4 over the
    contiguous copy gathered through the same tables."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_online_ref)
    from repro_torch.launch.serve import page_requests
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config(spec["arch"])
    B, S, G = spec["requests"], spec["prompt_len"], spec["gen_len"]
    page = 8                                    # serve's default
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, spec["seed"], device=dev)
    prompts, pool = page_requests(
        cfg.vocab_size, requests=B, prompt_len=S, gen_len=G,
        shared_prefix_len=spec["shared_prefix_len"], page_size=page,
        seed=spec["seed"])
    logits, cache = prefill(params, cfg,
                            torch.as_tensor(prompts, device=dev).long(),
                            max_len=S + G)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    del logits
    for _ in range(G - 1):
        lg, cache = decode_step(params, cfg, cache, tok)
        tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    del params, lg
    torch.cuda.empty_cache()
    L, _, S_max, K, hd = cache["k"].shape
    H = cfg.n_heads
    n_valid = int(cache["len"])
    P_max = S_max // page
    shared = spec["shared_prefix_len"] // page
    table = np.stack([pool.page_table(f"req{i}", P_max) for i in range(B)])
    check(np.all(table[:, :shared] == table[0, :shared])
          and len(np.unique(table[:, shared:])) == B * (P_max - shared)
          and pool.used_slots == shared + B * (P_max - shared),
          f"paged_stablelm: pool tables {pool.stats}")
    # every (request, page) written once: the shared pages from request 0
    bs, js = np.nonzero((np.arange(B)[:, None] == 0)
                        | (np.arange(P_max)[None, :] >= shared))
    src_b, src_j = (torch.from_numpy(a).to(dev) for a in (bs, js))
    dst = torch.from_numpy(table[bs, js].astype(np.int64)).to(dev)
    pools = {n: torch.zeros((K, PAGED_SLOTS, page, hd), device=dev)
             for n in ("k", "v")}
    rng = np.random.default_rng(16)
    lengths = rng.integers(S + 1, n_valid + 1, B).astype(np.int32)
    pt = torch.from_numpy(table).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    prefix = spec["shared_prefix_len"]
    prefix_diff = max(float((cache[n][:, :, :prefix]
                             - cache[n][:, :1, :prefix]).abs().max())
                      for n in ("k", "v"))
    errs = {"plain": 0.0, "K4 contiguous": 0.0}
    scale = 0.0
    for layer in range(L):
        for n, pl in pools.items():
            # (B, S_max, K, hd) -> (K, B, P_max, page, hd), into the pool
            c = cache[n][layer].reshape(B, P_max, page, K, hd).permute(
                3, 0, 1, 2, 4)
            pl[:, dst] = c[:, src_b, src_j]
        q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
            np.float32)).to(dev)
        got = paged_attention(q, pools["k"], pools["v"], pt, ln)
        check(bool(torch.isfinite(got).all()),
              f"paged_stablelm layer {layer}: not finite")
        qg = q.reshape(B, K, H // K, hd)
        flash_before = flash_fwd.launches
        for what, want in (
                ("plain", paged_attention_online_ref(
                    qg, pools["k"], pools["v"], pt, ln).reshape(B, H, hd)),
                ("K4 contiguous", flash_over_pages(
                    qg, pools["k"], pools["v"], pt, ln)().reshape(B, H, hd))):
            err = float((got - want).abs().max())
            bound = FLASH_TOL * max(1.0, float(want.abs().max()))
            check(err <= bound, f"paged_stablelm layer {layer}: max_abs_err "
                  f"vs {what} {err} > {bound}")
            errs[what] = max(errs[what], err)
            scale = max(scale, float(want.abs().max()))
        flash_fwd.launches = flash_before   # comparisons are not the path's
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"paged_stablelm: {cfg.name} at full width ({L} layers, {H} heads "
        f"of {hd}), {B} requests x {S} prompt tokens (shared prefix "
        f"{prefix}) + {G - 1} decode steps in {served_s:.3f} s (weights "
        f"drawn, prefill, decode); cache {tuple(cache['k'].shape)} with "
        f"{n_valid} valid tokens; pool {pool.used_slots} of {PAGED_SLOTS} "
        f"slots ({shared} shared prefix pages stored once, "
        f"{pool.stats['dedup_hits']} dedup hits); the shared prefix's K/V "
        f"in the {B} requests' own cache rows differ by at most "
        f"{prefix_diff:.3e}; {L} paged launches over lengths "
        f"{lengths.min()}..{lengths.max()}: max_abs_err vs plain "
        f"{errs['plain']:.3e}, vs K4 over the contiguous copy "
        f"{errs['K4 contiguous']:.3e} (tol {FLASH_TOL} x max(1, |want|), "
        f"|want| up to {scale:.3f}); peak device memory {peak:.3f} GiB")
    return dict(peak_gib=peak, errs=errs, prefix_diff=prefix_diff)


# kernel name fragment -> the kind the time splits report it under
KERNEL_KINDS = (("flash_", "flash_fwd"), ("ssd_", "ssd_chunked"),
                ("maxplus_chunked", "maxplus_chunked"),
                ("maxplus_seq", "maxplus_seq"),
                ("gemm", "products"), ("xmma", "products"))


def device_busy(fn) -> tuple:
    """(device busy ms, kernels, busy ms by kind) of one call of ``fn``
    under torch.profiler: the summed durations of the CUDA kernels it ran
    (one stream, so they do not overlap); (None, 0, {}) if the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None, 0, {}
    kinds: dict = {}
    for e in kern:
        kind = next((k for frag, k in KERNEL_KINDS
                     if frag in e.name.lower()), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(kinds.values()), len(kern), kinds


def serve_breakdown(dev, spec: dict, groups: dict, kernel: str) -> dict:
    """Where a warm prefill and a warm decode step of ``spec``'s shape go:
    host wall per group of layers (``groups``: name -> the model's layer
    list; synchronized forward hooks), the rest (embedding, final norm,
    LM head), the launches of ``kernel`` per call, and the device's busy
    share and kernel time by kind from torch.profiler.  Random weights
    from the spec's seed, drawn on the card, and random prompt tokens,
    as serve."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import KERNELS
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config(spec["arch"])
    params = init_params(cfg, spec["seed"], device=dev)
    B, S = spec["requests"], spec["prompt_len"]
    toks = torch.randint(1, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    max_len = S + spec["gen_len"]
    logits, cache = prefill(params, cfg, toks, max_len=max_len)  # warm-up
    tok = logits[:, -1].argmax(-1, keepdim=True)
    del logits
    spent = {g: 0.0 for g in groups}
    started = {}

    def pre(mod, args):
        torch.cuda.synchronize()
        started[mod] = time.perf_counter()

    def post(group):
        def hook(mod, args, out):
            torch.cuda.synchronize()
            spent[group] += time.perf_counter() - started[mod]
        return hook

    hooks = []
    for group, attr in groups.items():
        for mod in getattr(params, attr):
            hooks += [mod.register_forward_pre_hook(pre),
                      mod.register_forward_hook(post(group))]
    wrapper = KERNELS[kernel]
    wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, cfg, toks, max_len=max_len)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    out = dict(prefill_s=total, groups=spent,
               prefill_launches=wrapper.launches)
    decode_step(params, cfg, cache, tok)                   # warm-up
    torch.cuda.synchronize()
    wrapper.launches = 0
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    out["decode_step_s"] = (time.perf_counter() - t0) / steps
    out["decode_launches"] = wrapper.launches / steps
    for what, fn in (("prefill",
                      lambda: prefill(params, cfg, toks, max_len=max_len)),
                     ("decode", lambda: decode_step(params, cfg, cache,
                                                    tok))):
        t0 = time.perf_counter()
        (out[f"{what}_busy_ms"], out[f"{what}_kernels"],
         out[f"{what}_kinds"]) = device_busy(fn)
        out[f"{what}_traced_s"] = time.perf_counter() - t0
    return out


def log_breakdown(path: str, bd: dict) -> None:
    parts = [f"{g} {t:.4f} s ({t / bd['prefill_s']:.1%})"
             for g, t in bd["groups"].items()]
    rest = bd["prefill_s"] - sum(bd["groups"].values())
    log(f"{path} warm prefill {bd['prefill_s']:.4f} s: " + ", ".join(parts)
        + f", embedding, final norm and LM head {rest:.4f} s "
        f"({rest / bd['prefill_s']:.1%}); kernel launches "
        f"{bd['prefill_launches']} a prefill; warm decode step "
        f"{bd['decode_step_s'] * 1e3:.3f} ms, kernel launches "
        f"{bd['decode_launches']:g} a step")
    # the profiler slows the host many times over, not the kernels: the
    # busy share is taken against the untraced warm wall time
    for what, wall in (("prefill", bd["prefill_s"]),
                       ("decode", bd["decode_step_s"])):
        busy, n = bd[f"{what}_busy_ms"], bd[f"{what}_kernels"]
        wall *= 1e3
        log(f"{path} {what} under torch.profiler: "
            + ("device busy not measured (the profiler saw no kernels)"
               if busy is None else
               f"{n} kernels, device busy {busy:.3f} ms against "
               f"{wall:.3f} ms of untraced warm wall: the device idles "
               f"{1 - busy / wall:.1%} (traced wall "
               f"{bd[f'{what}_traced_s'] * 1e3:.3f} ms); busy by kind "
               + ", ".join(f"{k} {t:.3f} ms ({t / busy:.1%})" for k, t in
                           sorted(bd[f"{what}_kinds"].items(),
                                  key=lambda kv: -kv[1]))))


def serve_path(dev, spec: dict, kernel: str, per_prefill: int,
               per_step: int) -> dict:
    """Serve ``spec`` at full width on the card and check what comes out:
    token and logit shapes, finite logits, greedy tokens, the page pool,
    and ``kernel``'s launches, ``per_prefill`` in the prefill and
    ``per_step`` in each decode step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve(device=dev, **spec)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cfg = get_config(spec["arch"])
    B, G = spec["requests"], spec["gen_len"]
    name = f"serve_{spec['arch'].split('-')[0]}"
    want = {"prefill": per_prefill, "decode": per_step * (G - 1)}
    check(res["launches"][kernel] == want,
          f"{name}: {kernel} launches {res['launches'][kernel]}, expected "
          f"{want}")
    check(res["tokens"].shape == (B, G), f"{name}: token shape")
    check(res["logits"].shape == (B, G, cfg.vocab_size),
          f"{name}: logit shape")
    check(bool(np.isfinite(res["logits"]).all()),
          f"{name}: logits not finite")
    check(np.array_equal(res["tokens"], res["logits"].argmax(-1)),
          f"{name}: tokens are not the argmax of their logits")
    # the shared prefix's pages (serve's default 8 tokens a page) are
    # stored once and every later request hits them; each request also
    # holds its own local pages
    pages = spec["shared_prefix_len"] // 8
    local = (spec["prompt_len"] - spec["shared_prefix_len"] + G + 7) // 8
    check(res["pool"]["dedup_hits"] == (B - 1) * pages
          and res["pool"]["slots_used"] == pages + B * local,
          f"{name}: page pool {res['pool']}")
    log(f"{name}: {B} requests x {spec['prompt_len']} prompt tokens "
        f"(shared prefix {spec['shared_prefix_len']}) + {G} generated; "
        f"prefill {res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s "
        f"({G - 1} steps, {res['decode_s'] / (G - 1) * 1e3:.3f} ms each), "
        f"{res['tok_per_s']:.1f} tok/s; peak device memory {peak:.3f} GiB; "
        f"{kernel} launches {res['launches'][kernel]} (expected {want}); "
        f"pool {res['pool']}; generated[0][:8] "
        f"{res['tokens'][0][:8].tolist()}")
    return res


def serve_vs_cpu(dev, spec: dict) -> None:
    """The card's serve run against a CPU run handed the card's weights
    and fed the card's tokens: logits within ``LOGIT_TOL``.  Also reads
    (does not check) the same comparison with TF32 matrix products, which
    the serve path leaves off."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params
    kw = dict(spec)
    cfg = get_config(kw.pop("arch"))
    if "layers" in kw:
        cfg = dataclasses.replace(cfg, n_layers=kw.pop("layers"))
    model = init_params(cfg, kw["seed"], device=dev)
    gpu = serve(device=dev, params=model, **kw)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = serve(device=dev, params=model, teacher_tokens=gpu["tokens"],
                     **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    t0 = time.perf_counter()
    cpu = serve(device="cpu", params=model.cpu(),
                teacher_tokens=gpu["tokens"], **kw)
    err = float(np.max(np.abs(gpu["logits"] - cpu["logits"])))
    bound = LOGIT_TOL * max(1.0, float(np.max(np.abs(cpu["logits"]))))
    what = (f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
            f"vs CPU")
    check(err <= bound, f"{what}: logits max_abs_err {err} > {bound}")
    agree = float(np.mean(gpu["tokens"] == cpu["logits"].argmax(-1)))
    tf32_err = float(np.max(np.abs(tf32["logits"] - cpu["logits"])))
    log(f"{what} ({kw['requests']} requests x {kw['prompt_len']} tokens + "
        f"{kw['gen_len']}, teacher-forced with the card's tokens, the "
        f"card's weights): logits max_abs_err {err:.3e} <= {bound:.3e}; "
        f"card's tokens = CPU argmax for {agree:.0%}; CPU run "
        f"{time.perf_counter() - t0:.1f} s; with allow_tf32=True "
        f"{tf32_err:.3e}, {'above' if tf32_err > bound else 'within'} the "
        f"bound")


def run_figures(dev, wrappers: dict) -> dict:
    """The figures path: each sweep-backed runner of
    ``repro_torch.sim.experiments`` on the card, then each host-side one
    (once per engine its committed file has rows for), at
    ``benchmarks/run.py``'s arguments.  Per figure: its rows, the
    kernels' launches inside it and its wall seconds."""
    import inspect
    import torch
    from repro_torch.sim import experiments
    out = {}

    def run(tag, fn, **kw):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = fn(**kw)
        torch.cuda.synchronize()
        out[tag] = dict(rows=rows, wall_s=time.perf_counter() - t0,
                        launches={n: w.launches - before[n]
                                  for n, w in wrappers.items()})

    for family, runner, kw, _, _ in SWEEP_FIGURES:
        run(family, getattr(experiments, runner), **kw, device=dev)
    for runner, kw, path, _ in HOST_FIGURES:
        fn = getattr(experiments, runner)
        if "engine" not in inspect.signature(fn).parameters:
            run(runner, fn, **kw)
            continue
        committed = json.loads((ROOT / path).read_text())["rows"]
        for engine in dict.fromkeys(r["engine"] for r in committed):
            run(f"{runner}.{engine}", fn, **kw, engine=engine)
    return out


def check_figures(dev, figs: dict) -> dict:
    """Hold the figures path's rows: the sweep-backed ones to the same
    runners on the CPU (``SWEEP_RTOL``) and, like the host-side ones, to
    their committed rows in ``benchmarks/run.py --check``'s band.  The
    sweep-backed runners run once more, warm, under torch.profiler for
    the device's busy time and the scan kernels' share of it.  Logs one
    line a figure; returns the device busy ms of each sweep-backed one."""
    from repro_torch.sim import experiments
    busy_ms = {}
    for family, runner, kw, kernel, want in SWEEP_FIGURES:
        fig = figs[family]
        n = fig["launches"][kernel]
        check(n == want if want is not None else n > 0,
              f"figures {family}: {n} {kernel} launches, expected "
              f"{want if want is not None else 'at least one'}")
        fn = getattr(experiments, runner)
        cpu = fn(**kw, device="cpu")
        err = rows_close(fig["rows"], cpu, f"figures {family} vs the CPU")
        gated_n, ok_n, dev_max = band_check(
            sweep_figure_rows(family, fig["rows"]), committed_rows(family),
            f"figures {family}")
        busy, kernels, kinds = device_busy(lambda: fn(**kw, device=dev))
        scan_ms = kinds.get(kernel, 0.0)
        walls = sorted({r["walltime_s"] for r in fig["rows"]
                        if "walltime_s" in r})
        log(f"figures {family}: {runner}({kw}) on the card: "
            f"{len(fig['rows'])} rows, {ok_n} of {gated_n} committed "
            f"BENCH_sweep.json values in band (rtol {BENCH_RTOL}), largest "
            f"deviation {dev_max:.3e}; every value within {err:.3e} of the "
            f"CPU run; launches maxplus_chunked="
            f"{fig['launches']['maxplus_chunked']}, maxplus_seq="
            f"{fig['launches']['maxplus_seq']}; wall {fig['wall_s']:.3f} s"
            + (f" (rows' walltime_s {walls})" if walls else "")
            + ("; device busy not measured (the profiler saw no kernels)"
               if busy is None else
               f"; warm rerun under torch.profiler: {kernels} kernels, "
               f"device busy {busy:.3f} ms ({busy / 1e3 / fig['wall_s']:.1%}"
               f" of the untraced wall), {kernel} {scan_ms:.4f} ms "
               f"({scan_ms / busy:.1%} of busy)"))
        check(ok_n == gated_n, f"figures {family}: {gated_n - ok_n} "
              "committed values out of band")
        busy_ms[family] = busy
    for runner, _, path, decimals in HOST_FIGURES:
        tags = [t for t in figs if t.partition(".")[0] == runner]
        rows = [r for t in tags for r in figs[t]["rows"]]
        committed = json.loads((ROOT / path).read_text())["rows"]
        n, ok_n, dev_max = host_rows_check(rows, committed, decimals,
                                           f"figures {runner}")
        wall = sum(figs[t]["wall_s"] for t in tags)
        launches = {k: sum(figs[t]["launches"][k] for t in tags)
                    for k in ("maxplus_chunked", "maxplus_seq")}
        log(f"figures {runner} ({', '.join(tags)}) on the host: {n} rows, "
            f"{ok_n} in band of {path} (rtol {BENCH_RTOL}, floats rounded "
            f"to {decimals} decimals as committed), largest deviation "
            f"{dev_max:.3e}; launches maxplus_chunked="
            f"{launches['maxplus_chunked']}, maxplus_seq="
            f"{launches['maxplus_seq']}; wall {wall:.3f} s")
        if runner == "fig_rebalance":
            log("figures fig_rebalance post-shift p99 ms: " + ", ".join(
                f"{r['mode']} ({r['engine']}) {r['post_p99_ms']:.3f}"
                for r in rows))
        check(ok_n == n, f"figures {runner}: {n - ok_n} rows out of band "
              f"of {path}")
    return busy_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_fwd
    from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ssm_scan import ssm_scan_kernel
    from repro_torch.sim.cluster import ServiceParams
    from repro_torch.sim.sweep import SweepPoint, run_sweep, sweep_grid

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device(DEVICE, 0)
    kind = torch.cuda.get_device_name(0)
    card = peaks(kind)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, peaks {card}")
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"kernel build ({len(cuda_build.SOURCES)} sources, one nvcc each, "
        f"in parallel): {time.perf_counter() - t0:.2f} s")
    for src, text in cuda_build.BUILD_LOG.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {src}: {ln.strip()}")

    # ---------------------------------------------------- kernels alone
    kernels = kernel_phase(card, dev)
    kernels["ssd_chunked"] = ssd_kernel_phase(card, dev)
    kernels["flash_fwd"] = flash_kernel_phase(card, dev)
    kernels["paged_decode"] = paged_kernel_phase(card, dev)
    wrappers = {"maxplus_chunked": mp_kernel.maxplus_chunked,
                "maxplus_seq": mp_kernel.maxplus_seq,
                "ssd_chunked": ssm_scan_kernel, "flash_fwd": flash_fwd,
                "paged_decode": paged_decode}
    by_path: dict = {name: {} for name in wrappers}

    def drive(path: str, needs: str, fn):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
        for name, w in wrappers.items():
            by_path[name][path] = w.launches
        log(f"{path}: launches " + ", ".join(
            f"{n}={w.launches}" for n, w in wrappers.items()))
        check(wrappers[needs].launches > 0,
              f"{path}: {needs} was never launched")
        return res

    # ---------------------------------------------------- open loop
    # the card's run first, so it plans with cold host memos
    grid = sweep_grid()
    gpu = drive("open_64", "maxplus_chunked",
                lambda: run_sweep(grid, device=dev))
    cpu = run_sweep(grid, device="cpu")
    check(gpu.columns["mean_latency"].shape == (64,), "open loop points")
    columns_close(gpu, cpu, "open loop")
    check(np.all(np.isfinite(gpu.columns["mean_latency"])),
          "open loop latencies not finite")
    log(f"open loop 64 points on {gpu.info['device']}: grid "
        f"{gpu.info['grid']}, walltime {gpu.walltime_s:.3f} s (host "
        f"{gpu.info['host_s']:.3f} s of which planning "
        f"{gpu.info['plan_s']:.3f} s, device {gpu.info['device_s']:.3f} s); "
        f"CPU run {cpu.walltime_s:.3f} s; all columns <= {SWEEP_RTOL} of the "
        f"CPU run")

    # ---------------------------------------------------- closed loop
    infos = {"open_64": gpu.info}
    for path, groups, threads, ops, cache_keys in CLOSED_PATHS:
        rows = closed_path_rows(path)
        pt = SweepPoint(p_global=0.5, groups=groups, group_size=3,
                        threads=threads, ops=ops)
        svc = (None if cache_keys is None
               else ServiceParams(page_cache_keys=cache_keys))
        torch.cuda.reset_peak_memory_stats(dev)
        res = drive(path, "maxplus_seq", lambda: run_sweep(
            [pt], loop="closed", seed=0, service=svc, device=dev))
        ref = None
        if path == "fig_scale":
            # the same point through the plain versions on the host
            ref = run_sweep([pt], loop="closed", seed=0, service=svc,
                            device="cpu")
        c = res.columns
        check(int(c["ops"][0]) == groups * ops, f"{path}: op count")
        got = {}
        for metric, (want, tol) in rows.items():
            col, scale = ROW_COLUMNS[metric]
            got[metric] = scale * float(c[col][0])
            check(abs(got[metric] - want) <= tol,
                  f"{path}.{metric}: {got[metric]} vs committed {want} "
                  f"(tolerance {tol})")
        vs_cpu = ""
        if ref is not None:
            err = columns_close(res, ref, f"{path} vs the CPU run")
            check(res.info["rounds"] == ref.info["rounds"],
                  f"{path}: {res.info['rounds']} rounds on the card, "
                  f"{ref.info['rounds']} on the CPU")
            vs_cpu = (f"; all {len(ref.columns)} columns within {err:.3e} "
                      f"of the CPU run ({ref.walltime_s:.3f} s), same "
                      f"rounds")
        infos[path] = res.info
        log(f"{path}: {groups} groups x {threads} threads, "
            f"{int(c['ops'][0])} ops, grid {res.info['grid']}, "
            f"{res.info['rounds']} rounds; "
            + ", ".join(f"{m} {got[m]:.6f} (committed {w}, tol {t})"
                        for m, (w, t) in rows.items())
            + f"{vs_cpu}; walltime {res.walltime_s:.3f} s (host "
            f"{res.info['host_s']:.3f} s of which planning "
            f"{res.info['plan_s']:.3f} s, device rounds "
            f"{res.info['device_s']:.3f} s); peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")

    # ---------------------------------- kernels at the main path's shapes
    from repro_torch.kernels.maxplus_scan import (maxplus_chunked_ref,
                                                  maxplus_depart_ref)
    for path, info in infos.items():
        R, L = info["grid"]
        name = "maxplus_chunked" if path == "open_64" else "maxplus_seq"
        a, s = scan_inputs(R, L, 11, torch.float64, dev)
        if path == "open_64":
            got, plain = (mp_kernel.maxplus_chunked(a, s),
                          maxplus_chunked_ref(a, s))
            check(rel_err(got, plain) <= 1e-12, f"{path} shape: K1 error")
            ms = time_ms(lambda: mp_kernel.maxplus_chunked(a, s))
        else:
            got, plain = mp_kernel.maxplus_seq(a, s), maxplus_depart_ref(a, s)
            check(torch.equal(got, plain), f"{path} shape: K2 not bitwise")
            ms = time_ms(lambda: mp_kernel.maxplus_seq(a, s))
        b_ms, b_by = bound_ms(card, 3 * a.numel() * 8, 2 * a.numel(),
                              torch.float64)
        share = by_path[name][path] * ms * 1e-3 / info["device_s"]
        log(f"{path} scan shape ({R}, {L}) float64: {name} {ms:.4f} ms per "
            f"launch, bound {b_ms:.4f} ms ({b_by}), matches its plain "
            f"version; x {by_path[name][path]} launches = {share:.1%} of the "
            f"path's device time")

    # ------------------------------------------ figures: the path's end
    # (check_figures holds each figure's own launches: maxplus_seq's too)
    figs = drive("figures", "maxplus_chunked",
                 lambda: run_figures(dev, wrappers))
    busy_ms = check_figures(dev, figs)
    wall = sum(f["wall_s"] for f in figs.values())
    sweep_wall = sum(figs[f]["wall_s"] for f in busy_ms)
    busy = sum(b or 0.0 for b in busy_ms.values())
    log(f"figures: {len(figs)} runs, wall {wall:.3f} s, of which the "
        f"sweep-backed figures {sweep_wall:.3f} s (device busy {busy:.3f} "
        f"ms under torch.profiler) and the host figures "
        f"{wall - sweep_wall:.3f} s")

    # ------------------------------------------------ serving, full width
    cfg = get_config(SERVE["arch"])
    n_mlstm = cfg.n_layers - len(cfg.slstm_layers)
    # numerator + denominator scan per mLSTM layer, in prefill only
    drive("serve_xlstm", "ssd_chunked",
          lambda: serve_path(dev, SERVE, "ssd_chunked", 2 * n_mlstm, 0))
    k3 = kernels["ssd_chunked"]
    scan_s = n_mlstm * (k3["ms"] + k3["denominator"]["ms"]) / 1e3
    bd = serve_breakdown(dev, SERVE, {"mLSTM": "mlstm_layers",
                                      "sLSTM": "slstm_layers"},
                         "ssd_chunked")
    check(bd["prefill_launches"] == 2 * n_mlstm,
          f"serve_xlstm breakdown: {bd['prefill_launches']} SSD launches")
    log_breakdown("serve_xlstm", bd)
    log(f"serve_xlstm: of the warm prefill, the SSD kernel {scan_s:.4f} s "
        f"= {n_mlstm} x (numerator {k3['ms']:.4f} + denominator "
        f"{k3['denominator']['ms']:.4f}) ms from the kernel phase, "
        f"{scan_s / bd['prefill_s']:.1%}")

    dcfg = get_config(SERVE_DENSE["arch"])
    L = dcfg.n_layers
    # one attention call a layer, in prefill and in each decode step
    drive("serve_stablelm", "flash_fwd",
          lambda: serve_path(dev, SERVE_DENSE, "flash_fwd", L, L))
    check(by_path["flash_fwd"]["serve_stablelm"]
          == L * SERVE_DENSE["gen_len"],
          f"serve_stablelm: {by_path['flash_fwd']['serve_stablelm']} flash "
          f"launches, expected {L} x {SERVE_DENSE['gen_len']} passes")
    torch.cuda.empty_cache()
    bd = serve_breakdown(dev, SERVE_DENSE, {"decoder layers": "layers"},
                         "flash_fwd")
    check(bd["prefill_launches"] == L and bd["decode_launches"] == L,
          f"serve_stablelm breakdown: {bd['prefill_launches']} flash "
          f"launches a prefill, {bd['decode_launches']} a decode step")
    log_breakdown("serve_stablelm", bd)
    k4 = kernels["flash_fwd"]
    log(f"serve_stablelm: from the kernel phase, attention is {L} x "
        f"{k4['ms']:.4f} ms = {L * k4['ms'] / 1e3:.4f} s of the warm "
        f"prefill ({L * k4['ms'] / 1e3 / bd['prefill_s']:.1%}) and {L} x "
        f"{k4['decode']['ms']:.4f} ms = {L * k4['decode']['ms']:.3f} ms of "
        f"a decode step ({L * k4['decode']['ms'] / 1e3 / bd['decode_step_s']:.1%})")
    torch.cuda.empty_cache()

    # ------------------------ the page pool's data plane, full width
    drive("paged_stablelm", "paged_decode",
          lambda: paged_stablelm(dev, SERVE_DENSE))
    check(by_path["paged_decode"]["paged_stablelm"] == L,
          f"paged_stablelm: {by_path['paged_decode']['paged_stablelm']} "
          f"paged launches, expected {L}")
    k5 = kernels["paged_decode"]
    log(f"paged_stablelm: from the kernel phase, {L} x {k5['ms']:.4f} ms = "
        f"{L * k5['ms']:.3f} ms of paged attention a decode step, against "
        f"{L} x {k4['decode']['ms']:.4f} ms = {L * k4['decode']['ms']:.3f} "
        f"ms of K4 over the serve path's contiguous cache")
    torch.cuda.empty_cache()

    # ------------------------- the card's serve runs against the CPU's
    serve_vs_cpu(dev, SERVE_VS_CPU)
    serve_vs_cpu(dev, SERVE_DENSE_VS_CPU)

    for name, k in kernels.items():
        k["launches"] = sum(by_path[name].values())
        k["launches_by_path"] = by_path[name]
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
