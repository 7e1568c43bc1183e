#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
and holds each against its plain PyTorch version on the card, and times
it: the max-plus scans at (1000, 8192), the SSD scan at the serve paths'
own scans (mLSTM's numerator and denominator, and a strong decay that
must stay finite; Mamba2's at zamba2-1.2b's 512 heads of N = P = 64
from the zero state prefill passes; ``y`` and the final state; each
stage's time from torch.profiler, the peak device memory of a call, and
one request's mLSTM scans too), flash attention at the dense and hybrid
serve paths' prefill (causal) and decode (one query over the cache's
valid prefix) shapes (heads of 80 and of 64, and mixtral-8x7b's 32
query heads of 128 over 8 KV heads, also under a binding window, and
seamless-m4t-large-v2's five calls at 16 heads of 64: encoder
self-attention, decoder self-attention, cross-attention in prefill, and
the decoder's two decode calls, with a partial-tile cross-attention and
a cross decode over 1003 frames checked too), paged decode attention at stablelm-3b's decode and mixtral-8x7b's GQA shape
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
  5M ops, checked against the committed ``fig_scale_1m`` rows;
* ``closed_blocks``: the closed sweep in point blocks,
  ``benchmarks/run.py``'s per-device scaling grid (``closed_grid(threads=500, ops=1000)``, 16
  points) at ``devices=1`` and at one block a visible GPU, cold and warm,
  every column bitwise equal to ``devices=1``, the CPU's blocks within
  1e-9, and ``ValueError`` one device past the visible ones; wall, host
  and device split, blocks, rounds and K2 launches logged, not gated;
* ``obs``: ``repro_torch.obs.profile_maxplus`` for K1 and K2 at (8, 4096)
  and at ``fig_scale``'s scan grid, every CUDA key present and positive,
  its ``device_ms`` beside this script's own for the same inputs; once in
  a fresh process (the first call with the kernels' load); and the trace
  CLI, ``python -m repro_torch.obs summarize``, on the committed sample.

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
* ``serve_zamba2``: full-width zamba2-1.2b (38 Mamba2 layers, d_model
  2048, one shared attention block after every 6 of them, 6
  applications and a 2-layer tail; 1.17B random weights drawn on the
  card), the same requests, with both kernels' launches checked (the
  SSD kernel 38 a prefill and none in decode, flash 6 a prefill and 6 a
  decode step) and the same split (Mamba2 layers against the shared
  block);
* ``serve_mixtral``: mixtral-8x7b at full width cut to 8 of its 32
  layers (d_model 4096, 32 heads of 128 over 8 KV heads, 8 SwiGLU
  experts of 14336, top-2; 11.87B random weights drawn on the card, the
  whole model does not fit one card in float32), the same requests, the
  einsum dispatch, with the flash kernel's launches checked (8 a
  prefill, 8 a decode step, the SSD kernel none) and the split of a warm
  prefill and decode step into attention and MoE; then one of its
  full-width MoE layers alone at the prefill and decode shapes, einsum
  against sort dispatch within ``MOE_TOL``, each timed;
* ``serve_seamless``: seamless-m4t-large-v2 at full width and depth (24
  encoder and 24 decoder layers, d_model 1024, 16 heads of 64, SwiGLU
  8192, vocab 256,206 padded to 256,256; 2.04B random weights drawn on
  the card), the same requests with 1024 frame embeddings each (the
  frontend is a stub; frames from the seed), with the flash kernel's
  launches checked (72 a prefill: encoder self-attention, decoder
  self-attention and cross-attention in each layer; 48 a decode step)
  and the split of a warm prefill and decode step into encoder layers,
  decoder self-attention and MLP, and cross-attention;
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
  stablelm-3b and mixtral-8x7b at full width cut to 2 layers and
  zamba2-1.2b at full width cut to 7 (one shared-block application and
  one tail layer), 2 requests x 128 tokens, and seamless-m4t-large-v2
  cut to 2 encoder and 2 decoder layers, 2 requests x 256 tokens and
  256 frames; for mixtral also the
  smallest gap between a token's 2nd and 3rd router probability on the
  card, and how many expert choices the CPU made otherwise.

The training path, ``repro_torch.train.loop.train_loop`` (before it, in
the kernel phases, the gradient of flash attention: dq, dk and dv of
``FlashAttention``, the forward on the flash kernel and the backward in
torch ops, against float64 autograd of plain attention on the card at
stablelm-3b's training shape and mixtral-8x7b's GQA, within 8x the plain
float32 version's error, forward and backward timed):

* ``train_stablelm``: full-width, full-depth stablelm-3b (2.8B random
  weights drawn on the card), AdamW, 2 sequences of 1024 tokens from
  the synthetic pipeline, no rematerialization, 4 steps: seconds a step
  (median of steps 2 to 4), tokens per second, peak device memory,
  every loss finite, the flash kernel's launches checked at 32 a step;
  then the busy split of a warm step under torch.profiler (products,
  the flash kernel, the backward's attention ops, the optimizer) and
  the device's idle share;
* ``train_vs_cpu``: stablelm-3b at full width cut to 2 layers, one
  ``make_train_step`` on the card and on the CPU handed the card's
  weights and batch: loss within ``TRAIN_LOSS_RTOL``, every parameter's
  gradient present and within ``LOGIT_TOL`` scaled;
* ``train_resume``: reduced stablelm-3b on the card, 10 steps straight
  against 5 steps, a stop, one of 4 checkpoint hosts killed and a resume
  to 10 through the EdgeKV ``QuorumCheckpointer``: every loss bitwise
  equal.

Before the paths, ``analysis``: the port's static-analysis suite,
``python -m repro_torch.analysis src/repro_torch --json`` in a fresh
interpreter on the card's host, every rule over every file of the port;
a finding or a non-zero exit fails the run.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each path and read just after, and a path that never launched its
kernel fails.  The second-to-last line is a JSON object with each
kernel's numbers, the last ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the exit code is non-zero and no result line is
printed.  Without a GPU, or outside a checkout of the repository, it
exits non-zero at once.

Kernel times are device times, from torch.profiler over 20 back-to-back
calls (``device_ms``, on ``repro_torch.obs.profile.kernel_records``: a
window whose records of a kernel are not a multiple of its calls fails
the run), and beside them the wrapper's back-to-back time from CUDA
events (``call_ms``), which for a kernel of tens of microseconds is the
host's rate of calls.  ``python3 chip_smoke.py --kernels`` stops after
the kernel phases, drives no path and prints no result line: the quick
way to hold two trees' kernels against each other in one call.
``--closed-blocks`` runs the closed sweep in point blocks alone, at one
block and at one block a visible GPU (the run for a host of several
cards), and prints no result line either.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
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
# the closed sweep in point blocks: benchmarks/run.py's per-device scaling
# grid, closed_grid(threads=500, ops=1000), 16 points
CLOSED_BLOCKS = dict(threads=500, ops=1000)
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
SERVE_HYBRID = dict(SERVE, arch="zamba2-1.2b")
# mixtral-8x7b at full width cut to 8 of its 32 layers: a layer is 1.451B
# parameters, 5.81 GB in float32, so the whole model (186 GB) does not fit
# one 80 GB card; 8 layers with the embedding and head are 47.5 GB
SERVE_MOE = dict(SERVE, arch="mixtral-8x7b", layers=8)
# seamless-m4t-large-v2 at full width and depth (24 encoder and 24 decoder
# layers, 2.04B parameters, 8.2 GB in float32): each request carries as
# many frames as prompt tokens, 1024, the reference's enc_len = seq_len
SERVE_AUDIO = dict(SERVE, arch="seamless-m4t-large-v2")
SERVE_VS_CPU = dict(arch="xlstm-125m", requests=2, prompt_len=256,
                    shared_prefix_len=64, gen_len=8, seed=0)
SERVE_DENSE_VS_CPU = dict(arch="stablelm-3b", layers=2, requests=2,
                          prompt_len=128, shared_prefix_len=32, gen_len=8,
                          seed=0)
# zamba2-1.2b cut to 7 layers: one group of 6 with the shared block after
# it, and one tail layer with none
SERVE_HYBRID_VS_CPU = dict(SERVE_DENSE_VS_CPU, arch="zamba2-1.2b", layers=7)
# mixtral-8x7b cut to 2 layers, where capacity drops pairs: C 40 a
# sequence in prefill, C 1 for the batch of 2 in decode
SERVE_MOE_VS_CPU = dict(SERVE_DENSE_VS_CPU, arch="mixtral-8x7b")
# seamless-m4t-large-v2 cut to 2 encoder and 2 decoder layers: 2 requests
# of 256 prompt tokens and 256 frames
SERVE_AUDIO_VS_CPU = dict(SERVE_DENSE_VS_CPU, arch="seamless-m4t-large-v2",
                          enc_layers=2, prompt_len=256, shared_prefix_len=64)
# the keys of a serve spec that cut the model's depth rather than go to
# serve
DEPTH = ("layers", "enc_layers")
# the MoE layer's einsum dispatch against its sort dispatch on the card:
# max |einsum - sort| <= tol * max(1, max |einsum|); the same routing and
# expert products, the combine's sums in another order
MOE_TOL = 1e-5
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
# the training paths: full-width stablelm-3b (B 1 if B 2 does not fit);
# the card against the CPU at 2 layers (loss relative, gradients scaled
# as the logits, LOGIT_TOL); kill-and-resume on the reduced model
TRAIN = dict(arch="stablelm-3b", batch=2, seq_len=1024, steps=4, lr=3e-4,
             seed=0)
TRAIN_VS_CPU = dict(arch="stablelm-3b", layers=2, batch=2, seq_len=128,
                    seed=0)
TRAIN_RESUME = dict(arch="stablelm-3b", batch=2, seq_len=64, seed=3)
TRAIN_LOSS_RTOL = 1e-5
# flash attention's gradient: (model, B, S, query heads, KV heads, head
# width, window), causal; against float64 within GRAD_FACTOR x the plain
# float32 version's error, as the GPU test holds the forward
GRAD_SHAPES = (("stablelm-3b", 2, 1024, 32, 32, 80, 0),
               ("mixtral-8x7b", 2, 1024, 32, 8, 128, 4096))
GRAD_FACTOR = 8
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
            ms, call_ms = device_ms(lambda: wrapper(a, s)), time_ms(
                lambda: wrapper(a, s))
            plain_ms = time_ms(lambda: plain_fn(a, s), reps=1, windows=3)
            lib_ms = None
            if name == "maxplus_chunked":
                # yardstick only (never called by the port): the closed
                # form as torch cumsum + cummax
                def lib():
                    S = torch.cumsum(s, dim=1)
                    return S + torch.cummax(a - (S - s), dim=1).values
                lib_ms = device_ms(lib)
            log(f"{name} {tag} ({R}, {L}): {ms:.4f} ms on the device "
                f"(back-to-back calls {call_ms:.4f} ms), bound {b_ms:.4f} ms "
                f"({b_by}; {nbytes / ms / 1e9:.3f} TB/s achieved), plain "
                f"{plain_ms:.3f} ms, library "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
            if name == "maxplus_seq":
                # one row alone: its time over L is the dependent chain's
                # cost a step, with no other row's bytes in the way
                a1, s1 = a[:1].contiguous(), s[:1].contiguous()
                check(torch.equal(wrapper(a1, s1), plain_fn(a1, s1)),
                      f"{name} {tag} one row: not bitwise equal")
                one_ms = device_ms(lambda: wrapper(a1, s1))
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
                    max_abs_err=c["max_abs_err"], ms=ms, call_ms=call_ms,
                    plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return kernels


def ssd_inputs(BH: int, S: int, P: int, N: int, seed: int, dev,
               decay=None):
    """Seeded scan inputs with the reference kernel tests'
    distributions: normal x, log decay -softplus(normal) (or the
    constant ``decay``), sigmoid step, B and C normal / sqrt(N).  With
    ``decay="mamba2"``, Mamba2's own step and decay at A_log = 0: dt =
    softplus(normal) and log decay -dt (about -100 nats a chunk of
    128)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P))
    if decay == "mamba2":
        dt = np.logaddexp(0.0, rng.standard_normal((BH, S, 1)))
        loga = -dt
    else:
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


# the timing windows of stage_ms, their kernel records, and the kernels
# whose records in a window were not a multiple of its calls, after
# kernel_records's tries (records lost, or a stray): (kernel, records,
# calls)
PROFILER_RECORDS = {"windows": 0, "records": 0, "irregular": []}


def stage_ms(fn, stages, calls: int = 5) -> dict:
    """Device ms a call of each stage of ``fn``: the summed durations of
    each CUDA kernel over ``calls`` calls from torch.profiler
    (``repro_torch.obs.profile.kernel_records``), over ``calls``;
    ``stages`` maps a fragment of a CUDA kernel's name to its stage;
    kernels that match none are summed under "other".  Windows that
    stay irregular are tallied in ``PROFILER_RECORDS``."""
    from repro_torch.obs.profile import irregular, kernel_records
    per = kernel_records(fn, calls)
    check(bool(per), "torch.profiler saw no device time in a window")
    PROFILER_RECORDS["windows"] += 1
    PROFILER_RECORDS["records"] += sum(n for n, _ in per.values())
    PROFILER_RECORDS["irregular"] += [
        (name, n, calls) for name, n in irregular(per, calls).items()]
    out: dict = {}
    for name, (_, us) in per.items():
        stage = next((s for f, s in stages if f in name), "other")
        out[stage] = out.get(stage, 0.0) + us / calls / 1e3
    return out


def device_ms(fn, calls: int = 20) -> float:
    """Device ms a call of ``fn``: every kernel's, from ``stage_ms``.
    Unlike ``time_ms`` it leaves out the host's cost a call (checks,
    allocation, the ctypes call), which bounds a back-to-back run of a
    kernel of tens of microseconds."""
    return sum(stage_ms(fn, (), calls).values())


def check_profiler_records() -> None:
    """Log the timing windows' tally and fail if a window held a kernel
    whose records were not a multiple of its calls after its tries: a
    device time that lost records or counted a stray."""
    r = PROFILER_RECORDS
    log(f"torch.profiler: {r['windows']} timing windows, {r['records']} "
        f"kernel records, {len(r['irregular'])} irregular "
        f"(kernel, records, calls): {r['irregular'][:8]}")
    check(not r["irregular"], "torch.profiler: a timing window's kernel "
          "records are not a multiple of its calls")


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
    """The SSD kernel at the serve paths' scans, S = 1024, Q = 128.
    xlstm-125m's, BH = 8 requests x 4 heads, N = 384: mLSTM's numerator
    (P = 384, from zero and from a random state) and denominator (P =
    1), and a strong decay (60 nats a token) whose masked exponentials
    overflow.  zamba2-1.2b's Mamba2, BH = 8 requests x 64 heads, N = P =
    64, at its own decay and from the zero state prefill passes.  y and
    h_final against the plain chunked version on the same inputs, then
    timed beside it and its bound (and, where the products run in
    3xTF32, the tensor cores' figure), with each stage's time from
    torch.profiler and the peak device memory of one call above its
    inputs; mLSTM's numerator and denominator again at one request (BH
    4)."""
    import torch
    from repro_torch.kernels.ssm_scan import ssd_chunked_ref, ssm_scan

    S, Q = 1024, 128
    out = {}
    # (case, BH, P, N, decay, initial state, timed)
    for case, BH, P, N, decay, h0_kind, timed in (
            ("numerator", 32, 384, 384, None, None, True),
            ("numerator+h0", 32, 384, 384, None, "random", False),
            ("denominator", 32, 1, 384, None, None, True),
            ("strong-decay", 32, 384, 384, -60.0, None, False),
            ("numerator, one request", 4, 384, 384, None, None, True),
            ("denominator, one request", 4, 1, 384, None, None, True),
            ("mamba2", 512, 64, 64, "mamba2", "zero", True)):
        args = ssd_inputs(BH, S, P, N, 3, dev, decay)
        h0 = None
        if h0_kind == "zero":
            h0 = torch.zeros((BH, N, P), device=dev)
        elif h0_kind == "random":
            h0 = torch.randn((BH, N, P), device=dev,
                             generator=torch.Generator(dev).manual_seed(4))
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
        line = (f"ssd_chunked {case} (BH {BH}, S {S}, P {P}, N {N}, Q {Q}, "
                f"h0 {h0_kind or 'none'}):"
                f" max_abs_err vs plain y {errs['y']:.3e}, h_final "
                f"{errs['h_final']:.3e} (tol {SSD_TOL} x max(1, |plain|))")
        if timed:
            nbytes, ops = ssd_work(BH, S, P, N, Q, h0 is not None)
            b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
            ms = device_ms(lambda: ssm_scan(*args, chunk=Q, h0=h0))
            call_ms = time_ms(lambda: ssm_scan(*args, chunk=Q, h0=h0))
            plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=Q,
                                                       h0=h0),
                               reps=1, windows=3)
            stages = stage_ms(lambda: ssm_scan(*args, chunk=Q, h0=h0),
                              SSD_STAGES)
            peak = call_peak_mb(lambda: ssm_scan(*args, chunk=Q, h0=h0),
                                dev)
            # P > 1 runs its products in 3xTF32: three TF32 passes of the
            # chunked form's operations; P = 1 runs the recurrence on the
            # CUDA cores
            tc_ms = 3 * ops / card["tf32"] * 1e3 if P > 1 else None
            line += (f"; {ms:.4f} ms on the device (back-to-back calls "
                     f"{call_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by}: "
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
            out[case] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=max(errs.values()),
                             peak_mb=peak, stages_ms=stages)
        log(line)
        del args, h0
    num, den = out["numerator"], out["denominator"]
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "peak_mb", "stages_ms")
    return dict(
        name="ssd_chunked", route="cuda",
        source="src/repro_torch/kernels/ssm_scan/csrc/ssd_chunked.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:68", launches=0,
        max_abs_err=num["max_abs_err"], ms=num["ms"],
        call_ms=num["call_ms"], plain_ms=num["plain_ms"],
        bound_ms=num["bound_ms"], bound_by=num["bound_by"], library_ms=None,
        peak_mb=num["peak_mb"], stages_ms=num["stages_ms"],
        denominator={k: den[k] for k in keys},
        mamba2={k: out["mamba2"][k] for k in keys},
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


def sdpa_ms(q, k, v, kv_len: int, causal: bool) -> tuple:
    """torch's scaled_dot_product_attention on q (B, Sq, H, hd) over the
    first ``kv_len`` of k, v (B, Skv, K, hd), its device time
    (``device_ms``, as the kernel's).  Returns (ms, how):
    under GQA the call with ``enable_gqa`` (the same inputs), and beside
    it the call over K/V repeated to the H query heads beforehand
    (outside the timing), which reaches torch's MHA kernels."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
    if G == 1:
        return device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)), "MHA"
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    rep_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=causal))
    del kr, vr
    ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    return ms, f"enable_gqa; over K/V repeated to {q.shape[2]} heads " \
        f"{rep_ms:.4f} ms"


def flash_kernel_phase(card: dict, dev) -> dict:
    """The flash kernel at the serve paths' shapes for 8 requests:
    stablelm-3b's 32 heads of 80, zamba2-1.2b's shared block's 32 heads
    of 64 and mixtral-8x7b's 32 query heads of 128 over 8 KV heads (GQA,
    read natively).  Prefill (1024 tokens, causal) and decode (one query
    over a 1056-slot cache whose valid length, a device int32, is 1025,
    and for stablelm-3b also 1055); against the plain chunked version
    and the naive oracle on the same inputs (K/V repeated to the query
    heads for them), then timed beside the plain version, its bound and
    torch's scaled_dot_product_attention (float32, the yardstick; the
    port never calls it).  mixtral's prefill is also checked, untimed,
    under a window of 256 that binds."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_chunked_ref, flash_attention_ref, flash_fwd)

    B, S, H, S_max = 8, 1024, 32, 1056
    gen = torch.Generator(dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def fold(t, reps=1):          # (B, S, n, hd) -> (B * n * reps, S, hd)
        if reps > 1:
            t = t.repeat_interleave(reps, dim=2)
        return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[-1])

    def cases_at(hd: int, K: int, kv_lens: tuple, window: int) -> dict:
        """case -> (run, (q, k, v), plain kwargs, kv_len, causal, timed)"""
        q, k, v = randn(B, S, H, hd), randn(B, S, K, hd), randn(B, S, K, hd)
        q1, kc, vc = randn(B, 1, H, hd), randn(B, S_max, K, hd), randn(
            B, S_max, K, hd)
        cases = {"prefill": (lambda: flash_fwd(q, k, v, causal=True),
                             (q, k, v), dict(causal=True), S, True, True)}
        if window:
            cases[f"prefill window {window}"] = (
                lambda: flash_fwd(q, k, v, causal=True, window=window),
                (q, k, v), dict(causal=True, window=window), S, True, False)
        for n in kv_lens:
            n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
            cases[f"decode kv_len {n}"] = (
                lambda n_dev=n_dev: flash_fwd(q1, kc, vc, causal=False,
                                              kv_len=n_dev),
                (q1, kc, vc), dict(causal=False, seq_k=n_dev), n, False,
                True)
        return cases

    out = {}
    for model, hd, K, kv_lens, window in (
            ("stablelm-3b", 80, H, (S + 1, S_max - 1), 0),
            ("zamba2-1.2b", 64, H, (S + 1,), 0),
            ("mixtral-8x7b", 128, 8, (S + 1,), 256)):
        for case, (run, (a, b, c), kw, kv_len, causal, timed) in cases_at(
                hd, K, kv_lens, window).items():
            got = fold(run())
            check(bool(torch.isfinite(got).all()),
                  f"flash {model} {case}: not finite")
            folded = [fold(a), fold(b, H // K), fold(c, H // K)]
            errs = {}
            for what, plain_fn in (("plain", flash_attention_chunked_ref),
                                   ("naive", flash_attention_ref)):
                want = plain_fn(*folded, **kw)
                err = float((got - want).abs().max())
                bound = FLASH_TOL * max(1.0, float(want.abs().max()))
                check(err <= bound, f"flash {model} {case}: max_abs_err vs "
                      f"{what} {err} > {bound}")
                errs[what] = err
            del want, got
            shape = (f"(B {B}, Sq {a.shape[1]}, Skv {b.shape[1]}, H {H}, K "
                     f"{K}, hd {hd})")
            if not timed:
                log(f"flash_fwd {model} {case} {shape}: max_abs_err vs "
                    f"plain {errs['plain']:.3e}, vs naive "
                    f"{errs['naive']:.3e} (tol {FLASH_TOL} x max(1, "
                    f"|plain|)); checked, not timed")
                continue
            nbytes, ops = flash_work(B, a.shape[1], H, K, hd, kv_len, causal)
            b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
            ms, call_ms = device_ms(run), time_ms(run)
            plain_ms = time_ms(
                lambda: flash_attention_chunked_ref(*folded, **kw),
                reps=1, windows=3)
            lib_ms, how = sdpa_ms(a, b, c, kv_len, causal)
            # the tile configuration's products run in 3xTF32: three TF32
            # passes of the same operations on the tensor cores
            tc_ms = 3 * ops / card["tf32"] * 1e3
            log(f"flash_fwd {model} {case} {shape}: max_abs_err vs plain "
                f"{errs['plain']:.3e}, vs naive {errs['naive']:.3e} (tol "
                f"{FLASH_TOL} x max(1, |plain|)); {ms:.4f} ms on the "
                f"device (back-to-back calls {call_ms:.4f} ms), bound "
                f"{b_ms:.4f} ms ({b_by}: {ops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; {ops / ms / 1e9:.2f} TFLOP/s, "
                f"{nbytes / ms / 1e9:.3f} TB/s achieved), 3xTF32 on the "
                f"tensor cores {tc_ms:.4f} ms (3 x ops at "
                f"{card['tf32'] / 1e12:.0f} TFLOP/s), plain {plain_ms:.3f} "
                f"ms, library {lib_ms:.4f} ms (scaled_dot_product_attention,"
                f" float32, {how}); kernel / library {ms / lib_ms:.3f}")
            out[hd, case] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=errs["plain"],
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
        ms = device_ms(lambda: flash_fwd(qw, kw, vw, causal=True))
        lib_ms, _ = sdpa_ms(qw, kw, vw, S, True)
        log(f"flash_fwd prefill at hd {w}, MHA (B {B}, S {S}, H {H}): "
            f"max_abs_err vs plain {err:.3e}; {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), 3xTF32 on the tensor cores "
            f"{3 * ops / card['tf32'] * 1e3:.4f} ms, library {lib_ms:.4f} "
            f"ms; kernel / library {ms / lib_ms:.3f}")
    decode = f"decode kv_len {S + 1}"
    return dict(
        name="flash_fwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:87",
        launches=0, **out[80, "prefill"], decode=out[80, decode],
        hd64={"prefill": out[64, "prefill"], "decode": out[64, decode]},
        hd128_gqa={"prefill": out[128, "prefill"],
                   "decode": out[128, decode]})


# the audio path's attention calls for 8 requests of seamless-m4t-large-v2
# (16 heads of 64, K = H): (case, Sq, Skv, causal, device kv_len or None,
# the stack and phase that make the call on the serve path, or None).
# The last two are checked and not timed: a partial query tile (1000 is
# not a multiple of 128) with a partial KV tile (1030 of 64) and
# Sq != Skv, and a cross decode over 1003 frames
AUDIO_FLASH = (("encoder self", 1024, 1024, False, None, "encoder prefill"),
               ("decoder self", 1024, 1024, True, None, "decoder prefill"),
               ("cross prefill", 1024, 1024, False, None, "decoder prefill"),
               ("decoder self decode", 1, 1056, False, 1025,
                "decoder decode"),
               ("cross decode", 1, 1024, False, None, "decoder decode"),
               ("cross prefill, partial tiles", 1000, 1030, False, None,
                None),
               ("cross decode, 1003 frames", 1, 1003, False, None, None))


def flash_audio_phase(card: dict, dev) -> dict:
    """The flash kernel at the audio serve path's shapes (``AUDIO_FLASH``),
    each against the plain chunked version and the naive oracle within
    ``FLASH_TOL``; the timed ones beside the plain version, the bound and
    torch's scaled_dot_product_attention (float32, the same masks).
    Returns case -> the kernel JSON's keys; each case's ``launches``
    stays None until the serve path's run counts them
    (``LaunchesInside``)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_chunked_ref, flash_attention_ref, flash_fwd)
    B, H, hd = 8, 16, 64
    gen = torch.Generator(dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def fold(t):                  # (B, S, H, hd) -> (B * H, S, hd)
        return t.transpose(1, 2).reshape(-1, t.shape[1], hd)

    out = {}
    for case, Sq, Skv, causal, n, where in AUDIO_FLASH:
        q, k, v = randn(B, Sq, H, hd), randn(B, Skv, H, hd), randn(
            B, Skv, H, hd)
        n_dev = (None if n is None
                 else torch.tensor(n, dtype=torch.int32, device=dev))
        kv_len = Skv if n is None else n

        def run():
            return flash_fwd(q, k, v, causal=causal, kv_len=n_dev)

        got = fold(run())
        check(bool(torch.isfinite(got).all()),
              f"flash audio {case}: not finite")
        folded = [fold(q), fold(k), fold(v)]
        kw = dict(causal=causal, seq_k=0 if n_dev is None else n_dev)
        errs = {}
        for what, plain_fn in (("plain", flash_attention_chunked_ref),
                               ("naive", flash_attention_ref)):
            want = plain_fn(*folded, **kw)
            err = float((got - want).abs().max())
            bound = FLASH_TOL * max(1.0, float(want.abs().max()))
            check(err <= bound, f"flash audio {case}: max_abs_err vs {what} "
                  f"{err} > {bound}")
            errs[what] = err
        del want, got
        shape = (f"(B {B}, Sq {Sq}, Skv {Skv}, H {H}, K {H}, hd {hd}, "
                 f"{'causal' if causal else 'no mask'}"
                 + ("" if n is None else f", device kv_len {n}") + ")")
        head = (f"flash_fwd audio {case} {shape}: max_abs_err vs plain "
                f"{errs['plain']:.3e}, vs naive {errs['naive']:.3e} (tol "
                f"{FLASH_TOL} x max(1, |plain|))")
        if where is None:
            log(f"{head}; checked, not timed")
            continue
        nbytes, ops = flash_work(B, Sq, H, H, hd, kv_len, causal)
        b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
        ms, call_ms = device_ms(run), time_ms(run)
        plain_ms = time_ms(lambda: flash_attention_chunked_ref(*folded, **kw),
                           reps=1, windows=3)
        lib_ms, how = sdpa_ms(q, k, v, kv_len, causal)
        log(f"{head}; {ms:.4f} ms on the device (back-to-back calls "
            f"{call_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by}: "
            f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"{ops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s "
            f"achieved), 3xTF32 on the tensor cores "
            f"{3 * ops / card['tf32'] * 1e3:.4f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.4f} ms (scaled_dot_product_attention, "
            f"float32, {how}); kernel / library {ms / lib_ms:.3f}; "
            f"serve_seamless's {where} call")
        out[case] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=errs["plain"], library_ms=lib_ms,
                         launches=None)
    return out


def plain_attention(q, k, v, *, causal: bool, window: int):
    """Softmax attention of q (B, S, H, hd) over k, v (B, S, K, hd) in the
    inputs' dtype, K/V repeated to the query heads, the hidden keys
    selected away: the oracle autograd differentiates."""
    import torch
    from repro_torch.kernels.flash_attention.ref import _mask
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, 2) for t in (k, v))
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    mask = _mask(S, torch.arange(S, device=q.device), causal=causal,
                 window=window, seq_q=S, seq_k=S)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.where(mask, p, 0.0), v)


def flash_grad_phase(card: dict, dev) -> dict:
    """The gradient of flash attention at ``GRAD_SHAPES``: dq, dk, dv of
    ``FlashAttention`` (the forward on the flash kernel, the backward
    ``attention_grads`` in torch ops) against float64 autograd of
    :func:`plain_attention` on the same inputs, each within
    ``GRAD_FACTOR`` x the float32 plain version's own error; then the
    forward (the kernel) and the backward timed, the backward beside its
    bound (its five products, S = q kᵀ again, dV, dP, dQ, dK, over the
    visible pairs; q, k, v, o, dO read and dq, dk, dv written once) and
    its peak memory, and forward plus backward beside torch's
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_grads, flash_attention, flash_fwd)
    out = {}
    for model, B, S, H, K, hd, window in GRAD_SHAPES:
        gen = torch.Generator(dev).manual_seed(9)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev)
        k, v = (torch.randn((B, S, K, hd), generator=gen, device=dev)
                for _ in range(2))
        do = torch.randn((B, S, H, hd), generator=gen, device=dev)

        def grads(fn, dtype):
            xs = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            o = fn(*xs, causal=True, window=window)
            return [g.detach() for g in
                    torch.autograd.grad(o, xs, do.to(dtype))]

        want = grads(plain_attention, torch.float64)
        plain = grads(plain_attention, torch.float32)
        got = grads(flash_attention, torch.float32)
        errs = {}
        for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
            err = float((g.double() - w).abs().max())
            err_plain = float((p.double() - w).abs().max())
            check(err <= GRAD_FACTOR * err_plain,
                  f"flash gradient {model} {name}: max_abs_err {err} > "
                  f"{GRAD_FACTOR} x the plain float32 version's "
                  f"{err_plain}")
            errs[name] = (err, err_plain)
        del want, plain, got
        o = flash_fwd(q, k, v, causal=True, window=window)
        fwd_ms = time_ms(lambda: flash_fwd(q, k, v, causal=True,
                                           window=window))
        bwd_ms = time_ms(lambda: attention_grads(
            q, k, v, o, do, causal=True, window=window), reps=5, windows=3)
        peak = call_peak_mb(lambda: attention_grads(
            q, k, v, o, do, causal=True, window=window), dev)
        # the window (4096) does not bind at S 1024: the causal pairs
        _, f_ops = flash_work(B, S, H, K, hd, S, True)
        ops = f_ops * 5 // 2
        nbytes = 4 * (4 * B * S * H * hd + 4 * B * S * K * hd)
        b_ms, b_by = bound_ms(card, nbytes, ops, torch.float32)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        both_ms = time_ms(lambda: torch.autograd.grad(
            flash_attention(*xs, causal=True, window=window), xs, do),
            reps=5, windows=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=H != K),
            (qt, kt, vt), dot), reps=5, windows=3)
        log(f"flash gradient {model} (B {B}, S {S}, H {H}, K {K}, hd {hd}, "
            f"causal, window {window}): "
            + ", ".join(f"{n} max_abs_err {e:.3e} (plain float32 {p:.3e}, "
                        f"{e / p:.2f}x)" for n, (e, p) in errs.items())
            + f" against float64 autograd, bound {GRAD_FACTOR}x; forward "
            f"(flash_fwd) {fwd_ms:.4f} ms, backward (torch ops) "
            f"{bwd_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{ops / 1e9:.2f} GFLOP over the visible pairs, "
            f"{2 * ops / 1e9:.2f} over all the backward computes, "
            f"{nbytes / 1e6:.1f} MB), peak {peak:.1f} MB a call; forward "
            f"and backward through autograd {both_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms (scaled_dot_product_attention forward and "
            f"backward, float32)")
        out[model] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, bound_ms=b_ms,
                          bound_by=b_by, peak_mb=peak, fwd_bwd_ms=both_ms,
                          library_ms=lib_ms,
                          max_abs_err={n: e for n, (e, _) in errs.items()})
        del q, k, v, do, o, xs, qt, kt, vt
    return out


def train_stablelm(dev, spec: dict) -> dict:
    """``train_loop`` on ``spec``'s model at full width and depth on the
    card, from weights drawn there; with B 1 if B 2 does not fit.
    Returns the model, the batch and the loop's result."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.loop import train_loop
    cfg = get_config(spec["arch"])
    B = spec["batch"]
    while True:
        torch.cuda.reset_peak_memory_stats(dev)
        model = init_params(cfg, spec["seed"], device=dev)
        try:
            res = train_loop(cfg, steps=spec["steps"], batch=B,
                             seq_len=spec["seq_len"], lr=spec["lr"],
                             seed=spec["seed"], device=dev, params=model)
            break
        except torch.cuda.OutOfMemoryError as e:
            check(B > 1, f"train_stablelm: B 1 does not fit: {e}")
            log(f"train_stablelm: B {B} does not fit ({e}); B 1")
            del model
            torch.cuda.empty_cache()
            B = 1
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(len(res.losses) == spec["steps"]
          and all(math.isfinite(x) for x in res.losses),
          f"train_stablelm: losses {res.losses}")
    step_s = statistics.median(res.step_s[1:])
    log(f"train_stablelm ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
        f"parameters, AdamW, B {B} x S {spec['seq_len']}, no remat): "
        f"losses " + ", ".join(f"{x:.6f}" for x in res.losses)
        + f"; step seconds " + ", ".join(f"{t:.4f}" for t in res.step_s)
        + f"; {step_s:.4f} s a step (median of steps 2 to "
        f"{spec['steps']}), {B * spec['seq_len'] / step_s:.1f} tokens/s; "
        f"peak device memory {peak:.3f} GiB")
    return dict(model=model, batch=B, res=res, step_s=step_s, peak=peak)


def train_breakdown(dev, spec: dict, model, B: int, step_s: float) -> None:
    """Where a warm training step of ``model`` goes on the device, from
    torch.profiler: one whole ``make_train_step`` step (busy, kernels,
    the flash kernel's time, the products'), then the optimizer alone
    (clipping and AdamW on one step's gradients) and the backward's
    attention ops alone (``attention_grads`` once a layer at the step's
    shape) in windows of their own; the products less those of the
    attention window, and the rest.  The idle share is taken against the
    loop's untraced median step."""
    import torch
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import attention_grads, flash_fwd
    from repro_torch.models import forward_train
    from repro_torch.optim import adamw, clip_by_global_norm
    from repro_torch.train import make_train_step
    cfg, S = model.cfg, spec["seq_len"]
    opt = adamw(spec["lr"])
    step_fn, _ = make_train_step(cfg, opt, remat=False, chunk=256)
    named = dict(model.named_parameters())
    state = opt.init(named)
    batch = {k: torch.as_tensor(v, device=dev).long() for k, v in
             SyntheticTokens(cfg, B, S, spec["seed"]).batch_at(100).items()}
    step_fn(model, state, batch)                              # warm-up
    flash_fwd.launches = 0
    busy, n, kinds, _ = device_busy(
        lambda: step_fn(model, state, batch))
    check(flash_fwd.launches == cfg.n_layers,
          f"train_stablelm breakdown: {flash_fwd.launches} flash launches "
          f"a step")
    loss = forward_train(model, cfg, batch, remat=False)
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    del loss
    opt_busy, opt_n, _, _ = device_busy(lambda: opt.update(
        clip_by_global_norm(grads, 1.0)[0], state, named))
    del grads, state
    torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(1)
    H, hd = cfg.n_heads, cfg.hd
    q, k, v, do = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                   for _ in range(4))
    o = flash_fwd(q, k, v, causal=True)
    att_busy, att_n, att_kinds, _ = device_busy(lambda: [
        attention_grads(q, k, v, o, do, causal=True, window=0)
        for _ in range(cfg.n_layers)])
    if busy is None or opt_busy is None or att_busy is None:
        log("train_stablelm busy split: not measured (the profiler saw no "
            "kernels)")
        return
    k4 = kinds.get("flash_fwd", 0.0)
    products = kinds.get("products", 0.0) - att_kinds.get("products", 0.0)
    rest = busy - k4 - products - att_busy - opt_busy
    wall = step_s * 1e3
    parts = (("products (projections, MLP, LM head, forward and backward)",
              products), ("flash_fwd (K4)", k4),
             ("the backward's attention ops", att_busy),
             ("optimizer (clip and AdamW)", opt_busy), ("the rest", rest))
    log(f"train_stablelm warm step under torch.profiler: {n} kernels, "
        f"device busy {busy:.3f} ms against {wall:.3f} ms of untraced "
        f"step: the device idles {1 - busy / wall:.1%}; busy split "
        + ", ".join(f"{name} {t:.3f} ms ({t / busy:.1%})"
                    for name, t in parts)
        + f"; the optimizer's window {opt_n} kernels, the attention "
        f"backward's {att_n} ({cfg.n_layers} calls, its products "
        f"{att_kinds.get('products', 0.0):.3f} ms); busy by kind in the "
        f"step " + ", ".join(f"{k} {t:.3f} ms" for k, t in sorted(
            kinds.items(), key=lambda kv: -kv[1])))


def train_vs_cpu(dev, spec: dict) -> None:
    """One ``make_train_step`` step of ``spec``'s model (full width, cut
    to ``spec["layers"]``) on the card and on the CPU, the CPU handed the
    card's weights and the same batch: the losses within
    ``TRAIN_LOSS_RTOL``, and every parameter's gradient (as the optimizer
    receives it, after clipping) present and within ``LOGIT_TOL`` x max
    |CPU's|."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    model = init_params(cfg, spec["seed"], device=dev)
    cpu_model = copy.deepcopy(model).cpu()
    batch = SyntheticTokens(cfg, spec["batch"], spec["seq_len"],
                            spec["seed"]).batch_at(0)

    def step(params, device):
        seen = {}
        base = adamw(3e-4)

        def update(grads, state, named):
            seen.update({n: g.detach().to("cpu", copy=True)
                         for n, g in grads.items()})
            return base.update(grads, state, named)

        opt = Optimizer(base.init, update)
        fn, _ = make_train_step(cfg, opt, remat=False, chunk=256)
        state = opt.init(dict(params.named_parameters()))
        _, _, m = fn(params, state, {k: torch.as_tensor(v, device=device)
                                     .long() for k, v in batch.items()})
        return float(m["loss"]), float(m["grad_norm"]), seen

    loss, gnorm, g_card = step(model, dev)
    t0 = time.perf_counter()
    cpu_loss, cpu_gnorm, g_cpu = step(cpu_model, "cpu")
    cpu_s = time.perf_counter() - t0
    what = f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) vs CPU"
    names = [n for n, _ in cpu_model.named_parameters()]
    check(sorted(g_card) == sorted(g_cpu) == sorted(names),
          f"{what}: parameters without a gradient")
    rel = abs(loss - cpu_loss) / abs(cpu_loss)
    check(rel <= TRAIN_LOSS_RTOL, f"{what}: loss {loss} vs {cpu_loss}")
    worst, worst_name = 0.0, ""
    for n in names:
        scale = float(g_cpu[n].abs().max())
        check(scale > 0 and bool(torch.isfinite(g_card[n]).all()),
              f"{what}: gradient of {n} zero or not finite")
        err = float((g_card[n] - g_cpu[n]).abs().max()) / scale
        check(err <= LOGIT_TOL, f"{what}: gradient of {n} {err} > "
              f"{LOGIT_TOL} scaled")
        if err > worst:
            worst, worst_name = err, n
    log(f"{what} (B {spec['batch']} x S {spec['seq_len']}, one "
        f"make_train_step, the card's weights and batch): loss {loss:.7f} "
        f"vs {cpu_loss:.7f} ({rel:.3e} relative, bound "
        f"{TRAIN_LOSS_RTOL}); grad norm {gnorm:.6f} vs {cpu_gnorm:.6f}; "
        f"all {len(names)} parameters have a gradient, the largest "
        f"scaled error {worst:.3e} ({worst_name}, bound {LOGIT_TOL}); CPU "
        f"step {cpu_s:.1f} s")


def train_resume(dev, spec: dict) -> None:
    """Reduced ``spec`` model on the card: ``train_loop`` for 10 steps
    straight, and for 5 steps into a 4-host ``QuorumCheckpointer`` in a
    temporary directory, one host killed, then resumed to 10: every loss
    bitwise equal."""
    import tempfile
    from repro_torch.checkpoint import QuorumCheckpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.loop import train_loop
    cfg = reduced(get_config(spec["arch"]))
    kw = dict(batch=spec["batch"], seq_len=spec["seq_len"],
              seed=spec["seed"], device=dev)
    ref = train_loop(cfg, steps=10, **kw)
    with tempfile.TemporaryDirectory(prefix="train_resume_") as root:
        ck = QuorumCheckpointer(root, n_hosts=4, replication=3)
        a = train_loop(cfg, steps=5, ckpt=ck, ckpt_every=100,
                       async_ckpt=False, **kw)
        check(ck.latest_step() == 5, "train_resume: no step-5 checkpoint")
        ck.kill_host(1)
        b = train_loop(cfg, steps=10, ckpt=ck, ckpt_every=100,
                       async_ckpt=False, **kw)
    check(b.restored_from == 5, f"train_resume: resumed from "
          f"{b.restored_from}")
    check(a.losses + b.losses == ref.losses,
          f"train_resume: {a.losses + b.losses} != {ref.losses}")
    log(f"train_resume ({cfg.name}, B {spec['batch']} x S "
        f"{spec['seq_len']}): 10 steps straight and 5 + a stop + host1 of "
        f"4 killed + a resume from step {b.restored_from} to 10 through "
        f"the quorum checkpointer: all 10 losses bitwise equal (last "
        f"{ref.losses[-1]!r})")


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
            ms, call_ms = device_ms(run), time_ms(run)
            plain_ms = time_ms(lambda: paged_attention_online_ref(
                q, kp, vp, pt, ln), reps=1, windows=3)
            k4_ms = device_ms(k4)
            line += (f"; {ms:.4f} ms on the device (back-to-back calls "
                     f"{call_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by}: "
                     f"{nbytes / 1e6:.1f} MB of unique pages, "
                     f"{ops / 1e9:.3f} GFLOP; {nbytes / ms / 1e9:.3f} TB/s "
                     f"achieved), plain {plain_ms:.3f} ms, K4 over the "
                     f"contiguous copy ({B} calls) {k4_ms:.4f} ms, library "
                     f"- (no torch call reads through a page table)")
            out[case] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=errs["plain"],
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
    """(device busy ms, kernels, busy ms by kind, kernels by kind) of one
    call of ``fn`` under torch.profiler: the summed durations of the CUDA
    kernels it ran (one stream, so they do not overlap); (None, 0, {},
    {}) if the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None, 0, {}, {}
    kinds: dict = {}
    counts: dict = {}
    for e in kern:
        kind = next((k for frag, k in KERNEL_KINDS
                     if frag in e.name.lower()), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
        counts[kind] = counts.get(kind, 0) + 1
    return sum(kinds.values()), len(kern), kinds, counts


def spec_model(dev, spec: dict):
    """The model of a serve spec: its config, cut to ``spec["layers"]``
    (decoder) and ``spec["enc_layers"]`` (encoder) layers where given
    (every width kept), random weights drawn on the card from the spec's
    seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(spec["arch"])
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    if "enc_layers" in spec:
        cfg = dataclasses.replace(cfg, encoder_layers=spec["enc_layers"])
    return init_params(cfg, spec["seed"], device=dev)


class LaunchesInside:
    """Counts a kernel wrapper's launches made inside the calls of each
    group of modules (``groups``: name -> modules), by phase: a call
    whose input holds one position is a decode step's, any other a
    prefill's.  ``counts``: (group, phase) -> launches; the hooks are
    removed on leaving the ``with``."""

    def __init__(self, wrapper, groups: dict):
        self.wrapper, self.groups = wrapper, groups
        self.counts, self.started, self.hooks = {}, {}, []

    def __enter__(self):
        def pre(mod, args):
            self.started[mod] = self.wrapper.launches

        def post(group):
            def hook(mod, args, out):
                key = (group, "decode" if args[0].shape[1] == 1
                       else "prefill")
                self.counts[key] = (self.counts.get(key, 0)
                                    + self.wrapper.launches
                                    - self.started.pop(mod))
            return hook

        for group, mods in self.groups.items():
            for mod in mods:
                self.hooks += [mod.register_forward_pre_hook(pre),
                               mod.register_forward_hook(post(group))]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def serve_kwargs(spec: dict) -> dict:
    return {k: v for k, v in spec.items() if k not in DEPTH}


def serve_breakdown(dev, spec: dict, groups: dict, kernels: tuple,
                    params=None) -> dict:
    """Where a warm prefill and a warm decode step of ``spec``'s shape go:
    host wall per group of modules (``groups``: name -> a function of the
    model giving the modules whose calls make up the group; synchronized
    forward hooks, over the prefill and over one more decode step), the
    rest (embedding, final norm, LM head), the launches of each of
    ``kernels`` per call, the unhooked decode step's wall, and the
    device's busy share and kernel time by kind from torch.profiler.
    ``params``: the model (default ``spec_model``); random prompt tokens
    and, for the audio family, random frames, as serve."""
    import functools
    import torch
    from repro_torch.configs import AUDIO
    from repro_torch.launch.serve import KERNELS
    from repro_torch.models import decode_step
    from repro_torch.models import prefill as prefill_fn
    if params is None:
        params = spec_model(dev, spec)
    cfg = params.cfg
    B, S = spec["requests"], spec["prompt_len"]
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).to(dev)
    max_len = S + spec["gen_len"]
    frames = (torch.randn((B, S, cfg.d_model), generator=gen).to(dev)
              if cfg.family == AUDIO else None)
    prefill = functools.partial(prefill_fn, enc_frames=frames)
    logits, cache = prefill(params, cfg, toks, max_len=max_len)  # warm-up
    tok = logits[:, -1].argmax(-1, keepdim=True)
    del logits

    def hooked(fn) -> tuple:
        """(wall s, wall s per group) of one synchronized call of fn."""
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
        for group, mods in groups.items():
            for mod in mods(params):
                hooks += [mod.register_forward_pre_hook(pre),
                          mod.register_forward_hook(post(group))]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, spent
        finally:
            for h in hooks:
                h.remove()

    wrappers = {k: KERNELS[k] for k in kernels}
    for w in wrappers.values():
        w.launches = 0
    total, spent = hooked(lambda: prefill(params, cfg, toks,
                                          max_len=max_len))
    out = dict(prefill_s=total, groups=spent,
               prefill_launches={k: w.launches for k, w in wrappers.items()})
    decode_step(params, cfg, cache, tok)                   # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    out["decode_step_s"] = (time.perf_counter() - t0) / steps
    out["decode_launches"] = {k: w.launches / steps
                              for k, w in wrappers.items()}
    out["decode_hooked_s"], out["decode_groups"] = hooked(
        lambda: decode_step(params, cfg, cache, tok))
    for what, fn in (("prefill",
                      lambda: prefill(params, cfg, toks, max_len=max_len)),
                     ("decode", lambda: decode_step(params, cfg, cache,
                                                    tok))):
        t0 = time.perf_counter()
        (out[f"{what}_busy_ms"], out[f"{what}_kernels"],
         out[f"{what}_kinds"], out[f"{what}_counts"]) = device_busy(fn)
        out[f"{what}_traced_s"] = time.perf_counter() - t0
    if "flash_fwd" in wrappers and out["decode_busy_ms"] is not None:
        # one CUDA kernel a flash_fwd call, whatever its configuration
        n = out["decode_counts"].get("flash_fwd", 0)
        check(n == out["decode_launches"]["flash_fwd"],
              f"{spec['arch']}: {n} flash kernels under the profiler in a "
              f"decode step, {out['decode_launches']['flash_fwd']:g} "
              f"flash_fwd calls")
    return out


def log_breakdown(path: str, bd: dict, inner: tuple = ()) -> None:
    """``inner``: groups whose modules run inside another group's, left
    out of the sum that gives the rest."""
    def split(total, groups):
        rest = total - sum(t for g, t in groups.items() if g not in inner)
        return (", ".join(f"{g} {t:.4f} s ({t / total:.1%})"
                          for g, t in groups.items())
                + f", embedding, final norm and LM head {rest:.4f} s "
                f"({rest / total:.1%})")
    log(f"{path} warm prefill {bd['prefill_s']:.4f} s: "
        + split(bd["prefill_s"], bd["groups"])
        + "; kernel launches a prefill "
        + ", ".join(f"{k} {n}" for k, n in bd["prefill_launches"].items())
        + f"; warm decode step {bd['decode_step_s'] * 1e3:.3f} ms, kernel "
        f"launches a step "
        + ", ".join(f"{k} {n:g}" for k, n in bd["decode_launches"].items())
        + f"; one decode step under the hooks {bd['decode_hooked_s']:.4f} "
        f"s: " + split(bd["decode_hooked_s"], bd["decode_groups"]))
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
               + ", ".join(f"{k} {t:.3f} ms ({t / busy:.1%}, "
                           f"{bd[f'{what}_counts'][k]} kernels)" for k, t in
                           sorted(bd[f"{what}_kinds"].items(),
                                  key=lambda kv: -kv[1]))))


def serve_path(dev, spec: dict, launches: dict, params=None) -> dict:
    """Serve ``spec`` at full width on the card and check what comes out:
    token and logit shapes, finite logits, greedy tokens, the page pool,
    and each kernel's launches (``launches``: kernel -> (per prefill, per
    decode step)).  ``params``: the model to serve (a depth-cut one), or
    None for the one ``serve`` draws from the spec's seed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    kw = serve_kwargs(spec)
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve(device=dev, params=params, **kw)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cfg = get_config(spec["arch"])
    B, G = spec["requests"], spec["gen_len"]
    name = f"serve_{spec['arch'].split('-')[0]}"
    want = {k: {"prefill": pre, "decode": step * (G - 1)}
            for k, (pre, step) in launches.items()}
    for k, w in want.items():
        check(res["launches"][k] == w,
              f"{name}: {k} launches {res['launches'][k]}, expected {w}")
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
    depth = (f" ({params.cfg.n_layers} of {cfg.n_layers} layers, d_model "
             f"{cfg.d_model})" if params is not None else "")
    if cfg.encoder_layers:
        served = cfg if params is None else params.cfg
        depth = (f" ({served.encoder_layers} encoder and {served.n_layers} "
                 f"decoder layers, d_model {cfg.d_model}, "
                 f"{spec['prompt_len']} frames a request)")
    log(f"{name}{depth}: {B} requests x {spec['prompt_len']} prompt tokens "
        f"(shared prefix {spec['shared_prefix_len']}) + {G} generated; "
        f"prefill {res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s "
        f"({G - 1} steps, {res['decode_s'] / (G - 1) * 1e3:.3f} ms each), "
        f"{res['tok_per_s']:.1f} tok/s; peak device memory {peak:.3f} GiB; "
        + "; ".join(f"{k} launches {res['launches'][k]} (expected {w})"
                    for k, w in want.items())
        + f"; pool {res['pool']}; generated[0][:8] "
        f"{res['tokens'][0][:8].tolist()}")
    return res


def dropped_pairs(ids, n_experts: int, capacity: int) -> int:
    """(token, slot) pairs of expert ids (G, T, k) past their expert's
    capacity in their group: the pairs either dispatch drops."""
    import torch
    per = torch.nn.functional.one_hot(ids, n_experts).sum(dim=(1, 2))
    return int((per - capacity).clamp(min=0).sum())


def moe_phase(dev, layer, cfg) -> dict:
    """One full-width MoE layer (``layer``, the served model's first) on
    the card at the serve path's two shapes: prefill, each of 8
    sequences of 1024 tokens a group at the config's capacity factor,
    and decode, the batch of 8 as one group at max(cf, 2.0).  Both
    dispatches on the same seeded inputs, held to each other within
    ``MOE_TOL`` scaled, each timed with its peak memory a call; the
    pairs dropped at capacity are counted."""
    import torch
    from repro_torch.models import moe
    p = layer.params()
    gen = torch.Generator(dev).manual_seed(7)
    E, k, D, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    out = {}
    with torch.no_grad():    # the parameters require grad
        for shape, (G, T, cf) in (("prefill", (8, 1024, cfg.capacity_factor)),
                                  ("decode", (1, 8, max(cfg.capacity_factor,
                                                        2.0)))):
            x = torch.randn((G, T, D), generator=gen, device=dev)
            C = moe._capacity(T, E, k, cf)
            kw = dict(top_k=k, activation=cfg.activation, capacity_factor=cf)
            dropped = dropped_pairs(moe._top_k_gating(x, p["router"], k)[1],
                                    E, C)
            ys = {}
            for name, fn in (("einsum", moe.moe_apply_einsum),
                             ("sort", moe.moe_apply_sort)):
                ys[name] = fn(p, x, **kw)[0]
                peak = call_peak_mb(lambda: fn(p, x, **kw), dev)
                ms = time_ms(lambda: fn(p, x, **kw), reps=3, windows=3)
                out[shape, name] = dict(ms=ms, peak_mb=peak)
            err = float((ys["einsum"] - ys["sort"]).abs().max())
            bound = MOE_TOL * max(1.0, float(ys["einsum"].abs().max()))
            check(bool(torch.isfinite(ys["einsum"]).all()),
                  f"moe {shape}: not finite")
            check(err <= bound, f"moe {shape}: einsum vs sort max_abs_err "
                  f"{err} > {bound}")
            # the experts' products run every capacity slot, full or not
            expert_ops = 2 * G * E * C * D * F * (3 if cfg.activation ==
                                                   "swiglu" else 2)
            weights = sum(w.numel() for w in p["experts"].values()) * 4
            e, so = out[shape, "einsum"], out[shape, "sort"]
            log(f"moe {shape} (G {G}, T {T}, D {D}, E {E}, top-{k}, F {F}, "
                f"cf {cf}, C {C}; {dropped} of {G * T * k} pairs dropped at "
                f"capacity): einsum {e['ms']:.3f} ms (peak "
                f"{e['peak_mb']:.1f} MB a call), sort {so['ms']:.3f} ms "
                f"(peak {so['peak_mb']:.1f} MB); einsum vs sort max_abs_err "
                f"{err:.3e} (tol {MOE_TOL} x max(1, |einsum|)); the "
                f"experts' products {expert_ops / 1e12:.4f} TFLOP "
                f"({expert_ops / e['ms'] / 1e9:.2f} TFLOP/s in einsum), "
                f"their weights {weights / 1e9:.3f} GB "
                f"({weights / e['ms'] / 1e9:.3f} TB/s in einsum)")
            del x, ys
    return out


def router_watch(model) -> dict:
    """Forward hooks on every MoE layer of ``model`` that record, per
    call, the experts each token's router chose (the top k of its
    probabilities, as the layer computes them from the same input), the
    smallest gap between the k-th and (k+1)-th probability, where a
    float32 difference could flip the choice, and the (token, slot)
    pairs dropped at capacity in prefill and in decode."""
    import torch
    from repro_torch.models.moe import MoELayer, _capacity
    seen = {"ids": [], "gap": float("inf"), "hooks": [],
            "dropped": {"prefill": 0, "decode": 0}}

    def hook(mod, args, kwargs, out):
        x, k = args[0], kwargs["top_k"]
        E = mod.router.shape[-1]
        probs = torch.softmax((x @ mod.router).float(), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        ids = top.indices[..., :k]
        seen["ids"].append(ids.cpu())
        seen["gap"] = min(seen["gap"], float(
            (top.values[..., k - 1] - top.values[..., k]).min()))
        C = _capacity(x.shape[1], E, k, kwargs["capacity_factor"])
        # decode routes the batch as one group
        phase = "decode" if x.shape[0] == 1 else "prefill"
        seen["dropped"][phase] += dropped_pairs(ids, E, C)

    for mod in model.modules():
        if isinstance(mod, MoELayer):
            seen["hooks"].append(
                mod.register_forward_hook(hook, with_kwargs=True))
    return seen


def serve_vs_cpu(dev, spec: dict) -> None:
    """The card's serve run against a CPU run handed the card's weights
    and fed the card's tokens: logits within ``LOGIT_TOL``.  Also reads
    (does not check) the same comparison with TF32 matrix products, which
    the serve path leaves off, and for an MoE model the smallest
    2nd-to-3rd router probability gap on the card and how many routing
    choices the CPU run made otherwise."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve
    kw = serve_kwargs(spec)
    model = spec_model(dev, spec)
    cfg = model.cfg
    watch = router_watch(model)
    gpu = serve(device=dev, params=model, **kw)
    card_ids, watch["ids"] = watch["ids"], []
    for h in watch["hooks"]:
        h.remove()
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = serve(device=dev, params=model, teacher_tokens=gpu["tokens"],
                     **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    t0 = time.perf_counter()
    cpu_watch = router_watch(model.cpu())
    cpu = serve(device="cpu", params=model, teacher_tokens=gpu["tokens"],
                **kw)
    err = float(np.max(np.abs(gpu["logits"] - cpu["logits"])))
    bound = LOGIT_TOL * max(1.0, float(np.max(np.abs(cpu["logits"]))))
    enc = (f"{cfg.encoder_layers} encoder and " if cfg.encoder_layers
           else "")
    dec = " decoder" if cfg.encoder_layers else ""
    what = (f"{cfg.name} ({enc}{cfg.n_layers}{dec} layers, d_model "
            f"{cfg.d_model}) vs CPU")
    routing = ""
    if card_ids:
        check(len(card_ids) == len(cpu_watch["ids"]),
              f"{what}: MoE calls differ")
        moved = sum(int((a != b).sum()) for a, b in
                    zip(card_ids, cpu_watch["ids"]))
        total = sum(a.numel() for a in card_ids)
        routing = (f"; router: smallest gap between the top-{cfg.top_k} "
                   f"and the next probability on the card "
                   f"{watch['gap']:.3e}, the CPU's expert choices differ "
                   f"in {moved} of {total}; pairs dropped at capacity on "
                   f"the card {watch['dropped']}")
    check(err <= bound, f"{what}: logits max_abs_err {err} > {bound}"
          + routing)
    agree = float(np.mean(gpu["tokens"] == cpu["logits"].argmax(-1)))
    tf32_err = float(np.max(np.abs(tf32["logits"] - cpu["logits"])))
    log(f"{what} ({kw['requests']} requests x {kw['prompt_len']} tokens + "
        f"{kw['gen_len']}, teacher-forced with the card's tokens, the "
        f"card's weights): logits max_abs_err {err:.3e} <= {bound:.3e}; "
        f"card's tokens = CPU argmax for {agree:.0%}; CPU run "
        f"{time.perf_counter() - t0:.1f} s; with allow_tf32=True "
        f"{tf32_err:.3e}, {'above' if tf32_err > bound else 'within'} the "
        f"bound{routing}")


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
        busy, kernels, kinds, _ = device_busy(
            lambda: fn(**kw, device=dev))
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


def closed_blocks_phase(dev, smi: str, drive) -> None:
    """The closed sweep in point blocks: ``benchmarks/run.py``'s
    per-device scaling grid (``CLOSED_BLOCKS``, 16 points) at one block
    and at one block a visible GPU, each run cold (the path, its K2
    launches counted) and warm (timed), every column of every run
    bitwise equal to the first; the same grid's blocks in turn on the
    CPU within ``SWEEP_RTOL``; one device past the visible ones raises
    ``ValueError``.  The counterpart of ``sim.per_device_scaling.d*``:
    logged, never gated."""
    import numpy as np
    import torch
    from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
    from repro_torch.sim.sweep import closed_grid, run_sweep

    grid = closed_grid(**CLOSED_BLOCKS)
    count = torch.cuda.device_count()

    def sweep(devices, device=dev):
        return run_sweep(grid, loop="closed", seed=0, devices=devices,
                         device=device)

    def runs():
        out = {}
        for D in dict.fromkeys((1, count)):
            n0 = mp_kernel.maxplus_seq.launches
            cold = sweep(D)
            n_cold = mp_kernel.maxplus_seq.launches - n0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = sweep(D)
            torch.cuda.synchronize()
            out[D] = (cold, n_cold, warm, time.perf_counter() - t0)
        return out

    by_d = drive("closed_blocks", ("maxplus_seq",), runs)
    first = by_d[1][0]
    check(first.info["rounds"] is not None,
          "closed_blocks: the grid took the host (eviction) path")
    for D, (cold, n_cold, warm, warm_s) in by_d.items():
        check(cold.info["rounds"] is not None and n_cold > 0,
              f"closed_blocks devices={D}: no maxplus_seq launch")
        for tag, res in (("cold", cold), ("warm", warm)):
            for k, w in first.columns.items():
                check(np.array_equal(res.columns[k], w, equal_nan=True),
                      f"closed_blocks devices={D} {tag}: column {k} not "
                      f"bitwise equal to devices=1")
        i = cold.info
        log(f"closed_blocks devices={D}: {len(grid)} points "
            f"({CLOSED_BLOCKS}), {int(cold.columns['ops'].sum())} ops, "
            f"{i['blocks']} block(s) of grid {i['grid']}, {i['rounds']} "
            f"rounds, {n_cold} maxplus_seq launches; cold wall "
            f"{cold.walltime_s:.3f} s (host {i['host_s']:.3f} s of which "
            f"planning {i['plan_s']:.3f} s, device {i['device_s']:.3f} s), "
            f"warm wall {warm_s:.3f} s (device {warm.info['device_s']:.3f}"
            f" s); every column bitwise equal to devices=1 [{smi}]")
    t0 = time.perf_counter()
    cpu = sweep(2, "cpu")
    cpu_s = time.perf_counter() - t0
    err = columns_close(cpu, first, "closed_blocks the CPU's 2 blocks")
    check(cpu.info["rounds"] == first.info["rounds"],
          "closed_blocks: the CPU's blocks took other rounds")
    try:
        sweep(count + 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"closed_blocks: devices={count + 1} with "
                             f"{count} GPU(s) did not raise ValueError")
    log(f"closed_blocks: the CPU's 2 blocks in turn within {err:.3e} of "
        f"the card's ({cpu_s:.3f} s), same rounds; devices={count + 1} "
        f"raises ValueError ({refused})")


# keys profile_maxplus returns for a CUDA device
OBS_KEYS = {"compile_s", "traces", "argument_bytes", "output_bytes",
            "build_s", "device_ms", "peak_bytes", "rows", "n"}


def obs_phase(dev, smi: str, drive, scan_grid: tuple) -> None:
    """``repro_torch.obs``: ``profile_maxplus`` for K1 and K2 at its
    default (8, 4096) and at ``fig_scale``'s scan grid, every CUDA key
    present and positive, each ``device_ms`` beside this script's own
    ``device_ms`` of the kernel on the same inputs; one cold
    ``profile_maxplus`` in a fresh process (its ``compile_s`` holds the
    kernels' load, ``build_s``); the trace CLI on the committed sample."""
    import os
    import torch
    from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
    from repro_torch.obs import profile_maxplus
    from repro_torch.obs.profile import window

    cases = [(b, rows, n) for b in ("cuda", "ref")
             for rows, n in ((8, 4096), scan_grid)]
    profs = drive("obs", ("maxplus_chunked", "maxplus_seq"), lambda: {
        c: profile_maxplus(n=c[2], rows=c[1], backend=c[0], device=dev)
        for c in cases})
    for (backend, rows, n), p in profs.items():
        check(set(p) == OBS_KEYS, f"obs {backend} ({rows}, {n}): keys "
              f"{sorted(set(p) ^ OBS_KEYS)} differ")
        check(all(p[k] > 0 for k in OBS_KEYS - {"build_s"})
              and p["build_s"] >= 0,
              f"obs {backend} ({rows}, {n}): a key not positive: {p}")
        wrapper = (mp_kernel.maxplus_chunked if backend == "cuda"
                   else mp_kernel.maxplus_seq)
        a = torch.linspace(0.0, 1.0, rows * n, dtype=torch.float64,
                           device=dev).reshape(rows, n)
        s = torch.full((rows, n), 1e-4, dtype=torch.float64, device=dev)
        own = device_ms(lambda: wrapper(a, s))
        log(f"obs profile_maxplus backend={backend} ({wrapper.__name__}) "
            f"({rows}, {n}) float64: device_ms {p['device_ms']:.4f} (this "
            f"script's device_ms of the kernel on the same inputs "
            f"{own:.4f}), first call {p['compile_s'] * 1e3:.3f} ms (build "
            f"{p['build_s']:.3f} s), peak {p['peak_bytes'] / 1e6:.3f} MB, "
            f"{p['argument_bytes'] / 1e6:.3f} MB in, "
            f"{p['output_bytes'] / 1e6:.3f} MB out [{smi}]")
    # where torch.profiler loses records: K2's records in each third of
    # 5 timing windows of 3 x 20 calls
    a = torch.linspace(0.0, 1.0, 8 * 4096, dtype=torch.float64,
                       device=dev).reshape(8, 4096)
    s = torch.full((8, 4096), 1e-4, dtype=torch.float64, device=dev)
    thirds = [[sum(n for n, _ in t.values()) for t in window(
        lambda: mp_kernel.maxplus_seq(a, s), 20)] for _ in range(5)]
    log(f"obs: torch.profiler's maxplus_seq records in the thirds of 5 "
        f"windows of 3 x 20 calls, {time.perf_counter() - STARTED:.0f} s "
        f"into the process: {thirds}")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = ("import json; from repro_torch.obs import profile_maxplus; "
            "print(json.dumps(profile_maxplus()))")
    cold = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(cold.returncode == 0, f"obs cold profile_maxplus: {cold.stderr}")
    p = json.loads(cold.stdout.strip().splitlines()[-1])
    check(set(p) == OBS_KEYS and p["build_s"] > 0,
          f"obs cold profile_maxplus in a fresh process: {p}")
    log(f"obs profile_maxplus in a fresh process (K1, (8, 4096)): first "
        f"call {p['compile_s']:.4f} s, of which the kernels' load "
        f"{p['build_s']:.4f} s (built already); device_ms "
        f"{p['device_ms']:.4f} [{smi}]")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize",
         "benchmarks/sample_trace.json"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    check(cli.returncode == 0, f"obs CLI: rc {cli.returncode}: "
          f"{cli.stderr}")
    log(f"obs: python -m repro_torch.obs summarize "
        f"benchmarks/sample_trace.json rc 0, "
        f"{len(cli.stdout.splitlines())} lines")


def analysis_phase() -> None:
    """``repro_torch.analysis`` over ``src/repro_torch`` in a fresh
    interpreter: exit 0 and no finding, or the run fails."""
    import os
    from repro_torch.analysis import RULES, iter_py_files

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--json"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"analysis: rc {proc.returncode}: "
          f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    findings = json.loads(proc.stdout)
    check(findings == [], f"analysis: findings {findings}")
    files = sum(1 for _ in iter_py_files([SRC / "repro_torch"]))
    log(f"analysis: python -m repro_torch.analysis src/repro_torch: "
        f"{len(RULES)} rules, {files} files, {len(findings)} findings, "
        f"{seconds:.3f} s")


def main() -> int:
    import torch
    mode = sys.argv[1:]
    if mode not in ([], ["--kernels"], ["--closed-blocks"]):
        print("usage: chip_smoke.py [--kernels | --closed-blocks]",
              file=sys.stderr)
        return 2
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
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    smi = cards[0]
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

    wrappers = {"maxplus_chunked": mp_kernel.maxplus_chunked,
                "maxplus_seq": mp_kernel.maxplus_seq,
                "ssd_chunked": ssm_scan_kernel, "flash_fwd": flash_fwd,
                "paged_decode": paged_decode}
    by_path: dict = {name: {} for name in wrappers}

    def drive(path: str, needs: tuple, fn):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
        for name, w in wrappers.items():
            by_path[name][path] = w.launches
        log(f"{path}: launches " + ", ".join(
            f"{n}={w.launches}" for n, w in wrappers.items()))
        for name in needs:
            check(wrappers[name].launches > 0,
                  f"{path}: {name} was never launched")
        return res

    if mode == ["--closed-blocks"]:
        closed_blocks_phase(dev, smi, drive)
        log(f"--closed-blocks: that phase alone on "
            f"{torch.cuda.device_count()} GPU(s) ({'; '.join(cards)}); "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0

    # ---------------------------------------------------- kernels alone
    kernels = kernel_phase(card, dev)
    kernels["ssd_chunked"] = ssd_kernel_phase(card, dev)
    kernels["flash_fwd"] = flash_kernel_phase(card, dev)
    kernels["flash_fwd"]["hd64_audio"] = flash_audio_phase(card, dev)
    kernels["flash_fwd"]["gradient"] = flash_grad_phase(card, dev)
    kernels["paged_decode"] = paged_kernel_phase(card, dev)
    if mode == ["--kernels"]:
        log(f"--kernels: the kernel phases only, no path driven; "
            f"{time.perf_counter() - t_start:.1f} s")
        check_profiler_records()
        return 0

    analysis_phase()

    # ---------------------------------------------------- open loop
    # the card's run first, so it plans with cold host memos
    grid = sweep_grid()
    gpu = drive("open_64", ("maxplus_chunked",),
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
        res = drive(path, ("maxplus_seq",), lambda: run_sweep(
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
            ms = device_ms(lambda: mp_kernel.maxplus_chunked(a, s))
        else:
            got, plain = mp_kernel.maxplus_seq(a, s), maxplus_depart_ref(a, s)
            check(torch.equal(got, plain), f"{path} shape: K2 not bitwise")
            ms = device_ms(lambda: mp_kernel.maxplus_seq(a, s))
        b_ms, b_by = bound_ms(card, 3 * a.numel() * 8, 2 * a.numel(),
                              torch.float64)
        share = by_path[name][path] * ms * 1e-3 / info["device_s"]
        log(f"{path} scan shape ({R}, {L}) float64: {name} {ms:.4f} ms per "
            f"launch, bound {b_ms:.4f} ms ({b_by}), matches its plain "
            f"version; x {by_path[name][path]} launches = {share:.1%} of the "
            f"path's device time")

    # --------------------------- closed loop in point blocks, and obs
    closed_blocks_phase(dev, smi, drive)
    obs_phase(dev, smi, drive, tuple(infos["fig_scale"]["grid"]))

    # ------------------------------------------ figures: the path's end
    # (check_figures holds each figure's own launches: maxplus_seq's too)
    figs = drive("figures", ("maxplus_chunked",),
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
    drive("serve_xlstm", ("ssd_chunked",),
          lambda: serve_path(dev, SERVE, {"ssd_chunked": (2 * n_mlstm, 0)}))
    k3 = kernels["ssd_chunked"]
    scan_s = n_mlstm * (k3["ms"] + k3["denominator"]["ms"]) / 1e3
    bd = serve_breakdown(dev, SERVE, {"mLSTM": lambda m: m.mlstm_layers,
                                      "sLSTM": lambda m: m.slstm_layers},
                         ("ssd_chunked",))
    check(bd["prefill_launches"]["ssd_chunked"] == 2 * n_mlstm,
          f"serve_xlstm breakdown: {bd['prefill_launches']} SSD launches")
    log_breakdown("serve_xlstm", bd)
    log(f"serve_xlstm: of the warm prefill, the SSD kernel {scan_s:.4f} s "
        f"= {n_mlstm} x (numerator {k3['ms']:.4f} + denominator "
        f"{k3['denominator']['ms']:.4f}) ms from the kernel phase, "
        f"{scan_s / bd['prefill_s']:.1%}")

    dcfg = get_config(SERVE_DENSE["arch"])
    L = dcfg.n_layers
    # one attention call a layer, in prefill and in each decode step
    drive("serve_stablelm", ("flash_fwd",),
          lambda: serve_path(dev, SERVE_DENSE, {"flash_fwd": (L, L)}))
    check(by_path["flash_fwd"]["serve_stablelm"]
          == L * SERVE_DENSE["gen_len"],
          f"serve_stablelm: {by_path['flash_fwd']['serve_stablelm']} flash "
          f"launches, expected {L} x {SERVE_DENSE['gen_len']} passes")
    torch.cuda.empty_cache()
    bd = serve_breakdown(dev, SERVE_DENSE,
                         {"decoder layers": lambda m: m.layers},
                         ("flash_fwd",))
    check(bd["prefill_launches"] == {"flash_fwd": L}
          and bd["decode_launches"] == {"flash_fwd": L},
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
    drive("paged_stablelm", ("paged_decode",),
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

    # ----------------------------- the hybrid family, full width
    hcfg = get_config(SERVE_HYBRID["arch"])
    Lh = hcfg.n_layers
    n_app = Lh // hcfg.shared_attn_every
    both = ("ssd_chunked", "flash_fwd")
    # one Mamba2 scan a layer in prefill (decode takes a recurrence step
    # in plain torch), one attention call a shared-block application in
    # prefill and in each decode step; the tail layers have none
    drive("serve_zamba2", both, lambda: serve_path(
        dev, SERVE_HYBRID, {"ssd_chunked": (Lh, 0),
                            "flash_fwd": (n_app, n_app)}))
    check(by_path["flash_fwd"]["serve_zamba2"]
          == n_app * SERVE_HYBRID["gen_len"],
          f"serve_zamba2: {by_path['flash_fwd']['serve_zamba2']} flash "
          f"launches, expected {n_app} x {SERVE_HYBRID['gen_len']} passes")
    torch.cuda.empty_cache()
    bd = serve_breakdown(dev, SERVE_HYBRID,
                         {"Mamba2 layers": lambda m: m.layers,
                          "shared attention": lambda m: [m.shared_attn]},
                         both)
    check(bd["prefill_launches"] == {"ssd_chunked": Lh, "flash_fwd": n_app}
          and bd["decode_launches"] == {"ssd_chunked": 0,
                                        "flash_fwd": n_app},
          f"serve_zamba2 breakdown: launches {bd['prefill_launches']} a "
          f"prefill, {bd['decode_launches']} a decode step")
    log_breakdown("serve_zamba2", bd)
    k3m, k4h = kernels["ssd_chunked"]["mamba2"], k4["hd64"]
    log(f"serve_zamba2: from the kernel phase, the SSD kernel is {Lh} x "
        f"{k3m['ms']:.4f} ms = {Lh * k3m['ms'] / 1e3:.4f} s and attention "
        f"{n_app} x {k4h['prefill']['ms']:.4f} ms = "
        f"{n_app * k4h['prefill']['ms'] / 1e3:.4f} s of the warm prefill "
        f"({(Lh * k3m['ms'] + n_app * k4h['prefill']['ms']) / 1e3 / bd['prefill_s']:.1%}"
        f" together); attention {n_app} x {k4h['decode']['ms']:.4f} ms = "
        f"{n_app * k4h['decode']['ms']:.3f} ms of a decode step "
        f"({n_app * k4h['decode']['ms'] / 1e3 / bd['decode_step_s']:.1%})")
    del bd
    torch.cuda.empty_cache()

    # --------------------- the audio family, full width and full depth
    acfg = get_config(SERVE_AUDIO["arch"])
    La, Le, Ga = acfg.n_layers, acfg.encoder_layers, SERVE_AUDIO["gen_len"]
    # prefill: one self-attention call an encoder layer, one self- and one
    # cross-attention call a decoder layer; decode: the decoder's two
    a_pre, a_step = Le + 2 * La, 2 * La
    # the serve's model (the one serve draws from the seed), hooked to
    # count the flash launches inside each stack and each cross-attention
    model = spec_model(dev, SERVE_AUDIO)
    with LaunchesInside(flash_fwd, {
            "encoder": model.enc_layers, "decoder": model.layers,
            "cross": [lay.xattn for lay in model.layers]}) as inside:
        drive("serve_seamless", ("flash_fwd",), lambda: serve_path(
            dev, SERVE_AUDIO, {"ssd_chunked": (0, 0),
                               "flash_fwd": (a_pre, a_step)},
            params=model))
    n_in = inside.counts
    k4a = kernels["flash_fwd"]["hd64_audio"]
    for case, group, phase in (("encoder self", "encoder", "prefill"),
                               ("decoder self", "decoder", "prefill"),
                               ("cross prefill", "cross", "prefill"),
                               ("decoder self decode", "decoder", "decode"),
                               ("cross decode", "cross", "decode")):
        n = n_in.get((group, phase), 0)
        if group == "decoder":      # the decoder layer's calls less its
            n -= n_in.get(("cross", phase), 0)      # cross-attention's
        k4a[case]["launches"] = n
    want = {"encoder self": Le, "decoder self": La, "cross prefill": La,
            "decoder self decode": La * (Ga - 1),
            "cross decode": La * (Ga - 1)}
    got = {case: k4a[case]["launches"] for case in want}
    n_a = by_path["flash_fwd"]["serve_seamless"]
    check(got == want and n_a == sum(got.values())
          and by_path["ssd_chunked"]["serve_seamless"] == 0,
          f"serve_seamless: flash launches by call {got}, expected {want}; "
          f"{n_a} in all")
    log(f"serve_seamless: flash launches counted inside the modules: "
        + ", ".join(f"{c} {n}" for c, n in got.items())
        + f" (expected {Le}, {La}, {La}, {La} x {Ga - 1}, {La} x "
        f"{Ga - 1}), {n_a} in all, none outside them")
    torch.cuda.empty_cache()
    bd = serve_breakdown(dev, SERVE_AUDIO,
                         {"encoder layers": lambda m: m.enc_layers,
                          "decoder layers": lambda m: m.layers,
                          "cross-attention": lambda m: [
                              lay.xattn for lay in m.layers]},
                         both, params=model)
    check(bd["prefill_launches"] == {"ssd_chunked": 0, "flash_fwd": a_pre}
          and bd["decode_launches"] == {"ssd_chunked": 0,
                                        "flash_fwd": a_step},
          f"serve_seamless breakdown: launches {bd['prefill_launches']} a "
          f"prefill, {bd['decode_launches']} a decode step")
    log_breakdown("serve_seamless", bd, inner=("cross-attention",))
    for what, total, groups in (
            ("warm prefill", bd["prefill_s"], bd["groups"]),
            ("decode step under the hooks", bd["decode_hooked_s"],
             bd["decode_groups"])):
        enc_s, x_s = groups["encoder layers"], groups["cross-attention"]
        dec_s = groups["decoder layers"] - x_s
        rest = total - enc_s - groups["decoder layers"]
        log(f"serve_seamless {what} {total:.4f} s: encoder layers "
            f"{enc_s:.4f} s ({enc_s / total:.1%}), decoder self-attention "
            f"and MLP {dec_s:.4f} s ({dec_s / total:.1%}), cross-attention "
            f"(lnx excluded) {x_s:.4f} s ({x_s / total:.1%}), embedding, "
            f"final norm and LM head {rest:.4f} s ({rest / total:.1%})")
    pre_ms = Le * k4a["encoder self"]["ms"] + La * (
        k4a["decoder self"]["ms"] + k4a["cross prefill"]["ms"])
    step_ms = La * (k4a["decoder self decode"]["ms"]
                    + k4a["cross decode"]["ms"])
    log(f"serve_seamless: from the kernel phase, attention is {Le} x "
        f"{k4a['encoder self']['ms']:.4f} + {La} x "
        f"({k4a['decoder self']['ms']:.4f} + "
        f"{k4a['cross prefill']['ms']:.4f}) ms = {pre_ms:.3f} ms of the "
        f"warm prefill ({pre_ms / 1e3 / bd['prefill_s']:.1%}) and {La} x "
        f"({k4a['decoder self decode']['ms']:.4f} + "
        f"{k4a['cross decode']['ms']:.4f}) ms = {step_ms:.3f} ms of a "
        f"decode step ({step_ms / 1e3 / bd['decode_step_s']:.1%})")
    del bd, model
    torch.cuda.empty_cache()

    # ----------------------- the MoE family, full width, 8 of 32 layers
    # every earlier path's model is freed: 47.5 GB of weights must fit
    log(f"before serve_mixtral: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved")
    model = spec_model(dev, SERVE_MOE)
    Lm = model.cfg.n_layers
    # one attention call a layer in prefill and in each decode step; the
    # experts run in plain products
    drive("serve_mixtral", ("flash_fwd",), lambda: serve_path(
        dev, SERVE_MOE, {"ssd_chunked": (0, 0), "flash_fwd": (Lm, Lm)},
        params=model))
    check(by_path["flash_fwd"]["serve_mixtral"] == Lm * SERVE_MOE["gen_len"]
          and by_path["ssd_chunked"]["serve_mixtral"] == 0,
          f"serve_mixtral: {by_path['flash_fwd']['serve_mixtral']} flash "
          f"launches, expected {Lm} x {SERVE_MOE['gen_len']} passes")
    torch.cuda.empty_cache()
    bd = serve_breakdown(dev, SERVE_MOE,
                         {"decoder layers": lambda m: m.layers,
                          "MoE": lambda m: [lay.moe for lay in m.layers]},
                         both, params=model)
    check(bd["prefill_launches"] == {"ssd_chunked": 0, "flash_fwd": Lm}
          and bd["decode_launches"] == {"ssd_chunked": 0, "flash_fwd": Lm},
          f"serve_mixtral breakdown: launches {bd['prefill_launches']} a "
          f"prefill, {bd['decode_launches']} a decode step")
    log_breakdown("serve_mixtral", bd, inner=("MoE",))
    for what, total, groups in (
            ("warm prefill", bd["prefill_s"], bd["groups"]),
            ("decode step under the hooks", bd["decode_hooked_s"],
             bd["decode_groups"])):
        moe_s = groups["MoE"]
        attn_s = groups["decoder layers"] - moe_s
        rest = total - groups["decoder layers"]
        log(f"serve_mixtral {what} {total:.4f} s: attention (the layers "
            f"less MoE: norms, projections, RoPE, K4) {attn_s:.4f} s "
            f"({attn_s / total:.1%}), MoE (router, dispatch, experts, "
            f"combine) {moe_s:.4f} s ({moe_s / total:.1%}), embedding, "
            f"final norm and LM head {rest:.4f} s ({rest / total:.1%})")
    k4g = k4["hd128_gqa"]
    log(f"serve_mixtral: from the kernel phase, attention is {Lm} x "
        f"{k4g['prefill']['ms']:.4f} ms = {Lm * k4g['prefill']['ms']:.3f} ms"
        f" of the warm prefill "
        f"({Lm * k4g['prefill']['ms'] / 1e3 / bd['prefill_s']:.1%}) and {Lm}"
        f" x {k4g['decode']['ms']:.4f} ms = {Lm * k4g['decode']['ms']:.3f} "
        f"ms of a decode step "
        f"({Lm * k4g['decode']['ms'] / 1e3 / bd['decode_step_s']:.1%})")
    moe_phase(dev, model.layers[0].moe, model.cfg)
    del bd, model
    torch.cuda.empty_cache()

    # ------------------------- the card's serve runs against the CPU's
    serve_vs_cpu(dev, SERVE_VS_CPU)
    serve_vs_cpu(dev, SERVE_DENSE_VS_CPU)
    serve_vs_cpu(dev, SERVE_HYBRID_VS_CPU)
    serve_vs_cpu(dev, SERVE_MOE_VS_CPU)
    serve_vs_cpu(dev, SERVE_AUDIO_VS_CPU)
    torch.cuda.empty_cache()

    # ------------------------------------- training, full width and depth
    tcfg = get_config(TRAIN["arch"])
    tr = drive("train_stablelm", ("flash_fwd",),
               lambda: train_stablelm(dev, TRAIN))
    n_flash = by_path["flash_fwd"]["train_stablelm"]
    check(n_flash == tcfg.n_layers * TRAIN["steps"],
          f"train_stablelm: {n_flash} flash launches, expected "
          f"{tcfg.n_layers} x {TRAIN['steps']} steps")
    log(f"train_stablelm: flash_fwd {n_flash / TRAIN['steps']:g} launches "
        f"a step (expected {tcfg.n_layers}, one a layer's forward; the "
        f"backward launches none)")
    train_breakdown(dev, TRAIN, tr["model"], tr["batch"], tr["step_s"])
    g = kernels["flash_fwd"]["gradient"][TRAIN["arch"]]
    log(f"train_stablelm: from the gradient phase, the backward's attention "
        f"is {tcfg.n_layers} x {g['bwd_ms']:.4f} ms = "
        f"{tcfg.n_layers * g['bwd_ms']:.3f} ms a step and K4 "
        f"{tcfg.n_layers} x {g['fwd_ms']:.4f} ms = "
        f"{tcfg.n_layers * g['fwd_ms']:.3f} ms, of {tr['step_s'] * 1e3:.3f}"
        f" ms")
    del tr
    torch.cuda.empty_cache()
    drive("train_vs_cpu", ("flash_fwd",),
          lambda: train_vs_cpu(dev, TRAIN_VS_CPU))
    drive("train_resume", ("flash_fwd",),
          lambda: train_resume(dev, TRAIN_RESUME))

    for name, k in kernels.items():
        k["launches"] = sum(by_path[name].values())
        k["launches_by_path"] = by_path[name]
    check_profiler_records()
    log(f"total smoke time {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
