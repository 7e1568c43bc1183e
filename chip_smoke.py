#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain PyTorch version on the card and times it,
then drives the port's main path, the batched sweep engine, through its
entry point ``run_sweep``:

* open loop: the 64-point ``sweep_grid()``, checked <= 1e-9 per column
  against the same grid run by the port on the CPU (plain versions);
* closed loop ``fig_scale``: 100 groups x 100 threads, 100k ops, checked
  <= 1e-9 per column against the port's CPU run of the same point, and
  against the committed ``fig_scale`` rows of ``BENCH_sweep.json``;
* closed loop ``fig_scale_1m``: 1000 groups x 1000 threads = 1M clients,
  5M ops, checked against the committed ``fig_scale_1m`` rows.

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
# bytes/s; float64 and float32 operations/s outside the tensor cores.
PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, float64=25.6e12, float32=51.2e12),
    "H100": dict(bytes=3.35e12, float64=34e12, float32=67e12),
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


def columns_close(got, want, what: str) -> float:
    """Every column of sweep result ``got`` within ``SWEEP_RTOL`` of
    ``want`` (relative, absolute below 1), nan where ``want`` is nan;
    returns the largest error."""
    import numpy as np
    check(set(got.columns) == set(want.columns), f"{what}: column names")
    worst = 0.0
    for k, w in want.columns.items():
        g = got.columns[k]
        check(g.shape == w.shape and np.array_equal(np.isnan(g),
                                                    np.isnan(w)),
              f"{what} column {k}: shape or nan pattern differs")
        ok = ~np.isnan(w)
        err = float(np.max(np.abs(g[ok] - w[ok])
                           / np.maximum(1, np.abs(w[ok])), initial=0.0))
        check(err <= SWEEP_RTOL, f"{what} column {k}: rel err {err}")
        worst = max(worst, err)
    return worst


def committed_rows(path: str) -> dict:
    """``BENCH_sweep.json``'s rows of ``path`` that a sweep column gives:
    metric -> (committed value, tolerance).  The p99 row rides in the p95
    row's ``derived`` field as ``p99=...``."""
    rows = json.loads((ROOT / "BENCH_sweep.json").read_text())["rows"]
    found = {}
    for r in rows:
        pre, _, metric = r["name"].partition(".")
        if pre != path:
            continue
        pairs = [(metric, r["value"])] + [
            tuple(kv.split("=", 1)) for kv in r["derived"].split(";")
            if kv.startswith("p99=")]
        for m, text in pairs:
            m = "p99_latency_ms" if m == "p99" else m
            if m in ROW_COLUMNS:
                decimals = len(text.partition(".")[2])
                found[m] = (float(text),
                            max(ROW_TOL, 0.5 * 10.0 ** -decimals))
    need = {"write_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "throughput_ops"}
    check(need <= set(found), f"BENCH_sweep.json lacks {path} rows "
          f"{sorted(need - set(found))}")
    return found


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
            if tag == "float64":
                kernels[name] = dict(
                    name=name, route="cuda",
                    source=f"src/repro_torch/kernels/maxplus_scan/csrc/"
                           f"{name}.cu",
                    replaces=replaces, launches=0,
                    max_abs_err=c["max_abs_err"], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return kernels


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
    from repro_torch.kernels.maxplus_scan import kernel as mp_kernel
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
    mp_kernel.build()
    log(f"kernel build (nvcc, one per source, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for src, text in mp_kernel.BUILD_LOG.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {src}: {ln.strip()}")

    # ---------------------------------------------------- kernels alone
    kernels = kernel_phase(card, dev)
    wrappers = {"maxplus_chunked": mp_kernel.maxplus_chunked,
                "maxplus_seq": mp_kernel.maxplus_seq}
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
        rows = committed_rows(path)
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
