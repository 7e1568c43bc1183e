"""First-call / call-count / device-time / device-memory profiling for
the port's kernels.

PyTorch has no ahead-of-time compile step like JAX's
``jit(...).lower(...).compile()``: a call runs eagerly, and the CUDA
kernels are built and loaded at their first launch
(:mod:`repro_torch.kernels.cuda_build`).  So :func:`profile_compile`
times the first, cold call (the build included, and named), then
measures a warm call on the device.  Keys a device cannot give stay
absent from the result, as in the reference: XLA's ``trace_lower_s``,
``flops``, ``bytes_accessed`` and ``generated_code_bytes`` have no
counterpart here, and ``device_ms``, ``peak_bytes`` and ``build_s``
exist only for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from ..device import resolve_device
from .clock import walltime


class TraceCounter:
    """Wrap ``fn`` so each call of its Python body bumps ``.traces``.
    PyTorch runs eagerly, so that is every call (under JAX's jit, the
    reference's counter sees only retraces)."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.traces = 0
        functools.update_wrapper(self, fn)

    def __call__(self, *args: Any, **kw: Any) -> Any:
        self.traces += 1
        return self.fn(*args, **kw)


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


# a fragment of the name of the kernel torch.cuda._sleep launches, the
# marks that bound a timing window's counted calls
MARK = "spin_kernel"
TRIES = 3  # timing windows taken before kernel_records gives up

Records = Dict[str, Tuple[int, float]]


def window(fn: Callable[[], Any], calls: int) -> Tuple[Records, ...]:
    """One torch.profiler window over ``3 * calls`` back-to-back calls
    of ``fn``, a mark kernel between each third and the next: the
    records of each third (kernel name -> (records, summed duration in
    microseconds)), by the device's own timestamps.  Empty thirds when a
    mark was lost."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for third in range(3):
            if third:
                torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e for e in events if MARK in e.name]
    if len(marks) != 2:
        return {}, {}, {}
    out: Tuple[Records, ...] = ({}, {}, {})
    for e in events:
        if MARK in e.name:
            continue
        third = sum(e.time_range.start >= m.time_range.end for m in marks)
        n, us = out[third].get(e.name, (0, 0.0))
        out[third][e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def kernel_records(fn: Callable[[], Any], calls: int = 20) -> Records:
    """torch.profiler's records of the CUDA kernels that ``calls``
    back-to-back warm calls of ``fn`` launch: kernel name -> (records,
    their summed duration in microseconds).

    A kernel that each call launches ``k`` times has ``k * calls``
    records.  torch.profiler loses records at the edges of a window,
    more the longer the process has run, so the counted calls are the
    middle third of :func:`window`, between its marks, ``calls`` calls
    on each side taking the losses.  A window with no record there, or
    with a kernel whose records are not a multiple of ``calls`` (records
    lost, or a kernel ``fn`` does not launch on every call), is profiled
    again, up to ``TRIES`` windows; the last is returned whatever it
    holds, for the caller to check."""
    fn()
    torch.cuda.synchronize()
    per: Records = {}
    for _ in range(TRIES):
        per = window(fn, calls)[1]
        if per and not irregular(per, calls):
            break
    return per


def irregular(records: Records, calls: int) -> Dict[str, int]:
    """The kernels of :func:`kernel_records`'s ``records`` whose count
    is not a multiple of ``calls``, with that count."""
    return {name: n for name, (n, _) in records.items() if n % calls}


def device_ms(fn: Callable[[], Any], calls: int = 20) -> float:
    """Device ms a call of ``fn``: the summed durations of the CUDA
    kernels over ``calls`` warm calls (:func:`kernel_records`), over
    ``calls``.  It leaves out the host's cost a call (checks,
    allocation, the launch), which bounds a back-to-back run of a kernel
    of tens of microseconds."""
    per = kernel_records(fn, calls)
    if not per:
        raise RuntimeError(f"torch.profiler saw no device time in {TRIES} "
                           "windows")
    return sum(us for _, us in per.values()) / calls / 1e3


def profile_compile(fn: Callable, *args: Any,
                    static_argnames: Tuple[str, ...] = (),
                    **kw: Any) -> Dict[str, float]:
    """Run ``fn(*args, **kw)`` cold, then warm, and report stage timings
    and sizes.

    Returns keys ``compile_s`` (wall seconds of the first call,
    synchronized: on CUDA it includes building and loading the kernels
    when that call triggers it), ``traces`` (calls of ``fn``'s body in
    that first call), ``argument_bytes`` and ``output_bytes`` (the
    tensors' bytes, nested lists, tuples and dicts included).  When an
    argument lies on a CUDA device, also ``build_s`` (the part of
    ``compile_s`` spent in :func:`repro_torch.kernels.cuda_build.build`,
    0.0 when the kernels were already loaded), ``device_ms`` (device
    time of a warm call, :func:`device_ms`) and ``peak_bytes`` (device
    memory a warm call allocates above what was allocated before it, at
    its peak).  ``static_argnames`` is accepted for parity with the
    reference and has no effect: nothing is traced.
    """
    from ..kernels import cuda_build

    del static_argnames
    counter = TraceCounter(fn)
    cuda = [t.device for t in _tensors((args, kw)) if t.is_cuda]
    dev: Optional[torch.device] = cuda[0] if cuda else None

    def sync() -> None:
        if dev is not None:
            torch.cuda.synchronize(dev)

    built = cuda_build.BUILD_SECONDS
    sync()
    t0 = walltime()
    res = counter(*args, **kw)
    sync()
    out: Dict[str, float] = {
        "compile_s": walltime() - t0,
        "traces": float(counter.traces),
        "argument_bytes": _nbytes((args, kw)),
        "output_bytes": _nbytes(res),
    }
    del res
    if dev is None:
        return out
    out["build_s"] = cuda_build.BUILD_SECONDS - built
    with torch.cuda.device(dev):
        out["device_ms"] = device_ms(lambda: counter(*args, **kw))
        sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = counter(*args, **kw)
        sync()
        out["peak_bytes"] = float(torch.cuda.max_memory_allocated(dev)
                                  - base)
    return out


def profile_maxplus(n: int = 4096, rows: int = 8, backend: str = "cuda",
                    device=None) -> Dict[str, float]:
    """Profile one ``maxplus_depart`` configuration (the sweep engine's
    hot kernel) at a representative ``(rows, n)`` float64 scan shape, the
    dtype every sweep runs in.  ``backend="cuda"`` is the
    ``maxplus_chunked`` kernel (K1), ``"ref"`` the exact sequential
    ``maxplus_seq`` kernel (K2); ``device`` is the GPU unless named, and
    ``"cpu"`` runs their plain versions.  Adds ``rows`` and ``n`` to
    :func:`profile_compile`'s keys."""
    from ..kernels.maxplus_scan import maxplus_depart

    dev = resolve_device(device, "profile_maxplus")
    arrive = torch.linspace(0.0, 1.0, rows * n, dtype=torch.float64,
                            device=dev).reshape(rows, n)
    svc = torch.full((rows, n), 1e-4, dtype=torch.float64, device=dev)
    out = profile_compile(
        lambda a, s: maxplus_depart(a, s, backend=backend), arrive, svc)
    out["rows"], out["n"] = float(rows), float(n)
    return out
