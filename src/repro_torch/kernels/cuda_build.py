"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel package registers its ``csrc/*.cu`` sources here when it is
imported (data only: nothing is compiled then).  At first use, or when
:func:`build` is called, every registered source whose library is
missing is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface — one ``nvcc`` per source, all started
together — into ``_build/`` beside the package sources, and loaded with
:mod:`ctypes`.  A library is named by a hash of its source and flags, so
an edit rebuilds and an unchanged source loads at once.

Every entry point of a source returns a CUDA error code, which
:func:`launch` turns into an exception: nothing falls back.

``BUILD_SECONDS`` sums the wall seconds of every :func:`build` that
compiled or loaded a library, so a caller timing a first call can name
the build's share of it (``repro_torch.obs.profile_compile``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..obs.clock import walltime

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I64, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class Source(NamedTuple):
    path: Path
    # entry point -> (argtypes, restype)
    entries: Dict[str, Tuple[Sequence, object]]
    flags: Tuple[str, ...]


SOURCES: Dict[str, Source] = {}
BUILD_LOG: Dict[str, str] = {}   # source -> nvcc's output (ptxas -v)
BUILD_SECONDS = 0.0  # wall s of the builds that compiled or loaded
_LIBS: Dict[str, ctypes.CDLL] = {}


def register(name: str, path: Path,
             entries: Dict[str, Tuple[Sequence, object]],
             flags: Tuple[str, ...] = ()) -> None:
    """Declare source ``name`` (``path``) and its C entry points; each
    source also exports ``<name>_error_string``."""
    entries = dict(entries)
    entries[f"{name}_error_string"] = ([INT], ctypes.c_char_p)
    SOURCES[name] = Source(Path(path), entries, tuple(flags))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _flags(src: Source) -> Tuple[str, ...]:
    return NVCC_FLAGS + src.flags


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.path.read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, ctypes.CDLL]:
    """Compile every registered source whose library is missing, all
    ``nvcc`` processes started together, and load every library."""
    global BUILD_SECONDS
    t0 = walltime()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        if name in _LIBS or _target(name).exists():
            continue
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *_flags(src), "-o", str(tmp), str(src.path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].path.name}:\n{log}")
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    loaded = 0
    for name, src in SOURCES.items():
        if name in _LIBS:
            continue
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in src.entries.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
        loaded += 1
    if loaded:
        BUILD_SECONDS += walltime() - t0
    return _LIBS


def library(name: str) -> ctypes.CDLL:
    return _LIBS.get(name) or build()[name]


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` of source ``name`` with ``args`` and the
    current stream of ``device``; raise if it returns an error."""
    lib = library(name)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args,
                               P(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({err})")
