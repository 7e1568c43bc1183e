"""Import hygiene and device choice of the PyTorch port: it never imports
jax or the reference package, and its entry points run on the GPU unless
told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(imported_roots(path))
    assert not bad, (path, bad)


def test_sweep_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.sim.sweep, repro_torch.kernels; "
            "assert 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_run_sweep_defaults_to_the_gpu():
    from repro_torch.sim.sweep import SweepPoint, resolve_device, run_sweep
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        run_sweep([SweepPoint(groups=3, threads=2, ops=8)], loop="closed")
    with pytest.raises(RuntimeError, match="GPU"):
        run_sweep([SweepPoint(groups=3)], duration=0.5)
    assert resolve_device("cpu").type == "cpu"


def test_serving_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.launch.serve, repro_torch.models.convert; "
            "assert 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serve_defaults_to_the_gpu():
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import serve
    if torch.cuda.is_available():
        assert resolve_device(None, "serve").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        serve("xlstm-125m", reduced=True)
    with pytest.raises(RuntimeError, match="GPU"):
        serve("xlstm-125m", reduced=True, device="cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        serve(reduced=True)           # the default, stablelm-3b
