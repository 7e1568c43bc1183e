"""Hand-written CUDA kernels for the port's hot spots, each package with
kernel.py (the CUDA build, bindings and launch wrappers over ``csrc/``),
ops.py (backend dispatch) and ref.py (plain PyTorch versions, which CPU
tensors run):

* maxplus_scan — the EdgeKV simulator's leader-stage departure
  recurrence, batched over rows; the numeric core of the batched sweep
  engine (repro_torch.sim.sweep).
"""
from .maxplus_scan import maxplus_depart

__all__ = ["maxplus_depart"]
