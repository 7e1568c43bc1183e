"""Discrete-event emulation of the paper's testbed (Grid'5000 + Distem +
YCSB), in virtual time, driving the real EdgeKV protocol objects.

Three interchangeable evaluation paths: the generator oracle
(``engine="oracle"``), the vectorized fast path (``engine="fast"`` /
:class:`FastSimEdgeKV`, see :mod:`repro_torch.sim.vectorized`), and the
batched sweep engine (:func:`run_sweep`, :mod:`repro_torch.sim.sweep`)
that runs a whole grid of configurations as one PyTorch program on the
GPU."""
from .events import DeferredEnvironment, Environment, Resource, Timeout
from .network import EDGE_SETTING, CLOUD_SETTING, SETTINGS, NetworkModel, Link
from .records import OpRecord, RecordArray
from .ycsb import YCSBWorkload, Op, KINDS, DTYPES
from .cluster import SimEdgeKV, ServiceParams
from .vectorized import FastSimEdgeKV
from .sweep import (SweepPoint, SweepResult, closed_grid, run_sweep,
                    sweep_grid)

__all__ = [
    "Environment", "DeferredEnvironment", "Resource", "Timeout",
    "EDGE_SETTING", "CLOUD_SETTING", "SETTINGS", "NetworkModel", "Link",
    "YCSBWorkload", "Op", "KINDS", "DTYPES", "OpRecord", "RecordArray",
    "SimEdgeKV", "FastSimEdgeKV", "ServiceParams",
    "SweepPoint", "SweepResult", "closed_grid", "run_sweep", "sweep_grid",
]
