"""Discrete-event emulation of the paper's testbed (Grid'5000 + Distem +
YCSB), in virtual time, driving the real EdgeKV protocol objects.

Three interchangeable evaluation paths: the generator oracle
(``engine="oracle"``), the vectorized fast path (``engine="fast"`` /
:class:`FastSimEdgeKV`, see :mod:`repro_torch.sim.vectorized`), and the
batched sweep engine (:func:`run_sweep`, :mod:`repro_torch.sim.sweep`)
that runs a whole grid of configurations as one PyTorch program on the
GPU.

Over them sit the scenario layer (:mod:`repro_torch.sim.scenario`:
partitions, regional failures, flash crowds and diurnal load as
declarative :class:`Scenario` specs), the feedback rebalancing
controller (:mod:`repro_torch.sim.rebalance`) and one runner per paper
figure (:mod:`repro_torch.sim.experiments`), whose rows are those of the
reference.  Only the sweep engine and the figures built on it
(``fig13_request_rate``, ``fig_sweep``, ``fig_scale(engine="sweep")``)
run on a device."""
from .events import DeferredEnvironment, Environment, Resource, Timeout
from .network import EDGE_SETTING, CLOUD_SETTING, SETTINGS, NetworkModel, Link
from .records import OpRecord, RecordArray
from .ycsb import YCSBWorkload, Op, KINDS, DTYPES
from .cluster import SimEdgeKV, ServiceParams
from .vectorized import FastSimEdgeKV
from .scenario import (Diurnal, FlashCrowd, Partition, RegionalFailure,
                       Scenario)
from .sweep import (SweepPoint, SweepResult, closed_grid, run_sweep,
                    sweep_grid)

__all__ = [
    "Environment", "DeferredEnvironment", "Resource", "Timeout",
    "EDGE_SETTING", "CLOUD_SETTING", "SETTINGS", "NetworkModel", "Link",
    "YCSBWorkload", "Op", "KINDS", "DTYPES", "OpRecord", "RecordArray",
    "SimEdgeKV", "FastSimEdgeKV", "ServiceParams",
    "Scenario", "Partition", "RegionalFailure", "FlashCrowd", "Diurnal",
    "SweepPoint", "SweepResult", "closed_grid", "run_sweep", "sweep_grid",
]
