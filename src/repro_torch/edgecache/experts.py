"""MoE expert placement via the EdgeKV ring (weighted virtual nodes §7.1),
the counterpart of ``repro/edgecache/experts.py``.

Experts are *global keys*; model-axis shards are the ring's groups. The
ring (with weights for heterogeneous groups) decides which shard hosts
which expert. The layer consumes only a permutation, so moving an expert
(elastic rebalance, hot-expert replication) is a weight relocation — the
layer's code never changes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.hashring import ChordRing


def expert_placement(n_experts: int, n_shards: int, *,
                     shard_weights: Optional[List[float]] = None,
                     vnodes: int = 16) -> np.ndarray:
    """Returns perm (n_experts,) mapping expert -> shard slot, capacity-
    constrained: each shard receives exactly n_experts/n_shards experts
    (required by the static (E/n_shards)-per-shard weight layout); the
    ring's weighted ordering decides *which* experts go where."""
    if n_experts % n_shards:
        raise ValueError("expert count must divide shards")
    cap = n_experts // n_shards
    ring = ChordRing(virtual_nodes=vnodes)
    for s in range(n_shards):
        w = shard_weights[s] if shard_weights else 1.0
        ring.add_node(f"shard{s}", weight=w)
    assign: Dict[int, List[int]] = {s: [] for s in range(n_shards)}
    # ring-preferred shard first; overflow walks the successor list (same
    # rule as EdgeKV backup groups: deterministic successor ordering)
    for e in range(n_experts):
        key = f"expert-{e}"
        owner = int(ring.locate(key)[5:])
        s = owner
        for _ in range(n_shards):
            if len(assign[s]) < cap:
                assign[s].append(e)
                break
            s = (s + 1) % n_shards
    perm = np.zeros((n_experts,), np.int64)
    for s in range(n_shards):
        for j, e in enumerate(assign[s]):
            perm[s * cap + j] = e
    return perm


def apply_expert_permutation(expert_params: dict, perm: np.ndarray) -> dict:
    """Reorder stacked expert weights (L, E, ...) or (E, ...) by ``perm``
    so shard s holds experts perm[s*cap:(s+1)*cap].

    The expert axis is the reference's rule: axis 1 when a weight has 3
    or more dimensions and its first is not len(perm), else axis 0.  So
    a stacked (L, E, ...) weight with L == E is permuted along its layers;
    the port's per-layer (E, D, F) weights never meet that case."""
    def reorder(w: torch.Tensor) -> torch.Tensor:
        axis = 1 if w.dim() >= 3 and w.shape[0] != len(perm) else 0
        return torch.index_select(
            w, axis, torch.as_tensor(perm, dtype=torch.long, device=w.device))

    def tree_map(t):      # nested dicts of tensors, as jax.tree.map
        if isinstance(t, dict):
            return {k: tree_map(v) for k, v in t.items()}
        return reorder(t)

    return tree_map(expert_params)
