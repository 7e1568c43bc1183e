"""Sharding rules: map every parameter, input, cache and optimizer-state
dimension onto the mesh, the counterpart of
``repro/distributed/sharding.py``.

Mesh axes: ``(pod, data, model)`` multi-pod or ``(data, model)``
single-pod.  ``model`` carries TP (attention heads, FFN hidden, vocab)
and EP (the expert dimension, when it divides); ``data`` (and ``pod``)
carries the batch and, with ``fsdp=True``, a ZeRO-3-style extra shard of
every large weight.  Every assignment is checked for divisibility
against the mesh: a dimension that does not divide falls back to the
next candidate or to replication, so every (arch x shape x mesh) cell
gets a plan without per-arch tables.

A mesh is either a ``launch.mesh.MeshShape`` (``.shape``, a mapping of
axis name to size) or a torch ``DeviceMesh`` (``.mesh_dim_names``).  A
spec is a :class:`P`, one entry a tensor dimension, as jax's
``PartitionSpec``; :func:`to_shardings` turns specs into DTensor
placements.

The reference's rules see its parameter tree, where a layer stack is one
leaf with a leading layer axis (``layers/attn/wq``, (L, D, H hd)); the
port keeps one module a layer (``layers.3.attn.wq``, (D, H hd)).  So
each rule runs on the reference's stacked shape, and a per-layer
parameter's spec is its stack's with the layer axis, which no rule
shards, dropped.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import LISTED, reference_leaf, reference_leaves


def _axes_entry(part):
    """One entry of a spec as jax keeps it: an empty tuple of axes is
    None and a one-axis tuple is that axis."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        if len(part) == 1:
            return part[0]
    return part


class P(tuple):
    """A partition spec: for each tensor dimension None (replicated), a
    mesh axis name, or a tuple of names (major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_axes_entry(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``MeshShape`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _assign(shape: Sequence[int], mesh,
            prefs: Sequence[Tuple[int, Any]]) -> P:
    """Build a spec from (dim_index, axis) preferences, skipping any
    assignment that does not divide or whose dimension is already
    taken."""
    spec: list = [None] * len(shape)
    used = set()
    for di, ax in prefs:
        if di < 0:
            di += len(shape)
        if di >= len(shape) or spec[di] is not None:
            continue
        key = tuple(ax) if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in key):
            continue
        if _fits(shape[di], mesh, ax):
            spec[di] = ax
            used.update(key)
    return P(*spec)


def _leaf_spec(name: str, shape: Sequence[int], mesh, fs) -> P:
    """The reference's rule for its leaf ``name`` (the tree path joined
    with "/") of ``shape``."""
    stacked = 1 if re.search(r"layers", name) else 0

    def pref(*prefs):
        return _assign(shape, mesh, prefs)

    if "embed" in name:
        return pref((0, "model"), (1, fs))
    if "lm_head" in name:
        return pref((1, "model"), (0, fs))
    if re.search(r"attn/(wq|wk|wv)$", name):
        return pref((-1, "model"), (-2, fs))
    if re.search(r"attn/wo$", name):
        return pref((-2, "model"), (-1, fs))
    if re.search(r"(mlp|dense)/(w_gate|w_up)$", name):
        return pref((-1, "model"), (-2, fs))
    if re.search(r"(mlp|dense)/w_down$", name):
        return pref((-2, "model"), (-1, fs))
    if "router" in name:
        return pref((-2, fs))
    if "experts" in name:
        # (L, E, D, F): EP on expert dim if it divides, else TP on F
        E = shape[stacked]
        if _fits(E, mesh, "model"):
            if re.search(r"w_down$", name):
                return pref((stacked, "model"), (-2, fs))
            return pref((stacked, "model"), (-1, fs))
        if re.search(r"w_down$", name):
            return pref((-2, "model"), (-1, fs))
        return pref((-1, "model"), (-2, fs))
    if "mamba" in name:
        if "in_proj" in name or "out_proj" in name:
            # packed projection dims don't split cleanly on 'model'
            # (z|x|B|C|dt boundaries) -> FSDP only
            return pref((-2, fs), (-1, fs))
        return P(*([None] * len(shape)))
    if re.search(r"(mlstm|slstm)/", name):
        return pref((-1, fs))
    # norms, biases, scalars
    return P(*([None] * len(shape)))


def _named(params) -> Dict[str, torch.Tensor]:
    """A model's parameters by name, or a ``{name: tensor}`` dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg: ArchConfig, params, mesh, *,
                fsdp: bool = False) -> Dict[str, P]:
    """``{parameter name: P}`` for a ``LanguageModel`` (on any device,
    the meta device included) or its ``{name: tensor}`` dict, in the
    parameters' order."""
    del cfg     # the rules read names and shapes, as the reference's do
    named = _named(params)
    fs = "data" if fsdp else None
    out: Dict[str, P] = {}
    for key, names in reference_leaves(named).items():
        shape = tuple(named[names[0]].shape)
        stacked = reference_leaf(names[0])[1] is not None
        spec = _leaf_spec(key, (len(names),) + shape if stacked else shape,
                          mesh, fs)
        if stacked:
            if spec[0] is not None:
                raise ValueError(f"param_specs: {key} shards its layer axis "
                                 f"({spec}), which a per-layer parameter "
                                 f"cannot express")
            spec = P(*spec[1:])
        out.update((n, spec) for n in names)
    return {n: out[n] for n in named}


def _stacked_specs(param_spec_tree: Mapping[str, P]) -> Dict[str, P]:
    """The specs keyed by the reference's leaf keys, a stack's with its
    (unsharded) layer axis put back."""
    out = {}
    for key, names in reference_leaves(param_spec_tree).items():
        spec = param_spec_tree[names[0]]
        stacked = reference_leaf(names[0])[1] is not None
        out[key] = P(None, *spec) if stacked else spec
    return out


def _state_leaves(tree, path=()):
    """(key path, tensor) of a nested dict of tensors, in order."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _state_leaves(v, path + (k,))
    else:
        yield path, tree


def _nest(pairs) -> dict:
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def opt_state_specs(param_spec_tree: Mapping[str, P], opt_state,
                    mesh) -> dict:
    """Specs for the port's optimizer state, shaped like it.  Each
    moment inherits its parameter's spec: AdamW's ``m``/``v`` are keyed
    by the parameters' names, Adafactor's ``f`` by the reference's leaf
    keys (a stack's factored ``vr``/``vc`` keep the surviving
    dimensions' assignments).  Anything that no longer divides is
    replicated, and so is the step count.

    A quirk of the reference, kept: its walk from a state leaf to its
    parameter's spec cannot index its list of sLSTM layers (a list
    index prints as ``[0]``, which ``int`` rejects), so their state is
    replicated whatever the parameters' specs are."""
    lookup = {**param_spec_tree, **_stacked_specs(param_spec_tree)}

    def rule(keys, leaf):
        shape = leaf.shape
        if keys[-1] == "count":
            return P()
        core = [k for k in keys if k not in ("m", "v", "f", "vr", "vc")]
        node = lookup.get(core[0]) if len(core) == 1 else None
        if node is None or re.split(r"[./]", core[0])[0] in LISTED:
            return P(*([None] * len(shape)))
        base = list(node) + [None] * (len(shape) + 1 - len(node))
        if keys[-1] == "vr":      # param (..., a, b) -> mean over b
            spec = base[:len(shape)]
        elif keys[-1] == "vc":    # param (..., a, b) -> mean over a
            spec = base[:len(shape) - 1] + [base[len(shape)]]
        else:                     # m / v: same rank as param
            spec = base[:len(shape)]
        spec = [ax if ax is not None and d % axis_size(mesh, ax) == 0
                else None for d, ax in zip(shape, spec)]
        return P(*spec)

    return _nest((keys, rule(keys, leaf))
                 for keys, leaf in _state_leaves(opt_state))


def batch_specs(cfg: ArchConfig, batch: Mapping[str, torch.Tensor],
                mesh) -> Dict[str, P]:
    """The batch on the data axes (``pod`` and ``data``), or the last of
    them where all do not divide it, else replicated."""
    del cfg
    ba = batch_axes(mesh)

    def rule(shape):
        if not shape:
            return P()
        if _fits(shape[0], mesh, ba):
            return P(*((ba,) + (None,) * (len(shape) - 1)))
        if len(ba) > 1 and _fits(shape[0], mesh, ba[-1]):
            return P(*((ba[-1],) + (None,) * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return {k: rule(tuple(t.shape)) for k, t in batch.items()}


def cache_specs(cfg: ArchConfig, cache: Mapping[str, torch.Tensor],
                mesh) -> Dict[str, P]:
    """Decode-cache sharding (the port's cache has the reference's keys
    and stacked shapes): batch on the data axes; per-layer tensors pick
    heads ('model') when the (padded) KV head count divides, else the
    sequence dimension (sequence-parallel decode attention)."""
    del cfg
    ba = batch_axes(mesh)

    def rule(name, shape):
        if not shape:
            return P()
        if name in ("k", "v", "ak", "av", "xk", "xv", "ks", "vs"):
            # (L, B, S, K, hd): batch -> kv heads -> sequence; unsharded
            # batch (long_500k B=1) lets sequence take the data axes
            return _assign(shape, mesh,
                           [(1, ba), (3, "model"), (2, "model"), (2, ba)])
        if name == "conv":        # (L, B, ck-1, C)
            return _assign(shape, mesh, [(1, ba), (3, "model")])
        if name == "ssm":         # (L, B, H, N, P)
            return _assign(shape, mesh, [(1, ba), (2, "model")])
        if name.startswith("m_"):  # (Lm, B*nh, 1, hd, hd')
            return _assign(shape, mesh, [(1, ba)])
        if name.startswith("s_"):  # (Ls, B, D)
            return _assign(shape, mesh, [(1, ba), (2, "model")])
        return P(*([None] * len(shape)))

    return {k: rule(k, tuple(t.shape)) for k, t in cache.items()}


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension ``Shard(d)`` where tensor dimension d names its axis, else
    ``Replicate()``.  A dimension over several axes is sharded on each,
    and they must be in the mesh's order (major to minor), the only
    order DTensor lays shards out in."""
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        order = [names.index(a) if a in names else -1 for a in axes]
        if -1 in order or order != sorted(order):
            raise ValueError(f"to_shardings: {spec} names {axes} for "
                             f"dimension {d}; the mesh's axes are "
                             f"{tuple(names)}, in this order")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """Each spec of a (nested dict) tree as its DTensor placements (see
    :func:`placements`), for ``distribute_tensor(t, mesh, ...)``."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if spec_tree is None:
        return None
    return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
