"""Weights of the reference's parameter tree as a ``state_dict`` of
:class:`~.model.LanguageModel`, and back.

The reference keeps a layer stack that it scans over as one tree with a
leading layer axis (``layers``, ``mlstm_layers``) and individually placed
layers as a list (``slstm_layers``); the port keeps one module per
layer.  So ``tree["layers"]["attn"]["wq"][i]`` is ``layers.<i>.attn.wq``
and ``tree["slstm_layers"][i]["slstm"]["w_i"]`` is
``slstm_layers.<i>.slstm.w_i``; a single layer, the hybrid's shared
block, is one tree and one module (``tree["shared_attn"]["attn"]["wq"]``
is ``shared_attn.attn.wq``).  The leaves are numpy arrays (the tests
hand the reference's arrays over as numpy).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

STACKED = ("layers", "mlstm_layers")   # one tree, leading layer axis
LISTED = ("slstm_layers",)    # a list of per-layer trees


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) as a state_dict."""
    flat: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in STACKED:
            leaves: Dict[str, np.ndarray] = {}
            _flatten(sub, "", leaves)
            n = len(next(iter(leaves.values())))
            for i in range(n):
                for name, arr in leaves.items():
                    flat[f"{key}.{i}.{name}"] = arr[i]
        elif key in LISTED:
            for i, layer in enumerate(sub):
                _flatten(layer, f"{key}.{i}.", flat)
        else:
            _flatten(sub, f"{key}.", flat)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax` (numpy leaves)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, Dict[int, Dict[str, Any]]] = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] in STACKED + LISTED:
            node = per_layer.setdefault(parts[0], {}).setdefault(
                int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for key, layers in per_layer.items():
        ordered = [layers[i] for i in sorted(layers)]
        tree[key] = (_stack(ordered) if key in STACKED else ordered)
    return tree


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return np.stack(layers)
