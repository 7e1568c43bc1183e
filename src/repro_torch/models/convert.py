"""Weights of the reference's parameter tree as a ``state_dict`` of
:class:`~.model.LanguageModel`, and back.

The reference keeps a layer stack that it scans over as one tree with a
leading layer axis (``layers``, the audio family's ``enc_layers``,
``mlstm_layers``) and individually placed layers as a list
(``slstm_layers``); the port keeps one module per layer.  So
``tree["layers"]["attn"]["wq"][i]`` is ``layers.<i>.attn.wq`` and
``tree["slstm_layers"][i]["slstm"]["w_i"]`` is
``slstm_layers.<i>.slstm.w_i``; a single layer, the hybrid's shared
block, is one tree and one module (``tree["shared_attn"]["attn"]["wq"]``
is ``shared_attn.attn.wq``).  :func:`reference_leaf` names the
reference's leaf (and layer index) of a parameter, for the optimizers
and the checkpointer that keep the reference's layout.  The leaves are numpy arrays (the tests
hand the reference's arrays over as numpy).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

# one tree, leading layer axis
STACKED = ("layers", "enc_layers", "mlstm_layers")
LISTED = ("slstm_layers",)    # a list of per-layer trees


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def reference_leaf(name: str) -> Tuple[str, Optional[int]]:
    """The reference's leaf key of the port's parameter ``name`` (its
    tree path, dict keys and list indices joined with "/") and, for a
    stacked layer, the layer's index along that leaf's leading axis:
    ``layers.3.attn.wq`` -> ("layers/attn/wq", 3), ``slstm_layers.1.ln``
    -> ("slstm_layers/1/ln", None), ``layers.2.xattn.wk`` ->
    ("layers/xattn/wk", 2), ``embed`` -> ("embed", None)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def reference_leaves(names: Iterable[str]) -> Dict[str, List[str]]:
    """Each reference leaf key -> the port's parameter names that make
    it up, in layer order (one name unless the leaf is a stack)."""
    out: Dict[str, Dict[int, str]] = {}
    for name in names:
        key, idx = reference_leaf(name)
        out.setdefault(key, {})[-1 if idx is None else idx] = name
    return {k: [v[i] for i in sorted(v)] for k, v in out.items()}


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
