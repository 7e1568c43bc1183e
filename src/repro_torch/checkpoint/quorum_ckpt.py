"""Quorum checkpointing — EdgeKV's replication manager applied to training
state; the counterpart of ``repro/checkpoint/quorum_ckpt.py``.

Every param/optimizer leaf is a *key*; the consistent-hash ring places
each key on an owner host whose replica set is the owner + its R-1 ring
successors (an EdgeKV group). A shard write is durable when a **majority**
of its replica set persisted it — a dead or straggling host can neither
block the step nor lose data (minority failure tolerated on restore).

Hosts are directories (``root/host<i>/``) so fault injection in tests is
literal directory removal. The manifest commit is atomic (write + rename)
and carries per-shard checksums; restore reads each shard from the first
live replica whose checksum verifies.

Elastic rescale: changing the host count only moves K/m keys (consistent
hashing) — ``reshard()`` copies exactly the moved shards.

Backup mirroring (EdgeKV §7.3): an optional mirror root (another pod)
receives asynchronous non-voting copies; ``restore(prefer_backup=True)``
reads from it when the primary pod is gone (read-only semantics).

**Keys and files are the reference's.**  A state is nested dicts (and
lists) of tensors.  Its keys are the reference's leaf paths, dict keys
joined with "/": the model's parameters (``state["p"]``) and the
optimizer's per-parameter moments (``state["o"]["m"]``, ``["v"]``), which
the port keys by parameter name (``layers.3.attn.wq``), are written in
the reference's layout, each layer stack one array with a leading layer
axis (``p/layers/attn/wq``, as ``models.convert.params_to_jax``); every
other leaf is written as it is.  So the ring places every shard on the
same hosts as the reference's, and a checkpoint written by either
package restores in the other.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hashring import ChordRing
from repro_torch.models.convert import reference_leaf

# the sub-trees keyed by parameter name, written in the reference's layout
PARAM_TREES = (("p",), ("o", "m"), ("o", "v"))


def _map(tree, fn: Callable, path: Tuple = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _entries(tree) -> List[Tuple[str, Optional[int], Tuple, Any]]:
    """(reference key, index in its layer stack or None, the leaf's path
    in ``tree``, the leaf) for every leaf, in sorted key order."""
    out = []

    def visit(path, leaf):
        key, idx = "/".join(str(k) for k in path), None
        for prefix in PARAM_TREES:
            if len(path) == len(prefix) + 1 and path[:-1] == prefix:
                ref, idx = reference_leaf(path[-1])
                key = "/".join([*prefix, ref])
        out.append((key, idx, path, leaf))
        return leaf

    _map(tree, visit)
    return sorted(out, key=lambda e: (e[0], -1 if e[1] is None else e[1]))


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf, taken now: the optimizer updates its
    tensors in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _leaf_paths(state) -> List[Tuple[str, np.ndarray]]:
    """(key, host array) for every leaf of the reference's layout."""
    groups: Dict[str, Dict[Optional[int], np.ndarray]] = {}
    for key, idx, _, leaf in _entries(state):
        groups.setdefault(key, {})[idx] = _host(leaf)
    return [(key, parts[None] if None in parts
             else np.stack([parts[i] for i in sorted(parts)]))
            for key, parts in groups.items()]


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _shard_file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


class QuorumCheckpointer:
    def __init__(self, root: str, n_hosts: int, *, replication: int = 3,
                 vnodes: int = 8, mirror_root: Optional[str] = None):
        self.root = Path(root)
        self.n_hosts = n_hosts
        self.R = min(replication, n_hosts)
        self.ring = ChordRing(virtual_nodes=vnodes)
        for h in range(n_hosts):
            self.ring.add_node(f"host{h}")
            (self.root / f"host{h}").mkdir(parents=True, exist_ok=True)
        self.mirror_root = Path(mirror_root) if mirror_root else None
        if self.mirror_root:
            self.mirror_root.mkdir(parents=True, exist_ok=True)
        self.dead: set = set()
        self._async_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ placing
    def replicas_of(self, key: str) -> List[str]:
        return self.ring.preference_list(key, self.R)

    # ------------------------------------------------------------- saving
    def save(self, step: int, state, *, mirror: bool = True) -> Dict:
        """Quorum write of every shard; returns the committed manifest.
        Raises if any shard misses its majority (data would be at risk)."""
        return self._write(step, _leaf_paths(state), mirror=mirror)

    def _write(self, step: int, leaves: List[Tuple[str, np.ndarray]], *,
               mirror: bool = True) -> Dict:
        manifest = {"step": step, "shards": {}, "n_hosts": self.n_hosts,
                    "replication": self.R}
        for key, arr in leaves:
            reps = self.replicas_of(key)
            acks = []
            for host in reps:
                if host in self.dead:
                    continue  # straggler/dead host: skipped, not awaited
                p = self.root / host / f"step{step}" / _shard_file(key)
                p.parent.mkdir(parents=True, exist_ok=True)
                np.save(p, arr)
                acks.append(host)
            quorum = len(reps) // 2 + 1
            if len(acks) < quorum:
                raise RuntimeError(
                    f"shard {key}: only {len(acks)}/{len(reps)} replicas "
                    f"wrote (need {quorum})")
            manifest["shards"][key] = {
                "replicas": reps, "acked": acks, "dtype": str(arr.dtype),
                "shape": list(arr.shape), "sha1": _checksum(arr),
            }
        tmp = self.root / f".manifest-{step}.tmp"
        tmp.write_text(json.dumps(manifest))
        tmp.rename(self.root / f"manifest-{step}.json")
        if mirror and self.mirror_root is not None:
            self._mirror_async(step, leaves, manifest)
        return manifest

    def save_async(self, step: int, state) -> threading.Thread:
        """Overlap checkpoint IO with compute: the host snapshot is taken
        (synchronized and copied) before this returns, since the
        optimizer then goes on to update the same tensors in place; the
        files are written in a background thread."""
        leaves = _leaf_paths(state)
        t = threading.Thread(target=self._write, args=(step, leaves),
                             daemon=True)
        t.start()
        self._async_thread = t
        return t

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()

    def _mirror_async(self, step, leaves, manifest) -> None:
        def run():
            d = self.mirror_root / f"step{step}"
            d.mkdir(parents=True, exist_ok=True)
            for key, arr in leaves:
                np.save(d / _shard_file(key), arr)
            (self.mirror_root / f"manifest-{step}.json").write_text(
                json.dumps(manifest))
        th = threading.Thread(target=run, daemon=True)
        th.start()
        self._mirror_thread = th

    # ------------------------------------------------------------ restore
    def latest_step(self) -> Optional[int]:
        steps = [int(p.stem.split("-")[1])
                 for p in self.root.glob("manifest-*.json")]
        return max(steps) if steps else None

    def restore(self, template, step: Optional[int] = None, *,
                device=None, prefer_backup: bool = False):
        """A state shaped like ``template`` (nested dicts of tensors, as
        saved) with the checkpoint's values, as new tensors on ``device``
        (default: each template tensor's own) in the template's dtypes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint manifest")
        if prefer_backup:
            if self.mirror_root is None:
                raise RuntimeError("no mirror configured")
            manifest = json.loads(
                (self.mirror_root / f"manifest-{step}.json").read_text())
        else:
            manifest = json.loads(
                (self.root / f"manifest-{step}.json").read_text())
        arrays: Dict[str, np.ndarray] = {}
        values = {}
        for key, idx, path, leaf in _entries(template):
            if key not in arrays:
                arrays[key] = (self._read_mirror(manifest, key, step)
                               if prefer_backup
                               else self._read(manifest, key, step))
            arr = arrays[key] if idx is None else arrays[key][idx]
            values[path] = torch.from_numpy(np.array(arr)).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype).reshape(leaf.shape)
        return _map(template, lambda path, _: values[path])

    def _read(self, manifest: Dict, key: str, step: int) -> np.ndarray:
        info = manifest["shards"][key]
        for host in info["acked"] + [h for h in info["replicas"]
                                     if h not in info["acked"]]:
            p = self.root / host / f"step{step}" / _shard_file(key)
            if host in self.dead or not p.exists():
                continue
            cand = np.load(p)
            if _checksum(cand) == info["sha1"]:
                return cand
        raise RuntimeError(
            f"shard {key}: no surviving replica (lost "
            f"{info['replicas']})")

    def _read_mirror(self, manifest: Dict, key: str, step: int
                     ) -> np.ndarray:
        arr = np.load(self.mirror_root / f"step{step}" / _shard_file(key))
        if _checksum(arr) != manifest["shards"][key]["sha1"]:
            raise RuntimeError(f"mirror shard {key} corrupt")
        return arr

    # ------------------------------------------------------------ elastic
    def reshard(self, new_n_hosts: int) -> Dict[str, int]:
        """Elastic rescale: rebuild the ring with the new host set and copy
        ONLY the shards whose owner moved (consistent hashing bound K/m).
        Returns {'moved': k, 'total': K}."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError("nothing to reshard")
        manifest = json.loads(
            (self.root / f"manifest-{step}.json").read_text())
        new = QuorumCheckpointer(str(self.root), new_n_hosts,
                                 replication=self.R,
                                 mirror_root=(str(self.mirror_root)
                                              if self.mirror_root else None))
        moved = 0
        for key, info in manifest["shards"].items():
            new_reps = new.replicas_of(key)
            if set(new_reps) == set(info["replicas"]):
                continue
            moved += 1
            # copy from a surviving old replica to the new replica set
            src = None
            for host in info["acked"]:
                p = self.root / host / f"step{step}" / _shard_file(key)
                if p.exists() and host not in self.dead:
                    src = p
                    break
            if src is None:
                raise RuntimeError(f"shard {key} unrecoverable")
            arr = np.load(src)
            for host in new_reps:
                dst = self.root / host / f"step{step}" / _shard_file(key)
                dst.parent.mkdir(parents=True, exist_ok=True)
                if not dst.exists():
                    np.save(dst, arr)
            info["replicas"] = new_reps
            info["acked"] = new_reps
        manifest["n_hosts"] = new_n_hosts
        (self.root / f"manifest-{step}.json").write_text(
            json.dumps(manifest))
        return {"moved": moved, "total": len(manifest["shards"])}

    # ------------------------------------------------------- fault inject
    def kill_host(self, h: int) -> None:
        self.dead.add(f"host{h}")
        shutil.rmtree(self.root / f"host{h}", ignore_errors=True)

    def revive_host(self, h: int) -> None:
        self.dead.discard(f"host{h}")
        (self.root / f"host{h}").mkdir(parents=True, exist_ok=True)
