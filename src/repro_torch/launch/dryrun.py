"""The multi-pod dry run, the counterpart of ``repro/launch/dryrun.py``:
every (architecture x input shape) cell's step traced on the production
meshes, and the roofline's inputs written down.

The reference compiles each cell's SPMD program for 512 forced host
devices and parses the collectives out of XLA's HLO.  Torch has no SPMD
compiler; its counterpart of XLA's partitioner is DTensor's sharding
propagation.  So here each leaf of the cell's plan (``launch.specs.
cell_specs``: the model's parameters, the AdamW or Adafactor state, the
cache and the batch) becomes a DTensor of its local shard, a fake tensor
of the shard's shape on the CPU placed by the sharding rules
(``distributed.sharding.placements``), over a ``DeviceMesh`` on a fake
process group of 256 or 512 ranks in this process
(``launch.mesh.make_fake_mesh``).  The step function runs on them under
``FakeTensorMode`` and ``implicit_replication()`` (tensors the step
makes, such as RoPE angles and masks, are replicated), and a dispatch
mode below DTensor records what one device runs: each local op, and each
collective that DTensor issues to move a shard where the next op needs
it.  The fake tensors lie on the CPU, so the step traces the port's plain
versions, as the reference's dry run compiles its plain ``jnp`` code and
not its Pallas kernels.  Nothing is allocated on any device and no byte
is sent.

Usage (the reference's CLI)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh single,multi --out dryrun_results

A record holds the reference's keys.  Where they differ:

* ``collectives``: one entry per collective issued, ``{"kind",
  "result_bytes", "group", "trip", "comp"}`` as the reference's.  The
  port unrolls its layers in Python, so each layer's collectives are
  recorded once per layer with ``trip`` 1, the same total as the
  reference's trip count times one loop body.  ``result_bytes`` is the
  per-device result (the gathered buffer of an all-gather, the shard of a
  reduce-scatter), ``group`` the size of the process group the
  collective names, ``comp`` the module it was issued in (``layers.3``,
  ``layers.3.moe``) or ``"ENTRY"`` outside every module's forward (the
  embedding, the head, the loss, the backward outside a recomputed
  layer, the optimizer).  ``wire_bytes`` applies unchanged.
* ``flops_per_device``: the FLOPs of the ops one device runs on its local
  shards (torch's flop formulas, ``torch.utils.flop_counter``), never
  those of the DTensor-level op, which are the global product's.
  ``cost_analysis`` is ``{"flops": ...}``.
* ``bytes_per_device``: -1, as the reference writes when the backend's
  cost analysis has no "bytes accessed"; torch has no counterpart.
* ``memory_analysis``: ``argument_size_in_bytes`` (``arg_bytes_per_device``)
  and ``output_size_in_bytes`` (the local bytes of the step's outputs);
  an eager trace has no buffer assignment, so it gives no
  ``temp_size_in_bytes`` and says so under ``"error"``.
* ``lower_s`` is the time to build the plan and its DTensor arguments,
  ``compile_s`` the time of the trace.
* ``hlo_bytes`` is the length of the recorded op log, one line per local
  op and collective, in place of the HLO text; ``--keep-hlo`` writes it
  as ``<cell>.trace.txt``.
* ``torch``, a key the reference has not: the version of torch that
  traced the cell.  The trace is DTensor's program, and DTensor's
  sharding strategies change with the version.  The model code pins the
  placements of its products (``models.spmd``) so that a cell's FLOPs do
  not, but the ops between them may move collectives.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, supports_shape
from repro_torch.distributed.sharding import placements
from repro_torch.launch.mesh import (end_fake_group, make_fake_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import arg_bytes_per_device, cell_specs
from repro_torch.obs import walltime

# ------------------------------------------- the reference's HLO parsing
COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([\d,]*)\].*?\s"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
TRIP_RE = re.compile(r'known_trip_count.....n...(\d+)')
GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
GROUPS2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s64": 8,
               "f64": 8, "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
               "f8e4m3fn": 1, "f8e5m2": 1, "u64": 8}


def parse_collectives(hlo: str, default_trip: int):
    """Inventory collectives; multiply those inside while-loop bodies by
    the loop trip count (parsed from backend_config when present, else the
    layer count heuristic — documented in DESIGN.md §7)."""
    # map computation name -> trip count for known while bodies
    body_trips = {}
    for m in re.finditer(r"body=%?([\w.\-]+)", hlo):
        body_trips.setdefault(m.group(1), default_trip)
    # refine with known_trip_count: find while lines
    for m in re.finditer(
            r"while\(.*?\).*?body=%?([\w.\-]+).*?$", hlo, re.M):
        line = m.group(0)
        t = TRIP_RE.search(line)
        if t:
            body_trips[m.group(1)] = int(t.group(1))

    out = []
    current_comp = "ENTRY"
    for line in hlo.splitlines():
        comp = re.match(r"\s*%?([\w.\-]+)\s*\([\w\s.,%\[\]:]*\)\s*->.*{", line)
        if line.startswith("ENTRY"):
            current_comp = "ENTRY"
            continue
        if comp and "=" not in line:
            current_comp = comp.group(1)
            continue
        m = COLLECTIVE_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        size = math.prod(int(d) for d in dims.split(",") if d) \
            if dims else 1
        nbytes = size * DTYPE_BYTES.get(dtype, 4)
        gsize = 0
        g = GROUPS_RE.search(line)
        if g:
            gsize = len(g.group(1).split(","))
        else:
            g2 = GROUPS2_RE.search(line)
            if g2:
                gsize = int(g2.group(2))
        trip = body_trips.get(current_comp, 1) if current_comp != "ENTRY" \
            else 1
        out.append({"kind": kind, "result_bytes": nbytes, "group": gsize,
                    "trip": trip, "comp": current_comp})
    return out


def wire_bytes(entry) -> float:
    """Ring-algorithm wire bytes per device for one collective."""
    R, n = entry["result_bytes"], max(entry["group"], 2)
    k = entry["kind"]
    f = (n - 1) / n
    if k == "all-reduce":
        w = 2 * R * f
    elif k == "all-gather":
        w = R * f                   # result is the gathered (full) buffer
    elif k == "reduce-scatter":
        w = R * (n - 1)             # result is the 1/n shard
    elif k == "all-to-all":
        w = R * f
    else:                           # collective-permute
        w = R
    return w * entry["trip"]


# ------------------------------------------------------------ the trace
# torch's functional collectives (and DTensor's one all-to-all) by HLO
# kind; any other collective of the namespace (a broadcast, a
# point-to-point permute) is a "collective-permute", and wait_tensor
# moves no byte
KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}
FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd")
ALLTOALL = torch.ops._dtensor.shard_dim_alltoall.default
NO_TEMP = ("an eager trace has no buffer assignment: temp_size_in_bytes "
           "has no counterpart")


def _tensors(x):
    """Every tensor of a (nested) op result or step output, a module's
    parameters included."""
    if isinstance(x, nn.Module):
        yield from x.parameters()
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _local_bytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class Recorder(TorchDispatchMode):
    """What one device runs: a dispatch mode that lets DTensor go first
    (it returns ``NotImplemented`` for any op with a DTensor argument),
    so that it sees the local ops each DTensor op runs on its shards and
    the functional collectives each redistribution issues.  DTensor's
    sharding propagation also runs ops, on fake tensors of the global
    shape, to learn an output's shape: :meth:`paused` hides them."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: List[Dict[str, Any]] = []
        self.log: List[str] = []
        self.comp: List[str] = []       # module paths, innermost last
        self._paused = 0
        self._groups: Dict[str, int] = {}

    @contextlib.contextmanager
    def paused(self):
        """Hide the ops of DTensor's shape propagation
        (``ShardingPropagator._propagate_tensor_meta_non_cached``)."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        name = "_propagate_tensor_meta_non_cached"
        inner = getattr(SP, name)

        def wrapped(prop, *a, **kw):
            self._paused += 1
            try:
                return inner(prop, *a, **kw)
            finally:
                self._paused -= 1

        setattr(SP, name, wrapped)
        try:
            yield
        finally:
            setattr(SP, name, inner)

    @staticmethod
    @contextlib.contextmanager
    def cuda_alltoall():
        """DTensor's shard-to-shard move as on a CUDA mesh: its one
        all-to-all (``_dtensor.shard_dim_alltoall``), which a CPU mesh
        replaces by an all-gather and a chunk because gloo has no
        all-to-all.  The port's meshes on the card are CUDA meshes."""
        from torch.distributed.tensor import placement_types as pt

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)

        inner = pt.shard_dim_alltoall
        pt.shard_dim_alltoall = alltoall
        try:
            yield
        finally:
            pt.shard_dim_alltoall = inner

    @contextlib.contextmanager
    def modules(self, model: nn.Module):
        """Keep :attr:`comp`, the path of each module whose forward is
        running, by global forward hooks for as long as this lasts."""
        names = {id(m): n for n, m in model.named_modules() if n}
        hooks = nn.modules.module

        def pre(mod, args):
            self.comp.append(names.get(id(mod), type(mod).__name__))

        def post(mod, args, out):
            self.comp.pop()

        # always_call: a recomputed layer's forward (non-reentrant
        # checkpointing) is stopped by an exception once the backward has
        # what it needs, and its path must leave the stack all the same
        h = (hooks.register_module_forward_pre_hook(pre),
             hooks.register_module_forward_hook(post, always_call=True))
        try:
            yield
        finally:
            for x in h:
                x.remove()

    def _group(self, func, args, kwargs) -> int:
        names = [a.name for a in func._schema.arguments]
        i = names.index("group_name")
        name = kwargs["group_name"] if i >= len(args) else args[i]
        if name not in self._groups:
            self._groups[name] = _group_size(name)
        return self._groups[name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        comp = self.comp[-1] if self.comp else "ENTRY"
        shapes = [tuple(t.shape) for t in _tensors(out)]
        if func.namespace in FUNCTIONAL or func == ALLTOALL:
            if func._opname == "wait_tensor":
                return out
            kind = KINDS.get(func._opname, "collective-permute")
            group = self._group(func, args, kwargs)
            for t in _tensors(out):
                self.collectives.append({
                    "kind": kind, "result_bytes": _local_bytes(t),
                    "group": group, "trip": 1, "comp": comp})
            self.log.append(f"{comp}: {kind} {func} group={group} "
                            f"-> {shapes}")
            return out
        f = flop_registry.get(func._overloadpacket)
        n = int(f(*args, **kwargs, out_val=out)) if f else 0
        self.flops += n
        self.log.append(f"{comp}: {func} "
                        f"{[tuple(a.shape) for a in _tensors(args)]} -> "
                        f"{shapes}" + (f" flops={n}" if n else ""))
        return out


def _local_shape(shape, pls, mesh) -> List[int]:
    out = list(shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return out


def _fake_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A meta tensor as a fake CPU tensor: with a mesh, the DTensor of
    its local shard placed by ``spec``; without one, the whole tensor.
    Made under a ``FakeTensorMode``."""
    if mesh is None:
        return torch.empty(t.shape, dtype=t.dtype, device="cpu")
    pls = placements(mesh, spec)
    local = torch.empty(_local_shape(t.shape, pls, mesh), dtype=t.dtype,
                        device="cpu")
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place(arg, spec, mesh):
    """A plan's argument with each meta leaf made fake (see
    :func:`_fake_leaf`); a model's parameters are replaced in place."""
    if isinstance(arg, nn.Module):
        for name, p in list(arg.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            arg.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                _fake_leaf(p, spec[name], mesh),
                requires_grad=p.requires_grad)
        return arg
    if isinstance(arg, torch.Tensor):
        return _fake_leaf(arg, spec, mesh)
    if isinstance(arg, dict):
        return {k: _place(v, spec[k], mesh) for k, v in arg.items()}
    return type(arg)(_place(a, s, mesh) for a, s in zip(arg, spec))


_FAKE: List[FakeTensorMode] = []


def _fake_mode() -> FakeTensorMode:
    """One ``FakeTensorMode`` for every trace of the process: DTensor's
    sharding propagation caches what it learns from the mode that was
    active, and a second mode refuses the first one's tensors."""
    if not _FAKE:
        _FAKE.append(FakeTensorMode())
    return _FAKE[0]


def trace(plan, mesh=None) -> Dict[str, Any]:
    """Run ``plan``'s step once on fake tensors and return what one
    device ran: ``{"collectives", "flops", "output_bytes", "log"}``.
    With a ``DeviceMesh`` (a fake one, :func:`make_fake_mesh`) every
    argument is the DTensor of its shard; without one, the plain tensors
    of the whole step (one device holding everything)."""
    fake = _fake_mode()
    with fake:
        args = tuple(_place(a, s, mesh)
                     for a, s in zip(plan.args, plan.in_specs))
    model = next(a for a in args if isinstance(a, nn.Module))
    rec = Recorder()
    replicate = (implicit_replication() if mesh is not None
                 else contextlib.nullcontext())
    with fake, replicate, rec, rec.paused(), rec.cuda_alltoall(), \
            rec.modules(model):
        out = plan.step_fn(*args)
        out_bytes = sum(_local_bytes(t) for t in _tensors(out))
    return {"collectives": rec.collectives, "flops": rec.flops,
            "output_bytes": out_bytes, "log": "\n".join(rec.log) + "\n"}


# ----------------------------------------------------------- the cells
def cell_name(arch: str, shape_name: str, mesh_name: str,
              tag: str = "baseline") -> str:
    return f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{tag}" if tag != "baseline" else "")


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             out_dir: Path, overrides=None, tag="baseline",
             keep_hlo: bool = False):
    """One cell's record, written to ``<out_dir>/<cell>.json`` and
    returned; ``mesh`` is a fake ``DeviceMesh`` of the production shape
    (:func:`make_fake_mesh`)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    cell_id = cell_name(arch, shape_name, mesh_name, tag)
    out_path = out_dir / f"{cell_id}.json"
    if not ok:
        rec = {"cell": cell_id, "status": "skipped", "reason": why}
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[SKIP] {cell_id}: {why}")
        return rec

    t0 = walltime()
    try:
        plan = cell_specs(cfg, shape, mesh, overrides)
        t_lower = walltime() - t0
        got = trace(plan, mesh)
        t_compile = walltime() - t0 - t_lower
        arg_bytes = arg_bytes_per_device(plan.args, plan.in_specs, mesh)
        colls = got["collectives"]
        flops = float(got["flops"])
        rec = {
            "cell": cell_id, "status": "ok",
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "tag": tag,
            "devices": mesh.size(),
            "options": plan.meta["options"], "kind": plan.meta["kind"],
            "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
            "flops_per_device": flops,
            "bytes_per_device": -1.0,
            "cost_analysis": {"flops": flops},
            "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                                "output_size_in_bytes": got["output_bytes"],
                                "error": NO_TEMP},
            "arg_bytes_per_device": arg_bytes,
            "collectives": colls,
            "collective_wire_bytes_per_device": sum(
                wire_bytes(c) for c in colls),
            "hlo_bytes": len(got["log"]),
            "torch": torch.__version__,
        }
        if keep_hlo:
            (out_dir / f"{cell_id}.trace.txt").write_text(got["log"])
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[OK]   {cell_id}: compile={t_compile:.1f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll={rec['collective_wire_bytes_per_device']:.3e}B")
        return rec
    except Exception as e:
        rec = {"cell": cell_id, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:],
               "elapsed_s": round(walltime() - t0, 1),
               "torch": torch.__version__}
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {cell_id}: {type(e).__name__}: {str(e)[:200]}")
        return rec


def main(argv: Optional[List[str]] = None) -> int:
    """The reference's CLI.  The meshes run one after the other, each on
    a fake process group of its own size: the 256-rank group is ended
    before the 512-rank one starts, and the last one is ended on the way
    out."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--keep-hlo", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--overrides", default="",
                    help="json dict, e.g. '{\"dispatch\":\"sort\"}'")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    overrides = json.loads(args.overrides) if args.overrides else None

    n_ok = n_fail = n_skip = 0
    try:
        for mname in args.mesh.split(","):
            end_fake_group()
            mesh = make_fake_mesh(make_production_mesh(
                multi_pod=(mname == "multi")))
            for arch in archs:
                for shape in shapes:
                    cell_id = cell_name(arch, shape, mname, args.tag)
                    if args.skip_existing and (out_dir / f"{cell_id}.json"
                                               ).exists():
                        continue
                    rec = run_cell(arch, shape, mesh, mname, out_dir,
                                   overrides, args.tag, args.keep_hlo)
                    st = rec.get("status")
                    n_ok += st == "ok"
                    n_fail += st == "error"
                    n_skip += st == "skipped"
    finally:
        end_fake_group()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, "
          f"{n_skip} skipped (documented)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
