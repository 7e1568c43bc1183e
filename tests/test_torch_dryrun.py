"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference on the CPU.

``parse_collectives`` and ``wire_bytes`` are held to the reference's,
exactly, on HLO that the reference's jax compiles in a subprocess of 8
forced host devices (every collective kind, inside and outside a
``lax.scan``) and on hand-written lines.  The trace itself is held to
its contract: on a (1, 1) fake mesh a reduced dense cell issues no
collective and its per-device FLOPs are the plain step's; on (2, 2) and
(2, 2, 2) fake meshes every recorded collective is one of the five HLO
kinds, and the devices' FLOPs cover the unsharded step's, and are its
share where the heads divide the model axis (the training step's too,
and an expert-parallel MoE layer's).  The records carry the reference's
keys (and the torch version), cell ids and skip reasons.  Every test
ends the fake process group it started."""
import ast
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import supports_shape as jax_supports_shape
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import placements
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (MeshShape, end_fake_group,
                                     make_fake_mesh, make_host_mesh)
from repro_torch.launch.specs import arg_bytes_per_device, cell_specs

ROOT = Path(__file__).resolve().parent.parent
KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"}
SMALL = {"train": ShapeConfig("train_small", 32, 8, "train"),
         "prefill": ShapeConfig("prefill_small", 64, 8, "prefill"),
         "decode": ShapeConfig("decode_small", 64, 8, "decode")}
MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import sets XLA_FLAGS to force 512
    host devices (it is meant to be a process's entry point); the
    variable is put back at once."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


ref = _reference_dryrun()


@pytest.fixture(autouse=True)
def no_group_left():
    """Every test starts with no process group and ends the fake one."""
    assert not dist.is_initialized()
    yield
    end_fake_group()
    assert not dist.is_initialized()


def fake_mesh(sizes):
    return make_fake_mesh(MeshShape(MESHES[sizes], sizes))


# ------------------------------------------------ the reference's parsing
PROGRAM = textwrap.dedent("""
    import jax, jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((2, 4), ("a", "b"))

    def body(x):
        y = lax.psum(x, "b")
        g = lax.all_gather(y, "b", axis=0, tiled=True)
        s = lax.psum_scatter(g, "b", scatter_dimension=0, tiled=True)
        t = lax.all_to_all(s, "b", 0, 0, tiled=True)
        return lax.ppermute(t, "a", perm=[(0, 1), (1, 0)])

    def f(x):
        x = body(x)
        x, _ = lax.scan(lambda c, _: (body(c) * 0.5, None), x, None,
                        length=3)
        return x

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("a", "b"),
                              out_specs=P("a", "b")))
    print(g.lower(jnp.zeros((16, 32), jnp.float32)).compile().as_text())
""")


@pytest.fixture(scope="module")
def compiled_hlo() -> str:
    """The compiled HLO of one program of every collective kind, inside
    and outside a ``lax.scan``, from the reference's jax on 8 forced
    host devices in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PROGRAM], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_parse_collectives_on_compiled_hlo(compiled_hlo):
    want = ref.parse_collectives(compiled_hlo, default_trip=7)
    got = dryrun.parse_collectives(compiled_hlo, default_trip=7)
    assert got == want
    assert {e["kind"] for e in got} == KINDS
    # the reference's computation pattern does not take a signature with
    # a tuple parameter, as the compiled scan body's is, so its
    # collectives go under the computation before it, with trip 1: the
    # port keeps the quirk (the hand-written lines below reach the trip)
    assert len(got) == 10 and {e["comp"] for e in got} > {"ENTRY"}
    assert ([dryrun.wire_bytes(e) for e in got]
            == [ref.wire_bytes(e) for e in want])
    assert (sum(dryrun.wire_bytes(e) for e in got)
            == sum(ref.wire_bytes(e) for e in want) > 0)


HAND = """\
HloModule m

%body.1 (p: f32[8,8]) -> f32[8,8] {
  %ar = f32[8,8]{1,0} all-reduce(%x), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %ag = bf16[4,32]{1,0} all-gather(%y), replica_groups=[2,4]<=[8], dimensions={1}
  %rs.start = (f32[2,8]) reduce-scatter-start(%z), replica_groups=[4,2]<=[8]
}

%body.2 (p: s8[16]) -> s8[16] {
  %cp = s8[16]{0} collective-permute(%c), source_target_pairs={{0,1},{1,0}}
  %a2a = u16[] all-to-all(%d), replica_groups={{0,1}}
}

ENTRY %main (a: f32[8,8]) -> f32[8,8] {
  %w1 = (s32[], f32[8,8]) while(%t), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"_n":"12"}}
  %w2 = (s32[], s8[16]) while(%u), condition=%cond.2, body=%body.2, backend_config={"known_trip_count":{"n":"3"}}
  %top = f64[3,5]{1,0} all-reduce(%e), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %odd = f8e4m3fn[10]{0} all-gather(%f), dimensions={0}
}
"""


@pytest.mark.parametrize("default_trip", [1, 5])
def test_parse_collectives_on_hand_written_hlo(default_trip):
    want = ref.parse_collectives(HAND, default_trip=default_trip)
    got = dryrun.parse_collectives(HAND, default_trip=default_trip)
    assert got == want
    by = {(e["comp"], e["kind"]): e for e in got}
    # the trip count pattern reads w1's line; today's JSON form (w2's)
    # escapes it, and that body takes the default, in both packages
    assert by[("body.1", "all-reduce")]["trip"] == 12
    assert by[("body.2", "collective-permute")]["trip"] == default_trip
    assert by[("body.1", "all-gather")]["group"] == 4       # [2,4] form
    assert by[("body.1", "all-reduce")]["group"] == 4       # {{...}} form
    assert by[("ENTRY", "all-reduce")]["result_bytes"] == 3 * 5 * 8
    assert by[("body.2", "all-to-all")]["result_bytes"] == 2
    assert ([dryrun.wire_bytes(e) for e in got]
            == [ref.wire_bytes(e) for e in want])


def test_tables_match_the_reference():
    assert dryrun.DTYPE_BYTES == ref.DTYPE_BYTES
    for name in ("COLLECTIVE_RE", "TRIP_RE", "GROUPS_RE", "GROUPS2_RE"):
        assert getattr(dryrun, name).pattern == getattr(ref, name).pattern


# ------------------------------------------------------------ the trace
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_one_device_mesh_is_the_plain_step(kind):
    """On a (1, 1) fake mesh nothing moves, and one device runs the
    plain step's FLOPs (prefill and decode: forward only, where the
    plain step's chunked attention and the trace's whole-matrix one
    take the same products)."""
    cfg = reduced(get_config("stablelm-3b"))
    mesh = fake_mesh((1, 1))
    got = dryrun.trace(cell_specs(cfg, SMALL[kind], mesh), mesh)
    plain = dryrun.trace(cell_specs(cfg, SMALL[kind],
                                    MeshShape(("data", "model"), (1, 1))))
    assert got["collectives"] == []
    assert plain["collectives"] == []
    assert got["flops"] == plain["flops"] > 0


@pytest.mark.parametrize("sizes", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_collectives_on_small_meshes(sizes, fsdp, kind):
    cfg = replace(reduced(get_config("stablelm-3b")), n_layers=2)
    mesh = fake_mesh(sizes)
    plan = cell_specs(cfg, SMALL[kind], mesh, {"fsdp": fsdp})
    got = dryrun.trace(plan, mesh)
    colls = got["collectives"]
    assert colls and {c["kind"] for c in colls} <= KINDS
    assert all(c["trip"] == 1 and c["group"] in (2, 4, 8)
               and c["result_bytes"] > 0 for c in colls)
    assert sum(dryrun.wire_bytes(c) for c in colls) > 0
    assert {c["comp"] for c in colls} & {"ENTRY", "layers.0"}
    if kind == "train":      # the gradients reach their parameters' shards
        assert {"all-reduce", "reduce-scatter"} & {c["kind"] for c in colls}


def _traced(cfg, shape, sizes, overrides=None):
    """``cfg``'s step traced on a fake mesh of ``sizes``, the fake group
    of another size ended first."""
    end_fake_group()
    mesh = fake_mesh(sizes)
    return dryrun.trace(cell_specs(cfg, shape, mesh, overrides), mesh)


@pytest.mark.parametrize("sizes", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_devices_share_the_step(sizes, fsdp, kind):
    """Where the heads divide the model axis (reduced stablelm-3b: 4 query
    and 4 KV heads on 2), each device runs its share of the step's FLOPs
    and no more: the devices' sum is within 2% of the step's on one
    device (the (1, 1) mesh, which the plain step equals), the training
    step's backward included, whose products torch's own strategies
    would repeat over the model axis."""
    cfg = replace(reduced(get_config("stablelm-3b")), n_layers=2)
    whole = _traced(cfg, SMALL[kind], (1, 1), {"fsdp": fsdp})["flops"]
    got = _traced(cfg, SMALL[kind], sizes, {"fsdp": fsdp})["flops"]
    assert whole > 0
    assert abs(got * math.prod(sizes) - whole) <= 0.02 * whole


@pytest.mark.parametrize("sizes", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_forward_collectives_are_megatrons(sizes, kind):
    """A forward step's collectives on the model axis are Megatron's
    tensor parallelism's and no more: one all-reduce of the embedding's
    partial rows and two a layer (after attention's output projection and
    after the MLP), each of this device's rows of activations in the
    model's bfloat16, not a norm's float32."""
    cfg = replace(reduced(get_config("stablelm-3b")), n_layers=2)
    got = _traced(cfg, SMALL[kind], sizes)["collectives"]
    rows = SMALL[kind].global_batch // math.prod(sizes[:-1])
    S = 1 if kind == "decode" else SMALL[kind].seq_len
    assert [(c["kind"], c["group"], c["result_bytes"], c["comp"])
            for c in got] == [
        ("all-reduce", 2, rows * S * cfg.d_model * 2, comp)
        for comp in ("ENTRY", "layers.0", "layers.0", "layers.1",
                     "layers.1")]


def _flops_in(log: str, comp: str, op: str) -> int:
    """The FLOPs of ``op`` in the op log's lines issued in a module whose
    path ends with ``comp``."""
    pat = re.compile(rf"(\S*{re.escape(comp)}): {re.escape(op)} .* "
                     rf"flops=(\d+)$")
    return sum(int(m.group(2)) for m in map(pat.match, log.splitlines())
               if m)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_expert_parallel_runs_its_experts_alone(kind):
    """Under expert parallelism (reduced arctic-480b's 4 experts on a
    model axis of 2) each device dispatches its groups' tokens to its own
    experts only: the MoE layers' batched products (the dispatch, the
    experts' FFN, the combine) are the step's divided by the devices."""
    from torch.distributed.tensor import Shard
    cfg = reduced(get_config("arctic-480b"))
    end_fake_group()
    mesh = fake_mesh((2, 2))
    plan = cell_specs(cfg, SMALL[kind], mesh)
    experts = [n for n, _ in plan.args[0].named_parameters()
               if n.startswith("layers.0.moe.experts.")]
    assert len(experts) == 3 and all(
        placements(mesh, plan.in_specs[0][n])[1] == Shard(0)
        for n in experts)
    got = dryrun.trace(plan, mesh)["log"]
    whole = _traced(cfg, SMALL[kind], (1, 1))["log"]
    bmm = "aten.bmm.default"
    assert _flops_in(whole, ".moe", bmm) > 0
    assert _flops_in(got, ".moe", bmm) * 4 == _flops_in(whole, ".moe", bmm)


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-coder-33b",
                                  "granite-20b", "phi3-medium-14b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_devices_cover_the_unsharded_flops(arch, kind):
    """Per-device FLOPs times the devices are at least the unsharded
    step's (a device may repeat work, never skip it), for the dense
    family's head layouts: deepseek's KV heads do not divide the model
    axis and granite's are one."""
    cfg = reduced(get_config(arch))
    whole = dryrun.trace(cell_specs(cfg, SMALL[kind],
                                    MeshShape(("data", "model"), (1, 1))))
    mesh = fake_mesh((2, 2))
    got = dryrun.trace(cell_specs(cfg, SMALL[kind], mesh), mesh)
    assert got["flops"] * 4 >= whole["flops"] > 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b",
                                  "zamba2-1.2b", "xlstm-125m",
                                  "seamless-m4t-large-v2", "internvl2-76b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_every_family_traces(arch, kind):
    """The other families' steps on a (2, 2) fake mesh: the MoE layer
    (expert parallelism in arctic's reduced 4 experts, a sliding window
    shorter than the prompt in mixtral's), the SSD scan, the xLSTM
    mixers, the audio family's cross-attention and the VLM's prefix:
    the five kinds only, and the devices' FLOPs cover the step's."""
    cfg = reduced(get_config(arch))
    whole = dryrun.trace(cell_specs(cfg, SMALL[kind],
                                    MeshShape(("data", "model"), (1, 1))))
    mesh = fake_mesh((2, 2))
    got = dryrun.trace(cell_specs(cfg, SMALL[kind], mesh), mesh)
    assert got["collectives"]
    assert {c["kind"] for c in got["collectives"]} <= KINDS
    assert got["flops"] * 4 >= whole["flops"] > 0


def test_flops_are_local_not_global():
    """A product of DTensors counts the shard's FLOPs: (8, 64, 128) @
    (128, 512) with the batch over "data" and the columns over "model"
    of a (2, 2) mesh is 2 x 4 x 64 x 128 x 256 on a device, a quarter
    of the global product's."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh((2, 2))
    fake = dryrun._fake_mode()
    with fake:
        a = DTensor.from_local(torch.empty(4, 64, 128), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(128, 256), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        rec = dryrun.Recorder()
        with rec, rec.paused():
            a @ w
    assert rec.flops == 2 * 4 * 64 * 128 * 256
    assert rec.collectives == []


def test_gathered_bytes_are_the_result():
    """An all-gather's result bytes are the gathered buffer and a
    reduce-scatter's the shard, as XLA's result shapes are."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = fake_mesh((2, 2))
    with dryrun._fake_mode():
        x = DTensor.from_local(torch.empty(4, 6), mesh,
                               [Shard(0), Replicate()], run_check=False)
        p = DTensor.from_local(torch.empty(8, 6), mesh,
                               [Partial(), Replicate()], run_check=False)
        rec = dryrun.Recorder()
        with rec, rec.paused():
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Shard(0), Replicate()])
    assert [(c["kind"], c["result_bytes"], c["group"])
            for c in rec.collectives] == [("all-gather", 8 * 6 * 4, 2),
                                          ("reduce-scatter", 4 * 6 * 4, 2)]


# ---------------------------------------------------------- the records
def _reference_records():
    """The keys of each record ``repro.launch.dryrun.run_cell`` writes,
    by status, read from its source."""
    tree = ast.parse(Path(ref.__file__).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "status" in keys:
                status = node.values[keys.index("status")].value
                out[status] = set(keys)
    return out


REF_KEYS = _reference_records()


def test_cli_records(tmp_path, capsys):
    """The CLI on the full-size stablelm-3b: one cell traced on the
    256-rank mesh, one skipped, the reference's cell ids, keys and skip
    reason; the op log written with ``--keep-hlo``."""
    rc = dryrun.main(["--arch", "stablelm-3b", "--shape",
                      "decode_32k,long_500k", "--mesh", "single",
                      "--out", str(tmp_path), "--keep-hlo"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[OK]   stablelm-3b__decode_32k__single" in out
    assert "dry-run complete: 1 ok, 0 failed, 1 skipped" in out
    rec = json.loads((tmp_path / "stablelm-3b__decode_32k__single.json"
                      ).read_text())
    assert set(rec) == REF_KEYS["ok"] | {"torch"}
    assert rec["torch"] == torch.__version__
    assert rec["devices"] == 256 and rec["bytes_per_device"] == -1
    assert rec["cost_analysis"] == {"flops": rec["flops_per_device"]}
    mesh = MeshShape(("data", "model"), (16, 16))
    plan = cell_specs(get_config("stablelm-3b"), SHAPES["decode_32k"], mesh)
    args = arg_bytes_per_device(plan.args, plan.in_specs, mesh)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == args
    assert rec["arg_bytes_per_device"] == args
    assert rec["memory_analysis"]["output_size_in_bytes"] > 0
    log = (tmp_path / "stablelm-3b__decode_32k__single.trace.txt"
           ).read_text()
    assert len(log) == rec["hlo_bytes"] > 0
    assert rec["collective_wire_bytes_per_device"] == sum(
        ref.wire_bytes(c) for c in rec["collectives"]) > 0
    skip = json.loads((tmp_path / "stablelm-3b__long_500k__single.json"
                       ).read_text())
    assert set(skip) == REF_KEYS["skipped"]
    assert skip["reason"] == jax_supports_shape(
        jax_get_config("stablelm-3b"), JAX_SHAPES["long_500k"])[1]


def test_cli_failed_cell_exits_1(tmp_path, capsys):
    """A cell whose step raises (the hybrid family's training, not
    ported) is an error record with the reason, and the run exits 1."""
    rc = dryrun.main(["--arch", "zamba2-1.2b", "--shape", "train_4k",
                      "--mesh", "multi", "--out", str(tmp_path),
                      "--tag", "t"])
    assert rc == 1
    assert "[FAIL] zamba2-1.2b__train_4k__multi__t" in capsys.readouterr().out
    rec = json.loads((tmp_path / "zamba2-1.2b__train_4k__multi__t.json"
                      ).read_text())
    assert set(rec) == REF_KEYS["error"] | {"torch"}
    assert rec["error"].startswith("NotImplementedError")


# ------------------------------------------------------ the fake group
def test_fake_group_refuses_and_ends():
    mesh = fake_mesh((2, 2))
    assert mesh.size() == 4 and dist.get_world_size() == 4
    with pytest.raises(RuntimeError, match="fake mesh needs 8 ranks"):
        fake_mesh((2, 2, 2))
    assert end_fake_group() and not dist.is_initialized()
    assert not end_fake_group()


def test_gloo_group_after_the_fake_one():
    """A fake group is refused under a running gloo group, and a gloo
    group starts once the fake one has ended."""
    fake_mesh((2, 2))
    end_fake_group()
    make_host_mesh(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="'gloo' is running"):
            fake_mesh((1, 1))
        assert not end_fake_group()      # a gloo group is left alone
    finally:
        dist.destroy_process_group()
