"""The port's mesh layer (``repro_torch.distributed.sharding``,
``repro_torch.launch.{mesh,specs}``) against the JAX reference on the
CPU, every comparison exact.

Every config of ``ALL_ARCHS`` at full size, on the reference's
``AbstractMesh`` (16, 16) and (2, 16, 16) beside the port's
``make_production_mesh`` shapes: the reference's trees come from
``jax.eval_shape``, the port's from models built on the meta device.  A
per-layer parameter's spec is held to its stacked leaf's with the layer
axis dropped.  Then every cell's plan (``cell_specs``) leaf for leaf,
with ``arg_bytes_per_device``; the reference's option-path contract on
``make_host_mesh(device="cpu")``; DTensor placements on a one-rank gloo
mesh; and the meta device drawing and allocating nothing."""
import functools
import os

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ALL_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.serving import init_cache as jax_init_cache
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro_torch.configs import (AUDIO, SHAPES, get_config, reduced,
                                 supports_shape)
from repro_torch.distributed.sharding import (P, batch_specs, cache_specs,
                                              opt_state_specs, param_specs,
                                              to_shardings)
from repro_torch.launch import specs
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh)
from repro_torch.models import LanguageModel, init_cache, init_params
from repro_torch.models.convert import reference_leaf
from repro_torch.models.model import model_dims
from repro_torch.optim import adafactor, adamw


def _reference_arg_bytes():
    """``repro.launch.dryrun.arg_bytes_per_device``.  Importing that
    module sets XLA_FLAGS to force 512 host devices (it is meant to be a
    process's entry point); the variable is put back at once, so that no
    later subprocess of this worker starts jax with 512 devices."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import arg_bytes_per_device
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return arg_bytes_per_device


jax_arg_bytes = _reference_arg_bytes()

MESHES = {"single": (AbstractMesh((16, 16), ("data", "model")),
                     make_production_mesh()),
          "multi": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                    make_production_mesh(multi_pod=True))}
CELLS = [(arch, shape, mesh) for arch in ALL_ARCHS for shape in SHAPES
         for mesh in MESHES
         if supports_shape(get_config(arch), SHAPES[shape])[0]]


# ------------------------------------------- flattening both packages
def ref_flat(tree, prefix=""):
    """``{"a/b/0/c": leaf}`` of a reference pytree (PartitionSpecs as
    leaves, None dropped, as jax flattens them)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): leaf for path, leaf in leaves}


def port_flat(tree, prefix=""):
    """``{"a/b": leaf}`` of a port tree: a model by its parameters'
    names, dicts and tuples by key and index; None dropped."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, (torch.Tensor, P)):
        return {prefix.rstrip("/"): tree}
    if tree is None:
        return {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{prefix}{k}/"))
    return out


def as_reference(flat):
    """A flat port tree in the reference's layout: each per-layer
    parameter name (a key segment with dots) becomes its leaf key, the
    layers of a stack one leaf: tensors as (L, ...) shapes, specs with a
    None (unsharded) layer axis put back, which every layer must
    share."""
    groups = {}
    for key, leaf in flat.items():
        parts, idx = [], None
        for seg in key.split("/"):
            if "." in seg:
                seg, idx = reference_leaf(seg)
            parts.append(seg)
        groups.setdefault("/".join(parts), {})[idx] = leaf
    out = {}
    for key, by_layer in groups.items():
        if None in by_layer:
            out[key] = describe(by_layer[None])
            continue
        layers = [by_layer[i] for i in sorted(by_layer)]
        assert sorted(by_layer) == list(range(len(layers))), key
        first = describe(layers[0])
        assert all(describe(x) == first for x in layers), key
        out[key] = ((len(layers),) + first[0], first[1]) \
            if isinstance(layers[0], torch.Tensor) else (None,) + first
    return out


def describe(leaf):
    """A tensor as (shape, dtype name), a spec as a plain tuple."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, PartitionSpec):
        return tuple(leaf)
    if isinstance(leaf, P):
        return tuple(leaf)
    return tuple(leaf.shape), str(leaf.dtype)


def same(port_tree, ref_tree):
    got = as_reference(port_flat(port_tree))
    want = {k: describe(v) for k, v in ref_flat(ref_tree).items()}
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


# ------------------------------------------- the two packages' trees
@functools.lru_cache(maxsize=None)
def ref_params(arch, mesh, pad_kv):
    return jspecs._params_struct(jax_get_config(arch), MESHES[mesh][0],
                                 pad_kv=pad_kv)


@functools.lru_cache(maxsize=None)
def port_params(arch, mesh, pad_kv):
    return specs._params_struct(get_config(arch), MESHES[mesh][1],
                                pad_kv=pad_kv)


def test_production_meshes_match_the_reference():
    for jmesh, mesh in MESHES.values():
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.axis_names == tuple(jmesh.axis_names)


@pytest.mark.parametrize("pad_kv", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_meta_model_matches_the_reference_shapes(arch, pad_kv):
    model = port_params(arch, "single", pad_kv)
    assert all(t.is_meta for t in model.parameters())
    same(model, ref_params(arch, "single", pad_kv))


@pytest.mark.parametrize("pad_kv", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch, mesh, fsdp, pad_kv):
    jmesh, pmesh = MESHES[mesh]
    model = port_params(arch, mesh, pad_kv)
    got = param_specs(get_config(arch), model, pmesh, fsdp=fsdp)
    assert list(got) == [n for n, _ in model.named_parameters()]
    assert all(isinstance(s, P) for s in got.values())
    want = jsh.param_specs(jax_get_config(arch), ref_params(arch, mesh, pad_kv),
                           jmesh, fsdp=fsdp)
    same(got, want)


@pytest.mark.parametrize("pad_kv", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_opt_state_specs_match_jax(arch, mesh, fsdp, pad_kv):
    """AdamW (keyed by the port's names) and Adafactor (keyed by the
    reference's leaf keys): shapes and specs; the reference's sLSTM
    quirk (replicated state) included."""
    jmesh, pmesh = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, tree = port_params(arch, mesh, pad_kv), ref_params(arch, mesh,
                                                             pad_kv)
    p_spec = param_specs(cfg, model, pmesh, fsdp=fsdp)
    j_spec = jsh.param_specs(jcfg, tree, jmesh, fsdp=fsdp)
    for opt, jopt in ((adamw(), jax_adamw()), (adafactor(), jax_adafactor())):
        state = opt.init(dict(model.named_parameters()))
        jstate = jax.eval_shape(jopt.init, tree)
        same(state, jstate)
        same(opt_state_specs(p_spec, state, pmesh),
             jsh.opt_state_specs(j_spec, jstate, jmesh))


@pytest.mark.parametrize("pad_kv", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh, pad_kv):
    """Every shape's batch, and a cache at its batch and length, float
    and int8."""
    jmesh, pmesh = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, tree = port_params(arch, mesh, pad_kv), ref_params(arch, mesh,
                                                             pad_kv)
    for name, shape in SHAPES.items():
        batch = specs.input_specs(cfg, shape)
        jbatch = jspecs.input_specs(jcfg, JAX_SHAPES[name])
        same(batch, jbatch)
        same(batch_specs(cfg, batch, pmesh),
             jsh.batch_specs(jcfg, jbatch, jmesh))
        B, S = shape.global_batch, shape.seq_len
        audio = cfg.family == AUDIO
        for kv in (None, "int8"):
            cache = init_cache(model, cfg, B, S, enc_len=S if audio else None,
                               kv_dtype=kv)
            jcache = jax.eval_shape(functools.partial(
                jax_init_cache, tree, jcfg, B, S, jnp.bfloat16,
                enc_len=S if audio else 0, kv_dtype=kv))
            assert all(t.is_meta for t in cache.values())
            same(cache, jcache)
            same(cache_specs(cfg, cache, pmesh),
                 jsh.cache_specs(jcfg, jcache, jmesh))


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_specs_match_jax(arch, shape, mesh):
    jmesh, pmesh = MESHES[mesh]
    plan = specs.cell_specs(get_config(arch), SHAPES[shape], pmesh)
    jplan = jspecs.cell_specs(jax_get_config(arch), JAX_SHAPES[shape], jmesh)
    same(plan.args, jplan.args)
    same(plan.in_specs, jplan.in_specs)
    same(plan.out_specs, jplan.out_specs)
    assert plan.donate == jplan.donate
    assert plan.meta == jplan.meta
    assert all(t.is_meta for t in port_flat(plan.args).values())
    assert (specs.arg_bytes_per_device(plan.args, plan.in_specs, pmesh)
            == jax_arg_bytes(jplan.args, jplan.in_specs, jmesh))


# ------------------------------------------- the reference's contract
@pytest.fixture(scope="module")
def host_mesh():
    # the mesh's one-rank gloo group ends with the module, so no later
    # test in this process finds a group of another backend running
    yield make_host_mesh(device="cpu")
    dist.destroy_process_group()


def test_cell_specs_cover_all_option_paths(host_mesh):
    """``tests/test_serving_features.py``'s contract on the port: every
    hillclimb option combination still builds a plan."""
    cfg = get_config("deepseek-coder-33b")
    for ov in ({"pad_kv": True}, {"kv_dtype": "int8"},
               {"pad_kv": True, "kv_dtype": "int8"}):
        plan = specs.cell_specs(cfg, SHAPES["decode_32k"], host_mesh, ov)
        assert plan.args[1]["k"].dtype == (
            torch.int8 if ov.get("kv_dtype") == "int8" else torch.bfloat16)
        if ov.get("kv_dtype") == "int8":
            assert "ks" in plan.args[1]


def test_host_mesh_is_one_rank_over_data_and_model(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    assert host_mesh.device_type == "cpu"
    assert make_host_mesh(device="cpu").mesh_dim_names == ("data", "model")


def test_to_shardings_places_parameters(host_mesh):
    """Placements on a one-rank gloo mesh: each parameter distributed
    by them keeps every byte in its one local shard."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    cfg = reduced(get_config("mixtral-8x7b"))
    model = init_params(cfg, 0)
    spec = param_specs(cfg, model, host_mesh, fsdp=True)
    place = to_shardings(host_mesh, spec)
    assert place["embed"] == (Shard(1), Shard(0))       # P("model", "data")
    assert place["final_norm"] == (Replicate(), Replicate())
    for name, p in model.named_parameters():
        dt = distribute_tensor(p.detach(), host_mesh, place[name])
        assert tuple(dt.placements) == place[name]
        assert torch.equal(dt.to_local(), p.detach())
    # the step count, nested trees and a dimension over two axes
    tree = {"count": P(), "m": {"x": P(("data", "model"), None)}}
    assert to_shardings(host_mesh, tree) == {
        "count": (Replicate(), Replicate()),
        "m": {"x": (Shard(0), Shard(0))}}
    for bad in (P(("model", "data")), P("pod")):
        with pytest.raises(ValueError):
            to_shardings(host_mesh, bad)


def test_partition_spec_normalizes_as_jax():
    for parts in ((), (None,), ("data", None), (("data",), None),
                  ((), "model"), (("pod", "data"), None, "model")):
        assert tuple(P(*parts)) == tuple(PartitionSpec(*parts)), parts
    import pickle
    spec = P(("pod", "data"), None)
    assert pickle.loads(pickle.dumps(spec)) == spec


# ------------------------------------------- the meta device
def test_meta_model_draws_nothing(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("drew on the meta device")
    monkeypatch.setattr(torch, "Generator", boom)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", boom)
    model = init_params(get_config("arctic-480b"), 0, dtype=torch.bfloat16,
                        device="meta", tp=16, pad_kv=True)
    assert all(t.is_meta for t in model.state_dict().values())


@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "seamless-m4t-large-v2", "zamba2-1.2b",
                                  "xlstm-125m", "internvl2-76b"])
def test_draws_off_the_meta_device_unchanged(arch):
    """``init_params`` on the CPU is the generator-and-module build it
    was before the meta device came in, to the bit."""
    cfg = reduced(get_config(arch))
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.device("cpu"):
        want = LanguageModel(cfg, gen, torch.float32, model_dims(cfg, 8, True))
    got = init_params(cfg, 3, tp=8, pad_kv=True)
    for (n, a), (m, b) in zip(got.state_dict().items(),
                              want.state_dict().items(), strict=True):
        assert n == m and torch.equal(a, b), n


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "arctic-480b",
                                  "internvl2-76b"])
def test_large_cells_allocate_no_model_bytes(arch):
    """Every supported shape's plan on both production meshes: every
    argument (parameters, optimizer state, batch, cache) lies on the
    meta device, so none of arctic-480b's 0.96 TB of bf16 weights is
    allocated anywhere."""
    cfg = get_config(arch)
    for shape in SHAPES.values():
        if not supports_shape(cfg, shape)[0]:
            continue
        for _, mesh in MESHES.values():
            plan = specs.cell_specs(cfg, shape, mesh)
            assert all(t.is_meta for t in port_flat(plan.args).values())
