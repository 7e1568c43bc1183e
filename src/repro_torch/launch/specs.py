"""Shape-only stand-ins and sharding trees for every cell, the
counterpart of ``repro/launch/specs.py``.

``cell_specs(cfg, shape, mesh)`` returns everything that describes one
step of a cell (its step function, its arguments, their specs, what it
donates) without allocating a single model byte: the model, the
optimizer state, the cache and the batch are tensors on the meta device,
the counterparts of the reference's ``ShapeDtypeStruct``s, in bf16 as
the reference's.  A plan describes a step and runs none, so it builds for
every family and shape, also where the step itself would raise (the
hybrid, SSM and audio families' training).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import AUDIO, ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (P, axis_size, batch_specs,
                                              cache_specs, mesh_axes,
                                              opt_state_specs, param_specs)
from repro_torch.models import LanguageModel, init_cache, init_params
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

BF16 = torch.bfloat16
META = torch.device("meta")


@dataclass
class CellPlan:
    step_fn: Callable
    args: Tuple[Any, ...]          # meta-device models and tensor dicts
    in_specs: Tuple[Any, ...]      # P trees
    out_specs: Any
    donate: Tuple[int, ...]
    meta: Dict[str, Any]


def sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage (``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """The model inputs of one cell, shape only."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32)}
    S_tok = S - (cfg.frontend_tokens or 0)
    d: Dict[str, torch.Tensor] = {"tokens": sds((B, S_tok), torch.int32)}
    if shape.kind == "train":
        d["labels"] = sds((B, S_tok), torch.int32)
    if cfg.family == AUDIO:
        d["enc_frames"] = sds((B, S, cfg.d_model), BF16)
    if cfg.frontend_tokens:
        d["prefix_embeds"] = sds((B, cfg.frontend_tokens, cfg.d_model), BF16)
    return d


def _params_struct(cfg: ArchConfig, mesh, pad_kv: bool = False
                   ) -> LanguageModel:
    tp = mesh_axes(mesh)["model"]
    return init_params(cfg, 0, dtype=BF16, device=META, tp=tp,
                       pad_kv=pad_kv)


def _options(cfg: ArchConfig, overrides: Optional[dict] = None) -> dict:
    n = cfg.param_count()
    opts = {
        "fsdp": n >= 10e9,
        "remat": n >= 10e9,
        "dispatch": "einsum",
        "chunk": 1024,
        "pad_kv": False,
        "kv_dtype": None,
        "capacity_factor": None,
    }
    opts.update(overrides or {})
    return opts


def cell_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
               overrides: Optional[dict] = None) -> CellPlan:
    opts = _options(cfg, overrides)
    if opts.get("capacity_factor"):
        cfg = replace(cfg, capacity_factor=float(opts["capacity_factor"]))
    params = _params_struct(cfg, mesh, pad_kv=opts["pad_kv"])
    p_spec = param_specs(cfg, params, mesh, fsdp=opts["fsdp"])
    batch = input_specs(cfg, shape)
    b_spec = batch_specs(cfg, batch, mesh)
    meta = {"options": opts, "kind": shape.kind}

    if shape.kind == "train":
        step, opt = make_train_step(cfg, dispatch=opts["dispatch"],
                                    remat=opts["remat"],
                                    chunk=opts["chunk"])
        opt_state = opt.init(dict(params.named_parameters()))
        o_spec = opt_state_specs(p_spec, opt_state, mesh)
        return CellPlan(
            step_fn=step,
            args=(params, opt_state, batch),
            in_specs=(p_spec, o_spec, b_spec),
            out_specs=(p_spec, o_spec, None),
            donate=(0, 1),
            meta=meta,
        )

    if shape.kind == "prefill":
        step = make_prefill_step(cfg, dispatch=opts["dispatch"],
                                 max_len=shape.seq_len, chunk=opts["chunk"])
        return CellPlan(
            step_fn=step,
            args=(params, batch),
            in_specs=(p_spec, b_spec),
            out_specs=None,
            donate=(),
            meta=meta,
        )

    # decode: one token against a cache of seq_len
    step = make_decode_step(cfg, dispatch=opts["dispatch"])
    enc_len = shape.seq_len if cfg.family == AUDIO else None
    cache = init_cache(params, cfg, shape.global_batch, shape.seq_len,
                       enc_len=enc_len, kv_dtype=opts["kv_dtype"])
    c_spec = cache_specs(cfg, cache, mesh)
    tokens = batch["tokens"]
    t_spec = b_spec["tokens"]
    logits_spec = None  # left to the partitioner; the cache round-trips
    return CellPlan(
        step_fn=step,
        args=(params, cache, tokens),
        in_specs=(p_spec, c_spec, t_spec),
        out_specs=(logits_spec, c_spec),
        donate=(1,),
        meta=meta,
    )


def arg_leaves(args, in_specs) -> Iterator[Tuple[torch.Tensor, P]]:
    """(tensor, spec) of every argument leaf, paired by name: a model
    with its ``{parameter name: P}``, a dict with a dict of the same
    keys, a tensor with its P."""
    if isinstance(args, torch.nn.Module):
        args = dict(args.named_parameters())
    if isinstance(args, torch.Tensor):
        yield args, in_specs
    elif isinstance(args, dict):
        if set(args) != set(in_specs):
            raise KeyError(f"arguments {sorted(args)} against specs "
                           f"{sorted(in_specs)}")
        for k, v in args.items():
            yield from arg_leaves(v, in_specs[k])
    else:
        for a, s in zip(args, in_specs, strict=True):
            yield from arg_leaves(a, s)


def arg_bytes_per_device(args, in_specs, mesh) -> int:
    """Exact per-device bytes of all step arguments from the spec trees
    (the reference's ``launch/dryrun.py`` function, here because it is
    arithmetic on a plan)."""
    total = 0
    for a, s in arg_leaves(args, in_specs):
        shards = 1
        if isinstance(s, P):
            for ax in s:
                if ax is not None:
                    shards *= axis_size(mesh, ax)
        total += a.numel() * a.element_size() // shards
    return total
