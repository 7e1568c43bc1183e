"""The model code's steps on DTensors, where DTensor's sharding
propagation cannot take the plain code as it is.

The dry run (``repro_torch.launch.dryrun``) runs a cell's step on
DTensors over a fake mesh.  Most of the model code runs on them as it
is; the functions here stand in for the steps that DTensor cannot
propagate or that it would place badly: attention's head fold (it
merges the batch, sharded over "data", with the heads, sharded over
"model"), the SSD scan's fold, the MoE layer's dispatch, the xLSTM
mixers, the embedding and the loss's gather over a sharded vocabulary,
the cache's slot write, a projection onto heads that do not divide the
model axis.  Each is reached only when its tensors are DTensors: on
plain tensors the model code runs as before, and on the GPU it launches
the same kernels as often.

Each runs on each device's local shards (``local_map``), independent
over the batch and, where it is, over the heads, so that any
redistribution into those placements is a collective of the trace, as
XLA's partitioner would insert one.  A decode cache sharded over its
sequence (``distributed.sharding.cache_specs`` where the KV heads do not
divide the model axis) attends its slice of the keys on each device and
merges the slices' softmax with all-reduces over the model axis.  A
weight's product runs as Megatron's column- or row-parallel product
(:func:`linear`), a norm's output goes to the batch's placements
(:func:`rows`) and a gradient to its parameter's (:func:`like`).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention.kernel import check_groups
from repro_torch.kernels.flash_attention.ref import (NEG_INF, _len, _mask,
                                                     flash_attention_ref)

MODEL = "model"


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _model_dim(mesh) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index(MODEL) if MODEL in names else None


def _batch(mesh, B: int) -> List:
    """Placements of a batch of B rows: sharded over the data axes (every
    mesh dimension but "model") where they divide B, else over the last
    of them where it does, else replicated, as
    ``distributed.sharding.batch_specs`` places the batch."""
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n != MODEL]
    out: List = [Replicate()] * mesh.ndim
    if B % math.prod(mesh.size(i) for i in dims) == 0:
        for i in dims:
            out[i] = Shard(0)
    elif dims and B % mesh.size(dims[-1]) == 0:
        out[dims[-1]] = Shard(0)
    return out


def _spec(t, placements) -> Optional[tuple]:
    """``local_map``'s placements of an argument: None for a non-DTensor."""
    return tuple(placements) if is_dtensor(t) else None


def _whole_on(t, mesh) -> DTensor:
    """A plain tensor made inside the step as the DTensor it stands for
    under ``implicit_replication``: whole on every device."""
    return t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def rows(x: DTensor) -> DTensor:
    """``x`` (B, ...) with the batch's placements: a sub-layer's input
    (a norm's output) sharded over the data axes and whole on the model
    axis, as Megatron's tensor parallelism keeps it.  Left to itself,
    DTensor may shard the residual stream's sequence over the model axis
    and then merge it with the batch in a later flatten, which it cannot
    propagate."""
    return x.redistribute(x.device_mesh, _batch(x.device_mesh, x.shape[0]))


def like(t: DTensor, ref: DTensor) -> DTensor:
    """``t`` with ``ref``'s placements: a gradient reduced onto its
    parameter's shards (a reduce-scatter under FSDP, else an
    all-reduce), as each device's optimizer takes it."""
    return t.redistribute(ref.device_mesh, ref.placements)


def linear(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` (x (B, ..., D_in), w (D_in, D_out)) on each device's
    shards, placed as Megatron's tensor parallelism places it by ``w``'s
    placement on the model axis: columns (``Shard(1)``) take ``x`` whole
    on it and give their slice of the output; rows (``Shard(0)``) take
    their slice of ``x``'s last dimension, and their partial sums are
    all-reduced into the output; else ``x`` and the output are whole on
    it.  ``x`` goes over the data axes as the batch, the weight is
    gathered whole over them (FSDP's gather) and its gradient is a
    partial sum over those that hold the batch.  Pinned so, the backward's products are each device's shard
    of the step's, whatever placements DTensor's strategies would pick
    (torch 2.13's repeat the row-parallel ones over the model axis, and
    move a prefill's activations rather than gather its weights).  A
    decode step's product (one position a row, no gradient) is DTensor's
    own: its strategies give each device its share too, and keep a
    weight that is sharded over the data axes as well in place, moving
    the step's few rows instead.  Either way the partial sums are
    reduced at once (:func:`_reduced`)."""
    if x.dim() == 3 and x.shape[1] == 1 and not torch.is_grad_enabled():
        return _reduced(x @ w)
    mesh = w.device_mesh
    md = _model_dim(mesh)
    bp = _batch(mesh, x.shape[0])
    xp, out = list(bp), list(bp)
    xg = list(bp)
    wp = [Replicate()] * mesh.ndim
    if md is not None and w.placements[md] == Shard(1):
        wp[md] = Shard(1)
        out[md] = Shard(x.dim() - 1)
        xg[md] = Partial()
    elif md is not None and w.placements[md] == Shard(0):
        wp[md] = Shard(0)
        xp[md] = xg[md] = Shard(x.dim() - 1)
        out[md] = Partial()
    wg = [Partial() if b.is_shard() else q for b, q in zip(bp, wp)]
    y = local_map(torch.matmul, out_placements=out,
                  in_placements=(tuple(xp), tuple(wp)),
                  in_grad_placements=(tuple(xg), tuple(wg)),
                  device_mesh=mesh, redistribute_inputs=True)(x, w)
    return _reduced(y)


def _reduced(y: DTensor) -> DTensor:
    """``y`` with its partial sums all-reduced where the product makes
    them, in its dtype: left to DTensor, a later op may reduce them in
    its own (a norm's float32, twice the bytes) or more than once."""
    if not any(p.is_partial() for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in y.placements])


def project(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` for a projection whose heads do not divide the model axis
    (deepseek-coder-33b's 8 KV heads on 16): the weight is gathered whole
    (over the data axes too, FSDP's gather) and each device projects its
    batch rows onto every head, so that the output splits into whole
    heads.  The weight's gradient is a partial sum over the data axes."""
    mesh = w.device_mesh
    bp = _batch(mesh, x.shape[0])
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if b.is_shard() else Replicate() for b in bp]
    return local_map(torch.matmul, out_placements=list(bp),
                     in_placements=(tuple(bp), tuple(whole)),
                     in_grad_placements=(tuple(bp), tuple(grad)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def splits_heads(w: DTensor, n: int) -> bool:
    """Whether ``w``'s n heads divide its mesh's model axis."""
    md = _model_dim(w.device_mesh)
    return md is None or n % w.device_mesh.size(md) == 0


def _all_reduce(t: torch.Tensor, op: str, mesh, dim: int) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, dim)))


def _seq_parallel(q, k, v, kv_len, scales, *, window, mesh, dim: int,
                  seq_k: int):
    """Attention of every query head over this device's slice of the
    keys, (B, S_loc, K, hd) at offset rank x S_loc of ``seq_k``, merged
    over the model axis: the row max, the row sum and the unnormalized
    output all-reduced.  Non-causal (decode), in float32 as the plain
    version."""
    if scales is not None:
        k, v = k.float() * scales[0], v.float() * scales[1]
    B, Sq, H, hd = q.shape
    S_loc, K = k.shape[1], k.shape[2]
    pos = mesh.get_local_rank(dim) * S_loc + torch.arange(S_loc,
                                                          device=q.device)
    mask = _mask(Sq, pos, causal=False, window=window, seq_q=Sq,
                 seq_k=_len(0 if kv_len is None else kv_len, seq_k))
    qh = q.float().reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qh, k.float()) / math.sqrt(hd)
    s = torch.where(mask, s, NEG_INF)
    m = _all_reduce(s.amax(dim=-1, keepdim=True), "max", mesh, dim)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = _all_reduce(p.sum(dim=-1, keepdim=True), "sum", mesh, dim)
    o = _all_reduce(torch.einsum("bkgqt,btkd->bkgqd", p, v.float()), "sum",
                    mesh, dim)
    o = o / torch.clamp(l, min=1e-30)                  # (B, K, G, Sq, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _whole(q, k, v, *, causal: bool, window: int, kv_len, kv_scales):
    """Plain attention over every key at once (``ref.flash_attention_ref``,
    the oracle that the kernel and its chunked version are held to) on
    head-folded copies, folded as ``flash_attention`` folds them on the
    CPU; differentiable through autograd.  Its matrix products are the
    chunked version's, and a trace runs it as a handful of ops where the
    chunked version runs one tile of 64 keys after another."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    check_groups(H, K)
    G = H // K

    def fold(t, reps):      # (B, S, n, w) -> (B * n * reps, S, w)
        t = t.transpose(1, 2)
        if reps > 1:
            t = t.repeat_interleave(reps, dim=1)
        return t.reshape(-1, t.shape[2], t.shape[3])

    out = flash_attention_ref(
        fold(q, 1), fold(k, G), fold(v, G), causal=causal, window=window,
        seq_k=0 if kv_len is None else kv_len,
        kv_scales=None if kv_scales is None else tuple(
            fold(s, G) for s in kv_scales))
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def attention(q: DTensor, k: DTensor, v: DTensor, *, causal: bool,
              window: int, kv_len=None, kv_scales=None) -> DTensor:
    """Attention (shapes as ``flash_attention``'s) on each device's
    shards, by :func:`_whole`.  The batch goes over the data axes.  On the
    model axis: a cache sharded over its sequence stays so, the queries
    replicated (:func:`_seq_parallel`); else the query heads are sharded
    where they divide it, and the KV heads with them where they divide
    it too, or else (they then divide the model axis) each device takes
    the one KV head its query heads read, and the KV gradient is a
    partial sum over the model axis."""
    mesh = q.device_mesh
    md = _model_dim(mesh)
    B, _, H, _ = q.shape
    K, seq_k = k.shape[2], k.shape[1]
    qp, kp = _batch(mesh, B), _batch(mesh, B)
    kgrad = list(kp)
    seq = md is not None and k.placements[md] == Shard(1)
    pick = False
    if seq:
        kp[md] = kgrad[md] = Shard(1)
    elif md is not None and H % mesh.size(md) == 0:
        qp[md] = Shard(2)
        if K % mesh.size(md) == 0:
            kp[md] = kgrad[md] = Shard(2)
        else:
            pick, kgrad[md] = True, Partial()
    scales = tuple(kv_scales) if kv_scales is not None else (None, None)
    rep = [Replicate()] * mesh.ndim

    def local(q, k, v, kv_len, ks, vs):
        sc = None if ks is None else (ks, vs)
        if seq:
            return _seq_parallel(q, k, v, kv_len, sc, window=window,
                                 mesh=mesh, dim=md, seq_k=seq_k)
        if pick:      # query heads [r h, (r + 1) h) read KV head r h // G
            j = mesh.get_local_rank(md) * q.shape[2] // (H // K)
            k, v = k[:, :, j:j + 1], v[:, :, j:j + 1]
            sc = None if sc is None else tuple(s[:, :, j:j + 1] for s in sc)
        return _whole(q, k, v, causal=causal, window=window, kv_len=kv_len,
                      kv_scales=sc)

    args = (q, k, v, kv_len, *scales)
    return local_map(
        local, out_placements=list(qp),     # one output: a list
        in_placements=tuple(_spec(t, p) for t, p in zip(
            args, (qp, kp, kp, rep, kp, kp))),
        in_grad_placements=tuple(_spec(t, p) for t, p in zip(
            args, (qp, kgrad, kgrad, rep, kp, kp))),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def ssd(scan, x: DTensor, loga, dt, Bm, Cm, h0=None, **kw):
    """``scan(x, loga, dt, Bm, Cm, h0=h0, **kw)`` (``ssm.ssd_chunked``:
    x (B, S, H, P), loga and dt (B, S, H), Bm and Cm (B, S, N), h0 (B,
    H, N, P)) on each device's shards.  The scan is independent over the
    batch and the heads: the batch goes over the data axes and the
    heads over the model axis where they divide it, B and C, which the
    heads share, whole on it.  Returns (y, h_final) so placed."""
    mesh = x.device_mesh
    md = _model_dim(mesh)
    bp = _batch(mesh, x.shape[0])
    hx, hs = list(bp), list(bp)
    if md is not None and x.shape[2] % mesh.size(md) == 0:
        hx[md], hs[md] = Shard(2), Shard(1)

    def local(x, loga, dt, Bm, Cm, h0):
        return scan(x, loga, dt, Bm, Cm, h0=h0, **kw)

    args = (x, loga, dt, Bm, Cm, h0)
    return local_map(
        local, out_placements=(list(hx), list(hs)),
        in_placements=tuple(_spec(t, p) for t, p in zip(
            args, (hx, hx, hx, bp, bp, hs))),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def moe(apply, p: dict, x: DTensor, *, top_k: int, activation: str,
        capacity_factor: float, dispatch: str):
    """``apply(p, x, ...)`` (``moe.moe_apply_einsum``) on each device's
    shards.  The groups go over the data axes (a decode step's one group
    whole on every device), the tokens whole on the model axis.  Every
    weight is gathered whole over the data axes (FSDP's gather) and keeps
    its model-axis shard: the experts' (expert parallelism: each device
    runs its slice of the experts on every token's dispatch) or their
    hidden width's (tensor parallelism), and the dense residual FFN's.
    The devices' partial sums are all-reduced over the model axis into
    the output, as :func:`linear`'s row-parallel product; the aux loss takes
    its means over the whole batch (all-reduced over the data axes) and
    is whole everywhere."""
    if dispatch != "einsum":
        raise NotImplementedError(
            f"the {dispatch!r} dispatch on DTensors: its scatter into a "
            f"capacity buffer is not traced; the einsum dispatch is")
    mesh = x.device_mesh
    md = _model_dim(mesh)
    bp = _batch(mesh, x.shape[0])
    batch_dims = [i for i, b in enumerate(bp) if b.is_shard()]
    names, ws = [], []
    for key, val in p.items():
        for sub, w in (val.items() if isinstance(val, dict)
                       else [(None, val)]):
            names.append((key, sub))
            ws.append(w)

    def gathered(w):
        return tuple(w.placements[i] if i == md else Replicate()
                     for i in range(mesh.ndim))

    wp = [gathered(w) for w in ws]
    split = md is not None and any(pl[md].is_shard() for pl in wp)
    ep = md is not None and p["experts"]["w_up"].placements[md] == Shard(0)
    out = list(bp)
    if split:
        out[md] = Partial()

    def mean(t):
        m = t.mean(dim=(0, 1))
        for i in batch_dims:
            m = _all_reduce(m, "sum", mesh, i) / mesh.size(i)
        return m

    def local(x, *ws):
        q: dict = {}
        for (key, sub), w in zip(names, ws):
            if sub is None:
                q[key] = w
            else:
                q.setdefault(key, {})[sub] = w
        experts = None
        if ep:
            n = q["experts"]["w_up"].shape[0]
            experts = slice(mesh.get_local_rank(md) * n,
                            (mesh.get_local_rank(md) + 1) * n)
        return apply(q, x, top_k=top_k, activation=activation,
                     capacity_factor=capacity_factor, experts=experts,
                     mean=mean)

    # gradients: the tokens' a partial sum over the model axis (each
    # device's experts or hidden slice), each weight's over the data axes
    # that hold the batch
    xg = tuple(out)
    wg = [tuple(Partial() if b.is_shard() else q for b, q in zip(bp, pl))
          for pl in wp]
    y, aux = local_map(
        local, out_placements=(out, [Replicate()] * mesh.ndim),
        in_placements=(tuple(bp), *wp), in_grad_placements=(xg, *wg),
        device_mesh=mesh, redistribute_inputs=True)(x, *ws)
    return _reduced(y), aux


def batch_local(fn, p: dict, x: DTensor, state: Optional[dict], **kw):
    """``fn(p, x, state=state, **kw) -> (out, new state or None)`` (the
    xLSTM mixers, ``ssm.mlstm_apply`` and ``ssm.slstm_apply``) on each
    device's batch rows: the weights gathered whole (their rule shards
    them over the data axes alone, FSDP's), ``x``, the state and the
    outputs over the data axes on their first dimension (the mLSTM
    state's is batch x heads, batch-major) and whole on the model axis,
    where every device repeats the same work.  A plain tensor in the
    state (a fresh one) is taken as whole."""
    mesh = x.device_mesh
    bp = tuple(_batch(mesh, x.shape[0]))
    rep = tuple([Replicate()] * mesh.ndim)
    keys = list(p)
    skeys = list(state) if state is not None else []
    svals = [_whole_on(t, mesh) for t in (state or {}).values()]

    def local(x, *rest):
        w = dict(zip(keys, rest[:len(keys)]))
        st = dict(zip(skeys, rest[len(keys):])) if state is not None \
            else None
        out, new = fn(w, x, state=st, **kw)
        return (out, *(new[k] for k in skeys)) if new is not None else out

    n_out = 1 + (len(skeys) if state is not None else 0)
    got = local_map(
        local, out_placements=list(bp) if n_out == 1 else
        tuple([list(bp)] * n_out),
        in_placements=(bp, *[rep] * len(keys), *[bp] * len(svals)),
        device_mesh=mesh, redistribute_inputs=True)(
            x, *(p[k] for k in keys), *svals)
    if state is None:
        return got, None
    return got[0], dict(zip(skeys, got[1:]))


def write_slot(cache: DTensor, slot, src) -> None:
    """``cache.index_copy_(1, slot, src)`` on each device's shard, in
    place: ``src`` (B, 1, ...) goes where the cache's shards are, its
    one position replicated.  A cache sharded over its sequence (dim 1)
    writes on the device whose slice holds the slot and rewrites its own
    entry elsewhere."""
    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements) if p == Shard(1)]
    target = [Replicate() if i in seq else p
              for i, p in enumerate(cache.placements)]
    s = _whole_on(src, mesh).redistribute(mesh, target).to_local().to(cache.dtype)
    at = slot.full_tensor() if is_dtensor(slot) else slot
    c = cache.to_local()
    if not seq:
        c.index_copy_(1, at, s)
        return
    rank = 0
    for i in seq:                    # the mesh's order, major to minor
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
    local = at - rank * c.shape[1]
    hit = ((local >= 0) & (local < c.shape[1])).reshape(
        (1,) * s.dim())
    at = torch.clamp(local, 0, c.shape[1] - 1)
    c.index_copy_(1, at, torch.where(hit, s, c.index_select(1, at)))


def lookup(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` on each device's shards, Megatron's vocabulary-
    parallel embedding: a table whose rows are sharded over the model axis
    gives each device the rows of its slice, zeros for the tokens outside
    it, and the partial sums are all-reduced (:func:`rows`).  The table
    is gathered whole over the data axes (FSDP's gather) and its
    gradient is a partial sum over them.  The port's deterministic lookup
    (``model._Lookup``) sorts its tokens in the backward, whose output
    shape depends on the data, which a trace on fake tensors cannot
    follow."""
    mesh = table.device_mesh
    md = _model_dim(mesh)
    split = md is not None and table.placements[md] == Shard(0)
    tp: List = [Replicate()] * mesh.ndim
    if split:
        tp[md] = Shard(0)
    bp = _batch(mesh, tokens.shape[0])
    grad = [Partial() if b.is_shard() else p for b, p in zip(bp, tp)]
    out = list(bp)
    if split:
        out[md] = Partial()

    def local(table, tokens):
        ids = tokens.long()
        if not split:
            return table[ids]
        ids = ids - mesh.get_local_rank(md) * table.shape[0]
        hit = (ids >= 0) & (ids < table.shape[0])
        got = table[torch.clamp(ids, 0, table.shape[0] - 1)]
        return torch.where(hit[..., None], got, 0.0)

    x = local_map(local, out_placements=out,
                  in_placements=(tuple(tp), tuple(bp)),
                  in_grad_placements=(tuple(grad), tuple(bp)),
                  device_mesh=mesh, redistribute_inputs=True)(
                      table, _whole_on(tokens, mesh))
    return rows(x)


def shard_like(tensors: dict, specs: dict, mesh) -> dict:
    """Each plain tensor of ``tensors`` as the DTensor of its spec's
    placements, every device keeping its own chunk with no collective
    (``distribute_tensor(..., src_data_rank=None)``)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements
    return {k: distribute_tensor(t, mesh, placements(mesh, specs[k]),
                                 src_data_rank=None)
            for k, t in tensors.items()}


__all__ = ["attention", "batch_local", "is_dtensor", "like", "linear",
           "lookup", "moe", "project", "rows", "shard_like", "splits_heads", "ssd",
           "write_slot"]
