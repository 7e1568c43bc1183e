"""Preemption-safe training loop over the EdgeKV quorum checkpointer, the
counterpart of ``repro/train/loop.py``.

Restart-exactness: the data pipeline is index-addressable and the
checkpoint stores (params, opt_state, step), so a killed-and-resumed run
replays the identical batch sequence, and every step's arithmetic runs
in the same order on each run (the embedding's backward is the one
formulation that needed care: ``models.model._Lookup``).  Checkpoints
are quorum writes (majority of hosts, stragglers skipped) and can mirror
to a backup pod (§7.3).
"""
from __future__ import annotations

import signal
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.checkpoint import QuorumCheckpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import LanguageModel, init_params
from repro_torch.obs import walltime
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step


@dataclass
class LoopResult:
    losses: List[float]
    final_step: int
    restored_from: Optional[int]
    # wall seconds of each step run, from its batch to its loss on the
    # host (reading the loss waits for the device)
    step_s: List[float] = field(default_factory=list)


def train_loop(cfg: ArchConfig, *, steps: int, batch: int, seq_len: int,
               ckpt: Optional[QuorumCheckpointer] = None,
               ckpt_every: int = 50, lr: float = 3e-4, seed: int = 0,
               resume: bool = True, async_ckpt: bool = True,
               stop_flag: Optional[list] = None, device=None,
               params: Optional[LanguageModel] = None) -> LoopResult:
    """Train ``cfg`` with AdamW(``lr``) for steps ``[start, steps)`` on
    ``SyntheticTokens(cfg, batch, seq_len, seed)``, where ``start`` is
    the checkpoint's latest step when resuming, else 0.

    The device is the GPU unless ``device`` names another; with none
    visible this raises (no CPU fallback).  Weights are drawn from
    ``seed`` on that device; with ``params``, that model (of ``cfg``, on
    the device) is trained instead, in place.  Every ``ckpt_every``
    steps, on SIGTERM (set from the main thread) and at the end, the
    state goes to ``ckpt``."""
    dev = resolve_device(device, "train_loop")
    if params is None:
        params = init_params(cfg, seed, device=dev)
    elif params.cfg != cfg or params.embed.device.type != dev.type:
        raise ValueError(f"train_loop: params are a {params.cfg.name} on "
                         f"{params.embed.device}, not a {cfg.name} on {dev}")
    opt = adamw(lr)
    step_fn, _ = make_train_step(cfg, optimizer=opt, remat=False, chunk=256)
    data = SyntheticTokens(cfg, batch, seq_len, seed=seed)

    named = dict(params.named_parameters())
    opt_state = opt.init(named)
    start = 0
    restored = None
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        st = ckpt.restore({"p": named, "o": opt_state})
        with torch.no_grad():
            for name, t in named.items():
                t.copy_(st["p"][name])
        opt_state = st["o"]
        start = int(ckpt.latest_step())
        restored = start

    # preemption hook: save at the next step boundary on SIGTERM
    preempted = []
    try:
        prev = signal.signal(signal.SIGTERM,
                             lambda *_: preempted.append(True))
    except ValueError:  # not main thread (tests)
        prev = None

    losses: List[float] = []
    step_s: List[float] = []
    done = start
    for step in range(start, steps):
        if (stop_flag and stop_flag[0]) or preempted:
            break
        t0 = walltime()
        b = {k: torch.as_tensor(v, device=dev, dtype=(
                 torch.int64 if v.dtype.kind in "iu" else None))
             for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        step_s.append(walltime() - t0)
        done = step + 1
        if ckpt is not None and done % ckpt_every == 0:
            state = {"p": named, "o": opt_state}
            if async_ckpt:
                ckpt.save_async(done, state)  # overlaps next steps
            else:
                ckpt.save(done, state)

    if ckpt is not None:
        ckpt.wait()
        ckpt.save(done, {"p": named, "o": opt_state})
    if prev is not None:
        signal.signal(signal.SIGTERM, prev)
    return LoopResult(losses, done, restored, step_s)
