"""Serving launcher: batched requests through the EdgeKV two-tier page
pool, on the GPU unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch internvl2-76b --reduced --device cpu

Flow per batch, as in ``repro/launch/serve.py``: shared system prefixes
register as *global* pages (content-hashed, deduplicated, ring-placed);
each sequence's own context becomes *local* pages; prefill builds the
KV cache (or the recurrent state), then tokens decode step by step.  The
page-pool stats show the EdgeKV dedup win.  The dense family (the
default, stablelm-3b; attention in the ``flash_fwd`` kernel), the MoE
family (mixtral-8x7b, arctic-480b; attention in ``flash_fwd``, the
experts' einsum dispatch in plain torch products, as the reference's),
the audio family (seamless-m4t-large-v2: the encoder's self-attention,
the decoder's self-attention and its cross-attention over the encoder's
output all in ``flash_fwd``; the encoder's input, frame embeddings,
comes from the seed, as the frontend is a stub), the VLM family
(internvl2-76b: the dense stack in ``flash_fwd`` over each request's
``frontend_tokens`` patch embeddings, from the seed as the vision
frontend is a stub, and then its tokens), the hybrid (zamba2-1.2b;
Mamba2's prefill scans in the ``ssd_chunked`` kernel, the shared
attention block in ``flash_fwd``) and the SSM family (xlstm-125m; scans
in ``ssd_chunked``) are ported.  mixtral-8x7b at its 32 layers is 186
GB of float32 weights and internvl2-76b at its 80 layers about 282 GB:
neither fits one 80 GB card, so serve a depth-cut copy
(``dataclasses.replace(cfg, n_layers=8)``) with ``params=``.

:func:`serve` does the work and returns what it measured; :func:`main`
prints what the reference prints.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import (AUDIO, get_config,
                                 reduced as reduced_config)
from repro_torch.core.hashring import ChordRing
from repro_torch.device import resolve_device
from repro_torch.edgecache import PagePoolManager
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ssm_scan import ssm_scan_kernel
from repro_torch.models import (LanguageModel, decode_step, init_params,
                                prefill)
from repro_torch.obs import walltime

# the kernel wrappers whose launches serve reports, by kernel name
KERNELS = {"flash_fwd": flash_fwd, "ssd_chunked": ssm_scan_kernel}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def page_requests(vocab_size: int, *, requests: int, prompt_len: int,
                  gen_len: int, shared_prefix_len: int, page_size: int,
                  seed: Union[int, np.random.Generator]
                  ) -> Tuple[np.ndarray, PagePoolManager]:
    """The batch :func:`serve` runs: ``requests`` prompts (requests,
    prompt_len) int32 from ``seed`` (an int, or a numpy Generator that
    the draws advance), the first ``shared_prefix_len`` tokens shared,
    and the EdgeKV page pool (4096 slots of ``page_size``
    tokens, we are group g0 of 4 on the ring) with each request's pages
    registered: the shared prefix as deduplicated global pages, the rest
    of the prompt and the generated tokens as local pages, in token
    order (``pool.page_table(f"req{i}", ...)``)."""
    ring = ChordRing(virtual_nodes=8)
    for g in range(4):
        ring.add_node(f"g{g}")
    pool = PagePoolManager("g0", 4096, page_size, ring)

    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab_size, shared_prefix_len, dtype=np.int32)
    prompts = np.concatenate(
        [np.tile(shared, (requests, 1)),
         rng.integers(1, vocab_size, (requests,
                                      prompt_len - shared_prefix_len),
                      dtype=np.int32)], axis=1)

    # control plane: register pages (dedup happens here)
    n_local = (prompt_len - shared_prefix_len + gen_len + page_size
               - 1) // page_size
    for i in range(requests):
        pool.register_global(f"req{i}", shared)
        pool.alloc_local(f"req{i}", n_local)
    return prompts, pool


def serve(arch: str = "stablelm-3b", *, reduced: bool = False,
          requests: int = 8, prompt_len: int = 24, gen_len: int = 8,
          shared_prefix_len: int = 16, page_size: int = 8, device=None,
          seed: int = 0, teacher_tokens: Optional[np.ndarray] = None,
          params: Optional[LanguageModel] = None) -> Dict[str, Any]:
    """Serve ``requests`` prompts of ``prompt_len`` tokens (the first
    ``shared_prefix_len`` shared) for ``gen_len`` greedy tokens each.
    The audio family's requests also carry ``prompt_len`` frames each,
    as the reference sizes its cache (``enc_len = seq_len``): frame
    embeddings (requests, prompt_len, d_model) float32, drawn by
    ``standard_normal`` from the seed's generator after the prompts, as
    the reference's data pipeline draws them.  A request of a config
    with a stubbed frontend (the VLM family) carries its
    ``frontend_tokens`` patch embeddings, P of them, (requests, P,
    d_model) float32, drawn the same way, put before its prompt: the
    KV cache holds P + prompt_len + gen_len positions.  The page pool
    registers token pages only, as the reference's launcher does: the
    patches are not tokens and hold no page, so the P cache slots that
    hold their K/V stand outside the pool.

    Weights (drawn on the device) and prompts come from ``seed``; with
    ``params``, that model (on the device) is served instead, and its
    config replaces ``arch`` and ``reduced``: two devices draw different
    weights from one seed, so a comparison hands one run's model to the
    other.  With ``teacher_tokens`` ((requests, gen_len) ints) each
    decode step is fed those tokens instead of its own argmax, so two
    runs can be compared step by step.  The device is the GPU unless
    ``device`` names another.

    Returns tokens (requests, gen_len), the logits each token was chosen
    from (requests, gen_len, vocab), prefill and decode seconds, tokens
    per second, the page pool's stats, and ``launches``: how far each
    kernel wrapper's launch count (``flash_fwd.launches``,
    ``ssm_scan_kernel.launches``) moved in prefill and in decode.
    """
    # float32 throughout, as the reference serves.  On the card the
    # matrix products stay in full float32 only while
    # torch.backends.cuda.matmul.allow_tf32 stays False (PyTorch's
    # default): TF32 keeps about three digits, and the card's logits would
    # no longer match the CPU's
    dev = resolve_device(device, "serve")
    if params is None:
        cfg = get_config(arch)
        if reduced:
            cfg = reduced_config(cfg)
        params = init_params(cfg, seed, device=dev)
    elif params.embed.device.type != dev.type:
        raise ValueError(f"serve: params lie on {params.embed.device}, "
                         f"not on {dev}")
    cfg = params.cfg
    rng = np.random.default_rng(seed)
    prompts, pool = page_requests(
        cfg.vocab_size, requests=requests, prompt_len=prompt_len,
        gen_len=gen_len, shared_prefix_len=shared_prefix_len,
        page_size=page_size, seed=rng)
    frames = patches = None
    if cfg.family == AUDIO:
        frames = torch.from_numpy(rng.standard_normal(
            (requests, prompt_len, cfg.d_model)).astype(
                np.float32)).to(dev)
    P = cfg.frontend_tokens
    if P:
        patches = torch.from_numpy(rng.standard_normal(
            (requests, P, cfg.d_model)).astype(np.float32)).to(dev)
    B = requests

    forced = (None if teacher_tokens is None
              else torch.as_tensor(np.asarray(teacher_tokens),
                                   dtype=torch.int64, device=dev))
    V = cfg.vocab_size
    counts = [{n: w.launches for n, w in KERNELS.items()}]
    _sync(dev)
    t0 = walltime()
    logits, cache = prefill(params, cfg,
                            torch.as_tensor(prompts, device=dev).long(),
                            max_len=P + prompt_len + gen_len,
                            enc_frames=frames, prefix_embeds=patches)
    counts.append({n: w.launches for n, w in KERNELS.items()})
    step_logits = [logits[:, -1, :V].clone()]
    del logits
    tok = (step_logits[0].argmax(-1, keepdim=True) if forced is None
           else forced[:, :1])
    generated = [tok]
    _sync(dev)
    t1 = walltime()
    for step in range(1, gen_len):
        lg, cache = decode_step(params, cfg, cache, tok)
        step_logits.append(lg[:, :V])
        tok = (lg[:, :V].argmax(-1, keepdim=True) if forced is None
               else forced[:, step:step + 1])
        generated.append(tok)
    out = torch.cat(generated, dim=1).cpu().numpy()
    _sync(dev)
    t2 = walltime()
    counts.append({n: w.launches for n, w in KERNELS.items()})
    s = pool.stats
    return {
        "arch": cfg.name, "device": str(dev), "tokens": out,
        "logits": torch.stack(step_logits, dim=1).cpu().numpy(),
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "tok_per_s": B * gen_len / (t2 - t0),
        "pool": {"dedup_hits": s["dedup_hits"],
                 "remote_fetches": s["remote_fetch"],
                 "slots_used": pool.used_slots},
        "launches": {n: {"prefill": counts[1][n] - counts[0][n],
                         "decode": counts[2][n] - counts[1][n]}
                     for n in KERNELS},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    help="a config name: stablelm-3b (default), "
                    "deepseek-coder-33b, granite-20b, phi3-medium-14b, "
                    "mixtral-8x7b, arctic-480b, seamless-m4t-large-v2 "
                    "(frames from the seed), internvl2-76b (patch "
                    "embeddings from the seed), zamba2-1.2b or xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--shared-prefix-len", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    r = serve(args.arch, reduced=args.reduced, requests=args.requests,
              prompt_len=args.prompt_len, gen_len=args.gen_len,
              shared_prefix_len=args.shared_prefix_len,
              page_size=args.page_size, device=args.device)
    B, dt = args.requests, r["prefill_s"] + r["decode_s"]
    print(f"served {B} requests x {args.gen_len} tokens "
          f"in {dt:.2f}s ({r['tok_per_s']:.1f} tok/s)")
    print(f"generated[0]: {r['tokens'][0].tolist()}")
    s = r["pool"]
    print(f"edgekv pages: dedup_hits={s['dedup_hits']} "
          f"remote_fetches={s['remote_fetches']} "
          f"slots_used={s['slots_used']} "
          f"(shared prefix stored once for {B} requests)")


if __name__ == "__main__":
    main()
