"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``,
the counterpart of ``repro/launch/train.py``, on the GPU unless told
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --batch 2 --seq-len 1024 --steps 4

The dense (stablelm-3b, attention in the ``flash_fwd`` kernel, its
gradient in torch ops), MoE and VLM (internvl2-76b, the synthetic
pipeline's patch embeddings before the tokens) families train; the
hybrid and SSM families raise (their scans have no gradient yet), and
so does the audio family (its training is not ported yet).  With ``--ckpt-dir``
the state goes through the EdgeKV quorum checkpointer, and a rerun with
the same directory resumes from its latest step.
"""
from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-hosts", type=int, default=4)
    ap.add_argument("--mirror-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    from repro_torch.configs import get_config, reduced
    from repro_torch.train.loop import train_loop

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    ckpt = None
    if args.ckpt_dir:
        from repro_torch.checkpoint import QuorumCheckpointer
        ckpt = QuorumCheckpointer(
            args.ckpt_dir, args.ckpt_hosts,
            mirror_root=args.mirror_dir or None)
    res = train_loop(cfg, steps=args.steps, batch=args.batch,
                     seq_len=args.seq_len, lr=args.lr, seed=args.seed,
                     ckpt=ckpt, ckpt_every=args.ckpt_every,
                     device=args.device)
    if res.restored_from is not None:
        print(f"resumed from step {res.restored_from}")
    for i, l in enumerate(res.losses):
        if i % max(1, len(res.losses) // 10) == 0 or i == len(
                res.losses) - 1:
            print(f"step {res.final_step - len(res.losses) + i + 1}: "
                  f"loss={l:.4f}")
    print(f"done at step {res.final_step}")


if __name__ == "__main__":
    main()
