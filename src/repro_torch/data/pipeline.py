"""Deterministic synthetic data pipeline, a copy of
``repro/data/pipeline.py`` (numpy; batch ``i`` is bitwise the
reference's).

Seeded, shardable, restartable: batch ``i`` is a pure function of
(seed, i), so a restarted job resumes mid-epoch exactly (the checkpoint
stores only the step counter — the EdgeKV quorum checkpoint doesn't need
to persist data-iterator state). A Zipf token distribution gives the loss
curve realistic structure (cross-entropy actually decreases).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, AUDIO


@dataclass
class SyntheticTokens:
    cfg: ArchConfig
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ index)
        V = self.cfg.vocab_size
        S_tok = self.seq_len - (self.cfg.frontend_tokens or 0)
        # zipf over a permuted vocab + learnable bigram structure
        raw = rng.zipf(self.zipf_a, size=(self.batch, S_tok + 1))
        toks = (raw % (V - 2)) + 1
        # inject copy structure: every 4th token repeats its predecessor
        toks[:, 3::4] = toks[:, 2::4][:, :toks[:, 3::4].shape[1]]
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == AUDIO:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, self.seq_len, self.cfg.d_model)).astype(
                    np.float32)
        if self.cfg.frontend_tokens:
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_tokens,
                 self.cfg.d_model)).astype(np.float32)
        return out


def make_batch_iterator(cfg: ArchConfig, batch: int, seq_len: int,
                        seed: int = 0, start_index: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    src = SyntheticTokens(cfg, batch, seq_len, seed)
    i = start_index
    while True:
        yield src.batch_at(i)
        i += 1
