"""Plain PyTorch versions of paged decode attention, in the kernel's
layout: q (B, K, G, hd) (G query heads per KV head), pools k_pages and
v_pages (K, N, page, hd), ``page_table`` (B, P_max) pool slots and
``lengths`` (B,) valid tokens per sequence, both integer tensors on the
pools' device.  Returns (B, K, G, hd) in q's type; sums in float32.

* :func:`paged_attention_ref` — the oracle
  (``repro/kernels/paged_attention/ref.py``): gather every sequence's
  pages, masked softmax over the whole row.
* :func:`paged_attention_online_ref` — the online softmax page by page
  that the kernel computes (``_paged_kernel`` of
  ``repro/kernels/paged_attention/kernel.py``).  CPU tensors run it in
  place of the kernel.

Semantics, as in the reference: scores scaled by ``1/sqrt(hd)``;
positions at or past a sequence's length get a finite ``NEG_INF`` and
are selected to zero after the exponential; a sequence of length 0 gives
zeros.  Table entries of pages past ``ceil(length / page)`` are never
dereferenced: they are replaced by slot 0 before any gather (the JAX
gather clamps whatever it finds there, a torch index raises on it).  An
entry within the length is clamped into the pool, as the kernel does.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30   # finite: a row with no valid key must not give exp(-inf + inf)


def safe_table(page_table: torch.Tensor, lengths: torch.Tensor, page: int,
               n_slots: int) -> torch.Tensor:
    """(B, P_max) int64: ``page_table`` with every entry of a page that
    holds no valid position set to 0 and the rest clamped into the pool,
    so that gathering through it never reads past the pool."""
    n_pages = (lengths.long().clamp(min=0) + page - 1) // page      # (B,)
    p = torch.arange(page_table.shape[1], device=page_table.device)
    return torch.where(p[None, :] < n_pages[:, None],
                       page_table.long().clamp(0, n_slots - 1), 0)


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(K, N, page, hd) pool through a (B, P) table -> (B, K, P * page, hd):
    each sequence's tokens, contiguous."""
    K, _, page, hd = pages.shape
    B, P = table.shape
    return pages[:, table].transpose(0, 1).reshape(B, K, P * page, hd)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Gather every sequence's pages, then masked softmax attention."""
    B, K, G, hd = q.shape
    _, N, page, _ = k_pages.shape
    table = safe_table(page_table, lengths, page, N)
    k = gather_pages(k_pages, table).float()        # (B, K, S, hd)
    v = gather_pages(v_pages, table).float()
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) / math.sqrt(hd)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, None]  # (B,1,1,S)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bkgs,bksd->bkgd", p, v).to(q.dtype)


def paged_attention_online_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Online softmax over the table's pages in order, carrying the row
    max ``m``, the row sum ``l`` and the unnormalized output ``acc``; a
    page past a sequence's length changes nothing in its row."""
    B, K, G, hd = q.shape
    _, N, page, _ = k_pages.shape
    scale = 1.0 / math.sqrt(hd)
    table = safe_table(page_table, lengths, page, N)
    lengths = lengths.long()
    qf = q.float()
    m = torch.full((B, K, G, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, hd), dtype=torch.float32, device=q.device)
    t = torch.arange(page, device=q.device)
    for p in range(table.shape[1]):
        kp = k_pages[:, table[:, p]].transpose(0, 1).float()   # (B, K, page, hd)
        vp = v_pages[:, table[:, p]].transpose(0, 1).float()
        mask = (p * page + t[None, :] < lengths[:, None])[:, None, None]
        s = torch.einsum("bkgd,bktd->bkgt", qf, kp) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # select, not multiply: a row with no valid key yet has s == m_new
        # == NEG_INF, and exp(0) would weigh it 1
        pexp = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + pexp.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgt,bktd->bkgd", pexp, vp)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
