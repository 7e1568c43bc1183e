"""Entry point of paged decode attention: single-token queries over the
EdgeKV page pool, on the device the tensors lie on."""
from __future__ import annotations

import torch

from .kernel import paged_decode
from .ref import paged_attention_online_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd) single-token queries; pools (K, N, page, hd) with
    H % K == 0 (query head h reads KV head h // (H / K)); ``page_table``
    (B, P_max) pool slots and ``lengths`` (B,) valid tokens, integer
    tensors on the same device.  Returns (B, H, hd).

    CPU tensors run the plain online version; any other tensors go to the
    ``paged_decode`` CUDA kernel (tables cast to int32 on their device, as
    the reference's wrapper casts them), which raises off a CUDA device.
    There is no other fallback.
    """
    B, H, hd = q.shape
    K = k_pages.shape[0]
    if H % K:
        raise ValueError(f"paged_attention: {H} query heads are not a "
                         f"multiple of {K} KV heads")
    qg = q.reshape(B, K, H // K, hd)
    if q.device.type == "cpu":
        out = paged_attention_online_ref(qg, k_pages, v_pages, page_table,
                                         lengths)
    else:
        out = paged_decode(qg.contiguous(), k_pages.contiguous(),
                           v_pages.contiguous(),
                           page_table.to(torch.int32).contiguous(),
                           lengths.to(torch.int32).contiguous())
    return out.reshape(B, H, hd)
