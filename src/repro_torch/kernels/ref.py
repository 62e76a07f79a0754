"""Plain PyTorch versions of the port's kernels.

``paged_attention`` computes exactly what ``csrc/paged_attention.cu``
computes (and the reference's Pallas ``paged_attention``): scores in
float32 scaled after the dot, tokens at or past ``seq_len`` and table
holes masked, online softmax over the pages in table order, output
``acc / (l + 1e-30)``.  The allocator transaction kernels' plain
version is the core math itself (``core/transactions.alloc_math`` /
``free_math``).
"""
from __future__ import annotations

import torch

_NEG = -1e30


def page_ids(page_table, wpp=None):
    """Page ids from a table of page ids or of arena word offsets
    (floor division keeps a −1 hole at −1)."""
    pt = page_table.to(torch.int64)
    return pt if wpp is None else torch.div(pt, wpp, rounding_mode="floor")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None):
    """q (B, Hq, D); {k,v}_pages (NP, page, Hkv, D); page_table (B, P);
    seq_lens (B,).  Returns (B, Hq, D) float32."""
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k_pages.shape
    P = page_table.shape[1]
    G = Hq // Hkv
    pid = page_ids(page_table, wpp)
    qf = q.reshape(B, Hkv, G, D).float()
    m = torch.full((B, Hkv, G, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    tok = torch.arange(page, device=q.device)
    for i in range(P):
        ids = pid[:, i]
        k = k_pages[ids.clamp(min=0)].float()      # (B, page, Hkv, D)
        v = v_pages[ids.clamp(min=0)].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, k) * (1.0 / D ** 0.5)
        valid = ((i * page + tok)[None, :] < seq_lens[:, None]) \
            & (ids >= 0)[:, None]                  # (B, page)
        vb = valid[:, None, None, :]
        s = torch.where(vb, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vb, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgt,bthd->bhgd", p, v)
        m = m_new
    return (acc / (l + 1e-30)).reshape(B, Hq, D)
