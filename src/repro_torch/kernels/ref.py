"""Plain PyTorch versions of the port's kernels.

``paged_attention`` computes exactly what ``csrc/paged_attention.cu``
computes (and the reference's Pallas ``paged_attention``, or with
``window``/``ring`` the reference's jnp ``paged_attend1``): scores in
float32 scaled after the dot, tokens at or past ``seq_len``, before the
window and table holes masked, online softmax over the pages in table
order, output ``acc / (l + 1e-30)``.  The allocator transaction
kernels' plain version is the core math itself
(``core/transactions.alloc_math`` / ``free_math``).  ``ssd_ref`` is the naive sequential recurrence of the
Mamba-2 SSD, the oracle the chunked scan (``kernels/ssd_scan.py``) is
held to.

The piecewise allocator's five steps (``csrc/ring_txn.cu``,
``csrc/bitmap_txn.cu``) have their plain versions here too, computing
what the reference's Pallas kernels compute.  Counters and bit words
are int32 tensors (bit words hold uint32 patterns); the arithmetic
widens to int64.  A ring position is ``(front mod cap + j) mod cap``,
floor modulo as in the reference, taken on the true sum (the TPU
kernels slice a doubled row from ``front mod cap``), so a counter
past 2^31 reads the slot it would read below it.
"""
from __future__ import annotations

import torch

from repro_torch.core._index import wrap32
from repro_torch.core.groups import masked_rank

_NEG = -1e30
_I64 = torch.int64


def page_ids(page_table, wpp=None):
    """Page ids from a table of page ids or of arena word offsets
    (floor division keeps a −1 hole at −1)."""
    pt = page_table.to(torch.int64)
    return pt if wpp is None else torch.div(pt, wpp, rounding_mode="floor")


def slot_tokens(page_table, seq_lens, page: int, window=None,
                ring: bool = False):
    """Absolute token position (B, P, page) int64 of each table slot's
    tokens and whether it is attended: at or past 0, below ``seq_len``
    and, with a ``window``, at or past ``seq_len - window``.  A ring
    table's slot j holds page ``cur - ((cur - j) mod P)``, ``cur`` the
    page of token ``seq_len - 1`` (the reference's validity rules,
    ``repro/paged/kv_cache.py`` ``paged_attend1``)."""
    B, P = page_table.shape
    dev = page_table.device
    seq = seq_lens.to(_I64)[:, None, None]
    j = torch.arange(P, dtype=_I64, device=dev)[None, :, None]
    if ring:
        cur = (torch.clamp(seq, min=1) - 1) // page
        j = cur - torch.remainder(cur - j, P)
    tok = j * page + torch.arange(page, dtype=_I64, device=dev)
    valid = (tok >= 0) & (tok < seq)
    if window is not None:
        valid &= tok > seq - 1 - window
    return tok, valid


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, wpp=None,
                    window=None, ring=False, k_scale=None, v_scale=None,
                    dtype=torch.float32, stage=None):
    """q (B, Hq, D); {k,v}_pages (NP, page, Hkv, D); page_table (B, P);
    seq_lens (B,); int8 pages come with ``k_scale``/``v_scale`` (NP,
    page, Hkv) float32, and each element is read as ``float(k8) *
    scale``.  Returns (B, Hq, D) in ``dtype``, the type the arithmetic
    runs in: float32, as the kernel's; float64 judges both where two
    float32 summation orders part (large scores).  ``stage`` (a control
    of lower precision, on no path of the port): round q / sqrt(D), the
    scales, each dequantized element and p to that type before the sums,
    as the JAX reference stages bf16 and int8 pages in bf16."""
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k_pages.shape
    P = page_table.shape[1]
    G = Hq // Hkv
    pid = page_ids(page_table, wpp)
    _, attended = slot_tokens(page_table, seq_lens, page, window, ring)

    def rnd(x):
        return x if stage is None else x.to(stage).to(dtype)

    qf = q.reshape(B, Hkv, G, D).to(dtype)
    if stage is not None:
        qf = rnd(qf * D ** -0.5)
    m = torch.full((B, Hkv, G, 1), _NEG, dtype=dtype, device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=dtype, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=dtype, device=q.device)
    for i in range(P):
        ids = pid[:, i]
        k = k_pages[ids.clamp(min=0)].to(dtype)    # (B, page, Hkv, D)
        v = v_pages[ids.clamp(min=0)].to(dtype)
        if k_scale is not None:
            k = rnd(k * rnd(k_scale[ids.clamp(min=0)][..., None].to(dtype)))
            v = rnd(v * rnd(v_scale[ids.clamp(min=0)][..., None].to(dtype)))
        s = torch.einsum("bhgd,bthd->bhgt", qf, k)
        if stage is None:
            s = s * (1.0 / D ** 0.5)
        valid = attended[:, i] & (ids >= 0)[:, None]    # (B, page)
        vb = valid[:, None, None, :]
        s = torch.where(vb, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vb, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgt,bthd->bhgd", rnd(p), rnd(v))
        m = m_new
    return (acc / (l + 1e-30)).reshape(B, Hq, D)


def ssd_ref(x, dt, a, b, c, h0=None):
    """Mamba-2 SSD, naive sequential recurrence (the oracle).

    x (B, L, H, P); dt (B, L, H) positive steps; a (H,) negative decay
    rates; b, c (B, L, G, N) with H % G == 0; h0 (B, H, P, N) or None.
    Returns (y (B, L, H, P), h_final (B, H, P, N)), float32."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bh = torch.repeat_interleave(b, rep, dim=2)  # (B, L, H, N)
    ch = torch.repeat_interleave(c, rep, dim=2)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * a[None, :])  # (B, H)
        h = (h * decay[:, :, None, None]
             + (dt[:, t, :, None] * x[:, t]).float()[..., None]
             * bh[:, t, :, None, :].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t].float()))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# the piecewise allocator's steps
# ---------------------------------------------------------------------------

def _bits(words):
    """(W,) int32 words → (32 W,) int64 bits, bit b of word w at 32 w + b."""
    sh = torch.arange(32, dtype=_I64, device=words.device)
    return ((words.to(_I64)[:, None] >> sh[None, :]) & 1).reshape(-1)


def _class_ranks(cls, valid, num_classes: int):
    """(member, rank, class index, per-class member counts) of a lane
    vector: a member is a valid lane whose class lies in
    ``[0, num_classes)``; its rank counts the members of its class on
    lower lanes."""
    c = cls.to(_I64)
    member = valid & (c >= 0) & (c < num_classes)
    rank, counts = masked_rank(cls, member, num_classes)
    ci = torch.where(member, c, torch.zeros_like(c))
    return member, rank.to(_I64), ci, counts.to(_I64)


def ring_window_ref(store, front, counts, m: int):
    """``out[c, j] = store[c, (front[c] + j) mod cap]`` for
    ``j < counts[c]``, else −1; (C, m)."""
    C, cap = store.shape
    if m > cap:
        raise ValueError(f"window {m} exceeds ring capacity {cap}")
    j = torch.arange(m, dtype=_I64, device=store.device)[None, :]
    pos = (torch.remainder(front.to(_I64), cap)[:, None] + j) % cap
    vals = torch.gather(store, 1, pos)
    return torch.where(j < counts.to(_I64)[:, None], vals,
                       torch.full_like(vals, -1))


def ring_txn_pop_ref(store, front, back, cls, valid, limit: bool):
    """Bulk pop of the class rings: each member lane (``valid``, class
    in ``[0, C)``) takes rank ``r`` in its class and reads
    ``store[c, (front[c] + r) mod cap]``.  ``limit`` grants only ranks
    below the inventory ``back − front``; ``limit=False`` pops past it
    (the pool's semantics).  Other lanes read −1.  Returns
    ``(vals (n,), new front (C,))``, front advanced by the grants."""
    C, cap = store.shape
    member, rank, ci, _ = _class_ranks(cls, valid, C)
    grant = member
    if limit:
        avail = wrap32(back.to(_I64) - front.to(_I64)).to(_I64)
        grant = grant & (rank < avail[ci])
    pos = (torch.remainder(front.to(_I64), cap)[ci] + rank) % cap
    vals = torch.where(grant, store[ci, pos],
                       torch.full_like(cls, -1, dtype=store.dtype))
    cnt = torch.zeros(C, dtype=_I64, device=store.device)
    cnt.index_add_(0, ci, grant.to(_I64))
    return vals, wrap32(front.to(_I64) + cnt)


def ring_txn_push_ref(store, back, cls, vals, valid):
    """Bulk push, in place on ``store``: member lane of rank ``r``
    writes its value at ``(back[c] + r) mod cap`` of its class's row.
    Returns ``(store, new back (C,))``.  Defined while no class takes
    more than ``cap`` values."""
    C, cap = store.shape
    member, rank, ci, cnt = _class_ranks(cls, valid, C)
    pos = (torch.remainder(back.to(_I64), cap)[ci] + rank) % cap
    store[ci[member], pos[member]] = vals.to(store.dtype)[member]
    return store, wrap32(back.to(_I64) + cnt)


def chunk_txn_claim_ref(row, take: int, ppc: int):
    """Claim the first ``take`` free bits below ``ppc`` of one chunk's
    bitmap row (bw,).  Returns ``(page_idx (32 bw,) ascending and
    −1-padded, the row with those bits set, claimed count (1,))``."""
    dev = row.device
    occ = _bits(row)
    p = torch.arange(occ.shape[0], dtype=_I64, device=dev)
    free = ((occ == 0) & (p < ppc)).to(_I64)
    order = torch.cumsum(free, 0) - free
    chosen = (free == 1) & (order < take)
    pidx = torch.full((occ.shape[0] + 1,), -1, dtype=_I64, device=dev)
    pidx[torch.where(chosen, order, torch.full_like(order, -1))] = p
    add = (chosen.to(_I64).reshape(-1, 32)
           << torch.arange(32, dtype=_I64, device=dev)[None, :]).sum(1)
    nsel = chosen.sum().reshape(1).to(torch.int32)
    return (pidx[:-1].to(torch.int32), wrap32(row.to(_I64) | add), nsel)


def bitmap_select_ref(words, k: int):
    """Dense rank-select over a bitmap of (W,) words, W a multiple of
    32: each set bit's rank among the set bits if below ``k``, else −1;
    (32 W,) int32."""
    W = words.shape[0]
    if W % 32:
        raise ValueError(f"bitmap words {W} % block 32 != 0")
    bits = _bits(words)
    rank = torch.cumsum(bits, 0) - bits
    return torch.where((bits == 1) & (rank < k), rank,
                       torch.full_like(rank, -1)).to(torch.int32)
