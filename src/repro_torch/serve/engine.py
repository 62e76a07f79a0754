"""Continuous-batching serving engine on the Ouroboros paged KV cache
(port of the reference's host loop).

Requests are admitted into free batch slots, grow their KV page by page
out of the allocator, and release every page when they finish.  Each
decode tick issues at most ONE bulk alloc transaction covering every
growing slot (``_grow_active``), and each retiring request ONE bulk
free; on the card each transaction is one CUDA kernel launch
(``csrc/alloc_txn.cu``) and each layer's decode attention one launch of
``csrc/paged_attention.cu``.  KV pages are bf16, float32 or int8
(``kv_dtype``); int8 heaps carry a float32 scale per (page, slot, kv
head), written with each row and moved with each page.

When a grant fails the engine degrades instead of dying, as the
reference does: it returns the transaction's partial grants, runs ONE
defragmentation wave (``Ouroboros.defrag``: the plan on the card, then
one launch of ``csrc/defrag_txn.cu``), remaps every page reference
through the wave's forwarding table and retries once.  If that grant
fails too, decode growth evicts the youngest slot (its pages freed, its
request requeued at the front) and retries, and admission requeues the
request.  ``defrag_threshold`` adds a proactive wave whenever the
arena's ``frag_ratio`` exceeds it; ``cancel`` drops a request in any
state.

``num_shards > 1`` splits the page space into independent arenas
(``core/shards.py``): each slot's grants home on ``slot % num_shards``
and overflow to neighbour shards inside the same transaction (one
``sharded_alloc_txn`` launch; frees are one ``sharded_free_txn``, waves
one ``sharded_defrag_txn``).  ``rebalance_threshold`` adds a
cross-shard rebalance wave whenever the live pages of the fullest and
the emptiest shard differ by more than that many pages (checked after
admission, before each decode tick).

Per-modality aux pages: a model whose per-sequence state is not KV (the
ssm family's SSD state and conv tail, the moe family's expert buffers)
holds ``aux_pages``
(``kv_cache.modality_page_quota``) pages of the same arena per admitted
slot: granted in ONE bulk alloc before its prefill (the request is
requeued when the grant fails), freed in ONE bulk free at retirement,
eviction or cancel.  The arena is sized ``num_pages + max_batch *
aux_pages``.  An attention-free model has no page table: its slots grow
no KV pages, and its state lives in the model's dense state caches
(the admitted slot's rows written in place by its prefill).  Page ids
of a slot's aux grant are kept as one int64 numpy array.

Two decode loops share admission, retirement and the failure path:

``mega_step=False`` (host loop)  the host computes each slot's page
    need, issues the bulk grow, scatters the grants, decodes, and reads
    the tokens back.

``mega_step=True`` (fused decode mega-step)  the per-slot decode state
    (:class:`MegaState`) lives on the device, allocated once and only
    ever written in place.  One tick computes the page need from it,
    runs the bulk grow (``Ouroboros.grow``: one transaction, one kernel
    launch on the card), scatters the grants into the page table
    (``kv_cache.scatter_grant_words``), decodes with paged attention,
    argmaxes and advances the state, all on the device, with no host
    read inside (on the card the tick runs under
    ``torch.cuda.set_sync_debug_mode("error")``).  The host then reads
    one ``(B,)`` uint8 flag vector (bit 0 finished, bit 1 grant failed)
    and keeps integer mirrors of the state; page ids and tokens come
    back only at retirement.  A failed slot keeps its length and its
    K/V write drops in a table hole; the host returns its partial
    grants, runs a defrag wave and lets the next tick retry, and after
    two failed ticks in a row evicts the youngest slot.  Unlike the
    reference, nothing is admitted while a slot's last grant failed:
    the reference re-admits the evicted request at the next step, before
    the slots that starved can grow, so under sustained pressure (the
    96-page run of ``chip_smoke.py``) it evicts and re-admits the same
    request over and over while the other slots stall.
    Tokens equal the host loop's.

Snapshot/restore (A13), tracer and metrics (A14) are still to port.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import cast_for_compute
from repro_torch.models.transformer import Caches
from repro_torch.paged import kv_cache as KV


_NO_PAGES = np.zeros(0, np.int64)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (Lp,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class MegaState(NamedTuple):
    """The mega-step's device-resident per-slot state, ``(B,)`` each
    unless noted.  The tensors are made once and only written in place
    (admission, the tick, release), so the tick always reads and writes
    the same storage."""
    last_tok: torch.Tensor     # int32, token to decode this tick
    lens: torch.Tensor         # int32, tokens generated (prompt + new)
    page_counts: torch.Tensor  # int32, KV pages mapped
    active: torch.Tensor       # bool
    budget: torch.Tensor       # int32, new tokens still allowed
    eos: torch.Tensor          # int32, eos id, −1 = none
    out_buf: torch.Tensor      # (B, max_new_cap) int32, tokens so far
    n_out: torch.Tensor        # int32, tokens in out_buf


@contextlib.contextmanager
def no_host_sync(device):
    """Raise on any operation that waits for the card inside the block
    (``torch.cuda.set_sync_debug_mode("error")``); nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _ceil_div(x, d: int):
    return -torch.div(-x, d, rounding_mode="floor")


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 512, num_pages: Optional[int] = None,
                 kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 defrag_threshold: Optional[float] = None,
                 num_shards: int = 1,
                 rebalance_threshold: Optional[int] = None,
                 mega_step: bool = False, max_new_cap: int = 256,
                 device="cuda"):
        for name, v in (("max_batch", max_batch), ("max_seq", max_seq),
                        ("max_new_cap", max_new_cap)):
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not isinstance(num_shards, int) or num_shards < 1:
            raise ValueError(
                f"num_shards must be a positive int, got {num_shards!r}")
        if rebalance_threshold is not None:
            if num_shards == 1:
                raise ValueError(
                    "rebalance_threshold requires num_shards > 1")
            if (not isinstance(rebalance_threshold, int)
                    or rebalance_threshold < 1):
                raise ValueError(
                    f"rebalance_threshold must be None or a positive "
                    f"int (pages of max-min shard imbalance), got "
                    f"{rebalance_threshold!r}")
        if defrag_threshold is not None and not (
                0.0 < float(defrag_threshold) < 1.0):
            raise ValueError(
                f"defrag_threshold must be None or a frag_ratio in "
                f"(0, 1), got {defrag_threshold!r}")
        if kv_dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise TypeError(f"kv_dtype {kv_dtype} is not one of bfloat16, "
                            f"float32, int8")
        self.device = resolve_device(device)
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        # matrices cast to the compute dtype once (norms stay float32)
        self.params = cast_for_compute(params, compute_dtype)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.page = KV.PAGE_SIZE
        self.pps = -(-max_seq // self.page)
        self.num_pages = num_pages or max_batch * self.pps
        self.compute_dtype = compute_dtype
        self.defrag_threshold = (None if defrag_threshold is None
                                 else float(defrag_threshold))
        self.page_bytes = 256  # logical bytes per page in the heap
        self.num_shards = num_shards
        self.rebalance_threshold = rebalance_threshold
        self.mega_step = bool(mega_step)
        self.max_new_cap = max_new_cap

        # per-modality page policy: the SSM state rides the same arena
        # as KV pages, aux_pages per admitted slot (0 for dense models)
        self.aux_pages = KV.modality_page_quota(cfg, self.page_bytes)
        # the paper's allocator manages the page-id space; its arena
        # lives on the engine's device, so the transactions run there
        self.ouro, self.wpp, physical_pages = KV.make_kv_allocator(
            self.num_pages + max_batch * self.aux_pages, device=self.device,
            num_shards=num_shards)
        self.alloc_state = self.ouro.init()
        self._shard_words = (self.ouro.layout.shard_words
                             if num_shards > 1
                             else self.ouro.cfg.total_words)
        self._shard_pages = np.zeros(num_shards, np.int64)  # live/shard
        # KV heaps sized by the PHYSICAL page space (segment chunks make
        # granted ids sparse in it)
        self.caches = model.make_decode_caches(
            max_batch, max_seq=max_seq, kv_dtype=kv_dtype,
            num_pages=physical_pages, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        # each admitted slot's aux page ids (empty when it holds none)
        self.slot_aux: List[np.ndarray] = [_NO_PAGES] * max_batch
        self.slot_len = np.zeros(max_batch, np.int64)  # host truth
        self.waiting: List[Request] = []
        self._uid = 0
        # admission ordinals: the youngest active slot is the eviction
        # victim (it loses the least generated work)
        self._admit_ord = np.zeros(max_batch, np.int64)
        self._admit_counter = 0
        if self.mega_step:
            B, dev = max_batch, self.device

            def zeros(dtype=torch.int32):
                return torch.zeros(B, dtype=dtype, device=dev)

            self.mega = MegaState(
                last_tok=zeros(), lens=zeros(), page_counts=zeros(),
                active=zeros(torch.bool), budget=zeros(),
                eos=torch.full((B,), -1, dtype=torch.int32, device=dev),
                out_buf=torch.zeros((B, max_new_cap), dtype=torch.int32,
                                    device=dev),
                n_out=zeros())
            # slot b homes on b % num_shards, as in the host loop
            self._homes = (torch.arange(B, dtype=torch.int32, device=dev)
                           % num_shards)
            # host mirrors, advanced from the per-tick flags only
            self._pages_host = np.zeros(B, np.int64)
            self._nout_host = np.zeros(B, np.int64)
            self._fail_streak = np.zeros(B, np.int64)
            # slots whose grant failed on the last tick: they grow before
            # anything is admitted
            self._starving = np.zeros(B, bool)
        self.stats = {"allocs": 0, "frees": 0, "steps": 0,
                      "alloc_failures": 0,
                      "arena_mem_words": int(self.alloc_state.mem.numel()),
                      "arena_ctl_words": int(self.alloc_state.ctl.numel()),
                      # live pages per shard, and grants that landed off
                      # their home shard (the overflow walk at work)
                      "num_shards": num_shards,
                      "shard_pages_live": [0] * num_shards,
                      "alloc_overflows": 0,
                      # transactions issued: one kernel launch each
                      "alloc_txns": 0, "free_txns": 0,
                      # the allocation-failure path: waves run (one
                      # defrag_txn launch each), of them fired past
                      # defrag_threshold, pages they moved, slots
                      # evicted and requeued, requests cancelled
                      "defrag_waves": 0, "auto_defrag_waves": 0,
                      "pages_migrated": 0, "evictions": 0, "cancels": 0,
                      # cross-shard waves past rebalance_threshold (one
                      # sharded_defrag_txn launch each)
                      "rebalance_waves": 0,
                      # arena pages each admitted slot holds beyond KV
                      "aux_pages_per_slot": self.aux_pages,
                      # the decode loop, and the kernel launches of one
                      # steady tick (``launches_per_tick``)
                      "mega_step": self.mega_step,
                      "launches_per_tick": None}
        self.refresh_frag_stats()

    # ---- request lifecycle -------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos_id=None) -> int:
        if self.mega_step and max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds the mega-step "
                f"device token buffer (max_new_cap={self.max_new_cap}); "
                f"raise max_new_cap at engine construction")
        self._uid += 1
        self.waiting.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, eos_id))
        return self._uid

    def _bulk_alloc(self, homes) -> np.ndarray:
        """ONE allocator transaction granting one page per entry of
        ``homes`` (the requesting slot's home shard; a grant overflows
        to neighbour shards when that shard is full).  Lanes of every
        growing slot coalesce into this single launch.  Returns the page
        ids (int64, −1 for a failed lane)."""
        homes = np.asarray(homes, np.int32)
        n_pages = homes.shape[0]
        lanes = max(self.max_batch * 2, n_pages)
        sizes = torch.full((lanes,), self.page_bytes, dtype=torch.int32,
                           device=self.device)
        mask = torch.arange(lanes, device=self.device) < n_pages
        home = np.zeros(lanes, np.int32)
        home[:n_pages] = homes
        self.stats["alloc_txns"] += 1
        if self.num_shards > 1:
            self.alloc_state, offs = self.ouro.alloc(
                self.alloc_state, sizes, mask,
                shard_hint=torch.from_numpy(home).to(self.device))
        else:
            self.alloc_state, offs = self.ouro.alloc(self.alloc_state, sizes,
                                                     mask)
        offs = offs[:n_pages].cpu().numpy()
        ok = offs >= 0
        self.stats["allocs"] += int(ok.sum())
        self.stats["alloc_failures"] += int((~ok).sum())
        shard = self._note_shard_pages(offs[ok], +1)
        self.stats["alloc_overflows"] += int(
            (shard != home[:n_pages][ok]).sum())
        return np.where(ok, offs.astype(np.int64) // self.wpp, -1)

    def _alloc_pages(self, homes) -> np.ndarray:
        """Bulk page grant with defragmentation recovery: if any lane
        fails, return this transaction's partial grants, run ONE defrag
        wave and retry once.  The retry's result is returned as it is
        (−1 for a page still not granted)."""
        got = self._bulk_alloc(homes)
        if (got >= 0).all():
            return got
        self._bulk_free(got[got >= 0])
        self.defrag()
        return self._bulk_alloc(homes)

    def _note_shard_pages(self, offs, delta: int):
        """Move the per-shard live-page counts by ``delta`` for granted
        or freed word offsets; returns their owning shards.  The
        mega-step skips the count (its grants never reach the host):
        :meth:`_sync_shard_pages_from_table` recomputes it."""
        shard = offs // self._shard_words
        if not self.mega_step:
            self._shard_pages += delta * np.bincount(
                shard, minlength=self.num_shards).astype(np.int64)
            self.stats["shard_pages_live"] = [int(x)
                                              for x in self._shard_pages]
        return shard

    def _sync_shard_pages_from_table(self):
        """Per-shard live pages recomputed from the page table and the
        aux pages (the mega-step's only source of them): one (B, P)
        read, made on demand (rebalance checks), never by the tick."""
        self._shard_pages[:] = 0
        pages = [a for a in self.slot_aux if a.size]
        if self.caches.kv is not None:
            pt = self.caches.kv.page_table.cpu().numpy().astype(np.int64)
            pages.append(pt[pt >= 0])
        if pages:
            self._shard_pages += np.bincount(
                np.concatenate(pages) * self.wpp // self._shard_words,
                minlength=self.num_shards).astype(np.int64)
        self.stats["shard_pages_live"] = [int(x) for x in self._shard_pages]

    def _bulk_free(self, pages, count_stats: bool = True):
        """ONE free transaction returning ``pages`` (ids, a list or an
        array).  ``count_stats`` False leaves ``frees`` alone (grants
        that were never counted as allocs either)."""
        pages = np.asarray(pages, np.int64)
        if not pages.size:
            return
        lanes = max(self.max_batch * 2, pages.shape[0])
        offs = np.full(lanes, -1, np.int32)
        offs[:pages.shape[0]] = pages * self.wpp
        offs_t = torch.from_numpy(offs).to(self.device)
        sizes = torch.full((lanes,), self.page_bytes, dtype=torch.int32,
                           device=self.device)
        self.alloc_state = self.ouro.free(self.alloc_state, offs_t, sizes,
                                          offs_t >= 0)
        if count_stats:
            self.stats["frees"] += int(pages.shape[0])
        self.stats["free_txns"] += 1
        self._note_shard_pages(offs[offs >= 0], -1)

    def _map_pages(self, slot: int, upto_tokens: int) -> bool:
        """Grow a slot's page table to cover ``upto_tokens`` positions
        (admission path; decode growth coalesces in ``_grow_active``).
        False, with the partial grants returned, when the heap cannot
        hold them even after a defrag wave."""
        if self.caches.kv is None:  # attention-free: no KV pages
            return True
        need = -(-upto_tokens // self.page)
        missing = need - len(self.slot_pages[slot])
        if missing <= 0:
            return True
        got = self._alloc_pages([slot % self.num_shards] * missing)
        if (got < 0).any():
            self._bulk_free(got[got >= 0])
            return False
        self._map_granted([slot] * missing, got.tolist())
        return True

    def _alloc_aux(self, slot: int) -> bool:
        """Grant the slot its ``aux_pages`` in ONE bulk transaction (with
        the defrag retry); on failure the partial grant goes back and
        False is returned."""
        if self.aux_pages == 0:
            return True
        got = self._alloc_pages(np.full(self.aux_pages,
                                        slot % self.num_shards, np.int32))
        if (got < 0).any():
            self._bulk_free(got[got >= 0])
            return False
        self.slot_aux[slot] = got
        return True

    def _free_aux(self, slot: int):
        self._bulk_free(self.slot_aux[slot])
        self.slot_aux[slot] = _NO_PAGES

    def _map_granted(self, slots: List[int], pages: List[int]):
        """Extend the slots' page tables with granted page ids (one
        scatter covers every growing slot)."""
        cols = []
        grown: Dict[int, int] = {}
        for s in slots:
            cols.append(len(self.slot_pages[s]) + grown.get(s, 0))
            grown[s] = grown.get(s, 0) + 1
        dev = self.device
        self.caches.kv.page_table[
            torch.tensor(slots, dtype=torch.int64, device=dev),
            torch.tensor(cols, dtype=torch.int64, device=dev)] = \
            torch.tensor(pages, dtype=torch.int32, device=dev)
        for s, g in zip(slots, pages):
            self.slot_pages[s].append(g)

    def refresh_frag_stats(self):
        """``free_words``, ``largest_free_extent`` and ``frag_ratio``
        of the arena into ``stats`` (lists, one entry per shard, when
        ``num_shards > 1``)."""
        fs = self.ouro.frag_stats(self.alloc_state)
        self.stats.update(fs)
        return fs

    # ---- defragmentation (core/defrag.py) -----------------------------------

    def defrag(self) -> int:
        """Run one defragmentation wave on the KV allocator and remap
        every page reference the engine holds through its forwarding
        table (KV heaps, page table, slot page lists).  Returns the
        pages migrated.  Runs on allocation failure and past
        ``defrag_threshold``; operators may call it between steps."""
        self.alloc_state, fwd = self.ouro.defrag(self.alloc_state)
        moved = self._apply_forwarding(fwd)
        self.stats["defrag_waves"] += 1
        self.stats["pages_migrated"] += moved
        self.refresh_frag_stats()
        return moved

    def _maybe_auto_defrag(self):
        """One wave when ``frag_ratio`` (its largest over the shards)
        exceeds ``defrag_threshold`` (checked after every step), counted
        also in ``auto_defrag_waves``."""
        if self.defrag_threshold is None:
            return
        ratio = self.refresh_frag_stats()["frag_ratio"]
        if self.num_shards > 1:
            ratio = max(ratio)
        if ratio > self.defrag_threshold:
            self.defrag()
            self.stats["auto_defrag_waves"] += 1

    def _maybe_rebalance(self):
        """One cross-shard rebalance wave when the live pages of the
        fullest and the emptiest shard differ by more than
        ``rebalance_threshold``."""
        if self.num_shards == 1 or self.rebalance_threshold is None:
            return
        if self.mega_step:
            self._sync_shard_pages_from_table()
        live = self._shard_pages
        if int(live.max() - live.min()) <= self.rebalance_threshold:
            return
        self.alloc_state, fwd = self.ouro.rebalance(self.alloc_state)
        moved = self._apply_forwarding(fwd)
        self.stats["rebalance_waves"] += 1
        self.stats["pages_migrated"] += moved
        self.refresh_frag_stats()

    def _apply_forwarding(self, fwd) -> int:
        """Remap the engine's page references through a forwarding
        table: KV rows (and int8 scales) move old→new in place,
        page-table entries and ``slot_pages`` are rewritten, and the
        per-shard live counts follow pages that change shards.  Returns
        the pages migrated."""
        src = fwd.src.cpu()
        if not bool((src >= 0).any()):
            return 0
        max_span = self.ouro.cfg.words_per_chunk // self.wpp
        if self.caches.kv is not None:
            KV.apply_forwarding(self.caches.kv, fwd, self.wpp,
                                max_span=max_span)
        sp, dp = (x.cpu().numpy().astype(np.int64) for x in
                  KV.forwarding_page_map(fwd, self.wpp, max_span))
        keep = sp >= 0
        sp, dp = sp[keep], dp[keep]
        order = np.argsort(sp, kind="stable")
        sp, dp = sp[order], dp[order]

        def remap(pages):
            """New ids of ``pages`` (int64); moved pages change shards'
            live counts."""
            idx = np.searchsorted(sp, pages)
            hit = idx < len(sp)
            hit[hit] = sp[idx[hit]] == pages[hit]
            new = pages.copy()
            new[hit] = dp[idx[hit]]
            self._note_shard_pages(pages[hit] * self.wpp, -1)
            self._note_shard_pages(new[hit] * self.wpp, +1)
            return new

        for pages in self.slot_pages:
            if pages:
                pages[:] = remap(np.asarray(pages, np.int64)).tolist()
        self.slot_aux = [remap(a) if a.size else a for a in self.slot_aux]
        # mid-flight a mega slot's page ids live only in the page table,
        # which apply_forwarding rewrote above
        return len(sp)

    def _admit(self):
        if self.mega_step and self._starving.any():
            return
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            lp = len(req.prompt)
            if not self._alloc_aux(slot):
                self.waiting.insert(0, req)  # heap full; retry later
                break
            if not self._map_pages(slot, lp + 1):
                self._free_aux(slot)
                self.waiting.insert(0, req)  # heap full; retry later
                break
            # prefill the admitted row alone: its own table row, the
            # shared heaps, seq_len 0 (the reference's padded batch with
            # the other rows' tables hidden writes exactly these pages);
            # an SSM model writes the final states into the slot's rows
            kv, c = self.caches.kv, self.caches
            row = Caches(
                kv=None if kv is None else KV.PagedKV(
                    layers=kv.layers,
                    page_table=kv.page_table[slot:slot + 1],
                    seq_lens=torch.zeros(1, dtype=torch.int32,
                                         device=self.device)),
                ssm_h=None if c.ssm_h is None else c.ssm_h[:, slot:slot + 1],
                ssm_conv=(None if c.ssm_conv is None
                          else c.ssm_conv[:, slot:slot + 1]))
            tokens = torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                     device=self.device)
            logits, _ = self.model.prefill(self.params, {"tokens": tokens},
                                           row, dtype=self.compute_dtype)
            if kv is not None:
                kv.seq_lens[slot] = lp
            first = int(torch.argmax(logits[0]))
            req.out_tokens.append(first)
            self.slot_req[slot] = req
            self.slot_len[slot] = lp + 1
            self._admit_counter += 1
            self._admit_ord[slot] = self._admit_counter
            if self.mega_step:
                self._mega_admit(slot, req, first)

    # ---- graceful degradation: evict + requeue, cancel ----------------------

    def _youngest_active(self, exclude=()) -> Optional[int]:
        """The eviction victim: the most recently admitted active slot
        not in ``exclude`` (greedy decode replays its stream identically
        after re-admission)."""
        slots = [s for s in range(self.max_batch)
                 if self.slot_req[s] is not None and s not in exclude]
        if not slots:
            return None
        return max(slots, key=lambda s: int(self._admit_ord[s]))

    def _evict_slot(self, slot: int):
        """Evict an active slot: free its pages, zero its state and push
        its request to the FRONT of the waiting queue with its generated
        tokens discarded (re-admission replays the identical stream).
        Counted in ``stats["evictions"]``."""
        req = self.slot_req[slot]
        self._release(slot)
        req.out_tokens = []
        req.done = False
        self.waiting.insert(0, req)
        self.stats["evictions"] += 1

    def cancel(self, uid: int) -> bool:
        """Cancel a request between any two steps: one still waiting is
        removed; an active one frees every page its slot holds; a
        retired (or unknown) uid is a no-op returning False.  Returns
        True iff a request was cancelled (``stats["cancels"]``)."""
        for i, r in enumerate(self.waiting):
            if r.uid == uid:
                self.waiting.pop(i)
                self.stats["cancels"] += 1
                return True
        for slot in range(self.max_batch):
            r = self.slot_req[slot]
            if r is not None and r.uid == uid:
                self._release(slot)
                self.stats["cancels"] += 1
                return True
        return False

    # ---- main loop -----------------------------------------------------------
    def _grow_active(self, active: List[int]) -> List[int]:
        """Decode-step page growth for ALL active slots as ONE bulk
        alloc transaction.  When the grant fails even after a defrag
        wave, evicts the youngest slot and retries; never raises.
        Returns the slots still active."""
        active = list(active)
        if self.caches.kv is None:  # attention-free: no KV pages
            return active
        while True:
            slots = []
            for s in active:
                need = -(-(int(self.slot_len[s]) + 1) // self.page)
                slots.extend([s] * (need - len(self.slot_pages[s])))
            if not slots:
                return active
            got = self._alloc_pages([s % self.num_shards for s in slots])
            if (got >= 0).all():
                self._map_granted(slots, got.tolist())
                return active
            self._bulk_free(got[got >= 0])
            victim = self._youngest_active()
            if victim is None:
                return active
            self._evict_slot(victim)
            if victim in active:
                active.remove(victim)

    def _step_host(self) -> List[Request]:
        """Grow pages (evicting under exhaustion), decode one token for
        every surviving slot (token ids, not logits, come back to the
        host), retire finished requests."""
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        finished = []
        if active:
            active = self._grow_active(active)
        if active:
            toks = np.zeros((self.max_batch, 1), np.int64)
            for s in active:
                toks[s, 0] = self.slot_req[s].out_tokens[-1]
            logits, self.caches = self.model.decode_step(
                self.params, torch.from_numpy(toks).to(self.device),
                self.caches, dtype=self.compute_dtype)
            nxt = torch.argmax(logits, -1).cpu().numpy()
            for s in active:
                req = self.slot_req[s]
                req.out_tokens.append(int(nxt[s]))
                self.slot_len[s] += 1
                if (len(req.out_tokens) >= req.max_new_tokens
                        or (req.eos_id is not None
                            and int(nxt[s]) == req.eos_id)):
                    req.done = True
                    finished.append(req)
                    self._release(s)
        return finished

    # ---- the fused decode mega-step --------------------------------------

    def _mega_admit(self, slot: int, req: Request, first: int):
        """Write an admitted slot's control state into the device state.
        The pages granted at admission are already in its page-table
        row, which from here on is their only holder (``slot_pages`` is
        cleared; retirement reads the row back)."""
        npages = len(self.slot_pages[slot])
        self._pages_host[slot] = npages
        self.slot_pages[slot] = []
        self._nout_host[slot] = 1
        self._fail_streak[slot] = 0
        ms = self.mega
        for t, v in ((ms.last_tok, first), (ms.lens, int(self.slot_len[slot])),
                     (ms.page_counts, npages), (ms.active, True),
                     (ms.budget, req.max_new_tokens - 1),
                     (ms.eos, -1 if req.eos_id is None else int(req.eos_id)),
                     (ms.n_out, 1)):
            t[slot] = v
        ms.out_buf[slot] = 0
        ms.out_buf[slot, 0] = first

    def _tick(self, alloc_state, caches, ms: MegaState):
        """One decode tick on the device, reading nothing back: each
        slot's page need, ONE grow transaction (always issued, also when
        every lane is masked), the grants into the page table (a slot
        that missed any page gets none of them: it fails the tick),
        decode with paged attention, greedy argmax, and the in-place
        advance of ``ms`` for the slots that did not fail.  Returns
        ``(alloc_state, flags, lanes)``: flags (B,) uint8, bit 0
        finished, bit 1 failed; lanes the grow's (offsets, slots, mask),
        None for an attention-free model (nothing grows, nothing
        fails)."""
        B, dev = self.max_batch, self.device
        kv = caches.kv
        if kv is not None:
            need = torch.clamp(_ceil_div(ms.lens + 1, self.page)
                               - ms.page_counts, min=0)
            need = torch.where(ms.active, need, torch.zeros_like(need))
            alloc_state, offs, l_slot, l_rank, l_mask = self.ouro.grow(
                alloc_state, need, self.page_bytes, B,
                home=self._homes if self.num_shards > 1 else None)
            ok = l_mask & (offs >= 0)
            slots = torch.arange(B, dtype=torch.int32, device=dev)
            granted = ((l_slot[None, :] == slots[:, None])
                       & ok[None, :]).sum(1)
            failed = ms.active & (granted < need)
            grant_ok = ok & ~failed[l_slot.long()]
            KV.scatter_grant_words(kv.page_table, ms.page_counts, l_slot,
                                   l_rank, offs, grant_ok, self.wpp)
            ms.page_counts.add_(torch.where(failed, torch.zeros_like(need),
                                            need))
            lanes = (offs, l_slot, l_mask)
        else:
            failed = torch.zeros(B, dtype=torch.bool, device=dev)
            lanes = None
        advance = ms.active & ~failed
        logits, _ = self.model.decode_step(
            self.params, ms.last_tok[:, None].long(), caches,
            dtype=self.compute_dtype, advance=advance)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        col = torch.clamp(ms.n_out, max=self.max_new_cap - 1).long()[:, None]
        ms.out_buf.scatter_(1, col, torch.where(
            advance[:, None], nxt[:, None], ms.out_buf.gather(1, col)))
        step = advance.to(torch.int32)
        ms.budget.sub_(step)
        finished = advance & ((ms.budget <= 0)
                              | ((ms.eos >= 0) & (nxt == ms.eos)))
        ms.last_tok.copy_(torch.where(advance, nxt, ms.last_tok))
        ms.lens.add_(step)
        ms.n_out.add_(step)
        ms.active.logical_and_(~finished)
        flags = finished.to(torch.uint8) | (failed.to(torch.uint8) << 1)
        return alloc_state, flags, lanes

    def _step_mega(self) -> List[Request]:
        """One mega-step tick and its host follow-up: the tick (guarded
        against host syncs on the card), the one read of the flags, the
        host mirrors advanced from them, the failure path, retirement
        (where page ids and tokens come back)."""
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        if not active:
            return []
        with no_host_sync(self.device):
            self.alloc_state, flags, lanes = self._tick(
                self.alloc_state, self.caches, self.mega)
        flags = flags.cpu().numpy()           # the tick's one host read
        fin = (flags & 1) > 0
        fail = (flags & 2) > 0
        self._starving[:] = fail
        has_kv = self.caches.kv is not None
        # the grants recomputed with the device's need formula, so that
        # allocs and frees stay balanced
        grants = 0
        for s in active:
            if fail[s]:
                self.stats["alloc_failures"] += 1
                continue
            if has_kv:
                missing = max(-(-(int(self.slot_len[s]) + 1) // self.page)
                              - int(self._pages_host[s]), 0)
                grants += missing
                self._pages_host[s] += missing
            self.slot_len[s] += 1
            self._nout_host[s] += 1
        if has_kv:
            self.stats["alloc_txns"] += 1
            self.stats["allocs"] += grants
        if fail.any():
            self._recover_failed(fail, fin, *lanes)
        else:
            self._fail_streak[:] = 0
        return [self._release_mega(int(s)) for s in np.nonzero(fin)[0]
                if self.slot_req[s] is not None]   # not evicted this tick

    def _recover_failed(self, fail, fin, l_offs, l_slot, l_mask):
        """After a failed tick (host side, as in the host loop): return
        the failed slots' partial grants (uncounted), run ONE defrag
        wave, and let the next tick retry.  A slot failing twice in a
        row means the wave cannot reclaim enough: the youngest active
        slot not finishing this tick is evicted (requeued)."""
        offs = l_offs.cpu().numpy()
        slot = l_slot.cpu().numpy()
        leaked = l_mask.cpu().numpy() & (offs >= 0) & fail[slot]
        self._free_offsets(offs[leaked])
        self.defrag()
        self._fail_streak[fail] += 1
        self._fail_streak[~fail] = 0
        if (self._fail_streak >= 2).any():
            # a slot finishing this tick retires (and frees) next
            victim = self._youngest_active(
                exclude={int(s) for s in np.nonzero(fin)[0]})
            if victim is not None:
                self._evict_slot(victim)
                self._fail_streak[:] = 0

    def _free_offsets(self, offs_words):
        """Uncounted bulk free of granted word offsets that never
        reached the table (nor the ``allocs`` count)."""
        if len(offs_words):
            self._bulk_free(offs_words.astype(np.int64) // self.wpp,
                            count_stats=False)

    def _release_mega(self, slot: int) -> Request:
        """Retire a finished mega slot: its tokens come back from the
        device, then its pages are freed and its state zeroed."""
        req = self.slot_req[slot]
        n = int(self._nout_host[slot])
        req.out_tokens = self.mega.out_buf[slot, :n].cpu().tolist()
        req.done = True
        self._release(slot)
        return req

    def _probe_caches(self) -> Caches:
        """Caches for a probe tick that leaves the engine's as they are:
        copies of the page table, ``seq_lens`` and the SSM states, and
        the engine's own KV heaps, which a full-width model cannot hold
        twice.  The probe's K/V writes land at each row's ``seq_lens``
        (the next token's slot, written again before it is read) or in
        pages that are free in the engine's arena (written before they
        are read when granted), so no read sees them."""
        c = self.caches
        kv = None if c.kv is None else c.kv._replace(
            page_table=c.kv.page_table.clone(),
            seq_lens=c.kv.seq_lens.clone())
        return Caches(kv=kv, ssm_h=_clone(c.ssm_h),
                      ssm_conv=_clone(c.ssm_conv))

    def launches_per_tick(self) -> int:
        """Hand-written kernel launches of ONE steady decode tick,
        counted by ``kernels/ops.LAUNCHES`` over a tick run on copies of
        the arena and the slot state (the engine's own are left as they
        are; the caches as :meth:`_probe_caches` says): the mega-step's
        tick, or the host loop's decode plus its bulk grow (none for an
        attention-free model).  On the card a qwen2 or mixtral tick is
        one grow transaction plus one ``paged_attention`` a layer, at
        every ``max_batch``; on the CPU the plain versions run and the
        count is 0.  Recorded in ``stats["launches_per_tick"]``."""
        from repro_torch.kernels import ops
        alloc_state, caches = _clone(self.alloc_state), self._probe_caches()
        before = dict(ops.LAUNCHES)
        if self.mega_step:
            with no_host_sync(self.device):
                self._tick(alloc_state, caches, _clone(self.mega))
        else:
            toks = torch.zeros((self.max_batch, 1), dtype=torch.int64,
                               device=self.device)
            self.model.decode_step(self.params, toks, caches,
                                   dtype=self.compute_dtype)
            if caches.kv is not None:   # _bulk_alloc's lane shapes
                lanes = 2 * self.max_batch
                sizes = torch.full((lanes,), self.page_bytes,
                                   dtype=torch.int32, device=self.device)
                mask = torch.arange(lanes, device=self.device) < 1
                kw = ({} if self.num_shards == 1 else {
                    "shard_hint": torch.zeros(lanes, dtype=torch.int32,
                                              device=self.device)})
                self.ouro.alloc(alloc_state, sizes, mask, **kw)
        n = sum(ops.LAUNCHES[k] - before[k] for k in before)
        self.stats["launches_per_tick"] = n
        return n

    def step(self) -> List[Request]:
        """Admit, decode one token for all active slots (the mega-step
        or the host loop), retire finished requests.  Returns the
        requests finished this step."""
        self._admit()
        self._maybe_rebalance()
        finished = self._step_mega() if self.mega_step else self._step_host()
        self.stats["steps"] += 1
        self._maybe_auto_defrag()
        return finished

    def _release(self, slot: int):
        """Free every page the slot holds (KV, then aux: one transaction
        each) and zero its state, host and device.  Mid-flight a mega
        slot's KV page ids live only in its page-table row, read back
        here."""
        if self.mega_step:
            kv = self.caches.kv
            if kv is not None:
                row = kv.page_table[slot].cpu().numpy()
                self._bulk_free(row[row >= 0])
            ms = self.mega
            for t, v in ((ms.last_tok, 0), (ms.lens, 0), (ms.page_counts, 0),
                         (ms.active, False), (ms.budget, 0), (ms.eos, -1),
                         (ms.n_out, 0)):
                t[slot] = v
            self._pages_host[slot] = 0
            self._nout_host[slot] = 0
            self._fail_streak[slot] = 0
            self._starving[slot] = False
        else:
            self._bulk_free(self.slot_pages[slot])
            self.slot_pages[slot] = []
        self._free_aux(slot)
        kv = self.caches.kv
        if kv is not None:
            kv.page_table[slot] = -1
            kv.seq_lens[slot] = 0
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self._admit_ord[slot] = 0

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.waiting and all(r is None for r in self.slot_req):
                break
        return out


def _clone(x):
    """A deep copy of a tensor or a (nested) NamedTuple of tensors."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(_clone(v) for v in x))
