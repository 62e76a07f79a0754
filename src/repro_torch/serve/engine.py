"""Continuous-batching serving engine on the Ouroboros paged KV cache
(port of the reference's host loop).

Requests are admitted into free batch slots, grow their KV page by page
out of the allocator, and release every page when they finish.  Each
decode tick issues at most ONE bulk alloc transaction covering every
growing slot (``_grow_active``), and each retiring request ONE bulk
free; on the card each transaction is one CUDA kernel launch
(``csrc/alloc_txn.cu``) and each layer's decode attention one launch of
``csrc/paged_attention.cu``.

Host loop only: the fused decode mega-step (ROADMAP A9), defragmentation
and eviction (A10), shards (A11), snapshot/restore (A13), tracer and
metrics (A14) are still to port.  An allocation failure raises where
the reference would run a defragmentation wave.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import cast_for_compute
from repro_torch.models.transformer import Caches
from repro_torch.paged import kv_cache as KV


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (Lp,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 512, num_pages: Optional[int] = None,
                 kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 device="cuda"):
        for name, v in (("max_batch", max_batch), ("max_seq", max_seq)):
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if kv_dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f"kv_dtype {kv_dtype} is not ported yet (ROADMAP A6)")
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
        self.page_bytes = 256  # logical bytes per page in the heap

        # the paper's allocator manages the page-id space; its arena
        # lives on the engine's device, so the transactions run there
        self.ouro, self.wpp, physical_pages = KV.make_kv_allocator(
            self.num_pages, device=self.device)
        self.alloc_state = self.ouro.init()
        # KV heaps sized by the PHYSICAL page space (segment chunks make
        # granted ids sparse in it)
        self.caches = model.make_decode_caches(
            max_batch, max_seq=max_seq, kv_dtype=kv_dtype,
            num_pages=physical_pages, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_len = np.zeros(max_batch, np.int64)  # host truth
        self.waiting: List[Request] = []
        self._uid = 0
        self.stats = {"allocs": 0, "frees": 0, "steps": 0,
                      "alloc_failures": 0,
                      "arena_mem_words": int(self.alloc_state.mem.numel()),
                      "arena_ctl_words": int(self.alloc_state.ctl.numel()),
                      # transactions issued: one kernel launch each
                      "alloc_txns": 0, "free_txns": 0}
        self.refresh_frag_stats()

    # ---- request lifecycle -------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos_id=None) -> int:
        self._uid += 1
        self.waiting.append(Request(self._uid, np.asarray(prompt, np.int32),
                                    max_new_tokens, eos_id))
        return self._uid

    def _bulk_alloc(self, n_pages: int) -> List[int]:
        """ONE allocator transaction granting ``n_pages`` pages; lanes
        of every growing slot coalesce into this single launch."""
        lanes = max(self.max_batch * 2, n_pages)
        sizes = torch.full((lanes,), self.page_bytes, dtype=torch.int32,
                           device=self.device)
        mask = torch.arange(lanes, device=self.device) < n_pages
        self.stats["alloc_txns"] += 1
        self.alloc_state, offs = self.ouro.alloc(self.alloc_state, sizes,
                                                 mask)
        offs = offs[:n_pages].cpu().numpy()
        ok = offs >= 0
        self.stats["allocs"] += int(ok.sum())
        self.stats["alloc_failures"] += int((~ok).sum())
        return [int(o) // self.wpp if o >= 0 else -1 for o in offs]

    def _alloc_pages(self, n_pages: int) -> List[int]:
        """Bulk page grant.  On a failed lane the partial grants go
        back, then this raises where the reference would run a
        defragmentation wave and retry."""
        got = self._bulk_alloc(n_pages)
        if all(g >= 0 for g in got):
            return got
        self._bulk_free([g for g in got if g >= 0])
        raise RuntimeError(
            f"KV page heap exhausted ({sum(g < 0 for g in got)} of "
            f"{n_pages} pages not granted); defragmentation and eviction "
            f"are not ported yet (ROADMAP A10)")

    def _bulk_free(self, pages: List[int]):
        if not pages:
            return
        lanes = max(self.max_batch * 2, len(pages))
        offs = np.full(lanes, -1, np.int32)
        offs[:len(pages)] = np.asarray(pages, np.int32) * self.wpp
        offs_t = torch.from_numpy(offs).to(self.device)
        sizes = torch.full((lanes,), self.page_bytes, dtype=torch.int32,
                           device=self.device)
        self.alloc_state = self.ouro.free(self.alloc_state, offs_t, sizes,
                                          offs_t >= 0)
        self.stats["frees"] += len(pages)
        self.stats["free_txns"] += 1

    def _map_pages(self, slot: int, upto_tokens: int):
        """Grow a slot's page table to cover ``upto_tokens`` positions
        (admission path; decode growth coalesces in ``_grow_active``)."""
        need = -(-upto_tokens // self.page)
        missing = need - len(self.slot_pages[slot])
        if missing > 0:
            self._map_granted([slot] * missing, self._alloc_pages(missing))

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
        of the arena into ``stats``."""
        fs = self.ouro.frag_stats(self.alloc_state)
        self.stats.update(fs)
        return fs

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            lp = len(req.prompt)
            self._map_pages(slot, lp + 1)
            # prefill the admitted row alone: its own table row, the
            # shared heaps, seq_len 0 — the reference's padded batch with
            # the other rows' tables hidden writes exactly these pages
            kv = self.caches.kv
            row = KV.PagedKV(layers=kv.layers,
                             page_table=kv.page_table[slot:slot + 1],
                             seq_lens=torch.zeros(1, dtype=torch.int32,
                                                  device=self.device))
            tokens = torch.as_tensor(req.prompt[None], dtype=torch.int64,
                                     device=self.device)
            logits, _ = self.model.prefill(self.params, {"tokens": tokens},
                                           Caches(kv=row),
                                           dtype=self.compute_dtype)
            kv.seq_lens[slot] = lp
            req.out_tokens.append(int(torch.argmax(logits[0])))
            self.slot_req[slot] = req
            self.slot_len[slot] = lp + 1

    # ---- main loop -----------------------------------------------------------
    def _grow_active(self, active: List[int]):
        """Decode-step page growth for ALL active slots as ONE bulk
        alloc transaction."""
        slots = []
        for s in active:
            need = -(-(int(self.slot_len[s]) + 1) // self.page)
            slots.extend([s] * (need - len(self.slot_pages[s])))
        if slots:
            self._map_granted(slots, self._alloc_pages(len(slots)))

    def _step_host(self) -> List[Request]:
        """Grow pages, decode one token for every active slot (token ids,
        not logits, come back to the host), retire finished requests."""
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        finished = []
        if active:
            self._grow_active(active)
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

    def step(self) -> List[Request]:
        """Admit, decode one token for all active slots, retire finished
        requests.  Returns the requests finished this step."""
        self._admit()
        finished = self._step_host()
        self.stats["steps"] += 1
        return finished

    def _release(self, slot: int):
        self._bulk_free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        kv = self.caches.kv
        kv.page_table[slot] = -1
        kv.seq_lens[slot] = 0
        self.slot_req[slot] = None
        self.slot_len[slot] = 0

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.waiting and all(r is None for r in self.slot_req):
                break
        return out
