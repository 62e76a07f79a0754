#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold every kernel
against its plain version.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. the card (``nvidia-smi`` name and power limit); TF32 off;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel); their registers, and the tensor-core
   instructions of ``ssd_scan``'s kernels;
3. ``alloc_txn``/``free_txn`` against the plain allocator math on CPU
   copies of the same words: seeded alloc/free traces over mixed size
   classes on the serving engine's arena geometry sized for 65536 pages,
   lane widths 16 and 4096; ``mem``, ``ctl`` and offsets identical after
   every transaction.  Then ``defrag_txn`` against ``migrate_math``: the
   reference defrag test's churn (allocate until the heap is full, free
   all but every fifth page) strands pages on the engine's arena (256
   pages) and on the 65536-page arena, two waves each; per wave the plan
   on the card equals the plan on the CPU, the kernel's words equal the
   plain version's, and the wave leaves fewer bound chunks and a larger
   largest free extent.  Then the sharded kernels: ``sharded_alloc_txn``/
   ``sharded_free_txn`` against the plain serial replay run on a second
   arena on the card, on the engine's 4-shard arena for 256 pages (hashed
   homes, per-lane hint arrays, every lane homed on shard 0 until lanes
   are served at walk attempts 1-3), then ``sharded_defrag_txn``
   compaction and cross-shard rebalance waves (plans identical); and a
   4096-lane trace and both waves on the 4-shard arena for 65536 pages
   against CPU copies.  Then one admission's and one retirement's lanes
   of full-width mamba2-780m (298,656 pages of 256 B, lane tables in the
   device workspace) on the mamba2 engine's arena, single and 4-shard,
   against the plain math run on a second arena on the card (the
   retirement's revived chunks enqueued in parallel, one enqueue a
   block, by the free kernels' own count), and on the
   single arena the next admission's grant (the freed lanes' chunks in
   the class queue) against the plain math on CPU copies.  No
   piecewise kernel launches in this phase.  Then "phase 3 (piecewise)":
   the piecewise allocator API of all six variants (page and chunk over
   the ring, va and vl families) on the 65536-page geometry, seeded
   alloc/free traces at 16 and 4096 lanes through ``piecewise=True`` on
   the card (``ring_txn_pop``, ``ring_txn_push``, ``chunk_txn_claim``,
   ``ring_window``, ``bitmap_select``) against the plain route on CPU
   copies, word for word after every transaction; ``compact`` once per
   chunk variant; the ``vl_chunk`` traces also through the fused
   ``alloc_txn``/``free_txn`` (the same words outside the telemetry);
   every piecewise counter above 0 (and 0 in every serving run of phase
   5), and the ring pop and push launches by path (one warp, one block,
   a block per class) as their kernels counted them, which must sum to
   the wrappers' counts; then the ring steps and ``ring_window`` (m 4096)
   at the ring page variant's counters and past 2^31, and
   ``bitmap_select`` /
   ``bitmap_select_indices`` on the chunk variant's whole bitmap
   (k 4096), against their plain versions on the card.  Then "phase 3
   (variants)": all six variants through the fused ``alloc_txn``,
   ``free_txn``, ``sharded_alloc_txn``, ``sharded_free_txn``,
   ``defrag_txn`` and ``sharded_defrag_txn``, word for word against the
   plain math on CPU copies after every transaction and wave: seeded
   traces on the 65536-page geometry at 16 and 4096 lanes, an exhausting
   trace on the 256-page geometry, a 4-shard trace with lanes served at
   walk attempts > 0, compaction and rebalance waves of ``chunk`` and
   ``va_chunk``; then the paper's figure sweeps (figs 1-6) on its heap
   (32 MiB, 8 KiB chunks, 16-B pages): per variant sizes 16-8192 B at
   1024 lanes and 32-8192 lanes at 1000 B (chunk kinds 32-2048), 10
   rounds of alloc, ``write_pattern``, ``check_pattern``, free a cell,
   ``check_pattern`` true on every granted lane, each cell's first alloc
   and free held to the plain math, one line a cell with its times
   (CUDA events around each transaction);
4. ``paged_attention`` against its plain version at qwen2-0.5b decode
   shapes (B 8, Hq 14, Hkv 2, D 64, page 16, P 32), ragged lengths and
   holes, page-id and word-offset tables, float32 and bf16 (both sides
   widen the same values to float32: atol 1e-5 for each), its time a
   call on CUDA events (the wrapper's host work inside) and its three
   kernels' profiler device time; then with ``window`` and ``ring`` at
   mixtral-8x7b's decode shapes (B 8, Hq 32, Hkv 8, D 128, window 4096,
   lengths 1-8,192 on both sides of it): a 512-slot table and a 258-slot
   ring (window // 16 + 2), holes, both table modes and dtypes, atol
   1e-5, each case's device time, CUDA-event time, plain time and bound
   (the attended pages' bytes); then int8 pages with their float32
   scales (``paged_attention int8`` lines): unit inputs at qwen2's
   shapes (q float32 on page ids, q bf16 on word offsets), qwen1.5-32b's
   decode shapes (B 8, Hq 40, Hkv 40, D 128, lengths 1-1,024, a 64-slot
   table; q bf16 and float32, and its bf16 pages beside them),
   mixtral-8x7b's 512-slot window and 258-slot ring in int8, atol 1e-5,
   each with the same four times and its bound (K and V bytes plus
   scales); ``ssd_scan``
   against ``ssd_plain`` at mamba2-780m's heads (H 48, P 64, N 128, G 1,
   chunk 64) at 1, 4 and 7 chunks, bf16 and float32 (atol 1e-4 + rtol
   1e-4), and at 1-7 chunks its three kernels' profiler device time a
   call and its time a call on CUDA events;
5. serve full-width qwen2-0.5b (random weights from ``--seed``) in bf16:
   16 requests, prompts 16-448 tokens, 32 new tokens each, max_batch 8,
   max_seq 512.  The launch counters are zeroed just before and read just
   after; every transaction's lanes are recorded and replayed through the
   plain math on the CPU, which must end on the engine's arena words.
   Then the allocation-failure path: the same requests on an engine whose
   heap is too small for them (96 pages; a co-tenant binds chunks to the
   2048-B class and frees them; ``defrag_threshold`` 0.5).  Allocation
   failures, defrag waves (on failure and past the threshold), migrated
   pages and evictions must all occur, ``defrag_txn`` launches must equal
   the engine's waves, every uid's tokens must equal the unpressured
   run's, and the recorded alloc/free/defrag log replayed through the
   plain math on the CPU must end on the engine's words.  Then
   qwen2-0.5b with int8 KV pages ("phase 5: qwen2-0.5b int8" lines):
   unpressured, then under the same 96-page pressure, whose defrag waves
   must move pages the slots hold (their scales with them) and whose
   tokens must equal the unpressured int8 run's.  A small float32
   model is served on the card and on the CPU, unpressured and under the
   same pressure, and must give the same tokens (and stats and words).
   Then the same requests through ``ServingEngine(num_shards=4)``: with
   the reference sizing and ``rebalance_threshold`` 8 (rebalance waves
   must fire), and under pressure (16 pages, the co-tenant, a second
   co-tenant holding 128 pages, ``defrag_threshold`` 0.5: overflows to
   neighbour shards, lanes served at walk attempts > 0, failed grants,
   sharded defrag waves and evictions must all occur).  Each run's
   tokens must equal the unpressured run's, its launches the engine's
   counts (no single-arena allocator kernel launches), its shards must
   drain, and its log replayed through the plain math on the CPU must
   end on the engine's words.  Last, full-width mamba2-780m (random
   weights from ``--seed``, bf16) serves phase 5's request lengths, 32
   new tokens each, max_batch 8: one ``alloc_txn`` of 298,656 lanes per
   admission, one ``free_txn`` per retirement, one ``ssd_scan`` per
   prefill layer and no other launch; the timed run carries no check,
   and its grants, logged without a copy or a sync, are checked after
   it: every grant page-aligned, inside the heap and disjoint from every
   live page; ``allocs == frees`` and every slot's and shard's pages back
   to 0.  The same traffic on a second fresh engine (the checked run)
   must give the same tokens, and its first admission's grant and first
   retirement are replayed through the plain math on card copies of the
   words they started from, and every ``ssd_scan`` call of the checked
   run (every layer of every admission) is held to ``ssd_plain`` on the
   same tensors.  Each run prints what the alloc kernels'
   chunk chains took, as the kernels count it (``chain_stats``), and
   how the free kernels' enqueues wrote (``enqueue_stats``: the mamba2
   run's retirements must all be parallel);
6. kernel times from ``torch.profiler`` (allocator and defrag kernels
   replayed at the engine's recorded inputs; ``paged_attention`` also
   held to its plain version at the qwen2 run's own inputs, every 8th
   call of a rerun of its traffic; defrag also at the
   65536-page arena with M = 128; the sharded kernels at the sharded
   pressure run's inputs and on the 4-shard 65536-page arena; the five
   piecewise kernels at phase 3 (piecewise)'s inputs, and the ring pop
   and push also at one lane of a class ring and of the pool, 16 lanes,
   init's pool pop and init's widest push (``ring_widths``), each held
   to its plain version and timed on the path its kernels counted; the
   six widened kernels per variant at the figure cell of 1024 x 256 B;
   the mamba2
   rerun's ``ssd_scan`` and ``free_txn`` device time, each a sum over
   its kernels);
7. the fused decode mega-step (``ServingEngine(mega_step=True)``):
   ``launches_per_tick`` of full-width qwen2-0.5b (single arena and 4
   shards: one grow plus one ``paged_attention`` a layer, 25) and
   mamba2-780m (0) at max_batch 2 and 8, the allocator's part as its
   kernels counted it; then phase 5's traffic through the mega-step in
   four runs (qwen2-0.5b; under phase 5's pressure; 4 shards under the
   sharded pressure; mamba2-780m), each with phase 5's host-loop
   tokens, ``allocs == frees``, no page held after draining, failed
   ticks, defrag waves and evictions in the pressured runs, and its
   launches equal to the engine's counts; then profiled reruns of the
   qwen2 and mamba2 runs with every step's synchronizing calls counted
   (one, the flags' read, a steady tick), their device idle share beside
   the host loop's (phases 5-6), and tok/s of both loops.  Last, alone
   on the card, the moe slice: full-width mixtral-8x7b cut to 16 of its
   32 layers (47.0 GB of bf16 weights; 32 do not fit one 80-GB card)
   serves phase 5's 16 prompts plus one of 4,160 tokens (past the
   4096-token window), 32 new each, max_batch 8: through the host loop
   ("phase 5: mixtral-8x7b" lines: each admission's aux grant of 3,584
   pages, ``allocs == frees``, no page held, the launches equal to the
   engine's counts, then a rerun holding every ``paged_attention`` call
   of some ticks, one of them where the long request's window masks,
   to the plain version at atol 1e-5, and a profiled rerun: device busy
   and idle share), then through the mega-step ("phase 7:
   mixtral-8x7b" lines: ``launches_per_tick`` 17, the host loop's
   tokens, one synchronizing call a steady tick, counted in the timed
   run).  Then, alone on the card after mixtral's weights are freed, the
   int8 slice: qwen1.5-32b at the reference's widths and full depth (64
   layers, 70.4 GB of bf16 weights), int8 KV pages with float32 scales,
   max_batch 8, max_seq 1,024, phase 5's 16 prompts, 32 new each:
   through the host loop ("phase 5: qwen1.5-32b" lines: device memory
   after the weights and after the heaps, ``allocs == frees``, no page
   held, the launches equal to the engine's counts, a rerun holding
   every ``paged_attention`` call of some ticks to the plain version at
   the run's own inputs, a profiled rerun: device busy and idle share),
   then through the mega-step ("phase 7: qwen1.5-32b" lines:
   ``launches_per_tick`` 65, the host loop's tokens, one synchronizing
   call a steady tick).  Each phase
   prints its seconds.  Then one JSON line of per-kernel numbers (each
   kernel's launches in the mega-step runs too), then the card line,
   then the result line ``{"ok": true, "device": {...}}`` last.

Any failure raises: the script exits non-zero and prints no result line.
It exits non-zero at once when no CUDA device is present or when the
package sources are not beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate


def log(*a):
    print(*a, flush=True)


def sass_count(build, name: str, opcode: str):
    """{kernel: instructions of ``opcode``} in a kernel source's last
    build (``cuobjdump -sass``), or "not measured" without the tool."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not measured"
    text = subprocess.run([tool, "-sass", str(build._target(name))],
                          capture_output=True, text=True,
                          timeout=300).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn and re.search(r"\b" + opcode + r"\b", ln):
            out[fn] += 1
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


KERNEL_SYMBOLS = {"alloc_txn": "alloc_txn_kernel",
                  "free_txn": "free_txn_kernel",
                  "defrag_txn": "defrag_txn_kernel",
                  "sharded_alloc_txn": "sharded_alloc_txn_kernel",
                  "sharded_alloc_count": "sharded_alloc_count_kernel",
                  "sharded_alloc_place": "sharded_alloc_place_kernel",
                  "sharded_alloc_attempt": "sharded_alloc_attempt_kernel",
                  "sharded_free_txn": "sharded_free_txn_kernel",
                  "free_lanes": "free_lanes_kernel",
                  "sharded_defrag_txn": "sharded_defrag_txn_kernel",
                  "defrag_extract": "defrag_extract_kernel",
                  "paged_attention": "paged_attention_kernel",
                  "paged_attention_values": "paged_attention_values_kernel",
                  "paged_attention_merge": "paged_attention_merge_kernel",
                  "ssd_chunk": "ssd_chunk_kernel",
                  "ssd_pass": "ssd_pass_kernel",
                  "ssd_scan": "ssd_scan_kernel",
                  **{k: f"{k}_kernel" for k in (
                      "ring_txn_pop_warp", "ring_txn_pop_block",
                      "ring_txn_pop_class", "ring_txn_push_warp",
                      "ring_txn_push_block", "ring_txn_push_class")},
                  "chunk_txn_claim": "chunk_txn_claim_kernel",
                  "ring_window": "ring_window_kernel",
                  "bitmap_select": "bitmap_select_kernel"}


# the kernels of each kind of allocator call, and the names its wrappers
# count a call under (``ops.LAUNCHES``)
FAMILY = {"alloc": ("alloc_txn", "sharded_alloc_txn", "sharded_alloc_count",
                    "sharded_alloc_place", "sharded_alloc_attempt"),
          "free": ("free_txn", "sharded_free_txn", "free_lanes"),
          "defrag": ("defrag_txn", "sharded_defrag_txn", "defrag_extract")}
CALLS = {"alloc": ("alloc_txn", "sharded_alloc_txn"),
         "free": ("free_txn", "sharded_free_txn"),
         "defrag": ("defrag_txn", "sharded_defrag_txn")}


def kernel_launches() -> dict:
    """Every allocator and wave kernel's launches so far, counted on the
    card by the launches themselves ({KERNEL_SYMBOLS key: launches})."""
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.kernels import defrag_txn as DT
    return {**AT.launch_stats(), **DT.launch_stats()}


def per_call(prof, kind: str):
    """One kind of allocator call ("alloc", "free" or "defrag") in a
    ``profiled`` session of ``DeviceProfile(counted=True)``: (mean
    device ms a call: each kernel of the kind's family, its mean a
    launch times the launches the card counted, summed over the kernels
    and divided by the calls the wrappers counted (a dropped record does
    not shrink the total); launches recorded; launches counted; calls;
    each kernel's part as ``parts_text`` gives it; {kernel: launches a
    call})."""
    made = {k: prof.made[k] for k in FAMILY[kind] if prof.made.get(k)}
    calls = sum(prof.calls[c] for c in CALLS[kind])
    if not calls or not made:
        raise AssertionError(f"no {kind} call in the session: calls "
                             f"{prof.calls}, launches {prof.made}")
    got = prof.got
    ms = sum(got[k][0] * m for k, m in made.items()) / calls
    return (ms, sum(got[k][1] for k in made), sum(made.values()), calls,
            parts_text(got, made, calls),
            {k: m // calls if m % calls == 0 else m / calls
             for k, m in made.items()})


def parts_text(got, made, calls) -> str:
    """Each kernel of a call: its mean ms a launch, launches a call, and
    the launches the profiler recorded of those made."""
    return ", ".join(f"{k} {got[k][0]:.5f} ms x {m / calls:g} ({got[k][1]} "
                     f"of {m} recorded)" for k, m in made.items() if m)


def device_rows(prof, device=None):
    """[(name, device us, launches)] of a finished ``torch.profiler``
    session, largest first: every device activity (kernel, copy, set)
    summed by name from the profiler's raw records.  The same sums as
    ``key_averages()``'s device self time, without building its event
    tree, which takes about 0.1 ms a record (a minute for a serving
    rerun's 300,000)."""
    import torch
    device = device or torch.autograd.DeviceType.CUDA
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != device
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        us = (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
              else float(e.duration_us()))
        tot = acc.setdefault(e.name(), [0.0, 0])
        tot[0] += us
        tot[1] += 1
    return sorted(((k, us, n) for k, (us, n) in acc.items() if us > 0),
                  key=lambda r: -r[1])


class DeviceProfile:
    """``torch.profiler`` over a block of work: device time and launch
    count of each kernel whose symbol contains a given name.  With
    ``counted``, also the launches of each allocator and wave kernel in
    the block as the card counted them (``made``, from
    ``kernel_launches``) and the calls the wrappers counted (``calls``,
    from ``ops.LAUNCHES``)."""

    def __init__(self, counted: bool = False):
        self.counted = counted

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        if self.counted:
            from repro_torch.kernels import ops
            self._made0 = kernel_launches()
            self._calls0 = dict(ops.LAUNCHES)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if self.counted:
            from repro_torch.kernels import ops
            self.made = {k: m - self._made0[k]
                         for k, m in kernel_launches().items()}
            self.calls = {k: m - self._calls0[k]
                          for k, m in ops.LAUNCHES.items()}
        self.rows = device_rows(self._prof)
        return False

    def kernel(self, name: str):
        """(mean ms per launch, launches) of the named kernel (the whole
        symbol name: ``alloc_txn_kernel`` does not match
        ``sharded_alloc_txn_kernel``)."""
        pat = re.compile(r"(?:^|[^\w])" + re.escape(name) + r"\s*[(<]")
        rows = [r for r in self.rows if r[0] == name or pat.search(r[0])]
        us = sum(r[1] for r in rows)
        n = sum(r[2] for r in rows)
        return (us / n / 1e3 if n else None), n

    def busy_ms(self) -> float:
        return sum(r[1] for r in self.rows) / 1e3


def chains(reset: bool = True) -> dict:
    """The alloc kernels' own count of what their chunk chains took since
    the last reset (``kernels.alloc_txn.chain_stats``), then reset."""
    from repro_torch.kernels import alloc_txn as AT
    return AT.chain_stats(reset=reset)


def enqueues(reset: bool = True) -> dict:
    """The free kernels' own count of how their bulk enqueues wrote
    (``kernels.alloc_txn.enqueue_stats``) since the last reset, then
    reset."""
    from repro_torch.kernels import alloc_txn as AT
    return AT.enqueue_stats(reset=reset)


def rebuilds(reset: bool = True) -> dict:
    """The wave kernels' own count of how their queue rebuilds wrote
    (``kernels.defrag_txn.rebuild_stats``) since the last reset, then
    reset."""
    from repro_torch.kernels import defrag_txn as DT
    return DT.rebuild_stats(reset=reset)


def rebuild_text(r: dict) -> str:
    return (f"{r['parallel_rebuilds']} rebuild(s) whose queue values the "
            f"block wrote in parallel ({r['parallel_values']} values), "
            f"{r['serial_rebuilds']} in order on a dry pool "
            f"({r['serial_values']} values)")


def shard_steps(reset: bool = True) -> dict:
    """The sharded alloc kernels' own count of their transactions and
    steps (``kernels.alloc_txn.shard_stats``) since the last reset, then
    reset."""
    from repro_torch.kernels import alloc_txn as AT
    return AT.shard_stats(reset=reset)


def shard_text(c: dict) -> str:
    return (f"{c['transactions']} transaction(s) ran {c['steps']} "
            f"(attempt, shard) step(s) over {c['step_lanes']} lanes"
            + (f", {c['rescans']} on per-step lists" if c["rescans"]
               else ""))


def enqueue_text(e: dict) -> str:
    return (f"{e['parallel_enqueues']} enqueue(s) written in parallel "
            f"({e['parallel_values']} values), {e['serial_enqueues']} in "
            f"lane order ({e['serial_values']} values)")


def chain_text(c: dict) -> str:
    return (f"{c['whole_runs']} whole-chunk run(s) of {c['whole_chunks']} "
            f"chunks, {c['dequeue_tries']} dequeue run(s) tried taking "
            f"{c['dequeue_chunks']} chunks ({c['dequeue_short']} under 16, "
            f"{c['dequeue_empty']} none), {c['serial_steps']} serial "
            f"step(s) in {c['chains']} class chain(s)"
            + (f", {c['serial_classes']} left serial by an id outside the "
               f"heap" if c["serial_classes"] else ""))


# ---------------------------------------------------------------------------
# phase 3: allocator transactions, kernel vs plain math
# ---------------------------------------------------------------------------

SIZE_MENU = [256, 512, 1024, 2048, 4096, 8192, 100]  # 8192 > chunk: fails
SIZE_P = [0.6, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05]


def alloc_trace(rng, n_ops: int, lanes: int):
    """A seeded op list: ('alloc', sizes, mask) or ('free', k) where the
    free picks k live grants (resolved at replay time)."""
    ops_ = []
    for i in range(n_ops):
        if i % 3 == 2:
            ops_.append(("free", int(rng.integers(1, lanes + 1))))
        else:
            ops_.append(("alloc",
                         rng.choice(SIZE_MENU, lanes, p=SIZE_P).astype(
                             "int32"),
                         rng.random(lanes) < 0.9))
    return ops_


def word_err(got, want):
    """(differing words, max absolute difference) of two int32 tensors."""
    diff = (got.cpu().long() - want.cpu().long()).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def merge_err(acc, *errs):
    """Add the differing-word counts into ``acc`` and keep the largest
    absolute difference."""
    for n, mx in errs:
        acc["words"] += n
        acc["max_abs"] = max(acc["max_abs"], mx)


def phase_alloc(device, n_pages=65536, traces=((16, 36), (4096, 9)),
                seed=0):
    """Returns (the recorded transactions per lane width, the measured
    kernel-vs-plain word errors per transaction kind)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import make_kv_allocator

    dev_ouro, _, _ = make_kv_allocator(n_pages, device=device)
    cpu_ouro, _, _ = make_kv_allocator(n_pages, device="cpu")
    lay = cpu_ouro.layout
    log(f"phase 3: arena {lay.mem_words} mem words, {lay.ctl_words} ctl "
        f"words, {cpu_ouro.cfg.num_chunks} chunks, "
        f"{cpu_ouro.cfg.num_classes} classes")
    rng = np.random.default_rng(seed)
    logs = {}
    errs = {k: {"words": 0, "max_abs": 0} for k in ("alloc", "free")}
    n_txn = 0
    for lanes, n_ops in traces:
        sd, sc = dev_ouro.init(), cpu_ouro.init()
        live = []
        log_ = logs[lanes] = []
        for op in alloc_trace(rng, n_ops, lanes):
            if op[0] == "alloc":
                sizes = torch.from_numpy(op[1])
                mask = torch.from_numpy(op[2])
                sc, offs_c = cpu_ouro.alloc(sc, sizes, mask)
                sd, offs_d = dev_ouro.alloc(sd, sizes.to(device),
                                            mask.to(device))
                do, _ = e_off = word_err(offs_d, offs_c)
                if do:
                    raise AssertionError(f"alloc offsets differ ({lanes} "
                                         f"lanes, txn {n_txn})")
                live += [(int(o), int(s)) for o, s in
                         zip(offs_c.tolist(), op[1].tolist()) if o >= 0]
                log_.append(("alloc", sizes, mask, offs_c))
                kind = "alloc"
            else:
                k = min(op[1], len(live))
                pick = rng.choice(len(live), k, replace=False)
                sel = set(pick.tolist())
                drop = [live[i] for i in pick]
                live = [x for i, x in enumerate(live) if i not in sel]
                fo = np.full(lanes, -1, np.int32)
                fs = np.zeros(lanes, np.int32)
                fo[:k] = [o for o, _ in drop]
                fs[:k] = [s for _, s in drop]
                perm = rng.permutation(lanes)
                fo_t = torch.from_numpy(fo[perm])
                fs_t = torch.from_numpy(fs[perm])
                sc = cpu_ouro.free(sc, fo_t, fs_t, fo_t >= 0)
                fo_d = fo_t.to(device)
                sd = dev_ouro.free(sd, fo_d, fs_t.to(device), fo_d >= 0)
                log_.append(("free", fo_t, fs_t, fo_t >= 0))
                kind = "free"
                e_off = (0, 0)
            dm, _ = e_mem = word_err(sd.mem, sc.mem)
            dc, _ = e_ctl = word_err(sd.ctl, sc.ctl)
            merge_err(errs[kind], e_off, e_mem, e_ctl)
            if dm or dc:
                raise AssertionError(f"{kind} txn {n_txn} ({lanes} lanes): "
                                     f"{dm} mem / {dc} ctl words differ")
            n_txn += 1
        fails = sc.ctl[lay.off_t_fail:lay.off_t_fail + lay.num_classes]
        log(f"phase 3: lanes {lanes}: {n_ops} transactions, 0 differing "
            f"words; failed lanes per class {fails.tolist()}")
    return logs, errs


def churn(ouro, st, rng, lanes, page, until_full, rounds=14, keep_every=5):
    """The reference defrag test's churn (``tests/test_defrag.py``):
    allocate ``lanes`` pages a transaction (until two transactions in a
    row grant nothing, or for ``rounds``), then free all but every
    ``keep_every``-th grant in shuffled batches.  Returns the arena."""
    import numpy as np
    import torch
    dev = st.mem.device
    sizes = torch.full((lanes,), page, dtype=torch.int32, device=dev)
    live, fails = [], 0
    for step in range(1000):
        if (fails >= 2) if until_full else (step >= rounds):
            break
        mask = torch.from_numpy(rng.random(lanes) < 0.95).to(dev)
        st, offs = ouro.alloc(st, sizes, mask)
        got = [o for o in offs.tolist() if o >= 0]
        fails = fails + 1 if not got else 0
        live += got
    drop = [o for i, o in enumerate(live) if i % keep_every]
    rng.shuffle(drop)
    for i in range(0, len(drop), lanes):
        fo = np.full(lanes, -1, np.int32)
        fo[:len(drop[i:i + lanes])] = drop[i:i + lanes]
        fo_t = torch.from_numpy(fo).to(dev)
        st = ouro.free(st, fo_t, sizes, fo_t >= 0)
    return st


def bound_chunks(lay, mem) -> int:
    r = lay.region("chunk_class")
    return int((mem[r.offset:r.end] >= 0).sum())


def defrag_bound_ms(lay, before_mem, after_mem, src, sizes) -> float:
    """Least time of one wave (bytes) at the device memory rate.  Reads:
    the lanes, the ctl block, every chunk's free count and binding (the
    rebuild depends on all of them), each moved extent's source words and
    the bitmap words whose bits it flips.  Writes: every arena word the
    wave changed, once, and the core ctl words.  ``lay`` is one arena's
    layout; the words may be a sharded arena's (S, mem_words), whose S
    arenas are each rebuilt."""
    changed = (after_mem != before_mem).reshape(-1, lay.mem_words)
    S = changed.shape[0]
    moved = int((sizes[src >= 0] // 4).sum())
    bm = lay.region("bitmap")
    flipped = int(changed[:, bm.offset:bm.end].sum())
    reads = (3 * src.shape[0] + S * lay.ctl_words
             + 2 * S * lay.cfg.num_chunks + moved + flipped)
    writes = int(changed.sum()) + S * lay.core_ctl_words
    return 4 * (reads + writes) / HBM_BYTES_PER_S * 1e3


def phase_defrag(device, seed=0):
    """``defrag_txn`` against ``migrate_math`` on churned arenas.  Returns
    (the pre-wave states on the card with their plans and bounds, per
    arena; the measured word errors)."""
    import numpy as np
    import torch
    from repro_torch.core import arena, defrag
    from repro_torch.kernels import defrag_txn
    from repro_torch.paged.kv_cache import make_kv_allocator

    err = {"words": 0, "max_abs": 0}
    waves = {}
    for n_pages, lanes in ((256, 16), (65536, 4096)):
        ouro, _, _ = make_kv_allocator(n_pages, device=device)
        cfg, lay = ouro.cfg, ouro.layout
        rng = np.random.default_rng(seed + n_pages)
        st = ouro.init()
        waves[n_pages] = []
        for wave in range(2):
            st = churn(ouro, st, rng, lanes, 256, until_full=(wave == 0))
            mem_c, ctl_c = st.mem.cpu(), st.ctl.cpu()
            before = arena.Arena(mem_c.clone(), ctl_c.clone())
            pre = (st.mem.clone(), st.ctl.clone())
            M = ouro._moves(None)
            plan_d = defrag.plan_math(cfg, "chunk", "vl", st.mem, st.ctl,
                                      max_moves=M)
            plan_c = defrag.plan_math(cfg, "chunk", "vl", mem_c, ctl_c,
                                      max_moves=M)
            for a, b in zip(plan_d, plan_c):
                n_bad, _ = word_err(a, b)
                if n_bad:
                    raise AssertionError(f"defrag plan on the card differs "
                                         f"from the CPU's ({n_pages} pages, "
                                         f"wave {wave})")
            defrag_txn.arena_defrag_txn(cfg, "chunk", "vl", st.mem, st.ctl,
                                        *plan_d)
            defrag.migrate_math(cfg, "chunk", "vl", mem_c, ctl_c, *plan_c)
            torch.cuda.synchronize()
            dm, _ = e_mem = word_err(st.mem, mem_c)
            dc, _ = e_ctl = word_err(st.ctl, ctl_c)
            merge_err(err, e_mem, e_ctl)
            if dm or dc:
                raise AssertionError(f"defrag_txn ({n_pages} pages, wave "
                                     f"{wave}): {dm} mem / {dc} ctl words "
                                     f"differ from migrate_math")
            fs0 = ouro.frag_stats(before)
            fs1 = ouro.frag_stats(arena.Arena(mem_c, ctl_c))
            b0, b1 = bound_chunks(lay, before.mem), bound_chunks(lay, mem_c)
            moves = int((plan_c[0] >= 0).sum())
            log(f"phase 3: defrag_txn, {n_pages} pages ({cfg.num_chunks} "
                f"chunks), wave {wave}: {moves} moves of M {M}, 0 differing "
                f"words, plan identical; bound chunks {b0} -> {b1}, largest "
                f"free extent {fs0['largest_free_extent']} -> "
                f"{fs1['largest_free_extent']} words, frag ratio "
                f"{fs0['frag_ratio']:.3f} -> {fs1['frag_ratio']:.3f}")
            if not (b1 < b0 and fs1["largest_free_extent"]
                    > fs0["largest_free_extent"]):
                raise AssertionError("the wave reclaimed nothing")
            waves[n_pages].append(dict(
                pre=pre, plan=plan_d,
                bound=defrag_bound_ms(lay, before.mem, mem_c, plan_c[0],
                                      plan_c[2])))
    return waves, err


# ---------------------------------------------------------------------------
# phase 3 (piecewise): the piecewise allocator of all six variants
# ---------------------------------------------------------------------------

PIECEWISE = ("ring_txn_pop", "ring_txn_push", "chunk_txn_claim",
             "ring_window", "bitmap_select")
PIECEWISE_VARIANTS = tuple((k, f) for k in ("page", "chunk")
                           for f in ("ring", "va", "vl"))
PIECEWISE_TRACES = ((16, 12), (4096, 3))
WRAP = 2 ** 31


def no_piecewise(launches, where):
    """Raise if any piecewise step launched in ``where``."""
    hit = {k: launches[k] for k in PIECEWISE if launches[k]}
    if hit:
        raise AssertionError(f"{where} launched piecewise steps: {hit}")


def piecewise_arena(cfg, kind, family, device, piecewise):
    """A fresh arena of one variant and its views, initialised by the
    piecewise API (``piecewise`` picks its route)."""
    from repro_torch.core import arena, chunk_alloc, page_alloc
    lay = arena.layout(cfg, kind, family)
    st = arena.blank(lay, device)
    views = page_alloc.AllocState(*arena.unpack(lay, st))
    mod = page_alloc if kind == "page" else chunk_alloc
    mod.init(cfg, family, views, piecewise=piecewise)
    return st, views


def phase_piecewise(device, seed=0):
    """The piecewise allocator API (``core/page_alloc``,
    ``core/chunk_alloc``) of all six variants on the serving engine's
    arena geometry for 65536 pages: seeded alloc/free traces at lane
    widths 16 and 4096 through the piecewise route on the card, held
    word for word after every transaction to the plain route on CPU
    copies (``mem``, ``ctl`` and offsets); ``compact`` once on each chunk
    variant; the ``vl_chunk`` traces also through the fused
    ``alloc_txn``/``free_txn``, on the same words outside the telemetry.
    Then ``ring_window`` and ``bitmap_select``/``bitmap_select_indices``,
    and the ring steps at counters past 2^31, against their plain
    versions on the card's tensors.  Returns (the launches of the traces,
    the inputs phase 6 times the five kernels at, the measured errors per
    kernel)."""
    import numpy as np
    import torch
    from repro_torch.core import arena, chunk_alloc, groups, page_alloc
    from repro_torch.core.heap import size_to_class_device
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.kernels import ops, ref
    from repro_torch.paged.kv_cache import make_kv_allocator

    fused, _, _ = make_kv_allocator(65536, device=device)
    cfg = fused.cfg
    rng = np.random.default_rng(seed + 15)
    errs = {k: {"words": 0, "max_abs": 0} for k in PIECEWISE}
    trace_err = {"words": 0, "max_abs": 0}
    inputs = {}
    ops.reset_launches()
    AT.ring_launch_stats(reset=True)
    t_all = time.perf_counter()
    for kind, family in PIECEWISE_VARIANTS:
        mod = page_alloc if kind == "page" else chunk_alloc
        name = f"{family}_{kind}"
        for lanes, n_ops in PIECEWISE_TRACES:
            t0 = time.perf_counter()
            sd, vd = piecewise_arena(cfg, kind, family, device, True)
            sc, vc = piecewise_arena(cfg, kind, family, "cpu", False)
            sf = fused.init() if name == "vl_chunk" else None

            def check(what):
                em, ec = word_err(sd.mem, sc.mem), word_err(sd.ctl, sc.ctl)
                merge_err(trace_err, em, ec)
                if em[0] or ec[0]:
                    raise AssertionError(f"piecewise {name}, {lanes} lanes, "
                                         f"{what}: {em[0]} mem / {ec[0]} ctl "
                                         f"words differ")
                if sf is not None:
                    core = arena.layout(cfg, kind, family).core_ctl_words
                    fm = word_err(sd.mem, sf.mem)[0]
                    fc = word_err(sd.ctl[:core], sf.ctl[:core])[0]
                    if fm or fc:
                        raise AssertionError(
                            f"piecewise vl_chunk, {lanes} lanes, {what}: "
                            f"{fm} mem / {fc} core ctl words differ from "
                            f"the fused kernels'")

            check("init")
            live = []
            for i, op in enumerate(alloc_trace(rng, n_ops, lanes)):
                if op[0] == "alloc":
                    sizes, mask = torch.from_numpy(op[1]), \
                        torch.from_numpy(op[2])
                    _, oc = mod.alloc(cfg, family, vc, sizes, mask)
                    _, od = mod.alloc(cfg, family, vd, sizes.to(device),
                                      mask.to(device), piecewise=True)
                    e = word_err(od, oc)
                    merge_err(trace_err, e)
                    if e[0]:
                        raise AssertionError(f"piecewise {name}, {lanes} "
                                             f"lanes, alloc {i}: offsets "
                                             f"differ")
                    if sf is not None:
                        sf, _ = fused.alloc(sf, sizes.to(device),
                                            mask.to(device))
                    live += [(int(o), int(s)) for o, s in
                             zip(oc.tolist(), op[1].tolist()) if o >= 0]
                    if lanes == 4096 and name == "ring_page" \
                            and "pop" not in inputs:
                        inputs["pop"] = (sizes.to(device), mask.to(device))
                else:
                    k = min(op[1], len(live))
                    pick = rng.choice(len(live), k, replace=False)
                    sel = set(pick.tolist())
                    drop = [live[j] for j in pick]
                    live = [x for j, x in enumerate(live) if j not in sel]
                    fo = np.full(lanes, -1, np.int32)
                    fs = np.zeros(lanes, np.int32)
                    fo[:k] = [o for o, _ in drop]
                    fs[:k] = [s for _, s in drop]
                    perm = rng.permutation(lanes)
                    fo_t, fs_t = torch.from_numpy(fo[perm]), \
                        torch.from_numpy(fs[perm])
                    mod.free(cfg, family, vc, fo_t, fs_t, fo_t >= 0)
                    fo_d, fs_d = fo_t.to(device), fs_t.to(device)
                    mod.free(cfg, family, vd, fo_d, fs_d, fo_d >= 0,
                             piecewise=True)
                    if sf is not None:
                        sf = fused.free(sf, fo_d, fs_d, fo_d >= 0)
                    if lanes == 4096 and name == "ring_page" \
                            and "push" not in inputs:
                        inputs["push"] = (fo_d, fs_d)
                check(f"{op[0]} {i}")
            tail = ""
            if kind == "chunk" and lanes == 16:
                chunk_alloc.compact(cfg, family, vc)
                chunk_alloc.compact(cfg, family, vd, piecewise=True)
                sf = None
                check("compact")
                tail = ", compact"
            if lanes == 4096 and name in ("ring_page", "vl_chunk"):
                inputs[name] = (sd, vd)
            log(f"phase 3 (piecewise): {name}, lanes {lanes}: {n_ops} "
                f"transactions{tail}, 0 differing words"
                + ("; the fused alloc_txn/free_txn on the same words "
                   "outside the telemetry" if name == "vl_chunk" else "")
                + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"phase 3 (piecewise): launches of the traces "
        f"{json.dumps({k: launches[k] for k in PIECEWISE})} "
        f"({time.perf_counter() - t_all:.1f} s)")
    if min(launches[k] for k in PIECEWISE) == 0:
        raise AssertionError(f"a piecewise kernel never launched: "
                             f"{launches}")
    paths = AT.ring_launch_stats()
    log(f"phase 3 (piecewise): the traces' ring launches by path, as the "
        f"kernels counted them {json.dumps(paths)}")
    for k in ("ring_txn_pop", "ring_txn_push"):
        if sum(m for p, m in paths.items() if p.startswith(k)) \
                != launches[k]:
            raise AssertionError(f"{k}: the kernels counted {paths}, the "
                                 f"wrapper {launches[k]} launches")
    for k in PIECEWISE:
        merge_err(errs[k], (trace_err["words"], trace_err["max_abs"]))

    # the steps at phase 6's inputs and at counters past 2^31, against
    # their plain versions on the same tensors of the card
    def hold(k, got, want):
        for g, w in zip(got, want):
            e = word_err(g, w)
            merge_err(errs[k], e)
            if e[0]:
                raise AssertionError(f"{k}: {e[0]} words differ from the "
                                     f"plain version")

    q = inputs["ring_page"][1].q
    sizes, mask = inputs["pop"]
    cls = size_to_class_device(cfg, sizes)
    valid = mask & (cls < cfg.num_classes)
    # the grant windows: each class's granted count of the first alloc
    counts = torch.minimum(groups.segment_counts(cls, valid,
                                                 cfg.num_classes),
                           q.back - q.front)
    fo, fs = inputs["push"]
    fcls = size_to_class_device(cfg, fs)
    fvalid = (fo >= 0) & (fcls < cfg.num_classes)
    # the same inventories with every counter moved past 2^31 (int32
    # wrap): the largest back lands 5 past it
    shift = WRAP - int(q.back.max()) + 5
    past = [(x.long() + shift + WRAP) % 2 ** 32 - WRAP for x in (q.front,
                                                                q.back)]
    fronts = ((q.front, q.back), tuple(x.to(torch.int32) for x in past))
    for f, b in fronts:
        for limit in (True, False):
            hold("ring_txn_pop",
                 ops.ring_txn_pop(q.store, f, b, cls, valid, limit=limit),
                 ref.ring_txn_pop_ref(q.store, f, b, cls, valid, limit))
        store = q.store.clone()
        hold("ring_txn_push",
             ops.ring_txn_push(store, b, fcls, fo, fvalid),
             ref.ring_txn_push_ref(q.store.clone(), b, fcls, fo, fvalid))
        hold("ring_window",
             (ops.ring_window(q.store, f, counts, m=4096),),
             (ref.ring_window_ref(q.store, f, counts, 4096),))
    views = inputs["vl_chunk"][1]
    bitmap = views.meta.bitmap.reshape(-1)
    W = -(-bitmap.shape[0] // 32) * 32
    words = torch.zeros(W, dtype=torch.int32, device=device)
    words[:bitmap.shape[0]] = bitmap
    for k in (0, 4096, 10 ** 9):
        hold("bitmap_select", (ops.bitmap_select(words, k),),
             (ref.bitmap_select_ref(words, k),))
        got = ops.bitmap_select_indices(words, k, max_k=4096)
        want = ops.bitmap_select_indices(words.cpu(), k, max_k=4096)
        hold("bitmap_select", got, want)
    row = views.meta.bitmap[int(torch.argmax(
        (views.meta.free_count > 0).to(torch.int32)))]
    ppc = cfg.pages_per_chunk(0)
    for take in (0, 3, ppc, 10 ** 6):
        hold("chunk_txn_claim", ops.chunk_txn_claim(row, take, ppc=ppc),
             ref.chunk_txn_claim_ref(row, take, ppc))
    log(f"phase 3 (piecewise): ring_txn_pop, ring_txn_push and ring_window "
        f"(m 4096) on ring_page's class rings, at its counters and past "
        f"2^31; bitmap_select and bitmap_select_indices on vl_chunk's whole "
        f"bitmap ({bitmap.shape[0]} words padded to {W}), k 0, 4096, 1e9; "
        f"chunk_txn_claim takes 0-1e6: 0 differing words")
    timing = dict(store=q.store, front=q.front, back=q.back, cls=cls,
                  valid=valid, counts=counts, fo=fo, fcls=fcls,
                  fvalid=fvalid, words=words, row=row, ppc=ppc,
                  pool=views.ctx.pool,
                  init_lanes=cfg.data_chunks_per_class
                  * cfg.pages_per_chunk(0), page_words=cfg.page_words(0),
                  share=cfg.data_chunks_per_class)
    return launches, paths, timing, errs


def ring_bytes(kind, n, C, moved):
    """The bytes a ring pop or push of ``n`` lanes over ``C`` classes
    must move (each input word it needs read once, each output written
    once): the lanes' classes and flags, the counters, then for a pop
    the ``moved`` granted slots read, the values and new fronts written,
    for a push the ``moved`` members' values read and slots written and
    the new backs."""
    if kind == "ring_txn_pop":
        return 5 * n + 8 * C + 4 * moved + 4 * n + 4 * C
    return 5 * n + 4 * C + 8 * moved + 4 * C


def piecewise_bytes(t):
    """The bytes each other piecewise kernel must move at phase 6's
    inputs (each input word it needs read once, each output written
    once): the window reads the counted slots."""
    import torch
    C = t["front"].shape[0]
    read = int(torch.clamp(t["counts"], max=4096).sum())
    bw = t["row"].shape[0]
    W = t["words"].shape[0]
    return {"chunk_txn_claim": 4 * bw + 128 * bw + 4 * bw + 4,
            "ring_window": 8 * C + 4 * read + 4 * C * 4096,
            "bitmap_select": 4 * W + 128 * W}


def ring_widths(t):
    """The ring pop and push inputs phase 6 times, by width: one lane of
    a class ring (C = 5; the first member lane of phase 3 (piecewise)'s
    inputs) and of the chunk variant's pool (C = 1, the pool's
    semantics: the chunk drain's steps), the first 16 lanes and all
    4096 of those inputs; for the pop also init's pool pop of one
    class's share of chunks, for the push init's widest step (every
    page of one class's share, class 0, onto empty rings).  Each pop
    entry is (the wrapper's arguments, ``limit``), each push entry the
    wrapper's arguments."""
    import torch
    dev = t["store"].device
    C = t["front"].shape[0]
    pool = t["pool"]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    j = int(torch.nonzero(t["valid"])[0, 0])
    jf = int(torch.nonzero(t["fvalid"])[0, 0])
    ring = (t["store"], t["front"], t["back"])
    n0 = t["init_lanes"]
    pop = {"1 lane": (ring + (t["cls"][j:j + 1], t["valid"][j:j + 1]),
                      True),
           "1 lane, pool": ((pool.store, pool.front, pool.back, zero, one),
                            False),
           "16 lanes": (ring + (t["cls"][:16], t["valid"][:16]), True),
           "4096 lanes": (ring + (t["cls"], t["valid"]), True),
           f"{t['share']} lanes, pool, init": (
               (pool.store, pool.front, pool.back,
                torch.zeros(t["share"], dtype=torch.int32, device=dev),
                torch.ones(t["share"], dtype=torch.bool, device=dev)),
               False)}
    push = {"1 lane": (t["store"], t["back"], t["fcls"][jf:jf + 1],
                       t["fo"][jf:jf + 1], t["fvalid"][jf:jf + 1]),
            "1 lane, pool": (pool.store, pool.back, zero,
                             pool.store[0, :1].contiguous(), one),
            "16 lanes": (t["store"], t["back"], t["fcls"][:16],
                         t["fo"][:16], t["fvalid"][:16]),
            "4096 lanes": (t["store"], t["back"], t["fcls"], t["fo"],
                           t["fvalid"]),
            f"{n0} lanes, init": (
                t["store"], torch.zeros(C, dtype=torch.int32, device=dev),
                torch.zeros(n0, dtype=torch.int32, device=dev),
                torch.arange(n0, dtype=torch.int32, device=dev)
                * t["page_words"],
                torch.ones(n0, dtype=torch.bool, device=dev))}
    return pop, push


def time_ring(kind, args, limit, errs, reps=50):
    """One ring pop or push (``kind``) at one width: held to its plain
    version on the same tensors of the card (a push on copies of the
    store), then its profiler device time a call over ``reps`` launches
    on the path the kernels counted (all on one path), the plain
    version's time (CUDA events), and the byte bound."""
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.kernels import ops, ref
    if kind == "ring_txn_pop":
        def kern():
            return ops.ring_txn_pop(*args, limit=limit)

        def plain():
            return ref.ring_txn_pop_ref(*args, limit)
        want = plain()
        moved = int((want[0] >= 0).sum())
    else:
        store = args[0].clone()

        def kern():
            return ops.ring_txn_push(store, *args[1:])

        def plain():
            return ref.ring_txn_push_ref(store, *args[1:])
        want = ref.ring_txn_push_ref(args[0].clone(), *args[1:])
        cls, valid = args[2], args[4]
        moved = int((valid & (cls >= 0) & (cls < args[0].shape[0])).sum())
    got = (kern() if kind == "ring_txn_pop"
           else ops.ring_txn_push(args[0].clone(), *args[1:]))
    for g, w in zip(got, want):
        e = word_err(g, w)
        merge_err(errs[kind], e)
        if e[0]:
            raise AssertionError(f"{kind}: {e[0]} words differ from the "
                                 f"plain version")

    def session():  # the launches by path, as the kernels counted them
        AT.ring_launch_stats(reset=True)
        with DeviceProfile() as prof:
            for _ in range(reps):
                kern()
        prof.made = {k: m for k, m in AT.ring_launch_stats().items() if m}
        return prof

    prof = profiled(session)
    if len(prof.made) != 1 or sum(prof.made.values()) != reps:
        raise AssertionError(f"{kind}: launches {prof.made} for {reps}")
    (path, m), = prof.made.items()
    ms, seen = prof.got[path]
    n, C = args[3 if kind == "ring_txn_pop" else 2].shape[0], args[0].shape[0]
    nbytes = ring_bytes(kind, n, C, moved)
    return dict(ms=ms, plain=time_ms(plain, 10), seen=seen, counted=m,
                path=path[len(kind) + 1:], bytes=nbytes,
                bound=nbytes / HBM_BYTES_PER_S * 1e3)


def phase_piecewise_timing(t, errs, reps=50):
    """The five piecewise kernels' device times from ``torch.profiler``
    at phase 3 (piecewise)'s inputs (``reps`` launches in one session;
    the launch counters must count exactly those), the plain versions'
    times on the same tensors of the card (CUDA events; they read back,
    so they sync), and the byte bounds.  The push writes a copy of the
    store.  The ring pop and push also at each width of ``ring_widths``
    (``time_ring``: each held to its plain version, errors into
    ``errs``), under ``"by_width"``."""
    import torch
    from repro_torch.kernels import ops, ref
    pop_w, push_w = ring_widths(t)
    out = {}
    for kind, widths in (("ring_txn_pop", pop_w), ("ring_txn_push", push_w)):
        by = {}
        for label, spec in widths.items():
            args, limit = spec if kind == "ring_txn_pop" else (spec, None)
            r = by[label] = time_ring(kind, args, limit, errs, reps)
            log(f"phase 6: {kind} at {label} ({r['path']} path): kernel "
                f"{1e3 * r['ms']:.2f} us (profiler device time, {r['seen']} "
                f"of {r['counted']} counted launches recorded), plain "
                f"version on the card {1e3 * r['plain']:.1f} us, bound "
                f"{1e6 * r['bound']:.2f} ns ({r['bytes']} bytes)")
        out[kind] = dict(ms=by["4096 lanes"]["ms"],
                         plain=by["4096 lanes"]["plain"],
                         bound=by["4096 lanes"]["bound"], by_width=by)
    calls = {
        "chunk_txn_claim": (
            lambda: ops.chunk_txn_claim(t["row"], t["ppc"], ppc=t["ppc"]),
            lambda: ref.chunk_txn_claim_ref(t["row"], t["ppc"], t["ppc"])),
        "ring_window": (
            lambda: ops.ring_window(t["store"], t["front"], t["counts"],
                                    m=4096),
            lambda: ref.ring_window_ref(t["store"], t["front"], t["counts"],
                                        4096)),
        "bitmap_select": (
            lambda: ops.bitmap_select(t["words"], 4096),
            lambda: ref.bitmap_select_ref(t["words"], 4096)),
    }
    nbytes = piecewise_bytes(t)
    for name, (kern, plain) in calls.items():
        kern()
        torch.cuda.synchronize()
        ops.reset_launches()

        def session():
            with DeviceProfile() as prof:
                for _ in range(reps):
                    kern()
            return prof

        (ms, seen), = profiled(session, {name: reps}).got.values()
        sessions = ops.LAUNCHES[name] // reps
        if ops.LAUNCHES[name] != sessions * reps or sessions < 1:
            raise AssertionError(f"{name}: {ops.LAUNCHES[name]} launches "
                                 f"counted for {reps} a session")
        p_ms = time_ms(plain, 10)
        bound = nbytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, plain=p_ms, bound=bound)
        log(f"phase 6: {name} at phase 3 (piecewise)'s inputs: kernel "
            f"{1e3 * ms:.2f} us (profiler device time, {seen} of {reps} "
            f"launches recorded, {ops.LAUNCHES[name]} counted in "
            f"{sessions} session(s)), plain version on the card "
            f"{1e3 * p_ms:.1f} us, bound {1e6 * bound:.2f} ns "
            f"({nbytes[name]} bytes)")
    return out


# ---------------------------------------------------------------------------
# phase 3 (variants): the six variants through the fused kernels
# ---------------------------------------------------------------------------

VARIANTS = ("page", "chunk", "va_page", "vl_page", "va_chunk", "vl_chunk")
TXN_KERNELS = ("alloc_txn", "free_txn", "sharded_alloc_txn",
               "sharded_free_txn", "defrag_txn", "sharded_defrag_txn")
VARIANT_TRACES = ((16, 12), (4096, 3))
# the paper's benchmark heap and sweeps (the reference's
# benchmarks/common.py: BENCH_HEAP, ITERS, SIZE_SWEEP, THREAD_SWEEP,
# THREAD_SWEEP_CHUNK), copied: this script imports nothing of JAX
BENCH_HEAP = dict(total_bytes=32 << 20, chunk_bytes=8 << 10,
                  min_page_bytes=16)
BENCH_ITERS = 10
SIZE_SWEEP = (16, 64, 256, 1024, 4096, 8192)        # at 1024 lanes
THREAD_SWEEP = (32, 128, 512, 1024, 4096, 8192)     # at 1000 B
THREAD_SWEEP_CHUNK = (32, 128, 512, 1024, 2048)


def sweep_cells(variant):
    """(lanes, size) of the paper's two sweeps for one variant."""
    threads = THREAD_SWEEP_CHUNK if "chunk" in variant else THREAD_SWEEP
    return ([(1024, s) for s in SIZE_SWEEP]
            + [(n, 1000) for n in threads])


def hold_words(sd, sc, errs, kernel, what, *extra):
    """Add the differing words of arena ``sd`` (card) against ``sc``
    (CPU) and of the ``extra`` (differing, max) pairs into
    ``errs[kernel]``; raise if any word differs."""
    em, ec = word_err(sd.mem, sc.mem), word_err(sd.ctl, sc.ctl)
    merge_err(errs[kernel], em, ec, *extra)
    bad = em[0] + ec[0] + sum(e[0] for e in extra)
    if bad:
        raise AssertionError(f"{what}: {bad} words differ ({em[0]} mem, "
                             f"{ec[0]} ctl)")


class Lockstep:
    """One variant's facade on the card and on the CPU driven by the
    same transactions and waves; each one's offsets or plan and the
    arena words are held word for word (errors into ``errs`` by
    kernel)."""

    def __init__(self, cfg, variant, device, errs, **kw):
        from repro_torch.core import Ouroboros
        self.od = Ouroboros(cfg, variant, device=device, **kw)
        self.oc = Ouroboros(cfg, variant, device="cpu", **kw)
        self.sd, self.sc = self.od.init(), self.oc.init()
        self.dev, self.errs = device, errs
        self.pre = "sharded_" if self.oc.num_shards > 1 else ""
        self.live, self.failed, self.n = [], 0, 0
        self.hold("init", "alloc_txn")

    def hold(self, what, kernel, *extra):
        hold_words(self.sd, self.sc, self.errs, kernel,
                   f"{self.oc.variant} ({self.oc.num_shards} shard(s)) "
                   f"{what}", *extra)
        self.n += 1

    def alloc(self, sizes, mask, hint=None):
        import torch
        hk = {} if hint is None else {"shard_hint": torch.as_tensor(hint)}
        self.sc, oc = self.oc.alloc(self.sc, sizes, mask, **hk)
        if hint is not None:
            hk = {"shard_hint": hk["shard_hint"].to(self.dev)}
        self.sd, od = self.od.alloc(self.sd, sizes.to(self.dev),
                                    mask.to(self.dev), **hk)
        self.hold(f"alloc {self.n}", self.pre + "alloc_txn",
                  word_err(od, oc))
        self.failed += int(((oc < 0) & mask).sum())
        self.live += [(int(o), int(s)) for o, s in
                      zip(oc.tolist(), sizes.tolist()) if o >= 0]

    def free_some(self, rng, k, lanes):
        import numpy as np
        import torch
        k = min(k, len(self.live))
        pick = set(rng.choice(len(self.live), k, replace=False).tolist())
        drop = [x for i, x in enumerate(self.live) if i in pick]
        self.live = [x for i, x in enumerate(self.live) if i not in pick]
        fo = np.full(lanes, -1, np.int32)
        fs = np.zeros(lanes, np.int32)
        fo[:k] = [o for o, _ in drop]
        fs[:k] = [s for _, s in drop]
        perm = rng.permutation(lanes)
        fo_t, fs_t = torch.from_numpy(fo[perm]), torch.from_numpy(fs[perm])
        self.sc = self.oc.free(self.sc, fo_t, fs_t, fo_t >= 0)
        fo_d = fo_t.to(self.dev)
        self.sd = self.od.free(self.sd, fo_d, fs_t.to(self.dev), fo_d >= 0)
        self.hold(f"free {self.n}", self.pre + "free_txn")

    def trace(self, rng, n_ops, lanes, hints=None):
        """``alloc_trace``'s ops (a free with nothing live allocates)."""
        import torch
        for i, op in enumerate(alloc_trace(rng, n_ops, lanes)):
            if op[0] == "alloc" or not self.live:
                sizes, mask = op[1:] if op[0] == "alloc" else \
                    alloc_trace(rng, 1, lanes)[0][1:]
                self.alloc(torch.from_numpy(sizes), torch.from_numpy(mask),
                           None if hints is None else hints(rng, i, lanes))
            else:
                self.free_some(rng, op[1], lanes)
        return self

    def wave(self, kind):
        self.sc, fc = getattr(self.oc, kind)(self.sc)
        self.sd, fd = getattr(self.od, kind)(self.sd)
        self.hold(f"{kind} wave", self.pre + "defrag_txn",
                  *(word_err(a, b) for a, b in zip(fd, fc)))
        return int((fc.src >= 0).sum())


def phase_variants(device, seed=0):
    """The six variants (page and chunk over the ring, va and vl
    families) through the fused transaction and wave kernels, held word
    for word to the plain math on CPU copies: seeded alloc/free traces
    on the 65536-page arena geometry at 16 and 4096 lanes, an exhausting
    trace on the 256-page geometry, a 4-shard trace (hashed homes, every
    lane pinned to shard 0, per-lane hints; lanes served at walk
    attempts > 0), then for chunk and va_chunk compaction and rebalance
    waves.  Returns (the traces' launches, the measured errors per
    kernel)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import make_kv_allocator

    big = make_kv_allocator(65536, device="cpu")[0].cfg
    small = make_kv_allocator(256, device="cpu")[0].cfg
    shard4 = make_kv_allocator(256, device="cpu", num_shards=SHARDS)[0].cfg
    errs = {k: {"words": 0, "max_abs": 0} for k in TXN_KERNELS}
    rng = np.random.default_rng(seed + 16)
    chains()
    enqueues()
    rebuilds()
    ops.reset_launches()
    t_all = time.perf_counter()

    def hints(rng, i, lanes):
        return (None, np.zeros(lanes, np.int32),
                rng.integers(-4, 8, lanes).astype(np.int32))[i % 3]

    for v in VARIANTS:
        t0 = time.perf_counter()
        notes = []
        for lanes, n_ops in VARIANT_TRACES:
            ls = Lockstep(big, v, device, errs).trace(rng, n_ops, lanes)
            notes.append(f"{lanes} lanes x {n_ops}")
        ls = Lockstep(small, v, device, errs).trace(rng, 30, 64)
        if not ls.failed:
            raise AssertionError(f"{v}: the exhausting trace failed no lane")
        notes.append(f"exhausting 64 lanes x 30 ({ls.failed} failed lanes)")
        ls = Lockstep(shard4, v, device, errs, num_shards=SHARDS).trace(
            rng, 24, 64, hints=hints)
        lay = shard_lay(ls.oc)
        walked = int(ls.sc.ctl[:, lay.off_t_walk + 1:
                               lay.off_t_walk + SHARDS].sum())
        if not walked:
            raise AssertionError(f"{v}: no lane served at a walk attempt "
                                 f"> 0")
        notes.append(f"{SHARDS} shards 64 lanes x 24 ({walked} lanes "
                     f"served at walk attempts > 0)")
        if v in ("chunk", "va_chunk"):
            ls = Lockstep(small, v, device, errs)
            churn(ls.oc, ls.sc, np.random.default_rng(seed + 1), 16, 256,
                  True)
            churn(ls.od, ls.sd, np.random.default_rng(seed + 1), 16, 256,
                  True)
            ls.hold("churn", "alloc_txn")
            m1 = ls.wave("defrag")
            ls = Lockstep(shard4, v, device, errs, num_shards=SHARDS)
            for o, st in ((ls.oc, ls.sc), (ls.od, ls.sd)):
                dev = st.mem.device
                r = np.random.default_rng(seed + 2)
                sizes = torch.full((16,), 256, dtype=torch.int32, device=dev)
                home = torch.zeros(16, dtype=torch.int32, device=dev)
                live = []
                for _ in range(8):
                    mask = torch.from_numpy(r.random(16) < 0.9).to(dev)
                    st, offs = o.alloc(st, sizes, mask, shard_hint=home)
                    live += [x for x in offs.tolist() if x >= 0]
                drop = torch.tensor([x for i, x in enumerate(live) if i % 3],
                                    dtype=torch.int32)
                for i in range(0, drop.numel(), 16):
                    fo = torch.full((16,), -1, dtype=torch.int32)
                    fo[:drop[i:i + 16].numel()] = drop[i:i + 16]
                    fo = fo.to(dev)
                    o.free(st, fo, sizes, fo >= 0)
            ls.hold("churn", "sharded_alloc_txn")
            m2, m3 = ls.wave("defrag"), ls.wave("rebalance")
            if not (m1 and m2 and m3):
                raise AssertionError(f"{v}: a wave moved nothing ({m1}, "
                                     f"{m2}, {m3})")
            notes.append(f"waves: compaction {m1} moves, sharded "
                         f"compaction {m2}, rebalance {m3}")
        log(f"phase 3 (variants): {v}: " + "; ".join(notes)
            + f": 0 differing words ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in TXN_KERNELS}
    log(f"phase 3 (variants): launches of the traces and waves "
        f"{json.dumps(launches)} ({time.perf_counter() - t_all:.1f} s); "
        f"the alloc kernels' chunk chains: {chain_text(chains())}; the free "
        f"kernels' enqueues: {enqueue_text(enqueues())}; the waves' queue "
        f"rebuilds: {rebuild_text(rebuilds())}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a widened kernel never launched: {launches}")
    return launches, errs


def phase_sweeps(device, errs):
    """The paper's figure sweeps (figs 1-6, as the reference's
    ``benchmarks/common.bench_variant`` runs them) for the six variants
    on the paper's heap: per cell a fresh arena, ``BENCH_ITERS`` rounds
    of alloc -> ``write_pattern`` -> ``check_pattern`` -> free of every
    lane at one size, each transaction timed by CUDA events around it;
    ``check_pattern`` must hold on every granted lane and some lane must
    be granted.  Each cell's first alloc and first free are held word
    for word to the plain math on a CPU copy of the arena (the write
    between them applied to both).  The launch counters are zeroed just
    before the sweeps and read just after.  Returns the sweeps'
    launches."""
    import torch
    from repro_torch.core import HeapConfig, Ouroboros
    from repro_torch.kernels import ops

    cfg = HeapConfig(**BENCH_HEAP)
    t_all = time.perf_counter()
    chains()
    enqueues()
    ops.reset_launches()
    for v in VARIANTS:
        t0 = time.perf_counter()
        od = Ouroboros(cfg, v, device=device)
        oc = Ouroboros(cfg, v, device="cpu")
        init_c = oc.init()
        cells = sweep_cells(v)
        for lanes, size in cells:
            st = od.init()
            if (lanes, size) == cells[0]:
                hold_words(st, init_c, errs, "alloc_txn", f"{v} init")
            sizes = torch.full((lanes,), size, dtype=torch.int32,
                               device=device)
            mask = torch.ones(lanes, dtype=torch.bool, device=device)
            tags = torch.arange(lanes, dtype=torch.int32, device=device)
            times = {"alloc": [], "free": []}
            ok_all, granted_max = True, 0
            for it in range(BENCH_ITERS):
                if it == 0:
                    sc = type(st)(st.mem.to("cpu", copy=True),
                                  st.ctl.to("cpu", copy=True))
                a, b = _events()
                a.record()
                st, offs = od.alloc(st, sizes, mask)
                b.record()
                torch.cuda.synchronize()
                times["alloc"].append(a.elapsed_time(b))
                if it == 0:
                    sc, oc_offs = oc.alloc(sc, sizes.cpu(), mask.cpu())
                    hold_words(st, sc, errs, "alloc_txn",
                               f"{v} sweep {lanes} x {size} B alloc",
                               word_err(offs, oc_offs))
                st = od.write_pattern(st, offs, sizes, tags)
                ok = od.check_pattern(st, offs, sizes, tags)
                granted = offs >= 0
                ok_all &= bool(ok[granted].all()) and bool(granted.any())
                granted_max = max(granted_max, int(granted.sum()))
                if it == 0:
                    sc = oc.write_pattern(sc, offs.cpu(), sizes.cpu(),
                                          tags.cpu())
                a, b = _events()
                a.record()
                st = od.free(st, offs, sizes, mask)
                b.record()
                torch.cuda.synchronize()
                times["free"].append(a.elapsed_time(b))
                if it == 0:
                    sc = oc.free(sc, offs.cpu(), sizes.cpu(), mask.cpu())
                    hold_words(st, sc, errs, "free_txn",
                               f"{v} sweep {lanes} x {size} B free")
            if not ok_all:
                raise AssertionError(f"{v} {lanes} x {size} B: check_pattern "
                                     f"failed or no lane granted")
            us = {f"{k}_us_{w}": 1e3 * sum(t[i0:]) / len(t[i0:])
                  for k, t in times.items()
                  for w, i0 in (("all", 0), ("subsequent", 1))}
            row = dict(variant=v, n=lanes, size=size, granted=granted_max,
                       data_ok=ok_all, **us)
            log(f"phase 3 (variants): sweep {json.dumps(row)}")
        log(f"phase 3 (variants): {v}: {len(cells)} cells, check_pattern "
            f"true on every granted lane, first alloc and free of each "
            f"cell 0 differing words ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in TXN_KERNELS}
    log(f"phase 3 (variants): launches of the sweeps {json.dumps(launches)} "
        f"({time.perf_counter() - t_all:.1f} s); the alloc kernels' chunk "
        f"chains: {chain_text(chains())}; the free kernels' enqueues: "
        f"{enqueue_text(enqueues())}")
    if not (launches["alloc_txn"] and launches["free_txn"]):
        raise AssertionError(f"the sweeps launched no transaction kernel: "
                             f"{launches}")
    return launches


def cell_log(ouro_cpu, lanes, size, iters=2, wave=False):
    """The records (``replay_kernels``' vocabulary) of one figure cell on
    a CPU arena: ``iters`` rounds of alloc and free of every lane, homes
    hashed when sharded; with ``wave``, one alloc, a free of two of
    every three grants and a defrag wave of the plan the CPU makes.
    Returns (records, the index of the first record to time)."""
    import torch
    st = ouro_cpu.init()
    sizes = torch.full((lanes,), size, dtype=torch.int32)
    mask = torch.ones(lanes, dtype=torch.bool)
    log_ = []
    for _ in range(1 if wave else iters):
        st, offs = ouro_cpu.alloc(st, sizes, mask)
        log_.append(("alloc", sizes, mask, offs))
        fm = mask & (torch.arange(lanes) % 3 != 0) if wave else mask
        st = ouro_cpu.free(st, offs, sizes, fm)
        log_.append(("free", offs, sizes, fm))
    if wave:
        src, dst, sz = plan_of(ouro_cpu, st, "defrag",
                               ouro_cpu._moves(None))
        log_.append(("defrag", src, dst, sz))
        return log_, 2
    return log_, 0


def wave_bound_ms(ouro_cpu, log_):
    """``defrag_bound_ms`` of the wave that ends ``log_``."""
    st = ouro_cpu.init()
    for rec in log_[:-1]:
        if rec[0] == "alloc":
            st, _ = ouro_cpu.alloc(st, rec[1], rec[2])
        else:
            st = ouro_cpu.free(st, *rec[1:4])
    before = st.mem.clone()
    st = migrate(ouro_cpu, st, *log_[-1][1:4])
    return defrag_bound_ms(shard_lay(ouro_cpu), before, st.mem,
                           log_[-1][1], log_[-1][3])


def time_from_copies(ouro, pre, fn, kind, reps=20):
    """Mean device ms a call of ``fn(state)``, a ``kind`` of allocator
    call, from ``torch.profiler`` over ``reps`` calls, each on a fresh
    copy of the arena words ``pre`` (the copies are other kernels), its
    kernels summed as ``per_call`` sums them."""
    from repro_torch.core.arena import Arena
    from repro_torch.core.shards import ShardedArena
    st = (Arena if ouro.num_shards == 1 else ShardedArena)(
        *(t.clone() for t in pre))

    def session():
        with DeviceProfile(counted=True) as prof:
            for _ in range(reps):
                st.mem.copy_(pre[0])
                st.ctl.copy_(pre[1])
                fn(st)
        return prof

    return per_call(profiled(session), kind)[0]


def phase_variants_timing(device, lanes=1024, size=256, reps=20):
    """Each widened kernel's device time per variant from
    ``torch.profiler`` at the figure cell of ``lanes`` x ``size`` B on
    the paper's heap: the alloc of every lane from a fresh arena and the
    free of that grant, single and 4 shards with hashed homes, and for
    chunk kinds a defrag wave after two of three grants are freed, each
    ``reps`` times from copies of the words before it; the plain math on
    the card's tensors (CUDA events) and the byte bounds.  Returns
    {variant: {kernel: {ms, plain, bound}}}."""
    import torch
    from repro_torch.core import HeapConfig, Ouroboros
    cfg = HeapConfig(**BENCH_HEAP)
    sizes = torch.full((lanes,), size, dtype=torch.int32, device=device)
    mask = torch.ones(lanes, dtype=torch.bool, device=device)
    out = {}
    for v in VARIANTS:
        out[v] = {}
        for S in (1, SHARDS):
            kw = {"num_shards": S} if S > 1 else {}
            od = Ouroboros(cfg, v, device=device, **kw)
            oc = Ouroboros(cfg, v, device="cpu", **kw)
            pre = "sharded_" if S > 1 else ""
            st = od.init()
            words = (st.mem.clone(), st.ctl.clone())
            st, offs = od.alloc(st, sizes, mask)
            ms = {"alloc": time_from_copies(
                      od, words, lambda s: od.alloc(s, sizes, mask),
                      "alloc", reps),
                  "free": time_from_copies(
                      od, (st.mem.clone(), st.ctl.clone()),
                      lambda s: od.free(s, offs, sizes, mask), "free",
                      reps)}
            log_, _ = cell_log(oc, lanes, size)
            p = time_plain_txns(od, log_)
            b = txn_bound_ms(oc, log_)
            for kind in ("alloc", "free"):
                out[v][f"{pre}{kind}_txn"] = dict(
                    ms=ms[kind], plain=sum(p[kind]) / len(p[kind]),
                    bound=sum(b[kind]) / len(b[kind]))
            if od.kind == "chunk":
                log_, start = cell_log(oc, lanes, size, wave=True)
                st = od.init()
                for rec in log_[:start]:
                    args = [x.to(device) for x in rec[1:4]]
                    if rec[0] == "alloc":
                        st, _ = od.alloc(st, args[0], args[1])
                    else:
                        st = od.free(st, *args)
                wave = {"pre": (st.mem.clone(), st.ctl.clone()),
                        "plan": [x.to(device) for x in log_[start][1:4]]}
                ms, _, _, plain, _ = time_defrag_waves(od, [wave], reps=reps)
                out[v][f"{pre}defrag_txn"] = dict(
                    ms=ms, plain=plain, bound=wave_bound_ms(oc, log_))
        log(f"phase 6: {v} at the {lanes} x {size}-B cell of the paper's "
            f"heap ({reps} launches of each kernel, from copies of the "
            f"words before it): " + "; ".join(
                f"{name} {1e3 * t['ms']:.2f} us (plain on the card "
                f"{1e3 * t['plain']:.1f} us, bound {1e6 * t['bound']:.2f} "
                f"ns)" for name, t in out[v].items()))
    return out


# ---------------------------------------------------------------------------
# phase 4: paged attention, kernel vs plain version
# ---------------------------------------------------------------------------

def attn_inputs(device, dtype, wpp, seed=0, B=8, Hq=14, Hkv=2, D=64,
                page=16, P=32, NP=384):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, page, Hkv, D), np.float32))
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[1, 5] = -1           # holes inside the live range
    table[4, 0] = -1
    table[6, 10:] = -1
    seq = np.array([P * page, 1, 37, 0, 100, 255, 300, 511], np.int32)[:B]
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    t = [x.to(dtype) for x in (q, k, v)]
    return (t[0].to(device), t[1].to(device), t[2].to(device),
            torch.from_numpy(table).to(device),
            torch.from_numpy(seq).to(device))


def attn_bound_ms(q, k, table, seq, wpp, window=None, ring=False,
                  k_scale=None, **_) -> tuple:
    """Least time for this input: the K and V bytes of the attended
    tokens (below seq_len, inside the window, on the ring's last lap, of
    pages that are not holes; int8 pages with their two float32 scales
    a token and kv head, one for K and one for V) + q + out + table, or
    the float32 operations (int8: one more multiply an element of K and
    of V), whichever is larger."""
    from repro_torch.kernels.ref import page_ids, slot_tokens
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k.shape
    pid = page_ids(table, wpp).cpu()
    _, valid = slot_tokens(table.cpu(), seq.cpu(), page, window, ring)
    t_valid = int((valid & (pid >= 0)[:, :, None]).sum())
    el = k.element_size() + (4 / D if k_scale is not None else 0)
    nbytes = (2 * t_valid * Hkv * D * el + q.numel() * q.element_size()
              + B * Hq * D * 4 + table.numel() * 4 + B * 4)
    flops = (4 * (Hq // Hkv) + (2 if k_scale is not None else 0)) \
        * t_valid * Hkv * D
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


ATTN_KERNELS = ("paged_attention", "paged_attention_values",
                "paged_attention_merge")


def attn_device_ms(q, k, v, table, seq, wpp, reps=50, **kw):
    """Device ms of one ``paged_attention`` call from ``torch.profiler``
    over ``reps`` calls: the sum over its three kernels (scores, values,
    merge) of each one's mean over the launches the profiler recorded;
    each kernel's part; the fewest launches recorded of any of them.
    ``kw``: ``window`` and ``ring``."""
    from repro_torch.kernels import paged_attention as pa_kernel

    def session():
        with DeviceProfile() as prof:
            for _ in range(reps):
                pa_kernel.paged_attention(q, k, v, table, seq, wpp=wpp,
                                          **kw)
        return prof

    got = profiled(session, {k: reps for k in ATTN_KERNELS}).got
    parts = [got[k][0] for k in ATTN_KERNELS]
    return sum(parts), parts, min(n for _, n in got.values())


def phase_attention(device):
    """``paged_attention`` against its plain version at the decode
    shapes, four lines (dtype x table mode): the max error, the device
    time of a call (its three kernels, profiler), the CUDA-event
    time of a call (the wrapper's host work inside), the plain version's
    time and the bound; and the split geometry."""
    import torch
    from repro_torch.kernels import paged_attention as pa_kernel
    from repro_torch.kernels import ref

    res = {}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5)):
        for wpp in (None, 64):
            q, k, v, table, seq = attn_inputs(device, dtype, wpp)
            got = pa_kernel.paged_attention(q, k, v, table, seq, wpp=wpp)
            want = ref.paged_attention(q, k, v, table, seq, wpp=wpp)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (err <= atol) or not torch.isfinite(got).all():
                raise AssertionError(f"paged_attention {dtype} wpp={wpp}: "
                                     f"max error {err} > {atol}")
            ms, parts, rec = attn_device_ms(q, k, v, table, seq, wpp)
            wall = time_ms(lambda: pa_kernel.paged_attention(
                q, k, v, table, seq, wpp=wpp), 200)
            plain = time_ms(lambda: ref.paged_attention(
                q, k, v, table, seq, wpp=wpp), 10)
            bound, by = attn_bound_ms(q, k, table, seq, wpp)
            B, Hq, _ = q.shape
            _, page, Hkv, _ = k.shape
            pps, splits = pa_kernel.geometry(page, table.shape[1])
            tag = f"{str(dtype).split('.')[-1]} {'offsets' if wpp else 'ids'}"
            log(f"phase 4: paged_attention {tag}: max error {err:.3g} "
                f"(atol {atol}); kernel {ms:.5f} ms a call (profiler device "
                f"time: scores {parts[0]:.5f} + values {parts[1]:.5f} + merge "
                f"{parts[2]:.5f}, at least {rec} of 50 calls recorded), "
                f"{wall:.5f} ms a call on "
                f"CUDA events (wrapper inside), plain {plain:.4f} ms, bound "
                f"{bound:.5f} ms ({by}); {splits} splits of {pps} pages: "
                f"grid {B * Hkv} x {splits} blocks")
            res[(dtype, wpp)] = dict(err=err, ms=ms, wall=wall, plain=plain,
                                     bound=bound, by=by, pps=pps,
                                     splits=splits)
    return res


# mixtral-8x7b's decode attention: 32 query and 8 kv heads of 128, a
# 4096-token sliding window; sequence lengths on both sides of the
# window, up to 8192 tokens
MIXTRAL = "mixtral-8x7b"
MIX_ATTN = dict(B=8, Hq=32, Hkv=8, D=128, page=16, window=4096)
MIX_SEQ = (1, 100, 4096, 4097, 4160, 5000, 8000, 8192)


def mix_attn_inputs(device, dtype, wpp, ring, seed=0):
    """Unit normals at mixtral's heads: a table of 512 page slots (the
    8192-token row's pages) or a ring of window // page + 2 = 258 slots,
    shorter than the longest rows need; holes inside the window, before
    it and on the ring."""
    import numpy as np
    import torch
    B, Hq, Hkv, D = (MIX_ATTN[k] for k in ("B", "Hq", "Hkv", "D"))
    page, W = MIX_ATTN["page"], MIX_ATTN["window"]
    P = W // page + 2 if ring else max(MIX_SEQ) // page
    NP = B * P + 64
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q = normal(B, Hq, D)
    k, v = normal(NP, page, Hkv, D), normal(NP, page, Hkv, D)
    rng = np.random.default_rng(seed)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[1, 3] = -1            # inside the 100-token row
    lo = 254 if ring else 260
    table[5, lo:lo + 2] = -1    # inside row 5's window (or ring)
    table[7, 0:5] = -1          # before the 8192-token row's window
    table[6, P - 1] = -1        # the last slot
    if wpp:
        table = np.where(table >= 0, table * wpp, -1).astype(np.int32)
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(MIX_SEQ, dtype=torch.int32, device=device), P)


def phase_attention_mixtral(device):
    """``paged_attention`` with ``window`` and ``ring`` against its plain
    version at mixtral-8x7b's decode shapes: the window alone over a
    512-slot table, and a 258-slot ring table with the window (what the
    reference's windowed decode passes), both table modes, float32 and
    bf16 (atol 1e-5); the device time of a call, its time on CUDA
    events, the plain version's time and the bound (bytes of the
    attended tokens at 3.35 TB/s)."""
    import torch
    from repro_torch.kernels import paged_attention as pa_kernel
    from repro_torch.kernels import ref

    W, res = MIX_ATTN["window"], {}
    for ring in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for wpp in (None, 64):
                q, k, v, table, seq, P = mix_attn_inputs(device, dtype, wpp,
                                                         ring)
                kw = dict(wpp=wpp, window=W, ring=ring)
                got = pa_kernel.paged_attention(q, k, v, table, seq, **kw)
                want = ref.paged_attention(q, k, v, table, seq, **kw)
                whole = ref.paged_attention(q, k, v, table, seq, wpp=wpp)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (err <= 1e-5) or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"paged_attention {MIXTRAL} ring={ring} {dtype} "
                        f"wpp={wpp}: max error {err} > 1e-5")
                if not float((whole - want).abs().max()) > 1e-3:
                    raise AssertionError("the window masked nothing")
                ms, parts, rec = attn_device_ms(q, k, v, table, seq, wpp,
                                                window=W, ring=ring)
                wall = time_ms(lambda: pa_kernel.paged_attention(
                    q, k, v, table, seq, **kw), 100)
                plain = time_ms(lambda: ref.paged_attention(
                    q, k, v, table, seq, **kw), 2, warmup=1)
                bound, by = attn_bound_ms(q, k, table, seq, wpp, W, ring)
                pps, splits = pa_kernel.geometry(MIX_ATTN["page"], P)
                tag = (f"{'ring' if ring else 'window'} "
                       f"{str(dtype).split('.')[-1]} "
                       f"{'offsets' if wpp else 'ids'}")
                log(f"phase 4: paged_attention {MIXTRAL} {tag} (B 8, Hq 32, "
                    f"Hkv 8, D 128, window {W}, P {P}, seq {list(MIX_SEQ)}): "
                    f"max error {err:.3g} (atol 1e-5); kernel {ms:.5f} ms a "
                    f"call (profiler device time: scores {parts[0]:.5f} + "
                    f"values {parts[1]:.5f} + merge {parts[2]:.5f}, at least "
                    f"{rec} of 50 calls recorded), {wall:.5f} ms a call on "
                    f"CUDA events, plain {plain:.3f} ms, bound {bound:.5f} ms "
                    f"({by}); {splits} splits of {pps} pages")
                res[tag] = dict(err=err, ms=ms, wall=wall, plain=plain,
                                bound=bound, by=by, P=P)
                del q, k, v, got, want, whole
    torch.cuda.empty_cache()
    return res


# qwen1.5-32b's decode attention: 40 query and 40 kv heads of 128 (G 1),
# 8 sequences of 1-1,024 tokens on a 64-slot table (max_seq 1,024)
QWEN32 = "qwen1.5-32b"
Q32_ATTN = dict(B=8, Hq=40, Hkv=40, D=128, page=16, P=64)
Q32_SEQ = (1, 17, 64, 255, 448, 600, 1000, 1024)


def q32_attn_inputs(device, dtype, seed=0):
    """Unit normals at qwen1.5-32b's heads (q in ``dtype``, K and V in
    float32 for the caller to store), a permuted 64-slot table with
    holes inside the live range."""
    import numpy as np
    import torch
    B, Hq, Hkv, D, page, P = (Q32_ATTN[k] for k in
                              ("B", "Hq", "Hkv", "D", "page", "P"))
    NP = B * P + 64
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    q = normal(B, Hq, D).to(dtype)
    k, v = normal(NP, page, Hkv, D), normal(NP, page, Hkv, D)
    table = np.random.default_rng(seed).permutation(NP)[:B * P]
    table = table.reshape(B, P).astype(np.int32)
    table[2, 1] = -1            # inside the 64-token row
    table[5, 10:12] = -1        # inside the 600-token row
    table[7, 63] = -1           # the 1,024-token row's last page
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(Q32_SEQ, dtype=torch.int32, device=device))


def int8_pages(k, v):
    """K and V as the int8 KV cache stores them: the int8 words and a
    float32 scale per (page, slot, kv head), ``kv_cache._quant``."""
    from repro_torch.paged.kv_cache import _quant
    k8, ks = _quant(k.float())
    v8, vs = _quant(v.float())
    return k8, v8, dict(k_scale=ks, v_scale=vs)


def phase_attention_int8(device):
    """``paged_attention`` on int8 pages against its plain version (atol
    1e-5, each element read as float(k8) * scale on both sides): at
    qwen2's shapes with unit inputs (q float32 on page ids, q bf16 on
    word offsets), at qwen1.5-32b's decode shapes (q bf16 and float32;
    and its bf16 pages beside them), and at mixtral-8x7b's window
    (512-slot table) and ring (258 slots, word offsets); each case's
    device time a call (profiler), CUDA-event time, plain time and bound
    (the attended K and V bytes and their scales)."""
    import torch
    from repro_torch.kernels import paged_attention as pa_kernel
    from repro_torch.kernels import ref

    def qwen2(dtype, wpp):
        q, k, v, table, seq = attn_inputs(device, dtype, wpp)
        return (q, k, v, table, seq), dict(wpp=wpp), 32

    def q32(dtype, quant=True):
        q, k, v, table, seq = q32_attn_inputs(device, torch.bfloat16)
        return (q.to(dtype), k.to(torch.bfloat16), v.to(torch.bfloat16),
                table, seq), dict(quant=quant), Q32_ATTN["P"]

    def mixtral(wpp, ring):
        q, k, v, table, seq, P = mix_attn_inputs(device, torch.bfloat16, wpp,
                                                 ring)
        return ((q, k, v, table, seq),
                dict(wpp=wpp, window=MIX_ATTN["window"], ring=ring), P)

    cases = (
        ("unit qwen2 f32 ids", lambda: qwen2(torch.float32, None)),
        ("unit qwen2 bf16 offsets", lambda: qwen2(torch.bfloat16, 64)),
        (f"{QWEN32} bf16 ids", lambda: q32(torch.bfloat16)),
        (f"{QWEN32} f32 ids", lambda: q32(torch.float32)),
        (f"{QWEN32} bf16 ids, bf16 pages",
         lambda: q32(torch.bfloat16, quant=False)),
        (f"{MIXTRAL} window bf16 ids", lambda: mixtral(None, False)),
        (f"{MIXTRAL} ring bf16 offsets", lambda: mixtral(64, True)))
    res = {}
    for tag, make in cases:
        (q, k, v, table, seq), kw, P = make()
        if kw.pop("quant", True):
            k, v, scales = int8_pages(k, v)
            kw.update(scales)
        got = pa_kernel.paged_attention(q, k, v, table, seq, **kw)
        want = ref.paged_attention(q, k, v, table, seq, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= 1e-5) or not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention int8 {tag}: max error "
                                 f"{err} > 1e-5")
        wpp = kw.pop("wpp", None)
        ms, parts, rec = attn_device_ms(q, k, v, table, seq, wpp, **kw)
        wall = time_ms(lambda: pa_kernel.paged_attention(
            q, k, v, table, seq, wpp=wpp, **kw), 100)
        plain = time_ms(lambda: ref.paged_attention(
            q, k, v, table, seq, wpp=wpp, **kw), 2, warmup=1)
        bound, by = attn_bound_ms(q, k, table, seq, wpp, **kw)
        B, Hq, D = q.shape
        _, page, Hkv, _ = k.shape
        pps, splits = pa_kernel.geometry(page, P)
        log(f"phase 4: paged_attention int8 {tag} (B {B}, Hq {Hq}, Hkv "
            f"{Hkv}, D {D}, P {P}, pages {k.dtype}, q {q.dtype}): max "
            f"error {err:.3g} (atol 1e-5); kernel {ms:.5f} ms a call "
            f"(profiler device time: scores {parts[0]:.5f} + values "
            f"{parts[1]:.5f} + merge {parts[2]:.5f}, at least {rec} of 50 "
            f"calls recorded), {wall:.5f} ms a call on CUDA events, plain "
            f"{plain:.3f} ms, bound {bound:.5f} ms ({by}); {splits} splits "
            f"of {pps} pages: grid {B * Hkv} x {splits} blocks")
        res[tag] = dict(err=err, ms=ms, wall=wall, plain=plain, bound=bound,
                        by=by, parts=parts, int8=k.dtype == torch.int8)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: serve full-width qwen2-0.5b through the kernels
# ---------------------------------------------------------------------------

class RecordingOuroboros:
    """Delegates to the engine's allocator and keeps a CPU copy of every
    transaction's lanes (and the offsets it granted, and the home-shard
    hint of a sharded alloc) and of every wave's plan."""

    def __init__(self, ouro):
        self._ouro = ouro
        self.log = []

    def __getattr__(self, name):
        return getattr(self._ouro, name)

    def alloc(self, state, sizes, mask, shard_hint=None):
        kw = {} if shard_hint is None else {"shard_hint": shard_hint}
        state, offs = self._ouro.alloc(state, sizes, mask, **kw)
        hint = None if shard_hint is None else shard_hint.cpu()
        self.log.append(("alloc", sizes.cpu(), mask.cpu(), offs.cpu(), hint))
        return state, offs

    def free(self, state, offs, sizes, mask):
        self.log.append(("free", offs.cpu(), sizes.cpu(), mask.cpu()))
        return self._ouro.free(state, offs, sizes, mask)

    def defrag(self, state, max_moves=None):
        state, fwd = self._ouro.defrag(state, max_moves)
        self.log.append(("defrag", fwd.src.cpu(), fwd.dst.cpu(),
                         fwd.sizes.cpu()))
        return state, fwd

    def rebalance(self, state, max_moves=None):
        state, fwd = self._ouro.rebalance(state, max_moves)
        self.log.append(("rebalance", fwd.src.cpu(), fwd.dst.cpu(),
                         fwd.sizes.cpu()))
        return state, fwd


WAVES = ("defrag", "rebalance")


def kernel_of(ouro, kind: str) -> str:
    """The kernel a recorded transaction or wave launches on the card."""
    base = "defrag" if kind in WAVES else kind
    return ("sharded_" if ouro.num_shards > 1 else "") + f"{base}_txn"


def hint_kw(rec, dev=None):
    if rec[0] != "alloc" or len(rec) < 5 or rec[4] is None:
        return {}
    return {"shard_hint": rec[4] if dev is None else rec[4].to(dev)}


def plan_of(ouro, st, kind, max_moves):
    """The plan a wave of ``kind`` makes on arena ``st``."""
    from repro_torch.core import defrag, shards
    args = (ouro.cfg, ouro.kind, ouro.family, st.mem, st.ctl)
    if ouro.num_shards == 1:
        return defrag.plan_math(*args, max_moves=max_moves)
    S = ouro.num_shards
    if kind == "rebalance":
        return shards.rebalance_plan_math(ouro.cfg, S, *args[1:],
                                          max_moves=max_moves)
    return defrag.sharded_plan_math(ouro.cfg, S, *args[1:],
                                    max_moves=max_moves)


def migrate(ouro, st, src, dst, sizes):
    """One wave with a given plan (the kernel on the card, the plain math
    on the CPU)."""
    from repro_torch.core import transactions as T
    if ouro.num_shards == 1:
        return T.migrate(ouro.cfg, ouro.kind, ouro.family, st, src, dst,
                         sizes)
    return T.sharded_migrate(ouro.cfg, ouro.num_shards, ouro.kind,
                             ouro.family, st, src, dst, sizes)


def shard_lay(ouro):
    """One arena's layout (a shard's when sharded)."""
    return ouro.layout if ouro.num_shards == 1 else ouro.layout.shard


class CountingModel:
    """Delegates to the model, counts decode ticks, keeps each prefill's
    prompt length, and sums the host wall of the calls (each ends where
    the engine reads its token ids back, which syncs)."""

    def __init__(self, model):
        self._model = model
        self.decode_calls = 0
        self.prefill_lens = []
        self.secs = {"prefill": 0.0, "decode": 0.0}

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *a, **kw):
        self.decode_calls += 1
        t0 = time.perf_counter()
        out = self._model.decode_step(*a, **kw)
        self.secs["decode"] += time.perf_counter() - t0
        return out

    def prefill(self, params, batch, *a, **kw):
        self.prefill_lens.append(int(batch["tokens"].shape[1]))
        t0 = time.perf_counter()
        out = self._model.prefill(params, batch, *a, **kw)
        self.secs["prefill"] += time.perf_counter() - t0
        return out


def make_requests(cfg, seed, n, lo, hi):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def replay_plain(ouro, log_):
    """Replay recorded transactions and waves through the plain math of a
    CPU allocator; returns (arena, (differing offsets and plan words,
    their max absolute difference), per-wave byte bounds) against what
    the engine's kernels granted and planned."""
    st = ouro.init()
    bad = {"words": 0, "max_abs": 0}
    bounds = []
    for rec in log_:
        if rec[0] == "alloc":
            st, offs = ouro.alloc(st, rec[1], rec[2], **hint_kw(rec))
            merge_err(bad, word_err(rec[3], offs))
        elif rec[0] == "free":
            st = ouro.free(st, rec[1], rec[2], rec[3])
        else:
            plan = plan_of(ouro, st, rec[0], rec[1].shape[0])
            merge_err(bad, *(word_err(a, b) for a, b in zip(rec[1:], plan)))
            before = st.mem.clone()
            st = migrate(ouro, st, *rec[1:4])
            bounds.append(defrag_bound_ms(shard_lay(ouro), before, st.mem,
                                          rec[1], rec[3]))
    return st, (bad["words"], bad["max_abs"]), bounds


def profiled(session, made=None, tries=6):
    """Run ``session()`` (work under a ``DeviceProfile``, which it
    returns) until the profiler recorded a launch of every kernel that
    ran, up to ``tries`` sessions: the kernels of ``made`` ({kernel:
    launches made}), or, when None, every kernel whose launches the card
    counted (``DeviceProfile(counted=True)``).  The profiler can drop a
    launch's record (and has dropped a whole session's), never add one.
    Returns the profile with ``got`` {kernel: (mean ms a launch,
    launches recorded)} and ``made`` {kernel: launches}."""
    for _ in range(tries):
        prof = session()
        want = {k: m for k, m in (prof.made if made is None
                                  else made).items() if m}
        got = {k: prof.kernel(KERNEL_SYMBOLS[k]) for k in want}
        over = {k: n for k, (_, n) in got.items() if n > want[k]}
        if over:
            raise AssertionError(f"profiler saw more launches than were "
                                 f"made: {over} of {want}")
        if all(n for _, n in got.values()):
            prof.got, prof.made = got, want
            return prof
    raise AssertionError(f"profiler recorded no launch of "
                         f"{[k for k, (_, n) in got.items() if not n]} in "
                         f"{tries} sessions ({want} made in the last)")


def replay_kernels(ouro, log_, start=0):
    """Replay recorded transactions on a fresh arena on the card, inputs
    staged first, the records before ``start`` outside the profiler.
    Returns {kind: ``per_call``'s tuple} of the profiled records, waves
    of both kinds under "defrag"."""
    dev = ouro.device
    staged = [(rec[0], [x.to(dev) for x in rec[1:4]], hint_kw(rec, dev))
              for rec in log_]

    def run(st, records):
        for kind, args, kw in records:
            if kind == "alloc":
                ouro.alloc(st, args[0], args[1], **kw)
            elif kind == "free":
                ouro.free(st, *args)
            else:
                migrate(ouro, st, *args)

    def session():
        st = ouro.init()
        run(st, staged[:start])
        with DeviceProfile(counted=True) as prof:
            run(st, staged[start:])
        return prof

    prof = profiled(session)
    kinds = {"defrag" if kind in WAVES else kind
             for kind, _, _ in staged[start:]}
    return {kind: per_call(prof, kind) for kind in kinds}


def time_plain_txns(ouro, log_, start=0):
    """The plain math on the card's tensors, each recorded transaction
    timed with CUDA events (it reads scalars back, so it syncs).
    Returns {kind: [ms, ...]} of the records from ``start`` on (waves of
    both kinds under "defrag")."""
    import torch
    from repro_torch.core import defrag, shards
    from repro_torch.core import transactions as T
    st = ouro.init()
    out = {"alloc": [], "free": [], "defrag": []}
    dev = st.mem.device
    S = ouro.num_shards
    base = (ouro.kind, ouro.family, st.mem, st.ctl)
    for i, rec in enumerate(log_):
        args = [x.to(dev) for x in rec[1:4]]
        a, b = _events()
        a.record()
        if rec[0] == "alloc" and S == 1:
            T.alloc_math(ouro.cfg, *base, args[0], args[1])
        elif rec[0] == "alloc":
            home = shards.home_shards(args[0].shape[0], S,
                                      hint_kw(rec, dev).get("shard_hint"),
                                      device=dev)
            T.sharded_alloc_math(ouro.cfg, S, *base, args[0], args[1], home,
                                 ouro.walk)
        elif rec[0] == "free" and S == 1:
            T.free_math(ouro.cfg, *base, *args)
        elif rec[0] == "free":
            T.sharded_free_math(ouro.cfg, S, *base, *args)
        elif S == 1:
            defrag.migrate_math(ouro.cfg, *base, *args)
        else:
            defrag.sharded_migrate_math(ouro.cfg, S, *base, *args)
        b.record()
        torch.cuda.synchronize()
        if i >= start:
            out["defrag" if rec[0] in WAVES else rec[0]].append(
                a.elapsed_time(b))
    return out


def reached_shards(ouro, rec, offs) -> int:
    """Shards whose ctl block a transaction needs: for an alloc, the
    shards that serve a selected lane of a valid size at some (attempt,
    shard) step of the walk (a lane served at attempt a_i is selected at
    attempts 0..a_i, an unserved one at every attempt); for a free, the
    shards that own a freed offset.  One arena counts as one shard when
    any such lane is selected."""
    import torch
    from repro_torch.core import shards
    from repro_torch.core.heap import size_to_class_device
    S = ouro.num_shards
    sizes, mask = rec[1:3] if rec[0] == "alloc" else rec[2:4]
    valid = size_to_class_device(ouro.cfg, sizes) < shard_lay(ouro).num_classes
    mask = mask & valid
    if S == 1:
        return int(bool(mask.any()))
    Ws = ouro.shard_cfg.total_words
    owner = torch.div(offs.long(), Ws, rounding_mode="floor")
    if rec[0] == "free":
        return int(torch.unique(owner[mask & (offs >= 0)]).numel())
    home = shards.home_shards(mask.shape[0], S,
                              hint_kw(rec).get("shard_hint"),
                              device="cpu").long()
    served_at = torch.where(offs >= 0, (owner - home) % S,
                            torch.full_like(home, ouro.walk))
    reached = set()
    for a in range(ouro.walk + 1):
        sel = mask & (served_at >= a)
        reached.update(((home[sel] + a) % S).tolist())
    return len(reached)


def page_reads(ouro, old_ctl, new_ctl, offs) -> int:
    """Words a page kind's alloc must read beyond its lanes and ctl
    block: each granted lane's queue value (a ring store slot, or a heap
    word) and, for va and vl, one directory slot or chain link for each
    segment the grants span.  0 for chunk kinds (their reads are the
    words they change)."""
    if ouro.kind != "page":
        return 0
    lay = shard_lay(ouro)
    words = int((offs >= 0).sum())
    if ouro.family == "ring":
        return words
    spc = ouro.shard_cfg.slots_per_segment(ouro.family)
    o = old_ctl.reshape(-1, lay.ctl_words).long()
    n = new_ctl.reshape(-1, lay.ctl_words).long()
    for row in range(o.shape[0]):
        for c in range(lay.num_classes):
            f0 = int(o[row, lay.off_front + c])
            k = int(n[row, lay.off_front + c]) - f0
            if k > 0:
                words += (f0 + k - 1) // spc - f0 // spc + 1
    return words


def txn_bound_ms(ouro_cpu, log_, start=0):
    """Per-transaction least time (bytes) of the records from ``start``
    on: lane inputs and outputs, the ctl blocks of the shards the
    transaction reaches read and written, every arena word it changed
    read and written once, and a page kind's gathered queue words
    (``page_reads``), at the device memory rate.  Waves in the log, and
    the records before ``start``, are applied, not bounded."""
    st = ouro_cpu.init()
    S = ouro_cpu.num_shards
    ctl_words = shard_lay(ouro_cpu).ctl_words
    out = {"alloc": [], "free": []}
    for i, rec in enumerate(log_):
        if rec[0] in WAVES:
            st = migrate(ouro_cpu, st, *rec[1:4])
            continue
        before, before_ctl = st.mem.clone(), st.ctl.clone()
        if rec[0] == "alloc":  # sizes + mask (+ homes) in, offsets out
            st, offs = ouro_cpu.alloc(st, rec[1], rec[2], **hint_kw(rec))
            lane = 9 if S == 1 else 13
        else:                  # offsets + sizes + mask in
            st = ouro_cpu.free(st, rec[1], rec[2], rec[3])
            offs, lane = rec[1], 9
        if i < start:
            continue
        changed = int((st.mem != before).sum())
        ctl = 8 * ctl_words * reached_shards(ouro_cpu, rec, offs)
        reads = page_reads(ouro_cpu, before_ctl, st.ctl, offs) \
            if rec[0] == "alloc" else 0
        nbytes = lane * rec[1].shape[0] + ctl + 8 * changed + 4 * reads
        out[rec[0]].append(nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def phase_serve(device, seed):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = get_arch("qwen2-0.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=device)
    eng = ServingEngine(model, params, max_batch=8, max_seq=512,
                        kv_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16, device=device)
    rec = RecordingOuroboros(eng.ouro)
    eng.ouro = rec
    counting = CountingModel(eng.model)
    eng.model = counting
    prompts = make_requests(cfg, seed, 16, 16, 448)
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    log(f"phase 5: qwen2-0.5b full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.padded_vocab}) bf16; set-up "
        f"{time.perf_counter() - t0:.1f} s; arena "
        f"{eng.stats['arena_mem_words']} words")

    chains()
    enqueues()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    took = chains()
    freed = enqueues()
    ticks = counting.decode_calls

    toks = sum(len(r.out_tokens) for r in done)
    st = dict(eng.stats)
    log(f"phase 5: served {len(done)} requests, {toks} tokens, "
        f"{st['steps']} steps, {counting.decode_calls} decode ticks in "
        f"{wall:.2f} s: {toks / wall:.1f} tok/s (prefill included)")
    log(f"phase 5: stats {json.dumps(st)}")
    log(f"phase 5: launches {json.dumps(launches)}")
    log(f"phase 5: the alloc kernels' chunk chains: {chain_text(took)}; "
        f"the free kernels' enqueues: {enqueue_text(freed)}")
    if len(done) != 16 or any(len(r.out_tokens) != 32 or not r.done
                              for r in done):
        raise AssertionError("not every request finished with 32 tokens")
    for r in done:
        if any(not (0 <= t < cfg.padded_vocab) for t in r.out_tokens):
            raise AssertionError(f"request {r.uid}: token out of range")
    if st["allocs"] != st["frees"] or st["alloc_failures"] != 0:
        raise AssertionError(f"allocs {st['allocs']} != frees "
                             f"{st['frees']} or failures")
    if not bool((eng.caches.kv.page_table == -1).all()):
        raise AssertionError("page table not all holes after draining")
    if launches["alloc_txn"] != st["alloc_txns"] \
            or launches["free_txn"] != st["free_txns"]:
        raise AssertionError(f"allocator launches {launches} != "
                             f"transactions {st['alloc_txns']}/"
                             f"{st['free_txns']}")
    if any(launches[k] for k in ("sharded_alloc_txn", "sharded_free_txn",
                                 "sharded_defrag_txn", "ssd_scan")):
        raise AssertionError(f"a single-arena dense engine launched a "
                             f"sharded or SSD kernel: {launches}")
    no_piecewise(launches, "the qwen2-0.5b serving run")
    want_pa = cfg.num_layers * counting.decode_calls
    if launches["paged_attention"] != want_pa:
        raise AssertionError(f"paged_attention launches "
                             f"{launches['paged_attention']} != "
                             f"{want_pa}")
    path = ("alloc_txn", "free_txn", "paged_attention")
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    # the recorded lanes, replayed through the plain math on the CPU
    from repro_torch.paged.kv_cache import make_kv_allocator
    cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu")
    st_cpu, e_off, _ = replay_plain(cpu_ouro, rec.log)
    bad = e_off[0]
    dm, _ = e_mem = word_err(eng.alloc_state.mem, st_cpu.mem)
    dc, _ = e_ctl = word_err(eng.alloc_state.ctl, st_cpu.ctl)
    if bad or dm or dc:
        raise AssertionError(f"plain replay of {len(rec.log)} transactions: "
                             f"{bad} offset mismatches, {dm} mem / {dc} ctl "
                             f"words differ")
    log(f"phase 5: plain replay of {len(rec.log)} transactions on the CPU: "
        f"offsets and final arena words identical")

    return dict(engine=eng, log=rec.log, prompts=prompts,
                launches=launches, tok_s=toks / wall, wall=wall,
                steps=st["steps"], decode_ticks=ticks,
                tokens={r.uid: r.out_tokens for r in done},
                replay_err=(e_off, e_mem, e_ctl))


PRESSURE = dict(num_pages=96, defrag_threshold=0.5)
COTENANT_LANES, COTENANT_BYTES = 16, 2048


def cotenant(eng):
    """A co-tenant of the engine's arena binds chunks to the 2048-B class
    and frees them: the chunks stay bound to that class, stranded for the
    engine's 256-B pages until a defrag wave unbinds them."""
    import torch
    dev = eng.device
    sizes = torch.full((COTENANT_LANES,), COTENANT_BYTES, dtype=torch.int32,
                       device=dev)
    eng.alloc_state, offs = eng.ouro.alloc(
        eng.alloc_state, sizes,
        torch.ones(COTENANT_LANES, dtype=torch.bool, device=dev))
    eng.alloc_state = eng.ouro.free(eng.alloc_state, offs, sizes, offs >= 0)
    return int((offs >= 0).sum())


FAILURE_STATS = ("alloc_failures", "defrag_waves", "auto_defrag_waves",
                 "pages_migrated", "evictions")


def phase_pressure(device, serve):
    """Phase 5's requests on an engine whose heap is too small for them:
    the allocation-failure path (defrag on failure and past the
    threshold, eviction) must fire, launch one ``defrag_txn`` per wave,
    and change no token."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import make_kv_allocator
    from repro_torch.serve.engine import ServingEngine

    base = serve["engine"]
    eng = ServingEngine(base.model._model, base.params, max_batch=8,
                        max_seq=512, kv_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16, device=device,
                        **PRESSURE)
    rec = RecordingOuroboros(eng.ouro)
    eng.ouro = rec
    counting = CountingModel(eng.model)
    eng.model = counting
    bound = cotenant(eng)
    for p in serve["prompts"]:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()

    chains()
    enqueues()
    rebuilds()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    took = chains()
    freed = enqueues()
    rebuilt = rebuilds()
    st = dict(eng.stats)
    toks = sum(len(r.out_tokens) for r in done)
    log(f"phase 5: under pressure ({PRESSURE}, co-tenant {bound} x "
        f"{COTENANT_BYTES} B): served {len(done)} requests, {toks} tokens, "
        f"{st['steps']} steps in {wall:.2f} s: {toks / wall:.1f} tok/s")
    log(f"phase 5: under pressure: stats {json.dumps(st)}")
    log(f"phase 5: under pressure: launches {json.dumps(launches)}")
    log(f"phase 5: under pressure: the alloc kernels' chunk chains: "
        f"{chain_text(took)}; the free kernels' enqueues: "
        f"{enqueue_text(freed)}; the waves' queue rebuilds: "
        f"{rebuild_text(rebuilt)}")
    if (rebuilt["parallel_rebuilds"] + rebuilt["serial_rebuilds"]
            != launches["defrag_txn"]):
        raise AssertionError(f"under pressure: the wave kernels counted "
                             f"{rebuilt} for {launches['defrag_txn']} waves")
    got = {r.uid: r.out_tokens for r in done}
    want = serve["tokens"]
    if sorted(got) != sorted(want):
        raise AssertionError(f"served uids {sorted(got)} != {sorted(want)}")
    for uid in sorted(want):
        a, b = got[uid], want[uid]
        if a != b:
            pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
            raise AssertionError(f"uid {uid}: tokens differ from the "
                                 f"unpressured run first at position {pos}")
    zero = [k for k in FAILURE_STATS if not st[k] > 0]
    if zero:
        raise AssertionError(f"the failure path did not fire: {zero} == 0")
    if st["allocs"] != st["frees"]:
        raise AssertionError(f"allocs {st['allocs']} != frees {st['frees']}")
    if not bool((eng.caches.kv.page_table == -1).all()):
        raise AssertionError("page table not all holes after draining")
    want_l = {"alloc_txn": st["alloc_txns"], "free_txn": st["free_txns"],
              "defrag_txn": st["defrag_waves"], "sharded_alloc_txn": 0,
              "sharded_free_txn": 0, "sharded_defrag_txn": 0,
              "paged_attention": eng.cfg.num_layers * counting.decode_calls,
              "ssd_scan": 0, **{k: 0 for k in PIECEWISE}}
    if launches != want_l:
        raise AssertionError(f"launches {launches} != the engine's counts "
                             f"{want_l}")

    cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu")
    st_cpu, e_off, bounds = replay_plain(cpu_ouro, rec.log)
    dm, _ = e_mem = word_err(eng.alloc_state.mem, st_cpu.mem)
    dc, _ = e_ctl = word_err(eng.alloc_state.ctl, st_cpu.ctl)
    if e_off[0] or dm or dc:
        raise AssertionError(f"plain replay of {len(rec.log)} records: "
                             f"{e_off[0]} offset or plan mismatches, {dm} "
                             f"mem / {dc} ctl words differ")
    n_waves = sum(r[0] == "defrag" for r in rec.log)
    log(f"phase 5: under pressure: plain replay of {len(rec.log)} records "
        f"({n_waves} defrag waves) on the CPU: offsets, plans and final "
        f"arena words identical; every uid's tokens equal the unpressured "
        f"run's")
    return dict(log=rec.log, launches=launches, stats=st, wall=wall,
                bounds=bounds, replay_err=(e_off, e_mem, e_ctl),
                ouro=rec._ouro)


def live_moves(eng):
    """Count, wave by wave, the pages a wave's forwarding moves that the
    engine's slots hold (their K/V words and int8 scales move with
    them)."""
    from repro_torch.paged.kv_cache import forwarding_page_map
    moved, forward = [], eng._apply_forwarding

    def counted(fwd):
        sp, _ = forwarding_page_map(
            fwd, eng.wpp, eng.ouro.cfg.words_per_chunk // eng.wpp)
        live = {p for pages in eng.slot_pages for p in pages}
        moved.append(len(live & set(sp[sp >= 0].tolist())))
        return forward(fwd)
    eng._apply_forwarding = counted
    return moved


def phase_qwen2_int8(device, serve):
    """Phase 5's requests on full-width qwen2-0.5b with int8 KV pages
    (the same bf16 weights): unpressured, then under phase 5's pressure
    (96 pages, the co-tenant, ``defrag_threshold`` 0.5), whose defrag
    waves must move pages the slots hold, with their scales, and whose
    tokens must equal the unpressured int8 run's; ``allocs == frees``,
    no page held and the launches equal to the engine's counts in both
    runs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServingEngine
    base = serve["engine"]
    model, params = base.model._model, base.params
    out = {}
    for name, kw in (("qwen2-0.5b int8", {}),
                     ("qwen2-0.5b int8 under pressure", PRESSURE)):
        eng = ServingEngine(model, params, max_batch=8, max_seq=512,
                            kv_dtype=torch.int8,
                            compute_dtype=torch.bfloat16, device=device,
                            **kw)
        counting = CountingModel(eng.model)
        eng.model = counting
        moved = live_moves(eng)
        bound = cotenant(eng) if kw else 0
        for p in serve["prompts"]:
            eng.submit(p, max_new_tokens=32)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        st = dict(eng.stats)
        toks = {r.uid: list(r.out_tokens) for r in done}
        n = sum(map(len, toks.values()))
        log(f"phase 5: {name} ({kw}"
            + (f", co-tenant {bound} x {COTENANT_BYTES} B" if kw else "")
            + f"): served {len(done)} requests, {n} tokens, {st['steps']} "
            f"steps in {wall:.2f} s: {n / wall:.1f} tok/s; K/V heaps "
            f"{eng.caches.kv.layers.k.dtype} with float32 scales "
            f"{tuple(eng.caches.kv.layers.k_scale.shape)}")
        log(f"phase 5: {name}: stats {json.dumps(st)}")
        log(f"phase 5: {name}: launches {json.dumps(launches)}; pages the "
            f"slots held moved by each wave {moved}")
        if len(done) != 16 or any(len(t) != 32 for t in toks.values()):
            raise AssertionError(f"{name}: not every request finished with "
                                 f"32 tokens")
        drained(eng, name)
        want = {k: 0 for k in launches}
        want.update(alloc_txn=st["alloc_txns"], free_txn=st["free_txns"],
                    defrag_txn=st["defrag_waves"],
                    paged_attention=eng.cfg.num_layers
                    * counting.decode_calls)
        if launches != want or not launches["paged_attention"]:
            raise AssertionError(f"{name}: launches {launches} != the "
                                 f"engine's counts {want}")
        if kw:
            zero = [k for k in FAILURE_STATS if not st[k] > 0]
            if zero or not sum(moved):
                raise AssertionError(f"{name}: the failure path did not "
                                     f"fire ({zero} == 0) or moved no page "
                                     f"a slot held ({moved})")
            if toks != out["qwen2-0.5b int8"]["tokens"]:
                raise AssertionError(f"{name}: tokens differ from the "
                                     f"unpressured int8 run's")
        else:
            same = sum(a == b for u, t in toks.items()
                       for a, b in zip(t, serve["tokens"][u]))
            log(f"phase 5: {name}: {same} of {n} tokens equal the bf16-page "
                f"run's (int8 pages change the attended values)")
        out[name] = dict(tokens=toks, launches=launches, stats=st, wall=wall,
                         tok_s=n / wall, moved=moved)
        del eng, counting
    log(f"phase 5: qwen2-0.5b int8 under pressure: its tokens equal the "
        f"unpressured int8 run's")
    torch.cuda.empty_cache()
    return out


def time_defrag_waves(ouro, waves, reps=5):
    """The wave (``defrag_txn``, or ``sharded_defrag_txn`` for a sharded
    arena: its extract and rebuild kernels) on recorded pre-wave arenas:
    (mean device ms a wave from ``torch.profiler``, summed over its
    kernels as ``per_call`` sums them, launches it recorded, launches the
    card counted, mean ms of the plain math on the card's tensors by CUDA
    events, each kernel's part as ``parts_text`` gives it).  Each wave
    starts from a copy of the pre-wave words."""
    import torch
    from repro_torch.core import defrag
    from repro_torch.core.shards import ShardedArena
    from repro_torch.core.arena import Arena
    cfg, S = ouro.cfg, ouro.num_shards
    mem, ctl = (torch.empty_like(t) for t in waves[0]["pre"])
    st = (Arena if S == 1 else ShardedArena)(mem, ctl)

    def session():
        with DeviceProfile(counted=True) as prof:
            for w in waves:
                for _ in range(reps):
                    mem.copy_(w["pre"][0])
                    ctl.copy_(w["pre"][1])
                    migrate(ouro, st, *w["plan"])
        return prof

    ms, n, made, _, text, _ = per_call(profiled(session), "defrag")
    plain = []
    for w in waves:
        mem.copy_(w["pre"][0])
        ctl.copy_(w["pre"][1])
        a, b = _events()
        a.record()
        if S == 1:
            defrag.migrate_math(cfg, ouro.kind, ouro.family, mem, ctl,
                                *w["plan"])
        else:
            defrag.sharded_migrate_math(cfg, S, ouro.kind, ouro.family, mem,
                                        ctl, *w["plan"])
        b.record()
        torch.cuda.synchronize()
        plain.append(a.elapsed_time(b))
    return ms, n, made, sum(plain) / len(plain), text


# ---------------------------------------------------------------------------
# phase 3 (sharded): the sharded kernels vs the plain replays
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_MODES = (("hashed", 12), ("hinted", 12), ("exhausting", 28))


def sharded_hint(rng, mode, lanes):
    """A sharded alloc's ``shard_hint``: hashed homes, per-lane arrays
    (negative and >= S values included), or every lane on shard 0."""
    import numpy as np
    if mode == "hashed":
        return None
    if mode == "hinted":
        return rng.integers(-SHARDS, 2 * SHARDS, lanes).astype(np.int32)
    return np.zeros(lanes, np.int32)


def walk_bins(ouro, ctl):
    """Served lanes per overflow-walk attempt, summed over shards."""
    lay = shard_lay(ouro)
    return ctl[:, lay.off_t_walk:lay.off_t_walk + SHARDS].sum(0).tolist()


def phase_sharded(device, seed=0):
    """``sharded_alloc_txn``/``sharded_free_txn``/``sharded_defrag_txn``
    against their plain versions run on a second arena on the card:
    seeded traces on the engine's 4-shard arena for 256 pages (hashed
    homes, per-lane hints, every lane homed on shard 0 until lanes are
    served at walk attempts 1-3), then sharded compaction and rebalance
    waves; then a 4096-lane trace and waves on the 4-shard arena for
    65536 pages against CPU copies.  Returns (per-transaction logs and
    pre-wave states for phase 6, the measured word errors)."""
    import numpy as np
    import torch
    from repro_torch.core import defrag, shards
    from repro_torch.core import transactions as T
    from repro_torch.paged.kv_cache import make_kv_allocator

    ouro, _, _ = make_kv_allocator(256, device=device, num_shards=SHARDS)
    cfg, S = ouro.cfg, SHARDS
    log(f"phase 3: sharded arena {S} x {ouro.layout.mem_words} mem words, "
        f"{S} x {ouro.shard_cfg.num_chunks} chunks, walk {ouro.walk}")
    errs = {k: {"words": 0, "max_abs": 0} for k in ("alloc", "free",
                                                   "defrag")}
    rng = np.random.default_rng(seed + 7)
    lanes = 16
    waves = []

    def check(kind, what, sk, sp, offs=None):
        torch.cuda.synchronize()
        e = [word_err(sk.mem, sp.mem), word_err(sk.ctl, sp.ctl)]
        if offs is not None:
            e.append(word_err(*offs))
        merge_err(errs[kind], *e)
        if any(n for n, _ in e):
            raise AssertionError(f"{what}: {e[0][0]} mem / {e[1][0]} ctl "
                                 f"words / {e[2][0] if offs else 0} offsets "
                                 f"differ from the plain version")

    for mode, n_ops in SHARD_MODES:
        sk, sp = ouro.init(), ouro.init()   # kernel / plain, both on card
        live = []
        for i in range(n_ops):
            if live and i % 4 == 3:
                k = min(len(live), int(rng.integers(1, lanes + 1)))
                pick = set(rng.choice(len(live), k, replace=False).tolist())
                drop = [x for j, x in enumerate(live) if j in pick]
                live = [x for j, x in enumerate(live) if j not in pick]
                fo = np.full(lanes, -1, np.int32)
                fs = np.zeros(lanes, np.int32)
                fo[:k] = [a for a, _ in drop]
                fs[:k] = [b for _, b in drop]
                perm = rng.permutation(lanes)
                fo_t = torch.from_numpy(fo[perm]).to(device)
                fs_t = torch.from_numpy(fs[perm]).to(device)
                ouro.free(sk, fo_t, fs_t, fo_t >= 0)
                T.sharded_free_math(cfg, S, "chunk", "vl", sp.mem, sp.ctl,
                                    fo_t, fs_t, fo_t >= 0)
                check("free", f"sharded free ({mode}, op {i})", sk, sp)
                continue
            sizes = torch.from_numpy(rng.choice(SIZE_MENU, lanes, p=SIZE_P)
                                     .astype(np.int32)).to(device)
            mask = torch.from_numpy(rng.random(lanes) < 0.9).to(device)
            hint = sharded_hint(rng, mode, lanes)
            hint_t = None if hint is None else torch.from_numpy(hint).to(
                device)
            _, offs_k = ouro.alloc(sk, sizes, mask, shard_hint=hint_t)
            home = shards.home_shards(lanes, S, hint_t, device=device)
            _, _, offs_p = T.sharded_alloc_math(cfg, S, "chunk", "vl",
                                                sp.mem, sp.ctl, sizes, mask,
                                                home, ouro.walk)
            check("alloc", f"sharded alloc ({mode}, op {i})", sk, sp,
                  (offs_k, offs_p))
            live += [(o, b) for o, b in zip(offs_p.tolist(),
                                            sizes.tolist()) if o >= 0]
        bins = walk_bins(ouro, sk.ctl)
        log(f"phase 3: sharded {mode}: {n_ops} transactions, 0 differing "
            f"words and offsets; lanes served per walk attempt {bins}")
        if mode == "exhausting" and not all(b > 0 for b in bins):
            raise AssertionError(f"the walk did not reach attempt 3: {bins}")
    # waves on the exhausted arena, compaction then rebalance; then two of
    # three live grants freed and both waves again
    for rnd in range(2):
        if rnd:
            drop = [x for j, x in enumerate(live) if j % 3]
            live = [x for j, x in enumerate(live) if not j % 3]
            for i in range(0, len(drop), lanes):
                fo = np.full(lanes, -1, np.int32)
                fs = np.zeros(lanes, np.int32)
                part = drop[i:i + lanes]
                fo[:len(part)] = [o for o, _ in part]
                fs[:len(part)] = [b for _, b in part]
                fo_t = torch.from_numpy(fo).to(device)
                fs_t = torch.from_numpy(fs).to(device)
                ouro.free(sk, fo_t, fs_t, fo_t >= 0)
                T.sharded_free_math(cfg, S, "chunk", "vl", sp.mem, sp.ctl,
                                    fo_t, fs_t, fo_t >= 0)
                check("free", "sharded free before waves", sk, sp)
        for kind in WAVES:
            pre = (sk.mem.clone(), sk.ctl.clone())
            plan_k = plan_of(ouro, sk, kind, ouro._moves(None))
            plan_p = plan_of(ouro, sp, kind, ouro._moves(None))
            for a, b in zip(plan_k, plan_p):
                merge_err(errs["defrag"], word_err(a, b))
            live_w = shards.shard_live_words(cfg, S, "chunk", "vl", sk.mem,
                                             sk.ctl).tolist()
            before = sp.mem.clone()
            rebuilds()
            migrate(ouro, sk, *plan_k)
            rebuilt = rebuilds()
            defrag.sharded_migrate_math(cfg, S, "chunk", "vl", sp.mem,
                                        sp.ctl, *plan_p)
            check("defrag", f"sharded {kind} wave {rnd}", sk, sp)
            moves = int((plan_p[0] >= 0).sum())
            live_after = shards.shard_live_words(cfg, S, "chunk", "vl",
                                                 sp.mem, sp.ctl).tolist()
            log(f"phase 3: sharded {kind} wave {rnd}: {moves} moves, plan "
                f"identical, 0 differing words; live words per shard "
                f"{live_w} -> {live_after}; {rebuild_text(rebuilt)}")
            waves.append(dict(kind=kind, moves=moves, pre=pre, plan=plan_k,
                              bound=defrag_bound_ms(
                                  shard_lay(ouro), before.cpu(),
                                  sp.mem.cpu(), plan_p[0].cpu(),
                                  plan_p[2].cpu())))
            held = defrag.forward_offsets(
                defrag.Forwarding(*plan_p),
                torch.tensor([o for o, _ in live], dtype=torch.int32,
                             device=device))
            live = [(o, b) for o, (_, b) in zip(held.tolist(), live)]
    for kind in WAVES:
        if not sum(w["moves"] for w in waves if w["kind"] == kind):
            raise AssertionError(f"no sharded {kind} wave moved a page")

    # the 4-shard arena for 65536 pages: a 4096-lane trace against CPU
    # copies, then churn on the card and a compaction and a rebalance wave
    big, _, _ = make_kv_allocator(65536, device=device, num_shards=S)
    big_cpu, _, _ = make_kv_allocator(65536, device="cpu", num_shards=S)
    sk, sc = big.init(), big_cpu.init()
    big_log, live = [], []
    for op in alloc_trace(rng, 6, 4096):
        if op[0] == "alloc":
            sizes, mask = torch.from_numpy(op[1]), torch.from_numpy(op[2])
            sc, oc = big_cpu.alloc(sc, sizes, mask)
            _, ok_ = big.alloc(sk, sizes.to(device), mask.to(device))
            check("alloc", "sharded alloc, 65536 pages", sk, sc, (ok_, oc))
            big_log.append(("alloc", sizes, mask, oc, None))
            live += [(o, b) for o, b in zip(oc.tolist(), op[1].tolist())
                     if o >= 0]
        else:
            k = min(op[1], len(live))
            fo = np.full(4096, -1, np.int32)
            fs = np.zeros(4096, np.int32)
            fo[:k] = [o for o, _ in live[:k]]
            fs[:k] = [b for _, b in live[:k]]
            live = live[k:]
            fo_t, fs_t = torch.from_numpy(fo), torch.from_numpy(fs)
            sc = big_cpu.free(sc, fo_t, fs_t, fo_t >= 0)
            big.free(sk, fo_t.to(device), fs_t.to(device),
                     (fo_t >= 0).to(device))
            check("free", "sharded free, 65536 pages", sk, sc)
            big_log.append(("free", fo_t, fs_t, fo_t >= 0))
    log(f"phase 3: sharded 65536 pages ({S} x {big.shard_cfg.num_chunks} "
        f"chunks), 4096 lanes: {len(big_log)} transactions, 0 differing "
        f"words and offsets")
    big_waves = []
    sk = churn(big, big.init(), rng, 4096, 256, until_full=True)
    for kind in WAVES:
        sc = type(sk)(sk.mem.cpu(), sk.ctl.cpu())
        pre = (sk.mem.clone(), sk.ctl.clone())
        plan_k = plan_of(big, sk, kind, big._moves(None))
        plan_c = plan_of(big_cpu, sc, kind, big._moves(None))
        for a, b in zip(plan_k, plan_c):
            merge_err(errs["defrag"], word_err(a, b))
        before = sc.mem.clone()
        rebuilds()
        migrate(big, sk, *plan_k)
        rebuilt = rebuilds()
        migrate(big_cpu, sc, *plan_c)
        check("defrag", f"sharded {kind} wave, 65536 pages", sk, sc)
        moves = int((plan_c[0] >= 0).sum())
        log(f"phase 3: sharded {kind} wave, 65536 pages: {moves} moves, "
            f"plan identical, 0 differing words; {rebuild_text(rebuilt)}")
        if not moves:
            raise AssertionError(f"the 65536-page {kind} wave moved nothing")
        big_waves.append(dict(kind=kind, moves=moves, pre=pre, plan=plan_k,
                              bound=defrag_bound_ms(shard_lay(big), before,
                                                    sc.mem, plan_c[0],
                                                    plan_c[2])))
    for kind, e in errs.items():
        log(f"phase 3: sharded {kind}: {e['words']} differing words in all")
    return dict(waves=waves, big_log=big_log, big_waves=big_waves), errs


# ---------------------------------------------------------------------------
# phase 5 (sharded): serve the same requests through num_shards=4
# ---------------------------------------------------------------------------

HOLDER_PAGES = 128
SHARDED_RUNS = (
    # the reference sizing (4 shards x 12 chunks); a threshold that fires
    ("rebalance", dict(num_pages=256, num_shards=SHARDS,
                       rebalance_threshold=8), False, ("rebalance_waves",)),
    # phase 5's pressure settings gave no failed grant at 4 shards (96
    # pages: 4 x 10 chunks), nor did 16 or 64 pages with the co-tenant
    # alone (no eviction); a second co-tenant holding 128 x 256-B pages
    # live for the whole run makes every counter fire
    ("pressure", dict(num_pages=16, num_shards=SHARDS, defrag_threshold=0.5),
     True, ("alloc_failures", "alloc_overflows", "defrag_waves",
            "evictions")),
)


def holder(eng, n=HOLDER_PAGES):
    """A co-tenant that takes ``n`` 256-B pages (hashed homes) and holds
    them for the whole run."""
    import torch
    dev = eng.device
    sizes = torch.full((n,), 256, dtype=torch.int32, device=dev)
    eng.alloc_state, offs = eng.ouro.alloc(
        eng.alloc_state, sizes, torch.ones(n, dtype=torch.bool, device=dev))
    return int((offs >= 0).sum())


def phase_sharded_serve(device, serve):
    """Phase 5's requests through ``ServingEngine(num_shards=4)``: with
    rebalance waves, and under pressure (overflows, failed grants,
    sharded defrag waves, evictions).  Every uid's tokens equal phase
    5's; launches equal the engine's counts; the recorded log replayed
    through the plain math on the CPU ends on the engine's words."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import make_kv_allocator
    from repro_torch.serve.engine import ServingEngine

    base = serve["engine"]
    out = {}
    for name, kw, pressured, must in SHARDED_RUNS:
        eng = ServingEngine(base.model._model, base.params, max_batch=8,
                            max_seq=512, kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device=device,
                            **kw)
        rec = RecordingOuroboros(eng.ouro)
        eng.ouro = rec
        counting = CountingModel(eng.model)
        eng.model = counting
        held = (cotenant(eng), holder(eng)) if pressured else None
        start = len(rec.log)  # the engine's own records begin here
        for p in serve["prompts"]:
            eng.submit(p, max_new_tokens=32)
        bins0 = walk_bins(eng.ouro, eng.alloc_state.ctl)
        torch.cuda.synchronize()

        chains()
        enqueues()
        rebuilds()
        shard_steps()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        took = chains()
        freed = enqueues()
        rebuilt = rebuilds()
        steps = shard_steps()
        st = dict(eng.stats)
        bins = [b - a for a, b in zip(bins0, walk_bins(eng.ouro,
                                                       eng.alloc_state.ctl))]
        toks = sum(len(r.out_tokens) for r in done)
        log(f"phase 5: sharded {name} ({kw}"
            + (f", co-tenants {held[0]} x {COTENANT_BYTES} B freed and "
               f"{held[1]} x 256 B held" if held else "")
            + f"): served {len(done)} requests, {toks} tokens, "
            f"{st['steps']} steps in {wall:.2f} s: {toks / wall:.1f} tok/s")
        log(f"phase 5: sharded {name}: stats {json.dumps(st)}")
        log(f"phase 5: sharded {name}: launches {json.dumps(launches)}; "
            f"lanes served per walk attempt in the run {bins}")
        log(f"phase 5: sharded {name}: the alloc kernels' chunk chains: "
            f"{chain_text(took)}; the free kernels' enqueues: "
            f"{enqueue_text(freed)}; the sharded alloc's steps: "
            f"{shard_text(steps)}; the waves' queue rebuilds: "
            f"{rebuild_text(rebuilt)}")
        if steps["transactions"] != launches["sharded_alloc_txn"] or (
                rebuilt["parallel_rebuilds"] + rebuilt["serial_rebuilds"]
                != SHARDS * launches["sharded_defrag_txn"]):
            raise AssertionError(f"sharded {name}: the kernels counted "
                                 f"{steps} and {rebuilt} for launches "
                                 f"{launches}")
        got = {r.uid: r.out_tokens for r in done}
        want = serve["tokens"]
        if sorted(got) != sorted(want):
            raise AssertionError(f"sharded {name}: served uids "
                                 f"{sorted(got)} != {sorted(want)}")
        for uid in sorted(want):
            if got[uid] != want[uid]:
                raise AssertionError(f"sharded {name}: uid {uid}'s tokens "
                                     f"differ from phase 5's")
        zero = [k for k in must if not st[k] > 0]
        if pressured and not sum(bins[1:]) > 0:
            zero.append("walk bins > 0")
        if zero:
            raise AssertionError(f"sharded {name}: counters at 0: {zero}")
        if st["allocs"] != st["frees"] or any(st["shard_pages_live"]):
            raise AssertionError(f"sharded {name}: allocs {st['allocs']}, "
                                 f"frees {st['frees']}, live pages per "
                                 f"shard {st['shard_pages_live']}")
        if not bool((eng.caches.kv.page_table == -1).all()):
            raise AssertionError("page table not all holes after draining")
        want_l = {"alloc_txn": 0, "free_txn": 0, "defrag_txn": 0,
                  "sharded_alloc_txn": st["alloc_txns"],
                  "sharded_free_txn": st["free_txns"],
                  "sharded_defrag_txn": st["defrag_waves"]
                  + st["rebalance_waves"],
                  "paged_attention": eng.cfg.num_layers
                  * counting.decode_calls, "ssd_scan": 0,
                  **{k: 0 for k in PIECEWISE}}
        if launches != want_l:
            raise AssertionError(f"sharded {name}: launches {launches} != "
                                 f"the engine's counts {want_l}")
        cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu",
                                           num_shards=SHARDS)
        st_cpu, e_off, bounds = replay_plain(cpu_ouro, rec.log)
        dm, _ = e_mem = word_err(eng.alloc_state.mem, st_cpu.mem)
        dc, _ = e_ctl = word_err(eng.alloc_state.ctl, st_cpu.ctl)
        n_waves = sum(r[0] in WAVES for r in rec.log)
        log(f"phase 5: sharded {name}: plain replay of {len(rec.log)} "
            f"records ({n_waves} waves) on the CPU: {e_off[0]} differing "
            f"offsets and plan words, {dm} mem / {dc} ctl words differ")
        if e_off[0] or dm or dc:
            raise AssertionError(f"sharded {name}: the plain replay differs")
        out[name] = dict(log=rec.log, start=start, launches=launches,
                         stats=st, wall=wall,
                         bounds=bounds, replay_err=(e_off, e_mem, e_ctl),
                         ouro=rec._ouro, tok_s=toks / wall,
                         num_pages=eng.num_pages)
    return out


def phase_timing(device, serve, alloc_logs, pressure, waves):
    """Kernel times on the device from ``torch.profiler``, taken after
    the serving runs so that the profiler's hooks cannot slow them: the
    allocator and defrag kernels on the engines' recorded transactions
    and waves and on the phase-3 traces and arenas, the plain math at the
    engines' inputs, and where the serving run's device time went."""
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import make_kv_allocator
    eng = serve["engine"]
    dev_ouro = eng.ouro._ouro
    cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu")
    k_times = replay_kernels(dev_ouro, serve["log"])
    p_times = time_plain_txns(dev_ouro, serve["log"])
    bounds = txn_bound_ms(cpu_ouro, serve["log"])
    for kind in ("alloc", "free"):
        ms, n, want = k_times[kind][:3]
        log(f"phase 6: {kind}_txn at the engine's inputs: kernel "
            f"{1e3 * ms:.2f} us (profiler device time, {n} of {want} "
            f"launches recorded), plain math on the card "
            f"{1e3 * sum(p_times[kind]) / len(p_times[kind]):.1f} us, "
            f"bound {1e6 * sum(bounds[kind]) / len(bounds[kind]):.3f} ns")
    big_ouro, _, _ = make_kv_allocator(65536, device=device)
    for lanes, log_ in sorted(alloc_logs.items()):
        t = replay_kernels(big_ouro, log_)
        log(f"phase 6: phase-3 trace, lanes {lanes}: " + ", ".join(
            f"{kind}_txn {1e3 * t[kind][0]:.1f} us ({t[kind][1]} of "
            f"{t[kind][2]} launches recorded)" for kind in ("alloc", "free"))
            + " per transaction, profiler device time")

    # defrag_txn at the pressure engine's waves (replayed with its
    # transactions, so each wave sees the words it saw) and on the
    # phase-3 arenas
    d_ouro = pressure["ouro"]
    t = replay_kernels(d_ouro, pressure["log"])
    dp = time_plain_txns(d_ouro, pressure["log"])["defrag"]
    dk = dict(ms=t["defrag"][0], plain=sum(dp) / len(dp),
              bound=sum(pressure["bounds"]) / len(pressure["bounds"]))
    log(f"phase 6: defrag_txn at the engine's waves: kernel "
        f"{1e3 * dk['ms']:.2f} us (profiler device time, {t['defrag'][1]} of "
        f"{t['defrag'][2]} launches recorded), plain migrate_math on the card "
        f"{1e3 * dk['plain']:.1f} us, bound {1e6 * dk['bound']:.3f} ns")
    for n_pages, ws in sorted(waves.items()):
        ouro, _, _ = make_kv_allocator(n_pages, device=device)
        ms, n, made, plain, _ = time_defrag_waves(ouro, ws)
        bound = sum(w["bound"] for w in ws) / len(ws)
        log(f"phase 6: defrag_txn, phase-3 arena of {n_pages} pages "
            f"({ouro.cfg.num_chunks} chunks, M {ws[0]['plan'][0].shape[0]}): "
            f"kernel {1e3 * ms:.1f} us per wave ({n} of {made} launches "
            f"recorded), plain migrate_math on the card {1e3 * plain:.1f} "
            f"us, bound {1e6 * bound:.2f} ns")
        dk[n_pages] = dict(ms=ms, plain=plain, bound=bound)

    # where the serving run's device time went: the same traffic again
    # under the profiler (its wall is the profiler's, not the server's)
    eng.ouro = dev_ouro
    eng.alloc_state = eng.ouro.init()
    for p in serve["prompts"]:
        eng.submit(p, max_new_tokens=32)
    ops.reset_launches()
    with DeviceProfile() as prof:
        eng.run_until_done()
    calls = ops.LAUNCHES["paged_attention"]
    busy = prof.busy_ms()
    wall = 1e3 * serve["wall"]
    log(f"phase 6: serving device busy {busy:.0f} ms of the unprofiled "
        f"run's {wall:.0f} ms wall: device idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for key, us, n in prof.rows[:8]:
        log(f"phase 6:   {us / 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    # each kernel's mean over the launches the profiler kept, times the
    # rerun's calls: a dropped record does not shrink the total, and a
    # kernel with none recorded leaves it unmeasured
    got = [prof.kernel(KERNEL_SYMBOLS[k]) for k in ATTN_KERNELS]
    recorded = ", ".join(str(n) for _, n in got)
    if all(n for _, n in got):
        attn = calls * sum(ms for ms, _ in got)
        log(f"phase 6: paged_attention in that rerun: {attn:.2f} ms of "
            f"device time ({calls} calls x the per-launch means of its "
            f"scores, values and merge kernels, launches recorded: "
            f"{recorded})")
    else:
        attn = None
        log(f"phase 6: paged_attention in that rerun: not measured (a "
            f"kernel had no launch recorded; scores, values, merge: "
            f"{recorded} of {calls})")
    attention_in_serving(eng, serve)
    return dict(k_times=k_times, p_times=p_times, bounds=bounds, defrag=dk,
                attention=attn, busy=busy)


def attention_in_serving(eng, serve, every=8, atol=1e-5):
    """``paged_attention`` against its plain version at the serving
    run's own inputs (model-sized scores and values, not phase 4's unit
    normals): the same traffic again on the engine, every ``every``-th
    call held to the plain version on the card within ``atol``; the
    rerun's tokens must equal the timed run's."""
    from repro_torch.kernels import ops, ref
    kernel, calls, worst = ops.paged_attention, [0, 0], [0.0]

    def checked(q, k, v, table, seq, **kw):
        out = kernel(q, k, v, table, seq, **kw)
        if calls[0] % every == 0:
            want = ref.paged_attention(q, k, v, table, seq, **kw)
            worst[0] = max(worst[0], float((out - want).abs().max()))
            calls[1] += 1
        calls[0] += 1
        return out

    t0 = time.perf_counter()
    ops.paged_attention = checked
    try:
        eng.alloc_state = eng.ouro.init()
        for p in serve["prompts"]:
            eng.submit(p, max_new_tokens=32)
        done = eng.run_until_done()
    finally:
        ops.paged_attention = kernel
    if not worst[0] <= atol:
        raise AssertionError(f"paged_attention at the serving run's inputs: "
                             f"max error {worst[0]} > {atol}")
    if sorted(r.out_tokens for r in done) != sorted(
            serve["tokens"].values()):
        raise AssertionError("the checked rerun's tokens differ from the "
                             "timed run's")
    log(f"phase 6: paged_attention at the serving run's inputs: {calls[1]} "
        f"of {calls[0]} calls held to the plain version on the card, max "
        f"error {worst[0]:.3g} (atol {atol}); the rerun's tokens equal the "
        f"timed run's ({time.perf_counter() - t0:.1f} s for this check)")


def phase_sharded_timing(device, sh3, runs):
    """The sharded kernels' device times from ``torch.profiler``: at the
    pressure run's recorded transactions and waves (and the rebalance
    run's waves), and at the 4-shard arena for 65536 pages; the plain
    versions on the card's tensors and the byte bounds beside them."""
    from repro_torch.paged.kv_cache import make_kv_allocator
    res = {}
    pr = runs["pressure"]
    cpu_ouro, _, _ = make_kv_allocator(pr["num_pages"], device="cpu",
                                       num_shards=SHARDS)
    k_times = replay_kernels(pr["ouro"], pr["log"], pr["start"])
    p_times = time_plain_txns(pr["ouro"], pr["log"], pr["start"])
    bounds = txn_bound_ms(cpu_ouro, pr["log"], pr["start"])
    bounds["defrag"] = pr["bounds"]
    for kind in ("alloc", "free", "defrag"):
        ms, n, want = k_times[kind][:3]
        res[kind] = dict(ms=ms, plain=sum(p_times[kind]) / len(p_times[kind]),
                         bound=sum(bounds[kind]) / len(bounds[kind]))
        calls = k_times[kind][3]
        res[kind]["run_ms"] = ms * calls
        log(f"phase 6: {kernel_of(pr['ouro'], kind)} at the pressure "
            f"engine's inputs: kernel {1e3 * ms:.2f} us a call (profiler "
            f"device time summed over a call's kernels, {n} of {want} "
            f"launches recorded), {ms * calls:.3f} ms over the run's {calls} "
            f"calls; plain math on the card "
            f"{1e3 * res[kind]['plain']:.1f} us, bound "
            f"{1e6 * res[kind]['bound']:.3f} ns")
    rb = runs["rebalance"]
    t = replay_kernels(rb["ouro"], rb["log"], rb["start"])
    res["rebalance_waves"] = dict(ms=t["defrag"][0],
                                  bound=sum(rb["bounds"]) / len(rb["bounds"]),
                                  run_ms=t["defrag"][0] * t["defrag"][3])
    res["rebalance_alloc"] = dict(ms=t["alloc"][0],
                                  run_ms=t["alloc"][0] * t["alloc"][3])
    log(f"phase 6: sharded_defrag_txn at the rebalance engine's waves: "
        f"kernel {1e3 * t['defrag'][0]:.2f} us a wave ({t['defrag'][1]} of "
        f"{t['defrag'][2]} launches recorded), "
        f"{res['rebalance_waves']['run_ms']:.3f} ms over the run's "
        f"{t['defrag'][3]} waves, bound "
        f"{1e6 * res['rebalance_waves']['bound']:.3f} ns")
    log(f"phase 6: sharded_alloc_txn at the rebalance engine's inputs: "
        f"kernel {1e3 * t['alloc'][0]:.2f} us a call ({t['alloc'][1]} of "
        f"{t['alloc'][2]} launches recorded), "
        f"{res['rebalance_alloc']['run_ms']:.3f} ms over the run's "
        f"{t['alloc'][3]} calls")
    small, _, _ = make_kv_allocator(256, device=device, num_shards=SHARDS)
    ms, n, made, plain, _ = time_defrag_waves(small, sh3["waves"])
    log(f"phase 6: sharded_defrag_txn, phase-3 waves on the 256-page "
        f"4-shard arena: kernel {1e3 * ms:.1f} us per wave ({n} of {made} "
        f"launches recorded), plain on the card {1e3 * plain:.1f} us")

    big, _, _ = make_kv_allocator(65536, device=device, num_shards=SHARDS)
    big_cpu, _, _ = make_kv_allocator(65536, device="cpu", num_shards=SHARDS)
    t = replay_kernels(big, sh3["big_log"])
    p = time_plain_txns(big, sh3["big_log"])
    b = txn_bound_ms(big_cpu, sh3["big_log"])
    for kind in ("alloc", "free"):
        res[kind][65536] = dict(ms=t[kind][0],
                                plain=sum(p[kind]) / len(p[kind]),
                                bound=sum(b[kind]) / len(b[kind]))
        log(f"phase 6: {kernel_of(big, kind)}, 65536 pages, 4096 lanes: "
            f"kernel {1e3 * t[kind][0]:.1f} us a call ({t[kind][4]}; "
            f"{t[kind][1]} of "
            f"{t[kind][2]} launches recorded), plain on the card "
            f"{1e3 * res[kind][65536]['plain']:.1f} us, bound "
            f"{1e6 * res[kind][65536]['bound']:.2f} ns")
    ms, n, made, plain, parts = time_defrag_waves(big, sh3["big_waves"])
    bound = sum(w["bound"] for w in sh3["big_waves"]) / len(sh3["big_waves"])
    res["defrag"][65536] = dict(ms=ms, plain=plain, bound=bound)
    log(f"phase 6: sharded_defrag_txn, 65536 pages ({SHARDS} x "
        f"{big.shard_cfg.num_chunks} chunks, M {big._moves(None)}): kernel "
        f"{1e3 * ms:.1f} us per wave ({parts}; {n} of "
        f"{made} launches recorded), "
        f"plain on the card {1e3 * plain:.1f} us, bound {1e6 * bound:.2f} ns")
    return res


def phase_small_model(device, seed):
    """A float32 smoke-size model served on the card and on the CPU from
    the same weights, first unpressured, then under phase 5's memory
    pressure: identical tokens, stats and final arena words."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = get_arch("qwen2-0.5b").smoke()
    model = build_model(cfg)
    params = model.init(seed, device="cpu")
    ops.reset_launches()
    runs = (("unpressured", dict(max_batch=2, max_seq=96),
             make_requests(cfg, seed + 1, 5, 4, 40), 6),
            ("under pressure", dict(max_batch=8, max_seq=512, **PRESSURE),
             make_requests(cfg, seed, 16, 16, 448), 32))
    for name, kw, prompts, max_new in runs:
        outs = []
        for dev in (device, "cpu"):
            p_dev = {"embed": params["embed"].to(dev),
                     "final_norm": {k: v.to(dev) for k, v in
                                    params["final_norm"].items()},
                     "blocks": [{g: {n: w.to(dev) for n, w in leaves.items()}
                                 for g, leaves in b.items()}
                                for b in params["blocks"]]}
            eng = ServingEngine(model, p_dev, kv_dtype=torch.float32,
                                compute_dtype=torch.float32, device=dev, **kw)
            if "defrag_threshold" in kw:
                cotenant(eng)
            for p in prompts:
                eng.submit(p, max_new_tokens=max_new)
            toks = {r.uid: r.out_tokens for r in eng.run_until_done()}
            outs.append((toks, eng.alloc_state.mem.cpu(),
                         eng.alloc_state.ctl.cpu(), dict(eng.stats)))
        (tg, mg, cg, sg), (tc, mc, cc, sc) = outs
        if tg != tc:
            bad = [u for u in tg if tg[u] != tc.get(u)]
            raise AssertionError(f"float32 smoke model {name}: card tokens "
                                 f"differ from the CPU's for uids {bad}")
        if not (torch.equal(mg, mc) and torch.equal(cg, cc)):
            raise AssertionError(f"float32 smoke model {name}: arena words "
                                 f"differ")
        if sg != sc:
            raise AssertionError(f"float32 smoke model {name}: stats {sg} != "
                                 f"{sc}")
        no_piecewise(ops.LAUNCHES, f"the float32 smoke model {name}")
        fired = {k: sg[k] for k in FAILURE_STATS if k in sg}
        log(f"phase 5: float32 smoke model {name} on the card and the CPU: "
            f"{len(tg)} requests, identical tokens, stats and arena words"
            + (f"; {fired}" if "defrag_threshold" in kw else ""))


# ---------------------------------------------------------------------------
# the ssm slice: 298,656-lane transactions, ssd_scan, serving mamba2-780m
# ---------------------------------------------------------------------------

MAMBA = "mamba2-780m"


def aux_geometry():
    """mamba2-780m's aux pages per slot, and the serving engine's page
    count for max_batch 8 (256 KV-page budget + 8 slots' aux pages)."""
    from repro_torch.configs import get_arch
    from repro_torch.paged.kv_cache import modality_page_quota
    aux = modality_page_quota(get_arch(MAMBA))
    return aux, 256 + 8 * aux


def phase_aux_pairs(device, reps=10):
    """One admission's and one retirement's lanes of full-width
    mamba2-780m (298,656 256-B pages) on the engine's arena, single and
    4-shard: the kernels (lane tables in the device workspace) against
    the plain math, word for word (single: on a second arena on the
    card, its words after the grant kept for phase 5; 4-shard: on CPU
    copies, the faster host for the plain chain); then the kernels'
    device times (``torch.profiler``, each alloc from a fresh arena, each
    free of that alloc's grant), the plain versions' times and the byte
    bounds."""
    import torch
    from repro_torch.core import shards
    from repro_torch.core import transactions as T
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator

    n, n_pages = aux_geometry()
    res = {}
    for S in (1, SHARDS):
        o, _, _ = make_kv_allocator(n_pages, device=device, num_shards=S)
        lay = shard_lay(o)
        desc = AT.descriptor(lay)
        lib = AT._lib()
        ws = ((lib.alloc_txn_workspace_bytes(desc, n, AT.TABLE_SMEM_LIMIT)
               if S == 1 else lib.sharded_alloc_txn_workspace_bytes(
                   desc, n, AT.TABLE_SMEM_LIMIT)),
              lib.free_txn_workspace_bytes(desc, n, S, AT.TABLE_SMEM_LIMIT))
        if not all(ws):
            raise AssertionError(f"{n} lanes fit in shared memory: {ws}")
        pdev = device if S == 1 else "cpu"
        sk = o.init()
        sp = (o if S == 1 else make_kv_allocator(
            n_pages, device="cpu", num_shards=S)[0]).init()
        fresh = (sk.mem.clone(), sk.ctl.clone())
        sizes = torch.full((n,), 256, dtype=torch.int32, device=device)
        mask = torch.ones(n, dtype=torch.bool, device=device)
        psz, pmask = sizes.to(pdev), mask.to(pdev)
        base = (o.kind, o.family, sp.mem, sp.ctl)
        chains()
        shard_steps()
        _, offs = o.alloc(sk, sizes, mask)
        took = chains()
        steps = shard_steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if S == 1:
            want = T.alloc_math(o.cfg, *base, psz, pmask)[2]
        else:
            home = shards.home_shards(n, S, None, device=pdev)
            want = T.sharded_alloc_math(o.cfg, S, *base, psz, pmask, home,
                                        o.walk)[2]
        torch.cuda.synchronize()
        plain_alloc = 1e3 * (time.perf_counter() - t0)
        err = {"words": 0, "max_abs": 0}
        merge_err(err, word_err(offs, want), word_err(sk.mem, sp.mem),
                  word_err(sk.ctl, sp.ctl))
        if err["words"] or not bool((want >= 0).all()):
            raise AssertionError(f"{n}-lane alloc, {S} shard(s): "
                                 f"{err['words']} differing words")
        granted = (sk.mem.clone(), sk.ctl.clone())
        if S == 1:
            res["grant"] = dict(fresh=fresh, offs=want, mem=granted[0],
                                ctl=granted[1])
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
        fo = offs[perm.to(device)].contiguous()
        revived = revived_by(o, sk.mem, fo)
        enqueues()
        o.free(sk, fo, sizes, mask)
        freed = enqueues()
        if freed != dict(parallel_enqueues=S, parallel_values=revived,
                         serial_enqueues=0, serial_values=0):
            raise AssertionError(f"{n}-lane free, {S} shard(s): the "
                                 f"enqueue of {revived} revived chunks "
                                 f"took {freed}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if S == 1:
            T.free_math(o.cfg, *base, fo, psz, pmask)
        else:
            T.sharded_free_math(o.cfg, S, *base, fo.cpu(), psz, pmask)
        torch.cuda.synchronize()
        plain_free = 1e3 * (time.perf_counter() - t0)
        merge_err(err, word_err(sk.mem, sp.mem), word_err(sk.ctl, sp.ctl))
        if err["words"]:
            raise AssertionError(f"{n}-lane free, {S} shard(s): "
                                 f"{err['words']} differing words")

        def session():
            with DeviceProfile(counted=True) as prof:
                for _ in range(reps):
                    sk.mem.copy_(fresh[0])
                    sk.ctl.copy_(fresh[1])
                    o.alloc(sk, sizes, mask)
                    o.free(sk, fo, sizes, mask)
            return prof

        # each call's kernels as the card counted them: the alloc's one
        # block or its partition and attempt launches; the free's two
        # grid lane passes, then its block(s)
        prof = profiled(session)
        pa, pf = per_call(prof, "alloc"), per_call(prof, "free")
        alloc_ms, free_ms = pa[0], pf[0]
        # bytes: lanes in and out, the ctl blocks, every changed word
        # read and written once
        ctl = 8 * lay.ctl_words * S
        chg_a = int((granted[0] != fresh[0]).sum())
        chg_f = int((sk.mem != granted[0]).sum())
        bound_a = (9 * n + (4 * n if S > 1 else 0) + ctl + 8 * chg_a) \
            / HBM_BYTES_PER_S * 1e3
        bound_f = (9 * n + ctl + 8 * chg_f) / HBM_BYTES_PER_S * 1e3
        res[S] = dict(alloc=dict(ms=alloc_ms, plain=plain_alloc,
                                 bound=bound_a, steps=steps,
                                 launches=pa[5]),
                      free=dict(ms=free_ms, plain=plain_free,
                                bound=bound_f, enqueue=freed), err=err,
                      plain_on=pdev)
        pre = "sharded_" if S > 1 else ""
        log(f"phase 3: {n} lanes ({S} shard(s), {o.cfg.num_chunks} chunks, "
            f"workspace {ws[0]} / {ws[1]} B): alloc and free, 0 differing "
            f"words and offsets; {pre}alloc_txn {alloc_ms:.3f} ms a call "
            f"({pa[4]}), {pre}free_txn {free_ms:.3f} ms a call ({pf[4]}; "
            f"profiler device time; launches as the card counted them); "
            + (f"the alloc's steps (the kernel's count): {shard_text(steps)} "
               f"of {(o.walk + 1) * S} in {sum(pa[5].values()):g} "
               f"launch(es); " if S > 1 else "")
            + f"plain math on the "
            f"{'card' if S == 1 else 'CPU'} {plain_alloc:.0f} / "
            f"{plain_free:.0f} ms; bounds {1e3 * bound_a:.2f} / "
            f"{1e3 * bound_f:.2f} us; the alloc's chunk chain"
            f"{'s' if S > 1 else ''} (the kernel's count): "
            f"{chain_text(took)}; the free's enqueue{'s' if S > 1 else ''} "
            f"(the kernel's count): {enqueue_text(freed)}")
        res[S]["chain"] = took
        if S == 1:
            res[S]["requeued"] = requeued_alloc(o, lay, sk, sizes, mask, err,
                                                reps)
        del sk, sp, granted
        torch.cuda.empty_cache()
    return res


def revived_by(o, mem, offs) -> int:
    """The chunks a free of ``offs`` (global offsets) revives on the
    arena words ``mem``: touched by it and full (free count 0)."""
    lay = shard_lay(o)
    nc, wpc = lay.cfg.num_chunks, lay.cfg.words_per_chunk
    off = lay.region("free_count").offset
    fc = mem.reshape(o.num_shards, -1)[:, off:off + nc].reshape(-1)
    g = offs[offs >= 0].long()
    ws = lay.cfg.total_words
    return int((fc[((g // ws) * nc + (g % ws) // wpc).unique()] == 0).sum())


def requeued_alloc(o, lay, sk, sizes, mask, err, reps):
    """The next admission on the engine's arena, as the serving run makes
    it: the lanes granted again after the retirement freed them, their
    chunks waiting in the class queue (dequeue runs take them).  The
    kernel against the plain math on CPU copies of the freed words, word
    for word; its device time (profiler, each alloc from the freed
    words), the plain time and the byte bound."""
    import torch
    from repro_torch.core import transactions as T
    n = sizes.shape[0]
    freed = (sk.mem.clone(), sk.ctl.clone())   # after the session's free
    queued = int(freed[1][lay.off_back] - freed[1][lay.off_front])
    t_check = time.perf_counter()
    chains()
    _, rq = o.alloc(sk, sizes, mask)
    took = chains()
    cm, cc = freed[0].cpu(), freed[1].cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = T.alloc_math(o.cfg, o.kind, o.family, cm, cc, sizes.cpu(),
                        mask.cpu())[2]
    plain = 1e3 * (time.perf_counter() - t0)
    e = {"words": 0, "max_abs": 0}
    merge_err(e, word_err(rq, want), word_err(sk.mem, cm),
              word_err(sk.ctl, cc))
    if e["words"] or not bool((want >= 0).all()):
        raise AssertionError(f"{n}-lane alloc after the free: {e['words']} "
                             f"differing words")
    merge_err(err, (e["words"], e["max_abs"]))
    chg = int((sk.mem != freed[0]).sum())
    del cm, cc

    def session():
        with DeviceProfile(counted=True) as prof:
            for _ in range(reps):
                sk.mem.copy_(freed[0])
                sk.ctl.copy_(freed[1])
                o.alloc(sk, sizes, mask)
        return prof

    ka = kernel_of(o, "alloc")
    ms, rec = per_call(profiled(session), "alloc")[:2]
    bound = (9 * n + 8 * lay.ctl_words + 8 * chg) / HBM_BYTES_PER_S * 1e3
    log(f"phase 3: {n} lanes, the next admission ({queued} chunks of the "
        f"freed lanes in the class queue): 0 differing words and offsets; "
        f"{ka} {ms:.3f} ms (profiler device time, {rec} of {reps} launches "
        f"recorded); plain math on the CPU {plain:.0f} ms; bound "
        f"{1e3 * bound:.2f} us; its chunk chain (the kernel's count): "
        f"{chain_text(took)} ({time.perf_counter() - t_check:.1f} s for "
        f"this check)")
    del freed
    return dict(ms=ms, plain=plain, bound=bound, queued=queued, chain=took)


SSD_SHAPE = dict(H=48, P=64, G=1, N=128, Q=64)   # mamba2-780m's heads


def ssd_inputs(device, chunks, seed=0, dtype=None):
    """A single-row prefill's scan inputs at mamba2-780m's head shapes:
    bf16 x, B, C; softplus steps around dt_bias -3; a = -4."""
    import numpy as np
    import torch
    dtype = dtype or torch.bfloat16
    H, P, G, N, Q = (SSD_SHAPE[k] for k in "HPGNQ")
    L = Q * chunks
    rng = np.random.default_rng(seed + chunks)
    x = torch.from_numpy(rng.standard_normal((1, L, H, P), np.float32))
    raw = rng.standard_normal((1, L, H)).astype(np.float32) - 3.0
    dt = torch.nn.functional.softplus(torch.from_numpy(raw))
    b = torch.from_numpy(rng.standard_normal((1, L, G, N), np.float32))
    c = torch.from_numpy(rng.standard_normal((1, L, G, N), np.float32))
    return (x.to(dtype).to(device), dt.to(device),
            torch.full((H,), -4.0, device=device), b.to(dtype).to(device),
            c.to(dtype).to(device))


def ssd_bound_ms(x, b, chunks) -> tuple:
    """Least time of one scan: the bytes (x, dt, a, B, C read once; y and
    h_final written once) at the memory rate, or the operations the
    inputs need.  Per chunk: for each group the Q(Q+1)/2 unmasked entries
    of C B^T (N multiply-adds each; shared by the group's heads, exact on
    the bf16 tensor cores with float32 sums when B and C are bf16), and
    for each head the Q(Q+1)/2 P multiply-adds of W x and the 2 Q P N of
    exp(cum) C h^T and of the state update, in float32 outside the tensor
    cores.  The two kinds of unit run side by side, so the operations
    take the larger of their two times; the elementwise decay weights
    (Q(Q+1)/2 per head) are not counted.  Returns the larger of bytes and
    operations, and which."""
    import torch
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = SSD_SHAPE["Q"]
    tri = Q * (Q + 1) // 2
    el = x.element_size()
    nbytes = (B * L * H * P * el + B * L * H * 4 + 2 * B * L * G * N * el
              + H * 4 + B * L * H * P * 4 + B * H * P * N * 4)
    cb = chunks * B * G * 2 * tri * N
    f32 = chunks * B * H * 2 * (tri * P + 2 * Q * P * N)
    if b.dtype == torch.bfloat16:      # C B^T on the tensor cores
        ops_s = max(f32 / F32_FLOP_PER_S, cb / BF16_FLOP_PER_S)
    else:
        ops_s = (f32 + cb) / F32_FLOP_PER_S
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


SSD_ATOL = SSD_RTOL = 1e-4
# one ssd_scan call's kernels, in launch order: C B^T beside the chunk
# states, the pass over chunks (not launched for one chunk), the outputs
SSD_KERNELS = ("ssd_chunk", "ssd_pass", "ssd_scan")


def ssd_kernels(chunks: int) -> tuple:
    return SSD_KERNELS if chunks > 1 else ("ssd_chunk", "ssd_scan")


def ssd_device_ms(x, dt, a, b, c, chunks, reps=50):
    """Device ms of one ``ssd_scan`` call from ``torch.profiler`` over
    ``reps`` calls: the sum over the kernels it launches of each one's
    mean over the launches the profiler recorded; each kernel's part (0
    for one not launched); the fewest launches recorded of any."""
    from repro_torch.kernels import ssd_scan as ssd

    def session():
        with DeviceProfile() as prof:
            for _ in range(reps):
                ssd.ssd_scan(x, dt, a, b, c, chunk=SSD_SHAPE["Q"])
        return prof

    got = profiled(session, {k: reps for k in ssd_kernels(chunks)}).got
    parts = [got[k][0] if k in got else 0.0 for k in SSD_KERNELS]
    return sum(parts), parts, min(n for _, n in got.values())


def ssd_check(got, want, what):
    """|got - want| <= atol + rtol |want| everywhere, and finite."""
    excess = ((got - want).abs() - SSD_RTOL * want.abs()).max().item()
    if not (excess <= SSD_ATOL) or not bool(got.isfinite().all()):
        raise AssertionError(f"ssd_scan {what}: off its plain version")
    return float((got - want).abs().max())


def phase_ssd(device):
    """``ssd_scan`` against ``ssd_plain`` on the same card tensors at 1,
    4 and 7 chunks of the full-width shapes, bf16 and float32 (both
    widen the same values): |err| <= 1e-4 + 1e-4 |plain|.  Then the
    kernel's and the plain version's times (CUDA events) and the bound
    at every chunk count a single-row prefill of 16-448 tokens gives
    (1-7)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    Q = SSD_SHAPE["Q"]
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for chunks in (1, 4, 7):
            x, dt, a, b, c = ssd_inputs(device, chunks, dtype=dtype)
            y, hf = ssd.ssd_scan(x, dt, a, b, c, chunk=Q)
            wy, wh = ssd.ssd_plain(x, dt, a, b, c, Q)
            torch.cuda.synchronize()
            err = max(ssd_check(got, want, f"{dtype}, {chunks} chunks")
                      for got, want in ((y, wy), (hf, wh)))
            max_err = max(max_err, err)
            log(f"phase 4: ssd_scan {str(dtype).split('.')[-1]}, {chunks} "
                f"chunk(s) (L {chunks * Q}): max error {err:.3g} (atol "
                f"{SSD_ATOL} + rtol {SSD_RTOL}); y max "
                f"{float(wy.abs().max()):.3g}")
    times = {}
    for chunks in range(1, 8):
        x, dt, a, b, c = ssd_inputs(device, chunks)
        ms = time_ms(lambda: ssd.ssd_scan(x, dt, a, b, c, chunk=Q), 20)
        dev, parts, rec = ssd_device_ms(x, dt, a, b, c, chunks)
        plain = time_ms(lambda: ssd.ssd_plain(x, dt, a, b, c, Q), 3, 1)
        bound, by = ssd_bound_ms(x, b, chunks)
        times[chunks] = dict(ms=ms, device=dev, plain=plain, bound=bound,
                             by=by)
        log(f"phase 4: ssd_scan bf16, B 1, {chunks} chunk(s): kernels "
            f"{dev:.5f} ms a call (profiler device time: "
            + " + ".join(f"{k} {v:.5f}" for k, v in zip(SSD_KERNELS, parts))
            + f", at least {rec} of 50 calls recorded), {ms:.5f} ms a call "
            f"on CUDA events (wrapper inside), plain {plain:.3f} ms, bound "
            f"{bound:.5f} ms ({by}): {100 * bound / dev:.1f}% of it")
    return dict(err=max_err, times=times)


class ScanCheck:
    """Inside the block, every ``ops.ssd_scan`` call (the model's prefill
    layers) also runs ``ssd_plain`` on the same inputs and is held to it
    (atol 1e-4 + rtol 1e-4); the kernel's outputs are returned."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.ssd_scan import ssd_plain
        self.ops, self.fn = ops, ops.ssd_scan
        self.calls, self.err, self.chunks = 0, 0.0, set()

        def checked(x, dt, a, b, c, h0=None, *, chunk):
            y, hf = self.fn(x, dt, a, b, c, h0, chunk=chunk)
            wy, wh = ssd_plain(x, dt, a, b, c, chunk, h0)
            what = f"at the serving inputs, call {self.calls}"
            self.err = max(self.err, ssd_check(y, wy, what),
                           ssd_check(hf, wh, what))
            self.calls += 1
            self.chunks.add(x.shape[1] // chunk)
            return y, hf

        ops.ssd_scan = checked
        return self

    def __exit__(self, *exc):
        self.ops.ssd_scan = self.fn
        return False


class GrantLog:
    """Delegates to the engine's allocator and keeps each transaction's
    lane tensors (references: no copy, no sync), to be checked after the
    run.  With ``snap`` it also copies the arena words around the first
    alloc and the first free (a checked run's device copies, kept out of
    the timed run)."""

    def __init__(self, ouro, snap=False):
        self._ouro = ouro
        self.snap = snap
        self.log = []
        self.first = {}

    def __getattr__(self, name):
        return getattr(self._ouro, name)

    def _words(self, state):
        return (state.mem.clone(), state.ctl.clone())

    def alloc(self, state, sizes, mask, **kw):
        before = (self._words(state) if self.snap
                  and "alloc" not in self.first else None)
        state, offs = self._ouro.alloc(state, sizes, mask, **kw)
        if before is not None:
            self.first["alloc"] = (sizes, mask, offs, before,
                                   self._words(state))
        self.log.append(("alloc", offs, mask))
        return state, offs

    def free(self, state, offs, sizes, mask):
        before = (self._words(state) if self.snap
                  and "free" not in self.first else None)
        state = self._ouro.free(state, offs, sizes, mask)
        if before is not None:
            self.first["free"] = (offs, sizes, mask, before,
                                  self._words(state))
        self.log.append(("free", offs, mask))
        return state


def check_grants(log_, words, wpp, quota, device):
    """A GrantLog replayed in order on a bitmap of live pages: every
    transaction is one slot's whole quota; every grant page-aligned,
    inside the heap and disjoint from every page still live (the other
    slots' included); every free returns live pages; none left live."""
    import torch
    live = torch.zeros(words // wpp, dtype=torch.bool, device=device)
    for kind, offs, mask in log_:
        got = offs[mask & (offs >= 0)].long()
        if int(mask.sum()) != quota or got.numel() != quota:
            raise AssertionError(f"a {kind} is not one slot's whole quota")
        pages = got // wpp
        if kind == "alloc":
            if bool(((got % wpp != 0) | (got >= words)).any()):
                raise AssertionError("a grant is off a page boundary or "
                                     "past the heap")
            if bool(live[pages].any()) or \
                    torch.unique(pages).numel() != pages.numel():
                raise AssertionError("a grant overlaps a live page")
            live[pages] = True
        else:
            if not bool(live[pages].all()):
                raise AssertionError("a free returns a page that is not "
                                     "live")
            live[pages] = False
    if bool(live.any()):
        raise AssertionError("pages still live after draining")


def time_calls(obj, names):
    """Wraps ``obj``'s methods ``names`` to sum each one's host wall;
    returns the sums (filled as the calls run)."""
    secs = {name: 0.0 for name in names}
    for name in names:
        def timed(*a, _fn=getattr(obj, name), _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                secs[_name] += time.perf_counter() - t0
        setattr(obj, name, timed)
    return secs


def prompts_of_lengths(cfg, seed, lengths):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, n) for n in lengths]


def mamba_engine(model, params, prompts, snap, device):
    """A fresh mamba2 engine (max_batch 8, max_seq 512, bf16) with the
    prompts submitted, its allocator wrapped in a GrantLog and its model
    in a CountingModel."""
    import torch
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(model, params, max_batch=8, max_seq=512,
                        kv_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16, device=device)
    grants = GrantLog(eng.ouro, snap)
    eng.ouro = grants
    counting = CountingModel(eng.model)
    eng.model = counting
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    return eng, grants, counting


def phase_mamba_serve(device, seed, lengths, grant):
    """Serve full-width mamba2-780m (random weights from ``seed``, bf16):
    phase 5's 16 request lengths, 32 new tokens, max_batch 8.  Every
    admission's aux pages are one ``alloc_txn`` of 298,656 lanes and
    every retirement's one ``free_txn``; every prefill layer is one
    ``ssd_scan``.  The timed run carries no check inside its window: its
    grants are checked afterwards from the lane tensors it logged.  Then
    the same traffic on a second fresh engine (the checked run) must give
    the same tokens, and its first admission's grant is held to phase 3's
    plain replay of the same lanes on the same fresh arena (``grant``)
    and its first retirement replayed through the plain math on a card
    copy of the words it started from."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import transactions as T
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_arch(MAMBA)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=device)
    prompts = prompts_of_lengths(cfg, seed, lengths)
    eng, grants, counting = mamba_engine(model, params, prompts, False,
                                         device)
    host = time_calls(eng, ("_alloc_aux", "_free_aux"))
    aux = eng.aux_pages
    log(f"phase 5: {MAMBA} full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.ssm_nheads} SSD heads x {cfg.ssm_headdim}, "
        f"state {cfg.ssm_state}, vocab {cfg.padded_vocab}) bf16; set-up "
        f"{time.perf_counter() - t0:.1f} s; {aux} aux pages per slot; arena "
        f"{eng.stats['arena_mem_words']} words "
        f"({eng.ouro.cfg.num_chunks} chunks)")

    chains()
    enqueues()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    took = chains()
    freed = enqueues()
    st = dict(eng.stats)
    toks = sum(len(r.out_tokens) for r in done)
    admissions = len(counting.prefill_lens)
    log(f"phase 5: {MAMBA}: served {len(done)} requests, {toks} tokens, "
        f"{st['steps']} steps, {counting.decode_calls} decode ticks, "
        f"{admissions} admissions in {wall:.2f} s: {toks / wall:.1f} tok/s "
        f"(prefill included; no check inside the timed run)")
    log(f"phase 5: {MAMBA}: stats {json.dumps(st)}")
    log(f"phase 5: {MAMBA}: launches {json.dumps(launches)}")
    log(f"phase 5: {MAMBA}: the alloc kernels' chunk chains: "
        f"{chain_text(took)}; the free kernels' enqueues: "
        f"{enqueue_text(freed)}")
    if freed["serial_enqueues"] or freed["parallel_enqueues"] != \
            st["free_txns"]:
        raise AssertionError(f"a 298,656-lane retirement's enqueue took "
                             f"the lane-order loop: {freed}")
    host = {**counting.secs, "aux alloc": host["_alloc_aux"],
            "aux free": host["_free_aux"]}
    log(f"phase 5: {MAMBA}: host wall by call (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in host.items())
        + f", rest {wall - sum(host.values()):.3f}")
    if len(done) != 16 or any(len(r.out_tokens) != 32 or not r.done
                              for r in done):
        raise AssertionError("not every request finished with 32 tokens")
    for r in done:
        if any(not (0 <= t < cfg.padded_vocab) for t in r.out_tokens):
            raise AssertionError(f"request {r.uid}: token out of range")
    want_l = {k: 0 for k in launches}
    want_l.update(alloc_txn=st["alloc_txns"], free_txn=st["free_txns"],
                  ssd_scan=cfg.num_layers * admissions)
    if launches != want_l:
        raise AssertionError(f"launches {launches} != the engine's counts "
                             f"{want_l}")
    if st["alloc_txns"] != admissions or st["free_txns"] != 16:
        raise AssertionError("not one alloc per admission and one free per "
                             "retirement")
    if st["allocs"] != st["frees"] or st["allocs"] != aux * admissions \
            or st["alloc_failures"] or any(st["shard_pages_live"]):
        raise AssertionError(f"allocs {st['allocs']} / frees {st['frees']} /"
                             f" failures / live pages per shard "
                             f"{st['shard_pages_live']}")
    if any(a.size for a in eng.slot_aux):
        raise AssertionError("pages still held after draining")
    check_grants(grants.log, eng.ouro.cfg.total_words, eng.wpp, aux, device)
    eng.ouro = grants._ouro
    log(f"phase 5: {MAMBA}: {admissions} grants of {aux} pages each "
        f"page-aligned, in the heap and disjoint from every live page "
        f"(checked after the run from its logged lanes); allocs == frees "
        f"== {st['allocs']}; every slot's and shard's pages back to 0")

    # the checked run: the same traffic on a fresh engine; its first
    # grant (on a fresh arena, with the same lanes as phase 3's
    # single-arena pair) must end on phase 3's plain replay of it, and
    # its first retirement is replayed through the plain math on a card
    # copy of the words it started from
    t0 = time.perf_counter()
    eng_b, grants_b, counting_b = mamba_engine(model, params, prompts, True,
                                               device)
    del params
    with ScanCheck() as scans:
        done_b = eng_b.run_until_done()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    want_scans = cfg.num_layers * len(counting_b.prefill_lens)
    if scans.calls != want_scans:
        raise AssertionError(f"{scans.calls} scans held, not every layer "
                             f"of every admission ({want_scans})")
    log(f"phase 5: {MAMBA}: ssd_scan at the checked run's own inputs: "
        f"{scans.calls} calls (every layer of its "
        f"{len(counting_b.prefill_lens)} admissions, "
        f"{sorted(scans.chunks)} chunks) against ssd_plain on the same "
        f"tensors: max error {scans.err:.3g} (atol {SSD_ATOL} + rtol "
        f"{SSD_RTOL})")
    tokens = {r.uid: list(r.out_tokens) for r in done}
    if {r.uid: list(r.out_tokens) for r in done_b} != tokens:
        raise AssertionError("the checked run's tokens differ from the "
                             "timed run's")
    errs = {"alloc": {"words": 0, "max_abs": 0},
            "free": {"words": 0, "max_abs": 0}}
    t0 = time.perf_counter()
    sizes, mask, offs, (m0, c0), (m1, c1) = grants_b.first["alloc"]
    same = (word_err(m0, grant["fresh"][0])[0] == 0
            and word_err(c0, grant["fresh"][1])[0] == 0
            and bool((sizes == 256).all()) and bool(mask.all())
            and mask.shape[0] == grant["offs"].shape[0])
    if not same:
        raise AssertionError("the first grant is not phase 3's pair")
    merge_err(errs["alloc"], word_err(offs, grant["offs"]),
              word_err(m1, grant["mem"]), word_err(c1, grant["ctl"]))
    offs_f, sizes_f, mask_f, (m0, c0), (m1, c1) = grants_b.first["free"]
    m, c = m0.clone(), c0.clone()
    T.free_math(eng_b.ouro.cfg, eng_b.ouro.kind, eng_b.ouro.family, m, c,
                offs_f, sizes_f, mask_f)
    merge_err(errs["free"], word_err(m1, m), word_err(c1, c))
    torch.cuda.synchronize()
    log(f"phase 5: {MAMBA}: the checked run ({wall_b:.2f} s, set-up "
        f"included) gives the same tokens; its first grant "
        f"({int(mask.sum())} lanes, on phase 3's fresh arena) ends on phase "
        f"3's plain replay of it, and its first retirement replayed through "
        f"the plain math on the card ({time.perf_counter() - t0:.1f} s): "
        f"{errs['alloc']['words']} / {errs['free']['words']} differing "
        f"words and offsets")
    if errs["alloc"]["words"] or errs["free"]["words"]:
        raise AssertionError("the plain replay differs from the kernels")
    del eng_b, grants_b, m0, c0, m1, c1, m, c
    torch.cuda.empty_cache()
    chunks = [-(-n // SSD_SHAPE["Q"]) for n in counting.prefill_lens]
    return dict(launches=launches, tok_s=toks / wall, wall=wall, stats=st,
                chunks=chunks, errs=errs, engine=eng, prompts=prompts,
                tokens=tokens,
                host=host, scan_err=scans.err, scan_calls=scans.calls,
                enqueue=freed)


def phase_mamba_profile(mamba):
    """Where the mamba2 run's device time went: the same traffic again
    under the profiler (its wall is the profiler's, not the server's)."""
    from repro_torch.kernels import ops
    eng = mamba.pop("engine")
    for p in mamba["prompts"]:
        eng.submit(p, max_new_tokens=32)
    ops.reset_launches()
    with DeviceProfile(counted=True) as prof:
        eng.run_until_done()
    busy = prof.busy_ms()
    wall = 1e3 * mamba["wall"]
    log(f"phase 6: {MAMBA} serving device busy {busy:.0f} ms of the "
        f"unprofiled run's {wall:.0f} ms wall: device idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for key, us, n in prof.rows[:8]:
        log(f"phase 6:   {us / 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    # each kernel's mean over the launches the profiler kept, times the
    # launches the rerun made (as for paged_attention): every scan
    # launches ssd_chunk and ssd_scan, those of 2 chunks or more
    # ssd_pass; the frees' kernels as the card counted their launches
    out = {}
    scans = ops.LAUNCHES["ssd_scan"]
    layers = scans // len(mamba["chunks"])
    made = {"ssd_scan": {"ssd_chunk": scans, "ssd_scan": scans,
                         "ssd_pass": layers * sum(ch > 1 for ch in
                                                  mamba["chunks"])},
            "free_txn": {k: prof.made[k] for k in FAMILY["free"]
                         if prof.made[k]}}
    for name, parts in made.items():
        got = {k: prof.kernel(KERNEL_SYMBOLS[k]) for k in parts}
        recorded = ", ".join(f"{k} {got[k][1]} of {m}"
                             for k, m in parts.items())
        if all(got[k][1] for k, m in parts.items() if m):
            out[name] = sum(got[k][0] * m for k, m in parts.items() if m)
            log(f"phase 6: {MAMBA}: {name} in that rerun: {out[name]:.2f} ms "
                f"of device time (each kernel's per-launch mean times its "
                f"launches; launches recorded: {recorded})")
        else:
            out[name] = None
            log(f"phase 6: {MAMBA}: {name} in that rerun: not measured (a "
                f"kernel had no launch recorded: {recorded})")
    out["busy"] = busy
    return out


# ---------------------------------------------------------------------------
# phase 7: the fused decode mega-step
# ---------------------------------------------------------------------------

# (run, model, engine settings, co-tenants: 0 none, 1 the 2048-B one, 2
# also the 128-page holder, counters that must fire)
MEGA_RUNS = (
    ("qwen2-0.5b", "qwen2", {}, 0, ()),
    ("qwen2-0.5b under pressure", "qwen2", PRESSURE, 1,
     ("alloc_failures", "defrag_waves", "evictions")),
    ("qwen2-0.5b sharded under pressure", "qwen2", SHARDED_RUNS[1][1], 2,
     ("alloc_failures", "defrag_waves", "evictions")),
    (MAMBA, "mamba", {}, 0, ()),
)


def mega_engine(device, model, params, max_batch=8, **kw):
    import torch
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(model, params, max_batch=max_batch, max_seq=512,
                         kv_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16, device=device,
                         mega_step=True, max_new_cap=32, **kw)


def mega_launches(device, models):
    """``launches_per_tick`` of full-width qwen2-0.5b (single arena and 4
    shards) and mamba2-780m at max_batch 2 and 8, each beside the
    allocator launches its kernels counted in that probe tick."""
    from repro_torch.kernels import ops
    out = {}
    for name, key, kw in (("qwen2-0.5b", "qwen2", {}),
                          ("qwen2-0.5b, 4 shards", "qwen2",
                           {"num_shards": SHARDS}),
                          (MAMBA, "mamba", {})):
        per = []
        for mb in (2, 8):
            eng = mega_engine(device, *models[key], max_batch=mb, **kw)
            made0 = kernel_launches()
            calls0 = dict(ops.LAUNCHES)
            n = eng.launches_per_tick()
            made = {k: m - made0[k] for k, m in kernel_launches().items()
                    if m - made0[k]}
            calls = {k: m - calls0[k] for k, m in ops.LAUNCHES.items()
                     if m - calls0[k]}
            L = eng.cfg.num_layers
            want = 0 if eng.caches.kv is None else 1 + L
            grow = "alloc_txn" if eng.num_shards == 1 else "sharded_alloc_txn"
            want_made = {} if not want else {grow: 1}
            want_calls = {} if not want else {grow: 1, "paged_attention": L}
            if n != want or made != want_made or calls != want_calls:
                raise AssertionError(
                    f"{name}, max_batch {mb}: launches_per_tick {n} (want "
                    f"{want}), wrappers counted {calls}, kernels {made}")
            per.append(n)
            del eng
        log(f"phase 7: {name}: launches_per_tick {per[0]} at max_batch 2, "
            f"{per[1]} at 8 (the allocator's part as its kernels counted "
            f"it)")
        out[name] = per[1]
    return out


def steady_syncs(eng):
    """Serve ``eng``'s queue to the end, each step under
    ``set_sync_debug_mode("warn")``: ({synchronizing calls: steady steps}
    (nothing admitted, retired, failed or defragmented), the same of
    the other steps, finished requests)."""
    import warnings
    import torch
    steady, other, done = {}, {}, []
    prev = torch.cuda.get_sync_debug_mode()
    keys = ("alloc_failures", "defrag_waves")
    try:
        while eng.waiting or any(r is not None for r in eng.slot_req):
            slots = [id(r) for r in eng.slot_req]
            counts = [eng.stats[k] for k in keys]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                fin = eng.step()
                torch.cuda.set_sync_debug_mode(prev)
            n = sum("synchroniz" in str(w.message) for w in caught)
            quiet = (not fin and slots == [id(r) for r in eng.slot_req]
                     and counts == [eng.stats[k] for k in keys])
            tally = steady if quiet else other
            tally[n] = tally.get(n, 0) + 1
            done.extend(fin)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return steady, other, done


def phase_mega(device, models, serve, mamba, host_busy):
    """Phase 5's traffic through ``ServingEngine(mega_step=True)``: four
    runs (qwen2-0.5b, under pressure, sharded under pressure, mamba2-780m),
    each with the host loop's tokens, ``allocs == frees``, no page held
    after draining, the must-fire counters above 0, and its launches
    equal to the engine's counts (one grow a tick, one
    ``paged_attention`` a layer a tick).  Then profiled reruns of the
    qwen2 and mamba2 runs, each step's synchronizing calls counted: one
    a steady tick."""
    import torch
    from repro_torch.kernels import ops
    out = {"launches_per_tick": mega_launches(device, models)}
    want_toks = {"qwen2": serve["tokens"], "mamba": mamba["tokens"]}
    prompts = {"qwen2": serve["prompts"], "mamba": mamba["prompts"]}
    runs = {}
    for name, key, kw, tenants, must in MEGA_RUNS:
        eng = mega_engine(device, *models[key], **kw)
        counting = CountingModel(eng.model)
        eng.model = counting
        held = ((cotenant(eng),) + ((holder(eng),) if tenants > 1 else ())
                if tenants else ())
        for p in prompts[key]:
            eng.submit(p, max_new_tokens=32)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        st = dict(eng.stats)
        toks = sum(len(r.out_tokens) for r in done)
        log(f"phase 7: mega {name} ({kw}"
            + (f", co-tenants {held}" if held else "")
            + f"): served {len(done)} requests, {toks} tokens, "
            f"{st['steps']} steps, {counting.decode_calls} ticks in "
            f"{wall:.2f} s: {toks / wall:.1f} tok/s")
        log(f"phase 7: mega {name}: stats {json.dumps(st)}")
        log(f"phase 7: mega {name}: launches {json.dumps(launches)}")
        got = {r.uid: list(r.out_tokens) for r in done}
        if got != want_toks[key]:
            bad = sorted(u for u in set(got) | set(want_toks[key])
                         if got.get(u) != want_toks[key].get(u))
            raise AssertionError(f"mega {name}: tokens of uids {bad} differ "
                                 f"from phase 5's host loop")
        zero = [k for k in must if not st[k] > 0]
        if zero:
            raise AssertionError(f"mega {name}: counters at 0: {zero}")
        eng._sync_shard_pages_from_table()
        kv = eng.caches.kv
        if (st["allocs"] != st["frees"]
                or any(eng.stats["shard_pages_live"])
                or any(a.size for a in eng.slot_aux)
                or (kv is not None and not bool((kv.page_table == -1).all()))):
            raise AssertionError(f"mega {name}: pages still held after "
                                 f"draining (allocs {st['allocs']}, frees "
                                 f"{st['frees']}, live per shard "
                                 f"{eng.stats['shard_pages_live']})")
        L = eng.cfg.num_layers
        pre = "" if eng.num_shards == 1 else "sharded_"
        want_l = {k: 0 for k in launches}
        want_l[pre + "alloc_txn"] = st["alloc_txns"]
        want_l[pre + "free_txn"] = st["free_txns"]
        want_l[pre + "defrag_txn"] = st["defrag_waves"] + st["rebalance_waves"]
        path = [pre + "alloc_txn", pre + "free_txn"] + (
            [pre + "defrag_txn"] if tenants else [])
        if kv is None:
            want_l["ssd_scan"] = L * len(counting.prefill_lens)
            path.append("ssd_scan")
        else:
            want_l["paged_attention"] = L * counting.decode_calls
            path.append("paged_attention")
        if launches != want_l:
            raise AssertionError(f"mega {name}: launches {launches} != the "
                                 f"engine's counts {want_l}")
        if min(launches[k] for k in path) == 0:
            raise AssertionError(f"mega {name}: a kernel of the path never "
                                 f"launched: {launches}")
        runs[name] = dict(launches=launches, tok_s=toks / wall, wall=wall,
                          stats=st, key=key,
                          **({} if tenants else {"engine": eng}))
        del eng, counting
    out["runs"] = runs

    # profiled reruns of the unpressured runs; every step's synchronizing
    # calls counted (the flags' read is the only one of a steady tick)
    for name, host_name in (("qwen2-0.5b", "qwen2-0.5b"), (MAMBA, MAMBA)):
        r = runs[name]
        eng = r.pop("engine")
        for p in prompts[r["key"]]:
            eng.submit(p, max_new_tokens=32)
        with DeviceProfile() as prof:
            steady, other, done = steady_syncs(eng)
        if sorted(list(x.out_tokens) for x in done) != sorted(
                want_toks[r["key"]].values()):
            raise AssertionError(f"mega {name}: the profiled rerun's tokens "
                                 f"differ")
        if set(steady) != {1}:
            raise AssertionError(f"mega {name}: synchronizing calls of the "
                                 f"steady ticks {steady} (want 1 each)")
        busy = prof.busy_ms()
        wall = 1e3 * r["wall"]
        hb, hw = host_busy[host_name]
        r.update(busy=busy, idle=1 - busy / wall, steady=steady, other=other,
                 host_idle=1 - hb / hw)
        log(f"phase 7: mega {name}: device busy {busy:.0f} ms of the "
            f"unprofiled run's {wall:.0f} ms wall: device idle "
            f"{100 * r['idle']:.1f}% (host loop, phases 5-6: busy "
            f"{hb:.0f} ms of {hw:.0f} ms, idle {100 * r['host_idle']:.1f}%)")
        log(f"phase 7: mega {name}: synchronizing calls a step in the "
            f"rerun (count: steps): steady ticks {steady}, other steps "
            f"{other}")
        for key_, us, n in prof.rows[:6]:
            log(f"phase 7:   {us / 1e3:9.2f} ms  {n:6d}x  {key_[:90]}")
        del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the moe slice: mixtral-8x7b at full width, 16 of its 32 layers
# ---------------------------------------------------------------------------

# 32 layers of bf16 weights are 93.4 GB, past one 80-GB card; 16 are 47.0
MIXTRAL_LAYERS = 16
MIX_LONG = 4160          # a prompt past the 4096-token window
MIX_MAX_SEQ = MIX_LONG + 32
# aux pages a slot: 16 layers x top-2 x d_ff 14336 x 2 B in 256-B pages
MIX_QUOTA = 3584


def mixtral_model(device, seed):
    """Full-width mixtral-8x7b cut to ``MIXTRAL_LAYERS`` layers, random
    bf16 weights from ``seed`` (each leaf drawn in float32 and cast as it
    is drawn), and phase 5's 16 prompts plus one of ``MIX_LONG`` tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    full = get_arch(MIXTRAL)
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["lm_head"],
              *params["final_norm"].values(),
              *(w for b in params["blocks"] for g in b.values()
                for w in g.values())]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    rng = np.random.default_rng(seed + 1)
    prompts = make_requests(cfg, seed, 16, 16, 448) + [
        rng.integers(2, cfg.vocab_size, MIX_LONG)]
    log(f"phase 5: {MIXTRAL} full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads} query / {cfg.num_kv_heads} kv heads of "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok}, "
        f"window {cfg.sliding_window}, vocab {cfg.padded_vocab}, untied "
        f"lm_head) at depth {cfg.num_layers} of {full.num_layers}: "
        f"{nbytes} bytes of bf16 weights ({nbytes / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params, prompts


def mixtral_engine(device, model, params, **kw):
    import torch
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(model, params, max_batch=8, max_seq=MIX_MAX_SEQ,
                         kv_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16, device=device, **kw)


def aux_grants(eng):
    """Record each admission's aux grant (pages) as the engine makes it."""
    grants, grant = [], eng._alloc_aux

    def recorded(slot):
        ok = grant(slot)
        if ok:
            grants.append(len(eng.slot_aux[slot]))
        return ok
    eng._alloc_aux = recorded
    return grants


def drained(eng, name):
    """``allocs == frees``, no page in the table, no aux page held."""
    st = eng.stats
    kv = eng.caches.kv
    if eng.mega_step:
        eng._sync_shard_pages_from_table()
    if (st["allocs"] != st["frees"] or any(st["shard_pages_live"])
            or any(a.size for a in eng.slot_aux)
            or not bool((kv.page_table == -1).all())):
        raise AssertionError(f"{name}: pages still held after draining "
                             f"(allocs {st['allocs']}, frees {st['frees']})")


def serving_launches(launches, st, decode_calls, L, name):
    """The run's launches equal the engine's counts: one alloc_txn a
    transaction, one free_txn a retirement, one paged_attention a layer
    a tick, and nothing else."""
    want = {k: 0 for k in launches}
    want.update(alloc_txn=st["alloc_txns"], free_txn=st["free_txns"],
                paged_attention=L * decode_calls)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != the engine's "
                             f"counts {want}")
    if min(launches[k] for k in ("alloc_txn", "free_txn",
                                 "paged_attention")) == 0:
        raise AssertionError(f"{name}: a kernel of the path never "
                             f"launched: {launches}")


def mixtral_checked_rerun(eng, prompts, want_toks, every=32, atol=1e-5):
    """The host loop's traffic again, every call of every ``every``-th
    tick and of the first tick in which the long request's window masks
    held to the plain version at the run's own inputs (the ring
    and window the model passes); the tokens must equal the timed
    run's.  Returns (ticks checked, of them masking, calls checked, max
    error)."""
    import torch
    from repro_torch.kernels import ops, ref
    kernel, L = ops.paged_attention, eng.cfg.num_layers
    W = eng.cfg.sliding_window
    st = {"calls": 0, "checked": 0, "ticks": [], "masking": [], "err": 0.0,
          "on": False}

    def checked(q, k, v, table, seq, **kw):
        out = kernel(q, k, v, table, seq, **kw)
        tick, layer = divmod(st["calls"], L)
        if layer == 0:
            masks = int(seq.max()) > W
            st["on"] = (tick % every == 0
                        or (masks and not st["masking"]))
            if st["on"]:
                st["ticks"].append(tick)
                if masks:
                    st["masking"].append(tick)
        if st["on"]:
            if kw.get("window") != W or not kw.get("ring"):
                raise AssertionError(f"the model passed {kw} to "
                                     f"paged_attention")
            want = ref.paged_attention(q, k, v, table, seq, **kw)
            st["err"] = max(st["err"], float((out - want).abs().max()))
            st["checked"] += 1
        st["calls"] += 1
        return out

    eng.alloc_state = eng.ouro.init()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    ops.paged_attention = checked
    try:
        done = eng.run_until_done()
    finally:
        ops.paged_attention = kernel
    torch.cuda.synchronize()
    if sorted(r.out_tokens for r in done) != sorted(want_toks.values()):
        raise AssertionError(f"{MIXTRAL}: the checked rerun's tokens differ")
    if len(st["ticks"]) < 3 or not st["masking"] or not st["err"] <= atol:
        raise AssertionError(f"{MIXTRAL}: paged_attention at the run's "
                             f"inputs: ticks {st['ticks']} (masking "
                             f"{st['masking']}), max error {st['err']} "
                             f"(atol {atol})")
    return st


def phase_mixtral_serve(device, model, params, prompts):
    """Phase 5's requests plus one of ``MIX_LONG`` tokens through the host
    loop: one aux grant of the quota per admission, ``allocs == frees``,
    no page held, the launches equal to the engine's counts; then a
    checked rerun (``mixtral_checked_rerun``) and a profiled one."""
    import gc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.paged.kv_cache import modality_page_quota

    t0 = time.perf_counter()
    eng = mixtral_engine(device, model, params)
    quota = modality_page_quota(eng.cfg)
    grants = aux_grants(eng)
    counting = CountingModel(eng.model)
    eng.model = counting
    L = eng.cfg.num_layers
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    log(f"phase 5: {MIXTRAL}: engine max_batch 8, max_seq {MIX_MAX_SEQ}, "
        f"{eng.aux_pages} aux pages a slot (quota {quota}), KV heaps of "
        f"{eng.caches.kv.layers.k.shape[1]} pages ("
        f"{2 * eng.caches.kv.layers.k.numel() * 2 / 1e9:.2f} GB); "
        f"set-up {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = dict(eng.stats)
    toks = sum(len(r.out_tokens) for r in done)
    log(f"phase 5: {MIXTRAL}: served {len(done)} requests (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens), "
        f"{toks} tokens, {st['steps']} steps, {counting.decode_calls} "
        f"decode ticks in {wall:.2f} s: {toks / wall:.1f} tok/s (prefill "
        f"included: {counting.secs['prefill']:.2f} s host wall)")
    log(f"phase 5: {MIXTRAL}: stats {json.dumps(st)}")
    log(f"phase 5: {MIXTRAL}: launches {json.dumps(launches)}; aux grants "
        f"{grants}")
    if len(done) != len(prompts) or any(len(r.out_tokens) != 32
                                        for r in done):
        raise AssertionError(f"{MIXTRAL}: not every request finished with "
                             f"32 tokens")
    if any(not (0 <= t < eng.cfg.padded_vocab) for r in done
           for t in r.out_tokens):
        raise AssertionError(f"{MIXTRAL}: a token out of range")
    if grants != [MIX_QUOTA] * len(prompts) or quota != MIX_QUOTA:
        raise AssertionError(f"{MIXTRAL}: aux grants {grants}, quota {quota} "
                             f"(want {MIX_QUOTA} at each of {len(prompts)} "
                             f"admissions)")
    if st["alloc_failures"]:
        raise AssertionError(f"{MIXTRAL}: {st['alloc_failures']} failed "
                             f"grants")
    drained(eng, f"{MIXTRAL} host loop")
    serving_launches(launches, st, counting.decode_calls, L, MIXTRAL)
    tokens = {r.uid: r.out_tokens for r in done}

    t0 = time.perf_counter()
    chk = mixtral_checked_rerun(eng, prompts, tokens)
    log(f"phase 5: {MIXTRAL}: paged_attention at the run's own inputs: "
        f"{chk['checked']} calls of ticks {chk['ticks']} (the long "
        f"request's window masks in tick {chk['masking']}) held to the "
        f"plain version on the card, max error {chk['err']:.3g} (atol "
        f"1e-5); the rerun's tokens equal the timed run's "
        f"({time.perf_counter() - t0:.1f} s)")

    eng.alloc_state = eng.ouro.init()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    with DeviceProfile() as prof:
        done = eng.run_until_done()
    if sorted(r.out_tokens for r in done) != sorted(tokens.values()):
        raise AssertionError(f"{MIXTRAL}: the profiled rerun's tokens differ")
    busy = prof.busy_ms()
    attn = [prof.kernel(KERNEL_SYMBOLS[k]) for k in ATTN_KERNELS]
    attn_ms = sum(ms * n for ms, n in attn if ms)
    log(f"phase 5: {MIXTRAL}: profiled rerun: device busy {busy:.0f} ms of "
        f"the timed run's {1e3 * wall:.0f} ms wall: device idle "
        f"{100 * (1 - busy / (1e3 * wall)):.1f}%; paged_attention "
        f"{attn_ms:.1f} ms over {attn[0][1]} recorded calls")
    for key_, us, n in prof.rows[:6]:
        log(f"phase 5:   {us / 1e3:9.2f} ms  {n:6d}x  {key_[:90]}")
    out = dict(tokens=tokens, launches=launches, tok_s=toks / wall,
               wall=wall, busy=busy, idle=1 - busy / (1e3 * wall),
               checked=chk, stats=st,
               attn_ms=attn_ms, attn_calls=attn[0][1])
    del eng, counting, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the int8 slice: qwen1.5-32b at full width and depth, int8 KV pages
# ---------------------------------------------------------------------------

Q32_MAX_SEQ = 1024


def qwen32_model(device, seed):
    """Full-width, full-depth qwen1.5-32b (64 layers), random bf16
    weights from ``seed`` (each leaf drawn in float32 and cast as it is
    drawn, layer by layer), and phase 5's 16 prompt lengths."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    cfg = get_arch(QWEN32)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["lm_head"],
              *params["final_norm"].values(),
              *(w for b in params["blocks"] for g in b.values()
                for w in g.values())]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    free, total = torch.cuda.mem_get_info()
    log(f"phase 5: {QWEN32} full width and depth ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} query / "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.padded_vocab}, QKV bias, untied lm_head): "
        f"{sum(t.numel() for t in leaves)} parameters, {nbytes} bytes of "
        f"bf16 weights ({nbytes / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.1f} s; device memory after the "
        f"weights (mem_get_info): {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB")
    return model, params, make_requests(cfg, seed, 16, 16, 448)


def qwen32_engine(device, model, params, **kw):
    import torch
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(model, params, max_batch=8, max_seq=Q32_MAX_SEQ,
                         kv_dtype=torch.int8, compute_dtype=torch.bfloat16,
                         device=device, **kw)


def float64_judged(kernel_err, plain_err, D, atol=1e-5) -> bool:
    """Whether the kernel's largest error against a float64 evaluation of
    the same words and scales is within sqrt(D) times the plain
    version's own, + ``atol``.  Where the scores are large (qwen1.5-32b
    with random weights: |q|, |k| and |out| in the tens) two float32
    evaluations part by far more than 1e-5 (the plain version alone is
    that far from float64 there), so atol 1e-5 against the plain version
    cannot hold; the kernel sums each score's D products in order (PR
    17's rounding order), the plain version through cuBLAS in blocks.
    The factor lies between the two readings that set it, both printed
    by ``qwen32_checked_rerun``: the kernel's error over the plain
    version's, and that of a control of lower precision (the plain
    version staged in bf16, as the JAX reference stages int8 pages),
    which must fall outside.  A wrong page, slot, head or scale moves
    the output by about |v|, far past this."""
    return kernel_err <= D ** 0.5 * plain_err + atol


def qwen32_checked_rerun(eng, prompts, want_toks, every=30):
    """The host loop's traffic again, every ``paged_attention`` call of
    every ``every``-th tick held at the run's own inputs (its int8 heaps
    and their scales) to the plain version and, both of them, to a
    float64 evaluation (``float64_judged``), and a bf16-staged control
    (``ref.paged_attention(stage=torch.bfloat16)``) that must fail that
    judgement; the tokens must equal the timed run's.  Returns (ticks
    checked, calls checked, the kernel's largest difference from the
    plain version, the kernel's, the plain version's and the control's
    largest error against float64, the largest ratio of the kernel's
    error to the plain version's in one call, the largest output)."""
    import torch
    from repro_torch.kernels import ops, ref
    kernel, L = ops.paged_attention, eng.cfg.num_layers
    st = {"calls": 0, "checked": 0, "ticks": [], "err": 0.0, "k64": 0.0,
          "p64": 0.0, "c64": 0.0, "call_ratio": 0.0, "out": 0.0}

    def checked(q, k, v, table, seq, **kw):
        out = kernel(q, k, v, table, seq, **kw)
        tick, layer = divmod(st["calls"], L)
        if tick % every == 0:
            if layer == 0:
                st["ticks"].append(tick)
            if k.dtype != torch.int8 or kw.get("k_scale") is None:
                raise AssertionError(f"the model passed {k.dtype} pages "
                                     f"without scales to paged_attention")
            want = ref.paged_attention(q, k, v, table, seq, **kw)
            exact = ref.paged_attention(q, k, v, table, seq,
                                        dtype=torch.float64, **kw)
            staged = ref.paged_attention(q, k, v, table, seq,
                                         stage=torch.bfloat16, **kw)
            e = {key: float(x.abs().max()) for key, x in (
                ("err", out - want), ("k64", out - exact),
                ("p64", want - exact), ("c64", staged - exact),
                ("out", exact))}
            for key, x in e.items():
                st[key] = max(st[key], x)
            st["call_ratio"] = max(st["call_ratio"],
                                   e["k64"] / max(e["p64"], 1e-30))
            st["checked"] += 1
        st["calls"] += 1
        return out

    eng.alloc_state = eng.ouro.init()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    ops.paged_attention = checked
    try:
        done = eng.run_until_done()
    finally:
        ops.paged_attention = kernel
    torch.cuda.synchronize()
    if sorted(r.out_tokens for r in done) != sorted(want_toks.values()):
        raise AssertionError(f"{QWEN32}: the checked rerun's tokens differ")
    D = eng.cfg.head_dim_
    if len(st["ticks"]) < 3 or not float64_judged(st["k64"], st["p64"], D):
        raise AssertionError(f"{QWEN32}: paged_attention at the run's "
                             f"inputs: ticks {st['ticks']}, error against "
                             f"float64 {st['k64']} (the plain version's "
                             f"{st['p64']}, x sqrt({D}) + 1e-5)")
    if float64_judged(st["c64"], st["p64"], D):
        raise AssertionError(f"{QWEN32}: the bf16-staged control's error "
                             f"against float64, {st['c64']}, passes the "
                             f"limit sqrt({D}) x {st['p64']} + 1e-5, which "
                             f"then tells no lower precision apart")
    return st


def phase_qwen32_serve(device, model, params, prompts):
    """Phase 5's 16 prompts, 32 new each, through the host loop of
    full-width, full-depth qwen1.5-32b on int8 KV pages: ``allocs ==
    frees``, no page held, the launches equal to the engine's counts;
    then a checked rerun (``qwen32_checked_rerun``) and a profiled one
    (device busy and idle share)."""
    import gc
    import torch
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    eng = qwen32_engine(device, model, params)
    counting = CountingModel(eng.model)
    eng.model = counting
    L = eng.cfg.num_layers
    kv = eng.caches.kv.layers
    heap = sum(t.numel() * t.element_size() for t in kv)
    free, total = torch.cuda.mem_get_info()
    log(f"phase 5: {QWEN32}: engine max_batch 8, max_seq {Q32_MAX_SEQ}, "
        f"K/V heaps {kv.k.dtype} of {kv.k.shape[1]} pages with float32 "
        f"scales {tuple(kv.k_scale.shape)}: {heap} bytes "
        f"({heap / 1e9:.2f} GB); set-up {time.perf_counter() - t0:.1f} s; "
        f"device memory after the heaps (mem_get_info): "
        f"{free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB")
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = dict(eng.stats)
    toks = sum(len(r.out_tokens) for r in done)
    log(f"phase 5: {QWEN32}: served {len(done)} requests (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens), "
        f"{toks} tokens, {st['steps']} steps, {counting.decode_calls} "
        f"decode ticks in {wall:.2f} s: {toks / wall:.1f} tok/s (prefill "
        f"included: {counting.secs['prefill']:.2f} s host wall); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase 5: {QWEN32}: stats {json.dumps(st)}")
    log(f"phase 5: {QWEN32}: launches {json.dumps(launches)}")
    if len(done) != len(prompts) or any(len(r.out_tokens) != 32
                                        for r in done):
        raise AssertionError(f"{QWEN32}: not every request finished with "
                             f"32 tokens")
    if any(not (0 <= t < eng.cfg.padded_vocab) for r in done
           for t in r.out_tokens):
        raise AssertionError(f"{QWEN32}: a token out of range")
    if st["alloc_failures"]:
        raise AssertionError(f"{QWEN32}: {st['alloc_failures']} failed "
                             f"grants")
    drained(eng, f"{QWEN32} host loop")
    serving_launches(launches, st, counting.decode_calls, L, QWEN32)
    tokens = {r.uid: r.out_tokens for r in done}

    t0 = time.perf_counter()
    chk = qwen32_checked_rerun(eng, prompts, tokens)
    log(f"phase 5: {QWEN32}: paged_attention at the run's own inputs: "
        f"{chk['checked']} int8 calls of ticks {chk['ticks']}: the kernel "
        f"differs from the plain version by up to {chk['err']:.3g} (|out| "
        f"up to {chk['out']:.3g}; atol 1e-5 does not hold at these "
        f"magnitudes), and from a float64 evaluation of the same words "
        f"and scales by up to {chk['k64']:.3g}, the plain version by "
        f"{chk['p64']:.3g} (held: kernel <= sqrt({eng.cfg.head_dim_}) x "
        f"plain + 1e-5; kernel / plain {chk['k64'] / chk['p64']:.3g}, "
        f"largest in one call {chk['call_ratio']:.3g}), the bf16-staged "
        f"control by {chk['c64']:.3g} (control / plain "
        f"{chk['c64'] / chk['p64']:.3g}: outside the limit, as it must "
        f"be); the rerun's tokens equal the timed run's "
        f"({time.perf_counter() - t0:.1f} s)")

    eng.alloc_state = eng.ouro.init()
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    with DeviceProfile() as prof:
        done = eng.run_until_done()
    if sorted(r.out_tokens for r in done) != sorted(tokens.values()):
        raise AssertionError(f"{QWEN32}: the profiled rerun's tokens differ")
    busy = prof.busy_ms()
    attn = [prof.kernel(KERNEL_SYMBOLS[k]) for k in ATTN_KERNELS]
    attn_ms = sum(ms * n for ms, n in attn if ms)
    log(f"phase 5: {QWEN32}: profiled rerun: device busy {busy:.0f} ms of "
        f"the timed run's {1e3 * wall:.0f} ms wall: device idle "
        f"{100 * (1 - busy / (1e3 * wall)):.1f}%; paged_attention "
        f"{attn_ms:.1f} ms over {attn[0][1]} recorded calls")
    for key_, us, n in prof.rows[:6]:
        log(f"phase 5:   {us / 1e3:9.2f} ms  {n:6d}x  {key_[:90]}")
    out = dict(tokens=tokens, launches=launches, tok_s=toks / wall,
               wall=wall, busy=busy, idle=1 - busy / (1e3 * wall),
               checked=chk, stats=st, attn_ms=attn_ms, attn_calls=attn[0][1])
    del eng, counting, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_alone_mega(name, eng, prompts, host):
    """A model that runs alone on the card (mixtral-8x7b, qwen1.5-32b)
    through the mega-step engine ``eng``: ``launches_per_tick`` 1 + L
    (one grow, one ``paged_attention`` a layer, as the wrappers and the
    allocator kernel counted them); then one timed run of ``prompts``,
    each step's synchronizing calls counted (one a steady tick), with
    the host loop's tokens, the launches equal to the engine's counts
    and nothing held after draining."""
    import gc
    import torch
    from repro_torch.kernels import ops
    L = eng.cfg.num_layers
    made0, calls0 = kernel_launches(), dict(ops.LAUNCHES)
    n = eng.launches_per_tick()
    made = {k: m - made0[k] for k, m in kernel_launches().items()
            if m - made0[k]}
    calls = {k: m - calls0[k] for k, m in ops.LAUNCHES.items()
             if m - calls0[k]}
    if (n != 1 + L or made != {"alloc_txn": 1}
            or calls != {"alloc_txn": 1, "paged_attention": L}):
        raise AssertionError(f"{name} mega: launches_per_tick {n} (want "
                             f"{1 + L}), wrappers counted {calls}, kernels "
                             f"{made}")
    log(f"phase 7: {name}: launches_per_tick {n} at max_batch 8 (the "
        f"allocator's part as its kernel counted it: {made})")
    counting = CountingModel(eng.model)
    eng.model = counting
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    steady, other, done = steady_syncs(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = dict(eng.stats)
    toks = sum(len(r.out_tokens) for r in done)
    log(f"phase 7: mega {name}: served {len(done)} requests, {toks} "
        f"tokens, {st['steps']} steps, {counting.decode_calls} ticks in "
        f"{wall:.2f} s: {toks / wall:.1f} tok/s (host loop "
        f"{host['tok_s']:.1f}; each step under sync debug mode \"warn\")")
    log(f"phase 7: mega {name}: stats {json.dumps(st)}")
    log(f"phase 7: mega {name}: launches {json.dumps(launches)}")
    log(f"phase 7: mega {name}: synchronizing calls a step (count: "
        f"steps): steady ticks {steady}, other steps {other}")
    if {r.uid: list(r.out_tokens) for r in done} != host["tokens"]:
        raise AssertionError(f"mega {name}: tokens differ from the host "
                             f"loop's")
    if set(steady) != {1}:
        raise AssertionError(f"mega {name}: synchronizing calls of the "
                             f"steady ticks {steady} (want 1 each)")
    drained(eng, f"mega {name}")
    serving_launches(launches, st, counting.decode_calls, L,
                     f"mega {name}")
    out = dict(launches=launches, tok_s=toks / wall, wall=wall, stats=st,
               steady=steady, launches_per_tick=n)
    del eng, counting
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: package sources not found under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"phase 1: card {card!r}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"phase 2: built {sorted(secs)} in "
        f"{time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in sorted(secs.items()))})")
    for name in sorted(secs):
        for ln in build.ptxas_report(name).splitlines():
            log(f"phase 2: {name}: {ln.strip()}")
    log(f"phase 2: ssd_scan: tensor-core (HMMA) instructions by kernel "
        f"(cuobjdump): {json.dumps(sass_count(build, 'ssd_scan', 'HMMA'))}")

    t0 = time.perf_counter()
    ops.reset_launches()
    alloc_logs, alloc_errs = phase_alloc(device, seed=args.seed)
    waves, defrag_err = phase_defrag(device, seed=args.seed)
    sh3, sharded_errs = phase_sharded(device, seed=args.seed)
    aux_pairs = phase_aux_pairs(device)
    no_piecewise(ops.LAUNCHES, "phase 3's kernels and plain replays")
    log(f"phase 3: {time.perf_counter() - t0:.1f} s; no piecewise step "
        f"launched")
    t0 = time.perf_counter()
    pw_launches, pw_paths, pw_inputs, pw_errs = phase_piecewise(device,
                                                      seed=args.seed)
    log(f"phase 3 (piecewise): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    var_launches, var_errs = phase_variants(device, seed=args.seed)
    no_piecewise(ops.LAUNCHES, "phase 3 (variants)' traces and waves")
    sweep_launches = phase_sweeps(device, var_errs)
    no_piecewise(ops.LAUNCHES, "phase 3 (variants)' figure sweeps")
    log(f"phase 3 (variants): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    attn = phase_attention(device)
    mix_attn = phase_attention_mixtral(device)
    t1 = time.perf_counter()
    int8_attn = phase_attention_int8(device)
    log(f"phase 4: int8 pages: {time.perf_counter() - t1:.1f} s")
    ssd = phase_ssd(device)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve = phase_serve(device, args.seed)
    pressure = phase_pressure(device, serve)
    t1 = time.perf_counter()
    qwen2_int8 = phase_qwen2_int8(device, serve)
    log(f"phase 5: qwen2-0.5b int8: {time.perf_counter() - t1:.1f} s")
    sharded_runs = phase_sharded_serve(device, serve)
    phase_small_model(device, args.seed)
    mamba = phase_mamba_serve(device, args.seed,
                              [len(p) for p in serve["prompts"]],
                              aux_pairs.pop("grant"))
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    timing = phase_timing(device, serve, alloc_logs, pressure, waves)
    sh_timing = phase_sharded_timing(device, sh3, sharded_runs)
    # the models phase 7 serves again (weights already on the card)
    models = {"qwen2": (serve["engine"].model._model,
                        serve["engine"].params),
              "mamba": (mamba["engine"].model._model,
                        mamba["engine"].params)}
    del serve["engine"]
    mamba_dev = phase_mamba_profile(mamba)
    pw_timing = phase_piecewise_timing(pw_inputs, pw_errs)
    var_timing = phase_variants_timing(device)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mega = phase_mega(device, models, serve, mamba, {
        "qwen2-0.5b": (timing["busy"], 1e3 * serve["wall"]),
        MAMBA: (mamba_dev["busy"], 1e3 * mamba["wall"])})
    del models
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # the moe slice last, alone on the card: 47 GB of weights and 32 GB
    # of KV heaps leave no room for the other models
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 5: {MIXTRAL}: device memory before it "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    mix_model, mix_params, mix_prompts = mixtral_model(device, args.seed)
    mix_host = phase_mixtral_serve(device, mix_model, mix_params,
                                   mix_prompts)
    log(f"phase 5: {MIXTRAL}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mix_mega = phase_alone_mega(
        MIXTRAL, mixtral_engine(device, mix_model, mix_params,
                                mega_step=True, max_new_cap=32),
        mix_prompts, mix_host)
    del mix_params
    mega["runs"][f"{MIXTRAL} ({MIXTRAL_LAYERS} layers)"] = mix_mega
    log(f"phase 7: {MIXTRAL}: {time.perf_counter() - t0:.1f} s")

    # the int8 slice last, alone on the card: 70.4 GB of bf16 weights and
    # 6.9 GB of int8 KV heaps; mixtral's weights are gone first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"phase 5: {QWEN32}: device memory before it "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    q32_model, q32_params, q32_prompts = qwen32_model(device, args.seed)
    q32_host = phase_qwen32_serve(device, q32_model, q32_params,
                                  q32_prompts)
    log(f"phase 5: {QWEN32}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q32_mega = phase_alone_mega(
        QWEN32, qwen32_engine(device, q32_model, q32_params,
                              mega_step=True, max_new_cap=32),
        q32_prompts, q32_host)
    del q32_params
    mega["runs"][f"{QWEN32} (int8)"] = q32_mega
    log(f"phase 7: {QWEN32}: {time.perf_counter() - t0:.1f} s")

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    main_attn = attn[(torch.bfloat16, None)]
    kernels = []
    def aux_fields(S, kind):
        t = aux_pairs[S][kind]
        plain = ("plain_ms_298656_lanes" if aux_pairs[S]["plain_on"] != "cpu"
                 else "plain_cpu_ms_298656_lanes")
        geo = ({"chain_298656_lanes": aux_pairs[S]["chain"],
                "steps_298656_lanes": t["steps"],
                "launches_298656_lanes": t["launches"]}
               if kind == "alloc" else {"enqueue_298656_lanes": t["enqueue"]})
        if kind == "alloc" and "requeued" in aux_pairs[S]:
            r = aux_pairs[S]["requeued"]
            geo.update(ms_298656_lanes_requeued=r["ms"],
                       plain_cpu_ms_298656_lanes_requeued=r["plain"],
                       bound_ms_298656_lanes_requeued=r["bound"],
                       queued_chunks_298656_lanes_requeued=r["queued"],
                       chain_298656_lanes_requeued=r["chain"])
        return {"ms_298656_lanes": t["ms"], plain: t["plain"],
                "bound_ms_298656_lanes": t["bound"], **geo}

    def variant_runs(name):
        """The widened kernel's launches in phase 3 (variants)."""
        out = {"phase 3 (variants) traces and waves": var_launches[name]}
        if sweep_launches[name]:
            out["phase 3 (variants) figure sweeps"] = sweep_launches[name]
        return out

    def variant_fields(name):
        """Its time, plain time and bound per variant at the figure cell
        of 1024 x 256 B (variants whose kind launches it)."""
        t = {v: var_timing[v][name] for v in VARIANTS
             if name in var_timing[v]}
        return {"ms_by_variant_1024x256B": {v: x["ms"] for v, x in t.items()},
                "plain_ms_by_variant_1024x256B":
                    {v: x["plain"] for v, x in t.items()},
                "bound_ms_by_variant_1024x256B":
                    {v: x["bound"] for v, x in t.items()}}

    for name, kind in (("alloc_txn", "alloc"), ("free_txn", "free")):
        # phase 3 per transaction, both qwen2 serving runs' final words,
        # the 298,656-lane pair and mamba2's first grant and retirement
        err = dict(alloc_errs[kind])
        merge_err(err, *serve["replay_err"], *pressure["replay_err"])
        merge_err(err, (aux_pairs[1]["err"]["words"],
                        aux_pairs[1]["err"]["max_abs"]),
                  (mamba["errs"][kind]["words"],
                   mamba["errs"][kind]["max_abs"]),
                  (var_errs[name]["words"], var_errs[name]["max_abs"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/alloc_txn.cu",
            "replaces": ("src/repro/kernels/alloc_txn.py:284" if kind ==
                         "alloc" else "src/repro/kernels/alloc_txn.py:316"),
            "launches": serve["launches"][name],
            "max_abs_err": err["max_abs"], "max_err": err["max_abs"],
            "differing_words": err["words"],
            "launches_by_run": {"qwen2-0.5b": serve["launches"][name],
                                MAMBA: mamba["launches"][name],
                                f"{MIXTRAL} ({MIXTRAL_LAYERS} layers)":
                                    mix_host["launches"][name],
                                f"{QWEN32} (int8)":
                                    q32_host["launches"][name],
                                **{k: r["launches"][name]
                                   for k, r in qwen2_int8.items()},
                                **variant_runs(name)},
            "ms": timing["k_times"][kind][0],
            "plain_ms": mean(timing["p_times"][kind]),
            "bound_ms": mean(timing["bounds"][kind]), "bound_by": "bytes",
            "library_ms": None, **aux_fields(1, kind),
            **({"serving_device_ms_" + MAMBA: mamba_dev["free_txn"],
                "enqueue_" + MAMBA: mamba["enqueue"]} if kind == "free"
               else {}),
            **variant_fields(name)})
    # phase 3 per wave, and the pressure run's plans and final words
    err = dict(defrag_err)
    merge_err(err, *pressure["replay_err"],
              (var_errs["defrag_txn"]["words"],
               var_errs["defrag_txn"]["max_abs"]))
    dk = timing["defrag"]
    kernels.append({
        "name": "defrag_txn", "route": "cuda",
        "source": "src/repro_torch/csrc/defrag_txn.cu",
        "replaces": "src/repro/kernels/defrag_txn.py:71",
        "launches": pressure["launches"]["defrag_txn"],
        "launches_by_run": {"qwen2-0.5b under pressure":
                            pressure["launches"]["defrag_txn"],
                            **variant_runs("defrag_txn")},
        "max_abs_err": err["max_abs"], "max_err": err["max_abs"],
        "differing_words": err["words"],
        "ms": dk["ms"], "plain_ms": dk["plain"], "bound_ms": dk["bound"],
        "bound_by": "bytes", "library_ms": None,
        "ms_65536_pages": dk[65536]["ms"],
        "plain_ms_65536_pages": dk[65536]["plain"],
        "bound_ms_65536_pages": dk[65536]["bound"],
        **variant_fields("defrag_txn")})
    # phase 3 per transaction and wave, and both sharded runs' replays
    for name, kind, replaces in (
            ("sharded_alloc_txn", "alloc",
             "src/repro/kernels/alloc_txn.py:359"),
            ("sharded_free_txn", "free", "src/repro/kernels/alloc_txn.py:421"),
            ("sharded_defrag_txn", "defrag",
             "src/repro/kernels/defrag_txn.py:99")):
        err = dict(sharded_errs[kind])
        for run in sharded_runs.values():
            merge_err(err, *run["replay_err"])
        if kind != "defrag":
            merge_err(err, (aux_pairs[SHARDS]["err"]["words"],
                            aux_pairs[SHARDS]["err"]["max_abs"]))
        merge_err(err, (var_errs[name]["words"], var_errs[name]["max_abs"]))
        t = sh_timing[kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/defrag_txn.cu" if kind ==
                       "defrag" else "src/repro_torch/csrc/alloc_txn.cu"),
            "replaces": replaces,
            "launches": sum(run["launches"][name]
                            for run in sharded_runs.values()),
            "launches_by_run": {**{k: run["launches"][name]
                                   for k, run in sharded_runs.items()},
                                **variant_runs(name)},
            "max_abs_err": err["max_abs"], "max_err": err["max_abs"],
            "differing_words": err["words"],
            "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": "bytes", "library_ms": None,
            "ms_65536_pages": t[65536]["ms"],
            "plain_ms_65536_pages": t[65536]["plain"],
            "bound_ms_65536_pages": t[65536]["bound"],
            **(aux_fields(SHARDS, kind) if kind != "defrag" else {}),
            **({"serving_device_ms_by_run": {
                "under pressure": t["run_ms"],
                "rebalance": sh_timing["rebalance_" + (
                    "waves" if kind == "defrag" else "alloc")]["run_ms"]}}
               if kind != "free" else {}),
            **variant_fields(name)})
    attn_err = max([r["err"] for r in attn.values()]
                   + [r["err"] for r in mix_attn.values()]
                   + [r["err"] for r in int8_attn.values()]
                   + [mix_host["checked"]["err"], q32_host["checked"]["err"]])
    # the int8 runs: every paged_attention launch there read int8 pages
    int8_runs = {f"{QWEN32} (int8)": q32_host["launches"],
                 **{k: r["launches"] for k, r in qwen2_int8.items()},
                 f"mega {QWEN32} (int8)": q32_mega["launches"]}
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:66",
        "launches": serve["launches"]["paged_attention"],
        "launches_by_run": {
            "qwen2-0.5b": serve["launches"]["paged_attention"],
            f"{MIXTRAL} ({MIXTRAL_LAYERS} layers)":
                mix_host["launches"]["paged_attention"],
            **{k: r["paged_attention"] for k, r in int8_runs.items()
               if not k.startswith("mega")}},
        "max_abs_err": attn_err, "max_err": attn_err,
        "mixtral_serving_inputs_max_err": mix_host["checked"]["err"],
        # mixtral-8x7b's window (4096) and ring (258 slots) cases
        "ms_by_input_mixtral": {t: r["wall"] for t, r in mix_attn.items()},
        "device_ms_by_input_mixtral": {t: r["ms"]
                                       for t, r in mix_attn.items()},
        "plain_ms_by_input_mixtral": {t: r["plain"]
                                      for t, r in mix_attn.items()},
        "bound_ms_by_input_mixtral": {t: r["bound"]
                                      for t, r in mix_attn.items()},
        "max_abs_err_by_input_mixtral": {t: r["err"]
                                         for t, r in mix_attn.items()},
        "serving_device_ms_mixtral": mix_host["attn_ms"],
        # int8 pages with float32 scales: launches in the int8 runs, and
        # the phase 4 cases (unit, qwen1.5-32b's and mixtral's shapes;
        # one qwen1.5-32b case on bf16 pages beside them)
        "launches_int8": sum(r["paged_attention"]
                             for r in int8_runs.values()),
        "launches_int8_by_run": {k: r["paged_attention"]
                                 for k, r in int8_runs.items()},
        "ms_by_input_int8": {t: r["wall"] for t, r in int8_attn.items()},
        "device_ms_by_input_int8": {t: r["ms"]
                                    for t, r in int8_attn.items()},
        "plain_ms_by_input_int8": {t: r["plain"]
                                   for t, r in int8_attn.items()},
        "bound_ms_by_input_int8": {t: r["bound"]
                                   for t, r in int8_attn.items()},
        "max_abs_err_by_input_int8": {t: r["err"]
                                      for t, r in int8_attn.items()},
        f"{QWEN32}_serving_inputs_max_err": q32_host["checked"]["err"],
        f"{QWEN32}_serving_inputs_float64_err": q32_host["checked"]["k64"],
        f"{QWEN32}_serving_inputs_plain_float64_err":
            q32_host["checked"]["p64"],
        f"{QWEN32}_serving_inputs_bf16_staged_float64_err":
            q32_host["checked"]["c64"],
        f"serving_device_ms_{QWEN32}": q32_host["attn_ms"],
        # ms: CUDA events around the wrapper (its host work inside), as
        # for every earlier slice; device_ms: its kernels' profiler time
        "ms": main_attn["wall"], "plain_ms": main_attn["plain"],
        "bound_ms": main_attn["bound"], "bound_by": main_attn["by"],
        "library_ms": None, "device_ms": main_attn["ms"],
        "ms_by_input": {f"{str(dt).split('.')[-1]} "
                        f"{'offsets' if w else 'ids'}": r["wall"]
                        for (dt, w), r in attn.items()},
        "device_ms_by_input": {f"{str(dt).split('.')[-1]} "
                               f"{'offsets' if w else 'ids'}": r["ms"]
                               for (dt, w), r in attn.items()},
        "pages_per_split": main_attn["pps"],
        "splits": main_attn["splits"],
        "serving_device_ms": timing["attention"]})
    # the mamba2 run's prefills: each launch's chunk count, its time,
    # plain time and bound at that count, averaged over the run
    st_ = [ssd["times"][ch] for ch in mamba["chunks"]]
    by = {t["by"] for t in st_}
    err = max(ssd["err"], mamba["scan_err"])
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:66",
        "launches": mamba["launches"]["ssd_scan"],
        "max_abs_err": err, "max_err": err,
        "serving_inputs_max_err": mamba["scan_err"],
        # ms: CUDA events around the wrapper (its host work inside), as
        # for every earlier slice; device_ms: its three kernels' profiler
        # time
        "ms": mean([t["ms"] for t in st_]),
        "device_ms": mean([t["device"] for t in st_]),
        "plain_ms": mean([t["plain"] for t in st_]),
        "bound_ms": mean([t["bound"] for t in st_]),
        "bound_by": by.pop() if len(by) == 1 else "operations",
        "library_ms": None,
        "ms_by_chunks": {ch: t["ms"] for ch, t in ssd["times"].items()},
        "device_ms_by_chunks": {ch: t["device"]
                                for ch, t in ssd["times"].items()},
        "bound_ms_by_chunks": {ch: t["bound"]
                               for ch, t in ssd["times"].items()},
        "serving_device_ms": mamba_dev["ssd_scan"]})
    # phase 3 (piecewise): the traces' launches, their word errors and
    # the direct comparisons, the times at the traces' inputs
    for name, source, replaces in (
            ("ring_txn_pop", "ring_txn.cu", "kernels/alloc_txn.py:114"),
            ("ring_txn_push", "ring_txn.cu", "kernels/alloc_txn.py:182"),
            ("chunk_txn_claim", "bitmap_txn.cu", "kernels/alloc_txn.py:241"),
            ("ring_window", "ring_txn.cu", "kernels/ring_window.py:34"),
            ("bitmap_select", "bitmap_txn.cu",
             "kernels/bitmap_select.py:40")):
        t = pw_timing[name]
        by = t.get("by_width")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/{replaces}",
            "launches": pw_launches[name],
            "max_abs_err": pw_errs[name]["max_abs"],
            "max_err": pw_errs[name]["max_abs"],
            "differing_words": pw_errs[name]["words"],
            "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": "bytes", "library_ms": None,
            **({"launches_by_path": {p[len(name) + 1:]: m
                                     for p, m in pw_paths.items()
                                     if p.startswith(name)},
                **{key: {w: r[k] for w, r in by.items()}
                   for key, k in (("ms_by_width", "ms"),
                                  ("plain_ms_by_width", "plain"),
                                  ("bound_ms_by_width", "bound"),
                                  ("path_by_width", "path"))}}
               if by else {})})
    # each kernel's launches in the mega-step runs (phase 7)
    for k in kernels:
        k["launches_by_mega_run"] = {run: r["launches"].get(k["name"], 0)
                                     for run, r in mega["runs"].items()}
    p_toks = sum(len(t) for t in serve["tokens"].values())
    log(f"phase 7: mega-step against the host loop, tok/s: " + "; ".join(
        f"{run} {r['tok_s']:.1f}" for run, r in mega["runs"].items())
        + f" (host loop, phase 5: qwen2-0.5b {serve['tok_s']:.1f}, under "
        f"pressure {p_toks / pressure['wall']:.1f}, sharded under pressure "
        f"{sharded_runs['pressure']['tok_s']:.1f}, {MAMBA} "
        f"{mamba['tok_s']:.1f}); launches_per_tick "
        f"{json.dumps(mega['launches_per_tick'])}")
    log(f"total {time.perf_counter() - t_start:.1f} s; serving "
        f"{serve['tok_s']:.1f} tok/s; under pressure "
        f"{p_toks / pressure['wall']:.1f} tok/s; sharded "
        + "; ".join(f"{k} {r['tok_s']:.1f} tok/s"
                    for k, r in sharded_runs.items())
        + f"; {MAMBA} {mamba['tok_s']:.1f} tok/s; {MIXTRAL} "
        f"({MIXTRAL_LAYERS} layers) {mix_host['tok_s']:.1f} tok/s host loop, "
        f"{mix_mega['tok_s']:.1f} mega; qwen2-0.5b int8 "
        f"{qwen2_int8['qwen2-0.5b int8']['tok_s']:.1f} tok/s, under pressure "
        f"{qwen2_int8['qwen2-0.5b int8 under pressure']['tok_s']:.1f}; "
        f"{QWEN32} (int8) {q32_host['tok_s']:.1f} tok/s host loop, "
        f"{q32_mega['tok_s']:.1f} mega")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
