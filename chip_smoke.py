#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold every kernel
against its plain version.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. the card (``nvidia-smi`` name and power limit); TF32 off;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. ``alloc_txn``/``free_txn`` against the plain allocator math on CPU
   copies of the same words: seeded alloc/free traces over mixed size
   classes on the serving engine's arena geometry sized for 65536 pages,
   lane widths 16 and 4096; ``mem``, ``ctl`` and offsets identical after
   every transaction;
4. ``paged_attention`` against its plain version at qwen2-0.5b decode
   shapes (B 8, Hq 14, Hkv 2, D 64, page 16, P 32), ragged lengths and
   holes, page-id and word-offset tables, float32 and bf16 (both sides
   widen the same values to float32: atol 1e-5 for each);
5. serve full-width qwen2-0.5b (random weights from ``--seed``) in bf16:
   16 requests, prompts 16-448 tokens, 32 new tokens each, max_batch 8,
   max_seq 512.  The launch counters are zeroed just before and read just
   after; every transaction's lanes are recorded and replayed through the
   plain math on the CPU, which must end on the engine's arena words.  A
   small float32 model is then served on the card and on the CPU and must
   give the same tokens;
6. one JSON line of per-kernel numbers, then the card line, then the
   result line ``{"ok": true, "device": {...}}`` last.

Any failure raises: the script exits non-zero and prints no result line.
It exits non-zero at once when no CUDA device is present or when the
package sources are not beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores


def log(*a):
    print(*a, flush=True)


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
                  "paged_attention": "paged_attention_kernel"}


class DeviceProfile:
    """``torch.profiler`` over a block of work: device time and launch
    count of each kernel whose symbol contains a given name."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.rows = []
        for evt in self._prof.key_averages():
            us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0) or 0)
            if us > 0:
                self.rows.append((evt.key, float(us), int(evt.count)))
        self.rows.sort(key=lambda r: -r[1])
        return False

    def kernel(self, name: str):
        """(mean ms per launch, launches) of the named kernel."""
        us = sum(r[1] for r in self.rows if name in r[0])
        n = sum(r[2] for r in self.rows if name in r[0])
        return (us / n / 1e3 if n else None), n

    def busy_ms(self) -> float:
        return sum(r[1] for r in self.rows) / 1e3


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


def attn_bound_ms(q, k, table, seq, wpp) -> tuple:
    """Least time for this input: valid K and V bytes + q + out + table,
    or the float32 operations, whichever is larger."""
    import torch
    from repro_torch.kernels.ref import page_ids
    B, Hq, D = q.shape
    NP, page, Hkv, _ = k.shape
    P = table.shape[1]
    pid = page_ids(table, wpp).cpu()
    tok = torch.arange(P * page)
    valid = (tok[None, :] < seq.cpu()[:, None].long()) \
        & (pid >= 0).repeat_interleave(page, 1)
    t_valid = int(valid.sum())
    el = k.element_size()
    nbytes = (2 * t_valid * Hkv * D * el + q.numel() * q.element_size()
              + B * Hq * D * 4 + table.numel() * 4 + B * 4)
    flops = 4 * t_valid * (Hq // Hkv) * Hkv * D
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_attention(device):
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
            ms = time_ms(lambda: pa_kernel.paged_attention(
                q, k, v, table, seq, wpp=wpp), 200)
            plain = time_ms(lambda: ref.paged_attention(
                q, k, v, table, seq, wpp=wpp), 10)
            bound, by = attn_bound_ms(q, k, table, seq, wpp)
            tag = f"{str(dtype).split('.')[-1]} {'offsets' if wpp else 'ids'}"
            log(f"phase 4: paged_attention {tag}: max error {err:.3g} "
                f"(atol {atol}); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bound:.5f} ms ({by})")
            res[(dtype, wpp)] = dict(err=err, ms=ms, plain=plain,
                                     bound=bound, by=by)
    return res


# ---------------------------------------------------------------------------
# phase 5: serve full-width qwen2-0.5b through the kernels
# ---------------------------------------------------------------------------

class RecordingOuroboros:
    """Delegates to the engine's allocator and keeps a CPU copy of every
    transaction's lanes (and the offsets it granted)."""

    def __init__(self, ouro):
        self._ouro = ouro
        self.log = []

    def __getattr__(self, name):
        return getattr(self._ouro, name)

    def alloc(self, state, sizes, mask):
        state, offs = self._ouro.alloc(state, sizes, mask)
        self.log.append(("alloc", sizes.cpu(), mask.cpu(), offs.cpu()))
        return state, offs

    def free(self, state, offs, sizes, mask):
        self.log.append(("free", offs.cpu(), sizes.cpu(), mask.cpu()))
        return self._ouro.free(state, offs, sizes, mask)


class CountingModel:
    """Delegates to the model and counts decode ticks."""

    def __init__(self, model):
        self._model = model
        self.decode_calls = 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *a, **kw):
        self.decode_calls += 1
        return self._model.decode_step(*a, **kw)


def make_requests(cfg, seed, n, lo, hi):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def replay_plain(ouro, log_):
    """Replay recorded transactions through the plain math of a CPU
    allocator; returns (arena, (differing offsets, their max absolute
    difference)) against the offsets the engine's kernel granted."""
    st = ouro.init()
    bad = {"words": 0, "max_abs": 0}
    for rec in log_:
        if rec[0] == "alloc":
            st, offs = ouro.alloc(st, rec[1], rec[2])
            merge_err(bad, word_err(rec[3], offs))
        else:
            st = ouro.free(st, rec[1], rec[2], rec[3])
    return st, (bad["words"], bad["max_abs"])


def replay_kernels(ouro, log_):
    """Replay recorded transactions on a fresh arena on the card, inputs
    staged first.  Returns {kind: (mean device ms per launch as
    ``torch.profiler`` reports it, launches it reported, launches
    made)}; the profiler can drop a launch's record, never add one."""
    st = ouro.init()
    dev = st.mem.device
    staged = [(rec[0], [x.to(dev) for x in rec[1:4]]) for rec in log_]
    with DeviceProfile() as prof:
        for kind, args in staged:
            if kind == "alloc":
                ouro.alloc(st, args[0], args[1])
            else:
                ouro.free(st, *args)
    out = {}
    for kind in ("alloc", "free"):
        ms, n = prof.kernel(KERNEL_SYMBOLS[f"{kind}_txn"])
        want = sum(k == kind for k, _ in staged)
        if not 0 < n <= want:
            raise AssertionError(f"profiler saw {n} {kind}_txn launches with "
                                 f"device time, {want} were made")
        out[kind] = (ms, n, want)
    return out


def time_plain_txns(ouro, log_):
    """The plain math on the card's tensors, each recorded transaction
    timed with CUDA events (it reads scalars back, so it syncs).
    Returns {kind: [ms, ...]}."""
    import torch
    from repro_torch.core import transactions as T
    st = ouro.init()
    out = {"alloc": [], "free": []}
    dev = st.mem.device
    for rec in log_:
        args = [x.to(dev) for x in rec[1:4]]
        a, b = _events()
        a.record()
        if rec[0] == "alloc":
            T.alloc_math(ouro.cfg, ouro.kind, ouro.family, st.mem, st.ctl,
                         args[0], args[1])
        else:
            T.free_math(ouro.cfg, ouro.kind, ouro.family, st.mem, st.ctl,
                        *args)
        b.record()
        torch.cuda.synchronize()
        out[rec[0]].append(a.elapsed_time(b))
    return out


def txn_bound_ms(ouro_cpu, log_):
    """Per-transaction least time (bytes): lane inputs and outputs, the
    ctl block read and written, and every arena word the transaction
    changed read and written once, at the device memory rate."""
    import torch
    st = ouro_cpu.init()
    lay = ouro_cpu.layout
    out = {"alloc": [], "free": []}
    for rec in log_:
        before = st.mem.clone()
        if rec[0] == "alloc":  # sizes + mask in, offsets out
            st, _ = ouro_cpu.alloc(st, rec[1], rec[2])
        else:                  # offsets + sizes + mask in
            st = ouro_cpu.free(st, rec[1], rec[2], rec[3])
        changed = int((st.mem != before).sum())
        nbytes = 9 * rec[1].shape[0] + 8 * lay.ctl_words + 8 * changed
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

    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    ticks = counting.decode_calls

    toks = sum(len(r.out_tokens) for r in done)
    st = dict(eng.stats)
    log(f"phase 5: served {len(done)} requests, {toks} tokens, "
        f"{st['steps']} steps, {counting.decode_calls} decode ticks in "
        f"{wall:.2f} s: {toks / wall:.1f} tok/s (prefill included)")
    log(f"phase 5: stats {json.dumps(st)}")
    log(f"phase 5: launches {json.dumps(launches)}")
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
    want_pa = cfg.num_layers * counting.decode_calls
    if launches["paged_attention"] != want_pa:
        raise AssertionError(f"paged_attention launches "
                             f"{launches['paged_attention']} != "
                             f"{want_pa}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    # the recorded lanes, replayed through the plain math on the CPU
    from repro_torch.paged.kv_cache import make_kv_allocator
    cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu")
    st_cpu, e_off = replay_plain(cpu_ouro, rec.log)
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
                replay_err=(e_off, e_mem, e_ctl))


def phase_timing(device, serve, alloc_logs):
    """Kernel times on the device from ``torch.profiler``, taken after
    the serving run so that the profiler's hooks cannot slow it: the
    allocator kernels on the engine's recorded transactions and on the
    phase-3 traces, the plain math at the engine's inputs, and where the
    serving run's device time went."""
    from repro_torch.paged.kv_cache import make_kv_allocator
    eng = serve["engine"]
    dev_ouro = eng.ouro._ouro
    cpu_ouro, _, _ = make_kv_allocator(eng.num_pages, device="cpu")
    k_times = replay_kernels(dev_ouro, serve["log"])
    p_times = time_plain_txns(dev_ouro, serve["log"])
    bounds = txn_bound_ms(cpu_ouro, serve["log"])
    for kind in ("alloc", "free"):
        ms, n, want = k_times[kind]
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

    # where the serving run's device time went: the same traffic again
    # under the profiler (its wall is the profiler's, not the server's)
    eng.ouro = dev_ouro
    eng.alloc_state = eng.ouro.init()
    for p in serve["prompts"]:
        eng.submit(p, max_new_tokens=32)
    with DeviceProfile() as prof:
        eng.run_until_done()
    busy = prof.busy_ms()
    wall = 1e3 * serve["wall"]
    log(f"phase 6: serving device busy {busy:.0f} ms of the unprofiled "
        f"run's {wall:.0f} ms wall: device idle {100 * (1 - busy / wall):.1f}%")
    for key, us, n in prof.rows[:8]:
        log(f"phase 6:   {us / 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    return dict(k_times=k_times, p_times=p_times, bounds=bounds)


def phase_small_model(device, seed):
    """A float32 smoke-size model served on the card and on the CPU from
    the same weights: identical tokens and final arena words."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = get_arch("qwen2-0.5b").smoke()
    model = build_model(cfg)
    params = model.init(seed, device="cpu")
    prompts = make_requests(cfg, seed + 1, 5, 4, 40)
    outs = []
    for dev in (device, "cpu"):
        p_dev = {"embed": params["embed"].to(dev),
                 "final_norm": {k: v.to(dev) for k, v in
                                params["final_norm"].items()},
                 "blocks": [{g: {n: w.to(dev) for n, w in leaves.items()}
                             for g, leaves in b.items()}
                            for b in params["blocks"]]}
        eng = ServingEngine(model, p_dev, max_batch=2, max_seq=96,
                            kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        toks = {r.uid: r.out_tokens for r in eng.run_until_done()}
        outs.append((toks, eng.alloc_state.mem.cpu(),
                     eng.alloc_state.ctl.cpu()))
    (tg, mg, cg), (tc, mc, cc) = outs
    if tg != tc:
        raise AssertionError(f"float32 smoke model: card tokens {tg} != "
                             f"CPU tokens {tc}")
    if not (torch.equal(mg, mc) and torch.equal(cg, cc)):
        raise AssertionError("float32 smoke model: arena words differ")
    log(f"phase 5: float32 smoke model on the card and the CPU: "
        f"{len(tg)} requests, identical tokens and arena words")


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

    t0 = time.perf_counter()
    alloc_logs, alloc_errs = phase_alloc(device, seed=args.seed)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    attn = phase_attention(device)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve = phase_serve(device, args.seed)
    phase_small_model(device, args.seed)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    timing = phase_timing(device, serve, alloc_logs)
    del serve["engine"]
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    main_attn = attn[(torch.bfloat16, None)]
    kernels = []
    for name, kind in (("alloc_txn", "alloc"), ("free_txn", "free")):
        # phase 3 per transaction, and the serving run's final words
        err = dict(alloc_errs[kind])
        merge_err(err, *serve["replay_err"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/alloc_txn.cu",
            "replaces": ("src/repro/kernels/alloc_txn.py:284" if kind ==
                         "alloc" else "src/repro/kernels/alloc_txn.py:316"),
            "launches": serve["launches"][name],
            "max_abs_err": err["max_abs"], "max_err": err["max_abs"],
            "differing_words": err["words"],
            "ms": timing["k_times"][kind][0],
            "plain_ms": mean(timing["p_times"][kind]),
            "bound_ms": mean(timing["bounds"][kind]), "bound_by": "bytes",
            "library_ms": None})
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:66",
        "launches": serve["launches"]["paged_attention"],
        "max_abs_err": max(r["err"] for r in attn.values()),
        "max_err": max(r["err"] for r in attn.values()),
        "ms": main_attn["ms"], "plain_ms": main_attn["plain"],
        "bound_ms": main_attn["bound"], "bound_by": main_attn["by"],
        "library_ms": None})
    log(f"phase 6: total {time.perf_counter() - t_start:.1f} s; serving "
        f"{serve['tok_s']:.1f} tok/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
