"""Hold two checkouts of this repository side by side on one card.

    python3 compare_trees.py --other DIR [--rounds 4]

DIR is a second checkout (for example the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists); this
checkout is "this".  Each tree builds its own kernels into its own
``build/``.  Printed, one JSON line each:

1. ``paged_attention`` of each tree at ``chip_smoke.py`` phase 4's inputs
   (four lines: bf16 and float32, page ids and word offsets), and
   ``ssd_scan`` at phase 4's bf16 inputs of 1-7 chunks (one line each),
   in the order other, this, this, other, each in its own process (the
   two trees' packages share names): the time a call on CUDA events
   around the wrapper (its host work inside; 200 attention calls, 50
   scans) and the profiler device time a call (each of the tree's
   ``paged_attention*`` or ``ssd_*`` kernels' mean over the launches
   recorded in 50 calls, summed); then the largest difference between
   the two trees' scan outputs (y and h_final) at each chunk count.
2. The two trees' ``alloc_txn.cu`` on the same words: ``alloc_txn`` of
   one mamba2-780m admission (298,656 pages of 256 B) on the serving
   engine's fresh arena, ``free_txn`` of its retirement (granted by
   this tree's ``alloc_txn``), ``alloc_txn`` of the next admission (the
   freed chunks in the class queue), then ``sharded_free_txn`` of the
   same retirement on the 4-shard arena; both libraries are loaded in one process and launched
   in turns (other, this, this, other per round) from a copy of the
   words, each launch timed by CUDA events (every kernel a call
   launches inside); both must leave identical words and offsets.
3. The two trees' sharded kernels on the same words, launched in turns
   as in 2 (every kernel a call launches inside the timed span):
   ``sharded_alloc_txn`` of one 298,656-lane admission on the mamba2
   engine's fresh 4-shard arena and of a 4096-lane transaction of mixed
   sizes on the 4-shard arena for 65536 pages (after a short trace), both
   with hashed homes; ``sharded_defrag_txn``: a rebalance wave on the
   engine's 4-shard arena for 256 pages (every page homed on shard 0,
   two of three freed) and a compaction and a rebalance wave on the
   4-shard arena for 65536 pages (4 x 1,033 chunks) after the reference
   defrag test's churn.  Each line gives both trees' times and the
   largest difference between the words and offsets they leave, which
   must be 0.
4. This tree's ``sharded_alloc_txn`` on its two paths at inputs shaped
   like a serving engine's (16 and 32 lanes of 256 B on the 4-shard
   arena for 256 pages, every lane of one home, on a fresh arena and
   with the home shard full; 32 lanes homed on every shard in turn):
   the warp-sized block this tree picks for 32 lanes or fewer, and the
   grid path (partition and attempt launches) of a build with
   ``-DSHARDED_GRID_LANES=0``, in turns on the same words as in 2 (CUDA
   events, largest word difference, which must be 0), and each path's
   profiler device time a call (each kernel's mean a launch times the
   launches the kernels counted on the card, over the calls).
5. Each tree's ``free_txn_kernel`` instances: registers from the build's
   ``ptxas -v`` report and SASS instructions from ``cuobjdump``.
6. Each tree's full-width mamba2-780m and qwen2-0.5b (random weights
   from seed 0, bf16) serving ``chip_smoke.py`` phase 5's traffic, each
   tree in its own process, qwen2 as phase 5 serves it: unpressured,
   under pressure, and on 4 shards with rebalance waves and under
   pressure: a digest of every request's tokens per run, and whether
   the two trees' tokens are the same in every run.
7. The two trees' ``ring_txn.cu`` on the same words: ``ring_txn_pop``
   and ``ring_txn_push`` at each width ``chip_smoke.py`` phase 6 times
   them (``ring_widths``: one lane of a class ring and of the pool, 16
   and 4096 lanes, init's widest push) on the ring page variant's class
   rings after a 4096-lane alloc and free on the serving engine's
   geometry for 65536 pages, launched in turns as in 2 (a push from a
   copy of the store); each line gives both trees' CUDA event times, the
   profiler device time a call of each in four sessions in turns (every
   kernel whose name holds the step's, summed), this tree's path as its
   kernels counted it, and the largest difference between the words the
   two trees leave, which must be 0.

``--sections`` runs a subset (for example ``--sections 7``).  Exits
non-zero without a card.  Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (helpers only; imports no package)

ATTN_INPUTS = [("bfloat16", None), ("bfloat16", 64), ("float32", None),
               ("float32", 64)]


def device_ms(call, reps, label, word, tries=3):
    """Profiler device time of one ``call()``: each kernel whose name
    holds ``word``, its mean over the launches recorded in ``reps``
    calls, summed; and the kernels.  A session that records none of
    them (the profiler can drop a whole session's records) is run
    again, up to ``tries`` sessions."""
    call()
    for _ in range(tries):
        with cs.DeviceProfile() as prof:
            for _ in range(reps):
                call()
        kernels = {key: (us / n / 1e3, n) for key, us, n in prof.rows
                   if word in key}
        if kernels:
            return (sum(ms for ms, _ in kernels.values()),
                    {key[:60]: [ms, n] for key, (ms, n) in kernels.items()})
    raise RuntimeError(f"{label}: the profiler recorded no {word} kernel in "
                       f"{tries} sessions")


def scan_worker(label: str, out_path: str) -> dict:
    """This process's ``ssd_scan`` at phase 4's bf16 inputs of 1-7
    chunks: events ms and device ms a call; its outputs saved to
    ``out_path`` for the comparison of the two trees."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    out, outputs = {}, {}
    for chunks in range(1, 8):
        x, dt, a, b, c = cs.ssd_inputs("cuda", chunks)

        def call():
            return ssd.ssd_scan(x, dt, a, b, c, chunk=cs.SSD_SHAPE["Q"])

        events = cs.time_ms(call, 50)
        dev, kernels = device_ms(call, 50, label, "ssd_")
        outputs[chunks] = tuple(t.cpu() for t in call())
        out[chunks] = dict(events_ms=events, device_ms=dev, kernels=kernels)
    torch.save(outputs, out_path)
    return out


def digest(done) -> dict:
    """The digest and count of every request's tokens, in uid order."""
    import hashlib
    toks = [[int(t) for t in r.out_tokens]
            for r in sorted(done, key=lambda r: r.uid)]
    return dict(digest=hashlib.sha256(json.dumps(toks).encode()).hexdigest(),
                tokens=sum(len(t) for t in toks))


def tokens_worker() -> dict:
    """This process's mamba2-780m engine on phase 5's traffic, then
    qwen2-0.5b's engine on it as phase 5 serves it (unpressured, under
    pressure with the co-tenant, on 4 shards with rebalance waves and
    under pressure with both co-tenants): each run's tokens' digest and
    count."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine
    qwen = get_arch("qwen2-0.5b")
    requests = cs.make_requests(qwen, 0, 16, 16, 448)
    cfg = get_arch(cs.MAMBA)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prompts = cs.prompts_of_lengths(cfg, 0, [len(p) for p in requests])
    eng, _, _ = cs.mamba_engine(model, params, prompts, False, "cuda")
    out = {cs.MAMBA: digest(eng.run_until_done())}
    del eng, model, params
    torch.cuda.empty_cache()
    model = build_model(qwen)
    params = model.init(0, device="cuda")
    runs = ((("qwen2-0.5b", {}, False, False),
             ("qwen2-0.5b under pressure", cs.PRESSURE, True, False))
            + tuple((f"qwen2-0.5b sharded {name}", kw, pressured, pressured)
                    for name, kw, pressured, _ in cs.SHARDED_RUNS))
    for name, kw, cotenant, holder in runs:
        eng = ServingEngine(model, params, max_batch=8, max_seq=512,
                            kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device="cuda", **kw)
        if cotenant:
            cs.cotenant(eng)
        if holder:
            cs.holder(eng)
        for p in requests:
            eng.submit(p, max_new_tokens=32)
        out[name] = digest(eng.run_until_done())
    return out


def run_tokens(trees) -> dict:
    out = {}
    for label in ("this", "other"):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[label], "src"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tokens-worker"], env=env, cwd=trees[label],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{label} tokens worker failed:\n"
                               f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        out[label] = json.loads(r.stdout.splitlines()[-1])
    out["same"] = all(out["this"][k]["digest"] == out["other"][k]["digest"]
                      for k in out["this"])
    return out


def attention_worker(label: str) -> dict:
    """This process's ``repro_torch`` (PYTHONPATH picks the tree) at
    phase 4's inputs: events ms and device ms a call, per input."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    out = {}
    for dt, wpp in ATTN_INPUTS:
        q, k, v, table, seq = cs.attn_inputs("cuda", getattr(torch, dt), wpp)

        def call():
            return pa.paged_attention(q, k, v, table, seq, wpp=wpp)

        events = cs.time_ms(call, 200)
        dev, kernels = device_ms(call, 50, label, "paged_attention")
        out[f"{dt} {'offsets' if wpp else 'ids'}"] = dict(
            events_ms=events, device_ms=dev, kernels=kernels)
    return out


def run_workers(trees, tmp) -> tuple:
    """Each tree's worker in turns (other, this, this, other): its
    attention and scan lines, and the largest difference between the two
    trees' scan outputs (y, h_final) per chunk count."""
    import torch
    rows, saved = [], {}
    for k, label in enumerate(("other", "this", "this", "other")):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[label], "src"))
        path = os.path.join(tmp, f"scan-{k}.pt")
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", label, "--out", path], env=env,
                           cwd=trees[label], capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{label} worker failed:\n"
                               f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        rows.append(dict(tree=label, **json.loads(r.stdout.splitlines()[-1])))
        saved.setdefault(label, path)
    a, b = (torch.load(saved[t]) for t in ("this", "other"))
    diff = {ch: [float((x - y).abs().max()) for x, y in zip(a[ch], b[ch])]
            for ch in a}
    return rows, diff


def other_lib(other: str, name: str = "alloc_txn") -> str:
    """Build one of the other tree's kernel sources with its own build
    module; returns the library's path."""
    code = ("from repro_torch.kernels import build; "
            f"build.build_all([{name!r}]); "
            f"print(build._target({name!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=other,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(other, "src")),
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"other tree's {name} build failed:\n"
                           f"{r.stderr[-4000:]}")
    return r.stdout.strip().splitlines()[-1]


def in_turns(libs, rounds, words, launch):
    """Each tree's ``launch(lib)`` from a copy of ``words`` (the arena's
    mem and ctl), in turns (other, this, this, other per round, after a
    round that warms both up), timed by CUDA events; both trees must
    leave identical words and outputs.  Returns each tree's sorted ms and
    median, and the largest difference between what the two left."""
    import torch
    mem, ctl = words[2], words[3]
    times = {"this": [], "other": []}
    left = {}
    for r in range(rounds + 1):
        for label in ("other", "this", "this", "other"):
            mem.copy_(words[0])
            ctl.copy_(words[1])
            a, b = cs._events()
            a.record()
            out = launch(libs[label])
            b.record()
            torch.cuda.synchronize()
            if r:
                times[label].append(a.elapsed_time(b))
            if label not in left:
                left[label] = (mem.clone(), ctl.clone(), out)
    diff = max((int((x.long() - y.long()).abs().max()) if x.numel() else 0)
               for x, y in zip(left["this"], left["other"]))
    if diff:
        raise AssertionError(f"the two trees' kernels left different words "
                             f"(largest difference {diff})")
    out = {label: dict(ms=sorted(t), median_ms=sorted(t)[len(t) // 2])
           for label, t in times.items()}
    out["max_word_diff"] = diff
    return out


def run_aux(other_so: str, rounds: int) -> dict:
    """Both trees' ``alloc_txn`` of one mamba2-780m admission (298,656
    pages of 256 B) on a fresh arena, both trees' ``free_txn`` of its
    retirement (granted by this tree's ``alloc_txn``), then both trees'
    ``alloc_txn`` of the next admission (the freed chunks in the class
    queue), then both trees' ``sharded_free_txn`` of the retirement on
    the 4-shard arena, each on copies of the same words."""
    import torch
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator
    n, n_pages = cs.aux_geometry()
    o, _, _ = make_kv_allocator(n_pages, device="cuda")
    st = o.init()
    fresh = (st.mem.clone(), st.ctl.clone())
    sizes = torch.full((n,), 256, dtype=torch.int32, device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    _, offs = o.alloc(st, sizes, mask)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    fo = offs[perm.to("cuda")].contiguous()
    granted = (st.mem.clone(), st.ctl.clone())
    o.free(st, fo, sizes, mask)
    freed = (st.mem.clone(), st.ctl.clone())
    desc = AT.descriptor(o.layout)
    libs = {"this": AT._lib(), "other": ctypes.CDLL(other_so)}
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for lib in libs.values():
        lib.free_txn_launch.argtypes = [AT.ArenaDesc, P, P, P, P, P, I, P, P]
        lib.alloc_txn_launch.argtypes = [AT.ArenaDesc, P, P, P, P, I, P, P,
                                         P]
        lib.free_txn_launch.restype = lib.alloc_txn_launch.restype = I
        lib.free_txn_workspace_bytes.argtypes = [AT.ArenaDesc, I, I, Z]
        lib.alloc_txn_workspace_bytes.argtypes = [AT.ArenaDesc, I, Z]
        lib.free_txn_workspace_bytes.restype = Z
        lib.alloc_txn_workspace_bytes.restype = Z
    stream = AT._stream(st.mem.device)

    def free(lib):
        ws = AT.workspace(lib.free_txn_workspace_bytes(
            desc, n, 1, AT.TABLE_SMEM_LIMIT), "cuda")
        err = lib.free_txn_launch(desc, st.mem.data_ptr(), st.ctl.data_ptr(),
                                  fo.data_ptr(), sizes.data_ptr(),
                                  mask.data_ptr(), n, AT._ptr(ws), stream)
        if err:
            raise RuntimeError(f"free_txn: CUDA error {err}")
        return st.ctl[:0]

    def alloc(lib):
        ws = AT.workspace(lib.alloc_txn_workspace_bytes(
            desc, n, AT.TABLE_SMEM_LIMIT), "cuda")
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        err = lib.alloc_txn_launch(desc, st.mem.data_ptr(),
                                   st.ctl.data_ptr(), sizes.data_ptr(),
                                   mask.data_ptr(), n, out.data_ptr(),
                                   AT._ptr(ws), stream)
        if err:
            raise RuntimeError(f"alloc_txn: CUDA error {err}")
        return out

    out = {"alloc_txn, the first admission": in_turns(
               libs, rounds, fresh + (st.mem, st.ctl), alloc),
           "free_txn, the retirement": in_turns(
               libs, rounds, granted + (st.mem, st.ctl), free),
           "alloc_txn, the next admission": in_turns(
               libs, rounds, freed + (st.mem, st.ctl), alloc)}
    del st, fresh, granted, freed

    # the same retirement on the 4-shard arena
    S = cs.SHARDS
    o, _, _ = make_kv_allocator(n_pages, device="cuda", num_shards=S)
    st = o.init()
    _, offs = o.alloc(st, sizes, mask)
    fo = offs[perm.to("cuda")].contiguous()
    granted = (st.mem.clone(), st.ctl.clone())
    lay = o.layout.shard   # one shard's layout, as the wrapper passes it
    desc = AT.descriptor(lay)
    for lib in libs.values():
        lib.sharded_free_txn_launch.argtypes = [AT.ArenaDesc, P, P, I, I, I,
                                                P, P, P, I, P, P]
        lib.sharded_free_txn_launch.restype = I

    def sharded_free(lib):
        ws = AT.workspace(lib.free_txn_workspace_bytes(
            desc, n, S, AT.TABLE_SMEM_LIMIT), "cuda")
        err = lib.sharded_free_txn_launch(
            desc, st.mem.data_ptr(), st.ctl.data_ptr(), S, lay.mem_words,
            lay.ctl_words, fo.data_ptr(), sizes.data_ptr(), mask.data_ptr(),
            n, AT._ptr(ws), stream)
        if err:
            raise RuntimeError(f"sharded_free_txn: CUDA error {err}")
        return st.ctl[:0]

    out["sharded_free_txn, the retirement on 4 shards"] = in_turns(
        libs, rounds, granted + (st.mem, st.ctl), sharded_free)
    return out


def smem_limit(tree: str) -> int:
    """A tree's lane-table limit (its wrappers' ``TABLE_SMEM_LIMIT``),
    read from its source: the two trees' kernels may keep different
    static shared memory beside their tables."""
    text = open(os.path.join(tree, "src", "repro_torch", "kernels",
                             "alloc_txn.py")).read()
    return int(eval(re.search(r"^TABLE_SMEM_LIMIT = (.+)$", text,
                              re.M).group(1), {}))


def run_sharded(trees, sos, rounds: int) -> dict:
    """Both trees' ``sharded_alloc_txn`` and ``sharded_defrag_txn`` on
    copies of the same words, in turns (section 3), each through its own
    launcher signature: a launcher that takes the lane-table limit and a
    wave workspace counted over the shards are this slice's."""
    import numpy as np
    import torch
    from repro_torch.core import shards
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator
    S = cs.SHARDS
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    alibs = {label: ctypes.CDLL(sos[label]["alloc_txn"]) for label in sos}
    dlibs = {label: ctypes.CDLL(sos[label]["defrag_txn"]) for label in sos}
    limit = {}
    for label in sos:
        a, d = alibs[label], dlibs[label]
        limit[a._name] = limit[d._name] = smem_limit(trees[label])
        new = hasattr(a, "sharded_alloc_txn_grid")
        a.sharded_alloc_txn_workspace_bytes.argtypes = [AT.ArenaDesc, I, Z]
        a.sharded_alloc_txn_workspace_bytes.restype = Z
        a.sharded_alloc_txn_launch.argtypes = (
            [AT.ArenaDesc, P, P, I, I, I, P, P, P, I, I, P, P]
            + ([Z] if new else []) + [P])
        a.sharded_alloc_txn_launch.restype = I
        a._new = new
        new = hasattr(d, "defrag_txn_rebuild_stats")
        d.defrag_txn_workspace_bytes.argtypes = (
            [AT.ArenaDesc] + ([I] if new else []) + [Z])
        d.defrag_txn_workspace_bytes.restype = Z
        d.sharded_defrag_txn_launch.argtypes = [AT.ArenaDesc, P, P, I, I, I,
                                                P, P, P, I, P, P]
        d.sharded_defrag_txn_launch.restype = I
        d._new = new
    out = {}

    def alloc_case(what, o, st, sizes, mask):
        lay = o.layout.shard
        desc = AT.descriptor(lay)
        n = sizes.shape[0]
        home = shards.home_shards(n, S, None, device="cuda")
        stream = AT._stream(st.mem.device)

        def launch(lib):
            lim = limit[lib._name]
            ws = AT.workspace(lib.sharded_alloc_txn_workspace_bytes(
                desc, n, lim), "cuda")
            offs = torch.empty(n, dtype=torch.int32, device="cuda")
            err = lib.sharded_alloc_txn_launch(
                desc, st.mem.data_ptr(), st.ctl.data_ptr(), S, lay.mem_words,
                lay.ctl_words, sizes.data_ptr(), mask.data_ptr(),
                home.data_ptr(), n, o.walk, offs.data_ptr(), AT._ptr(ws),
                *([lim] if lib._new else []), stream)
            if err:
                raise RuntimeError(f"sharded_alloc_txn: CUDA error {err}")
            return offs

        words = (st.mem.clone(), st.ctl.clone(), st.mem, st.ctl)
        out[what] = in_turns(alibs, rounds, words, launch)

    def wave_case(what, o, st, kind):
        lay = o.layout.shard
        desc = AT.descriptor(lay)
        src, dst, sizes = cs.plan_of(o, st, kind, o._moves(None))
        M = src.shape[0]
        stream = AT._stream(st.mem.device)

        def launch(lib):
            lim = limit[lib._name]
            ws = AT.workspace(lib.defrag_txn_workspace_bytes(
                desc, *([S] if lib._new else []), lim), "cuda")
            err = lib.sharded_defrag_txn_launch(
                desc, st.mem.data_ptr(), st.ctl.data_ptr(), S, lay.mem_words,
                lay.ctl_words, src.data_ptr(), dst.data_ptr(),
                sizes.data_ptr(), M, AT._ptr(ws), stream)
            if err:
                raise RuntimeError(f"sharded_defrag_txn: CUDA error {err}")
            return st.ctl[:0]

        words = (st.mem.clone(), st.ctl.clone(), st.mem, st.ctl)
        out[what] = dict(moves=int((src >= 0).sum()),
                         **in_turns(dlibs, rounds, words, launch))

    # the mamba2 admission on the fresh 4-shard engine arena
    n, n_pages = cs.aux_geometry()
    o, _, _ = make_kv_allocator(n_pages, device="cuda", num_shards=S)
    st = o.init()
    alloc_case(f"sharded_alloc_txn, {n} lanes of 256 B", o, st,
               torch.full((n,), 256, dtype=torch.int32, device="cuda"),
               torch.ones(n, dtype=torch.bool, device="cuda"))
    del o, st
    torch.cuda.empty_cache()
    # 4096 lanes of mixed sizes after a short trace, 65536 pages
    rng = np.random.default_rng(3)
    o, _, _ = make_kv_allocator(65536, device="cuda", num_shards=S)
    st = o.init()
    trace = [op for op in cs.alloc_trace(rng, 4, 4096) if op[0] == "alloc"]
    for op in trace[:-1]:
        o.alloc(st, torch.from_numpy(op[1]).cuda(),
                torch.from_numpy(op[2]).cuda())
    alloc_case("sharded_alloc_txn, 4096 lanes of mixed sizes", o, st,
               torch.from_numpy(trace[-1][1]).cuda(),
               torch.from_numpy(trace[-1][2]).cuda())
    # both waves on the churned 65536-page arena
    st = cs.churn(o, o.init(), rng, 4096, 256, until_full=True)
    for kind in cs.WAVES:
        wave_case(f"sharded_defrag_txn, {kind} wave, {S} x "
                  f"{o.shard_cfg.num_chunks} chunks", o, st, kind)
    # a rebalance wave on the engine's 256-page arena: pages homed on
    # shard 0, two of three freed
    o, _, _ = make_kv_allocator(256, device="cuda", num_shards=S)
    st, live = o.init(), []
    sizes = torch.full((16,), 256, dtype=torch.int32, device="cuda")
    home0 = torch.zeros(16, dtype=torch.int32, device="cuda")
    for _ in range(6):
        _, offs = o.alloc(st, sizes, torch.ones(16, dtype=torch.bool,
                                                device="cuda"),
                          shard_hint=home0)
        live += [x for x in offs.tolist() if x >= 0]
    drop = [x for i, x in enumerate(live) if i % 3]
    for i in range(0, len(drop), 16):
        fo = torch.full((16,), -1, dtype=torch.int32)
        fo[:len(drop[i:i + 16])] = torch.tensor(drop[i:i + 16],
                                               dtype=torch.int32)
        fo = fo.cuda()
        o.free(st, fo, sizes, fo >= 0)
    wave_case(f"sharded_defrag_txn, rebalance wave, {S} x "
              f"{o.shard_cfg.num_chunks} chunks (the engine's arena)", o, st,
              "rebalance")
    return out


def variant_lib(define: str) -> str:
    """This tree's ``alloc_txn.cu`` built with ``-D<define>`` beside its
    own build; returns the library's path."""
    from repro_torch.kernels import build
    so = build.build_dir() / f"liballoc_txn-{define.replace('=', '')}.so"
    r = subprocess.run([build.nvcc(), *build.FLAGS, f"-D{define}", "-o",
                        str(so), str(build.csrc_dir() / "alloc_txn.cu")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"alloc_txn.cu with -D{define} failed to "
                           f"build:\n{r.stderr[-4000:]}")
    return str(so)


def counted_ms(lib, call, reps, tries=3):
    """Profiler device time of one ``call()`` of a sharded alloc through
    ``lib``: each kernel's mean a launch times the launches the kernels
    counted on the card (``alloc_txn_launch_stats``), summed, over
    ``reps`` calls; a session in which the profiler recorded no launch
    of a kernel that ran is run again, up to ``tries`` sessions.
    Returns (ms, {kernel: [mean ms a launch, recorded, counted]})."""
    import torch
    from repro_torch.kernels import alloc_txn as AT
    names = AT.LAUNCH_STATS

    def counts():
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(names))()
        if lib.alloc_txn_launch_stats(buf, 0):
            raise RuntimeError("alloc_txn_launch_stats failed")
        return dict(zip(names, (int(v) for v in buf)))

    call()
    for _ in range(tries):
        before = counts()
        with cs.DeviceProfile() as prof:
            for _ in range(reps):
                call()
        made = {k: m - before[k] for k, m in counts().items()
                if m > before[k]}
        got = {k: prof.kernel(f"{k}_kernel") for k in made}
        if all(n for _, n in got.values()):
            return (sum(got[k][0] * m for k, m in made.items()) / reps,
                    {k: [got[k][0], got[k][1], m] for k, m in made.items()})
    raise RuntimeError(f"the profiler recorded no launch of a kernel in "
                       f"{tries} sessions: {got} of {made}")


def run_warp_grid(rounds: int, reps: int = 50) -> dict:
    """Section 4: this tree's ``sharded_alloc_txn`` on the warp-sized
    block and on the grid path at engine-shaped inputs, in turns on the
    same words, and each path's counted device time a call."""
    import torch
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.kernels import build
    from repro_torch.paged.kv_cache import make_kv_allocator
    S = cs.SHARDS
    build.build_all(["alloc_txn"])
    libs = {"this": ctypes.CDLL(str(build._target("alloc_txn"))),
            "other": ctypes.CDLL(variant_lib("SHARDED_GRID_LANES=0"))}
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for lib in libs.values():
        lib.sharded_alloc_txn_workspace_bytes.argtypes = [AT.ArenaDesc, I, Z]
        lib.sharded_alloc_txn_workspace_bytes.restype = Z
        lib.sharded_alloc_txn_grid.argtypes = [AT.ArenaDesc, I, Z]
        lib.sharded_alloc_txn_grid.restype = I
        lib.sharded_alloc_txn_launch.argtypes = [
            AT.ArenaDesc, P, P, I, I, I, P, P, P, I, I, P, P, Z, P]
        lib.sharded_alloc_txn_launch.restype = I
        lib.alloc_txn_launch_stats.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), I]
        lib.alloc_txn_launch_stats.restype = I
    o, _, _ = make_kv_allocator(256, device="cuda", num_shards=S)
    lay = o.layout.shard
    desc = AT.descriptor(lay)
    lim = AT.TABLE_SMEM_LIMIT
    stream = AT._stream(torch.device("cuda"))
    fresh = o.init()
    full = o.init()     # shard 0 filled with 16-lane grants homed on it
    sz16 = torch.full((16,), 256, dtype=torch.int32, device="cuda")
    on16 = torch.ones(16, dtype=torch.bool, device="cuda")
    for _ in range(64):
        _, offs = o.alloc(full, sz16, on16, shard_hint=torch.zeros(
            16, dtype=torch.int32, device="cuda"))
        if bool((offs < 0).any()):
            break
    else:
        raise AssertionError("shard 0 never filled")
    cases = [(16, "one home, fresh arena", fresh, False),
             (16, "one home, its shard full", full, False),
             (32, "one home, its shard full", full, False),
             (32, "homes on every shard in turn, fresh arena", fresh, True)]
    out = {}
    for n, what, st, spread in cases:
        sizes = torch.full((n,), 256, dtype=torch.int32, device="cuda")
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        home = torch.arange(n, dtype=torch.int32, device="cuda") % S
        if not spread:
            home.zero_()
        mem, ctl = st.mem.clone(), st.ctl.clone()

        def launch(lib):
            ws = AT.workspace(lib.sharded_alloc_txn_workspace_bytes(
                desc, n, lim), "cuda")
            offs = torch.empty(n, dtype=torch.int32, device="cuda")
            err = lib.sharded_alloc_txn_launch(
                desc, mem.data_ptr(), ctl.data_ptr(), S, lay.mem_words,
                lay.ctl_words, sizes.data_ptr(), mask.data_ptr(),
                home.data_ptr(), n, o.walk, offs.data_ptr(), AT._ptr(ws),
                lim, stream)
            if err:
                raise RuntimeError(f"sharded_alloc_txn: CUDA error {err}")
            return offs

        paths = {label: ("grid" if lib.sharded_alloc_txn_grid(desc, n, lim)
                         else "warp") for label, lib in libs.items()}
        if paths != {"this": "warp", "other": "grid"}:
            raise AssertionError(f"{n} lanes took the paths {paths}")
        t = in_turns(libs, rounds, (st.mem, st.ctl, mem, ctl), launch)
        line = {"warp": t["this"], "grid": t["other"],
                "max_word_diff": t["max_word_diff"]}
        for label, path in paths.items():

            def call(lib=libs[label]):
                mem.copy_(st.mem)
                ctl.copy_(st.ctl)
                launch(lib)

            ms, parts = counted_ms(libs[label], call, reps)
            line[f"{path}_device_ms"] = ms
            line[f"{path}_kernels"] = parts
        out[f"{n} lanes, {what}"] = line
    return out


def ring_inputs(seed: int = 15) -> dict:
    """``chip_smoke.ring_widths``' inputs, made with this tree's package:
    the ring page variant's class rings (C = 5) after one 4096-lane
    alloc of phase 3's size mix and a free of its grants in a shuffled
    lane order, and the chunk variant's pool, on the serving engine's
    geometry for 65536 pages."""
    import numpy as np
    import torch
    from repro_torch.core import page_alloc
    from repro_torch.core.heap import size_to_class_device
    from repro_torch.paged.kv_cache import make_kv_allocator
    cfg = make_kv_allocator(65536, device="cuda")[0].cfg
    C = cfg.num_classes
    _, ring = cs.piecewise_arena(cfg, "page", "ring", "cuda", True)
    _, chunk = cs.piecewise_arena(cfg, "chunk", "vl", "cuda", True)
    rng = np.random.default_rng(seed)
    _, sizes, mask = cs.alloc_trace(rng, 1, 4096)[0]
    sizes = torch.from_numpy(sizes).cuda()
    mask = torch.from_numpy(mask).cuda()
    cls = size_to_class_device(cfg, sizes)
    _, offs = page_alloc.alloc(cfg, "ring", ring, sizes, mask,
                               piecewise=True)
    perm = torch.from_numpy(rng.permutation(4096)).cuda()
    fo, fs = offs[perm].contiguous(), sizes[perm].contiguous()
    fcls = size_to_class_device(cfg, fs)
    return dict(store=ring.q.store, front=ring.q.front, back=ring.q.back,
                cls=cls, valid=mask & (cls < C), fo=fo, fcls=fcls,
                fvalid=(fo >= 0) & (fcls < C), pool=chunk.ctx.pool,
                init_lanes=cfg.data_chunks_per_class
                * cfg.pages_per_chunk(0), page_words=cfg.page_words(0),
                share=cfg.data_chunks_per_class)


def ring_launcher(kind, spec, stream):
    """(``launch(lib)``: ``kind`` through a tree's library at one
    ``ring_widths`` entry, returning what it wrote; the words it starts
    from; the words it writes in place), for ``in_turns``."""
    import torch
    if kind == "ring_txn_pop":
        (store, front, back, cls, valid), limit = spec
        C, cap = store.shape
        n = cls.shape[0]
        vals = torch.empty(n, dtype=torch.int32, device="cuda")
        nf = torch.empty(C, dtype=torch.int32, device="cuda")

        def launch(lib):
            err = lib.ring_txn_pop_launch(
                store.data_ptr(), front.data_ptr(), back.data_ptr(),
                cls.data_ptr(), valid.data_ptr(), n, C, cap, int(limit),
                vals.data_ptr(), nf.data_ptr(), stream)
            if err:
                raise RuntimeError(f"ring_txn_pop: CUDA error {err}")
            return torch.cat([vals, nf])
        return launch, store, store.clone()   # the pop writes no store
    store, back, cls, vals, valid = spec
    C, cap = store.shape
    n = cls.shape[0]
    work = store.clone()
    nb = torch.empty(C, dtype=torch.int32, device="cuda")

    def launch(lib):
        err = lib.ring_txn_push_launch(
            work.data_ptr(), back.data_ptr(), cls.data_ptr(),
            vals.data_ptr(), valid.data_ptr(), n, C, cap, nb.data_ptr(),
            stream)
        if err:
            raise RuntimeError(f"ring_txn_push: CUDA error {err}")
        return nb.clone()
    return launch, store, work


def run_ring(other: str, rounds: int, reps: int = 50) -> dict:
    """Section 7: both trees' ring pop and push at each width of
    ``chip_smoke.ring_widths``, in turns on the same words."""
    import torch
    from repro_torch.kernels import alloc_txn as AT
    libs = {"this": AT.ring_lib(),
            "other": ctypes.CDLL(other_lib(other, "ring_txn"))}
    P, I = ctypes.c_void_p, ctypes.c_int
    libs["other"].ring_txn_pop_launch.argtypes = [P] * 5 + [I] * 4 + [P] * 3
    libs["other"].ring_txn_push_launch.argtypes = [P] * 5 + [I] * 3 + [P] * 2
    libs["other"].ring_txn_pop_launch.restype = I
    libs["other"].ring_txn_push_launch.restype = I
    stream = AT._stream(torch.device("cuda"))
    empty = torch.empty(0, dtype=torch.int32, device="cuda")
    out = {}
    for kind, widths in zip(("ring_txn_pop", "ring_txn_push"),
                            cs.ring_widths(ring_inputs())):
        for label, spec in widths.items():
            launch, start, work = ring_launcher(kind, spec, stream)
            t = in_turns(libs, rounds, (start, empty, work, empty), launch)
            line = {"this": t["this"], "other": t["other"],
                    "max_word_diff": t["max_word_diff"]}
            AT.ring_launch_stats(reset=True)
            for tree in ("other", "this", "this", "other"):
                ms, parts = device_ms(lambda: launch(libs[tree]), reps, tree,
                                      kind)
                line.setdefault(f"{tree}_device_ms", []).append(ms)
                line[f"{tree}_kernels"] = parts
            ran = [k for k, v in AT.ring_launch_stats(reset=True).items()
                   if v]
            if len(ran) != 1:
                raise AssertionError(f"{kind} at {label}: this tree ran the "
                                     f"paths {ran}")
            line["this_path"] = ran[0][len(kind) + 1:]
            out[f"{kind} at {label}"] = line
    return out


def free_kernel_profile(so: str) -> dict:
    """Registers (``ptxas -v``, from the build's log) and SASS
    instructions (``cuobjdump``) of each ``free_txn_kernel`` instance."""
    regs = {}
    log = os.path.splitext(so)[0] + ".log"
    entry = None
    for ln in open(log, errors="replace").read().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and "15free_txn_kernel" in entry:
            regs[entry] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, timeout=300).stdout
        fn = None
        for ln in text.splitlines():
            m = re.search(r"Function : (\w+)", ln)
            if m:
                fn = m.group(1)
                continue
            if fn and "15free_txn_kernel" in fn and re.search(
                    r"/\*[0-9a-f]{4,}\*/", ln):
                sass[fn] = sass.get(fn, 0) + 1
    return dict(registers=regs, sass_instructions=sass or "not measured")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--worker")
    ap.add_argument("--tokens-worker", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--sections", default="1,2,3,4,5,6,7",
                    help="comma-separated section numbers to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(dict(attention=attention_worker(args.worker),
                              ssd_scan=scan_worker(args.worker, args.out))))
        return 0
    if args.tokens_worker:
        print(json.dumps(tokens_worker()))
        return 0
    if not args.other:
        ap.error("--other is required")
    sys.path.insert(0, os.path.join(ROOT, "src"))   # this tree's package
    trees = {"this": ROOT, "other": os.path.abspath(args.other)}
    sections = {int(x) for x in args.sections.split(",")}
    if 1 in sections:
        with tempfile.TemporaryDirectory() as tmp:
            rows, diff = run_workers(trees, tmp)
        for what in ("attention", "ssd_scan"):
            for row in rows:
                line = {"tree": row["tree"], what: row[what]}
                print(f"{what} {json.dumps(line)}", flush=True)
        print(f"ssd_scan, the largest difference between the trees' "
              f"outputs (y, h_final) by chunks {json.dumps(diff)}",
              flush=True)
    from repro_torch.kernels import build
    if sections & {2, 3, 5}:
        other_so = other_lib(trees["other"])
        build.build_all(["alloc_txn"])
    if 2 in sections:
        for what, t in run_aux(other_so, args.rounds).items():
            print(f"{what} at 298656 lanes, CUDA events a launch "
                  f"{json.dumps(t)}", flush=True)
    if 3 in sections:
        sos = {"this": {k: str(build._target(k))
                        for k in ("alloc_txn", "defrag_txn")},
               "other": {"alloc_txn": other_so,
                         "defrag_txn": other_lib(trees["other"],
                                                 "defrag_txn")}}
        build.build_all(["defrag_txn"])
        for what, t in run_sharded(trees, sos, args.rounds).items():
            print(f"{what}, CUDA events a call {json.dumps(t)}", flush=True)
    if 4 in sections:
        for what, t in run_warp_grid(args.rounds).items():
            print(f"sharded_alloc_txn, warp-sized block against the grid "
                  f"path, {what} {json.dumps(t)}", flush=True)
    if 5 in sections:
        for label, so in (("this", str(build._target("alloc_txn"))),
                          ("other", other_so)):
            print(f"free_txn_kernel {label} "
                  f"{json.dumps(free_kernel_profile(so))}", flush=True)
    if 6 in sections:
        print(f"tokens on phase 5's traffic, every run "
              f"{json.dumps(run_tokens(trees))}", flush=True)
    if 7 in sections:
        for what, t in run_ring(trees["other"], args.rounds).items():
            print(f"{what}, CUDA events and device time a call "
                  f"{json.dumps(t)}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
