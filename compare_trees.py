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
2. The two trees' ``alloc_txn.cu`` on the same words: ``free_txn`` of
   one mamba2-780m retirement (298,656 pages of 256 B) on the serving
   engine's arena, granted by this tree's ``alloc_txn``, then
   ``alloc_txn`` of the next admission (the freed chunks in the class
   queue), then ``sharded_free_txn`` of the same retirement on the
   4-shard arena; both libraries are loaded in one process and launched
   in turns (other, this, this, other per round) from a copy of the
   words, each launch timed by CUDA events (every kernel a call
   launches inside); both must leave identical words and offsets.
3. Each tree's ``free_txn_kernel`` instances: registers from the build's
   ``ptxas -v`` report and SASS instructions from ``cuobjdump``.
4. Each tree's full-width mamba2-780m (random weights from seed 0, bf16)
   serving ``chip_smoke.py`` phase 5's traffic, each in its own process:
   a digest of every request's tokens, and whether the two trees'
   tokens are the same.

Exits non-zero without a card.  Prints the card's name and power limit.
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


def tokens_worker() -> dict:
    """This process's mamba2-780m engine on phase 5's traffic: the
    tokens' digest and count."""
    import hashlib
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    qwen = get_arch("qwen2-0.5b")
    lengths = [len(p) for p in cs.make_requests(qwen, 0, 16, 16, 448)]
    cfg = get_arch(cs.MAMBA)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prompts = cs.prompts_of_lengths(cfg, 0, lengths)
    eng, _, _ = cs.mamba_engine(model, params, prompts, False, "cuda")
    done = sorted(eng.run_until_done(), key=lambda r: r.uid)
    toks = [[int(t) for t in r.out_tokens] for r in done]
    return dict(digest=hashlib.sha256(json.dumps(toks).encode()).hexdigest(),
                tokens=sum(len(t) for t in toks))


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
    out["same"] = out["this"]["digest"] == out["other"]["digest"]
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


def other_alloc_lib(other: str) -> str:
    """Build the other tree's ``alloc_txn.cu`` with its own build module;
    returns the library's path."""
    code = ("from repro_torch.kernels import build; "
            "build.build_all(['alloc_txn']); "
            "print(build._target('alloc_txn'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=other,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(other, "src")),
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"other tree's alloc_txn build failed:\n"
                           f"{r.stderr[-4000:]}")
    return r.stdout.strip().splitlines()[-1]


def in_turns(libs, rounds, words, launch):
    """Each tree's ``launch(lib)`` from a copy of ``words`` (the arena's
    mem and ctl), in turns (other, this, this, other per round, after a
    round that warms both up), timed by CUDA events; both trees must
    leave identical words and outputs.  Returns each tree's sorted ms and
    median."""
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
    if not all(torch.equal(x, y) for x, y in zip(left["this"],
                                                  left["other"])):
        raise AssertionError("the two trees' kernels left different words")
    return {label: dict(ms=sorted(t), median_ms=sorted(t)[len(t) // 2])
            for label, t in times.items()}


def run_aux(other_so: str, rounds: int) -> dict:
    """Both trees' ``free_txn`` of one mamba2-780m retirement (298,656
    pages of 256 B, granted by this tree's ``alloc_txn`` on a fresh
    arena), then both trees' ``alloc_txn`` of the next admission (the
    freed chunks in the class queue), then both trees'
    ``sharded_free_txn`` of the retirement on the 4-shard arena, each on
    copies of the same words."""
    import torch
    from repro_torch.kernels import alloc_txn as AT
    from repro_torch.paged.kv_cache import make_kv_allocator
    n, n_pages = cs.aux_geometry()
    o, _, _ = make_kv_allocator(n_pages, device="cuda")
    st = o.init()
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

    out = {"free_txn, the retirement": in_turns(
               libs, rounds, granted + (st.mem, st.ctl), free),
           "alloc_txn, the next admission": in_turns(
               libs, rounds, freed + (st.mem, st.ctl), alloc)}
    del st, granted, freed

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
    with tempfile.TemporaryDirectory() as tmp:
        rows, diff = run_workers(trees, tmp)
    for what in ("attention", "ssd_scan"):
        for row in rows:
            line = {"tree": row["tree"], what: row[what]}
            print(f"{what} {json.dumps(line)}", flush=True)
    print(f"ssd_scan, the largest difference between the trees' outputs "
          f"(y, h_final) by chunks {json.dumps(diff)}", flush=True)
    other_so = other_alloc_lib(trees["other"])
    for what, t in run_aux(other_so, args.rounds).items():
        print(f"{what} at 298656 lanes, CUDA events a launch "
              f"{json.dumps(t)}", flush=True)
    from repro_torch.kernels import build
    for label, so in (("this", str(build._target("alloc_txn"))),
                      ("other", other_so)):
        print(f"free_txn_kernel {label} "
              f"{json.dumps(free_kernel_profile(so))}", flush=True)
    print(f"{cs.MAMBA} tokens on phase 5's traffic "
          f"{json.dumps(run_tokens(trees))}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
