"""Hold two checkouts of this repository side by side on one card.

    python3 compare_trees.py --other DIR [--rounds 4]

DIR is a second checkout (for example the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists); this
checkout is "this".  Each tree builds its own kernels into its own
``build/``.  Printed, one JSON line each:

1. ``paged_attention`` of each tree at ``chip_smoke.py`` phase 4's inputs
   (four lines: bf16 and float32, page ids and word offsets), in the
   order other, this, this, other, each in its own process (the two
   trees' packages share names): the time a call on CUDA events around
   the wrapper (200 calls, its host work inside) and the profiler device
   time a call (each of the tree's ``paged_attention*`` kernels' mean
   over the launches recorded in 50 calls, summed).
2. The two trees' ``alloc_txn.cu`` on the same words: ``free_txn`` of
   one mamba2-780m retirement (298,656 pages of 256 B) on the serving
   engine's arena, granted by this tree's ``alloc_txn``, then
   ``alloc_txn`` of the next admission (the freed chunks in the class
   queue); both libraries are loaded in one process and launched in
   turns (other, this, this, other per round) from a copy of the words,
   each launch timed by CUDA events; both must leave identical words
   and offsets.
3. Each tree's ``free_txn_kernel`` instances: registers from the build's
   ``ptxas -v`` report and SASS instructions from ``cuobjdump``.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (helpers only; imports no package)

ATTN_INPUTS = [("bfloat16", None), ("bfloat16", 64), ("float32", None),
               ("float32", 64)]


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
        call()
        with cs.DeviceProfile() as prof:
            for _ in range(50):
                call()
        kernels = {key: (us / n / 1e3, n) for key, us, n in prof.rows
                   if "paged_attention" in key}
        if not kernels:
            raise RuntimeError(f"{label}: the profiler recorded no "
                               f"paged_attention kernel")
        out[f"{dt} {'offsets' if wpp else 'ids'}"] = dict(
            events_ms=events,
            device_ms=sum(ms for ms, _ in kernels.values()),
            kernels={key[:60]: [ms, n] for key, (ms, n) in kernels.items()})
    return out


def run_attention(trees) -> list:
    rows = []
    for label in ("other", "this", "this", "other"):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[label], "src"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--attention-worker", label], env=env,
                           cwd=trees[label], capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"{label} attention worker failed:\n"
                               f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        rows.append(dict(tree=label,
                         attention=json.loads(r.stdout.splitlines()[-1])))
    return rows


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
    freed chunks in the class queue), each on copies of the same
    words."""
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

    return {"free_txn, the retirement": in_turns(
                libs, rounds, granted + (st.mem, st.ctl), free),
            "alloc_txn, the next admission": in_turns(
                libs, rounds, freed + (st.mem, st.ctl), alloc)}


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
    ap.add_argument("--attention-worker")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.attention_worker:
        print(json.dumps(attention_worker(args.attention_worker)))
        return 0
    if not args.other:
        ap.error("--other is required")
    sys.path.insert(0, os.path.join(ROOT, "src"))   # this tree's package
    trees = {"this": ROOT, "other": os.path.abspath(args.other)}
    for row in run_attention(trees):
        print(f"attention {json.dumps(row)}", flush=True)
    other_so = other_alloc_lib(trees["other"])
    for what, t in run_aux(other_so, args.rounds).items():
        print(f"{what} at 298656 lanes, CUDA events a launch "
              f"{json.dumps(t)}", flush=True)
    from repro_torch.kernels import build
    for label, so in (("this", str(build._target("alloc_txn"))),
                      ("other", other_so)):
        print(f"free_txn_kernel {label} "
              f"{json.dumps(free_kernel_profile(so))}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
