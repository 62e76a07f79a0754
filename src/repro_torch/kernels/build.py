"""Build and load the port's CUDA kernels.

Each source in ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``; the allocator kernels share ``csrc/arena_dev.cuh``.
Builds go to ``build/repro_torch/`` at the root of the checkout, named
by a hash of the source, the shared headers and the flags, so an
unchanged source is never rebuilt.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: this module imports on machines
without a CUDA toolkit, and only a launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

SOURCES = {"alloc_txn": "alloc_txn.cu",
           "defrag_txn": "defrag_txn.cu",
           "paged_attention": "paged_attention.cu",
           "ssd_scan": "ssd_scan.cu",
           "ring_txn": "ring_txn.cu",
           "bitmap_txn": "bitmap_txn.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def csrc_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1] / "csrc"


def build_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str) -> pathlib.Path:
    src = (csrc_dir() / SOURCES[name]).read_bytes()
    for header in sorted(csrc_dir().glob("*.cuh")):
        src += header.read_bytes()
    tag = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every (or each named) kernel source that is not built
    yet, one ``nvcc`` per source, all started together.  Returns the
    wall seconds per source (0.0 when already built); raises with the
    compiler's output if any build fails.  Each build's ``-Xptxas -v``
    report is kept beside its library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        so = _target(name)
        if so.exists():
            secs[name] = 0.0
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp),
               str(csrc_dir() / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), so, tmp)
    failed = []
    for name, (p, t0, so, tmp) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_bytes(log)
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode})\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def ptxas_report(name: str) -> str:
    """The register/shared-memory lines ``ptxas -v`` printed for a
    kernel's last build (empty when it was built elsewhere)."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(ln for ln in log.read_text(errors="replace").splitlines()
                     if "registers" in ln or "Compiling entry" in ln)


def libraries_loaded() -> int:
    """How many kernel libraries this process has loaded (each built
    first when absent): the port's counterpart of a jit cache's size,
    which grows exactly when a call paid a first-use build or load."""
    return len(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        so = _target(name)
        if not so.exists():
            build_all([name])
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
    return lib
