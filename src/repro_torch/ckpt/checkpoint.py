"""Atomic, async checkpointing with keep-k retention (port of the
reference's ``ckpt/checkpoint.py``, in its on-disk format).

Layout:   <dir>/step_<N>/<flat.leaf.path>.npy  +  meta.json
Atomicity: written into ``step_<N>.tmp`` then ``os.replace``'d: a crash
mid-save never corrupts the latest checkpoint (restore scans only
committed dirs).  ``AsyncCheckpointer.save`` copies every leaf to host
memory synchronously (the device tensors may change right after) and
writes on a daemon thread.

A tree is nested dicts, lists, tuples or NamedTuples whose leaves are
tensors or numpy arrays (``None`` leaves are skipped, as the reference's
pytrees skip them).  Leaf keys are the reference's: dict keys (in sorted
order), list and tuple indices, and ``.field`` for a NamedTuple field,
joined by ``|`` (``caches|.kv|.layers|.k``).  So a directory either
package writes, the other reads:

- ``meta.json`` holds ``step``, ``leaves`` (``file``, ``shape`` and
  ``dtype`` of each key) and the ``extra`` sidecar;
- a bfloat16 leaf is saved as the 2-byte void records (dtype string
  ``"bfloat16"``) that ``np.save`` writes for an ``ml_dtypes`` array,
  and read back by viewing the bytes as 16-bit integers, then as
  ``torch.bfloat16``; every other dtype is numpy's own.

Three hardening contracts the serving snapshot leans on, as the
reference's:

- **Exact key→file map.**  Leaf filenames are sanitized keys, so two
  keys can collide after sanitization; ``_write`` suffixes a colliding
  filename with ``__<n>`` and ``meta.json`` records the exact map —
  restore reads files only through it.
- **Raw-dtype fidelity.**  ``restore`` reinterprets each file through
  the dtype recorded in ``meta.json``, so a bf16 KV heap round-trips
  bit for bit.
- **Retention never races restore off a cliff.**  ``_retain`` always
  keeps the newest committed step (even ``keep=0``), and ``restore``
  falls back to the next-newest committed step when the one it
  selected vanished mid-read.

``restore`` puts each leaf on its template leaf's device (numpy
template leaves come back as numpy arrays).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "|"
BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``{key: leaf}`` of ``tree`` in the reference's order and key
    syntax (``None`` leaves left out)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, prefix + (k,)))
    return out


def unflatten_like(template, leaves: Dict[str, Any],
                   prefix: Tuple[str, ...] = ()):
    """``template``'s structure with each leaf replaced by
    ``leaves[key]`` (``None`` stays ``None``)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: unflatten_like(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            unflatten_like(v, leaves, prefix + ("." + f,))
            for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves[_SEP.join(prefix)]


def to_host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf and its dtype string: a bfloat16 leaf
    (a tensor, or an ``ml_dtypes`` array) as its raw 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == BF16:
        return arr.view(np.int16), BF16
    return arr, str(arr.dtype)


def from_host(arr: np.ndarray, dtype: str, device=None):
    """A leaf from host words and their dtype string: a tensor on
    ``device`` when one is given (and always for bfloat16, which numpy
    cannot hold without ``ml_dtypes``), else a numpy array."""
    arr = np.ascontiguousarray(arr)
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        arr = arr.view(np.dtype(dtype))
        if device is None:
            return arr
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def as_tensor(leaf) -> torch.Tensor:
    """A leaf (a tensor, or a numpy array, ``ml_dtypes`` bfloat16
    included) as a tensor, on the host unless it is a tensor already."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return from_host(*to_host(leaf), device="cpu")


def _host_tree(state) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: to_host(v) for k, v in flatten(state).items()}


def save(state, directory: str, step: int, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  ``extra``: JSON-serializable sidecar
    stored in meta.json.  Returns the committed path."""
    return _write(_host_tree(state), directory, step, keep, extra)


def _save_npy(path: str, arr: np.ndarray, dtype: str):
    with open(path, "wb") as f:
        if dtype == BF16:
            # the header np.save writes for an ml_dtypes bfloat16 array
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(f, arr)


def _write(host, directory, step, keep, extra=None):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": {}}
    if extra is not None:
        meta["extra"] = extra
    used = set()
    for k, (v, dtype) in host.items():
        base = re.sub(r"[^A-Za-z0-9_.|-]", "_", k)
        # sanitization is lossy: suffix until unique so a later leaf
        # cannot overwrite an earlier one (meta records the exact map)
        fn, n = base + ".npy", 0
        while fn in used:
            n += 1
            fn = f"{base}__{n}.npy"
        used.add(fn)
        _save_npy(os.path.join(tmp, fn), v, dtype)
        meta["leaves"][k] = {"file": fn, "shape": list(v.shape),
                             "dtype": dtype}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(directory, keep)
    return final


def _retain(directory, keep):
    # never retain away the newest committed checkpoint: a concurrent
    # restore may have just selected it
    keep = max(int(keep), 1)
    steps = sorted(d for d in os.listdir(directory)
                   if re.fullmatch(r"step_\d{8}", d))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Copy to host synchronously, write on a daemon thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, state, step: int, extra: Optional[dict] = None):
        self.wait()
        host = _host_tree(state)
        self._thread = threading.Thread(
            target=_write,
            args=(host, self.directory, step, self.keep, extra),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def committed_steps(directory: str):
    """All committed step numbers under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if re.fullmatch(r"step_\d{8}", d))


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _candidates(directory, step):
    candidates = ([step] if step is not None
                  else list(reversed(committed_steps(directory))))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return candidates


def read_meta(directory: str, step: Optional[int] = None):
    """The committed ``meta.json`` record as ``(meta, step)``.  With
    ``step=None`` picks the newest committed step, falling back past
    steps a concurrent retention sweep removed mid-read."""
    candidates = _candidates(directory, step)
    err = None
    for s in candidates:
        try:
            d = os.path.join(directory, f"step_{s:08d}")
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f), s
        except FileNotFoundError as e:
            err = e
    raise FileNotFoundError(
        f"every committed step under {directory} vanished mid-read "
        f"(candidates {candidates})") from err


def restore(template: Any, directory: str, step: Optional[int] = None):
    """Restore into the structure of ``template`` (None leaves stay
    None), each leaf on its template leaf's device.  Returns ``(tree,
    step)``.  When ``step`` is None, restores the newest committed step,
    falling back to the next-newest if a concurrent keep-k sweep deleted
    the selected one between the directory listing and the read."""
    candidates = _candidates(directory, step)
    err = None
    for s in candidates:
        try:
            return _load(template, directory, s), s
        except FileNotFoundError as e:
            if step is not None:
                raise
            err = e
    raise FileNotFoundError(
        f"every committed step under {directory} vanished mid-read "
        f"(candidates {candidates})") from err


def _load(template, directory, step):
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    out = {}
    for k, leaf in flatten(template).items():
        info = meta["leaves"][k]
        out[k] = from_host(np.load(os.path.join(d, info["file"])),
                           info["dtype"], device=(
                               leaf.device if isinstance(leaf, torch.Tensor)
                               else None))
    return unflatten_like(template, out)
