"""The port's checkpointing (``ckpt/checkpoint.py``) and fault-tolerance
runtime (``ft/runtime.py``) held to the JAX reference's.

The reference's ``tests/test_ckpt_ft.py`` cases (all but
``elastic_rescale``, which comes with the port of the sharding rules)
run on the port with trees of tensors and numpy arrays; then both
cross-reads: a directory the port wrote is read by
``repro.ckpt.checkpoint.restore``/``read_meta`` and one the reference
wrote by the port, bf16, int8, int32, float32 and bool leaves equal
byte for byte (a bf16 file is byte for byte the one ``np.save`` writes
for an ``ml_dtypes`` array).  ``StepMonitor`` gives the reference's
flags and EWMA for the same step times.
"""
import os
import shutil
import signal
import time
from typing import NamedTuple, Optional

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ckpt import checkpoint as JCK
from repro.ft.runtime import StepMonitor as JStepMonitor

from repro_torch.ckpt import checkpoint as CK
from repro_torch.ft.runtime import PreemptionGuard, StepMonitor
from repro_torch.obs.metrics import MetricsRegistry, validate_exposition


class Pair(NamedTuple):
    k: torch.Tensor
    v: torch.Tensor
    scale: Optional[torch.Tensor] = None


class JPair(NamedTuple):
    k: object
    v: object
    scale: object = None


def _state(seed=0):
    """A tree in the serving snapshot's shapes of structure: nested
    dicts, a NamedTuple with a None field, a list, every dtype kind."""
    g = torch.Generator().manual_seed(seed)
    return {"arena_mem": torch.randint(-9, 2 ** 20, (300,), generator=g,
                                       dtype=torch.int32),
            "caches": Pair(k=torch.randn(2, 3, 4, generator=g).to(
                torch.bfloat16), v=torch.randn(2, 3, 4, generator=g)),
            "layers": [torch.randint(-128, 127, (5, 2), generator=g,
                                     dtype=torch.int8),
                       torch.rand(3, generator=g) > 0.5],
            "slot_len": np.arange(4, dtype=np.int64)}


def _same(a, b):
    fa, fb = CK.flatten(a), CK.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert type(x) is type(y), k
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                y.view(torch.int16) if y.dtype == torch.bfloat16 else y), k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_roundtrip(tmp_path):
    state = _state()
    CK.save(state, str(tmp_path), step=7)
    restored, step = CK.restore(state, str(tmp_path))
    assert step == 7
    _same(state, restored)
    assert isinstance(restored["caches"], Pair)
    assert restored["caches"].scale is None


def test_keep_k_retention(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4, 5):
        CK.save(state, str(tmp_path), step=s, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert CK.latest_step(str(tmp_path)) == 5


def test_async_checkpointer(tmp_path):
    """The host copy is taken at ``save``: a tensor changed right after
    does not reach the file."""
    state = _state()
    want = state["arena_mem"].clone()
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(state, 1)
    state["arena_mem"].add_(1)
    ck.save(state, 2)  # waits for the previous write
    ck.wait()
    assert CK.latest_step(str(tmp_path)) == 2
    first, _ = CK.restore(state, str(tmp_path), step=1)
    assert torch.equal(first["arena_mem"], want)
    restored, _ = CK.restore(state, str(tmp_path))
    _same(state, restored)


def test_atomicity_partial_write_ignored(tmp_path):
    state = _state()
    CK.save(state, str(tmp_path), step=1)
    os.makedirs(tmp_path / "step_00000002.tmp")  # a crash mid-save
    assert CK.latest_step(str(tmp_path)) == 1
    _, step = CK.restore(state, str(tmp_path))
    assert step == 1


def test_colliding_leaf_paths_roundtrip(tmp_path):
    """``a/b``, ``a?b`` and ``a_b`` sanitize to one filename: the later
    ones take ``__<n>`` suffixes and meta.json maps each key exactly,
    as the reference's does."""
    state = {"a/b": torch.arange(4), "a?b": torch.arange(4) + 100,
             "a_b": torch.arange(4) + 200}
    CK.save(state, str(tmp_path), step=1)
    restored, _ = CK.restore(state, str(tmp_path))
    for k in state:
        assert torch.equal(restored[k], state[k])
    meta, _ = CK.read_meta(str(tmp_path))
    files = [v["file"] for v in meta["leaves"].values()]
    assert len(files) == len(set(files)) == 3
    jdir = tmp_path / "ref"
    JCK.save({k: jnp.asarray(v.numpy()) for k, v in state.items()},
             str(jdir), step=1)
    jmeta, _ = JCK.read_meta(str(jdir))
    assert {k: v["file"] for k, v in meta["leaves"].items()} == \
        {k: v["file"] for k, v in jmeta["leaves"].items()}


def test_restore_falls_back_when_step_vanishes(tmp_path):
    state = {"w": torch.arange(8)}
    CK.save(state, str(tmp_path), step=1)
    CK.save(state, str(tmp_path), step=2)
    shutil.rmtree(tmp_path / "step_00000002")  # swept after the listing
    restored, step = CK.restore(state, str(tmp_path))
    assert step == 1
    assert torch.equal(restored["w"], torch.arange(8))
    with pytest.raises(FileNotFoundError):
        CK.restore(state, str(tmp_path), step=2)


def test_retention_never_deletes_newest(tmp_path):
    state = {"w": torch.arange(2)}
    for s in (1, 2, 3):
        CK.save(state, str(tmp_path), step=s, keep=0)
    assert CK.committed_steps(str(tmp_path)) == [3]


def test_bfloat16_roundtrips_bit_exact(tmp_path):
    x = torch.linspace(-3, 3, 64).to(torch.bfloat16)
    CK.save({"kv": x}, str(tmp_path), step=1)
    restored, _ = CK.restore({"kv": x}, str(tmp_path))
    assert restored["kv"].dtype == torch.bfloat16
    assert torch.equal(restored["kv"].view(torch.int16), x.view(torch.int16))


def test_async_extra_sidecar_roundtrips(tmp_path):
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save({"w": torch.arange(3)}, 1, extra={"queue": [1, 2], "k": "v"})
    ck.wait()
    meta, step = CK.read_meta(str(tmp_path))
    assert step == 1
    assert meta["extra"] == {"queue": [1, 2], "k": "v"}


def test_numpy_template_leaves_stay_numpy(tmp_path):
    state = {"t": torch.arange(3, dtype=torch.int32),
             "n": np.arange(3, dtype=np.int64)}
    CK.save(state, str(tmp_path), step=1)
    restored, _ = CK.restore(state, str(tmp_path))
    assert isinstance(restored["t"], torch.Tensor)
    assert isinstance(restored["n"], np.ndarray)
    assert restored["n"].dtype == np.int64


# --------------------------------------------------------------------------
# cross-reads: either package reads the other's directory
# --------------------------------------------------------------------------

def _jax_state(state):
    """The reference's counterpart of ``_state()``: the same words in
    jnp arrays (bf16 as ml_dtypes) and the reference-side NamedTuple."""
    def j(t):
        if isinstance(t, np.ndarray):
            return t
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    c = state["caches"]
    return {"arena_mem": j(state["arena_mem"]),
            "caches": JPair(k=j(c.k), v=j(c.v), scale=None),
            "layers": [j(x) for x in state["layers"]],
            "slot_len": state["slot_len"]}


def _host_words(leaf):
    if isinstance(leaf, torch.Tensor):
        return CK.to_host(leaf)[0].tobytes()
    a = np.asarray(leaf)
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.int16)
    return a.tobytes()


def test_keys_and_files_match_reference(tmp_path):
    """The same tree flattens to the reference's keys in its order, and
    both packages write the same meta.json and the same bytes in every
    file (bf16's ``<V2`` header included)."""
    state = _state()
    jstate = _jax_state(state)
    flat, _ = JCK._flatten(jstate)
    assert list(CK.flatten(state)) == list(flat)
    CK.save(state, str(tmp_path / "port"), step=3, extra={"a": 1})
    JCK.save(jstate, str(tmp_path / "ref"), step=3, extra={"a": 1})
    mp, _ = CK.read_meta(str(tmp_path / "port"))
    mj, _ = JCK.read_meta(str(tmp_path / "ref"))
    assert mp == mj
    for info in mp["leaves"].values():
        a = (tmp_path / "port" / "step_00000003" / info["file"]).read_bytes()
        b = (tmp_path / "ref" / "step_00000003" / info["file"]).read_bytes()
        assert a == b, info


def test_reference_reads_port_directory(tmp_path):
    state = _state(1)
    CK.save(state, str(tmp_path), step=5, extra={"fp": "x"})
    jstate = _jax_state(_state(2))   # a template of other values
    restored, step = JCK.restore(jstate, str(tmp_path))
    meta, _ = JCK.read_meta(str(tmp_path))
    assert step == 5 and meta["extra"] == {"fp": "x"}
    assert restored["caches"].k.dtype == jnp.bfloat16
    assert restored["layers"][0].dtype == jnp.int8
    want, got = CK.flatten(state), JCK._flatten(restored)[0]
    for k in want:
        if isinstance(want[k], np.ndarray):
            # JAX without x64 holds the int64 host table as int32
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
        else:
            assert _host_words(want[k]) == _host_words(np.asarray(got[k])), k


def test_port_reads_reference_directory(tmp_path):
    state = _state(3)
    JCK.save(_jax_state(state), str(tmp_path), step=9, extra={"fp": "y"})
    restored, step = CK.restore(_state(4), str(tmp_path))
    meta, _ = CK.read_meta(str(tmp_path))
    assert step == 9 and meta["extra"] == {"fp": "y"}
    _same(state, restored)


# --------------------------------------------------------------------------
# ft/runtime.py
# --------------------------------------------------------------------------

def test_step_monitor_stop_without_start():
    with pytest.raises(RuntimeError, match="without a matching"):
        StepMonitor().stop()


def _feed(mon, times):
    out = []
    for dt in times:
        mon.start()
        mon._t0 -= dt
        r = mon.stop()
        out.append((r["straggler"], r["ewma"]))
    return out


@pytest.mark.parametrize("alpha,threshold,warmup,times,flagged", [
    (0.5, 1.5, 2, (0.1, 0.1, 1.0), True),  # first judged step flagged
    (0.5, 1.5, 0, (0.1, 0.1, 0.1, 1.0), True),
    (0.1, 1.5, 2, (3.0, 0.1, 0.1, 0.12, 0.3, 0.11, 0.5), False)])
def test_step_monitor_matches_reference(alpha, threshold, warmup, times,
                                        flagged):
    """The same step times give the reference's straggler flags and
    EWMA (a 10× step right after warm-up is flagged: the EWMA is seeded
    from the warm-up median, not from the step it judges)."""
    kw = dict(alpha=alpha, threshold=threshold, warmup=warmup)
    got, want = _feed(StepMonitor(**kw), times), _feed(JStepMonitor(**kw),
                                                        times)
    assert [f for f, _ in got] == [f for f, _ in want]
    assert got[-1][0] == flagged
    for (_, a), (_, b) in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) < 1e-3 * b


def test_step_monitor_fleet_report():
    mon = StepMonitor(threshold=1.5)
    flags = mon.fleet_report(np.array([1.0, 1.1, 0.9, 5.0, 1.0]))
    assert list(flags) == [False, False, False, True, False]


def test_step_monitor_publishes_through_registry():
    reg = MetricsRegistry()
    mon = StepMonitor(warmup=1, registry=reg)
    for _ in range(3):
        mon.start()
        mon.stop()
    assert validate_exposition(reg.to_prometheus()) > 0
    assert reg.get("repro_steps_total").samples[()] == 3
    assert reg.get("repro_step_time_ms").samples[()].count == 3
    assert reg.get("repro_step_time_ewma_ms") is not None


def test_preemption_guard_sets_flag():
    g = PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not g.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert g.should_stop
    g.restore()
