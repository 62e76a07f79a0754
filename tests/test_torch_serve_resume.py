"""Crash-safe serving through the port's entry point, on the CPU.

``python -m repro_torch.launch.serve --device cpu --smoke --snapshot-dir
D`` is sent SIGTERM after its first ``REQ`` line: it finishes the tick in
flight, snapshots into D and exits with code 3.  ``--resume`` then
serves the rest, and the killed run's ``REQ`` lines followed by the
resumed run's are the uninterrupted run's (served beside the killed
one).  The uninterrupted run also writes ``--metrics-file`` and
``--trace-file``, which
``launch/obs_dump.py`` validates; its ``--snapshot`` view of the
killed run's directory is the reference's ``scripts/obs_dump.py`` view,
line for line.
"""
import contextlib
import importlib.util
import io
import os
import pathlib
import signal
import subprocess
import sys
import threading

import pytest

from repro_torch.launch import obs_dump, serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
# enough work that the signal lands mid-stream: 32 requests of 32 new
# tokens through 2 slots take hundreds of ticks after the first finishes
ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
        "--requests", "32", "--max-new", "32", "--max-batch", "2",
        "--max-seq", "96"]
TIMEOUT = 240


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cmd():
    return [sys.executable, "-m", "repro_torch.launch.serve", *ARGS]


def _run(extra):
    return subprocess.run([*_cmd(), *extra], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT)


def _reqs(text):
    return [ln for ln in text.splitlines() if ln.startswith("REQ ")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run (with metrics and trace files), the killed
    run (SIGTERM after its first REQ line) and the resumed run."""
    d = tmp_path_factory.mktemp("resume")
    # the uninterrupted run goes on beside the killed one
    full = subprocess.Popen(
        [*_cmd(), "--metrics-file", str(d / "m.prom"), "--metrics-every",
         "7", "--trace-file", str(d / "t.json")], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    killed = subprocess.Popen([*_cmd(), "--snapshot-dir", str(d / "snap")],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              text=True)
    # the subprocesses' own time limit (the reads below block until the
    # killed run exits)
    watchdog = threading.Timer(TIMEOUT, lambda: (killed.kill(), full.kill()))
    watchdog.start()
    head = []
    try:
        for line in killed.stdout:
            head.append(line)
            if line.startswith("REQ "):
                killed.send_signal(signal.SIGTERM)
                break
        # the same buffered reader: lines it already holds are kept
        tail = killed.stdout.read()
        killed.wait()
        out, err = full.communicate(timeout=TIMEOUT)
    finally:
        watchdog.cancel()
        for proc in (killed, full):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    resumed = _run(["--snapshot-dir", str(d / "snap"), "--resume",
                    "--metrics-file", str(d / "r.json")])
    return dict(dir=d, full_rc=full.returncode, full_out=out, full_err=err,
                killed_rc=killed.returncode,
                killed_out="".join(head) + tail, resumed=resumed)


def test_sigterm_snapshots_and_exits_3(runs):
    assert runs["full_rc"] == 0, runs["full_err"][-2000:]
    assert runs["killed_rc"] == 3, runs["killed_out"][-2000:]
    assert "preempted: snapshot committed to" in runs["killed_out"]
    assert len(_reqs(runs["killed_out"])) < 32


def test_resume_reproduces_the_uninterrupted_run(runs):
    res = runs["resumed"]
    assert res.returncode == 0, res.stderr[-2000:]
    assert "resumed from snapshot step" in res.stdout
    want = _reqs(runs["full_out"])
    assert len(want) == 32
    got = _reqs(runs["killed_out"]) + _reqs(res.stdout)
    assert got == want


def test_obs_dump_validates_metrics_and_trace(runs):
    d = runs["dir"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert obs_dump.main(["--metrics", str(d / "m.prom"),
                              "--trace", str(d / "t.json")]) == 0
        assert obs_dump.main(["--metrics", str(d / "r.json")]) == 0
    text = out.getvalue()
    assert "valid Prometheus exposition" in text
    assert "JSON metrics" in text
    assert "valid trace" in text and "tick" in text and "prefill" in text
    assert "repro_alloc_granted_total" in (d / "m.prom").read_text()


def test_obs_dump_snapshot_view_equals_reference(runs):
    """The port's view of the killed run's snapshot directory is the
    reference tool's, line for line."""
    spec = importlib.util.spec_from_file_location(
        "ref_obs_dump", ROOT / "scripts" / "obs_dump.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    snap = str(runs["dir"] / "snap")
    a, b = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(a):
        obs_dump.dump_snapshot(snap)
    with contextlib.redirect_stdout(b):
        ref.dump_snapshot(snap)
    assert a.getvalue() == b.getvalue()
    assert "live pages held" in a.getvalue()


@pytest.mark.parametrize("argv,match", [
    (["--metrics-every", "0"], "--metrics-every must be >= 1"),
    (["--resume"], "--resume requires --snapshot-dir"),
])
def test_cli_rejects_bad_flags(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "qwen2-0.5b", *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_obs_dump_live_on_the_cpu(mega, capsys):
    """``--live`` replays a scenario on a smoke engine through the port's
    ``serve/replay.py`` with a tracer, then prints the drained telemetry
    (every page granted is back) and the validated metrics and trace
    (every tick steady: the CPU loads no kernel library)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert obs_dump.main(["--live", "--device", "cpu",
                              *(["--mega"] if mega else [])]) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    words = {ln.split()[0]: ln.split(None, 1)[1]
             for ln in out.splitlines() if ln.startswith("  t_")}
    granted = sum(map(int, words["t_alloc"].strip("[]").split(",")))
    freed = sum(map(int, words["t_free"].strip("[]").split(",")))
    assert granted == freed > 0
    assert f"{'mega' if mega else 'host'} on cpu" in out
    assert "metrics exposition: valid" in out
    assert "trace: valid" in out and "every tick steady" in out
