"""The port's observability layer held to the JAX reference's.

- ``obs/metrics.py`` and ``obs/trace.py``: the reference's
  ``tests/test_obs.py`` cases on metrics and traces, and the same calls
  on both registries give the same Prometheus text and JSON;
- the serving engine: the port's (``device="cpu"``) and the reference's
  (jnp backend) serve the same trace with a ``Tracer`` through
  admission, prefill, growth, defrag waves, evictions, cancels (waiting
  and active), a rebalance wave and a snapshot/restore, at S = 1 (host
  loop) and S = 4 (mega-step): the sequence of span names, phases and
  arguments is equal (times aside), and so are ``drain_telemetry`` and
  every ``publish_metrics`` exposition line but
  ``repro_engine_jit_first_calls_total``.  That counter means jit cache
  growth in the reference and kernel libraries loaded in the port (none
  on the CPU), so it and the ``tick`` span's compile/steady category are
  compared to their own meaning instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models.model import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import get_arch
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import MetricsRegistry, validate_exposition
from repro_torch.obs.trace import NULL, PHASES, Tracer, validate_trace
from repro_torch.serve.engine import ServingEngine

JIT_LINE = "repro_engine_jit_first_calls_total"


# ---- metrics registry --------------------------------------------------------

def test_metrics_counter_gauge_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("repro_test_total", "a counter", labelnames=("shard",))
    c.labels(shard=0).inc()
    c.labels(shard=0).inc(2)
    c.labels(shard=1).set(7)  # re-publishing a device total
    reg.gauge("repro_test_waiting", "a gauge").set(3)
    text = reg.to_prometheus()
    assert validate_exposition(text) == 3
    assert 'repro_test_total{shard="0"} 3' in text
    assert 'repro_test_total{shard="1"} 7' in text
    doc = reg.to_json()
    assert doc["repro_test_total"]["type"] == "counter"
    vals = {tuple(s["labels"].items()): s["value"]
            for s in doc["repro_test_total"]["samples"]}
    assert vals[(("shard", "0"),)] == 3


def test_metrics_histogram_exposition():
    reg = MetricsRegistry()
    h = reg.histogram("repro_test_ms", "latency", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    text = reg.to_prometheus()
    assert validate_exposition(text) > 0
    assert 'repro_test_ms_bucket{le="10"} 2' in text
    assert 'repro_test_ms_bucket{le="+Inf"} 4' in text
    assert "repro_test_ms_count 4" in text
    assert "repro_test_ms_sum 555.5" in text


def test_metrics_declaration_hygiene():
    reg = MetricsRegistry()
    reg.counter("repro_ok_total", "x", labelnames=("a",))
    assert reg.counter("repro_ok_total", "x", labelnames=("a",)) \
        is reg.get("repro_ok_total")
    with pytest.raises(ValueError, match="re-declared"):
        reg.gauge("repro_ok_total", "x", labelnames=("a",))
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad name", "x")
    with pytest.raises(ValueError, match="got labels"):
        reg.get("repro_ok_total").labels(b=1)
    with pytest.raises(TypeError):
        reg.histogram("repro_h", "x").inc()


def test_validate_exposition_rejects_malformed():
    with pytest.raises(ValueError, match="no TYPE"):
        validate_exposition("orphan_sample 1\n")
    with pytest.raises(ValueError, match="malformed sample"):
        validate_exposition("# TYPE x counter\nx{bad 1\n")
    with pytest.raises(ValueError, match="no samples"):
        validate_exposition("# TYPE x counter\n")


def _publish(reg):
    c = reg.counter("repro_a_total", "a", labelnames=("shard", "c"))
    for s in range(3):
        for k in range(2):
            c.labels(shard=s, c=k).set(s * 10 + k + 0.5 * (k == 1))
    reg.gauge("repro_g", "g").set(0.1)
    h = reg.histogram("repro_h_ms", "h", labelnames=("kind",))
    for v in (0.3, 7.0, 12345.0, 2.5):
        h.labels(kind="x").observe(v)
    reg.counter("repro_b_total", "b").inc(4)
    return reg


def test_registry_exposition_equals_reference():
    """The same calls give the reference's Prometheus text and JSON."""
    mine, ref = _publish(MetricsRegistry()), _publish(
        jmetrics.MetricsRegistry())
    assert mine.to_prometheus() == ref.to_prometheus()
    assert mine.to_json() == ref.to_json()
    for text in ("orphan 1\n", "# TYPE x counter\nx{bad 1\n",
                 mine.to_prometheus()):
        try:
            want = jmetrics.validate_exposition(text)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:12]):
                validate_exposition(text)
        else:
            assert validate_exposition(text) == want


# ---- trace spans -------------------------------------------------------------

def test_tracer_spans_and_validation():
    tr = Tracer()
    with tr.span("prefill", slot=1):
        pass
    ts = tr.begin()
    tr.complete("tick", ts, cat="compile", step=0)
    ts = tr.begin()
    tr.complete("tick", ts, cat="steady", step=1)
    tr.instant("cancel", uid=3)
    doc = tr.to_json()
    assert validate_trace(doc, require_phases=True) == 4
    names = [ev["name"] for ev in doc["traceEvents"]]
    assert names == ["prefill", "tick", "tick", "cancel"]
    assert all(ev["name"].split("/")[0] in PHASES
               for ev in doc["traceEvents"])
    assert PHASES == jtrace.PHASES
    assert jtrace.validate_trace(doc, require_phases=True) == 4


def test_validate_trace_rejections():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_trace({})
    bad = {"traceEvents": [{"name": "not_a_phase", "cat": "engine",
                            "ph": "X", "ts": 0, "dur": 1,
                            "pid": 0, "tid": 0}]}
    with pytest.raises(ValueError, match="taxonomy"):
        validate_trace(bad)
    steady_only = Tracer()
    steady_only.complete("tick", steady_only.begin(), cat="steady")
    with pytest.raises(ValueError, match="compile"):
        validate_trace(steady_only.to_json(), require_phases=True)
    assert validate_trace(steady_only.to_json()) == 1


def test_null_tracer_is_noop(tmp_path):
    before = len(NULL.events)
    with NULL.span("tick"):
        pass
    NULL.complete("tick", NULL.begin())
    NULL.instant("cancel")
    assert len(NULL.events) == before
    tr = Tracer()
    tr.instant("cancel", uid=1, where="waiting")
    tr.write(str(tmp_path / "t.json"))
    assert validate_trace(jtrace.load(str(tmp_path / "t.json"))) == 1


# ---- the engine, port against reference --------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = jget("qwen2-0.5b").smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_arch("qwen2-0.5b").smoke()
    return jm, jp, build_model(tcfg), P.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _cotenant(je, te, free):
    """A co-tenant takes every free page of both arenas but ``free``,
    in transactions of the engines' own lane count (no new shapes for
    the reference to compile): the engines run short and evict."""
    lanes = 2 * te.max_batch
    sizes = np.full(lanes, 256, np.int32)
    while True:
        n = te.ouro.frag_stats(te.alloc_state)["free_words"] // te.wpp - free
        if n <= 0:
            return
        mask = np.arange(lanes) < n
        je.alloc_state, oj = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                           jnp.asarray(mask))
        te.alloc_state, ot = te.ouro.alloc(te.alloc_state,
                                           torch.from_numpy(sizes),
                                           torch.from_numpy(mask))
        np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
        assert (ot.numpy()[mask] >= 0).all()


# (engine settings, pages left free by a co-tenant (None: no co-tenant),
# max new tokens, prompt lengths)
CASES = {
    "S1-host": (dict(max_batch=3, max_seq=64, num_pages=16), 7, 12, (24,)),
    "S4-mega": (dict(max_batch=3, max_seq=64, num_shards=4,
                     rebalance_threshold=1, mega_step=True), None, 6, (30,)),
}


def _serve(e, prompts, max_new):
    """Five requests; the fourth cancelled while waiting, the third
    once active; an in-memory snapshot restored into the same engine
    at step 2.  Returns the tokens per uid."""
    for i in range(5):
        e.submit(prompts[i % len(prompts)], max_new)
    e.cancel(4)
    done = []
    for t in range(300):
        if t == 2:
            e.restore(e.snapshot())
        if t == 3:
            assert e.cancel(3)
        done += e.step()
        if not e.waiting and all(r is None for r in e.slot_req):
            break
    return {r.uid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request, models):
    """Both engines through one case: (reference, port, their tokens)."""
    jm, jp, tm, tp = models
    kw, free, max_new, lens = CASES[request.param]
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", tracer=jtrace.Tracer(), **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       tracer=Tracer(), **kw)
    if free is not None:
        _cotenant(je, te, free)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 500, n) for n in lens]
    return request.param, je, te, _serve(je, prompts, max_new), \
        _serve(te, prompts, max_new)


def _events(tracer):
    return [(ev["name"], ev["ph"], ev["args"]) for ev in tracer.events]


def test_engine_spans_equal_reference(served):
    case, je, te, want, got = served
    assert got == want and len(got) == 3
    assert _events(te.tracer) == _events(je.tracer)
    names = {ev["name"] for ev in te.tracer.events}
    expect = {"admission", "prefill", "tick", "snapshot", "restore",
              "cancel"}
    expect |= ({"bulk_grow", "defrag_wave", "eviction"} if case == "S1-host"
               else {"rebalance_wave"})
    assert expect <= names, names
    assert validate_trace(te.tracer.to_json()) == len(te.tracer.events)
    # no kernel library exists on the CPU: every port tick is steady,
    # while the reference's first ticks compiled
    ticks = [ev["cat"] for ev in te.tracer.events if ev["name"] == "tick"]
    assert set(ticks) == {"steady"} and not te.last_tick_compiled
    assert "compile" in {ev["cat"] for ev in je.tracer.events
                         if ev["name"] == "tick"}


def test_engine_metrics_equal_reference(served):
    case, je, te, _, _ = served
    for field, want in je.drain_telemetry().items():
        np.testing.assert_array_equal(te.drain_telemetry()[field],
                                      np.asarray(want), err_msg=field)
    mine = te.publish_metrics().to_prometheus()
    ref = je.publish_metrics(jmetrics.MetricsRegistry()).to_prometheus()
    assert validate_exposition(mine) == jmetrics.validate_exposition(ref)

    def lines(text):
        return [ln for ln in text.splitlines() if JIT_LINE not in ln]
    assert lines(mine) == lines(ref)
    assert f"{JIT_LINE} 0" in mine.splitlines()
    assert te.jit_first_calls == 0 < je.stats["jit_first_calls"]
    # the engine's own registry is what it publishes into by default
    assert te.publish_metrics() is te.metrics
    if case == "S4-mega":
        assert 'repro_alloc_granted_total{shard="3",size_class="4"}' in mine
