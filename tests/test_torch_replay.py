"""The port's traffic-replay harness (``repro_torch/serve/replay.py``)
held to the reference's ``serve/replay.py`` on the CPU.

- ``generate_trace`` gives the reference's trace, item for item, for
  every scenario of the zoo, seeds 0-3, two vocab sizes and two engine
  bounds;
- ``Scenario`` refuses what the reference refuses, with its messages;
- ``ReplayResult.summary()`` gives the reference's cell, key for key
  and value for value, for the same replay record;
- the port-side counterparts of the reference's parity tests
  (``tests/test_replay.py``), on the port's own float32 smoke engines
  (``engine_factory(device="cpu")``): bursty traffic host loop against
  mega-step on qwen2, abandonment with aux pages on recurrentgemma,
  shards 1 against 4, abandonment freeing every page on mamba2 in both
  loops, and the three uid states of ``cancel``.  Exact: tokens per
  uid, cancelled uids, queue waits, and ``allocs == frees`` with no page
  held.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import replay as jrp

from repro_torch.serve import replay as rp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- traces -------------------------------------------------------------------

@pytest.mark.parametrize("bounds", ({}, {"max_seq": 48, "max_new_cap": 8}),
                         ids=("default", "tight"))
@pytest.mark.parametrize("vocab", (512, 256000))
@pytest.mark.parametrize("name", sorted(jrp.SCENARIOS))
def test_generate_trace_equals_reference(name, vocab, bounds):
    assert rp.SCENARIOS[name] == rp.Scenario(
        **dataclasses.asdict(jrp.SCENARIOS[name]))
    for seed in range(4):
        want = jrp.generate_trace(jrp.SCENARIOS[name], seed=seed,
                                  vocab_size=vocab, **bounds)
        got = rp.generate_trace(rp.SCENARIOS[name], seed=seed,
                                vocab_size=vocab, **bounds)
        assert [dataclasses.astuple(it) for it in got] == \
            [dataclasses.astuple(it) for it in want]
        assert all(type(it) is rp.TraceItem for it in got)


def test_trace_determinism_and_bounds():
    sc = rp.SCENARIOS["bursty"]
    a = rp.generate_trace(sc, seed=13, vocab_size=128)
    assert a == rp.generate_trace(sc, seed=13, vocab_size=128)
    assert a != rp.generate_trace(sc, seed=14, vocab_size=128)
    items = rp.generate_trace(sc, seed=0, vocab_size=64, max_seq=48,
                              max_new_cap=8)
    assert len(items) == sc.n_requests
    assert items == sorted(items, key=lambda it: it.step)
    for it in items:
        assert 1 <= len(it.prompt) and 1 <= it.max_new <= 8
        assert len(it.prompt) + it.max_new <= 48
        assert all(2 <= t < 64 for t in it.prompt)


@pytest.mark.parametrize("bad", ({"arrival": "uniform"},
                                 {"abandon_frac": 1.5},
                                 {"abandon_frac": -0.1}))
def test_scenario_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        jrp.Scenario("bad", **bad)
    with pytest.raises(ValueError) as got:
        rp.Scenario("bad", **bad)
    assert str(got.value) == str(want.value)


# ---- the summary --------------------------------------------------------------

@pytest.mark.parametrize("sharded", (False, True), ids=("one", "shards"))
def test_summary_equals_reference(sharded):
    """The same replay record through both ``summary()``: the same keys
    and values, compile ticks split out of the steady percentiles
    (``frag_ratio`` a list per shard when sharded)."""
    rng = np.random.default_rng(5)
    frag = [0.25, 0.5, 0.125, 0.0] if sharded else 0.375
    rec = dict(scenario="bursty", arch="qwen2-0.5b-smoke", mode="mega",
               tokens={1: [3, 4], 2: [5], 4: [6, 7, 8]}, cancelled=[3],
               steps=17, tick_ms=list(rng.exponential(2.0, 17)),
               queue_wait={1: 0, 2: 3, 4: 7},
               stats={"evictions": 1, "defrag_waves": 2,
                      "auto_defrag_waves": 1, "pages_migrated": 9,
                      "aux_pages_per_slot": 0, "allocs": 40, "frees": 40,
                      "frag_ratio": frag},
               compiled=[True, True] + [False] * 15)
    want = jrp.ReplayResult(**rec).summary()
    got = rp.ReplayResult(**rec).summary()
    assert list(got) == list(want) and got == want
    assert got["compile_ms"] > 0 and got["completed"] == 3


# ---- parity on the port's engines ------------------------------------------

def test_bursty_parity_mega_vs_host():
    """A bursty trace that overruns max_batch: host loop and mega-step
    give the same tokens and queue waits."""
    cfg, make = rp.engine_factory("qwen2-0.5b", device="cpu")
    trace = rp.generate_trace(rp.SCENARIOS["bursty"], seed=11,
                              vocab_size=cfg.vocab_size)
    assert len(trace) > 3 * 2, "the burst should overrun the batch"
    host, mega = rp.replay_pair(make(mega=False), make(mega=True), trace,
                                scenario="bursty")
    assert host.tokens == mega.tokens and host.tokens
    assert host.queue_wait == mega.queue_wait
    assert max(host.queue_wait.values()) > 0
    assert (host.mode, mega.mode) == ("host", "mega")
    for r in (host, mega):
        s = r.summary()
        assert s["completed"] + s["cancelled"] == s["requests"] == 18
        assert s["compile_ms"] == 0.0 and not any(r.compiled)


def test_abandon_parity_with_aux_pages():
    """Cancels mid-stream on a model whose slots hold aux pages (the
    hybrid's RG-LRU state)."""
    cfg, make = rp.engine_factory("recurrentgemma-9b", device="cpu")
    eng_h, eng_m = make(mega=False), make(mega=True)
    assert eng_h.aux_pages > 0
    trace = rp.generate_trace(rp.SCENARIOS["abandon"], seed=7,
                              vocab_size=cfg.vocab_size)
    host, mega = rp.replay_pair(eng_h, eng_m, trace, scenario="abandon")
    assert host.cancelled == mega.cancelled and host.cancelled
    assert host.summary()["aux_pages_per_slot"] == eng_h.aux_pages


def test_shard_parity():
    """Shards 1 and 4, the same trace and loop: the same tokens."""
    cfg, make = rp.engine_factory("qwen2-0.5b", device="cpu")
    trace = rp.generate_trace(rp.SCENARIOS["steady"], seed=2,
                              vocab_size=cfg.vocab_size)
    one, four = rp.replay_pair(make(mega=False, num_shards=1),
                               make(mega=False, num_shards=4), trace,
                               scenario="steady")
    assert one.tokens == four.tokens and one.tokens
    assert isinstance(four.stats["frag_ratio"], list)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
def test_abandonment_frees_all_pages(mega):
    """After an abandonment-heavy replay on mamba2 (aux pages, no KV)
    drains, every page went back: ``allocs == frees``, no slot holds a
    page, no shard a live page."""
    cfg, make = rp.engine_factory("mamba2-780m", device="cpu")
    eng = make(mega=mega)
    assert eng.aux_pages > 0
    trace = rp.generate_trace(rp.SCENARIOS["abandon"], seed=5,
                              vocab_size=cfg.vocab_size)
    r = rp.replay(eng, trace, scenario="abandon")
    assert r.cancelled, "the abandon trace cancelled nothing"
    rp.assert_conserved(eng)
    assert eng.stats["cancels"] == len(r.cancelled)
    assert eng.stats["allocs"] > 0


def test_cancel_waiting_active_retired():
    """A waiting uid leaves the queue, an active one frees its pages, a
    retired or unknown one is a no-op returning False."""
    cfg, make = rp.engine_factory("qwen2-0.5b", max_batch=2, device="cpu")
    eng = make(mega=False)
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.integers(2, cfg.vocab_size, 6), max_new_tokens=4)
            for _ in range(4)]
    eng.step()
    active = {r.uid for r in eng.slot_req if r is not None}
    waiting = [r.uid for r in eng.waiting]
    assert len(active) == 2 and len(waiting) == 2
    assert eng.cancel(waiting[0]) is True
    live = eng.stats["allocs"] - eng.stats["frees"]
    victim = sorted(active)[0]
    assert eng.cancel(victim) is True
    assert eng.stats["allocs"] - eng.stats["frees"] < live
    assert eng.cancel(victim) is False
    assert eng.cancel(10_000) is False
    done = eng.run_until_done(500)
    assert eng.cancel(done[0].uid) is False
    assert {r.uid for r in done} == set(uids) - {waiting[0], victim}
    rp.assert_conserved(eng)
    assert eng.stats["cancels"] == 2


def test_engine_factory_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        rp.engine_factory("qwen2-0.5b")
