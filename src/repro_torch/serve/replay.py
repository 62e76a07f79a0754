"""Traffic-replay harness (port of the reference's ``serve/replay.py``).

A deterministic, seedable traffic generator (Poisson arrivals, bursty
spikes, mixed prompt and output lengths, clients that abandon
mid-stream) and a replay loop that pushes any :class:`ServingEngine`
through a trace, recording tick latency, queue waits, evictions,
``frag_ratio`` and defrag waves.

``generate_trace(scenario, seed=s, ...)`` is a pure function of its
arguments and gives the reference's trace, item for item, for the same
arguments (numpy's ``default_rng``, drawn in the reference's order).  A
trace replays token for token per uid on the host loop and on the
mega-step, and at any shard count (:func:`replay_pair` and
:func:`assert_conserved`).  Abandonment is an absolute engine step
(cancel at step ``t``), which both loops reach through the same host
admission, so cancels keep parity.

Compile ticks: the port has no jit.  Its only compile is a kernel
library built or loaded at first use (``kernels/build.py``), so a tick
during which the loaded libraries grew counts as ``compiled``; every
other tick, and every tick on the CPU, does not.  The engine keeps that
signal (``ServingEngine.last_tick_compiled``, the tick span's category)
and the replay reads it from there, as the reference's reads its
engine's.

    from repro_torch.serve.replay import (SCENARIOS, engine_factory,
                                          generate_trace, replay_pair)
    cfg, make = engine_factory("mamba2-780m", device="cpu")
    trace = generate_trace(SCENARIOS["bursty"], seed=0,
                           vocab_size=cfg.vocab_size)
    host, mega = replay_pair(make(mega=False), make(mega=True), trace)
    print(host.summary())
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One deterministic traffic shape.

    All randomness flows from the seed handed to :func:`generate_trace`.
    A prompt's length is drawn from ``prompt_long`` with probability
    ``long_frac``, else from ``prompt_short`` (inclusive uniform
    ranges); output budgets from ``out_lens``.  A client abandons with
    probability ``abandon_frac``, hanging up ``abandon_after`` steps
    after it arrived (absolute engine-step time)."""
    name: str
    n_requests: int = 12
    arrival: str = "poisson"            # poisson | burst
    rate: float = 0.75                  # poisson: mean arrivals / step
    burst_every: int = 10               # burst: steps between spikes
    burst_size: int = 5                 # burst: arrivals per spike
    prompt_short: Tuple[int, int] = (4, 12)
    prompt_long: Tuple[int, int] = (20, 44)
    long_frac: float = 0.25
    out_lens: Tuple[int, int] = (2, 14)
    abandon_frac: float = 0.0
    abandon_after: Tuple[int, int] = (2, 12)

    def __post_init__(self):
        if self.arrival not in ("poisson", "burst"):
            raise ValueError(
                f"unknown arrival process {self.arrival!r}; pick from "
                f"('poisson', 'burst')")
        if not 0.0 <= self.abandon_frac <= 1.0:
            raise ValueError(
                f"abandon_frac must be in [0, 1], got "
                f"{self.abandon_frac!r}")


#: The reference's scenario zoo: ``steady`` is the baseline; ``bursty``
#: spikes admissions past ``max_batch`` so the queue and the allocator
#: churn together; ``abandon`` cancels half the clients mid-stream.
SCENARIOS = {
    "steady": Scenario("steady"),
    "bursty": Scenario("bursty", arrival="burst", burst_every=8,
                       burst_size=6, n_requests=18, long_frac=0.4),
    "abandon": Scenario("abandon", abandon_frac=0.5, n_requests=14,
                        out_lens=(6, 14)),
}


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One client: arrives at ``step``, submits ``prompt`` with budget
    ``max_new``, and cancels at absolute step ``cancel_step`` (None:
    stays to completion)."""
    step: int
    prompt: Tuple[int, ...]
    max_new: int
    cancel_step: Optional[int]


def generate_trace(scenario: Scenario, *, seed: int, vocab_size: int,
                   max_seq: int = 96, max_new_cap: int = 32
                   ) -> List[TraceItem]:
    """The trace of ``scenario``, sorted by arrival step.  Prompt and
    budget are clipped so every request fits ``max_seq``, and budgets to
    the mega-step's ``max_new_cap``.

    >>> a = generate_trace(SCENARIOS["steady"], seed=7, vocab_size=64)
    >>> a == generate_trace(SCENARIOS["steady"], seed=7, vocab_size=64)
    True
    >>> a != generate_trace(SCENARIOS["steady"], seed=8, vocab_size=64)
    True
    """
    rng = np.random.default_rng(seed)
    sc = scenario
    steps: List[int] = []
    t = 0
    while len(steps) < sc.n_requests:
        if sc.arrival == "poisson":
            k = int(rng.poisson(sc.rate))
        else:  # a spike every burst_every steps, quiet between
            k = sc.burst_size if t % sc.burst_every == 0 else 0
        steps.extend([t] * min(k, sc.n_requests - len(steps)))
        t += 1
    items = []
    for step in steps:
        lo, hi = (sc.prompt_long if rng.random() < sc.long_frac
                  else sc.prompt_short)
        budget = int(rng.integers(sc.out_lens[0], sc.out_lens[1] + 1))
        budget = min(budget, max_new_cap)
        lp = int(rng.integers(lo, hi + 1))
        lp = max(1, min(lp, max_seq - budget - 2))
        prompt = tuple(int(x) for x in rng.integers(2, vocab_size, lp))
        cancel = None
        if rng.random() < sc.abandon_frac:
            cancel = step + int(rng.integers(sc.abandon_after[0],
                                             sc.abandon_after[1] + 1))
        items.append(TraceItem(step, prompt, budget, cancel))
    return items


@dataclasses.dataclass
class ReplayResult:
    """What one replay of one trace through one engine produced."""
    scenario: str
    arch: str
    mode: str                       # host | mega
    tokens: Dict[int, List[int]]    # uid -> emitted tokens (completed)
    cancelled: List[int]            # uids actually cancelled
    steps: int
    tick_ms: List[float]            # host wall per engine step
    queue_wait: Dict[int, int]      # uid -> steps from arrival to admission
    stats: dict                     # engine stats at drain
    compiled: List[bool] = dataclasses.field(default_factory=list)
    # ^ per tick: did a kernel library get built or loaded in it?

    def summary(self) -> dict:
        """The reference's telemetry cell: p50/p99 tick latency and
        queue wait, completion and abandonment counts, and the
        allocator's fragmentation and defrag trajectory.  Ticks that
        built or loaded a kernel library are summed into ``compile_ms``
        and left out of the ``*_steady`` percentiles."""
        s = self.stats
        waits = list(self.queue_wait.values()) or [0]
        frag = s["frag_ratio"]
        frag = max(frag) if isinstance(frag, list) else frag
        flags = (self.compiled if len(self.compiled) == len(self.tick_ms)
                 else [False] * len(self.tick_ms))
        steady = [ms for ms, c in zip(self.tick_ms, flags) if not c]
        steady = steady or list(self.tick_ms)
        return {
            "scenario": self.scenario,
            "arch": self.arch,
            "mode": self.mode,
            "requests": len(self.tokens) + len(self.cancelled),
            "completed": len(self.tokens),
            "cancelled": len(self.cancelled),
            "steps": self.steps,
            "tokens": sum(len(t) for t in self.tokens.values()),
            "tick_ms_p50": float(np.percentile(self.tick_ms, 50)),
            "tick_ms_p99": float(np.percentile(self.tick_ms, 99)),
            "compile_ms": float(sum(
                ms for ms, c in zip(self.tick_ms, flags) if c)),
            "tick_ms_p50_steady": float(np.percentile(steady, 50)),
            "tick_ms_p99_steady": float(np.percentile(steady, 99)),
            "queue_wait_p50": float(np.percentile(waits, 50)),
            "queue_wait_p99": float(np.percentile(waits, 99)),
            "evictions": s["evictions"],
            "defrag_waves": s["defrag_waves"],
            "auto_defrag_waves": s["auto_defrag_waves"],
            "pages_migrated": s["pages_migrated"],
            "aux_pages_per_slot": s["aux_pages_per_slot"],
            "allocs": s["allocs"],
            "frees": s["frees"],
            "frag_ratio_final": float(frag),
        }


def replay(engine, trace: List[TraceItem], *, scenario: str = "",
           max_steps: int = 2000) -> ReplayResult:
    """Drive ``engine`` through ``trace`` to drain: submit arrivals at
    their step, issue scheduled cancels, tick once per step, and record
    completion tokens, tick latency (host wall; each tick ends in a
    host read of its tokens or flags), whether the tick loaded a kernel
    library (``engine.last_tick_compiled``) and queue waits.  Raises if
    the trace does not drain within ``max_steps``."""
    items = sorted(trace, key=lambda it: it.step)
    cancel_at: Dict[int, List[int]] = {}
    arrived: Dict[int, int] = {}        # uid -> arrival step
    admitted: Dict[int, int] = {}       # uid -> admission step
    tokens: Dict[int, List[int]] = {}
    cancelled: List[int] = []
    tick_ms: List[float] = []
    compiled: List[bool] = []
    next_i = 0
    t = 0
    while t < max_steps:
        while next_i < len(items) and items[next_i].step <= t:
            it = items[next_i]
            uid = engine.submit(np.asarray(it.prompt, np.int32),
                                max_new_tokens=it.max_new)
            arrived[uid] = t
            if it.cancel_step is not None:
                cancel_at.setdefault(max(it.cancel_step, t + 1),
                                     []).append(uid)
            next_i += 1
        for uid in cancel_at.pop(t, []):
            if uid not in tokens and engine.cancel(uid):
                cancelled.append(uid)
        t0 = time.perf_counter()
        done = engine.step()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        compiled.append(engine.last_tick_compiled)
        for r in engine.slot_req:
            if r is not None and r.uid not in admitted:
                admitted[r.uid] = t
        for r in done:
            tokens[r.uid] = list(map(int, r.out_tokens))
            admitted.setdefault(r.uid, t)
        t += 1
        if (next_i == len(items) and not engine.waiting
                and all(r is None for r in engine.slot_req)):
            break
    else:
        raise RuntimeError(
            f"replay did not drain within {max_steps} steps "
            f"({len(tokens)} completed, {len(cancelled)} cancelled of "
            f"{len(items)})")
    engine.refresh_frag_stats()
    return ReplayResult(
        scenario=scenario,
        arch=engine.cfg.name,
        mode="mega" if engine.mega_step else "host",
        tokens=tokens,
        cancelled=sorted(cancelled),
        steps=t,
        tick_ms=tick_ms,
        queue_wait={u: admitted[u] - arrived[u] for u in admitted},
        stats=dict(engine.stats),
        compiled=compiled)


def assert_conserved(engine):
    """After a drained replay every page ever granted (KV and aux
    alike) went back through the allocator (``allocs == frees``), no
    slot holds a page id, the page table is all holes, and no shard
    holds a live page."""
    s = engine.stats
    assert s["allocs"] == s["frees"], (
        f"page leak: {s['allocs']} allocs vs {s['frees']} frees "
        f"({s['allocs'] - s['frees']} pages stranded)")
    assert all(not p for p in engine.slot_pages), engine.slot_pages
    assert all(not len(a) for a in engine.slot_aux), engine.slot_aux
    kv = engine._kv()
    if kv is not None:
        held = int((kv.page_table >= 0).sum())
        assert held == 0, f"page table still maps {held} pages"
    if engine.mega_step:
        engine._sync_shard_pages_from_table()
    assert sum(engine.stats["shard_pages_live"]) == 0, (
        engine.stats["shard_pages_live"])


def replay_pair(engine_a, engine_b, trace, *, scenario: str = "",
                max_steps: int = 2000):
    """Replay the same trace through two engines (host loop and
    mega-step, or shards 1 and 4) and assert the same tokens per uid,
    the same cancelled uids and conservation on both.  Returns the two
    :class:`ReplayResult`."""
    ra = replay(engine_a, trace, scenario=scenario, max_steps=max_steps)
    rb = replay(engine_b, trace, scenario=scenario, max_steps=max_steps)
    assert ra.cancelled == rb.cancelled, (
        f"cancelled sets diverge: {ra.mode}={ra.cancelled} vs "
        f"{rb.mode}={rb.cancelled}")
    assert set(ra.tokens) == set(rb.tokens), (
        f"completed sets diverge: {sorted(ra.tokens)} vs "
        f"{sorted(rb.tokens)}")
    for uid in ra.tokens:
        assert ra.tokens[uid] == rb.tokens[uid], (
            f"uid {uid} token streams diverge between {ra.mode} and "
            f"{rb.mode}: {ra.tokens[uid]} vs {rb.tokens[uid]}")
    assert_conserved(engine_a)
    assert_conserved(engine_b)
    return ra, rb


def engine_factory(arch: str, *, max_batch: int = 3, max_seq: int = 96,
                   max_new_cap: int = 32, seed: int = 0, device="cuda"):
    """Build the smoke config of ``arch`` and its parameters (the
    port's ``init`` from ``seed``, float32) once; returns ``(cfg,
    make)`` where ``make(mega=..., **engine_kw)`` builds a fresh float32
    :class:`ServingEngine` over the shared parameters on ``device``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    dev = resolve_device(device)
    cfg = get_arch(arch).smoke()
    model = build_model(cfg)
    params = model.init(seed, device=dev)

    def make(mega: bool = False, **kw):
        kw.setdefault("max_batch", max_batch)
        kw.setdefault("max_seq", max_seq)
        kw.setdefault("max_new_cap", max_new_cap)
        return ServingEngine(model, params, kv_dtype=torch.float32,
                             compute_dtype=torch.float32, mega_step=mega,
                             device=dev, **kw)

    return cfg, make
