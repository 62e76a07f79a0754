"""Lockstep driving of the port's serving engine beside the JAX
reference's, shared by the encoder-decoder, VLM and last dense
(command-r-35b, internlm2-20b) engine tests.

``drive`` steps both engines through the reference replay harness's
``TraceItem`` schedule (submissions, cancels) and checks after every
step that both hold the same KV page ids; ``check_same`` compares the
stats both engines keep and the arena words.  ``plain_matches`` and
``abandonment_matches`` are the whole engine cases of one arch.
"""
import numpy as np

from repro.serve.replay import TraceItem


def drive(engines, trace, each_step=None, max_steps=400):
    """Step ``engines`` (reference, port) through ``trace`` in lockstep;
    after every step their slots hold the same page ids and page tables,
    and ``each_step(je, te, t)`` runs when given.  Returns per engine
    (tokens per uid, cancelled uids)."""
    out = [({}, []) for _ in engines]
    items = sorted(trace, key=lambda it: it.step)
    cancel_at, nxt, t = {}, 0, 0
    je, te = engines
    while t < max_steps:
        while nxt < len(items) and items[nxt].step <= t:
            it = items[nxt]
            uids = {e.submit(np.asarray(it.prompt, np.int32),
                             max_new_tokens=it.max_new) for e in engines}
            assert len(uids) == 1
            if it.cancel_step is not None:
                cancel_at.setdefault(max(it.cancel_step, t + 1),
                                     []).append(uids.pop())
            nxt += 1
        for uid in cancel_at.pop(t, []):
            for e, (toks, cancelled) in zip(engines, out):
                if uid not in toks and e.cancel(uid):
                    cancelled.append(uid)
        for e, (toks, _) in zip(engines, out):
            for r in e.step():
                toks[r.uid] = list(map(int, r.out_tokens))
        assert [list(map(int, a)) for a in te.slot_pages] == \
            [[int(p) for p in a] for a in je.slot_pages], f"step {t}"
        np.testing.assert_array_equal(te._kv().page_table.numpy(),
                                      np.asarray(je._kv().page_table),
                                      err_msg=f"step {t}")
        if each_step is not None:
            each_step(je, te, t)
        t += 1
        if nxt == len(items) and all(
                not e.waiting and all(r is None for r in e.slot_req)
                for e in engines):
            return out
    raise AssertionError(f"not drained in {max_steps} steps")


def check_same(je, te):
    """The stats both engines keep, and the arena words, are equal."""
    shared = set(je.stats) & set(te.stats)
    assert {"allocs", "frees", "alloc_txns", "cancels", "steps",
            "alloc_failures"} <= shared
    assert {k: te.stats[k] for k in shared} == \
        {k: je.stats[k] for k in shared}
    np.testing.assert_array_equal(te.alloc_state.mem.numpy(),
                                  np.asarray(je.alloc_state.mem))
    np.testing.assert_array_equal(te.alloc_state.ctl.numpy(),
                                  np.asarray(je.alloc_state.ctl))


def drained(te):
    """``allocs == frees`` and no page left in the table."""
    assert te.stats["allocs"] == te.stats["frees"] > 0
    assert bool((te._kv().page_table == -1).all())


def plain_trace(cfg, lens, max_new=8):
    """Prompts of ``lens`` tokens, all submitted at step 0."""
    rng = np.random.default_rng(len(lens))
    return [TraceItem(step=0, prompt=tuple(int(t) for t in rng.integers(
        2, cfg.vocab_size, n)), max_new=max_new, cancel_step=None)
        for n in lens]


def hold_all_but(je, te, pages: int):
    """A co-tenant's grant of every free page of both arenas but
    ``pages``; returns a function that frees it again in both."""
    import jax.numpy as jnp
    import torch
    free_pages = (te.ouro.frag_stats(te.alloc_state)["free_words"]
                  // te.wpp)
    hold = free_pages - pages
    sizes = np.full(hold, 256, np.int32)
    je.alloc_state, jo = je.ouro.alloc(je.alloc_state, jnp.asarray(sizes),
                                       jnp.ones(hold, bool))
    te.alloc_state, to = te.ouro.alloc(te.alloc_state,
                                       torch.from_numpy(sizes),
                                       torch.ones(hold, dtype=torch.bool))
    assert (to.numpy() >= 0).all()
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    def release():
        te.alloc_state = te.ouro.free(te.alloc_state, to,
                                      torch.from_numpy(sizes), to >= 0)
        je.alloc_state = je.ouro.free(je.alloc_state, jo, jnp.asarray(sizes),
                                      jo >= 0)
    return release


_MODELS = {}


def models(arch):
    """(reference model, its params, port model, converted params) of
    ``arch``'s smoke config, made once per process."""
    import jax
    from repro.configs import get_arch as jget
    from repro.models.model import build_model as jbuild
    from repro_torch.configs import get_arch
    from repro_torch.models import params as P
    from repro_torch.models.model import build_model
    if arch not in _MODELS:
        cfg, tcfg = jget(arch).smoke(), get_arch(arch).smoke()
        jm = jbuild(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[arch] = (jm, jp, build_model(tcfg), P.params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


def engines(arch, mega, **kw):
    """float32 engines of both packages (the reference on its jnp
    backend) over ``models(arch)``."""
    import jax.numpy as jnp
    import torch
    from repro.serve.engine import ServingEngine as JEngine
    from repro_torch.serve.engine import ServingEngine
    jm, jp, tm, tp = models(arch)
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


def plain_matches(arch, mega):
    """Prompts of 2-70 tokens, 8 new each, max_batch 3: the same tokens,
    page ids every step, stats and arena words, all pages returned."""
    je, te = engines(arch, mega, max_batch=3, max_seq=96)
    lens = (40, 9, 70, 2)
    (jt, _), (tt, _) = drive((je, te), plain_trace(te.cfg, lens))
    assert tt == jt and len(tt) == len(lens)
    check_same(je, te)
    drained(te)


def abandonment_matches(arch, mega):
    """The reference replay harness's abandonment trace (seed 7):
    cancels of waiting and active requests free every page."""
    from repro.serve.replay import SCENARIOS, generate_trace
    from repro_torch.configs import get_arch
    trace = generate_trace(SCENARIOS["abandon"], seed=7,
                           vocab_size=get_arch(arch).smoke().vocab_size,
                           max_seq=96)
    je, te = engines(arch, mega, max_batch=3, max_seq=128)
    (jt, jcan), (tt, tcan) = drive((je, te), trace)
    assert tcan == jcan and tcan, "the trace cancelled nothing"
    assert tt == jt and tt
    check_same(je, te)
    drained(te)
