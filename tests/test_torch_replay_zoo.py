"""The port's replay of every reference config against the reference's,
on the CPU.

For each of the reference's ten archs (``repro.configs.ALL_ARCHS``),
its smoke config and parameters (the reference ``Model.init`` with key
0, converted by ``params_from_jax``) serve the reference's zoo smoke
trace (``tests/test_replay.py``'s ``_SMOKE``: the abandon scenario cut
to 4 requests, 2-5 new tokens, abandon fraction 0.4, seed 3) on float32
engines at max_batch 2, max_seq 96: the reference's engine (jnp
allocator backend) through the reference's ``replay``, the port's
through the port's ``replay``, host loop and mega-step.  Equal, exactly:
tokens per uid, cancelled uids, ``steps``, ``queue_wait``, and the
stats ``allocs``, ``frees``, ``evictions``, ``defrag_waves``,
``pages_migrated`` and ``aux_pages_per_slot``; ``frag_ratio_final``
within 1e-6.  Both engines are conserved at drain.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ALL_ARCHS
from repro.configs import get_arch as jget
from repro.models.model import build_model as jbuild
from repro.serve import replay as jrp
from repro.serve.engine import ServingEngine as JEngine

from repro_torch.configs import ARCH_REGISTRY, get_arch
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.serve import replay as rp
from repro_torch.serve.engine import ServingEngine

SMOKE = dict(n_requests=4, out_lens=(2, 5), abandon_frac=0.4)
STATS = ("allocs", "frees", "evictions", "defrag_waves", "pages_migrated",
         "aux_pages_per_slot")
ENGINE = dict(max_batch=2, max_seq=96, max_new_cap=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_zoo_is_every_reference_config():
    assert len(ALL_ARCHS) == 10
    assert set(ALL_ARCHS) == set(ARCH_REGISTRY)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_replay_equals_reference(arch):
    cfg, tcfg = jget(arch).smoke(), get_arch(arch).smoke()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = P.params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    sc = dataclasses.replace(jrp.SCENARIOS["abandon"], **SMOKE)
    trace = jrp.generate_trace(sc, seed=3, vocab_size=cfg.vocab_size)
    mine = rp.generate_trace(
        dataclasses.replace(rp.SCENARIOS["abandon"], **SMOKE), seed=3,
        vocab_size=tcfg.vocab_size)
    assert [dataclasses.astuple(it) for it in mine] == \
        [dataclasses.astuple(it) for it in trace]
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", **ENGINE)
    want = jrp.replay(je, trace, scenario="smoke")
    jrp.assert_conserved(je)
    assert len(want.tokens) + len(want.cancelled) == len(trace)
    for mega in (False, True):
        eng = ServingEngine(tm, tp, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu",
                            mega_step=mega, **ENGINE)
        got = rp.replay(eng, mine, scenario="smoke")
        what = f"{arch} {'mega' if mega else 'host'}"
        assert got.tokens == {u: list(map(int, t))
                              for u, t in want.tokens.items()}, what
        assert got.cancelled == want.cancelled, what
        assert got.steps == want.steps, what
        assert got.queue_wait == want.queue_wait, what
        gs, ws = got.summary(), want.summary()
        assert {k: gs[k] for k in STATS} == {k: ws[k] for k in STATS}, what
        assert abs(gs["frag_ratio_final"] - ws["frag_ratio_final"]) <= 1e-6
        rp.assert_conserved(eng)
