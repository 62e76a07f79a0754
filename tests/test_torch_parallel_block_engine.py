"""The serving engine of command-r-35b (the parallel block, LayerNorm,
tied embeddings) and internlm2-20b held to the JAX reference's on the
CPU, in both loops (host loop and mega-step), at their smoke configs
(2 layers, d 128), float32.

Parameters come from the reference ``Model.init`` through
``params_from_jax``.  Exact: the reference's tokens per uid, KV page
ids and page tables after every step (``tests/torch_lockstep.py``),
stats and arena words, with ``allocs == frees``, on plain traffic and
through the reference replay harness's abandonment trace (cancels).
The models' own arithmetic is held in
``tests/test_torch_parallel_block.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget
from repro.models.model import build_model as jbuild
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.replay import SCENARIOS, generate_trace

from repro_torch.configs import get_arch
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine
from torch_lockstep import check_same, drained, drive, plain_trace

ARCHS = ("command-r-35b", "internlm2-20b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def models(arch):
    """(reference model, its params, port model, converted params)."""
    if arch not in _MODELS:
        cfg, tcfg = jget(arch).smoke(), get_arch(arch).smoke()
        jm = jbuild(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[arch] = (jm, jp, build_model(tcfg), P.params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


def _engines(arch, mega, **kw):
    jm, jp, tm, tp = models(arch)
    je = JEngine(jm, jp, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                 alloc_backend="jnp", mega_step=mega, **kw)
    te = ServingEngine(tm, tp, kv_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu",
                       mega_step=mega, **kw)
    return je, te


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, mega):
    """Prompts of 2-70 tokens, 8 new each, max_batch 3."""
    je, te = _engines(arch, mega, max_batch=3, max_seq=96)
    lens = (40, 9, 70, 2)
    (jt, _), (tt, _) = drive((je, te), plain_trace(te.cfg, lens))
    assert tt == jt and len(tt) == len(lens)
    check_same(je, te)
    drained(te)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
@pytest.mark.parametrize("arch", ARCHS)
def test_abandonment_matches_reference(arch, mega):
    """The reference replay harness's abandonment trace (seed 7):
    cancels of waiting and active requests free every page."""
    trace = generate_trace(SCENARIOS["abandon"], seed=7,
                           vocab_size=get_arch(arch).smoke().vocab_size,
                           max_seq=96)
    je, te = _engines(arch, mega, max_batch=3, max_seq=128)
    (jt, jcan), (tt, tcan) = drive((je, te), trace)
    assert tcan == jcan and tcan, "the trace cancelled nothing"
    assert tt == jt and tt
    check_same(je, te)
    drained(te)
