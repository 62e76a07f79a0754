"""The serving engine of internlm2-20b held to the JAX reference's on
the CPU, in both loops (host loop and mega-step), at its smoke config,
float32, as ``tests/test_torch_parallel_block_engine.py`` holds
command-r-35b's (one file an arch, so the two run on two workers).

Parameters come from the reference ``Model.init`` through
``params_from_jax``.  Exact: the reference's tokens per uid, KV page
ids and page tables after every step (``tests/torch_lockstep.py``),
stats and arena words, with ``allocs == frees``, on plain traffic and
through the reference replay harness's abandonment trace (cancels).
The models' own arithmetic is held in
``tests/test_torch_parallel_block.py``.
"""
import pytest
import torch

from torch_lockstep import abandonment_matches, plain_matches

ARCHS = ("internlm2-20b",)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, mega):
    """Prompts of 2-70 tokens, 8 new each, max_batch 3."""
    plain_matches(arch, mega)


@pytest.mark.parametrize("mega", (False, True), ids=("host", "mega"))
@pytest.mark.parametrize("arch", ARCHS)
def test_abandonment_matches_reference(arch, mega):
    """The reference replay harness's abandonment trace (seed 7):
    cancels of waiting and active requests free every page."""
    abandonment_matches(arch, mega)
