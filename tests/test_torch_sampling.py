"""temp_tpu_torch's edge samplers: invariants and distributions.

A torch.Generator cannot replay JAX's threefry bits, so the samplers are
held to what they promise rather than to the JAX package's bits: the exact
kept count, kept slots only among the masked ones, and each masked slot
kept with the same frequency over seeds. The JAX package's samplers are
held to the same counts on the same masks.
"""

import jax
import numpy as np
import pytest
import torch

from temp_tpu.ops.sampling import subsample_edges as jax_subsample_edges
from temp_tpu.ops.sampling import subsample_positives as jax_subsample_pos
from temp_tpu_torch.ops.sampling import subsample_edges, subsample_positives

from test_torch_slice import one_thread  # noqa: F401

# one intra-op thread for each test (``one_thread``): with the tier-1
# run's workers on the same cores, torch's thread pools make each small op
# wait on the others' threads
pytestmark = pytest.mark.usefixtures("one_thread")


def _masks(seed=0):
    rs = np.random.RandomState(seed)
    m = rs.rand(4, 64) < np.array([[0.0], [0.3], [0.8], [1.0]])
    m[1, :3] = True  # at least a few masked slots in the sparse row
    return torch.from_numpy(m)


@pytest.mark.parametrize("rate", [0.5, 0.8, 0.25])
def test_subsample_edges_keeps_exact_count_of_masked_slots(rate):
    emask = _masks()
    for seed in range(5):
        kept = subsample_edges(torch.Generator().manual_seed(seed), emask,
                               rate)
        assert kept.dtype == torch.bool and kept.shape == emask.shape
        assert not (kept & ~emask).any()
        want = (rate * emask.sum(-1).float()).long()
        assert torch.equal(kept.sum(-1), want)
        for row in range(emask.shape[0]):  # the JAX sampler keeps as many
            ref = jax_subsample_edges(jax.random.PRNGKey(seed),
                                      emask[row].numpy(), rate)
            assert int(np.asarray(ref).sum()) == int(want[row])


@pytest.mark.parametrize("max_facts", [0, 5, 40, 1000])
def test_subsample_positives_keeps_at_most_max_facts(max_facts):
    emask = _masks(1)
    kept = subsample_positives(torch.Generator().manual_seed(3), emask,
                               max_facts)
    assert not (kept & ~emask).any()
    want = emask.sum(-1).clamp(max=max_facts)
    assert torch.equal(kept.sum(-1), want)
    for row in range(emask.shape[0]):
        ref = jax_subsample_pos(jax.random.PRNGKey(3), emask[row].numpy(),
                                max_facts)
        assert int(np.asarray(ref).sum()) == int(want[row])


@pytest.mark.parametrize("fn,arg", [(subsample_edges, 0.5),
                                    (subsample_positives, 10)])
def test_samplers_are_uniform_over_draws(fn, arg):
    """Each of the 20 masked slots is kept in about the same share of 2000
    independent draws (one generator, one row a draw): keep share
    p = 10/20, so the count of a slot has standard deviation
    sqrt(2000 p (1-p)) = 22.4; 5 sigma is 112 around 1000."""
    emask = torch.zeros(2000, 32, dtype=torch.bool)
    emask[:, ::3][:, :10] = True
    emask[:, 1::3][:, :10] = True
    counts = fn(torch.Generator().manual_seed(0), emask, arg).sum(0)
    assert int(counts[~emask[0]].sum()) == 0
    hits = counts[emask[0]].double()
    assert hits.numel() == 20
    assert float((hits - 1000.0).abs().max()) <= 112.0
    assert float(hits.sum()) == 2000 * 10


def test_samplers_follow_the_generator():
    emask = _masks(2)
    a = subsample_edges(torch.Generator().manual_seed(9), emask, 0.5)
    b = subsample_edges(torch.Generator().manual_seed(9), emask, 0.5)
    c = subsample_edges(torch.Generator().manual_seed(10), emask, 0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
