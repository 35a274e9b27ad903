"""The port's scheduled sampling against the JAX package's: the
ground-truth count (float32, round-half-to-even) over the decay curve,
the exact-count random-rank mix, and the gradient block of
`detach_sampled`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import sampling as jsampling
from pivp_tpu_torch.ops import sampling


@pytest.mark.parametrize("batch", [2, 8, 32])
def test_num_ground_truth_matches_jax(batch):
    iters = np.arange(0, 20001, 37)
    want = np.asarray(jax.jit(jax.vmap(
        lambda i: jsampling.num_ground_truth(batch, 900.0, i)))(
            jnp.asarray(iters, jnp.float32)))
    got = np.array([sampling.num_ground_truth(batch, 900.0, int(i))
                    for i in iters])
    np.testing.assert_array_equal(got, want)
    assert got[0] == batch and got[-1] == 0


@pytest.mark.parametrize("batch", [1, 5, 8])
def test_exact_count_of_ground_truth_rows(batch):
    gt = torch.ones(batch, 3, 2)
    gen = torch.zeros(batch, 3, 2)
    g = torch.Generator().manual_seed(batch)
    for n_gt in range(batch + 1):
        u = torch.rand(batch, generator=g)
        mixed = sampling.scheduled_sample(u, gt, gen, n_gt)
        rows = mixed.flatten(1)
        assert bool(((rows == 0).all(1) | (rows == 1).all(1)).all())
        assert int(rows[:, 0].sum()) == n_gt
        # The ground-truth rows are those whose uniform ranks lowest.
        chosen = set(torch.argsort(u)[:n_gt].tolist())
        assert chosen == set(torch.nonzero(rows[:, 0]).flatten().tolist())


def test_extreme_counts_give_one_side_exactly():
    r = np.random.RandomState(0)
    gt = torch.tensor(r.randn(4, 5, 5, 3))
    gen = torch.tensor(r.randn(4, 5, 5, 3))
    u = torch.tensor(r.rand(4))
    assert torch.equal(sampling.scheduled_sample(u, gt, gen, 0), gen)
    assert torch.equal(sampling.scheduled_sample(u, gt, gen, 4), gt)


@pytest.mark.parametrize("detach", [False, True])
def test_detach_sampled_blocks_the_gradient(detach):
    gen = torch.ones(4, 3, requires_grad=True)
    gt = torch.zeros(4, 3)
    u = torch.tensor([0.1, 0.9, 0.5, 0.3])
    mixed = sampling.scheduled_sample(u, gt, gen * 2.0, 2,
                                      detach_sampled=detach)
    assert mixed.requires_grad is not detach
    if not detach:
        mixed.sum().backward()
        # Rows 1 and 2 (the two largest uniforms) are generated.
        np.testing.assert_array_equal(gen.grad[:, 0].numpy(),
                                      [0.0, 2.0, 2.0, 0.0])


def test_fold_in_gives_distinct_reproducible_streams():
    seeds = {sampling.fold_in(1, i) for i in range(1000)}
    assert len(seeds) == 1000
    a = torch.rand(5, generator=sampling.generator(1, 7))
    b = torch.rand(5, generator=sampling.generator(1, 7))
    c = torch.rand(5, generator=sampling.generator(1, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
