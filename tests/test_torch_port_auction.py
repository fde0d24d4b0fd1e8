"""Port parity: the device matcher's auction (``detection/matcher.py:
auction_assign``'s plain version, which the CPU runs) against the JAX
``auction_assign`` (jitted, vmapped over the leading axes), on the CPU.

The int32 assignments must be equal, not close: random costs at (6, 32,
12) and (2, 3, 16, 8); integer costs full of ties (the first index wins
in ``i1``, ``winner`` and ``item_of_gt``, and a tie makes v2 = v1); all
positive costs with padded gts, whose zero benefit rows set the spread
and so ε; more valid gts than queries (the loop stops at Q assigned, not
at ``max_iters``); no valid gt (no iteration, every owner -1); non-prefix
masks; a mask shared by every layer.  The ε-CS bound against the port's
exact ``linear_sum_assignment`` and the wrapper's refusals
(``tests/test_torch_port_cuda.py`` holds the kernel itself against the
plain version on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection.matcher import auction_assign as jax_auction
from vit_torch_tpu_torch.detection import matcher
from vit_torch_tpu_torch.detection.matcher import (auction_assign,
                                                   auction_assign_reference,
                                                   linear_sum_assignment)
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

_jax = jax.jit(jax_auction)


def _masks(rng, lead, N, p=0.6):
    m = (rng.random(lead + (N,)) < p).astype(np.float32)
    m[..., 0] = 0.0            # never a prefix: slot 0 padded
    m[..., -1] = 1.0           # and at least one valid gt
    return m


def _case(kind, shape, seed):
    rng = np.random.default_rng(seed)
    lead, N = shape[:-2], shape[-1]
    if kind == "random":
        return rng.standard_normal(shape).astype(np.float32), _masks(
            rng, lead, N)
    if kind == "ties":
        return rng.integers(0, 3, shape).astype(np.float32), _masks(
            rng, lead, N)
    if kind == "positive":
        # every benefit of a valid gt is negative, so the padded rows'
        # zeros are the maximum of the spread
        return rng.uniform(1.0, 2.0, shape).astype(np.float32), _masks(
            rng, lead, N, p=0.4)
    if kind == "more_gts":
        return rng.uniform(0.0, 1.0, shape).astype(np.float32), np.ones(
            lead + (N,), np.float32)
    if kind == "none_valid":
        return rng.standard_normal(shape).astype(np.float32), np.zeros(
            lead + (N,), np.float32)
    raise ValueError(kind)


CASES = [("random", (6, 32, 12)), ("random", (2, 3, 16, 8)),
         ("ties", (6, 32, 12)), ("ties", (2, 3, 16, 8)),
         ("positive", (6, 32, 12)), ("positive", (4, 20, 16)),
         ("more_gts", (3, 4, 10)), ("none_valid", (2, 8, 6))]


@pytest.mark.parametrize("kind,shape", CASES)
def test_auction_equals_jax(kind, shape):
    cost, mask = _case(kind, shape, seed=len(kind) + sum(shape))
    want = np.asarray(_jax(jnp.asarray(cost), jnp.asarray(mask)))
    got, iters = auction_assign(torch.from_numpy(cost),
                                torch.from_numpy(mask), return_iters=True)
    assert got.dtype == torch.int32 and got.shape == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)
    Q = shape[-2]
    valid = mask > 0
    target = np.minimum(valid.sum(-1), Q)
    owner = got.numpy()
    for idx in np.ndindex(*shape[:-2]):
        o = owner[idx]
        taken = o[o >= 0]
        # a permutation on the valid gts: each at most once, only valid
        assert len(taken) == len(set(taken.tolist())) == target[idx]
        assert valid[idx][taken].all()
    if kind == "more_gts":
        # stops at Q assigned, far below max_iters
        assert (target == Q).all() and int(iters.max()) < 256
    if kind == "none_valid":
        assert (owner == -1).all() and (iters.numpy() == 0).all()


def test_ties_exercise_the_first_index_rules():
    """The integer costs are tie-heavy: many rows hold their best value
    more than once, so ``i1``'s first-index rule and v2 = v1 decide."""
    cost, mask = _case("ties", (6, 32, 12), seed=0)
    best = cost.min(axis=-2, keepdims=True)
    assert ((cost == best).sum(-2) > 1).mean() > 0.5


def test_padding_sets_epsilon():
    """All-positive costs: the padded gts' zero benefit rows are the
    maximum of the spread, so they set ε (the JAX ``benefit = where(valid,
    -cost.T, 0)`` over all N slots), and the port matches JAX there."""
    cost, mask = _case("positive", (4, 20, 16), seed=40)
    for c, m in zip(cost, mask):
        full = np.where(m[:, None] > 0, -c.T, 0.0)
        valid_only = -c[:, m > 0].T
        assert full.max() == 0.0 > valid_only.max()
        assert (full.max() - full.min()) != (valid_only.max()
                                              - valid_only.min())
    want = np.asarray(_jax(jnp.asarray(cost), jnp.asarray(mask)))
    got = auction_assign(torch.from_numpy(cost), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_shared_by_layers():
    """A (B, N) mask serves every layer of an (L, B, Q, N) cost, as the
    trainer passes it."""
    rng = np.random.default_rng(3)
    cost = rng.standard_normal((3, 2, 16, 8)).astype(np.float32)
    mask = _masks(rng, (2,), 8)
    full = np.broadcast_to(mask, (3, 2, 8)).copy()
    want = np.asarray(_jax(jnp.asarray(cost), jnp.asarray(full)))
    got = auction_assign(torch.from_numpy(cost), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_epsilon_complementary_slackness_bound(seed):
    """The auction's total cost is within n_valid · ε of the exact
    optimum (ε-CS), ε = spread / 500 over the padded benefit."""
    rng = np.random.default_rng(100 + seed)
    cost = rng.uniform(0, 5, (8, 24, 12)).astype(np.float32)
    mask = _masks(rng, (8,), 12)
    owner = auction_assign(torch.from_numpy(cost),
                           torch.from_numpy(mask)).numpy()
    for b in range(8):
        valid = np.flatnonzero(mask[b] > 0)
        rows, cols = linear_sum_assignment(cost[b][:, valid])
        best = cost[b][rows, valid[cols]].sum()
        q = np.flatnonzero(owner[b] >= 0)
        total = cost[b][q, owner[b][q]].sum()
        benefit = np.where(mask[b][:, None] > 0, -cost[b].T, 0.0)
        eps = max(benefit.max() - benefit.min(), 1e-6) / 500
        assert best - 1e-4 <= total <= best + len(valid) * eps + 1e-4


def test_wrapper_refusals():
    """Shapes that do not fit raise; so does a problem beyond a block's
    shared memory (no fallback), and tensors off the CPU that are not on
    one CUDA device."""
    cost = torch.zeros(2, 3, 4, 5)
    with pytest.raises(ValueError, match="does not fit"):
        auction_assign(cost, torch.ones(2, 5))
    with pytest.raises(ValueError, match="does not fit"):
        auction_assign(cost, torch.ones(3, 4))
    with pytest.raises(ValueError, match="shared memory"):
        matcher.auction_assign(torch.zeros(1, 400, 200, device="meta"),
                               torch.ones(1, 200, device="meta"))
    with pytest.raises(ValueError, match="one CUDA"):
        auction_assign(torch.zeros(1, 4, 5, device="meta"), torch.ones(1, 5))
    assert matcher.auction_smem_bytes(100, 64) == 4 * (6400 + 200 + 256)


def test_plain_version_counts_no_launch():
    before = auction_assign.launches
    cost, mask = _case("random", (6, 32, 12), seed=1)
    auction_assign_reference(torch.from_numpy(cost), torch.from_numpy(mask))
    auction_assign(torch.from_numpy(cost), torch.from_numpy(mask))
    assert auction_assign.launches == before
