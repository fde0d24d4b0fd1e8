"""The launch plan of the CaiT talking-heads kernels
(``ops/talking_heads.py:talking_heads_plan``), on the CPU: at every
chip_smoke shape and at the card tests' shapes, the blocks of the three
launches cover every query row, key and head once, the shared memory fits
(two blocks an SM up to 8 heads), the scratch between the launches has the
size the kernels address, and what the kernels do not take is refused."""

import pytest

from vit_torch_tpu_torch.ops import talking_heads as th
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SMEM_MAX, SMEM_HALF = 232448, 115712
# chip_smoke's TH_SHAPES (cait_s24_224 bs32, xxs24, s24_384, m36_384,
# m48_448, ragged) and the card tests' small shapes (head dims 16, 32, 64;
# H = 1, 2, 6; a single token)
SHAPES = [(32, 8, 196, 48), (32, 4, 196, 48), (8, 8, 576, 48),
          (8, 16, 576, 48), (4, 16, 784, 48), (2, 4, 37, 48),
          (2, 8, 196, 48), (1, 16, 100, 64), (3, 2, 17, 16),
          (1, 6, 50, 32), (2, 1, 1, 48), (2, 8, 70, 16), (2, 8, 70, 32),
          (2, 8, 70, 64), (2, 1, 50, 48)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_every_row_key_and_head_once(shape):
    """Launches 1 and 2: block (row tile, part y, image) takes 16-key tiles
    [y t, y t + t), t = ceil(tiles / parts); the parts cover every tile
    once and none is empty.  Launch 3: a block a (row tile, head, image).
    The heads are padded to the kernels' instance (4, 8 or 16)."""
    B, H, N, D = shape
    plan = th.talking_heads_plan(B, H, N, D)
    assert plan.padded_heads == next(m for m in (4, 8, 16) if H <= m)
    rows, tiles = -(-N // 64), -(-N // 16)
    assert plan.grid == (rows, plan.parts, B)
    assert plan.pv_grid == (rows, H, B)
    per = -(-tiles // plan.parts)
    owned = [0] * tiles
    for part in range(plan.parts):
        run = range(part * per, min(tiles, (part + 1) * per))
        assert len(run) >= 1
        for kt in run:
            owned[kt] += 1
    assert owned == [1] * tiles


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_keeps_the_shared_memory_budget(shape):
    """A block of launches 1 and 2 holds its rows' Q of every padded head,
    the tables, the softmax statistics, the barriers and 2 to 8 ring slots
    of 16 keys, as many as fit: within half an SM's shared memory (two
    blocks an SM) up to 8 heads, within a block's 227 KB at 16; launch 3
    holds four 64-key value tiles."""
    B, H, N, D = shape
    plan = th.talking_heads_plan(B, H, N, D)
    mh = plan.padded_heads
    row_bytes = 128 if D > 32 else 64
    limit = SMEM_HALF if mh <= 8 else SMEM_MAX
    assert plan.blocks_per_sm == (2 if mh <= 8 else 1)
    assert 2 <= plan.slots <= 8 and plan.smem_bytes <= limit
    slot = mh * 16 * row_bytes
    assert plan.slots == 8 or plan.smem_bytes + slot > limit
    assert plan.pv_smem_bytes == 1024 + 4 * 64 * row_bytes + 64


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_sizes_the_scratch(shape):
    """The statistics: (m, l) in fp32 for every (image, part, padded head,
    row of the padded row tiles); the mixed weights: one bf16 for every
    (image, head, padded row, key of the padded 16-key tiles)."""
    B, H, N, D = shape
    plan = th.talking_heads_plan(B, H, N, D)
    rows, keys = -(-N // 64) * 64, -(-N // 16) * 16
    assert plan.stats_bytes == B * plan.parts * plan.padded_heads * rows * 8
    assert plan.mix_bytes == B * H * rows * keys * 2


def test_plan_of_the_headline_and_largest_shapes():
    """cait_s24_224 bs32: 4 row tiles x 2 key parts x 32 images, two blocks
    an SM with two 16-key slots each; m48_448 bs4 (16 heads): 13 row tiles
    x 5 parts x 4 images, one block an SM, two slots beside its 128 KB of
    Q; the parts adapt to the card's SMs."""
    assert th.talking_heads_plan(32, 8, 196, 48) == th.Plan(
        8, 2, 2, (4, 2, 32), 2, 104136, (4, 8, 32), 33856, 1048576,
        27262976)
    assert th.talking_heads_plan(4, 16, 784, 48) == th.Plan(
        16, 1, 5, (13, 5, 4), 2, 208136, (13, 16, 4), 33856, 2129920,
        83492864)
    assert th.talking_heads_plan(32, 8, 196, 48, sms=66).parts == 1


@pytest.mark.parametrize("shape", [(2, 4, 16, 40), (2, 17, 16, 48),
                                   (2, 0, 16, 48), (2, 4, 0, 48),
                                   (65536, 4, 16, 48), (0, 4, 16, 48)])
def test_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError, match="no talking-heads plan"):
        th.talking_heads_plan(*shape)
