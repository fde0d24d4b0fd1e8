"""The launch plans of the Swin window kernels, on the CPU: the window
GEMM's (``ops/gemm.py:gemm_plan``) at every Swin width of the port's zoo,
its per-image row table (``window_rows``) against the window order of the
block's autograd Function (``window_block._window_order``), the
attention core's (``ops/window_attention.py:core_plan``) and its
backward's (``bwd_plan``: the same runs, the dbias partials and the
shared memory).  Each plan is walked the way its kernel walks it
(``csrc/window_gemm.cu``, ``csrc/window_attention_fwd.cu``,
``csrc/window_attention_bwd.cu``), so the tests show that every output
element and every (window, head) pair is computed exactly once."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS
from vit_torch_tpu_torch.ops import gemm as gm
from vit_torch_tpu_torch.ops import window_attention as wa
from vit_torch_tpu_torch.ops import window_block as wb
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SMEM_MAX = 232448
SWIN_BLOCKS = [(32, 96, 96, 128, 12, 6), (32, 96, 96, 128, 12, 0),
               (32, 48, 48, 256, 12, 6), (32, 48, 48, 256, 12, 0),
               (32, 24, 24, 512, 12, 6), (32, 24, 24, 512, 12, 0),
               (32, 12, 12, 1024, 12, 0), (32, 56, 56, 96, 7, 3),
               (2, 10, 15, 64, 5, 2)]


def _zoo_products():
    """(T, K, N) of the four products of every stage of every Swin config
    with head dim 32, at bs32 and bs1, and the ragged block case."""
    shapes = set()
    for cfg in SWIN_CONFIGS.values():
        if cfg.embed_dim // cfg.num_heads[0] != 32:
            continue
        side = (384 if cfg.window_size == 12 else 224) // cfg.patch_size
        for i in range(len(cfg.depths)):
            C, hw = cfg.embed_dim * 2 ** i, (side >> i) ** 2
            for bs in (32, 1):
                for K, N in ((C, 3 * C), (C, C), (C, 4 * C), (4 * C, C)):
                    shapes.add((bs * hw, K, N))
    shapes.update((300, K, N) for K, N in ((64, 192), (64, 64), (64, 256),
                                           (256, 64)))
    return sorted(shapes)


ZOO_PRODUCTS = _zoo_products()


def _cover(extent, tile, tiles):
    """How often each of ``extent`` indices falls in ``tiles`` tiles of
    ``tile``, cut at the edge."""
    count = np.zeros(extent, dtype=np.int64)
    for t in range(tiles):
        count[t * tile:min((t + 1) * tile, extent)] += 1
    return count


@pytest.mark.parametrize("sms", [132, 8])
def test_gemm_plan_covers_every_output_once(sms):
    """Rows and columns are each covered by exactly one tile; the
    persistent blocks (tile = block + i * grid) visit every tile once; the
    tile width is one of the kernel's instances and the ring fits."""
    for T, K, N in ZOO_PRODUCTS:
        plan = gm.gemm_plan(T, K, N, sms)
        assert plan.block_n in gm.BLOCK_NS
        assert (_cover(N, plan.block_n, plan.tiles_n) == 1).all()
        assert plan.tiles_m == -(-T // gm.BLOCK_M)
        tiles = plan.tiles_m * plan.tiles_n
        assert 1 <= plan.grid == min(tiles, sms)
        visits = np.bincount(np.concatenate(
            [np.arange(b, tiles, plan.grid) for b in range(plan.grid)]),
            minlength=tiles)
        assert (visits == 1).all()
        assert 2 <= plan.stages <= 8 and plan.smem_bytes <= SMEM_MAX
        assert plan.smem_bytes + (gm.BLOCK_M + plan.block_n) * 128 > \
            SMEM_MAX or plan.stages == 8


@pytest.mark.parametrize("T,K,N,block_n", [
    (294912, 128, 384, 192), (294912, 128, 128, 128),
    (294912, 128, 512, 128), (4608, 1024, 3072, 128),
    (18432, 512, 2048, 192), (100352, 96, 96, 128), (300, 64, 64, 128)])
def test_gemm_plan_picks_the_least_loaded_width(T, K, N, block_n):
    """The width whose busiest SM computes the fewest columns: 192 for the
    stage-1 qkv (two 192-column tiles against three of 128), 128 where N
    is one narrow tile or 192 would pad it (512) or leave a longer last
    wave (stage 4's qkv), the wider on a tie (stage 3's fc1)."""
    assert gm.gemm_plan(T, K, N).block_n == block_n


@pytest.mark.parametrize("T,K,N", [(128, 48, 128), (128, 16, 128),
                                   (128, 64, 4), (128, 64, 100),
                                   (0, 64, 64)])
def test_gemm_plan_refuses_what_the_kernel_does_not_take(T, K, N):
    with pytest.raises(ValueError, match="window_gemm takes"):
        gm.gemm_plan(T, K, N)


def _window_order(H, W, w, shift):
    return wb._window_order(H, W, w, shift, torch.device("cpu"))[0]


@pytest.mark.parametrize("case", SWIN_BLOCKS, ids=str)
def test_window_rows_match_the_window_order(case):
    _, H, W, _, w, shift = case
    rows = gm.window_rows(H, W, w, shift, torch.device("cpu"))
    assert rows.dtype == torch.int32 and rows.shape == (H * W,)
    assert torch.equal(rows.long(), _window_order(H, W, w, shift))


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 12).flatmap(lambda w: st.tuples(
    st.integers(1, 4), st.integers(1, 4), st.just(w),
    st.integers(0, w - 1))))
def test_window_rows_match_the_window_order_drawn(geometry):
    nh, nw, w, shift = geometry
    H, W = nh * w, nw * w
    rows = gm.window_rows(H, W, w, shift, torch.device("cpu"))
    assert torch.equal(rows.long(), _window_order(H, W, w, shift))


@pytest.mark.parametrize("H,W,w,shift", [(10, 12, 5, 0), (12, 12, 12, 12),
                                         (12, 12, 0, 0)])
def test_window_rows_refuse_a_map_the_window_does_not_tile(H, W, w, shift):
    with pytest.raises(ValueError, match="not tiled by window"):
        gm.window_rows(H, W, w, shift, torch.device("cpu"))


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("nW", [1, 4, 16, 64])
@pytest.mark.parametrize("N", [25, 49, 144])
def test_core_plan_takes_every_window_head_once(N, nW, sms):
    """Block x takes head h and mask row j of its group (x mod groups) and
    a run (x div groups) of the group's windows j + nW b: every (window,
    head) pair once, and every window of a block on the block's mask
    row."""
    for H, images in ((4, 32), (32, 1), (3, 2)):
        Bn = images * nW
        plan = wa.core_plan(Bn, N, H, nW, sms)
        assert plan.keys == next(k for k in wa.CORE_KEYS if N <= k)
        assert plan.query_rows % 64 == 0 and plan.query_rows >= plan.keys
        assert plan.groups == H * nW and plan.windows == images
        assert plan.blocks == plan.groups * plan.chunks
        assert 2 <= plan.stages <= 6 and plan.smem_bytes <= SMEM_MAX
        seen = np.zeros((Bn, H), dtype=np.int64)
        for x in range(plan.blocks):
            c, g = divmod(x, plan.groups)
            j, h = divmod(g, H)
            b = np.arange(c * plan.per_block,
                          min(plan.windows, (c + 1) * plan.per_block))
            assert b.size >= 1
            windows = j + nW * b
            assert (windows % nW == j).all()
            seen[windows, h] += 1
        assert (seen == 1).all()
        if plan.groups < sms:   # runs only as far as they fill the card
            assert plan.blocks <= max(sms, plan.groups)


@pytest.mark.parametrize("Bn,N,H,nW", [(4, 145, 2, 1), (4, 0, 2, 1),
                                       (6, 49, 2, 4), (4, 49, 0, 1)])
def test_core_plan_refuses_what_the_kernel_does_not_take(Bn, N, H, nW):
    with pytest.raises(ValueError, match="no window attention plan"):
        wa.core_plan(Bn, N, H, nW)


def _bwd_cases():
    """(Bn, N, H, nW) of the backward at every chip_smoke block case."""
    cases = []
    for B, H, W, C, w, shift in SWIN_BLOCKS:
        nW = (H // w) * (W // w)
        cases.append((B * nW, w * w, C // 32, nW if shift else 1))
    return cases


@pytest.mark.parametrize("case", _bwd_cases(), ids=str)
def test_bwd_plan_takes_every_window_head_once(case):
    """The backward walks the forward's runs (block x: group x mod groups,
    run x div groups): every (window, head) pair once; each block writes
    its dbias partial (or one a warpgroup) and every (part, head) the
    reduction sums is written exactly once, so no partial is left
    unwritten."""
    Bn, N, H, nW = case
    plan = wa.bwd_plan(Bn, N, H, nW)
    core = wa.core_plan(Bn, N, H, nW)
    assert plan[:7] == tuple(core)[:7]
    assert plan.split == (plan.keys == 144)
    assert plan.stages == 1 if plan.split else 2 <= plan.stages <= 4
    wparts = 1 if plan.split else 2
    assert plan.parts == plan.chunks * nW * wparts
    seen = np.zeros((Bn, H), dtype=np.int64)
    written = np.zeros((plan.parts, H), dtype=np.int64)
    for x in range(plan.blocks):
        c, g = divmod(x, plan.groups)
        j, h = divmod(g, H)
        b = np.arange(c * plan.per_block,
                      min(plan.windows, (c + 1) * plan.per_block))
        seen[j + nW * b, h] += 1
        for wg in range(wparts):
            written[(c * nW + j) * wparts + wg, h] += 1
    assert (seen == 1).all() and (written == 1).all()


@pytest.mark.parametrize("N,keys,smem", [
    (144, 144, 231552), (49, 64, 113568), (25, 32, 70688), (16, 16, 51840),
    (1, 16, 50400)])
def test_bwd_plan_shared_memory(N, keys, smem):
    """The kernel's layout: 1 KB of alignment, the P and dS tiles (92,160
    bytes at N = 144; 4 x 8 KB below), then at N = 144 the dbias sums of
    the 9 warps with live rows (72 fp32 a thread) and below it the fp32
    table (rows of the keys' width padded to an odd multiple of 8
    floats), the barriers, the ring (at N = 144, K, V and two Q/dO slots);
    within the 227 KB a block may use.
    At N = 144 each block keeps its threads' table values in a global
    scratch of the same 82,944 bytes a block."""
    plan = wa.bwd_plan(8 * 4, N, 3, 4)
    assert plan.keys == keys and plan.smem_bytes == smem
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.table_bytes == (plan.blocks * 82944 if plan.split else 0)
    if not plan.split:   # as many stages as fit, up to 4
        stage = 4 * keys * 32 * 2
        assert plan.stages == 4 or plan.smem_bytes + stage > SMEM_MAX


@pytest.mark.parametrize("Bn,N,H,nW", [(4, 145, 2, 1), (4, 0, 2, 1),
                                       (6, 49, 2, 4), (4, 49, 0, 1)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(Bn, N, H, nW):
    with pytest.raises(ValueError, match="no window attention plan"):
        wa.bwd_plan(Bn, N, H, nW)
