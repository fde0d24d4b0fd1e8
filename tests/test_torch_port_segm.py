"""Port parity: DETR instance masks (DETRSegm), their losses, the mask
RLE library, the segm evaluation and the ``--masks`` CLI against the JAX
package, on the CPU.

``_mask`` (encode, decode, area, merge, polygons, bbox and RLE IoU with
crowd gts and empty sides, the RLEs of un-letterboxed masks at the
geometries of ``tests/test_segmentation.py``) exactly, against the JAX
functions with their native library and with their numpy loops; the
nearest resize; the focal and dice losses and ``mask_losses`` in fp32;
the bit packing and the post-process; ``MHAttentionMap`` and
``MaskHeadSmallConv`` at a size
whose stage maps are exact halves and at one whose are not (a wrong
nearest mode shows there); the whole DETRSegm (``swin_test3``, hidden
32, 6 queries, 4 mask heads) with seeded numpy weights carried by
``state_dict_from_jax``, its forward in fp32 and the gradients of the
DETR and mask losses in float64; a three-step ``masks=True`` trajectory
with the JAX key sequence's flips fed in; the ``load_masks`` batches and
the mask transforms; ``COCOeval`` segm, the eval helpers and
``evaluate`` with PQ and without; the CLI.  Each JAX function is traced
once in the file.
"""

import contextlib
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection import _mask as jax_mask
from vit_torch_tpu.detection import coco_data as jax_data
from vit_torch_tpu.detection import coco_eval as jax_eval
from vit_torch_tpu.detection import detr as jax_detr
from vit_torch_tpu.detection import engine as jax_engine
from vit_torch_tpu.detection import segmentation as jax_seg
from vit_torch_tpu.detection import transforms as jax_tf
from vit_torch_tpu.models.swin import SWIN_CONFIGS as JAX_SWIN_CONFIGS
from vit_torch_tpu.models.swin import SwinTransformer as JaxSwin
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.detection import _mask, coco_data, coco_eval
from vit_torch_tpu_torch.detection import detr, engine, segmentation
from vit_torch_tpu_torch.detection import transforms
from vit_torch_tpu_torch.models.layers import QLinear
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SIZE, K, Q, HEADS = 64, 3, 6, 4
CFG = dict(num_classes=K, num_queries=Q, hidden_dim=32, num_heads=4,
           enc_layers=1, dec_layers=2, ffn_dim=64)
# fp32 losses of values of order 1: summation order only
LOSS_RTOL = 1e-6
# the mask modules in fp32: a few convs and GroupNorms of values of order
# 1, summation order; relative to max |JAX output|
MODULE_RTOL = 1e-5
# the whole model's fp32 forward (as tests/test_torch_port_detr.py)
FWD_ATOL = 2e-5
# the gradients of the float64 models: both packages' losses cast the
# predictions to fp32 (as the JAX functions do), so the loss arithmetic
# and its gradient carry fp32 rounding in another summation order;
# relative to each parameter's largest |grad|, floored at a hundredth of
# the model's largest where a gradient is zero in exact arithmetic and
# reads as that rounding (the key biases; the first decoder layer's
# self-attention, whose values are zero)
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-2
# zoom-crop masks: a resampled value within rounding of the 0.5 threshold
# may land on either side
CROP_MASK_SHARE = 1e-3


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_mask_variants():
    """The JAX ``_mask`` with its native library (where built) and with
    its numpy fallbacks, the per-pixel and per-run loops the port
    vectorises."""
    return [contextlib.nullcontext(),
            mock.patch.object(jax_mask, "_load_lib", lambda: None)]


def _o0(jitted):
    """A ``jax.jit`` function compiled at LLVM's -O0 on its first call
    (its later calls must take the same shapes): a fraction of the
    default's compile time for these one- and three-call programs; fp
    arithmetic is not reordered at any level."""
    compiled = {}

    def call(*args):
        if not compiled:
            compiled["fn"] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled["fn"](*args)
    return call


def _jit(fn):
    return _o0(jax.jit(fn))


def _seed_tree(shapes, seed):
    """Numpy leaves for a flax tree of shapes: kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.1), the queries N(0, 1), the rest N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "query_embed" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        if "kernel" in name and len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _jax_model(dtype=jnp.float32):
    cfg = jax_detr.DETRConfig(**CFG)
    backbone = JaxSwin(JAX_SWIN_CONFIGS["swin_test3"], dtype=dtype,
                       multi_features=True, name="backbone")
    return cfg, jax_seg.DETRSegm(cfg, backbone, num_mask_heads=HEADS,
                                 dtype=dtype)


def _seeded_params(jmodel, seed=0, size=SIZE):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), True))
    return _seed_tree(shapes["params"], seed)


def _port_model(params, size=SIZE, dtype=torch.float32):
    model = detr.build_detr(detr.DETRConfig(**CFG), "swin_test3", size,
                            dtype, masks=True, num_mask_heads=HEADS)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _blob_masks(n, S, seed=0, holes=False):
    """The JAX tests' masks: a few rectangles, with a hole."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, S, S), bool)
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            y0, x0 = rng.integers(0, S - 4, 2)
            hh, ww = rng.integers(3, S // 2, 2)
            masks[i, y0:y0 + hh, x0:x0 + ww] = True
        if holes:
            y0, x0 = rng.integers(S // 4, S // 2, 2)
            masks[i, y0:y0 + 5, x0:x0 + 5] = False
    return masks


# -- _mask ------------------------------------------------------------------

def test_rle_basics_match_jax():
    """encode, decode, area, merge and polygons: the same counts lists,
    pixels and areas, on empty, full, 1-first and random masks."""
    rng = np.random.default_rng(0)
    for trial in range(12):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        ms = rng.random((5, h, w)) < rng.random()
        ms[0], ms[1] = False, True
        ms[2, 0, 0] = True
        rles = [_mask.encode(m) for m in ms]
        for variant in _jax_mask_variants():
            with variant:
                assert [jax_mask.encode(m) for m in ms] == rles
                for r in rles:
                    np.testing.assert_array_equal(_mask.decode(r),
                                                  jax_mask.decode(r))
                    assert _mask.area(r) == jax_mask.area(r)
                assert _mask.merge(rles[2:]) == jax_mask.merge(rles[2:])
        assert _mask.merge(rles[:1]) == rles[0]
    polys = [[1, 1, 20, 2, 15, 18], [3.5, 4, 9, 4, 9, 11.2, 3.5, 11],
             [1, 1, 2, 2]]                    # two points: not drawn
    assert _mask.poly_to_rle(polys, 24, 30) == jax_mask.poly_to_rle(
        polys, 24, 30)


def test_mask_library_is_numpy_only():
    """The port's ``_mask`` loads no shared library (the JAX package's
    ``libmaskops.so`` is its own build)."""
    import inspect
    src = inspect.getsource(_mask)
    assert "ctypes" not in src and "CDLL" not in src


@pytest.mark.parametrize("case", ["rle", "bbox", "empty_dt", "empty_gt"])
def test_iou_matches_jax(case):
    """IoU with crowd gts (intersection over the dt's area), to 1e-15."""
    rng = np.random.default_rng(1)
    masks = _blob_masks(7, 40, seed=2, holes=True)
    masks[6] = False
    rles = [jax_mask.encode(m) for m in masks]
    crowd = [0, 1, 0, 1]
    if case == "rle":
        dt, gt = rles[:5], rles[3:]
    elif case == "bbox":
        dt, gt = rng.random((5, 4)) * 20, rng.random((4, 4)) * 20
        crowd = crowd[:4]
    else:
        dt, gt = rles[:3], rles[3:]
        if case == "empty_dt":
            dt = []
        else:
            gt, crowd = [], []
    got = _mask.iou(dt, gt, crowd)
    for variant in _jax_mask_variants():
        with variant:
            want = jax_mask.iou(dt, gt, crowd)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-15, rtol=0)
    if case == "rle":
        assert (got > 0).any() and (got[:, 1] != got[:, 0]).any()


@pytest.mark.parametrize("orig,scale,pad", [
    ((64, 64), 1.0, (0, 0)),           # identity
    ((128, 96), 0.5, (8, 0)),          # downscaled, x-padded
    ((50, 70), 0.9, (0, 9)),           # non-integer ratio
    ((200, 40), 0.3, (26, 2)),         # strong downscale, both pads
    ((30, 20), 2.0, (12, 2)),          # upscale (orig smaller than box)
    ((9, 9), 0.0, (0, 0)),             # degenerate: no content
])
def test_unletterboxed_rles_match_jax(orig, scale, pad):
    """The evaluation's masks at the original resolution
    (``_unletterbox_masks``, then ``encode``), a checkerboard too (a flip
    every pixel): the same pixels and the same RLEs as the JAX
    package's, with its native library and with its numpy loops."""
    S = 64
    masks = _blob_masks(5, S, seed=11, holes=True)
    masks[4] = np.indices((S, S)).sum(0) % 2 == 0
    args = (masks.astype(np.uint8), scale, np.asarray(pad),
            np.asarray(orig))
    want = jax_engine._unletterbox_masks(*args)
    got = engine._unletterbox_masks(*args)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, *orig)
    for i in range(len(masks)):
        rle = _mask.encode(got[i])
        for variant in _jax_mask_variants():
            with variant:
                assert rle == jax_mask.encode(want[i]), (i, orig)


# -- losses, packing, post-process -------------------------------------------

def _loss_case(seed=3):
    rng = np.random.default_rng(seed)
    B, N, h = 2, 4, 16
    pred = (2 * rng.standard_normal((B, Q, h, h))).astype(np.float32)
    gt = np.stack([_blob_masks(N, SIZE, seed=seed + b)
                   for b in range(B)]).astype(np.uint8)
    assign = np.full((B, Q), -1, np.int32)
    assign[0, [0, 2, 5]] = [3, 0, 1]
    assign[1, [1, 4]] = [2, 0]
    box_mask = np.ones((B, N), np.float32)
    return pred, gt, assign, box_mask


@pytest.mark.parametrize("sample_mask", [[1.0, 1.0], [1.0, 0.0]])
def test_mask_losses_match_jax(sample_mask):
    """``mask_losses`` (-1 assignments, a padded sample), and the dice
    and focal losses on their own, in fp32."""
    pred, gt, assign, box_mask = _loss_case()
    sm = np.asarray(sample_mask, np.float32)
    flat = pred.reshape(-1, 16, 16)
    targets = (np.random.default_rng(4).random(flat.shape) < 0.3)
    valid = (np.arange(len(flat)) % 3 != 0).astype(np.float32)

    def jax_side(pred, gt, assign, box_mask, sm, flat, targets, valid):
        return (jax_seg.mask_losses(pred, gt, assign, box_mask, sm),
                jax_seg.dice_loss(flat, targets, valid),
                jax_seg.sigmoid_focal_loss(flat, targets, valid))

    want, dice, focal = jax.tree.map(float, _jit(jax_side)(
        pred, gt, assign, box_mask, sm, flat, targets, valid))
    got = segmentation.mask_losses(_t(pred), _t(gt), _t(assign),
                                   _t(box_mask), _t(sm))
    for k in ("loss_mask", "loss_dice"):
        np.testing.assert_allclose(got[k].item(), want[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    for w, pf in ((dice, segmentation.dice_loss),
                  (focal, segmentation.sigmoid_focal_loss)):
        g = pf(_t(flat), _t(targets), _t(valid)).item()
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", [(2, 3, 8, 16), (2, 10, 10),
                                   (3, 64, 64)])
def test_pack_mask_bits_matches_jax(shape):
    """The bit packing (W a multiple of 8 and not) exactly, and
    ``np.unpackbits`` sliced to W gives the masks back."""
    m = np.random.default_rng(5).random(shape) < 0.4
    want = np.asarray(jax_seg.pack_mask_bits(jnp.asarray(m)))
    got = segmentation.pack_mask_bits(torch.from_numpy(m)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.unpackbits(got, axis=-1)[..., :shape[-1]], m)


@pytest.mark.parametrize("src,dst", [
    ((8, 8), (16, 16)),                # the mask head's doubling
    ((64, 64), (16, 16)),              # the gt masks' 4:1 (row 4i + 2)
    ((13, 13), (25, 25)),              # not a doubling
    ((25, 13), (13, 25)),              # down one axis, up the other
    ((7, 5), (7, 5)),                  # identity
])
def test_resize_nearest_matches_jax(src, dst):
    """``resize_nearest`` (``F.interpolate`` at a doubling) and
    ``gather_nearest`` (every size) against ``jax.image.resize(...,
    "nearest")`` (half-pixel centres) exactly, on fp32 maps and on uint8
    masks, where torch's ``nearest`` would differ; and their gradient is
    the sum over the positions that read each source pixel."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = rng.standard_normal((2, 3, *src)).astype(np.float32)
    m = (rng.random((2, 3, *src)) < 0.5).astype(np.uint8)
    paths = (segmentation.resize_nearest,
             lambda a, size: segmentation.gather_nearest(a, *size))
    for a in (x, m):
        want = np.asarray(jax.image.resize(jnp.asarray(a), (2, 3, *dst),
                                           "nearest"))
        for resize in paths:
            got = resize(torch.from_numpy(a), dst)
            assert got.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(got.numpy(), want)
    g = rng.standard_normal((2, 3, *dst)).astype(np.float32)
    want = jax.vjp(lambda v: jax.image.resize(v, (2, 3, *dst), "nearest"),
                   jnp.asarray(x))[1](jnp.asarray(g))[0]
    for resize in paths:
        xt = torch.from_numpy(x).requires_grad_()
        resize(xt, dst).backward(torch.from_numpy(g))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


def test_postprocess_segm_matches_jax():
    """Bilinear upsampling then ``sigmoid > 0.5``: the same pixels, but
    for those whose upsampled logit is within 1e-6 of 0."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, Q, 16, 16)).astype(np.float32)
    logits[0, 0, 3, 3] = 0.0
    want = np.asarray(jax_seg.postprocess_segm(jnp.asarray(logits), SIZE))
    up = np.asarray(jax.image.resize(jnp.asarray(logits),
                                     (2, Q, SIZE, SIZE), "bilinear"))
    got = segmentation.postprocess_segm(_t(logits), SIZE).numpy()
    assert got.shape == want.shape and got.dtype == bool
    differ = got != want
    assert (np.abs(up[differ]) < 1e-6).all()
    assert differ.sum() <= (np.abs(up) < 1e-6).sum()


# -- modules ----------------------------------------------------------------

@pytest.mark.parametrize("mem,laterals", [
    (4, (8, 16, 32)),                  # exact halves
    (5, (9, 17, 33)),                  # not: the nearest mode shows
])
def test_mask_modules_match_jax(mem, laterals):
    """``MHAttentionMap`` and ``MaskHeadSmallConv`` (three laterals, so
    ``lay5`` runs) with seeded weights."""
    from vit_torch_tpu.detection.segmentation import (
        MaskHeadSmallConv as JaxHead, MHAttentionMap as JaxMap)
    rng = np.random.default_rng(8)
    B, C = 2, 32
    q = rng.standard_normal((B, Q, C)).astype(np.float32)
    mem_map = rng.standard_normal((B, mem, mem, C)).astype(np.float32)
    jmap = JaxMap(C, HEADS)
    p_map = _seed_tree(jax.eval_shape(lambda: jmap.init(
        jax.random.PRNGKey(0), q, mem_map))["params"], 9)
    stack = rng.standard_normal((B * Q, mem, mem, C + HEADS)).astype(
        np.float32)
    feats = [rng.standard_normal((B, s, s, c)).astype(np.float32)
             for s, c in zip(laterals, (64, 32, 16))]
    jhead = JaxHead(C)
    p_head = _seed_tree(jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), stack, feats, Q))["params"], 10)
    want_attn, want = jax.tree.map(np.asarray, _jit(lambda pm, ph: (
        jmap.apply({"params": pm}, q, mem_map),
        jhead.apply({"params": ph}, stack, feats, Q)))(p_map, p_head))
    amap = segmentation.MHAttentionMap(C, HEADS)
    amap.load_state_dict(state_dict_from_jax(p_map), strict=True)
    with torch.no_grad():
        got_attn = amap(_t(q), _t(mem_map)).numpy()
    np.testing.assert_allclose(got_attn, want_attn, rtol=0,
                               atol=MODULE_RTOL * np.abs(want_attn).max())
    head = segmentation.MaskHeadSmallConv(C + HEADS, (64, 32, 16), C)
    head.load_state_dict(state_dict_from_jax(p_head), strict=True)
    with torch.no_grad():
        got = head(_t(stack).permute(0, 3, 1, 2),
                   [_t(f).permute(0, 3, 1, 2) for f in feats], Q).numpy()
    assert got.shape == want.shape == (B * Q, laterals[-1], laterals[-1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MODULE_RTOL * np.abs(want).max())


def test_detr_segm_forward_matches_jax():
    """The whole model at 72 px (Swin maps 18, 9 and 5: not halves):
    every decoder layer's logits and boxes, and the mask logits."""
    size = 72
    _, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=11, size=size)
    x = np.random.default_rng(12).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = _jit(lambda p, x: jmodel.apply({"params": p}, x, True))(
        params, jnp.asarray(x))
    model = _port_model(params, size).eval()
    with torch.no_grad():
        got = model(_t(x))
    assert got["pred_masks"].shape == (2, Q, 18, 18)
    assert len(got["aux_outputs"]) == CFG["dec_layers"] - 1
    for g, w in zip(got["aux_outputs"] + [got],
                    list(want["aux_outputs"]) + [want]):
        for k in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=FWD_ATOL, rtol=0, err_msg=k)
    wm = np.asarray(want["pred_masks"])
    np.testing.assert_allclose(got["pred_masks"].numpy(), wm, rtol=0,
                               atol=MODULE_RTOL * np.abs(wm).max())


def _detr_targets(B=2, n=4, seed=13):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (B, n, 2))
    wh = rng.uniform(0.1, 0.4, (B, n, 2))
    return {"labels": rng.integers(1, K + 1, (B, n)).astype(np.int32),
            "boxes_cxcywh": np.concatenate([xy + wh / 2, wh], -1),
            "box_mask": np.asarray([[1, 1, 0, 1], [0, 1, 1, 0]],
                                   np.float32)[:B],
            "mask": np.asarray([1.0, 0.0])}


def test_detr_segm_gradients_match_jax_float64():
    """The gradient of every parameter of the summed DETR losses of both
    decoder layers and the mask losses of the last, under one fed-in
    assignment (a padded sample), in float64 on both sides."""
    _, jm32 = _jax_model()
    params32 = _seeded_params(jm32, seed=14)
    x = np.random.default_rng(15).standard_normal((2, SIZE, SIZE, 3))
    tg = _detr_targets()
    gt = np.stack([_blob_masks(4, SIZE, seed=16 + b)
                   for b in range(2)]).astype(np.uint8)
    assign = np.full((2, 2, Q), -1, np.int32)
    assign[:, 0, [1, 4]] = [3, 0]
    assign[:, 1, [0, 2, 5]] = [1, 2, -1]
    with _x64():
        _, jmodel = _jax_model(jnp.float64)
        params = jax.tree.map(lambda a: a.astype(np.float64), params32)

        def loss_fn(p):
            out = jmodel.apply({"params": p}, x, True)
            layers = out["aux_outputs"] + [out]
            total = sum(jax_detr.detr_losses(o, tg, assign[li], K)["loss"]
                        for li, o in enumerate(layers))
            ml = jax_seg.mask_losses(out["pred_masks"], gt, assign[-1],
                                     tg["box_mask"], tg["mask"])
            return total + ml["loss_mask"] + ml["loss_dice"], ml

        (jloss, jml), jgrads = _jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        jgrads = jax.tree.map(np.asarray, jgrads)
        jloss, jml = float(jloss), {k: float(v) for k, v in jml.items()}
    model = _port_model(params32, dtype=torch.float64).double().eval()
    out = model(_t(x))
    layers = out["aux_outputs"] + [out]
    ttg = {k: _t(v) for k, v in tg.items()}
    total = sum(detr.detr_losses(o, ttg, _t(assign[li]), K)["loss"]
                for li, o in enumerate(layers))
    ml = segmentation.mask_losses(out["pred_masks"], _t(gt),
                                  _t(assign[-1]), ttg["box_mask"],
                                  ttg["mask"])
    loss = total + ml["loss_mask"] + ml["loss_dice"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    for k, v in jml.items():
        np.testing.assert_allclose(ml[k].item(), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    want = state_dict_from_jax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    assert {"mask_head.lay4.weight", "mask_head.adapter2.weight",
            "bbox_attention.k_linear.weight"} <= set(grads)
    floor = GRAD_FLOOR * max(v.abs().max().item() for v in want.values())
    for n, g in grads.items():
        w = want[n].double().numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_RTOL * max(np.abs(w).max(), floor), err_msg=n)


def test_detr_state_dict_loads_into_detr_segm():
    """DETRSegm keeps DETR's names: a DETR state dict loads and leaves
    only the mask branch missing."""
    cfg = detr.DETRConfig(**CFG)
    plain = detr.build_detr(cfg, "swin_test3", SIZE, torch.float32)
    segm = detr.build_detr(cfg, "swin_test3", SIZE, torch.float32,
                           torch.Generator().manual_seed(1), masks=True,
                           num_mask_heads=HEADS)
    missing, unexpected = segm.load_state_dict(plain.state_dict(),
                                               strict=False)
    assert not unexpected and missing
    assert all(k.startswith(("bbox_attention.", "mask_head."))
               for k in missing)
    assert {k.split(".")[0] for k in missing} == {"bbox_attention",
                                                 "mask_head"}
    for k, v in plain.state_dict().items():
        assert torch.equal(segm.state_dict()[k], v)


def test_w8a8_reaches_the_transformer_only(monkeypatch):
    """Under ``VITX_W8A8=1`` in eval the transformer's projections are
    QLinears that quantise; the mask branch has none."""
    model = detr.build_detr(detr.DETRConfig(**CFG), "swin_test3", SIZE,
                            torch.float32, masks=True,
                            num_mask_heads=HEADS).eval()
    monkeypatch.setenv("VITX_W8A8", "1")
    assert model.input_proj.quantized()
    assert model.decoder[0].cross_attn.q.quantized()
    for branch in (model.bbox_attention, model.mask_head):
        assert not any(isinstance(m, QLinear) for m in branch.modules())
    with torch.no_grad():
        out = model(torch.zeros((1, SIZE, SIZE, 3)))
    assert torch.isfinite(out["pred_masks"]).all()


# -- trainer ----------------------------------------------------------------

def _mask_batches(n_steps=3, B=2, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        xy = rng.uniform(0, 40, (B, 4, 2))
        wh = rng.uniform(8, 20, (B, 4, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        masks = np.zeros((B, 4, SIZE, SIZE), np.uint8)
        for b in range(B):
            for j in range(4):
                x0, y0, x1, y1 = boxes[b, j].astype(int)
                masks[b, j, y0:y1, x0 + 1:x1] = 1
        out.append({
            "image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(
                np.uint8),
            "boxes": boxes,
            "labels": rng.integers(1, K + 1, (B, 4)).astype(np.int32),
            "box_mask": (rng.random((B, 4)) < 0.8).astype(np.float32),
            "gt_masks": masks,
            "mask": np.asarray([1.0, float(i < 2)], np.float32)})
    return out


def test_masks_trainer_trajectory_matches_jax():
    """Three host-matcher AdamW steps of ``masks=True`` with the flip on
    (the JAX key sequence's flips fed to the port, which moves the masks
    with the images): every logged term, the mask losses among them, and
    every parameter after the last (as tests/test_torch_port_detr.py)."""
    lr = 1e-3
    _, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=18)
    batches = _mask_batches()
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=SIZE,
                                      num_classes=K, lr=lr, masks=True,
                                      augment=True)
    jtr._forward_costs = _o0(jtr._forward_costs)
    jtr._train_step = _o0(jtr._train_step)
    key, draws = jtr.rng, []
    for b in batches:
        key, step = jax.random.split(key)
        r_flip = jax.random.split(step, 3)[0]
        draws.append({"flip": _t(jax.random.bernoulli(
            r_flip, 0.5, (len(b["image"]),)))})
    assert any(d["flip"].any() for d in draws)
    model = _port_model(params)
    tr = engine.DetectionTrainer(model, image_size=SIZE, num_classes=K,
                                 lr=lr, masks=True, augment=True)
    tr.draw = lambda B: draws.pop(0)
    logs = {"jax": [], "port": []}
    jtr.train_one_epoch(batches, 0, print_freq=1,
                        log_fn=lambda i, n, l: logs["jax"].append(l))
    tr.train_one_epoch(batches, 0, print_freq=1,
                       log_fn=lambda i, n, l: logs["port"].append(l))
    assert len(logs["port"]) == 3 and not draws
    for want, got in zip(logs["jax"], logs["port"]):
        assert sorted(got) == sorted(want)
        assert "loss_mask" in got and "loss_dice" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jtr.params))
    got = model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)


# -- data and transforms ----------------------------------------------------

@pytest.mark.parametrize("segm", ["polygon", "rle"])
def test_load_masks_matches_jax(segm, tmp_path):
    """``load_masks`` batches equal the JAX dataset's: polygons drawn in
    letterbox pixels, RLEs decoded, resized and pasted."""
    img_dir, ann_file = coco_data.make_synthetic_coco(
        str(tmp_path), n_images=5, size=40, seed=2)
    if segm == "rle":
        d = json.load(open(ann_file))
        for a in d["annotations"]:
            a["segmentation"] = jax_mask.poly_to_rle(a["segmentation"], 40,
                                                     40)
        json.dump(d, open(ann_file, "w"))
    kw = dict(image_size=56, max_boxes=4, load_masks=True)
    j_ds = jax_data.CocoDetectionDataset(img_dir, ann_file, **kw)
    p_ds = coco_data.CocoDetectionDataset(img_dir, ann_file, **kw)
    j_b = list(jax_data.CocoLoader(j_ds, 2, num_workers=0))
    p_b = list(coco_data.CocoLoader(p_ds, 2, num_workers=0))
    assert len(p_b) == len(j_b) == 3
    for jb, pb in zip(j_b, p_b):
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert p_b[0]["gt_masks"].shape == (2, 4, 56, 56)
    assert p_b[0]["gt_masks"].sum() > 0


def test_mask_transforms_with_jax_draws():
    """The flip and the zoom-crop of (B, N, S, S) masks with the JAX
    functions' draws: the flip exactly, the crop but for pixels within
    rounding of the 0.5 threshold (at most CROP_MASK_SHARE of them)."""
    rng = np.random.default_rng(19)
    B, S = 6, 32
    images = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    xy = rng.uniform(0, 20, (B, 3, 2))
    bxs = np.concatenate([xy, xy + 10], -1).astype(np.float32)
    box_mask = np.ones((B, 3), np.float32)
    masks = np.stack([_blob_masks(3, S, seed=20 + b)
                      for b in range(B)]).astype(np.uint8)
    def jax_side(key, images, bxs, box_mask, masks):
        k_flip, k_crop = jax.random.split(key)
        flip = jax.random.bernoulli(k_flip, 0.5, (B,))
        flipped = jax_tf.random_hflip(k_flip, images, bxs, S, masks)[2]
        r_apply, r_scale, r_off = jax.random.split(k_crop, 3)
        w = jax.random.uniform(r_scale, (B,), minval=0.6, maxval=1.0) * S
        crop = {"apply": jax.random.bernoulli(r_apply, 0.5, (B,)),
                "zoom": S / w,
                "off": jax.random.uniform(r_off, (B, 2), maxval=1.0)
                * (S - w[:, None])}
        cropped = jax_tf.random_zoom_crop(k_crop, images, bxs, box_mask, S,
                                          masks)[3]
        return flip, flipped, crop, cropped

    flip, want_flip, crop, want_crop = jax.tree.map(np.asarray, _jit(
        jax_side)(jax.random.PRNGKey(3), images, bxs, box_mask, masks))
    got = transforms.apply_hflip(_t(flip), _t(images), _t(bxs), S,
                                 masks=_t(masks))
    assert len(got) == 3 and 0 < flip.sum() < B
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_flip))
    got = transforms.apply_zoom_crop({k: _t(v) for k, v in crop.items()},
                                     _t(images), _t(bxs), _t(box_mask), S,
                                     _t(masks))
    assert got[3].dtype == torch.uint8 and 0 < crop["apply"].sum() < B
    differ = got[3].numpy() != np.asarray(want_crop)
    assert differ.mean() <= CROP_MASK_SHARE
    assert (got[3].numpy() != masks).any()


# -- evaluation -------------------------------------------------------------

def _segm_gt(rng, n_images=4, h=40, w=48):
    images = [{"id": i + 1, "height": h, "width": w}
              for i in range(n_images)]
    anns, aid = [], 1
    for img in images:
        for j in range(3):
            m = _blob_masks(1, 40, seed=int(rng.integers(1 << 30)))[0]
            m = np.pad(m, ((0, 0), (0, w - 40)))
            segm = (jax_mask.encode(m) if j != 1 else
                    [[2.0, 2.0, 30.0, 4.0, 25.0, 33.0, 5.0, 30.0]])
            area = (float(jax_mask.area(segm)) if j != 1 else 700.0)
            ys, xs = np.nonzero(m)
            anns.append({"id": aid, "image_id": img["id"],
                         "category_id": int(rng.integers(1, 3)),
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min() + 1),
                                  float(ys.max() - ys.min() + 1)],
                         "area": area, "iscrowd": int(j == 2 and
                                                      img["id"] == 2),
                         "segmentation": segm})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}


def _segm_results(rng, gt):
    res = []
    for a in gt["annotations"]:
        for shift in (0, 3):
            m = np.roll(jax_mask.decode(a["segmentation"]) if isinstance(
                a["segmentation"], dict) else jax_mask.decode(
                jax_mask.poly_to_rle(a["segmentation"], 40, 48)), shift, 1)
            res.append({"image_id": a["image_id"],
                        "category_id": a["category_id"],
                        "bbox": a["bbox"], "score": float(rng.random()),
                        "segmentation": jax_mask.encode(m)})
    return res


def test_cocoeval_segm_matches_jax():
    """``COCOeval(..., "segm")`` over RLE and polygon gts, a crowd gt and
    shifted detections: the 12 numbers at 1e-12; and ``CocoEvaluator``
    fed the pixel masks gives the same."""
    rng = np.random.default_rng(23)
    gt = _segm_gt(rng)
    res = _segm_results(rng, gt)
    stats = []
    for mod in (jax_eval, coco_eval):
        coco_gt = mod.COCO(dataset=gt)
        ev = mod.COCOeval(coco_gt, coco_gt.load_res(res), "segm")
        ev.evaluate()
        ev.accumulate()
        stats.append(ev.summarize())
    np.testing.assert_allclose(stats[1], stats[0], atol=1e-12, rtol=0)
    assert 0 < stats[1][0] < 1
    e = coco_eval.CocoEvaluator(coco_eval.COCO(dataset=gt),
                                ("bbox", "segm"))
    for r in res:
        x, y, bw, bh = r["bbox"]
        e.update({r["image_id"]: {
            "boxes": [[x, y, x + bw, y + bh]], "scores": [r["score"]],
            "labels": [r["category_id"]],
            "masks": [_mask.decode(r["segmentation"])]}})
    e.accumulate()
    np.testing.assert_allclose(list(e.summarize()["segm"].values()),
                               stats[0], atol=1e-12, rtol=0)


def test_unletterbox_and_pq_prepare_match_jax():
    """``_unletterbox_masks`` at an odd geometry and ``_pq_prepare``
    (polygon and RLE gts, a crowd, overlapping predictions)."""
    rng = np.random.default_rng(24)
    masks = _blob_masks(5, 64, seed=25, holes=True).astype(np.uint8)
    args = (0.9, np.asarray([0, 9]), np.asarray([50, 70]))
    want = jax_engine._unletterbox_masks(masks, *args)
    np.testing.assert_array_equal(engine._unletterbox_masks(masks, *args),
                                  want)
    gt = _segm_gt(rng, n_images=2)
    pred = {"masks": np.stack([_blob_masks(1, 40, seed=s)[0]
                               for s in range(4)]).astype(np.uint8),
            "labels": np.asarray([1, 2, 1, 2]),
            "scores": np.asarray([0.9, 0.3, 0.5, 0.7])}
    pred["masks"] = np.pad(pred["masks"], ((0, 0), (0, 0), (0, 8)))
    for img_id in (1, 2):
        w = jax_engine._pq_prepare(jax_eval.COCO(dataset=gt), img_id, pred)
        g = engine._pq_prepare(coco_eval.COCO(dataset=gt), img_id, pred)
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _eval_loader(tmp_path):
    img_dir, ann_file = coco_data.make_synthetic_coco(
        str(tmp_path), n_images=5, size=48, seed=4)
    ds = coco_data.CocoDetectionDataset(img_dir, ann_file, image_size=SIZE,
                                        max_boxes=4)
    return (ds, jax_eval.COCO(ann_file),
            list(coco_data.CocoLoader(ds, 2, num_workers=0)))


def test_evaluate_matches_jax(tmp_path):
    """``evaluate`` on a carried model, with PQ and without: bbox, segm
    and PQ equal to the JAX trainer's (whose evaluation without PQ takes
    its run-length route); the two settings' segm equal."""
    _, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=26)
    ds, jax_gt, batches = _eval_loader(tmp_path)
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=SIZE,
                                      num_classes=K, masks=True)
    both = _jit(lambda p, b: (jtr._predict_vars({"params": p}, b),
                              jtr._predict_vars({"params": p}, b,
                                                with_runs=True)))
    # one trace of both packings (evaluate asks for one or the other)
    jtr._predict = lambda p, b: both(p, b)[0]
    jtr._predict_runs = lambda p, b: both(p, b)[1]
    tr = engine.DetectionTrainer(_port_model(params), image_size=SIZE,
                                 num_classes=K, masks=True)
    kw = dict(iou_types=("bbox", "segm"), label_to_cat=ds.label_to_cat)
    out = {}
    for panoptic in (False, True):
        want = jtr.evaluate(batches, jax_gt, panoptic=panoptic, **kw)
        got = tr.evaluate(batches, ds.coco, panoptic=panoptic, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            for m, v in want[k].items():
                np.testing.assert_allclose(got[k][m], v, atol=1e-9,
                                           err_msg=f"{k}.{m}")
        out[panoptic] = got
        prof = tr.last_eval_profile
        assert prof["images"] == 5 and min(
            prof[k] for k in ("t_get", "t_host", "t_final")) >= 0
    assert out[False]["segm"] == out[True]["segm"]
    assert "panoptic" in out[True] and "panoptic" not in out[False]


# -- CLI --------------------------------------------------------------------

def test_cli_masks_test_mode(tmp_path):
    """``--test --masks --device cpu``: what
    ``tests/test_segmentation.py::test_masks_cli_reports_segm_and_pq``
    checks of the JAX CLI, the mask losses and the settings."""
    fp = str(tmp_path / "stats.json")
    record = cli_coco.main(["--test", "--masks", "--device", "cpu",
                            "--epochs", "1", "--no_initial_eval",
                            "--stats_fp", fp])
    d = json.load(open(fp))
    val = d["logs"][0]["val"]
    assert "segm" in val and len(val["segm"]) == 12
    assert all(np.isfinite(val["panoptic"][k]) for k in ("pq", "sq", "rq"))
    train = d["logs"][0]["train"]
    assert np.isfinite(train["loss_mask"]) and np.isfinite(
        train["loss_dice"])
    assert d["info"]["backbone"] == "swin_test3" and record["telem"][
        "completed"]


@pytest.mark.parametrize("argv", [
    ["--masks", "--head", "faster_rcnn"],
    ["--panoptic_root", "p", "--head", "faster_rcnn"],
    ["--masks", "--keypoints", "--head", "faster_rcnn"],
    ["--panoptic_root", "p", "--keypoints"]])
def test_cli_refuses_mask_combinations_before_any_work(argv, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(coco_data, "make_synthetic_coco", None)
    fp = tmp_path / "s.json"
    with pytest.raises(SystemExit):
        cli_coco.main(["--test", "--device", "cpu", "--stats_fp", str(fp)]
                      + argv)
    assert not fp.exists()
    assert not os.path.exists(tmp_path / "p")
