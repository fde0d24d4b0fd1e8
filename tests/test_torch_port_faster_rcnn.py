"""Port parity: Faster R-CNN and Keypoint R-CNN against the JAX package,
on the CPU.

The JAX tests' tiny configuration (``tests/test_faster_rcnn.py:15-18``:
64 px, strides 4 and 8, anchors 8 and 16) over ``resnet_test``, with a
five-keypoint head of two 8-channel convs, and over ``swin_test3``
(strides 4, 8 and 16); seeded numpy weights and BatchNorm statistics in
the JAX model's tree (``jax.eval_shape``, no init compile) carried into
the port by ``state_dict_from_jax``, loaded strictly.

Discrete stages (top-k, NMS, matching, sampling) turn one-ulp differences
into other choices, so each is held against the JAX function on the same
inputs, and the chosen indices are asserted equal before what follows
them is compared.  The losses, the gradients of every parameter and the
three-step trajectory run in float64 on both sides (``jax_enable_x64``):
a train-mode BatchNorm output within fp32 rounding of 0 takes either
side of the next ReLU in either package (``tests/test_torch_port_resnet
.py``).  The sampling noise and the flip are the JAX key sequence's
draws, fed to the port.  Each JAX function is traced once.
"""

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection import boxes as jax_boxes
from vit_torch_tpu.detection import faster_rcnn as jf
from vit_torch_tpu.detection.engine import (
    FasterRCNNTrainer as JaxFasterRCNNTrainer)
from vit_torch_tpu.models.resnet import RESNET_CONFIGS as JAX_RESNET_CONFIGS
from vit_torch_tpu.models.resnet import ResNet as JaxResNet
from vit_torch_tpu.models.swin import SWIN_CONFIGS as JAX_SWIN_CONFIGS
from vit_torch_tpu.models.swin import SwinTransformer as JaxSwin
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.data.augment import normalize
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.detection import boxes, faster_rcnn as pf
from vit_torch_tpu_torch.detection.engine import FasterRCNNTrainer
from vit_torch_tpu_torch.detection.transforms import apply_hflip
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SIZE, K, KP = 64, 3, 5
CFG = jf.FasterRCNNConfig(num_classes=K, image_size=SIZE, strides=(4, 8),
                          anchor_sizes=(8.0, 16.0), num_proposals=32,
                          rpn_pre_nms_topk=64, rpn_batch=32, roi_batch=16,
                          detections=10)
KP_CFG = dataclasses.replace(CFG, num_keypoints=KP, kp_conv_channels=(8, 8),
                             kp_rois=8)
N_ANCHORS = 3 * ((SIZE // 4) ** 2 + (SIZE // 8) ** 2)
SWIN_CFG = dataclasses.replace(CFG, strides=(4, 8, 16),
                               anchor_sizes=(8.0, 16.0, 32.0))
# fp32 values of a few layers: max |port - JAX| relative to max |JAX|
# (summation order; box_fc1 sums 7 x 7 x 256 = 12,544 products)
FWD_RTOL = 5e-5
# float64: values, losses and gradients relative to the largest |value|
# of each.  XLA's jitted RoIAlign is not float64-exact: on the CPU it
# differs from the same JAX function run eagerly by up to 5e-6 of the
# maps' values (the port agrees with the eager one to 1e-15), which moves
# the class logits by 3e-7 and the keypoint head's gradients by 2e-6
# between the jitted JAX program and the port; the RPN, which reads no
# RoI, and the proposals agree to 1e-14
GRAD_RTOL = 1e-5
RPN_RTOL_F64 = 1e-12
# a gradient zero in exact arithmetic (the keypoint deconv's bias: the
# heatmap softmax, which both packages compute in fp32, ignores a shift
# shared by a keypoint's whole map) is fp32 rounding noise on both sides:
# each is held below this share of the model's largest gradient
ZERO_GRADS = ("kp_head.deconv.bias",)
ZERO_GRAD_SHARE = 1e-6
# W8A8: both sides round the same fp32 values to int8 codes; a code one
# step apart (the JAX scale's fused multiply-add, see
# tests/test_torch_port_quant.py) moves a logit by about 1e-2 of its
# range (tests/test_torch_port_detr.py's bounds)
W8A8_ATOL = 5e-2
W8A8_MEDIAN_ATOL = 1e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_model(cfg=KP_CFG, backbone="resnet_test", dtype=jnp.float32):
    if backbone in JAX_SWIN_CONFIGS:
        bb = JaxSwin(JAX_SWIN_CONFIGS[backbone], dtype=dtype,
                     multi_features=True, name="backbone")
    else:
        bb = JaxResNet(JAX_RESNET_CONFIGS[backbone], dtype=dtype,
                       features_only=True, name="backbone")
    return jf.FasterRCNN(cfg, bb, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _shapes(jmodel):
    return jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        deterministic=True))


def _seeded(jmodel, seed=0):
    """Variables of the JAX model's shapes from numpy: kernels of std
    1/sqrt(fan in), scales and BN variances in [0.5, 1.5], every other
    leaf (biases, BN means, tables) of std 0.1."""
    shapes = _shapes(jmodel)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name and len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if "scale" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _port(cfg, variables, backbone="resnet_test", dtype=torch.float32):
    """The port's model with the JAX variables, loaded strictly (built on
    the meta device: the load sets every parameter and statistic)."""
    from vit_torch_tpu_torch.models.zoo import reset_buffers
    model = pf.build_faster_rcnn(pf.FasterRCNNConfig(
        **dataclasses.asdict(cfg)), backbone, dtype, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], batch_stats=variables.get("batch_stats")),
        strict=True)
    reset_buffers(model)
    return model.to(dtype)


def _jit(fn):
    """``jax.jit`` whose XLA program is compiled at LLVM's -O0 on its
    first call: a third of the default's compile time for the one-call
    fp32 forwards (the float64 train steps run slower so than they
    compile); fp arithmetic is not reordered at any level."""
    compiled = {}

    def call(*args):
        if not compiled:
            compiled["fn"] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled["fn"](*args)
    return call


def _images(n=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


def _targets(seed=2, B=2, G=4):
    """Boxes on the 64 px canvas (one image with a padded slot), labels,
    five keypoints a box (some invisible, one on the far edge)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 36, (B, G, 2))
    wh = rng.uniform(10, 28, (B, G, 2))
    bx = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    kx = rng.uniform(0, 1, (B, G, KP, 2)) * wh[:, :, None] + xy[:, :, None]
    kv = rng.integers(0, 3, (B, G, KP, 1)).astype(np.float64)
    kps = np.concatenate([kx, kv], -1).astype(np.float32)
    kps[0, 0, 0, :2] = bx[0, 0, 2:]                  # the far corner
    return {"boxes": bx, "labels": rng.integers(1, K + 1, (B, G)).astype(
        np.int32),
        "box_mask": np.asarray([[1, 1, 0, 1], [1, 0, 0, 0]], np.float32),
        "mask": np.ones((B,), np.float32), "keypoints": kps}


def _targets_on_proposals(model, x, tg):
    """``tg`` with the first two gt boxes of each image moved onto
    train-mode proposals 0 and 5 of ``model`` on images ``x`` (shifted by
    a pixel), so that the RoI head and the keypoint branch get positives
    with seeded weights; their keypoints follow the boxes."""
    with torch.no_grad():
        props = model.train()(_t(x))["proposals"].numpy()
    for b in range(2):
        for g, p in ((0, 0), (1, 5)):
            old, new = tg["boxes"][b, g], props[b, p] + [1, -1, 1, -1]
            rel = (tg["keypoints"][b, g, :, :2] - old[:2]) / (old[2:]
                                                               - old[:2])
            tg["boxes"][b, g] = new
            tg["keypoints"][b, g, :, :2] = new[:2] + rel * (new[2:] - new[:2])
            tg["box_mask"][b, g] = 1.0
    return tg


# --------------------------------------------------------------------------
# stages


def test_anchors_and_box_coding_match_jax():
    """The anchor grid exactly; encode, decode (with the dw clip and the
    box clip), smooth L1 and the sigmoid CE within 1e-6 of each's largest
    value."""
    a = pf.generate_anchors(SIZE, (4, 8), (8.0, 16.0))
    np.testing.assert_array_equal(a, jf.generate_anchors(SIZE, (4, 8),
                                                         (8.0, 16.0)))
    assert pf.FasterRCNNConfig(**dataclasses.asdict(CFG)).num_anchors \
        == len(a)
    rng = np.random.default_rng(0)
    bx = np.concatenate([rng.uniform(0, 40, (50, 2)),
                         rng.uniform(0, 40, (50, 2)) + 45], -1).astype(
        np.float32)
    bx[3] = [5.0, 5.0, 5.0, 5.0]                      # degenerate: clamps
    deltas = (3 * rng.standard_normal((50, 4))).astype(np.float32)
    want = jax.jit(lambda bx, a, d: (
        jf.encode_boxes(bx, a), jf.decode_boxes(d, a),
        jf.decode_boxes(d, a, clip=64.0), jf.smooth_l1(d),
        jf.optax_sigmoid_ce(d, (d > 0).astype(jnp.float32))))(
        bx, a[:50], deltas)
    got = (pf.encode_boxes(_t(bx), _t(a[:50])),
           pf.decode_boxes(_t(deltas), _t(a[:50])),
           pf.decode_boxes(_t(deltas), _t(a[:50]), clip=64.0),
           pf.smooth_l1(_t(deltas)),
           pf.optax_sigmoid_ce(_t(deltas), _t(deltas > 0, torch.float32)))
    for got, want in zip(got, want):
        # an ulp of the coordinates, where x - w/2 cancels
        assert _rel(got, want) <= 1e-6


def test_nms_padded_matches_jax():
    """Indices and validity exactly, over a batch: random boxes with equal
    scores (the first index wins, as ``jnp.argmax``), an image of all
    -inf scores, degenerate boxes, and more outputs than boxes."""
    rng = np.random.default_rng(3)
    n = 40
    xy = rng.uniform(0, 50, (3, n, 2))
    bx = np.concatenate([xy, xy + rng.uniform(0, 20, (3, n, 2))],
                        -1).astype(np.float32)
    bx[0, 5] = bx[0, 5, [0, 1, 0, 1]]                  # zero area
    sc = rng.standard_normal((3, n)).astype(np.float32)
    sc[0, 10:20] = 0.5                                  # ties
    sc[1] = -np.inf                                     # nothing to keep
    sc[2, ::3] = -np.inf
    jnms = jax.jit(jax.vmap(
        lambda b, s, m: jax_boxes.nms_padded(b, s, 0.5, m),
        in_axes=(0, 0, None)), static_argnums=2)
    for m in (12, 50):
        want = jnms(jnp.asarray(bx), jnp.asarray(sc), m)
        idx, valid = boxes.nms_padded(_t(bx), _t(sc), 0.5, m)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))
        one = boxes.nms_padded(_t(bx[0]), _t(sc[0]), 0.5, m)
        np.testing.assert_array_equal(one[0].numpy(), idx[0].numpy())
    assert not valid[1].any() and valid[0].sum() > 0


def test_matching_and_sampling_match_jax():
    """``match_to_gt`` (masked gts, the -1 band, the low-quality rescue)
    exactly, and ``sample_balanced`` on the JAX function's own noise
    exactly (its index order, weights and positives)."""
    anchors = jf.generate_anchors(SIZE, (4, 8), (8.0, 16.0))
    tg = _targets()
    jmatch = jax.jit(jax.vmap(jf.match_to_gt,
                              in_axes=(None, 0, 0, None, None, None)),
                     static_argnums=(3, 4, 5))
    for hi, lo, low in ((0.7, 0.3, True), (0.5, 0.5, False)):
        want = jmatch(jnp.asarray(anchors), jnp.asarray(tg["boxes"]),
                      jnp.asarray(tg["box_mask"]), hi, lo, low)
        got = pf.match_to_gt(_t(anchors), _t(tg["boxes"]),
                             _t(tg["box_mask"]), hi, lo, low)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    label = np.asarray(want[1])
    assert {-1, 0, 1} <= set(np.unique(np.asarray(jmatch(
        jnp.asarray(anchors), jnp.asarray(tg["boxes"]),
        jnp.asarray(tg["box_mask"]), 0.7, 0.3, True)[1])).tolist())
    for num, frac in ((32, 0.5), (16, 0.25), (900, 0.5)):
        keys = jax.random.split(jax.random.PRNGKey(num), 2)
        noise = jax.vmap(lambda k: jax.random.uniform(k, (len(anchors),)))(
            keys)
        want = jax.jit(jax.vmap(lambda k, lab: jf.sample_balanced(
            k, lab, num, frac)))(keys, label)
        got = pf.sample_balanced(_t(noise), _t(label), num, frac)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pyramid(seed=4, C=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, s, C)).astype(np.float32)
            for s in (32, 16, 8)]


def _rois():
    """RoIs across every level, over the map's borders, unit boxes and a
    degenerate one, on a 128 px canvas."""
    return np.asarray([
        [[2.0, 2, 20, 20], [0, 0, 120, 120], [-5, -5, 40, 60],
         [100, 100, 128, 128], [7, 7, 7, 7], [0, 0, 1, 1]],
        [[0.0, 0, 10, 10], [30, 40, 90, 80], [1, 1, 127, 127],
         [60, 2, 70, 126], [0, 0, 1, 1], [-20, 90, 150, 140]]], np.float32)


@pytest.mark.parametrize("flat", ["1", "0"])
def test_roi_align_matches_jax_with_gradients(flat, monkeypatch):
    """Both RoIAlign forms (``VITX_ROI_FLAT`` on both sides) at sizes 7
    and 3, values and the gradient to every level and to the boxes
    against ``jax.vjp`` (fp32, summation order)."""
    monkeypatch.setenv("VITX_ROI_FLAT", flat)
    feats, rois = _pyramid(), _rois()
    strides = (4, 8, 16)
    rng = np.random.default_rng(5)
    for S in (7, 3):
        ct = rng.standard_normal((2, 6, S, S, 6)).astype(np.float32)

        def vjp(f, b, ct, S=S):
            out, back = jax.vjp(lambda f, b: jf.roi_align(f, b, strides, S),
                                f, b)
            return out, back(ct)

        want, (dfeats, dboxes) = jax.jit(vjp)(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois),
            jnp.asarray(ct))
        tf = [_t(f).requires_grad_() for f in feats]
        tb = _t(rois).requires_grad_()
        got = pf.roi_align(tf, tb, strides, S)
        got.backward(_t(ct))
        assert _rel(got.detach(), want) < FWD_RTOL
        for g, w in zip(tf, dfeats):
            assert _rel(g.grad, w) < FWD_RTOL
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(dboxes),
                                   atol=1e-4 * np.abs(dboxes).max())


def test_fpn_and_rpn_head_match_jax():
    """The FPN at odd map sizes (25 -> 13 -> 7: the nearest-neighbour
    upsample must be ``nearest-exact``) and the RPN head's (y, x, a)
    flatten order, against the JAX modules with the same weights."""
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in ((25, 8), (13, 16), (7, 32))]
    jfpn = jf.FPN(16)
    jrpn = jf.RPNHead()
    shapes = jax.eval_shape(lambda: jfpn.init(jax.random.PRNGKey(0),
                                              [jnp.asarray(f) for f in feats]))
    p_fpn = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape))
                         .astype(np.float32), shapes)["params"]
    outs = jfpn.apply({"params": p_fpn}, [jnp.asarray(f) for f in feats])
    shapes = jax.eval_shape(lambda: jrpn.init(jax.random.PRNGKey(0), outs))
    p_rpn = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape))
                         .astype(np.float32), shapes)["params"]
    logits, deltas = jrpn.apply({"params": p_rpn}, outs)
    fpn, rpn = pf.FPN([8, 16, 32], 16), pf.RPNHead(16)
    sd = state_dict_from_jax({"fpn": p_fpn})
    fpn.load_state_dict({k[4:]: v for k, v in sd.items()})
    rpn.load_state_dict(state_dict_from_jax(p_rpn))
    with torch.no_grad():
        got = fpn([_t(f) for f in feats])
        glog, gdel = rpn(got)
    for g, w in zip(got, outs):
        assert g.shape == w.shape and _rel(g, w) < FWD_RTOL
    assert _rel(glog, logits) < FWD_RTOL and _rel(gdel, deltas) < FWD_RTOL
    assert gdel.shape == (2, 3 * (25 ** 2 + 13 ** 2 + 7 ** 2), 4)


# --------------------------------------------------------------------------
# whole model


@jax.jit
def _jax_proposal_index(logits, deltas, anchors):
    """The JAX proposal stage's anchor index per slot (-1 where empty):
    its top-k and ``nms_padded`` on the same inputs (every configuration
    here shares CFG's proposal settings)."""
    cfg = CFG

    def one(logit, delta):
        box = jf.decode_boxes(delta, anchors, clip=float(cfg.image_size))
        score, idx = jax.lax.top_k(logit, min(cfg.rpn_pre_nms_topk,
                                              logit.shape[0]))
        keep, valid = jax_boxes.nms_padded(box[idx], score,
                                           cfg.rpn_nms_thresh,
                                           cfg.num_proposals)
        return jnp.where(valid, idx[keep], -1)
    return jax.vmap(one)(logits, deltas)


def _check_proposals(model, out, want, rtol):
    """Proposal indices equal (the port's proposal stage on the JAX RPN
    outputs, and in the port's own forward), then the proposal boxes."""
    _, _, idx = model.proposals(_t(want["rpn_logits"]),
                                _t(want["rpn_deltas"]), out["anchors"])
    jidx = np.asarray(_jax_proposal_index(
        want["rpn_logits"], want["rpn_deltas"], want["anchors"]))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(out["proposal_index"].numpy(), jidx)
    assert _rel(out["proposals"].detach(), want["proposals"]) < rtol


def test_eval_forward_decode_and_predict_match_jax():
    """The eval forward of Keypoint R-CNN over ``resnet_test`` (BN on its
    statistics, folded on both sides): RPN logits and deltas, proposal
    indices, class logits and box deltas; the detections (labels and
    their order equal) with keypoints on them; ``faster_rcnn_predict``
    with the letterbox undone and the keypoints decoded."""
    jm = _jax_model()
    var = _seeded(jm)
    x = _images()
    scale = np.asarray([0.5, 2.0], np.float32)
    pad = np.asarray([[0.0, 8.0], [3.0, 0.0]], np.float32)

    def run(v, x):
        out = jm.apply(v, x, deterministic=True)
        return out, jf.faster_rcnn_predict(out, KP_CFG, jnp.asarray(scale),
                                           jnp.asarray(pad))

    want, wpred = jax.tree.map(np.asarray, _jit(run)(var, x))
    model = _port(KP_CFG, var).eval()
    with torch.no_grad():
        out = model(_t(x))
        pred = pf.faster_rcnn_predict(out, model.config, _t(scale), _t(pad))
    for k in ("rpn_logits", "rpn_deltas"):
        assert _rel(out[k], want[k]) < FWD_RTOL, k
    _check_proposals(model, out, want, FWD_RTOL)
    for k in ("cls_logits", "box_deltas", "kp_logits"):
        assert _rel(out[k], want[k]) < FWD_RTOL, k
    np.testing.assert_array_equal(out["detections"]["labels"].numpy(),
                                  want["detections"]["labels"])
    np.testing.assert_array_equal(pred["labels"].numpy(), wpred["labels"])
    for k in ("boxes", "scores", "keypoints"):
        assert _rel(pred[k], wpred[k]) < FWD_RTOL, k
    assert pred["keypoints"].shape == (2, KP_CFG.detections, KP, 3)
    # decode_detections alone on the JAX outputs
    dets = pf.decode_detections({k: _t(want[k]) for k in (
        "cls_logits", "box_deltas", "proposals")}, model.config)
    jdets = jax.jit(lambda o: jf.decode_detections(o, KP_CFG))(
        {k: want[k] for k in ("cls_logits", "box_deltas", "proposals")})
    for k in ("labels", "scores", "boxes"):
        np.testing.assert_allclose(dets[k].numpy(), np.asarray(jdets[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)


def test_swin_backbone_forward_matches_jax():
    """Faster R-CNN over ``swin_test3``'s three stage maps (the module
    surgery route), eval mode: RPN outputs, proposal indices, heads."""
    jm = _jax_model(SWIN_CFG, "swin_test3")
    var = _seeded(jm, seed=7)
    x = _images(seed=8)
    want = jax.tree.map(np.asarray, _jit(
        lambda v, x: jm.apply(v, x, deterministic=True))(var, x))
    model = _port(SWIN_CFG, var, "swin_test3").eval()
    with torch.no_grad():
        out = model(_t(x))
    assert len(model.fpn.lateral) == 3
    for k in ("rpn_logits", "rpn_deltas"):
        assert _rel(out[k], want[k]) < FWD_RTOL, k
    _check_proposals(model, out, want, FWD_RTOL)
    for k in ("cls_logits", "box_deltas"):
        assert _rel(out[k], want[k]) < FWD_RTOL, k


def _jax_draws(rng, B, n_anchors, n_props):
    """The JAX trainer's draws of one step from its key: the flip, then
    per image the RPN and the RoI noise (``engine.py:730``,
    ``faster_rcnn.py:459`` and ``:140``)."""
    flip_rng, sample_rng = jax.random.split(rng)
    keys = [jax.random.split(k) for k in jax.random.split(sample_rng, B)]
    return {"flip": _t(jax.random.bernoulli(flip_rng, 0.5, (B,))),
            "rpn_noise": _t(np.stack([jax.random.uniform(k[0], (n_anchors,))
                                      for k in keys])),
            "roi_noise": _t(np.stack([jax.random.uniform(k[1], (n_props,))
                                      for k in keys]))}


def test_train_losses_and_gradients_match_jax_in_float64():
    """Keypoint R-CNN in train mode, float64 on both sides, on the JAX
    draws: RPN outputs, proposal indices, class logits and box deltas;
    every loss term; the gradient of every parameter of the summed loss
    (``jax.value_and_grad``); the BatchNorm statistics after the
    forward."""
    x = _images(seed=10)
    with _x64():
        jm = _jax_model(dtype=jnp.float64)
        var = jax.tree.map(lambda a: a.astype(np.float64), _seeded(jm, 11))
    tg = _targets_on_proposals(_port(KP_CFG, var, dtype=torch.float64), x,
                               _targets(seed=9))
    with _x64():
        rng = jax.random.PRNGKey(3)
        draws = _jax_draws(jax.random.fold_in(rng, 0), 2, N_ANCHORS,
                           CFG.num_proposals)
        sample_rng = jax.random.split(jax.random.fold_in(rng, 0))[1]

        def loss_fn(p):
            out, new = jm.apply({"params": p,
                                 "batch_stats": var["batch_stats"]},
                                jnp.asarray(x, jnp.float64),
                                deterministic=False,
                                mutable=["batch_stats"])
            losses = jf.faster_rcnn_losses(
                out, {k: jnp.asarray(v) for k, v in tg.items()}, KP_CFG,
                sample_rng)
            return losses["loss"], (losses, out, new["batch_stats"])

        (_, (jl, want, jstats)), jgrads = jax.tree.map(
            np.asarray, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                var["params"]))
    model = _port(KP_CFG, var, dtype=torch.float64).train()
    out = model(_t(x))
    _check_proposals(model, out, want, RPN_RTOL_F64)
    for k in ("rpn_logits", "rpn_deltas"):
        assert _rel(out[k].detach(), want[k]) < RPN_RTOL_F64, k
    for k in ("cls_logits", "box_deltas", "kp_logits"):
        assert _rel(out[k].detach(), want[k]) < GRAD_RTOL, k
    losses = pf.faster_rcnn_losses(
        out, {k: _t(v) for k, v in tg.items()}, model.config, draws)
    assert sorted(losses) == sorted(jl)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), jl[k], rtol=GRAD_RTOL,
                                   atol=1e-12, err_msg=k)
    assert losses["loss_keypoint"].item() > 0
    losses["loss"].backward()
    want_g = state_dict_from_jax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    top = max(v.abs().max().item() for v in want_g.values())
    for n, g in grads.items():
        w = want_g[n].double().numpy()
        if n in ZERO_GRADS:
            assert max(g.abs().max().item(), np.abs(w).max()) \
                < ZERO_GRAD_SHARE * top, n
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=n)
    sd = model.state_dict()
    for k, v in state_dict_from_jax({}, batch_stats=jstats).items():
        if not k.endswith("num_batches_tracked"):
            assert _rel(sd[k], v.double()) < GRAD_RTOL, k


def test_trainer_trajectory_matches_jax_in_float64():
    """Three SGD steps of Keypoint R-CNN with the flip on (keypoints
    mirrored and swapped), epoch 0's warmup, clip at 10, coupled decay,
    against the JAX ``FasterRCNNTrainer`` on its own key sequence's draws:
    every logged term of every step (rtol 1e-4), every parameter and
    running statistic after the last.  The first step's gt boxes sit on
    its proposals (found on the flipped images), so that it trains the
    RoI head's regression and the keypoint head."""
    lr = 0.02
    flip_inds = (1, 0, 2, 4, 3)
    with _x64():
        jm = _jax_model(dtype=jnp.float64)
        var = jax.tree.map(lambda a: a.astype(np.float64), _seeded(jm, 13))
        jtr = JaxFasterRCNNTrainer(jm, var["params"], cfg=KP_CFG, lr=lr,
                                   augment=True, kp_flip_inds=flip_inds)
        jtr.model_state = {"batch_stats": var["batch_stats"]}
        key, draws = jtr.rng, []
        for _ in range(3):
            key, step = jax.random.split(key)
            draws.append(_jax_draws(step, 2, N_ANCHORS, CFG.num_proposals))
    rng = np.random.default_rng(12)
    batches = []
    for i in range(3):
        image = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
        tg = _targets(seed=20 + i)
        if i == 0:
            # the targets on the proposals of the flipped images, then
            # flipped back (the flip and the swap are involutions)
            flip = draws[0]["flip"]
            seen = apply_hflip(flip, _t(image), _t(tg["boxes"]), SIZE)[0]
            tg = _targets_on_proposals(
                _port(KP_CFG, var, dtype=torch.float64),
                normalize(seen, **NORM_VALUES["imagenet"]).numpy(), tg)
            _, bx, kp = apply_hflip(flip, _t(image), _t(tg["boxes"]), SIZE,
                                    _t(tg["keypoints"]), flip_inds)
            tg["boxes"], tg["keypoints"] = bx.numpy(), kp.numpy()
        batches.append({
            "image": image, "boxes": tg["boxes"], "labels": tg["labels"],
            "box_mask": tg["box_mask"], "gt_keypoints": tg["keypoints"],
            "mask": np.asarray([1.0, float(i < 2)], np.float32)})
    with _x64():
        jlogs = []
        jtr.train_one_epoch(batches, 0, print_freq=1,
                            log_fn=lambda i, n, l: jlogs.append(l))
        jparams = jax.tree.map(np.asarray, jtr.params)
        jstats = jax.tree.map(np.asarray, jtr.model_state["batch_stats"])
    model = _port(KP_CFG, var, dtype=torch.float64)
    tr = FasterRCNNTrainer(model, cfg=model.config, lr=lr, augment=True,
                           kp_flip_inds=flip_inds)
    tr.draw = lambda B: draws.pop(0)
    logs = []
    tr.train_one_epoch(batches, 0, print_freq=1,
                       log_fn=lambda i, n, l: logs.append(l))
    assert len(logs) == 3 and not draws
    assert logs[0]["loss_reg"] > 0 and logs[0]["loss_keypoint"] > 0
    for want, got in zip(jlogs, logs):
        want = {("loss_total" if k == "loss" else k): v
                for k, v in want.items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       atol=1e-9, err_msg=k)
    sd = model.state_dict()
    for k, w in state_dict_from_jax(jparams, batch_stats=jstats).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), w.double().numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(lr)


def test_w8a8_eval_forward_matches_jax(monkeypatch):
    """Under ``VITX_W8A8=1`` both packages run ``box_fc1`` and ``box_fc2``
    through int8 in the eval forward; the proposals are the fp ones (the
    RPN is not quantised), the class logits within the DETR test's W8A8
    bounds; training never quantises."""
    jm = _jax_model(CFG)
    var = _seeded(jm, seed=14)
    x = _images(seed=15)
    model = _port(CFG, var).eval()
    with torch.no_grad():
        fp = model(_t(x))
    monkeypatch.setenv("VITX_W8A8", "1")
    want = jax.tree.map(np.asarray, _jit(
        lambda v, x: jm.apply(v, x, deterministic=True))(var, x))
    assert model.box_fc1.quantized() and model.box_fc2.quantized()
    with torch.no_grad():
        got = model(_t(x))
    np.testing.assert_array_equal(got["proposal_index"].numpy(),
                                  fp["proposal_index"].numpy())
    diff = np.abs(got["cls_logits"].numpy() - want["cls_logits"])
    assert diff.max() <= W8A8_ATOL and np.median(diff) <= W8A8_MEDIAN_ATOL
    assert (got["cls_logits"] - fp["cls_logits"]).abs().max() > 0
    assert not model.train().box_fc1.quantized()


def test_importer_loads_the_jax_trees_strictly():
    """Faster R-CNN over ``resnet_test`` and Keypoint R-CNN over
    ``swin_test3``: every key of the port's state dict, none left over,
    the keypoint deconv flipped in space."""
    for cfg, bb in ((CFG, "resnet_test"), (
            dataclasses.replace(SWIN_CFG, num_keypoints=KP,
                                kp_conv_channels=(8,)), "swin_test3")):
        var = _seeded(_jax_model(cfg, bb), seed=16)
        sd = state_dict_from_jax(var["params"],
                                 batch_stats=var.get("batch_stats"))
        model = pf.build_faster_rcnn(pf.FasterRCNNConfig(
            **dataclasses.asdict(cfg)), bb, torch.float32)
        assert set(sd) == set(model.state_dict())
        model.load_state_dict(sd, strict=True)
    kernel = var["params"]["kp_head"]["deconv"]["kernel"]
    np.testing.assert_array_equal(
        model.kp_head.deconv.weight.detach().numpy(),
        kernel[::-1, ::-1].transpose(2, 3, 0, 1))


# --------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("argv,iou_types", [
    ([], ["bbox"]), (["--keypoints"], ["bbox", "keypoints"]),
    (["--backbone", "swin_test3"], ["bbox"])], ids=["resnet", "keypoints",
                                                     "swin"])
def test_cli_faster_rcnn_writes_the_stats_json(argv, iou_types, tmp_path):
    """``--test --device cpu --head faster_rcnn --epochs 1``: the JAX
    CLI's stats JSON (the 12 bbox numbers, the 10 keypoint numbers with
    ``--keypoints``), a finite loss, the JAX CLI's tiny settings."""
    fp = str(tmp_path / "stats.json")
    record = cli_coco.main(["--test", "--device", "cpu", "--head",
                            "faster_rcnn", "--epochs", "1", "--limit_test",
                            "8", "--no_initial_eval", "--stats_fp", fp]
                           + argv)
    assert record["telem"]["completed"] is True
    d = json.load(open(fp))
    val = d["logs"][0]["val"]
    assert list(val) == iou_types and len(val["bbox"]) == 12
    if "keypoints" in val:
        assert list(val["keypoints"]) == [
            "ap", "ap50", "ap75", "apm", "apl", "ar", "ar50", "ar75", "arm",
            "arl"]
        assert "loss_keypoint" in d["logs"][0]["train"]
    assert np.isfinite(d["logs"][0]["train"]["loss_total"])
    assert d["info"]["backbone"] == (argv[1] if argv[:1] == ["--backbone"]
                                     else "resnet_test")
    assert d["info"]["image_size"] == 64


@pytest.mark.parametrize("argv,words", [
    (["--keypoints"], "--keypoints requires --head faster_rcnn"),
    (["--head", "faster_rcnn", "--keypoints", "--masks"],
     "--keypoints cannot be combined"),
    (["--head", "faster_rcnn", "--panoptic_root", "p"],
     "--panoptic_root requires --head detr"),
    (["--head", "faster_rcnn", "--masks"], "--masks requires --head detr")])
def test_cli_refuses_the_jax_combinations(argv, words, tmp_path,
                                          monkeypatch):
    from vit_torch_tpu_torch.detection import coco_data
    monkeypatch.setattr(coco_data, "make_synthetic_coco", None)
    fp = tmp_path / "s.json"
    with pytest.raises(SystemExit, match=words):
        cli_coco.main(["--test", "--device", "cpu", "--stats_fp", str(fp)]
                      + argv)
    assert not fp.exists()


def test_cli_dtype_by_route():
    """bf16 by default on CUDA; float32 on CUDA refused on the routes with
    the bf16-only kernels (DETR, Faster R-CNN over Swin), taken by
    Faster R-CNN over a ResNet."""
    cuda = torch.device("cuda")
    parse = cli_coco.get_args_parser().parse_args
    args = parse(["--head", "faster_rcnn", "--backbone", "resnext50_32x4d",
                  "--dtype", "float32"])
    assert cli_coco._dtype(args, cuda) == torch.float32
    args = parse(["--head", "faster_rcnn"])
    assert cli_coco._dtype(args, cuda) == torch.bfloat16
    args.dtype = "float32"
    with pytest.raises(ValueError, match="bfloat16"):
        cli_coco._dtype(args, cuda)
