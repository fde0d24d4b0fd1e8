"""Port parity: the Keypoint R-CNN pieces and the keypoint data and
evaluation against the JAX package, on the CPU.

The keypoint head with its weights through ``state_dict_from_jax`` (the
transposed conv's kernel flipped in space), the heatmap targets (the far
box edge too), the heatmap loss and the decode; the flip index swap from
keypoint names; the horizontal flip of keypoints on the JAX draw; the
synthetic set with keypoints (JSON and pixels) and the loader's
``gt_keypoints``; ``COCOeval("keypoints")``, its OKS matrices and its 10
numbers, on the synthetic set with perturbed predictions, and the
evaluator.  Inputs come from numpy with a seed; fp32 unless stated.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection import coco_data as jax_data
from vit_torch_tpu.detection import coco_eval as jax_eval
from vit_torch_tpu.detection import keypoint as jk
from vit_torch_tpu.detection import transforms as jax_tf
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.detection import coco_data, coco_eval
from vit_torch_tpu_torch.detection import keypoint as pk
from vit_torch_tpu_torch.detection import transforms
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# fp32 heatmaps after two 3x3 convs and the deconv: summation order
HEAD_RTOL = 1e-5
# the decoded keypoints: fp32 pixel coordinates of order 60
DECODE_ATOL = 1e-4
# the COCO numbers are float64 means of the same matches
STATS_ATOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_keypoint_head_matches_jax_through_the_importer():
    """``KeypointHead`` (two 3x3 convs, the 4x4 stride-2 transposed conv,
    bilinear x2) with the JAX head's weights: the importer flips the
    transposed conv's kernel in space, which ``F.conv_transpose2d``
    needs to compute flax's ``ConvTranspose(padding="SAME")``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 7, 12)).astype(np.float32)
    head = jk.KeypointHead(5, (16, 8))
    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3)
                          .astype(np.float32), shapes)["params"]
    want = np.asarray(jax.jit(lambda p, x: head.apply({"params": p}, x))(
        params, x))
    port = pk.KeypointHead(12, 5, (16, 8))
    sd = state_dict_from_jax({"kp_head": params})
    port.load_state_dict({k[len("kp_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == want.shape == (2, 3, 28, 28, 5)
    assert _rel(got, want) < HEAD_RTOL
    # without the flip no crop of the transposed conv matches
    port.deconv.weight.data = port.deconv.weight.data.flip(2, 3)
    with torch.no_grad():
        assert _rel(port(_t(x)), want) > 0.1


def _kp_case(seed=1, R=6, K=5, HM=8):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (2, R, 2))
    wh = rng.uniform(4, 20, (2, R, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    kxy = xy[:, :, None] + rng.uniform(-0.2, 1.2, (2, R, K, 2)) \
        * wh[:, :, None]
    kv = rng.integers(0, 3, (2, R, K, 1))
    kps = np.concatenate([kxy, kv], -1).astype(np.float32)
    kps[0, 0, 0, :2] = boxes[0, 0, 2:]          # the far corner: last bin
    kps[0, 0, 0, 2] = 2
    kps[1, 2, 1, 0] = boxes[1, 2, 2]            # the far x edge
    kps[1, 2, 1, 2] = 1
    logits = (3 * rng.standard_normal((2, R, HM, HM, K))).astype(np.float32)
    weights = (rng.random((2, R)) < 0.7).astype(np.float32)
    return boxes, kps, logits, weights


def test_heatmap_targets_loss_and_decode_match_jax():
    """Heatmap targets and validity exactly (keypoints on the far box
    edge take the last bin and stay valid); the per-image heatmap CE over
    the weighted RoIs; the 3x3 soft-argmax decode."""
    boxes, kps, logits, weights = _kp_case()
    HM = logits.shape[2]

    @jax.jit
    def jax_side(kps, boxes, logits, weights):
        return (jk.keypoints_to_heatmap_targets(kps, boxes, HM),
                jax.vmap(jk.keypoint_loss)(logits, boxes, kps, weights),
                jk.heatmaps_to_keypoints(logits, boxes))

    (want_idx, want_valid), want_loss, want_kps = jax_side(
        kps, boxes, logits, weights)
    idx, valid = pk.keypoints_to_heatmap_targets(_t(kps), _t(boxes), HM)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert valid[0, 0, 0] == 1 and idx[0, 0, 0] == HM * HM - 1
    assert valid[1, 2, 1] == 1 and idx[1, 2, 1] % HM == HM - 1
    want = np.asarray(want_loss)
    got = pk.keypoint_loss(_t(logits), _t(boxes), _t(kps), _t(weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = pk.keypoint_loss(_t(logits[1]), _t(boxes[1]), _t(kps[1]),
                           _t(weights[1]))
    assert one.shape == () and one.item() == pytest.approx(want[1],
                                                           rel=1e-6)
    want = np.asarray(want_kps)
    got = pk.heatmaps_to_keypoints(_t(logits), _t(boxes)).numpy()
    assert got.shape == (2, 6, 5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("names", [
    ["nose", "left_eye", "right_eye", "left_ear", "right_ear",
     "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
     "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
     "right_knee", "left_ankle", "right_ankle"],
    ["tl", "tr", "center", "bl", "br"],
    ["ankle_l", "ankle_r", "head", "lshoulder", "rshoulder"],
    ["a", "b", "c"],
    ["left_x", "right_y", ""]], ids=["coco17", "corners", "tokens",
                                     "mirror_free", "no_pairs"])
def test_kp_flip_inds_from_names_match_jax(names):
    got = pk.kp_flip_inds_from_names(names)
    assert got == jk.kp_flip_inds_from_names(names)
    assert all(got[j] == i for i, j in enumerate(got))   # an involution
    if len(names) == 17:
        assert got == pk.COCO_KP_FLIP_INDS == jk.COCO_KP_FLIP_INDS


def test_hflip_keypoints_with_the_jax_draw():
    """The per-sample flip of images, boxes and (B, N, K, 3) keypoints
    (x mirrored about S, the K axis swapped) on the JAX package's draw."""
    rng = np.random.default_rng(2)
    S, B = 16, 6
    images = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    bxs = np.sort(rng.uniform(0, S, (B, 3, 4)), -1).astype(np.float32)
    kps = np.concatenate([rng.uniform(0, S, (B, 3, 5, 2)),
                          rng.integers(0, 3, (B, 3, 5, 1))],
                         -1).astype(np.float32)
    inds = (1, 0, 2, 4, 3)
    key = jax.random.PRNGKey(5)
    want = jax_tf.random_hflip(key, jnp.asarray(images), jnp.asarray(bxs), S,
                               keypoints=jnp.asarray(kps),
                               kp_flip_inds=inds)
    flip = _t(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < int(flip.sum()) < B
    got = transforms.apply_hflip(flip, _t(images), _t(bxs), S, _t(kps),
                                 inds)
    for g, w in zip(got, (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # without a swap the K order stays; the generator's own draw
    g = torch.Generator().manual_seed(0)
    im, bx, kp = transforms.random_hflip(g, _t(images), _t(bxs), S,
                                         keypoints=_t(kps))
    assert kp.shape == kps.shape


def test_synthetic_keypoint_set_and_loader_match_jax(tmp_path):
    """``make_synthetic_coco(keypoints=True)`` writes the JAX package's
    JSON and pixels; the loader's ``gt_keypoints`` (and every other key)
    equal the JAX loader's; the schema's names and count."""
    j_img, j_ann = jax_data.make_synthetic_coco(str(tmp_path / "jax"),
                                                n_images=5, size=80, seed=4,
                                                keypoints=True)
    p_img, p_ann = coco_data.make_synthetic_coco(str(tmp_path / "port"),
                                                 n_images=5, size=80, seed=4,
                                                 keypoints=True)
    assert open(j_ann).read() == open(p_ann).read()
    names = sorted(os.listdir(j_img))
    assert names == sorted(os.listdir(p_img)) and len(names) == 5
    assert all(filecmp.cmp(os.path.join(j_img, n), os.path.join(p_img, n),
                           shallow=False) for n in names)
    kw = dict(image_size=96, max_boxes=4, load_keypoints=True)
    j_ds = jax_data.CocoDetectionDataset(j_img, j_ann, **kw)
    p_ds = coco_data.CocoDetectionDataset(p_img, p_ann, **kw)
    assert (p_ds.num_keypoints, p_ds.kp_names) == (
        j_ds.num_keypoints, j_ds.kp_names) == (5, ["tl", "tr", "center",
                                                   "bl", "br"])
    j_batches = list(jax_data.CocoLoader(j_ds, 2, shuffle=True, seed=1))
    p_batches = list(coco_data.CocoLoader(p_ds, 2, shuffle=True, seed=1))
    for jb, pb in zip(j_batches, p_batches):
        assert sorted(jb) == sorted(pb) and "gt_keypoints" in pb
        for k in jb:
            assert jb[k].dtype == pb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    # no names in the categories: COCO's 17
    data = json.load(open(p_ann))
    for cat in data["categories"]:
        del cat["keypoints"]
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(data))
    ds = coco_data.CocoDetectionDataset(p_img, str(bare), **kw)
    assert (ds.num_keypoints, ds.kp_names) == (17, [])
    assert ds[0]["gt_keypoints"].shape == (4, 17, 3)


def _kp_results(ann_file, seed=6, drop_bbox=False):
    """Perturbed predictions of the synthetic set's gts: each gt found
    with jittered keypoints (some far off), a spurious detection per
    image, scores at random; optionally without their boxes."""
    rng = np.random.default_rng(seed)
    data = json.load(open(ann_file))
    res = []
    for ann in data["annotations"]:
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        kp[:, :2] += rng.normal(0, rng.choice([0.5, 2.0, 8.0]), (len(kp), 2))
        r = {"image_id": ann["image_id"], "category_id": ann["category_id"],
             "keypoints": kp.reshape(-1).tolist(),
             "score": float(rng.random())}
        if not drop_bbox:
            x, y, w, h = ann["bbox"]
            r["bbox"] = [x + rng.normal(0, 1), y + rng.normal(0, 1), w, h]
        res.append(r)
    for img in data["images"]:
        kp = np.concatenate([rng.uniform(0, 80, (5, 2)), np.ones((5, 1))],
                            -1)
        r = {"image_id": img["id"], "category_id": 1, "score": 0.3,
             "keypoints": kp.reshape(-1).tolist()}
        if not drop_bbox:
            r["bbox"] = [10.0, 10.0, 30.0, 30.0]
        res.append(r)
    return res


@pytest.mark.parametrize("drop_bbox", [False, True], ids=["boxes",
                                                          "kp_extent"])
def test_cocoeval_keypoints_matches_jax(drop_bbox, tmp_path):
    """``COCOeval(..., "keypoints")`` on the synthetic keypoint set (a gt
    with no labelled keypoint among them, ignored; 0.05 sigmas for its
    five keypoints) and perturbed predictions: every image's OKS matrix
    and the 10 numbers equal the JAX evaluator's; results without a bbox
    take it from their keypoints' extent."""
    _, ann = coco_data.make_synthetic_coco(str(tmp_path), n_images=12,
                                           size=80, seed=5, keypoints=True)
    data = json.load(open(ann))
    a = data["annotations"][0]
    a["keypoints"] = [v if i % 3 != 2 else 0 for i, v in
                      enumerate(a["keypoints"])]
    a["num_keypoints"] = 0
    res = _kp_results(ann, drop_bbox=drop_bbox)
    evs = []
    for mod in (jax_eval, coco_eval):
        gt = mod.COCO(dataset=json.loads(json.dumps(data)))
        ev = mod.COCOeval(gt, gt.load_res(json.loads(json.dumps(res))),
                          "keypoints")
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evs.append(ev)
    jev, pev = evs
    assert (pev.max_dets, pev.area_lbl) == ([20], ["all", "medium",
                                                   "large"])
    for key, want in jev._ious.items():
        got = pev._compute_iou(*key)
        np.testing.assert_allclose(got, want, rtol=0, atol=STATS_ATOL)
    assert pev.stats.shape == (10,) and 0 < pev.stats[0] < 1
    np.testing.assert_allclose(pev.stats, jev.stats, rtol=0,
                               atol=STATS_ATOL)
    if drop_bbox:
        r = pev.coco_dt.anns[1]
        kp = np.asarray(r["keypoints"]).reshape(-1, 3)
        assert r["bbox"][2] == pytest.approx(kp[:, 0].max() - kp[:, 0].min())


def test_coco_evaluator_keypoints_match_jax(tmp_path):
    """``CocoEvaluator(("bbox", "keypoints")).update`` with ``keypoints``
    (N, K, 3) per image: both summaries equal the JAX evaluator's, under
    ``KP_METRIC_KEYS`` for the keypoints."""
    _, ann = coco_data.make_synthetic_coco(str(tmp_path), n_images=6,
                                           size=80, seed=7, keypoints=True)
    res = _kp_results(ann, seed=8)
    preds = {}
    for r in res:
        p = preds.setdefault(r["image_id"], {"boxes": [], "scores": [],
                                             "labels": [], "keypoints": []})
        x, y, w, h = r["bbox"]
        p["boxes"].append([x, y, x + w, y + h])
        p["scores"].append(r["score"])
        p["labels"].append(r["category_id"])
        p["keypoints"].append(np.asarray(r["keypoints"]).reshape(-1, 3))
    out = []
    for mod in (jax_eval, coco_eval):
        ev = mod.CocoEvaluator(mod.COCO(ann), ("bbox", "keypoints"))
        for img_id, p in preds.items():
            ev.update({img_id: {k: np.asarray(v) for k, v in p.items()}})
        ev.accumulate()
        out.append(ev.summarize())
    assert list(out[1]["keypoints"]) == coco_eval.CocoEvaluator.KP_METRIC_KEYS
    for t in ("bbox", "keypoints"):
        for k, v in out[0][t].items():
            assert out[1][t][k] == pytest.approx(v, abs=STATS_ATOL), (t, k)


def test_synthetic_set_at_the_card_size_has_keypoint_ground_truth(tmp_path):
    """chip_smoke's keypoint set (512 px pictures letterboxed to 512):
    every picture has a box whose five keypoints all lie inside it, so
    that its keypoint AP has ground truth to score."""
    img, ann = coco_data.make_synthetic_coco(str(tmp_path), n_images=32,
                                             size=512, seed=1,
                                             keypoints=True)
    ds = coco_data.CocoDetectionDataset(img, ann, image_size=512,
                                        load_keypoints=True)
    for i in range(len(ds)):
        d = ds[i]
        b, k = d["boxes"][:, None], d["gt_keypoints"]
        inside = ((k[..., 0] >= b[..., 0]) & (k[..., 0] <= b[..., 2])
                  & (k[..., 1] >= b[..., 1]) & (k[..., 1] <= b[..., 3])
                  & (k[..., 2] > 0)).all(-1) & (d["box_mask"] > 0)
        assert inside.any(), i
