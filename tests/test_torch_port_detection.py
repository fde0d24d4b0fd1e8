"""Port parity: the detection data and matching path against the JAX
package, on the CPU.

Box ops and GIoU; ``COCOeval`` bbox on the perfect, empty and
half-shifted cases of ``tests/test_detection.py`` and on a random set
with crowd gts (all 12 numbers); the numpy Hungarian against
``scipy.optimize.linear_sum_assignment`` (equal total cost) and the JAX
``hungarian_match``; ``cost_matrices``; the three train transforms with
the JAX draws fed into the port's arithmetic, the zoom-crop's resampled
pixels too; the synthetic set and the letterbox loader's batches.  Inputs come from numpy with a seed; each
JAX function is traced once in the file.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from vit_torch_tpu.detection import boxes as jax_boxes
from vit_torch_tpu.detection import coco_data as jax_data
from vit_torch_tpu.detection import coco_eval as jax_eval
from vit_torch_tpu.detection import matcher as jax_matcher
from vit_torch_tpu.detection import transforms as jax_tf
from vit_torch_tpu_torch.detection import boxes, coco_data, coco_eval
from vit_torch_tpu_torch.detection import matcher, transforms
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# fp32 box arithmetic on values of order 1-100: summation order only
BOX_ATOL = 1e-5
# the COCO numbers are float64 means of the same matches; the JAX package
# takes its IoU from the native library, the port from numpy
STATS_ATOL = 1e-12
# the zoom-crop's resample: a sample coordinate of order S = 48 carries
# fp32 rounding of ~4e-6 (XLA may fuse its multiply-adds) into the
# triangle weights of both axes, times pixel values up to 255
RESAMPLE_ATOL = 5e-3


def _rand_xyxy(rng, shape, size=1.0):
    xy = rng.random(shape + (2,)) * size * 0.7
    wh = rng.random(shape + (2,)) * size * 0.3 + 1e-3
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@jax.jit
def _jax_box_ops(a, b):
    return {"iou": jax_boxes.box_iou(a, b),
            "giou": jax_boxes.generalized_box_iou(a, b),
            "area": jax_boxes.box_area(a),
            "cxcywh": jax_boxes.xyxy_to_cxcywh(a),
            "back": jax_boxes.cxcywh_to_xyxy(jax_boxes.xyxy_to_cxcywh(a)),
            "xywh": jax_boxes.xyxy_to_xywh(a)}


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _rand_xyxy(rng, (3, 7)), _rand_xyxy(rng, (3, 5))
    b[0, 0] = a[0, 0]                       # one identical pair
    b[1, 1] = [5.0, 5.0, 6.0, 6.0]          # one disjoint box
    want = _jax_box_ops(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = {"iou": boxes.box_iou(ta, tb),
           "giou": boxes.generalized_box_iou(ta, tb),
           "area": boxes.box_area(ta), "cxcywh": boxes.xyxy_to_cxcywh(ta),
           "back": boxes.cxcywh_to_xyxy(boxes.xyxy_to_cxcywh(ta)),
           "xywh": boxes.xyxy_to_xywh(ta)}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   atol=BOX_ATOL, rtol=0, err_msg=k)
    assert float(got["iou"][0, 0, 0]) == pytest.approx(1.0)
    assert float(got["giou"][1, 1, 1]) < 0


# -- COCO evaluation --------------------------------------------------------

def _toy_dataset():
    """``tests/test_detection.py``'s toy ground truth."""
    return {
        "images": [{"id": 1, "height": 100, "width": 100},
                   {"id": 2, "height": 100, "width": 100}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 1,
             "bbox": [10, 10, 20, 20], "area": 400, "iscrowd": 0},
            {"id": 2, "image_id": 1, "category_id": 2,
             "bbox": [50, 50, 20, 20], "area": 400, "iscrowd": 0},
            {"id": 3, "image_id": 2, "category_id": 1,
             "bbox": [30, 30, 40, 40], "area": 1600, "iscrowd": 0}],
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}


def _toy_case(name):
    data = _toy_dataset()
    dts = []
    for a in data["annotations"]:
        x, y, w, h = a["bbox"]
        if name == "perfect":
            dts.append({"image_id": a["image_id"],
                        "category_id": a["category_id"], "bbox": a["bbox"],
                        "score": 0.9})
        elif name == "half_shifted":
            dts.append({"image_id": a["image_id"],
                        "category_id": a["category_id"],
                        "bbox": [x + w * 0.4, y, w, h], "score": 0.9})
    return data, dts


def _random_case(seed=0):
    """12 images of 200 px, 3 classes, 0-6 gts each (a sixth of them
    crowd regions, all sizes), and 0-12 scored detections each, some near
    a gt and some anywhere."""
    rng = np.random.default_rng(seed)
    images, anns, dts = [], [], []
    for i in range(1, 13):
        images.append({"id": i, "height": 200, "width": 200})
        gts = []
        for _ in range(int(rng.integers(0, 7))):
            w, h = rng.uniform(4, 120, 2)
            x, y = rng.uniform(0, 200 - w), rng.uniform(0, 200 - h)
            gts.append([float(x), float(y), float(w), float(h)])
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.integers(1, 4)),
                         "bbox": gts[-1], "area": float(w * h * 0.9),
                         "iscrowd": int(rng.random() < 1 / 6)})
        for _ in range(int(rng.integers(0, 13))):
            if gts and rng.random() < 0.6:
                x, y, w, h = gts[int(rng.integers(len(gts)))]
                box = [x + rng.normal(0, w * 0.1), y + rng.normal(0, h * 0.1),
                       w * rng.uniform(0.8, 1.2), h * rng.uniform(0.8, 1.2)]
            else:
                w, h = rng.uniform(4, 120, 2)
                box = [rng.uniform(0, 200 - w), rng.uniform(0, 200 - h), w, h]
            dts.append({"image_id": i,
                        "category_id": int(rng.integers(1, 4)),
                        "bbox": [float(v) for v in box],
                        "score": float(rng.random())})
    cats = [{"id": c, "name": str(c)} for c in (1, 2, 3)]
    return {"images": images, "annotations": anns, "categories": cats}, dts


@pytest.mark.parametrize("case", ["perfect", "empty", "half_shifted",
                                  "random_crowd"])
def test_cocoeval_bbox_matches_jax(case):
    data, dts = (_random_case() if case == "random_crowd"
                 else _toy_case(case))
    stats = []
    for mod in (jax_eval, coco_eval):
        gt = mod.COCO(dataset=json.loads(json.dumps(data)))
        ev = mod.COCOeval(gt, gt.load_res(json.loads(json.dumps(dts))),
                          "bbox")
        ev.evaluate()
        ev.accumulate()
        stats.append(ev.summarize())
    want, got = stats
    np.testing.assert_allclose(got, want, atol=STATS_ATOL, rtol=0)
    if case == "perfect":
        assert got[0] > 0.99 and got[1] > 0.99
    elif case == "empty":
        assert got[0] <= 0.0
    elif case == "half_shifted":
        assert got[0] < 0.2
    else:
        assert 0.0 < got[0] < 1.0


def test_coco_evaluator_matches_jax():
    """xyxy predictions in, the named 12 numbers out, as the JAX
    evaluator gives them."""
    data, dts = _random_case(seed=1)
    outs = []
    for mod in (jax_eval, coco_eval):
        evaluator = mod.CocoEvaluator(mod.COCO(dataset=data), ["bbox"])
        for img in data["images"]:
            mine = [d for d in dts if d["image_id"] == img["id"]]
            xywh = np.asarray([d["bbox"] for d in mine]).reshape(-1, 4)
            evaluator.update({img["id"]: {
                "boxes": np.concatenate([xywh[:, :2],
                                         xywh[:, :2] + xywh[:, 2:]], 1),
                "scores": np.asarray([d["score"] for d in mine]),
                "labels": np.asarray([d["category_id"] for d in mine])}})
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        outs.append(evaluator.summarize())
    want, got = outs
    assert list(got["bbox"]) == coco_eval.CocoEvaluator.METRIC_KEYS
    for k in want["bbox"]:
        assert got["bbox"][k] == pytest.approx(want["bbox"][k],
                                               abs=STATS_ATOL)


def test_bbox_iou_matches_jax_mask_library():
    from vit_torch_tpu.detection import _mask
    rng = np.random.default_rng(2)
    dt = rng.uniform(1, 50, (9, 4))
    gt = rng.uniform(1, 50, (6, 4))
    crowd = [0, 1, 0, 0, 1, 0]
    np.testing.assert_allclose(coco_eval.bbox_iou(dt, gt, crowd),
                               _mask.iou(dt, gt, crowd), atol=1e-12)
    assert coco_eval.bbox_iou(dt[:0], gt, crowd).shape == (0, 6)


# -- matcher ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (8, 3), (3, 8), (100, 7),
                                   (7, 100), (40, 40), (100, 64)])
def test_hungarian_reaches_scipys_optimum(shape):
    rng = np.random.default_rng(sum(shape))
    for trial in range(5):
        cost = rng.standard_normal(shape)
        if trial % 2:
            cost = np.round(cost, 1)           # ties
        rows, cols = matcher.linear_sum_assignment(cost)
        r2, c2 = scipy_lsa(cost)
        assert len(rows) == min(shape)
        assert len(set(rows.tolist())) == len(rows)
        assert len(set(cols.tolist())) == len(cols)
        assert (np.diff(rows) > 0).all()
        assert cost[rows, cols].sum() == pytest.approx(cost[r2, c2].sum(),
                                                       abs=1e-9)


def test_hungarian_refuses_non_finite_costs():
    with pytest.raises(ValueError, match="inf or nan"):
        matcher.linear_sum_assignment(np.asarray([[0.0, np.nan]]))


def test_hungarian_match_matches_jax():
    """The JAX unit cases assign the same slots; a random (B, Q, N) cost
    with non-prefix masks reaches the same total cost per image."""
    cost = np.asarray([[[0.1, 5.0], [5.0, 0.2], [9.0, 9.0]]])
    mask = np.asarray([[1.0, 1.0]])
    np.testing.assert_array_equal(matcher.hungarian_match(cost, mask),
                                  jax_matcher.hungarian_match(cost, mask))
    cost = np.asarray([[[0.1, 5.0, 4.0], [5.0, 0.2, 0.3], [9.0, 9.0, 0.1]]],
                      np.float32)
    mask = np.asarray([[1.0, 0.0, 1.0]])
    got = matcher.hungarian_match(cost, mask)
    np.testing.assert_array_equal(got, jax_matcher.hungarian_match(cost,
                                                                   mask))
    assert 1 not in got[0]
    rng = np.random.default_rng(3)
    cost = rng.random((4, 20, 9)).astype(np.float32)
    mask = (rng.random((4, 9)) < 0.6).astype(np.float32)
    mask[3] = 0.0                                  # an image with no gt
    got = matcher.hungarian_match(cost, mask)
    want = jax_matcher.hungarian_match(cost, mask)
    for b in range(4):
        total = [sum(cost[b, q, a[b, q]] for q in range(20) if a[b, q] >= 0)
                 for a in (got, want)]
        assert total[0] == pytest.approx(total[1], abs=1e-6)
        assert sorted(got[b][got[b] >= 0]) == list(np.flatnonzero(mask[b]))
    assert (got[3] == -1).all()


@jax.jit
def _jax_costs(logits, pred, labels, gt, mask):
    return jax_matcher.cost_matrices(logits, pred, labels, gt, mask)


def test_cost_matrices_match_jax():
    rng = np.random.default_rng(4)
    B, Q, N, K = 2, 10, 6, 4
    logits = rng.standard_normal((B, Q, K + 1)).astype(np.float32)
    pred = rng.uniform(0.1, 0.9, (B, Q, 4)).astype(np.float32)
    gt = rng.uniform(0.1, 0.9, (B, N, 4)).astype(np.float32)
    labels = rng.integers(1, K + 1, (B, N)).astype(np.int32)
    mask = np.asarray([[1, 1, 0, 1, 0, 0], [1, 0, 1, 1, 1, 1]], np.float32)
    want = np.asarray(_jax_costs(*(jnp.asarray(x) for x in (
        logits, pred, labels, gt, mask))))
    got = matcher.cost_matrices(*(torch.from_numpy(x) for x in (
        logits, pred, labels, gt, mask)))
    assert got.dtype == torch.float32 and got.shape == (B, Q, N)
    np.testing.assert_allclose(got.numpy(), want, atol=BOX_ATOL, rtol=1e-6)
    assert (got.numpy()[mask[:, None, :].repeat(Q, 1) == 0] == 1e9).all()


# -- transforms -------------------------------------------------------------

S = 48                          # canvas side of the transform tests


def _resample(images, zoom, off):
    """The JAX zoom-crop's resample in fp32 (its ``resample_one``)."""
    def one(img, z, o):
        return jax.image.scale_and_translate(
            img.astype(jnp.float32), img.shape, (0, 1), jnp.asarray([z, z]),
            jnp.asarray([-o[0] * z, -o[1] * z]), method="linear")
    return jax.vmap(one)(images, zoom, off)


@jax.jit
def _jax_transforms(key, images, bxs, box_mask):
    """Each transform on the same batch, with the draws it made (split as
    the JAX functions split their keys)."""
    k_flip, k_crop, k_erase = jax.random.split(key, 3)
    B = images.shape[0]
    flip = jax.random.bernoulli(k_flip, 0.5, (B,))
    f_images, f_boxes, _ = jax_tf.random_hflip(k_flip, images, bxs, S)
    r_apply, r_scale, r_off = jax.random.split(k_crop, 3)
    s = jax.random.uniform(r_scale, (B,), minval=0.6, maxval=1.0)
    w = s * S
    crop = {"apply": jax.random.bernoulli(r_apply, 0.5, (B,)),
            "zoom": S / w,
            "off": jax.random.uniform(r_off, (B, 2), maxval=1.0)
            * (S - w[:, None])}
    c_images, c_boxes, c_mask, _ = jax_tf.random_zoom_crop(
        k_crop, images, bxs, box_mask, S)
    e_apply, e_area, e_ratio, e_pos = jax.random.split(k_erase, 4)
    erase = {"apply": jax.random.bernoulli(e_apply, 0.5, (B,)),
             "area": jax.random.uniform(e_area, (B,), minval=0.02,
                                        maxval=0.33),
             "log_ratio": jax.random.uniform(
                 e_ratio, (B,), minval=jnp.log(0.3), maxval=jnp.log(3.3)),
             "pos": jax.random.uniform(e_pos, (B, 2))}
    value = [255.0 * m for m in (0.485, 0.456, 0.406)]
    e_images = jax_tf.random_erasing(k_erase, images, value=value)
    return {"flip": flip, "f_images": f_images, "f_boxes": f_boxes,
            "crop": crop, "resampled": _resample(images, crop["zoom"],
                                                 crop["off"]),
            "c_images": c_images, "c_boxes": c_boxes, "c_mask": c_mask,
            "erase": erase, "e_images": e_images}


@pytest.fixture(scope="module")
def transform_case():
    rng = np.random.default_rng(5)
    B = 8
    images = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    bxs = _rand_xyxy(rng, (B, 5), size=S)
    box_mask = (rng.random((B, 5)) < 0.8).astype(np.float32)
    # boxes the crop cuts down to a sliver or out of the window
    bxs[:, 0] = [0.0, 0.0, 2.0, 2.0]
    bxs[:, 1] = [S - 3.0, S - 3.0, S - 0.5, S - 0.5]
    want = jax.tree.map(np.asarray, _jax_transforms(
        jax.random.PRNGKey(7), jnp.asarray(images), jnp.asarray(bxs),
        jnp.asarray(box_mask)))
    assert 0 < want["crop"]["apply"].sum() < B        # both branches taken
    return images, bxs, box_mask, want


def _t(x):
    return torch.from_numpy(np.array(x))


def test_hflip_with_jax_draws(transform_case):
    images, bxs, _, want = transform_case
    got_images, got_boxes = transforms.apply_hflip(
        _t(want["flip"]), _t(images), _t(bxs), S)
    np.testing.assert_array_equal(got_images.numpy(), want["f_images"])
    np.testing.assert_allclose(got_boxes.numpy(), want["f_boxes"], atol=0)


def test_zoom_crop_with_jax_draws(transform_case):
    """The resampled pixels in fp32, the uint8 images (the cast truncates,
    so a sum that lands within rounding of an integer may move by one),
    the boxes and the mask of the boxes the crop keeps."""
    images, bxs, box_mask, want = transform_case
    crop = {k: _t(v) for k, v in want["crop"].items()}
    resampled = transforms.resample_linear(_t(images), crop["zoom"],
                                           crop["off"])
    np.testing.assert_allclose(resampled.numpy(), want["resampled"],
                               atol=RESAMPLE_ATOL, rtol=0)
    got_images, got_boxes, got_mask = transforms.apply_zoom_crop(
        crop, _t(images), _t(bxs), _t(box_mask), S)
    diff = np.abs(got_images.numpy().astype(int)
                  - want["c_images"].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(got_boxes.numpy(), want["c_boxes"],
                               atol=BOX_ATOL, rtol=0)
    np.testing.assert_array_equal(got_mask.numpy(), want["c_mask"])
    assert (got_mask.numpy() < box_mask).any()      # a crop dropped a box


def test_erasing_with_jax_draws(transform_case):
    images, _, _, want = transform_case
    got = transforms.apply_erasing(
        {k: _t(v) for k, v in want["erase"].items()}, _t(images),
        value=[255.0 * m for m in (0.485, 0.456, 0.406)])
    np.testing.assert_array_equal(got.numpy(), want["e_images"])


def test_random_transforms_draw_from_the_generator():
    """One seed, one result; another seed, another; shapes and dtypes
    kept."""
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.integers(0, 256, (6, S, S, 3),
                                           dtype=np.uint8))
    bxs = torch.from_numpy(_rand_xyxy(rng, (6, 4), size=S))
    mask = torch.ones((6, 4))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        im, bx = transforms.random_hflip(g, images, bxs, S)
        im, bx, bm = transforms.random_zoom_crop(g, im, bx, mask, S)
        return transforms.random_erasing(g, im, value=[1.0, 2.0, 3.0]), bx, bm

    a, b, c = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.uint8 and a[0].shape == images.shape


# -- data -------------------------------------------------------------------

def test_synthetic_set_and_loader_match_jax(tmp_path):
    """The same seed writes the same files, and the letterbox loader's
    shuffled batches (the last one padded) are equal array for array."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    j_img, j_ann = jax_data.make_synthetic_coco(str(jdir), n_images=7,
                                                size=80, seed=3)
    p_img, p_ann = coco_data.make_synthetic_coco(str(pdir), n_images=7,
                                                 size=80, seed=3)
    assert json.load(open(j_ann)) == json.load(open(p_ann))
    names = sorted(os.listdir(j_img))
    assert names == sorted(os.listdir(p_img)) and len(names) == 7
    assert all(filecmp.cmp(os.path.join(j_img, n), os.path.join(p_img, n),
                           shallow=False) for n in names)
    kw = dict(image_size=96, max_boxes=4)
    j_ds = jax_data.CocoDetectionDataset(j_img, j_ann, **kw)
    p_ds = coco_data.CocoDetectionDataset(p_img, p_ann, **kw)
    assert (p_ds.label_to_cat, p_ds.num_classes) == (j_ds.label_to_cat,
                                                     j_ds.num_classes)
    j_batches = list(jax_data.CocoLoader(j_ds, 3, shuffle=True, seed=1))
    p_batches = list(coco_data.CocoLoader(p_ds, 3, shuffle=True, seed=1))
    assert len(p_batches) == len(j_batches) == 3
    for jb, pb in zip(j_batches, p_batches):
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert p_batches[-1]["mask"].tolist() == [1.0, 0.0, 0.0]
    assert coco_data.letterbox_params(60, 80, 96) == \
        jax_data.letterbox_params(60, 80, 96)


def test_loader_serial_and_threaded_agree(tmp_path):
    img, ann = coco_data.make_synthetic_coco(str(tmp_path), n_images=5,
                                             size=40)
    ds = coco_data.CocoDetectionDataset(img, ann, image_size=48, max_boxes=3,
                                        category_ids=[1, 2])
    serial = list(coco_data.CocoLoader(ds, 2, num_workers=0))
    threaded = list(coco_data.CocoLoader(ds, 2))
    for a, b in zip(serial, threaded):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    first = next(iter(coco_data.CocoLoader(ds, 2)))   # an early stop
    assert first["image"].shape == (2, 48, 48, 3)
    assert set(np.unique(np.concatenate(
        [b["labels"] for b in serial]))) <= {0, 1, 2}
