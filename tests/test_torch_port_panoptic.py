"""Port parity: panoptic quality, the panoptic-PNG dataset and
``cli.coco --panoptic_root`` against the JAX package, on the CPU.

``PQStat`` on the cases of ``tests/test_panoptic.py`` and on random maps
with crowd, void and class-mismatch segments; ``masks_to_segment_map``;
``rgb2id``/``id2rgb`` and ``masks_to_boxes``; the synthetic panoptic
writer (the same files from the same seed); ``CocoPanopticDataset``'s
items, ``instance_gt`` and ``pq_ground_truth``; and the CLI on a written
split.  numpy and PIL on both sides: nothing here traces JAX.
"""

import filecmp
import json
import os

import numpy as np
import pytest

from vit_torch_tpu.detection import panoptic_data as jax_pan
from vit_torch_tpu.detection import panoptic_eval as jax_pq
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.detection import panoptic_data, panoptic_eval
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()


def _rect_map(shape, rects):
    m = np.zeros(shape, np.int32)
    for sid, (y0, x0, y1, x1) in rects.items():
        m[y0:y1, x0:x1] = sid
    return m


def _pq_cases():
    """(gt_map, gt_segments, pred_map, pred_segments, crowd_ids) cases."""
    S = (32, 32)
    gt = _rect_map(S, {1: (0, 0, 16, 16), 2: (16, 16, 32, 32),
                       3: (0, 20, 10, 30)})
    cases = {
        "perfect": (gt, {1: 1, 2: 2, 3: 1}, gt, {1: 1, 2: 2, 3: 1}, ()),
        "partial_and_miss": (gt, {1: 1, 2: 2, 3: 1},
                             _rect_map(S, {5: (0, 0, 14, 16),
                                           6: (20, 0, 30, 8)}),
                             {5: 1, 6: 2}, ()),
        "class_mismatch": (gt, {1: 1, 2: 2, 3: 1}, gt,
                           {1: 2, 2: 2, 3: 1}, ()),
        "crowd": (gt, {1: 1, 2: 2, 3: 1},
                  _rect_map(S, {7: (16, 16, 32, 32), 8: (0, 20, 10, 30)}),
                  {7: 2, 8: 1}, (2,)),
        # gt ids missing from its segments fold into void; a prediction
        # mostly on void is not a false positive
        "void": (_rect_map(S, {1: (0, 0, 16, 16), 9: (16, 0, 32, 16)}),
                 {1: 1}, _rect_map(S, {4: (18, 0, 30, 14),
                                       5: (0, 0, 16, 16)}),
                 {4: 2, 5: 1}, ()),
    }
    rng = np.random.default_rng(0)
    for i in range(3):
        g = rng.integers(0, 6, S).astype(np.int32)
        p = np.where(rng.random(S) < 0.8, g, rng.integers(0, 6, S))
        cases[f"random{i}"] = (
            g, {k: int(rng.integers(1, 3)) for k in range(1, 6)},
            p.astype(np.int32), {k: int(rng.integers(1, 3))
                                 for k in range(1, 6)}, (3,) if i else ())
    return cases


@pytest.mark.parametrize("case", sorted(_pq_cases()))
def test_pq_stat_matches_jax(case):
    """Every accumulator and the summary (per class too), exactly."""
    args = _pq_cases()[case]
    stats = []
    for mod in (jax_pq, panoptic_eval):
        pq = mod.PQStat()
        pq.update(*args)
        pq.update(*args)               # accumulates over images
        stats.append((dict(pq.tp), dict(pq.fp), dict(pq.fn), dict(pq.iou),
                      pq.summarize()))
    assert stats[1] == stats[0]
    if case == "perfect":
        assert stats[1][-1]["pq"] == 1.0


def test_masks_to_segment_map_matches_jax():
    """The higher score paints last; fully overpainted and empty masks
    leave no segment."""
    rng = np.random.default_rng(1)
    masks = rng.random((6, 20, 24)) < 0.3
    masks[2] = False
    masks[4] = masks[5]                     # 5 scores higher: 4 vanishes
    labels = [1, 2, 1, 3, 2, 1]
    scores = [0.5, 0.9, 0.7, 0.1, 0.2, 0.8]
    want = jax_pq.masks_to_segment_map(masks, labels, scores, (20, 24))
    got = panoptic_eval.masks_to_segment_map(masks, labels, scores,
                                             (20, 24))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == 4


def test_rgb_ids_and_mask_boxes_match_jax():
    ids = np.asarray([[0, 1, 255], [256, 70000, 16777215]], np.int32)
    rgb = panoptic_data.id2rgb(ids)
    np.testing.assert_array_equal(rgb, jax_pan.id2rgb(ids))
    np.testing.assert_array_equal(panoptic_data.rgb2id(rgb), ids)
    np.testing.assert_array_equal(panoptic_data.rgb2id(rgb),
                                  jax_pan.rgb2id(rgb))
    m = np.zeros((3, 16, 16), np.uint8)
    m[0, 3:7, 2:10] = 1
    m[2, 15, 0] = 1
    np.testing.assert_array_equal(panoptic_data.masks_to_boxes(m),
                                  jax_pan.masks_to_boxes(m))


def _write_both(tmp_path, **kw):
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    jax_pan.make_synthetic_panoptic(roots[0], **kw)
    panoptic_data.make_synthetic_panoptic(roots[1], **kw)
    return roots


def test_synthetic_panoptic_writer_matches_jax(tmp_path):
    """The same seed writes the same JSON, JPEGs and PNGs."""
    jroot, proot = _write_both(tmp_path, n_images=5, size=48, seed=3)
    assert json.load(open(os.path.join(jroot, "panoptic.json"))) == \
        json.load(open(os.path.join(proot, "panoptic.json")))
    for sub in ("data", "panoptic"):
        names = sorted(os.listdir(os.path.join(jroot, sub)))
        assert names == sorted(os.listdir(os.path.join(proot, sub)))
        assert len(names) == 5 and all(filecmp.cmp(
            os.path.join(jroot, sub, n), os.path.join(proot, sub, n),
            shallow=False) for n in names)


@pytest.mark.parametrize("things_only", [False, True])
def test_panoptic_dataset_matches_jax(things_only, tmp_path):
    """Items (letterboxed at another size), the instance-gt view and the
    PQ ground truth equal the JAX dataset's."""
    root = str(tmp_path / "pan")
    panoptic_data.make_synthetic_panoptic(root, n_images=4, size=40,
                                          seed=4)
    args = (os.path.join(root, "data"), os.path.join(root, "panoptic"),
            os.path.join(root, "panoptic.json"))
    kw = dict(image_size=56, max_boxes=3, things_only=things_only)
    j_ds = jax_pan.CocoPanopticDataset(*args, **kw)
    p_ds = panoptic_data.CocoPanopticDataset(*args, **kw)
    assert (len(p_ds), p_ds.num_classes, p_ds.label_to_cat) == (
        len(j_ds), j_ds.num_classes, j_ds.label_to_cat)
    for i in range(len(p_ds)):
        want, got = j_ds[i], p_ds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert p_ds[0]["gt_masks"].shape == (3, 56, 56)
    assert p_ds.coco.dataset == j_ds.coco.dataset
    for img_id in p_ds.ids:
        g, w = p_ds.pq_ground_truth(img_id), j_ds.pq_ground_truth(img_id)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]


def test_panoptic_cli_end_to_end(tmp_path):
    """``--panoptic_root`` on a written split trains the mask head and
    scores bbox and segm AP and PQ on the instance-gt view (what
    ``tests/test_panoptic_data.py::test_panoptic_cli_end_to_end`` checks
    of the JAX CLI)."""
    for split, seed in (("train", 5), ("validation", 6)):
        panoptic_data.make_synthetic_panoptic(
            str(tmp_path / split), n_images=4, size=48, seed=seed)
    fp = tmp_path / "stats.json"
    record = cli_coco.main([
        "--panoptic_root", str(tmp_path), "--backbone", "swin_test3",
        "--image_size", "64", "--bs", "2", "--epochs", "1",
        "--max_boxes", "8", "--enc_layers", "1", "--dec_layers", "1",
        "--hidden_dim", "64", "--num_queries", "8", "--device", "cpu",
        "--no_initial_eval", "--stats_fp", str(fp)])
    row = record["logs"][-1]
    assert record["info"]["masks"] is True
    assert np.isfinite(row["train"]["loss_mask"])
    assert "segm" in row["val"] and "panoptic" in row["val"]
    assert all(np.isfinite(row["val"]["panoptic"][k])
               for k in ("pq", "sq", "rq"))
    assert json.load(open(fp))["logs"]
