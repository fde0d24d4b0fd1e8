"""Panoptic COCO data, counterpart of
``vit_torch_tpu/detection/panoptic_data.py`` (the reference's
``object_detr/datasets/coco_panoptic.py``, its ``--dataset_file
coco_panoptic``).

A panoptic annotation is one PNG an image whose RGB triplet encodes the
segment id (``id = R + 256 G + 256² B``, panopticapi's ``rgb2id``) and
a JSON with each segment's ``category_id`` and ``iscrowd``.  The loader
cuts an instance mask per segment, takes its box from the mask's extent
(``masks_to_boxes``) and gives the batch of
:class:`~vit_torch_tpu_torch.detection.coco_data.CocoDetectionDataset`
with ``gt_masks`` (image, boxes, labels, box_mask, gt_masks, scale, pad,
orig_size), so that ``DetectionTrainer(masks=True)`` and the segm and PQ
evaluations take it unchanged: ``max_boxes`` segment slots an image, the
id map NEAREST-resized and pasted into the letterbox canvas (the image's
geometry).  ``make_synthetic_panoptic`` writes the same files as the JAX
package's from the same seed.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from vit_torch_tpu_torch.detection.coco_data import letterbox_params


def rgb2id(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 panoptic PNG → (H, W) int32 segment-id map
    (panopticapi semantics: id = R + 256 G + 256² B)."""
    color = color.astype(np.int32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb2id` (used by tests / writers)."""
    ids = ids.astype(np.int32)
    return np.stack([ids % 256, (ids // 256) % 256, ids // (256 * 256)],
                    axis=-1).astype(np.uint8)


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary masks → (N, 4) xyxy boxes of the mask extents
    (reference ``object_detr/util/box_ops.py:masks_to_boxes``); empty
    masks give zero boxes."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


class CocoPanopticDataset:
    """Index over a panoptic-annotated COCO directory.

    ``images_dir`` holds the JPEGs, ``ann_dir`` the per-image segment PNGs,
    ``ann_file`` the panoptic JSON (``images`` + ``annotations`` with
    ``file_name``/``segments_info``, ``categories``).
    """

    def __init__(self, images_dir: str, ann_dir: str, ann_file: str,
                 image_size: int = 512, max_boxes: int = 64,
                 limit: int = 0, things_only: bool = False) -> None:
        self.images_dir = images_dir
        self.ann_dir = ann_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.things_only = things_only
        with open(ann_file) as f:
            self.meta = json.load(f)
        # align images ↔ annotations by id (the reference sorts by
        # file_name; id-keyed lookup is equivalent and order-robust)
        self.imgs = {img["id"]: img for img in self.meta["images"]}
        anns = self.meta.get("annotations", [])
        self.anns = {a["image_id"]: a for a in anns}
        self.ids = sorted(self.anns.keys() if anns else self.imgs.keys())
        if limit and limit > 0:
            self.ids = self.ids[:limit]
        cats = self.meta.get("categories", [])
        self.cats = {c["id"]: c for c in cats}
        cat_ids = sorted(c["id"] for c in cats) if cats else sorted(
            {s["category_id"] for a in anns for s in a["segments_info"]})
        if things_only:
            cat_ids = [c for c in cat_ids
                       if self.cats.get(c, {}).get("isthing", 1)]
        self.category_ids = cat_ids
        self.cat_to_label = {c: i + 1 for i, c in enumerate(cat_ids)}
        self.label_to_cat = {v: k for k, v in self.cat_to_label.items()}
        self.num_classes = len(cat_ids)

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def coco(self):
        """Lazy COCO instance-gt view (what the evaluators consume)."""
        if not hasattr(self, "_coco"):
            self._coco = self.instance_gt()
        return self._coco

    def _segment_masks(self, ann: dict, pad_x, pad_y, nh, nw):
        """Decode the segment PNG and cut per-segment letterboxed masks."""
        from PIL import Image
        png = np.asarray(Image.open(
            os.path.join(self.ann_dir, ann["file_name"])).convert("RGB"))
        id_map = rgb2id(png)
        # NEAREST resize of the id map keeps segment ids intact
        small = np.asarray(Image.fromarray(id_map.astype(np.int32),
                                           mode="I").resize(
            (nw, nh), Image.NEAREST))
        S = self.image_size
        canvas = np.zeros((S, S), np.int32)
        canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = small
        return canvas

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image
        img_id = self.ids[idx]
        ann = self.anns.get(img_id)
        info = self.imgs[img_id]
        # panoptic file_name is the PNG name; the image is the .jpg twin
        # (dict.get's default evaluates eagerly — ann can be None on an
        # images-only split, so branch explicitly)
        img_name = info.get("file_name")
        if img_name is None:
            img_name = ann["file_name"].replace(".png", ".jpg")
        if img_name.endswith(".png"):
            img_name = img_name.replace(".png", ".jpg")
        img = np.asarray(Image.open(
            os.path.join(self.images_dir, img_name)).convert("RGB"))
        h, w = img.shape[:2]
        S = self.image_size
        scale, pad_x, pad_y, nh, nw = letterbox_params(h, w, S)
        resized = np.asarray(
            Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
        image = np.full((S, S, 3), 114, np.uint8)
        image[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros((self.max_boxes,), np.int32)
        box_mask = np.zeros((self.max_boxes,), np.float32)
        masks = np.zeros((self.max_boxes, S, S), np.uint8)
        if ann is not None:
            seg_map = self._segment_masks(ann, pad_x, pad_y, nh, nw)
            segments = [s for s in ann["segments_info"]
                        if s["category_id"] in self.cat_to_label]
            for i, seg in enumerate(segments[:self.max_boxes]):
                m = (seg_map == seg["id"]).astype(np.uint8)
                masks[i] = m
                boxes[i] = masks_to_boxes(m[None])[0]
                labels[i] = self.cat_to_label[seg["category_id"]]
                box_mask[i] = 1.0
        return {
            "image": image.astype(np.float32),
            "boxes": boxes,
            "labels": labels,
            "box_mask": box_mask,
            "gt_masks": masks,
            "image_id": np.int64(img_id),
            "scale": np.float32(scale),
            "pad": np.asarray([pad_x, pad_y], np.float32),
            "orig_size": np.asarray([h, w], np.float32),
        }

    def instance_gt(self):
        """COCO instance-annotation view of the panoptic ground truth (RLE
        segmentations cut from the segment PNGs, xywh boxes from mask
        extents) — feeds the bbox/segm ``COCOeval`` and the instance-based
        PQ scoring path unchanged, so ``DetectionTrainer.evaluate`` works
        on panoptic data without panopticapi JSON conversion."""
        from vit_torch_tpu_torch.detection import _mask
        images, annotations = [], []
        ann_id = 1
        for img_id in self.ids:
            info = self.imgs[img_id]
            images.append({"id": img_id, "height": info["height"],
                           "width": info["width"],
                           "file_name": info.get("file_name", "")})
            gt_map, segments, crowd = self.pq_ground_truth(img_id)
            for sid, cat in segments.items():
                if cat not in self.cat_to_label:
                    continue
                m = (gt_map == sid).astype(np.uint8)
                box = masks_to_boxes(m[None])[0]
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": cat,
                    "bbox": [float(box[0]), float(box[1]),
                             float(box[2] - box[0]), float(box[3] - box[1])],
                    "area": float(m.sum()),
                    "iscrowd": int(sid in crowd),
                    "segmentation": _mask.encode(m),
                })
                ann_id += 1
        from vit_torch_tpu_torch.detection.coco_eval import COCO
        cats = [self.cats.get(c, {"id": c, "name": str(c)})
                for c in self.category_ids]
        return COCO(dataset={"images": images, "annotations": annotations,
                             "categories": cats})

    def pq_ground_truth(self, img_id: int):
        """(gt_map, segments, crowd_ids) at original resolution for
        :class:`~vit_torch_tpu.detection.panoptic_eval.PQStat`."""
        from PIL import Image
        ann = self.anns[img_id]
        png = np.asarray(Image.open(
            os.path.join(self.ann_dir, ann["file_name"])).convert("RGB"))
        gt_map = rgb2id(png)
        segments = {s["id"]: s["category_id"] for s in ann["segments_info"]}
        crowd = {s["id"] for s in ann["segments_info"]
                 if s.get("iscrowd", 0)}
        return gt_map, segments, crowd


def make_synthetic_panoptic(root: str, n_images: int = 8, size: int = 64,
                            n_thing_classes: int = 3, seed: int = 0) -> str:
    """Write one synthetic panoptic split (``root/{data,panoptic,
    panoptic.json}``) — the panoptic twin of
    ``coco_data.make_synthetic_coco``: bright axis-aligned rectangles are
    *thing* segments, all remaining pixels one *stuff* "background"
    segment, so PQ has both halves (SQ over things, the stuff segment's
    IoU) with exact ground truth.  Returns ``root``."""
    import json as _json

    from PIL import Image
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "data")
    pan_dir = os.path.join(root, "panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)
    BG_CAT = 100                       # stuff category id
    images, annotations = [], []
    for i in range(n_images):
        img = (rng.normal(40, 15, (size, size, 3))).clip(0, 255)
        id_map = np.ones((size, size), np.int32)       # background segment
        segments = [{"id": 1, "category_id": BG_CAT, "iscrowd": 0}]
        for j in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, n_thing_classes))
            bw = int(rng.integers(8, size // 2))
            bh = int(rng.integers(8, size // 2))
            x = int(rng.integers(0, size - bw))
            y = int(rng.integers(0, size - bh))
            color = np.zeros(3)
            # clamp: cls >= 6 would exceed 255 and wrap dark under the
            # uint8 cast (same formula as make_synthetic_coco, which only
            # ever sees <= 3 classes)
            color[cls % 3] = min(200 + 55 * (cls // 3), 255)
            img[y:y + bh, x:x + bw] = color
            sid = j + 2                # later rectangles overwrite earlier
            id_map[y:y + bh, x:x + bw] = sid
            segments.append({"id": sid, "category_id": cls + 1,
                             "iscrowd": 0})
        # drop segments fully occluded by later rectangles
        live = set(np.unique(id_map).tolist())
        segments = [s for s in segments if s["id"] in live]
        for s in segments:
            m = id_map == s["id"]
            s["area"] = int(m.sum())
            box = masks_to_boxes(m[None].astype(np.uint8))[0]
            s["bbox"] = [float(box[0]), float(box[1]),
                         float(box[2] - box[0]), float(box[3] - box[1])]
        name = f"{i + 1:06d}"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_dir, name + ".jpg"))
        Image.fromarray(id2rgb(id_map)).save(
            os.path.join(pan_dir, name + ".png"))
        images.append({"id": i + 1, "file_name": name + ".jpg",
                       "height": size, "width": size})
        annotations.append({"image_id": i + 1, "file_name": name + ".png",
                            "segments_info": segments})
    categories = [{"id": c + 1, "name": f"class{c}", "isthing": 1}
                  for c in range(n_thing_classes)]
    categories.append({"id": BG_CAT, "name": "background", "isthing": 0})
    with open(os.path.join(root, "panoptic.json"), "w") as f:
        _json.dump({"images": images, "annotations": annotations,
                    "categories": categories}, f)
    return root
