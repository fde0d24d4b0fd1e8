"""COCO detection data, counterpart of
``vit_torch_tpu/detection/coco_data.py``: direct JSON loading with the
reference's OD-aware letterbox (``object/coco_datasets.py:25-120``),
fixed shapes (every image letterboxed to one ``image_size``, every target
padded to ``max_boxes`` with a validity mask), the threaded prefetching
batcher, and the synthetic COCO-format set of the smoke runs.

Batches are numpy on the host: ``image`` (B, S, S, 3) uint8, ``boxes``
(B, N, 4) xyxy letterbox pixels, ``labels`` (B, N) int32 with 0 the
background, ``box_mask`` (B, N), ``mask`` (B,) (padding of the last
batch), ``image_id``, ``scale``, ``pad`` and ``orig_size`` for mapping
predictions back to the original pixels.  With ``load_keypoints`` a
batch also has ``gt_keypoints`` (B, N, K, 3) in letterbox pixels, K from
the categories' keypoint names (17, COCO's person, where none are
given).  With ``load_masks``, ``gt_masks`` (B, N, S, S) uint8: each
annotation's polygons rasterised by PIL in letterbox pixels, or its RLE
decoded, NEAREST-resized with PIL and pasted into the canvas.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from vit_torch_tpu_torch.detection.coco_eval import COCO


def letterbox_params(h: int, w: int, size: int):
    """scale + (pad_x, pad_y) to fit (h, w) into (size, size) preserving
    aspect ratio, centred (fit_to_od semantics)."""
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y = (size - nh) // 2
    pad_x = (size - nw) // 2
    return scale, pad_x, pad_y, nh, nw


class CocoDetectionDataset:
    """In-memory index over a COCO directory (``images_dir/*.jpg`` and a
    ``labels.json``-style annotation file, the reference's DETR layout
    ``object_detr/datasets/coco.py:198-201``), with the class-subset
    filter (``category_ids``), ``limit`` and seeded shuffling.  With
    ``load_keypoints``, ``num_keypoints`` and ``kp_names`` come from the
    category with the most keypoint names (reference
    ``object/coco_utils.py:222-251``), 17 where no category names any."""

    def __init__(self, images_dir: str, ann_file: str, image_size: int = 512,
                 max_boxes: int = 64, limit: int = 0,
                 category_ids: Optional[Sequence[int]] = None,
                 keep_empty: bool = False, seed: int = 0,
                 shuffle: bool = False, load_masks: bool = False,
                 load_keypoints: bool = False) -> None:
        self.images_dir = images_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.load_masks = load_masks
        self.load_keypoints = load_keypoints
        self.coco = COCO(ann_file)
        self.num_keypoints = 0
        self.kp_names: list = []
        if load_keypoints:
            for cat in self.coco.cats.values():
                names = cat.get("keypoints", [])
                if len(names) > self.num_keypoints:
                    self.num_keypoints = len(names)
                    self.kp_names = list(names)
            if self.num_keypoints == 0:
                self.num_keypoints = 17
        ids = self.coco.get_img_ids()
        if category_ids:
            category_ids = set(category_ids)
            # filter annotations to the class subset (reference
            # object/coco_pipeline.py:351-355)
            for img_id in ids:
                anns = self.coco.img_to_anns.get(img_id, [])
                self.coco.img_to_anns[img_id] = [
                    a for a in anns if a["category_id"] in category_ids]
        if not keep_empty:
            ids = [i for i in ids if self.coco.img_to_anns.get(i)]
        if shuffle:
            ids = list(np.random.default_rng(seed).permutation(ids))
        if limit and limit > 0:
            ids = ids[:limit]
        self.ids = [int(i) for i in ids]
        self.category_ids = (sorted(category_ids) if category_ids
                             else self.coco.get_cat_ids())
        # contiguous label mapping: 0 is background, 1..K are classes
        self.cat_to_label = {c: i + 1 for i, c in enumerate(self.category_ids)}
        self.label_to_cat = {v: k for k, v in self.cat_to_label.items()}
        self.num_classes = len(self.category_ids)

    def __len__(self) -> int:
        return len(self.ids)

    @staticmethod
    def _rasterize(segm, scale, pad_x, pad_y, size) -> np.ndarray:
        """A polygon or RLE segmentation as a (size, size) uint8 mask in
        letterbox pixels."""
        from PIL import Image, ImageDraw
        from vit_torch_tpu_torch.detection import _mask
        if isinstance(segm, dict):                     # RLE at original size
            m = _mask.decode(segm)
            h, w = m.shape[:2]
            nh, nw = int(round(h * scale)), int(round(w * scale))
            img = Image.fromarray(m * 255).resize((nw, nh), Image.NEAREST)
            canvas = np.zeros((size, size), np.uint8)
            canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = (
                np.asarray(img) > 0).astype(np.uint8)
            return canvas
        img = Image.new("L", (size, size), 0)
        draw = ImageDraw.Draw(img)
        for poly in segm:
            pts = [(poly[i] * scale + pad_x, poly[i + 1] * scale + pad_y)
                   for i in range(0, len(poly) - 1, 2)]
            if len(pts) >= 3:
                draw.polygon(pts, outline=1, fill=1)
        return np.asarray(img, np.uint8)

    def _load_image(self, info: dict) -> np.ndarray:
        from PIL import Image
        path = os.path.join(self.images_dir, info.get("file_name"))
        return np.asarray(Image.open(path).convert("RGB"), np.uint8)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image
        img_id = self.ids[idx]
        img = self._load_image(self.coco.imgs[img_id])
        h, w = img.shape[:2]
        S = self.image_size
        scale, pad_x, pad_y, nh, nw = letterbox_params(h, w, S)
        resized = np.asarray(
            Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
        canvas = np.full((S, S, 3), 114, np.uint8)
        canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros((self.max_boxes,), np.int32)
        box_mask = np.zeros((self.max_boxes,), np.float32)
        masks = (np.zeros((self.max_boxes, S, S), np.uint8)
                 if self.load_masks else None)
        kps = (np.zeros((self.max_boxes, self.num_keypoints, 3), np.float32)
               if self.load_keypoints else None)
        anns = [a for a in self.coco.img_to_anns.get(img_id, [])
                if not a.get("iscrowd", 0)][:self.max_boxes]
        for i, ann in enumerate(anns):
            x, y, bw, bh = ann["bbox"]
            boxes[i] = [x * scale + pad_x, y * scale + pad_y,
                        (x + bw) * scale + pad_x, (y + bh) * scale + pad_y]
            labels[i] = self.cat_to_label.get(ann["category_id"], 0)
            box_mask[i] = 1.0
            if masks is not None and "segmentation" in ann:
                masks[i] = self._rasterize(ann["segmentation"], scale,
                                           pad_x, pad_y, S)
            if kps is not None and ann.get("keypoints"):
                k = np.asarray(ann["keypoints"], np.float32).reshape(
                    -1, 3)[:self.num_keypoints]
                k[:, 0] = k[:, 0] * scale + pad_x
                k[:, 1] = k[:, 1] * scale + pad_y
                kps[i, :len(k)] = k
        extra = {} if masks is None else {"gt_masks": masks}
        if kps is not None:
            extra["gt_keypoints"] = kps
        return {
            **extra,
            "image": canvas,
            "boxes": np.clip(boxes, 0, S),
            "labels": labels,
            "box_mask": box_mask,
            "image_id": np.int64(img_id),
            "scale": np.float32(scale),
            "pad": np.asarray([pad_x, pad_y], np.float32),
            "orig_size": np.asarray([h, w], np.float32),
        }


class CocoLoader:
    """Fixed-shape batcher over :class:`CocoDetectionDataset`.

    Host input pipeline (the reference's ``DataLoader(num_workers=4)``,
    ``object/coco_pipeline.py:411-417``): per-sample JPEG decode and
    letterboxing run on a thread pool (PIL releases the GIL in its
    codecs), and assembled batches are staged through a bounded queue by a
    producer thread, so that the host pipeline overlaps the device's
    work.  The last batch is padded with sample 0 and masked out."""

    def __init__(self, dataset: CocoDetectionDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _assemble(self, idx: np.ndarray, valid: int, fetch) -> dict:
        samples = list(fetch(self.dataset.__getitem__,
                             [int(i) for i in idx]))
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["mask"] = (np.arange(self.batch_size) < valid).astype(
            np.float32)
        return batch

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            valid = len(idx)
            if valid < bs:
                idx = np.concatenate([idx, np.zeros(bs - valid, np.int64)])
            yield idx, valid

    def __iter__(self):
        if self.num_workers <= 0:
            for idx, valid in self._batches():
                yield self._assemble(idx, valid, map)
            return

        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx, valid in self._batches():
                        if stop.is_set():
                            return
                        q.put(self._assemble(idx, valid, pool.map))
            except BaseException as e:          # handed to the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early lets the producer finish
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def make_synthetic_coco(tmp_dir: str, n_images: int = 8, size: int = 64,
                        n_classes: int = 3, seed: int = 0,
                        keypoints: bool = False) -> tuple:
    """Write a synthetic COCO-format set (``tmp_dir/data/*.jpg`` and
    ``tmp_dir/labels.json``) for smoke runs without network access:
    axis-aligned bright rectangles on dark noise, 1-3 a picture, so that
    even short training shows learning.  With ``keypoints`` every
    annotation has five visible keypoints (``tl``, ``tr``, ``center``,
    ``bl``, ``br``: the corners one pixel in and a bright dot drawn at the
    centre).  Returns ``(images_dir, ann_file)``.  The same seed writes
    the same files as the JAX package's ``make_synthetic_coco``."""
    import json
    from PIL import Image
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(tmp_dir, "data")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img = (rng.normal(40, 15, (size, size, 3))).clip(0, 255)
        n_obj = int(rng.integers(1, 4))
        for _ in range(n_obj):
            cls = int(rng.integers(0, n_classes))
            bw = int(rng.integers(8, size // 2))
            bh = int(rng.integers(8, size // 2))
            x = int(rng.integers(0, size - bw))
            y = int(rng.integers(0, size - bh))
            color = np.zeros(3)
            color[cls % 3] = min(200 + 55 * (cls // 3), 255)  # no uint8 wrap
            img[y:y + bh, x:x + bw] = color
            ann = {
                "id": ann_id, "image_id": i + 1, "category_id": cls + 1,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "segmentation": [[float(x), float(y), float(x + bw),
                                  float(y), float(x + bw), float(y + bh),
                                  float(x), float(y + bh)]],
                "area": float(bw * bh), "iscrowd": 0}
            if keypoints:
                cx, cy = x + bw / 2, y + bh / 2
                img[int(cy) - 1:int(cy) + 1, int(cx) - 1:int(cx) + 1] = 255
                pts = [(x + 1, y + 1), (x + bw - 1, y + 1), (cx, cy),
                       (x + 1, y + bh - 1), (x + bw - 1, y + bh - 1)]
                ann["keypoints"] = [float(v) for p in pts
                                    for v in (p[0], p[1], 2)]
                ann["num_keypoints"] = len(pts)
            annotations.append(ann)
            ann_id += 1
        fname = f"{i + 1:06d}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_dir, fname))
        images.append({"id": i + 1, "file_name": fname,
                       "height": size, "width": size})
    categories = [{"id": c + 1, "name": f"class{c}"}
                  for c in range(n_classes)]
    if keypoints:
        for cat in categories:
            cat["keypoints"] = ["tl", "tr", "center", "bl", "br"]
    ann_file = os.path.join(tmp_dir, "labels.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return img_dir, ann_file
