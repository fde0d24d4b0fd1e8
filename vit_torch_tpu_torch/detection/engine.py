"""Detection train/eval engine, counterpart of
``vit_torch_tpu/detection/engine.py``'s ``DetectionTrainer`` and
``FasterRCNNTrainer`` (the reference's ``object/engine.py:14-110`` and
``object_detr/engine.py``): the DETR train step with the host Hungarian
matcher or the device auction matcher (with ``masks``, DETRSegm's focal
and dice losses on the last layer's assignment), the Faster R-CNN /
Keypoint R-CNN train step with its matching and sampling on the device,
the epoch loop with epoch-0 linear LR warmup, loss logging and the
non-finite-loss stop, its chunked form (``train_one_epoch_scan``), the
checkpoint state, the predict functions the serving bundles share, and
the COCO bbox, segm and keypoint evaluation with panoptic quality.

One forward a step, upstream DETR's order: the training forward, the
matching costs from its detached outputs on the device, the assignment,
then the set losses of every decoder layer and the backward on the same
graph.  ``matcher="host"`` copies the ``(L, B, Q, N)`` costs to the host
once and solves each exactly there (:func:`~vit_torch_tpu_torch.
detection.matcher.hungarian_match`); ``matcher="device"`` runs
:func:`~vit_torch_tpu_torch.detection.matcher.auction_assign` on the
costs' device, so that nothing reads the device before the loss (the JAX
``train_step_fused``).  (The JAX host path runs the training forward
twice, once for the costs and once inside the differentiated step, with
one dropout key, so that both see the same predictions.)

``train_one_epoch_scan`` is the JAX chunked-scan epoch run as K eager
steps a chunk: the same steps and draws as the per-step epoch, except that
epoch 0's warmup sets the LR once a chunk (the value of the chunk's last
buffered batch), and the logs of a chunk are read from the device once.

Optimisers as the JAX trainer builds them: ``adamw`` is global-norm
clipping at ``grad_clip`` (``g · max_norm / norm`` where the norm exceeds
it, optax's arithmetic) then AdamW with decoupled weight decay; ``sgd`` is
momentum SGD with torch's coupled weight decay (the reference fork's
recipe, ``object_detr/main.py:239-252``).  Faster R-CNN's is the
reference's SGD (``object/coco_pipeline.py:464-476``: momentum 0.9,
coupled weight decay 5e-4) after a global-norm clip at 10, optax's order
clip → add decay → momentum.

With a ``mesh`` (a pure ``data`` mesh, ``parallel/``) every rank draws a
step's augmentation and noise for the global batch and keeps its rows,
solves its own images' assignments, and divides its loss terms by the
global counts (``collectives.global_denominators``: DETR's ``num_boxes``
and class weights, the images of Faster R-CNN); its loss drives the
backward scaled by the number of ranks, the gradients are averaged over
them before the clip, BatchNorm's statistics are the global batch's, and
the logged terms are summed over the ranks, so that a step equals the
single-process step on the global batch, as the JAX step does under
GSPMD.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vit_torch_tpu_torch.data.augment import normalize
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.detection import _mask
from vit_torch_tpu_torch.detection.boxes import xyxy_to_cxcywh
from vit_torch_tpu_torch.detection.coco_eval import CocoEvaluator
from vit_torch_tpu_torch.detection.detr import detr_losses, postprocess
from vit_torch_tpu_torch.detection.faster_rcnn import (draw_noise,
                                                       faster_rcnn_losses,
                                                       faster_rcnn_predict)
from vit_torch_tpu_torch.detection.matcher import (auction_assign,
                                                   cost_matrices,
                                                   hungarian_match)
from vit_torch_tpu_torch.detection.panoptic_eval import (PQStat,
                                                         masks_to_segment_map)
from vit_torch_tpu_torch.detection.segmentation import (mask_losses,
                                                        pack_mask_bits,
                                                        postprocess_segm)
from vit_torch_tpu_torch.detection.transforms import (apply_erasing,
                                                      apply_hflip,
                                                      apply_zoom_crop,
                                                      draw_erasing,
                                                      draw_hflip,
                                                      draw_zoom_crop)
from vit_torch_tpu_torch.models.layers import set_generator
from vit_torch_tpu_torch.parallel.collectives import global_denominators
from vit_torch_tpu_torch.train.optimizers import set_learning_rate


def prep_targets(labels: torch.Tensor, boxes: torch.Tensor,
                 box_mask: torch.Tensor, mask: torch.Tensor,
                 image_size: int) -> Dict[str, torch.Tensor]:
    """Loss targets: boxes normalised to [0, 1] and turned to cxcywh."""
    return {"labels": labels,
            "boxes_cxcywh": xyxy_to_cxcywh(boxes / image_size),
            "box_mask": box_mask, "mask": mask}


def clip_grad_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient becomes
    ``g / norm * max_norm`` when the global norm is not below
    ``max_norm`` (torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``).
    No host sync, a few multi-tensor launches.  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


def _to_device(array, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array on ``device``; to CUDA through pinned memory, so that
    the copy waits neither for the host nor for the device's queue."""
    t = torch.as_tensor(array)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _device_batch(batch: dict, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The images, boxes, labels and masks of a host batch on ``device``
    (:func:`_to_device`), the tensors both trainers' steps read."""
    return {
        "image": _to_device(batch["image"], device),
        "boxes": _to_device(batch["boxes"], device, torch.float32),
        "labels": _to_device(batch["labels"], device, torch.long),
        "box_mask": _to_device(batch["box_mask"], device, torch.float32),
        "mask": _to_device(batch["mask"], device, torch.float32)}


def _data_layout(model: torch.nn.Module, mesh):
    """The detection trainers' :class:`~vit_torch_tpu_torch.parallel.api.
    Layout` (None without a mesh); only the ``data`` axis may be larger
    than one."""
    if mesh is None:
        return None
    if any(mesh.shape[a] != 1 for a in ("model", "seq", "pipe")):
        raise ValueError("detection supports data-parallel meshes only "
                         "(e.g. --mesh data=8)")
    from vit_torch_tpu_torch.parallel.api import prepare_model
    return prepare_model(model, mesh)


def _step_update(layout, params, optimizer, total: torch.Tensor,
                 clip: Optional[float]) -> None:
    """Backward (scaled by the batch shards under a mesh), the gradient
    average, the global-norm clip, the update."""
    optimizer.zero_grad(set_to_none=True)
    if layout is None:
        total.backward()
    else:
        from vit_torch_tpu_torch.parallel.api import sync_gradients
        (total * layout.loss_scale).backward()
        sync_gradients(params, layout)
    if clip is not None:
        clip_grad_global_norm(params, clip)
    optimizer.step()


def _reduce_logs(logs: Dict[str, torch.Tensor], layout
                 ) -> Dict[str, torch.Tensor]:
    """Each term summed over the batch shards (each holds its part of the
    global term); the identity without a mesh."""
    if layout is None or layout.batch_group is None:
        return logs
    keys = list(logs)
    vals = layout.reduce_batch(torch.stack([logs[k].float() for k in keys]))
    return dict(zip(keys, vals))


def _read_logs(chunk) -> list:
    """The host values of a list of steps' device logs: one stacked copy
    (one read of the device) for all of them."""
    keys = list(chunk[0])
    rows = torch.stack([torch.stack([logs[k].float() for k in keys])
                        for logs in chunk]).tolist()
    return [dict(zip(keys, row)) for row in rows]


def _epoch(train_step, loader, epoch: int, set_lr, base_lr: float,
           warmup_steps: int, print_freq: int, warmup: bool,
           log_fn: Optional[Callable]) -> Dict[str, float]:
    """The reference's ``train_one_epoch`` (``object/engine.py:14-55``):
    linear warmup over ``min(len(loader), warmup_steps)`` steps in epoch
    0, the mean of every logged term (one read of the device a step),
    ``sys.exit(1)`` on a non-finite ``loss_total``."""
    n_batches = len(loader)
    totals: Dict[str, float] = {}
    count = 0
    for i, batch in enumerate(loader):
        if warmup and epoch == 0:
            frac = (i + 1) / max(min(n_batches, warmup_steps), 1)
            set_lr(base_lr * min(frac, 1.0))
        logs = _read_logs([train_step(batch)])[0]
        if not np.isfinite(logs["loss_total"]):
            print(f"Loss is {logs['loss_total']}, stopping training")
            print(logs)
            sys.exit(1)
        for k, v in logs.items():
            totals[k] = totals.get(k, 0.0) + v
        count += 1
        if log_fn and (i % print_freq == 0 or i == n_batches - 1):
            log_fn(i, n_batches, logs)
    return {k: v / max(count, 1) for k, v in totals.items()}


def _scan_epoch(train_step, loader, epoch: int, steps_per_dispatch: int,
                set_lr, base_lr: float, warmup_steps: int, warmup: bool,
                log_fn: Optional[Callable]) -> Dict[str, float]:
    """The JAX ``train_one_epoch_scan`` (``engine.py:459-531``; Faster
    R-CNN's ``:852-926``) as eager steps: batches are buffered
    ``steps_per_dispatch`` at a time and a full buffer runs as one chunk
    of steps whose logs stay on the device and are read once; a tail that
    does not fill a chunk runs per step (one read a step).  Epoch 0's
    warmup sets the LR as each batch is buffered, so that a chunk trains
    at the LR of its last buffered batch.  The non-finite stop and
    ``log_fn`` (every ``steps_per_dispatch``-th step and the last) follow
    each read."""
    n_batches = len(loader)
    totals: Dict[str, float] = {}
    count = done = 0
    buf: list = []

    def accum(logs):
        nonlocal count, done
        if not np.isfinite(logs["loss_total"]):
            print(f"Loss is {logs['loss_total']}, stopping training")
            print(logs)
            sys.exit(1)
        for k, v in logs.items():
            totals[k] = totals.get(k, 0.0) + v
        count += 1
        done += 1
        if log_fn and (done % steps_per_dispatch == 0 or done == n_batches):
            log_fn(done - 1, n_batches, logs)

    def flush():
        if len(buf) < steps_per_dispatch:
            for batch in buf:
                accum(_read_logs([train_step(batch)])[0])
        else:
            for logs in _read_logs([train_step(batch) for batch in buf]):
                accum(logs)
        buf.clear()

    for batch in loader:
        if warmup and epoch == 0:
            frac = (done + len(buf) + 1) / max(min(n_batches, warmup_steps), 1)
            set_lr(base_lr * min(frac, 1.0))
        buf.append(batch)
        if len(buf) == steps_per_dispatch:
            flush()
    flush()
    return {k: v / max(count, 1) for k, v in totals.items()}


def _unletterbox_masks(masks: np.ndarray, scale: float, pad: np.ndarray,
                       orig_size: np.ndarray) -> np.ndarray:
    """(N, S, S) letterbox masks → (N, h, w) binary masks at the original
    resolution: the content region cropped and resized back by one
    index gather, nearest at half-pixel centres (``floor((dst + 0.5) ·
    src / dst)``), as the JAX package's ``_unletterbox_masks``."""
    masks = np.asarray(masks, np.uint8)
    h, w = int(orig_size[0]), int(orig_size[1])
    nh, nw = int(round(h * float(scale))), int(round(w * float(scale)))
    px, py = int(pad[0]), int(pad[1])
    if masks.shape[0] == 0 or nh <= 0 or nw <= 0:
        return np.zeros((masks.shape[0], h, w), np.uint8)
    crop = masks[:, py:py + nh, px:px + nw]
    ys = np.clip(np.floor((np.arange(h) + 0.5) * nh / h).astype(np.int64),
                 0, nh - 1)
    xs = np.clip(np.floor((np.arange(w) + 0.5) * nw / w).astype(np.int64),
                 0, nw - 1)
    return (crop[:, ys[:, None], xs[None, :]] > 0).astype(np.uint8)


def _pq_prepare(coco_gt, img_id: int, pred: Dict[str, np.ndarray]):
    """One image's PQ inputs: the gt segment map rasterised from the COCO
    annotations (later annotations paint over earlier ones) and the
    predicted one painted from the instance masks (the higher score
    last)."""
    info = coco_gt.imgs[img_id]
    h, w = int(info["height"]), int(info["width"])
    gt_map = np.zeros((h, w), np.int32)
    gt_segments: Dict[int, int] = {}
    crowd_ids = []
    for sid, ann in enumerate(coco_gt.img_to_anns.get(img_id, []), start=1):
        segm = ann.get("segmentation")
        if segm is None:
            continue
        rle = segm if isinstance(segm, dict) else _mask.poly_to_rle(segm, h,
                                                                   w)
        gt_map[_mask.decode(rle).astype(bool)] = sid
        gt_segments[sid] = int(ann["category_id"])
        if ann.get("iscrowd", 0):
            crowd_ids.append(sid)
    pred_map, pred_segments = masks_to_segment_map(
        pred["masks"], [int(l) for l in pred["labels"]],
        [float(s) for s in pred["scores"]], (h, w))
    return gt_map, gt_segments, pred_map, pred_segments, crowd_ids


@torch.no_grad()
def predict_detr(model: torch.nn.Module, norm: dict, image_size: int,
                 batch: dict, masks: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """DETR's predictions for a host batch (``image`` uint8 (B, S, S, 3),
    ``scale`` (B,), ``pad`` (B, 2)), eval mode: scored boxes in original
    pixels and, with ``masks``, the (B, Q, S, S) masks at the letterbox's
    resolution bit-packed row-major for the copy to the host
    (``masks_packed``).  The trainer's ``predict`` and the serving bundle
    both run it."""
    model.eval()
    dev = next(model.parameters()).device
    images = torch.as_tensor(batch["image"]).to(dev)
    outputs = model(normalize(images, **norm))
    preds = postprocess(outputs, image_size,
                        torch.as_tensor(batch["scale"]).to(dev),
                        torch.as_tensor(batch["pad"]).to(dev))
    if masks and "pred_masks" in outputs:
        preds["masks_packed"] = pack_mask_bits(
            postprocess_segm(outputs["pred_masks"], image_size))
    return preds


@torch.no_grad()
def predict_faster_rcnn(model: torch.nn.Module, norm: dict,
                        batch: dict) -> Dict[str, torch.Tensor]:
    """Faster R-CNN's scored boxes (and keypoints) in original pixels for
    a host batch, eval mode; shared by the trainer and the bundle."""
    model.eval()
    dev = next(model.parameters()).device
    images = _to_device(batch["image"], dev)
    outputs = model(normalize(images, **norm))
    return faster_rcnn_predict(
        outputs, model.config, _to_device(batch["scale"], dev, torch.float32),
        _to_device(batch["pad"], dev, torch.float32))


def _to_host(tensors: Dict[str, torch.Tensor]):
    """Start the copy of ``tensors`` to the host; returns the host tensors
    and the CUDA event that marks their arrival (None on the CPU)."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
    event = None
    if any(v.is_cuda for v in tensors.values()):
        event = torch.cuda.Event()
        event.record()
    return host, event


class DetectionTrainer:
    def __init__(self, model: torch.nn.Module, *, image_size: int,
                 num_classes: int, lr: float = 1e-4,
                 weight_decay: float = 1e-4, warmup_steps: int = 1000,
                 grad_clip: float = 0.1, masks: bool = False,
                 augment: bool = False, aug_crop: bool = False,
                 aug_erase: bool = False, matcher: str = "host",
                 opt: str = "adamw", momentum: float = 0.9,
                 norm_values: Optional[dict] = None, seed: int = 0,
                 mesh=None) -> None:
        """``model`` is a :class:`~vit_torch_tpu_torch.detection.detr.DETR`
        on its device, with ``masks`` a :class:`~vit_torch_tpu_torch.
        detection.segmentation.DETRSegm` (batches then carry
        ``gt_masks``).  ``augment`` turns on the horizontal flip;
        ``aug_crop`` and ``aug_erase`` apply with it or without it.  Every
        random draw (augmentation in :meth:`draw`, drop-path) comes from
        one generator on the model's device, seeded with ``seed``.
        ``matcher`` is ``"host"`` (exact, one copy of the costs) or
        ``"device"`` (the auction, no host read).  ``mesh``: data
        parallelism over its ``data`` axis (see the module)."""
        if matcher not in ("host", "device"):
            raise ValueError(f"unknown matcher {matcher!r}")
        if opt not in ("adamw", "sgd"):
            raise ValueError(f"unknown detection optimizer {opt!r}")
        self.model = model
        self.device = next(model.parameters()).device
        self.image_size = image_size
        self.num_classes = num_classes
        self.masks = masks
        self.augment = augment
        self.aug_crop = aug_crop
        self.aug_erase = aug_erase
        self.matcher = matcher
        self.warmup_steps = max(int(warmup_steps), 1)
        self.grad_clip = grad_clip if opt == "adamw" else None
        self.norm = norm_values or NORM_VALUES["imagenet"]
        self.erase_value = [255.0 * m for m in self.norm["mean"]]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(model, self.generator)
        self.layout = _data_layout(model, mesh)
        self.params = [p for p in model.parameters() if p.requires_grad]
        if opt == "sgd":
            self.optimizer = torch.optim.SGD(self.params, lr=lr,
                                             momentum=momentum,
                                             weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.AdamW(self.params, lr=lr,
                                               weight_decay=weight_decay)
        self.base_lr = lr
        # host time a host-matcher step spent waiting for the costs (the
        # forward's end and the copy) and solving the assignments, summed
        # over the steps (the device matcher charges nothing here)
        self.host_ms = {"costs_wait": 0.0, "match": 0.0, "steps": 0}
        self.last_eval_profile: Dict[str, float] = {}

    def set_lr(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    # ------------------------------------------------------------------
    def _batch(self, batch: dict) -> Dict[str, torch.Tensor]:
        out = _device_batch(batch, self.device)
        if self.masks:
            out["gt_masks"] = _to_device(batch["gt_masks"], self.device,
                                         torch.uint8)
        return out

    def draw(self, batch_size: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """One step's augmentation draws from the trainer's generator, in
        this order: the flip's ``flip`` (B,) where ``augment``, the
        zoom-crop's where ``aug_crop``, the erasing's where ``aug_erase``
        (:mod:`~vit_torch_tpu_torch.detection.transforms`'s ``draw_*``).
        A test replaces it to feed the JAX trainer's draws in."""
        dev, out = self.device, {}
        if self.augment:
            out["flip"] = draw_hflip(self.generator, batch_size, dev)
        if self.aug_crop:
            out["crop"] = draw_zoom_crop(self.generator, batch_size,
                                         self.image_size, dev)
        if self.aug_erase:
            out["erase"] = draw_erasing(self.generator, batch_size, dev)
        return out

    def _augmented(self, b: Dict[str, torch.Tensor], draws):
        """Images, boxes, box_mask and the gt masks (None without
        ``masks``) under one step's ``draws``; the masks move with the
        images."""
        images, boxes, box_mask = b["image"], b["boxes"], b["box_mask"]
        gt_masks = b.get("gt_masks")
        if "flip" in draws:
            flipped = apply_hflip(draws["flip"], images, boxes,
                                  self.image_size, masks=gt_masks)
            images, boxes = flipped[:2]
            gt_masks = flipped[2] if gt_masks is not None else None
        if "crop" in draws:
            cropped = apply_zoom_crop(draws["crop"], images, boxes, box_mask,
                                      self.image_size, gt_masks)
            images, boxes, box_mask = cropped[:3]
            gt_masks = cropped[3] if gt_masks is not None else None
        if "erase" in draws:
            # the dataset mean, so that the patch normalises to zero
            images = apply_erasing(draws["erase"], images,
                                   value=self.erase_value)
        return images, boxes, box_mask, gt_masks

    def match(self, layers, targets) -> torch.Tensor:
        """The ``(L, B, Q)`` assignment of every decoder layer's
        predictions: fp32 costs on the device from detached outputs, then
        the auction there (``matcher="device"``), or one copy to the host
        and the exact assignment there."""
        t0 = time.perf_counter()
        with torch.no_grad():
            costs = torch.stack([
                cost_matrices(o["pred_logits"].detach(),
                              o["pred_boxes"].detach(), targets["labels"],
                              targets["boxes_cxcywh"], targets["box_mask"])
                for o in layers])
            if self.matcher == "device":
                return auction_assign(costs, targets["box_mask"])
            costs = costs.cpu().numpy()
            box_mask = targets["box_mask"].cpu().numpy()
        t1 = time.perf_counter()
        assign = np.stack([hungarian_match(c, box_mask) for c in costs])
        self.host_ms["costs_wait"] += 1e3 * (t1 - t0)
        self.host_ms["match"] += 1e3 * (time.perf_counter() - t1)
        self.host_ms["steps"] += 1
        return torch.from_numpy(assign).to(self.device)

    def losses(self, outputs, targets, assign, gt_masks=None):
        """Sum of the set losses of every decoder layer and the last
        layer's terms; with ``gt_masks`` and ``pred_masks`` in the
        outputs, plus the mask losses on the last layer's assignment
        (``loss_mask``, ``loss_dice``)."""
        layers = list(outputs.get("aux_outputs", [])) + [outputs]
        total, logs = 0.0, {}
        for li, o in enumerate(layers):
            terms = detr_losses(o, targets, assign[li], self.num_classes)
            total = total + terms["loss"]
            logs = terms
        if gt_masks is not None and "pred_masks" in outputs:
            ml = mask_losses(outputs["pred_masks"], gt_masks, assign[-1],
                             targets["box_mask"], targets["mask"])
            total = total + ml["loss_mask"] + ml["loss_dice"]
            logs = {**logs, **ml}
        return total, logs

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One step on a host batch (:class:`~vit_torch_tpu_torch.detection.
        coco_data.CocoLoader`'s dict): augment, forward, match, losses,
        backward, clip, update.  Returns the last layer's loss terms (and
        the mask losses) and ``loss_total`` as device tensors."""
        self.model.train()
        B = len(batch["image"])
        draws = self.draw(B)
        if self.layout is not None:
            batch = self.layout.shard_tree(batch, B)
            draws = self.layout.shard_tree(draws, B)
        b = self._batch(batch)
        images, boxes, box_mask, gt_masks = self._augmented(b, draws)
        x = normalize(images, **self.norm)
        targets = prep_targets(b["labels"], boxes, box_mask, b["mask"],
                               self.image_size)
        outputs = self.model(x)
        layers = list(outputs.get("aux_outputs", [])) + [outputs]
        assign = self.match(layers, targets)
        with global_denominators(self.layout and self.layout.batch_group):
            total, logs = self.losses(outputs, targets, assign,
                                      gt_masks if self.masks else None)
        _step_update(self.layout, self.params, self.optimizer, total,
                     self.grad_clip)
        return _reduce_logs({**{k: v.detach() for k, v in logs.items()},
                             "loss_total": total.detach()}, self.layout)

    def train_one_epoch(self, loader, epoch: int, print_freq: int = 10,
                        warmup: bool = True,
                        log_fn: Optional[Callable] = None
                        ) -> Dict[str, float]:
        """One epoch of :meth:`train_step` (:func:`_epoch`), the warmup
        over ``min(len(loader), warmup_steps)`` steps."""
        return _epoch(self.train_step, loader, epoch, self.set_lr,
                      self.base_lr, self.warmup_steps, print_freq, warmup,
                      log_fn)

    def train_one_epoch_scan(self, loader, epoch: int,
                             steps_per_dispatch: int = 8,
                             warmup: bool = True,
                             log_fn: Optional[Callable] = None
                             ) -> Dict[str, float]:
        """The chunked epoch (:func:`_scan_epoch`) for the device matcher;
        the host matcher reads the device every step, so it raises, as
        the JAX trainer does."""
        if self.matcher != "device":
            raise ValueError("train_one_epoch_scan requires matcher='device'"
                             " (host Hungarian needs a round-trip per step)")
        return _scan_epoch(self.train_step, loader, epoch,
                           steps_per_dispatch, self.set_lr, self.base_lr,
                           self.warmup_steps, warmup, log_fn)

    def checkpoint_state(self, epoch: int) -> Dict[str, Any]:
        """What a detection checkpoint holds after ``epoch``: the model's
        state dict (BatchNorm buffers included), the optimizer's, the
        generator's state (the JAX ``rng``) and the epoch."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "epoch": epoch}

    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`checkpoint_state`'s dict."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        # a CUDA generator's state is a CPU ByteTensor
        self.generator.set_state(state["generator"].cpu())

    def predict(self, batch: dict) -> Dict[str, torch.Tensor]:
        """:func:`predict_detr` of the trainer's model."""
        return predict_detr(self.model, self.norm, self.image_size, batch,
                            self.masks)

    def evaluate(self, loader, coco_gt, iou_types=("bbox",),
                 score_threshold: float = 0.0,
                 label_to_cat: Optional[Dict[int, int]] = None,
                 panoptic: bool = False) -> Dict[str, Dict[str, float]]:
        """The reference's ``evaluate`` (``object/engine.py:70-110``):
        predictions, ``CocoEvaluator`` update (with the keypoints where
        the predictions have them), accumulate, summarize;
        ``label_to_cat`` maps the model's contiguous labels back to COCO
        ids.  With ``"segm"`` in ``iou_types`` the predicted masks are
        scored as RLEs at the original resolution (the reference's
        ``object/engine.py:58-67``); with ``panoptic`` they are also
        painted into segment maps and scored as PQ (``out["panoptic"]``:
        pq, sq, rq, n).  Each image's masks are unpacked, taken back to
        the original pixels (:func:`_unletterbox_masks`) and encoded by
        :class:`~vit_torch_tpu_torch.detection.coco_eval.CocoEvaluator`
        (the JAX package's pixel route, with PQ or without).  Under a
        mesh each rank takes every n-th batch and the results (and PQ
        counts) are merged across the ranks.  One batch deep: batch i + 1's forward is queued, and its predictions start
        for the host, before batch i's host work, whose per-image part
        runs on a pool of 8 threads.  ``last_eval_profile`` splits the
        host time: waiting for the predictions (``t_get``), the per-image
        updates (``t_host``), the final accumulate with PQ
        (``t_final``)."""
        from concurrent.futures import ThreadPoolExecutor
        evaluator = CocoEvaluator(coco_gt, iou_types)
        want_masks = "segm" in iou_types or panoptic
        pq = PQStat() if panoptic else None
        S = self.image_size
        prof = {"t_get": 0.0, "t_host": 0.0, "t_final": 0.0, "images": 0}
        self.last_eval_profile = prof

        def prep_image(args):
            """One image's update (and PQ inputs): score filter, label
            map, the masks' pixels."""
            preds, batch, b = args
            keep = preds["scores"][b] >= score_threshold
            labels = preds["labels"][b][keep]
            if label_to_cat:
                labels = np.asarray([label_to_cat.get(int(l), int(l))
                                     for l in labels])
            update = {"boxes": preds["boxes"][b][keep],
                      "scores": preds["scores"][b][keep],
                      "labels": labels}
            if "keypoints" in preds:
                update["keypoints"] = preds["keypoints"][b][keep]
            geometry = (batch["scale"][b], batch["pad"][b],
                        batch["orig_size"][b])
            if want_masks and "masks_packed" in preds:
                # the packed width is byte-padded: slice back to S
                pix = np.unpackbits(preds["masks_packed"][b][keep],
                                    axis=-1)[..., :S]
                update["masks"] = _unletterbox_masks(pix, *geometry)
            img_id = int(batch["image_id"][b])
            pq_args = (_pq_prepare(coco_gt, img_id, update)
                       if pq is not None and "masks" in update else None)
            return img_id, update, pq_args

        def drain(pool, batch, host, event):
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            preds = {k: v.numpy() for k, v in host.items()}
            t1 = time.perf_counter()
            todo = [(preds, batch, b) for b in range(len(batch["image_id"]))
                    if batch["mask"][b] != 0]
            # the per-image work on the pool; the evaluator and PQ
            # accumulate here, in image order
            for img_id, update, pq_args in pool.map(prep_image, todo):
                if pq_args is not None:
                    pq.update(*pq_args)
                evaluator.update({img_id: update})
            prof["images"] += len(todo)
            prof["t_get"] += t1 - t0
            prof["t_host"] += time.perf_counter() - t1

        share = ((self.layout.batch_index, self.layout.batch_count)
                 if getattr(self, "layout", None) is not None else (0, 1))
        with ThreadPoolExecutor(max_workers=8) as pool:
            pending = None
            for i, batch in enumerate(loader):
                if i % share[1] != share[0]:
                    continue
                host, event = _to_host(self.predict(batch))
                if pending is not None:
                    drain(pool, *pending)
                pending = (batch, host, event)
            if pending is not None:
                drain(pool, *pending)
        t0 = time.perf_counter()
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        out = evaluator.summarize()
        if pq is not None and share[1] > 1:
            from vit_torch_tpu_torch.parallel.multihost import (
                all_gather_objects)
            merged = PQStat()
            for part in all_gather_objects(pq):
                merged.merge(part)
            pq = merged
        if pq is not None:
            out["panoptic"] = {k: v for k, v in pq.summarize().items()
                               if k != "per_class"}
        prof["t_final"] = time.perf_counter() - t0
        return out


class FasterRCNNTrainer:
    """The Faster R-CNN / Keypoint R-CNN engine (the reference's
    ``object/coco_pipeline.py:442-559`` with ``object/engine.py``): one
    step is the flip, the forward, the losses with the matching and the
    balanced sampling on the device, the backward, the clip and the SGD
    update; nothing in it reads the device before the loss terms are
    logged.  BatchNorm trains in train mode, its running statistics
    updated as the JAX ``batch_stats`` are.

    Every random draw of a step comes from one generator on the model's
    device, seeded with ``seed``, in :meth:`draw`: the flip (B,), the RPN
    sampling noise (B, ΣA) and the RoI noise (B, num_proposals).  The
    JAX trainer splits its key per step, image and stage instead; a test
    feeds those draws in by replacing :meth:`draw`."""

    GRAD_CLIP = 10.0          # the global-norm clip of the JAX chain

    def __init__(self, model: torch.nn.Module, *, cfg, lr: float = 2e-3,
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 augment: bool = False, kp_flip_inds=None,
                 norm_values: Optional[dict] = None, seed: int = 0,
                 mesh=None) -> None:
        """``model`` is a :class:`~vit_torch_tpu_torch.detection.
        faster_rcnn.FasterRCNN` on its device; ``kp_flip_inds`` the
        keypoints' left/right swap under the flip (None keeps their
        order); ``mesh`` as :class:`DetectionTrainer`'s."""
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.image_size = cfg.image_size
        self.augment = augment
        self.kp_flip = (None if kp_flip_inds is None else torch.as_tensor(
            list(kp_flip_inds), dtype=torch.long).to(self.device))
        self.norm = norm_values or NORM_VALUES["imagenet"]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(model, self.generator)
        self.layout = _data_layout(model, mesh)
        self.params = [p for p in model.parameters() if p.requires_grad]
        # coupled decay: g + wd·p before the momentum, as the JAX chain's
        # add_decayed_weights then sgd
        self.optimizer = torch.optim.SGD(self.params, lr=lr,
                                         momentum=momentum,
                                         weight_decay=weight_decay)
        self.base_lr = lr
        self.warmup_steps = 1000
        self.last_eval_profile: Dict[str, float] = {}

    def set_lr(self, lr: float) -> None:
        set_learning_rate(self.optimizer, lr)

    def _batch(self, batch: dict) -> Dict[str, torch.Tensor]:
        out = _device_batch(batch, self.device)
        if "gt_keypoints" in batch:
            out["keypoints"] = _to_device(batch["gt_keypoints"], self.device,
                                          torch.float32)
        return out

    def draw(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """One step's random draws (see the class)."""
        flip = draw_hflip(self.generator, batch_size, self.device)
        return {"flip": flip, **draw_noise(self.generator, self.cfg,
                                           batch_size, self.device)}

    def losses(self, batch: dict, draws: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The train-mode forward and :func:`~vit_torch_tpu_torch.
        detection.faster_rcnn.faster_rcnn_losses` of a host batch under
        ``draws`` (the flip applies where ``augment``)."""
        self.model.train()
        if self.layout is not None:
            batch = self.layout.shard_tree(batch, len(batch["image"]))
        b = self._batch(batch)
        images, boxes, kps = b["image"], b["boxes"], b.get("keypoints")
        if self.augment:
            flipped = apply_hflip(draws["flip"], images, boxes,
                                  self.image_size, kps, self.kp_flip)
            images, boxes = flipped[:2]
            if kps is not None:
                kps = flipped[2]
        outputs = self.model(normalize(images, **self.norm))
        targets = {"boxes": boxes, "labels": b["labels"],
                   "box_mask": b["box_mask"], "mask": b["mask"]}
        if kps is not None:
            targets["keypoints"] = kps
        with global_denominators(self.layout and self.layout.batch_group):
            return faster_rcnn_losses(outputs, targets, self.cfg, draws)

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One step on a host batch; returns the loss terms and
        ``loss_total`` as device tensors.  Under a mesh the draws are the
        global batch's and each rank keeps its rows."""
        B = len(batch["image"])
        draws = self.draw(B)
        if self.layout is not None:
            draws = self.layout.shard_tree(draws, B)
        losses = self.losses(batch, draws)
        _step_update(self.layout, self.params, self.optimizer,
                     losses["loss"], self.GRAD_CLIP)
        logs = {k: v.detach() for k, v in losses.items() if k != "loss"}
        logs["loss_total"] = losses["loss"].detach()
        return _reduce_logs(logs, self.layout)

    def train_one_epoch(self, loader, epoch: int, print_freq: int = 10,
                        warmup: bool = True,
                        log_fn: Optional[Callable] = None
                        ) -> Dict[str, float]:
        """One epoch of :meth:`train_step` (:func:`_epoch`), the warmup
        over ``min(len(loader), 1000)`` steps."""
        return _epoch(self.train_step, loader, epoch, self.set_lr,
                      self.base_lr, self.warmup_steps, print_freq, warmup,
                      log_fn)

    def train_one_epoch_scan(self, loader, epoch: int,
                             steps_per_dispatch: int = 8,
                             warmup: bool = True,
                             log_fn: Optional[Callable] = None
                             ) -> Dict[str, float]:
        """The chunked epoch (:func:`_scan_epoch`); nothing in a step
        reads the device before its loss."""
        return _scan_epoch(self.train_step, loader, epoch,
                           steps_per_dispatch, self.set_lr, self.base_lr,
                           self.warmup_steps, warmup, log_fn)

    def predict(self, batch: dict) -> Dict[str, torch.Tensor]:
        """:func:`predict_faster_rcnn` of the trainer's model."""
        return predict_faster_rcnn(self.model, self.norm, batch)

    # checkpoints and COCO evaluation are the DETR engine's
    checkpoint_state = DetectionTrainer.checkpoint_state
    load_checkpoint_state = DetectionTrainer.load_checkpoint_state
    evaluate = DetectionTrainer.evaluate
