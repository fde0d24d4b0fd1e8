"""Classifier and detector serving bundles, counterpart of
``vit_torch_tpu/serving/export.py``.

A bundle is a directory holding ``manifest.json`` and ``weights.pt`` (the
classifier's state dict, written with ``torch.save``).  The manifest keeps
the JAX package's fields, with this package's own ``format`` and
``torch_version``, and adds the ``classifier`` units that rebuild the
model.  Loading needs this package, not the checkpoint the weights came
from; there is no traced artifact (the JAX package's StableHLO).

Serving contract per bundle:

    uint8 images (bs, H, W, C)  →  fp32 logits (bs, num_classes)

with ``(x/255 - mean)/std`` computed in the activation dtype; C is the
manifest's ``image_channels`` (3, or a tire model's LBP channel stack).
``ServingModel.predict`` pads a batch up to the smallest bucket that holds
it and slices the padding off; oversize batches run in chunks of the
largest bucket.

W8A8 (``ops/quant.py``): a bundle exported under ``VITX_W8A8=1`` has
``"w8a8": true`` in its manifest and serves every quantised product
(:class:`~vit_torch_tpu_torch.models.layers.QLinear`) through int8,
whatever ``VITX_W8A8`` says when it is loaded; a bundle without it serves
in fp even with the flag set.  The JAX package bakes the path into its
traced artifact; here the manifest carries it.  With ``prequant`` (the
default) each quantised layer's weight is stored as its int8 rows
(``<layer>.weight_q``, ``(N, K)``) and fp32 scales (``<layer>.weight_scale``)
in place of the fp32 ``<layer>.weight``, and ``"w8a8_prequant": true``;
a family without such layers (ResNet) stores fp32 weights and says false.

Detection bundles (:func:`export_detector`, format
``vit_torch_tpu_torch.serving.detection/1``) hold a DETR (DETRSegm) or
Faster R-CNN (Keypoint R-CNN) trainer's model in the same layout; the
manifest adds what rebuilds it (head, backbone, config, classes, norm,
activation dtype) and the outputs' names, shapes and dtypes.  Their
contract is the eval loader's batch:

    {"image": uint8 (bs, S, S, 3), "scale": f32 (bs,), "pad": f32 (bs, 2)}
        →  {"scores", "labels", "boxes"[, "keypoints" | "masks_packed"]}

built from pictures of any size by :func:`letterbox_images`; the served
forward is the trainer's own predict function
(``detection/engine.py:predict_detr`` / ``predict_faster_rcnn``).
``DetectionServingModel.predict_tree`` pads every leaf up to a bucket and
slices every output back.  The JAX package's StableHLO bundles are
refused like any foreign format.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vit_torch_tpu_torch.device import resolve_device
from vit_torch_tpu_torch.models.layers import QLinear, set_w8a8
from vit_torch_tpu_torch.models.zoo import (VisionModelZoo, ZooModel,
                                            reset_buffers)
from vit_torch_tpu_torch.ops.quant import quantize_weight, w8a8_enabled

FORMAT = "vit_torch_tpu_torch.serving/1"
DETECTION_FORMAT = "vit_torch_tpu_torch.serving.detection/1"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"


@dataclasses.dataclass
class ServingModel:
    """A loaded classifier bundle on one device, or, for a data-parallel
    bundle (``num_devices > 1`` in its manifest), replicated onto several:
    ``replicas`` then holds ``(model, device, mean, std)`` for each, and a
    batch is split over them and the logits concatenated."""

    manifest: Dict
    model: torch.nn.Module
    device: torch.device
    mean: torch.Tensor
    std: torch.Tensor
    replicas: Optional[List[tuple]] = None

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return _buckets(self.manifest)

    @torch.inference_mode()
    def _forward(self, images: np.ndarray) -> np.ndarray:
        if self.replicas:
            # every replica's part queued before any is read back
            outs = [self._run(*rep, part) for rep, part in zip(
                self.replicas, np.array_split(images, len(self.replicas)))
                if len(part)]
            return np.concatenate([o.float().cpu().numpy() for o in outs])
        return self._run(self.model, self.device, self.mean, self.std,
                         images).float().cpu().numpy()

    @staticmethod
    def _run(model, device, mean, std, images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        return model((x.to(mean.dtype) / 255.0 - mean) / std)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Run raw uint8 NHWC images through the classifier."""
        C = self.manifest.get("image_channels", 3)
        if images.ndim != 4 or images.shape[-1] != C:
            raise ValueError(f"expected (bs, H, W, {C}) uint8, got "
                             f"{images.shape}")
        if np.asarray(images).dtype != np.uint8:
            raise ValueError(
                f"expected uint8 pixels in [0, 255], got {images.dtype} — "
                f"the bundle normalizes; do not pre-scale")
        _check_image_size(self.manifest, images.shape[1:3])
        n = images.shape[0]
        buckets = self.batch_sizes
        largest = buckets[-1]
        if n > largest:
            parts = [self.predict(images[i:i + largest])
                     for i in range(0, n, largest)]
            return np.concatenate(parts, axis=0)
        bs = next(b for b in buckets if b >= n)
        if n < bs:
            pad = np.zeros((bs - n,) + images.shape[1:], images.dtype)
            images = np.concatenate([images, pad], axis=0)
        return self._forward(np.ascontiguousarray(images))[:n]


def _check_image_size(manifest: Dict, hw) -> None:
    S = manifest.get("image_size")
    if S and tuple(hw) != (S, S):
        raise ValueError(
            f"this bundle was exported for {S}x{S} inputs, got "
            f"{hw[0]}x{hw[1]} — preprocess with "
            f"serving.letterbox_images (detection) or "
            f"data.datasets.resize_images (classification) first")


def _buckets(manifest: Dict) -> Tuple[int, ...]:
    return tuple(sorted(int(b) for b in manifest["batch_sizes"]))


@dataclasses.dataclass
class DetectionServingModel:
    """A loaded detection bundle on one device; ``predict`` is the
    trainer's predict function of the model, norm and batch."""

    manifest: Dict
    model: torch.nn.Module
    device: torch.device
    predict: Callable[[Dict], Dict[str, torch.Tensor]]

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return _buckets(self.manifest)

    @torch.inference_mode()
    def _forward(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.predict(batch).items()}

    def predict_tree(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Run a letterboxed batch (:func:`letterbox_images`): every leaf
        is padded along axis 0 up to the smallest bucket that holds it,
        every output sliced back to the request size; oversize batches
        run in chunks of the largest bucket."""
        if not batch:
            raise ValueError("empty batch")
        img = np.asarray(batch["image"])
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 'image', got {img.dtype} — use "
                             f"serving.letterbox_images to build the batch")
        if img.ndim != 4 or img.shape[-1] != 3:
            raise ValueError(f"expected (bs, H, W, 3) images, got "
                             f"{img.shape}")
        _check_image_size(self.manifest, img.shape[1:3])
        n = img.shape[0]
        buckets = self.batch_sizes
        largest = buckets[-1]
        if n > largest:
            parts = [self.predict_tree({k: np.asarray(v)[i:i + largest]
                                        for k, v in batch.items()})
                     for i in range(0, n, largest)]
            return {k: np.concatenate([p[k] for p in parts], axis=0)
                    for k in parts[0]}
        bs = next(b for b in buckets if b >= n)

        def pad(a):
            a = np.asarray(a)
            if a.shape[0] == bs:
                return np.ascontiguousarray(a)
            fill = np.zeros((bs - n,) + a.shape[1:], a.dtype)
            return np.concatenate([a, fill], axis=0)

        out = self._forward({k: pad(v) for k, v in batch.items()})
        return {k: v[:n] for k, v in out.items()}


def letterbox_images(images: Sequence[np.ndarray], image_size: int) -> Dict:
    """Host-side half of the detection serving contract: uint8 HWC images
    of any size → the bundle's fixed-shape batch.

    Mirrors the training loader (``detection/coco_data.py``: aspect-
    preserving bilinear resize, centred 114-gray padding, by
    ``letterbox_params``), so that serving sees what training saw; the
    bundle's postprocess maps boxes back to each original frame with
    ``scale`` and ``pad``."""
    from PIL import Image

    from vit_torch_tpu_torch.detection.coco_data import letterbox_params

    S = int(image_size)
    batch = {"image": np.full((len(images), S, S, 3), 114, np.uint8),
             "scale": np.zeros((len(images),), np.float32),
             "pad": np.zeros((len(images), 2), np.float32)}
    for i, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        h, w = img.shape[:2]
        scale, pad_x, pad_y, nh, nw = letterbox_params(h, w, S)
        resized = np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
            (nw, nh), Image.BILINEAR), np.uint8)
        batch["image"][i, pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
        batch["scale"][i] = scale
        batch["pad"][i] = (pad_x, pad_y)
    return batch


def _prequantize(model: torch.nn.Module, state: Dict,
                 cast: Optional[torch.dtype]) -> bool:
    """Replace each :class:`QLinear`'s ``weight`` in ``state`` by its int8
    rows and fp32 scales (Q1 on the model's device, from the weight as it
    is stored, cast or not).  Returns whether any layer was quantised."""
    found = False
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, QLinear):
                continue
            w = mod.weight if cast is None else mod.weight.to(cast)
            w_q, w_scale = quantize_weight(w)
            del state[f"{name}.weight"]
            state[f"{name}.weight_q"] = w_q.cpu()
            state[f"{name}.weight_scale"] = w_scale.cpu()
            found = True
    return found


def export_classifier(zoo_model: ZooModel, *,
                      batch_sizes: Sequence[int] = (1, 8, 32),
                      norm: Optional[Dict[str, Sequence[float]]] = None,
                      param_dtype: Optional[str] = None,
                      prequant: bool = True,
                      w8a8: Optional[bool] = None,
                      num_devices: int = 1) -> Dict:
    """Package a zoo classifier for serving.

    ``norm`` is ``{"mean": (3,), "std": (3,)}`` in 0-1 units (a
    ``data.datasets.NORM_VALUES`` entry); default is identity.
    ``param_dtype="bfloat16"`` casts the stored weights, halving the
    bundle; matmuls cast weights to the activation dtype anyway, and
    LayerNorm still computes in fp32.

    Under ``VITX_W8A8=1`` (or ``w8a8=True``, which overrides the flag
    either way) the bundle serves through int8 (``"w8a8"`` in the
    manifest); with ``prequant`` (default) its quantised layers' weights
    are stored as int8 rows and fp32 scales, about a quarter of their fp32
    bytes, and serving skips the per-call weight quantisation.
    ``prequant=False`` keeps the fp32 weights, quantised per call.

    ``num_devices > 1`` makes a data-parallel bundle: :func:`load_bundle`
    replicates the model onto that many devices and splits each batch
    over them (the JAX bundle shards its batch axis over a device mesh);
    a machine with fewer devices refuses it.

    Returns ``{"manifest": dict, "state_dict": dict}``."""
    norm = norm or {"mean": (0.0, 0.0, 0.0), "std": (1.0, 1.0, 1.0)}
    cast = getattr(torch, param_dtype) if param_dtype else None
    state = {k: (v.detach().to("cpu", cast) if cast is not None
                 and v.is_floating_point() else v.detach().cpu())
             for k, v in zoo_model.model.state_dict().items()}
    w8a8 = w8a8_enabled() if w8a8 is None else w8a8
    prequantized = w8a8 and prequant and _prequantize(zoo_model.model,
                                                      state, cast)
    classifier = zoo_model.classifier
    manifest = {
        "format": FORMAT,
        "arch": zoo_model.arch,
        "family": zoo_model.family,
        "image_size": int(zoo_model.image_size),
        "image_channels": int(zoo_model.image_channels),
        "batch_sizes": sorted(set(int(b) for b in batch_sizes)),
        "num_classes": int(classifier[-1] if classifier
                           else zoo_model.feature_dim),
        "classifier": classifier,
        "norm": {"mean": list(map(float, norm["mean"])),
                 "std": list(map(float, norm["std"]))},
        "platforms": ["cuda", "cpu"],
        "activation_dtype": str(zoo_model.dtype).replace("torch.", ""),
        "param_dtype": str(param_dtype) if param_dtype else "float32",
        "num_devices": int(num_devices),
        "w8a8": w8a8,
        "w8a8_prequant": prequantized,
        "torch_version": torch.__version__,
    }
    return {"manifest": manifest, "state_dict": state}


def _detection_predict(manifest: Dict) -> Callable:
    """The trainer's predict function for a detection manifest, as a
    function of the model and the batch."""
    from vit_torch_tpu_torch.detection.engine import (predict_detr,
                                                      predict_faster_rcnn)
    norm = manifest["norm"]
    if manifest["head"] == "faster_rcnn":
        return lambda model, batch: predict_faster_rcnn(model, norm, batch)
    S, masks = int(manifest["image_size"]), bool(manifest["masks"])
    return lambda model, batch: predict_detr(model, norm, S, batch, masks)


def export_detector(trainer, *, image_size: int,
                    batch_sizes: Sequence[int] = (1, 8),
                    prequant: bool = True) -> Dict:
    """Package a detection trainer's model for serving: ``DetectionTrainer``
    (DETR: scores, labels, boxes; DETRSegm adds the bit-packed masks) or
    ``FasterRCNNTrainer`` (the padded top-D detections, with keypoints
    for Keypoint R-CNN).  The state dict carries BatchNorm's statistics.
    Under ``VITX_W8A8=1`` with ``prequant`` (default) the QLinear weights
    (DETR's transformer and Swin MLPs, Faster R-CNN's ``box_fc1`` and
    ``box_fc2``) are stored as int8 rows and fp32 scales, as
    :func:`export_classifier` stores them.  The outputs' names, shapes
    and dtypes come from one predict at the smallest bucket.

    Returns ``{"manifest": dict, "state_dict": dict}``."""
    from vit_torch_tpu_torch.detection.engine import FasterRCNNTrainer
    model = trainer.model
    head = "faster_rcnn" if isinstance(trainer, FasterRCNNTrainer) else "detr"
    masks = head == "detr" and bool(trainer.masks)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    w8a8 = w8a8_enabled()
    prequantized = w8a8 and prequant and _prequantize(model, state, None)
    buckets = sorted(set(int(b) for b in batch_sizes))
    cfg = dataclasses.asdict(model.config)
    manifest = {
        "format": DETECTION_FORMAT,
        "image_size": int(image_size),
        "batch_sizes": buckets,
        "head": head,
        "masks": masks,
        "num_mask_heads": int(getattr(model, "num_mask_heads", 0)),
        "backbone": model.backbone_arch,
        "config": cfg,
        "num_classes": int(cfg["num_classes"]),
        "norm": {"mean": list(map(float, trainer.norm["mean"])),
                 "std": list(map(float, trainer.norm["std"]))},
        "activation_dtype": str(model.dtype).replace("torch.", ""),
        "platforms": ["cuda", "cpu"],
        "num_devices": 1,
        "w8a8": w8a8,
        "w8a8_prequant": prequantized,
        "torch_version": torch.__version__,
    }
    S, n = int(image_size), buckets[0]
    sample = {"image": np.zeros((n, S, S, 3), np.uint8),
              "scale": np.ones((n,), np.float32),
              "pad": np.zeros((n, 2), np.float32)}
    with torch.inference_mode():
        outs = _detection_predict(manifest)(model, sample)
    manifest["outputs"] = [
        {"name": k, "shape": list(v.shape),
         "dtype": str(v.dtype).replace("torch.", "")}
        for k, v in sorted(outs.items())]
    return {"manifest": manifest, "state_dict": state}


def _load_detector(manifest: Dict, state: Dict,
                   dev: torch.device) -> DetectionServingModel:
    """Rebuild a detection bundle's model on the meta device, load its
    weights with ``assign=True`` and move it to ``dev``."""
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.faster_rcnn import (FasterRCNNConfig,
                                                           build_faster_rcnn)
    dt = getattr(torch, manifest["activation_dtype"])
    cfg = manifest["config"]
    if manifest["head"] == "faster_rcnn":
        cfg = FasterRCNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in cfg.items()})
        model = build_faster_rcnn(cfg, manifest["backbone"], dt,
                                  device="meta")
    else:
        model = build_detr(DETRConfig(**cfg), manifest["backbone"],
                           int(manifest["image_size"]), dt, device="meta",
                           masks=bool(manifest["masks"]),
                           num_mask_heads=int(manifest["num_mask_heads"])
                           or 8)
    for key in [k for k in state if k.endswith(".weight_q")]:
        layer = key[:-len(".weight_q")]
        model.get_submodule(layer).set_prequant(
            state[key], state[f"{layer}.weight_scale"])
    model.load_state_dict(state, assign=True)
    reset_buffers(model, "cpu")
    model = model.to(dev).eval()
    # the manifest, not the server's environment, decides the path
    set_w8a8(model, bool(manifest.get("w8a8", False)))
    predict = _detection_predict(manifest)
    return DetectionServingModel(manifest=manifest, model=model, device=dev,
                                 predict=lambda batch: predict(model, batch))


def save_bundle(bundle_dir: str, exported: Dict) -> None:
    """Write ``export_classifier``'s or ``export_detector``'s result as a
    directory bundle."""
    os.makedirs(bundle_dir, exist_ok=True)
    torch.save(exported["state_dict"], os.path.join(bundle_dir, _WEIGHTS))
    with open(os.path.join(bundle_dir, _MANIFEST), "w") as f:
        json.dump(exported["manifest"], f, indent=1)


def _replica_devices(manifest: Dict, dev: torch.device,
                     devices: Optional[Sequence]) -> List[torch.device]:
    """The devices a data-parallel bundle replicates onto: ``devices``, or
    ``cuda:0..N-1``; fewer than the manifest's ``num_devices`` raises, as
    the JAX bundle does."""
    n = int(manifest.get("num_devices", 1))
    if devices is not None:
        have = [torch.device(d) for d in devices]
    elif dev.type == "cuda":
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        have = [dev]
    if len(have) < n:
        raise ValueError(f"bundle needs {n} devices, have {len(have)}")
    return have[:n]


def load_bundle(bundle_dir: str,
                device: Optional[Union[str, torch.device]] = None,
                devices: Optional[Sequence] = None
                ) -> Union[ServingModel, DetectionServingModel]:
    """Load a bundle directory onto ``device`` (CUDA when omitted): a
    classifier's as a :class:`ServingModel`, a detector's as a
    :class:`DetectionServingModel`.  A data-parallel classifier bundle
    (``num_devices > 1``) loads onto ``devices`` (default ``cuda:0..N-1``)
    and raises ``ValueError`` where fewer are present."""
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    fmt = str(manifest.get("format", ""))
    if fmt not in (FORMAT, DETECTION_FORMAT):
        raise ValueError(f"{bundle_dir} holds a {fmt!r} bundle; this "
                         f"package serves {FORMAT!r} and "
                         f"{DETECTION_FORMAT!r}")
    if not manifest["batch_sizes"]:
        raise ValueError(f"no batch sizes in {bundle_dir}")
    if fmt == DETECTION_FORMAT:
        state = torch.load(os.path.join(bundle_dir, _WEIGHTS),
                           map_location="cpu", weights_only=True)
        return _load_detector(manifest, state, dev)
    dt = getattr(torch, manifest["activation_dtype"])
    zm = VisionModelZoo.get_model(
        manifest["arch"], classifier=manifest["classifier"],
        image_size=manifest["image_size"], dtype=dt, device="meta",
        image_channels=manifest.get("image_channels", 3))
    state = torch.load(os.path.join(bundle_dir, _WEIGHTS),
                       map_location="cpu", weights_only=True)
    for key in [k for k in state if k.endswith(".weight_q")]:
        layer = key[:-len(".weight_q")]
        zm.model.get_submodule(layer).set_prequant(
            state[key], state[f"{layer}.weight_scale"])
    zm.model.load_state_dict(state, assign=True)
    reset_buffers(zm.model, "cpu")
    model = zm.model.to(dev).eval()
    # the manifest, not the server's environment, decides the path
    set_w8a8(model, bool(manifest.get("w8a8", False)))
    norm = manifest["norm"]
    replicas = None
    if int(manifest.get("num_devices", 1)) > 1:
        replicas = []
        for d in _replica_devices(manifest, dev, devices):
            rep = copy.deepcopy(model).to(d).eval()
            replicas.append((rep, d, torch.tensor(norm["mean"], dtype=dt,
                                                  device=d),
                             torch.tensor(norm["std"], dtype=dt, device=d)))
        model, dev = replicas[0][0], replicas[0][1]
    return ServingModel(
        manifest=manifest, model=model, device=dev,
        mean=torch.tensor(norm["mean"], dtype=dt, device=dev),
        std=torch.tensor(norm["std"], dtype=dt, device=dev),
        replicas=replicas)
