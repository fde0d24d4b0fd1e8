"""Classifier serving bundles, counterpart of
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
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vit_torch_tpu_torch.device import resolve_device
from vit_torch_tpu_torch.models.layers import QLinear, set_w8a8
from vit_torch_tpu_torch.models.zoo import (VisionModelZoo, ZooModel,
                                            reset_buffers)
from vit_torch_tpu_torch.ops.quant import quantize_weight, w8a8_enabled

FORMAT = "vit_torch_tpu_torch.serving/1"
_DETECTION_FORMAT = "vit_torch_tpu.serving.detection"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"


@dataclasses.dataclass
class ServingModel:
    """A loaded classifier bundle on one device."""

    manifest: Dict
    model: torch.nn.Module
    device: torch.device
    mean: torch.Tensor
    std: torch.Tensor

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return tuple(sorted(int(b) for b in self.manifest["batch_sizes"]))

    @torch.inference_mode()
    def _forward(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(images).to(self.device)
        x = (x.to(self.mean.dtype) / 255.0 - self.mean) / self.std
        return self.model(x).float().cpu().numpy()

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
        self._check_image_size(images.shape[1:3])
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

    def _check_image_size(self, hw) -> None:
        S = self.manifest.get("image_size")
        if S and tuple(hw) != (S, S):
            raise ValueError(
                f"this bundle was exported for {S}x{S} inputs, got "
                f"{hw[0]}x{hw[1]} — preprocess with "
                f"data.datasets.resize_images first")


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
                      w8a8: Optional[bool] = None) -> Dict:
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
        "num_devices": 1,
        "w8a8": w8a8,
        "w8a8_prequant": prequantized,
        "torch_version": torch.__version__,
    }
    return {"manifest": manifest, "state_dict": state}


def save_bundle(bundle_dir: str, exported: Dict) -> None:
    """Write ``export_classifier``'s result as a directory bundle."""
    os.makedirs(bundle_dir, exist_ok=True)
    torch.save(exported["state_dict"], os.path.join(bundle_dir, _WEIGHTS))
    with open(os.path.join(bundle_dir, _MANIFEST), "w") as f:
        json.dump(exported["manifest"], f, indent=1)


def load_bundle(bundle_dir: str,
                device: Optional[Union[str, torch.device]] = None
                ) -> ServingModel:
    """Load a bundle directory onto ``device`` (CUDA when omitted)."""
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    fmt = str(manifest.get("format", ""))
    if fmt.startswith(_DETECTION_FORMAT):
        raise NotImplementedError(
            "detection bundles are not served by the port yet (detection "
            "slice, ROADMAP.md)")
    if fmt != FORMAT:
        raise ValueError(f"{bundle_dir} holds a {fmt!r} bundle; this "
                         f"package serves {FORMAT!r}")
    if not manifest["batch_sizes"]:
        raise ValueError(f"no batch sizes in {bundle_dir}")
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
    return ServingModel(
        manifest=manifest, model=model, device=dev,
        mean=torch.tensor(norm["mean"], dtype=dt, device=dev),
        std=torch.tensor(norm["std"], dtype=dt, device=dev))
