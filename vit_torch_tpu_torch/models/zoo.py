"""Model zoo facade, counterpart of ``vit_torch_tpu/models/zoo.py``.

``VisionModelZoo.get_model(arch, ...)`` returns a :class:`ZooModel` whose
``model`` is a :class:`Classifier` (backbone + optional MLP head) with
seeded weights on the requested device.  Every family of the JAX
package is ported: dino/vit, swin, cait, deit, xcit and resnet
(ResNeXt/WRN).  ``available_archs`` lists every arch,
``get_output_shape`` runs a model on the meta device, and ``remat``
recomputes each backbone block in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vit_torch_tpu_torch.device import resolve_device
from vit_torch_tpu_torch.models.cait import CAIT_CONFIGS, CaiT
from vit_torch_tpu_torch.models.deit import DEIT_CONFIGS, build_deit
from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
from vit_torch_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet
from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, SwinTransformer
from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, VisionTransformer
from vit_torch_tpu_torch.models.xcit import XCIT_CONFIGS, XCiT


class Classifier(nn.Module):
    """Backbone + optional MLP head; state dict keys ``backbone.*`` and
    ``head.*``."""

    def __init__(self, backbone: nn.Module, head: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        if self.head is not None:
            feats = self.head(feats)
        return feats


@dataclasses.dataclass
class ZooModel:
    arch: str
    family: str
    model: Classifier
    feature_dim: int
    image_size: int
    classifier: Optional[List[int]] = None
    patch_size: Optional[int] = None
    image_channels: int = 3

    @property
    def dtype(self) -> torch.dtype:
        return self.model.backbone.dtype


# arch-string prefix → family, as in the JAX package
_ARCH_FAMILIES: List = [
    ("dino_", "dino"),
    ("vit_", "dino"),
    ("cait", "cait"),
    ("xcit", "xcit"),
    ("swin", "swin"),
    ("deit", "deit"),
    ("resnext", "resnet"),
    ("wide_resnet", "resnet"),
    ("resnet", "resnet"),
]


def arch_family(arch: str) -> str:
    for prefix, family in _ARCH_FAMILIES:
        if arch.startswith(prefix):
            return family
    raise ValueError(f"unknown arch {arch!r}; known families: "
                     f"{sorted(set(f for _, f in _ARCH_FAMILIES))}")


# family → (its configs, the function that makes its backbone from a
# config); a DeiT config is a (ViTConfig, distilled) pair
_PORTED = {"dino": (VIT_CONFIGS, VisionTransformer),
           "swin": (SWIN_CONFIGS, SwinTransformer),
           "cait": (CAIT_CONFIGS, CaiT),
           "deit": (DEIT_CONFIGS, build_deit),
           "xcit": (XCIT_CONFIGS, XCiT),
           "resnet": (RESNET_CONFIGS, ResNet)}


def reset_buffers(model: nn.Module,
                  device: Optional[Union[str, torch.device]] = None) -> None:
    """Recompute every module's computed buffers (Swin's relative-position
    index and shifted-window masks) on ``device`` (each buffer's own when
    None): after ``to_empty``, or after a state-dict load into a model
    built on meta, whose non-persistent buffers hold no data."""
    for mod in model.modules():
        if hasattr(mod, "reset_buffers"):
            mod.reset_buffers(None if device is None
                              else torch.device(device))


class VisionModelZoo:
    """Facade: ``get_model(arch, ...)`` → :class:`ZooModel`."""

    @classmethod
    def available_archs(cls) -> List[str]:
        """Every arch the zoo builds, sorted (the JAX facade's set)."""
        return sorted({arch for configs, _ in _PORTED.values()
                       for arch in configs})

    @classmethod
    def get_model(
        cls,
        arch: str,
        image_channels: int = 3,
        classifier: Optional[Sequence[int]] = None,
        image_size: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ) -> ZooModel:
        """Build a zoo model with seeded weights.

        ``classifier=None`` gives the headless backbone (features out);
        ``classifier=[*fc, num_labels]`` appends the MLP head.  Weights are
        drawn on the CPU from ``generator`` (seed 0 when omitted), so a seed
        gives the same weights on every device, then moved to ``device``
        (CUDA when omitted).  ``device="meta"`` skips the init, for callers
        that load a state dict next.  ``image_size`` defaults to the
        config's ``default_image_size`` where it has one (CaiT), else to
        384 for the ``*384*`` archs and to 224 otherwise.  ``remat`` runs
        each backbone block under ``torch.utils.checkpoint`` when a
        gradient is recorded (``layers.run_block``; the JAX package's
        ``jax.checkpoint`` per block)."""
        dev = resolve_device(device)
        family = arch_family(arch)
        if family not in _PORTED:
            raise NotImplementedError(
                f"model family {family!r} (arch {arch!r}) is not ported yet; "
                f"see ROADMAP.md for the order of the port")
        configs, build = _PORTED[family]
        if arch not in configs:
            raise ValueError(f"unknown {family} arch {arch!r}; have "
                             f"{sorted(configs)}")
        if image_size is None:
            image_size = getattr(configs[arch], "default_image_size",
                                 384 if "384" in arch else 224)
        with torch.device("meta"):
            backbone = build(configs[arch], image_size=image_size,
                             image_channels=image_channels, dtype=dtype)
            backbone.remat = remat
            head = (ClassifierHead(backbone.feature_dim, classifier)
                    if classifier else None)
            model = Classifier(backbone, head)
        if dev.type != "meta":
            model.to_empty(device="cpu")
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            init_weights(model, generator)
            reset_buffers(model)
            model.to(dev)
        model.eval()
        return ZooModel(arch=arch, family=family, model=model,
                        feature_dim=backbone.feature_dim,
                        image_size=image_size,
                        classifier=list(classifier) if classifier else None,
                        patch_size=getattr(backbone.config, "patch_size",
                                           None),
                        image_channels=image_channels)

    @classmethod
    def get_output_shape(cls, zoo_model: ZooModel, image_size: int,
                         image_channels: int = 3) -> Tuple[int, ...]:
        """The output shape of ``zoo_model`` for one ``image_size`` image,
        with no memory and no FLOPs spent (the JAX facade's
        ``jax.eval_shape``): a copy of the model is built on the meta
        device and run on fake CPU tensors, which carry shapes only.  (On
        meta tensors the kernel wrappers raise: they take the plain version
        only for CPU tensors.)"""
        from torch._subclasses.fake_tensor import FakeTensorMode
        twin = cls.get_model(zoo_model.arch, image_channels=image_channels,
                             classifier=zoo_model.classifier,
                             image_size=image_size, dtype=zoo_model.dtype,
                             device="meta")
        with FakeTensorMode(allow_non_fake_inputs=True):
            twin.model.to_empty(device="cpu")
            reset_buffers(twin.model, "cpu")
            x = torch.empty((1, image_size, image_size, image_channels))
            return tuple(twin.model(x).shape)
