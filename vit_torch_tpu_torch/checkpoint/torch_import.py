"""Torch checkpoints into the port's models, counterpart of the serving
part of ``vit_torch_tpu/checkpoint/torch_import.py``.

The port's parameter names are DINO's, timm/Facebook DeiT's and CaiT's,
Microsoft Swin's, facebookresearch/xcit's and torchvision's, so each of
those state dicts loads as it is (CaiT's ``module.`` prefix is stripped),
XCiT's and ResNeXt/WRN's with their BatchNorm running statistics; what
remains is unwrapping the published checkpoint variants, skipping Swin's
computed buffers and the classifier heads, and bicubic interpolation of
the position table to the model's grid, with the JAX package's
``jax.image.resize`` semantics (Keys cubic, a = -0.5, half-pixel centres,
antialiased when shrinking) written in numpy.  The loader is chosen by the
backbone's family, as the JAX package's ``_FAMILY_IMPORTERS`` does.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import numpy as np
import torch
from torch import nn


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) bicubic resampling matrix of ``jax.image.resize``."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None])
                    / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(pos: np.ndarray, target_tokens: int,
                          num_prefix: int = 1) -> np.ndarray:
    """Bicubic-resize the patch-grid part of a ``(1, P+prefix, D)`` position
    table to ``target_tokens`` patch positions (DINO semantics)."""
    n_patch = pos.shape[1] - num_prefix
    if n_patch == target_tokens:
        return pos
    prefix, grid = pos[:, :num_prefix], pos[:, num_prefix:]
    src = int(round(n_patch ** 0.5))
    dst = int(round(target_tokens ** 0.5))
    if src * src != n_patch or dst * dst != target_tokens:
        raise ValueError(
            f"non-square pos-embed grids: {n_patch} -> {target_tokens}")
    D = pos.shape[2]
    w = _resize_weights(src, dst).astype(np.float32)
    grid = grid.reshape(src, src, D).astype(np.float32)
    grid = np.einsum("hwd,hy,wx->yxd", grid, w, w)
    return np.concatenate(
        [prefix, grid.reshape(1, dst * dst, D).astype(pos.dtype)], axis=1)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint file to a flat ``{key: tensor}`` dict.

    Unwraps ``{'model': sd}`` / ``{'state_dict': sd}`` / ``{'teacher': sd}``,
    strips the ``module.`` prefix, and keeps the ``backbone.`` subtree of a
    DINO full checkpoint."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # DINO full checkpoints pickle an argparse.Namespace beside the
        # weights; allow just that type and retry
        with torch.serialization.safe_globals([argparse.Namespace]):
            sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict", "teacher"):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
            break
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v
    if out and all(k.startswith(("backbone.", "head.", "head_dist."))
                   for k in out):
        out = {k[len("backbone."):]: v for k, v in out.items()
               if k.startswith("backbone.")}
    return out


def load_backbone_state_dict(path: str, model: nn.Module,
                             image_size: int) -> None:
    """Load a checkpoint of the backbone's family into ``model.backbone``
    in place, by the loader of ``backbone.family``: a DINO/timm ViT or a
    Facebook/timm DeiT or CaiT through :func:`load_vit_state_dict`, a
    Microsoft Swin through :func:`load_swin_state_dict`, a
    facebookresearch/xcit XCiT through :func:`load_xcit_state_dict`, a
    torchvision ResNeXt/WRN through :func:`load_resnet_state_dict`."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    backbone = model.backbone
    family = getattr(backbone, "family", None)
    if family not in _FAMILY_LOADERS:
        raise NotImplementedError(f"no checkpoint loader for a "
                                  f"{type(backbone).__name__} backbone")
    _FAMILY_LOADERS[family](load_torch_state_dict(path), backbone,
                            image_size)


def load_vit_state_dict(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                        image_size: int) -> None:
    """Load a DINO/timm ViT, Facebook/timm DeiT or CaiT state dict into a
    port backbone in place.  The position table is interpolated to the
    ``image_size`` grid, its first ``num_prefix_tokens`` rows kept as they
    are (the backbone's: 1 for the CLS token, 2 for a distilled DeiT's CLS
    and distillation tokens, 0 for CaiT's table).  Keys the backbone lacks
    (``head.*``, DeiT's ``head_dist.*``) are ignored; keys it needs and the
    dict lacks raise."""
    target = backbone.state_dict()
    num_prefix = getattr(backbone, "num_prefix_tokens", 1)
    n_target = target["pos_embed"].shape[1] - num_prefix
    if n_target != (image_size // backbone.config.patch_size) ** 2:
        raise ValueError(f"model grid has {n_target} patches, not the grid "
                         f"of image size {image_size}")
    if "pos_embed" in sd:
        sd["pos_embed"] = torch.from_numpy(interpolate_pos_embed(
            sd["pos_embed"].float().numpy(), n_target,
            num_prefix=num_prefix))
    sd = {k: v for k, v in sd.items() if k in target}
    missing = sorted(set(target) - set(sd))
    if missing:
        raise ValueError(f"checkpoint lacks backbone keys {missing[:8]}")
    backbone.load_state_dict(sd)


# computed from the window and map size (non-persistent buffers of the port)
_SWIN_COMPUTED = ("relative_position_index", "attn_mask")


def _load_by_name(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                  what: str) -> None:
    """Load the backbone's keys of ``sd`` into it in place; raise on any
    key the backbone needs and the dict lacks or on a shape mismatch."""
    target = backbone.state_dict()
    missing = sorted(set(target) - set(sd))
    if missing:
        raise ValueError(f"{what} state dict lacks backbone keys "
                         f"{missing[:8]}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {tuple(v.shape)}"
           for k, v in target.items() if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"{what} state dict shapes do not match the "
                         f"backbone: {bad[:8]}")
    backbone.load_state_dict({k: sd[k] for k in target})


def load_swin_state_dict(sd: Dict[str, torch.Tensor],
                         backbone: nn.Module, image_size: int = 0) -> None:
    """Load a Microsoft Swin state dict (already unwrapped from
    ``checkpoint['model']``) into a port Swin backbone in place.  The
    port's names are Microsoft's, so this is a load by name that skips
    ``relative_position_index``, ``attn_mask`` and ``head.*``, as the
    reference's ``strict=False`` load does, and raises on any key the
    backbone needs and the dict lacks or on a shape mismatch."""
    _load_by_name({k: v for k, v in sd.items()
                   if not k.startswith("head.")
                   and k.rsplit(".", 1)[-1] not in _SWIN_COMPUTED},
                  backbone, "Swin")


def load_xcit_state_dict(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                         image_size: int = 0) -> None:
    """Load a facebookresearch/xcit state dict into a port XCiT backbone in
    place, by name, with the BatchNorm running statistics of its conv stem
    and LPI; ``head.*`` is skipped.  Raises on any key the backbone needs
    and the dict lacks or on a shape mismatch.  The conv stem and the
    Fourier encoding take any image size, so nothing is interpolated."""
    _load_by_name({k: v for k, v in sd.items() if not k.startswith("head.")},
                  backbone, "XCiT")


def load_resnet_state_dict(sd: Dict[str, torch.Tensor], backbone: nn.Module,
                           image_size: int = 0) -> None:
    """Load a torchvision ResNeXt/WRN state dict into a port ResNet
    backbone in place, by name, with every BatchNorm's running statistics;
    ``fc.*`` is skipped.  Raises on any key the backbone needs and the
    dict lacks or on a shape mismatch."""
    _load_by_name({k: v for k, v in sd.items() if not k.startswith("fc.")},
                  backbone, "ResNet")


# backbone family -> its loader ``(state dict, backbone, image size)``
_FAMILY_LOADERS = {"dino": load_vit_state_dict, "deit": load_vit_state_dict,
                   "cait": load_vit_state_dict, "swin": load_swin_state_dict,
                   "xcit": load_xcit_state_dict,
                   "resnet": load_resnet_state_dict}
