"""JAX/flax parameter tree → the port's state dict.

The inverse of ``vit_torch_tpu/checkpoint/torch_import.py``'s
``import_vit``, ``import_swin``, ``import_cait``, ``import_xcit`` and
``import_resnet``, so weights (and BatchNorm statistics) trained or
initialised by the JAX package run in the port:

- a Dense ``kernel`` ``(in, out)`` becomes a Linear ``weight`` ``(out, in)``;
- the patch-embed matmul kernel ``(p*p*C, D)`` becomes the conv weight
  ``(D, C, p, p)`` (ViT's ``patch_embed.kernel``, Swin's
  ``patch_embed_kernel``; Swin's ``patch_embed_norm`` becomes
  ``patch_embed.norm``);
- LayerNorm ``scale`` becomes ``weight``;
- ``blocks_{i}`` becomes ``blocks.{i}``; Swin's ``layers_{i}_blocks_{j}``
  and ``layers_{i}_downsample`` become ``layers.{i}.blocks.{j}`` and
  ``layers.{i}.downsample``; CaiT's ``blocks_token_only_{i}`` becomes
  ``blocks_token_only.{i}``;
- CaiT's head mixes ``attn.proj_l_kernel`` / ``attn.proj_l_bias`` (and
  ``proj_w``) become the ``Linear(H, H)`` ``attn.proj_l.weight``
  (transposed) / ``attn.proj_l.bias``;
- a conv ``kernel`` ``(kh, kw, I, O)`` becomes the conv ``weight``
  ``(O, I, kh, kw)`` by ``transpose(3, 2, 0, 1)`` (a depthwise ``(3, 3, 1,
  C)`` becomes ``(C, 1, 3, 3)``); a plain ``.T`` would swap kh and kw;
- XCiT's ``patch_embed.conv{i}`` / ``bn{i}`` become
  ``patch_embed.proj.{2i}.0`` / ``.1``, its ``pos_proj_kernel`` ``(64,
  C)`` the 1x1 conv ``pos_embeder.token_projection.weight`` ``(C, 64, 1,
  1)`` and ``pos_proj_bias`` its bias, ``cls_attn_blocks_{i}``
  ``cls_attn_blocks.{i}``;
- ResNet's ``layer{i}_{j}`` becomes ``layer{i}.{j}``, and
  ``downsample_conv`` / ``downsample_bn`` ``downsample.0`` / ``.1``;
- the ``batch_stats`` collection's BatchNorm ``mean`` / ``var`` become
  ``running_mean`` / ``running_var``, with a ``num_batches_tracked`` of 0
  beside them (a strict load needs it; flax does not count batches);
- Swin's ``relative_position_bias_table``, CaiT's ``gamma_1`` and
  ``gamma_2``, XCiT's ``gamma1``-``gamma3`` and ``temperature``, and the
  ``cls_token``, ``pos_embed`` and DeiT's ``dist_token`` leaves are kept
  as they are.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, np.asarray(val)


def _torch_key(path: str) -> str:
    """A flax parameter path in the port's module names."""
    key = re.sub(r"layers_(\d+)_", r"layers.\1.", path)
    key = re.sub(r"patch_embed_(kernel|bias|norm)", r"patch_embed.\1",
                 key)
    key = re.sub(r"blocks_token_only_(\d+)", r"blocks_token_only.\1",
                 key)
    key = re.sub(r"blocks_(\d+)", r"blocks.\1", key)
    key = re.sub(r"(^|\.)(proj_[lw])_(kernel|bias)$", r"\1\2.\3", key)
    key = re.sub(r"patch_embed\.(conv|bn)(\d+)\.", lambda m: (
        f"patch_embed.proj.{2 * int(m[2])}.{int(m[1] == 'bn')}."), key)
    key = re.sub(r"(^|\.)pos_proj_(kernel|bias)$",
                 r"\1pos_embeder.token_projection.\2", key)
    key = re.sub(r"(^|\.)layer(\d+)_(\d+)\.", r"\1layer\2.\3.", key)
    return re.sub(r"downsample_(conv|bn)\.", lambda m: (
        f"downsample.{int(m[1] == 'bn')}."), key)


def state_dict_from_jax(params: Mapping[str, Any], image_channels: int = 3,
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Map a flax classifier tree of any family (``{"backbone": ...,
    "head": ...}``, or a bare backbone tree) of numpy-convertible arrays,
    and its ``batch_stats`` collection where the model has BatchNorm
    (XCiT, ResNet), to a state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        key = _torch_key(path)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("patch_embed.kernel"):
            D = arr.shape[1]
            p = int(round((arr.shape[0] // image_channels) ** 0.5))
            arr = arr.reshape(p, p, image_channels, D).transpose(3, 2, 0, 1)
            key = key[:-len("kernel")] + "proj.weight"
        elif key.endswith("patch_embed.bias"):
            key = key[:-len("bias")] + "proj.bias"
        elif key.endswith("token_projection.kernel"):
            arr = arr.T[:, :, None, None]
            key = key[:-len("kernel")] + "weight"
        elif leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = key[:-len("kernel")] + "weight"
        elif leaf == "scale":
            key = key[:-len("scale")] + "weight"
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for path, arr in _flatten(batch_stats or {}):
        prefix, leaf = _torch_key(path).rsplit(".", 1)
        out[f"{prefix}.running_{leaf}"] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((),
                                                           dtype=torch.long)
    return out
