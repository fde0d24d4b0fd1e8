"""JAX/flax parameter tree → the port's state dict.

The inverse of ``vit_torch_tpu/checkpoint/torch_import.py:import_vit`` and
``import_swin``, so weights trained or initialised by the JAX package run
in the port:

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
- Swin's ``relative_position_bias_table``, CaiT's ``gamma_1`` and
  ``gamma_2``, and the ``cls_token``, ``pos_embed`` and DeiT's
  ``dist_token`` leaves are kept as they are.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, np.asarray(val)


def state_dict_from_jax(params: Mapping[str, Any], image_channels: int = 3
                        ) -> Dict[str, torch.Tensor]:
    """Map a flax ViT, DeiT, Swin or CaiT classifier tree (``{"backbone": ...,
    "head": ...}``, or a bare backbone tree) of numpy-convertible arrays to
    a state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        key = re.sub(r"layers_(\d+)_", r"layers.\1.", path)
        key = re.sub(r"patch_embed_(kernel|bias|norm)", r"patch_embed.\1",
                     key)
        key = re.sub(r"blocks_token_only_(\d+)", r"blocks_token_only.\1",
                     key)
        key = re.sub(r"blocks_(\d+)", r"blocks.\1", key)
        key = re.sub(r"(^|\.)(proj_[lw])_(kernel|bias)$", r"\1\2.\3", key)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("patch_embed.kernel"):
            D = arr.shape[1]
            p = int(round((arr.shape[0] // image_channels) ** 0.5))
            arr = arr.reshape(p, p, image_channels, D).transpose(3, 2, 0, 1)
            key = key[:-len("kernel")] + "proj.weight"
        elif key.endswith("patch_embed.bias"):
            key = key[:-len("bias")] + "proj.bias"
        elif leaf == "kernel":
            arr = arr.T
            key = key[:-len("kernel")] + "weight"
        elif leaf == "scale":
            key = key[:-len("scale")] + "weight"
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out
