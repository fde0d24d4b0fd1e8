"""Serving-export CLI: build (or import) a classifier, then ship it.

    python -m vit_torch_tpu_torch.cli.export --arch dino_vitb8 \
        --classifier 512,10 --dataset stl10 --bs 1,8,32 --out /tmp/bundle

writes a bundle (``serving/export.py``: manifest + weights) that
``python -m vit_torch_tpu_torch.cli.serve --bundle /tmp/bundle`` serves.
Without ``--torch_ckpt`` the weights are seeded random ones (pipeline
smoke and speed only); with it the backbone comes from a DINO/timm torch
checkpoint or a Facebook DeiT (``--arch deit_*``, the distilled ones
with both tokens) or CaiT checkpoint (``--arch cait_*``), its position
table interpolated to ``--image_size``, from a Microsoft Swin
checkpoint (``--arch swin_base_patch4_window12_384_22k`` and the other
Swin archs), from a facebookresearch/xcit checkpoint (``--arch xcit_*``)
or from a torchvision ResNeXt/WRN one (``--arch resnext50_32x4d``, ...);
the last two carry their BatchNorm running statistics into the bundle,
which serves in eval mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _norm_for(norm_values, dataset: str):
    """Normalization constants for ``--dataset``; unknown (ImageFolder-
    style) names fall back to the imagenet constants."""
    if dataset not in norm_values:
        print(f"note: no normalization entry for dataset '{dataset}' — "
              f"using imagenet constants (the ImageFolder default)",
              file=sys.stderr)
        return norm_values["imagenet"]
    return norm_values[dataset]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True,
                   help="a zoo arch: dino_*/vit_*, deit_*, cait_*, swin_*, "
                        "xcit_*, resnext*/wide_resnet*")
    p.add_argument("--classifier", default="10",
                   help="comma-separated head units incl. class count, "
                        "e.g. 512,10 (reference [*fc, num_labels])")
    p.add_argument("--image_size", type=int, default=None,
                   help="input size (default: the arch's, as the zoo "
                        "gives it)")
    p.add_argument("--bs", default="1,8,32",
                   help="comma-separated batch-size buckets")
    p.add_argument("--dataset", default="synthetic",
                   help="normalization constants to store "
                        "(data.datasets.NORM_VALUES key)")
    p.add_argument("--torch_ckpt", default=None,
                   help="torch checkpoint for the backbone weights")
    p.add_argument("--platforms", default=None,
                   help="multi-platform export; not ported (the bundle is "
                        "weights, which every device loads)")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 serving path; not ported yet")
    p.add_argument("--no_prequant", action="store_true",
                   help="with --w8a8 only")
    p.add_argument("--param_dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="cast stored weights (bfloat16 halves the bundle)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel bundles (>1) are not ported yet")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--out", required=True, help="bundle output directory")
    args = p.parse_args(argv)

    if args.platforms:
        raise NotImplementedError("--platforms belongs to a later slice of "
                                  "the port (ROADMAP.md)")
    if args.num_devices > 1:
        raise NotImplementedError("--num_devices > 1 belongs to a later "
                                  "slice of the port (ROADMAP.md)")
    if args.w8a8:
        raise NotImplementedError("--w8a8 belongs to a later slice of the "
                                  "port (ROADMAP.md)")

    from vit_torch_tpu_torch.checkpoint.torch_import import (
        load_backbone_state_dict)
    from vit_torch_tpu_torch.data.datasets import NORM_VALUES
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.serving.export import (
        export_classifier, save_bundle)

    classifier = [int(u) for u in args.classifier.split(",") if u]
    zm = VisionModelZoo.get_model(
        args.arch, classifier=classifier, image_size=args.image_size,
        device=args.device, generator=torch.Generator().manual_seed(0))
    if args.torch_ckpt:
        load_backbone_state_dict(args.torch_ckpt, zm.model, zm.image_size)
    else:
        print("warning: no --torch_ckpt — exporting randomly-initialized "
              "weights (smoke only)", file=sys.stderr)
    exported = export_classifier(
        zm, batch_sizes=[int(b) for b in args.bs.split(",") if b],
        norm=_norm_for(NORM_VALUES, args.dataset),
        param_dtype=args.param_dtype)
    save_bundle(args.out, exported)
    sizes = {f: os.path.getsize(os.path.join(args.out, f))
             for f in sorted(os.listdir(args.out))}
    print(json.dumps({"out": args.out, "manifest": exported["manifest"],
                      "files_bytes": sizes}))


if __name__ == "__main__":
    main()
