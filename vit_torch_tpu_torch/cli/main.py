"""Classification CLI, counterpart of ``vit_torch_tpu/cli/main.py``: the
reference ``main.py`` flag surface and run flow, args → datasets → model
zoo → trainer → fit → stats JSON.  Runs on CUDA unless ``--device cpu``.

    python -m vit_torch_tpu_torch.cli.main --dataset synthetic \\
        --arch dino_vitb8 --image_size 224 --bs 32 --epoch 1 --opt adamw \\
        --lr 1e-4 --fc 512

``--lineareval`` freezes the backbone; ``--lineareval --cache_features``
runs the backbone once and trains the head on cached features.  Flags of
slices that are not ported yet raise (``utils/args.py:check_ported``).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import torch

from vit_torch_tpu_torch.data.augment import (make_eval_transform,
                                              make_train_augment)
from vit_torch_tpu_torch.data.datasets import Datasets
from vit_torch_tpu_torch.device import resolve_device
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.train.trainer import Trainer
from vit_torch_tpu_torch.utils.args import (ARGS, check_ported,
                                            classification_config)
from vit_torch_tpu_torch.utils.stats import Stats, default_hardware


def main(argv: Optional[Sequence[str]] = None) -> Stats:
    A = ARGS(classification_config())
    A.set_and_parse_args(argv)
    args = A.args
    check_ported(args)
    print("args:", json.dumps(A.info, indent=4))

    device = resolve_device(args["device"])
    dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else torch.float32

    data = Datasets(args["dataset"], image_size=args["image_size"],
                    bs=args["bs"], root_path=args["root_path"],
                    data_path=args["data_path"],
                    limit_train=args["limit_train"],
                    limit_test=args["limit_test"], seed=args["seed"])

    classifier = [*args["fc"], data.num_labels]
    zoo_model = VisionModelZoo.get_model(
        args["arch"], classifier=classifier, image_size=data.image_size,
        dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(args["seed"]))
    if args["pretrained"]:
        if not args["torch_ckpt"]:
            raise ValueError(
                "--pretrained requires --torch_ckpt <path> (no network "
                "access to fetch hub checkpoints)")
        from vit_torch_tpu_torch.checkpoint.torch_import import (
            load_backbone_state_dict)
        load_backbone_state_dict(args["torch_ckpt"], zoo_model.model,
                                 data.image_size)

    stats = Stats(
        splits=("train", "val"), stats_fp=args["stats_fp"], info=A.info,
        telem={
            "hardware": default_hardware(device),
            "mode": "lineareval" if args["lineareval"] else "finetune",
            "bs": args["bs"],
            "sample_count_train": data.info["sample_count_train"],
            "sample_count_val": data.info["sample_count_val"],
        },
        epoch_total=args["epoch"],
        sample_totals={"train": data.info["sample_count_train"],
                       "val": data.info["sample_count_val"]},
    )

    trainer = Trainer(
        zoo_model,
        epochs=args["epoch"], lr=args["lr"], opt=args["opt"],
        lr_scheduler=args["lr_scheduler"], lr_step=args["lr_step"],
        lr_gamma=args["lr_gamma"], lr_scale=args["lr_scale"],
        lineareval=args["lineareval"],
        earlystop_epoch=args["earlystop_epoch"],
        seed=args["seed"], stats=stats,
        augment_fn=make_train_augment(**data.norm_values, dtype=dtype),
        eval_transform=make_eval_transform(**data.norm_values, dtype=dtype),
    )
    # as in the JAX CLI, the scan path trains on data.sets, which ignores
    # --limit_train / --limit_test
    sets = {"train": data.sets["train"], "val": data.sets["test"]}
    if args["lineareval"] and args["cache_features"]:
        trainer.fit_lineareval_cached(sets, args["bs"])
    elif args["scan"]:
        trainer.fit_scan(sets, args["bs"])
    else:
        trainer.fit(data.loaders)
    print("\nresults:", json.dumps(stats.update_results(), indent=2))
    if args["stats_fp"]:
        print("stats saved to", args["stats_fp"])
    return stats


if __name__ == "__main__":
    main()
