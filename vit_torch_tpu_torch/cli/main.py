"""Classification CLI, counterpart of ``vit_torch_tpu/cli/main.py``: the
reference ``main.py`` flag surface and run flow, args → datasets → model
zoo → trainer → fit → stats JSON.  Runs on CUDA unless ``--device cpu``.

    python -m vit_torch_tpu_torch.cli.main --dataset synthetic \\
        --arch dino_vitb8 --image_size 224 --bs 32 --epoch 1 --opt adamw \\
        --lr 1e-4 --fc 512

``--arch`` takes every family of the zoo: dino/vit, deit, cait, swin
(also through ``cli.main_swin``), xcit and the ResNeXt/WRN CNNs
(``resnext50_32x4d``, ``wide_resnet50_2``, ...), whose BatchNorm running
statistics the fine-tune and the plain linear eval update (the backbone
runs in train mode) and the cached linear eval reads (eval mode);
``--pretrained --torch_ckpt`` loads a checkpoint of the arch's family.
``VITX_FUSED_MLP=1`` sends every block's MLP through the fused kernel.
``--lineareval`` freezes the backbone; ``--lineareval --cache_features``
runs the backbone once and trains the head on cached features.

``--ckpt_dir D`` saves checkpoints into D (every new best, and every
``--save_every`` epochs; the best mirrored into ``D/best``) and
``--resume D`` continues from D's latest one (``train/trainer.py``).
``--export_bundle B`` writes the trained classifier as a serving bundle
(``serving/export.py``, buckets ``--export_bs``, the dataset's
normalisation) that ``cli.serve --bundle B`` serves; under
``VITX_W8A8=1`` it is a W8A8 bundle with prequantised int8 weights, as
the JAX export is under the flag.  ``--aug_auto
POLICY`` adds AutoAugment to the train augmentation.  ``--dataset tire
--data_path DIR`` builds LBP channel stacks (``--tire_settings 0-3``;
7 channels for setting 0) from an ImageFolder (``data/tire.py``).

``--mesh SPEC`` (``'data=4'``, ``'data=2,model=2'``, ...) trains over a
``torch.distributed`` mesh (``parallel/``): launched by ``torchrun`` over
its world, or as a world of one when run plainly (``--mesh data=1``);
``--fsdp`` shards the large parameters and their optimizer moments over
the batch axes (alone it implies the world of one), and
``--pipe_microbatches M`` sets the GPipe microbatches of a ``pipe`` axis.
On CUDA the group is NCCL (gloo where torchrun's local ranks outnumber
the cards and share them), on the CPU gloo:

    torchrun --nproc_per_node 4 -m vit_torch_tpu_torch.cli.main \
        --mesh data=2,model=2 --device cpu --dataset synthetic \
        --arch vit_tiny_test --image_size 32 --bs 16 --epoch 1

As in the JAX CLI, ``--scan`` runs only without a mesh or on a pure data
mesh without ``--fsdp``, and ``--fsdp`` refuses ``--cache_features``.
Rank 0 alone writes the stats file, checkpoints and the bundle.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import torch.distributed as dist

import torch

from vit_torch_tpu_torch.data.augment import (make_eval_transform,
                                              make_train_augment)
from vit_torch_tpu_torch.data.datasets import Datasets
from vit_torch_tpu_torch.device import resolve_device
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.parallel.multihost import (is_main_process,
                                                    setup_mesh)
from vit_torch_tpu_torch.serving.export import export_classifier, save_bundle
from vit_torch_tpu_torch.train.trainer import Trainer
from vit_torch_tpu_torch.utils.args import ARGS, classification_config
from vit_torch_tpu_torch.utils.stats import Stats, default_hardware


def main(argv: Optional[Sequence[str]] = None) -> Stats:
    A = ARGS(classification_config())
    A.set_and_parse_args(argv)
    args = A.args
    print("args:", json.dumps(A.info, indent=4))

    device = resolve_device(args["device"])
    mesh, device, formed = setup_mesh(args["mesh"], device,
                                      force=args["fsdp"])
    try:
        return _run(A, args, device, mesh)
    finally:
        if formed:
            dist.destroy_process_group()


def _run(A, args, device, mesh) -> Stats:
    dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else torch.float32

    image_channels = 3
    if args["dataset"] == "tire":
        from vit_torch_tpu_torch.data.tire import TireDatasets
        data = TireDatasets(args["data_path"] or args["root_path"],
                            image_size=args["image_size"] or 224,
                            bs=args["bs"], settings=args["tire_settings"],
                            seed=args["seed"], limit_train=args["limit_train"],
                            limit_test=args["limit_test"],
                            aug_auto=args["aug_auto"])
        image_channels = data.image_channels
        augment_fn = data.make_augment_fn(dtype=dtype)
    else:
        data = Datasets(args["dataset"], image_size=args["image_size"],
                        bs=args["bs"], root_path=args["root_path"],
                        data_path=args["data_path"],
                        limit_train=args["limit_train"],
                        limit_test=args["limit_test"], seed=args["seed"])
        augment_fn = make_train_augment(**data.norm_values, dtype=dtype,
                                        auto_policy=args["aug_auto"] or None)

    classifier = [*args["fc"], data.num_labels]
    zoo_model = VisionModelZoo.get_model(
        args["arch"], classifier=classifier, image_size=data.image_size,
        dtype=dtype, device=device, image_channels=image_channels,
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
        splits=("train", "val"),
        stats_fp=args["stats_fp"] if is_main_process() else None,
        info=A.info,
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
        seed=args["seed"], stats=stats, augment_fn=augment_fn,
        eval_transform=make_eval_transform(**data.norm_values, dtype=dtype),
        ckpt_dir=args["ckpt_dir"], save_every=args["save_every"],
        resume=args["resume"], mesh=mesh, fsdp=args["fsdp"],
        pipe_microbatches=args["pipe_microbatches"],
    )
    # as in the JAX CLI, the scan path trains on data.sets, which ignores
    # --limit_train / --limit_test; it handles no mesh and pure data
    # meshes, the others run the per-step path
    use_scan = args["scan"] and not args["fsdp"] and (
        mesh is None or all(mesh.shape[a] == 1
                            for a in ("model", "seq", "pipe")))
    sets = {"train": data.sets["train"], "val": data.sets["test"]}
    if args["lineareval"] and args["cache_features"]:
        if args["fsdp"]:
            # the cached path runs unsharded steps: silently dropping the
            # requested sharding would defeat its purpose
            raise SystemExit("--fsdp is not supported with --cache_features "
                             "(the cached lineareval path is single-program);"
                             " drop one of the two flags")
        trainer.fit_lineareval_cached(sets, args["bs"])
    elif use_scan:
        trainer.fit_scan(sets, args["bs"])
    else:
        trainer.fit(data.loaders)
    print("\nresults:", json.dumps(stats.update_results(), indent=2))
    if args["export_bundle"]:
        export_zm = zoo_model
        if trainer.layout is not None:
            # the bundle holds the single-process model: gather it (every
            # rank), rebuild it whole on rank 0
            from vit_torch_tpu_torch.parallel.api import full_state
            state, _ = full_state(trainer.model, None, trainer.layout)
            export_zm = VisionModelZoo.get_model(
                args["arch"], classifier=classifier,
                image_size=data.image_size, dtype=dtype, device="cpu",
                image_channels=image_channels)
            export_zm.model.load_state_dict(state)
        if is_main_process():
            exported = export_classifier(
                export_zm, norm=data.norm_values,
                batch_sizes=[int(b) for b in args["export_bs"].split(",")
                             if b])
            save_bundle(args["export_bundle"], exported)
            print("serving bundle saved to", args["export_bundle"])
    if args["stats_fp"]:
        print("stats saved to", args["stats_fp"])
    return stats


if __name__ == "__main__":
    main()
