"""COCO detection CLI, counterpart of ``vit_torch_tpu/cli/coco.py`` (the
reference's ``object/coco_pipeline.py`` flags ``:51-72``, ``--test``
smoke mode ``:75-82`` and per-epoch stats JSON ``:442-559``;
``object_detr/main.py``): trains DETR over a Swin feature map with the
host Hungarian matcher or, with ``--matcher device``, the auction on the
card (``--head detr``, the default; with ``--masks`` DETRSegm, the
instance-mask head), or Faster R-CNN over a ResNet or Swin FPN (``--head
faster_rcnn``; with ``--keypoints`` Keypoint R-CNN), on a COCO-format
directory (or, with ``--panoptic_root``, a panoptic-PNG one, which
implies ``--masks``), evaluates COCO bbox AP (segm AP and PQ with masks,
keypoint AP with keypoints) after every epoch (and once before training),
and streams the train losses and the COCO numbers to a stats JSON.  The
flags keep the JAX CLI's names and defaults.

``--scan K`` (K > 1) trains in chunks of K steps whose logs are read
once (``train_one_epoch_scan``) with ``--head faster_rcnn`` or
``--matcher device``, and per step otherwise, as the JAX CLI does.
``--ckpt_dir D`` saves the model, optimizer, generator and epoch after
each epoch's evaluation (the last three kept); ``--resume D`` restores
D's latest and continues at the next epoch, without the initial
evaluation (a resumed run rebuilds its loader, so its first epoch takes
epoch 0's permutation, as the JAX loader does).  ``--export_bundle B``
writes the trained detector as a serving bundle (``serving/export.py``,
buckets ``--export_bs``; W8A8 under ``VITX_W8A8=1``), which
``cli.serve --bundle B`` serves over HTTP.

    python -m vit_torch_tpu_torch.cli.coco --data_root /path/coco \\
        --backbone swin_tiny_patch4_window7_224 --epochs 5 --bs 8 [--masks]
    python -m vit_torch_tpu_torch.cli.coco --panoptic_root /path/panoptic
    python -m vit_torch_tpu_torch.cli.coco --data_root /path/coco \\
        --head faster_rcnn --backbone resnext50_32x4d [--keypoints]
    python -m vit_torch_tpu_torch.cli.coco --test [--masks]  # on the card
    python -m vit_torch_tpu_torch.cli.coco --test --device cpu \\
        [--masks | --head faster_rcnn [--keypoints] [--backbone swin_test3]]
    python -m vit_torch_tpu_torch.cli.coco --test --device cpu \\
        --matcher device --scan 2 --ckpt_dir /tmp/c --export_bundle /tmp/b

It runs on CUDA unless ``--device cpu``.  ``--dtype`` defaults to
bfloat16 on CUDA and float32 on the CPU: the flash and window kernels
take bfloat16, so ``--dtype float32`` on CUDA raises on the routes that
run them (DETR, and Faster R-CNN over Swin); Faster R-CNN over a ResNet
runs no hand kernel and takes either.  ``--test`` writes a 16-image
synthetic set at 64 px and trains 1-2 epochs: of a 1 + 1 layer,
hidden-64 DETR with 8 queries and 2 heads (head dim 32, the flash
kernels' smallest) over ``swin_test`` (``swin_test3`` with masks: the
mask head's laterals want three stages) on the CPU and Swin-T on the
card, whose window kernels take head dim 32 only; or of Faster R-CNN with the
JAX CLI's tiny settings over ``resnet_test`` (anchors 8 and 16, 64
proposals, a two-conv 64-channel keypoint head).

``--mesh data=N`` trains data-parallel over ``torch.distributed``
(``torchrun --nproc_per_node N``, or ``data=1`` in a plain process; NCCL
on CUDA, gloo on the CPU): every rank holds the whole model, takes its
rows of each global batch and solves its own images' assignments, the
losses divide by global counts and the gradients are averaged
(``detection/engine.py``).  Any other axis exits before any work with the
JAX CLI's message; rank 0 alone writes the stats, checkpoints and bundle.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("coco detection")
    p.add_argument("--data_root", default="", type=str,
                   help="COCO dir: {train,validation}/{data,labels.json}")
    p.add_argument("--backbone", default="swin_tiny_patch4_window7_224")
    p.add_argument("--head", default="detr", choices=["detr", "faster_rcnn"],
                   help="detection head: DETR set prediction "
                        "(object_detr/) or Faster R-CNN (object/)")
    p.add_argument("--keypoints", action="store_true",
                   help="add the Keypoint R-CNN head (faster_rcnn only) and "
                        "score the keypoints iou_type (reference "
                        "object/coco_utils.py:222-251 get_coco_kp)")
    p.add_argument("--panoptic_root", default="", type=str,
                   help="panoptic dataset root: {train,validation}/{data,"
                        "panoptic,panoptic.json} (reference --dataset_file "
                        "coco_panoptic); implies --masks and scores PQ")
    p.add_argument("--scan", default=1, type=int,
                   help="train steps per chunk (faster_rcnn, or detr with "
                        "--matcher device; >1 reads the logs once a chunk)")
    p.add_argument("--matcher", default="host", choices=["host", "device"],
                   help="DETR matching: host = exact Hungarian on the host "
                        "(one copy of the costs a step), device = the "
                        "auction on the card (no host read)")
    p.add_argument("--opt", default="adamw", choices=["adamw", "sgd"],
                   help="adamw = upstream DETR's recipe (clip 0.1), sgd = "
                        "the reference fork's (momentum .9, coupled wd; "
                        "object_detr/main.py:239-252)")
    p.add_argument("--masks", action="store_true",
                   help="DETR instance-mask head (DETRSegm, reference "
                        "object_detr --masks); adds segm AP and PQ")
    p.add_argument("--image_size", default=512, type=int)
    p.add_argument("--bs", default=8, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_step", default=8, type=int,
                   help="StepLR period in epochs (reference "
                        "object/coco_pipeline.py:464-476)")
    p.add_argument("--lr_gamma", default=0.1, type=float,
                   help="StepLR decay factor")
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--torch_ckpt", default="", type=str,
                   help="local state_dict for the backbone: Microsoft Swin, "
                        "or torchvision ResNeXt/WRN for faster_rcnn (the "
                        "reference trains detection from pretrained "
                        "backbones)")
    p.add_argument("--no_hflip", action="store_true",
                   help="disable the train-time random horizontal flip")
    p.add_argument("--aug_crop", action="store_true",
                   help="DETR train-time RandomSelect zoom-crop")
    p.add_argument("--aug_erase", action="store_true",
                   help="DETR train-time RandomErasing")
    p.add_argument("--no_initial_eval", action="store_true",
                   help="skip the epoch-0 validation pass")
    p.add_argument("--ckpt_dir", default="", type=str,
                   help="save a checkpoint here after every epoch")
    p.add_argument("--resume", default="", type=str,
                   help="resume from this checkpoint dir's latest epoch")
    p.add_argument("--num_queries", default=100, type=int)
    p.add_argument("--pre_norm", action="store_true",
                   help="pre-norm DETR transformer (normalize_before)")
    p.add_argument("--position_embedding", default="sine",
                   choices=["sine", "learned"])
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--max_boxes", default=64, type=int)
    p.add_argument("--limit_train", default=0, type=int)
    p.add_argument("--limit_test", default=0, type=int)
    p.add_argument("--labels", default=[], nargs="+", type=int,
                   help="category-id subset filter")
    p.add_argument("--stats_fp", default=f"./logs/coco/stats_"
                   f"{time.strftime('%y%m%d_%H%M%S')}.json")
    p.add_argument("--mesh", default="", type=str,
                   help="data-parallel device mesh spec, e.g. 'data=8' or ''"
                        " = single device (params replicated, batch "
                        "sharded, gradient all-reduce)")
    p.add_argument("--export_bundle", default="", type=str,
                   help="write the trained detector as a serving bundle")
    p.add_argument("--export_bs", default="1,8", type=str)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="activations: bfloat16 on CUDA (the default; the "
                        "kernels take nothing else), float32 on the CPU")
    p.add_argument("--test", action="store_true",
                   help="smoke mode: a tiny synthetic set, at most 2 "
                        "epochs (reference object/coco_pipeline.py:75-82)")
    return p


def check_combinations(args: argparse.Namespace) -> None:
    """The JAX CLI's refusals of flags that do not go together."""
    for part in filter(None, args.mesh.split(",")):
        axis, _, size = part.partition("=")
        if axis.strip() != "data" and size.strip() != "1":
            raise SystemExit("detection supports data-parallel meshes only "
                             "(e.g. --mesh data=8)")
    if args.keypoints and args.head != "faster_rcnn":
        raise SystemExit("--keypoints requires --head faster_rcnn")
    if args.keypoints and (args.masks or args.panoptic_root):
        raise SystemExit("--keypoints cannot be combined with --masks/"
                         "--panoptic_root (no mask+keypoint model)")
    if args.panoptic_root and args.head == "faster_rcnn":
        raise SystemExit("--panoptic_root requires --head detr (the "
                         "faster_rcnn head produces no mask predictions)")
    if args.masks and args.head == "faster_rcnn":
        raise SystemExit("--masks requires --head detr (the faster_rcnn "
                         "head produces no mask predictions)")


def _runs_window_kernels(args) -> bool:
    """Whether the model runs the bf16-only flash or window kernels on
    CUDA: DETR always, Faster R-CNN over a Swin backbone."""
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS
    return args.head == "detr" or args.backbone in SWIN_CONFIGS


def _dtype(args, device: torch.device) -> torch.dtype:
    if args.dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if (device.type == "cuda" and args.dtype == "float32"
            and _runs_window_kernels(args)):
        raise ValueError("--dtype float32 on CUDA: the flash and window "
                         "kernels take bfloat16 activations")
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def _frcnn_backbone(args) -> str:
    """The Faster R-CNN trunk: the Swin or ResNet config named, else
    ``resnet_test`` under ``--test`` and ``resnext50_32x4d`` otherwise,
    as the JAX CLI picks it."""
    from vit_torch_tpu_torch.models.resnet import RESNET_CONFIGS
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS
    if args.backbone in SWIN_CONFIGS or args.backbone in RESNET_CONFIGS:
        return args.backbone
    return "resnet_test" if args.test else "resnext50_32x4d"


def _faster_rcnn_config(args, train_ds):
    """``FasterRCNNConfig`` as the JAX CLI builds it (``:257-300``): one
    FPN level a backbone stage at strides 4·2^i, anchors 32·2^i (8·2^i
    under ``--test``), and ``--test``'s tiny counts."""
    from vit_torch_tpu_torch.detection.faster_rcnn import FasterRCNNConfig
    from vit_torch_tpu_torch.models.resnet import RESNET_CONFIGS
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS
    arch = _frcnn_backbone(args)
    n_stages = (len(SWIN_CONFIGS[arch].depths) if arch in SWIN_CONFIGS
                else len(RESNET_CONFIGS[arch].layers))
    strides = tuple(4 * 2 ** i for i in range(n_stages))
    base = 8.0 if args.test else 32.0
    sizes = tuple(base * 2 ** i for i in range(n_stages))
    kp_kw = {}
    if args.keypoints:
        kp_kw = dict(num_keypoints=train_ds.num_keypoints,
                     kp_conv_channels=(64,) * 2 if args.test else (512,) * 8,
                     kp_rois=16 if args.test else 128)
    return FasterRCNNConfig(
        num_classes=train_ds.num_classes, image_size=args.image_size,
        strides=strides, anchor_sizes=sizes,
        num_proposals=64 if args.test else 256,
        rpn_pre_nms_topk=128 if args.test else 1000,
        rpn_batch=64 if args.test else 256,
        roi_batch=32 if args.test else 128,
        detections=20 if args.test else 100, **kp_kw)


def _kp_flip_inds(train_ds):
    """The keypoints' left/right swap under the flip: COCO's for a
    17-keypoint schema without names, else derived from the names (the
    JAX CLI's ``:302-311``); None keeps the order."""
    from vit_torch_tpu_torch.detection.keypoint import (
        COCO_KP_FLIP_INDS, kp_flip_inds_from_names)
    if train_ds.num_keypoints == 17 and not train_ds.kp_names:
        return COCO_KP_FLIP_INDS
    if train_ds.kp_names:
        return kp_flip_inds_from_names(train_ds.kp_names)
    return None


def _panoptic_split(args, split: str, limit: int):
    """``--panoptic_root``'s ``split`` (``train`` or ``validation``)."""
    from vit_torch_tpu_torch.detection.panoptic_data import (
        CocoPanopticDataset)
    root = os.path.join(args.panoptic_root, split)
    return CocoPanopticDataset(
        os.path.join(root, "data"), os.path.join(root, "panoptic"),
        os.path.join(root, "panoptic.json"), image_size=args.image_size,
        max_boxes=args.max_boxes, limit=limit)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    check_combinations(args)
    from vit_torch_tpu_torch.device import resolve_device
    from vit_torch_tpu_torch.parallel.multihost import setup_mesh
    mesh, device, formed = setup_mesh(args.mesh, resolve_device(args.device))
    try:
        return _run(args, mesh, device)
    finally:
        if formed:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, mesh, device: torch.device) -> dict:
    if args.panoptic_root:
        # panoptic segments train the mask head, in --test runs too
        args.masks = True
    from vit_torch_tpu_torch.detection.coco_data import (
        CocoDetectionDataset, CocoLoader, make_synthetic_coco)
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import (DetectionTrainer,
                                                      FasterRCNNTrainer)
    from vit_torch_tpu_torch.detection.faster_rcnn import build_faster_rcnn
    from vit_torch_tpu_torch.parallel.multihost import is_main_process
    from vit_torch_tpu_torch.utils.stats import default_hardware

    main_rank = is_main_process()
    frcnn = args.head == "faster_rcnn"
    num_heads = 8
    if args.test:
        tmp = tempfile.mkdtemp(prefix="coco_smoke_")
        img_dir, ann_file = make_synthetic_coco(tmp, n_images=16, size=64,
                                                keypoints=args.keypoints)
        train_dirs = val_dirs = (img_dir, ann_file)
        args.epochs = min(args.epochs, 2)
        args.bs = min(args.bs, 4)
        args.image_size = 64
        args.max_boxes = 8
        args.enc_layers, args.dec_layers = 1, 1
        args.hidden_dim, args.num_queries = 64, 8
        num_heads = 2
        if args.backbone == get_args_parser().get_default("backbone"):
            if frcnn:
                args.backbone = "resnet_test"
            elif device.type == "cpu":
                args.backbone = "swin_test3" if args.masks else "swin_test"
    else:
        if not (args.data_root or args.panoptic_root):
            raise ValueError("--data_root or --panoptic_root required (or "
                             "--test)")
        train_dirs = (os.path.join(args.data_root, "train", "data"),
                      os.path.join(args.data_root, "train", "labels.json"))
        val_dirs = (os.path.join(args.data_root, "validation", "data"),
                    os.path.join(args.data_root, "validation",
                                 "labels.json"))

    dtype = _dtype(args, device)
    cats = args.labels or None
    if args.panoptic_root and not args.test:
        # the evaluation runs on the panoptic set's instance-gt view
        train_ds = _panoptic_split(args, "train", args.limit_train)
        val_ds = _panoptic_split(args, "validation", args.limit_test)
    else:
        train_ds = CocoDetectionDataset(
            *train_dirs, image_size=args.image_size,
            max_boxes=args.max_boxes, limit=args.limit_train,
            category_ids=cats, load_masks=args.masks,
            load_keypoints=args.keypoints)
        val_ds = CocoDetectionDataset(*val_dirs, image_size=args.image_size,
                                      max_boxes=args.max_boxes,
                                      limit=args.limit_test,
                                      category_ids=cats)
    if mesh is not None and args.bs % mesh.shape["data"]:
        raise SystemExit(f"--bs {args.bs} must be a multiple of the "
                         f"data axis size ({mesh.shape['data']})")
    train_loader = CocoLoader(train_ds, args.bs, shuffle=True)
    val_loader = CocoLoader(val_ds, args.bs)
    print(f"train: {len(train_ds)} images, val: {len(val_ds)} images, "
          f"{train_ds.num_classes} classes")

    if frcnn:
        cfg = _faster_rcnn_config(args, train_ds)
        model = build_faster_rcnn(cfg, _frcnn_backbone(args), dtype,
                                  torch.Generator().manual_seed(0), device)
    else:
        cfg = DETRConfig(num_classes=train_ds.num_classes,
                         num_queries=args.num_queries,
                         hidden_dim=args.hidden_dim, num_heads=num_heads,
                         enc_layers=args.enc_layers,
                         dec_layers=args.dec_layers, pre_norm=args.pre_norm,
                         position_embedding=args.position_embedding)
        model = build_detr(cfg, args.backbone, args.image_size, dtype,
                           torch.Generator().manual_seed(0), device,
                           masks=args.masks)
    if args.torch_ckpt:
        from vit_torch_tpu_torch.checkpoint.torch_import import (
            load_backbone_state_dict)
        load_backbone_state_dict(args.torch_ckpt, model, args.image_size)
        print(f"loaded pretrained {model.backbone.family} backbone from "
              f"{args.torch_ckpt}")
    if frcnn:
        # the JAX CLI's FasterRCNNTrainer call: SGD at --lr with its own
        # momentum and decay (0.9, 5e-4), the flip with the keypoint swap
        trainer = FasterRCNNTrainer(
            model, cfg=cfg, lr=args.lr, augment=not args.no_hflip,
            kp_flip_inds=_kp_flip_inds(train_ds) if args.keypoints else None,
            mesh=mesh)
    else:
        trainer = DetectionTrainer(model, image_size=args.image_size,
                                   num_classes=train_ds.num_classes,
                                   lr=args.lr, masks=args.masks,
                                   augment=not args.no_hflip,
                                   aug_crop=args.aug_crop,
                                   aug_erase=args.aug_erase,
                                   matcher=args.matcher, opt=args.opt,
                                   weight_decay=args.weight_decay,
                                   mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params ({args.head}, {dtype}, "
          f"{device})")

    record = {"info": vars(args),
              "telem": {"hardware": default_hardware(device),
                        "time_start": time.time(), "completed": False},
              "logs": []}

    def save():
        if not main_rank:
            return
        os.makedirs(os.path.dirname(os.path.abspath(args.stats_fp)),
                    exist_ok=True)
        record["telem"]["time_updated"] = time.time()
        with open(args.stats_fp, "w") as f:
            json.dump(record, f, indent=2, default=str)

    def log_fn(i, n, logs):
        print(f"\r  [{i + 1}/{n}] " + " ".join(
            f"{k}[{v:.4f}]" for k, v in logs.items()), end="", flush=True)

    # mask models add segm and PQ (reference object/engine.py:58-67 adds
    # segm; object_detr/datasets/panoptic_eval.py scores PQ)
    iou_types = (("bbox",) + (("segm",) if args.masks else ())
                 + (("keypoints",) if args.keypoints else ()))
    eval_kw = dict(label_to_cat=val_ds.label_to_cat, iou_types=iou_types,
                   panoptic=args.masks)
    start_epoch = 0
    if args.resume:
        from vit_torch_tpu_torch.checkpoint.ckpt_io import (
            latest_step, restore_checkpoint)
        t0 = time.perf_counter()
        last = latest_step(args.resume)
        trainer.load_checkpoint_state(restore_checkpoint(
            args.resume, last, map_location=device))
        start_epoch = last + 1       # restore_checkpoint raised if None
        record["resumed"] = {"from": args.resume, "epoch": start_epoch,
                             "seconds": time.perf_counter() - t0}
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    if not args.no_initial_eval and start_epoch == 0:
        metrics = trainer.evaluate(val_loader, val_ds.coco, **eval_kw)
        record["initial"] = metrics
        print(f"initial: AP {metrics.get('bbox', {}).get('ap', 0):.4f}")
        save()

    # chunked epochs where no step reads the device before its loss
    use_scan = args.scan > 1 and (frcnn or args.matcher == "device")
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        # StepLR(lr_step, lr_gamma), reference coco_pipeline.py:464-476
        sched_lr = args.lr * args.lr_gamma ** (epoch // max(args.lr_step, 1))
        trainer.base_lr = sched_lr        # epoch 0's warmup ramps to it
        trainer.set_lr(sched_lr)
        if use_scan:
            train_logs = trainer.train_one_epoch_scan(
                train_loader, epoch, steps_per_dispatch=args.scan,
                log_fn=log_fn)
        else:
            train_logs = trainer.train_one_epoch(train_loader, epoch,
                                                 log_fn=log_fn)
        print()
        metrics = trainer.evaluate(val_loader, val_ds.coco, **eval_kw)
        row = {"epoch": epoch, "time": time.time() - t0,
               "train": train_logs, "val": metrics}
        record["logs"].append(row)
        if args.ckpt_dir and main_rank:
            from vit_torch_tpu_torch.checkpoint.ckpt_io import (
                save_checkpoint)
            t1 = time.perf_counter()
            save_checkpoint(args.ckpt_dir, trainer.checkpoint_state(epoch),
                            epoch)
            row["ckpt_seconds"] = time.perf_counter() - t1
        save()
        ap = metrics.get("bbox", {})
        line = (f"epoch {epoch}: loss {train_logs['loss_total']:.4f} "
                f"AP {ap.get('ap', 0):.4f} AP50 {ap.get('ap50', 0):.4f}")
        if "segm" in metrics:
            line += f" segmAP {metrics['segm'].get('ap', 0):.4f}"
        if "keypoints" in metrics:
            line += f" kpAP {metrics['keypoints'].get('ap', 0):.4f}"
        if "panoptic" in metrics:
            line += f" PQ {metrics['panoptic'].get('pq', 0):.4f}"
        print(line)

    if args.export_bundle and main_rank:
        from vit_torch_tpu_torch.serving.export import (export_detector,
                                                        save_bundle)
        exported = export_detector(
            trainer, image_size=args.image_size,
            batch_sizes=[int(b) for b in args.export_bs.split(",") if b])
        save_bundle(args.export_bundle, exported)
        record["export_bundle"] = exported["manifest"]
        print("serving bundle saved to", args.export_bundle)

    record["telem"]["completed"] = True
    save()
    print("stats saved to", args.stats_fp)
    return record


if __name__ == "__main__":
    main()
