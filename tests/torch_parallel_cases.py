"""The rank side of ``tests/test_torch_port_parallel.py``: one spawned
group of four gloo ranks runs every multi-rank case once, and rank 0
saves the results for the tests to compare.  Imports no JAX (the ranks
never initialise it); the test process prepares the inputs
(``inputs.pt``: seeded weights in the port's names, from the JAX trees)
and runs the references.
"""

import datetime
import os
import tempfile
import traceback
import warnings
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
VIT = dict(arch="vit_tiny_test", classifier=[10], image_size=16)
STEPS, LR = 3, 0.05
FSDP_MIN = 1024        # vit_tiny_test's largest tensors hold 16384 values


def vit_batch():
    """The 3-step classification batch (16 images; the last 3 rows
    padding, so that the global count matters)."""
    rng = np.random.default_rng(0)
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    return (rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 10, 16).astype(np.int64), mask)


def ring_inputs():
    """q, k, v and the output gradient, (B, N, H, D) at an N that seq=4
    does not divide."""
    rng = np.random.default_rng(5)
    return [rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
            for _ in range(4)]


def _mesh(spec):
    from vit_torch_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(spec, "cpu")


def _zoo(arch, classifier, image_size, dtype=torch.float32, seed=0):
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    return VisionModelZoo.get_model(
        arch, classifier=classifier, image_size=image_size, dtype=dtype,
        device="cpu", generator=torch.Generator().manual_seed(seed))


def _augment():
    """The real train augmentation at 16 px: crop, flip, AutoAugment,
    cutout."""
    from vit_torch_tpu_torch.data.augment import make_train_augment
    return make_train_augment((0.5, 0.5, 0.5), (0.25, 0.25, 0.25),
                              cutout_size=4, auto_policy="imagenet")


def augment_batch():
    """:func:`vit_batch` as uint8 pictures, for the augmentation."""
    _, labels, mask = vit_batch()
    return (np.random.default_rng(8).integers(
        0, 256, (16, 16, 16, 3), dtype=np.uint8), labels, mask)


def _run_steps(zm, step, layout, images, labels, mask, steps):
    zm.model.train()
    batch = [torch.as_tensor(a) for a in (images, labels, mask)]
    if layout is not None:
        batch = [layout.shard(t) for t in batch]
    losses = []
    for _ in range(steps):
        m = step(*batch)
        losses.append((m["loss_sum"] / m["count"]).item())
    return losses


def sharded_steps(zm, spec, images, labels, mask, *, fsdp=False,
                  fsdp_min_size=2 ** 16, opt="sgd", lr=LR, steps=STEPS,
                  augment=False):
    """``steps`` train steps of ``zm`` over the mesh of ``spec`` on one
    global batch, each rank feeding its rows: (losses, the single-process
    state dict)."""
    from vit_torch_tpu_torch.parallel.api import (full_state, param_groups,
                                                  prepare_model)
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step
    layout = prepare_model(zm.model, _mesh(spec), fsdp=fsdp,
                           fsdp_min_size=fsdp_min_size, arch=zm.arch)
    opt = get_optimizer(opt, param_groups(
        [p for p in zm.model.parameters() if p.requires_grad]), lr)
    if fsdp:
        # the card's multi-tensor update (the CPU's default is per tensor),
        # which cannot mix FSDP's DTensors with plain tensors in a group
        for group in opt.param_groups:
            group["foreach"] = True
    step = make_train_step(zm.model, opt, _augment() if augment else None,
                           generator=torch.Generator().manual_seed(7),
                           layout=layout)
    losses = _run_steps(zm, step, layout, images, labels, mask, steps)
    return losses, full_state(zm.model, None, layout)[0]


def plain_steps(zm, images, labels, mask, *, opt="sgd", lr=LR,
                steps=STEPS, augment=False):
    """The single-process counterpart of :func:`sharded_steps`."""
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step, split_params
    step = make_train_step(zm.model, get_optimizer(
        opt, split_params(zm.model, False), lr),
        _augment() if augment else None,
        generator=torch.Generator().manual_seed(7))
    losses = _run_steps(zm, step, None, images, labels, mask, steps)
    return losses, {k: v.detach().clone()
                    for k, v in zm.model.state_dict().items()}


TP_FAMILIES = (("cait_test", 16), ("swin_test", 32))


def tp_family_batch(size):
    _, labels, mask = vit_batch()
    return (np.random.default_rng(2).normal(
        0, 1, (16, size, size, 3)).astype(np.float32), labels, mask)


# --------------------------------------------------------------------------
# the cases (each runs on every rank; rank 0's return value is kept)

def case_vit(inputs, workdir):
    out = {}
    for spec, fsdp in (("data=4", False), ("data=2,model=2", False),
                       ("data=4", True)):
        zm = _zoo(**VIT)
        zm.model.load_state_dict(inputs["vit"])
        key = spec + (" fsdp" if fsdp else "")
        out[key] = sharded_steps(zm, spec, *vit_batch(), fsdp=fsdp,
                                 fsdp_min_size=FSDP_MIN)
        if fsdp:
            from torch.distributed.tensor import DTensor
            out["fsdp_sharded"] = sorted(
                n for n, p in zm.model.named_parameters()
                if isinstance(p, DTensor))
    zm = _zoo(**VIT)
    zm.model.load_state_dict(inputs["vit"])
    out["data=4 augment"] = sharded_steps(zm, "data=4", *augment_batch(),
                                          augment=True)
    return out


def case_seq(inputs, workdir):
    zm = _zoo(**VIT)
    zm.model.load_state_dict(inputs["vit"])
    return sharded_steps(zm, "data=2,seq=2", *vit_batch())


def case_pipe(inputs, workdir):
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    from vit_torch_tpu_torch.parallel.pipeline import (
        build_pipeline_classifier)
    zm = _zoo(**VIT)
    zm.model.load_state_dict(inputs["vit"])
    out = {"trainer_steps": sharded_steps(zm, "data=2,pipe=2", *vit_batch())}
    _, _, step = build_pipeline_classifier(
        VIT_CONFIGS["vit_tiny_test"], 10, _mesh("data=2,pipe=2"),
        image_size=16, num_microbatches=4, seed=3)
    images, labels, _ = vit_batch()
    out["classifier_losses"] = [step(torch.as_tensor(images),
                                     torch.as_tensor(labels)).item()
                                for _ in range(4)]
    return out


def case_tp_families(inputs, workdir):
    out = {}
    for arch, size in TP_FAMILIES:
        zm = _zoo(arch, [10], size)
        zm.model.load_state_dict(inputs[arch])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[arch] = sharded_steps(zm, "data=2,model=2",
                                      *tp_family_batch(size))
        out[arch + " warnings"] = [str(w.message) for w in caught]
    return out


def case_resnet(inputs, workdir):
    zm = _zoo("resnet_test", [10], 32, dtype=torch.float64)
    zm.model.load_state_dict(inputs["resnet"])
    zm.model.double()
    images, labels, mask = inputs["resnet_batch"]
    return sharded_steps(zm, "data=4", images, labels, mask)


def case_ring(inputs, workdir):
    from vit_torch_tpu_torch.ops.ring_attention import ring_attention
    mesh = _mesh("seq=4")
    group, S, idx = mesh.group("seq"), 4, mesh.coords["seq"]
    q, k, v, do = (torch.as_tensor(a) for a in ring_inputs())
    N = q.shape[1]
    n = -(-N // S)

    def local(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n * S - N))
        return t[:, idx * n:(idx + 1) * n].contiguous()

    ql, kl, vl = (local(t).requires_grad_() for t in (q, k, v))
    out = ring_attention(ql, kl, vl, group, kv_len=N)
    out.backward(local(do))

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(S)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, 1)[:, :N]

    return {"out": gather(out.detach()), "dq": gather(ql.grad),
            "dk": gather(kl.grad), "dv": gather(vl.grad)}


def case_full_grads(inputs, workdir):
    """One step's gradients gathered to the single-process layout
    (``api.full_grads``) on a tensor-parallel and a pipeline mesh."""
    from vit_torch_tpu_torch.parallel.api import (full_grads, param_groups,
                                                  prepare_model)
    from vit_torch_tpu_torch.train.optimizers import get_optimizer
    from vit_torch_tpu_torch.train.steps import make_train_step
    out = {}
    for spec in ("data=2,model=2", "data=2,pipe=2"):
        zm = _zoo(**VIT)
        zm.model.load_state_dict(inputs["vit"])
        layout = prepare_model(zm.model, _mesh(spec), arch=zm.arch)
        step = make_train_step(zm.model, get_optimizer("sgd", param_groups(
            list(zm.model.parameters())), LR), None,
            generator=torch.Generator().manual_seed(7), layout=layout)
        _run_steps(zm, step, layout, *vit_batch(), 1)
        out[spec] = full_grads(zm.model, layout)
    return out


def case_staged(inputs, workdir):
    """The ring and the pipeline's steps again with every point-to-point
    transfer staged through host buffers (``collectives._staged`` forced
    true): the tests hold them bit for bit against the direct transfers."""
    from vit_torch_tpu_torch.parallel import collectives
    with mock.patch.object(collectives, "_staged", lambda t, group: True):
        out = {"ring": case_ring(inputs, workdir)}
        zm = _zoo(**VIT)
        zm.model.load_state_dict(inputs["vit"])
        out["pipe"] = sharded_steps(zm, "data=2,pipe=2", *vit_batch())
    return out


def _ckpt_trainer(spec, workdir, **kw):
    from vit_torch_tpu_torch.data.loader import ArrayDataLoader
    from vit_torch_tpu_torch.train.trainer import Trainer
    zm = _zoo(**VIT, seed=4)
    images, labels = ckpt_data()
    loaders = {"train": ArrayDataLoader(images, labels, 8, shuffle=True,
                                        seed=0),
               "val": ArrayDataLoader(images[:8], labels[:8], 8)}
    tr = Trainer(zm, opt="adamw", lr=1e-3, seed=0,
                 augment_fn=lambda g, x: x.float() / 255.0,
                 eval_transform=lambda x: x.float() / 255.0,
                 ckpt_dir=os.path.join(workdir, "ckpt"),
                 print_progress=False,
                 mesh=None if spec is None else _mesh(spec), **kw)
    return tr, loaders


def ckpt_data():
    rng = np.random.default_rng(9)
    return (rng.integers(0, 256, (24, 16, 16, 3), dtype=np.uint8),
            rng.integers(0, 10, 24).astype(np.int64))


def case_ckpt(inputs, workdir):
    from vit_torch_tpu_torch.parallel.api import full_state
    tr, loaders = _ckpt_trainer("data=4", workdir, epochs=1, fsdp=True,
                                fsdp_min_size=FSDP_MIN)
    tr.fit(loaders)
    dist.barrier()
    tr2, loaders = _ckpt_trainer("data=2,pipe=2", workdir, epochs=2,
                                 resume=os.path.join(workdir, "ckpt"))
    start = tr2.start_epoch
    tr2.fit(loaders)
    state, opt = full_state(tr2.model, tr2.optimizer, tr2.layout)
    return {"start_epoch": start, "state": state, "step": tr2.step,
            "opt_keys": sorted(opt["state"])}


def scan_trainer(spec):
    """A trainer for the epoch loop over device-resident splits, with the
    real train augmentation; SGD as the other parity cases (AdamW scales
    a gradient that is rounding noise, as the key bias's, to a full
    step)."""
    from vit_torch_tpu_torch.train.trainer import Trainer
    zm = _zoo(**VIT, seed=5)
    return Trainer(zm, epochs=2, opt="sgd", lr=LR, seed=0,
                   augment_fn=_augment(),
                   eval_transform=lambda x: x.float() / 255.0,
                   print_progress=False,
                   mesh=None if spec is None else _mesh(spec))


def scan_sets():
    images, labels = ckpt_data()
    return {"train": (images, labels), "val": (images[:16], labels[:16])}


def case_scan(inputs, workdir):
    from vit_torch_tpu_torch.parallel.api import full_state
    tr = scan_trainer("data=4")
    stats = tr.fit_scan(scan_sets(), 8)
    return {"rows": scan_rows(stats), "step": tr.step,
            "state": full_state(tr.model, None, tr.layout)[0]}


def scan_rows(stats):
    """Each epoch's (train loss, val loss, val accuracy)."""
    d = stats.to_dict()
    return [(t["loss"], v["loss"], v["acc"])
            for t, v in zip(d["train"], d["val"])]


def detection_batches(masks=False):
    """Two global batches of 4 synthetic COCO pictures at 32 px."""
    from vit_torch_tpu_torch.detection.coco_data import (
        CocoDetectionDataset, CocoLoader, make_synthetic_coco)
    tmp = tempfile.mkdtemp(prefix="coco_dp_")
    img_dir, ann = make_synthetic_coco(tmp, n_images=8, size=64)
    ds = CocoDetectionDataset(img_dir, ann, image_size=32, max_boxes=8)
    return list(CocoLoader(ds, 4)), ds.num_classes


DETR_CFG = dict(num_queries=8, hidden_dim=32, num_heads=4, enc_layers=1,
                dec_layers=2, ffn_dim=64)
DETR_LR = 1e-3
FRCNN_LR = 1e-2


FRCNN_CFG = dict(image_size=32, fpn_channels=32, strides=(4, 8),
                 anchor_sizes=(8.0, 16.0), num_proposals=32,
                 rpn_pre_nms_topk=64, rpn_batch=32, roi_batch=16,
                 detections=10)


def detection_trainers(kind, num_classes, mesh=None, state=None,
                       augment=True):
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import (DetectionTrainer,
                                                      FasterRCNNTrainer)
    from vit_torch_tpu_torch.detection.faster_rcnn import (FasterRCNNConfig,
                                                           build_faster_rcnn)
    gen = torch.Generator().manual_seed(0)
    if kind == "detr":
        cfg = DETRConfig(num_classes=num_classes, **DETR_CFG)
        model = build_detr(cfg, "swin_test", 32, torch.float32, gen, "cpu")
        if state is not None:
            model.load_state_dict(state)
        return DetectionTrainer(model, image_size=32,
                                num_classes=num_classes, lr=DETR_LR,
                                augment=augment, seed=0, mesh=mesh)
    cfg = FasterRCNNConfig(num_classes=num_classes, **FRCNN_CFG)
    model = build_faster_rcnn(cfg, "resnet_test", torch.float32, gen, "cpu")
    if state is not None:
        model.load_state_dict(state)
    return FasterRCNNTrainer(model, cfg=cfg, lr=FRCNN_LR, augment=True,
                             seed=0, mesh=mesh)


def detection_run(tr, batches):
    logs = [{k: v.item() for k, v in tr.train_step(b).items()}
            for b in batches]
    return logs, {k: v.detach().clone()
                  for k, v in tr.model.state_dict().items()}


def case_detection(inputs, workdir):
    batches, k = detection_batches()
    mesh = _mesh("data=4")
    out = {kind: detection_run(detection_trainers(kind, k, mesh), batches)
           for kind in ("detr", "frcnn")}
    out["detr_jax"] = detection_run(detection_trainers(
        "detr", k, mesh, state=inputs["detr"], augment=False), batches)
    # one step on the JAX trainer's draws for the global batch (its flip
    # and sampling noise), each rank keeping its row
    tr = detection_trainers("frcnn", k, mesh, state=inputs["frcnn"])
    tr.draw = lambda B: dict(inputs["frcnn_draws"])
    out["frcnn_jax"] = detection_run(tr, batches[:1])
    return out


def case_cli(inputs, workdir):
    from vit_torch_tpu_torch.cli.main import main
    rank = dist.get_rank()
    main(["--dataset", "synthetic", "--arch", "vit_tiny_test",
          "--image_size", "32", "--epoch", "1", "--bs", "16", "--device",
          "cpu", "--limit_train", "32", "--limit_test", "16", "--scan", "0",
          "--mesh", "data=2,model=2", "--dtype", "float32",
          "--ckpt_dir", os.path.join(workdir, "cli_ckpt"),
          "--export_bundle", os.path.join(workdir, "cli_bundle"),
          "--export_bs", "1,4",
          "--stats_fp", os.path.join(workdir, f"stats_r{rank}.json")])
    return sorted(f for f in os.listdir(workdir) if f.startswith("stats_"))


def case_utils(inputs, workdir):
    from vit_torch_tpu_torch.data.loader import ArrayDataLoader
    from vit_torch_tpu_torch.parallel.multihost import (all_gather_objects,
                                                        save_on_master)
    rank = dist.get_rank()
    gathered = all_gather_objects({"rank": rank, "sq": rank * rank})

    def write(path):
        with open(path, "w") as f:
            f.write("saved")

    save_on_master(write, os.path.join(workdir, f"master_r{rank}.txt"))
    from vit_torch_tpu_torch.parallel.api import Layout, shard_batch
    rows = shard_batch({"image": torch.arange(8.0), "label": torch.arange(8),
                        "note": "kept"}, Layout(_mesh("data=4")))
    loader = ArrayDataLoader(np.zeros((10, 2, 2, 3), np.uint8),
                             np.arange(10), 2, process_shard=True)
    shards = all_gather_objects(loader.labels.tolist())
    from vit_torch_tpu_torch.parallel.partition import apply_tensor_parallel
    zm = _zoo(**VIT)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cut = apply_tensor_parallel(zm.model, _mesh("model=4").group("model"))
    dist.barrier()
    return {"gathered": gathered, "shards": shards,
            "tp4_cut": sorted(cut), "tp4_warnings": [str(w.message)
                                                      for w in caught],
            "batch_rows": all_gather_objects(
                (rows["image"].tolist(), rows["label"].tolist(),
                 rows["note"])),
            "saved": sorted(f for f in os.listdir(workdir)
                            if f.startswith("master_"))}


CASES = [case_utils, case_ring, case_vit, case_seq, case_pipe, case_staged,
         case_full_grads, case_tp_families, case_resnet, case_ckpt,
         case_scan, case_detection, case_cli]


def _rank_main(rank: int, port: int, workdir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    results = {}
    for case in CASES:
        try:
            results[case.__name__] = case(inputs, workdir)
        except Exception:                     # reported by the test
            results[case.__name__] = {"error": traceback.format_exc()}
            raise
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_group(workdir: str, timeout: float = 240.0) -> dict:
    """Spawn the four ranks (the ``spawn`` context: no fork of a process
    that has initialised JAX), wait for them, return rank 0's results."""
    import multiprocessing

    from vit_torch_tpu_torch.parallel.multihost import free_port
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, workdir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * WORLD:
        raise RuntimeError(f"the rank group failed: exit codes {codes}")
    return torch.load(os.path.join(workdir, "results.pt"), weights_only=False)
