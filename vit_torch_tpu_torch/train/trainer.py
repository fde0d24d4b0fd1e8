"""Trainer, counterpart of ``vit_torch_tpu/train/trainer.py`` (the
reference's ``Network`` class, ``utils_network.py:117-553``).

Optimizer registry via ``--opt``, per-epoch LR scheduling via
``--lr_scheduler``, ``fit()`` over {train, val} loaders with per-epoch
stats rounds streamed to JSON, the epoch loop over device-resident splits
(``fit_scan``, the default), cached-feature linear eval
(``fit_lineareval_cached``), early stopping on a no-val-improvement
window, the ``VITX_DEBUG_EVAL=1`` dump, and throttled progress printing.

The trainer owns one seeded ``torch.Generator`` on the model's device; the
augmentation and every dropout / drop-path of the model draw from it, so a
run is reproducible from ``seed``.  It switches the model to ``train()``
for the train split and ``eval()`` for the val split.

Checkpoints (``checkpoint/ckpt_io.py``) follow the JAX trainer: with
``ckpt_dir`` every new best val accuracy is saved, and every
``save_every``-th epoch, with the epoch as the step; each best is mirrored
into ``ckpt_dir/best`` (``max_to_keep=1``) so that recency retention never
evicts it.  A checkpoint holds the model's ``state_dict()`` (BatchNorm
statistics included), the optimizer's, the step count, the epoch and the
generator's state.  ``resume`` restores the latest one and starts at the
epoch after it, with the best val accuracy of every save seeding both the
best-tracking and the early-stop history.  The cached linear eval saves
the full model (frozen backbone, live head) with the head optimizer's
state; a resumed cached run starts that optimizer afresh, as the JAX
package does.

As in the JAX package, the epoch loop over device-resident splits makes a
fresh ``np.random.default_rng(seed)`` and loops from the start epoch, so
a resumed run's first epoch takes epoch 0's permutation, not the one the
unbroken run would take there (the per-step loaders restart theirs the
same way).  A resumed run equals an unbroken one only where the order
cannot matter.

With a ``mesh`` (``parallel/mesh.py``) the model is laid out over it
before the optimizer is built (``parallel/api.py:prepare_model``: the
pipeline stage, tensor parallelism, the ring, FSDP2 with ``fsdp``), and
the steps of ``train/steps.py`` take its layout: each rank moves only its
rows of a global batch to its device, and the steps return the global
batch's metrics.
Checkpoints stay in the single-process layout (``api.full_state``,
written by rank 0 only), so a run saved under one mesh resumes under any
other and under none, as the JAX trainer's do.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from vit_torch_tpu_torch.checkpoint.ckpt_io import (BEST_SUBDIR,
                                                   best_saved_metric,
                                                   restore_checkpoint,
                                                   save_checkpoint)
from vit_torch_tpu_torch.models.layers import set_generator
from vit_torch_tpu_torch.models.zoo import ZooModel
from vit_torch_tpu_torch.parallel.multihost import is_main_process
from vit_torch_tpu_torch.train.optimizers import (get_optimizer,
                                                  set_learning_rate)
from vit_torch_tpu_torch.train.scan import (cache_backbone_features,
                                            device_split, epoch_indices,
                                            make_scan_eval_fn,
                                            make_scan_train_fn)
from vit_torch_tpu_torch.train.schedules import get_lr_factor_fn
from vit_torch_tpu_torch.train.steps import (
    accumulate_metrics, finalize_metrics, init_metric_accumulator,
    make_eval_step, make_train_step, split_params)
from vit_torch_tpu_torch.utils.stats import Stats


def should_early_stop(val_accs, window: int) -> bool:
    """Reference early-stop rule (``utils_network.py:322-328``): stop when
    the best val accuracy is not within the last ``window`` epochs."""
    if window <= 0 or len(val_accs) < window:
        return False
    return max(val_accs[-window:]) < max(val_accs)


def _debug_eval_on() -> bool:
    """True when the VITX_DEBUG_EVAL=1 dump is requested (read per epoch
    so tests can toggle it without rebuilding the trainer)."""
    return os.environ.get("VITX_DEBUG_EVAL") == "1"


def _print_debug_eval(outputs: np.ndarray, labels: np.ndarray) -> None:
    """The reference's DEBUG eval dump (``utils_network.py:500-514``):
    shapes, host-recomputed accuracy, and a 20-wide pred-vs-true window."""
    print()
    print(f"got outputs shape {outputs.shape} and labels shape "
          f"{labels.shape}")
    print("acc: ", float(np.mean((outputs == labels).astype(np.int32))))
    print("examples:")
    print("output:", outputs[:20])
    print("label: ", labels[:20])


class Trainer:
    def __init__(
        self,
        zoo_model: ZooModel,
        *,
        epochs: int = 100,
        lr: float = 0.001,
        opt: str = "sgd",
        lr_scheduler: str = "step",
        lr_step: int = 10,
        lr_gamma: float = 0.5,
        lr_scale: float = 0.1,
        lineareval: bool = False,
        earlystop_epoch: int = 5,
        seed: int = 0,
        stats: Optional[Stats] = None,
        augment_fn: Optional[Callable] = None,
        eval_transform: Optional[Callable] = None,
        ckpt_dir: str = "",
        save_every: int = 0,
        resume: str = "",
        print_progress: bool = True,
        mesh=None,
        fsdp: bool = False,
        fsdp_min_size: int = 2 ** 16,
        pipe_microbatches: int = 0,
    ) -> None:
        self.zoo_model = zoo_model
        self.model = zoo_model.model
        self.device = next(self.model.parameters()).device
        self.epochs = epochs
        self.base_lr = lr
        self.opt_name = opt
        self.lineareval = lineareval
        self.earlystop_epoch = earlystop_epoch
        self.stats = stats or Stats(splits=("train", "val"), stats_fp=None)
        self.print_progress = print_progress
        self.seed = seed
        self.augment_fn = augment_fn
        self.eval_transform = eval_transform
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.start_epoch = 0
        self.step = 0                         # optimizer steps taken

        self.lr_factor_fn = get_lr_factor_fn(lr_scheduler, lr_step, lr_gamma,
                                             lr_scale)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, self.generator)
        params = split_params(self.model, lineareval)
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            from vit_torch_tpu_torch.parallel.api import (param_groups,
                                                          prepare_model)
            self.layout = prepare_model(
                self.model, mesh, fsdp=fsdp, fsdp_min_size=fsdp_min_size,
                pipe_microbatches=pipe_microbatches, arch=zoo_model.arch)
            params = param_groups([p for p in self.model.parameters()
                                   if p.requires_grad])
        self.optimizer = get_optimizer(opt, params, lr)
        self.train_step = make_train_step(
            self.model, self.optimizer, augment_fn, generator=self.generator,
            lineareval=lineareval, layout=self.layout)
        self.eval_step = self._make_eval_step()

        # best-val tracking persists across resume: without re-seeding, the
        # first epoch after it would always rank as a new best
        self.best_acc = -1.0
        if resume:
            self._restore(resume)

    # ------------------------------------------------------------------
    def _make_eval_step(self, with_preds: bool = False):
        return make_eval_step(self.model, self.eval_transform,
                              with_preds=with_preds, layout=self.layout)

    def _restore(self, ckpt_dir: str) -> None:
        if self.layout is not None:
            from vit_torch_tpu_torch.parallel.api import load_full_state
            state = restore_checkpoint(ckpt_dir, map_location="cpu")
            load_full_state(self.model, self.optimizer, self.layout,
                            state["model"], state["optimizer"])
        else:
            state = restore_checkpoint(ckpt_dir, map_location=self.device)
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]
        # a CUDA generator's state is a CPU ByteTensor
        self.generator.set_state(state["generator"].cpu())
        self.start_epoch = state["epoch"] + 1
        prev_best = best_saved_metric(ckpt_dir)
        if prev_best is not None:
            self.best_acc = prev_best
        if self.print_progress:
            print(f"resumed from {ckpt_dir} at epoch {self.start_epoch}"
                  + (f" (best val_acc so far {prev_best:.4f})"
                     if prev_best is not None else ""))

    def checkpoint_state(self, epoch: int) -> Dict[str, Any]:
        """What a checkpoint holds after ``epoch`` (in the single-process
        layout; under a mesh a collective, every rank calls it)."""
        if self.layout is not None:
            from vit_torch_tpu_torch.parallel.api import full_state
            model, opt = full_state(self.model, self.optimizer, self.layout)
            return {"model": model, "optimizer": opt, "step": self.step,
                    "epoch": epoch, "generator": self.generator.get_state()}
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "epoch": epoch,
                "generator": self.generator.get_state()}

    def _maybe_checkpoint(self, epoch: int, val_acc: float) -> None:
        """The JAX trainer's policy: save on a new best and every
        ``save_every`` epochs; mirror each best into ``ckpt_dir/best``."""
        if not self.ckpt_dir:
            return
        is_best = val_acc > self.best_acc
        self.best_acc = max(self.best_acc, val_acc)
        if not (is_best or (self.save_every
                            and epoch % self.save_every == 0)):
            return
        state = self.checkpoint_state(epoch)
        if not is_main_process():
            return
        save_checkpoint(self.ckpt_dir, state, epoch,
                        metrics={"val_acc": val_acc})
        if is_best:
            save_checkpoint(os.path.join(self.ckpt_dir, BEST_SUBDIR), state,
                            epoch, metrics={"val_acc": val_acc},
                            max_to_keep=1)

    def _seed_val_accs(self) -> list:
        """Early-stop history seed: the best pre-resume accuracy keeps the
        no-improvement window honest across a resume."""
        return [self.best_acc] if self.best_acc > -1.0 else []

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]):
        """The step's tensors of a host batch: this rank's rows of it under
        a mesh."""
        arrays = (batch["image"], np.asarray(batch["label"], np.int64),
                  batch["mask"])
        if self.layout is not None:
            arrays = (self.layout.shard(a) for a in arrays)
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def run_one_epoch(self, loader: Iterable,
                      training: bool) -> Dict[str, float]:
        S = self.stats
        self.model.train(training)
        acc = init_metric_accumulator(self.device)
        lr = self.optimizer.param_groups[0]["lr"]
        debug_eval = not training and _debug_eval_on()
        dbg_out: list = []
        dbg_lab: list = []
        for batch in loader:
            valid = int(np.asarray(batch["mask"]).sum())
            images, labels, mask = self._to_device(batch)
            if training:
                m = self.train_step(images, labels, mask)
                self.step += 1
            else:
                m = self.eval_step(images, labels, mask)
            if debug_eval:
                keep = np.asarray(batch["mask"]).astype(bool)
                preds = self._make_eval_step(with_preds=True)(
                    images, labels, mask)["pred"].cpu().numpy()
                dbg_out.append(preds[keep])
                dbg_lab.append(np.asarray(batch["label"])[keep])
            acc = accumulate_metrics(acc, m)
            S.update(sample_count=valid, lr=lr)
            if self.print_progress:
                S.print()
        if debug_eval and dbg_out:
            _print_debug_eval(np.concatenate(dbg_out),
                              np.concatenate(dbg_lab))
        final = finalize_metrics(acc)
        # overwrite the streaming counters with exact device-side metrics
        S.S.metrics["acc"].reset_round()
        S.S.metrics["loss"].reset_round()
        S.update(sample_count=0, acc=final["acc"], loss=final["loss"], lr=lr)
        return final

    # ------------------------------------------------------------------
    def fit(self, loaders: Dict[str, Any]) -> Stats:
        """The per-step path (``--scan 0``): host batches from loaders."""
        S = self.stats
        val_accs = self._seed_val_accs()
        for epoch in range(self.start_epoch, self.epochs):
            set_learning_rate(self.optimizer,
                              self.base_lr * self.lr_factor_fn(epoch))
            for split in ("train", "val"):
                if split not in loaders or loaders[split] is None:
                    continue
                S.set_split(split)
                S.new_round(epoch)
                final = self.run_one_epoch(loaders[split],
                                           training=(split == "train"))
                S.finish_round(save=True)
                if self.print_progress:
                    S.print(force=True, end="\n")
                if split == "val":
                    val_accs.append(final["acc"])
                    self._maybe_checkpoint(epoch, final["acc"])
            if should_early_stop(val_accs, self.earlystop_epoch):
                if self.print_progress:
                    print(f"\nearly stop at epoch {epoch}: no val improvement "
                          f"in {self.earlystop_epoch} epochs")
                break
        S.finish(save=True)
        return S

    # ------------------------------------------------------------------
    def fit_scan(self, sets: Dict[str, Any], batch_size: int) -> Stats:
        """Epoch loop over device-resident splits (see ``train/scan.py``):
        each split moves to the device once as uint8; every step gathers
        its batch there.  ``sets`` maps split → (uint8 images, labels)."""
        with_preds = _debug_eval_on()
        train_run = make_scan_train_fn(self.train_step)
        eval_run = make_scan_eval_fn(self._make_eval_step(with_preds),
                                     with_preds=with_preds)
        device_sets = {split: device_split(imgs, labels, self.device)
                       for split, (imgs, labels) in sets.items()}
        return self._scan_epoch_loop(train_run, eval_run, device_sets,
                                     batch_size, self.model, self.layout)

    def fit_lineareval_cached(self, sets: Dict[str, Any],
                              batch_size: int) -> Stats:
        """Cached-feature linear eval: the frozen backbone runs once over
        each split, then every epoch trains only the MLP head on the cached
        features, with a fresh optimizer over the head.  Train-time random
        augmentation is skipped, exactly like the reference's cached
        datasets."""
        if not self.lineareval:
            raise ValueError("fit_lineareval_cached requires lineareval")
        if self.layout is not None and self.layout.pipe is not None:
            raise ValueError("cached lineareval does not pipeline; use the "
                             "per-step path (fit) with a pipe mesh")
        head = self.model.head
        device_sets = {}
        for split, (imgs, labels) in sets.items():
            images, labels_d = device_split(imgs, labels, self.device)
            feats = cache_backbone_features(self.model.backbone, images,
                                            batch_size, self.eval_transform)
            device_sets[split] = (feats, labels_d)
        head_opt = get_optimizer(self.opt_name, head.parameters(),
                                 self.base_lr)
        outer_opt, self.optimizer = self.optimizer, head_opt
        with_preds = _debug_eval_on()
        train_run = make_scan_train_fn(make_train_step(head, head_opt))
        eval_run = make_scan_eval_fn(
            make_eval_step(head, with_preds=with_preds),
            with_preds=with_preds)
        try:
            return self._scan_epoch_loop(train_run, eval_run, device_sets,
                                         batch_size, head)
        finally:
            self.optimizer = outer_opt

    def _scan_epoch_loop(self, train_run, eval_run, device_sets,
                         batch_size: int, module: torch.nn.Module,
                         layout=None) -> Stats:
        """The epochs over device-resident splits; under a ``layout`` each
        step gathers this rank's rows of its global batch."""
        rng = np.random.default_rng(self.seed)   # epoch 0's, also on resume
        S = self.stats
        val_accs = self._seed_val_accs()
        for epoch in range(self.start_epoch, self.epochs):
            lr = self.base_lr * self.lr_factor_fn(epoch)
            set_learning_rate(self.optimizer, lr)
            for split, training in (("train", True), ("val", False)):
                if split not in device_sets:
                    continue
                images, labels = device_sets[split]
                S.set_split(split)
                S.new_round(epoch)
                idx, msk = epoch_indices(len(labels), batch_size, rng,
                                         shuffle=training)
                rows = (idx, msk) if layout is None else (
                    layout.shard(idx, 1), layout.shard(msk, 1))
                module.train(training)
                if training:
                    m = train_run(images, labels, *rows)
                    self.step += len(idx)
                else:
                    m = eval_run(images, labels, *rows)
                    if isinstance(m, tuple):       # VITX_DEBUG_EVAL preds
                        m, preds = m
                        valid = msk.astype(bool)
                        _print_debug_eval(
                            preds.cpu().numpy()[valid],
                            labels.cpu().numpy()[idx][valid])
                final = finalize_metrics(m)
                S.update(sample_count=int(final["count"]), lr=lr,
                         acc=final["acc"], loss=final["loss"])
                S.finish_round(save=True)
                if self.print_progress:
                    S.print(force=True, end="\n")
                if split == "val":
                    val_accs.append(final["acc"])
                    self._maybe_checkpoint(epoch, final["acc"])
            if should_early_stop(val_accs, self.earlystop_epoch):
                if self.print_progress:
                    print(f"\nearly stop at epoch {epoch}")
                break
        S.finish(save=True)
        return S
