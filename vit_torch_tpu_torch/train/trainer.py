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

Checkpointing, resume, meshes and pipelines are not ported yet: the CLI
refuses their flags (``utils/args.py:check_ported``).  Fine-tuning a Swin
on CUDA raises here, before the first step: its window kernels have no
backward yet (ROADMAP.md B6).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from vit_torch_tpu_torch.models.layers import set_generator
from vit_torch_tpu_torch.models.zoo import ZooModel
from vit_torch_tpu_torch.ops.window_attention import BACKWARD_ITEM
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
        print_progress: bool = True,
    ) -> None:
        self.zoo_model = zoo_model
        self.model = zoo_model.model
        self.device = next(self.model.parameters()).device
        if (self.device.type == "cuda" and not lineareval
                and zoo_model.family == "swin"):
            # refused here, before the first step, not inside one
            raise NotImplementedError(
                f"fine-tuning Swin on CUDA needs the window kernels' "
                f"backward ({BACKWARD_ITEM}): use --lineareval, or train on "
                f"the CPU")
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

        self.lr_factor_fn = get_lr_factor_fn(lr_scheduler, lr_step, lr_gamma,
                                             lr_scale)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, self.generator)
        self.optimizer = get_optimizer(
            opt, split_params(self.model, lineareval), lr)
        self.train_step = make_train_step(
            self.model, self.optimizer, augment_fn, generator=self.generator,
            lineareval=lineareval)
        self.eval_step = make_eval_step(self.model, eval_transform)

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray]):
        return (torch.from_numpy(batch["image"]).to(self.device),
                torch.from_numpy(np.asarray(batch["label"], np.int64)).to(
                    self.device),
                torch.from_numpy(batch["mask"]).to(self.device))

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
            else:
                m = self.eval_step(images, labels, mask)
            if debug_eval:
                keep = np.asarray(batch["mask"]).astype(bool)
                with torch.no_grad():
                    x = (images if self.eval_transform is None
                         else self.eval_transform(images))
                    preds = self.model(x).argmax(-1).cpu().numpy()
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
        val_accs: list = []
        for epoch in range(self.epochs):
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
        eval_run = make_scan_eval_fn(
            make_eval_step(self.model, self.eval_transform,
                           with_preds=with_preds), with_preds=with_preds)
        device_sets = {split: device_split(imgs, labels, self.device)
                       for split, (imgs, labels) in sets.items()}
        return self._scan_epoch_loop(train_run, eval_run, device_sets,
                                     batch_size, self.model)

    def fit_lineareval_cached(self, sets: Dict[str, Any],
                              batch_size: int) -> Stats:
        """Cached-feature linear eval: the frozen backbone runs once over
        each split, then every epoch trains only the MLP head on the cached
        features, with a fresh optimizer over the head.  Train-time random
        augmentation is skipped, exactly like the reference's cached
        datasets."""
        if not self.lineareval:
            raise ValueError("fit_lineareval_cached requires lineareval")
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
                         batch_size: int, module: torch.nn.Module) -> Stats:
        rng = np.random.default_rng(self.seed)
        S = self.stats
        val_accs: list = []
        for epoch in range(self.epochs):
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
                module.train(training)
                if training:
                    m = train_run(images, labels, idx, msk)
                else:
                    m = eval_run(images, labels, idx, msk)
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
            if should_early_stop(val_accs, self.earlystop_epoch):
                if self.print_progress:
                    print(f"\nearly stop at epoch {epoch}")
                break
        S.finish(save=True)
        return S
