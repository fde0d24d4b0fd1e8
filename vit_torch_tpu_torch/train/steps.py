"""Train and eval steps with device-resident metrics, counterpart of
``vit_torch_tpu/train/steps.py``.

A train step is augment → forward → masked fp32 cross-entropy → backward →
optimizer step, all queued on the model's device; it returns three device
scalars (``loss_sum``, ``correct``, ``count``) that the epoch loop adds up
on the device, so the host syncs once per logging window
(:func:`finalize_metrics`).

Linear eval freezes the backbone's parameters and runs the backbone under
``torch.no_grad()``, so no backbone backward is ever built: the
counterpart of differentiating only the trainable subtree
(``steps.py:11-16``).  The backbone still runs in train mode (dropout and
drop-path active), as the JAX step calls it with ``deterministic=False``.

Batches carry a validity ``mask`` so the final partial batch of an epoch
is zero-padded to the static batch shape and counts for nothing.

With a ``layout`` (``parallel/api.py:Layout``) the same steps run on a
mesh, and equal the single-process step on the global batch, as GSPMD
makes the JAX package's sharded step (``tests/test_parallel.py:107``):
each step takes this rank's rows of the global batch (``Layout.shard``);
the augmentation is drawn for the global batch and applied to those rows;
the cross-entropy divides by the global mask count; the backward is
scaled by the batch shards and the gradients averaged over the replicas
(``api.sync_gradients``); and the metrics are summed over the batch
shards.  Without one, none of that happens.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn


def split_params(model: nn.Module, lineareval: bool) -> List[nn.Parameter]:
    """The trainable parameters of a ``Classifier``; under ``lineareval``
    the backbone's are frozen (``requires_grad=False``) and only the head
    trains."""
    if not lineareval:
        for p in model.parameters():
            p.requires_grad_(True)
        return list(model.parameters())
    if getattr(model, "head", None) is None:
        raise ValueError("lineareval requires a classifier head to train")
    for p in model.backbone.parameters():
        p.requires_grad_(False)
    for p in model.head.parameters():
        p.requires_grad_(True)
    return list(model.head.parameters())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean CE in float32 (plain CE like the reference's
    ``nn.CrossEntropyLoss``); ``count`` replaces the mask's own sum as the
    denominator (the global count on a mesh)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if count is None:
        count = mask.sum()
    return (nll * mask).sum() / count.clamp_min(1.0)


def _count(mask: torch.Tensor, layout) -> torch.Tensor:
    """The valid rows of the global batch."""
    return mask.sum() if layout is None else layout.reduce_batch(mask.sum())


def _metrics(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             loss: torch.Tensor, layout=None) -> Dict[str, torch.Tensor]:
    pred = logits.argmax(dim=-1)
    correct = ((pred == labels.long()).float() * mask).sum()
    count = mask.sum()
    if layout is not None:
        # each rank's loss is its part of the global mean
        loss, correct, count = layout.reduce_batch(torch.stack(
            [loss.float(), correct.float(), count.float()]))
    return {"loss_sum": loss * count, "correct": correct, "count": count}


def _logits(model: nn.Module, images: torch.Tensor,
            lineareval: bool) -> torch.Tensor:
    if lineareval:
        with torch.no_grad():
            feats = model.backbone(images)
        return model.head(feats)
    return model(images)


def _augment(augment_fn: Optional[Callable], generator, images: torch.Tensor,
             layout) -> torch.Tensor:
    """The train input of this rank's ``images``.  On a batch-sharded
    layout an augmentation with ``draw`` / ``apply`` (``data/augment.py:
    DrawnAugment``) draws for the global batch and applies this rank's
    rows of the draws; a plain ``fn(generator, images)`` is called on the
    rows as it is (it must draw nothing from the generator)."""
    if augment_fn is None:
        return images
    if layout is None or layout.batch_count == 1 or not hasattr(
            augment_fn, "draw"):
        return augment_fn(generator, images)
    batch = images.shape[0] * layout.batch_count
    draws = augment_fn.draw(generator, batch, images.shape[1:3],
                            images.device)
    return augment_fn.apply(images, layout.shard_tree(draws, batch))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    augment_fn: Optional[Callable] = None, *,
                    generator: Optional[torch.Generator] = None,
                    lineareval: bool = False, layout=None) -> Callable:
    """``step(images, labels, mask) -> metrics``.  ``images`` are uint8
    NHWC on the model's device (this rank's rows under a ``layout``);
    ``augment_fn(generator, images)`` turns them into the model's input.
    The caller puts the model in train mode."""
    if layout is not None:
        from vit_torch_tpu_torch.parallel.api import sync_gradients
        params = [p for p in model.parameters() if p.requires_grad]

    def train_step(images: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _augment(augment_fn, generator, images, layout)
        logits = _logits(model, x, lineareval)
        loss = cross_entropy_loss(logits, labels, mask, _count(mask, layout))
        optimizer.zero_grad(set_to_none=True)
        if layout is None:
            loss.backward()
        else:
            (loss * layout.loss_scale).backward()
            sync_gradients(params, layout)
        optimizer.step()
        return _metrics(logits.detach(), labels, mask, loss.detach(), layout)

    return train_step


def make_eval_step(model: nn.Module,
                   eval_transform: Optional[Callable] = None,
                   with_preds: bool = False, layout=None) -> Callable:
    """``step(images, labels, mask) -> metrics`` without gradients; the
    caller puts the model in eval mode.  ``with_preds`` adds the argmax
    predictions as ``"pred"`` (the global batch's under a ``layout``)."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images if eval_transform is None else eval_transform(images)
        logits = model(x)
        loss = cross_entropy_loss(logits, labels, mask, _count(mask, layout))
        out = _metrics(logits, labels, mask, loss, layout)
        if with_preds:
            pred = logits.argmax(dim=-1)
            out["pred"] = pred if layout is None else layout.gather_batch(
                pred)
        return out

    return eval_step


def init_metric_accumulator(device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("loss_sum", "correct", "count")}


def accumulate_metrics(acc: Dict[str, torch.Tensor],
                       m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: acc[k] + m[k].float() for k in acc}


def finalize_metrics(acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The single device-to-host sync per logging window."""
    vals = torch.stack([acc["loss_sum"], acc["correct"],
                        acc["count"]]).float().cpu().tolist()
    loss_sum, correct, count = vals
    denom = max(count, 1.0)
    return {"acc": correct / denom, "loss": loss_sum / denom,
            "count": count}
