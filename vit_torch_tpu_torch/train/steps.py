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
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked mean CE in float32 (plain CE like the reference's
    ``nn.CrossEntropyLoss``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _metrics(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    pred = logits.argmax(dim=-1)
    correct = ((pred == labels.long()).float() * mask).sum()
    count = mask.sum()
    return {"loss_sum": loss * count, "correct": correct, "count": count}


def _logits(model: nn.Module, images: torch.Tensor,
            lineareval: bool) -> torch.Tensor:
    if lineareval:
        with torch.no_grad():
            feats = model.backbone(images)
        return model.head(feats)
    return model(images)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    augment_fn: Optional[Callable] = None, *,
                    generator: Optional[torch.Generator] = None,
                    lineareval: bool = False) -> Callable:
    """``step(images, labels, mask) -> metrics``.  ``images`` are uint8
    NHWC on the model's device; ``augment_fn(generator, images)`` turns
    them into the model's input.  The caller puts the model in train
    mode."""

    def train_step(images: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images if augment_fn is None else augment_fn(generator, images)
        logits = _logits(model, x, lineareval)
        loss = cross_entropy_loss(logits, labels, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return _metrics(logits.detach(), labels, mask, loss.detach())

    return train_step


def make_eval_step(model: nn.Module,
                   eval_transform: Optional[Callable] = None,
                   with_preds: bool = False) -> Callable:
    """``step(images, labels, mask) -> metrics`` without gradients; the
    caller puts the model in eval mode.  ``with_preds`` adds the argmax
    predictions as ``"pred"``."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images if eval_transform is None else eval_transform(images)
        logits = model(x)
        loss = cross_entropy_loss(logits, labels, mask)
        out = _metrics(logits, labels, mask, loss)
        if with_preds:
            out["pred"] = logits.argmax(dim=-1)
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
