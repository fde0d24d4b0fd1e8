"""Optimizer registry, counterpart of ``vit_torch_tpu/train/optimizers.py``.

``--opt`` ∈ {sgd, adam, adadelta, adagrad, adamw, adabelief}, the
reference's ``Network.optimizer_fns`` (``utils_network.py:119-126``).  The
JAX package pinned optax to the torch semantics the reference trains with
(``tests/test_torch_trajectory.py``), so here the first five are stock
``torch.optim``:

- ``sgd``: momentum 0.9;
- ``adam``, ``adadelta``: torch defaults;
- ``adagrad``: torch defaults (initial accumulator 0, eps 1e-10);
- ``adamw``: torch's default decoupled weight decay 0.01.

``adabelief`` is the reference's ``AdaBelief(eps=1e-16, betas=(0.9,
0.999), weight_decouple=True, rectify=True)``, written by hand below as
:class:`RectifiedAdaBelief` (the adabelief-pytorch package is not a
dependency).

The per-epoch LR is set on the param groups (:func:`set_learning_rate`),
the counterpart of the JAX package's injected ``learning_rate``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch


class RectifiedAdaBelief(torch.optim.Optimizer):
    """AdaBelief with variance rectification (paper Algorithm 2).

    ``s_t`` accumulates the belief ``(g - m)^2 + eps``; while the SMA
    length ``rho_t <= 4`` the step is bias-corrected momentum SGD, after
    which the RAdam-style term ``r_t`` scales the adaptive step
    ``(m / bc1) / (sqrt(s / bc2) + eps)``.  eps enters both inside ``s_t``
    and in the denominator, as in the JAX package."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, lr = group["eps"], group["lr"]
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["s"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, s = state["m"], state["s"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g - m, g - m, value=1 - b2).add_(eps)
                bc1 = 1 - b1 ** t
                bc2 = 1 - b2 ** t
                rho_t = rho_inf - 2.0 * t * b2 ** t / bc2
                if rho_t > 4.0:
                    r_t = math.sqrt((rho_t - 4.0) * (rho_t - 2.0) * rho_inf
                                    / ((rho_inf - 4.0) * (rho_inf - 2.0)
                                       * rho_t))
                    denom = (s / bc2).sqrt_().add_(eps)
                    p.addcdiv_(m, denom, value=-lr * r_t / bc1)
                else:
                    p.add_(m, alpha=-lr / bc1)
        return loss


OPTIMIZERS: Dict[str, Callable] = {
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr, momentum=0.9),
    "adam": lambda params, lr: torch.optim.Adam(params, lr=lr),
    "adadelta": lambda params, lr: torch.optim.Adadelta(params, lr=lr),
    "adagrad": lambda params, lr: torch.optim.Adagrad(params, lr=lr),
    "adamw": lambda params, lr: torch.optim.AdamW(params, lr=lr,
                                                  weight_decay=0.01),
    "adabelief": lambda params, lr: RectifiedAdaBelief(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-16),
}


def get_optimizer(name: str, params: Iterable[torch.Tensor],
                  lr: float = 0.001) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` at learning rate ``lr``."""
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} is not supported! must be one of "
                         f"[ {' | '.join(OPTIMIZERS)} ]")
    return OPTIMIZERS[name](list(params), lr)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Per-epoch LR update (the LambdaLR equivalent)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
