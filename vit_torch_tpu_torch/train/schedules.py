"""Learning-rate schedules, a copy of ``vit_torch_tpu/train/schedules.py``
(pure Python; the port imports nothing of the JAX package).

Capability parity with the reference's ``LRSchedule`` closures + ``LambdaLR``
wiring (``utils_network.py:35-73,529-544``): per-epoch multiplicative factors
on the base LR, selected by ``--lr_scheduler`` ∈
{none, step, exp, cos, ca, cos_exp} with ``--lr_step/--lr_gamma/--lr_scale``.

Fixed (not replicated) reference bugs: 'none' returned ``lambda e: e``
(scaling LR by the epoch index) — here it is a constant 1.0; 'ca' was in the
flag choices but raised NotImplementedError — here it is true cosine
annealing to ``min_scale`` over ``step`` epochs.

The factor functions are pure Python floats: the trainer sets the
resulting LR on the optimizer's param groups per epoch (LR changes at
epoch granularity exactly like the reference's scheduler.step()).
"""

from __future__ import annotations

import math
from typing import Callable


def none_fn(**_) -> Callable[[int], float]:
    return lambda e: 1.0


def step_fn(step: int = 10, gamma: float = 0.5, **_) -> Callable[[int], float]:
    assert step > 0 and 0 <= gamma <= 1
    return lambda e: gamma ** math.floor(e / step)


def exp_fn(gamma: float = 0.99, **_) -> Callable[[int], float]:
    assert 0 <= gamma <= 1
    return lambda e: gamma ** float(e)


def cos_fn(step: int = 20, min_scale: float = 0.1, **_) -> Callable[[int], float]:
    """The reference's restarting half-period cosine: ``mod(e/step, 0.5)``
    sweeps the factor 1→min_scale over ``step/2`` epochs, then restarts
    (``utils_network.py:60-63``)."""
    assert 0 <= min_scale <= 1
    return lambda e: ((1.0 - min_scale) / 2
                      * (math.cos(math.fmod(e / step, 0.5) * math.pi * 2) + 1)
                      + min_scale)


def cos_exp_fn(step: int = 20, min_scale: float = 0.1, gamma: float = 0.5,
               **_) -> Callable[[int], float]:
    base = cos_fn(step=step, min_scale=min_scale)
    assert 0 <= gamma <= 1
    return lambda e: base(e) * gamma ** float(e / step)


def cosine_annealing_fn(step: int = 20, min_scale: float = 0.1,
                        **_) -> Callable[[int], float]:
    """Standard cosine annealing over ``step`` epochs (the 'ca' choice the
    reference declared but never implemented)."""
    assert 0 <= min_scale <= 1
    return lambda e: (min_scale + (1.0 - min_scale) / 2
                      * (1 + math.cos(math.pi * min(e / step, 1.0))))


_SCHEDULES = {
    "none": none_fn,
    "step": step_fn,
    "exp": exp_fn,
    "cos": cos_fn,
    "cos_exp": cos_exp_fn,
    "ca": cosine_annealing_fn,
}


def get_lr_factor_fn(lr_scheduler: str = "step", lr_step: int = 10,
                     lr_gamma: float = 0.5, lr_scale: float = 0.1,
                     ) -> Callable[[int], float]:
    """Flag-compatible entry point (``--lr_scheduler/--lr_step/--lr_gamma/--lr_scale``)."""
    if lr_scheduler not in _SCHEDULES:
        raise NotImplementedError(
            f"lr scheduler {lr_scheduler!r} not implemented; "
            f"have {sorted(_SCHEDULES)}")
    return _SCHEDULES[lr_scheduler](step=lr_step, gamma=lr_gamma,
                                    min_scale=lr_scale)
