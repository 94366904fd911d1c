"""Learning-rate schedules (counterpart of
``climsim_tpu/train/schedules.py``): plain functions of the update count
that return the learning rate, which the trainer writes into the
optimizer before each update.

``one_cycle`` and ``warmup_constant`` reproduce the formulas of optax's
``cosine_onecycle_schedule``, ``linear_schedule`` and ``join_schedules``
that the JAX package builds them from (``torch.optim.lr_scheduler.
OneCycleLR`` has other endpoints).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def cyclical(init_lr: float, max_lr: float, step_size: int,
             halve_per_cycle: bool = True) -> Schedule:
    """Triangular cyclical LR; amplitude scaled by 1/2**(cycle-1)."""

    def schedule(step):
        cycle = math.floor(1 + step / (2 * step_size))
        x = abs(step / step_size - 2 * cycle + 1)
        amp = (max_lr - init_lr) * max(0.0, 1 - x)
        if halve_per_cycle:
            amp = amp / (2.0 ** (cycle - 1))
        return init_lr + amp

    return schedule


def step_decay(init_lr: float, every_steps: int,
               factor: float = 0.2) -> Schedule:
    """lr * factor**floor(step/every)."""
    return lambda step: init_lr * factor ** math.floor(step / every_steps)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init to end over ``steps``, then end."""
    if steps <= 0:
        return lambda step: init

    def schedule(step):
        frac = 1 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _join(schedules: Sequence[Schedule],
          boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _cosine_onecycle(transition_steps: int, peak: float, pct_start: float,
                     div_factor: float, final_div_factor: float) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div up to peak at
    int(pct_start * steps), then down to peak/div/final_div at steps."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs transition_steps > 0")
    scales = {int(pct_start * transition_steps): div_factor,
              int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = [peak / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * scales[b])

    def schedule(step):
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 \
                    * (math.cos(math.pi * pct) + 1)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


def one_cycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: float = 1e4,
              annealing: str = "cos") -> Schedule:
    """OneCycle: initial lr = max_lr/div_factor, final lr =
    initial/final_div_factor, warmup fraction pct_start, anneal strategy
    'cos' or 'linear'."""
    if annealing == "cos":
        return _cosine_onecycle(total_steps, max_lr, pct_start, div_factor,
                                final_div_factor)
    if annealing != "linear":
        raise ValueError(f"annealing '{annealing}' not in ('cos','linear')")
    init = max_lr / div_factor
    final = init / final_div_factor
    up = max(1, int(round(pct_start * total_steps)))
    return _join([_linear(init, max_lr, up),
                  _linear(max_lr, final, max(1, total_steps - up))], [up])


def warmup_constant(lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup to a constant lr."""
    return _join([_linear(0.0, lr, warmup_steps), lambda step: lr],
                 [warmup_steps])


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    ``warmup_steps``, then a cosine from peak to ``end_value`` at
    ``decay_steps`` (counted from 0, warmup included), then end."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")

    def cosine(step):
        frac = min(step, span) / span
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)

    return _join([_linear(init_value, peak_value, warmup_steps), cosine],
                 [warmup_steps])
