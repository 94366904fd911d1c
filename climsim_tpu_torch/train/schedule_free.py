"""Schedule-free AdamW (Defazio et al. 2024) as a ``torch.optim.Optimizer``,
written to ``optax.contrib.schedule_free_adamw``'s arithmetic (optax
0.2.6, which the JAX package's rollout trainer calls for
``adamwschedulefree`` and ``schedulefree``) with its defaults: b1 0.9,
b2 0.999, eps 1e-8, no warmup, ``weight_lr_power`` 2.0.

Each step, with y the parameters (where the gradient was taken) and z
the base sequence held in the state:

* the base update is RMSprop with bias correction and eps outside the
  root plus decoupled weight decay on y, times -lr:
  nu = b2 nu + (1 - b2) g^2, u = -lr (g / (sqrt(nu / (1 - b2^t)) + eps)
  + wd y), and z' = z + u;
* the averaging weight is c = w / (sum of w so far), w = max_lr^power
  (max_lr the largest learning rate seen);
* x = (y - (1 - b1) z) / b1, x' = (1 - c) x + c z', y' = b1 x' + (1 - b1)
  z'.

The parameters the optimizer leaves are y', optax's parameters (the
averaged point x' is (y' - (1 - b1) z') / b1). ``lr`` is a float or, as optax
takes it, a schedule of the step count: optax reads it at the 0-based
count for the base update and at the 1-based count for the averaging
weight, and so does this optimizer (a callable ``lr`` cannot be saved in
a state dict; the rollout trainer gives a float, as JAX's does)."""
from __future__ import annotations

import torch

__all__ = ["ScheduleFreeAdamW"]


class ScheduleFreeAdamW(torch.optim.Optimizer):

    def __init__(self, params, lr: float = 0.0025, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, weight_lr_power: float = 2.0):
        super().__init__(params, dict(
            lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            weight_lr_power=weight_lr_power, weight_sum=0.0, max_lr=0.0,
            step_count=0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            t0 = group["step_count"]
            group["step_count"] = t0 + 1
            lr = group["lr"]
            lr, weight_lr = (lr(t0), lr(t0 + 1)) if callable(lr) \
                else (lr, lr)
            max_lr = max(group["max_lr"], weight_lr)
            weight = max_lr ** group["weight_lr_power"]
            total = group["weight_sum"] + weight
            ck = weight / total if total > 0 else 0.0
            group["max_lr"], group["weight_sum"] = max_lr, total
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["z"] = p.detach().clone()
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = int(state["step"])
                nu = state["exp_avg_sq"]
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                u = g / (torch.sqrt(nu / (1 - b2 ** t)) + group["eps"]) \
                    + group["weight_decay"] * p
                z_old = state["z"]
                z = z_old - lr * u
                x = (p - (1.0 - b1) * z_old) / b1
                x = (1.0 - ck) * x + ck * z
                p.copy_(b1 * x + (1.0 - b1) * z)
                state["z"] = z
        return loss
