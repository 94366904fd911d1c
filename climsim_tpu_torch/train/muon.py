"""Muon (momentum orthogonalized by Newton-Schulz) as a
``torch.optim.Optimizer``, as the JAX package's optax transformation
(``climsim_tpu/train/muon.py``): for parameters of two or more
dimensions the Nesterov momentum buffer, merged to 2-D (all leading axes
by the last), is orthogonalized by 5 steps of the quintic Newton-Schulz
iteration X <- aX + b(XX^T)X + c(XX^T)^2 X with (a, b, c) = (3.4445,
-4.7750, 2.0315) and scaled by sqrt(max(1, rows / cols)); vectors and
scalars run Adam (b1 0.9, b2 0.999, eps 1e-8) at ``lr / 20``. Weight
decay is added to the update, times the learning rate. The learning rate
of a step is the group's ``lr`` when the step runs (``schedule_offset``:
the JAX transformation reads its schedule at the 1-based count of the
step). ``torch.optim.Muon`` takes only 2-D parameters and has no Adam
side, so it is not used."""
from __future__ import annotations

import math

import torch

__all__ = ["Muon", "newton_schulz_orthogonalize"]

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_orthogonalize(G: torch.Tensor,
                                steps: int = 5) -> torch.Tensor:
    """Approximately the nearest orthogonal matrix to G [m, n]."""
    a, b, c = NS_COEFFS
    transpose = G.shape[0] > G.shape[1]
    X = G.t() if transpose else G
    X = X / (torch.linalg.norm(X) + 1e-7)
    for _ in range(steps):
        A = X @ X.t()
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X.t() if transpose else X


class Muon(torch.optim.Optimizer):
    """Muon with the JAX package's defaults (momentum 0.95, Nesterov, 5
    Newton-Schulz steps; the Adam side at lr / 20)."""

    schedule_offset = 1

    def __init__(self, params, lr: float = 0.02, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5,
                 adam_lr_div: float = 20.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(
            lr=lr, momentum=momentum, nesterov=nesterov, ns_steps=ns_steps,
            adam_lr_div=adam_lr_div, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    key = ("momentum",) if p.dim() >= 2 \
                        else ("exp_avg", "exp_avg_sq")
                    for k in key:
                        state[k] = torch.zeros_like(p)
                state["step"] += 1
                count = int(state["step"])
                if p.dim() >= 2:
                    mom = state["momentum"]
                    mom.mul_(group["momentum"]).add_(g)
                    eff = g + group["momentum"] * mom if group["nesterov"] \
                        else mom
                    g2 = eff.reshape(-1, eff.shape[-1])
                    o = newton_schulz_orthogonalize(g2, group["ns_steps"])
                    u = o.reshape(eff.shape) \
                        * math.sqrt(max(1.0, g2.shape[0] / g2.shape[1]))
                    step_lr = lr
                else:
                    b1, b2 = group["b1"], group["b2"]
                    m, v = state["exp_avg"], state["exp_avg_sq"]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).add_(g * g, alpha=1 - b2)
                    u = (m / (1 - b1 ** count)) / (
                        torch.sqrt(v / (1 - b2 ** count)) + group["eps"])
                    step_lr = lr / group["adam_lr_div"]
                if wd:
                    u = u + wd * p
                p.sub_(step_lr * u)
        return loss
