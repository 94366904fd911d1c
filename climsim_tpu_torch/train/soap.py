"""SOAP (Shampoo with Adam in the preconditioner's eigenbasis) as a
``torch.optim.Optimizer``, step for step as the JAX package's optax
transformation (``climsim_tpu/train/soap.py``):

* the first step only initializes the preconditioner from the gradient
  and updates no parameter;
* each step projects the gradient into the eigenbasis, runs Adam's moments
  there (denominator sqrt(v) + eps, step size lr sqrt(1 - b2^t) /
  (1 - b1^t)), projects the update back, then applies decoupled weight
  decay to the updated parameter;
* the accumulators L and R are lerped with the raw gradient after the
  update, so a gradient never enters its own projection;
* every ``precondition_frequency`` steps the bases refresh by one power
  iteration and a QR: the estimated eigenvalues sort the old basis
  columns in descending order, ``exp_avg_sq`` is permuted with them and
  ``exp_avg`` is re-projected (back through the old basis, forward
  through the new);
* the first basis is a full ``eigh`` with its columns in descending
  eigenvalue order.

Parameters of fewer than two dimensions, and those whose merged 2-D shape
has a side above ``max_precond_dim``, run plain Adam with the same
first-step skip; higher-rank parameters are merged to 2-D (all leading
axes by the last). The learning rate of a step is the group's ``lr``
when the step runs (``schedule_offset``: the JAX transformation reads its
schedule at the 1-based count of the step). Where JAX picks the refresh
with ``lax.cond`` on the device, here the host picks it from the step
count; ``torch.linalg.eigh`` and ``qr`` check their result on the host,
one synchronization per refresh on a CUDA device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["SOAP"]


def _shape2d(p: torch.Tensor):
    if p.dim() < 2:
        return None
    return (math.prod(p.shape[:-1]), p.shape[-1])


def _eigh_desc(M: torch.Tensor) -> torch.Tensor:
    """The eigenbasis of M with its columns in descending eigenvalue
    order."""
    M32 = M.float() + 1e-30 * torch.eye(M.shape[0], device=M.device)
    return torch.linalg.eigh(M32).eigenvectors.flip(1)


def _qr_q(A: torch.Tensor) -> torch.Tensor:
    """The orthonormal factor of A's QR decomposition."""
    return torch.linalg.qr(A).Q


def _desc_order(est: torch.Tensor) -> torch.Tensor:
    """The order of the eigenvalue estimates ``est``, largest first (the
    refresh's sort, soap.py:152-160)."""
    return torch.argsort(-est)


class SOAP(torch.optim.Optimizer):
    """SOAP with the JAX package's defaults (b1 0.95, b2 0.95,
    shampoo_beta 0.95, eps 1e-8, a refresh every 10 steps, max_precond_dim
    4096)."""

    # the schedule is read at the step's 1-based count
    schedule_offset = 1

    def __init__(self, params, lr: float = 3e-3, b1: float = 0.95,
                 b2: float = 0.95, shampoo_beta: float = 0.95,
                 eps: float = 1e-8, precondition_frequency: int = 10,
                 weight_decay: float = 0.0, max_precond_dim: int = 4096):
        super().__init__(params, dict(
            lr=lr, b1=b1, b2=b2, shampoo_beta=shampoo_beta, eps=eps,
            precondition_frequency=precondition_frequency,
            weight_decay=weight_decay, max_precond_dim=max_precond_dim))

    def _init_state(self, p, group):
        state = self.state[p]
        state["step"] = torch.tensor(0.0)
        shape = _shape2d(p)
        if shape is None or max(shape) > group["max_precond_dim"]:
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
            return state
        m, n = shape
        z = lambda *s: torch.zeros(s, dtype=p.dtype, device=p.device)
        state["exp_avg"], state["exp_avg_sq"] = z(m, n), z(m, n)
        state["L"], state["R"] = z(m, m), z(n, n)
        state["QL"] = torch.eye(m, dtype=p.dtype, device=p.device)
        state["QR"] = torch.eye(n, dtype=p.dtype, device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p] or self._init_state(p, group)
                step = int(state["step"])     # steps taken before this one
                state["step"] += 1
                live = step > 0
                bc1 = 1.0 - b1 ** max(step, 1)
                bc2 = 1.0 - b2 ** max(step, 1)
                step_size = lr * math.sqrt(bc2) / bc1
                if "L" in state:
                    self._matrix(p, state, group, step, live, step_size)
                elif live:
                    g = p.grad
                    m, v = state["exp_avg"], state["exp_avg_sq"]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).add_(g * g, alpha=1 - b2)
                    self._apply(p, step_size * (m / (v.sqrt() + eps)), lr,
                                wd)
        return loss

    @staticmethod
    def _apply(p, u, lr, wd):
        """p -= u, then the decoupled weight decay on the updated
        parameter: p - (u + lr wd (p - u))."""
        if wd:
            u = u + lr * wd * (p - u)
        p.sub_(u)

    def _matrix(self, p, state, group, step, live, step_size):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        sb = group["shampoo_beta"]
        g2 = p.grad.reshape(state["exp_avg"].shape)
        QL, QR = state["QL"], state["QR"]
        m, v = state["exp_avg"], state["exp_avg_sq"]
        if live:
            gp = QL.t() @ g2 @ QR
            m = b1 * m + (1 - b1) * gp
            v = b2 * v + (1 - b2) * gp * gp
            u = QL @ (m / (torch.sqrt(v) + eps)) @ QR.t()
            self._apply(p, step_size * u.reshape(p.shape), group["lr"],
                        group["weight_decay"])
        # the accumulators after the update, then the basis
        m_back = QL @ m @ QR.t()
        L = sb * state["L"] + (1 - sb) * (g2 @ g2.t())
        R = sb * state["R"] + (1 - sb) * (g2.t() @ g2)
        if step == 0:
            QLn, QRn = _eigh_desc(L).to(g2.dtype), _eigh_desc(R).to(g2.dtype)
        elif step % group["precondition_frequency"] == 0:
            L32, R32, QL32, QR32 = L.float(), R.float(), QL.float(), \
                QR.float()
            sortL = _desc_order(torch.diagonal(QL32.t() @ L32 @ QL32))
            sortR = _desc_order(torch.diagonal(QR32.t() @ R32 @ QR32))
            v = v[sortL][:, sortR]
            QLn = _qr_q(L32 @ QL32[:, sortL]).to(g2.dtype)
            QRn = _qr_q(R32 @ QR32[:, sortR]).to(g2.dtype)
        else:
            QLn, QRn = QL, QR
        state["exp_avg"] = QLn.t() @ m_back @ QRn
        state["exp_avg_sq"] = v
        state["L"], state["R"], state["QL"], state["QR"] = L, R, QLn, QRn
