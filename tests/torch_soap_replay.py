"""Replay the JAX package's SOAP eigenbases in the port's SOAP (a helper
of the tests, not collected by pytest).

``eigh`` fixes a basis only up to the free rotation that a degenerate
eigenvalue leaves, and the first basis of a rectangular weight always
has one: L = g g^T or R = g^T g of a single gradient has rank
min(rows, cols). SOAP's elementwise Adam in that basis is not invariant
to the rotation, so two correct implementations diverge at the first
preconditioned step. To hold the port to JAX beyond it, JAX's run
records every basis it computes (the initial ``_eigh_desc`` and the
refresh's QR, through ``jax.debug.callback``, so JAX stays jitted) and
the port's run looks up, for each of its own, the recorded one whose
input matrix is nearest to its input (they differ by rounding) and uses
it."""
from __future__ import annotations

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

# the modules (the packages export functions of the same names)
JS = importlib.import_module("climsim_tpu.train.soap")
TS = importlib.import_module("climsim_tpu_torch.train.soap")


class BasisLog:
    """(kind, input matrix, basis) of every basis JAX's SOAP computed."""

    def __init__(self):
        self.entries: list = []
        self.replayed = 0

    def add(self, kind, a, q):
        self.entries.append((kind, np.array(a), np.array(q)))

    def nearest(self, kind: str, x: torch.Tensor, rtol: float):
        xn = x.detach().cpu().double().numpy()
        scale = max(float(np.abs(xn).max()), 1e-30)
        found = sorted(
            (float(np.abs(a - xn).max()) / scale, i)
            for i, (k, a, _) in enumerate(self.entries)
            if k == kind and a.shape == xn.shape)
        best = found[0][0] if found else np.inf
        second = found[1][0] if len(found) > 1 else np.inf
        q = self.entries[found[0][1]][2] if found else None
        assert best < rtol and 10 * best < second, \
            f"no recorded {kind} input within {rtol} and 10x nearer than " \
            f"the next (nearest {best:.3g}, next {second:.3g}, {xn.shape})"
        self.replayed += 1
        return torch.tensor(q, dtype=x.dtype, device=x.device)


@contextlib.contextmanager
def record_jax(log: BasisLog):
    """JAX's SOAP records each basis it computes into ``log``."""
    eigh, qr = JS._eigh_desc, jnp.linalg.qr

    def rec_eigh(M):
        Q = eigh(M)
        jax.debug.callback(lambda m, q: log.add("eigh", m, q), M, Q)
        return Q

    def rec_qr(A, *a, **k):
        Q, R = qr(A, *a, **k)
        jax.debug.callback(lambda x, q: log.add("qr", x, q), A, Q)
        return Q, R

    JS._eigh_desc, jnp.linalg.qr = rec_eigh, rec_qr
    try:
        yield log
        jax.effects_barrier()
    finally:
        JS._eigh_desc, jnp.linalg.qr = eigh, qr


@contextlib.contextmanager
def replay_port(log: BasisLog, rtol: float = 0.1):
    """The port's SOAP takes each basis from ``log``: the recorded one
    whose input is within ``rtol`` (of the input's largest entry) and at
    least 10x nearer than any other recorded input of that shape. The
    inputs differ by rounding, which a loss term of large weight (the
    water term's 3e7) amplifies to a few 1e-3 in a first gradient's Gram
    matrix and up to 6e-2 in a refresh's product; another parameter's or
    step's input is O(1) away."""
    eigh, qr = TS._eigh_desc, TS._qr_q
    TS._eigh_desc = lambda M: log.nearest("eigh", M, rtol)
    TS._qr_q = lambda A: log.nearest("qr", A, rtol)
    try:
        yield log
    finally:
        TS._eigh_desc, TS._qr_q = eigh, qr
