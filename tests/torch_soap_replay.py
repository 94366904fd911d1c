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
it.

The refresh also sorts the eigenvalue estimates (the diagonal of
Q^T L Q), and two estimates a rounding apart can sort either way: then
the runs take different permutations and part. JAX's run records each
sort's estimates and order too, and the port keeps its own order where
it is JAX's and takes JAX's only where the two differ among estimates
closer to each other than ``SORT_GAP`` (relative) or than twice the
largest difference between the two packages' estimates at that sort
(then either order is a rounding's choice), or within float32 rounding
of the largest estimate (``SORT_FLOOR`` of it: a rectangular weight's
Gram matrix has eigenvalues that are zero but for rounding); an order
that differs anywhere else fails. ``reordered`` counts the sorts that took JAX's
order, beside ``replayed`` for the bases."""
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


# estimates closer than this (relative to the larger), or than twice the
# packages' own distance, or than SORT_FLOOR of the largest estimate, may
# sort either way
SORT_GAP, SORT_FLOOR = 1e-3, 1e-6


class BasisLog:
    """(kind, input matrix, basis) of every basis JAX's SOAP computed, and
    (estimates, order) of every sort of its refreshes."""

    def __init__(self):
        self.entries: list = []
        self.sorts: list = []
        self.replayed = 0
        self.sorted = 0
        self.reordered = 0

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

    def order(self, est: torch.Tensor, rtol: float) -> torch.Tensor:
        """The port's descending order of ``est``, or JAX's recorded one
        for the nearest recorded estimates where they differ only among
        estimates within SORT_GAP of each other."""
        own = torch.argsort(-est)
        e = est.detach().cpu().double().numpy()
        scale = max(float(np.abs(e).max()), 1e-30)
        found = sorted((float(np.abs(a - e).max()) / scale, i)
                       for i, (a, _) in enumerate(self.sorts)
                       if a.shape == e.shape)
        assert found and found[0][0] < rtol and (
            len(found) < 2 or 10 * found[0][0] < found[1][0]), \
            f"no recorded sort within {rtol} (nearest {found[:2]})"
        self.sorted += 1
        jo = self.sorts[found[0][1]][1]
        mine = own.cpu().numpy()
        if np.array_equal(mine, jo):
            return own
        # how far the port's estimates are from JAX's at this sort
        apart = float(np.abs(self.sorts[found[0][1]][0] - e).max())
        for i in np.flatnonzero(mine != jo):
            a, b = e[mine[i]], e[jo[i]]
            assert abs(a - b) <= max(SORT_GAP * max(abs(a), abs(b)),
                                     2 * apart) + SORT_FLOOR * scale, \
                f"the orders differ at {i} between estimates {a} and {b} " \
                f"(the largest {scale}, the packages {apart} apart)"
        self.reordered += 1
        return torch.as_tensor(jo, device=est.device)


@contextlib.contextmanager
def record_jax(log: BasisLog):
    """JAX's SOAP records each basis it computes into ``log``."""
    eigh, qr, argsort = JS._eigh_desc, jnp.linalg.qr, jnp.argsort

    def rec_eigh(M):
        Q = eigh(M)
        jax.debug.callback(lambda m, q: log.add("eigh", m, q), M, Q)
        return Q

    def rec_qr(A, *a, **k):
        Q, R = qr(A, *a, **k)
        jax.debug.callback(lambda x, q: log.add("qr", x, q), A, Q)
        return Q, R

    def rec_argsort(a, *args, **kw):
        # the refresh sorts -est
        order = argsort(a, *args, **kw)
        jax.debug.callback(lambda x, o: log.sorts.append(
            (-np.array(x, np.float64), np.array(o))), a, order)
        return order

    JS._eigh_desc, jnp.linalg.qr, jnp.argsort = rec_eigh, rec_qr, \
        rec_argsort
    try:
        yield log
        jax.effects_barrier()
    finally:
        JS._eigh_desc, jnp.linalg.qr, jnp.argsort = eigh, qr, argsort


@contextlib.contextmanager
def replay_port(log: BasisLog, rtol: float = 0.1):
    """The port's SOAP takes each basis from ``log``: the recorded one
    whose input is within ``rtol`` (of the input's largest entry) and at
    least 10x nearer than any other recorded input of that shape. The
    inputs differ by rounding, which a loss term of large weight (the
    water term's 3e7) amplifies to a few 1e-3 in a first gradient's Gram
    matrix and up to 6e-2 in a refresh's product; another parameter's or
    step's input is O(1) away."""
    eigh, qr, order = TS._eigh_desc, TS._qr_q, TS._desc_order
    TS._eigh_desc = lambda M: log.nearest("eigh", M, rtol)
    TS._qr_q = lambda A: log.nearest("qr", A, rtol)
    TS._desc_order = lambda est: log.order(est, rtol)
    try:
        yield log
    finally:
        TS._eigh_desc, TS._qr_q, TS._desc_order = eigh, qr, order
