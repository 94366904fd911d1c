"""The port's SOAP, Muon and schedule-free AdamW against the JAX
package's optax transformations (``climsim_tpu.train.soap.soap``,
``climsim_tpu.train.muon.muon`` and ``optax.contrib.schedule_free_adamw``)
on the CPU: the parameters after N steps from the same seeded gradients,
in float32, to 1e-5 relative (plus 1e-6 of the parameter's scale), with a
constant learning rate and with a callable schedule (the port's group
``lr`` set before each step to the schedule at the step's 1-based count,
where optax reads it).

SOAP runs 25 steps with ``precondition_frequency`` 10 (the first basis
and two refreshes) on a 1-D parameter, a 2-D one, a 3-D one merged to
2-D and one whose side is above ``max_precond_dim`` (plain Adam), at
weight decay 0 and 0.01. ``eigh`` and ``qr`` fix each basis column only
up to sign, to which the update is invariant, but not a basis that a
degenerate eigenvalue leaves free: the preconditioned parameters are
square after merging, so their gradients' Gram matrices have full
rank."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.contrib
import pytest
import torch

from climsim_tpu.train.muon import muon as jmuon
from climsim_tpu.train.soap import soap as jsoap
from climsim_tpu_torch.train.muon import Muon, newton_schulz_orthogonalize
from climsim_tpu_torch.train.schedule_free import ScheduleFreeAdamW
from climsim_tpu_torch.train.soap import SOAP

SHAPES = {"b": (7,), "w2": (8, 8), "w3": (2, 3, 6), "big": (20, 4)}


def schedule(count):
    return 0.01 / (1.0 + 0.1 * count)


def _run(jax_tx, torch_opt, params, n, sched, seed=0, scale=1.0):
    """N steps of both from the same gradients; returns both parameter
    sets as numpy."""
    rng = np.random.default_rng(seed)
    grads = [{k: (scale * rng.normal(0, 1, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(n)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax_tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = torch_opt(list(tp.values()))
    for i, g in enumerate(grads):
        upd, state = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        if sched is not None:
            for grp in opt.param_groups:
                grp["lr"] = sched(i + opt.schedule_offset)
        opt.step()
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: p.detach().numpy() for k, p in tp.items()}, opt)


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.5, s).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(want, got):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("scheduled", [False, True])
def test_soap_matches_jax(wd, scheduled):
    lr = schedule if scheduled else 3e-3
    params = _params()
    want, got, opt = _run(
        jsoap(lr, weight_decay=wd, max_precond_dim=16),
        lambda ps: SOAP(ps, lr=3e-3, weight_decay=wd, max_precond_dim=16),
        params, 25, schedule if scheduled else None)
    _close(want, got)
    # the parameters moved, and the large one ran plain Adam
    for k in params:
        assert np.abs(got[k] - params[k]).max() > 1e-4, k
    big = opt.state[opt.param_groups[0]["params"][3]]
    assert "L" not in big and "L" in opt.state[
        opt.param_groups[0]["params"][1]]


def test_soap_first_step_updates_nothing():
    params = _params()
    _, got, _ = _run(jsoap(3e-3, weight_decay=0.01),
                     lambda ps: SOAP(ps, lr=3e-3, weight_decay=0.01),
                     params, 1, None)
    for k in params:
        assert np.array_equal(got[k], params[k]), k


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("scheduled", [False, True])
def test_muon_matches_jax(wd, scheduled):
    lr = schedule if scheduled else 0.02
    want, got, _ = _run(jmuon(lr, weight_decay=wd),
                        lambda ps: Muon(ps, lr=0.02, weight_decay=wd),
                        _params(), 10, schedule if scheduled else None)
    _close(want, got)


def test_newton_schulz_matches_jax():
    from climsim_tpu.train.muon import newton_schulz_orthogonalize as jns
    g = np.random.default_rng(3).normal(0, 1, (12, 5)).astype(np.float32)
    for a in (g, g.T):
        np.testing.assert_allclose(
            newton_schulz_orthogonalize(torch.tensor(a)).numpy(),
            np.asarray(jns(jnp.asarray(a))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("scheduled", [False, True])
def test_schedule_free_matches_optax(wd, scheduled):
    """A schedule is given to both as a callable: optax reads it at the
    0-based count for the base update and at the 1-based count for the
    averaging weight."""
    lr = schedule if scheduled else 0.01
    want, got, opt = _run(
        optax.contrib.schedule_free_adamw(lr, weight_decay=wd),
        lambda ps: ScheduleFreeAdamW(ps, lr=lr, weight_decay=wd),
        _params(), 20, None)
    _close(want, got)


@pytest.mark.parametrize("cls", [SOAP, Muon, ScheduleFreeAdamW])
def test_state_dict_round_trip(cls):
    """A rebuilt optimizer loaded from the state dict continues exactly
    (the rollout checkpoints save and restore it)."""
    params = _params()
    rng = np.random.default_rng(5)
    grads = [[torch.tensor(rng.normal(0, 1, v.shape).astype(np.float32))
              for v in params.values()] for _ in range(14)]

    def steps(opt, ps, gs):
        for g in gs:
            for p, gi in zip(ps, g):
                p.grad = gi.clone()
            opt.step()

    a = [torch.nn.Parameter(torch.tensor(v)) for v in params.values()]
    oa = cls(a, lr=1e-3)
    steps(oa, a, grads)
    b = [torch.nn.Parameter(torch.tensor(v)) for v in params.values()]
    ob = cls(b, lr=1e-3)
    steps(ob, b, grads[:9])
    c = [torch.nn.Parameter(p.detach().clone()) for p in b]
    oc = cls(c, lr=1e-3)
    oc.load_state_dict(ob.state_dict())
    steps(oc, c, grads[9:])
    for x, y in zip(a, c):
        assert torch.equal(x, y)
