"""Semi-online rollout training (``RolloutConfig(semi_online=True)``,
rnn/utils.py:994-1060) in the port against the JAX package's trainer, on
the CPU, in float32: the prognostic input channels rebuilt from the
model's previous prediction and the true dynamics increment, normalized
with the state normalizer and the cloud-exp coefficients, through a W 3
window of the scan and the v4 arms, with and without remat (the scan arm
with mixed replay, whose mask gates the rebuilt state): the loss, the
memory and every parameter's gradient against ``jax.value_and_grad`` of
JAX's ``_window_loss`` on the same flax parameters; and the same updates from
``run_epoch``, ``run_epoch_fused`` and ``update``. The construction is
tests/test_rnn.py::test_rollout_semi_online's (nneur 16, ny 6, n_prog 6,
15 input channels) on ``Grid.synthetic``'s 60 levels, with yscales,
normalizer and cloud coefficients that are not the identity.

Tolerances: test_torch_train_arms.py's (the loss to 1e-5, gradients to
2e-4 of each value plus 1e-6 of the gradient's scale)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.models import common as jcommon
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch.models import RNNAutoreg, from_flax_params
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
from climsim_tpu_torch.train.rollout import run_epoch_fused
from test_torch_rnn_a12 import random_params

NX, NX_SFC, NY, NY_SFC, NH_MEM, L, B, W = 15, 24, 6, 8, 4, 60, 6, 3
_g = JaxGrid.synthetic(4, L)
HYAI, HYBI = np.asarray(_g.hyai, np.float32), np.asarray(_g.hybi, np.float32)
HYAM = tuple(float(v) for v in np.asarray(_g.hyam))
HYBM = tuple(float(v) for v in np.asarray(_g.hybm))
ARMS = {"scan": dict(), "v4": dict(use_pallas=True, fuse_heads=True,
                                   fuse_init=True)}
# scales that move the rebuilt state visibly: dt y / ysl ~ 1e-3 of it
YSCALE_LEV = np.array([1e4, 1e7, 1e9, 1e9, 1e4, 1e4], np.float32)
YSCALE_SCA = np.ones(NY_SFC, np.float32)
XMEAN = np.array([[250.0, 1e-3, 0.5, 0.5, 0.0, 0.0]], np.float32)
XDIV = np.array([[20.0, 1e-3, 0.5, 0.5, 10.0, 10.0]], np.float32)
LBD = np.linspace(50.0, 150.0, L).astype(np.float32)
G_RTOL, G_ATOL = 2e-4, 1e-6


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    x_lev = rng.normal(0, 1, (T, B, L, NX)).astype(np.float32)
    x_raw = np.stack([rng.normal(250, 10, (T, B, L)),
                      np.abs(rng.normal(1e-3, 3e-4, (T, B, L))),
                      np.abs(rng.normal(0, 1e-5, (T, B, L))),
                      np.abs(rng.normal(0, 1e-5, (T, B, L))),
                      rng.normal(0, 10, (T, B, L)),
                      rng.normal(0, 5, (T, B, L))], -1).astype(np.float32)
    y_raw = (rng.normal(0, 1, (T, B, L, NY))
             / YSCALE_LEV).astype(np.float32)
    return {"x_lev": x_lev,
            "x_sfc": rng.normal(0, 1, (T, B, NX_SFC)).astype(np.float32),
            "y_lev": np.tanh(x_lev[..., :NY]) * 0.5,
            "y_sfc": rng.normal(0, 0.5, (T, B, NY_SFC)).astype(np.float32),
            "sp": rng.uniform(9.6e4, 1.03e5, (T, B)).astype(np.float32),
            "x_lev_raw": x_raw, "y_lev_raw": y_raw}


def _trainers(arm, jax_side=True, **cfg):
    """(JAX's trainer, its flax parameters, the port's trainer on them);
    the parameters are JAX's init structure with seeded leaves
    (test_torch_rnn_a12.py::random_params). Without ``jax_side`` only the
    port's trainer, on its own seeded init."""
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=(16, 16),
              nh_mem=NH_MEM, hyam=HYAM, hybm=HYBM, add_pres=False,
              output_prune=False, **ARMS[arm])
    cfg = dict(loss="mse", lr=1e-3, rollout_schedule={0: W},
               semi_online=True, n_prog=6, **cfg)
    extra = dict(yscale_lev=YSCALE_LEV, yscale_sca=YSCALE_SCA,
                 xmean_prog=XMEAN, xdiv_prog=XDIV, lbd_qc=LBD,
                 lbd_qi=LBD * 2)
    tm = RNNAutoreg(policy=tcommon.F32, device="cpu", **kw)
    assert tm.arm == arm
    tt = RolloutTrainer(tm, RolloutConfig(**cfg), HYAI, HYBI, device="cpu",
                        **extra)
    if not jax_side:
        return None, None, tt
    jm = JaxRNNAutoreg(policy=jcommon.F32, **kw)
    params = random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((B, L, NX), jnp.float32),
        jnp.zeros((B, NX_SFC), jnp.float32),
        jnp.zeros((B, L, NH_MEM), jnp.float32)), seed=0)
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    jt = JaxTrainer(jm, JaxConfig(**cfg), HYAI, HYBI, **extra)
    return jt, params, tt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _replay(arm):
    """The scan arm runs mixed replay (half the columns rebuild their
    state, the rest read the true one); the v4 arm none."""
    return "mixed" if arm == "scan" else None


def _inputs():
    data = _data(W)
    mask = (np.arange(B) % 2).astype(np.float32)
    mem = np.random.default_rng(9).normal(0, 0.5, (B, L, NH_MEM)).astype(
        np.float32)
    return data, mem, mask


@functools.lru_cache(maxsize=None)
def _jax_window(arm):
    """JAX's loss, memory and gradients of one W 3 window, from one
    jitted ``value_and_grad`` of its trainer's ``_window_loss`` without
    remat (remat recomputes the same operations), compiled at XLA's
    backend optimization level 0 (the same HLO, half the compile time on
    the CPU); and the flax parameters."""
    jt, params, _ = _trainers(arm, replay=_replay(arm))
    data, mem, mask = _inputs()
    with jax.enable_x64(False):
        args = ({k: jnp.asarray(v) for k, v in data.items()},
                jnp.asarray(mem), jnp.asarray(mask))
        (jl, jmem), jg = jax.value_and_grad(
            lambda p: jt._window_loss(p, *args), has_aux=True)(params)
    return (float(jl), np.asarray(jmem), _flat(jg["params"]),
            jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_window_loss_and_grads_match_jax(arm, remat):
    """One W 3 window, with and without remat in the port, against JAX's:
    the loss, the memory and every gradient."""
    jl, jmem, jg, params = _jax_window(arm)
    _, _, tt = _trainers(arm, jax_side=False, remat=remat,
                         replay=_replay(arm))
    tt.model.load_state_dict(from_flax_params(params, tt.model))
    data, mem, mask = _inputs()
    tl, tmem = tt._window_loss({k: torch.as_tensor(v)
                                for k, v in data.items()},
                               torch.as_tensor(mem), torch.as_tensor(mask))
    tl.backward()
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    np.testing.assert_allclose(tmem.detach().numpy(), jmem,
                               rtol=2e-5, atol=2e-6)
    tg = {n: p.grad.numpy() for n, p in tt.model.named_parameters()}
    assert set(tg) == set(jg)
    for name, g in tg.items():
        np.testing.assert_allclose(g, jg[name], rtol=G_RTOL,
                                   atol=G_ATOL * np.abs(jg[name]).max(),
                                   err_msg=f"{arm}: d{name}")


def test_semi_online_changes_the_window():
    """The model sees the rebuilt state: the window's loss differs from
    the plain window's (the test's x_lev is not the normalized raw
    state, and from the second step the state is the model's)."""
    _, _, tt = _trainers("scan", jax_side=False)
    data = {k: torch.as_tensor(v) for k, v in _data(W, seed=2).items()}
    mem = torch.zeros((B, L, NH_MEM))
    with torch.no_grad():
        semi = tt._window_loss(data, mem, None)[0]
        tt.cfg.semi_online = False
        plain = tt._window_loss(data, mem, None)[0]
    assert torch.isfinite(semi) and not torch.equal(semi, plain)


def test_epochs_and_update_agree():
    """run_epoch, run_epoch_fused and update on one chunk of 2 W windows
    give the same losses and parameters (no replay: no mask is drawn),
    finite, as JAX's epoch of tests/test_rnn.py::test_rollout_semi_online
    runs."""
    chunk = _data(2 * W, seed=4)
    results = []
    for how in ("run_epoch", "fused", "update"):
        _, _, tt = _trainers("scan", jax_side=False)
        if how == "run_epoch":
            _, rec = tt.run_epoch(None, [chunk], 0)
            loss = rec["loss"]
        elif how == "fused":
            _, rec = run_epoch_fused(tt, None, [chunk], 0)
            loss = rec["loss"]
        else:
            mem = tt.init({k: torch.as_tensor(v) for k, v in chunk.items()})
            losses = []
            for s in (0, W):
                mem, lo = tt.update(tt._window(chunk, s, W), mem, None)
                losses.append(float(lo))
            loss = float(np.mean(losses))
        results.append((loss, [p.detach().clone()
                               for p in tt.model.parameters()]))
    for loss, params in results[1:]:
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, results[0][0], rtol=1e-6)
        for a, b in zip(params, results[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
