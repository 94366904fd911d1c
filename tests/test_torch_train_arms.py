"""Rollout training of the batch-major emulator arms (scan, v2, v3, v4)
against the JAX package's trainer, on the CPU: one window's loss, memory
and parameter gradients, and one update of ``run_epoch``, with the same
flax parameters and numpy-seeded data. tests/test_torch_train.py holds
the channel-major v6 model the same way; ``conf/autoreg_gru.yaml`` trains
the scan arm, bench.py times its training beside v6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import common as jcommon
from climsim_tpu.models.rnn import RNNAutoreg as JaxRNNAutoreg
from climsim_tpu.train.rollout import (RolloutConfig as JaxConfig,
                                       RolloutTrainer as JaxTrainer)
from climsim_tpu_torch.models import (RNNAutoreg, from_flax_params,
                                      from_optax_adam)
from climsim_tpu_torch.models import common as tcommon
from climsim_tpu_torch.ops import (bigru_bwd_lbh, fused_bigru_heads_init_lbh,
                                   fused_bigru_heads_lbh, fused_bigru_lbh)
from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer

NX, NX_SFC, NY, NY_SFC = 6, 24, 6, 8
NNEUR, NH_MEM, L, B, W = (16, 16), 4, 16, 12, 2
ARMS = {"scan": dict(add_pres=True),
        "v2": dict(use_pallas=True, add_pres=True),
        "v3": dict(use_pallas=True, fuse_heads=True, add_pres=False),
        "v4": dict(use_pallas=True, fuse_heads=True, fuse_init=True,
                   add_pres=False)}
YSCALE_LEV = np.array([1e5, 1e8, 1e9, 1e9, 1e5, 1e5], np.float32)
YSCALE_SCA = np.array([1e-2, 1e-2, 1e8, 1e8, 1e-2, 1e-2, 1e-2, 1e-2],
                      np.float32)
HYAI = np.linspace(2e-3, 0.0, L + 1).astype(np.float32)
HYBI = np.linspace(0.0, 1.0, L + 1).astype(np.float32)
HYAM = tuple(0.5 * (HYAI[1:] + HYAI[:-1]).astype(np.float64))
HYBM = tuple(0.5 * (HYBI[1:] + HYBI[:-1]).astype(np.float64))
# tests/test_torch_train.py's tolerances: the same float32 arithmetic up to
# summation order over 2 x 16 recurrent levels and a few losses
G_RTOL, G_ATOL = 2e-4, 1e-6


def _data(T, seed=3):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    return {"x_lev": r(T, B, L, NX), "x_sfc": r(T, B, NX_SFC),
            "y_lev": r(T, B, L, NY), "y_sfc": r(T, B, NY_SFC),
            "sp": (1e5 + 1e3 * rng.standard_normal((T, B))).astype(
                np.float32)}


def _trainers(arm, **cfg):
    kw = dict(nx=NX, nx_sfc=NX_SFC, ny=NY, ny_sfc=NY_SFC, nneur=NNEUR,
              nh_mem=NH_MEM, hyam=HYAM, hybm=HYBM, sp_mean=1e5, sp_div=1e3,
              **ARMS[arm])
    jm = JaxRNNAutoreg(policy=jcommon.F32, **kw)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((B, L, NX), jnp.float32),
                     jnp.zeros((B, NX_SFC), jnp.float32),
                     jnp.zeros((B, L, NH_MEM), jnp.float32))
    tm = RNNAutoreg(policy=tcommon.F32, device="cpu", **kw)
    assert tm.arm == arm
    tm.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    scales = dict(yscale_lev=YSCALE_LEV, yscale_sca=YSCALE_SCA)
    jt = JaxTrainer(jm, JaxConfig(**cfg), HYAI, HYBI, **scales)
    tt = RolloutTrainer(tm, RolloutConfig(**cfg), HYAI, HYBI, device="cpu",
                        **scales)
    return jt, params, tt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_window_loss_and_grads_match_jax(arm, remat):
    """One window (W 2, MSE with the water term) of each batch-major arm:
    the loss, the new memory and every parameter gradient against
    jax.value_and_grad of the JAX trainer's ``_window_loss``. On the CPU
    the fused arms' gradients come from the plain versions (v2: B8's; v3
    and v4: autograd of the composition over fused_bigru_lbh)."""
    cfg = dict(loss="mse", rollout_schedule={0: W}, w_water=1e-3,
               remat=remat)
    jt, params, tt = _trainers(arm, **cfg)
    data = _data(W)
    mask = np.ones((B,), np.float32)
    mem = np.random.default_rng(9).normal(0, 0.5, (B, L, NH_MEM)).astype(
        np.float32)

    def jloss(p):
        return jt._window_loss(p, {k: jnp.asarray(v) for k, v in
                                   data.items()}, jnp.asarray(mem),
                               jnp.asarray(mask))
    (jl, jmem), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    jg = _flat(jg["params"])
    tl, tmem = tt._window_loss({k: torch.as_tensor(v) for k, v in
                                data.items()}, torch.as_tensor(mem),
                               torch.as_tensor(mask))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tmem.detach().numpy(), np.asarray(jmem),
                               rtol=2e-5, atol=2e-6)
    tg = {n: p.grad.numpy() for n, p in tt.model.named_parameters()}
    assert set(tg) == set(jg)
    for name, g in tg.items():
        assert np.abs(g).max() > 0, f"no gradient reaches {name}"
        np.testing.assert_allclose(g, jg[name], rtol=G_RTOL,
                                   atol=G_ATOL * np.abs(jg[name]).max(),
                                   err_msg=f"{arm}: d{name}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_update_matches_jax(arm):
    """One update of ``run_epoch`` (one chunk of W steps, remat, Adam 1e-3)
    from a carried non-zero Adam state against the JAX trainer: the loss
    record and the memory, then every parameter to 1e-5 of its size plus
    2% of one Adam step (lr), as tests/test_torch_train.py. On the CPU no
    kernel launches."""
    lr = 1e-3
    cfg = dict(loss="mse", lr=lr, rollout_schedule={0: W}, remat=True,
               w_water=1e-3)
    jt, params, tt = _trainers(arm, **cfg)
    rng = np.random.default_rng(11)
    mu = jax.tree_util.tree_map(
        lambda p: rng.normal(0, 1e-3, p.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: rng.uniform(1e-7, 1e-6, p.shape).astype(np.float32),
        params)
    adam = jt.tx.init(params)
    adam = (adam[0]._replace(count=jnp.asarray(3, jnp.int32),
                             mu=jax.tree_util.tree_map(jnp.asarray, mu),
                             nu=jax.tree_util.tree_map(jnp.asarray, nu)),) \
        + tuple(adam[1:])
    tt.opt.load_state_dict(from_optax_adam(mu, nu, 3, tt.model, tt.opt))
    chunk = _data(W, seed=5)
    flat = _flat(params["params"])
    jp, _, jmem, jrec = jt.run_epoch(jax.tree_util.tree_map(jnp.copy, params),
                                     adam, None, [chunk], epoch=0)
    wrappers = (fused_bigru_lbh, bigru_bwd_lbh, fused_bigru_heads_lbh,
                fused_bigru_heads_init_lbh)
    before = [w.launches for w in wrappers]
    tmem, trec = tt.run_epoch(None, [chunk], epoch=0)
    assert [w.launches for w in wrappers] == before
    assert trec["updates"] == jrec["updates"] == 1
    np.testing.assert_allclose(trec["loss"], jrec["loss"], rtol=1e-5)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=1e-4,
                               atol=1e-5)
    jflat = _flat(jp["params"])
    for name, p in tt.model.named_parameters():
        p = p.detach().numpy()
        assert np.abs(p - flat[name]).max() > 0.1 * lr, f"{name} is stuck"
        np.testing.assert_allclose(p, jflat[name], rtol=1e-5,
                                   atol=0.02 * lr, err_msg=f"{arm}: {name}")
